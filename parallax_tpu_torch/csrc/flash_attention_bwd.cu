// Flash-attention backward for Hopper (sm_90a) in fp32: dq and dk/dv.
//
// Replaces the two TPU backward kernels of
// parallax_tpu/ops/pallas_attention.py, launched by `_flash_backward`:
//   * pt_flash_dq  <- `_flash_dq_kernel`  (its pl.pallas_call at line 298);
//   * pt_flash_dkv <- `_flash_dkv_kernel` (its pl.pallas_call at line 326).
// Same function, same rounding points:
//   * q is multiplied by `scale` in the input dtype before every dot;
//   * dO, k and v are widened to fp32; every product accumulates in fp32;
//   * p = exp(s - lse) is recomputed from the forward's lse, and zeroed
//     where s <= -1e30 / 2 (masked scores are set to -1e30 first). A fully
//     masked row has lse = -1e30, so exp(s - lse) is 1 there and only this
//     check on s zeroes it;
//   * ds = p * (dO.v - delta), with delta = rowsum(dO * out) (less the lse
//     cotangent) computed by the caller;
//   * dq = scale * sum_k ds.k, rounded to q's dtype once; dk = sum_q ds.(scale
//     q) is written unscaled (q was pre-scaled), dv = sum_q p.dO.
// Inputs and outputs keep the public [B, T, H, hd] layout (the kernels walk
// the strides); lse and delta are [B, H, Tq] fp32. fp32 inputs only: bf16
// dq and dk/dv are the wgmma kernels of flash_attention_sm90.cu, and fp32
// dq and dk/dv run the split-operand TF32 tensor-core kernels of
// flash_attention_f32_sm90.cu (pt_flash_dq and pt_flash_dkv here are off
// the route, the earlier times of their rows); hd in
// {64, 128}, any Tq / Tk (the ragged tile edge is masked). `causal` is the
// top-left aligned tril of the forward: q row i sees keys j <= i.
//
// Two kernels and no atomics: dq is reduced over the k tiles inside one
// block, dk and dv over the q tiles inside another, each in a fixed order,
// so the gradients are bitwise the same from run to run.
//
// What bounds it on the H100: dq does three products of 2*Tq*Tk*hd
// operations per (batch, head), dk/dv four; over 67 TF/s fp32 outside the
// tensor cores (data sheet) that is about 0.1 ms at T 512 (B 8, H 8, hd
// 64), where the q/k/v/dO bytes over 3.35 TB/s take a tenth of that. These first kernels, like the forward, do not reach for the
// tensor cores: their dots are fp32 FMAs on the CUDA cores out of shared
// memory, which keeps fp32 results within 2e-5 of the plain version and
// keeps the code short; the shared-memory reads that feed each FMA are what
// bounds them. The design keeps the [Tq, Tk] probability matrix out of
// device memory, as the TPU kernels do: dq streams 64-row K/V tiles past a
// resident q/dO tile and stops at the last tile the causal diagonal reaches;
// dk/dv streams 64-row q/dO tiles past a resident K/V tile, starting at the
// first q tile that reaches the diagonal. One TF32 product on fp32
// operands keeps about 3 decimal digits, which would break the fp32
// contract; a product of split operands (x = hi + lo, three TF32 products
// summed in fp32) keeps it, which is what flash_attention_f32_sm90.cu does
// for dq and dk/dv; bf16 runs on wgmma with TMA-fed tiles
// (flash_attention_sm90.cu).

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;   // q rows per tile
constexpr int BK = 64;   // k/v rows per tile
constexpr int NT = 128;  // threads per block: two per resident row

// the element type's widening and rounding (identities for fp32)
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// p, zeroed where the (masked) score is at or below -1e30 / 2
__device__ __forceinline__ float prob(float s, bool ok, float lse) {
  const float sv = ok ? s : kNegInf;
  return sv > kNegInf * 0.5f ? expf(sv - lse) : 0.f;
}

// B5: one block per (64-row q tile, head, batch); thread pair per q row.
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kv_mask,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int H, int Tq,
    int Tk, float scale, int causal) {
  constexpr int LD = HD + 1;     // padded rows: conflict-free column reads
  constexpr int HALF = HD / 2;   // dq columns per thread
  constexpr int CPT = BK / 2;    // score columns per thread
  constexpr int LDP = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;              // [BQ][LD] scale * q, rounded to T
  float* sO = sQ + BQ * LD;      // [BQ][LD] dO
  float* sK = sO + BQ * LD;      // [BK][LD]
  float* sV = sK + BK * LD;      // [BK][LD]
  float* sS = sV + BK * LD;      // [BQ][LDP] ds of the current k tile
  __shared__ int sOk[BK];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid >> 1;        // this thread's q row within the tile
  const int half = tid & 1;      // which interleaved half of the columns
  const long rs = (long)H * HD;  // row stride of [B, T, H, hd]
  const T* qb = q + (long)b * Tq * rs + (long)h * HD;
  const T* ob = dout + (long)b * Tq * rs + (long)h * HD;
  const T* kb = k + (long)b * Tk * rs + (long)h * HD;
  const T* vb = v + (long)b * Tk * rs + (long)h * HD;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int rr = i / HD, d = i % HD;
    const int t = qt * BQ + rr;
    float x = 0.f, o = 0.f;
    if (t < Tq) {
      x = to_f(from_f<T>(to_f(qb[t * rs + d]) * scale));
      o = to_f(ob[t * rs + d]);
    }
    sQ[rr * LD + d] = x;
    sO[rr * LD + d] = o;
  }

  const int qpos = qt * BQ + r;
  const bool live = qpos < Tq;
  const long row = ((long)b * H + h) * Tq + qpos;
  const float row_lse = live ? lse[row] : 0.f;
  const float row_delta = live ? delta[row] : 0.f;
  float acc[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) acc[c] = 0.f;

  int num_k = (Tk + BK - 1) / BK;
  if (causal) num_k = min(num_k, ((qt + 1) * BQ + BK - 1) / BK);

  for (int kt = 0; kt < num_k; ++kt) {
    __syncthreads();  // every read of the previous tile is done
    for (int i = tid; i < BK * HD; i += NT) {
      const int j = i / HD, d = i % HD;
      const int t = kt * BK + j;
      float kx = 0.f, vx = 0.f;
      if (t < Tk) {
        kx = to_f(kb[t * rs + d]);
        vx = to_f(vb[t * rs + d]);
      }
      sK[j * LD + d] = kx;
      sV[j * LD + d] = vx;
    }
    if (tid < BK) {
      const int t = kt * BK + tid;
      sOk[tid] = t < Tk && (kv_mask == nullptr || kv_mask[(long)b * Tk + t] > 0);
    }
    __syncthreads();

    // scores and dO.v of row r at columns j = 2*i + half
    float s[CPT], dp[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) s[i] = dp[i] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = sQ[r * LD + d];
      const float od = sO[r * LD + d];
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int j = 2 * i + half;
        s[i] += qd * sK[j * LD + d];
        dp[i] += od * sV[j * LD + d];
      }
    }
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int j = 2 * i + half;
      const bool ok = sOk[j] && (!causal || qpos >= kt * BK + j);
      sS[r * LDP + j] = prob(s[i], ok, row_lse) * (dp[i] - row_delta);
    }
    __syncwarp();  // both threads of the row pair wrote their ds values

    // acc holds dq columns 2*c + half
    for (int j = 0; j < BK; ++j) {
      const float ds = sS[r * LDP + j];
      const float* krow = sK + j * LD + half;
#pragma unroll
      for (int c = 0; c < HALF; ++c) acc[c] += ds * krow[2 * c];
    }
  }

  if (live) {
    T* out = dq + ((long)b * Tq + qpos) * rs + (long)h * HD;
#pragma unroll
    for (int c = 0; c < HALF; ++c) out[2 * c + half] = from_f<T>(acc[c] * scale);
  }
}

// B6: one block per (64-row k tile, head, batch); thread pair per k row.
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kv_mask,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int H, int Tq, int Tk, float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int HALF = HD / 2;   // dk / dv columns per thread
  constexpr int RPT = BQ / 2;    // q rows per thread
  constexpr int LDP = BQ + 1;
  extern __shared__ float smem[];
  float* sK = smem;              // [BK][LD]
  float* sV = sK + BK * LD;      // [BK][LD]
  float* sQ = sV + BK * LD;      // [BQ][LD] scale * q, rounded to T
  float* sO = sQ + BQ * LD;      // [BQ][LD] dO
  float* sP = sO + BQ * LD;      // [BK][LDP] p of the current q tile
  float* sS = sP + BK * LDP;     // [BK][LDP] ds of the current q tile
  __shared__ float sL[BQ], sD[BQ];

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid >> 1;        // this thread's k row within the tile
  const int half = tid & 1;
  const long rs = (long)H * HD;
  const T* qb = q + (long)b * Tq * rs + (long)h * HD;
  const T* ob = dout + (long)b * Tq * rs + (long)h * HD;
  const T* kb = k + (long)b * Tk * rs + (long)h * HD;
  const T* vb = v + (long)b * Tk * rs + (long)h * HD;

  for (int i = tid; i < BK * HD; i += NT) {
    const int j = i / HD, d = i % HD;
    const int t = kt * BK + j;
    float kx = 0.f, vx = 0.f;
    if (t < Tk) {
      kx = to_f(kb[t * rs + d]);
      vx = to_f(vb[t * rs + d]);
    }
    sK[j * LD + d] = kx;
    sV[j * LD + d] = vx;
  }

  const int kpos = kt * BK + r;
  const bool kok =
      kpos < Tk && (kv_mask == nullptr || kv_mask[(long)b * Tk + kpos] > 0);
  float ak[HALF], av[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) ak[c] = av[c] = 0.f;

  const int num_q = (Tq + BQ - 1) / BQ;
  // q tiles wholly before this k tile's diagonal see none of it
  const int q_lo = causal ? (kt * BK) / BQ : 0;

  for (int qi = q_lo; qi < num_q; ++qi) {
    __syncthreads();  // every read of the previous q tile is done
    for (int i = tid; i < BQ * HD; i += NT) {
      const int rr = i / HD, d = i % HD;
      const int t = qi * BQ + rr;
      float x = 0.f, o = 0.f;
      if (t < Tq) {
        x = to_f(from_f<T>(to_f(qb[t * rs + d]) * scale));
        o = to_f(ob[t * rs + d]);
      }
      sQ[rr * LD + d] = x;
      sO[rr * LD + d] = o;
    }
    if (tid < BQ) {
      const int t = qi * BQ + tid;
      const long row = ((long)b * H + h) * Tq + t;
      sL[tid] = t < Tq ? lse[row] : 0.f;
      sD[tid] = t < Tq ? delta[row] : 0.f;
    }
    __syncthreads();

    // p of k row r against q rows i = 2*m + half
    {
      float s[RPT];
#pragma unroll
      for (int m = 0; m < RPT; ++m) s[m] = 0.f;
      for (int d = 0; d < HD; ++d) {
        const float kd = sK[r * LD + d];
#pragma unroll
        for (int m = 0; m < RPT; ++m) s[m] += sQ[(2 * m + half) * LD + d] * kd;
      }
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        const int i = 2 * m + half;
        const int qpos = qi * BQ + i;
        const bool ok = kok && qpos < Tq && (!causal || qpos >= kpos);
        sP[r * LDP + i] = prob(s[m], ok, sL[i]);
      }
    }
    // ds = p * (dO.v - delta)
    {
      float dp[RPT];
#pragma unroll
      for (int m = 0; m < RPT; ++m) dp[m] = 0.f;
      for (int d = 0; d < HD; ++d) {
        const float vd = sV[r * LD + d];
#pragma unroll
        for (int m = 0; m < RPT; ++m) dp[m] += sO[(2 * m + half) * LD + d] * vd;
      }
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        const int i = 2 * m + half;
        sS[r * LDP + i] = sP[r * LDP + i] * (dp[m] - sD[i]);
      }
    }
    __syncwarp();  // both threads of the row pair wrote their p and ds

    // ak / av hold dk / dv columns 2*c + half
    for (int i = 0; i < BQ; ++i) {
      const float p = sP[r * LDP + i];
      const float ds = sS[r * LDP + i];
      const float* orow = sO + i * LD + half;
      const float* qrow = sQ + i * LD + half;
#pragma unroll
      for (int c = 0; c < HALF; ++c) {
        av[c] += p * orow[2 * c];
        ak[c] += ds * qrow[2 * c];
      }
    }
  }

  if (kpos < Tk) {
    const long off = ((long)b * Tk + kpos) * rs + (long)h * HD;
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      dk[off + 2 * c + half] = from_f<T>(ak[c]);
      dv[off + 2 * c + half] = from_f<T>(av[c]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* kv_mask, const void* dout, const void* lse,
                      const void* delta, void* dq, int B, int H, int Tq,
                      int Tk, float scale, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (4 * BQ * (HD + 1) + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_dq_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_mask),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), H, Tq, Tk,
      scale, causal);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* kv_mask, const void* dout, const void* lse,
                       const void* delta, void* dk, void* dv, int B, int H,
                       int Tq, int Tk, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (4 * BK * (HD + 1) + 2 * BK * (BQ + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + BK - 1) / BK, H, B);
  flash_dkv_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_mask),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pt_flash_dq(const void* q, const void* k, const void* v,
                           const void* kv_mask, const void* dout,
                           const void* lse, const void* delta, void* dq,
                           int B, int H, int Tq, int Tk, int hd, float scale,
                           int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_DQ(HD)                                                             \
  launch_dq<float, HD>(q, k, v, kv_mask, dout, lse, delta, dq, B, H, Tq, Tk, \
                       scale, causal, st)
  if (hd == 64) return PT_DQ(64);
  if (hd == 128) return PT_DQ(128);
#undef PT_DQ
  return (int)cudaErrorInvalidValue;
}

extern "C" int pt_flash_dkv(const void* q, const void* k, const void* v,
                            const void* kv_mask, const void* dout,
                            const void* lse, const void* delta, void* dk,
                            void* dv, int B, int H, int Tq, int Tk, int hd,
                            float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_DKV(HD)                                                            \
  launch_dkv<float, HD>(q, k, v, kv_mask, dout, lse, delta, dk, dv, B, H, Tq, \
                        Tk, scale, causal, st)
  if (hd == 64) return PT_DKV(64);
  if (hd == 128) return PT_DKV(128);
#undef PT_DKV
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
