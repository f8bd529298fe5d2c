// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_fwd_kernel` of
// parallax_tpu/ops/pallas_attention.py (launched by `_flash_forward`,
// its pl.pallas_call at line 141). Same function, same rounding points:
//   * q is multiplied by `scale` in the input dtype before the dot;
//   * QK^T and PV accumulate in fp32 and p stays fp32;
//   * masked scores (kv_mask == 0, causal k > q, ragged tile edge) are
//     set to -1e30 and their probabilities zeroed after the exp;
//   * a fully masked row yields out = 0 and lse = m + log(1e-30).
// Inputs and output keep the public [B, T, H, hd] layout (the kernel
// walks the strides, so no transpose is materialised); lse is
// [B, H, Tq] fp32. fp32 inputs, hd in {64, 128}, any Tq / Tk. This first
// kernel is off the route: fp32 runs the split-operand TF32 tensor-core
// forward of flash_attention_f32_sm90.cu, bf16 the wgmma kernel of
// flash_attention_sm90.cu; it stays as the earlier time of the fp32 rows.
//
// What bounds it on the H100: the q/k/v/out bytes over 3.35 TB/s and the
// 4*B*H*Tq*Tk*hd operations over 989 TF/s bf16 (data sheet) are close at
// T = 512, B = H = 8, hd = 64 (about 5 and 4 us), and the bytes bound the
// serving shape (one 64-token source); either way the bound is a few
// microseconds. This first kernel does not reach for the tensor cores:
// it runs its dots as fp32 FMAs on the CUDA cores out of shared memory,
// and that is what bounds it. One TF32 tensor-core product would break
// the 2e-5 the fp32 results are held to; a product of split operands
// (x = hi + lo, three TF32 products) does not, which is how
// flash_attention_f32_sm90.cu keeps fp32 on the tensor cores. The design
// keeps the [Tq, Tk] score matrix out
// of device memory, as the TPU kernel does: one block per
// (64-row q tile, head, batch) stages its q tile once, then streams
// 64-row K/V tiles through shared memory with the online softmax held in
// registers, and skips K tiles wholly past the causal diagonal. The bf16
// forward runs on wgmma with TMA-fed tiles (flash_attention_sm90.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // k/v rows per streamed tile
constexpr int NT = 128;  // threads per block: two per q row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kv_mask,
    T* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk,
    float scale, int causal) {
  constexpr int LD = HD + 1;     // padded rows: conflict-free column reads
  constexpr int HALF = HD / 2;   // output columns per thread
  constexpr int CPT = BK / 2;    // score columns per thread
  constexpr int LDP = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;              // [BQ][LD]
  float* sK = sQ + BQ * LD;      // [BK][LD]
  float* sV = sK + BK * LD;      // [BK][HD]
  float* sP = sV + BK * HD;      // [BQ][LDP]
  __shared__ int sOk[BK];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid >> 1;        // this thread's q row within the tile
  const int half = tid & 1;      // which interleaved half of the columns
  const long row_stride = (long)H * HD;
  const T* qb = q + (long)b * Tq * row_stride + (long)h * HD;
  const T* kb = k + (long)b * Tk * row_stride + (long)h * HD;
  const T* vb = v + (long)b * Tk * row_stride + (long)h * HD;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int rr = i / HD, d = i % HD;
    const int t = qt * BQ + rr;
    float x = 0.f;
    if (t < Tq) x = to_f(from_f<T>(to_f(qb[t * row_stride + d]) * scale));
    sQ[rr * LD + d] = x;
  }

  const int qpos = qt * BQ + r;
  float m = kNegInf, l = 0.f;
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
        kx = to_f(kb[t * row_stride + d]);
        vx = to_f(vb[t * row_stride + d]);
      }
      sK[j * LD + d] = kx;
      sV[j * HD + d] = vx;
    }
    if (tid < BK) {
      const int t = kt * BK + tid;
      sOk[tid] = t < Tk && (kv_mask == nullptr || kv_mask[(long)b * Tk + t] > 0);
    }
    __syncthreads();

    // scores of row r at columns j = 2*i + half
    float s[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) s[i] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = sQ[r * LD + d];
#pragma unroll
      for (int i = 0; i < CPT; ++i) s[i] += qd * sK[(2 * i + half) * LD + d];
    }
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int j = 2 * i + half;
      const bool ok = sOk[j] && (!causal || qpos >= kt * BK + j);
      s[i] = ok ? s[i] : kNegInf;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(fminf(m - m_new, 0.f));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const float p = s[i] > kNegInf * 0.5f ? expf(s[i] - m_new) : 0.f;
      sum += p;
      sP[r * LDP + 2 * i + half] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();  // both threads of the row pair wrote their p values

    // acc holds output columns 2*c + half
#pragma unroll
    for (int c = 0; c < HALF; ++c) acc[c] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = sP[r * LDP + j];
      const float* vrow = sV + j * HD + half;
#pragma unroll
      for (int c = 0; c < HALF; ++c) acc[c] += p * vrow[2 * c];
    }
  }

  if (qpos < Tq) {
    const float denom = fmaxf(l, 1e-30f);
    T* ob = out + ((long)b * Tq + qpos) * row_stride + (long)h * HD;
#pragma unroll
    for (int c = 0; c < HALF; ++c) ob[2 * c + half] = from_f<T>(acc[c] / denom);
    if (half == 0) lse[((long)b * H + h) * Tq + qpos] = m + logf(denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_mask, void* out, void* lse, int B, int H,
                   int Tq, int Tk, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_mask),
      static_cast<T*>(out), static_cast<float*>(lse), H, Tq, Tk, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v,
                            const void* kv_mask, void* out, void* lse, int B,
                            int H, int Tq, int Tk, int hd, float scale,
                            int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<float, 64>(q, k, v, kv_mask, out, lse, B, H, Tq, Tk, scale,
                             causal, st);
  if (hd == 128)
    return launch<float, 128>(q, k, v, kv_mask, out, lse, B, H, Tq, Tk,
                              scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
