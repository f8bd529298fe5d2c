// Paged-KV decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_attn_kernel` of
// parallax_tpu/ops/pallas_paged_attention.py (launched by `_kernel_call`,
// its pl.pallas_call at line 278). Same function:
//   * q [S, G, D], pools [pool, page_size, D], pages [S, P] int32,
//     pos [S, G] int32 -> out [S, G, D], D = num_heads * hd;
//   * a page id >= pool_pages (the sentinel) is masked by PAGE: the
//     kernel never reads it (the pool may carry spare pages past
//     pool_pages that sentinel writes land in);
//   * query g sees positions <= pos[s, g];
//   * scores are the fp32 dot DIVIDED by sqrt(hd) after the dot, PV uses
//     fp32 p, and a query with no live visible position returns exact
//     zeros (acc = 0, l = 0 -> 0 / max(l, 1e-30)), never NaN.
// fp32 and bf16 inputs, hd in {64, 128}, 1 <= G <= 4.
//
// What bounds it on the H100: decode attention reads each visible K/V
// row once (4*hd bytes per head in bf16) and does 4*hd operations on it
// per query, so G operations per byte, far below the ~295 at which the
// tensor cores would bind; the bound is device-memory bandwidth
// (3.35 TB/s, data sheet) over the live K/V bytes (`kernel_hbm_bytes`).
//
// Design: the TPU kernel ran every head over the full D width with
// head-masked operands to satisfy Mosaic's tiling rule; Hopper has no
// such rule, so one block per (slot, head) reads only its own hd-wide
// slice of each live K/V row and never spends the num_heads-times MACs.
// The block reads its page row and positions, walks positions only up to
// max_g pos[s, g] (pages past the frontier are never touched, sentinel
// pages are skipped), stages 128 positions of K/V at a time in shared
// memory (any page size: a chunk may span several pages), and keeps the
// online softmax per query. Loads are plain scalar ones, each behind its
// page-id load, without a copy pipeline: the kernel is latency-bound,
// not bandwidth-bound (it takes the same time in fp32 and bf16).
// Vectorised loads and overlapping the next chunk's loads with this
// chunk's math (cp.async or TMA) are the later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int NT = 128;    // threads per block
constexpr int CH = NT;     // positions staged per chunk: one per thread
constexpr int GMAX = 4;    // most queries per slot
constexpr int NW = NT / 32;

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ pages,
    const int* __restrict__ pos, T* __restrict__ out, int G, int D, int P,
    int page_size, int pool_pages, float sqrt_hd) {
  constexpr int LDK = HD + 1;      // padded rows: conflict-free row dots
  constexpr int NPART = NT / HD;   // threads sharing one output column
  extern __shared__ float smem[];
  float* sK = smem;                // [CH][LDK]
  float* sV = sK + CH * LDK;       // [CH][HD]
  float* sQ = sV + CH * HD;        // [GMAX][HD]
  float* sP = sQ + GMAX * HD;      // [GMAX][CH]
  float* sAcc = sP + GMAX * CH;    // [NPART][GMAX][HD]
  __shared__ float sMax[GMAX][NW];
  __shared__ float sSum[GMAX][NW];
  __shared__ int sPos[GMAX];

  const int s = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* prow = pages + (long)s * P;

  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    sQ[g * HD + d] = to_f(q[((long)s * G + g) * D + h * HD + d]);
  }
  if (tid < G) sPos[tid] = pos[(long)s * G + tid];
  __syncthreads();
  int maxpos = -1;
  for (int g = 0; g < G; ++g) maxpos = max(maxpos, sPos[g]);
  // positions [0, limit) are the only ones any query of this slot sees
  const int limit = min(maxpos + 1, P * page_size);

  float m[GMAX], l[GMAX], acc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
    acc[g] = 0.f;
  }
  const int col = tid % HD, part = tid / HD;

  for (int c0 = 0; c0 < limit; c0 += CH) {
    __syncthreads();  // every read of the previous chunk is done
    for (int i = tid; i < CH * HD; i += NT) {
      const int j = i / HD, d = i % HD;
      const int t = c0 + j;
      float kx = 0.f, vx = 0.f;
      if (t < limit) {
        const int page = prow[t / page_size];
        if (page >= 0 && page < pool_pages) {
          const long off = ((long)page * page_size + t % page_size) * D +
                           h * HD + d;
          kx = to_f(k_pool[off]);
          vx = to_f(v_pool[off]);
        }
      }
      sK[j * LDK + d] = kx;
      sV[j * HD + d] = vx;
    }
    __syncthreads();

    // this thread's position in the chunk
    const int t = c0 + tid;
    bool live = false;
    if (t < limit) {
      const int page = prow[t / page_size];
      live = page >= 0 && page < pool_pages;
    }
    float sc[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      sc[g] = kNegInf;
      if (g < G) {
        float dot = 0.f;
        for (int d = 0; d < HD; ++d) dot += sQ[g * HD + d] * sK[tid * LDK + d];
        if (live && t <= sPos[g]) sc[g] = dot / sqrt_hd;
        const float mx = warp_max(sc[g]);
        if (lane == 0) sMax[g][warp] = mx;
      }
    }
    __syncthreads();
    float alpha[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      alpha[g] = 1.f;
      if (g < G) {
        float mc = sMax[g][0];
#pragma unroll
        for (int w = 1; w < NW; ++w) mc = fmaxf(mc, sMax[g][w]);
        const float m_new = fmaxf(m[g], mc);
        alpha[g] = expf(fminf(m[g] - m_new, 0.f));
        const float p = sc[g] > kNegInf * 0.5f ? expf(sc[g] - m_new) : 0.f;
        sP[g * CH + tid] = p;
        const float ps = warp_sum(p);
        if (lane == 0) sSum[g][warp] = ps;
        m[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) sum += sSum[g][w];
        l[g] = l[g] * alpha[g] + sum;
        acc[g] *= alpha[g];
      }
    }
    for (int j = part; j < CH; j += NPART) {
      const float vv = sV[j * HD + col];
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) acc[g] += sP[g * CH + j] * vv;
    }
  }

  // the NPART threads of one column each hold a partial sum over
  // positions; every partial was rescaled by the same alphas
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G) sAcc[(part * GMAX + g) * HD + col] = acc[g];
  __syncthreads();
  if (part == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        float total = 0.f;
#pragma unroll
        for (int pp = 0; pp < NPART; ++pp) total += sAcc[(pp * GMAX + g) * HD + col];
        out[((long)s * G + g) * D + h * HD + col] =
            from_f<T>(total / fmaxf(l[g], 1e-30f));
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* pages, const void* pos, void* out, int S,
                   int G, int H, int P, int page_size, int pool_pages,
                   float sqrt_hd, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (CH * (HD + 1) + CH * HD + GMAX * HD +
                                       GMAX * CH + NT * GMAX);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S, H);
  paged_decode_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(pages),
      static_cast<const int*>(pos), static_cast<T*>(out), G, H * HD, P,
      page_size, pool_pages, sqrt_hd);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pt_paged_decode(const void* q, const void* k_pool,
                               const void* v_pool, const void* pages,
                               const void* pos, void* out, int S, int G,
                               int H, int hd, int P, int page_size,
                               int pool_pages, float sqrt_hd, int is_bf16,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > GMAX) return (int)cudaErrorInvalidValue;
  if (hd == 64) {
    return is_bf16
               ? launch<__nv_bfloat16, 64>(q, k_pool, v_pool, pages, pos, out,
                                           S, G, H, P, page_size, pool_pages,
                                           sqrt_hd, st)
               : launch<float, 64>(q, k_pool, v_pool, pages, pos, out, S, G,
                                   H, P, page_size, pool_pages, sqrt_hd, st);
  }
  if (hd == 128) {
    return is_bf16
               ? launch<__nv_bfloat16, 128>(q, k_pool, v_pool, pages, pos,
                                            out, S, G, H, P, page_size,
                                            pool_pages, sqrt_hd, st)
               : launch<float, 128>(q, k_pool, v_pool, pages, pos, out, S, G,
                                    H, P, page_size, pool_pages, sqrt_hd, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
