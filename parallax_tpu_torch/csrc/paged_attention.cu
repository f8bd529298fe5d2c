// Paged-KV decode attention for Hopper (sm_90a), split over the cache.
//
// Replaces the TPU kernel `_paged_attn_kernel` of
// parallax_tpu/ops/pallas_paged_attention.py (launched by `_kernel_call`,
// its pl.pallas_call at line 278). Same function:
//   * q [S, G, D], pools [pool, page_size, D], pages [S, P] int32,
//     pos [S, G] int32 -> out [S, G, D], D = num_heads * hd;
//   * a page id outside [0, pool_pages) (the sentinel) is masked by PAGE:
//     the kernel never reads it (the pool may carry spare pages past
//     pool_pages that sentinel writes land in);
//   * query g sees positions <= pos[s, g];
//   * scores are the fp32 dot DIVIDED by sqrt(hd) after the dot, PV uses
//     fp32 p, and a query with no live visible position returns exact
//     zeros (acc = 0, l = 0 -> 0 / max(l, 1e-30)), never NaN.
// fp32 and bf16 inputs, hd in {64, 128}, 1 <= G <= 4, any page size, any P.
//
// What bounds it on the H100: each visible K/V row is read once (4 hd
// bytes a head in bf16) for G * 4 hd operations, so G operations a byte,
// far below the ~295 at which the tensor cores would bind. The bound is
// device-memory bandwidth (3.35 TB/s, data sheet) over the live, visible K/V
// bytes (`kernel_hbm_bytes`). What a kernel needs for that: many bytes in
// flight, 16-byte coalesced loads, and enough blocks to fill 132 SMs when
// the slots are few or short.
//
// Design (flash-decoding over a page table):
//   * Work split. The grid is (H / HB, S, NSPLIT): a block takes one slot,
//     a group of HB heads whose row segment is 256 contiguous bytes in
//     bf16 (hd 64 -> HB 2, hd 128 -> HB 1; HB 1 in fp32 and for an odd
//     head count), and one range of `range` positions.
//     ops/paged_attention.py's `split_plan` picks HB, NSPLIT and the range
//     from the shapes alone (no host read of pos or pages). A block whose
//     range starts past its slot's frontier (max_g pos[s, g], read here on
//     the device) writes "empty" (l = 0) and exits.
//   * Page ids once. Each block loads its range's page ids into shared
//     memory before any K/V load, so no K/V load waits on a page-id load.
//   * Loads. 16-byte `cp.async.cg` copies (LDGSTS) fill a ring of NS = 3
//     chunk stages (CH = 32 positions of K and of V over the block's HB hd
//     columns), kept in the input dtype and widened in registers. A row
//     past the range end or in a sentinel page is zero-filled without a
//     global read. Every stage commits a group, empty or not, so the
//     wait_group count holds on ragged tails. No TMA: a box would have to
//     divide the page size (1 and 12 are taken), and a tensor map a call
//     would add host time to a host-bound loop.
//   * Math on the CUDA cores in fp32. 16 lanes (a half warp, "sub-warp")
//     take one position's row segment, each lane EPL = HB hd / 16 elements
//     of it and of the G queries (in registers); a head's dot is a
//     shuffle reduction over its 16 / HB lanes. The NSW sub-warps (16 in
//     bf16, 8 in fp32) take the chunk's positions j = NSW i + sub-warp, and
//     each keeps its own online softmax (m, l, acc) per query and head,
//     updated once a chunk; at the end the sub-warps merge in shared memory
//     in sub-warp order. The queries are a template parameter, so G = 1
//     holds no registers for four.
//   * Cross-split merge. With NSPLIT > 1 each block writes fp32 (acc[hd],
//     m, l) per (g, head) into a workspace [S, NSPLIT, G, H, hd + 2], and
//     `paged_combine_kernel` (one block per slot and head group) merges the
//     splits in split order, skipping those with l = 0. No atomics: the
//     result is bitwise repeatable.
// tests/test_torch_paged_attention.py emulates this arithmetic on the CPU
// (split ranges, sub-warp partials in order, splits in order) against the
// JAX kernel and the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int CH = 32;          // positions a chunk
constexpr int NS = 3;           // chunk stages in the ring
constexpr int GMAX = 4;         // most queries a slot
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// EPL consecutive elements at p (aligned to their size), widened to fp32
template <int EPL>
__device__ __forceinline__ void load_f(const float* p, float (&x)[EPL]) {
  static_assert(EPL % 4 == 0, "fp32 rows load as float4");
#pragma unroll
  for (int i = 0; i < EPL; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    x[i] = v.x;
    x[i + 1] = v.y;
    x[i + 2] = v.z;
    x[i + 3] = v.w;
  }
}
template <int EPL>
__device__ __forceinline__ void load_f(const __nv_bfloat16* p,
                                       float (&x)[EPL]) {
  static_assert(EPL == 4 || EPL == 8, "bf16 rows load as 8 or 16 bytes");
  uint32_t w[EPL / 2];
  if constexpr (EPL == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  }
#pragma unroll
  for (int i = 0; i < EPL / 2; ++i) {   // element 2i is the low half
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16 bytes global -> shared; with valid false, 16 zero bytes and no read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x / d, correctly rounded for normal operands, from rd = 1 / d rounded:
// the fast path of the IEEE division, inline (its slow path, for
// denormals and infinities, is a call that would spill the accumulators)
__device__ __forceinline__ float div_rn(float x, float d, float rd) {
  const float q = x * rd;
  return fmaf(fmaf(-q, d, x), rd, q);
}

// n / d for 0 <= n < 2^31 as a multiply-high and a shift (d >= 1; the
// multiplier and shift come from the host, `make_divider`)
struct Divider {
  int d;
  unsigned mul;
  int shift;
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)(__umulhi((unsigned)n, mul) >> shift);
  }
};

Divider make_divider(int d) {
  Divider r{d, 0u, 0};
  if (d > 1) {
    int p = 0;                                    // ceil(log2 d)
    while ((1ll << p) < d) ++p;
    r.mul = (unsigned)(((1ull << (31 + p)) + d - 1) / d);
    r.shift = p - 1;
  }
  return r;
}

template <typename T, int HD, int HB>
struct Shape {
  // threads a block: 8 warps in bf16, enough to hide the arithmetic of
  // G = 3 queries behind the loads; 4 in fp32, where 8 ran slower
  static constexpr int NT = sizeof(T) == 2 ? 256 : 128;
  static constexpr int NSW = NT / 16;                 // sub-warps of 16 lanes
  static constexpr int PPS = CH / NSW;                // a sub-warp's positions
  static constexpr int RBE = HB * HD;                 // a row segment
  static constexpr int RB16 = RBE * (int)sizeof(T) / 16;  // 16-byte pieces
  static constexpr int EPL = RBE / 16;                // elements a lane holds
  static constexpr int LPH = HD / EPL;                // lanes of one head
  static constexpr int STAGE = 2 * CH * RBE;          // K then V, elements
  static constexpr size_t RING = (size_t)NS * STAGE * sizeof(T);
  // the sub-warps' partials, written over the ring after the last chunk
  static constexpr size_t MERGE =
      sizeof(float) * ((size_t)NSW * GMAX * RBE + 2 * NSW * GMAX * HB);
  static_assert(MERGE <= RING, "partials fit in the ring");
  static_assert(CH * RB16 % NT == 0, "the threads share a chunk's copies");
};

// grid (H / HB, S, nsplit): the head groups of one slot and range run side
// by side, so the whole rows they read leave the memory together. The
// minimum of one block an SM lets ptxas take the registers it needs: with
// no minimum it spilled a few in two instantiations to fit more blocks.
template <typename T, int HD, int HB, int G>
__global__ void __launch_bounds__(Shape<T, HD, HB>::NT, 1)
paged_decode_kernel_sm90(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ pages,
    const int* __restrict__ pos, T* __restrict__ out, float* __restrict__ ws,
    int H, int P, Divider page, int pool_pages, int range, float sqrt_hd,
    float inv_sqrt_hd) {
  using Sh = Shape<T, HD, HB>;
  constexpr int RBE = Sh::RBE, RB16 = Sh::RB16, EPL = Sh::EPL;
  constexpr int LPH = Sh::LPH, STAGE = Sh::STAGE;
  constexpr int NT = Sh::NT, NSW = Sh::NSW, PPS = Sh::PPS;
  constexpr int PIECE = 16 / (int)sizeof(T);          // elements a copy
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);               // [NS][2][CH][RBE]
  int* sPage = reinterpret_cast<int*>(smem + Sh::RING);

  const int h0 = blockIdx.x * HB, s = blockIdx.y, split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int D = H * HD;
  const int ps = page.d;
  const int tid = threadIdx.x;
  const int sw = tid >> 4;                            // sub-warp
  const int li = tid & 15;                            // lane in it
  const int hl = li / LPH;                            // its head in the group
  const int col = li * EPL;                           // its first element

  int qpos[G];
  int frontier = -1;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    qpos[g] = pos[(long)s * G + g];
    frontier = max(frontier, qpos[g]);
  }
  // positions [t0, t_end) are this block's that some query sees
  const int t0 = split * range;
  const int t_end = min(min(t0 + range, frontier + 1), P * ps);
  if (t0 >= t_end) {
    if (nsplit == 1) {
      for (int i = tid; i < G * RBE; i += NT)
        out[((long)s * G + i / RBE) * D + h0 * HD + i % RBE] =
            from_f<T>(0.f);
    } else if (tid < G * HB) {
      float* w = ws + ((((long)s * nsplit + split) * G + tid / HB) * H + h0 +
                       tid % HB) * (HD + 2);
      w[HD] = kNegInf;
      w[HD + 1] = 0.f;
    }
    return;
  }
  const int slot0 = page.div(t0);
  const int npg = page.div(t_end - 1) + 1 - slot0;
  for (int i = tid; i < npg; i += NT) sPage[i] = pages[(long)s * P + slot0 + i];
  __syncthreads();

  const int nch = (t_end - t0 + CH - 1) / CH;
  // chunk c's K and V rows into stage c % NS; one commit group either way
  auto issue = [&](int c) {
    if (c < nch) {
      T* dst = ring + (c % NS) * STAGE;
      const int cs = t0 + c * CH;
#pragma unroll
      for (int k = 0; k < CH * RB16 / NT; ++k) {
        const int i = tid + k * NT;
        const int j = i / RB16, piece = i % RB16;
        const int t = cs + j;
        long off = 0;
        bool valid = false;
        if (t < t_end) {
          const int slot = page.div(t);
          const int id = sPage[slot - slot0];
          valid = id >= 0 && id < pool_pages;
          if (valid)
            off = ((long)id * ps + (t - slot * ps)) * D + h0 * HD +
                  piece * PIECE;
        }
        T* row = dst + j * RBE + piece * PIECE;
        cp_async16(row, k_pool + off, valid);
        cp_async16(row + CH * RBE, v_pool + off, valid);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int c = 0; c < NS - 1; ++c) issue(c);
  float qf[G][EPL], acc[G][EPL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
    load_f<EPL>(q + ((long)s * G + g) * D + h0 * HD + col, qf[g]);
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int c = 0; c < nch; ++c) {
    cp_async_wait<NS - 2>();   // this thread's copies of chunk c landed
    __syncthreads();           // everyone's; and chunk c - 1 is read
    issue(c + NS - 1);         // into chunk c - 1's stage
    const T* sK = ring + (c % NS) * STAGE;
    const T* sV = sK + CH * RBE;
    const int cs = t0 + c * CH;
    float p[PPS][G];
#pragma unroll
    for (int i = 0; i < PPS; ++i) {
      const int t = cs + i * NSW + sw;
      bool live = false;
      if (t < t_end) {
        const int id = sPage[page.div(t) - slot0];
        live = id >= 0 && id < pool_pages;
      }
      float kx[EPL];
      load_f<EPL>(sK + (i * NSW + sw) * RBE + col, kx);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        // two interleaved partial sums halve the dependent chain
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; e += 2) {
          d0 = fmaf(qf[g][e], kx[e], d0);
          d1 = fmaf(qf[g][e + 1], kx[e + 1], d1);
        }
        float dot = d0 + d1;
#pragma unroll
        for (int o = LPH / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(kFull, dot, o);
        p[i][g] = live && t <= qpos[g] ? div_rn(dot, sqrt_hd, inv_sqrt_hd)
                                       : kNegInf;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int i = 0; i < PPS; ++i) mx = fmaxf(mx, p[i][g]);
      const float alpha = expf(m[g] - mx);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < PPS; ++i) {
        p[i][g] = p[i][g] > kNegInf * 0.5f ? expf(p[i][g] - mx) : 0.f;
        psum += p[i][g];
      }
      l[g] = l[g] * alpha + psum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < PPS; ++i) {
      float vx[EPL];
      load_f<EPL>(sV + (i * NSW + sw) * RBE + col, vx);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[g][e] = fmaf(p[i][g], vx[e], acc[g][e]);
    }
  }

  // merge the sub-warps' partials, in sub-warp order, over the ring
  cp_async_wait<0>();
  __syncthreads();
  float* sAcc = reinterpret_cast<float*>(smem);       // [NSW][G][RBE]
  float* sM = sAcc + NSW * G * RBE;                   // [NSW][G][HB]
  float* sL = sM + NSW * G * HB;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      sAcc[(sw * G + g) * RBE + col + e] = acc[g][e];
    if (li % LPH == 0) {
      sM[(sw * G + g) * HB + hl] = m[g];
      sL[(sw * G + g) * HB + hl] = l[g];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * RBE; i += NT) {
    const int g = i / RBE, c = i % RBE, hh = c / HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < NSW; ++w) M = fmaxf(M, sM[(w * G + g) * HB + hh]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NSW; ++w) {
      const float mw = sM[(w * G + g) * HB + hh];
      if (mw > kNegInf * 0.5f) {
        const float e = expf(mw - M);
        L += sL[(w * G + g) * HB + hh] * e;
        A += sAcc[(w * G + g) * RBE + c] * e;
      }
    }
    if (nsplit == 1) {
      // A / max(L, 1e-30): a reciprocal and one correction, inline (A = 0
      // gives exact zeros)
      const float d = fmaxf(L, 1e-30f);
      out[((long)s * G + g) * D + h0 * HD + c] =
          from_f<T>(div_rn(A, d, __fdividef(1.f, d)));
    } else {
      float* w = ws + ((((long)s * nsplit + split) * G + g) * H + h0 + hh) *
                          (HD + 2);
      w[c % HD] = A;
      if (c % HD == 0) {
        w[HD] = M;
        w[HD + 1] = L;
      }
    }
  }
}

// out[s, g, h] from the nsplit partials (acc, m, l), merged in split order;
// a split with l = 0 saw no visible position and adds nothing
template <typename T, int HD, int HB>
__global__ void paged_combine_kernel(const float* __restrict__ ws,
                                     T* __restrict__ out, int G, int H,
                                     int nsplit) {
  const int i = threadIdx.x, s = blockIdx.y;
  const int g = i / (HB * HD), hh = (i / HD) % HB, d = i % HD;
  const int h = blockIdx.x * HB + hh;
  const long stride = (long)G * H * (HD + 2);        // one split
  const float* w = ws + (((long)s * nsplit * G + g) * H + h) * (HD + 2);
  float M = kNegInf;
  for (int sp = 0; sp < nsplit; ++sp) M = fmaxf(M, w[sp * stride + HD]);
  float L = 0.f, A = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) {
    const float* ws_sp = w + sp * stride;
    const float lsp = ws_sp[HD + 1];
    if (lsp > 0.f) {
      const float e = expf(ws_sp[HD] - M);
      L += lsp * e;
      A += ws_sp[d] * e;
    }
  }
  out[((long)s * G + g) * H * HD + h * HD + d] =
      from_f<T>(A / fmaxf(L, 1e-30f));
}

template <typename T, int HD, int HB, int G>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* pages, const void* pos, void* out, void* ws,
                   int S, int H, int P, int page_size, int pool_pages,
                   int nsplit, int range, float sqrt_hd,
                   cudaStream_t stream) {
  using Sh = Shape<T, HD, HB>;
  auto kernel = paged_decode_kernel_sm90<T, HD, HB, G>;
  // the most page ids a range of `range` positions touches
  const int span = (range + page_size - 1) / page_size + 1;
  const int npg = span < P ? span : P;
  const size_t smem = Sh::RING + sizeof(int) * (size_t)npg;
  // the dynamic shared-memory limit, raised once a device as far as needed
  static size_t limit[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || smem > limit[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) limit[dev] = smem;
  }
  const dim3 grid(H / HB, S, nsplit);
  kernel<<<grid, Sh::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(pages),
      static_cast<const int*>(pos), static_cast<T*>(out),
      static_cast<float*>(ws), H, P, make_divider(page_size), pool_pages,
      range, sqrt_hd, (float)(1.0 / (double)sqrt_hd));
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  paged_combine_kernel<T, HD, HB><<<dim3(H / HB, S), G * HB * HD, 0,
                                    stream>>>(static_cast<const float*>(ws),
                                              static_cast<T*>(out), G, H,
                                              nsplit);
  return cudaGetLastError();
}

template <typename T, int HD, int HB>
cudaError_t launch_g(int G, const void* q, const void* k_pool,
                     const void* v_pool, const void* pages, const void* pos,
                     void* out, void* ws, int S, int H, int P, int page_size,
                     int pool_pages, int nsplit, int range, float sqrt_hd,
                     cudaStream_t st) {
#define PT_ARGS                                                             \
  q, k_pool, v_pool, pages, pos, out, ws, S, H, P, page_size, pool_pages, \
      nsplit, range, sqrt_hd, st
  switch (G) {
    case 1: return launch<T, HD, HB, 1>(PT_ARGS);
    case 2: return launch<T, HD, HB, 2>(PT_ARGS);
    case 3: return launch<T, HD, HB, 3>(PT_ARGS);
    case 4: return launch<T, HD, HB, 4>(PT_ARGS);
  }
#undef PT_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

// hb: heads a block (split_plan); nsplit: position ranges a slot, each of
// `range` positions; ws: fp32 [S, nsplit, G, H, hd + 2] when nsplit > 1
extern "C" int pt_paged_decode(const void* q, const void* k_pool,
                               const void* v_pool, const void* pages,
                               const void* pos, void* out, void* ws, int S,
                               int G, int H, int hd, int P, int page_size,
                               int pool_pages, int hb, int nsplit, int range,
                               float sqrt_hd, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > GMAX || nsplit < 1 || range < 1 || page_size < 1 ||
      H % hb || (nsplit > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
#define PT_ARGS                                                              \
  G, q, k_pool, v_pool, pages, pos, out, ws, S, H, P, page_size, pool_pages, \
      nsplit, range, sqrt_hd, st
  if (is_bf16) {
    if (hd == 64 && hb == 2) return launch_g<__nv_bfloat16, 64, 2>(PT_ARGS);
    if (hd == 64 && hb == 1) return launch_g<__nv_bfloat16, 64, 1>(PT_ARGS);
    if (hd == 128 && hb == 1) return launch_g<__nv_bfloat16, 128, 1>(PT_ARGS);
  } else {
    if (hd == 64 && hb == 1) return launch_g<float, 64, 1>(PT_ARGS);
    if (hd == 128 && hb == 1) return launch_g<float, 128, 1>(PT_ARGS);
  }
#undef PT_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
