// fp32 flash attention for Hopper (sm_90a) on the tensor cores: the
// forward and dk/dv as split-operand (3xTF32) mma.sync products.
//
// Replaces two TPU kernels of parallax_tpu/ops/pallas_attention.py for
// fp32 inputs:
//   * pt_flash_fwd_tf32x3 <- `_flash_fwd_kernel` (its pl.pallas_call at
//     line 141, launched by `_flash_forward`);
//   * pt_flash_dkv_tf32x3 <- `_flash_dkv_kernel` (its pl.pallas_call at
//     line 326, launched by `_flash_backward`).
// Same function, same rounding points as the plain versions of
// ops/flash_attention.py:
//   * q is multiplied by `scale` in fp32 before every product;
//   * every product accumulates in fp32, p and ds stay fp32;
//   * masked scores (kv_mask == 0, causal k > q, the ragged tile edge) are
//     set to -1e30 and p is zeroed where the score is at or below
//     -1e30 / 2: a fully masked row gives out = 0, lse = m + log(1e-30)
//     and zero gradients;
//   * the forward gives out and lse [B, H, Tq]; dk/dv recompute
//     p = exp(s - lse), take ds = p * (dO.v - delta) with delta from the
//     caller (the lse cotangent already folded in), and write
//     dv = sum_q p.dO and dk = sum_q ds.(scale q), unscaled.
// Inputs and outputs keep the public [B, T, H, hd] layout; hd 64 or 128,
// any Tq / Tk, `causal` the top-left aligned tril. bf16 runs
// flash_attention_sm90.cu; fp32 dq runs the first kernel of
// flash_attention_bwd.cu.
//
// Why the split product keeps the fp32 contract. One TF32 product rounds
// each operand to 10 mantissa bits, about 5e-4 relative, which moves
// attention at unit-normal inputs by 2e-4 to 2e-3: 10 to 100 times the
// 2e-5 the fp32 kernels are held to. Splitting each operand as
// x = hi + lo, hi = tf32(x), lo = tf32(x - hi), and summing
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi drops only a_lo.b_lo and lo's own
// rounding, about 2^-22 relative: as close to float64 as an fp32 dot
// product is (tests/test_torch_flash_fp32_split.py emulates both on the
// CPU). The two small cross terms go in before hi.hi. The rounding is
// cvt.rna.tf32.f32's (nearest, ties away from zero), written as two
// integer operations: bit for bit the same on finite values, and faster
// than the instruction, which the compiler expands with its NaN and
// infinity cases. One more source of error is the tensor core's own: it
// truncates each sum it writes, so a long running sum fed by mma directly
// drifts toward zero (dv past 2e-5 of its peak at T 2048 causal). Every
// product that feeds a running sum (the output, dk, dv) is therefore
// summed from zero into a temporary and added to the running sum in fp32
// (mma3_add), which costs about 15 % of dk/dv's time and holds T 4096
// within the contract. tools/torch_flash_fp32_variants.py builds both
// alternatives and measures them against this source.
//
// Why mma.sync and not wgmma: an m16n8k8 tf32 mma.sync takes A from
// registers in a layout the scores' accumulator feeds with no data
// movement (below), and leaves each warp its own 16 rows, so the hi/lo
// split happens on fragments in registers as they are loaded. wgmma would
// want the split operands in shared memory (B always, A for the best
// rate): three times the tile bytes a product and a split pass between
// the copy and the product.
//
// The layouts. One warp owns 16 rows of the resident tile (q rows in the
// forward, k rows in dk/dv); a block is 4 warps, 64 rows, the resident
// tile in shared memory. The streamed tiles (K/V in the forward, q/dO in
// dk/dv) come through a ring of two shared-memory stages filled by 16-byte
// cp.async while the previous tile is multiplied, rows padded to hd + 4
// floats: a fragment read of rows gid and columns tig (gid = lane / 4,
// tig = lane % 4) and one of rows 2 tig, 2 tig + 1 and columns gid both
// touch 32 distinct banks. The second product (P.V, P^T.dO, dS^T.q) takes
// the first one's accumulator as its A operand with neither a shuffle nor
// a trip through shared memory: the accumulator holds columns 2 tig and
// 2 tig + 1 of an 8-column block where A wants columns tig and tig + 4,
// so the second product's k index tig stands for column 2 tig and tig + 4
// for 2 tig + 1, and its B fragment reads rows 2 tig and 2 tig + 1 to
// match (a sum does not care in which order its k terms come). The online
// softmax (m, l) and the output, or the dk/dv sums, stay in registers;
// dk/dv sum over q tiles in a fixed order inside one block, no atomics, so
// they are bitwise the same from run to run. dk/dv splits its resident K/V
// fragments again for each q tile: keeping them split would take 128 more
// registers a thread or twice the tile's shared memory (one block an SM),
// and the re-split is about a sixth of the kernel's split work.
//
// What bounds it on the H100: at B 8, T 512, H 8, hd 64 the forward does
// 4.29 G operations, three TF32 products each: 0.026 ms at 495 TF/s TF32
// (data sheet, dense), against 0.010 ms for its bytes at 3.35 TB/s; dk/dv
// does twice the forward's products, 0.052 ms. So the tensor cores bound
// both at the sizes that matter. What holds the kernels at about a fifth
// of that (0.134 and 0.247 ms, chip_smoke.py on an H100): each mma needs
// its fragment split (five ALU operations a value) and each B fragment a
// shared-memory read, which a warp of 16 rows does for its own rows alone.
// The forward caps its registers to fit three blocks an SM (measured
// faster than holding q's fragments in registers at two); dk/dv needs its
// 255 registers for the four sums and runs two. Causal: the forward stops
// at the last K tile the diagonal reaches and launches the longest q
// tiles first; dk/dv starts at the first q tile that reaches the
// diagonal; a warp whose 16 rows see none of a tile skips its products.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int NW = 4;          // warps per block
constexpr int NT = NW * 32;    // threads per block
constexpr int WM = 16;         // resident rows per warp (the mma's M)
constexpr int BR = NW * WM;    // resident rows per block

// cvt.rna.tf32.f32 of a finite x: half an ulp of tf32 added to the
// magnitude's bits (the sign bit rides along), then the 13 bits tf32 drops
// cleared: nearest, ties away from zero
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each a tf32 value in a 32-bit register
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (16 x 8) split into hi and lo.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float x0, float x1, float x2,
                                      float x3) {
    split(x0, hi[0], lo[0]);
    split(x1, hi[1], lo[1]);
    split(x2, hi[2], lo[2]);
    split(x3, hi[3], lo[3]);
  }
};

// d += a.b as 3xTF32: the two cross terms first, then hi.hi
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(d, a.lo, bh0, bh1);
  mma(d, a.hi, bl0, bl1);
  mma(d, a.hi, bh0, bh1);
}

// d += a.b, the three products summed from zero first: the running sum d
// only ever takes round-to-nearest fp32 additions (the tensor core
// truncates every sum it writes; the note at the top)
__device__ __forceinline__ void mma3_add(float (&d)[4], const FragA& a,
                                         float b0, float b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(t, a, b0, b1);
  d[0] += t[0];
  d[1] += t[1];
  d[2] += t[2];
  d[3] += t[3];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(fill ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool fill) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(fill ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// rows [row0, row0 + n) of one head of a [B, T, H, HD] tensor (base at
// the head, row stride rs) into shared rows of LD floats; rows at or past
// T are zero-filled
template <int HD, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* base,
                                          long rs, int row0, int n, int T,
                                          int tid) {
  constexpr int CH = HD / 4;     // 16-byte chunks a row
  for (int i = tid; i < n * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 4;
    const int t = row0 + r;
    const bool in = t < T;
    cp_async16(dst + r * LD + c, base + (in ? (long)t * rs + c : 0), in);
  }
}

// B4: one block per (64-row q tile, head, batch), streaming BK-row K/V
// tiles past the resident q tile; warp w owns q rows 16 w .. 16 w + 15.
template <int HD, int BK>
__global__ void __launch_bounds__(NT, 3) flash_fwd_kernel_tf32x3(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ kv_mask,
    float* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk,
    float scale, int causal) {
  constexpr int LD = HD + 4;
  constexpr int KS = HD / 8;     // k steps of Q.K^T, n tiles of P.V
  constexpr int NS = BK / 8;     // n tiles of Q.K^T, k steps of P.V
  constexpr int STAGE = 2 * BK * LD;
  extern __shared__ __align__(16) float smem[];
  int* sMask = reinterpret_cast<int*>(smem + 2 * STAGE);   // [2][BK]
  float* sQ = smem + 2 * STAGE + 2 * BK;                   // [BR][LD]

  const int num_q = (Tq + BR - 1) / BR;
  // causal: the longest q tiles (the most K tiles) first
  const int qt = causal ? num_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const long rs = (long)H * HD;
  const float* qb = q + (long)b * Tq * rs + (long)h * HD;
  const float* kb = k + (long)b * Tk * rs + (long)h * HD;
  const float* vb = v + (long)b * Tk * rs + (long)h * HD;
  const int* mb = kv_mask == nullptr ? nullptr : kv_mask + (long)b * Tk;

  const int row0 = qt * BR + warp * WM;   // the warp's first q row
  const int r0 = row0 + gid, r1 = r0 + 8;

  float o[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  int num_k = (Tk + BK - 1) / BK;
  if (causal) num_k = min(num_k, ((qt + 1) * BR + BK - 1) / BK);

  auto load = [&](int kt, int st) {
    float* sK = smem + st * STAGE;
    load_rows<HD, LD>(sK, kb, rs, kt * BK, BK, Tk, tid);
    load_rows<HD, LD>(sK + BK * LD, vb, rs, kt * BK, BK, Tk, tid);
    if (mb != nullptr && tid < BK) {
      const int t = kt * BK + tid;
      cp_async4(sMask + st * BK + tid, mb + (t < Tk ? t : 0), t < Tk);
    }
    cp_commit();
  };

  if (num_k > 0) {
    load_rows<HD, LD>(sQ, qb, rs, qt * BR, BR, Tq, tid);
    load(0, 0);   // one group with the resident q tile
  }
  for (int kt = 0; kt < num_k; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < num_k) {
      load(kt + 1, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* sK = smem + st * STAGE;
    const float* sV = sK + BK * LD;
    const int key0 = kt * BK;
    if (!causal || key0 <= row0 + WM - 1) {
      // S = Q.K^T: the accumulator of n tile n holds rows r0 (s[n][0..1])
      // and r1 (s[n][2..3]) at keys key0 + 8 n + 2 tig + (0, 1)
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        // the warp's q fragment, scaled in fp32 as the plain version does
        const float* qp = sQ + (warp * WM + gid) * LD + kk * 8 + tig;
        FragA a;
        a.set(qp[0] * scale, qp[8 * LD] * scale, qp[4] * scale,
              qp[8 * LD + 4] * scale);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float* kp = sK + (n * 8 + gid) * LD + kk * 8 + tig;
          mma3(s[n], a, kp[0], kp[4]);
        }
      }
      // mask, then the online softmax over rows r0 and r1
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = n * 8 + 2 * tig + e;
          const int t = key0 + j;
          const bool ok = mb != nullptr ? sMask[st * BK + j] > 0 : t < Tk;
          if (!(ok && (!causal || t <= r0))) s[n][e] = kNegInf;
          if (!(ok && (!causal || t <= r1))) s[n][2 + e] = kNegInf;
          mx0 = fmaxf(mx0, s[n][e]);
          mx1 = fmaxf(mx1, s[n][2 + e]);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = expf(fminf(m0 - mn0, 0.f));
      const float al1 = expf(fminf(m1 - mn1, 0.f));
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 =
              s[n][e] > kNegInf * 0.5f ? expf(s[n][e] - mn0) : 0.f;
          const float p1 =
              s[n][2 + e] > kNegInf * 0.5f ? expf(s[n][2 + e] - mn1) : 0.f;
          s[n][e] = p0;
          s[n][2 + e] = p1;
          sum0 += p0;
          sum1 += p1;
        }
      }
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }
      // O += P.V: k step j of P is n tile j of S, its k index tig standing
      // for key 2 tig and tig + 4 for key 2 tig + 1
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        FragA a;
        a.set(s[j][0], s[j][2], s[j][1], s[j][3]);
        const float* vp = sV + (j * 8 + 2 * tig) * LD + gid;
#pragma unroll
        for (int n = 0; n < KS; ++n)
          mma3_add(o[n], a, vp[n * 8], vp[LD + n * 8]);
      }
    }
    __syncthreads();   // every read of this stage is done before its refill
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < KS; ++n) {
    const int c = n * 8 + 2 * tig;
    if (r0 < Tq)
      *reinterpret_cast<float2*>(out + ((long)b * Tq + r0) * rs +
                                 (long)h * HD + c) =
          make_float2(o[n][0] / d0, o[n][1] / d0);
    if (r1 < Tq)
      *reinterpret_cast<float2*>(out + ((long)b * Tq + r1) * rs +
                                 (long)h * HD + c) =
          make_float2(o[n][2] / d1, o[n][3] / d1);
  }
  if (tig == 0) {
    const long row = ((long)b * H + h) * Tq;
    if (r0 < Tq) lse[row + r0] = m0 + logf(d0);
    if (r1 < Tq) lse[row + r1] = m1 + logf(d1);
  }
}

// B6: one block per (64-row k tile, head, batch), streaming BQ-row q/dO
// tiles; warp w owns k rows 16 w .. 16 w + 15 of the tile.
template <int HD, int BQ>
__global__ void __launch_bounds__(NT) flash_dkv_kernel_tf32x3(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ kv_mask,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int H, int Tq, int Tk, float scale, int causal) {
  constexpr int LD = HD + 4;
  constexpr int KS = HD / 8;     // k steps of K.q^T and V.dO^T; n tiles of dK, dV
  constexpr int NS = BQ / 8;     // n tiles of S^T, dP^T; k steps of dK, dV
  constexpr int STAGE = 2 * BQ * LD;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                       // [BR][LD], resident
  float* sV = sK + BR * LD;               // [BR][LD], resident
  float* sRing = sV + BR * LD;            // [2][q then dO]
  float* sL = sRing + 2 * STAGE;          // [2][BQ] lse
  float* sD = sL + 2 * BQ;                // [2][BQ] delta

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const long rs = (long)H * HD;
  const float* qb = q + (long)b * Tq * rs + (long)h * HD;
  const float* ob = dout + (long)b * Tq * rs + (long)h * HD;
  const float* kb = k + (long)b * Tk * rs + (long)h * HD;
  const float* vb = v + (long)b * Tk * rs + (long)h * HD;
  const float* lb = lse + ((long)b * H + h) * Tq;
  const float* db = delta + ((long)b * H + h) * Tq;

  const int key0 = kt * BR + warp * WM;   // the warp's first k row
  const int k0 = key0 + gid, k1 = k0 + 8;
  const bool ok0 =
      k0 < Tk && (kv_mask == nullptr || kv_mask[(long)b * Tk + k0] > 0);
  const bool ok1 =
      k1 < Tk && (kv_mask == nullptr || kv_mask[(long)b * Tk + k1] > 0);

  float ak[KS][4], av[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n) {
    ak[n][0] = ak[n][1] = ak[n][2] = ak[n][3] = 0.f;
    av[n][0] = av[n][1] = av[n][2] = av[n][3] = 0.f;
  }

  const int num_q = (Tq + BQ - 1) / BQ;
  // q tiles wholly before this k tile's diagonal see none of it
  const int q_lo = causal ? (kt * BR) / BQ : 0;

  auto load = [&](int qi, int st) {
    float* sQ = sRing + st * STAGE;
    load_rows<HD, LD>(sQ, qb, rs, qi * BQ, BQ, Tq, tid);
    load_rows<HD, LD>(sQ + BQ * LD, ob, rs, qi * BQ, BQ, Tq, tid);
    if (tid < BQ) {
      const int t = qi * BQ + tid;
      const int src = t < Tq ? t : 0;
      cp_async4(sL + st * BQ + tid, lb + src, t < Tq);
      cp_async4(sD + st * BQ + tid, db + src, t < Tq);
    }
    cp_commit();
  };

  if (q_lo < num_q) {
    load_rows<HD, LD>(sK, kb, rs, kt * BR, BR, Tk, tid);
    load_rows<HD, LD>(sV, vb, rs, kt * BR, BR, Tk, tid);
    load(q_lo, 0);   // one group with the resident K/V
  }
  for (int qi = q_lo; qi < num_q; ++qi) {
    const int st = (qi - q_lo) & 1;
    if (qi + 1 < num_q) {
      load(qi + 1, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* sQ = sRing + st * STAGE;
    const float* sO = sQ + BQ * LD;
    const float* sl = sL + st * BQ;
    const float* sd = sD + st * BQ;
    const int qrow0 = qi * BQ;
    if (!causal || qrow0 + BQ - 1 >= key0) {
      // S^T = K.q^T and dP^T = V.dO^T: the accumulators of n tile n hold
      // k rows k0 ([n][0..1]) and k1 ([n][2..3]) at q rows
      // qrow0 + 8 n + 2 tig + (0, 1)
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const float* kp = sK + (warp * WM + gid) * LD + kk * 8 + tig;
        const float* vp = sV + (warp * WM + gid) * LD + kk * 8 + tig;
        FragA a, c;
        a.set(kp[0], kp[8 * LD], kp[4], kp[8 * LD + 4]);
        c.set(vp[0], vp[8 * LD], vp[4], vp[8 * LD + 4]);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float* qp = sQ + (n * 8 + gid) * LD + kk * 8 + tig;
          const float* op = sO + (n * 8 + gid) * LD + kk * 8 + tig;
          mma3(s[n], a, qp[0] * scale, qp[4] * scale);
          mma3(dp[n], c, op[0], op[4]);
        }
      }
      // p (into s) and ds (into dp)
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = n * 8 + 2 * tig + e;
          const int t = qrow0 + i;
          const bool live = t < Tq;
          const bool v0 = ok0 && live && (!causal || t >= k0);
          const bool v1 = ok1 && live && (!causal || t >= k1);
          const float s0 = v0 ? s[n][e] : kNegInf;
          const float s1 = v1 ? s[n][2 + e] : kNegInf;
          const float p0 = s0 > kNegInf * 0.5f ? expf(s0 - sl[i]) : 0.f;
          const float p1 = s1 > kNegInf * 0.5f ? expf(s1 - sl[i]) : 0.f;
          s[n][e] = p0;
          s[n][2 + e] = p1;
          dp[n][e] = p0 * (dp[n][e] - sd[i]);
          dp[n][2 + e] = p1 * (dp[n][2 + e] - sd[i]);
        }
      }
      // dV += P^T.dO and dK += dS^T.(scale q): k step j is n tile j of
      // S^T, its k index tig standing for q row 2 tig, tig + 4 for 2 tig + 1
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        FragA a, c;
        a.set(s[j][0], s[j][2], s[j][1], s[j][3]);
        c.set(dp[j][0], dp[j][2], dp[j][1], dp[j][3]);
        const float* op = sO + (j * 8 + 2 * tig) * LD + gid;
        const float* qp = sQ + (j * 8 + 2 * tig) * LD + gid;
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          mma3_add(av[n], a, op[n * 8], op[LD + n * 8]);
          mma3_add(ak[n], c, qp[n * 8] * scale, qp[LD + n * 8] * scale);
        }
      }
    }
    __syncthreads();   // every read of this stage is done before its refill
  }

#pragma unroll
  for (int n = 0; n < KS; ++n) {
    const int c = n * 8 + 2 * tig;
    if (k0 < Tk) {
      const long off = ((long)b * Tk + k0) * rs + (long)h * HD + c;
      *reinterpret_cast<float2*>(dk + off) = make_float2(ak[n][0], ak[n][1]);
      *reinterpret_cast<float2*>(dv + off) = make_float2(av[n][0], av[n][1]);
    }
    if (k1 < Tk) {
      const long off = ((long)b * Tk + k1) * rs + (long)h * HD + c;
      *reinterpret_cast<float2*>(dk + off) = make_float2(ak[n][2], ak[n][3]);
      *reinterpret_cast<float2*>(dv + off) = make_float2(av[n][2], av[n][3]);
    }
  }
}

template <int HD, int BK>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* kv_mask, void* out, void* lse, int B,
                       int H, int Tq, int Tk, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * 2 * BK * (HD + 4) + 2 * BK + BR * (HD + 4));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_tf32x3<HD, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BR - 1) / BR, H, B);
  flash_fwd_kernel_tf32x3<HD, BK><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(kv_mask),
      static_cast<float*>(out), static_cast<float*>(lse), H, Tq, Tk, scale,
      causal);
  return cudaGetLastError();
}

template <int HD, int BQ>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* kv_mask, const void* dout,
                       const void* lse, const void* delta, void* dk,
                       void* dv, int B, int H, int Tq, int Tk, float scale,
                       int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * BR * (HD + 4) +
                                       2 * 2 * BQ * (HD + 4) + 2 * 2 * BQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel_tf32x3<HD, BQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + BR - 1) / BR, H, B);
  flash_dkv_kernel_tf32x3<HD, BQ><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(kv_mask),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// The streamed tile is 64 rows at hd 64 and 32 at hd 128, which keeps the
// ring and the accumulators of hd 128 within one SM's registers and
// shared memory.
extern "C" int pt_flash_fwd_tf32x3(const void* q, const void* k,
                                   const void* v, const void* kv_mask,
                                   void* out, void* lse, int B, int H,
                                   int Tq, int Tk, int hd, float scale,
                                   int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch_fwd<64, 64>(q, k, v, kv_mask, out, lse, B, H, Tq, Tk,
                              scale, causal, st);
  if (hd == 128)
    return launch_fwd<128, 32>(q, k, v, kv_mask, out, lse, B, H, Tq, Tk,
                               scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pt_flash_dkv_tf32x3(const void* q, const void* k,
                                   const void* v, const void* kv_mask,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv,
                                   int B, int H, int Tq, int Tk, int hd,
                                   float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch_dkv<64, 64>(q, k, v, kv_mask, dout, lse, delta, dk, dv, B,
                              H, Tq, Tk, scale, causal, st);
  if (hd == 128)
    return launch_dkv<128, 32>(q, k, v, kv_mask, dout, lse, delta, dk, dv,
                               B, H, Tq, Tk, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
