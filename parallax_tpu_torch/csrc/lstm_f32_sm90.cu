// The fp32 LSTM forward for Hopper (sm_90a): one persistent,
// weight-stationary launch a pass, its two products split-operand (3xTF32)
// mma.sync on the tensor cores.
//
// Replaces, for fp32 inputs on the shapes that ops/lstm.py routes here
// (`fwd_route`), the TPU kernels of parallax_tpu/ops/pallas_lstm.py:
//   B1 `_lstm_kernel`     (pl.pallas_call at line 290): pt_lstm_fwd_tf32x3
//                          with gates == cseq == nullptr
//   B2 `_lstm_kernel_res` (pl.pallas_call at line 299): pt_lstm_fwd_tf32x3
//                          with the two residual outputs
// fp32 B3 and the fp32 shapes this kernel does not take stay on
// csrc/lstm.cu; bf16 runs csrc/lstm_sm90.cu.
//
// Same function and rounding points as csrc/lstm.cu's fp32 forward and
// lstm_recurrence_plain:
//   * gates = xw_t + hs_{t-1} . w_h, fp32 accumulation, the product skipped
//     at t = 0 (h_0 = 0);
//   * i|f|g|o split, sigma(f + 1), an fp32 c carry; sigma and tanh as
//     expf and tanhf (no tanh.approx: its error would compound through c);
//   * hs_t = (sigma(o) tanh c) . w_proj, fp32 accumulation;
//   * B2 also stores the post-activation gates [T, B, 4H] (gate-major) and
//     c [T, B, H], the layout csrc/lstm.cu's fp32 B3 and _bwd_epilogue read.
//
// Why the split product. One TF32 product rounds each operand to 10
// mantissa bits; through 20 steps of the recurrence at LM1B's widths that
// is about 3e-4 of the output, past the 1e-4 the fp32 kernels are held to.
// Each operand is split as x = hi + lo (hi = tf32(x), lo = tf32(x - hi),
// nearest, ties away) and a.b summed as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi:
// about 1e-7 (tests/test_torch_lstm.py emulates both on the CPU). The
// tensor core truncates each sum it writes, so every 64-deep chunk of a
// product is summed from zero and added to the running sum in fp32, as
// flash_attention_f32_sm90.cu's mma3_add does for its long sums.
//
// Design. The structure of csrc/lstm_sm90.cu's bf16 forward: a grid of
// nb = H / 16 blocks, block j owning the 16 hidden units u0 = 16 j ..
// u0 + 15 (64 gate columns), 256 threads (8 warps), one block an SM,
// launched cooperatively; two grid barriers a step.
//   * Resident: the block's w_h slice, fp32 and unsplit, in shared memory
//     as [64 columns][P] (column n = gate n / 16, unit n % 16), rows padded
//     to a multiple of 32 floats plus 8; each B fragment is split into
//     hi/lo as it is read. The fp32 c of the block's units stays in
//     registers for the whole pass.
//   * Gates: warp w owns batch rows 16 w .. 16 w + 15 (B <= 128). hs_{t-1}
//     streams through a two-stage ring of 16-byte cp.async copies, 64-deep
//     k chunks of all the batch rows, while the previous chunk is
//     multiplied. The mma's k slots are permuted (slot tig holds k 2 tig,
//     slot tig + 4 holds k 2 tig + 1, for A and B alike: a sum does not
//     care in which order its terms come), so every A and B fragment is
//     one 8-byte shared-memory load, and rows of 64 + 8 floats make those
//     loads free of bank conflicts. Each thread's accumulators hold all
//     four gates of 4 units in 2 rows, so the cell runs in registers; it
//     writes hfull [B, H] (fp32 scratch) and, for B2, the residuals, and
//     loads xw_{t+1} into registers while the grid waits.
//   * Grid barrier; then the projection in 8-column output tiles: job (cg,
//     m) is hs_t's columns 8 cg .. 8 cg + 7 over batch rows 64 m .. 64 m +
//     63, jobs dealt to the blocks in turn. Warps 0-3 and 4-7 split the
//     contraction over H in halves, one 16-row tile a warp; a ring stage
//     holds a 64-deep chunk of both halves' hfull rows and w_proj rows
//     (w_proj stays in L2: the 64 KB column slice a block would need beside
//     w_h's 128 KB does not fit). The second half's sums go through shared memory
//     to the first, which stores hs_t. Grid barrier (none after the last
//     step).
// One owner for every output element and a fixed summation order
// everywhere, no atomics: bitwise repeatable.
//
// Shared memory (f32_smem_bytes in ops/lstm.py): the w_h slice 64 x
// (ceil32(P) + 8) floats (133,120 bytes at P 512), two ring stages of 128
// x 72 floats of rows and 2 x 64 x 12 of w_proj (43,008 bytes each), and
// the projection's half sums (2 KB): 221,184 bytes at P 512 of the 232,448
// a block may have.
//
// What bounds it on the H100: one pass at T 20, B 128, H 2048, P 512 is
// 25.77 G operations (no gates product at t = 0), three TF32 products
// each: 0.156 ms at 495 TF/s TF32 (0.385 ms at 67 TF/s fp32), against
// 0.03-0.04 ms for its device-memory bytes. Per step every block reads
// all of hs_{t-1} (256 KB) and its projection job's 64 hfull rows (512
// KB) and w_proj columns (64 KB) from L2: about 100 MB a step across the
// grid, which with the two grid barriers and each step's serial chain
// (load, product, cell, barrier, product, barrier) is what holds it above
// the tensor-core bound.
//
// Hazards (csrc/lstm_sm90.cu's note has them at length):
//  1. Co-residency: the grid barriers need every block resident; the
//     launch is cooperative (refused when the grid cannot be), the route
//     sizes the grid from the SM count, and every spin traps after 4 s.
//  2. Ordering: hfull and hs_t are written by other blocks with plain
//     stores before a release at GPU scope, and read after the acquire by
//     cp.async.cg, which reads L2 (never a stale L1 line).
//  3. The barrier counter is a fresh zeroed int a call (the wrapper's).
//  4. Edges: rows past B are zero-filled and never stored; P and H edges
//     are cut at 8-deep k steps (P a multiple of 8, H of 16); the wrapper
//     passes 16-byte aligned xw, w_h and w_proj (it copies a view that is
//     not).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;                   // warps a block, 16 batch rows each
constexpr int NT = NW * 32;
constexpr int UNITS = 16;               // hidden units a block
constexpr int NC = 4 * UNITS;           // the block's gate columns
constexpr int KCH = 64;                 // k depth of a ring stage
constexpr int LDA = KCH + 8;            // ring row stride, floats
constexpr int ROWS = 128;               // ring rows (B <= 128)
constexpr int LDP = 12;                 // w_proj chunk row stride, floats
constexpr int kStage = ROWS * LDA + 2 * KCH * LDP;   // floats a stage
constexpr int kRed = 4 * 32 * 4;        // floats: the projection's half sums
constexpr int kMaxSmem = 232448;        // 227 KB, sm_90's per-block limit
static_assert(NT == 2 * 2 * KCH, "one w_proj copy a thread a stage");

// -- split-operand TF32 products (as in flash_attention_f32_sm90.cu) -----

// cvt.rna.tf32.f32 of a finite x: nearest, ties away from zero
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

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

// An A fragment (16 x 8) split into hi and lo, from the two 8-byte loads of
// rows gid (x) and gid + 8 (y): slot tig holds k 2 tig, tig + 4 k 2 tig + 1
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float2 x, float2 y) {
    split(x.x, hi[0], lo[0]);
    split(y.x, hi[1], lo[1]);
    split(x.y, hi[2], lo[2]);
    split(y.y, hi[3], lo[3]);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(fill ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// -- the grid barrier (csrc/lstm_sm90.cu's, for cp.async readers) --------

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Traps once a spin has lasted 4 s: a lost arrival becomes a launch error
// instead of a hung card.
struct SpinGuard {
  uint64_t t0 = 0;
  int spins = 0;
  __device__ __forceinline__ void tick() {
    if ((++spins & 1023) == 0) {
      const uint64_t now = global_ns();
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > 4000000000ull) {
        __trap();
      }
    }
  }
};

// Barrier k of the pass waits for the count k nb. Every thread's stores of
// the phase precede thread 0's release; thread 0 acquires the count and the
// block's barrier orders the acquire before every thread's later reads.
__device__ __forceinline__ void grid_sync(unsigned* counter,
                                          unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter)
                 : "memory");
    SpinGuard guard;
    for (;;) {
      unsigned seen;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(counter)
                   : "memory");
      if (seen >= target) break;
      guard.tick();
    }
    __threadfence();
  }
  __syncthreads();
}

// -- the pass -------------------------------------------------------------

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// `count` chunks through the block's two-stage ring: issue(i, stage) fills
// a stage with chunk i (its cp.async copies; the commit is here), and
// compute(i, stage) runs once chunk i has landed, while chunk i + 1 loads.
template <class Issue, class Compute>
__device__ __forceinline__ void stream(float* ring, int count, Issue issue,
                                       Compute compute) {
  if (count <= 0) return;
  issue(0, ring);
  cp_commit();
  for (int i = 0; i < count; ++i) {
    if (i + 1 < count) {
      issue(i + 1, ring + ((i + 1) & 1) * kStage);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    compute(i, ring + (i & 1) * kStage);
    __syncthreads();   // every read of this stage is done before its refill
  }
}

template <bool RES>
__global__ void __launch_bounds__(NT, 1) lstm_fwd_kernel_tf32x3(
    const float* __restrict__ xw, const float* __restrict__ w_h,
    const float* __restrict__ w_proj, float* hs, float* __restrict__ gates,
    float* __restrict__ cseq, float* hfull, unsigned* __restrict__ counter,
    int T, int B, int H, int P) {
  extern __shared__ __align__(16) float smem[];
  const int LDK = (P + 31) / 32 * 32 + 8;
  float* sWh = smem;                       // [NC][LDK]
  float* ring = sWh + NC * LDK;            // [2][kStage]
  float* red = ring + 2 * kStage;          // [4 * 32][4]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nb = gridDim.x, j = blockIdx.x;
  const int u0 = j * UNITS;
  const long H4 = 4L * H;
  const int MR = min(ROWS, (B + 15) / 16 * 16);   // ring rows in use

  // the w_h slice, once: column n = q 16 + ul is w_h[:, q H + u0 + ul]
  for (int i = tid; i < P * (NC / 4); i += NT) {
    const int k = i / (NC / 4), r = i % (NC / 4);
    const int q = r / 4, ul = (r % 4) * 4;
    const float4 v = *reinterpret_cast<const float4*>(
        w_h + (long)k * H4 + (long)q * H + u0 + ul);
    float* dst = sWh + (q * UNITS + ul) * LDK + k;
    dst[0] = v.x;
    dst[LDK] = v.y;
    dst[2 * LDK] = v.z;
    dst[3 * LDK] = v.w;
  }
  __syncthreads();

  // this thread's rows (r0, r0 + 8) and units u0 + 8 half + 2 tig + e
  const int r0 = warp * 16 + gid;
  const bool gate_warp = warp * 16 < B;
  float c_st[2][2][2];      // [hh][half][e]
  float2 xv[2][4][2];       // xw_t: [hh][gate q][half]
  auto load_xw = [&](int t) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = r0 + 8 * hh;
          xv[hh][q][half] =
              row < B ? *reinterpret_cast<const float2*>(
                            xw + ((long)t * B + row) * H4 + (long)q * H +
                            u0 + 8 * half + 2 * tig)
                      : make_float2(0.f, 0.f);
        }
  };
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      c_st[hh][half][0] = c_st[hh][half][1] = 0.f;
  if (gate_warp) load_xw(0);

  const int KC = (P + KCH - 1) / KCH;      // chunks of the gates product
  const int KH = (H + KCH - 1) / KCH;      // chunks of the projection
  const int kh0 = (KH + 1) / 2;            // the first half's chunks
  const int NCG = P / 8, MT = (B + 63) / 64;
  unsigned barrier = 0;
  for (int t = 0; t < T; ++t) {
    // ---- gates = xw_t + hs_{t-1} . w_h slice, then the cell --------------
    // acc[2 q + half][2 hh + e]: gate q of unit 8 half + 2 tig + e, row
    // r0 + 8 hh
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    if (t > 0) {
      const float* h_prev = hs + (long)(t - 1) * B * P;
      stream(
          ring, KC,
          [&](int i, float* st) {
            for (int v = tid; v < MR * (KCH / 4); v += NT) {
              const int r = v / (KCH / 4), c4 = (v % (KCH / 4)) * 4;
              const int k = i * KCH + c4;
              const bool in = r < B && k < P;
              cp_async16(st + r * LDA + c4,
                         h_prev + (in ? (long)r * P + k : 0), in);
            }
          },
          [&](int i, const float* st) {
            if (!gate_warp) return;
            const int k0 = i * KCH;
            const int steps = min(KCH / 8, (P - k0) / 8);
            float tmp[8][4];
#pragma unroll
            for (int n = 0; n < 8; ++n)
              tmp[n][0] = tmp[n][1] = tmp[n][2] = tmp[n][3] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KCH / 8; ++kk) {
              if (kk < steps) {
                const float* ap = st + r0 * LDA + kk * 8 + 2 * tig;
                FragA a;
                a.set(*reinterpret_cast<const float2*>(ap),
                      *reinterpret_cast<const float2*>(ap + 8 * LDA));
#pragma unroll
                for (int n = 0; n < 8; ++n) {
                  const float2 b = *reinterpret_cast<const float2*>(
                      sWh + (n * 8 + gid) * LDK + k0 + kk * 8 + 2 * tig);
                  mma3(tmp[n], a, b.x, b.y);
                }
              }
            }
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              acc[n][0] += tmp[n][0];
              acc[n][1] += tmp[n][1];
              acc[n][2] += tmp[n][2];
              acc[n][3] += tmp[n][3];
            }
          });
    }
    if (gate_warp) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = r0 + 8 * hh;
          float ig[2], fg[2], gg[2], og[2], cn[2], hv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int a = 2 * hh + e;
            const float x0 = e ? xv[hh][0][half].y : xv[hh][0][half].x;
            const float x1 = e ? xv[hh][1][half].y : xv[hh][1][half].x;
            const float x2 = e ? xv[hh][2][half].y : xv[hh][2][half].x;
            const float x3 = e ? xv[hh][3][half].y : xv[hh][3][half].x;
            ig[e] = sigmoid(acc[half][a] + x0);
            fg[e] = sigmoid(acc[2 + half][a] + x1 + 1.f);
            gg[e] = tanhf(acc[4 + half][a] + x2);
            og[e] = sigmoid(acc[6 + half][a] + x3);
            float& c = c_st[hh][half][e];
            c = fg[e] * c + ig[e] * gg[e];   // c = 0 at t = 0
            cn[e] = c;
            hv[e] = og[e] * tanhf(c);
          }
          if (row >= B) continue;
          const int u = u0 + 8 * half + 2 * tig;
          *reinterpret_cast<float2*>(hfull + (long)row * H + u) =
              make_float2(hv[0], hv[1]);
          if (RES) {
            float* gt = gates + ((long)t * B + row) * H4 + u;
            *reinterpret_cast<float2*>(gt) = make_float2(ig[0], ig[1]);
            *reinterpret_cast<float2*>(gt + H) = make_float2(fg[0], fg[1]);
            *reinterpret_cast<float2*>(gt + 2L * H) =
                make_float2(gg[0], gg[1]);
            *reinterpret_cast<float2*>(gt + 3L * H) =
                make_float2(og[0], og[1]);
            *reinterpret_cast<float2*>(cseq + ((long)t * B + row) * H + u) =
                make_float2(cn[0], cn[1]);
          }
        }
      if (t + 1 < T) load_xw(t + 1);   // lands while the grid waits
    }
    grid_sync(counter, ++barrier * nb);

    // ---- projection: hs_t's 8 columns 8 cg.. over rows 64 m.. -------------
    const int hf = warp / 4;                 // the warp's half of H
    for (int jb = j; jb < NCG * MT; jb += nb) {
      const int cg = jb % NCG, m = jb / NCG;
      const bool live = 64 * m + (warp % 4) * 16 < B;
      float pacc[4] = {0.f, 0.f, 0.f, 0.f};
      stream(
          ring, kh0,
          [&](int i, float* st) {
            for (int v = tid; v < ROWS * (KCH / 4); v += NT) {
              const int r = v / (KCH / 4), c4 = (v % (KCH / 4)) * 4;
              const int ci = r < 64 ? i : kh0 + i;
              const int row = 64 * m + r % 64, k = ci * KCH + c4;
              const bool in = row < B && ci < KH && k < H;
              cp_async16(st + r * LDA + c4,
                         hfull + (in ? (long)row * H + k : 0), in);
            }
            {
              const int v = tid;             // NT == 2 * KCH * 2 copies
              const int h2 = v / (2 * KCH), kr = (v % (2 * KCH)) / 2;
              const int c4 = (v % 2) * 4;
              const int ci = h2 == 0 ? i : kh0 + i, k = ci * KCH + kr;
              const bool in = ci < KH && k < H;
              cp_async16(st + ROWS * LDA + (h2 * KCH + kr) * LDP + c4,
                         w_proj + (in ? (long)k * P + cg * 8 + c4 : 0), in);
            }
          },
          [&](int i, const float* st) {
            const int ci = hf == 0 ? i : kh0 + i;
            if (!live || ci >= KH) return;
            const int steps = min(KCH / 8, (H - ci * KCH) / 8);
            const float* wp = st + ROWS * LDA + hf * KCH * LDP;
            float tmp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int kk = 0; kk < KCH / 8; ++kk) {
              if (kk < steps) {
                const float* ap = st + r0 * LDA + kk * 8 + 2 * tig;
                FragA a;
                a.set(*reinterpret_cast<const float2*>(ap),
                      *reinterpret_cast<const float2*>(ap + 8 * LDA));
                const float* bp = wp + (kk * 8 + 2 * tig) * LDP + gid;
                mma3(tmp, a, bp[0], bp[LDP]);
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) pacc[e] += tmp[e];
          });
      if (hf == 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((warp - 4) * 32 + lane) * 4 + e] = pacc[e];
      }
      __syncthreads();
      if (hf == 0) {
        const int col = cg * 8 + 2 * tig;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = 64 * m + warp * 16 + gid + 8 * hh;
          const float* o = red + (warp * 32 + lane) * 4 + 2 * hh;
          if (row < B)
            *reinterpret_cast<float2*>(hs + ((long)t * B + row) * P + col) =
                make_float2(pacc[2 * hh] + o[0], pacc[2 * hh + 1] + o[1]);
        }
      }
    }
    if (t + 1 < T) grid_sync(counter, ++barrier * nb);
  }
}

template <bool RES>
cudaError_t launch(const void* xw, const void* w_h, const void* w_proj,
                   void* hs, void* gates, void* cseq, void* hfull,
                   void* counter, int T, int B, int H, int P, size_t smem,
                   cudaStream_t stream) {
  static const cudaError_t ready = cudaFuncSetAttribute(
      lstm_fwd_kernel_tf32x3<RES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (ready != cudaSuccess) return ready;
  const float* a_xw = static_cast<const float*>(xw);
  const float* a_wh = static_cast<const float*>(w_h);
  const float* a_wp = static_cast<const float*>(w_proj);
  float* a_hs = static_cast<float*>(hs);
  float* a_gates = static_cast<float*>(gates);
  float* a_cseq = static_cast<float*>(cseq);
  float* a_hfull = static_cast<float*>(hfull);
  unsigned* a_counter = static_cast<unsigned*>(counter);
  void* args[] = {&a_xw,    &a_wh,   &a_wp,      &a_hs, &a_gates, &a_cseq,
                  &a_hfull, &a_counter, &T,      &B,    &H,       &P};
  // cooperative: refused (cudaErrorCooperativeLaunchTooLarge) unless every
  // block can be resident at once, which the grid barriers need
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lstm_fwd_kernel_tf32x3<RES>),
      dim3(H / UNITS), dim3(NT), args, smem, stream);
}

}  // namespace

// B1 (gates == cseq == nullptr) and B2 in fp32: xw [T, B, 4H], w_h
// [P, 4H], w_proj [H, P], hs [T, B, P], gates [T, B, 4H], cseq [T, B, H];
// scratch hfull [B, H] fp32 and counter, one zeroed 32-bit int; every base
// on 16 bytes. A shape outside what the kernel takes (ops/lstm.py's
// fwd_route) returns cudaErrorInvalidValue.
extern "C" int pt_lstm_fwd_tf32x3(const void* xw, const void* w_h,
                                  const void* w_proj, void* hs, void* gates,
                                  void* cseq, void* hfull, void* counter,
                                  int T, int B, int H, int P, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool res = gates != nullptr;
  const size_t smem =
      sizeof(float) * ((size_t)NC * ((P + 31) / 32 * 32 + 8) + 2 * kStage +
                       kRed);
  if (res != (cseq != nullptr) || T < 1 || B < 1 || B > ROWS || P < 8 ||
      P % 8 != 0 || H < UNITS || H % UNITS != 0 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return res ? (int)launch<true>(xw, w_h, w_proj, hs, gates, cseq, hfull,
                                 counter, T, B, H, P, smem, st)
             : (int)launch<false>(xw, w_h, w_proj, hs, gates, cseq, hfull,
                                  counter, T, B, H, P, smem, st);
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
