// Flash-attention forward (B4), dq (B5) and dk/dv (B6) in bf16 for Hopper
// (sm_90a): TMA-fed tiles, wgmma products, a producer warp and a consumer
// warpgroup.
//
// Replaces, for bf16 inputs, the TPU kernels of
// parallax_tpu/ops/pallas_attention.py:
//   * pt_flash_fwd_sm90 <- `_flash_fwd_kernel` (line 46; pl.pallas_call at
//     line 141);
//   * pt_flash_dq_sm90  <- `_flash_dq_kernel`  (line 160; pl.pallas_call at
//     line 298);
//   * pt_flash_dkv_sm90 <- `_flash_dkv_kernel` (line 208; pl.pallas_call at
//     line 326).
// fp32 inputs stay on csrc/flash_attention.cu and csrc/flash_attention_bwd.cu
// (fp32 FMAs): a wgmma on fp32 operands is TF32, about 3 decimal digits.
//
// Same function as those kernels: q is multiplied by `scale` in bf16 before
// every dot; masked scores (kv_mask == 0, causal k > q, the ragged Tk edge)
// are -1e30 and their p is zeroed where the score is at or below -1e30 / 2;
// a row with no key gives out = 0, lse = m + log(1e-30) and dq = 0, a key
// with kv_mask 0 dk = dv = 0; dq is scaled once at the end, dk is not (q
// was pre-scaled); each output is rounded once to bf16. Rounding points
// that are new and bf16-only: p (forward, dk/dv) and ds (dq, dk/dv) are
// rounded to bf16 before the second product (O += P.V, dq += dS.K, dV +=
// P^T.dO, dK += dS^T.q^), which the TPU kernels take in fp32
// (pallas_attention.py:91, :202, :251-258). The row sums l of the forward
// stay sums of fp32 p. dk/dv also folds `scale` into its fp32 products
// instead of rounding q^ = bf16(q scale): its scores are scale (K.q^T) and
// its dK is scale (dS^T.q). At hd 64 scale is 2^-3, so the fold gives the
// same bits; at hd 128 (scale 2^-3.5) it skips q^'s rounding, one more
// rounding point. The plain versions in ops/flash_attention.py keep fp32 p
// and ds and the rounded q^; the kernels are held to them within 2e-2 of
// the plain peak.
//
// Layout: q, k, v, dO are [B, T, H, hd] bf16, contiguous, base 16-byte
// aligned (TMA); lse and delta [B, H, Tq] fp32; kv_mask [B, Tk] int32 or
// null; hd in {64, 128}; any Tq, Tk >= 1 (dk/dv also Tq 0); causal is the
// top-left tril.
//
// Design of B4 and B5. One block per (64-row q tile, head, batch), 256
// threads: warpgroup 0 consumes, warpgroup 1 produces (one thread issues
// every TMA load, then the warpgroup gives its registers to the consumer
// with setmaxnreg). Every operand has one tensor map over the 4-D view
// (hd, H, T, B) of its [B, T, H, hd] tensor, box (64, 1, 64, 1) with the
// 128-byte swizzle: a 64-row tile is one box at hd 64 and two at hd 128 (a
// box's inner dimension is at most 128 bytes under that swizzle). The
// producer loads the q tile (and the dO tile for dq) once, then streams
// 64-row K/V tiles into a ring (3 stages at hd 64, 2 at hd 128) guarded by
// full/empty mbarrier pairs; loads of tile j+1 run while the
// consumer multiplies tile j. TMA's zero fill covers the ragged Tk and Tq
// edges; the mask still sets those scores to -1e30. The consumer scales
// its q tile in shared memory, then for each K/V tile:
//   forward: S = q^.K^T (wgmma, both operands from shared memory, K-major),
//     the online softmax on S in registers, O = alpha O + P.V (wgmma, P
//     from registers rounded to bf16, V as stored: [BK, hd] with hd
//     contiguous is the MN-major B operand, taken through the transpose
//     bit, so no transposed copy is made);
//   dq: S = q^.K^T and dP = dO.V^T (two shared-memory wgmmas), p = exp(S -
//     lse), dS = p (dP - delta) rounded to bf16, dq += dS.K (wgmma, dS from
//     registers, K as the MN-major B operand).
// The m64nNk16 accumulator gives each thread two rows (r and r + 8) and,
// in each 8-column block i, columns 8i + 2(lane % 4) + {0, 1}; that is
// also the register layout of wgmma's A operand, so P and dS go from the
// accumulator to the second product without a shuffle. Row max and row
// sum reduce over the four lanes of a quad. out, lse and dq are stored
// from registers, masked at the Tq edge. dq has no atomics: one block owns
// its q tile's dq and sums the K tiles in order, so it is bitwise
// repeatable. Causal blocks stop at the last K tile the diagonal reaches.
//
// Design of B6, the same parts with the roles swapped: one block per (head,
// batch, 64-row K/V tile), the K tile slowest so that under causal the blocks
// with the most q tiles start first, keeps its K and V tiles resident (one TMA
// load each) and streams 64-row q and dO tiles through a 4-stage ring, with
// each stage's lse (times log2 e) and delta beside them. lse and delta cannot
// ride TMA (a map over [B, H, Tq] fp32 needs Tq 4 to be a multiple of 16), so
// the producer warp's 32 lanes load them with plain loads into the stage and
// count on its full barrier (33 arrivals: lane 0's first, with the TMA bytes,
// before the loads, then one from every lane after its stores). The consumer
// computes the transposed scores directly, rows k and columns q, so nothing is
// transposed through shared memory: S^T = K.q^T and dP^T = V.dO^T
// (shared-memory wgmmas, K-major), P^T = exp(scale S^T - lse[col]) and dS^T =
// P^T (dP^T - delta[col]) in registers, then dV += P^T.dO and dK += dS^T.q (P^T
// and dS^T from registers in bf16, dO and q as stored, the MN-major B operand).
// Masks in that layout: kv_mask and the Tk edge depend on the row only, so a
// block computes them once and writes zeros for its masked rows at the end (a
// row's sums depend on that row of P^T and dS^T alone); the Tq edge and causal
// are per column, applied only on the tiles that need them (the last, ragged q
// tile; under causal the diagonal tile, the first the block sees: earlier q
// tiles see none of its keys). TMA's zero fill at the Tq edge gives q = 0, so s
// = 0 and p = exp(-lse) there, not 0: the column mask zeroes it. dk and dv have
// no atomics: one block owns its K/V tile and sums the q tiles in order. B6
// uses no setmaxnreg: 160 threads (the consumer warpgroup and one producer
// warp) under __launch_bounds__(160, 2) at hd 64 give each thread up to 200
// registers (dK, dV, S^T and dP^T live together: 4 x 32 fp32 a thread), two
// blocks per SM; at hd 128 (dK and dV alone take 128) one block per SM and up
// to 255.
//
// Tiling by shape: every shape takes 64-row tiles, one consumer warpgroup
// per block. The main paths' shapes (serving B 1 and NMT training B 64,
// both T 64, H 8, hd 64) give blocks that hold one tile and see one tile
// of the other side: one load of each operand, two (forward), three (dq)
// or four (dk/dv) wgmma batches; B64 H8 is 512 blocks, two waves at two
// blocks per SM. T 512 gives 8 streamed tiles per block, T 2048 32, where
// the ring's steady state shows.
//
// What bounds it on the H100: 4 B H Tq Tk hd operations (forward; 6 for
// dq, 8 for dk/dv) over 989 TF/s bf16, against the q/k/v/out bytes over
// 3.35 TB/s. At T 512 (B 8, H 8, hd 64) the two bounds are about 4 and 5
// us (dk/dv: 9 us of operations); at T 64 the bytes bound. This design
// runs each tile's products and its elementwise pass one after the other
// within the warpgroup, so the elementwise instructions and the wgmma
// latency, not the tensor cores, set the pace: two blocks per SM (B4 and
// B5: 128 registers a thread) overlap one block's softmax with the other's
// products, tiles that every row sees whole skip the mask, and exp runs as
// ex2 on the special-function unit. ptxas compiles B4's and B5's consumer
// for the launch bound's 128 registers whatever setmaxnreg grants it, so
// dq at hd 128 (S, dP and a 64 x 128 accumulator live together) spills a
// little.

#include <cuda.h>          // CUtensorMap and its enums; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;                 // q rows per block
constexpr int BK = 64;                 // K/V rows per streamed tile
constexpr int NT = 256;                // consumer + producer warpgroups
constexpr int kBox = 64 * 64 * 2;      // bytes of one 64 x 64 bf16 box
constexpr int kConsumers = 128;
constexpr int kBlocksPerSM = 2;        // the register budget: 128 a thread
constexpr float kLog2e = 1.4426950408889634f;

// -- shared memory, barriers, TMA ----------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of this parity has completed. A wait that
// lasts 4 s traps, which the launch then reports as an error, where a lost
// arrival would otherwise hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (int spins = 1;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023) == 0) {
      const uint64_t now = global_ns();
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > 4000000000ull) {
        __trap();
      }
    }
  }
}

// One 64 x 64 box at element coordinates (c0 in hd, head, t, batch).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int h, int t,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(h), "r"(t), "r"(b),
      "r"(bar)
      : "memory");
}

// The 64-row tile starting at row t: HD / 64 boxes, each kBox bytes.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int h, int t, int b) {
#pragma unroll
  for (int c = 0; c < HD / 64; ++c) tma_load(dst + c * kBox, map, bar, c * 64, h, t, b);
}

// q <- bf16(q * scale) in place, as every version rounds it; the swizzle
// does not matter to an elementwise pass.
template <int HD>
__device__ __forceinline__ void scale_tile(uint8_t* tile, float scale,
                                           int tid) {
  uint4* vec = reinterpret_cast<uint4*>(tile);
#pragma unroll
  for (int i = tid; i < 64 * HD / 8; i += kConsumers) {
    uint4 v = vec[i];
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(x[e]);
      x[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    vec[i] = v;
  }
  // the generic-proxy writes must be visible to wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// -- wgmma ------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle. K-major tiles (the
// contraction dimension contiguous) use SBO = 1024 (eight 128-byte rows);
// MN-major tiles (N contiguous) also use LBO = the distance between
// 64-column boxes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator accesses across a wgmma
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B from shared memory,
// both K-major with the 128-byte swizzle; accumulate = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (bf16 pairs in
// the accumulator's row/column order), B from shared memory MN-major (N
// contiguous, the 128-byte swizzle; the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A from registers (bf16 pairs in
// the accumulator's row/column order), B from shared memory MN-major (N
// contiguous, the 128-byte swizzle; the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// S[64 x 64] = A[64 x HD] . B[64 x HD]^T, both tiles K-major in shared
// memory: 16 columns (32 bytes) per step inside a box, the next box after 4.
template <int HD>
__device__ __forceinline__ void product_nt(float (&s)[32], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    wgmma_ss_n64(s, smem_desc(a + off, 16, 1024),
                 smem_desc(b + off, 16, 1024), kk > 0);
  }
}

// D[64 x HD] += P[64 x 64] . B[64 x HD]: P from registers, B the tile as
// stored ([64 rows, HD] with HD contiguous), 16 rows (2048 bytes) per step.
template <int HD>
__device__ __forceinline__ void product_nn(float (&d)[HD / 2],
                                           const uint32_t (&p)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t desc = smem_desc(b + kk * 2048, kBox, 1024);
    if constexpr (HD == 64) {
      wgmma_rs_n64(d, p[kk], desc);
    } else {
      wgmma_rs_n128(d, p[kk], desc);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator S[64 x 64] of this thread as wgmma A fragments, rounded to
// bf16: step kk takes columns 16kk..16kk+15, which are S's values
// 8kk..8kk+7 in this thread.
__device__ __forceinline__ void to_fragments(const float (&s)[32],
                                             uint32_t (&p)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  }
}

// Which of this thread's 16 score columns of K tile j are attendable keys
// (inside Tk, kv_mask > 0): bit 2i + e for column 8i + 2(lane % 4) + e.
__device__ __forceinline__ uint32_t key_bits(const int* kv_mask, int b,
                                             int Tk, int j, int lane) {
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kpos = j * BK + 8 * i + 2 * (lane % 4) + e;
      const bool ok = kpos < Tk &&
                      (kv_mask == nullptr || kv_mask[(long)b * Tk + kpos] > 0);
      bits |= static_cast<uint32_t>(ok) << (2 * i + e);
    }
  }
  return bits;
}

// Whether K tile j needs the mask at all: a kv_mask, the ragged Tk edge, or
// a causal diagonal that some row of q tile qt does not reach.
__device__ __forceinline__ bool needs_mask(const int* kv_mask, int Tk,
                                           int causal, int qt, int j) {
  return kv_mask != nullptr || (j + 1) * BK > Tk ||
         (causal && (j + 1) * BK - 1 > qt * BQ);
}

// Masked scores to -1e30: keys outside Tk or kv_mask (the bits of
// key_bits), and under causal keys past the row's own position.
__device__ __forceinline__ void mask_scores(float (&sc)[32], uint32_t keys,
                                            int causal, const int (&qpos)[2],
                                            int j, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = j * BK + 8 * i + 2 * (lane % 4) + e;
        const bool ok =
            ((keys >> (2 * i + e)) & 1) && (!causal || qpos[hh] >= kpos);
        float& x = sc[4 * i + 2 * hh + e];
        x = ok ? x : kNegInf;
      }
    }
  }
}

// 2^x on the special-function unit; exp(x) is ex2(x log2 e), one FFMA
// ahead of it.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Shared memory of a block: its resident tiles (q; q and dO for dq), the
// K/V ring, then the barriers: full[stages], empty[stages], resident.
template <int HD, int kResident>
struct Layout {
  static constexpr int kStages = HD == 64 ? 3 : 2;
  static constexpr int kTile = (HD / 64) * kBox;   // one 64-row tile
  static constexpr int kBars = (kResident + 2 * kStages) * kTile;  // offset
  static constexpr size_t kBytes = 1024 + kBars + 8 * (2 * kStages + 1);
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// B4: one block per (64-row q tile, head, batch).
template <int HD>
__global__ void __launch_bounds__(NT, kBlocksPerSM) flash_fwd_kernel_sm90(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ kv_mask,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int Tq,
    int Tk, float scale, int causal) {
  using L = Layout<HD, 1>;
  constexpr int S = L::kStages, TILE = L::kTile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sRing = sQ + TILE;  // stage s: K at 2s tiles, V after it
  const uint32_t bars = sQ + L::kBars;
  const uint32_t q_bar = bars + 16 * S;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  int num_k = (Tk + BK - 1) / BK;
  if (causal) num_k = min(num_k, qt + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_bar, TILE);
      load_tile<HD>(sQ, &tm_q, q_bar, h, qt * BQ, b);
      for (int j = 0; j < num_k; ++j) {
        const int s = j % S;
        mbar_wait(bars + 8 * (S + s), ((j / S) & 1) ^ 1);
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, 2 * TILE);
        load_tile<HD>(sRing + 2 * s * TILE, &tm_k, full, h, j * BK, b);
        load_tile<HD>(sRing + (2 * s + 1) * TILE, &tm_v, full, h, j * BK, b);
      }
    }
  } else {  // consumer warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
    const int tid = threadIdx.x, lane = tid % 32;
    const int r0 = (tid / 32) * 16 + lane / 4;   // rows r0 and r0 + 8
    const int qpos[2] = {qt * BQ + r0, qt * BQ + r0 + 8};
    mbar_wait(q_bar, 0);
    scale_tile<HD>(smem, scale, tid);

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    for (int j = 0; j < num_k; ++j) {
      const int s = j % S;
      const bool masked = needs_mask(kv_mask, Tk, causal, qt, j);
      const uint32_t keys = masked ? key_bits(kv_mask, b, Tk, j, lane) : 0;
      mbar_wait(bars + 8 * s, (j / S) & 1);
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      pin(sc);
      wg_fence();
      product_nt<HD>(sc, sQ, sRing + 2 * s * TILE);
      wg_commit();
      wg_wait_all();
      pin(sc);

      if (masked) mask_scores(sc, keys, causal, qpos, j, lane);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float alpha[2], ml[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(m[hh], quad_max(mx[hh]));
        alpha[hh] = ex2(fminf(m[hh] - m_new, 0.f) * kLog2e);
        m[hh] = m_new;
        ml[hh] = m_new * kLog2e;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i / 2) % 2;
        const float p =
            sc[i] > kNegInf * 0.5f ? ex2(fmaf(sc[i], kLog2e, -ml[hh])) : 0.f;
        sum[hh] += p;
        sc[i] = p;
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + quad_sum(sum[hh]);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      uint32_t pf[4][4];
      to_fragments(sc, pf);

      pin(o);
      wg_fence();
      product_nn<HD>(o, pf, sRing + (2 * s + 1) * TILE);
      wg_commit();
      wg_wait_all();
      pin(o);
      mbar_arrive(bars + 8 * (S + s));  // this thread is done with stage s
    }

    const long rs = (long)H * HD;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (qpos[hh] >= Tq) continue;
      const float denom = fmaxf(l[hh], 1e-30f);
      __nv_bfloat16* row = out + ((long)b * Tq + qpos[hh]) * rs + (long)h * HD;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const int col = 8 * i + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(
            o[4 * i + 2 * hh] / denom, o[4 * i + 2 * hh + 1] / denom);
      }
      if (lane % 4 == 0)
        lse[((long)b * H + h) * Tq + qpos[hh]] = m[hh] + logf(denom);
    }
  }
}

// B5: one block per (64-row q tile, head, batch); dq summed over the K tiles
// in order inside the block.
template <int HD>
__global__ void __launch_bounds__(NT, kBlocksPerSM) flash_dq_kernel_sm90(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do,
    const int* __restrict__ kv_mask, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H,
    int Tq, int Tk, float scale, int causal) {
  using L = Layout<HD, 2>;
  constexpr int S = L::kStages, TILE = L::kTile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sO = sQ + TILE;         // dO
  const uint32_t sRing = sO + TILE;
  const uint32_t bars = sQ + L::kBars;
  const uint32_t q_bar = bars + 16 * S;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  int num_k = (Tk + BK - 1) / BK;
  if (causal) num_k = min(num_k, qt + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_bar, 2 * TILE);
      load_tile<HD>(sQ, &tm_q, q_bar, h, qt * BQ, b);
      load_tile<HD>(sO, &tm_do, q_bar, h, qt * BQ, b);
      for (int j = 0; j < num_k; ++j) {
        const int s = j % S;
        mbar_wait(bars + 8 * (S + s), ((j / S) & 1) ^ 1);
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, 2 * TILE);
        load_tile<HD>(sRing + 2 * s * TILE, &tm_k, full, h, j * BK, b);
        load_tile<HD>(sRing + (2 * s + 1) * TILE, &tm_v, full, h, j * BK, b);
      }
    }
  } else {  // consumer warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
    const int tid = threadIdx.x, lane = tid % 32;
    const int r0 = (tid / 32) * 16 + lane / 4;   // rows r0 and r0 + 8
    const int qpos[2] = {qt * BQ + r0, qt * BQ + r0 + 8};
    float lse2[2], row_delta[2];   // lse in base 2
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const bool live = qpos[hh] < Tq;
      const long row = ((long)b * H + h) * Tq + qpos[hh];
      lse2[hh] = live ? lse[row] * kLog2e : 0.f;
      row_delta[hh] = live ? delta[row] : 0.f;
    }
    mbar_wait(q_bar, 0);
    scale_tile<HD>(smem, scale, tid);

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    for (int j = 0; j < num_k; ++j) {
      const int s = j % S;
      const bool masked = needs_mask(kv_mask, Tk, causal, qt, j);
      const uint32_t keys = masked ? key_bits(kv_mask, b, Tk, j, lane) : 0;
      mbar_wait(bars + 8 * s, (j / S) & 1);
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      pin(sc);
      pin(dp);
      wg_fence();
      product_nt<HD>(sc, sQ, sRing + 2 * s * TILE);
      product_nt<HD>(dp, sO, sRing + (2 * s + 1) * TILE);
      wg_commit();
      wg_wait_all();
      pin(sc);
      pin(dp);

      if (masked) mask_scores(sc, keys, causal, qpos, j, lane);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i / 2) % 2;
        const float p = sc[i] > kNegInf * 0.5f
                            ? ex2(fmaf(sc[i], kLog2e, -lse2[hh]))
                            : 0.f;
        sc[i] = p * (dp[i] - row_delta[hh]);   // ds
      }
      uint32_t dsf[4][4];
      to_fragments(sc, dsf);

      pin(acc);
      wg_fence();
      product_nn<HD>(acc, dsf, sRing + 2 * s * TILE);
      wg_commit();
      wg_wait_all();
      pin(acc);
      mbar_arrive(bars + 8 * (S + s));  // this thread is done with stage s
    }

    const long rs = (long)H * HD;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (qpos[hh] >= Tq) continue;
      __nv_bfloat16* row = dq + ((long)b * Tq + qpos[hh]) * rs + (long)h * HD;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const int col = 8 * i + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(
            acc[4 * i + 2 * hh] * scale, acc[4 * i + 2 * hh + 1] * scale);
      }
    }
  }
}

// B6's shared memory: K and V resident, the q/dO ring, each stage's lse
// (base 2) and delta of its 64 q rows, then the barriers: full[stages],
// empty[stages], kv. Two blocks per SM at hd 64 (83 KB each), one at 128.
template <int HD>
struct DkvLayout {
  static constexpr int kStages = 4;
  static constexpr int kBlocksPerSM = HD == 64 ? 2 : 1;
  static constexpr int kTile = (HD / 64) * kBox;
  static constexpr int kRows = (2 + 2 * kStages) * kTile;   // lse / delta
  static constexpr int kBars = kRows + kStages * 2 * BQ * 4;
  static constexpr size_t kBytes = 1024 + kBars + 8 * (2 * kStages + 1);
};
constexpr int kDkvThreads = kConsumers + 32;   // + one producer warp

// B6: one block per (head, batch, 64-row K/V tile); dk and dv summed over the
// q tiles in order inside the block.
template <int HD>
__global__ void __launch_bounds__(kDkvThreads, DkvLayout<HD>::kBlocksPerSM)
    flash_dkv_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const int* __restrict__ kv_mask,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int H, int Tq,
                          int Tk, float scale, int causal) {
  using L = DkvLayout<HD>;
  constexpr int S = L::kStages, TILE = L::kTile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + TILE;
  const uint32_t sRing = sV + TILE;  // stage s: q at 2s tiles, dO after it
  // stage s: lse2 (lse log2 e) of its q rows at 2 BQ s, delta after it
  float* rows = reinterpret_cast<float*>(smem + L::kRows);
  const uint32_t bars = sK + L::kBars;
  const uint32_t kv_bar = bars + 16 * S;
  const int h = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 33);   // lane 0 twice, lanes 1-31 once
      mbar_init(bars + 8 * (S + s), kConsumers);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // q tiles wholly before this K tile's diagonal see none of its keys
  const int q_lo = causal ? (kt * BK) / BQ : 0;
  const int n_q = max((Tq + BQ - 1) / BQ - q_lo, 0);

  if (tid >= kConsumers) {  // producer warp
    const int lane = tid - kConsumers;
    if (n_q > 0 && lane == 0) {
      mbar_expect_tx(kv_bar, 2 * TILE);
      load_tile<HD>(sK, &tm_k, kv_bar, h, kt * BK, b);
      load_tile<HD>(sV, &tm_v, kv_bar, h, kt * BK, b);
    }
    for (int j = 0; j < n_q; ++j) {
      const int s = j % S, qt = q_lo + j;
      mbar_wait(bars + 8 * (S + s), ((j / S) & 1) ^ 1);
      const uint32_t full = bars + 8 * s;
      if (lane == 0) {   // the TMA loads first: the plain loads overlap them
        mbar_expect_tx(full, 2 * TILE);
        load_tile<HD>(sRing + 2 * s * TILE, &tm_q, full, h, qt * BQ, b);
        load_tile<HD>(sRing + (2 * s + 1) * TILE, &tm_do, full, h, qt * BQ,
                      b);
      }
      float* st = rows + 2 * BQ * s;
#pragma unroll
      for (int half = 0; half < BQ / 32; ++half) {
        const int c = lane + 32 * half;
        const int qpos = qt * BQ + c;
        const long row = ((long)b * H + h) * Tq + qpos;
        st[c] = qpos < Tq ? lse[row] * kLog2e : 0.f;
        st[BQ + c] = qpos < Tq ? delta[row] : 0.f;
      }
      mbar_arrive(full);   // releases this lane's lse / delta stores
    }
  } else {  // consumer warpgroup
    const int lane = tid % 32;
    const int r0 = (tid / 32) * 16 + lane / 4;   // k rows r0 and r0 + 8
    const int kpos[2] = {kt * BK + r0, kt * BK + r0 + 8};
    bool key_ok[2];   // inside Tk, kv_mask > 0: dk and dv are not zeroed
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      key_ok[hh] = kpos[hh] < Tk && (kv_mask == nullptr ||
                                     kv_mask[(long)b * Tk + kpos[hh]] > 0);
    const float c2 = scale * kLog2e;              // scale folded into ex2
    float ak[HD / 2], av[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) ak[i] = av[i] = 0.f;
    if (n_q > 0) mbar_wait(kv_bar, 0);
    for (int j = 0; j < n_q; ++j) {
      const int s = j % S, qt = q_lo + j;
      // the ragged Tq edge, or (causal) a key past some column's q position
      const bool masked = (qt + 1) * BQ > Tq ||
                          (causal && qt * BQ < (kt + 1) * BK - 1);
      const uint32_t sQ = sRing + 2 * s * TILE, sO = sQ + TILE;
      mbar_wait(bars + 8 * s, (j / S) & 1);
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      pin(st);
      pin(dpt);
      wg_fence();
      product_nt<HD>(st, sK, sQ);    // S^T / scale
      product_nt<HD>(dpt, sV, sO);   // dP^T
      wg_commit();
      wg_wait_all();
      pin(st);
      pin(dpt);

      const float* lse2 = rows + 2 * BQ * s;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 8 * i + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
        const float2 d2 = *reinterpret_cast<const float2*>(lse2 + BQ + col);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * i + 2 * hh + e;
            float p = ex2(fmaf(st[x], c2, -(e ? l2.y : l2.x)));
            if (masked) {
              const int qpos = qt * BQ + col + e;
              const bool ok = qpos < Tq && (!causal || kpos[hh] <= qpos);
              p = ok ? p : 0.f;
            }
            st[x] = p;
            dpt[x] = p * (dpt[x] - (e ? d2.y : d2.x));   // ds
          }
        }
      }
      uint32_t pf[4][4], dsf[4][4];
      to_fragments(st, pf);
      to_fragments(dpt, dsf);

      pin(av);
      pin(ak);
      wg_fence();
      product_nn<HD>(av, pf, sO);    // dV += P^T.dO
      product_nn<HD>(ak, dsf, sQ);   // dK += dS^T.q
      wg_commit();
      wg_wait_all();
      pin(av);
      pin(ak);
      mbar_arrive(bars + 8 * (S + s));  // this thread is done with stage s
    }

    const long rs = (long)H * HD;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (kpos[hh] >= Tk) continue;
      const long off = ((long)b * Tk + kpos[hh]) * rs + (long)h * HD;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const int col = 8 * i + 2 * (lane % 4);
        const int x = 4 * i + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
            key_ok[hh]
                ? __floats2bfloat162_rn(ak[x] * scale, ak[x + 1] * scale)
                : __floats2bfloat162_rn(0.f, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
            key_ok[hh] ? __floats2bfloat162_rn(av[x], av[x + 1])
                       : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
  }
}

// -- host ---------------------------------------------------------------------

// cuTensorMapEncodeTiled belongs to libcuda, which this library does not
// link: it is resolved through the runtime at first use.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a [B, T, H, hd] bf16 tensor as the 4-D (hd, H, T, B) view,
// box (64, 1, 64, 1), 128-byte swizzle, zero fill out of bounds.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int T, int H,
                     int hd) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)H * hd * 2,
                                 (cuuint64_t)T * H * hd * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Shared memory past 48 KB, and, for a kernel that moves registers with
// setmaxnreg (B4, B5), a check of the register count it starts with: two
// blocks of 256 threads give each thread 128 registers, and setmaxnreg
// moves 128 * (128 - 40) of them from the producer warpgroup to the
// consumer warpgroup (216 = 128 + 88), which only balances at 128; a
// consumer waiting on registers no one frees would hang. B6 uses no
// setmaxnreg (entry_regs 0: no check). Done once per kernel (the launchers
// keep the result).
constexpr int kSetmaxnregEntry = 128;
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, int entry_regs) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || entry_regs == 0) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return attr.numRegs == entry_regs ? cudaSuccess
                                    : cudaErrorInvalidKernelImage;
}

template <int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* kv_mask, void* out, void* lse, int B, int H,
                       int Tq, int Tk, float scale, int causal,
                       cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = make_map(&mq, q, B, Tq, H, HD)) != cudaSuccess) return err;
  if ((err = make_map(&mk, k, B, Tk, H, HD)) != cudaSuccess) return err;
  if ((err = make_map(&mv, v, B, Tk, H, HD)) != cudaSuccess) return err;
  const size_t smem = Layout<HD, 1>::kBytes;
  static const cudaError_t ready =
      prepare(flash_fwd_kernel_sm90<HD>, smem, kSetmaxnregEntry);
  if (ready != cudaSuccess) return ready;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel_sm90<HD><<<grid, NT, smem, stream>>>(
      mq, mk, mv, static_cast<const int*>(kv_mask),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), H, Tq, Tk,
      scale, causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* kv_mask, const void* dout, const void* lse,
                      const void* delta, void* dq, int B, int H, int Tq,
                      int Tk, float scale, int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  cudaError_t err;
  if ((err = make_map(&mq, q, B, Tq, H, HD)) != cudaSuccess) return err;
  if ((err = make_map(&mk, k, B, Tk, H, HD)) != cudaSuccess) return err;
  if ((err = make_map(&mv, v, B, Tk, H, HD)) != cudaSuccess) return err;
  if ((err = make_map(&mo, dout, B, Tq, H, HD)) != cudaSuccess) return err;
  const size_t smem = Layout<HD, 2>::kBytes;
  static const cudaError_t ready =
      prepare(flash_dq_kernel_sm90<HD>, smem, kSetmaxnregEntry);
  if (ready != cudaSuccess) return ready;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_dq_kernel_sm90<HD><<<grid, NT, smem, stream>>>(
      mq, mk, mv, mo, static_cast<const int*>(kv_mask),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* kv_mask, const void* dout, const void* lse,
                       const void* delta, void* dk, void* dv, int B, int H,
                       int Tq, int Tk, float scale, int causal,
                       cudaStream_t stream) {
  CUtensorMap mq{}, mk, mv, mo{};
  cudaError_t err;
  if (Tq > 0) {   // with no q row no block reads q or dO
    if ((err = make_map(&mq, q, B, Tq, H, HD)) != cudaSuccess) return err;
    if ((err = make_map(&mo, dout, B, Tq, H, HD)) != cudaSuccess) return err;
  }
  if ((err = make_map(&mk, k, B, Tk, H, HD)) != cudaSuccess) return err;
  if ((err = make_map(&mv, v, B, Tk, H, HD)) != cudaSuccess) return err;
  const size_t smem = DkvLayout<HD>::kBytes;
  static const cudaError_t ready =
      prepare(flash_dkv_kernel_sm90<HD>, smem, 0);
  if (ready != cudaSuccess) return ready;
  // the K tile is the slowest grid dimension: under causal the first K
  // tiles see the most q tiles, and their blocks start first
  const dim3 grid(H, B, (Tk + BK - 1) / BK);
  flash_dkv_kernel_sm90<HD><<<grid, kDkvThreads, smem, stream>>>(
      mq, mk, mv, mo, static_cast<const int*>(kv_mask),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H,
      Tq, Tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pt_flash_fwd_sm90(const void* q, const void* k, const void* v,
                                 const void* kv_mask, void* out, void* lse,
                                 int B, int H, int Tq, int Tk, int hd,
                                 float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch_fwd<64>(q, k, v, kv_mask, out, lse, B, H, Tq, Tk, scale,
                          causal, st);
  if (hd == 128)
    return launch_fwd<128>(q, k, v, kv_mask, out, lse, B, H, Tq, Tk, scale,
                           causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pt_flash_dq_sm90(const void* q, const void* k, const void* v,
                                const void* kv_mask, const void* dout,
                                const void* lse, const void* delta, void* dq,
                                int B, int H, int Tq, int Tk, int hd,
                                float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch_dq<64>(q, k, v, kv_mask, dout, lse, delta, dq, B, H, Tq,
                         Tk, scale, causal, st);
  if (hd == 128)
    return launch_dq<128>(q, k, v, kv_mask, dout, lse, delta, dq, B, H, Tq,
                          Tk, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pt_flash_dkv_sm90(const void* q, const void* k, const void* v,
                                 const void* kv_mask, const void* dout,
                                 const void* lse, const void* delta, void* dk,
                                 void* dv, int B, int H, int Tq, int Tk,
                                 int hd, float scale, int causal,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch_dkv<64>(q, k, v, kv_mask, dout, lse, delta, dk, dv, B, H,
                          Tq, Tk, scale, causal, st);
  if (hd == 128)
    return launch_dkv<128>(q, k, v, kv_mask, dout, lse, delta, dk, dv, B, H,
                           Tq, Tk, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
