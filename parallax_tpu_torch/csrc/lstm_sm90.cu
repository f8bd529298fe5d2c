// The bf16 LSTM recurrence for Hopper (sm_90a): the forward and the
// time-reversed backward, each one persistent, weight-stationary launch per
// pass, their products on wgmma.
//
// Replaces, for bf16 inputs on the shapes that ops/lstm.py routes here
// (`fwd_route`, `bwd_route`), the TPU kernels of
// parallax_tpu/ops/pallas_lstm.py:
//   B1 `_lstm_kernel`     (pl.pallas_call at line 290): pt_lstm_fwd_sm90
//                          with gates == cseq == nullptr
//   B2 `_lstm_kernel_res` (pl.pallas_call at line 299): pt_lstm_fwd_sm90
//                          with the two residual outputs
//   B3 `_lstm_bwd_kernel` (pl.pallas_call at line 477): pt_lstm_bwd_sm90
// fp32 B1/B2 run csrc/lstm_f32_sm90.cu (split-operand TF32 mma.sync: a
// wgmma on fp32 operands is one TF32 product, about 3 decimal digits);
// fp32 B3 and the shapes neither takes stay on csrc/lstm.cu.
//
// Same function and rounding points as csrc/lstm.cu:
//   * gates = xw_t (widened) + hs_{t-1} . w_h, fp32 accumulation; the
//     product is skipped at t = 0 (h_0 = 0); hs_{t-1} is round_bf16(h);
//   * i|f|g|o split, sigma(f + 1), fp32 c carry;
//   * hs_t = round_bf16(sigma(o) tanh c) . w_proj, fp32 accumulation,
//     stored in bf16;
//   * B2 also stores the post-activation gates [T, B, 4H] and c [T, B, H]
//     in bf16, in the layout B3 and _bwd_epilogue read;
//   * B3, for s = T-1 .. 0 with fp32 (dc, dh) carries from 0: dh_tot = g_s
//     + dh, stored in fp32; d_hfull = round_bf16(dh_tot) . w_proj^T; the
//     cell backward from the saved gates and c (c_prev = 0 at s = 0); d_xw_s
//     = d_gates in bf16; dh = round_bf16(d_gates) . w_h^T, skipped after
//     s = 0.
// sigma(x) = 1 / (1 + 2^(-x log2 e)) and tanh(x) = 1 - 2 / (1 + 2^(2x log2
// e)), with ex2.approx and a correctly rounded reciprocal: about 1e-7 from
// expf/tanhf, far below the bf16 rounding of h. Products sum their
// contraction in 64-wide chunks, in order; the projection's two halves (one
// per warpgroup) are added once at the end; B3's dh is one fp32 partial per
// block (its 64 G gate columns) summed in block order.
// tests/test_torch_lstm.py emulates that arithmetic on the CPU against the
// plain version.
//
// Forward design. A grid of nb = H / U blocks, U = 16 G hidden units a
// block (G = 1 or 2, from the SM count: every block must be resident), 256
// threads (two warpgroups), one block per SM, launched cooperatively. Block
// j owns units u0 = j U .. u0 + U - 1.
//   * Resident weights: at the start the block copies its slice of w_h once
//     into shared memory: for each group of 16 units, the 64 columns {gate q
//     H + u0 + 16 g + ul}, K-major (rows = those columns, P contiguous) with
//     the 128-byte swizzle, 8 KB per 64-wide k chunk (64 KB at P 512). It
//     also copies the 8 columns of w_proj that its projection tile needs (H
//     x 8, 32 KB at H 2048). Both stay for all T steps; the fp32 c of the
//     block's units lives in registers for the whole pass.
//   * Gates: warpgroup w takes batch rows 64w .. 64w + 63 (B <= 128). It
//     streams hs_{t-1} through its own TMA ring (64 x 64 boxes, 128-byte
//     swizzle, S stages of 8 KB) and runs [64, P] . [P, 64] per group on
//     wgmma (m64n64k16, both operands from shared memory). A group's 64
//     columns are its 16 units' 4 gates, so each thread's accumulator holds
//     all four gates of 4 units in 2 rows, and the cell runs in registers.
//     It writes its hfull slice (bf16) to a [2, B, H] scratch (two buffers
//     by step parity) and, for B2, the residuals; xw_{t+1} is loaded into
//     registers while the grid waits.
//   * Grid barrier; then the projection: block j computes hs_t's tile of
//     8 columns cg = j mod (P / 8) for the 64-row tiles m = j div (P / 8),
//     + nb / (P / 8), ... (wgmma m64n8k16, w_proj's slice resident). Its two
//     warpgroups split the contraction over H in halves, each streaming
//     hfull boxes through its ring; the second half's sums go through
//     shared memory to the first, which stores hs_t in bf16. One block owns
//     each output element and sums in a fixed order: bitwise repeatable.
//   * Grid barrier (none after the last step).
// Split chosen: output-column tiles, not split-K inside clusters. Each block
// reads the whole of hfull's rows for its tile (256 KB at the LM1B shape,
// 32 MB of L2 reads a step over 128 blocks) where a split-K over clusters of
// 8 would read 8 times less, but needs a DSMEM reduction and a cooperative
// launch with clusters; this is the simpler first design.
//
// Backward design (B3). The forward's blocks of 16 G units, warpgroup rows
// and launch, with G taken the other way round: bwd_route prefers G = 2,
// the fewest blocks, because every block writes a whole [B, P] fp32
// partial of dh that the owners read back (64 blocks at the LM1B shape:
// 16 + 16 MB of partials a step where 128 would move 32 + 32).
//   * Resident weights: the same w_h slice as the forward, stored the same
//     way; for dh it is the B operand MN-major (k = the block's 64 G gate
//     columns, n = P contiguous; the transpose bit). The block's 16 G rows
//     of w_proj, K-major (P contiguous), 2 KB per group and 64-wide k chunk
//     (16 KB at P 512), the B operand of d_hfull. The fp32 dc of the block's
//     units lives in registers for the whole pass.
//   * Prologue: block j owns a fixed slice of the B x P elements (B P / nb
//     of them, contiguous); it writes dh_tot_{T-1} = g_{T-1} into dh_total
//     and, rounded, into a bf16 broadcast buffer dh_bf [2, B, P] (buffer s
//     mod 2). Grid barrier.
//   * Step s, phase 1: each warpgroup streams its 64 rows of dh_bf[s mod 2]
//     through its TMA ring into d_hfull = [64, P] . [P, 16] per group
//     (m64n16k16); runs the cell backward in registers on the residuals it
//     prefetched (gates_s, c_s, c_{s-1}); stores d_xw_s; then, for s > 0,
//     the partial dh_j = round(d_gates)[64, 64 G] . w_h slice^T [64 G, P]
//     (m64n128k16 / m64n64k16, A straight from registers: each gate's
//     m64n16 accumulator is a k16 A fragment, as FlashAttention-3 feeds P
//     to P.V) into an fp32 workspace ws [nb, B, P]. It prefetches the next
//     step's residuals. Grid barrier.
//   * Phase 2 (s > 0): each block sums ws[0 .. nb-1] over its owned slice
//     in block order, adds g_{s-1}, and writes dh_total[s-1] and dh_bf[(s-1)
//     mod 2]. Grid barrier.
// One owner per element, a fixed order everywhere, no data atomics: bitwise
// repeatable.
//
// What bounds it on the H100: one pass at the LM1B shape (T 20, B 128, H
// 2048, P 512) is 27 GFLOP, 0.027 ms at 989 TF/s; its device-memory bytes
// 0.03-0.04 ms. The forward moves per step 16 MB (h to every block) + 32 MB
// (hfull rows to every projection tile) through L2; the backward, over nb
// blocks, nb 128 KB (dh_bf to every block) + nb 256 KB of partials written
// and as many read + about 5 MB of residuals and outputs (45 MB at nb 64).
// Each step runs 2 grid barriers and a
// serial chain (load, wgmma, cell, wgmma, store, barrier); L2 bandwidth,
// the barriers' latency and that chain bound it, not the tensor cores.
//
// Hazards, and what the code does about each:
//  1. Co-residency: a grid barrier over blocks that are not all resident
//     hangs the card. The launch is cudaLaunchCooperativeKernel, which
//     refuses a grid that cannot be resident; ops/lstm.py sizes the grid
//     from the SM count. Every spin (grid barrier, mbarrier) traps after 4
//     s, which the caller sees as a launch error, not a hang.
//  2. Ordering across proxies: hfull, hs_t and dh_bf are written by other
//     blocks with generic stores and read here by TMA (the async proxy). The
//     barrier releases at GPU scope after __syncthreads and __threadfence;
//     each thread that issues TMA loads acquires the counter itself and
//     then runs fence.proxy.async.global before its loads. B3's partials
//     are read with ld.global.cg (L2, never a stale L1 line).
//  3. Barrier state across launches and streams: the counter is a fresh
//     zeroed int per call (the wrapper's torch.zeros on the caller's
//     stream); barrier k waits for the count k nb. The kernels allocate
//     nothing.
//  4. Shared memory: the weight slices + 2 S ring stages (+ 2 KB for the
//     forward) must fit in 227 KB; the routes pick S to fit, and the
//     launchers raise the dynamic shared-memory limit before the launch.
//  5. Layouts and edges: xw, gates and d_xw are [T, B, 4H], gate-major, so a
//     group's columns are four runs of 16 units. B not a multiple of 64
//     and P or H not a multiple of 64 rely on TMA's zero fill (the weight
//     slices are zero past P and H) and on masked stores. TMA needs
//     16-byte strides (P, H multiples of 8); the weight copies use 16-byte
//     loads (16-byte aligned bases, which the wrappers check).
//  6. Transcendentals: see above; no tanh.approx, whose 2^-11 error would
//     compound through c; B3 recomputes tanh(c_s) from the stored bf16 c.

#include <cuda.h>          // CUtensorMap and its enums; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;                // two warpgroups
constexpr int kBox = 64 * 64 * 2;      // one 64 x 64 bf16 box
constexpr int kPBox = 8 * 64 * 2;      // one 8 x 64 bf16 w_proj chunk
constexpr int kRed = 128 * 4 * 4;      // the projection's half sums
constexpr int kMaxSmem = 232448;       // 227 KB, sm_90's per-block limit
constexpr float kLog2e = 1.4426950408889634f;

// -- shared memory, barriers, TMA ----------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
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

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  SpinGuard guard;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    guard.tick();
  }
}

// One 64 x 64 box of a 3-D (k, row, slab) map at element coordinates.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k, int row,
                                         int slab) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(slab),
      "r"(bar)
      : "memory");
}

// The grid barrier: barrier k of the pass waits for the count k nb. Every
// thread's stores of the phase precede thread 0's release; the threads that
// issue TMA loads (thread 0 of each warpgroup) acquire the count themselves
// and order it before their async-proxy reads.
__device__ __forceinline__ void grid_sync(unsigned* counter,
                                          unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter)
                 : "memory");
  }
  if (threadIdx.x % 128 == 0) {
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
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
  }
  __syncthreads();
}

// -- wgmma ------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: SBO = 1024 (eight
// 128-byte rows). K-major tiles (the contraction contiguous) leave LBO
// unused; MN-major ones (N contiguous) set it to the distance between
// 64-column boxes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr,
                                              uint32_t lbo = 16) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
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
// the 128 threads of warpgroup wg: every warp has finished its wgmma on a
// stage before one thread refills it
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], both K-major in shared memory.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t desc_a,
                                          uint64_t desc_b) {
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
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D[64 x 8] += A[64 x 16] . B[16 x 8], both K-major in shared memory.
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t desc_a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D[64 x 16] += A[64 x 16] . B[16 x 16], both K-major in shared memory.
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t desc_a,
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (bf16 pairs in
// the accumulator's row/column order), B from shared memory MN-major (N
// contiguous, the 128-byte swizzle; the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
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

// D[64 x 128] += A[64 x 16] . B[16 x 128], as wgmma_rs_n64 over two
// 64-column boxes (LBO apart).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
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

// -- the cell -------------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float sigmoid_f(float x) {
  return __frcp_rn(1.f + ex2(-x * kLog2e));
}
__device__ __forceinline__ float tanh_f(float x) {
  return 1.f - 2.f * __frcp_rn(1.f + ex2(2.f * kLog2e * x));
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of element (row n, k) of a K-major tile with 128-byte rows
// and the 128-byte swizzle (16-byte chunk k / 8 of row n at chunk (k / 8)
// xor (n mod 8)), as TMA writes it; k < 64.
__device__ __forceinline__ uint32_t swz(int n, int k) {
  return n * 128 + (((k >> 3) ^ (n & 7)) << 4) + (k & 7) * 2;
}

// -- the pieces both kernels share -------------------------------------------

// A warpgroup's TMA ring of S stages of one 64 x 64 box each, with a full
// barrier per stage: chunk n of the pass sits in stage n mod S and
// completes phase (n / S) mod 2 of that stage's barrier. Thread 0 of the
// warpgroup issues the loads.
struct Ring {
  uint32_t stages, full;   // shared addresses: the boxes, the barriers
  int S, wg, wt;
  uint32_t n_done = 0;

  // stream `count` boxes at k = 64 (c0 + i), rows 64 m of slab `slab`
  // through the ring, calling mma(stage address, chunk index) on each
  template <typename Mma>
  __device__ __forceinline__ void stream(const CUtensorMap* map, int c0,
                                         int count, int m, int slab,
                                         Mma mma) {
    if (wt == 0)
      for (int i = 0; i < min(S, count); ++i) {
        const int s = (n_done + i) % S;
        mbar_expect_tx(full + 8 * s, kBox);
        tma_load(stages + s * kBox, map, full + 8 * s, 64 * (c0 + i), 64 * m,
                 slab);
      }
    for (int i = 0; i < count; ++i) {
      const uint32_t n = n_done + i, s = n % S;
      mbar_wait(full + 8 * s, (n / S) & 1);
      mma(stages + s * kBox, c0 + i);
      if (i + S < count) {
        wg_sync(wg);
        if (wt == 0) {
          mbar_expect_tx(full + 8 * s, kBox);
          tma_load(stages + s * kBox, map, full + 8 * s, 64 * (c0 + i + S),
                   64 * m, slab);
        }
      }
    }
    n_done += count;
  }
};

// The block's w_h slice, copied once into K-major boxes at `wh`: for each
// group g of 16 units, the 64 columns {gate q H + u0 + 16 g + ul} as rows
// q 16 + ul, P contiguous in 64-wide chunks (zero past P). One 16-byte load
// is 8 consecutive units of one gate at one k.
template <int G>
__device__ __forceinline__ void copy_wh_slice(uint8_t* wh,
                                              const bf16* __restrict__ w_h,
                                              int u0, int H, int P) {
  const int KC = (P + 63) / 64;
  const long H4 = 4L * H;
  for (int v = threadIdx.x; v < G * 8 * KC * 64; v += NT) {
    const int k = v / (G * 8), r = v % (G * 8);
    const int g = r / 8, q = (r % 8) / 2, h8 = r % 2;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (k < P)
      val = *reinterpret_cast<const uint4*>(
          w_h + (long)k * H4 + (long)q * H + u0 + 16 * g + 8 * h8);
    const bf16* e8 = reinterpret_cast<const bf16*>(&val);
    bf16* box = reinterpret_cast<bf16*>(wh + (g * KC + k / 64) * kBox);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      box[swz(q * 16 + 8 * h8 + e, k % 64) / 2] = e8[e];
  }
}

// -- the kernel -------------------------------------------------------------------

// Layout of the dynamic shared memory (from a 1024-byte aligned base):
// w_h slice [G][KC] boxes, w_proj slice [KH] chunks, the two warpgroups'
// rings [2][S] boxes, the projection's half sums, then the rings' full
// barriers [2][S].
struct Smem {
  int wh, wp, ring, red, bars, bytes;
  __host__ __device__ Smem(int G, int P, int H, int S) {
    const int KC = (P + 63) / 64, KH = (H + 63) / 64;
    wh = 0;
    wp = G * KC * kBox;
    ring = wp + KH * kPBox;
    red = ring + 2 * S * kBox;
    bars = red + kRed;
    bytes = 1024 + bars + 2 * S * 8;
  }
};

template <int G, bool RES>
__global__ void __launch_bounds__(NT, 1) lstm_fwd_kernel_sm90(
    const __grid_constant__ CUtensorMap tm_h,
    const __grid_constant__ CUtensorMap tm_f, const bf16* __restrict__ xw,
    const bf16* __restrict__ w_h, const bf16* __restrict__ w_proj,
    bf16* __restrict__ hs, bf16* __restrict__ gates, bf16* __restrict__ cseq,
    bf16* __restrict__ hfull, unsigned* __restrict__ counter, int T, int B,
    int H, int P, int S) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const Smem L(G, P, H, S);
  const int KC = (P + 63) / 64, KH = (H + 63) / 64;
  const uint32_t base = smem_u32(smem);
  const uint32_t sWh = base + L.wh, sWp = base + L.wp;
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int lane = tid % 32;
  Ring ring{base + L.ring + wg * S * kBox, base + L.bars + wg * S * 8, S,
            wg, wt};
  const int nb = gridDim.x, j = blockIdx.x;
  const int u0 = j * 16 * G;
  const int MT = (B + 63) / 64;            // 64-row tiles of the batch
  const int NCG = P / 8, R = nb / NCG;     // projection: column tiles, rows
  const int cg = j % NCG, rsplit = j / NCG;
  const long H4 = 4L * H;

  if (tid == 0) {
    for (int i = 0; i < 2 * S; ++i) mbar_init(base + L.bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  copy_wh_slice<G>(smem + L.wh, w_h, u0, H, P);
  // the w_proj slice: columns cg * 8 .. cg * 8 + 7, one 16-byte load a k
  for (int k = tid; k < KH * 64; k += NT) {
    uint4 val = make_uint4(0, 0, 0, 0);
    if (k < H)
      val = *reinterpret_cast<const uint4*>(w_proj + (long)k * P + cg * 8);
    const bf16* e8 = reinterpret_cast<const bf16*>(&val);
    bf16* chunk = reinterpret_cast<bf16*>(smem + L.wp + (k / 64) * kPBox);
#pragma unroll
    for (int n = 0; n < 8; ++n) chunk[swz(n, k % 64) / 2] = e8[n];
  }
  // the generic-proxy writes must be visible to wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // this thread's rows (r0, r0 + 8) and units (u0 + 16 g + 8 p + cu + e)
  const int r0 = 64 * wg + (wt / 32) * 16 + lane / 4;
  const int cu = 2 * (lane % 4);
  const bool gate_wg = wg < MT;
  float c_st[G][8];       // [g][p * 4 + hh * 2 + e]
  uint32_t xv[G][16];     // xw_t pairs, [g][q * 4 + p * 2 + hh]
  auto load_xw = [&](int t) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = r0 + 8 * hh;
            xv[g][q * 4 + p * 2 + hh] =
                row < B ? *reinterpret_cast<const uint32_t*>(
                              xw + ((long)t * B + row) * H4 + (long)q * H +
                              u0 + 16 * g + 8 * p + cu)
                        : 0u;
          }
  };
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) c_st[g][i] = 0.f;
  if (gate_wg) load_xw(0);

  unsigned barrier = 0;
  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    bf16* hf = hfull + (long)buf * B * H;
    // ---- gates and cell ----------------------------------------------------
    if (gate_wg) {
      float acc[G][32];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[g][i] = 0.f;
      if (t > 0) {
        ring.stream(&tm_h, 0, KC, wg, t - 1, [&](uint32_t a, int c) {
#pragma unroll
          for (int g = 0; g < G; ++g) pin(acc[g]);
          wg_fence();
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const uint32_t b = sWh + (g * KC + c) * kBox;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_n64(acc[g], smem_desc(a + kk * 32),
                        smem_desc(b + kk * 32));
          }
          wg_commit();
          wg_wait_all();
#pragma unroll
          for (int g = 0; g < G; ++g) pin(acc[g]);
        });
      }
      // acc[g][8 q + 4 p + 2 hh + e]: gate q of unit 16 g + 8 p + cu + e,
      // row r0 + 8 hh
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = r0 + 8 * hh;
            float2 x[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) x[q] = unpack(xv[g][q * 4 + p * 2 + hh]);
            float ig[2], fg[2], gg[2], og[2], cn[2], hv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int a = 4 * p + 2 * hh + e;
              ig[e] = sigmoid_f(acc[g][a] + (e ? x[0].y : x[0].x));
              fg[e] = sigmoid_f(acc[g][8 + a] + (e ? x[1].y : x[1].x) + 1.f);
              gg[e] = tanh_f(acc[g][16 + a] + (e ? x[2].y : x[2].x));
              og[e] = sigmoid_f(acc[g][24 + a] + (e ? x[3].y : x[3].x));
              float& c = c_st[g][p * 4 + hh * 2 + e];
              c = fg[e] * c + ig[e] * gg[e];   // c = 0 at t = 0
              cn[e] = c;
              hv[e] = og[e] * tanh_f(c);
            }
            if (row >= B) continue;
            const int u = u0 + 16 * g + 8 * p + cu;
            *reinterpret_cast<uint32_t*>(hf + (long)row * H + u) =
                pack(hv[0], hv[1]);
            if (RES) {
              bf16* gt = gates + ((long)t * B + row) * H4 + u;
              *reinterpret_cast<uint32_t*>(gt) = pack(ig[0], ig[1]);
              *reinterpret_cast<uint32_t*>(gt + H) = pack(fg[0], fg[1]);
              *reinterpret_cast<uint32_t*>(gt + 2L * H) = pack(gg[0], gg[1]);
              *reinterpret_cast<uint32_t*>(gt + 3L * H) = pack(og[0], og[1]);
              *reinterpret_cast<uint32_t*>(cseq + ((long)t * B + row) * H +
                                           u) = pack(cn[0], cn[1]);
            }
          }
      if (t + 1 < T) load_xw(t + 1);   // lands while the grid waits
    }
    grid_sync(counter, ++barrier * nb);

    // ---- projection: hs_t's 8 columns cg * 8.. for row tiles m -------------
    const int kh0 = (KH + 1) / 2;   // warpgroup 0's chunks of H
    const int c0 = wg == 0 ? 0 : kh0, count = wg == 0 ? kh0 : KH - kh0;
    for (int m = rsplit; m < MT; m += R) {
      float pacc[4] = {0.f, 0.f, 0.f, 0.f};
      ring.stream(&tm_f, c0, count, m, buf, [&](uint32_t a, int c) {
        pin(pacc);
        wg_fence();
        const uint32_t b = sWp + c * kPBox;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_n8(pacc, smem_desc(a + kk * 32), smem_desc(b + kk * 32));
        wg_commit();
        wg_wait_all();
        pin(pacc);
      });
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) red[wt * 4 + i] = pacc[i];
      }
      __syncthreads();
      if (wg == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = 64 * m + (wt / 32) * 16 + lane / 4 + 8 * hh;
          if (row < B)
            *reinterpret_cast<uint32_t*>(hs + ((long)t * B + row) * P +
                                         cg * 8 + cu) =
                pack(pacc[2 * hh] + red[wt * 4 + 2 * hh],
                     pacc[2 * hh + 1] + red[wt * 4 + 2 * hh + 1]);
        }
      }
      __syncthreads();
    }
    if (t + 1 < T) grid_sync(counter, ++barrier * nb);
  }
}

// Layout of B3's dynamic shared memory (from a 1024-byte aligned base):
// the w_h slice [G][KC] boxes, the w_proj rows [G][KC] chunks of 16 rows x
// 64 k, the two warpgroups' rings [2][S] boxes, then the rings' full
// barriers [2][S].
constexpr int kRows = 16 * 64 * 2;     // 16 w_proj rows x 64 k, bf16
struct BwdSmem {
  int wh, wp, ring, bars, bytes;
  __host__ __device__ BwdSmem(int G, int P, int S) {
    const int KC = (P + 63) / 64;
    wh = 0;
    wp = G * KC * kBox;
    ring = wp + G * KC * kRows;
    bars = ring + 2 * S * kBox;
    bytes = 1024 + bars + 2 * S * 8;
  }
};

// An m64nN accumulator, M = N / 2 values a thread (acc[4 i + 2 hh + e]: row
// r0 + 8 hh, column n0 + 8 i + cu + e), into the fp32 [B, P] rows of `part`,
// masked to B and P.
template <int M>
__device__ __forceinline__ void store_partial(const float (&acc)[M],
                                              float* part, int r0, int cu,
                                              int n0, int B, int P) {
#pragma unroll
  for (int i = 0; i < M / 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh, col = n0 + 8 * i + cu;
      if (row < B && col < P)
        __stcg(reinterpret_cast<float2*>(part + (long)row * P + col),
               make_float2(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]));
    }
}

template <int G>
__global__ void __launch_bounds__(NT, 1) lstm_bwd_kernel_sm90(
    const __grid_constant__ CUtensorMap tm_d, const float* __restrict__ gout,
    const bf16* __restrict__ gates, const bf16* __restrict__ cseq,
    const bf16* __restrict__ w_h, const bf16* __restrict__ w_proj,
    bf16* __restrict__ dxw, float* __restrict__ dhtot, bf16* dh_bf,
    float* ws, unsigned* __restrict__ counter, int T, int B, int H, int P,
    int S) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const BwdSmem L(G, P, S);
  const int KC = (P + 63) / 64;
  const uint32_t base = smem_u32(smem);
  const uint32_t sWh = base + L.wh, sWp = base + L.wp;
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int lane = tid % 32;
  Ring ring{base + L.ring + wg * S * kBox, base + L.bars + wg * S * 8, S,
            wg, wt};
  const int nb = gridDim.x, j = blockIdx.x;
  const int u0 = j * 16 * G;
  const int MT = (B + 63) / 64;
  const long H4 = 4L * H, BP = (long)B * P;

  if (tid == 0) {
    for (int i = 0; i < 2 * S; ++i) mbar_init(base + L.bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  copy_wh_slice<G>(smem + L.wh, w_h, u0, H, P);
  // the block's w_proj rows u0 + 16 g + n: one 16-byte load is 8
  // consecutive k of one row, which is one swizzled 16-byte chunk
  for (int v = tid; v < G * 16 * KC * 8; v += NT) {
    const int row = v / (KC * 8), k = 8 * (v % (KC * 8));
    uint4 val = make_uint4(0, 0, 0, 0);
    if (k < P)
      val = *reinterpret_cast<const uint4*>(w_proj +
                                            (long)(u0 + row) * P + k);
    *reinterpret_cast<uint4*>(smem + L.wp +
                              ((row / 16) * KC + k / 64) * kRows +
                              swz(row % 16, k % 64)) = val;
  }
  // the generic-proxy writes must be visible to wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // dh_tot_s = g_s (+ the sum of the partials in ws, in block order) over
  // this block's slice of the B x P elements, as float2 pairs: into
  // dh_total[s] and, rounded, into dh_bf[s mod 2]
  const long n2 = BP / 2, e2 = (n2 + nb - 1) / nb;
  const long lo = j * e2, hi = min(n2, lo + e2);
  auto reduce = [&](int s, bool partials) {
    const float2* gs = reinterpret_cast<const float2*>(gout + s * BP);
    const float2* w2 = reinterpret_cast<const float2*>(ws);
    float2* out = reinterpret_cast<float2*>(dhtot + s * BP);
    uint32_t* out_bf = reinterpret_cast<uint32_t*>(dh_bf + (s & 1) * BP);
    for (long i = lo + tid; i < hi; i += NT) {
      float2 sum = make_float2(0.f, 0.f);
      if (partials) {
#pragma unroll 16
        for (int z = 0; z < nb; ++z) {
          const float2 v = __ldcg(w2 + z * n2 + i);
          sum.x += v.x;
          sum.y += v.y;
        }
      }
      const float2 gi = gs[i];
      const float2 d = make_float2(gi.x + sum.x, gi.y + sum.y);
      out[i] = d;
      out_bf[i] = pack(d.x, d.y);
    }
  };

  // this thread's rows (r0, r0 + 8) and units (u0 + 16 g + 8 p + cu + e)
  const int r0 = 64 * wg + (wt / 32) * 16 + lane / 4;
  const int cu = 2 * (lane % 4);
  const bool gate_wg = wg < MT;
  float dc[G][8];        // [g][p * 4 + hh * 2 + e]
  uint32_t gv[G][16];    // gates_s pairs, [g][q * 4 + p * 2 + hh]
  uint32_t cv[G][4];     // c_s pairs, [g][p * 2 + hh]
  uint32_t pv[G][4];     // c_{s-1} pairs (0 at s = 0)
  auto load_gates = [&](int s) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = r0 + 8 * hh;
            gv[g][q * 4 + p * 2 + hh] =
                row < B ? *reinterpret_cast<const uint32_t*>(
                              gates + ((long)s * B + row) * H4 + (long)q * H +
                              u0 + 16 * g + 8 * p + cu)
                        : 0u;
          }
  };
  auto load_c = [&](uint32_t (&c)[G][4], int s) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = r0 + 8 * hh;
          c[g][p * 2 + hh] =
              s >= 0 && row < B
                  ? *reinterpret_cast<const uint32_t*>(
                        cseq + ((long)s * B + row) * H + u0 + 16 * g + 8 * p +
                        cu)
                  : 0u;
        }
  };
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) dc[g][i] = 0.f;
  if (gate_wg) {
    load_gates(T - 1);
    load_c(cv, T - 1);
    load_c(pv, T - 2);
  }

  unsigned barrier = 0;
  reduce(T - 1, false);
  grid_sync(counter, ++barrier * nb);
  for (int s = T - 1; s >= 0; --s) {
    // ---- phase 1: d_hfull, the cell backward, d_xw_s, the partial of dh --
    if (gate_wg) {
      float dhf[G][8];   // d_hfull, [g][4 p + 2 hh + e]
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < 8; ++i) dhf[g][i] = 0.f;
      ring.stream(&tm_d, 0, KC, wg, s & 1, [&](uint32_t a, int c) {
#pragma unroll
        for (int g = 0; g < G; ++g) pin(dhf[g]);
        wg_fence();
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const uint32_t b = sWp + (g * KC + c) * kRows;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_n16(dhf[g], smem_desc(a + kk * 32), smem_desc(b + kk * 32));
        }
        wg_commit();
        wg_wait_all();
#pragma unroll
        for (int g = 0; g < G; ++g) pin(dhf[g]);
      });
      // af[g][q]: gate q's d_gates of group g as the A fragment of one k16
      // step (register p * 2 + hh holds row r0 + 8 hh, units 8 p + cu + e)
      uint32_t af[G][4][4];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = r0 + 8 * hh;
            float2 x[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              x[q] = unpack(gv[g][q * 4 + p * 2 + hh]);
            const float2 ct = unpack(cv[g][p * 2 + hh]);
            const float2 cp = unpack(pv[g][p * 2 + hh]);
            float dg[4][2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float ig = e ? x[0].y : x[0].x, fg = e ? x[1].y : x[1].x;
              const float gg = e ? x[2].y : x[2].x, og = e ? x[3].y : x[3].x;
              const float dh = dhf[g][4 * p + 2 * hh + e];
              const float tc = tanh_f(e ? ct.y : ct.x);
              const float d_o = dh * tc;
              float& d = dc[g][p * 4 + hh * 2 + e];
              const float dc_tot = d + dh * og * (1.f - tc * tc);
              const float d_i = dc_tot * gg, d_f = dc_tot * (e ? cp.y : cp.x);
              const float d_g = dc_tot * ig;
              d = dc_tot * fg;
              dg[0][e] = d_i * ig * (1.f - ig);
              dg[1][e] = d_f * fg * (1.f - fg);
              dg[2][e] = d_g * (1.f - gg * gg);
              dg[3][e] = d_o * og * (1.f - og);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q)
              af[g][q][p * 2 + hh] = pack(dg[q][0], dg[q][1]);
            if (row >= B) continue;
            bf16* dx = dxw + ((long)s * B + row) * H4 + u0 + 16 * g + 8 * p +
                       cu;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              *reinterpret_cast<uint32_t*>(dx + (long)q * H) =
                  af[g][q][p * 2 + hh];
          }
      if (s > 0) {
        // dh's partial over the block's gate columns, 128 (or 64) columns
        // of P at a time, into ws[j]
        float* part = ws + (long)j * BP;
        for (int kc = 0; kc < KC; kc += 2) {
          if (kc + 1 < KC) {
            float acc[64];
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[i] = 0.f;
            pin(acc);
            wg_fence();
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                wgmma_rs_n128(acc, af[g][q],
                              smem_desc(sWh + (g * KC + kc) * kBox + q * 2048,
                                        kBox));
            wg_commit();
            wg_wait_all();
            pin(acc);
            store_partial(acc, part, r0, cu, 64 * kc, B, P);
          } else {
            float acc[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[i] = 0.f;
            pin(acc);
            wg_fence();
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                wgmma_rs_n64(acc, af[g][q],
                             smem_desc(sWh + (g * KC + kc) * kBox + q * 2048,
                                       kBox));
            wg_commit();
            wg_wait_all();
            pin(acc);
            store_partial(acc, part, r0, cu, 64 * kc, B, P);
          }
        }
        // the next step's residuals land while the grid waits
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[g][i] = pv[g][i];
        load_gates(s - 1);
        load_c(pv, s - 2);
      }
    }
    if (s == 0) break;
    grid_sync(counter, ++barrier * nb);
    // ---- phase 2: dh_tot_{s-1} over this block's slice -------------------
    reduce(s - 1, true);
    grid_sync(counter, ++barrier * nb);
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

// The map of a [slabs, rows, K] bf16 tensor as the 3-D (K, rows, slabs)
// view, box (64, 64, 1), 128-byte swizzle, zero fill out of bounds.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int slabs, int rows,
                     int K) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows,
                              (cuuint64_t)slabs};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 2,
                                 (cuuint64_t)rows * K * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int G, bool RES>
cudaError_t launch(const void* xw, const void* w_h, const void* w_proj,
                   void* hs, void* gates, void* cseq, void* hfull,
                   void* counter, int T, int B, int H, int P, int S,
                   cudaStream_t stream) {
  CUtensorMap tm_h, tm_f;
  cudaError_t err;
  if ((err = make_map(&tm_h, hs, T, B, P)) != cudaSuccess) return err;
  if ((err = make_map(&tm_f, hfull, 2, B, H)) != cudaSuccess) return err;
  static const cudaError_t ready = cudaFuncSetAttribute(
      lstm_fwd_kernel_sm90<G, RES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (ready != cudaSuccess) return ready;
  const bf16* a_xw = static_cast<const bf16*>(xw);
  const bf16* a_wh = static_cast<const bf16*>(w_h);
  const bf16* a_wp = static_cast<const bf16*>(w_proj);
  bf16* a_hs = static_cast<bf16*>(hs);
  bf16* a_gates = static_cast<bf16*>(gates);
  bf16* a_cseq = static_cast<bf16*>(cseq);
  bf16* a_hfull = static_cast<bf16*>(hfull);
  unsigned* a_counter = static_cast<unsigned*>(counter);
  void* args[] = {&tm_h,   &tm_f,    &a_xw,      &a_wh, &a_wp, &a_hs,
                  &a_gates, &a_cseq, &a_hfull,   &a_counter, &T,   &B,
                  &H,      &P,       &S};
  const int nb = H / (16 * G);
  // cooperative: refused (cudaErrorCooperativeLaunchTooLarge) unless every
  // block can be resident at once, which the grid barriers need
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lstm_fwd_kernel_sm90<G, RES>), dim3(nb),
      dim3(NT), args, Smem(G, P, H, S).bytes, stream);
}

template <int G>
cudaError_t launch_bwd(const void* g, const void* gates, const void* cseq,
                       const void* w_h, const void* w_proj, void* dxw,
                       void* dhtot, void* dh_bf, void* ws, void* counter,
                       int T, int B, int H, int P, int S,
                       cudaStream_t stream) {
  CUtensorMap tm_d;
  cudaError_t err;
  if ((err = make_map(&tm_d, dh_bf, 2, B, P)) != cudaSuccess) return err;
  static const cudaError_t ready = cudaFuncSetAttribute(
      lstm_bwd_kernel_sm90<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (ready != cudaSuccess) return ready;
  const float* a_g = static_cast<const float*>(g);
  const bf16* a_gates = static_cast<const bf16*>(gates);
  const bf16* a_cseq = static_cast<const bf16*>(cseq);
  const bf16* a_wh = static_cast<const bf16*>(w_h);
  const bf16* a_wp = static_cast<const bf16*>(w_proj);
  bf16* a_dxw = static_cast<bf16*>(dxw);
  float* a_dhtot = static_cast<float*>(dhtot);
  bf16* a_dhbf = static_cast<bf16*>(dh_bf);
  float* a_ws = static_cast<float*>(ws);
  unsigned* a_counter = static_cast<unsigned*>(counter);
  void* args[] = {&tm_d,  &a_g,    &a_gates, &a_cseq, &a_wh,
                  &a_wp,  &a_dxw,  &a_dhtot, &a_dhbf, &a_ws,
                  &a_counter, &T,  &B,       &H,      &P,
                  &S};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lstm_bwd_kernel_sm90<G>),
      dim3(H / (16 * G)), dim3(NT), args, BwdSmem(G, P, S).bytes, stream);
}

}  // namespace

// B1 (gates == cseq == nullptr) and B2 in bf16: xw [T, B, 4H], w_h
// [P, 4H], w_proj [H, P], hs [T, B, P], gates [T, B, 4H], cseq [T, B, H];
// scratch hfull [2, B, H] bf16 and counter, one zeroed 32-bit int. groups
// (G: 16 G units a block) and stages (S: each warpgroup's ring) come from
// ops/lstm.py's fwd_route; a shape outside what the kernel takes returns
// cudaErrorInvalidValue.
extern "C" int pt_lstm_fwd_sm90(const void* xw, const void* w_h,
                                const void* w_proj, void* hs, void* gates,
                                void* cseq, void* hfull, void* counter, int T,
                                int B, int H, int P, int groups, int stages,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool res = gates != nullptr;
  if (res != (cseq != nullptr) || (groups != 1 && groups != 2) ||
      stages < 2 || T < 1 || B < 1 || B > 128 || P < 8 || P % 8 != 0 ||
      H % (16 * groups) != 0 || (H / (16 * groups)) % (P / 8) != 0 ||
      Smem(groups, P, H, stages).bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (groups == 1)
    return res ? (int)launch<1, true>(xw, w_h, w_proj, hs, gates, cseq, hfull,
                                      counter, T, B, H, P, stages, st)
               : (int)launch<1, false>(xw, w_h, w_proj, hs, gates, cseq,
                                       hfull, counter, T, B, H, P, stages, st);
  return res ? (int)launch<2, true>(xw, w_h, w_proj, hs, gates, cseq, hfull,
                                    counter, T, B, H, P, stages, st)
             : (int)launch<2, false>(xw, w_h, w_proj, hs, gates, cseq, hfull,
                                     counter, T, B, H, P, stages, st);
}

// B3 in bf16: g [T, B, P] fp32, gates [T, B, 4H], cseq [T, B, H], w_h
// [P, 4H], w_proj [H, P]; d_xw [T, B, 4H] bf16 and dh_total [T, B, P] fp32
// out; scratch dh_bf [2, B, P] bf16, ws [H / 16G, B, P] fp32 and counter,
// one zeroed 32-bit int. groups (G) and stages (S) come from ops/lstm.py's
// bwd_route; a shape outside what the kernel takes returns
// cudaErrorInvalidValue.
extern "C" int pt_lstm_bwd_sm90(const void* g, const void* gates,
                                const void* cseq, const void* w_h,
                                const void* w_proj, void* dxw, void* dhtot,
                                void* dh_bf, void* ws, void* counter, int T,
                                int B, int H, int P, int groups, int stages,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((groups != 1 && groups != 2) || stages < 2 || T < 1 || B < 1 ||
      B > 128 || P < 8 || P % 8 != 0 || H % (16 * groups) != 0 ||
      BwdSmem(groups, P, stages).bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return groups == 1
             ? (int)launch_bwd<1>(g, gates, cseq, w_h, w_proj, dxw, dhtot,
                                  dh_bf, ws, counter, T, B, H, P, stages, st)
             : (int)launch_bwd<2>(g, gates, cseq, w_h, w_proj, dxw, dhtot,
                                  dh_bf, ws, counter, T, B, H, P, stages, st);
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
