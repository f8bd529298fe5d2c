// LSTM recurrence kernels for Hopper (sm_90a): the forward, the forward
// that saves residuals, and the time-reversed backward.
//
// Replace the TPU kernels of parallax_tpu/ops/pallas_lstm.py:
//   B1 `_lstm_kernel`     (pl.pallas_call at line 290): pt_lstm_fwd with
//                          gates == cseq == nullptr
//   B2 `_lstm_kernel_res` (pl.pallas_call at line 299): pt_lstm_fwd with
//                          the two residual outputs
//   B3 `_lstm_bwd_kernel` (pl.pallas_call at line 477): pt_lstm_bwd
// Same function, same rounding points as the Pallas kernels:
//   * gates = xw_t (widened to fp32) + round_w(h) @ w_h, fp32 accumulation;
//     split i|f|g|o, sigma(f + 1); c is an fp32 carry;
//   * h = round_w(sigma(o) * tanh c) @ w_proj, fp32 accumulation; the
//     output hs_t is h in the compute dtype. The compute, weight and output
//     dtypes are one dtype here (the wrapper checks it), so round_w(h) of
//     the next step IS hs_t, and the gates kernel reads hs_{t-1} directly:
//     no fp32 h carry is kept;
//   * B2 also stores the post-activation gates and c at the compute dtype;
//   * B3 runs s = T-1 .. 0 with fp32 (dc, dh) carries: dh_tot = g_s + dh
//     is streamed out in fp32, d_hfull = round_w(dh_tot) @ w_proj^T, the
//     cell backward (c_prev zeroed at s = 0), d_gates stored as d_xw at the
//     compute dtype, and dh = round_w(d_gates) @ w_h^T (round_w(d_gates) is
//     the stored d_xw, which the dh kernel reads).
//
// What runs here: fp32 B3, and B1/B2 at the shapes the persistent
// kernels do not take (ops/lstm.py's fwd_route and bwd_route): bf16 B1-B3
// run csrc/lstm_sm90.cu and fp32 B1/B2 csrc/lstm_f32_sm90.cu where those
// take the shape (the LM1B step, lm1b_eval and the drift sentinels on an
// H100). This first version stays built for the rest, and chip_smoke.py
// times it beside the fp32 persistent forward as that row's "earlier".
//
// Design: per-timestep launches, chosen over a persistent cooperative grid
// because it is short and obviously right at any shape. Each step of the
// forward is three launches (gates + cell; the projection, split over its
// contraction; the sum of the splits); each step of the backward is three
// (projection-transpose + cell backward; the recurrent-transpose product,
// split; the sum that writes the next dh_tot). The launcher below issues
// all of a pass's launches from one host call, on the caller's stream.
// Every product is a tiled fp32-FMA GEMM out of shared memory (BK = 16):
// fp32 results match the plain version to ~1e-6, as PR 1's kernels do.
// The gates tile holds 16 hidden units x their 4 gate columns, so each
// thread owns all four gates of one unit and runs the cell update in
// registers: the [B, 4H] pre-activations never reach device memory.
//
// What bounds it on the H100: at the flagship per-card shape (T 20, B 128,
// E 512, H 2048, P 512, bf16) one pass is 2*T*B*(P*4H + H*P) = 27 GFLOP,
// 0.027 ms at 989 TF/s, and kernel_hbm_bytes' streams are 0.03-0.04 ms at
// 3.35 TB/s. This kernel runs its products on the CUDA cores (fp32 FMA,
// 67 TF/s peak: 0.4 ms per pass at best) and re-reads w_h / w_proj from
// the L2 cache every step (8.4 MB bf16 fits in the 50 MB L2), so the
// CUDA-core FMA rate bounds it. Keeping the weights resident across SMs
// (the persistent-RNN scheme) and moving the products to wgmma are the
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int BK = 16;   // depth of one shared-memory k tile

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
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// acc[TM][TN] += A[m0.., k_begin:k_end] @ B[k_begin:k_end, n0..] for this
// thread's TM x TN micro-tile at rows ty*TM.., columns tx*TN.. of the
// BM x BN block tile. load_a(sA, i, k0) / load_b(sB, i, k0) fill element i
// of the k tile starting at k0 (sA is [BK][BM], sB is [BK][BN], zero
// outside the matrices); each picks its own index order so that
// neighbouring threads read neighbouring addresses. k_begin is a multiple
// of BK.
template <int BM, int BN, int TM, int TN, class LA, class LB>
__device__ __forceinline__ void mainloop(int k_begin, int k_end, LA load_a,
                                         LB load_b, float (&acc)[TM][TN]) {
  static_assert((BM / TM) * (BN / TN) == NT, "one micro-tile per thread");
  __shared__ float sA[BK * BM];
  __shared__ float sB[BK * BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) load_a(sA, i, k0);
    for (int i = tid; i < BK * BN; i += NT) load_b(sB, i, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sA[kk * BM + ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sB[kk * BN + tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
}

// ---- forward: gates + cell (B1 without, B2 with the residuals) ----------
constexpr int G_BM = 64, G_UNITS = 16, G_BN = 4 * G_UNITS, G_TM = 4;

template <typename T, bool RES>
__global__ void __launch_bounds__(NT) lstm_gates_kernel(
    const T* __restrict__ xw_t, const T* __restrict__ h_prev,
    const T* __restrict__ w_h, float* __restrict__ c, T* __restrict__ hfull,
    T* __restrict__ gates_t, T* __restrict__ c_t, int B, int H, int P) {
  const int m0 = blockIdx.y * G_BM, u0 = blockIdx.x * G_UNITS;
  const long H4 = 4L * H;
  float acc[G_TM][4] = {};
  if (h_prev != nullptr) {  // h_0 = 0: the first step is xw_0 alone
    auto load_a = [&](float* s, int i, int k0) {
      const int ml = i / BK, kl = i % BK, m = m0 + ml, k = k0 + kl;
      s[kl * G_BM + ml] = (m < B && k < P) ? to_f(h_prev[(long)m * P + k])
                                           : 0.f;
    };
    // column q of the load order is (gate q / 16, unit q % 16): runs of 16
    // consecutive units of one gate; it lands at unit-major column
    // unit * 4 + gate, so each thread's 4 columns are one unit's 4 gates
    auto load_b = [&](float* s, int i, int k0) {
      const int kl = i / G_BN, q = i % G_BN;
      const int gate = q / G_UNITS, ul = q % G_UNITS;
      const int k = k0 + kl, u = u0 + ul;
      s[kl * G_BN + ul * 4 + gate] =
          (k < P && u < H) ? to_f(w_h[(long)k * H4 + (long)gate * H + u])
                           : 0.f;
    };
    mainloop<G_BM, G_BN, G_TM, 4>(0, P, load_a, load_b, acc);
  }
  const int tx = threadIdx.x % G_UNITS, ty = threadIdx.x / G_UNITS;
  const int u = u0 + tx;
  if (u >= H) return;
#pragma unroll
  for (int r = 0; r < G_TM; ++r) {
    const int m = m0 + ty * G_TM + r;
    if (m >= B) continue;
    const T* x = xw_t + (long)m * H4 + u;
    const float ig = sigmoid(acc[r][0] + to_f(x[0]));
    const float fg = sigmoid(acc[r][1] + to_f(x[H]) + 1.f);
    const float gg = tanhf(acc[r][2] + to_f(x[2L * H]));
    const float og = sigmoid(acc[r][3] + to_f(x[3L * H]));
    const long mu = (long)m * H + u;
    const float c_old = h_prev != nullptr ? c[mu] : 0.f;
    const float cn = fg * c_old + ig * gg;
    c[mu] = cn;
    hfull[mu] = from_f<T>(og * tanhf(cn));
    if (RES) {
      T* gt = gates_t + (long)m * H4 + u;
      gt[0] = from_f<T>(ig);
      gt[H] = from_f<T>(fg);
      gt[2L * H] = from_f<T>(gg);
      gt[3L * H] = from_f<T>(og);
      c_t[mu] = from_f<T>(cn);
    }
  }
}

// ---- 32 x 32 tiles for the other three products --------------------------
constexpr int S_BM = 32, S_BN = 32, S_TM = 2, S_TN = 2;

// The two products with a short output ([B, P]) and a long contraction
// (H, 4H) split the contraction over blockIdx.z in slices of kc (a
// multiple of BK): each slice writes its partial sums to ws[z] and a
// second launch adds the slices in order of z, so the result does not
// depend on scheduling. Without the split the grid would be 64 blocks at
// the training shape.

// partial sums of the forward projection hs_t = hfull @ w_proj,
// [B, H] x [H, P], over h in slice z
template <typename T>
__global__ void __launch_bounds__(NT) lstm_proj_kernel(
    const T* __restrict__ hfull, const T* __restrict__ w_proj,
    float* __restrict__ ws, int B, int H, int P, int kc) {
  const int m0 = blockIdx.y * S_BM, n0 = blockIdx.x * S_BN;
  const int z = blockIdx.z;
  float acc[S_TM][S_TN] = {};
  auto load_a = [&](float* s, int i, int k0) {
    const int ml = i / BK, kl = i % BK, m = m0 + ml, k = k0 + kl;
    s[kl * S_BM + ml] = (m < B && k < H) ? to_f(hfull[(long)m * H + k]) : 0.f;
  };
  auto load_b = [&](float* s, int i, int k0) {
    const int kl = i / S_BN, nl = i % S_BN, k = k0 + kl, n = n0 + nl;
    s[kl * S_BN + nl] = (k < H && n < P) ? to_f(w_proj[(long)k * P + n]) : 0.f;
  };
  mainloop<S_BM, S_BN, S_TM, S_TN>(z * kc, min(H, (z + 1) * kc), load_a,
                                   load_b, acc);
  const int tx = threadIdx.x % (S_BN / S_TN), ty = threadIdx.x / (S_BN / S_TN);
  float* part = ws + (long)z * B * P;
#pragma unroll
  for (int i = 0; i < S_TM; ++i)
#pragma unroll
    for (int j = 0; j < S_TN; ++j) {
      const int m = m0 + ty * S_TM + i, n = n0 + tx * S_TN + j;
      if (m < B && n < P) part[(long)m * P + n] = acc[i][j];
    }
}

// hs_t = sum over z of the projection's slices, in the compute dtype
template <typename T>
__global__ void __launch_bounds__(NT) lstm_proj_reduce_kernel(
    const float* __restrict__ ws, T* __restrict__ hs_t, long n, int ks) {
  const long i = (long)blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < ks; ++z) s += ws[z * n + i];
  hs_t[i] = from_f<T>(s);
}

// ---- backward, step s: d_hfull = round_w(dh_tot_s) @ w_proj^T, then the
// cell backward; writes d_xw_s and carries dc to step s - 1 --------------
template <typename T>
__global__ void __launch_bounds__(NT) lstm_bwd_cell_kernel(
    const float* __restrict__ dhtot_s, const T* __restrict__ w_proj,
    const T* __restrict__ gates_s, const T* __restrict__ c_s,
    const T* __restrict__ c_prev, float* __restrict__ dc,
    T* __restrict__ dxw_s, int B, int H, int P, int last) {
  const int m0 = blockIdx.y * S_BM, n0 = blockIdx.x * S_BN;
  float acc[S_TM][S_TN] = {};
  auto load_a = [&](float* s, int i, int k0) {
    const int ml = i / BK, kl = i % BK, m = m0 + ml, k = k0 + kl;
    s[kl * S_BM + ml] =
        (m < B && k < P) ? round_to<T>(dhtot_s[(long)m * P + k]) : 0.f;
  };
  // B(k = p, n = unit j) = w_proj[j, p]: k runs along w_proj's rows
  auto load_b = [&](float* s, int i, int k0) {
    const int nl = i / BK, kl = i % BK, k = k0 + kl, n = n0 + nl;
    s[kl * S_BN + nl] = (k < P && n < H) ? to_f(w_proj[(long)n * P + k]) : 0.f;
  };
  mainloop<S_BM, S_BN, S_TM, S_TN>(0, P, load_a, load_b, acc);
  const int tx = threadIdx.x % (S_BN / S_TN), ty = threadIdx.x / (S_BN / S_TN);
  const long H4 = 4L * H;
#pragma unroll
  for (int i = 0; i < S_TM; ++i)
#pragma unroll
    for (int jj = 0; jj < S_TN; ++jj) {
      const int m = m0 + ty * S_TM + i, j = n0 + tx * S_TN + jj;
      if (m >= B || j >= H) continue;
      const float dhf = acc[i][jj];
      const T* gt = gates_s + (long)m * H4 + j;
      const float ig = to_f(gt[0]), fg = to_f(gt[H]);
      const float gg = to_f(gt[2L * H]), og = to_f(gt[3L * H]);
      const long mj = (long)m * H + j;
      const float ct = to_f(c_s[mj]);
      const float cp = c_prev != nullptr ? to_f(c_prev[mj]) : 0.f;
      const float tc = tanhf(ct);
      const float d_o = dhf * tc;
      const float dc_tot = (last ? 0.f : dc[mj]) + dhf * og * (1.f - tc * tc);
      const float d_i = dc_tot * gg, d_f = dc_tot * cp, d_g = dc_tot * ig;
      dc[mj] = dc_tot * fg;
      T* dx = dxw_s + (long)m * H4 + j;
      dx[0] = from_f<T>(d_i * ig * (1.f - ig));
      dx[H] = from_f<T>(d_f * fg * (1.f - fg));
      dx[2L * H] = from_f<T>(d_g * (1.f - gg * gg));
      dx[3L * H] = from_f<T>(d_o * og * (1.f - og));
    }
}

// ---- backward, step s > 0: partial sums of dh = d_xw_s @ w_h^T over the
// gate columns of slice z --------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) lstm_bwd_dh_kernel(
    const T* __restrict__ dxw_s, const T* __restrict__ w_h,
    float* __restrict__ ws, int B, int H, int P, int kc) {
  const int m0 = blockIdx.y * S_BM, n0 = blockIdx.x * S_BN;
  const int z = blockIdx.z;
  const int K = 4 * H;
  float acc[S_TM][S_TN] = {};
  auto load_a = [&](float* s, int i, int k0) {
    const int ml = i / BK, kl = i % BK, m = m0 + ml, k = k0 + kl;
    s[kl * S_BM + ml] = (m < B && k < K) ? to_f(dxw_s[(long)m * K + k]) : 0.f;
  };
  // B(k = gate column, n = p) = w_h[p, k]: k runs along w_h's rows
  auto load_b = [&](float* s, int i, int k0) {
    const int nl = i / BK, kl = i % BK, k = k0 + kl, n = n0 + nl;
    s[kl * S_BN + nl] = (k < K && n < P) ? to_f(w_h[(long)n * K + k]) : 0.f;
  };
  mainloop<S_BM, S_BN, S_TM, S_TN>(z * kc, min(K, (z + 1) * kc), load_a,
                                   load_b, acc);
  const int tx = threadIdx.x % (S_BN / S_TN), ty = threadIdx.x / (S_BN / S_TN);
  float* part = ws + (long)z * B * P;
#pragma unroll
  for (int i = 0; i < S_TM; ++i)
#pragma unroll
    for (int j = 0; j < S_TN; ++j) {
      const int m = m0 + ty * S_TM + i, n = n0 + tx * S_TN + j;
      if (m < B && n < P) part[(long)m * P + n] = acc[i][j];
    }
}

// dh_tot_{s-1} = g_{s-1} + the sum over z of dh's slices
__global__ void __launch_bounds__(NT) lstm_bwd_dh_reduce_kernel(
    const float* __restrict__ ws, const float* __restrict__ g_prev,
    float* __restrict__ dhtot_prev, long n, int ks) {
  const long i = (long)blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < ks; ++z) s += ws[z * n + i];
  dhtot_prev[i] = g_prev[i] + s;
}

inline dim3 grid_for(int rows, int bm, int cols, int bn, int ks = 1) {
  return dim3((cols + bn - 1) / bn, (rows + bm - 1) / bm, ks);
}

// the slice length of a contraction of K split ks ways, a multiple of BK
inline int slice_len(int K, int ks) {
  return ((K + ks - 1) / ks + BK - 1) / BK * BK;
}

template <typename T>
cudaError_t fwd(const void* xw, const void* w_h, const void* w_proj, void* hs,
                void* gates, void* cseq, void* c, void* hfull, void* ws,
                int ks, int Tn, int B, int H, int P, cudaStream_t st) {
  const T* x = static_cast<const T*>(xw);
  T* out = static_cast<T*>(hs);
  T* g = static_cast<T*>(gates);
  T* cs = static_cast<T*>(cseq);
  const long xs = 4L * B * H, hsz = (long)B * P, cz = (long)B * H;
  const dim3 gg = grid_for(B, G_BM, H, G_UNITS);
  const dim3 gp = grid_for(B, S_BM, P, S_BN, ks);
  const int kc = slice_len(H, ks);
  const unsigned gr = (unsigned)((hsz + NT - 1) / NT);
  float* wsf = static_cast<float*>(ws);
  for (int t = 0; t < Tn; ++t) {
    const T* h_prev = t > 0 ? out + (t - 1) * hsz : nullptr;
    if (g != nullptr) {
      lstm_gates_kernel<T, true><<<gg, NT, 0, st>>>(
          x + t * xs, h_prev, static_cast<const T*>(w_h),
          static_cast<float*>(c), static_cast<T*>(hfull), g + t * xs,
          cs + t * cz, B, H, P);
    } else {
      lstm_gates_kernel<T, false><<<gg, NT, 0, st>>>(
          x + t * xs, h_prev, static_cast<const T*>(w_h),
          static_cast<float*>(c), static_cast<T*>(hfull), nullptr, nullptr,
          B, H, P);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    lstm_proj_kernel<T><<<gp, NT, 0, st>>>(static_cast<const T*>(hfull),
                                           static_cast<const T*>(w_proj), wsf,
                                           B, H, P, kc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    lstm_proj_reduce_kernel<T><<<gr, NT, 0, st>>>(wsf, out + t * hsz, hsz, ks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t bwd(const void* g, const void* gates, const void* cseq,
                const void* w_h, const void* w_proj, void* dxw, void* dhtot,
                void* dc, void* ws, int ks, int Tn, int B, int H, int P,
                cudaStream_t st) {
  const float* gf = static_cast<const float*>(g);
  const T* ga = static_cast<const T*>(gates);
  const T* cs = static_cast<const T*>(cseq);
  T* dx = static_cast<T*>(dxw);
  float* dh = static_cast<float*>(dhtot);
  const long xs = 4L * B * H, hsz = (long)B * P, cz = (long)B * H;
  // dh_tot_{T-1} = g_{T-1}: no carry enters the last step
  cudaError_t err = cudaMemcpyAsync(dh + (Tn - 1) * hsz, gf + (Tn - 1) * hsz,
                                    sizeof(float) * hsz,
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return err;
  const dim3 gc = grid_for(B, S_BM, H, S_BN);
  const dim3 gd = grid_for(B, S_BM, P, S_BN, ks);
  const int kc = slice_len(4 * H, ks);
  const unsigned gr = (unsigned)((hsz + NT - 1) / NT);
  float* wsf = static_cast<float*>(ws);
  for (int s = Tn - 1; s >= 0; --s) {
    lstm_bwd_cell_kernel<T><<<gc, NT, 0, st>>>(
        dh + s * hsz, static_cast<const T*>(w_proj), ga + s * xs, cs + s * cz,
        s > 0 ? cs + (s - 1) * cz : nullptr, static_cast<float*>(dc),
        dx + s * xs, B, H, P, s == Tn - 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (s == 0) break;
    lstm_bwd_dh_kernel<T><<<gd, NT, 0, st>>>(
        dx + s * xs, static_cast<const T*>(w_h), wsf, B, H, P, kc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    lstm_bwd_dh_reduce_kernel<<<gr, NT, 0, st>>>(wsf, gf + (s - 1) * hsz,
                                                 dh + (s - 1) * hsz, hsz, ks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// B1 (gates == cseq == nullptr) and B2: xw [T, B, 4H], w_h [P, 4H],
// w_proj [H, P], hs [T, B, P], gates [T, B, 4H], cseq [T, B, H], all of
// the compute dtype; scratch c [B, H] fp32, hfull [B, H] compute dtype and
// ws [ks, B, P] fp32 for the projection's ks contraction slices.
extern "C" int pt_lstm_fwd(const void* xw, const void* w_h,
                           const void* w_proj, void* hs, void* gates,
                           void* cseq, void* c, void* hfull, void* ws, int ks,
                           int T, int B, int H, int P, int is_bf16,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((gates == nullptr) != (cseq == nullptr) || ks < 1)
    return (int)cudaErrorInvalidValue;
  return is_bf16 ? (int)fwd<__nv_bfloat16>(xw, w_h, w_proj, hs, gates, cseq,
                                           c, hfull, ws, ks, T, B, H, P, st)
                 : (int)fwd<float>(xw, w_h, w_proj, hs, gates, cseq, c, hfull,
                                   ws, ks, T, B, H, P, st);
}

// B3: g [T, B, P] fp32, gates [T, B, 4H], cseq [T, B, H], w_h, w_proj of
// the compute dtype; d_xw [T, B, 4H] compute dtype and dh_total [T, B, P]
// fp32 out; scratch dc [B, H] fp32 and ws [ks, B, P] fp32 for the
// recurrent product's ks contraction slices.
extern "C" int pt_lstm_bwd(const void* g, const void* gates, const void* cseq,
                           const void* w_h, const void* w_proj, void* dxw,
                           void* dhtot, void* dc, void* ws, int ks, int T,
                           int B, int H, int P, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ks < 1) return (int)cudaErrorInvalidValue;
  return is_bf16 ? (int)bwd<__nv_bfloat16>(g, gates, cseq, w_h, w_proj, dxw,
                                           dhtot, dc, ws, ks, T, B, H, P, st)
                 : (int)bwd<float>(g, gates, cseq, w_h, w_proj, dxw, dhtot,
                                   dc, ws, ks, T, B, H, P, st);
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
