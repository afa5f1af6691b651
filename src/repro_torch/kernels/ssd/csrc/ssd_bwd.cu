// The backward of kernel K7: the gradient of the Mamba-2 SSD intra-chunk
// block.
//
// Replaces no TPU kernel: the reference differentiates its plain chunked
// scan (src/repro/kernels/ssd/ops.py -> ssd_chunked_ref under jax.grad).
// It is the backward of K7, whose pallas_call is
// src/repro/kernels/ssd/kernel.py:88 (ssd_intra_chunk_pallas, :57), and
// computes the gradient of what that kernel computes, per (batch, head,
// chunk) of length L, for the cotangents dY (L x P) of y_diag and dS
// (N x P) of the chunk's state:
//
//   W  = tril(C B^T o e^{s_t - s_j}) o dt_j      u_j = e^{s_{L-1} - s_j} dt_j
//   dW = tril(dY X^T)                           M   = dW o e^{s_t - s_j} o dt_j
//   dX = W^T dY + (u o B) dS                    dC  = M B
//   dB = M^T C + u o (X dS^T)
//   ddt_j = sum_t (dW o C B^T o e^{s_t - s_j})_tj + e^{s_{L-1} - s_j} R_j
//   ds_t  = sum_j (dW o W)_tj - sum_i (dW o W)_it - E_t  (+ sum_j E_j at t = L-1)
//
// with R_j = sum_n B_jn (X dS^T)_jn and E_j = u_j R_j.  ddt is the direct
// part only: s = chunk_logdecay(dt, A) stays in PyTorch, whose autograd
// carries ds into dt and A through the cumsum.  ssd/ref.py:
// ssd_intra_chunk_backward_ref is the plain version, the same products.
//
// Layouts.  x (Ba, T, H, P), dY (Ba, T, H, P) and B/C (Ba, T, G, N) come
// with their batch, time and head/group strides (the last axis
// contiguous); head h reads group h / (H / G).  dt (Ba, T, H), s (Ba, nc,
// L, H) and dS (Ba, nc, H, N, P) are contiguous float32.  The outputs are
// written contiguous: dX (Ba, T, H, P), ddt (Ba, T, H), ds (Ba, nc, L, H)
// and dB, dC PER HEAD (Ba, T, H, N); the launcher sums dB and dC over each
// group's heads (the adjoint of the per-head repeat, which the reference
// keeps outside its kernel).  Every output element is written by one
// thread in a fixed order: no atomics, two runs are bitwise equal.
//
// Work per block.  One block of 256 threads per (chunk, head, batch), the
// float32 forward's grid; nothing but the inputs is saved by the forward:
// C B^T, the decay and W are recomputed here.  Every product is a 4 x 4
// register tile per thread, float32 FMAs on the CUDA cores, over a
// contraction index k along which both operands lie k-major in shared
// memory (a float4 of each per k).  The phases, each after a barrier:
//   1. load B^T, C^T (N x L), X^T, dY^T (P x L), dt and s; u and the end
//      decay e^{s_{L-1} - s_j};
//   2. per lower (t, j) tile: C B^T over n and dY X^T over p together, then
//      W, M and P1 = dW o C B^T o decay (zeros above the diagonal and past
//      L);
//   3. row and column sums of P1 (ddt's first term, the dW o W part of ds);
//      reload dY and C row-major over their transposes, dS (N x P), and
//      scale B^T by u in place;
//   4. M^T; dX tiles (j, p): W^T dY over t >= j, (u o B) dS over n;
//   5. reload B row-major over (u o B)^T and dS^T (P x N) over dS;
//   6. dC tiles (t, n): M B over j <= t; dB tiles (j, n): M^T C over
//      t >= j, X dS^T over p, and each tile's share of R_j;
//   7. ddt, E, ds per row.
// Rows past a ragged L (50, 5, 1) are zero in every tile and never written.
//
// Shared memory (floats; L4 = L rounded up to 4, LP = L4 + 4, NP = N + 4,
// PP = P + 4, the pads spread columns over the banks and keep rows 16-byte
// aligned): two slots of max(N LP, L4 NP) (B, C in either layout), X^T
// (P LP), dY in either layout, W (later the R shares), M, P1 (later M^T)
// (L4 LP each), dS in either layout (max(N PP, P NP)), and seven L4
// vectors: 193,280 bytes at L 64, N 128, P 64, one block per SM.
//
// Bound.  At mamba2-1.3b's training shape (Ba 4, T 2048, H 64, P 64,
// N 128, G 1, L 64) the inputs x, dY (134 MB each), dS (268 MB), B, C,
// dt, s and the outputs dX (134 MB), dB and dC per head (268 MB each),
// ddt and ds come to ~1.2 GB, 0.36 ms at 3.35 TB/s; the products, counted
// whole (2 L^2 N for C B^T, 2 x 2 L^2 P for dW and W^T dY, 2 x 2 L^2 N for
// dC and dB, 2 x 2 L N P for the dS terms: ~6.3 MFLOP a cell, 8192 cells)
// take 0.77 ms at the float32 CUDA-core rate (67 TFLOP/s), so operations
// bound it.  This first form runs the lower triangles only (~4.3 MFLOP a
// cell) at one block per SM; a tensor-core (3xTF32) form is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;   // bytes of shared memory a block may use (H100)

struct Dims {
  int T, H, G, N, P, L, nc;
  long long xb, xt, xh;  // x strides (elements)
  long long bb, bt, bg;  // B strides
  long long cb, ct, cg;  // C strides
  long long yb, yt, yh;  // dY strides
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline long long mx(long long a, long long b) { return a > b ? a : b; }

// Offsets (floats) of the shared-memory slots; every one a multiple of 4.
struct Slots {
  int L4, LP, NP, PP;
  long long b, c, x, y, w, m, q, s, v, total;
};

__host__ __device__ inline Slots slots(int L, int N, int P) {
  Slots z;
  z.L4 = round4(L);
  z.LP = z.L4 + 4;
  z.NP = N + 4;
  z.PP = P + 4;
  const long long bc = mx(static_cast<long long>(N) * z.LP, static_cast<long long>(z.L4) * z.NP);
  const long long tile = static_cast<long long>(z.L4) * z.LP;
  z.b = 0;
  z.c = z.b + bc;
  z.x = z.c + bc;
  z.y = z.x + static_cast<long long>(P) * z.LP;
  z.w = z.y + mx(static_cast<long long>(P) * z.LP, static_cast<long long>(z.L4) * z.PP);
  z.m = z.w + static_cast<long long>(z.L4) * mx(z.LP, N / 4);
  z.q = z.m + tile;
  z.s = z.q + tile;
  z.v = z.s + mx(static_cast<long long>(N) * z.PP, static_cast<long long>(P) * z.NP);
  z.total = z.v + 7LL * z.L4;
  return z;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&r)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}

// acc[a][q] += u[a] * v[q]
__device__ __forceinline__ void outer(float (&acc)[4][4], const float4 u, const float4 v) {
  const float ur[4] = {u.x, u.y, u.z, u.w}, vr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(ur[a], vr[q], acc[a][q]);
}

__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ dt,
               const float* __restrict__ s, const float* __restrict__ dy,
               const float* __restrict__ dS, float* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ ds, float* __restrict__ dB, float* __restrict__ dC, Dims d) {
  extern __shared__ __align__(16) float sm[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int L = d.L, N = d.N, P = d.P, H = d.H;
  const Slots z = slots(L, N, P);
  const int L4 = z.L4, LP = z.LP, NP = z.NP, PP = z.PP;
  const int g = h / (H / d.G);
  float* sB = sm + z.b;   // B^T [N][LP]; (u o B)^T; then B [L4][NP]
  float* sC = sm + z.c;   // C^T [N][LP]; then C [L4][NP]
  float* sX = sm + z.x;   // X^T [P][LP]
  float* sY = sm + z.y;   // dY^T [P][LP]; then dY [L4][PP]
  float* sW = sm + z.w;   // W [L4][LP]; then the R shares [L4][N/4]
  float* sM = sm + z.m;   // M [L4][LP]
  float* sQ = sm + z.q;   // P1 [L4][LP]; then M^T [L4][LP]
  float* sS = sm + z.s;   // dS [N][PP]; then dS^T [P][NP]
  float* vdt = sm + z.v;  // dt, s, u, end decay, ddt's first term, ds's dW o W part, E
  float* vs = vdt + L4;
  float* vu = vs + L4;
  float* vend = vu + L4;
  float* vddt = vend + L4;
  float* vds = vddt + L4;
  float* ve = vds + L4;
  const int tid = threadIdx.x;
  const long long t0 = static_cast<long long>(c) * L;
  const long long cell = (static_cast<long long>(b) * d.nc + c) * H + h;   // (b, c, h)
  const long long tok = (static_cast<long long>(b) * d.T + t0) * H + h;    // (b, t0, h)
  const float* xg = x + b * d.xb + t0 * d.xt + h * d.xh;
  const float* yg = dy + b * d.yb + t0 * d.yt + h * d.yh;
  const float* bg = Bm + b * d.bb + t0 * d.bt + g * d.bg;
  const float* cg = Cm + b * d.cb + t0 * d.ct + g * d.cg;
  const float* sg = dS + cell * N * P;

  // ---- 1. B^T, C^T, X^T, dY^T, dt, s; rows past L zero --------------------
  for (int i = tid; i < L4 * N; i += kThreads) {
    const int t = i / N, n = i - t * N;
    sB[n * LP + t] = t < L ? bg[t * d.bt + n] : 0.f;
    sC[n * LP + t] = t < L ? cg[t * d.ct + n] : 0.f;
  }
  for (int i = tid; i < L4 * P; i += kThreads) {
    const int t = i / P, p = i - t * P;
    sX[p * LP + t] = t < L ? xg[t * d.xt + p] : 0.f;
    sY[p * LP + t] = t < L ? yg[t * d.yt + p] : 0.f;
  }
  for (int t = tid; t < L4; t += kThreads) {
    vdt[t] = t < L ? dt[tok + static_cast<long long>(t) * H] : 0.f;
    vs[t] = t < L ? s[((static_cast<long long>(b) * d.nc + c) * L + t) * H + h] : 0.f;
  }
  __syncthreads();
  for (int t = tid; t < L4; t += kThreads) {
    const float e = t < L ? expf(vs[L - 1] - vs[t]) : 0.f;
    vend[t] = e;
    vu[t] = e * vdt[t];
  }

  // ---- 2. per (t, j) tile: C B^T and dY X^T on the lower tiles; W, M, P1 --
  const int nt = L4 / 4;
  for (int k = tid; k < nt * nt; k += kThreads) {
    const int ti = k / nt, tj = k - ti * nt;
    float gs[4][4] = {}, gw[4][4] = {};
    if (tj <= ti) {
      for (int n = 0; n < N; ++n) outer(gs, ld4(sC + n * LP + 4 * ti), ld4(sB + n * LP + 4 * tj));
      for (int p = 0; p < P; ++p) outer(gw, ld4(sY + p * LP + 4 * ti), ld4(sX + p * LP + 4 * tj));
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = 4 * ti + a;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 4 * tj + q;
        float w = 0.f, m = 0.f, p1 = 0.f;
        if (j <= t && t < L) {   // the decay of j > t is never formed (it may overflow)
          const float e = expf(vs[t] - vs[j]);
          const float gd = gs[a][q] * e;
          w = gd * vdt[j];
          m = gw[a][q] * e * vdt[j];
          p1 = gw[a][q] * gd;
        }
        sW[t * LP + j] = w;
        sM[t * LP + j] = m;
        sQ[t * LP + j] = p1;
      }
    }
  }
  __syncthreads();

  // ---- 3. sums of P1; dY, C, dS reloaded; B^T scaled by u ------------------
  for (int t = tid; t < L; t += kThreads) {
    float row = 0.f, col = 0.f;
    for (int j = 0; j < L; ++j) {
      row = fmaf(sQ[t * LP + j], vdt[j], row);
      col += sQ[j * LP + t];
    }
    vddt[t] = col;  // sum_i (dW o C B^T o decay)_it
    // sum_j (dW o W)_tj - sum_i (dW o W)_it, the product rounded on its own
    // (not contracted into the difference), so the diagonal's two terms
    // cancel exactly where they stand alone (L = 1: ds = 0)
    vds[t] = __fsub_rn(row, __fmul_rn(vdt[t], col));
  }
  for (int i = tid; i < L4 * P; i += kThreads) {
    const int t = i / P, p = i - t * P;
    sY[t * PP + p] = t < L ? yg[t * d.yt + p] : 0.f;
  }
  for (int i = tid; i < L4 * N; i += kThreads) {
    const int t = i / N, n = i - t * N;
    sC[t * NP + n] = t < L ? cg[t * d.ct + n] : 0.f;
  }
  for (int i = tid; i < N * P; i += kThreads) {
    const int n = i / P, p = i - n * P;
    sS[n * PP + p] = sg[i];
  }
  for (int i = tid; i < N * L4; i += kThreads) {
    const int n = i / L4, j = i - n * L4;
    sB[n * LP + j] *= vu[j];
  }
  __syncthreads();

  // ---- 4. M^T; dX = W^T dY + (u o B) dS, tiles (j, p) ----------------------
  for (int i = tid; i < L4 * L4; i += kThreads) {
    const int t = i / L4, j = i - t * L4;
    sQ[j * LP + t] = sM[t * LP + j];
  }
  const int np4 = P / 4;
  for (int k = tid; k < nt * np4; k += kThreads) {
    const int tj = k / np4, tp = k - tj * np4;
    float acc[4][4] = {};
    for (int t = 4 * tj; t < L; ++t)
      outer(acc, ld4(sW + t * LP + 4 * tj), ld4(sY + t * PP + 4 * tp));
    for (int n = 0; n < N; ++n) outer(acc, ld4(sB + n * LP + 4 * tj), ld4(sS + n * PP + 4 * tp));
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = 4 * tj + a;
      if (j < L) st4(dx + (tok + static_cast<long long>(j) * H) * P + 4 * tp, acc[a]);
    }
  }
  __syncthreads();

  // ---- 5. B row-major, dS^T -------------------------------------------------
  for (int i = tid; i < L4 * N; i += kThreads) {
    const int t = i / N, n = i - t * N;
    sB[t * NP + n] = t < L ? bg[t * d.bt + n] : 0.f;
  }
  for (int i = tid; i < N * P; i += kThreads) {
    const int n = i / P, p = i - n * P;
    sS[p * NP + n] = sg[i];
  }
  __syncthreads();

  // ---- 6. dC = M B (t, n); dB = M^T C + u o (X dS^T) (j, n), R's shares ----
  const int nn4 = N / 4, nd = nt * nn4;
  float* rs = sW;
  for (int k = tid; k < 2 * nd; k += kThreads) {
    float acc[4][4] = {};
    if (k < nd) {
      const int ti = k / nn4, tn = k - ti * nn4;
      const int jmax = min(4 * ti + 3, L - 1);
      for (int j = 0; j <= jmax; ++j)
        outer(acc, ld4(sQ + j * LP + 4 * ti), ld4(sB + j * NP + 4 * tn));
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = 4 * ti + a;
        if (t < L) st4(dC + (tok + static_cast<long long>(t) * H) * N + 4 * tn, acc[a]);
      }
    } else {
      const int kk = k - nd, tj = kk / nn4, tn = kk - tj * nn4;
      float qa[4][4] = {};
      for (int t = 4 * tj; t < L; ++t)
        outer(acc, ld4(sM + t * LP + 4 * tj), ld4(sC + t * NP + 4 * tn));
      for (int p = 0; p < P; ++p) outer(qa, ld4(sX + p * LP + 4 * tj), ld4(sS + p * NP + 4 * tn));
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = 4 * tj + a;
        const float4 bv = ld4(sB + j * NP + 4 * tn);
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
        float r = 0.f, o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          o[q] = fmaf(vu[j], qa[a][q], acc[a][q]);
          r = fmaf(br[q], qa[a][q], r);
        }
        rs[j * nn4 + tn] = r;
        if (j < L) st4(dB + (tok + static_cast<long long>(j) * H) * N + 4 * tn, o);
      }
    }
  }
  __syncthreads();

  // ---- 7. ddt, E and ds per row ---------------------------------------------
  for (int t = tid; t < L; t += kThreads) {
    float r = 0.f;
    for (int q = 0; q < nn4; ++q) r += rs[t * nn4 + q];
    ddt[tok + static_cast<long long>(t) * H] = vddt[t] + vend[t] * r;
    ve[t] = vu[t] * r;
  }
  __syncthreads();
  for (int t = tid; t < L; t += kThreads) {
    float v = vds[t] - ve[t];
    if (t == L - 1) {
      float tot = 0.f;
      for (int j = 0; j < L; ++j) tot += ve[j];
      v += tot;
    }
    ds[((static_cast<long long>(b) * d.nc + c) * L + t) * H + h] = v;
  }
}

bool valid(int Ba, int T, int H, int G, int N, int P, int L) {
  return L >= 1 && L <= 64 && T % L == 0 && N >= 4 && N <= 128 && N % 4 == 0 && P >= 4 &&
         P <= 64 && P % 4 == 0 && G >= 1 && H % G == 0 && H <= 65535 && Ba >= 1 && Ba <= 65535;
}

}  // namespace

// float32 only.  strides: x's batch, time and head strides, then B's and
// C's batch, time and group strides, then dY's batch, time and head
// strides (elements).  dB and dC are per head (Ba, T, H, N).  Returns the
// CUDA error code of the launch (0: launched).
extern "C" int repro_ssd_backward(const void* x, const void* Bm, const void* Cm, const void* dt,
                                  const void* s, const void* dy, const void* dstates, void* dx,
                                  void* ddt, void* ds, void* dB, void* dC, int Ba, int T, int H,
                                  int G, int N, int P, int L, const long long* strides,
                                  void* stream) {
  if (!valid(Ba, T, H, G, N, P, L)) return static_cast<int>(cudaErrorInvalidValue);
  const long long* st = strides;
  const Dims d{T, H, G, N, P, L, T / L, st[0], st[1], st[2], st[3], st[4], st[5],
               st[6], st[7], st[8], st[9], st[10], st[11]};
  const long long bytes = slots(L, N, P).total * static_cast<long long>(sizeof(float));
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(T / L), H, Ba);
  ssd_bwd_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const float*>(dt), static_cast<const float*>(s), static_cast<const float*>(dy),
      static_cast<const float*>(dstates), static_cast<float*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(ds), static_cast<float*>(dB), static_cast<float*>(dC), d);
  return static_cast<int>(cudaGetLastError());
}

// The launch plan repro_ssd_backward uses for these sizes: out[0..4] =
// blocks along x, y and z, threads per block, bytes of dynamic shared
// memory.  Returns a CUDA error code.
extern "C" int repro_ssd_bwd_plan(int Ba, int T, int H, int G, int N, int P, int L,
                                  long long* out) {
  if (!valid(Ba, T, H, G, N, P, L)) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = T / L;
  out[1] = H;
  out[2] = Ba;
  out[3] = kThreads;
  out[4] = slots(L, N, P).total * static_cast<long long>(sizeof(float));
  return 0;
}
