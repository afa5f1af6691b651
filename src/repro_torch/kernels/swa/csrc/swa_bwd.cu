// The backward of K6 (causal sliding-window GQA attention), float32, on the
// CUDA cores: FlashAttention-2's backward in its simplest form.
//
// Replaces no TPU kernel: the JAX package has no backward for its Pallas
// kernel src/repro/kernels/swa/kernel.py:129 (swa_pallas); it differentiates
// its plain attention.  The port's training path runs K6 (swa.cu) forward
// on the card, so its gradient needs a kernel of its own.  It computes the
// gradient of kernels/swa/ref.py::swa_ref (plain version:
// ref.py::swa_backward_ref) for q (B, H, T, D), k and v (B, Hkv, S, D), the
// queries the last T of the S keys, query i (position i + S - T) seeing
// the keys j with  qpos - w < j <= qpos:
//
//   P = exp(scale q k^T - lse)  under the mask,     dV = P^T dO,
//   dP = dO V^T,   dS = P (dP - Drow),  Drow = rowsum(dO o O),
//   dQ = scale dS K,   dK = scale dS^T Q,
//
// with lse = m + log l per row from K6's float32 forward (swa.cu writes it
// when given a pointer), so P is never renormalised here.
//
// Three kernels, one stream, no atomics (the result is deterministic):
//  * swa_bwd_drow: Drow, one warp per (batch, head, row).
//  * swa_bwd_dkdv: one block per (k tile of 64 keys, batch x kv head).  It
//    keeps the tile's K and V in shared memory and dK, dV in registers, and
//    walks the group's q heads and, per head, the q tiles whose window
//    meets the k tile (queries i with  j0 <= qpos <= j1 + w - 1).  Per q
//    tile it recomputes the logits S^T (keys x queries) and dP^T, forms P
//    and dS in shared memory, then adds P^T dO and dS^T Q (Q pre-scaled).
//  * swa_bwd_dq: one block per (q tile, batch x head), the forward's walk
//    over the k tiles of its window; dQ += dS K in registers.
// Both main kernels recompute S and dP: 14 D FLOP per unmasked (query,
// key) pair against the 10 D of the five products, for blocks that need no
// cross-block reduction.
//
// The mask is the forward's select: a masked logit becomes NEG_INF = -1e30
// before the exponential (exp(-1e30 - lse) = 0), never a product; rows past
// T and keys past S are zero in shared memory, masked, and never written.
// The logits are formed as the forward forms them (q scaled on load, the
// same float4 fmaf order over D), so P is the forward's softmax.
//
// Tiles and memory: 256 threads; thread (ti, tj) = (tid / 16, tid % 16)
// owns rows ti + 16 a and float4 column chunks tj + 16 n (n < NC =
// ceil(D / 64)), as in swa.cu.  q tiles are BQ = 64 rows at D <= 128 and
// 32 above (so that D 256 fits): dK/dV take 2 (64 + BQ)(D + 4) + 2 64
// (BQ + 4) floats of shared memory (105 KB at D 64, 213 KB at D 256), dQ
// 2 (64 + BQ)(D + 4) + BQ 68.
//
// Bound.  At llama3.2-1b's training shape (B 4, H 32, Hkv 8, T = S = 2048,
// D 64, global) the 268.6 M unmasked pairs need 10 D FLOP each: 171.9 GFLOP,
// 2.565 ms at 67 TFLOP/s (float32, CUDA cores), against 0.10 ms for the
// bytes (q, k, v, o, dO, lse in; dq, dk, dv out).  So operations bound it;
// this first form spends 14 D and reads its operands from shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 64;         // keys per k tile
constexpr int kThreads = 256;
constexpr int kMaxD = 256;
constexpr int kDrowRows = kThreads / 32;   // rows per block of swa_bwd_drow
constexpr float kNegInf = -1e30f;

struct Dims {
  int H, Hkv, T, S, D, w;
  float scale;
  // strides (elements) along batch, head, time of q, k, v, o, dO, dq, dk, dv
  long long qb, qh, qt, kb, kh, ks, vb, vh, vs, ob, oh, ot, gb, gh, gt;
  long long dqb, dqh, dqt, dkb, dkh, dks, dvb, dvh, dvs;
};

inline int bq_for(int D) { return D <= 128 ? 64 : 32; }

// The launch plan of each kernel (kernels/plans.py::swa_bwd_plans mirrors
// it): blocks along x and y, threads per block, rows per block.
struct Plan {
  long long gx, gy;
  int threads, rows;
};

void plans_for(int B, int H, int Hkv, int T, int S, int D, Plan out[3]) {
  const int bq = bq_for(D);
  out[0] = Plan{(T + kDrowRows - 1) / kDrowRows, static_cast<long long>(B) * H, kThreads,
                kDrowRows};
  out[1] = Plan{(S + kBK - 1) / kBK, static_cast<long long>(B) * Hkv, kThreads, kBK};
  out[2] = Plan{(T + bq - 1) / bq, static_cast<long long>(B) * H, kThreads, bq};
}

__global__ void __launch_bounds__(kThreads)
swa_bwd_drow(const float* __restrict__ o, const float* __restrict__ g, float* __restrict__ drow,
             Dims d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kDrowRows + warp;
  if (i >= d.T) return;
  const int b = blockIdx.y / d.H, h = blockIdx.y - (blockIdx.y / d.H) * d.H;
  const float* orow = o + b * d.ob + h * d.oh + i * d.ot;
  const float* grow = g + b * d.gb + h * d.gh + i * d.gt;
  float s = 0.f;
  for (int c = lane; c < d.D; c += 32) s = fmaf(orow[c], grow[c], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) drow[static_cast<long long>(blockIdx.y) * d.T + i] = s;
}

// rows [0, n) of a (rows, D) strided global tile into shared memory rows of
// LD floats (times mul); rows past `limit` are zero
__device__ inline void load_rows(float* dst, const float* src, long long stride, int row0,
                                 int n, int limit, int D, int LD, float mul) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int r = e / D, c = e - r * D, i = row0 + r;
    dst[r * LD + c] = i < limit ? src[i * stride + c] * mul : 0.f;
  }
}

// sum over D of a[ra] . b[rb] for CA rows of a and CB rows of b (float4
// steps, the forward's order)
template <int CA, int CB>
__device__ inline void dots(float (&acc)[CA][CB], const float* a, const int (&ra)[CA],
                            const float* b, const int (&rb)[CB], int D, int LD) {
#pragma unroll
  for (int x = 0; x < CA; ++x)
#pragma unroll
    for (int y = 0; y < CB; ++y) acc[x][y] = 0.f;
  for (int dd = 0; dd < D; dd += 4) {
    float4 av[CA], bv[CB];
#pragma unroll
    for (int x = 0; x < CA; ++x) av[x] = *reinterpret_cast<const float4*>(a + ra[x] * LD + dd);
#pragma unroll
    for (int y = 0; y < CB; ++y) bv[y] = *reinterpret_cast<const float4*>(b + rb[y] * LD + dd);
#pragma unroll
    for (int x = 0; x < CA; ++x)
#pragma unroll
      for (int y = 0; y < CB; ++y) {
        float t = acc[x][y];
        t = fmaf(av[x].x, bv[y].x, t);
        t = fmaf(av[x].y, bv[y].y, t);
        t = fmaf(av[x].z, bv[y].z, t);
        acc[x][y] = fmaf(av[x].w, bv[y].w, t);
      }
  }
}

__host__ __device__ inline size_t dkdv_smem_floats(int D, int bq) {
  return 2 * static_cast<size_t>(kBK + bq) * (D + 4) + 2 * static_cast<size_t>(kBK) * (bq + 4) +
         2 * static_cast<size_t>(bq);
}

__host__ __device__ inline size_t dq_smem_floats(int D, int bq) {
  return 2 * static_cast<size_t>(kBK + bq) * (D + 4) + static_cast<size_t>(bq) * (kBK + 4) +
         2 * static_cast<size_t>(bq);
}

template <int NC, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
swa_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ g,
             const float* __restrict__ lse, const float* __restrict__ drow,
             float* __restrict__ dk, float* __restrict__ dv, Dims d) {
  constexpr int CQ = BQ / 16;
  extern __shared__ __align__(16) float sm[];
  const int D = d.D, LD = D + 4, LP = BQ + 4;
  float* ks = sm;                // [kBK][LD]
  float* vs = ks + kBK * LD;     // [kBK][LD]
  float* qs = vs + kBK * LD;     // [BQ][LD], scaled
  float* gs = qs + BQ * LD;      // [BQ][LD]
  float* ps = gs + BQ * LD;      // [kBK][LP]  P^T
  float* dss = ps + kBK * LP;    // [kBK][LP]  dS^T
  float* ls = dss + kBK * LP;    // [BQ] lse
  float* dr = ls + BQ;           // [BQ] Drow
  const int b = blockIdx.y / d.Hkv, hk = blockIdx.y - (blockIdx.y / d.Hkv) * d.Hkv;
  const int grp = d.H / d.Hkv;
  const int j0 = blockIdx.x * kBK;
  const int s_off = d.S - d.T;
  const int tid = threadIdx.x, ti = tid >> 4, tj = tid & 15;

  load_rows(ks, k + b * d.kb + hk * d.kh, d.ks, j0, kBK, d.S, D, LD, 1.f);
  load_rows(vs, v + b * d.vb + hk * d.vh, d.vs, j0, kBK, d.S, D, LD, 1.f);

  float adk[4][NC][4], adv[4][NC][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) adk[a][n][e] = adv[a][n][e] = 0.f;

  // the queries whose window meets keys [j0, j_hi]
  const int j_hi = min(j0 + kBK, d.S) - 1;
  const int i_lo = max(0, j0 - s_off);
  const int i_hi = min(d.T - 1, j_hi + d.w - 1 - s_off);
  int rk[4], rq[CQ];
#pragma unroll
  for (int a = 0; a < 4; ++a) rk[a] = ti + 16 * a;
#pragma unroll
  for (int c = 0; c < CQ; ++c) rq[c] = tj + 16 * c;

  for (int h = hk * grp; h < (hk + 1) * grp; ++h) {
    const float* qg = q + b * d.qb + h * d.qh;
    const float* gg = g + b * d.gb + h * d.gh;
    const long long row = (static_cast<long long>(b) * d.H + h) * d.T;
    for (int i0 = (i_lo / BQ) * BQ; i0 <= i_hi; i0 += BQ) {
      __syncthreads();  // the previous tile's Q, dO, P and dS are read
      load_rows(qs, qg, d.qt, i0, BQ, d.T, D, LD, d.scale);
      load_rows(gs, gg, d.gt, i0, BQ, d.T, D, LD, 1.f);
      for (int r = tid; r < BQ; r += kThreads) {
        const bool in = i0 + r < d.T;
        ls[r] = in ? lse[row + i0 + r] : 0.f;
        dr[r] = in ? drow[row + i0 + r] : 0.f;
      }
      __syncthreads();

      float s[4][CQ], dp[4][CQ];
      dots<4, CQ>(s, ks, rk, qs, rq, D, LD);   // S^T: keys x queries
      dots<4, CQ>(dp, vs, rk, gs, rq, D, LD);  // dP^T
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int kpos = j0 + rk[a];
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          const int qpos = i0 + rq[c] + s_off;
          const bool mk = i0 + rq[c] < d.T && kpos < d.S && kpos <= qpos && kpos > qpos - d.w;
          const float p = expf((mk ? s[a][c] : kNegInf) - ls[rq[c]]);
          ps[rk[a] * LP + rq[c]] = p;
          dss[rk[a] * LP + rq[c]] = p * (dp[a][c] - dr[rq[c]]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q (Q scaled), on the column chunks tj + 16 n
      for (int c = 0; c < BQ; ++c) {
        float pa[4], da[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = ps[rk[a] * LP + c];
          da[a] = dss[rk[a] * LP + c];
        }
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const int col = 4 * (tj + 16 * n);
          if (col < D) {
            const float4 gv = *reinterpret_cast<const float4*>(gs + c * LD + col);
            const float4 qv = *reinterpret_cast<const float4*>(qs + c * LD + col);
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              adv[a][n][0] = fmaf(pa[a], gv.x, adv[a][n][0]);
              adv[a][n][1] = fmaf(pa[a], gv.y, adv[a][n][1]);
              adv[a][n][2] = fmaf(pa[a], gv.z, adv[a][n][2]);
              adv[a][n][3] = fmaf(pa[a], gv.w, adv[a][n][3]);
              adk[a][n][0] = fmaf(da[a], qv.x, adk[a][n][0]);
              adk[a][n][1] = fmaf(da[a], qv.y, adk[a][n][1]);
              adk[a][n][2] = fmaf(da[a], qv.z, adk[a][n][2]);
              adk[a][n][3] = fmaf(da[a], qv.w, adk[a][n][3]);
            }
          }
        }
      }
    }
  }

  // keys past S are not written
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + rk[a];
    if (j >= d.S) continue;
    float* kout = dk + b * d.dkb + hk * d.dkh + j * d.dks;
    float* vout = dv + b * d.dvb + hk * d.dvh + j * d.dvs;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = 4 * (tj + 16 * n);
      if (col < D) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          kout[col + e] = adk[a][n][e];
          vout[col + e] = adv[a][n][e];
        }
      }
    }
  }
}

template <int NC, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
swa_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ g,
           const float* __restrict__ lse, const float* __restrict__ drow,
           float* __restrict__ dq, Dims d) {
  constexpr int CQ = BQ / 16;
  extern __shared__ __align__(16) float sm[];
  const int D = d.D, LD = D + 4, LS = kBK + 4;
  float* qs = sm;                // [BQ][LD], scaled
  float* gs = qs + BQ * LD;      // [BQ][LD]
  float* ks = gs + BQ * LD;      // [kBK][LD]
  float* vs = ks + kBK * LD;     // [kBK][LD]
  float* dss = vs + kBK * LD;    // [BQ][LS]  dS
  float* ls = dss + BQ * LS;     // [BQ]
  float* dr = ls + BQ;           // [BQ]
  const int b = blockIdx.y / d.H, h = blockIdx.y - (blockIdx.y / d.H) * d.H;
  const int hk = h / (d.H / d.Hkv);
  const int i0 = blockIdx.x * BQ;
  const int s_off = d.S - d.T;
  const int tid = threadIdx.x, ti = tid >> 4, tj = tid & 15;
  const long long row = static_cast<long long>(blockIdx.y) * d.T;

  load_rows(qs, q + b * d.qb + h * d.qh, d.qt, i0, BQ, d.T, D, LD, d.scale);
  load_rows(gs, g + b * d.gb + h * d.gh, d.gt, i0, BQ, d.T, D, LD, 1.f);
  for (int r = tid; r < BQ; r += kThreads) {
    const bool in = i0 + r < d.T;
    ls[r] = in ? lse[row + i0 + r] : 0.f;
    dr[r] = in ? drow[row + i0 + r] : 0.f;
  }

  const int q_lo = i0 + s_off;
  const int q_hi = min(i0 + BQ, d.T) - 1 + s_off;
  const int kv_lo = max(0, q_lo - d.w + 1);
  const float* kg = k + b * d.kb + hk * d.kh;
  const float* vg = v + b * d.vb + hk * d.vh;

  float acc[CQ][NC][4];
#pragma unroll
  for (int a = 0; a < CQ; ++a)
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;
  int rq[CQ], rk[4];
#pragma unroll
  for (int a = 0; a < CQ; ++a) rq[a] = ti + 16 * a;
#pragma unroll
  for (int c = 0; c < 4; ++c) rk[c] = tj + 16 * c;

  for (int j0 = (kv_lo / kBK) * kBK; j0 <= q_hi; j0 += kBK) {
    __syncthreads();  // the previous tile's K, V and dS are read
    load_rows(ks, kg, d.ks, j0, kBK, d.S, D, LD, 1.f);
    load_rows(vs, vg, d.vs, j0, kBK, d.S, D, LD, 1.f);
    __syncthreads();

    float s[CQ][4], dp[CQ][4];
    dots<CQ, 4>(s, qs, rq, ks, rk, D, LD);
    dots<CQ, 4>(dp, gs, rq, vs, rk, D, LD);
#pragma unroll
    for (int a = 0; a < CQ; ++a) {
      const int qpos = i0 + rq[a] + s_off;
      const bool row_in = i0 + rq[a] < d.T;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = j0 + rk[c];
        const bool mk = row_in && kpos < d.S && kpos <= qpos && kpos > qpos - d.w;
        const float p = expf((mk ? s[a][c] : kNegInf) - ls[rq[a]]);
        dss[rq[a] * LS + rk[c]] = p * (dp[a][c] - dr[rq[a]]);
      }
    }
    __syncthreads();

    // dQ += dS K on the column chunks tj + 16 n
    for (int j = 0; j < kBK; ++j) {
      float da[CQ];
#pragma unroll
      for (int a = 0; a < CQ; ++a) da[a] = dss[rq[a] * LS + j];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int col = 4 * (tj + 16 * n);
        if (col < D) {
          const float4 kv = *reinterpret_cast<const float4*>(ks + j * LD + col);
#pragma unroll
          for (int a = 0; a < CQ; ++a) {
            acc[a][n][0] = fmaf(da[a], kv.x, acc[a][n][0]);
            acc[a][n][1] = fmaf(da[a], kv.y, acc[a][n][1]);
            acc[a][n][2] = fmaf(da[a], kv.z, acc[a][n][2]);
            acc[a][n][3] = fmaf(da[a], kv.w, acc[a][n][3]);
          }
        }
      }
    }
  }

  // rows past T are not written
#pragma unroll
  for (int a = 0; a < CQ; ++a) {
    const int i = i0 + rq[a];
    if (i >= d.T) continue;
    float* out = dq + b * d.dqb + h * d.dqh + i * d.dqt;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = 4 * (tj + 16 * n);
      if (col < D) {
#pragma unroll
        for (int e = 0; e < 4; ++e) out[col + e] = acc[a][n][e] * d.scale;
      }
    }
  }
}

template <int NC, int BQ>
int launch(const float* q, const float* k, const float* v, const float* o, const float* g,
           const float* lse, float* drow, float* dq, float* dk, float* dv, int B,
           const Dims& d, cudaStream_t stream) {
  Plan pl[3];
  plans_for(B, d.H, d.Hkv, d.T, d.S, d.D, pl);
  const size_t b_kv = dkdv_smem_floats(d.D, BQ) * sizeof(float);
  const size_t b_q = dq_smem_floats(d.D, BQ) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(swa_bwd_dkdv<NC, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(b_kv));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(swa_bwd_dq<NC, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(b_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  swa_bwd_drow<<<dim3(static_cast<unsigned>(pl[0].gx), static_cast<unsigned>(pl[0].gy)),
                 pl[0].threads, 0, stream>>>(o, g, drow, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  swa_bwd_dkdv<NC, BQ><<<dim3(static_cast<unsigned>(pl[1].gx), static_cast<unsigned>(pl[1].gy)),
                         pl[1].threads, b_kv, stream>>>(q, k, v, g, lse, drow, dk, dv, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  swa_bwd_dq<NC, BQ><<<dim3(static_cast<unsigned>(pl[2].gx), static_cast<unsigned>(pl[2].gy)),
                       pl[2].threads, b_q, stream>>>(q, k, v, g, lse, drow, dq, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, g (= dO) and lse as K6's float32 forward saw and wrote them;
// drow a (B, H, T) float32 scratch; dq, dk, dv outputs.  strides: the batch,
// head and time strides of q, k, v, o, g, dq, dk, dv, in that order (D
// contiguous everywhere); lse and drow are (B, H, T) contiguous.  w: the
// window, at most S.  Returns the CUDA error code of the launches (0:
// launched).
extern "C" int repro_swa_backward(const void* q, const void* k, const void* v, const void* o,
                                  const void* g, const void* lse, void* drow, void* dq,
                                  void* dk, void* dv, int B, int H, int Hkv, int T, int S,
                                  int D, int w, float scale, const long long* strides,
                                  void* stream) {
  if (D <= 0 || D > kMaxD || D % 4 != 0 || Hkv <= 0 || H % Hkv != 0 || T < 1 || S < T ||
      w < 1 || static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* s = strides;
  const Dims d{H, Hkv, T, S, D, w, scale,
               s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
               s[12], s[13], s[14], s[15], s[16], s[17], s[18], s[19], s[20], s[21], s[22],
               s[23]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v), *fo = static_cast<const float*>(o),
              *fg = static_cast<const float*>(g), *fl = static_cast<const float*>(lse);
  float *fdr = static_cast<float*>(drow), *fdq = static_cast<float*>(dq),
        *fdk = static_cast<float*>(dk), *fdv = static_cast<float*>(dv);
  switch ((D + 63) / 64) {
    case 1:
      return launch<1, 64>(fq, fk, fv, fo, fg, fl, fdr, fdq, fdk, fdv, B, d, st);
    case 2:
      return launch<2, 64>(fq, fk, fv, fo, fg, fl, fdr, fdq, fdk, fdv, B, d, st);
    case 3:
      return launch<3, 32>(fq, fk, fv, fo, fg, fl, fdr, fdq, fdk, fdv, B, d, st);
    default:
      return launch<4, 32>(fq, fk, fv, fo, fg, fl, fdr, fdq, fdk, fdv, B, d, st);
  }
}

// The launch plans repro_swa_backward uses: out[4 i .. 4 i + 3] = blocks
// along x and y, threads per block, rows per block of kernel i (0 Drow,
// 1 dK/dV, 2 dQ).  Returns a CUDA error code.
extern "C" int repro_swa_bwd_plan(int B, int H, int Hkv, int T, int S, int D, long long* out) {
  if (T < 1 || S < T || D <= 0 || D > kMaxD || Hkv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl[3];
  plans_for(B, H, Hkv, T, S, D, pl);
  for (int i = 0; i < 3; ++i) {
    out[4 * i] = pl[i].gx;
    out[4 * i + 1] = pl[i].gy;
    out[4 * i + 2] = pl[i].threads;
    out[4 * i + 3] = pl[i].rows;
  }
  return 0;
}
