// The backward of K6 (causal sliding-window GQA attention), float32, in
// 3xTF32 on the tensor cores: FlashAttention-2's backward on mma.sync.
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
// when given a pointer), so P is never renormalised here.  Logits and the
// LSE are taken into log2 units (exp2).
//
// Bound.  At llama3.2-1b's training shape (B 4, H 32, Hkv 8, T = S = 2048,
// D 64, global) the 268.6 M unmasked pairs need 10 D FLOP each (the five
// products S, dP, dV, dK, dQ): 171.9 GFLOP, 0.347 ms at TF32's 495 TFLOP/s
// and so 1.042 ms in three TF32 products (2.565 ms on the float32 CUDA
// cores), against 0.10 ms for the bytes (q, k, v, o, dO, lse in; dq, dk,
// dv out).  So operations bound it.
//
// Three kernels, one stream, no atomics: every output element is summed by
// one thread in a fixed order, so two runs give the same bits.
//  * swa_bwd_drow: Drow, one warp per (batch, head, row).
//  * swa_bwd_dkdv<DP, DC, BQ, ST>: one block of four warps per (batch x kv
//    head, k tile of 64 keys), the first k tiles of every head (the longest
//    walks of a causal layer) first, warp w owning keys 16 w .. 16 w + 15.  It
//    keeps the tile's K and V in shared memory and dK, dV in registers, and
//    walks the group's q heads and, per head, the q tiles of BQ rows whose
//    window meets the k tile (queries i with  j0 <= qpos <= j1 + w - 1),
//    Q, dO, the LSE and Drow through a ring of ST stages.  Per q tile it
//    forms S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T in the same
//    registers, which are the A operands of dV += P^T dO and dK += dS^T Q.
//    dK and dV of DC columns fit the registers; at DP 256 (DC 128) the walk
//    runs twice, once per half of the columns, and recomputes S^T and dP^T.
//  * swa_bwd_dq<DP, BN, ST, MT>: one block of four warps per (batch x head,
//    q tile of 64 MT rows), the last q tiles of every head first, warp w
//    owning rows 16 MT w .. 16 MT (w + 1) - 1 as MT m-tiles of 16 that share
//    each K and V fragment it loads and splits (MT 2 at DP 64, else 1); the
//    forward's walk over the kv tiles (BN keys, ST stages) of its window; S
//    and dP, then dS, which is the A operand of dQ += dS K.  S is the
//    forward's, bit for bit (the same fragments in the same order), so P =
//    exp(S - LSE) meets the forward's LSE exactly.
// Both main kernels recompute S and dP: 14 D FLOP per unmasked pair against
// the 10 D of the five products, for blocks that need no cross-block sum.
//
// Every product is 3xTF32 (tf32.cuh: mma.sync m16n8k8, each operand split
// into two TF32 parts in registers right after its load, three products
// summed in float32).  P^T, dS^T and dS never leave the registers: an
// accumulator over 8 columns is the next product's A operand under a
// permuted k order (tf32.cuh, acc_to_a and load_b_kn_perm).  A tensor-core
// accumulator cuts each sum toward zero as it adds, a bias that grows with
// the length of the sum (dK sums 8192 query rows at llama3.2-1b's shape,
// and 6e-5 of the plain version is what that gave on an H100, against the
// 1e-5 tolerance): so it holds one tile's product only (from zero, in
// chunks of 64 columns, 32 at DC 128), and dK, dV and dQ sum the tiles in
// float32 on the CUDA cores.  Loads are cp.async (16-byte pieces where the
// views allow, else 4-byte ones; rows past T and S zero-filled) into shared
// rows of DP + 4 floats, so no fragment load meets a bank conflict; the pad
// columns D .. DP are zero and the products run over D rounded up to 8.  A
// warp skips a tile none of whose pairs is in the window; a tile inside the
// window of every pair of a warp takes no select.  Products go out term by
// term over groups of four n-tiles (tf32.cuh, mma3_group).  The mask is the
// forward's select: a masked pair's P is 0, never a product; keys past S
// and rows past T are masked or zero and never written.  The longest walks
// of a causal layer launch first, so that short blocks fill the last wave.
//
// Shapes (DP the padded width: 64, 128 or 256), and what ptxas gives them
// (-Xptxas -v, sm_90a, nvcc 12.9; no spills anywhere):
//   dK/dV: DP 64: DC 64, BQ 64, two stages (105 KB of shared memory, two
//          blocks per SM; 248 registers); DP 128: DC 128, BQ 32, two stages
//          (135 KB; 241); DP 256: DC 128, BQ 32, one stage (200 KB; 248).
//   dQ:    DP 64: BN 32, MT 2 (128 rows), two stages (104 KB, two blocks
//          per SM; 219 registers); DP 128: BN 64, two stages (203 KB; 223);
//          DP 256: BN 32, one stage (200 KB; 237).
#include "../../csrc/tf32.cuh"

namespace {

constexpr int kTile = 64;         // keys per dK/dV block, rows per dQ block (16 per warp)
constexpr int kThreads = 128;     // the main kernels: four warps
constexpr int kDrowThreads = 256;
constexpr int kMaxD = 256;
constexpr int kDrowRows = kDrowThreads / 32;   // rows per block of swa_bwd_drow

struct Dims {
  int H, Hkv, T, S, D, w;
  float scale;
  // strides (elements) along batch, head, time of q, k, v, o, dO, dq, dk, dv
  long long qb, qh, qt, kb, kh, ks, vb, vh, vs, ob, oh, ot, gb, gh, gt;
  long long dqb, dqh, dqt, dkb, dkh, dks, dvb, dvh, dvs;
};

// The launch plan of each kernel (kernels/plans.py::swa_bwd_plans mirrors
// it): blocks along x and y, threads per block, rows per block.
struct Plan {
  long long gx, gy;
  int threads, rows;
};

inline int dq_rows(int D) { return D <= 64 ? 2 * kTile : kTile; }   // 64 MT

void plans_for(int B, int H, int Hkv, int T, int S, int D, Plan out[3]) {
  out[0] = Plan{(T + kDrowRows - 1) / kDrowRows, static_cast<long long>(B) * H, kDrowThreads,
                kDrowRows};
  out[1] = Plan{static_cast<long long>(B) * Hkv, (S + kTile - 1) / kTile, kThreads, kTile};
  const int bm = dq_rows(D);
  out[2] = Plan{static_cast<long long>(B) * H, (T + bm - 1) / bm, kThreads, bm};
}

__global__ void __launch_bounds__(kDrowThreads)
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

// Accumulator fragments (g = lane / 4, t = lane % 4): rows g (entries 0, 1)
// and g + 8 (2, 3) of the warp's 16, columns 8 j + 2 t + {0, 1} of n-tile j.

// dK and dV of the k tile's 64 keys (S^T: rows keys, columns queries)
template <int DP, int DC, int BQ, int ST>
__global__ void __launch_bounds__(kThreads)
swa_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ g,
             const float* __restrict__ lse, const float* __restrict__ drow,
             float* __restrict__ dk, float* __restrict__ dv, Dims d, int vec) {
  constexpr int LD = DP + 4, NQ = BQ / 8, NC = DC / 8, CH = DC <= 64 ? 8 : 4;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                   // [64][LD]
  float* vs = ks + kTile * LD;      // [64][LD]
  float* qs = vs + kTile * LD;      // [ST][BQ][LD]
  float* gs = qs + ST * BQ * LD;    // [ST][BQ][LD]
  float* ls = gs + ST * BQ * LD;    // [ST][BQ]  lse in log2 units
  float* dr = ls + ST * BQ;         // [ST][BQ]  Drow
  const int b = blockIdx.x / d.Hkv, hk = blockIdx.x - (blockIdx.x / d.Hkv) * d.Hkv;
  const int grp = d.H / d.Hkv;
  const int j0 = blockIdx.y * kTile, s_off = d.S - d.T;
  const int wp = threadIdx.x >> 5, gq = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
  const int nk = (d.D + 7) / 8;     // k-steps of S^T and dP^T
  const float c = d.scale * kLog2e;

  zero_pad(sm, 2 * kTile + 2 * ST * BQ, d.D, DP, LD);
  load_rows_async(ks, k + b * d.kb + hk * d.kh, d.ks, j0, kTile, d.S, d.D, LD, vec);
  load_rows_async(vs, v + b * d.vb + hk * d.vh, d.vs, j0, kTile, d.S, d.D, LD, vec);

  // the q tiles (of every head of the group) whose window meets keys [j0, j_hi]
  const int j_hi = min(j0 + kTile, d.S) - 1;
  const int i_lo = max(0, j0 - s_off), i_hi = min(d.T - 1, j_hi + d.w - 1 - s_off);
  const int it0 = (i_lo / BQ) * BQ;
  const int n_it = i_hi >= i_lo ? (i_hi - it0) / BQ + 1 : 0;
  const int n_steps = grp * n_it;                  // (head, q tile) steps of one pass
  const int total = (DP / DC) * n_steps;           // and of every pass over the columns

  // the loads of step u (Q, dO, LSE and Drow of one head's q tile) into stage u % ST
  auto issue = [&](int u) {
    const int r = u % n_steps, hh = hk * grp + r / n_it, i0 = it0 + (r % n_it) * BQ;
    const int st = u % ST;
    load_rows_async(qs + st * BQ * LD, q + b * d.qb + hh * d.qh, d.qt, i0, BQ, d.T, d.D, LD,
                    vec);
    load_rows_async(gs + st * BQ * LD, g + b * d.gb + hh * d.gh, d.gt, i0, BQ, d.T, d.D, LD,
                    vec);
    const long long row = (static_cast<long long>(b) * d.H + hh) * d.T;
    for (int x = threadIdx.x; x < BQ; x += kThreads) {
      const bool in = i0 + x < d.T;
      ls[st * BQ + x] = in ? lse[row + i0 + x] * kLog2e : 0.f;
      dr[st * BQ + x] = in ? drow[row + i0 + x] : 0.f;
    }
  };
  if (total > 0) issue(0);
  cp_commit();

  // this warp's keys k_lo .. k_lo + 15 (row gq and gq + 8 of each fragment)
  const int k_lo = j0 + 16 * wp;
  const int kpos = k_lo + gq;   // of row gq; row gq + 8 is kpos + 8
  const float* kw = ks + 16 * wp * LD;
  const float* vw = vs + 16 * wp * LD;

  float adk[NC][4], adv[NC][4];
  zero(adk);
  zero(adv);
  // dK (times scale) and dV of columns c0 .. c0 + DC; keys past S are not written
  auto write = [&](int c0) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = c0 + 8 * j + 2 * t;
      if (col >= d.D) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = kpos + 8 * half;
        if (key >= d.S) continue;
        float* ko = dk + b * d.dkb + hk * d.dkh + key * d.dks + col;
        float* vo = dv + b * d.dvb + hk * d.dvh + key * d.dvs + col;
        ko[0] = adk[j][2 * half] * d.scale;
        ko[1] = adk[j][2 * half + 1] * d.scale;
        vo[0] = adv[j][2 * half];
        vo[1] = adv[j][2 * half + 1];
      }
    }
  };

  for (int u = 0; u < total; ++u) {
    if (ST == 2 && u + 1 < total) {   // step u + 1 loads under this step's products
      issue(u + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int r = u % n_steps, i0 = it0 + (r % n_it) * BQ, st = u % ST;
    const int c0 = (u / n_steps) * DC;
    const float* qt = qs + st * BQ * LD;
    const float* gt = gs + st * BQ * LD;
    const float* lt = ls + st * BQ;
    const float* dt = dr + st * BQ;
    // the positions of this tile's real queries
    const int qp_lo = i0 + s_off, qp_hi = min(i0 + BQ, d.T) - 1 + s_off;
    if (k_lo < d.S && k_lo <= qp_hi && k_lo + 15 > qp_lo - d.w) {
      // S^T = K Q^T, dP^T = V dO^T
      float s[NQ][4], dp[NQ][4];
      zero(s);
      zero(dp);
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        if (kk >= nk) break;
        FragA ak, av;
        load_a(ak, kw + 8 * kk, LD, gq, t);
        load_a(av, vw + 8 * kk, LD, gq, t);
#pragma unroll
        for (int jg = 0; jg < NQ; jg += 4) {
          FragB bq[4], bg[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) load_b_nk(bq[j], qt + 8 * (jg + j) * LD + 8 * kk, LD, gq, t);
          mma3_group(s, jg, ak, bq);
#pragma unroll
          for (int j = 0; j < 4; ++j) load_b_nk(bg[j], gt + 8 * (jg + j) * LD + 8 * kk, LD, gq, t);
          mma3_group(dp, jg, av, bg);
        }
      }
      // P^T and dS^T in place; a pair outside the window gets P = 0 by a select
      const bool inside = i0 + BQ <= d.T && k_lo + 15 <= qp_lo && k_lo > i0 + BQ - 1 + s_off - d.w;
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * t + (e & 1), qp = i0 + qi + s_off;
          const int kp = kpos + ((e & 2) ? 8 : 0);
          const bool ok = inside || (i0 + qi < d.T && kp <= qp && kp > qp - d.w);
          const float p = ok ? exp2f(s[j][e] * c - lt[qi]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dt[qi]);
        }
      // dV += P^T dO, dK += dS^T Q over columns c0 .. c0 + DC: this step's
      // products on the tensor cores from zero, in chunks of CH n-tiles,
      // added in float32 on the CUDA cores
#pragma unroll
      for (int jc = 0; jc < NC; jc += CH) {
        if (c0 + 8 * jc < 8 * nk) {
          float part[CH][4];
          tile_product<NQ, CH>(part, s, gt + c0, LD, jc, nk - c0 / 8, gq, t);
#pragma unroll
          for (int j = 0; j < CH; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) adv[jc + j][e] += part[j][e];
          tile_product<NQ, CH>(part, dp, qt + c0, LD, jc, nk - c0 / 8, gq, t);
#pragma unroll
          for (int j = 0; j < CH; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) adk[jc + j][e] += part[j][e];
        }
      }
    }
    __syncthreads();   // every warp has read this stage before it is refilled
    if (ST == 1 && u + 1 < total) {
      issue(u + 1);
      cp_commit();
    }
    if ((u + 1) % n_steps == 0) {   // the end of a pass over the columns
      write(c0);
      zero(adk);
      zero(adv);
    }
  }
  if (total == 0) {   // keys no query sees: zero gradients
    cp_wait<0>();
    for (int c0 = 0; c0 < DP; c0 += DC) write(c0);
  }
}

// dQ of the q tile's 64 MT rows (S: rows queries, columns keys); warp w
// owns its rows 16 MT w .. 16 MT (w + 1) - 1 as MT m-tiles of 16, which
// share every K and V fragment that the warp loads and splits
template <int DP, int BN, int ST, int MT>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 2 : 1)
swa_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ g,
           const float* __restrict__ lse, const float* __restrict__ drow,
           float* __restrict__ dq, Dims d, int vec) {
  constexpr int LD = DP + 4, NT = BN / 8, NO = DP / 8, BM = kTile * MT;
  constexpr int CH = MT == 1 && DP <= 128 ? 8 : 4;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                   // [BM][LD]
  float* gs = qs + BM * LD;         // [BM][LD]
  float* ks = gs + BM * LD;         // [ST][BN][LD]
  float* vs = ks + ST * BN * LD;    // [ST][BN][LD]
  const int nq = (d.T + BM - 1) / BM;
  const int bh = blockIdx.x, b = bh / d.H, h = bh - b * d.H, hk = h / (d.H / d.Hkv);
  const int i0 = (nq - 1 - static_cast<int>(blockIdx.y)) * BM, s_off = d.S - d.T;
  const int wp = threadIdx.x >> 5, gq = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
  const int nk = (d.D + 7) / 8;   // k-steps of S and dP, live n-tiles of dQ
  const float c = d.scale * kLog2e;
  const float* kg = k + b * d.kb + hk * d.kh;
  const float* vg = v + b * d.vb + hk * d.vh;

  const int q_lo = i0 + s_off, q_hi = min(i0 + BM, d.T) - 1 + s_off;
  const int j_first = (max(0, q_lo - d.w + 1) / BN) * BN;
  const int ntiles = (q_hi - j_first) / BN + 1;

  zero_pad(sm, 2 * BM + 2 * ST * BN, d.D, DP, LD);
  load_rows_async(qs, q + b * d.qb + h * d.qh, d.qt, i0, BM, d.T, d.D, LD, vec);
  load_rows_async(gs, g + b * d.gb + h * d.gh, d.gt, i0, BM, d.T, d.D, LD, vec);
  load_rows_async(ks, kg, d.ks, j_first, BN, d.S, d.D, LD, vec);
  load_rows_async(vs, vg, d.vs, j_first, BN, d.S, d.D, LD, vec);
  cp_commit();

  // this warp's rows r0 .. r0 + 16 MT - 1, their LSE (log2 units) and Drow:
  // row gq (half 0) and gq + 8 (half 1) of m-tile m is r0 + 16 m + gq + 8 half
  const int r0 = i0 + 16 * MT * wp;
  const int p_lo = r0 + s_off, p_hi = min(r0 + 16 * MT - 1, d.T - 1) + s_off;
  const long long row = static_cast<long long>(bh) * d.T;
  float l[MT][2], dr[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r0 + 16 * m + gq + 8 * half;
      l[m][half] = i < d.T ? lse[row + i] * kLog2e : 0.f;
      dr[m][half] = i < d.T ? drow[row + i] : 0.f;
    }
  const float* qw = qs + 16 * MT * wp * LD;
  const float* gw = gs + 16 * MT * wp * LD;

  float acc[MT][NO][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) zero(acc[m]);
  for (int n = 0; n < ntiles; ++n) {
    const int j0 = j_first + n * BN, st = n % ST;
    if (ST == 2 && n + 1 < ntiles) {   // tile n + 1 loads under this tile's products
      const int nx = (n + 1) % ST;
      load_rows_async(ks + nx * BN * LD, kg, d.ks, j0 + BN, BN, d.S, d.D, LD, vec);
      load_rows_async(vs + nx * BN * LD, vg, d.vs, j0 + BN, BN, d.S, d.D, LD, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + st * BN * LD;
    const float* vt = vs + st * BN * LD;
    if (r0 < d.T && j0 <= p_hi && j0 + BN - 1 > p_lo - d.w) {
      // S = Q K^T, dP = dO V^T
      float s[MT][NT][4], dp[MT][NT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        zero(s[m]);
        zero(dp[m]);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        if (kk >= nk) break;
        FragA aq[MT], ag[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          load_a(aq[m], qw + 16 * m * LD + 8 * kk, LD, gq, t);
          load_a(ag[m], gw + 16 * m * LD + 8 * kk, LD, gq, t);
        }
#pragma unroll
        for (int jg = 0; jg < NT; jg += 4) {
          FragB bk[4], bv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) load_b_nk(bk[j], kt + 8 * (jg + j) * LD + 8 * kk, LD, gq, t);
#pragma unroll
          for (int m = 0; m < MT; ++m) mma3_group(s[m], jg, aq[m], bk);
#pragma unroll
          for (int j = 0; j < 4; ++j) load_b_nk(bv[j], vt + 8 * (jg + j) * LD + 8 * kk, LD, gq, t);
#pragma unroll
          for (int m = 0; m < MT; ++m) mma3_group(dp[m], jg, ag[m], bv);
        }
      }
      // dS in place of dP; a pair outside the window gets P = 0 by a select
      const bool inside = j0 + BN - 1 <= p_lo && j0 > p_hi - d.w;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = j0 + 8 * j + 2 * t + (e & 1);
            const int qp = r0 + 16 * m + gq + ((e & 2) ? 8 : 0) + s_off;
            const bool ok = inside || (kp <= qp && kp > qp - d.w);
            const float p = ok ? exp2f(s[m][j][e] * c - l[m][e >> 1]) : 0.f;
            dp[m][j][e] = p * (dp[m][j][e] - dr[m][e >> 1]);
          }
      // dQ += dS K: this tile's product on the tensor cores from zero, in
      // chunks of CH n-tiles, added in float32 on the CUDA cores
#pragma unroll
      for (int jc = 0; jc < NO; jc += CH) {
        if (jc < nk) {
          float part[MT][CH][4];
          tile_product<MT, NT, CH>(part, dp, kt, LD, jc, nk, gq, t);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int j = 0; j < CH; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[m][jc + j][e] += part[m][j][e];
        }
      }
    }
    __syncthreads();   // every warp has read this stage before it is refilled
    if (ST == 1 && n + 1 < ntiles) {
      load_rows_async(ks, kg, d.ks, j0 + BN, BN, d.S, d.D, LD, vec);
      load_rows_async(vs, vg, d.vs, j0 + BN, BN, d.S, d.D, LD, vec);
      cp_commit();
    }
  }

  // dQ (times scale); rows past T are not written
  float* out = dq + b * d.dqb + h * d.dqh;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= d.D) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = r0 + 16 * m + gq + 8 * half;
        if (i < d.T) {
          out[i * d.dqt + col] = acc[m][j][2 * half] * d.scale;
          out[i * d.dqt + col + 1] = acc[m][j][2 * half + 1] * d.scale;
        }
      }
    }
}

template <int DP, int DC, int BQ, int STKV, int BN, int STQ, int MTQ>
int launch(const float* q, const float* k, const float* v, const float* o, const float* g,
           const float* lse, float* drow, float* dq, float* dk, float* dv, int B,
           const Dims& d, cudaStream_t stream) {
  constexpr int LD = DP + 4;
  Plan pl[3];
  plans_for(B, d.H, d.Hkv, d.T, d.S, d.D, pl);
  const size_t b_kv = (static_cast<size_t>(2 * kTile + 2 * STKV * BQ) * LD + 2 * STKV * BQ) *
                      sizeof(float);
  const size_t b_q = static_cast<size_t>(2 * kTile * MTQ + 2 * STQ * BN) * LD * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(swa_bwd_dkdv<DP, DC, BQ, STKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(b_kv));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(swa_bwd_dq<DP, BN, STQ, MTQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(b_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = vec_ok(q, d.qb, d.qh, d.qt) && vec_ok(k, d.kb, d.kh, d.ks) &&
                  vec_ok(v, d.vb, d.vh, d.vs) && vec_ok(g, d.gb, d.gh, d.gt);
  swa_bwd_drow<<<dim3(static_cast<unsigned>(pl[0].gx), static_cast<unsigned>(pl[0].gy)),
                 pl[0].threads, 0, stream>>>(o, g, drow, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  swa_bwd_dkdv<DP, DC, BQ, STKV>
      <<<dim3(static_cast<unsigned>(pl[1].gx), static_cast<unsigned>(pl[1].gy)), pl[1].threads,
         b_kv, stream>>>(q, k, v, g, lse, drow, dk, dv, d, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  swa_bwd_dq<DP, BN, STQ, MTQ>
      <<<dim3(static_cast<unsigned>(pl[2].gx), static_cast<unsigned>(pl[2].gy)), pl[2].threads,
         b_q, stream>>>(q, k, v, g, lse, drow, dq, d, vec);
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
  // <DP, dK/dV: DC, BQ, stages; dQ: BN, stages, m-tiles a warp>
  if (D <= 64)
    return launch<64, 64, 64, 2, 32, 2, 2>(fq, fk, fv, fo, fg, fl, fdr, fdq, fdk, fdv, B, d, st);
  if (D <= 128)
    return launch<128, 128, 32, 2, 64, 2, 1>(fq, fk, fv, fo, fg, fl, fdr, fdq, fdk, fdv, B, d,
                                             st);
  return launch<256, 128, 32, 1, 32, 1, 1>(fq, fk, fv, fo, fg, fl, fdr, fdq, fdk, fdv, B, d, st);
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
