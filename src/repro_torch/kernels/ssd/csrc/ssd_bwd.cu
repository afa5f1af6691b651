// The backward of kernel K7: the gradient of the Mamba-2 SSD intra-chunk
// block, float32, in 3xTF32 on the tensor cores.
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
//   dX = W^T dY + u o (B dS)                    dC  = M B
//   dB = M^T C + (u o X) dS^T
//   ddt_j = sum_t (dW o C B^T o e^{s_t - s_j})_tj + e^{s_{L-1} - s_j} R_j
//   ds_t  = sum_j (dW o W)_tj - sum_i (dW o W)_it - E_t  (+ sum_j E_j at t = L-1)
//
// with R_j = sum_p X_jp (B dS)_jp (= sum_n B_jn (X dS^T)_jn) and E_j = u_j
// R_j.  ddt is the direct part only: s = chunk_logdecay(dt, A) stays in
// PyTorch, whose autograd carries ds into dt and A through the cumsum.
// ssd/ref.py: ssd_intra_chunk_backward_ref is the plain version.
//
// Layouts.  x (Ba, T, H, P), dY (Ba, T, H, P) and B/C (Ba, T, G, N) come
// with their batch, time and head/group strides (the last axis
// contiguous); head h reads group h / (H / G).  dt (Ba, T, H), s (Ba, nc,
// L, H) and dS (Ba, nc, H, N, P) are contiguous float32.  dX (Ba, T, H, P),
// ddt (Ba, T, H) and ds (Ba, nc, L, H) are written contiguous; dB and dC
// as (Ba, T, G x S, N), one partial sum per slice of HS heads of a group
// (S = H / G / HS slices), which the launcher sums over the slices (the
// adjoint of the per-head repeat, which the reference keeps outside its
// kernel).
//
// Bound.  At mamba2-1.3b's training shape (Ba 4, T 2048, H 64, P 64,
// N 128, G 1, L 64) the bytes (x, dY, dS, B, C, dt, s in; dX, ddt, ds, dB
// and dC grouped out) are 696 MB, 0.208 ms at 3.35 TB/s; the products the
// gradient needs (C B^T once per group; dY X^T, W^T dY, M B and M^T C per
// head; all on the causal lower triangle; the two dS products per head
// whole) 30.3 GFLOP, 0.184 ms as three TF32 products at 495 TFLOP/s
// (0.453 ms on the float32 CUDA cores).  So the bytes bound it, the
// products close behind, and the per-head dB and dC of the first,
// CUDA-core form (1.07 GB more, 0.32 ms) had to go.  That form did the
// products per head on whole L x L squares (0.769 ms on the CUDA cores).
//
// Design.  Two kernels on one stream, each on the forward's grid (one block
// per (batch, chunk, group, slice of HS heads), HS the largest divisor of
// H / G, at most 8, that leaves two blocks per SM), each recomputing what
// it needs from the forward's inputs:
//  * ssd_bwd_dc, four warps: warp w owns the rows t = 16 w .. 16 w + 15.
//    Per head, dW = dY X^T over the column tiles j <= 16 w + 15, M on the
//    accumulator fragments, and dC += M B with M the A operand in registers
//    (tf32.cuh: acc_to_a, load_b_kn_perm).  dC of the slice's heads is
//    summed in registers, head by head, and written once.
//  * ssd_bwd_dxdb, two warpgroups whose warps own rows j, so that W^T and
//    M^T come out of the products as accumulators with rows j.  Both form
//    G^T = B C^T once per block (the scores are the same for every head of
//    a group).  Per head, warpgroup 0 (warp w: rows 16 w ..) forms dW^T =
//    X dY^T over the column tiles t >= 16 w, then P1^T = dW^T o G^T o decay
//    (its row sums give ddt's first term; its column sums, weighted by
//    dt_j, ds's first, the four warps' partials added through shared memory
//    in a fixed order), M^T, and dB += M^T C + (u o X) dS^T (two products
//    from zero, added in float32, summed over the slice's heads in
//    registers).  Warpgroup 1 (warp w: rows 16 (3 - w) .., so that each SM
//    sub-partition pairs a long causal walk with a short one) forms W^T
//    and dX = W^T dY + u o V with V = B dS, in two chunks of 32 columns of
//    p, and R_j = sum_p X_jp V_jp on the CUDA cores.  Each warpgroup walks
//    the heads in a loop of its own (the same barriers), so that neither
//    keeps the other's accumulators live.  The row and column sums for ddt
//    and ds run in float32 on the CUDA cores in a fixed order.
// Both recompute dW, and each of ssd_bwd_dxdb's warpgroups forms G^T for
// its own rows, once per slice of HS heads: at mamba2's shape about 3.2
// GFLOP (11 %) more than the 30.3 the gradient needs (counted on the
// triangles), for blocks that need no cross-block sum.  No atomics:
// every output element is summed by one thread in a fixed order, so two
// runs give the same bits.
//
// Products, loads, accumulation.  Every product is 3xTF32 (tf32.cuh:
// mma.sync m16n8k8, each operand split into two TF32 parts right after its
// load, three products summed in float32).  Fragment loads read either
// orientation of a shared tile (load_a, load_b_nk, load_b_kn_perm, and for
// B dS load_a_perm), so one copy of each operand serves every product.  A
// tensor-core accumulator cuts each sum toward zero: G^T and V sum N in two
// halves of 64, each from zero, added in float32; the products over the
// chunk's rows or over P run in one accumulator from zero, added to their
// outputs in float32.  A float64 model of this arithmetic
// (tests/test_torch_ssd_tf32.py) puts every gradient, ds included, within
// 2e-6 of exact float64.  Loads are cp.async (16-byte pieces where the
// views allow it, else 4-byte ones): B and C once, then x, dY (and dS)
// through a ring of two stages, head hl + 1 loading under head hl's
// products.  Rows past L are zero-filled and never written; the widths are
// padded to 32 with zero columns (a group of four n-tiles runs whole),
// shared rows are the padded width plus 4 floats (LD = 4 mod 8: 32
// distinct banks for every fragment load but load_a_perm's).
//
// Code size.  The k-step loops whose index only moves addresses stay
// rolled (#pragma unroll 1); those whose A operand is an accumulator (the
// tile products) must unroll, since registers are not indexed at run time.
// Unrolled whole, ssd_bwd_dxdb's two warpgroups ran two long streams of
// different code, which (by inference) did not fit the instruction cache:
// rolling took the backward from 2.31 to 1.75 ms at mamba2's shape (H100).
//
// Resources at L 64, N 128, P 64, HS 8 (ptxas, sm_90a, nvcc 12.9):
// ssd_bwd_dc 103 KB of shared memory (B, two stages of x and dY, s and
// dt), two blocks of 128 threads per SM, 195 registers, no spills, 408
// TF32 HMMA instructions; ssd_bwd_dxdb 208 KB (C, B, two stages of x, dY
// and dS, the tables, the sums' scratch), one block of 256 threads per SM,
// 255 registers, no spills, 744 TF32 HMMA instructions.  ssd_bwd_dxdb
// takes three quarters of the backward's time: with one block of eight
// warps a SM it waits on mma.sync's and the loads' latencies.
#include "../../csrc/tf32.cuh"
#include "heads.cuh"

#include <algorithm>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;     // ssd_bwd_dc: four warps
constexpr int kThreadsX = 256;    // ssd_bwd_dxdb: two warpgroups
constexpr int kRows = 64;         // rows of a chunk's tiles (L <= 64)
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use (H100)

struct Dims {
  int T, H, G, N, P, L, nc, R, HS, ns;  // R = H / G heads per group, ns = R / HS slices
  long long xb, xt, xh;  // x strides (elements)
  long long bb, bt, bg;  // B strides
  long long cb, ct, cg;  // C strides
  long long yb, yt, yh;  // dY strides
};

__host__ __device__ inline int round32(int n) { return (n + 31) & ~31; }

// Offsets (floats) of the two kernels' shared memory; every one a multiple
// of 4.  ldn, ldp: the row lengths of the N- and P-wide tiles.
struct Smem {
  int ldn, ldp, npad;
  long long dc_b, dc_stage, dc_tab, dc_total;                                   // ssd_bwd_dc
  long long c, b, stage, st_y, st_s, tab, red, total;                           // ssd_bwd_dxdb
};

__host__ __device__ inline Smem smem_for(int N, int P, int HS) {
  Smem z;
  z.npad = round32(N);
  z.ldn = z.npad + 4;
  z.ldp = round32(P) + 4;
  const long long tn = static_cast<long long>(kRows) * z.ldn, tp = static_cast<long long>(kRows) * z.ldp;
  // ssd_bwd_dc: B [64][ldn]; stages [2] of {x, dY} [64][ldp]; s, dt [HS][64]
  z.dc_b = 0;
  z.dc_stage = tn;
  z.dc_tab = z.dc_stage + 4 * tp;
  z.dc_total = z.dc_tab + 2LL * HS * kRows;
  // ssd_bwd_dxdb: C, B [64][ldn]; stages [2] of {x, dY [64][ldp], dS [npad][ldp]};
  // s, dt [HS][64]; the sums' scratch: column partials [4][64], row sums, R, E [64]
  z.c = 0;
  z.b = tn;
  z.stage = 2 * tn;
  z.st_y = tp;                                            // dY within a stage
  z.st_s = 2 * tp;                                        // dS within a stage
  const long long stage = 2 * tp + static_cast<long long>(z.npad) * z.ldp;
  z.tab = z.stage + 2 * stage;
  z.red = z.tab + 2LL * HS * kRows;
  z.total = z.red + 7LL * kRows;
  return z;
}

// the stage size (floats) of ssd_bwd_dxdb
__host__ __device__ inline long long dxdb_stage(const Smem& z) {
  return 2LL * kRows * z.ldp + static_cast<long long>(z.npad) * z.ldp;
}

// the block's (batch, chunk, group, slice), slice fastest: the blocks of
// one (batch, chunk, group) run together
struct Cell {
  int b, c, grp, slice, h0;
};
__device__ __forceinline__ Cell cell_of(const Dims& d) {
  int r = blockIdx.x;
  Cell z;
  z.slice = r % d.ns;
  r /= d.ns;
  z.grp = r % d.G;
  r /= d.G;
  z.c = r % d.nc;
  z.b = r / d.nc;
  z.h0 = z.grp * d.R + z.slice * d.HS;
  return z;
}

// s and dt of the block's heads into tables [HS][64]; rows past L are 0
__device__ __forceinline__ void load_tables(float* s_tab, float* dt_tab, const float* s,
                                            const float* dt, const Dims& d, const Cell& z) {
  const long long srow = (static_cast<long long>(z.b) * d.nc + z.c) * d.L;
  const long long trow = static_cast<long long>(z.b) * d.T + static_cast<long long>(z.c) * d.L;
  for (int e = threadIdx.x; e < kRows * d.HS; e += blockDim.x) {
    const int tt = e / d.HS, hl = e - tt * d.HS;
    s_tab[hl * kRows + tt] = tt < d.L ? s[(srow + tt) * d.H + z.h0 + hl] : 0.f;
    dt_tab[hl * kRows + tt] = tt < d.L ? dt[(trow + tt) * d.H + z.h0 + hl] : 0.f;
  }
}

// An accumulator of NT n-tiles (rows r0 + g and r0 + g + 8, columns col0 +
// 8 jn ..) out as 16-byte stores (tf32.cuh, pair_rows); rows at or past
// `rows` and columns at or past `cols` are not written.  row_stride: the
// output's stride between rows (floats).
template <int NT>
__device__ __forceinline__ void store_tile(float* out, const float (&acc)[NT][4], int r0, int col0,
                                           int rows, int cols, long long row_stride, int g, int t) {
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {
    float o[4];
    const int row = r0 + g + (pair_rows(acc[jn], t, o) ? 8 : 0);
    const int col = col0 + 8 * jn + 4 * (t >> 1);
    if (row < rows && col < cols) store4(out + row * row_stride + col, o);
  }
}

// Accumulator fragments (g = lane / 4, t = lane % 4): rows g (entries 0, 1)
// and g + 8 (2, 3) of the warp's 16, columns 8 j + 2 t + {0, 1} of n-tile j.

// dC = sum over the slice's heads of M B; rows t of warp w: 16 w ..
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_dc(const float* __restrict__ x, const float* __restrict__ Bm, const float* __restrict__ dt,
           const float* __restrict__ s, const float* __restrict__ dy, float* __restrict__ dC,
           Dims d, int vec) {
  extern __shared__ __align__(16) float sm[];
  const Smem z = smem_for(d.N, d.P, d.HS);
  const int ldn = z.ldn, ldp = z.ldp, L = d.L, N = d.N, P = d.P;
  float* sB = sm + z.dc_b;           // B [64][ldn]
  float* stg = sm + z.dc_stage;      // [2] x {x, dY} [64][ldp]
  float* s_tab = sm + z.dc_tab;      // [HS][64]
  float* dt_tab = s_tab + d.HS * kRows;
  const Cell cl = cell_of(d);
  const int tid = threadIdx.x, wp = tid >> 5, g = (tid >> 2) & 7, t = tid & 3;
  const long long t0 = static_cast<long long>(cl.c) * L;
  const float* xg = x + cl.b * d.xb + t0 * d.xt;
  const float* yg = dy + cl.b * d.yb + t0 * d.yt;
  const int tp = kRows * ldp;

  zero_pad(sB, kRows, N, z.npad, ldn);
  zero_pad(stg, 4 * kRows, P, ldp - 4, ldp);
  load_rows_async(sB, Bm + cl.b * d.bb + t0 * d.bt + cl.grp * d.bg, d.bt, 0, kRows, L, N, ldn, vec);
  load_rows_async(stg, xg + cl.h0 * d.xh, d.xt, 0, kRows, L, P, ldp, vec);
  load_rows_async(stg + tp, yg + cl.h0 * d.yh, d.yt, 0, kRows, L, P, ldp, vec);
  cp_commit();
  load_tables(s_tab, dt_tab, s, dt, d, cl);
  cp_wait<0>();
  __syncthreads();

  const int nkp = (P + 7) / 8, nkl = (L + 7) / 8, nnt = (N + 7) / 8;
  const int r0 = 16 * wp, ta = r0 + g, tb = ta + 8;
  const int ny = r0 < L ? min(2 * wp + 2, nkl) : 0;   // column tiles j <= t of this warp
  float acc[16][4];   // dC of rows ta, tb, 16 n-tiles of n
  zero(acc);

  for (int hl = 0; hl < d.HS; ++hl) {
    const int h = cl.h0 + hl;
    if (hl + 1 < d.HS) {   // the next head's x and dY into the other stage
      float* nx = stg + ((hl + 1) & 1) * 2 * tp;
      load_rows_async(nx, xg + (h + 1) * d.xh, d.xt, 0, kRows, L, P, ldp, vec);
      load_rows_async(nx + tp, yg + (h + 1) * d.yh, d.yt, 0, kRows, L, P, ldp, vec);
      cp_commit();
    }
    const float* xs = stg + (hl & 1) * 2 * tp;
    const float* ys = xs + tp;
    const float* s_h = s_tab + hl * kRows;
    const float* dt_h = dt_tab + hl * kRows;
    if (ny > 0) {
      // dW = dY X^T over p, the column tiles j <= 16 w + 15
      float m[8][4];
      zero(m);
#pragma unroll 1
      for (int kk = 0; kk < 8; ++kk) {
        if (kk >= nkp) break;
        FragA a;
        load_a(a, ys + r0 * ldp + 8 * kk, ldp, g, t);
#pragma unroll
        for (int jg = 0; jg < 8; jg += 4) {
          if (jg < ny) {
            FragB bf[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) load_b_nk(bf[j], xs + 8 * (jg + j) * ldp + 8 * kk, ldp, g, t);
            mma3_group(m, jg, a, bf);
          }
        }
      }
      // M = select(j <= t < L, dW e^{s_t - s_j} dt_j, 0) in place
      const float s_a = s_h[ta], s_b = s_h[tb];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tr = e < 2 ? ta : tb, j = 8 * jn + 2 * t + (e & 1);
          m[jn][e] = (j <= tr && tr < L)
                         ? m[jn][e] * expf((e < 2 ? s_a : s_b) - s_h[j]) * dt_h[j] : 0.f;
        }
      // dC += M B over j, 64 columns of n at a time
#pragma unroll
      for (int jc = 0; jc < 16; jc += 8) {
        if (jc < nnt) {
          float part[8][4];
          tile_product<8, 8>(part, m, sB, ldn, jc, nnt, 0, ny, g, t);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[jc + j][e] += part[j][e];
        }
      }
    }
    cp_wait<0>();      // the next head's tiles have landed (this thread's copies)
    __syncthreads();   // everyone's; and every warp is done with this stage
  }
  // the slice's partial: dC (Ba, T, G x S, N)
  const int gs = d.G * d.ns;
  float* out = dC + ((cl.b * static_cast<long long>(d.T) + t0) * gs + cl.grp * d.ns + cl.slice) * N;
  store_tile<16>(out, acc, r0, 0, L, N, static_cast<long long>(gs) * N, g, t);
}

// dX, ddt, ds per head and dB = sum over the slice's heads.  Two
// warpgroups: warpgroup 0 (warp w owning the rows j = 16 w ..) forms dW^T,
// P1^T's sums and M^T, and dB; warpgroup 1 (warp w owning the rows j =
// 16 (3 - w) .., so that each SM sub-partition pairs a long causal walk
// with a short one) forms W^T, V = B dS, dX and R.
__global__ void __launch_bounds__(kThreadsX, 1)
ssd_bwd_dxdb(const float* __restrict__ x, const float* __restrict__ Bm,
             const float* __restrict__ Cm, const float* __restrict__ dt,
             const float* __restrict__ s, const float* __restrict__ dy,
             const float* __restrict__ dS, float* __restrict__ dx, float* __restrict__ ddt,
             float* __restrict__ ds, float* __restrict__ dB, Dims d, int vec) {
  extern __shared__ __align__(16) float sm[];
  const Smem z = smem_for(d.N, d.P, d.HS);
  const int ldn = z.ldn, ldp = z.ldp, L = d.L, N = d.N, P = d.P, H = d.H;
  const long long stage = dxdb_stage(z);
  float* sC = sm + z.c;              // C [64][ldn]
  float* sB = sm + z.b;              // B [64][ldn]
  float* stg = sm + z.stage;         // [2] x {x [64][ldp], dY [64][ldp], dS [npad][ldp]}
  float* s_tab = sm + z.tab;         // [HS][64]
  float* dt_tab = s_tab + d.HS * kRows;
  float* colpart = sm + z.red;       // [4][64]: each warp's column sums of P1^T weighted by dt_j
  float* rsum = colpart + 4 * kRows; // [64]: row sums of P1^T
  float* rv = rsum + kRows;          // [64]: R
  float* ev = rv + kRows;            // [64]: E
  const Cell cl = cell_of(d);
  const int tid = threadIdx.x, wg = tid >> 7, wp = (tid >> 5) & 3, g = (tid >> 2) & 7, t = tid & 3;
  const long long t0 = static_cast<long long>(cl.c) * L;
  const long long srow = (static_cast<long long>(cl.b) * d.nc + cl.c) * L;
  const long long trow = static_cast<long long>(cl.b) * d.T + t0;
  const float* xg = x + cl.b * d.xb + t0 * d.xt;
  const float* yg = dy + cl.b * d.yb + t0 * d.yt;
  const long long cell0 = (static_cast<long long>(cl.b) * d.nc + cl.c) * H;   // (b, c, head 0)

  auto issue = [&](int hl) {   // x, dY and dS of head hl into stage hl % 2
    float* st = stg + (hl & 1) * stage;
    const int h = cl.h0 + hl;
    load_rows_async(st, xg + h * d.xh, d.xt, 0, kRows, L, P, ldp, vec);
    load_rows_async(st + z.st_y, yg + h * d.yh, d.yt, 0, kRows, L, P, ldp, vec);
    load_rows_async(st + z.st_s, dS + (cell0 + h) * N * P, P, 0, z.npad, N, P, ldp, vec);
  };
  zero_pad(sC, 2 * kRows, N, z.npad, ldn);   // C and B
  for (int i = 0; i < 2; ++i) zero_pad(stg + i * stage, 2 * kRows + z.npad, P, ldp - 4, ldp);
  load_rows_async(sC, Cm + cl.b * d.cb + t0 * d.ct + cl.grp * d.cg, d.ct, 0, kRows, L, N, ldn, vec);
  load_rows_async(sB, Bm + cl.b * d.bb + t0 * d.bt + cl.grp * d.bg, d.bt, 0, kRows, L, N, ldn, vec);
  issue(0);
  cp_commit();
  load_tables(s_tab, dt_tab, s, dt, d, cl);
  cp_wait<0>();
  __syncthreads();

  const int nkp = (P + 7) / 8, nkl = (L + 7) / 8, nkn = (N + 7) / 8, nnt = nkn, npt = nkp;
  const int r0 = 16 * (wg == 0 ? wp : 3 - wp), ja = r0 + g, jb = ja + 8;
  const bool live = r0 < L;
  const int kt0 = r0 / 8;   // the first column tile t >= r0

  // ---- G^T = B C^T, rows j of this warp, the column tiles t >= r0; once
  // for the block's heads, N in two halves summed from zero ----------------
  float gt[8][4];
  zero(gt);
  if (live) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (8 * half >= nkn) break;
      float part[8][4];
      zero(part);
#pragma unroll 1
      for (int kk = 0; kk < 8; ++kk) {
        const int k = 8 * half + kk;
        if (k >= nkn) break;
        FragA a;
        load_a(a, sB + r0 * ldn + 8 * k, ldn, g, t);
#pragma unroll
        for (int jg = 0; jg < 8; jg += 4) {
          if (jg + 3 >= kt0 && jg < nkl) {
            FragB bf[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) load_b_nk(bf[j], sC + 8 * (jg + j) * ldn + 8 * k, ldn, g, t);
            mma3_group(part, jg, a, bf);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gt[j][e] += part[j][e];
    }
  }

  // Each warpgroup walks the heads in a loop of its own, so that each keeps
  // only its own accumulators live; both loops meet the same barriers (two
  // a head).  Head hl + 1's tiles load into the other stage under head hl's
  // products, every thread its share.
  auto heads = [&](auto&& body, auto&& tail) {
    for (int hl = 0; hl < d.HS; ++hl) {
      if (hl + 1 < d.HS) {
        issue(hl + 1);
        cp_commit();
      }
      const float* xs = stg + (hl & 1) * stage;
      const float* s_h = s_tab + hl * kRows;
      const float* dt_h = dt_tab + hl * kRows;
      const float s_ja = s_h[ja], s_jb = s_h[jb], dt_ja = dt_h[ja], dt_jb = dt_h[jb];
      // e^{s_{L-1} - s_j} and u_j of rows ja, jb (0 past L)
      const float ee_a = ja < L ? expf(s_h[L - 1] - s_ja) : 0.f;
      const float ee_b = jb < L ? expf(s_h[L - 1] - s_jb) : 0.f;
      body(cl.h0 + hl, xs, xs + z.st_y, xs + z.st_s, s_h, s_ja, s_jb, dt_ja, dt_jb, ee_a * dt_ja,
           ee_b * dt_jb);
      __syncthreads();   // the sums' scratch is written
      tail(cl.h0 + hl, s_h, dt_h);
      cp_wait<0>();      // the next head's tiles have landed (this thread's copies)
      __syncthreads();   // everyone's; every warp is done with this stage and the sums
    }
  };

  if (wg == 0) {
    float acc[16][4];   // dB of rows ja, jb, 16 n-tiles of n
    zero(acc);
    heads([&](int h, const float* xs, const float* ys, const float* ss, const float* s_h,
              float s_ja, float s_jb, float dt_ja, float dt_jb, float u_a, float u_b) {
      float rs_a = 0.f, rs_b = 0.f;
      float cp[8][2];   // this thread's column partials of P1^T (two rows each), weighted by dt_j
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) cp[jn][0] = cp[jn][1] = 0.f;
      if (live) {
        // ---- dW^T = X dY^T over p, the column tiles t >= r0 --------------
        float m[8][4];
        zero(m);
#pragma unroll 1
        for (int kk = 0; kk < 8; ++kk) {
          if (kk >= nkp) break;
          FragA a;
          load_a(a, xs + r0 * ldp + 8 * kk, ldp, g, t);
#pragma unroll
          for (int jg = 0; jg < 8; jg += 4) {
            if (jg + 3 >= kt0 && jg < nkl) {
              FragB bf[4];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                load_b_nk(bf[j], ys + 8 * (jg + j) * ldp + 8 * kk, ldp, g, t);
              mma3_group(m, jg, a, bf);
            }
          }
        }
        // ---- P1^T = dW^T o G^T o decay: its sums; M^T in place ------------
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jr = e < 2 ? ja : jb, tc = 8 * jn + 2 * t + (e & 1);
            const bool ok = jr <= tc && tc < L;   // the decay of j > t is never formed
            const float ex = ok ? expf(s_h[tc] - (e < 2 ? s_ja : s_jb)) : 0.f;
            const float p1 = ok ? m[jn][e] * (gt[jn][e] * ex) : 0.f;
            const float dtj = e < 2 ? dt_ja : dt_jb;
            m[jn][e] = ok ? m[jn][e] * ex * dtj : 0.f;
            if (e < 2) rs_a += p1; else rs_b += p1;
            cp[jn][e & 1] += p1 * dtj;
          }
        // ---- dB += M^T C + (u o X) dS^T, 64 columns of n at a time -------
#pragma unroll
        for (int jc = 0; jc < 16; jc += 8) {
          if (jc < nnt) {
            float part[8][4];
            tile_product<8, 8>(part, m, sC, ldn, jc, nnt, kt0, nkl, g, t);
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[jc + j][e] += part[j][e];
            zero(part);
#pragma unroll 1
            for (int kk = 0; kk < 8; ++kk) {
              if (kk >= nkp) break;
              FragA a;
              load_a_scaled(a, xs + r0 * ldp + 8 * kk, ldp, g, t, u_a, u_b);
#pragma unroll
              for (int jg = 0; jg < 8; jg += 4) {
                if (jc + jg < nnt) {
                  FragB bf[4];
#pragma unroll
                  for (int j = 0; j < 4; ++j)
                    load_b_nk(bf[j], ss + 8 * (jc + jg + j) * ldp + 8 * kk, ldp, g, t);
                  mma3_group(part, jg, a, bf);
                }
              }
            }
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[jc + j][e] += part[j][e];
          }
        }
      }
      // the row sums within quads, the column partials over the warp's 16
      // rows (0 from a warp past L), out to shared memory
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        rs_a += __shfl_xor_sync(0xffffffffu, rs_a, off);
        rs_b += __shfl_xor_sync(0xffffffffu, rs_b, off);
      }
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float v = cp[jn][q];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
          if (g == 0) colpart[wp * kRows + 8 * jn + 2 * t + q] = v;
        }
      if (t == 0) {
        if (ja < L) rsum[ja] = rs_a;
        if (jb < L) rsum[jb] = rs_b;
      }
    }, [&](int h, const float* s_h, const float* dt_h) {
      // ---- ddt, E and ds per row (threads 0 .. 63, warps 0 and 1) ---------
      if (tid >= kRows) return;
      // sum_j E_j: both warps reduce the same 64 values in the same order
      const int ln = tid & 31;
      float tot = (ln < L ? ev[ln] : 0.f) + (ln + 32 < L ? ev[ln + 32] : 0.f);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, off);
      if (tid < L) {
        const float ee = expf(s_h[L - 1] - s_h[tid]);
        ddt[(trow + tid) * H + h] = rsum[tid] + ee * rv[tid];
        const float row = ((colpart[tid] + colpart[kRows + tid]) + colpart[2 * kRows + tid]) +
                          colpart[3 * kRows + tid];
        // the product rounded on its own (not contracted into the
        // difference), so the diagonal's two terms cancel exactly where they
        // stand alone (L = 1: ds = 0)
        float v = __fsub_rn(row, __fmul_rn(dt_h[tid], rsum[tid])) - ev[tid];
        if (tid == L - 1) v += tot;
        ds[(srow + tid) * H + h] = v;
      }
    });
    // the slice's partial: dB (Ba, T, G x S, N)
    const int gs = d.G * d.ns;
    float* out =
        dB + ((cl.b * static_cast<long long>(d.T) + t0) * gs + cl.grp * d.ns + cl.slice) * N;
    store_tile<16>(out, acc, r0, 0, L, N, static_cast<long long>(gs) * N, g, t);
  } else {
    heads([&](int h, const float* xs, const float* ys, const float* ss, const float* s_h,
              float s_ja, float s_jb, float dt_ja, float dt_jb, float u_a, float u_b) {
      float R_a = 0.f, R_b = 0.f;
      if (live) {
        // ---- W^T = select(j <= t < L, G^T e^{s_t - s_j} dt_j, 0) ----------
        float w[8][4];
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jr = e < 2 ? ja : jb, tc = 8 * jn + 2 * t + (e & 1);
            const bool ok = jr <= tc && tc < L;
            const float ex = ok ? expf(s_h[tc] - (e < 2 ? s_ja : s_jb)) : 0.f;
            w[jn][e] = ok ? (gt[jn][e] * ex) * (e < 2 ? dt_ja : dt_jb) : 0.f;
          }
        // ---- dX = W^T dY + u o V, V = B dS; 32 columns of p at a time -----
        float* dxh = dx + (trow * H + h) * P;
#pragma unroll
        for (int pc = 0; pc < 8; pc += 4) {
          if (pc < npt) {
            float v[4][4], part[4][4];
            zero(v);
#pragma unroll
            for (int half = 0; half < 2; ++half) {   // V over n in two halves, each from zero
              if (8 * half >= nkn) break;
              zero(part);
#pragma unroll 1
              for (int kk = 0; kk < 8; ++kk) {
                const int k = 8 * half + kk;
                if (k >= nkn) break;
                FragA a;
                load_a_perm(a, sB + r0 * ldn + 8 * k, ldn, g, t);
                FragB bf[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  load_b_kn_perm(bf[j], ss + 8 * k * ldp + 8 * (pc + j), ldp, g, t);
                mma3_group(part, 0, a, bf);
              }
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) v[j][e] += part[j][e];
            }
            // R_j = sum_p X_jp V_jp (this thread's columns)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int jr = e < 2 ? ja : jb, p = 8 * (pc + j) + 2 * t + (e & 1);
                const float xv = xs[jr * ldp + p];
                if (e < 2) R_a = fmaf(xv, v[j][e], R_a); else R_b = fmaf(xv, v[j][e], R_b);
              }
            tile_product<8, 4>(part, w, ys, ldp, pc, npt, kt0, nkl, g, t);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                part[j][e] = fmaf(e < 2 ? u_a : u_b, v[j][e], part[j][e]);
            store_tile<4>(dxh, part, r0, 8 * pc, L, P, static_cast<long long>(H) * P, g, t);
          }
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        R_a += __shfl_xor_sync(0xffffffffu, R_a, off);
        R_b += __shfl_xor_sync(0xffffffffu, R_b, off);
      }
      if (t == 0) {
        if (ja < L) {
          rv[ja] = R_a;
          ev[ja] = u_a * R_a;
        }
        if (jb < L) {
          rv[jb] = R_b;
          ev[jb] = u_b * R_b;
        }
      }
    }, [](int, const float*, const float*) {});
  }
}

bool valid(int Ba, int T, int H, int G, int N, int P, int L) {
  return L >= 1 && L <= 64 && T % L == 0 && N >= 4 && N <= 128 && N % 4 == 0 && P >= 4 &&
         P <= 64 && P % 4 == 0 && G >= 1 && H % G == 0 && Ba >= 1;
}

}  // namespace

// float32 only.  strides: x's batch, time and head strides, then B's and
// C's batch, time and group strides, then dY's batch, time and head
// strides (elements).  dB and dC are (Ba, T, G x S, N) with S = H / G /
// HS, one partial sum per slice of HS heads (HS: heads_per_block on the
// current device, as repro_ssd_bwd_plan reports it).  Returns the CUDA
// error code of the launches (0: launched).
extern "C" int repro_ssd_backward(const void* x, const void* Bm, const void* Cm, const void* dt,
                                  const void* s, const void* dy, const void* dstates, void* dx,
                                  void* ddt, void* ds, void* dB, void* dC, int Ba, int T, int H,
                                  int G, int N, int P, int L, const long long* strides,
                                  void* stream) {
  if (!valid(Ba, T, H, G, N, P, L)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int e_sm = sm_count(&sms);
  if (e_sm != 0) return e_sm;
  const int hs = heads_per_block(Ba, H, G, T / L, sms);
  const long long* st = strides;
  const int R = H / G;
  const Dims d{T, H, G, N, P, L, T / L, R, hs, R / hs,
               st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]};
  const long long blocks = static_cast<long long>(Ba) * d.nc * G * d.ns;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Smem z = smem_for(N, P, hs);
  const long long b_dc = z.dc_total * static_cast<long long>(sizeof(float));
  const long long b_dxdb = z.total * static_cast<long long>(sizeof(float));
  if (b_dxdb > kMaxSmem || b_dc > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_dc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(b_dc));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_dxdb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(b_dxdb));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float *fx = static_cast<const float*>(x), *fB = static_cast<const float*>(Bm),
              *fC = static_cast<const float*>(Cm), *fdt = static_cast<const float*>(dt),
              *fs = static_cast<const float*>(s), *fdy = static_cast<const float*>(dy);
  const int vec = vec_ok(x, d.xb, d.xh, d.xt) && vec_ok(Bm, d.bb, d.bg, d.bt) &&
                  vec_ok(Cm, d.cb, d.cg, d.ct) && vec_ok(dy, d.yb, d.yh, d.yt) &&
                  vec_ok(dstates, 0, 0, 0);
  const cudaStream_t stm = static_cast<cudaStream_t>(stream);
  ssd_bwd_dc<<<static_cast<unsigned>(blocks), kThreads, b_dc, stm>>>(
      fx, fB, fdt, fs, fdy, static_cast<float*>(dC), d, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dxdb<<<static_cast<unsigned>(blocks), kThreadsX, b_dxdb, stm>>>(
      fx, fB, fC, fdt, fs, fdy, static_cast<const float*>(dstates), static_cast<float*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(ds), static_cast<float*>(dB), d, vec);
  return static_cast<int>(cudaGetLastError());
}

// The launch plan repro_ssd_backward uses for these sizes (both kernels
// share its grid): out[0..5] = blocks along x, y and z, threads per block
// of ssd_bwd_dxdb (ssd_bwd_dc takes half as many), heads per block (hs),
// bytes of dynamic shared memory of ssd_bwd_dxdb (the larger).  Returns a
// CUDA error code.
extern "C" int repro_ssd_bwd_plan(int Ba, int T, int H, int G, int N, int P, int L,
                                  long long* out) {
  if (!valid(Ba, T, H, G, N, P, L)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int e_sm = sm_count(&sms);
  if (e_sm != 0) return e_sm;
  const int hs = heads_per_block(Ba, H, G, T / L, sms);
  out[0] = static_cast<long long>(Ba) * (T / L) * G * (H / G / hs);
  out[1] = 1;
  out[2] = 1;
  out[3] = kThreadsX;
  out[4] = hs;
  out[5] = smem_for(N, P, hs).total * static_cast<long long>(sizeof(float));
  return 0;
}
