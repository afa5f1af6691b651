// Kernel K7 of the port: the intra-chunk block of the Mamba-2 SSD scan.
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py:29,57
// (_ssd_chunk_kernel / ssd_intra_chunk_pallas) and computes what its body
// computes, per (batch, head, chunk) of length L:
//
//   W[t][j] = (C_t . B_j) * exp(s_t - s_j) * dt_j   for j <= t, else 0
//   Y_diag  = W X                                   (L x P), in x's type
//   S_c     = (exp(s_{L-1} - s) * dt * B)^T X       (N x P), float32
//
// with s the inclusive in-chunk cumulative sum of dt * A in float32,
// computed outside (ssd/ref.py: chunk_logdecay), as the reference does.
// The decay exp(s_t - s_j) of j > t is a positive exponent that may
// overflow: it is never used, the entry is selected to 0 (a 0/1 mask times
// inf would give NaN).
//
// Layouts.  x (Ba, T, H, P) and B/C (Ba, T, G, N) come with their batch,
// time and head/group strides (the last axis contiguous), so the slices of
// the Mamba layer's projection launch without copies; head h reads group
// h / (H / G), so grouped B/C are read as they are and never repeated per
// head.  dt (Ba, T, H) and s (Ba, nc, L, H) are contiguous float32; y_diag
// (Ba, T, H, P) and the states (Ba, nc, H, N, P) are written contiguous.
//
// Bound.  Each input is read once and each output written once: at the
// main path's shape (Ba 4, T 2048, H 64, P 64, N 128, G 1, L 64) in bf16
// that is ~411 MB (268 MB of it the float32 states), 0.123 ms at
// 3.35 TB/s, in float32 549 MB, 0.164 ms; the 10.8 GFLOP the causal block
// needs (C B^T once per group and W X on the lower triangle, the states
// whole) take 0.011 ms on the bf16 tensor cores and 0.066 ms as three TF32
// products, so the bytes bound both kernels.
//
// Which kernel runs.  Both run on the tensor cores; the C entry point
// picks, and reports its pick: x in bfloat16 with N and P multiples of 8
// runs ssd_chunk_kernel_tc (wgmma, TMA); float32, and bfloat16 with N or P
// not a multiple of 8, run ssd_chunk_kernel_tf32 (3xTF32 on mma.sync).  Both
// take L <= 64, N <= 128, P <= 64, and one grid (plan_for): HS heads of one
// group per block.
//
// float32 (and bfloat16 at the widths wgmma does not take):
// ssd_chunk_kernel_tf32<T>, 3xTF32 on the tensor cores (csrc/tf32.cuh:
// mma.sync m16n8k8, each float32 operand split into two TF32 parts, three
// products summed in float32, about 2^-21 of each product left out).
//  * Bound.  At mamba2-1.3b's training shape (Ba 4, T 2048, H 64, P 64,
//    N 128, G 1, L 64) in float32 the bytes (x, B, C, dt read once; y_diag,
//    the float32 states, s written once) are 549 MB, 0.164 ms at 3.35 TB/s,
//    half of them the states; the products the causal block needs (C B^T
//    once per group and W X on the L (L + 1) / 2 entries of the lower
//    triangle, (u o B)^T X whole) 10.8 GFLOP, 0.066 ms as three TF32
//    products at 495 TFLOP/s.  The first, CUDA-core form did 21.5 GFLOP
//    (per head, on whole L x L tiles), 0.32 ms on the float32 CUDA cores,
//    which is why it could not reach half of its bound.  So the bytes
//    bound it: the design computes C B^T once per group, not per head,
//    streams x through a ring and writes y and the states as
//    16-byte stores; and it keeps enough warps in flight (four a
//    sub-partition) for mma.sync's latencies.
//  * Work per block.  Two warpgroups per (batch, chunk, group, slice of HS
//    heads of that group), the wgmma kernel's grid: C and B are loaded once
//    and the scores C B^T computed once for the HS heads (a third of the
//    products at G = 1).  Warpgroup 0 forms the scores and Y, warp w the
//    rows t = 16 w .. 16 w + 15, over the column tiles j <= 16 w + 15 only
//    (the causal half); warpgroup 1 forms the states, warp w the rows n =
//    32 w .. 32 w + 31 (two m-tiles sharing each split fragment of X).
//    Per head: W = select(j <= t < L, S e^{s_t - s_j} dt_j, 0) on the
//    accumulator fragments of S, which are the A operand of W X under a
//    permuted k (tf32.cuh: acc_to_a, load_b_kn_perm); (u o B)^T, u_j =
//    e^{s_{L-1} - s_j} dt_j, read from B stored [j][n] by load_a_km_perm
//    (each u_j B_jn rounded to float32, as the plain version does).  Each
//    warpgroup walks the heads in a loop of its own, so that neither keeps
//    the other's accumulators live (128 registers, two blocks per SM).
//  * Loads.  C, B and the first head's x by cp.async (16-byte pieces where
//    the views allow it, else 4-byte ones; bfloat16 converted to float32
//    on the way, synchronously), then x through a ring of two stages: head
//    hl + 1 loads while head hl computes.  Rows past L are zero-filled (no
//    row of the next chunk is read), as are the pad columns N .. and P ..
//    (widths rounded up to 32: a group of four n-tiles runs whole).  Shared
//    rows are the widths plus 4 floats (LD = 4 mod 8), so every fragment
//    load reads 32 distinct banks.
//  * Stores.  y_diag (in x's type) and the states go out from the
//    accumulators, lanes t and t ^ 1 trading halves so that each lane
//    stores four consecutive columns at once (tf32.cuh, pair_rows): rows
//    past L and columns past N or P are never written.
//  * Accumulation.  A tensor-core accumulator cuts each sum toward zero
//    (tf32.cuh).  C B^T sums N in two halves of 64, each from zero, added
//    in float32; W X and the states sum the chunk's L <= 64 rows in one
//    accumulator.  A float64 model of this arithmetic
//    (tests/test_torch_ssd_tf32.py) puts y_diag and the states within 2e-6
//    of exact float64 (one TF32 product would leave ~7e-4).  Two runs give
//    the same bits.
//  * Resources.  Shared memory (2 x 64 (N32 + 4) + 2 x 64 (P32 + 4) + 3 x 64
//    HS) floats: 106 KB at N 128, P 64, HS 8, two blocks of 256 threads per
//    SM.  The k-steps of the scores and of the states stay rolled loops
//    (their index only moves addresses; unrolled, the kernel took 0.39 ms
//    at mamba2's training shape, rolled 0.36: by inference, the unrolled
//    code did not fit the instruction cache).  ptxas (sm_90a, nvcc 12.9):
//    128 registers, no spills; 288 TF32 HMMA instructions.
//
// bfloat16: ssd_chunk_kernel_tc, wgmma and TMA.
//  * Work per block.  One warpgroup (128 threads) per (batch, chunk,
//    group, slice of HS heads of that group).  C B^T is the same for every
//    head of a group: the block loads the chunk's C and B once (L x N bf16
//    each) and computes the scores C B^T once (wgmma m64n64k16, K = N, C
//    and B K-major from shared memory), kept in float32 registers.  Then,
//    head by head:
//      - the states, transposed: S_c^T = (u X)^T B with u_j = exp(s_{L-1} -
//        s_j) dt_j.  X^T comes out of the X tile by ldmatrix.trans, each
//        column j is scaled by u_j and split into three bf16 terms
//        hi + lo + lo2 (each the rounding of what the terms before it
//        left; together they hold the float32 value to 2^-24) in
//        registers, the A operand of wgmma m64n128k16 with B's tile as the
//        MN-major B operand: 12 products a head;
//      - while they run, W = select(j <= t < L, S exp(s_t - s_j) dt_j, 0) in
//        registers, as two bf16 terms hi + lo (the S fragment is the A
//        fragment of W, as K6 does with P);
//      - Y = W_hi X + W_lo X (wgmma m64n64k16, X the MN-major B operand): 8
//        products a head;
//      - y goes, as bf16, into the X stage it was computed from (its layout),
//        the states into four staging tiles (64 rows of n by 32 float32
//        columns of p, 128-byte swizzled, conflict-free scalar stores);
//        thread 0 stores both by TMA and goes on.  TMA clips the stores at
//        L, N and P: rows t >= L and columns past N or P are never written.
//    The launcher takes the largest HS (a divisor of H / G, at most 8) that
//    still gives at least two blocks per SM: 1024 blocks of 8 heads at
//    4 x 2048, 320 of 4 at 1 x 1000 (L 50).
//  * Loads.  Thread 0 issues every load as TMA from 5-D tensor maps of the
//    strided views, time cut into (chunk, row in chunk): (N | P, group |
//    head, row, chunk, batch), boxes of 64 columns by 64 rows, 128-byte
//    swizzled (the layout wgmma's descriptors read).  A ragged L (50, 5, 1)
//    is zero-filled, as are columns past N or P: no row of the next chunk
//    is read.  X comes through a ring of three stages on mbarriers; a stage
//    is reloaded (for the head three on) once the TMA store of the y it
//    staged has read it, one head later, so two heads' X are in flight.
//  * Precision (the states are held to 1e-5 normwise, y_diag to 1e-2).  C,
//    B and X are exact in bf16, so C B^T is exact up to summation order.
//    u X is not: a float32 CPU model of this plan
//    (tests/test_torch_ssd_tc.py) puts the states 1.8e-3 to 2.5e-3 off with
//    u X rounded once to bf16, 2.7e-6 to 5.2e-6 with two terms and 0.8e-7
//    to 1.6e-7 with three, hence three.  W rounded once puts y_diag up to
//    6.2e-3 off after its bf16 store, two terms up to 1.9e-3 (the store's
//    own rounding).  The tensor-core work stays far under the byte bound.
//  * Resources: 88 KB of tiles (C, B, the X ring, the states' staging)
//    and 768 HS bytes of float32 tables (s, dt, u); two blocks per SM.
//    ptxas (sm_90a, nvcc 12.9): 212 registers, no spills.
#include "../../csrc/tf32.cuh"
#include "heads.cuh"

#include <algorithm>
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kThreads = 128;               // the wgmma kernel: one warpgroup
constexpr int kF32Threads = 256;            // the 3xTF32 kernel: two warpgroups
constexpr int kRows = 64;                   // rows of a chunk's tiles (L <= 64)
constexpr int kMaxSmem = 232448;            // bytes of shared memory a block may use (H100)

// The launch plan of both kernels (kernels/plans.py::ssd_plan mirrors it):
// blocks along x, y and z, threads per block and heads per block: HS heads
// of one group per block (heads.cuh); one warpgroup a block on wgmma, two
// in 3xTF32.
struct Plan {
  long long gx;
  int gy, gz, threads, heads;
};

Plan plan_for(bool wgmma, int Ba, int H, int G, int nc, int sms) {
  const int HS = heads_per_block(Ba, H, G, nc, sms);
  return Plan{static_cast<long long>(Ba) * nc * G * (H / G / HS), 1, 1,
              wgmma ? kThreads : kF32Threads, HS};
}

struct Dims {
  int T, H, G, N, P, L, nc;
  long long xb, xt, xh;  // x strides (elements)
  long long bb, bt, bg;  // B strides
  long long cb, ct, cg;  // C strides
};

// ===========================================================================
// float32 (and bfloat16 at the widths wgmma does not take): 3xTF32
// ===========================================================================

struct F32Dims {
  Dims d;
  int R, HS, n_slices;
};

__host__ __device__ inline int round32(int n) { return (n + 31) & ~31; }

// floats of dynamic shared memory: C and B (64 rows of N32 + 4), two
// stages of x (64 rows of P32 + 4), the tables s, dt and u ([HS][64] each)
__host__ __device__ inline size_t f32_smem_floats(int N, int P, int HS) {
  return 2 * static_cast<size_t>(kRows) * (round32(N) + 4) +
         2 * static_cast<size_t>(kRows) * (round32(P) + 4) + 3 * static_cast<size_t>(HS) * kRows;
}

// rows [0, 64) of a strided (rows, D) tile into shared rows of LD floats,
// rows at or past `limit` zero: float32 by cp.async (the caller commits and
// waits), bfloat16 converted to float32 on the way
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long stride,
                                          int limit, int D, int LD, bool vec) {
  load_rows_async(dst, src, stride, 0, kRows, limit, D, LD, vec);
}
__device__ __forceinline__ void load_rows(float* dst, const __nv_bfloat16* src, long long stride,
                                          int limit, int D, int LD, bool) {
  for (int e = threadIdx.x; e < kRows * D; e += blockDim.x) {
    const int r = e / D, c = e - r * D;
    dst[r * LD + c] = r < limit ? __bfloat162float(src[r * stride + c]) : 0.f;
  }
}

// four consecutive float32 values out as T: a float4, or four bfloat16
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&o)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]), hi = __floats2bfloat162_rn(o[2], o[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

// Accumulator fragments (g = lane / 4, t = lane % 4): rows g (entries 0, 1)
// and g + 8 (2, 3) of an m-tile of 16 rows, columns 8 j + 2 t + {0, 1} of
// n-tile j.
template <typename T>
__global__ void __launch_bounds__(kF32Threads, 2)
ssd_chunk_kernel_tf32(const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ dt, const float* __restrict__ s,
                      T* __restrict__ y, float* __restrict__ states, F32Dims f, int vec) {
  const Dims& d = f.d;
  const int L = d.L, N = d.N, P = d.P, H = d.H, HS = f.HS;
  const int ldn = round32(N) + 4, ldp = round32(P) + 4;
  extern __shared__ __align__(16) float sm[];
  float* sC = sm;                        // [64][ldn]
  float* sB = sC + kRows * ldn;          // [64][ldn]
  float* sX = sB + kRows * ldn;          // [2][64][ldp]
  float* s_tab = sX + 2 * kRows * ldp;   // [HS][64]
  float* dt_tab = s_tab + HS * kRows;
  float* u_tab = dt_tab + HS * kRows;

  int r = blockIdx.x;   // slice fastest: the blocks of one (batch, chunk, group) run together
  const int slice = r % f.n_slices;
  r /= f.n_slices;
  const int grp = r % d.G;
  r /= d.G;
  const int c = r % d.nc, b = r / d.nc;
  const int h0 = grp * f.R + slice * HS;
  const int tid = threadIdx.x, wg = tid >> 7, wp = (tid >> 5) & 3, g = (tid >> 2) & 7, t = tid & 3;
  const long long t0 = static_cast<long long>(c) * L;

  zero_pad(sC, 2 * kRows, N, ldn - 4, ldn);   // C and B
  zero_pad(sX, 2 * kRows, P, ldp - 4, ldp);   // both stages of x
  const T* xg = x + b * d.xb + t0 * d.xt;
  load_rows(sC, Cm + b * d.cb + t0 * d.ct + grp * d.cg, d.ct, L, N, ldn, vec);
  load_rows(sB, Bm + b * d.bb + t0 * d.bt + grp * d.bg, d.bt, L, N, ldn, vec);
  load_rows(sX, xg + h0 * d.xh, d.xt, L, P, ldp, vec);
  cp_commit();
  // the tables of the block's heads; rows past L are 0
  const long long srow = (static_cast<long long>(b) * d.nc + c) * L;
  const long long trow = static_cast<long long>(b) * d.T + t0;
  for (int e = tid; e < kRows * HS; e += kF32Threads) {
    const int tt = e / HS, hl = e - tt * HS;
    s_tab[hl * kRows + tt] = tt < L ? s[(srow + tt) * H + h0 + hl] : 0.f;
    dt_tab[hl * kRows + tt] = tt < L ? dt[(trow + tt) * H + h0 + hl] : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < kRows * HS; e += kF32Threads) {
    const int tt = e & (kRows - 1);
    u_tab[e] = tt < L ? expf(s_tab[e - tt + L - 1] - s_tab[e]) * dt_tab[e] : 0.f;
  }
  cp_wait<0>();
  __syncthreads();

  const int nkn = (N + 7) / 8;        // k-steps over n
  const int nkl = (L + 7) / 8;        // k-steps over the chunk's rows
  const int np = (P + 7) / 8;         // live n-tiles over p
  const int nmt = (N + 15) / 16;      // m-tiles of the states
  // warpgroup 0: the scores and Y, warp w the rows t = 16 w ..; warpgroup
  // 1: the states, warp w the rows n = 32 w .. (two m-tiles)
  const int r0 = 16 * wp;
  const int ta = r0 + g, tb = ta + 8;
  const int ny = wg == 0 && r0 < L ? min(2 * wp + 2, nkl) : 0;   // column tiles j <= t

  // ---- the scores S = C B^T for rows r0 .., once for the block's heads:
  // the column tiles j <= 16 w + 15 only, N in two halves, each summed from
  // zero on the tensor cores and added in float32 ------------------------
  float sc[8][4];
  zero(sc);
  if (ny > 0) {
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
        load_a(a, sC + r0 * ldn + 8 * k, ldn, g, t);
#pragma unroll
        for (int jg = 0; jg < 8; jg += 4) {
          if (jg < ny) {
            FragB bf[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) load_b_nk(bf[j], sB + 8 * (jg + j) * ldn + 8 * k, ldn, g, t);
            mma3_group(part, jg, a, bf);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] += part[j][e];
    }
  }

  // Each warpgroup walks the heads in a loop of its own, so that each keeps
  // only its own accumulators live; both loops meet the same barriers (one
  // a head, after the next head's x has landed).  Head hl + 1's x loads into
  // the other stage under head hl's products, every thread its share.
  auto heads = [&](auto&& body) {
    for (int hl = 0; hl < HS; ++hl) {
      if (hl + 1 < HS) {
        load_rows(sX + ((hl + 1) & 1) * kRows * ldp, xg + (h0 + hl + 1) * d.xh, d.xt, L, P, ldp,
                  vec);
        cp_commit();
      }
      body(hl, sX + (hl & 1) * kRows * ldp);
      cp_wait<0>();      // the next head's x has landed (this thread's copies)
      __syncthreads();   // everyone's; and every warp is done with this stage
    }
  };
  const int col0 = 4 * (t >> 1);
  if (wg == 0) {
    heads([&](int hl, const float* xs) {
      // ---- Y = W X over the column tiles j <= t: W of columns 8 kj ..,
      // selected (never multiplied) by the causal mask, the A operand ----
      const int h = h0 + hl;
      const float* s_h = s_tab + hl * kRows;
      const float* dt_h = dt_tab + hl * kRows;
      const float s_a = s_h[ta], s_b = s_h[tb];
      float ya[8][4];
      zero(ya);
#pragma unroll
      for (int kj = 0; kj < 8; ++kj) {
        if (kj >= ny) break;
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tr = e < 2 ? ta : tb, j = 8 * kj + 2 * t + (e & 1);
          w[e] = (j <= tr && tr < L) ? sc[kj][e] * expf((e < 2 ? s_a : s_b) - s_h[j]) * dt_h[j]
                                     : 0.f;
        }
        FragA aw;
        acc_to_a(aw, w);
#pragma unroll
        for (int jg = 0; jg < 8; jg += 4) {
          if (jg < np) {
            FragB bx[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              load_b_kn_perm(bx[j], xs + 8 * kj * ldp + 8 * (jg + j), ldp, g, t);
            mma3_group(ya, jg, aw, bx);
          }
        }
      }
      // out: four consecutive columns a lane; rows past L, columns past P
      // are not written
      T* yh = y + (trow * H + h) * P;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        float o[4];
        const int row = pair_rows(ya[jn], t, o) ? tb : ta, col = 8 * jn + col0;
        if (row < L && col < P) store4(yh + static_cast<long long>(row) * H * P + col, o);
      }
    });
  } else {
    heads([&](int hl, const float* xs) {
      // ---- the states (u o B)^T X, two m-tiles of rows n sharing each
      // split fragment of X ----------------------------------------------
      const int h = h0 + hl;
      const float* u_h = u_tab + hl * kRows;
      float sa[2][8][4];
      zero(sa[0]);
      zero(sa[1]);
#pragma unroll 1
      for (int kj = 0; kj < 8; ++kj) {
        if (kj >= nkl) break;
        FragA au[2];
        const float u0 = u_h[8 * kj + 2 * t], u1 = u_h[8 * kj + 2 * t + 1];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          if (2 * wp + mi < nmt)
            load_a_km_perm(au[mi], sB + 8 * kj * ldn + 32 * wp + 16 * mi, ldn, g, t, u0, u1);
#pragma unroll
        for (int jg = 0; jg < 8; jg += 4) {
          if (jg < np) {
            FragB bx[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              load_b_kn_perm(bx[j], xs + 8 * kj * ldp + 8 * (jg + j), ldp, g, t);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              if (2 * wp + mi < nmt) mma3_group(sa[mi], jg, au[mi], bx);
          }
        }
      }
      float* st = states + ((static_cast<long long>(b) * d.nc + c) * H + h) * N * P;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          float o[4];
          const int n = 32 * wp + 16 * mi + g + (pair_rows(sa[mi][jn], t, o) ? 8 : 0);
          const int col = 8 * jn + col0;
          if (n < N && col < P) store4(st + static_cast<long long>(n) * P + col, o);
        }
    });
  }
}

template <typename T>
int run_tf32(const void* x, const void* Bm, const void* Cm, const float* dt, const float* s,
             void* y, float* states, int Ba, const Dims& d, cudaStream_t stream) {
  int sms = 0;
  const int e_sm = sm_count(&sms);
  if (e_sm != 0) return e_sm;
  const Plan pl = plan_for(false, Ba, d.H, d.G, d.nc, sms);
  if (pl.gx > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = f32_smem_floats(d.N, d.P, pl.heads) * sizeof(float);
  if (bytes > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel_tf32<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = std::is_same<T, float>::value && vec_ok(x, d.xb, d.xh, d.xt) &&
                  vec_ok(Bm, d.bb, d.bg, d.bt) && vec_ok(Cm, d.cb, d.cg, d.ct);
  const F32Dims f{d, d.H / d.G, pl.heads, d.H / d.G / pl.heads};
  ssd_chunk_kernel_tf32<T><<<static_cast<unsigned>(pl.gx), pl.threads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(Bm), static_cast<const T*>(Cm), dt, s,
      static_cast<T*>(y), states, f, vec);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// bfloat16: the tensor-core kernel
// ===========================================================================

constexpr int kTcStages = 3;                // stages of the X ring
constexpr uint32_t kTile = 64 * 128;        // 64 rows of 128 bytes, 128-byte swizzled
constexpr uint32_t kKStep = 16 * 128;       // 16 rows of a tile: one k-step of an MN-major operand
constexpr int kTcTiles = 4 + kTcStages + 4;  // C, B, the X ring, the states' staging

struct TcDims {
  int T, H, G, N, P, L, nc, R, HS, n_slices;  // R = H / G heads per group
};

// dynamic shared memory: C and B (two tiles each, columns 0-63 and
// 64-127), the X ring, the states' staging tiles (four of 64 rows by 32
// float32 columns), then the float32 tables s, dt and u of the block's
// heads ([HS][64] each)
__host__ __device__ inline size_t tc_smem_bytes(int HS) {
  return 1024 + static_cast<size_t>(kTcTiles) * kTile +
         3 * static_cast<size_t>(HS) * 64 * sizeof(float);
}

// TMA: the box at (c0, c1, c2, c3, c4) of a 5-D tensor map into shared
// address dst (zero-filled past the tensor's edges), completing on mbarrier
// bar; and the box at shared address src out to (c0, ...) (clipped at the
// tensor's edges) in the thread's bulk group
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// the bulk group's commit, and a wait until every committed group has read
// its shared memory
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// four 8 x 8 bf16 matrices out of shared memory, transposed: lane l gives
// the address of row l % 8 of matrix l / 8, and receives, of matrix i, the
// elements (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4) in r[i]
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Fragments of a wgmma m64nN, thread (warp wp, lane ln) of the warpgroup:
// the accumulator's entries 4 jb, 4 jb + 1 are row 16 wp + ln / 4, columns
// 8 jb + 2 (ln % 4) + {0, 1}; entries 4 jb + 2, 4 jb + 3 the row 8 below.
// A register operand of k-step kk: a[0] row 16 wp + ln / 4, columns
// 16 kk + 2 (ln % 4) + {0, 1}; a[1] the row 8 below; a[2], a[3] the same 8
// columns to the right.
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel_tc(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap bmap,
                    const __grid_constant__ CUtensorMap cmap,
                    const __grid_constant__ CUtensorMap ymap,
                    const __grid_constant__ CUtensorMap smap, const float* __restrict__ dt,
                    const float* __restrict__ s, TcDims d) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kTcStages];  // C and B; the X ring
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sC = base, sB = base + 2 * kTile, sX = base + 4 * kTile,
                 sS = sX + kTcStages * kTile;
  float* s_tab = reinterpret_cast<float*>(gbase + kTcTiles * kTile);
  float* dt_tab = s_tab + d.HS * 64;
  float* u_tab = dt_tab + d.HS * 64;
  const uint32_t bar_bc = smem_u32(&bars[0]), bar_x = bar_bc + 8;

  int r = blockIdx.x;  // slice fastest: the blocks of one (batch, chunk, group) run together
  const int slice = r % d.n_slices;
  r /= d.n_slices;
  const int g = r % d.G;
  r /= d.G;
  const int c = r % d.nc, b = r / d.nc;
  const int L = d.L, H = d.H, HS = d.HS, h0 = g * d.R + slice * HS;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar_bc, 1);
    for (int i = 0; i < kTcStages; ++i) mbar_init(bar_x + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bar_bc, 4 * kTile);
    for (int sl = 0; sl < 2; ++sl) {
      tma_load_5d(sC + sl * kTile, &cmap, bar_bc, 64 * sl, g, 0, c, b);
      tma_load_5d(sB + sl * kTile, &bmap, bar_bc, 64 * sl, g, 0, c, b);
    }
    for (int i = 0; i < kTcStages && i < HS; ++i) {
      mbar_expect(bar_x + 8 * i, kTile);
      tma_load_5d(sX + i * kTile, &xmap, bar_x + 8 * i, 0, h0 + i, 0, c, b);
    }
  }
  // the tables of the block's heads; rows past L are 0
  const long long srow = (static_cast<long long>(b) * d.nc + c) * L;
  const long long trow = static_cast<long long>(b) * d.T + static_cast<long long>(c) * L;
  for (int e = tid; e < 64 * HS; e += kThreads) {
    const int t = e / HS, hl = e - t * HS;
    s_tab[hl * 64 + t] = t < L ? s[(srow + t) * H + h0 + hl] : 0.f;
    dt_tab[hl * 64 + t] = t < L ? dt[(trow + t) * H + h0 + hl] : 0.f;
  }
  __syncthreads();  // also publishes the mbarriers' init
  for (int e = tid; e < 64 * HS; e += kThreads) {
    const int t = e & 63;
    u_tab[e] = t < L ? expf(s_tab[e - t + L - 1] - s_tab[e]) * dt_tab[e] : 0.f;
  }
  __syncthreads();

  const int wp = tid >> 5, ln = tid & 31, q = ln & 3;
  const int ta = 16 * wp + (ln >> 2), tb = ta + 8;  // this thread's rows of a fragment
  const bool in_a = ta < L, in_b = tb < L;
  // this lane's row address of ldmatrix: row j0 + (ln & 7) of the X tile,
  // the 16-byte chunk of columns p0 .. p0 + 7 (matrix ln / 8: p0 = 16 wp +
  // 8 (ln / 8 % 2), j0 = 16 kk + 8 (ln / 16)); swizzled
  const int lj = (ln & 7) + 8 * (ln >> 4), lchunk = 2 * wp + ((ln >> 3) & 1);
  const uint32_t ld_off = lj * 128 + ((lchunk ^ (lj & 7)) << 4);

  // ---- the scores C B^T, once for every head of the block ------------------
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  mbar_wait(bar_bc, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t off = (kk >> 2) * kTile + (kk & 3) * 32;
    wgmma_ss_n64(sc, sw128_desc(sC + off, 16, 1024), sw128_desc(sB + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);

  for (int hl = 0; hl < HS; ++hl) {
    const int st = hl % kTcStages, h = h0 + hl;
    const uint32_t xs = sX + st * kTile;
    const float* s_h = s_tab + hl * 64;
    const float* dt_h = dt_tab + hl * 64;
    const float* u_h = u_tab + hl * 64;
    mbar_wait(bar_x + 8 * st, (hl / kTcStages) & 1);

    // ---- S_c^T = (u X)^T B: A = (u X)^T in registers, three bf16 terms ------
    // (X^T out of the MN-major X tile by ldmatrix.trans; column j scaled by
    // u_j), B the B tile (MN-major, N = 128 over its two 64-column tiles)
    uint32_t ux[3][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t xv[4];
      ldmatrix_x4_trans(xv, xs + kk * kKStep + ld_off);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 u = *reinterpret_cast<const float2*>(u_h + 16 * kk + 8 * (i >> 1) + 2 * q);
        const float2 x = unpack_bf16(xv[i]);
        const float v0 = u.x * x.x, v1 = u.y * x.y;
        ux[0][kk][i] = pack_bf16(v0, v1);
        const float2 f0 = unpack_bf16(ux[0][kk][i]);
        const float r0 = v0 - f0.x, r1 = v1 - f0.y;
        ux[1][kk][i] = pack_bf16(r0, r1);
        const float2 f1 = unpack_bf16(ux[1][kk][i]);
        ux[2][kk][i] = pack_bf16(r0 - f1.x, r1 - f1.y);
      }
    }
    float sa[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sa[i] = 0.f;
    fence_regs(sa);
#pragma unroll
    for (int t3 = 0; t3 < 3; ++t3)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(ux[t3][kk]);
    wgmma_fence();
#pragma unroll
    for (int t3 = 0; t3 < 3; ++t3)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n128(sa, ux[t3][kk], sw128_desc(sB + kk * kKStep, kTile, 1024));
    wgmma_commit();

    // ---- W in registers while those run: two bf16 terms; the S fragment of
    // columns 16 kk .. 16 kk + 15 is the A fragment of k-step kk
    uint32_t whi[4][4], wlo[4][4];
    const float s_a = s_h[ta], s_b = s_h[tb];
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      const int j = 8 * jb + 2 * q;
      const float2 sj = *reinterpret_cast<const float2*>(s_h + j);
      const float2 dj = *reinterpret_cast<const float2*>(dt_h + j);
      float w[4];
      w[0] = (in_a && j <= ta) ? sc[4 * jb] * exp2f((s_a - sj.x) * kLog2e) * dj.x : 0.f;
      w[1] = (in_a && j + 1 <= ta) ? sc[4 * jb + 1] * exp2f((s_a - sj.y) * kLog2e) * dj.y : 0.f;
      w[2] = (in_b && j <= tb) ? sc[4 * jb + 2] * exp2f((s_b - sj.x) * kLog2e) * dj.x : 0.f;
      w[3] = (in_b && j + 1 <= tb) ? sc[4 * jb + 3] * exp2f((s_b - sj.y) * kLog2e) * dj.y : 0.f;
      const int kk = jb >> 1, ca = 2 * (jb & 1);
      whi[kk][ca] = pack_bf16(w[0], w[1]);
      whi[kk][ca + 1] = pack_bf16(w[2], w[3]);
      const float2 ha = unpack_bf16(whi[kk][ca]), hb = unpack_bf16(whi[kk][ca + 1]);
      wlo[kk][ca] = pack_bf16(w[0] - ha.x, w[1] - ha.y);
      wlo[kk][ca + 1] = pack_bf16(w[2] - hb.x, w[3] - hb.y);
    }

    wgmma_wait<0>();
    fence_regs(sa);
#pragma unroll
    for (int t3 = 0; t3 < 3; ++t3)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(ux[t3][kk]);

    // ---- Y = W_hi X + W_lo X (X the MN-major B operand) ------------------------
    float ya[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) ya[i] = 0.f;
    fence_regs(ya);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(whi[kk]);
      fence_regs(wlo[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dx = sw128_desc(xs + kk * kKStep, kTile, 1024);
      wgmma_rs_n64(ya, whi[kk], dx);
      wgmma_rs_n64(ya, wlo[kk], dx);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(ya);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(whi[kk]);
      fence_regs(wlo[kk]);
    }

    // The last head's stores have read the staging tiles and its X stage,
    // which is then reloaded; every warp's products have read this X stage,
    // which now stages y.
    if (tid == 0) {
      bulk_wait_read();
      const int hn = hl - 1 + kTcStages;
      if (hl > 0 && hn < HS) {
        const int sp = (hl - 1) % kTcStages;
        mbar_expect(bar_x + 8 * sp, kTile);
        tma_load_5d(sX + sp * kTile, &xmap, bar_x + 8 * sp, 0, h0 + hn, 0, c, b);
      }
    }
    __syncthreads();

    // ---- staging: y (bf16) into this X stage, as the X tile was laid out;
    // the states into tile 2 (n / 64) + p / 32 at row n % 64, column p % 32
    unsigned char* ys = gbase + (xs - base);
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      *reinterpret_cast<uint32_t*>(ys + ta * 128 + ((jb ^ (ta & 7)) << 4) + 4 * q) =
          pack_bf16(ya[4 * jb], ya[4 * jb + 1]);
      *reinterpret_cast<uint32_t*>(ys + tb * 128 + ((jb ^ (tb & 7)) << 4) + 4 * q) =
          pack_bf16(ya[4 * jb + 2], ya[4 * jb + 3]);
    }
    unsigned char* ss = gbase + (sS - base);
#pragma unroll
    for (int jb = 0; jb < 16; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = ta + 8 * (e >> 1), n = 8 * jb + 2 * q + (e & 1);
        const int row = n & 63, chunk = (p & 31) >> 2;
        *reinterpret_cast<float*>(ss + (2 * (n >> 6) + (p >> 5)) * kTile + row * 128 +
                                  ((chunk ^ (row & 7)) << 4) + 4 * (p & 3)) = sa[4 * jb + e];
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the staging, for TMA
    __syncthreads();
    if (tid == 0) {
      tma_store_5d(&ymap, xs, 0, h, 0, c, b);
      const int row = (b * d.nc + c) * H + h;
      for (int t4 = 0; t4 < 4; ++t4)  // a tile wholly past P or N is not stored
        if (32 * (t4 & 1) < d.P && 64 * (t4 >> 1) < d.N)
          tma_store_3d(&smap, sS + t4 * kTile, 32 * (t4 & 1), 64 * (t4 >> 1), row);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_read();  // shared memory outlives the last stores' reads
}

// The tensor map of a bf16 (batch, time, heads, cols) view whose time axis
// is cut into (chunk, row in chunk): 5-D (cols, heads, row, chunk, batch)
// with element strides (1, sh, st, L st, sb), boxes of 64 columns by 64 rows,
// 128-byte swizzle: a load is zero-filled, a store clipped, past the edges.
// 0, or a CUDA error code.
int make_map(CUtensorMap* map, const void* ptr, int cols, int heads, int L, int nc, int batch,
             long long sh, long long st, long long sb) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t gdim[5] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(nc),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t gstride[4] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(st) * L * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  for (int i = 0; i < 4; ++i)
    if (gstride[i] % 16 != 0 || gstride[i] == 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cuuint32_t box[5] = {64, 1, 64, 1, 1}, estride[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr),
                              gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The tensor map of the float32 states (rows, N, P) (contiguous; rows =
// batch x chunk x head): boxes of 32 columns by 64 rows of one head,
// 128-byte swizzle; a store is clipped at N and P.  0, or a CUDA error code.
int make_states_map(CUtensorMap* map, void* ptr, int P, int N, long long rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t gdim[3] = {static_cast<cuuint64_t>(P), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t gstride[2] = {static_cast<cuuint64_t>(P) * 4,
                                 static_cast<cuuint64_t>(N) * P * 4};
  if (gstride[0] % 16 != 0 || reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cuuint32_t box[3] = {32, 64, 1}, estride[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ptr, gdim, gstride, box,
                              estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int run_tc(const void* x, const void* Bm, const void* Cm, const float* dt, const float* s,
           void* y, float* states, int Ba, const Dims& d, cudaStream_t stream) {
  int sms = 0;
  const int e_sm = sm_count(&sms);
  if (e_sm != 0) return e_sm;
  const int R = d.H / d.G;
  const Plan pl = plan_for(true, Ba, d.H, d.G, d.nc, sms);
  const int HS = pl.heads;
  const long long blocks = pl.gx;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  alignas(64) CUtensorMap xmap, bmap, cmap, ymap, smap;
  int e = make_map(&xmap, x, d.P, d.H, d.L, d.nc, Ba, d.xh, d.xt, d.xb);
  if (e == 0) e = make_map(&bmap, Bm, d.N, d.G, d.L, d.nc, Ba, d.bg, d.bt, d.bb);
  if (e == 0) e = make_map(&cmap, Cm, d.N, d.G, d.L, d.nc, Ba, d.cg, d.ct, d.cb);
  if (e == 0) e = make_map(&ymap, y, d.P, d.H, d.L, d.nc, Ba, d.P, static_cast<long long>(d.H) * d.P,
                           static_cast<long long>(d.T) * d.H * d.P);
  if (e == 0) e = make_states_map(&smap, states, d.P, d.N, static_cast<long long>(Ba) * d.nc * d.H);
  if (e != 0) return e;
  const size_t bytes = tc_smem_bytes(HS);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const TcDims t{d.T, d.H, d.G, d.N, d.P, d.L, d.nc, R, HS, R / HS};
  ssd_chunk_kernel_tc<<<static_cast<unsigned>(blocks), pl.threads, bytes, stream>>>(
      xmap, bmap, cmap, ymap, smap, dt, s, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (x, B, C and y_diag).  strides: x's batch,
// time and head strides, then B's and C's batch, time and group strides
// (bfloat16 with N and P multiples of 8, the wgmma kernel: x, B and C
// 16-byte aligned, their strides positive multiples of 8 elements, for the
// TMA tensor maps).  *kernel is set to the kernel launched (0 the 3xTF32
// kernel, 1 the wgmma kernel; both on the tensor cores).  Returns the CUDA
// error code of the launch (0: launched).
extern "C" int repro_ssd_intra_chunk(int dtype, const void* x, const void* Bm, const void* Cm,
                                     const void* dt, const void* s, void* y, void* states,
                                     int Ba, int T, int H, int G, int N, int P, int L,
                                     const long long* strides, void* stream, int* kernel) {
  if (L < 1 || L > 64 || T % L != 0 || N < 4 || N > 128 || N % 4 != 0 || P < 4 || P > 64 ||
      P % 4 != 0 || G < 1 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Dims d{T, H, G, N, P, L, T / L,
         strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* sf = static_cast<const float*>(s);
  float* sto = static_cast<float*>(states);
  switch (dtype) {
    case 0:
      *kernel = 0;
      return run_tf32<float>(x, Bm, Cm, dtf, sf, y, sto, Ba, d, st);
    case 1:
      if (N % 8 == 0 && P % 8 == 0) {
        *kernel = 1;
        return run_tc(x, Bm, Cm, dtf, sf, y, sto, Ba, d, st);
      }
      *kernel = 0;
      return run_tf32<__nv_bfloat16>(x, Bm, Cm, dtf, sf, y, sto, Ba, d, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch plan repro_ssd_intra_chunk uses for these sizes (both kernels
// share it; dtype and the widths N, P pick the kernel as there): out[0..4] =
// blocks along x, y and z, threads per block, heads per block.  Returns a
// CUDA error code.
extern "C" int repro_ssd_plan(int dtype, int Ba, int T, int H, int G, int N, int P, int L,
                              long long* out) {
  if (L < 1 || T % L != 0 || G < 1 || H % G != 0 || dtype < 0 || dtype > 1 || N < 1 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int e = sm_count(&sms);
  if (e != 0) return e;
  const Plan p = plan_for(dtype == 1 && N % 8 == 0 && P % 8 == 0, Ba, H, G, T / L, sms);
  out[0] = p.gx;
  out[1] = p.gy;
  out[2] = p.gz;
  out[3] = p.threads;
  out[4] = p.heads;
  return 0;
}
