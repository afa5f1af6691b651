// Kernel K6 of the port: causal sliding-window GQA flash attention.
//
// Replaces the TPU kernel src/repro/kernels/swa/kernel.py:37,90,129
// (_swa_kernel / swa_pallas) and computes the function of its plain
// version (kernels/swa/ref.py::swa_ref): query i (absolute position
// i + S - T, the queries being the last T of the S keys) attends to the
// keys j with  qpos - w < j <= qpos,  w = min(window, S), so w = S is
// plain causal attention.  q head h reads kv head h / (H / Hkv): grouped
// k/v are read as they are, never repeated per head.  q (B, H, T, D), k and
// v (B, Hkv, S, D) come with their batch, head and time strides (D
// contiguous): the model passes transposed views of its (B, T, H, D)
// projections without a copy.  The output is written with the strides the
// launcher gives (it allocates (B, T, H, D)).
//
// The dtype alone picks the kernel, here in the C entry point; both run on
// the tensor cores: bfloat16 on wgmma (swa_kernel_tc), float32 in 3xTF32 on
// mma.sync (swa_kernel_tf32, float32's accuracy from three TF32 products).
// Both keep one rule for the mask: a select, never a product.  A masked
// logit becomes NEG_INF = -1e30 before the row maximum and weighs 0 after it
// (a kv tile masked for a whole row adds nothing), and a row whose l stayed
// 0 divides by 1.  Ragged T and S are masked; rows past T are never
// written.
//
// Bound.  At gemma3-4b's prefill (B 4, H 8, Hkv 4, T = S = 2048, D 256,
// bf16) the bytes (q and o 33.5 MB, k and v 33.5 MB) take 0.020 ms at
// 3.35 TB/s; the unmasked pairs (1.57 M per head at window 1024, 2.10 M
// global) need 4 D FLOP each: 51.6 / 68.7 GFLOP, 0.052 / 0.069 ms on the
// bf16 tensor cores, 0.31 / 0.42 ms in float32 as three TF32 products
// (0.77 / 1.03 ms on the float32 CUDA cores).  So operations bound both
// dtypes, and both belong on the tensor cores.
//
// bfloat16: swa_kernel_tc<DP>, FlashAttention-3's shape on wgmma and TMA.
//  * Tiles and order.  One block per (q tile of BM = 64 nwg rows, batch x
//    head): nwg consumer warpgroups of 128 threads, one per 64 rows, and one
//    producer warpgroup.  The launcher takes nwg = 2 (BM 128, 384 threads;
//    both consumers share each K/V tile) unless that grid has fewer blocks
//    than the card has SMs, then nwg = 1 (BM 64, 256 threads): 4 x 2048 at 8
//    heads gives 512 blocks of 128 rows, 1 x 1000 gives 128 blocks of 64 rows
//    instead of 64 of 128.  The grid is one-dimensional, q tile major, the
//    last q tiles first: those are the longest of a global layer, so the
//    short ones fill the last wave.
//  * Loads.  One thread of the producer issues every load as TMA
//    (cp.async.bulk.tensor) from 4-D tensor maps of the strided q, k and v
//    views (D, then row, head and batch in the order of their strides; the
//    model's time stride is H D 2 bytes), in boxes of 64 columns, 128-byte
//    swizzled: the layout wgmma's descriptors read (64-column slabs, 8-row
//    atoms on 1024-byte boundaries).  TMA zero-fills past T, S and D.  Q
//    arrives once; K and V go through rings of two stages each, with "full"
//    mbarriers (the TMA bytes) and "empty" ones (every consumer thread, once
//    its products have read the stage), so the loads of K_{n+1} and V_n run
//    under the products of step n.  The producer gives its registers up
//    (setmaxnreg 24), the consumers take them (240); the two roles split once
//    and never meet again.  No consumer spends an instruction on a load, and
//    no barrier ties the two consumer warpgroups together.
//  * Head width.  The kernel is templated on the padded width DP = 64, 128
//    or 256 (D <= DP); the pad columns of Q, K and V are zero in shared
//    memory (they add exact zeros to Q K^T and to the unused output columns)
//    and the output's pad columns are never written.
//  * Products.  S = Q K^T is wgmma m64n64k16 with Q and K from shared
//    memory, both K-major (K stored [key][d] is the K-major B operand).  P
//    is rounded to bf16 in registers, where the plain version rounds it,
//    and its S fragment is the A fragment of O += P V (wgmma m64nDPk16, A
//    from registers); V stored [key][d] is the MN-major B operand, read
//    with wgmma's transpose flag, not copied.  Accumulators are float32.
//    Step n issues S_n and P_{n-1} V_{n-1} together and runs the softmax of
//    S_n while P_{n-1} V_{n-1} is in flight.  Every product runs on every
//    step of the block, so no wgmma or wait sits on a branch the compiler
//    cannot prove uniform (ptxas would serialise them).
//  * Softmax.  Logits are scaled into log2 units in float32 (scale log2 e),
//    m, l and the rescaling of O are float32 (exp2); l is kept per thread
//    over its columns and reduced over the four lanes of a row once, at the
//    end; the output is rounded once.
//  * Masks only where needed.  A kv tile inside every row's window of a
//    warpgroup (keys at most its first row's position and above its last
//    row's position minus w) takes no select; only the diagonal tiles and
//    those on the window's lower edge pay for it.  A tile that meets none of
//    a warpgroup's rows comes out fully masked.
//  * Resources at DP 256: O takes 128 float32 registers a thread, S 32,
//    P 16.  ptxas (-Xptxas -v, sm_90a, nvcc 12.9) gives every instantiation
//    168 registers at entry, the most 384 threads may start with; the
//    consumers then run on 240.  DP 256 keeps an 8-byte stack frame with 4
//    bytes of spill stores and loads, DP 128 and 64 none.  Shared memory:
//    Q 64 KB (BM 128) + 2 x (32 + 32) KB of K and V = 192 KB, one block per
//    SM.
//
// float32: swa_kernel_tf32<DP, BN, MT>, 3xTF32 on the tensor cores
// (tf32.cuh: mma.sync m16n8k8, each operand split into two TF32 parts,
// three products summed in float32, about 2^-21 of each product left out).
//  * Bound.  At llama3.2-1b's training shape (B 4, H 32, Hkv 8, T = S =
//    2048, D 64, global) the 268.6 M unmasked pairs need 4 D FLOP each:
//    68.75 GFLOP, 0.139 ms at TF32's 495 TFLOP/s and so 0.417 ms in three
//    products (1.03 ms on the float32 CUDA cores); the bytes (q, k, v and
//    o) take 0.04 ms.  So operations bound it, and the design spends its
//    instructions on keeping the tensor cores fed.
//  * Tiles and order.  One block of four warps per (batch x head, q tile of
//    64 MT rows), the last q tiles of every head (the longest of a causal
//    layer) first, so that short blocks fill the last wave; warp w owns the
//    tile's rows 16 MT w .. 16 MT (w + 1) - 1 as MT m-tiles of 16 (MT 2 at
//    DP 64, else 1), which share every K and V fragment it loads and
//    splits.  The block walks only the kv tiles of BN keys (32 at DP 64 and
//    256, 64 at DP 128) that meet [q_lo - w + 1, q_hi]; a warp skips a tile
//    that none of its rows sees.
//  * Loads.  Q once, K and V through a ring of two stages, all by cp.async
//    (16-byte pieces where the views allow it, else 4-byte ones; rows past T
//    and S zero-filled), so that tile n + 1 loads under the products of tile
//    n.  Shared rows are DP + 4 floats, so no fragment load meets a bank
//    conflict; the pad columns D .. DP are zero (they add exact zeros) and
//    the products run over D rounded up to 8 only.
//  * Products.  S = Q K^T and O += P V, each 3xTF32; every operand is split
//    in registers right after its load (Q's fragment once per k-step for all
//    BN keys), and the products go out term by term over groups of four
//    n-tiles (tf32.cuh, mma3_group), so that no MMA waits on the one before.
//    S is formed as swa_bwd_dq forms it, fragment for fragment, so that the
//    backward's P = exp(S - LSE) meets this LSE bit for bit.  P never leaves
//    the registers: the accumulator of S over 8 keys is the A operand of
//    P V over those keys under a permuted key order (tf32.cuh, acc_to_a and
//    load_b_kn_perm), so no shuffle and no shared memory carries it.  A
//    tensor-core accumulator cuts each sum toward zero, so it holds one
//    tile's P V only (from zero, in chunks of 64 columns, 32 when MT is 2 or
//    DP 256): O = O alpha + P V is an fmaf on the CUDA cores, rounded to
//    nearest.
//  * Softmax.  Logits scaled into log2 units in float32; a masked one
//    becomes NEG_INF by a select before the row maximum; m and l per row
//    (l summed per thread, over the four lanes of a row at the end);
//    O / l by a float32 division; the LSE, in natural units, is
//    m ln 2 + log l.  A kv tile inside every row's window of a warp takes
//    no select.
//  * Resources.  Shared memory (64 MT + 4 BN)(DP + 4) floats: 70 KB at DP
//    64 (two blocks per SM), 169 KB at DP 128, 200 KB at DP 256.  ptxas
//    (-Xptxas -v, sm_90a, nvcc 12.9): 212 / 208 / 225 registers at DP 64 /
//    128 / 256, no spills.
#include "../../csrc/tf32.cuh"

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kF32Rows = 64;      // q rows per m-tile of all four warps of a float32 block
constexpr int kF32Threads = 128;
constexpr int kMaxD = 256;

// The launch plan of either kernel (kernels/plans.py::swa_plan mirrors it):
// blocks along x and y, threads per block and q rows per block.  The
// float32 kernel takes 64 rows of one (batch, head) per block, x over
// (batch, head) and y over q tiles, the last first; the bfloat16
// kernel 64 rows per consumer warpgroup, two warpgroups when the grid fills
// the SMs.
struct Plan {
  long long gx, gy;
  int threads, rows;
};

// m-tiles of 16 rows a warp of the float32 kernel holds at padded width DP
// (its registers allow two at DP 64), and so its q rows per block
constexpr int f32_mt(int DP) { return DP <= 64 ? 2 : 1; }
inline int f32_rows(int D) { return kF32Rows * f32_mt(D <= 64 ? 64 : D <= 128 ? 128 : 256); }

Plan plan_for(bool bf16, int B, int H, int T, int D, int sms) {
  const long long n_bh = static_cast<long long>(B) * H;
  if (!bf16) {
    const int bm = f32_rows(D);
    return Plan{n_bh, (T + bm - 1) / bm, kF32Threads, bm};
  }
  const int nwg = n_bh * ((T + 127) / 128) >= sms ? 2 : 1;
  return Plan{n_bh * ((T + 64 * nwg - 1) / (64 * nwg)), 1, 128 * nwg + 128, 64 * nwg};
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
}

// ===========================================================================
// float32: 3xTF32 on the tensor cores
// ===========================================================================

struct Dims {
  int H, Hkv, T, S, D, w;
  float scale;
  long long qb, qh, qt;  // q strides (elements): batch, head, time
  long long kb, kh, ks;  // k
  long long vb, vh, vs;  // v
  long long ob, oh, ot;  // output
};

// keys per kv tile: 32 at DP 64 and 256, 64 at DP 128
constexpr int f32_bn(int DP) { return DP == 128 ? 64 : 32; }

// bytes of dynamic shared memory: Q (64 MT rows), K and V (two stages of BN
// rows each), rows of DP + 4 floats
inline size_t f32_smem_bytes(int DP) {
  return static_cast<size_t>(kF32Rows * f32_mt(DP) + 4 * f32_bn(DP)) * (DP + 4) * sizeof(float);
}

// Accumulator fragments (g = lane / 4, t = lane % 4): rows g (entries 0, 1)
// and g + 8 (2, 3) of each of the warp's MT m-tiles of 16 rows, columns
// 8 j + 2 t + {0, 1} of n-tile j.  Row statistics are [m][half], half 0 for
// row g and 1 for row g + 8.
template <int DP, int BN, int MT>
__global__ void __launch_bounds__(kF32Threads, DP <= 64 ? 2 : 1)
swa_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                Dims d, int vec) {
  constexpr int LD = DP + 4, NT = BN / 8, NO = DP / 8, BM = kF32Rows * MT;
  constexpr int CH = MT == 1 && DP <= 128 ? 8 : 4;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                   // [BM][LD]
  float* ks = qs + BM * LD;         // [2][BN][LD]
  float* vs = ks + 2 * BN * LD;     // [2][BN][LD]
  const int nq = (d.T + BM - 1) / BM;
  const int bh = blockIdx.x, b = bh / d.H, h = bh - b * d.H, hk = h / (d.H / d.Hkv);
  const int i0 = (nq - 1 - static_cast<int>(blockIdx.y)) * BM, s_off = d.S - d.T;
  const int wp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
  const int nk = (d.D + 7) / 8;   // k-steps of S, live n-tiles of O
  const float* kg = k + b * d.kb + hk * d.kh;
  const float* vg = v + b * d.vb + hk * d.vh;

  // the kv tiles that meet the window of some row of this block
  const int q_lo = i0 + s_off, q_hi = min(i0 + BM, d.T) - 1 + s_off;
  const int j_first = (max(0, q_lo - d.w + 1) / BN) * BN;
  const int ntiles = (q_hi - j_first) / BN + 1;

  zero_pad(sm, BM + 4 * BN, d.D, DP, LD);
  load_rows_async(qs, q + b * d.qb + h * d.qh, d.qt, i0, BM, d.T, d.D, LD, vec);
  load_rows_async(ks, kg, d.ks, j_first, BN, d.S, d.D, LD, vec);
  load_rows_async(vs, vg, d.vs, j_first, BN, d.S, d.D, LD, vec);
  cp_commit();

  // this warp's rows r0 .. r0 + 16 MT - 1; row g (+ 8) of m-tile m is
  // r0 + 16 m + g (+ 8)
  const int r0 = i0 + 16 * MT * wp;
  const int p_lo = r0 + s_off, p_hi = min(r0 + 16 * MT - 1, d.T - 1) + s_off;
  const float c = d.scale * kLog2e;
  const float* qw = qs + 16 * MT * wp * LD;

  float acc[MT][NO][4], m_run[MT][2], l_run[MT][2];   // l: this thread's columns
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    zero(acc[m]);
    m_run[m][0] = m_run[m][1] = kNegInf;
    l_run[m][0] = l_run[m][1] = 0.f;
  }

  for (int n = 0; n < ntiles; ++n) {
    const int j0 = j_first + n * BN;
    if (n + 1 < ntiles) {   // tile n + 1 into the other stage, under this tile's products
      const int st = (n + 1) & 1;
      load_rows_async(ks + st * BN * LD, kg, d.ks, j0 + BN, BN, d.S, d.D, LD, vec);
      load_rows_async(vs + st * BN * LD, vg, d.vs, j0 + BN, BN, d.S, d.D, LD, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + (n & 1) * BN * LD;
    const float* vt = vs + (n & 1) * BN * LD;
    if (r0 < d.T && j0 <= p_hi && j0 + BN - 1 > p_lo - d.w) {
      // S = Q K^T, each K fragment loaded and split once for the MT m-tiles
      float s[MT][NT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) zero(s[m]);
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        if (kk >= nk) break;
        FragA a[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) load_a(a[m], qw + 16 * m * LD + 8 * kk, LD, g, t);
#pragma unroll
        for (int jg = 0; jg < NT; jg += 4) {
          FragB bf[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) load_b_nk(bf[j], kt + 8 * (jg + j) * LD + 8 * kk, LD, g, t);
#pragma unroll
          for (int m = 0; m < MT; ++m) mma3_group(s[m], jg, a[m], bf);
        }
      }
      // the online softmax in log2 units; the mask selects
      const bool inside = j0 + BN - 1 <= p_lo && j0 > p_hi - d.w;
      float alpha[MT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float mx[2] = {m_run[m][0], m_run[m][1]};
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[m][j][e] * c;
            if (!inside) {
              const int kpos = j0 + 8 * j + 2 * t + (e & 1);
              const int qp = r0 + 16 * m + g + ((e & 2) ? 8 : 0) + s_off;
              x = (kpos <= qp && kpos > qp - d.w) ? x : kNegInf;
            }
            s[m][j][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1)
            mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], off));
          alpha[m][half] = exp2f(m_run[m][half] - mx[half]);
          m_run[m][half] = mx[half];
        }
        // a row with no key yet subtracts 0, so its masked logits give exp2(-1e30) = 0
        const float sub[2] = {mx[0] == kNegInf ? 0.f : mx[0], mx[1] == kNegInf ? 0.f : mx[1]};
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(s[m][j][e] - sub[e >> 1]);
            s[m][j][e] = p;
            rs[e >> 1] += p;
          }
        l_run[m][0] = alpha[m][0] * l_run[m][0] + rs[0];
        l_run[m][1] = alpha[m][1] * l_run[m][1] + rs[1];
      }
      // O = O alpha + P V, P from the registers that held S; P V of this tile
      // on the tensor cores from zero, in chunks of CH n-tiles, each V
      // fragment split once for the MT m-tiles, added by fmaf
#pragma unroll
      for (int jc = 0; jc < NO; jc += CH) {
        if (jc < nk) {
          float pv[MT][CH][4];
          tile_product<MT, NT, CH>(pv, s, vt, LD, jc, nk, g, t);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int j = 0; j < CH; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[m][jc + j][e] = fmaf(acc[m][jc + j][e], alpha[m][e >> 1], pv[m][j][e]);
        }
      }
    }
    __syncthreads();   // every warp has read this stage before tile n + 2 refills it
  }

  // ---- out = acc / l (l == 0 divides by 1); rows past T are not written --
  // lse (when given, for the backward swa_bwd.cu): (B, H, T), natural units
  if (r0 >= d.T) return;
  float* og = o + b * d.ob + h * d.oh;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float l = l_run[m][half];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
      const int i = r0 + 16 * m + g + 8 * half;
      if (i >= d.T) continue;
      if (lse != nullptr && t == 0)
        lse[static_cast<long long>(bh) * d.T + i] = m_run[m][half] * kLn2 + logf(l);
      const float den = l == 0.f ? 1.f : l;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < d.D) {
          og[i * d.ot + col] = acc[m][j][2 * half] / den;
          og[i * d.ot + col + 1] = acc[m][j][2 * half + 1] / den;
        }
      }
    }
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
               const Dims& d, cudaStream_t stream) {
  constexpr int BN = f32_bn(DP), MT = f32_mt(DP);
  const size_t bytes = f32_smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(swa_kernel_tf32<DP, BN, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan pl = plan_for(false, B, d.H, d.T, d.D, 0);
  const int vec = vec_ok(q, d.qb, d.qh, d.qt) && vec_ok(k, d.kb, d.kh, d.ks) &&
                  vec_ok(v, d.vb, d.vh, d.vs);
  const dim3 grid(static_cast<unsigned>(pl.gx), static_cast<unsigned>(pl.gy));
  swa_kernel_tf32<DP, BN, MT><<<grid, pl.threads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, d, vec);
  return static_cast<int>(cudaGetLastError());
}

int run_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
            const Dims& d, cudaStream_t stream) {
  if (d.D <= 64) return launch_f32<64>(q, k, v, o, lse, B, d, stream);
  if (d.D <= 128) return launch_f32<128>(q, k, v, o, lse, B, d, stream);
  return launch_f32<256>(q, k, v, o, lse, B, d, stream);
}

// ===========================================================================
// bfloat16: the tensor-core kernel
// ===========================================================================

constexpr int kTcBN = 64;          // keys per kv tile
constexpr int kTcStages = 2;       // stages of the K ring and of the V ring
constexpr int kTcThreads = 384;    // two consumer warpgroups and the producer

struct TcDims {
  int H, Hkv, T, S, D, w, nwg, n_bh;
  float scale_log2;  // softmax scale times log2(e)
  // the coordinate slots (1-3) of row, head and batch in the tensor maps of
  // q, k and v (their dimensions are ordered by stride)
  int qr, qh, qb, kr, kh, kb, vr, vh, vb;
  long long ob, oh, ot;  // output strides
};

// TMA: the box of 64 columns from column c0 of (row, head, batch) of a
// tensor map, into shared address dst (128-byte swizzled, zero-filled past
// the tensor's edges), completing on mbarrier bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int row, int head, int batch, int pr, int ph) {
  const int c1 = pr == 1 ? row : ph == 1 ? head : batch;
  const int c2 = pr == 2 ? row : ph == 2 ? head : batch;
  const int c3 = pr == 3 ? row : ph == 3 ? head : batch;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// d (64 x 256, float32) += A (64 x 16, bf16 in registers) B (16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n128(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&o)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n256(o, a, db);
}

__host__ __device__ inline size_t tc_smem_bytes(int DP, int nwg) {
  return 1024 + static_cast<size_t>(64 * nwg + 2 * kTcStages * kTcBN) * DP * 2;
}

// One block per (q tile of 64 nwg rows, batch x head); consumer warpgroup
// g < nwg owns the tile's rows 64 g .. 64 g + 63, warpgroup nwg is the
// producer.  Accumulator fragment of a wgmma m64nN:
// thread (warp wp, lane ln) of a warpgroup holds, for n8 block j, rows
// 16 wp + ln / 4 (entries 4 j, 4 j + 1) and that + 8 (4 j + 2, 4 j + 3),
// columns 8 j + 2 (ln % 4) + {0, 1}.
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
swa_kernel_tc(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
              TcDims d) {
  constexpr uint32_t kTileBytes = kTcBN * DP * 2;  // one K or V tile
  constexpr uint32_t kSlabKV = kTcBN * 128;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // mbarriers: Q full; K full x 2, V full x 2 (the producer's TMA bytes);
  // K empty x 2, V empty x 2 (every consumer thread, once its products
  // have read the stage)
  __shared__ __align__(8) uint64_t bars[9];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int BM = 64 * d.nwg, n_cons = 128 * d.nwg;
  const uint32_t slab_q = BM * 128;
  const uint32_t sk = sq + BM * DP * 2, sv = sk + kTcStages * kTileBytes;
  const uint32_t full_q = smem_u32(&bars[0]), full_k = full_q + 8, full_v = full_q + 24,
                 empty_k = full_q + 40, empty_v = full_q + 56;

  // the last q tiles (the longest of a global layer) go first
  const int nq = (d.T + BM - 1) / BM;
  const int bh = blockIdx.x % d.n_bh, tile = nq - 1 - blockIdx.x / d.n_bh;
  const int b = bh / d.H, h = bh - b * d.H, hk = h / (d.H / d.Hkv);
  const int i0 = tile * BM, s_off = d.S - d.T;
  const int q_hi = min(i0 + BM, d.T) - 1 + s_off;
  const int j_first = (max(0, i0 + s_off - d.w + 1) / kTcBN) * kTcBN;
  const int ntiles = (q_hi - j_first) / kTcBN + 1;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(full_k + 8 * i, 1);
      mbar_init(full_v + 8 * i, 1);
      mbar_init(empty_k + 8 * i, n_cons);
      mbar_init(empty_v + 8 * i, n_cons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The roles split once and never meet again (setmaxnreg needs that): the
  // producer warpgroup gives up registers, the consumers take them.
  if (tid >= n_cons) {  // the producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == n_cons) {
      mbar_expect(full_q, BM * DP * 2);
      for (int sl = 0; sl < DP / 64; ++sl)
        tma_load(sq + sl * slab_q, &qmap, full_q, 64 * sl, i0, h, b, d.qr, d.qh);
      for (int n = 0; n < ntiles; ++n) {  // K_0, V_0, K_1, V_1, ...
        const int st = n & 1, u = n >> 1, j0 = j_first + n * kTcBN;
        if (u > 0) mbar_wait(empty_k + 8 * st, (u - 1) & 1);
        mbar_expect(full_k + 8 * st, kTileBytes);
        for (int sl = 0; sl < DP / 64; ++sl)
          tma_load(sk + st * kTileBytes + sl * kSlabKV, &kmap, full_k + 8 * st, 64 * sl, j0, hk,
                   b, d.kr, d.kh);
        if (u > 0) mbar_wait(empty_v + 8 * st, (u - 1) & 1);
        mbar_expect(full_v + 8 * st, kTileBytes);
        for (int sl = 0; sl < DP / 64; ++sl)
          tma_load(sv + st * kTileBytes + sl * kSlabKV, &vmap, full_v + 8 * st, 64 * sl, j0, hk,
                   b, d.vr, d.vh);
      }
    }
    return;
  }

  // the consumers.  wg through a shuffle: the compiler then knows it is
  // uniform per warp, and so is every branch on it
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int t = tid & 127, wp = t >> 5, ln = t & 31;
  const int r_lo = i0 + 64 * wg;                   // this warpgroup's first query
  const int p_lo = r_lo + s_off, p_hi = min(r_lo + 63, d.T - 1) + s_off;
  const int row_a = r_lo + 16 * wp + (ln >> 2);    // and row_a + 8
  const int qpos_a = row_a + s_off;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;  // l: this thread's columns
  uint32_t pa[4][4];   // P of the previous kv tile, bf16, the A operand of O += P V

  // Step n runs S_n = Q K_n^T and O += P_{n-1} V_{n-1} on the tensor cores
  // together; the softmax of S_n runs while P_{n-1} V_{n-1} is in flight.
  // Every product runs on every step of the block, so no wgmma or wait sits
  // on a path the compiler cannot prove uniform (it would serialise them); a
  // tile that meets none of a warpgroup's rows comes out fully masked.
  auto issue_s = [&](int n, float (&s)[32]) {
    const uint32_t st = (n & 1) * kTileBytes;
    mbar_wait(full_k + 8 * (n & 1), (n >> 1) & 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss_n64(s, sw128_desc(sq + (kk >> 2) * slab_q + wg * 64 * 128 + off, 16, 1024),
                   sw128_desc(sk + st + (kk >> 2) * kSlabKV + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int n) {  // O += P_n V_n
    const uint32_t st = (n & 1) * kTileBytes;
    mbar_wait(full_v + 8 * (n & 1), (n >> 1) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<DP>(acc, pa[kk], sw128_desc(sv + st + kk * 16 * 128, kSlabKV, 1024));
    wgmma_commit();
  };
  // the online softmax of S_n in place: s becomes P_n (float32), the row
  // maxima and this thread's partial sums move on, alpha rescales O
  auto softmax = [&](int n, float (&s)[32], float& alpha_a, float& alpha_b) {
    fence_regs(s);
    const int j0 = j_first + n * kTcBN;
    // logits in log2 units; a masked one becomes NEG_INF before the row
    // maximum and weighs 0 after it.  A tile inside every row's window of
    // this warpgroup (keys at most its first row's position and above its
    // last row's position minus w) takes no select.
    const bool inside = j0 + kTcBN - 1 <= p_lo && j0 > p_hi - d.w;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] *= d.scale_log2;
      if (!inside) {
        const int kpos = j0 + 8 * (i >> 2) + 2 * (ln & 3) + (i & 1);
        const int qp = qpos_a + ((i & 2) ? 8 : 0);
        s[i] = (kpos <= qp && kpos > qp - d.w) ? s[i] : kNegInf;
      }
    }
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    alpha_a = exp2f(m_a - mx_a);
    alpha_b = exp2f(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    // a row with no key yet subtracts 0, so its masked logits give exp2(-1e30) = 0
    const float sub_a = mx_a == kNegInf ? 0.f : mx_a, sub_b = mx_b == kNegInf ? 0.f : mx_b;
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(s[i] - ((i & 2) ? sub_b : sub_a));
      s[i] = p;
      if (i & 2)
        rs_b += p;
      else
        rs_a += p;
    }
    l_a = alpha_a * l_a + rs_a;
    l_b = alpha_b * l_b + rs_b;
  };
  // after P_{n-1} V_{n-1}: O *= alpha, and P_n (bf16) becomes the A operand;
  // the S fragment of keys 16 kk .. 16 kk + 15 is the A fragment of step kk
  auto rescale_and_pack = [&](const float (&s)[32], float alpha_a, float alpha_b) {
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= (i & 2) ? alpha_b : alpha_a;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c) pa[kk][c] = pack_bf16(s[8 * kk + 2 * c], s[8 * kk + 2 * c + 1]);
  };

  {
    float s[32], alpha_a, alpha_b;
    mbar_wait(full_q, 0);
    issue_s(0, s);
    wgmma_wait<0>();
    mbar_arrive(empty_k);
    softmax(0, s, alpha_a, alpha_b);
    rescale_and_pack(s, alpha_a, alpha_b);
  }
  for (int n = 1; n < ntiles; ++n) {
    float s[32], alpha_a, alpha_b;
    issue_s(n, s);
    issue_pv(n - 1);
    wgmma_wait<1>();
    mbar_arrive(empty_k + 8 * (n & 1));
    softmax(n, s, alpha_a, alpha_b);
    wgmma_wait<0>();
    mbar_arrive(empty_v + 8 * ((n - 1) & 1));
    rescale_and_pack(s, alpha_a, alpha_b);
  }
  issue_pv(ntiles - 1);
  wgmma_wait<0>();
  fence_regs(acc);

  // ---- out = acc / l (l == 0 divides by 1); rows past T are not written --
  if (r_lo >= d.T) return;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a), inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
  __nv_bfloat16* og = o + b * d.ob + h * d.oh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * (ln & 3);
    if (col < d.D) {
      if (row_a < d.T)
        *reinterpret_cast<__nv_bfloat162*>(og + row_a * d.ot + col) =
            __floats2bfloat162_rn(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
      if (row_a + 8 < d.T)
        *reinterpret_cast<__nv_bfloat162*>(og + (row_a + 8) * d.ot + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
    }
  }
}

// The tensor map of a bf16 (batch, heads, rows, D) view with element strides
// sb, sh, sr (D contiguous): 4-D, its three outer dimensions ordered by
// stride (a size-1 dimension goes last), boxes of 64 columns by box_rows
// rows, 128-byte swizzle, zero fill past the edges.  TMA takes the outer
// dimensions in any order, but on an H100 this order ran K6 faster at
// gemma3-4b's prefill shapes than (D, row, head, batch) did, in every run of
// an A/B in one call.  pos receives the coordinate slots of row, head and
// batch.  0, or a CUDA error code.
int make_map(CUtensorMap* map, int (&pos)[3], const void* ptr, int D, int rows, int heads,
             int batch, long long sr, long long sh, long long sb, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  struct Dim {
    long long n, stride;
    int which;
  } dim[3] = {{rows, sr, 0}, {heads, sh, 1}, {batch, sb, 2}};
  long long far = 8;  // a size-1 dimension takes a stride past every other
  for (const Dim& x : dim) far = std::max(far, x.n * x.stride);
  for (Dim& x : dim)
    if (x.n == 1) x.stride = (far + 7) / 8 * 8;
  for (int i = 1; i < 3; ++i)  // insertion sort by stride
    for (int j = i; j > 0 && dim[j].stride < dim[j - 1].stride; --j) {
      const Dim t = dim[j];
      dim[j] = dim[j - 1];
      dim[j - 1] = t;
    }
  cuuint64_t gdim[4] = {static_cast<cuuint64_t>(D), 0, 0, 0}, gstride[3];
  cuuint32_t box[4] = {64, 1, 1, 1}, estride[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    gdim[i + 1] = static_cast<cuuint64_t>(dim[i].n);
    gstride[i] = static_cast<cuuint64_t>(dim[i].stride) * 2;
    pos[dim[i].which] = i + 1;
    if (dim[i].which == 0) box[i + 1] = static_cast<cuuint32_t>(box_rows);
  }
  for (int i = 0; i < 3; ++i)
    if (gstride[i] % 16 != 0 || gstride[i] == 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, const Dims& d,
              cudaStream_t stream) {
  int sms = 0;
  const int e_sm = sm_count(&sms);
  if (e_sm != 0) return e_sm;
  const long long n_bh = static_cast<long long>(B) * d.H;
  const Plan pl = plan_for(true, B, d.H, d.T, d.D, sms);
  const int nwg = pl.rows / 64;
  const long long blocks = pl.gx;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  alignas(64) CUtensorMap qmap, kmap, vmap;
  int qp[3], kp[3], vp[3];
  int e = make_map(&qmap, qp, q, d.D, d.T, d.H, B, d.qt, d.qh, d.qb, 64 * nwg);
  if (e == 0) e = make_map(&kmap, kp, k, d.D, d.S, d.Hkv, B, d.ks, d.kh, d.kb, kTcBN);
  if (e == 0) e = make_map(&vmap, vp, v, d.D, d.S, d.Hkv, B, d.vs, d.vh, d.vb, kTcBN);
  if (e != 0) return e;
  const size_t bytes = tc_smem_bytes(DP, nwg);
  cudaError_t err = cudaFuncSetAttribute(swa_kernel_tc<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const TcDims t{d.H, d.Hkv, d.T, d.S, d.D, d.w, nwg, static_cast<int>(n_bh), d.scale * kLog2e,
                 qp[0], qp[1], qp[2], kp[0], kp[1], kp[2], vp[0], vp[1], vp[2],
                 d.ob, d.oh, d.ot};
  swa_kernel_tc<DP><<<static_cast<unsigned>(blocks), pl.threads, bytes, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), t);
  return static_cast<int>(cudaGetLastError());
}

int run_tc(const void* q, const void* k, const void* v, void* o, int B, const Dims& d,
           cudaStream_t stream) {
  if (d.D <= 64) return launch_tc<64>(q, k, v, o, B, d, stream);
  if (d.D <= 128) return launch_tc<128>(q, k, v, o, B, d, stream);
  return launch_tc<256>(q, k, v, o, B, d, stream);
}

}  // namespace

// dtype 0: float32 (the 3xTF32 kernel), 1: bfloat16 (the wgmma kernel), for
// q, k, v and the output.  strides: the batch, head and time
// strides of q, k, v and the output, in that order (bfloat16: q, k and v
// 16-byte aligned, their strides positive multiples of 8 elements, for the
// TMA tensor maps).  w: the window, at most S.  *kernel is set to the kind
// of kernel launched (0 CUDA cores, 1 tensor cores; both dtypes give 1).  lse: null,
// or (float32 only) a (B, H, T) float32 buffer that receives each row's
// log-sum-exp of the scaled logits, for the backward (swa_bwd.cu).  Returns
// the CUDA error code of the launch (0: launched).
extern "C" int repro_swa_attention(int dtype, const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int Hkv, int T, int S, int D, int w,
                                   float scale, const long long* strides, void* stream,
                                   int* kernel, void* lse) {
  if (D <= 0 || D > kMaxD || D % 4 != 0 || H % Hkv != 0 || T < 1 || S < T || w < 1 ||
      (lse != nullptr && dtype != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{H, Hkv, T, S, D, w, scale,
               strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
               strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      *kernel = 1;
      return run_f32(q, k, v, o, static_cast<float*>(lse), B, d, st);
    case 1:
      *kernel = 1;
      return run_tc(q, k, v, o, B, d, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch plan repro_swa_attention uses for (B, H, T) at head width D
// (dtype picks the kernel as there): out[0..3] = blocks along x and y,
// threads per block, q rows per block.  Returns a CUDA error code.
extern "C" int repro_swa_plan(int dtype, int B, int H, int T, int D, long long* out) {
  if (dtype < 0 || dtype > 1 || T < 1 || D <= 0 || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  if (dtype == 1) {
    const int e = sm_count(&sms);
    if (e != 0) return e;
  }
  const Plan p = plan_for(dtype == 1, B, H, T, D, sms);
  out[0] = p.gx;
  out[1] = p.gy;
  out[2] = p.threads;
  out[3] = p.rows;
  return 0;
}
