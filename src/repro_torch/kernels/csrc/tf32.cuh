// 3xTF32 building blocks shared by the float32 kernels of K6 (swa/csrc/
// swa.cu, swa_bwd.cu) and of K7 (ssd/csrc/ssd.cu, ssd_bwd.cu): float32
// products on the tensor cores with float32's accuracy.
//
// TF32 keeps 10 mantissa bits (unit roundoff 2^-11), too few for the port's
// 1e-5 float32 tolerances.  Each float32 operand x is split into two TF32
// values, big = rna(x) and small = rna(x - big) (rna as cvt.rna.tf32.f32:
// round to nearest, ties away from zero; x - big is exact in float32), and
// a product a b is taken as a_small b_big + a_big b_small + a_big b_big,
// the small terms first, summed in the float32 accumulator.  What is left
// out, a_small b_small and the rounding of small, is about 2^-21 of |a b|.
// The accumulator cuts each sum toward zero, so it sums one tile
// (tile_product) and longer sums run in float32 on the CUDA cores.
//
// The instruction is mma.sync.aligned.m16n8k8 (one warp, 16 x 8 x 8): its
// A and B fragments are registers, so each operand is split once after its
// load, and a float32 accumulator fragment can be the next product's A
// operand without leaving the thread (acc_to_a).  wgmma would give the
// higher rate, but for .tf32 it takes shared-memory operands K-major only
// and A alone from registers: V, stored [key][d], would need a transposed
// copy, and every shared-memory operand a second copy for its small part.
//
// Fragments (g = lane / 4, t = lane % 4): A (16 x 8) holds rows g, g + 8
// and columns t, t + 4; B (8 x 8) holds k = t, t + 4 of column g; the
// accumulator C (16 x 8) holds rows g, g + 8 and columns 2t, 2t + 1.
// Shared tiles are float32 rows of LD floats, LD = 4 mod 8 (K6: DP + 4, K7:
// its widths rounded up to 32, plus 4), so every fragment load below reads
// 32 distinct banks but load_a_perm, whose pairs of 8-byte reads meet
// two-way conflicts.
#pragma once

#include "hopper.cuh"

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;


struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

// big = cvt.rna.tf32.f32(x) and small = cvt.rna.tf32.f32(x - big) for
// finite x, in integer instructions: adding half a TF32 ulp (0x1000) to the
// bits rounds the magnitude to nearest, ties away from zero; big's 13 low
// bits are then cleared, small's are left, since the tensor cores ignore
// them.  cvt.rna itself costs four instructions a value (it guards Inf and
// NaN), and the splits are most of what the kernels issue besides the
// products.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// d += a b on the tensor cores, one TF32 product
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[j0 + j] += a b[j] in 3xTF32 for the G n-tiles of a group, issued term
// by term over the group (small-big for every j, then big-small, then
// big-big): consecutive products are independent, so their latency hides
// behind each other instead of stalling three dependent MMAs in a row
template <int G, int N>
__device__ __forceinline__ void mma3_group(float (&d)[N][4], int j0, const FragA& a,
                                           const FragB (&b)[G]) {
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32(d[j0 + j], a.small, b[j].big);
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32(d[j0 + j], a.big, b[j].small);
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32(d[j0 + j], a.big, b[j].big);
}

// A from a row-major shared tile at s (its row 0, column 0 of this k-step)
__device__ __forceinline__ void load_a(FragA& a, const float* s, int LD, int g, int t) {
  split(s[g * LD + t], a.big[0], a.small[0]);
  split(s[(g + 8) * LD + t], a.big[1], a.small[1]);
  split(s[g * LD + t + 4], a.big[2], a.small[2]);
  split(s[(g + 8) * LD + t + 4], a.big[3], a.small[3]);
}

// B of a product X Y^T whose Y is stored row-major [n][k] (K of Q K^T):
// column n = g, k = t and t + 4
__device__ __forceinline__ void load_b_nk(FragB& b, const float* s, int LD, int g, int t) {
  split(s[g * LD + t], b.big[0], b.small[0]);
  split(s[g * LD + t + 4], b.big[1], b.small[1]);
}

// A from a row-major shared tile at s, row g scaled by r0 and row g + 8 by
// r1 before the split (u o X of K7's backward: each product u_j x_jp rounded
// to float32 first)
__device__ __forceinline__ void load_a_scaled(FragA& a, const float* s, int LD, int g, int t,
                                              float r0, float r1) {
  split(s[g * LD + t] * r0, a.big[0], a.small[0]);
  split(s[(g + 8) * LD + t] * r1, a.big[1], a.small[1]);
  split(s[g * LD + t + 4] * r0, a.big[2], a.small[2]);
  split(s[(g + 8) * LD + t + 4] * r1, a.big[3], a.small[3]);
}

// A from a row-major shared tile [m][k] under the permuted k of
// load_b_kn_perm (k = t standing for column 2t, k = t + 4 for 2t + 1): the
// operand of a product whose B is read by load_b_kn_perm (B of B dS in K7's
// backward)
__device__ __forceinline__ void load_a_perm(FragA& a, const float* s, int LD, int g, int t) {
  const float2 r0 = *reinterpret_cast<const float2*>(s + g * LD + 2 * t);
  const float2 r1 = *reinterpret_cast<const float2*>(s + (g + 8) * LD + 2 * t);
  split(r0.x, a.big[0], a.small[0]);
  split(r1.x, a.big[1], a.small[1]);
  split(r0.y, a.big[2], a.small[2]);
  split(r1.y, a.big[3], a.small[3]);
}

// A (rows m, k) from a shared tile stored [k][m] (the transpose of what A
// is), under the permuted k of load_b_kn_perm, row 2t of the tile scaled by
// k0 and row 2t + 1 by k1 before the split: (u o B)^T of K7's states, read
// from B stored [j][n].  Element (m, k) is s[k LD + m]: lanes read 8t + g
// (mod 32) apart, conflict-free for LD = 4 mod 8.
__device__ __forceinline__ void load_a_km_perm(FragA& a, const float* s, int LD, int g, int t,
                                               float k0, float k1) {
  split(s[2 * t * LD + g] * k0, a.big[0], a.small[0]);
  split(s[2 * t * LD + g + 8] * k0, a.big[1], a.small[1]);
  split(s[(2 * t + 1) * LD + g] * k1, a.big[2], a.small[2]);
  split(s[(2 * t + 1) * LD + g + 8] * k1, a.big[3], a.small[3]);
}

// The accumulator C of a product over 8 columns as the A operand of the
// next product over those columns (P of P V), in registers: the next
// product's k index is permuted, k = t standing for column 2t and k = t + 4
// for column 2t + 1, so that each thread already holds its A elements
// (a0 = c0, a1 = c2, a2 = c1, a3 = c3).  load_b_kn_perm reads B's rows in
// the same order.
__device__ __forceinline__ void acc_to_a(FragA& a, const float (&c)[4]) {
  split(c[0], a.big[0], a.small[0]);
  split(c[2], a.big[1], a.small[1]);
  split(c[1], a.big[2], a.small[2]);
  split(c[3], a.big[3], a.small[3]);
}

// B stored row-major [k][n] (V of P V) under acc_to_a's permuted k: rows
// 2t and 2t + 1 of column g
__device__ __forceinline__ void load_b_kn_perm(FragB& b, const float* s, int LD, int g, int t) {
  split(s[2 * t * LD + g], b.big[0], b.small[0]);
  split(s[(2 * t + 1) * LD + g], b.big[1], b.small[1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
}

// One tile's product over its NK k-tiles for the CH n-tiles j0 .. j0 + CH
// of a chunk, for each of the MT m-tiles of a warp: out[m][j] = sum over kj
// of A(x[m][kj]) B(kj, j0 + j), A from the accumulator fragments x
// (acc_to_a), B by load_b_kn_perm from rows 8 kj and columns 8 (j0 + j) of
// b, loaded and split once for all m-tiles; n-tiles at or past n_live are
// skipped, and so are the k-tiles outside [k_lo, k_hi) (their A is zero:
// the causal half of K7's products).  The sum starts from zero: a
// tensor-core accumulator cuts each sum toward zero as it adds, so a long
// sum (over every tile of a walk) stays out of it and the caller adds the
// tile's product in float32 on the CUDA cores.
template <int MT, int NK, int CH>
__device__ __forceinline__ void tile_product(float (&out)[MT][CH][4], const float (&x)[MT][NK][4],
                                             const float* b, int LD, int j0, int n_live, int k_lo,
                                             int k_hi, int g, int t) {
  constexpr int G = CH < 4 ? CH : 4;
#pragma unroll
  for (int m = 0; m < MT; ++m) zero(out[m]);
#pragma unroll
  for (int kj = 0; kj < NK; ++kj) {
    if (kj < k_lo || kj >= k_hi) continue;
    FragA a[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc_to_a(a[m], x[m][kj]);
#pragma unroll
    for (int jg = 0; jg < CH; jg += G) {
      if (j0 + jg < n_live) {   // a group with a live n-tile runs whole (pad columns are 0)
        FragB bf[G];
#pragma unroll
        for (int j = 0; j < G; ++j)
          load_b_kn_perm(bf[j], b + 8 * kj * LD + 8 * (j0 + jg + j), LD, g, t);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma3_group(out[m], jg, a[m], bf);
      }
    }
  }
}

template <int MT, int NK, int CH>
__device__ __forceinline__ void tile_product(float (&out)[MT][CH][4], const float (&x)[MT][NK][4],
                                             const float* b, int LD, int j0, int n_live, int g,
                                             int t) {
  tile_product<MT, NK, CH>(out, x, b, LD, j0, n_live, 0, NK, g, t);
}

// the same for one m-tile
template <int NK, int CH>
__device__ __forceinline__ void tile_product(float (&out)[CH][4], const float (&x)[NK][4],
                                             const float* b, int LD, int j0, int n_live, int k_lo,
                                             int k_hi, int g, int t) {
  tile_product<1, NK, CH>(reinterpret_cast<float(&)[1][CH][4]>(out),
                          reinterpret_cast<const float(&)[1][NK][4]>(x), b, LD, j0, n_live, k_lo,
                          k_hi, g, t);
}
template <int NK, int CH>
__device__ __forceinline__ void tile_product(float (&out)[CH][4], const float (&x)[NK][4],
                                             const float* b, int LD, int j0, int n_live, int g,
                                             int t) {
  tile_product<NK, CH>(out, x, b, LD, j0, n_live, 0, NK, g, t);
}

// cp.async of 16 or 4 bytes; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + n) of a strided (rows, D) global tile, asynchronously,
// into shared rows of LD floats; rows at or past `limit` become zeros.
// vec: the tensor is 16-byte aligned with strides of 4-element multiples,
// so rows go in 16-byte pieces (else in 4-byte ones).  Columns D.. of the
// shared rows are left as they are.
__device__ __forceinline__ void load_rows_async(float* dst, const float* src, long long stride,
                                                int row0, int n, int limit, int D, int LD,
                                                bool vec) {
  const int step = vec ? 4 : 1, per_row = D / step;
  for (int e = threadIdx.x; e < n * per_row; e += blockDim.x) {
    const int r = e / per_row, c = (e - r * per_row) * step, i = row0 + r;
    const bool in = i < limit;
    const float* from = src + (in ? i * stride + c : 0);
    if (vec)
      cp_async16(dst + r * LD + c, from, in ? 16 : 0);
    else
      cp_async4(dst + r * LD + c, from, in ? 4 : 0);
  }
}

// zeros in columns D .. DP of `rows` shared rows of LD floats from p (the
// head width's pad: its columns add exact zeros to every product)
__device__ __forceinline__ void zero_pad(float* p, int rows, int D, int DP, int LD) {
  const int w = DP - D;
  for (int e = threadIdx.x; e < rows * w; e += blockDim.x) {
    const int r = e / w;
    p[r * LD + D + (e - r * w)] = 0.f;
  }
}

// An accumulator n-tile (rows g and g + 8, columns 2t and 2t + 1) as four
// consecutive columns a lane, for one 16-byte store: lanes t and t ^ 1
// trade halves, so that an even t holds row g's columns 4 (t / 2) .. + 3 and
// an odd t row g + 8's.  Every lane of the warp takes part.  Returns the
// row half (0: row g, 1: row g + 8); the columns start at 4 (t / 2).
__device__ __forceinline__ int pair_rows(const float (&c)[4], int t, float (&o)[4]) {
  const bool odd = t & 1;
  const float r0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
  o[0] = odd ? r0 : c[0];
  o[1] = odd ? r1 : c[1];
  o[2] = odd ? c[2] : r0;
  o[3] = odd ? c[3] : r1;
  return odd;
}

__device__ __forceinline__ void store4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}

// 16-byte pieces are possible: the pointer is 16-byte aligned and the
// batch, head and time strides are multiples of 4 elements
inline bool vec_ok(const void* p, long long sb, long long sh, long long st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0 && sh % 4 == 0 && st % 4 == 0;
}

}  // namespace
