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
// Every product is taken in float32 with float32 sums, as the reference
// casts to float32 before every dot.  The decay exp(s_t - s_j) of j > t is
// a positive exponent that may overflow: it is never computed, the entry
// is selected to 0 (a 0/1 mask times inf would give NaN).
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
// 3.35 TB/s; the ~21.5 GFLOP take 0.022 ms on the bf16 tensor cores, so
// the bytes bound it.  This kernel does its arithmetic in float32 on the
// CUDA cores (no tensor cores), whose 67 TFLOP/s make 0.32 ms a floor it
// cannot beat.
//
// Design (a simple first form).  One block of 256 threads per (chunk,
// head, batch).  The chunk's x (L x P), B and C (transposed, N x L), dt,
// s and W live in dynamic shared memory as float32 (104 KB at L 64, N 128,
// P 64; two blocks per SM).  Each thread computes 4 x 4 register tiles:
// first the lower-triangular tiles of W (an N-long product of a column of
// C^T and one of B^T, float4 reads), then tiles of Y_diag (the j <= t
// part of W X) and of S_c, B first scaled by exp(s_{L-1} - s_j) dt_j in
// place.  Rows past L (a ragged L not a multiple of 4) are zero and never
// written out.  Tensor cores (wgmma on bf16 tiles) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ float up(T x);
template <> __device__ __forceinline__ float up<float>(float x) { return x; }
template <> __device__ __forceinline__ float up<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T down(float x);
template <> __device__ __forceinline__ float down<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 down<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Dims {
  int T, H, G, N, P, L, nc;
  long long xb, xt, xh;  // x strides (elements)
  long long bb, bt, bg;  // B strides
  long long cb, ct, cg;  // C strides
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// floats of dynamic shared memory: x (L4 x P), B^T and C^T (N x LP),
// W (L4 x LP), dt, s and the state weights (L4 each); LP = L4 + 4 keeps
// rows 16-byte aligned and spreads the columns of B^T over the banks
__host__ __device__ inline size_t smem_floats(int L, int N, int P) {
  const int L4 = round4(L), LP = L4 + 4;
  return static_cast<size_t>(L4) * P + 2 * static_cast<size_t>(N) * LP +
         static_cast<size_t>(L4) * LP + 3 * static_cast<size_t>(L4);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
                 const float* __restrict__ dt, const float* __restrict__ s,
                 T* __restrict__ y, float* __restrict__ states, Dims d) {
  extern __shared__ __align__(16) float sm[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int L = d.L, N = d.N, P = d.P, H = d.H;
  const int L4 = round4(L), LP = L4 + 4;
  const int g = h / (H / d.G);
  float* xs = sm;                    // [L4][P]
  float* bt = xs + L4 * P;           // [N][LP]
  float* ct = bt + N * LP;           // [N][LP]
  float* w = ct + N * LP;            // [L4][LP]
  float* dts = w + L4 * LP;          // [L4]
  float* ss = dts + L4;              // [L4]
  float* us = ss + L4;               // [L4]
  const int tid = threadIdx.x;
  const long long t0 = static_cast<long long>(c) * L;

  // ---- load the chunk, float32, zero rows past L --------------------------
  const T* xg = x + b * d.xb + t0 * d.xt + h * d.xh;
  for (int i = tid; i < L4 * P; i += kThreads) {
    const int t = i / P, p = i - t * P;
    xs[i] = t < L ? up(xg[t * d.xt + p]) : 0.f;
  }
  const T* bg = Bm + b * d.bb + t0 * d.bt + g * d.bg;
  const T* cg = Cm + b * d.cb + t0 * d.ct + g * d.cg;
  for (int i = tid; i < L4 * N; i += kThreads) {
    const int t = i / N, n = i - t * N;
    bt[n * LP + t] = t < L ? up(bg[t * d.bt + n]) : 0.f;
    ct[n * LP + t] = t < L ? up(cg[t * d.ct + n]) : 0.f;
  }
  for (int t = tid; t < L4; t += kThreads) {
    const long long row = (static_cast<long long>(b) * d.T + t0 + t) * H + h;
    const long long srow = ((static_cast<long long>(b) * d.nc + c) * L + t) * H + h;
    dts[t] = t < L ? dt[row] : 0.f;
    ss[t] = t < L ? s[srow] : 0.f;
  }
  __syncthreads();

  // ---- state weights exp(s_{L-1} - s_j) dt_j; W on the lower tiles ---------
  for (int t = tid; t < L4; t += kThreads) us[t] = t < L ? expf(ss[L - 1] - ss[t]) * dts[t] : 0.f;
  const int nt = L4 / 4;
  for (int k = tid; k < nt * (nt + 1) / 2; k += kThreads) {
    int ti = static_cast<int>((sqrtf(8.f * k + 1.f) - 1.f) * 0.5f);
    while (ti * (ti + 1) / 2 > k) --ti;
    while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
    const int tj = k - ti * (ti + 1) / 2;  // tj <= ti
    float acc[4][4] = {};
    for (int n = 0; n < N; ++n) {
      const float4 cv = *reinterpret_cast<const float4*>(ct + n * LP + 4 * ti);
      const float4 bv = *reinterpret_cast<const float4*>(bt + n * LP + 4 * tj);
      const float cr[4] = {cv.x, cv.y, cv.z, cv.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(cr[a], br[q], acc[a][q]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = 4 * ti + a;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 4 * tj + q;
        w[t * LP + j] = (j <= t && t < L) ? acc[a][q] * expf(ss[t] - ss[j]) * dts[j] : 0.f;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * L4; i += kThreads) {  // B_j <- B_j exp(s_{L-1} - s_j) dt_j
    const int n = i / L4, j = i - n * L4;
    bt[n * LP + j] *= us[j];
  }
  __syncthreads();

  // ---- Y_diag = W X (4 x 4 tiles of (t, p)) and S_c = B'^T X ((n, p)) ----
  const int np4 = P / 4, ny = nt * np4, ns = (N / 4) * np4;
  for (int k = tid; k < ny + ns; k += kThreads) {
    float acc[4][4] = {};
    if (k < ny) {
      const int ti = k / np4, tp = k - ti * np4;
      const int jmax = min(4 * ti + 3, L - 1);
      for (int j = 0; j <= jmax; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + j * P + 4 * tp);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float wa = w[(4 * ti + a) * LP + j];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(wa, xr[q], acc[a][q]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = 4 * ti + a;
        if (t < L) {
          T* yo = y + ((static_cast<long long>(b) * d.T + t0 + t) * H + h) * P + 4 * tp;
#pragma unroll
          for (int q = 0; q < 4; ++q) yo[q] = down<T>(acc[a][q]);
        }
      }
    } else {
      const int kk = k - ny, tn = kk / np4, tp = kk - tn * np4;
      for (int j = 0; j < L; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + j * P + 4 * tp);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float ba = bt[(4 * tn + a) * LP + j];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(ba, xr[q], acc[a][q]);
        }
      }
      float* so = states + ((static_cast<long long>(b) * d.nc + c) * H + h) * N * P;
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float4*>(so + (4 * tn + a) * P + 4 * tp) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    }
  }
}

template <typename T>
int run(const void* x, const void* Bm, const void* Cm, const float* dt, const float* s, void* y,
        float* states, int Ba, const Dims& d, cudaStream_t stream) {
  const size_t bytes = smem_floats(d.L, d.N, d.P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(d.nc, d.H, Ba);
  ssd_chunk_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(Bm), static_cast<const T*>(Cm), dt, s,
      static_cast<T*>(y), states, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (x, B, C and y_diag).  strides: x's batch,
// time and head strides, then B's and C's batch, time and group strides.
// Returns the CUDA error code of the launch (0: launched).
extern "C" int repro_ssd_intra_chunk(int dtype, const void* x, const void* Bm, const void* Cm,
                                     const void* dt, const void* s, void* y, void* states,
                                     int Ba, int T, int H, int G, int N, int P, int L,
                                     const long long* strides, void* stream) {
  Dims d{T, H, G, N, P, L, T / L,
         strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* sf = static_cast<const float*>(s);
  float* sto = static_cast<float*>(states);
  switch (dtype) {
    case 0:
      return run<float>(x, Bm, Cm, dtf, sf, y, sto, Ba, d, st);
    case 1:
      return run<__nv_bfloat16>(x, Bm, Cm, dtf, sf, y, sto, Ba, d, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
