// Kernel K1 of the port: one explicit 7-point heat-diffusion step.
//
// Replaces the TPU kernel src/repro/kernels/stencil3d/kernel.py:28-97
// (_heat_kernel / heat_step_pallas), and computes what
// src/repro/kernels/stencil3d/ref.py computes, in the same order:
//
//   out = T                                           on the outer ring
//   out = T + dt * (lam * Ci * (dxx/dx^2 + dyy/dy^2 + dzz/dz^2))   inside
//
// Like the TPU kernel, it multiplies by 1/dx^2 instead of dividing by dx^2
// (as PyTorch's own CUDA division by a scalar does): an IEEE division
// takes a slow path on a zero numerator, which a smooth field has often.
//
// on a batch of local blocks (B, nx, ny, nz): the batch axis is the
// virtual ranks of a field, or of a slab of one.
//
// Bound.  It reads T and Ci once and writes T once: 3 words per cell.  The
// reference quotes about 0.23 FLOP/B; counted here it is 16 FLOP per 12 B
// in f32 (1.3 FLOP/B), either way far below the H100's ridge of
// 67 TFLOP/s / 3.35 TB/s = 20 FLOP/B.  The kernel is memory-bound: its
// floor is 3 * n * itemsize / 3.35 TB/s.
//
// Design.  One thread per cell.  Neighbouring threads run along z, the
// contiguous axis, so the loads of a warp coalesce; a block tiles
// 32 (z) x 4 (y) x 2 (x) cells, and the six neighbour reads of a cell
// are mostly the centre reads of other threads, served from L1/L2.  The
// grid's z dimension walks x tiles and the batch.  Each input comes with
// its four strides, so slab views of a field launch without copies; the
// output is contiguous.  bf16 is computed in f32 and rounded once; f64 is
// computed in f64.  Shared-memory tiling and z-marching are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T> struct Acc { using type = T; };
template <> struct Acc<__nv_bfloat16> { using type = float; };

template <typename T> __device__ __forceinline__ typename Acc<T>::type up(T x) { return x; }
template <> __device__ __forceinline__ float up<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T down(typename Acc<T>::type x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 down<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {
  long long b, x, y, z;
};

constexpr int kTz = 32, kTy = 4, kTx = 2;

template <typename T>
__global__ void __launch_bounds__(kTz * kTy * kTx)
heat_step_kernel(const T* __restrict__ Tin, const T* __restrict__ Ci, T* __restrict__ out,
                 int nx, int ny, int nz, Strides st, Strides sc,
                 typename Acc<T>::type lam, typename Acc<T>::type dt,
                 typename Acc<T>::type rdx2, typename Acc<T>::type rdy2,
                 typename Acc<T>::type rdz2) {
  using A = typename Acc<T>::type;
  const int k = blockIdx.x * kTz + threadIdx.x;
  const int j = blockIdx.y * kTy + threadIdx.y;
  const int xtiles = (nx + kTx - 1) / kTx;
  const int b = blockIdx.z / xtiles;
  const int i = (blockIdx.z % xtiles) * kTx + threadIdx.z;
  if (i >= nx || j >= ny || k >= nz) return;

  const T* t = Tin + b * st.b + i * st.x + j * st.y + k * st.z;
  const long long o = ((static_cast<long long>(b) * nx + i) * ny + j) * nz + k;
  if (i == 0 || i == nx - 1 || j == 0 || j == ny - 1 || k == 0 || k == nz - 1) {
    out[o] = *t;  // the ring passes through bit for bit
    return;
  }
  const A c = up(t[0]);
  const A c2 = A(2) * c;
  const A d2x = (up(t[st.x]) - c2 + up(t[-st.x])) * rdx2;
  const A d2y = (up(t[st.y]) - c2 + up(t[-st.y])) * rdy2;
  const A d2z = (up(t[st.z]) - c2 + up(t[-st.z])) * rdz2;
  const A ci = up(Ci[b * sc.b + i * sc.x + j * sc.y + k * sc.z]);
  out[o] = down<T>(c + dt * (lam * ci * (d2x + d2y + d2z)));
}

template <typename T>
cudaError_t launch(const void* Tin, const void* Ci, void* out, int nx, int ny, int nz,
                   Strides st, Strides sc, double lam, double dt, double dx2, double dy2,
                   double dz2, dim3 grid, dim3 block, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  heat_step_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(Tin), static_cast<const T*>(Ci), static_cast<T*>(out), nx, ny, nz,
      st, sc, A(lam), A(dt), A(1) / A(dx2), A(1) / A(dy2), A(1) / A(dz2));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float64.  Strides are in elements:
// (batch, x, y, z) for T (ts*) and Ci (cs*).  dx2 = dx * dx, and so on.
// grid and block are the caller's launch plan (kernels/plans.py::cell_plan:
// grid (z tiles, y tiles, x tiles * nb)); a block other than (kTz, kTy, kTx)
// is refused.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_heat_step(int dtype, const void* Tin, const void* Ci, void* out, int nb,
                               int nx, int ny, int nz, long long tsb, long long tsx,
                               long long tsy, long long tsz, long long csb, long long csx,
                               long long csy, long long csz, double lam, double dt, double dx2,
                               double dy2, double dz2, int gx, int gy, int gz, int bx, int by,
                               int bz, void* stream) {
  if (bx != kTz || by != kTy || bz != kTx || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{tsb, tsx, tsy, tsz}, sc{csb, csx, csy, csz};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(gx, gy, gz), block(bx, by, bz);
  switch (dtype) {
    case 0:
      return launch<float>(Tin, Ci, out, nx, ny, nz, st, sc, lam, dt, dx2, dy2, dz2, grid, block,
                           s);
    case 1:
      return launch<__nv_bfloat16>(Tin, Ci, out, nx, ny, nz, st, sc, lam, dt, dx2, dy2, dz2,
                                   grid, block, s);
    case 2:
      return launch<double>(Tin, Ci, out, nx, ny, nz, st, sc, lam, dt, dx2, dy2, dz2, grid, block,
                            s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
