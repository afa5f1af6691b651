// Kernels K2-K5 of the port: the fused solver operators on cell centers.
//
// Replace the TPU kernels of src/repro/kernels/solver3d/kernel.py, center
// variants (the face variants come with the staggered slice):
//
//   K2 apply_kernel     <- apply_pallas    (:278, _center_au :81-113)
//        out = A u = -sum_d [cf+ (u+ - u0) - cf- (u0 - u-)] / h_d^2 inside,
//        cf+- = 0.5 * (c0 + c+-); 0 on the ring
//   K3 residual_kernel  <- residual_pallas (:298, _residual_center :115)
//        out = f - A u inside; 0 on the ring
//   K4 jacobi_kernel    <- jacobi_pallas   (:321, _jacobi_center :123)
//        out = u0 + (omega * (f - A u)) / dia inside; u on the ring
//   K5 cheb_kernel      <- cheb_pallas     (:347, _cheb_center :131)
//        z = (f - A u) / dia; dn = z / b on the first step, else a * d + b * z;
//        out_u = u0 + dn, out_d = dn inside; u and 0 on the ring
//
// and compute what src/repro_torch/kernels/solver3d/ref.py computes, in its
// order.  Scalars (0.5, omega, a, b) are rounded to the field's type first,
// as the reference's weakly typed Python floats are.  On the center path
// every value written depends only on the local interior and its six
// neighbours, which always lie inside the block, so the TPU kernels'
// wrap-mapped x tiles have no counterpart here.
//
// Division.  The three divisions by h_d^2 are multiplications by 1/h_d^2
// computed on the host (as K1 does): an IEEE division is a software
// sequence, with a slow path on a zero numerator, and the CG and V-cycle
// iterates start at zero.  The divisions by dia and b are per cell and stay
// divisions.  The compiler may contract to FMA.
//
// Bound.  Each kernel reads each input once and writes each output once:
// K2 3 words per cell (u, c; out), K3 4, K4 5, K5 7 (6 on the first step,
// which reads no d).  About 40 operations per cell in f64 against ~10 bytes
// per operation moved: far below the H100's f64 ridge, so the floor is the
// bytes over 3.35 TB/s.
//
// Design.  One thread per cell, as K1: neighbouring threads run along z,
// the contiguous axis, so a warp's loads coalesce; a block tiles
// 32 (z) x 4 (y) x 2 (x) cells and the neighbour reads hit L1/L2.  The
// grid's z dimension walks x tiles and the batch of blocks.  Each input
// comes with four strides (batch, x, y, z), so views launch without
// copies; outputs are contiguous and every cell of them is written.
#include <cuda_runtime.h>

namespace {

struct Strides {
  long long b, x, y, z;
};

constexpr int kTz = 32, kTy = 4, kTx = 2;
enum Op { kApply = 0, kResidual = 1, kJacobi = 2, kCheb = 3 };

template <typename T>
struct Params {
  const T* u;
  const T* c;
  const T* f;
  const T* dia;
  const T* d;
  T* out;
  T* dout;
  int nx, ny, nz;
  Strides su, sc, sf, sdia, sd;
  T rh2[3];  // 1 / h_d^2
  T omega, a, b;
  int first;  // K5: the first step (no a): d = z / b, the input d is not read
};

__device__ __forceinline__ long long at(const Strides& s, int b, int i, int j, int k) {
  return static_cast<long long>(b) * s.b + static_cast<long long>(i) * s.x +
         static_cast<long long>(j) * s.y + static_cast<long long>(k) * s.z;
}

// The cell of this thread; false outside the array.
__device__ __forceinline__ bool cell(int nx, int ny, int nz, int& b, int& i, int& j, int& k) {
  k = blockIdx.x * kTz + threadIdx.x;
  j = blockIdx.y * kTy + threadIdx.y;
  const int xtiles = (nx + kTx - 1) / kTx;
  b = blockIdx.z / xtiles;
  i = (blockIdx.z % xtiles) * kTx + threadIdx.z;
  return i < nx && j < ny && k < nz;
}

__device__ __forceinline__ bool ring(int nx, int ny, int nz, int i, int j, int k) {
  return i == 0 || i == nx - 1 || j == 0 || j == ny - 1 || k == 0 || k == nz - 1;
}

// A u at an interior cell, in the reference's order: acc accumulates
// (cf+ (u+ - u0) - cf- (u0 - u-)) / h_d^2 over d = x, y, z; A u = -acc.
template <typename T>
__device__ __forceinline__ T center_au(const Params<T>& p, int b, int i, int j, int k) {
  const T* u = p.u + at(p.su, b, i, j, k);
  const T* c = p.c + at(p.sc, b, i, j, k);
  const long long us[3] = {p.su.x, p.su.y, p.su.z};
  const long long cs[3] = {p.sc.x, p.sc.y, p.sc.z};
  const T half = T(0.5);
  const T u0 = u[0], c0 = c[0];
  T acc = T(0);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const T cfp = half * (c0 + c[cs[d]]);
    const T cfm = half * (c0 + c[-cs[d]]);
    const T t = cfp * (u[us[d]] - u0) - cfm * (u0 - u[-us[d]]);
    acc = acc + t * p.rh2[d];
  }
  return -acc;
}

template <typename T>
__global__ void __launch_bounds__(kTz * kTy * kTx) apply_kernel(Params<T> p) {
  int b, i, j, k;
  if (!cell(p.nx, p.ny, p.nz, b, i, j, k)) return;
  const long long o = ((static_cast<long long>(b) * p.nx + i) * p.ny + j) * p.nz + k;
  p.out[o] = ring(p.nx, p.ny, p.nz, i, j, k) ? T(0) : center_au<T>(p, b, i, j, k);
}

template <typename T>
__global__ void __launch_bounds__(kTz * kTy * kTx) residual_kernel(Params<T> p) {
  int b, i, j, k;
  if (!cell(p.nx, p.ny, p.nz, b, i, j, k)) return;
  const long long o = ((static_cast<long long>(b) * p.nx + i) * p.ny + j) * p.nz + k;
  if (ring(p.nx, p.ny, p.nz, i, j, k)) {
    p.out[o] = T(0);
    return;
  }
  p.out[o] = p.f[at(p.sf, b, i, j, k)] - center_au<T>(p, b, i, j, k);
}

template <typename T>
__global__ void __launch_bounds__(kTz * kTy * kTx) jacobi_kernel(Params<T> p) {
  int b, i, j, k;
  if (!cell(p.nx, p.ny, p.nz, b, i, j, k)) return;
  const long long o = ((static_cast<long long>(b) * p.nx + i) * p.ny + j) * p.nz + k;
  const T u0 = p.u[at(p.su, b, i, j, k)];
  if (ring(p.nx, p.ny, p.nz, i, j, k)) {
    p.out[o] = u0;  // the ring passes through bit for bit
    return;
  }
  const T r = p.f[at(p.sf, b, i, j, k)] - center_au<T>(p, b, i, j, k);
  p.out[o] = u0 + (p.omega * r) / p.dia[at(p.sdia, b, i, j, k)];
}

template <typename T>
__global__ void __launch_bounds__(kTz * kTy * kTx) cheb_kernel(Params<T> p) {
  int b, i, j, k;
  if (!cell(p.nx, p.ny, p.nz, b, i, j, k)) return;
  const long long o = ((static_cast<long long>(b) * p.nx + i) * p.ny + j) * p.nz + k;
  const T u0 = p.u[at(p.su, b, i, j, k)];
  if (ring(p.nx, p.ny, p.nz, i, j, k)) {
    p.out[o] = u0;
    p.dout[o] = T(0);
    return;
  }
  const T r = p.f[at(p.sf, b, i, j, k)] - center_au<T>(p, b, i, j, k);
  const T z = r / p.dia[at(p.sdia, b, i, j, k)];
  const T dn = p.first ? z / p.b : p.a * p.d[at(p.sd, b, i, j, k)] + p.b * z;
  p.out[o] = u0 + dn;
  p.dout[o] = dn;
}

template <typename T>
cudaError_t launch(int op, const Params<T>& p, int nb, cudaStream_t stream) {
  const dim3 block(kTz, kTy, kTx);
  const dim3 grid((p.nz + kTz - 1) / kTz, (p.ny + kTy - 1) / kTy,
                  ((p.nx + kTx - 1) / kTx) * nb);
  switch (op) {
    case kApply:
      apply_kernel<T><<<grid, block, 0, stream>>>(p);
      break;
    case kResidual:
      residual_kernel<T><<<grid, block, 0, stream>>>(p);
      break;
    case kJacobi:
      jacobi_kernel<T><<<grid, block, 0, stream>>>(p);
      break;
    case kCheb:
      cheb_kernel<T><<<grid, block, 0, stream>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(int op, const void* u, const void* c, const void* f,
                const void* dia, const void* d, void* out, void* dout, int nb, int nx, int ny,
                int nz, const long long* st, const double* h2, double omega, double a,
                double b, int first, cudaStream_t stream) {
  Params<T> p;
  p.u = static_cast<const T*>(u);
  p.c = static_cast<const T*>(c);
  p.f = static_cast<const T*>(f);
  p.dia = static_cast<const T*>(dia);
  p.d = static_cast<const T*>(d);
  p.out = static_cast<T*>(out);
  p.dout = static_cast<T*>(dout);
  p.nx = nx;
  p.ny = ny;
  p.nz = nz;
  Strides* s[5] = {&p.su, &p.sc, &p.sf, &p.sdia, &p.sd};
  for (int q = 0; q < 5; ++q) *s[q] = Strides{st[4 * q], st[4 * q + 1], st[4 * q + 2], st[4 * q + 3]};
  for (int q = 0; q < 3; ++q) p.rh2[q] = T(1) / T(h2[q]);
  p.omega = T(omega);
  p.a = T(a);
  p.b = T(b);
  p.first = first;
  return launch<T>(op, p, nb, stream);
}

}  // namespace

// op: 0 = apply (K2), 1 = residual (K3), 2 = jacobi (K4), 3 = cheb (K5).
// dtype: 0 = float32, 2 = float64 (the codes of heat_step.cu).  Inputs an op
// does not read may be null.  strides: 20 element strides, (batch, x, y, z)
// for u, c, f, dia and d in turn.  h2: h_x^2, h_y^2, h_z^2.  first: K5's
// first step (a is not used and d is not read).  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int repro_solver3d(int op, int dtype, const void* u, const void* c,
                              const void* f, const void* dia, const void* d, void* out,
                              void* dout, int nb, int nx, int ny, int nz, const long long* strides,
                              const double* h2, double omega, double a, double b, int first,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return run<float>(op, u, c, f, dia, d, out, dout, nb, nx, ny, nz, strides, h2,
                        omega, a, b, first, s);
    case 2:
      return run<double>(op, u, c, f, dia, d, out, dout, nb, nx, ny, nz, strides, h2,
                         omega, a, b, first, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
