// Kernels K2-K5 of the port: the fused solver operators, on cell centers
// and on the three face locations.
//
// Replace the TPU kernels of src/repro/kernels/solver3d/kernel.py:
//
//   K2 apply          <- apply_pallas    (:278; _center_au :81-113, _face_au :190)
//   K3 residual       <- residual_pallas (:298; _residual_center :115, _residual_face :218)
//   K4 jacobi         <- jacobi_pallas   (:321; _jacobi_center :123, _jacobi_face :223)
//   K5 cheb           <- cheb_pallas     (:347; _cheb_center :131, _cheb_face :229)
//
// and compute what src/repro_torch/kernels/solver3d/ref.py computes, in its
// order.  Scalars (0.5, 0.25, omega, a, b) are rounded to the field's type
// first, as the reference's weakly typed Python floats are.
//
// Center (SD = -1):
//   A u = -sum_d [cf+ (u+ - u0) - cf- (u0 - u-)] / h_d^2 inside,
//   cf+- = 0.5 * (c0 + c+-); the ring gets 0 (K2, K3), u (K4), u and 0 (K5).
//   With a Helmholtz shift field s (the implicit two-phase pressure's
//   1/dt + 1/eta), A u = s0 * u0 - acc instead of -acc, in the order of the
//   reference's poisson_stencil(shift=) (ref.py:74).  The shift is a
//   template flag picked once per launch, so the unshifted kernels are the
//   same code as without it.  The smoothers' dia already holds the shift
//   (the caller adds it), so K4/K5 do not add it again.
//   Every value written depends only on the cell and its six neighbours,
//   which lie inside the block, so no read wraps.
// Face (SD = 0, 1, 2: the field is staggered along SD), the MAC stripped
// component of src/repro_torch/stencil/mac.py:
//   A u = -sum_dd t_dd, with t_SD = (c[+SD] (u[+SD] - u0) - c0 (u0 - u[-SD])) / h_SD^2
//   and, across dims dd != SD, with the edge coefficient
//   e[x] = 0.25 * ((c[x] + c[x+SD]) + (c[x+dd] + c[x+dd+SD])),
//   t_dd = (e[x] (u[+dd] - u0) - e[x-dd] (u0 - u[-dd])) / h_dd^2.
//   Every neighbour index is taken modulo the block's extent in its dim:
//   the reference's rolls act on the whole local array, halos included, so
//   at a block's first and last planes the neighbour is the opposite plane
//   of the SAME block (the TPU kernel's wrap-mapped ghost rows).  K2 face is
//   unmasked, so those wrapped values are its output on the ring.  With the
//   interior mask m:  K3 (f - A u) * m;  K4 u + (omega * r) / dia with
//   r = (f - A u) * m;  K5 z = r / dia, dn = z / b (first step) or
//   a * d + b * z, outputs u + dn and dn; all over the whole block.  A
//   masked cell (m = 0) gets exactly 0 (K3), u (K4), u + a d and a d (K5).
//
// Division.  The divisions by h_d^2 are multiplications by 1/h_d^2
// computed on the host (as K1 does): an IEEE division is a software
// sequence, with a slow path on a zero numerator, and the CG and V-cycle
// iterates start at zero.  The divisions by dia and b are per cell and stay
// divisions.  The compiler may contract to FMA.
//
// Bound.  Each kernel reads each input once and writes each output once.
// Center: K2 3 words per cell (u, c; out), K3 4, K4 5, K5 7 (6 on the first
// step, which reads no d); one more with a shift (K2 4, K3 5, K4 6, K5 8).
// Face, with the mask: K2 3, K3 5, K4 6, K5 8 (7 on the first step).  About
// 40 (center) to 60 (face) operations per cell in f64 against ~10 bytes per
// operation moved: far below the H100's f64 ridge, so the floor is the bytes
// over 3.35 TB/s.
//
// Design.  One thread per cell, as K1: neighbouring threads run along z,
// the contiguous axis, so a warp's loads coalesce; a block tiles
// 32 (z) x 4 (y) x 2 (x) cells and the neighbour reads hit L1/L2.  The
// grid's z dimension walks x tiles and the batch of blocks.  Each input
// comes with four strides (batch, x, y, z), so views launch without
// copies; outputs are contiguous and every cell of them is written.  The
// face stagger dim is a template parameter, so each (op, SD) pair is its
// own kernel with the edge-average pattern unrolled; the center kernels take
// the shift flag the same way.
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
  const T* m;  // face ops: the location's interior mask
  const T* s;  // center ops: the Helmholtz shift (null: none)
  T* out;
  T* dout;
  int nx, ny, nz;
  Strides su, sc, sf, sdia, sd, sm, ss;
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
// (cf+ (u+ - u0) - cf- (u0 - u-)) / h_d^2 over d = x, y, z; A u = -acc, or
// s0 * u0 - acc with a shift.
template <typename T, bool kShift>
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
  if (kShift) return p.s[at(p.ss, b, i, j, k)] * u0 - acc;
  return -acc;
}

template <typename T, bool kShift>
__global__ void __launch_bounds__(kTz * kTy * kTx) apply_kernel(Params<T> p) {
  int b, i, j, k;
  if (!cell(p.nx, p.ny, p.nz, b, i, j, k)) return;
  const long long o = ((static_cast<long long>(b) * p.nx + i) * p.ny + j) * p.nz + k;
  p.out[o] = ring(p.nx, p.ny, p.nz, i, j, k) ? T(0) : center_au<T, kShift>(p, b, i, j, k);
}

template <typename T, bool kShift>
__global__ void __launch_bounds__(kTz * kTy * kTx) residual_kernel(Params<T> p) {
  int b, i, j, k;
  if (!cell(p.nx, p.ny, p.nz, b, i, j, k)) return;
  const long long o = ((static_cast<long long>(b) * p.nx + i) * p.ny + j) * p.nz + k;
  if (ring(p.nx, p.ny, p.nz, i, j, k)) {
    p.out[o] = T(0);
    return;
  }
  p.out[o] = p.f[at(p.sf, b, i, j, k)] - center_au<T, kShift>(p, b, i, j, k);
}

template <typename T, bool kShift>
__global__ void __launch_bounds__(kTz * kTy * kTx) jacobi_kernel(Params<T> p) {
  int b, i, j, k;
  if (!cell(p.nx, p.ny, p.nz, b, i, j, k)) return;
  const long long o = ((static_cast<long long>(b) * p.nx + i) * p.ny + j) * p.nz + k;
  const T u0 = p.u[at(p.su, b, i, j, k)];
  if (ring(p.nx, p.ny, p.nz, i, j, k)) {
    p.out[o] = u0;  // the ring passes through bit for bit
    return;
  }
  const T r = p.f[at(p.sf, b, i, j, k)] - center_au<T, kShift>(p, b, i, j, k);
  p.out[o] = u0 + (p.omega * r) / p.dia[at(p.sdia, b, i, j, k)];
}

template <typename T, bool kShift>
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
  const T r = p.f[at(p.sf, b, i, j, k)] - center_au<T, kShift>(p, b, i, j, k);
  const T z = r / p.dia[at(p.sdia, b, i, j, k)];
  const T dn = p.first ? z / p.b : p.a * p.d[at(p.sd, b, i, j, k)] + p.b * z;
  p.out[o] = u0 + dn;
  p.dout[o] = dn;
}

// ---------------------------------------------------------------------------
// face locations: the roll-form MAC stencil, wrapping inside the block
// ---------------------------------------------------------------------------

// The cell and its wrapped neighbours along each dim: pos[d] = {i - 1, i, i + 1}
// modulo the extent n_d.
struct Nbrs {
  int pos[3][3];
};

__device__ __forceinline__ Nbrs neighbours(int nx, int ny, int nz, int i, int j, int k) {
  const int n[3] = {nx, ny, nz};
  const int x[3] = {i, j, k};
  Nbrs q;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    q.pos[d][0] = x[d] == 0 ? n[d] - 1 : x[d] - 1;
    q.pos[d][1] = x[d];
    q.pos[d][2] = x[d] == n[d] - 1 ? 0 : x[d] + 1;
  }
  return q;
}

// Offset of the cell shifted by (s0, s1, s2), each in {-1, 0, 1}.
__device__ __forceinline__ long long at_shift(const Strides& s, int b, const Nbrs& q, int s0,
                                              int s1, int s2) {
  return at(s, b, q.pos[0][s0 + 1], q.pos[1][s1 + 1], q.pos[2][s2 + 1]);
}

// Unit shift along dim d (+1 or -1), as a (s0, s1, s2) triple.
__device__ __forceinline__ int sh(int d, int dim, int s) { return d == dim ? s : 0; }

template <typename T, int SD>
__device__ __forceinline__ T face_au(const Params<T>& p, int b, const Nbrs& q) {
  auto U = [&](int s0, int s1, int s2) { return p.u[at_shift(p.su, b, q, s0, s1, s2)]; };
  auto C = [&](int s0, int s1, int s2) { return p.c[at_shift(p.sc, b, q, s0, s1, s2)]; };
  const T quarter = T(0.25);
  const T u0 = U(0, 0, 0), c0 = C(0, 0, 0);
  // c at +SD, shared by the own-dim flux and both edge averages
  const T cs = C(sh(0, SD, 1), sh(1, SD, 1), sh(2, SD, 1));
  T acc = T(0);
#pragma unroll
  for (int dd = 0; dd < 3; ++dd) {
    T t;
    if (dd == SD) {
      const T up = U(sh(0, SD, 1), sh(1, SD, 1), sh(2, SD, 1));
      const T um = U(sh(0, SD, -1), sh(1, SD, -1), sh(2, SD, -1));
      t = (cs * (up - u0) - c0 * (u0 - um)) * p.rh2[SD];
    } else {
      // a[x] = c[x] + c[x + SD] at x, x + dd and x - dd
      const T a0 = c0 + cs;
      const T ap = C(sh(0, dd, 1), sh(1, dd, 1), sh(2, dd, 1)) +
                   C(sh(0, dd, 1) + sh(0, SD, 1), sh(1, dd, 1) + sh(1, SD, 1),
                     sh(2, dd, 1) + sh(2, SD, 1));
      const T am = C(sh(0, dd, -1), sh(1, dd, -1), sh(2, dd, -1)) +
                   C(sh(0, dd, -1) + sh(0, SD, 1), sh(1, dd, -1) + sh(1, SD, 1),
                     sh(2, dd, -1) + sh(2, SD, 1));
      const T e = quarter * (a0 + ap);    // edge average at x
      const T em = quarter * (am + a0);   // edge average at x - dd
      const T up = U(sh(0, dd, 1), sh(1, dd, 1), sh(2, dd, 1));
      const T um = U(sh(0, dd, -1), sh(1, dd, -1), sh(2, dd, -1));
      t = (e * (up - u0) - em * (u0 - um)) * p.rh2[dd];
    }
    acc = dd == 0 ? t : acc + t;
  }
  return -acc;
}

template <typename T, int SD>
__global__ void __launch_bounds__(kTz * kTy * kTx) apply_face_kernel(Params<T> p) {
  int b, i, j, k;
  if (!cell(p.nx, p.ny, p.nz, b, i, j, k)) return;
  const long long o = ((static_cast<long long>(b) * p.nx + i) * p.ny + j) * p.nz + k;
  p.out[o] = face_au<T, SD>(p, b, neighbours(p.nx, p.ny, p.nz, i, j, k));
}

// (f - A u) * m at this cell
template <typename T, int SD>
__device__ __forceinline__ T face_residual(const Params<T>& p, int b, int i, int j, int k) {
  const T au = face_au<T, SD>(p, b, neighbours(p.nx, p.ny, p.nz, i, j, k));
  return (p.f[at(p.sf, b, i, j, k)] - au) * p.m[at(p.sm, b, i, j, k)];
}

template <typename T, int SD>
__global__ void __launch_bounds__(kTz * kTy * kTx) residual_face_kernel(Params<T> p) {
  int b, i, j, k;
  if (!cell(p.nx, p.ny, p.nz, b, i, j, k)) return;
  const long long o = ((static_cast<long long>(b) * p.nx + i) * p.ny + j) * p.nz + k;
  p.out[o] = face_residual<T, SD>(p, b, i, j, k);
}

template <typename T, int SD>
__global__ void __launch_bounds__(kTz * kTy * kTx) jacobi_face_kernel(Params<T> p) {
  int b, i, j, k;
  if (!cell(p.nx, p.ny, p.nz, b, i, j, k)) return;
  const long long o = ((static_cast<long long>(b) * p.nx + i) * p.ny + j) * p.nz + k;
  const T r = face_residual<T, SD>(p, b, i, j, k);
  p.out[o] = p.u[at(p.su, b, i, j, k)] + (p.omega * r) / p.dia[at(p.sdia, b, i, j, k)];
}

template <typename T, int SD>
__global__ void __launch_bounds__(kTz * kTy * kTx) cheb_face_kernel(Params<T> p) {
  int b, i, j, k;
  if (!cell(p.nx, p.ny, p.nz, b, i, j, k)) return;
  const long long o = ((static_cast<long long>(b) * p.nx + i) * p.ny + j) * p.nz + k;
  const T z = face_residual<T, SD>(p, b, i, j, k) / p.dia[at(p.sdia, b, i, j, k)];
  const T dn = p.first ? z / p.b : p.a * p.d[at(p.sd, b, i, j, k)] + p.b * z;
  p.out[o] = p.u[at(p.su, b, i, j, k)] + dn;
  p.dout[o] = dn;
}

template <typename T, int SD>
void launch_face(int op, const Params<T>& p, dim3 grid, dim3 block, cudaStream_t stream) {
  switch (op) {
    case kApply:
      apply_face_kernel<T, SD><<<grid, block, 0, stream>>>(p);
      break;
    case kResidual:
      residual_face_kernel<T, SD><<<grid, block, 0, stream>>>(p);
      break;
    case kJacobi:
      jacobi_face_kernel<T, SD><<<grid, block, 0, stream>>>(p);
      break;
    case kCheb:
      cheb_face_kernel<T, SD><<<grid, block, 0, stream>>>(p);
      break;
  }
}

template <typename T, bool kShift>
void launch_center(int op, const Params<T>& p, dim3 grid, dim3 block, cudaStream_t stream) {
  switch (op) {
    case kApply:
      apply_kernel<T, kShift><<<grid, block, 0, stream>>>(p);
      break;
    case kResidual:
      residual_kernel<T, kShift><<<grid, block, 0, stream>>>(p);
      break;
    case kJacobi:
      jacobi_kernel<T, kShift><<<grid, block, 0, stream>>>(p);
      break;
    case kCheb:
      cheb_kernel<T, kShift><<<grid, block, 0, stream>>>(p);
      break;
  }
}

template <typename T>
cudaError_t launch(int op, int sd, const Params<T>& p, dim3 grid, dim3 block,
                   cudaStream_t stream) {
  if (block.x != kTz || block.y != kTy || block.z != kTx) return cudaErrorInvalidValue;
  if (op < kApply || op > kCheb || sd < -1 || sd > 2) return cudaErrorInvalidValue;
  if (sd != -1 && p.s != nullptr) return cudaErrorInvalidValue;  // shifts are center only
  switch (sd) {
    case 0:
      launch_face<T, 0>(op, p, grid, block, stream);
      return cudaGetLastError();
    case 1:
      launch_face<T, 1>(op, p, grid, block, stream);
      return cudaGetLastError();
    case 2:
      launch_face<T, 2>(op, p, grid, block, stream);
      return cudaGetLastError();
    default:
      break;
  }
  if (p.s != nullptr) {
    launch_center<T, true>(op, p, grid, block, stream);
  } else {
    launch_center<T, false>(op, p, grid, block, stream);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(int op, int sd, const void* u, const void* c, const void* f,
                const void* dia, const void* d, const void* m, const void* s, void* out,
                void* dout,
                int nx, int ny, int nz, const long long* st, const double* h2, double omega,
                double a, double b, int first, dim3 grid, dim3 block, cudaStream_t stream) {
  Params<T> p;
  p.u = static_cast<const T*>(u);
  p.c = static_cast<const T*>(c);
  p.f = static_cast<const T*>(f);
  p.dia = static_cast<const T*>(dia);
  p.d = static_cast<const T*>(d);
  p.m = static_cast<const T*>(m);
  p.s = static_cast<const T*>(s);
  p.out = static_cast<T*>(out);
  p.dout = static_cast<T*>(dout);
  p.nx = nx;
  p.ny = ny;
  p.nz = nz;
  Strides* strides[7] = {&p.su, &p.sc, &p.sf, &p.sdia, &p.sd, &p.sm, &p.ss};
  for (int q = 0; q < 7; ++q) {
    *strides[q] = Strides{st[4 * q], st[4 * q + 1], st[4 * q + 2], st[4 * q + 3]};
  }
  for (int q = 0; q < 3; ++q) p.rh2[q] = T(1) / T(h2[q]);
  p.omega = T(omega);
  p.a = T(a);
  p.b = T(b);
  p.first = first;
  return launch<T>(op, sd, p, grid, block, stream);
}

}  // namespace

// op: 0 = apply (K2), 1 = residual (K3), 2 = jacobi (K4), 3 = cheb (K5).
// dtype: 0 = float32, 2 = float64 (the codes of heat_step.cu).  sd: -1 for
// cell centers, else the stagger dim of the face location (0, 1, 2).  Inputs
// an op does not read may be null; m is the face ops' interior mask; s is
// the center ops' Helmholtz shift (null: no shift; a face op refuses one).
// strides: 28 element strides, (batch, x, y, z) for u, c, f, dia, d, m and s
// in turn.  h2: h_x^2, h_y^2, h_z^2.  first: K5's first step (a is not used and
// d is not read).  grid and block are the caller's launch plan
// (kernels/plans.py::cell_plan: grid (z tiles, y tiles, x tiles * nb)); a
// block other than (kTz, kTy, kTx) is refused.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int repro_solver3d(int op, int dtype, int sd, const void* u, const void* c,
                              const void* f, const void* dia, const void* d, const void* m,
                              const void* s, void* out, void* dout, int nb, int nx, int ny, int nz,
                              const long long* strides, const double* h2, double omega, double a,
                              double b, int first, int gx, int gy, int gz, int bx, int by, int bz,
                              void* stream) {
  if (nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const dim3 grid(gx, gy, gz), block(bx, by, bz);
  switch (dtype) {
    case 0:
      return run<float>(op, sd, u, c, f, dia, d, m, s, out, dout, nx, ny, nz, strides, h2,
                        omega, a, b, first, grid, block, cs);
    case 2:
      return run<double>(op, sd, u, c, f, dia, d, m, s, out, dout, nx, ny, nz, strides, h2,
                         omega, a, b, first, grid, block, cs);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
