// Kernel K6 of the port: causal sliding-window GQA flash attention.
//
// Replaces the TPU kernel src/repro/kernels/swa/kernel.py:37,90
// (_swa_kernel / swa_pallas) and computes the function of its plain
// version (kernels/swa/ref.py::swa_ref): query i (absolute position
// i + S - T, the queries being the last T of the S keys) attends to the
// keys j with  qpos - w < j <= qpos,  w = min(window, S), so w = S is
// plain causal attention.  q head h reads kv head h / (H / Hkv): grouped
// k/v are read as they are, never repeated per head.
//
// Arithmetic.  q (scaled by `scale` on load), k and v are taken to float32;
// the products, the online softmax (m, l, acc) and the final division are
// float32; the output is rounded once to q's type.  The mask is a select,
// never a product: a masked logit becomes NEG_INF = -1e30 before the row
// maximum and its weight is set to 0 (so a kv tile that is masked for a
// whole row adds nothing), and a row whose l stayed 0 divides by 1.
//
// Layouts.  q (B, H, T, D), k and v (B, Hkv, S, D) come with their batch,
// head and time strides (D contiguous): the model passes transposed views
// of its (B, T, H, D) projections without a copy.  The output is written
// with the strides the launcher gives (the launcher allocates (B, T, H, D)).
//
// Bound.  At gemma3-4b's prefill (B 4, H 8, Hkv 4, T = S = 2048, D 256,
// bf16) the bytes (q and o 33.5 MB, k and v 33.5 MB) take 0.020 ms at
// 3.35 TB/s; the unmasked pairs (1.57 M per head at window 1024, 2.10 M
// global) need 4 D FLOP each: 51.6 / 68.7 GFLOP, 0.052 / 0.069 ms on the
// bf16 tensor cores, 0.77 / 1.03 ms on the float32 CUDA cores.  So
// operations bound it.
//
// Design (a simple first form, CUDA cores, float32).  One block of 256
// threads per (q tile of 64 rows, batch x head).  The block walks only the
// kv tiles of 64 keys that meet [q_lo - w + 1, q_hi]; Q (scaled), K, V and
// P live in dynamic shared memory as float32 rows padded to D + 4 (212 KB at
// D 256, one block per SM).  Thread (ti, tj) = (tid / 16, tid % 16) owns
// rows ti + 16 a (a < 4): it computes logits of columns tj + 16 c (c < 4)
// with float4 reads (a row of 8 lanes reads 8 distinct K rows, conflict
// free; Q reads are broadcasts), reduces the row maximum and sum over its
// 16 lanes with shuffles, and accumulates the output columns of the
// float4 chunks tj + 16 n (n < NC = ceil(D / 64)) in registers (64 at
// D 256).  Ragged edges: Q rows past T and K/V rows past S are zero in
// shared memory and masked; output rows past T are never written.  Tensor
// cores (wgmma on bf16 tiles, TMA loads) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

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
  int H, Hkv, T, S, D, w;
  float scale;
  long long qb, qh, qt;  // q strides (elements): batch, head, time
  long long kb, kh, ks;  // k
  long long vb, vh, vs;  // v
  long long ob, oh, ot;  // output
};

// floats of dynamic shared memory: Q, K, V (64 rows of D + 4 each) and P
// (64 x 68)
__host__ __device__ inline size_t smem_floats(int D) {
  return 3 * static_cast<size_t>(kBQ) * (D + 4) + static_cast<size_t>(kBQ) * (kBK + 4);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 1)
swa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, Dims d) {
  extern __shared__ __align__(16) float sm[];
  const int D = d.D, LD = D + 4, LP = kBK + 4;
  float* qs = sm;              // [kBQ][LD]
  float* ks = qs + kBQ * LD;   // [kBK][LD]
  float* vs = ks + kBK * LD;   // [kBK][LD]
  float* ps = vs + kBK * LD;   // [kBQ][LP]
  const int b = blockIdx.y / d.H, h = blockIdx.y - (blockIdx.y / d.H) * d.H;
  const int hk = h / (d.H / d.Hkv);
  const int i0 = blockIdx.x * kBQ;
  const int s_off = d.S - d.T;
  const int tid = threadIdx.x, ti = tid >> 4, tj = tid & 15;

  // ---- the q tile, scaled, float32; rows past T are zero ------------------
  const T* qg = q + b * d.qb + h * d.qh;
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e - r * D, i = i0 + r;
    qs[r * LD + c] = i < d.T ? up(qg[i * d.qt + c]) * d.scale : 0.f;
  }

  // ---- the kv tiles that meet the window of some row of this tile ---------
  const int q_lo = i0 + s_off;
  const int q_hi = min(i0 + kBQ, d.T) - 1 + s_off;
  const int kv_lo = max(0, q_lo - d.w + 1);
  const T* kg = k + b * d.kb + hk * d.kh;
  const T* vg = v + b * d.vb + hk * d.vh;

  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;
  }

  for (int j0 = (kv_lo / kBK) * kBK; j0 <= q_hi; j0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e - r * D, j = j0 + r;
      const bool in = j < d.S;
      ks[r * LD + c] = in ? up(kg[j * d.ks + c]) : 0.f;
      vs[r * LD + c] = in ? up(vg[j * d.vs + c]) : 0.f;
    }
    __syncthreads();

    // logits of rows ti + 16 a, columns tj + 16 c
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
    for (int dd = 0; dd < D; dd += 4) {
      float4 qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = *reinterpret_cast<const float4*>(qs + (ti + 16 * a) * LD + dd);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kc[c] = *reinterpret_cast<const float4*>(ks + (tj + 16 * c) * LD + dd);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float t = s[a][c];
          t = fmaf(qa[a].x, kc[c].x, t);
          t = fmaf(qa[a].y, kc[c].y, t);
          t = fmaf(qa[a].z, kc[c].z, t);
          s[a][c] = fmaf(qa[a].w, kc[c].w, t);
        }
    }

    // online softmax: the mask selects, the row statistics reduce over the
    // 16 lanes that share a row
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ti + 16 * a;
      const int qpos = i0 + r + s_off;
      const bool row_in = i0 + r < d.T;
      bool mk[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = j0 + tj + 16 * c;
        mk[c] = row_in && kpos < d.S && kpos <= qpos && kpos > qpos - d.w;
        s[a][c] = mk[c] ? s[a][c] : kNegInf;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = mk[c] ? expf(s[a][c] - m_new) : 0.f;
        ps[r * LP + tj + 16 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[a] - m_new);
      l[a] = alpha * l[a] + rs;
      m[a] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][n][e] *= alpha;
    }
    __syncthreads();

    // acc += P V on the output chunks tj + 16 n
    for (int j = 0; j < kBK; ++j) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = ps[(ti + 16 * a) * LP + j];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int col = 4 * (tj + 16 * n);
        if (col < D) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + j * LD + col);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc[a][n][0] = fmaf(pa[a], vv.x, acc[a][n][0]);
            acc[a][n][1] = fmaf(pa[a], vv.y, acc[a][n][1]);
            acc[a][n][2] = fmaf(pa[a], vv.z, acc[a][n][2]);
            acc[a][n][3] = fmaf(pa[a], vv.w, acc[a][n][3]);
          }
        }
      }
    }
  }

  // ---- out = acc / l (l == 0 divides by 1); rows past T are not written --
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ti + 16 * a;
    if (i >= d.T) continue;
    const float den = l[a] == 0.f ? 1.f : l[a];
    T* og = o + b * d.ob + h * d.oh + i * d.ot;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = 4 * (tj + 16 * n);
      if (col < D) {
#pragma unroll
        for (int e = 0; e < 4; ++e) og[col + e] = down<T>(acc[a][n][e] / den);
      }
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int B, const Dims& d,
           cudaStream_t stream) {
  const size_t bytes = smem_floats(d.D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(swa_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((d.T + kBQ - 1) / kBQ, B * d.H);
  swa_kernel<T, NC><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, int B, const Dims& d,
        cudaStream_t stream) {
  switch ((d.D + 63) / 64) {
    case 1:
      return launch<T, 1>(q, k, v, o, B, d, stream);
    case 2:
      return launch<T, 2>(q, k, v, o, B, d, stream);
    case 3:
      return launch<T, 3>(q, k, v, o, B, d, stream);
    case 4:
      return launch<T, 4>(q, k, v, o, B, d, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (q, k, v and the output).  strides: the
// batch, head and time strides of q, k, v and the output, in that order.
// w: the window, at most S.  Returns the CUDA error code of the launch
// (0: launched).
extern "C" int repro_swa_attention(int dtype, const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int Hkv, int T, int S, int D, int w,
                                   float scale, const long long* strides, void* stream) {
  if (D <= 0 || D > kMaxD || D % 4 != 0 || H % Hkv != 0 || T < 1 || S < T || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{H, Hkv, T, S, D, w, scale,
               strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
               strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return run<float>(q, k, v, o, B, d, st);
    case 1:
      return run<__nv_bfloat16>(q, k, v, o, B, d, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
