// The rate of mma.sync.m16n8k8 in TF32 (float32 accumulators) that one
// card reaches: every SM runs warps that issue independent chains of
// products on registers, so no load and no dependency holds them back.
// The port's 3xTF32 kernels (K6, K7, their backwards) are built from this
// instruction; chip_smoke.py states their bounds at the data sheet's dense
// TF32 peak (TF32_FLOP_PER_S), and this measures what the instruction gives.
//
// Build and run on the card (sm_90a):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o tf32_mma_rate tools/tf32_mma_rate.cu
//   ./tf32_mma_rate
// Prints one line per (chains, warps per block, blocks per SM): the time,
// TFLOP/s (2 x 16 x 8 x 8 FLOP per product and warp) and the cycles per
// product per SM sub-partition.
#include <cstdint>
#include <cstdio>

#include <cuda_runtime.h>

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// C independent accumulator chains per warp, iters rounds of C products.
template <int C>
__global__ void bench(float* out, long long* cyc, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + i);
  float d[C][4] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < C; ++c) mma(d[c], a, b);
  }
  const long long t1 = clock64();
  float s = 0;
  for (int c = 0; c < C; ++c) s += d[c][0] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the products live
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}

template <int C>
void run(int warps, int blocks_per_sm) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int blocks = sms * blocks_per_sm, threads = 32 * warps, iters = 4096;
  float* out;
  long long* cyc;
  cudaMalloc(&out, blocks * threads * sizeof(float));
  cudaMalloc(&cyc, blocks * sizeof(long long));
  bench<C><<<blocks, threads>>>(out, cyc, 16);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  bench<C><<<blocks, threads>>>(out, cyc, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0;
  cudaEventElapsedTime(&ms, e0, e1);
  long long c0 = 0;
  cudaMemcpy(&c0, cyc, sizeof(long long), cudaMemcpyDeviceToHost);
  const double products = static_cast<double>(blocks) * warps * iters * C;
  printf("chains %2d warps/block %2d blocks/SM %d: %.3f ms, %.2f TFLOP/s tf32, "
         "cycles per product per SM sub-partition %.2f\n",
         C, warps, blocks_per_sm, ms, products * 2048 / ms / 1e9,
         static_cast<double>(c0) / (products / sms / 4));
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(out);
  cudaFree(cyc);
}

int main() {
  for (int w : {4, 8, 16}) {
    run<1>(w, 1);
    run<4>(w, 1);
    run<8>(w, 1);
    run<16>(w, 1);
  }
  run<4>(4, 2);
  run<8>(4, 2);
  run<12>(8, 2);
  const cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    printf("CUDA error: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
