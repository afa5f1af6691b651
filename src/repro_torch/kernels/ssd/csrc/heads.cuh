// The heads per block of K7's kernels (ssd.cu) and of its backward's
// (ssd_bwd.cu), one rule, which kernels/plans.py::_ssd_grid mirrors: the
// largest divisor HS of the heads per group H / G, at most kMaxHS, that
// leaves at least two blocks per SM (else one head).  A block takes HS heads
// of one group of one (batch, chunk), so that it loads B and C and forms
// C B^T once for them.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kMaxHS = 8;

inline int heads_per_block(int Ba, int H, int G, int nc, int sms) {
  const int R = H / G;
  const long long groups = static_cast<long long>(Ba) * nc * G;
  for (int hs = std::min(R, kMaxHS); hs > 1; --hs)
    if (R % hs == 0 && groups * (R / hs) >= 2LL * sms) return hs;
  return 1;
}

// The current device's SM count; returns the CUDA error code.
inline int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
}

}  // namespace
