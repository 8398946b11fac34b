// Helpers shared by the grid-stride kernels of elementwise.cu and the
// persistent grid of fir.cu.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace tina {

// Streaming multiprocessors of the current device (an H100 SXM's 132 if
// the query fails), asked once per device: a process may launch on
// several cards, each under its own current device.
inline int sm_count() {
  static std::atomic<int> sms[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  int n = dev < 64 ? sms[dev].load(std::memory_order_relaxed) : 0;
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 132;
    if (dev < 64) sms[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// Blocks of `threads` for a grid-stride loop over n elements: one per
// `threads` elements, at most four full waves of the card (2048 resident
// threads per SM).
inline unsigned grid_stride_blocks(long long n, int threads) {
  const long long want = (n + threads - 1) / threads;
  const long long cap = (long long)sm_count() * (2048 / threads) * 4;
  return (unsigned)(want < cap ? want : cap);
}

}  // namespace tina
