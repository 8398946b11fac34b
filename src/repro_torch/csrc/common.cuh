// Helpers shared by the grid-stride kernels of elementwise.cu and the
// persistent grid of fir.cu.
#pragma once

#include <cuda_runtime.h>

namespace tina {

// Streaming multiprocessors of the current device (an H100 SXM's 132 if
// the query fails), asked once.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
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
