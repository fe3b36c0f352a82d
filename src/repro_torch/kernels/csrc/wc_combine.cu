// wc_combine: run boundaries and in-run rank over a SORTED int32 key array
// (the materialized wait queues of CIDER §4.2: is_first = queue head /
// coordinator, is_last = queue tail / executor, rank = position in queue).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wc_combine/wc_combine.py
// (wc_combine, pallas_call at :69) and its padded wrapper ops.py:22.
//
// The TPU kernel walks the blocks in grid order and carries (previous key,
// run length) from one block to the next in SMEM.  Hopper runs blocks in no
// order, so this kernel carries nothing: each thread owns one element,
//   is_first[i] = i == 0   || k[i] != k[i-1]
//   is_last[i]  = i == N-1 || k[i] != k[i+1]
//   rank[i]     = i - lower_bound(k, k[i])      (binary search in [0, i])
// which gives the stitched outputs of the TPU wrapper directly, for any N,
// with no padding.
//
// Bound: 10 bytes per element (4 in, 1 + 1 + 4 out) over 3.35 TB/s; the
// neighbour loads hit the same lines as the coalesced own-element load, and
// the binary search of a non-head element reads O(log run) lines that stay
// in L2.  At the engine's sizes (N = 4096 per window) the launch itself
// dominates the bound by orders of magnitude.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
wc_combine_kernel(const int* __restrict__ keys, uint8_t* __restrict__ first,
                  uint8_t* __restrict__ last, int* __restrict__ rank, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int k = keys[i];
  const bool f = (i == 0) || (keys[i - 1] != k);
  const bool l = (i == n - 1) || (keys[i + 1] != k);
  int start = i;
  if (!f) {
    // first index in [0, i) whose key is >= k; keys[i] == k bounds it
    int lo = 0, hi = i;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (keys[mid] < k) lo = mid + 1; else hi = mid;
    }
    start = lo;
  }
  first[i] = f;
  last[i] = l;
  rank[i] = i - start;
}

}  // namespace

extern "C" int wc_combine_launch(int device, const int* keys, uint8_t* first,
                                 uint8_t* last, int* rank, int n,
                                 cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    wc_combine_kernel<<<blocks, kThreads, 0, stream>>>(keys, first, last,
                                                       rank, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
