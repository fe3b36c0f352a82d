// wc_combine: run boundaries and in-run rank over a SORTED int32 key array
// (the materialized wait queues of CIDER §4.2: is_first = queue head /
// coordinator, is_last = queue tail / executor, rank = position in queue).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wc_combine/wc_combine.py
// (wc_combine, pallas_call at :69) and its padded wrapper ops.py:22.
//
// The TPU kernel walks the blocks in grid order and carries (previous key,
// run length) from one block to the next in SMEM.  Hopper runs blocks in no
// order, so nothing is carried between blocks.  One launch, a tiled single
// pass: each block owns a tile of kTile = 128 threads x 4 keys = 512
// consecutive keys (8 blocks at the engine's N = 4096, 2,048 at 2^20; the
// short per-thread chain is worth more than fewer, larger tiles at every
// N), and every global read of the block is issued in one round:
//   * each thread loads its keys with int4 loads; lane 0 of each warp also
//     loads the key before the warp's span, lane 31 the key after it (the
//     tile's halo keys k[tile_start - 1] and k[tile_end] among them); warp 0
//     loads the 32 keys before the tile, the window its run search starts
//     from;
//   * is_first / is_last compare each key with its neighbours: in
//     registers, from the neighbouring lanes by shuffles, or the loaded
//     edge keys;
//   * rank[i] = i - start(i), start(i) = the last run head at or before i:
//     a thread-serial max-scan of head indices, a warp max-scan with
//     __shfl_up_sync, and one __syncthreads to combine the warp totals.
//     When the tile's first key continues a run of an earlier tile, ONE
//     warp of the block finds that run's start: in the 32-key window when
//     the run starts there (one ballot, no further read), else by a
//     cooperative search over [0, tile_start - 32] in which each step's 32
//     lanes probe 32 evenly spaced keys and ballot, about log32(N)
//     dependent reads (3 at N = 2^15, 4 at 2^20).  The keys are sorted, so
//     the start comes from the data and no block waits on another;
//   * is_first and is_last are stored as one 4-byte word of flags a thread
//     (a warp's store covers 128 contiguous bytes), rank with int4 stores; a
//     ragged last tile (and any input off 16-byte boundaries) takes the
//     scalar path for its partial threads.
//
// Bound: 10 bytes per element (4 in, 1 + 1 + 4 out) over 3.35 TB/s: 12 ns at
// the engine's N = 4096, where one launch's own latency (~1 us) sets the
// time; 3.1 us at 2^20.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 4;          // one int4 of keys, one flag word
constexpr int kTile = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The first index in [0, hi] whose key is >= key, given keys[hi] == key:
// the start of key's run.  Called by one whole warp; every lane returns it.
// Each step the 32 lanes probe 32 evenly spaced keys of [lo, hi] (lane 31
// probes hi) and ballot; the first lane that sees a key >= key narrows the
// span to (its left neighbour's probe, its own probe].
__device__ int warp_run_start(const int* __restrict__ keys, int hi, int key) {
  const int lane = threadIdx.x & 31;
  int lo = 0;
  while (lo < hi) {
    const long long len = hi - lo;
    const int p = lo + static_cast<int>((len * (lane + 1)) >> 5);
    const unsigned ge = __ballot_sync(kFull, __ldg(keys + p) >= key);
    const int c = __ffs(ge) - 1;                  // lane 31 sees keys[hi]
    const int p_c = __shfl_sync(kFull, p, c);
    const int p_before = __shfl_sync(kFull, p, c > 0 ? c - 1 : 0);
    lo = c > 0 ? p_before + 1 : lo;
    hi = p_c;
  }
  return lo;
}

// The four flags in `bits` as four one-byte values, in one 4-byte store.
__device__ __forceinline__ void store_flags(uint8_t* dst, uint32_t bits) {
  *reinterpret_cast<uint32_t*>(dst) =
      (bits & 1u) | (((bits >> 1) & 1u) << 8) | (((bits >> 2) & 1u) << 16) |
      (((bits >> 3) & 1u) << 24);
}

__global__ void __launch_bounds__(kThreads)
wc_combine_kernel(const int* __restrict__ keys, uint8_t* __restrict__ first,
                  uint8_t* __restrict__ last, int* __restrict__ rank, int n,
                  int aligned) {
  __shared__ int s_warp_max[kWarps];     // each warp's last head index
  __shared__ int s_carry;                // start of the tile's first run
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wid = t >> 5;
  const int tile = blockIdx.x * kTile;
  const int base = tile + t * kPerThread;
  const int cnt = max(0, min(kPerThread, n - base));
  const bool vec = aligned && cnt == kPerThread;

  // every read of the block, in one round
  int k[kPerThread];
  if (vec) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(keys + base));
    k[0] = v.x; k[1] = v.y; k[2] = v.z; k[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      k[j] = j < cnt ? keys[base + j] : 0;
  }
  const int edge_before = lane == 0 && base > 0 && cnt > 0
                              ? __ldg(keys + base - 1) : 0;
  const int edge_after = lane == 31 && cnt == kPerThread &&
                                 static_cast<long long>(base) + kPerThread < n
                             ? __ldg(keys + base + kPerThread) : 0;
  const int window = wid == 0 && tile > 0 ? __ldg(keys + tile - 32 + lane)
                                          : 0;

  int tail = k[0];
#pragma unroll
  for (int j = 1; j < kPerThread; ++j)
    if (j < cnt) tail = k[j];
  int prev = __shfl_up_sync(kFull, tail, 1);
  int next = __shfl_down_sync(kFull, k[0], 1);
  if (lane == 0) prev = edge_before;
  if (lane == 31) next = edge_after;

  // one warp: where does the run holding the tile's first key start?
  if (wid == 0) {
    int carry = -1;
    const int key0 = __shfl_sync(kFull, k[0], 0);
    if (tile > 0 && __shfl_sync(kFull, window, 31) == key0) {
      const unsigned in_run = __ballot_sync(kFull, window == key0);
      carry = (in_run & 1u) ? warp_run_start(keys, tile - 32, key0)
                            : tile - 32 + __ffs(in_run) - 1;
    }
    if (lane == 0) s_carry = carry;
  }

  uint32_t fbits = 0, lbits = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = base + j;
    const int kp = j == 0 ? prev : k[j - 1];
    const int kn = j == kPerThread - 1 ? next : k[j + 1];
    fbits |= static_cast<uint32_t>(i == 0 || kp != k[j]) << j;
    lbits |= static_cast<uint32_t>(i == n - 1 || kn != k[j]) << j;
  }
  // thread-serial max-scan of head indices (they grow with i)
  int hm[kPerThread];
  int run = -1;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (j < cnt && ((fbits >> j) & 1u)) run = base + j;
    hm[j] = run;
  }
  // warp max-scan of the threads' last heads, then the block's warps
  int incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = max(incl, o);
  }
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = -1;
  if (lane == 31) s_warp_max[wid] = incl;
  __syncthreads();
  int pre = s_carry;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    if (w < wid) pre = max(pre, s_warp_max[w]);
  pre = max(pre, excl);

  int r[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) r[j] = base + j - max(pre, hm[j]);

  if (vec) {
    store_flags(first + base, fbits);
    store_flags(last + base, lbits);
    *reinterpret_cast<int4*>(rank + base) = make_int4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (j < cnt) {
        first[base + j] = (fbits >> j) & 1u;
        last[base + j] = (lbits >> j) & 1u;
        rank[base + j] = r[j];
      }
    }
  }
}

}  // namespace

// One launch of ceil(n / kTile) blocks; none for n == 0.
extern "C" int wc_combine_launch(int device, const int* keys, uint8_t* first,
                                 uint8_t* last, int* rank, int n,
                                 cudaStream_t stream) {
  // a launch goes to the calling thread's current device, which need not
  // be the tensors'
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int aligned =
        ((reinterpret_cast<uintptr_t>(keys) | reinterpret_cast<uintptr_t>(first) |
          reinterpret_cast<uintptr_t>(last) | reinterpret_cast<uintptr_t>(rank)) &
         15) == 0;
    const int blocks =
        static_cast<int>((static_cast<long long>(n) + kTile - 1) / kTile);
    wc_combine_kernel<<<blocks, kThreads, 0, stream>>>(keys, first, last,
                                                       rank, n, aligned);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
