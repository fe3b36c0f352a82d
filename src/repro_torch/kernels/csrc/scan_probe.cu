// scan_probe: the fused SCAN reader-probe sweep of engine step 5c.  Over
// lanes SORTED by (key, pos), per lane:
//   e_before[i] = existence just before lane i: the setcode of the last
//                 setter (setcode >= 0) strictly before i in its key run,
//                 else e_init[i];
//   waits[i]    = writer lanes strictly before i in its key run.
//
// Replaces the Pallas TPU kernel src/repro/kernels/scan_probe/scan_probe.py
// (scan_probe, pallas_call at :84) and its padded wrapper ops.py:22.
//
// The TPU kernel walks the blocks in grid order with an SMEM carry of (last
// key, last setcode of the open run, writers in the open run).  Hopper runs
// blocks in no order, so the carry becomes a device-wide SEGMENTED scan:
// element i is (head = is_first[i], w = writer[i], c = setcode or -1) and
//   a (+) b = (a.head | b.head,
//              b.head ? b.w : a.w + b.w,
//              b.head ? b.c : (b.c >= 0 ? b.c : a.c))
// is associative with identity (0, 0, -1).  The EXCLUSIVE scan at a lane
// that is not a run head gives exactly (writers in [start, i), last setter
// in [start, i)).  Three launches:
//   (a) scan_probe_reduce: each 1024-lane tile's aggregate;
//   (b) scan_probe_prefix: one block scans the tile aggregates (exclusive);
//   (c) scan_probe_apply:  each tile scans itself again, adds its prefix and
//       writes both outputs.
// A single-pass decoupled look-back would read the inputs once instead of
// twice; this is the simple form.
//
// Bound: 15 bytes per lane (4 key + 4 setcode + 1 writer + 1 e_init in,
// 1 + 4 out) over 3.35 TB/s.  At the engine's sizes (34,816 - 69,632 lanes)
// the bound is ~0.3 us and the three launches dominate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;          // lanes per block, one per thread
constexpr unsigned kFull = 0xffffffffu;

struct Seg {
  int head;   // a run head lies in the span
  int w;      // writers since the span's last head (or its start)
  int c;      // last setcode >= 0 since the span's last head, else -1
};

__device__ __forceinline__ Seg seg_identity() { return Seg{0, 0, -1}; }

// a covers the lanes before b's
__device__ __forceinline__ Seg seg_combine(const Seg& a, const Seg& b) {
  Seg r;
  r.head = a.head | b.head;
  r.w = b.head ? b.w : a.w + b.w;
  r.c = b.head ? b.c : (b.c >= 0 ? b.c : a.c);
  return r;
}

__device__ __forceinline__ Seg load_lane(const int* __restrict__ keys,
                                         const int* __restrict__ setcode,
                                         const uint8_t* __restrict__ writer,
                                         int i, int n) {
  if (i >= n) return seg_identity();
  const int k = keys[i];
  const int sc = setcode[i];
  Seg s;
  s.head = (i == 0) || (keys[i - 1] != k);
  s.w = writer[i] ? 1 : 0;
  s.c = sc >= 0 ? sc : -1;
  return s;
}

__device__ __forceinline__ Seg warp_inclusive(Seg v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    Seg o;
    o.head = __shfl_up_sync(kFull, v.head, off);
    o.w = __shfl_up_sync(kFull, v.w, off);
    o.c = __shfl_up_sync(kFull, v.c, off);
    if (lane >= off) v = seg_combine(o, v);
  }
  return v;
}

// Inclusive scan over the block's kTile threads; every thread must call it.
__device__ Seg block_inclusive(Seg v, Seg* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  v = warp_inclusive(v);
  if (lane == 31) warp_tot[wid] = v;
  __syncthreads();
  if (wid == 0) {
    Seg t = warp_inclusive(warp_tot[lane]);   // kTile / 32 == 32 warps
    warp_tot[lane] = t;
  }
  __syncthreads();
  if (wid > 0) v = seg_combine(warp_tot[wid - 1], v);
  return v;
}

__global__ void __launch_bounds__(kTile)
scan_probe_reduce(const int* __restrict__ keys, const int* __restrict__ setcode,
                  const uint8_t* __restrict__ writer, int n,
                  int* __restrict__ agg) {
  __shared__ Seg warp_tot[32];
  const int i = blockIdx.x * kTile + threadIdx.x;
  const Seg v = block_inclusive(load_lane(keys, setcode, writer, i, n),
                                warp_tot);
  if (threadIdx.x == kTile - 1) {
    agg[3 * blockIdx.x + 0] = v.head;
    agg[3 * blockIdx.x + 1] = v.w;
    agg[3 * blockIdx.x + 2] = v.c;
  }
}

__global__ void __launch_bounds__(kTile)
scan_probe_prefix(const int* __restrict__ agg, int* __restrict__ prefix,
                  int n_tiles) {
  __shared__ Seg warp_tot[32];
  __shared__ Seg incl[kTile];
  Seg carry = seg_identity();
  for (int base = 0; base < n_tiles; base += kTile) {
    const int j = base + threadIdx.x;
    Seg v = seg_identity();
    if (j < n_tiles) v = Seg{agg[3 * j], agg[3 * j + 1], agg[3 * j + 2]};
    incl[threadIdx.x] = block_inclusive(v, warp_tot);
    __syncthreads();
    if (j < n_tiles) {
      const Seg ex = threadIdx.x == 0
                         ? carry : seg_combine(carry, incl[threadIdx.x - 1]);
      prefix[3 * j + 0] = ex.head;
      prefix[3 * j + 1] = ex.w;
      prefix[3 * j + 2] = ex.c;
    }
    carry = seg_combine(carry, incl[kTile - 1]);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kTile)
scan_probe_apply(const int* __restrict__ keys, const int* __restrict__ setcode,
                 const uint8_t* __restrict__ writer,
                 const uint8_t* __restrict__ e_init, int n,
                 const int* __restrict__ prefix, uint8_t* __restrict__ e_before,
                 int* __restrict__ waits) {
  __shared__ Seg warp_tot[32];
  __shared__ Seg incl[kTile];
  const int i = blockIdx.x * kTile + threadIdx.x;
  const Seg lane = load_lane(keys, setcode, writer, i, n);
  incl[threadIdx.x] = block_inclusive(lane, warp_tot);
  __syncthreads();
  if (i >= n) return;
  const int t = 3 * blockIdx.x;
  const Seg tile_prefix = Seg{prefix[t], prefix[t + 1], prefix[t + 2]};
  const Seg ex = threadIdx.x == 0
                     ? tile_prefix
                     : seg_combine(tile_prefix, incl[threadIdx.x - 1]);
  const uint8_t e0 = e_init[i] ? 1 : 0;
  if (lane.head) {           // nothing of my run lies before me
    waits[i] = 0;
    e_before[i] = e0;
  } else {                   // ex spans [start, i) of my run
    waits[i] = ex.w;
    e_before[i] = ex.c >= 0 ? static_cast<uint8_t>(ex.c & 1) : e0;
  }
}

}  // namespace

// agg and prefix: scratch of 3 * ceil(n / 1024) int32 each.
extern "C" int scan_probe_launch(int device, const int* keys,
                                 const int* setcode, const uint8_t* writer,
                                 const uint8_t* e_init, uint8_t* e_before,
                                 int* waits, int* agg, int* prefix, int n,
                                 cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int n_tiles = (n + kTile - 1) / kTile;
  scan_probe_reduce<<<n_tiles, kTile, 0, stream>>>(keys, setcode, writer, n,
                                                   agg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_probe_prefix<<<1, kTile, 0, stream>>>(agg, prefix, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_probe_apply<<<n_tiles, kTile, 0, stream>>>(keys, setcode, writer,
                                                  e_init, n, prefix, e_before,
                                                  waits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
