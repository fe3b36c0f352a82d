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
// element i is (head = is_first[i], w = writer[i], c = setcode & 1 for a
// setter, else -1) and
//   a (+) b = (a.head | b.head,
//              b.head ? b.w : a.w + b.w,
//              b.head ? b.c : (b.c >= 0 ? b.c : a.c))
// is associative with identity (0, 0, -1).  The EXCLUSIVE scan at a lane
// that is not a run head gives exactly (writers in [start, i), last setter
// in [start, i)).
//
// One launch, a single pass with decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016).
// A tile is kTile = 128 threads x 4 lanes = 512 lanes (68 blocks at the
// engine's N = 34,816, 136 at 69,632, 2,048 at 2^20): the short
// per-thread chain is worth more than fewer tiles at every N.
//   * Each block takes its tile from a ticket counter (tile =
//     atomicInc(ctr, gridDim.x - 1), so the launch's last ticket wraps the
//     counter back to 0 for the next launch, with no count kept on the
//     host), and a block waits only on tiles whose blocks have already
//     started: no deadlock however many tiles there are.
//   * It loads its lanes once (keys and setcode as int4, writer and e_init
//     as one 4-byte word of flags a thread) plus, in lane 0 of each warp,
//     the key before the warp's span (the tile's halo key for warp 0);
//     reduces them thread-serial, scans across the warp and the block, and
//     at once publishes the tile's aggregate as ONE 64-bit status word
//     (flag, head, c + 1, w in 31 bits, the call's epoch) with a release
//     store.  A tile that holds a run head publishes it
//     as its inclusive prefix at once: the head cuts the segment, so
//     nothing before it can change it.
//   * Only when its first lane continues a run of the tile before does warp
//     0 look back over 32 predecessors at a time (acquire loads), waiting
//     only for the words up to the nearest stop: the first inclusive prefix
//     or the first aggregate with head = 1.  So the look-back is never
//     deeper than the run, in tiles.  The tile's inclusive prefix is
//     published once the block has its exclusive prefix.
//   * A status word of an earlier call carries an older epoch and reads as
//     not ready, so no memset is launched between calls; the host zeroes
//     the words when it grows them and when the epoch wraps.
//   * It applies the exclusive prefix lane by lane and stores e_before as
//     one 4-byte word of flags a thread, waits with int4 stores.
//
// Bound: 15 bytes per lane (4 key + 4 setcode + 1 writer + 1 e_init in,
// 1 + 4 out) over 3.35 TB/s: 0.31 us at the engine's N = 69,632, where the
// chain of dependent round trips (ticket, loads, the predecessor's status
// word) sets the time; 4.7 us at 2^20.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 4;     // one int4 of keys and of setcodes, one
                                  // word of flags
constexpr int kTile = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// status word: flag (bits 0-1), head (2), c + 1 (3-4), w (5-35), epoch (36-63)
constexpr unsigned long long kFlagAggregate = 1;
constexpr unsigned long long kFlagPrefix = 2;
constexpr int kEpochShift = 36;

struct Seg {
  int head;   // a run head lies in the span
  int w;      // writers since the span's last head (or its start)
  int c;      // the bit of the span's last setter since its last head,
              // else -1
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

__device__ __forceinline__ unsigned long long pack_status(
    unsigned long long flag, const Seg& s, unsigned epoch) {
  return flag | (static_cast<unsigned long long>(s.head) << 2) |
         (static_cast<unsigned long long>(s.c + 1) << 3) |
         (static_cast<unsigned long long>(static_cast<unsigned>(s.w)) << 5) |
         (static_cast<unsigned long long>(epoch) << kEpochShift);
}

__device__ __forceinline__ Seg unpack_status(unsigned long long s) {
  return Seg{static_cast<int>((s >> 2) & 1),
             static_cast<int>((s >> 5) & 0x7fffffffull),
             static_cast<int>((s >> 3) & 3) - 1};
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// Four one-byte flags as four bits (one 4-byte load), and back (one store).
__device__ __forceinline__ uint32_t load_flags(const uint8_t* src) {
  const uint32_t word = __ldg(reinterpret_cast<const unsigned*>(src));
  uint32_t b = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    b |= static_cast<uint32_t>(((word >> (8 * j)) & 0xffu) != 0) << j;
  return b;
}

__device__ __forceinline__ void store_flags(uint8_t* dst, uint32_t bits) {
  *reinterpret_cast<uint32_t*>(dst) =
      (bits & 1u) | (((bits >> 1) & 1u) << 8) | (((bits >> 2) & 1u) << 16) |
      (((bits >> 3) & 1u) << 24);
}

// Inside a tile w <= kTile, so a Seg fits one 32-bit shuffle.
__device__ __forceinline__ int pack32(const Seg& s) {
  return (s.w << 3) | ((s.c + 1) << 1) | s.head;
}

__device__ __forceinline__ Seg unpack32(int v) {
  return Seg{v & 1, v >> 3, ((v >> 1) & 3) - 1};
}

__device__ __forceinline__ Seg shfl_seg(const Seg& s, int src) {
  return Seg{__shfl_sync(kFull, s.head, src), __shfl_sync(kFull, s.w, src),
             __shfl_sync(kFull, s.c, src)};
}

// The combined status of the tiles before `tile`, back to (and including)
// the nearest one that published its inclusive prefix or holds a run head.
// Called by one whole warp; every lane returns it.  Lane l reads tile
// `pred - l`, so 32 predecessors are read at once, nearest in lane 0; the
// warp waits only for the words up to the nearest stop.
__device__ __forceinline__ Seg look_back(const unsigned long long* status,
                                         int tile, unsigned epoch) {
  const int lane = threadIdx.x & 31;
  Seg acc = seg_identity();          // tiles (pred, tile), combined
  for (int pred = tile - 1;; pred -= 32) {
    const int j = pred - lane;
    unsigned long long s = 0;
    bool ready = j < 0;              // before tile 0: an empty prefix
    bool stop = j < 0;
    unsigned stops;
    for (;;) {                       // each word's block holds an earlier
      if (!ready) {                  // ticket, so it is written soon
        s = load_acquire(status + j);
        ready = (s >> kEpochShift) == epoch && (s & 3) != 0;
        stop = ready && ((s & 3) == kFlagPrefix || ((s >> 2) & 1));
      }
      const unsigned readies = __ballot_sync(kFull, ready);
      stops = __ballot_sync(kFull, stop);
      const unsigned need = stops ? stops ^ (stops - 1) : kFull;
      if ((readies & need) == need) break;
    }
    const int c = stops ? __ffs(stops) - 1 : 32;
    Seg v = lane <= c && j >= 0 ? unpack_status(s) : seg_identity();
    // ordered reduction: lane 0 ends with v[31] (+) ... (+) v[0], older first
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Seg o = shfl_seg(v, (lane + off) & 31);
      if (lane + off < 32) v = seg_combine(o, v);
    }
    acc = seg_combine(shfl_seg(v, 0), acc);
    if (stops) return acc;
  }
}

__global__ void __launch_bounds__(kThreads)
scan_probe_kernel(const int* __restrict__ keys, const int* __restrict__ setcode,
                  const uint8_t* __restrict__ writer,
                  const uint8_t* __restrict__ e_init,
                  uint8_t* __restrict__ e_before, int* __restrict__ waits,
                  int n, int aligned, unsigned* __restrict__ ctr,
                  unsigned long long* __restrict__ status, unsigned epoch) {
  __shared__ int s_tile;
  __shared__ int s_warp[kWarps];         // each warp's total, packed
  __shared__ int s_continues;            // the first lane is not a head
  __shared__ Seg s_prefix;               // the tile's exclusive prefix
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wid = t >> 5;
  if (t == 0) {
    const unsigned ticket = atomicInc(ctr, gridDim.x - 1);
    if (ticket >= gridDim.x) __trap();   // the counter was not at rest
    s_tile = static_cast<int>(ticket);
  }
  __syncthreads();
  const int tile = s_tile;
  const int lo = tile * kTile + t * kPerThread;
  const int cnt = max(0, min(kPerThread, n - lo));
  const bool vec = aligned && cnt == kPerThread;

  // every read of the tile, in one round
  int k[kPerThread], sc[kPerThread];
  uint32_t wbits = 0, ebits = 0;
  if (vec) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(keys + lo));
    const int4 b = __ldg(reinterpret_cast<const int4*>(setcode + lo));
    k[0] = a.x; k[1] = a.y; k[2] = a.z; k[3] = a.w;
    sc[0] = b.x; sc[1] = b.y; sc[2] = b.z; sc[3] = b.w;
    wbits = load_flags(writer + lo);
    ebits = load_flags(e_init + lo);
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const bool in = j < cnt;
      k[j] = in ? keys[lo + j] : 0;
      sc[j] = in ? setcode[lo + j] : -1;
      wbits |= static_cast<uint32_t>(in && writer[lo + j] != 0) << j;
      ebits |= static_cast<uint32_t>(in && e_init[lo + j] != 0) << j;
    }
  }
  // the key before each warp's span (the tile's halo key for warp 0)
  const int edge_before = lane == 0 && lo > 0 && cnt > 0
                              ? __ldg(keys + lo - 1) : 0;

  // a lane's c: the bit its setter writes (setcode & 1), or -1
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) sc[j] = sc[j] >= 0 ? (sc[j] & 1) : -1;
  int tail = k[0];
#pragma unroll
  for (int j = 1; j < kPerThread; ++j)
    if (j < cnt) tail = k[j];
  int prev = __shfl_up_sync(kFull, tail, 1);
  if (lane == 0) prev = edge_before;
  if (t == 0) s_continues = lo > 0 && edge_before == k[0];

  // per-lane head bits and the thread's aggregate
  uint32_t hbits = 0;
  Seg agg = seg_identity();
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int kb = j == 0 ? prev : k[j - 1];
    const uint32_t h = lo + j == 0 || kb != k[j];
    hbits |= h << j;
    if (j < cnt)
      agg = seg_combine(agg, Seg{static_cast<int>(h),
                                 static_cast<int>((wbits >> j) & 1u), sc[j]});
  }
  // inclusive scan across the warp (one packed shuffle a step), then the
  // block's warps through shared memory
  Seg incl = agg;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Seg o = unpack32(__shfl_up_sync(kFull, pack32(incl), off));
    if (lane >= off) incl = seg_combine(o, incl);
  }
  Seg excl = unpack32(__shfl_up_sync(kFull, pack32(incl), 1));
  if (lane == 0) excl = seg_identity();
  if (lane == 31) s_warp[wid] = pack32(incl);
  __syncthreads();
  Seg pre = seg_identity();
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    if (w < wid) pre = seg_combine(pre, unpack32(s_warp[w]));
  excl = seg_combine(pre, excl);

  // publish the tile's aggregate at once -- as its inclusive prefix when
  // it holds a run head -- and look back only when the first lane needs it
  Seg total = seg_identity();
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    total = seg_combine(total, unpack32(s_warp[w]));
  if (t == 0)
    store_release(status + tile,
                  pack_status(total.head ? kFlagPrefix : kFlagAggregate,
                              total, epoch));
  if (s_continues) {                     // the same for every thread
    if (wid == 0) {
      const Seg before = look_back(status, tile, epoch);
      if (lane == 0) {
        s_prefix = before;
        if (!total.head)
          store_release(status + tile,
                        pack_status(kFlagPrefix, seg_combine(before, total),
                                    epoch));
      }
    }
    __syncthreads();
    excl = seg_combine(s_prefix, excl);
  }

  // apply: the exclusive prefix lane by lane
  Seg run = excl;
  uint32_t obits = 0;
  int wt[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const uint32_t e0 = (ebits >> j) & 1u;
    const bool h = (hbits >> j) & 1u;
    wt[j] = h ? 0 : run.w;
    obits |= (h ? e0 : (run.c >= 0 ? static_cast<uint32_t>(run.c) : e0)) << j;
    run = seg_combine(run, Seg{static_cast<int>(h),
                               static_cast<int>((wbits >> j) & 1u), sc[j]});
  }
  if (vec) {
    store_flags(e_before + lo, obits);
    *reinterpret_cast<int4*>(waits + lo) =
        make_int4(wt[0], wt[1], wt[2], wt[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (j < cnt) {
        e_before[lo + j] = (obits >> j) & 1u;
        waits[lo + j] = wt[j];
      }
    }
  }
}

}  // namespace

// One launch of ceil(n / kTile) blocks; none for n == 0.  The low 32 bits
// of scratch[0] are the ticket counter, 0 when a launch starts and again
// when it ends; scratch[1 + tile] is the tile's status word; epoch (1 to
// 2^28 - 1) differs from every earlier launch's since the words were last
// zeroed.
extern "C" int scan_probe_launch(int device, const int* keys,
                                 const int* setcode, const uint8_t* writer,
                                 const uint8_t* e_init, uint8_t* e_before,
                                 int* waits, unsigned long long* scratch,
                                 unsigned epoch, int n, cudaStream_t stream) {
  // a launch goes to the calling thread's current device, which need not
  // be the tensors'
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int aligned =
        ((reinterpret_cast<uintptr_t>(keys) |
          reinterpret_cast<uintptr_t>(setcode) |
          reinterpret_cast<uintptr_t>(writer) |
          reinterpret_cast<uintptr_t>(e_init) |
          reinterpret_cast<uintptr_t>(e_before) |
          reinterpret_cast<uintptr_t>(waits)) & 15) == 0;
    const int blocks =
        static_cast<int>((static_cast<long long>(n) + kTile - 1) / kTile);
    scan_probe_kernel<<<blocks, kThreads, 0, stream>>>(
        keys, setcode, writer, e_init, e_before, waits, n, aligned,
        reinterpret_cast<unsigned*>(scratch), scratch + 1, epoch);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
