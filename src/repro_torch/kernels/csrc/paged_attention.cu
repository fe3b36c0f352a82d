// paged_attention: one-token GQA decode attention over a paged KV pool.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention/paged_attention.py (paged_attention,
// pallas_call at :74) and the dense decode path it stands for in
// src/repro/models/attention.py (decode_attention; a dense (B, Smax, KH, D)
// cache is the pool of B pages of Smax rows under the identity block
// table).
//
//   out[b, h] = sum_{t < length[b]} softmax_t(scale * q[b, h] . K_b[t]) V_b[t]
//
// where row t of sequence b is row t % page of pool page
// block_table[b, t / page] and kv head h // g; scale = D^-1/2; (m, l, acc)
// in f32; output in q's type (in f32 when an lse buffer is given).  The
// pools are strided views of (NPOOL, page, KH, D) with D contiguous.
//
// Bound on an H100 SXM: the K and V rows of the valid positions
// (2 * sum(length) * KH * D * sizeof(T) bytes) over 3.35 TB/s; the
// 4 * sum(length) * H * D operations are far below the line.  At decode_32k
// (B 8, KH 8, D 128, bf16, lengths up to 32768) that is up to 1.07 GB,
// 0.32 ms.
//
// Design (flash decoding).  The sequence is split across blocks, and so
// may be a kv head's query heads: grid (KH x n_hgroups, B, n_split), one
// block of 128 threads per (kv head and group of gh = g / n_hgroups of its
// query heads, sequence, split of `split` positions).  With one group
// (n_hgroups 1) a block serves all g query heads of its kv head, so that
// each K/V row is read once from device memory; with more, each group's
// block reads the kv head's rows itself (from L2 after the first), which
// pays where the grid would otherwise be a few blocks: recurrentgemma's
// MQA (KH 1, g 16) at B 1 ran its 40-row serve slot on one block of one
// SM.  n_split and n_hgroups come from shapes (the block table's span NP *
// page, B, KH, g), never from the lengths, which stay on the device; a
// block whose split starts at or past the sequence's positions returns at
// once.  Each head's result takes the same arithmetic whatever the
// grouping.  Inside a block:
//  * Loads: tiles of 32 positions, double-buffered with cp.async (16 bytes
//    a thread) into shared memory in the input's type; each row's page id
//    comes from the block table as it is loaded, so a page may end inside a
//    tile, and entries past ceil(length / page) are never read.  Rows past
//    the sequence are zero-filled (cp.async with no source bytes).
//  * Scores: the g dot products of a position split D over 4 lanes of a
//    warp (16-byte reads of every 4th chunk; K rows padded so that the reads
//    fall in distinct banks), finished by two shuffles; 8 positions a warp.
//    This kernel (paged_split_kernel) is compiled at the widths W 32, 64,
//    96, 112, 128 and 256 with D = W a compile-time constant, as every
//    published head dim runs (D read at run time made the published shapes
//    21-31 % slower on an H100: its loops divide by D).  A row that is not
//    a multiple of 4 chunks (D 112 in bf16: 14) leaves some lanes' last
//    round past the row, which they skip: lanes 0 and 1 take 4 chunks,
//    lanes 2 and 3 take 3.
//  * Softmax: a warp per query head, a lane per position; P.V by threads
//    that own (head, column pair).
//  * Every other head dim and row (paged_cols_kernel): the same design
//    with D at run time over a row in chunks of W columns, W the smallest
//    compiled width at or above D (D 80 on 96, recurrentgemma-9b's smoke
//    D 16 on 32), 256 past it; the pools are never copied.  Each tile of
//    positions streams as one stage per chunk (K's chunk, the heads' chunk
//    of q as f32 and, with the first, V's columns of the block's column
//    pass); a score is the sum of its chunks' dots; past 256 the grid
//    holds ceil(D / 256) column passes, each block accumulating its 256
//    output columns.  Rows that are not whole 16-byte chunks, or lie off
//    16-byte boundaries (base pointer or a stride), are loaded element by
//    element, each chunk zero-filled to whole chunks; the others with
//    cp.async.
// With one split the block writes the output; with more, each writes its
// heads' partials (acc[gh][D], m, l; a column pass its columns of acc, and
// pass 0 m and l) in f32 to scratch, laid out (B, KH, n_split, g, D + 2)
// with the true D whatever the grouping, and
// paged_merge_kernel (a
// second launch, one block per (query head, sequence)) combines them by
// their log-sum-exp weights.
//
// Given an `lse` buffer (f32, (B, H) contiguous; nullptr for none, as
// serving passes), the launch is one part of a split sequence, as
// dist/decode_attn.py makes it: the block that writes a head's output
// also writes the log-sum-exp of its scaled, masked scores, m + log(l), in
// natural-log units, the weight by which the parts are merged; the output
// is written in f32, unrounded, so that the merge rounds once; and a
// sequence of length <= 0 (a part past its sequence's length, whose weight
// is 0) reads nothing: output 0, lse -INFINITY.
//
// Masks follow the reference: a position at or past the length scores the
// finite -1e30 (a sequence of length <= 0 therefore averages every row of
// its pages, as the reference does, and every split of it runs), and rows
// past the positions a block reads score -INFINITY and never count.  The
// TPU kernel carries (m, l, acc) across its page grid axis; here that axis
// is the loop inside a block plus the merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int kTP = 32;        // positions per tile (one per lane)
constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

using attn::from_f32;
using attn::to_f32;

struct Pool {  // element strides of a (NPOOL, page, KH, D) view
  long long p, o, h;
};

// positions a sequence's blocks read: its length, clipped to the block
// table's span; a sequence of length <= 0 reads (and averages) the span,
// or nothing when the launch is a part of a split sequence
__device__ __forceinline__ int positions(int length, int span, bool part) {
  return length >= 1 ? min(length, span) : (part ? 0 : span);
}

// element i of the output: in T, or in f32 for a part of a split sequence
template <typename T>
__device__ __forceinline__ void store_out(void* o, bool f32, long long i,
                                          float x) {
  if (f32)
    static_cast<float*>(o)[i] = x;
  else
    static_cast<T*>(o)[i] = from_f32<T>(x);
}

// a K tile row is padded to 64 bytes past a multiple of 128, so that the
// 16-byte reads of the 8 lanes of a quarter-warp (2 rows x 4 chunks 16
// bytes apart) fall in distinct banks; in a round that a row's last chunks
// end (D 112 in bf16: 14 chunks, the fourth round 2 of them) fewer lanes
// read, in the same banks
template <typename T, int D>
__host__ __device__ constexpr int k_stride() {
  return D + ((64 - int(D * sizeof(T)) % 128 + 128) % 128) / int(sizeof(T));
}

// shared memory of a block that serves g query heads
template <typename T, int D>
size_t smem_bytes(int g) {
  // K tiles [2][kTP][k_stride], V tiles [2][kTP][D] in T; then f32
  // Qs[g][D], Ss[g][kTP], Acc[g][D], m/l/alpha[g]
  return sizeof(T) * 2 * kTP * (k_stride<T, D>() + D) +
         sizeof(float) * (size_t(g) * (2 * D + kTP) + 3 * size_t(g));
}

// 16 bytes of T in shared memory as f32
template <typename T>
__device__ __forceinline__ void chunk_f32(const T* src, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < int(16 / sizeof(T)); ++i) out[i] = to_f32(e[i]);
}

// two neighbouring elements of T in shared memory as f32
__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D: the head dim, the tiles' row length
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ bt,
                   const int* __restrict__ lengths, void* __restrict__ o,
                   float* __restrict__ part, float* __restrict__ lse, int H,
                   int KH, int n_hgroups, int page, int NP, int split,
                   int n_split, long long qsb, long long qsh, Pool ks,
                   Pool vs, long long btsb, long long osb, long long osh,
                   float scale) {
  constexpr int CH = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int LK = k_stride<T, D>();
  constexpr int RJ = (D / CH + 3) / 4;  // rounds of 4 chunks, at most
  constexpr int hd = D;
  constexpr int rc = hd / CH;           // chunks per row
  // this block's kv head hk and its query heads h0 .. h0 + g - 1 (g of the
  // kv head's H / KH)
  const int g = H / KH / n_hgroups;
  const int hk = blockIdx.x / n_hgroups, b = blockIdx.y, sp = blockIdx.z;
  const int h0 = hk * (H / KH) + (blockIdx.x % n_hgroups) * g;
  const int length = lengths[b];
  const int span = NP * page;
  const int n_valid = min(length, span);  // unmasked positions
  const bool f32_out = lse != nullptr;
  const int n_pos = positions(length, span, f32_out);
  const int p0 = sp * split;
  if (p0 >= n_pos) {
    if (n_pos == 0 && sp == 0 && part == nullptr) {
      // an empty part with one split: no merge writes its output
      for (int idx = threadIdx.x; idx < g * hd; idx += kThreads)
        store_out<T>(o, true, b * osb + (h0 + idx / hd) * osh + idx % hd,
                     0.f);
      for (int gi = threadIdx.x; gi < g; gi += kThreads)
        lse[static_cast<long long>(b) * H + h0 + gi] = -INFINITY;
    }
    return;
  }
  const int p1 = min(p0 + split, n_pos);
  const int n_tiles = (p1 - p0 + kTP - 1) / kTP;

  extern __shared__ __align__(16) uint8_t smem[];
  T* Kt = reinterpret_cast<T*>(smem);  // [2][kTP][LK]
  T* Vt = Kt + 2 * kTP * LK;           // [2][kTP][D]
  float* Qs = reinterpret_cast<float*>(Vt + 2 * kTP * D);  // [g][D], scaled
  float* Ss = Qs + g * D;    // [g][kTP]: scores, then probabilities
  float* Acc = Ss + g * kTP;  // [g][D]
  float* Ms = Acc + g * D;    // [g] running max
  float* Ls = Ms + g;         // [g] running sum
  float* As = Ls + g;         // [g] this tile's rescale

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* btb = bt + b * btsb;

  auto load_tile = [&](int tile, int buf) {
    const int t0 = p0 + tile * kTP;
    for (int idx = tid; idx < kTP * rc; idx += kThreads) {
      const int r = idx / rc, c = idx % rc, t = t0 + r;
      const T* ksrc = kp;
      const T* vsrc = vp;
      if (t < p1) {
        const long long pid = btb[t / page];
        const int off = t % page;
        ksrc = kp + pid * ks.p + off * ks.o + hk * ks.h + c * CH;
        vsrc = vp + pid * vs.p + off * vs.o + hk * vs.h + c * CH;
      }
      cp_async16(Kt + (buf * kTP + r) * LK + c * CH, ksrc, t < p1);
      cp_async16(Vt + (buf * kTP + r) * D + c * CH, vsrc, t < p1);
    }
    cp_async_commit();
  };
  load_tile(0, 0);

  for (int idx = tid; idx < g * hd; idx += kThreads) {
    const int gi = idx / hd, d = idx % hd;
    Qs[gi * D + d] = to_f32(q[b * qsb + (h0 + gi) * qsh + d]) * scale;
    Acc[gi * D + d] = 0.f;
  }
  for (int gi = tid; gi < g; gi += kThreads) {
    Ms[gi] = kNegInf;
    Ls[gi] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1, t0 = p0 + tile * kTP;
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and, at first, Qs/Acc/Ms/Ls) in place

    // scores: 4 lanes per position, each taking every 4th 16-byte chunk of
    // the row, two shuffles to finish a dot product; 8 positions a warp
    {
      const int r = warp * (kTP / kWarps) + lane / 4, qd = lane % 4;
      const T* krow = Kt + (buf * kTP + r) * LK;
      float kf[RJ][CH];
#pragma unroll
      for (int j = 0; j < RJ; ++j)
        if (4 * j + qd < rc) chunk_f32(krow + (4 * j + qd) * CH, kf[j]);
      const int t = t0 + r;
      for (int gi = 0; gi < g; ++gi) {
        const float* qrow = Qs + gi * D;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          if (4 * j + qd >= rc) continue;
#pragma unroll
          for (int e = 0; e < CH; e += 2) {
            s0 = fmaf(qrow[(4 * j + qd) * CH + e], kf[j][e], s0);
            s1 = fmaf(qrow[(4 * j + qd) * CH + e + 1], kf[j][e + 1], s1);
          }
        }
        float s = s0 + s1;
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (qd == 0)
          Ss[gi * kTP + r] = t >= p1 ? -INFINITY : (t < n_valid ? s : kNegInf);
      }
    }
    __syncthreads();

    // online softmax: a warp per query head, a lane per position
    for (int gi = warp; gi < g; gi += kWarps) {
      const float s = Ss[gi * kTP + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[gi];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(s - m_new);
      Ss[gi * kTP + lane] = p;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Ls[gi] = Ls[gi] * alpha + sum;
        Ms[gi] = m_new;
        As[gi] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: a thread per (head, column pair)
    for (int idx = tid; idx < g * (hd / 2); idx += kThreads) {
      const int gi = idx / (hd / 2), d = 2 * (idx % (hd / 2));
      const float alpha = As[gi];
      float a0 = Acc[gi * D + d] * alpha, a1 = Acc[gi * D + d + 1] * alpha;
      const T* vcol = Vt + buf * kTP * D + d;
      const float* prow = Ss + gi * kTP;
#pragma unroll 8
      for (int r = 0; r < kTP; ++r) {
        const float p = prow[r];
        const float2 v = pair_f32(vcol + r * D);
        a0 = fmaf(p, v.x, a0);
        a1 = fmaf(p, v.y, a1);
      }
      Acc[gi * D + d] = a0;
      Acc[gi * D + d + 1] = a1;
    }
    __syncthreads();  // the buffer and Ss are rewritten next
  }

  if (part == nullptr) {  // one split: the output itself
    for (int idx = tid; idx < g * hd; idx += kThreads) {
      const int gi = idx / hd, d = idx % hd;
      store_out<T>(o, f32_out, b * osb + (h0 + gi) * osh + d,
                   Acc[gi * D + d] / fmaxf(Ls[gi], 1e-30f));
    }
    if (lse != nullptr)
      for (int gi = tid; gi < g; gi += kThreads)
        lse[static_cast<long long>(b) * H + h0 + gi] =
            Ms[gi] + logf(fmaxf(Ls[gi], 1e-30f));
    return;
  }
  // partial of split sp: part[b][hk][sp][h - hk * H / KH] = (acc[0..hd),
  // m, l) for this block's heads h
  float* pb = part + (((static_cast<long long>(b) * KH + hk) * n_split + sp) *
                          (H / KH) + h0 - hk * (H / KH)) * (hd + 2);
  for (int idx = tid; idx < g * hd; idx += kThreads)
    pb[(idx / hd) * (hd + 2) + idx % hd] = Acc[(idx / hd) * D + idx % hd];
  for (int gi = tid; gi < g; gi += kThreads) {
    pb[gi * (hd + 2) + hd] = Ms[gi];
    pb[gi * (hd + 2) + hd + 1] = Ls[gi];
  }
}

// out[b, h] from the partials of the splits that ran, weighted by
// exp(m_split - max m): one block per (query head, sequence), so that a
// few kv heads (recurrentgemma's one) still merge on as many blocks as
// there are query heads; the head dim D is W when WHOLE, else `d_arg`
template <typename T, int W, bool WHOLE>
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const float* __restrict__ part,
                   const int* __restrict__ lengths, void* __restrict__ o,
                   float* __restrict__ lse, int H, int KH, int page, int NP,
                   int d_arg, int split, int n_split, long long osb,
                   long long osh) {
  const int D = WHOLE ? W : d_arg;
  const int g = H / KH;
  const int h = blockIdx.x, hk = h / g, gi = h % g, b = blockIdx.y;
  const bool f32_out = lse != nullptr;
  const int n_pos = positions(lengths[b], NP * page, f32_out);
  const int ran = (n_pos + split - 1) / split;
  const float* pb =
      part + (static_cast<long long>(b) * KH + hk) * n_split * g * (D + 2);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float mx = -INFINITY;
    for (int s = 0; s < ran; ++s)
      mx = fmaxf(mx, pb[(s * g + gi) * (D + 2) + D]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < ran; ++s) {
      const float* ps = pb + (s * g + gi) * (D + 2);
      const float w = expf(ps[D] - mx);
      num = fmaf(ps[d], w, num);
      den = fmaf(ps[D + 1], w, den);
    }
    store_out<T>(o, f32_out, b * osb + h * osh + d, num / fmaxf(den, 1e-30f));
    if (f32_out && d == 0)
      lse[static_cast<long long>(b) * H + h] = mx + logf(fmaxf(den, 1e-30f));
  }
}

// Narrow rows and head dims past 256: the split kernel's design over a
// row in chunks of W columns.  Grid (KH x n_hgroups x n_pass, B, n_split):
// the block of column pass `pass` computes the scores over every chunk of
// the row and accumulates the output's columns [pass W, pass W + W) only.
// Each tile of positions is streamed as its row chunks, one stage each
// (K's chunk, the query heads' chunk of q staged as f32, and at the
// tile's first chunk V's columns of the pass), double-buffered; a
// position's score is the sum of its chunks' dots, the masks applied
// after the last.  Every pass computes the same scores in the same order,
// so their softmax statistics are the same bits, and pass 0 alone writes
// lse and the partials' (m, l).  NARROW loads element by element (a row
// that is not whole 16-byte chunks, or off 16-byte boundaries), zero-
// filling each chunk up to whole chunks; else cp.async 16 bytes at a
// time, as the split kernel.
template <typename T, int W, bool NARROW>
__global__ void __launch_bounds__(kThreads)
paged_cols_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const int* __restrict__ bt,
                  const int* __restrict__ lengths, void* __restrict__ o,
                  float* __restrict__ part, float* __restrict__ lse, int H,
                  int KH, int n_hgroups, int n_pass, int page, int NP,
                  int hd, int split, int n_split, long long qsb,
                  long long qsh, Pool ks, Pool vs, long long btsb,
                  long long osb, long long osh, float scale) {
  constexpr int CH = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int LK = k_stride<T, W>();
  constexpr int RJ = (W / CH + 3) / 4;  // rounds of 4 chunks, at most
  const int g = H / KH / n_hgroups;
  const int pass = blockIdx.x % n_pass, grp = blockIdx.x / n_pass;
  const int hk = grp / n_hgroups, b = blockIdx.y, sp = blockIdx.z;
  const int h0 = hk * (H / KH) + (grp % n_hgroups) * g;
  const int nc = (hd + W - 1) / W;              // chunks of a row
  const int c0 = pass * W, pw = min(W, hd - c0);  // this pass's columns
  const int length = lengths[b];
  const int span = NP * page;
  const int n_valid = min(length, span);
  const bool f32_out = lse != nullptr;
  const int n_pos = positions(length, span, f32_out);
  const int p0 = sp * split;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (p0 >= n_pos) {
    if (n_pos == 0 && sp == 0 && part == nullptr) {
      for (int idx = tid; idx < g * pw; idx += kThreads)
        store_out<T>(o, true,
                     b * osb + (h0 + idx / pw) * osh + c0 + idx % pw, 0.f);
      if (pass == 0)
        for (int gi = tid; gi < g; gi += kThreads)
          lse[static_cast<long long>(b) * H + h0 + gi] = -INFINITY;
    }
    return;
  }
  const int p1 = min(p0 + split, n_pos);
  const int n_tiles = (p1 - p0 + kTP - 1) / kTP;

  extern __shared__ __align__(16) uint8_t smem[];
  T* Kt = reinterpret_cast<T*>(smem);  // [2][kTP][LK]: a chunk, by stage
  T* Vt = Kt + 2 * kTP * LK;           // [2][kTP][W]: the pass's, by tile
  float* Qs = reinterpret_cast<float*>(Vt + 2 * kTP * W);  // [2][g][W]
  float* Ss = Qs + 2 * g * W;  // [g][kTP]
  float* Acc = Ss + g * kTP;   // [g][W]
  float* Ms = Acc + g * W;
  float* Ls = Ms + g;
  float* As = Ls + g;
  const int* btb = bt + b * btsb;

  // columns [col0, col0 + cw) of the tile's rows into dst (row pitch
  // `pitch`), zeros past them to whole chunks and in rows past p1
  auto load_rows = [&](T* dst, int pitch, const T* base, const Pool& ps,
                       int t0, int col0, int cw) {
    if constexpr (NARROW) {
      const int cwr = (cw + CH - 1) / CH * CH;
      for (int idx = tid; idx < kTP * cwr; idx += kThreads) {
        const int r = idx / cwr, c = idx % cwr, t = t0 + r;
        T x = attn::from_f32<T>(0.f);
        if (t < p1 && c < cw)
          x = base[btb[t / page] * ps.p + (t % page) * ps.o + hk * ps.h +
                   col0 + c];
        dst[r * pitch + c] = x;
      }
    } else {
      const int rc = cw / CH;
      for (int idx = tid; idx < kTP * rc; idx += kThreads) {
        const int r = idx / rc, c = idx % rc, t = t0 + r;
        const T* src = base;
        if (t < p1)
          src = base + btb[t / page] * ps.p + (t % page) * ps.o + hk * ps.h +
                col0 + c * CH;
        cp_async16(dst + r * pitch + c * CH, src, t < p1);
      }
    }
  };
  // chunk kc of the group's query rows, scaled, as f32 into Qs[buf]
  auto load_q = [&](int buf, int kc) {
    const int cw = min(W, hd - kc * W), cwr = (cw + CH - 1) / CH * CH;
    for (int idx = tid; idx < g * cwr; idx += kThreads) {
      const int gi = idx / cwr, c = idx % cwr;
      Qs[(buf * g + gi) * W + c] =
          c < cw ? to_f32(q[b * qsb + (h0 + gi) * qsh + kc * W + c]) * scale
                 : 0.f;
    }
  };
  auto issue = [&](int st) {
    const int tile = st / nc, kc = st % nc, t0 = p0 + tile * kTP;
    load_rows(Kt + (st & 1) * kTP * LK, LK, kp, ks, t0, kc * W,
              min(W, hd - kc * W));
    if (kc == 0) load_rows(Vt + (tile & 1) * kTP * W, W, vp, vs, t0, c0, pw);
    if (nc > 1) load_q(st & 1, kc);
    cp_async_commit();
  };

  if (nc == 1) load_q(0, 0);
  for (int idx = tid; idx < g * W; idx += kThreads) Acc[idx] = 0.f;
  for (int gi = tid; gi < g; gi += kThreads) {
    Ms[gi] = kNegInf;
    Ls[gi] = 0.f;
  }
  issue(0);

  const int n_st = n_tiles * nc;
  for (int st = 0; st < n_st; ++st) {
    const int tile = st / nc, kc = st % nc, t0 = p0 + tile * kTP;
    if (st + 1 < n_st) {
      issue(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (and, at first, Qs/Acc/Ms/Ls) in place

    // this chunk's dots: 4 lanes per position, as the split kernel
    {
      const int r = warp * (kTP / kWarps) + lane / 4, qd = lane % 4;
      const int rc = (min(W, hd - kc * W) + CH - 1) / CH;
      const T* krow = Kt + ((st & 1) * kTP + r) * LK;
      const float* qc = Qs + (nc == 1 ? 0 : (st & 1)) * g * W;
      float kf[RJ][CH];
#pragma unroll
      for (int j = 0; j < RJ; ++j)
        if (4 * j + qd < rc) chunk_f32(krow + (4 * j + qd) * CH, kf[j]);
      const int t = t0 + r;
      for (int gi = 0; gi < g; ++gi) {
        const float* qrow = qc + gi * W;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          if (4 * j + qd >= rc) continue;
#pragma unroll
          for (int e = 0; e < CH; e += 2) {
            s0 = fmaf(qrow[(4 * j + qd) * CH + e], kf[j][e], s0);
            s1 = fmaf(qrow[(4 * j + qd) * CH + e + 1], kf[j][e + 1], s1);
          }
        }
        float s = s0 + s1;
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (qd == 0) {
          float* at = Ss + gi * kTP + r;
          const float sum = kc == 0 ? s : *at + s;
          *at = kc < nc - 1 ? sum
                            : (t >= p1 ? -INFINITY
                                       : (t < n_valid ? sum : kNegInf));
        }
      }
    }
    __syncthreads();  // the stage's buffers are rewritten next
    if (kc < nc - 1) continue;

    for (int gi = warp; gi < g; gi += kWarps) {
      const float s = Ss[gi * kTP + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[gi];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(s - m_new);
      Ss[gi * kTP + lane] = p;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Ls[gi] = Ls[gi] * alpha + sum;
        Ms[gi] = m_new;
        As[gi] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over the pass's columns (an odd last column
    // pairs with a zero)
    const int np2 = (pw + 1) / 2;
    for (int idx = tid; idx < g * np2; idx += kThreads) {
      const int gi = idx / np2, d = 2 * (idx % np2);
      const float alpha = As[gi];
      float a0 = Acc[gi * W + d] * alpha, a1 = Acc[gi * W + d + 1] * alpha;
      const T* vcol = Vt + (tile & 1) * kTP * W + d;
      const float* prow = Ss + gi * kTP;
#pragma unroll 8
      for (int r = 0; r < kTP; ++r) {
        const float p = prow[r];
        const float2 v = pair_f32(vcol + r * W);
        a0 = fmaf(p, v.x, a0);
        a1 = fmaf(p, v.y, a1);
      }
      Acc[gi * W + d] = a0;
      Acc[gi * W + d + 1] = a1;
    }
    __syncthreads();
  }

  if (part == nullptr) {
    for (int idx = tid; idx < g * pw; idx += kThreads) {
      const int gi = idx / pw, d = idx % pw;
      store_out<T>(o, f32_out, b * osb + (h0 + gi) * osh + c0 + d,
                   Acc[gi * W + d] / fmaxf(Ls[gi], 1e-30f));
    }
    if (lse != nullptr && pass == 0)
      for (int gi = tid; gi < g; gi += kThreads)
        lse[static_cast<long long>(b) * H + h0 + gi] =
            Ms[gi] + logf(fmaxf(Ls[gi], 1e-30f));
    return;
  }
  float* pb = part + (((static_cast<long long>(b) * KH + hk) * n_split + sp) *
                          (H / KH) + h0 - hk * (H / KH)) * (hd + 2);
  for (int idx = tid; idx < g * pw; idx += kThreads)
    pb[(idx / pw) * (hd + 2) + c0 + idx % pw] = Acc[(idx / pw) * W + idx % pw];
  if (pass == 0)
    for (int gi = tid; gi < g; gi += kThreads) {
      pb[gi * (hd + 2) + hd] = Ms[gi];
      pb[gi * (hd + 2) + hd + 1] = Ls[gi];
    }
}

// shared memory of a column-pass block that serves g query heads
template <typename T, int W>
size_t cols_smem_bytes(int g) {
  // K chunks [2][kTP][k_stride], V tiles [2][kTP][W] in T; then f32
  // Qs[2][g][W], Ss[g][kTP], Acc[g][W], m/l/alpha[g]
  return sizeof(T) * 2 * kTP * (k_stride<T, W>() + W) +
         sizeof(float) * (size_t(g) * (3 * W + kTP) + 3 * size_t(g));
}

// the column-pass instance of width W at head dim hd (n_pass passes)
template <typename T, int W, bool NARROW>
int launch_cols(const void* q, const void* kp, const void* vp, const int* bt,
                const int* lengths, void* o, float* part, float* lse, int B,
                int H, int KH, int n_hgroups, int page, int NP, int hd,
                int split, int n_split, long long qsb, long long qsh,
                Pool ks, Pool vs, long long btsb, long long osb,
                long long osh, float scale, int* grid, cudaStream_t stream) {
  if (split % kTP || n_split < 1 || (n_split > 1) != (part != nullptr) ||
      n_hgroups < 1 || (H / KH) % n_hgroups)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_pass = (hd + W - 1) / W;
  const size_t bytes = cols_smem_bytes<T, W>(H / KH / n_hgroups);
  cudaError_t err = cudaFuncSetAttribute(
      paged_cols_kernel<T, W, NARROW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks(KH * n_hgroups * n_pass, B, n_split);
  paged_cols_kernel<T, W, NARROW><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, lengths, o, part, lse, H, KH, n_hgroups,
      n_pass, page, NP, hd, split, n_split, qsb, qsh, ks, vs, btsb, osb, osh,
      scale);
  grid[0] = blocks.x;
  grid[1] = blocks.y;
  grid[2] = blocks.z;
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  paged_merge_kernel<T, W, false><<<dim3(H, B), kThreads, 0, stream>>>(
      part, lengths, o, lse, H, KH, page, NP, hd, split, n_split, osb, osh);
  return static_cast<int>(cudaGetLastError());
}

// the split kernel of head dim D
template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* lengths, void* o, float* part, float* lse, int B,
           int H, int KH, int n_hgroups, int page, int NP, int split,
           int n_split, long long qsb, long long qsh, Pool ks, Pool vs,
           long long btsb, long long osb, long long osh, float scale,
           int* grid, cudaStream_t stream) {
  if (split % kTP || n_split < 1 || (n_split > 1) != (part != nullptr) ||
      n_hgroups < 1 || (H / KH) % n_hgroups)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes<T, D>(H / KH / n_hgroups);
  cudaError_t err = cudaFuncSetAttribute(
      paged_split_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks(KH * n_hgroups, B, n_split);
  paged_split_kernel<T, D><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, lengths, o, part, lse, H, KH, n_hgroups,
      page, NP, split, n_split, qsb, qsh, ks, vs, btsb, osb, osh, scale);
  grid[0] = blocks.x;
  grid[1] = blocks.y;
  grid[2] = blocks.z;
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  paged_merge_kernel<T, D, true><<<dim3(H, B), kThreads, 0, stream>>>(
      part, lengths, o, lse, H, KH, page, NP, D, split, n_split, osb, osh);
  return static_cast<int>(cudaGetLastError());
}

// whether a pool's rows are whole 16-byte chunks on 16-byte boundaries
// (base pointer, every stride but the last, and a row of D elements)
template <typename T>
bool rows16(const void* p, Pool st, int D) {
  const long long sz = sizeof(T);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.p * sz % 16 == 0 &&
         st.o * sz % 16 == 0 && st.h * sz % 16 == 0 && D * sz % 16 == 0;
}

// head dim D on the instance of width W: the split kernel where D is a
// compiled width (D == W) and the pools' rows are whole 16-byte chunks on
// 16-byte boundaries, else the column-pass kernel (element loads where
// the rows are not); ran = {W, passes, element loads}
template <typename T>
int launch_d(int D, int W, const void* q, const void* kp, const void* vp,
             const int* bt, const int* lengths, void* o, float* part,
             float* lse, int B, int H, int KH, int n_hgroups, int page,
             int NP, int split, int n_split, long long qsb, long long qsh,
             Pool ks, Pool vs, long long btsb, long long osb, long long osh,
             float scale, int* grid, int* ran, cudaStream_t stream) {
  if (D < 1 || (D <= 256 ? D > W : W != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool narrow = !rows16<T>(kp, ks, D) || !rows16<T>(vp, vs, D);
  ran[0] = W;
  ran[1] = (D + W - 1) / W;
  ran[2] = narrow;
  if (!narrow && D == W) {
    switch (W) {
#define PAGED_CASE(WW)                                                      \
  case WW:                                                                  \
    return launch<T, WW>(q, kp, vp, bt, lengths, o, part, lse, B, H, KH,     \
                         n_hgroups, page, NP, split, n_split, qsb, qsh, ks,  \
                         vs, btsb, osb, osh, scale, grid, stream);
      PAGED_CASE(32)
      PAGED_CASE(64)
      PAGED_CASE(96)
      PAGED_CASE(112)
      PAGED_CASE(128)
      PAGED_CASE(256)
#undef PAGED_CASE
    }
  }
  switch (W) {
#define COLS_CASE(WW)                                                       \
  case WW:                                                                  \
    return narrow ? launch_cols<T, WW, true>(                                \
                        q, kp, vp, bt, lengths, o, part, lse, B, H, KH,     \
                        n_hgroups, page, NP, D, split, n_split, qsb, qsh,   \
                        ks, vs, btsb, osb, osh, scale, grid, stream)        \
                  : launch_cols<T, WW, false>(                               \
                        q, kp, vp, bt, lengths, o, part, lse, B, H, KH,     \
                        n_hgroups, page, NP, D, split, n_split, qsb, qsh,   \
                        ks, vs, btsb, osb, osh, scale, grid, stream);
    COLS_CASE(32)
    COLS_CASE(64)
    COLS_CASE(96)
    COLS_CASE(112)
    COLS_CASE(128)
    COLS_CASE(256)
#undef COLS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, the pools and out share it).
// Strides are in elements; the D axis is contiguous; block_table's page
// axis is contiguous; block_table and lengths are int32.  D is the head
// dim, W the instance it runs on: the smallest compiled width at or above
// D up to 256, 256 past it.  ran[0..3) is set to the instance dispatched
// on, its column passes (ceil(D / W)) and whether rows were loaded element
// by element (a pool's rows not whole 16-byte chunks on 16-byte
// boundaries).  `split` (a multiple of 32) positions per block, n_split
// blocks per (kv head, sequence) and, across them, n_hgroups blocks per kv
// head (n_hgroups divides H / KH); with n_split > 1, `part` is f32 scratch
// of B * KH * n_split * (H / KH) * (D + 2) elements, else null.  grid[0..3)
// is set to the split launch's grid (KH * n_hgroups * passes, B, n_split).
// lse: f32 (B, H) contiguous, or null; given, the launch is a part of a
// split sequence: `o` is f32, and a length <= 0 reads nothing (out 0, lse
// -INFINITY).
extern "C" int paged_attention_launch(
    int device, int dtype, const void* q, const void* kp, const void* vp,
    const int* bt, const int* lengths, void* o, float* part, float* lse,
    int B, int H, int KH, int n_hgroups, int page, int NP, int D, int W,
    int split, int n_split, long long qsb, long long qsh, long long ksp,
    long long kso, long long ksh, long long vsp, long long vso, long long vsh,
    long long btsb, long long osb, long long osh, float scale, int* grid,
    int* ran, cudaStream_t stream) {
  grid[0] = grid[1] = grid[2] = 0;
  ran[0] = ran[1] = ran[2] = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || H == 0) return 0;
  const Pool ks{ksp, kso, ksh}, vs{vsp, vso, vsh};
  if (dtype == 0)
    return launch_d<float>(D, W, q, kp, vp, bt, lengths, o, part, lse, B, H,
                           KH, n_hgroups, page, NP, split, n_split, qsb, qsh,
                           ks, vs, btsb, osb, osh, scale, grid, ran, stream);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, W, q, kp, vp, bt, lengths, o, part,
                                   lse, B, H, KH, n_hgroups, page, NP, split,
                                   n_split, qsb, qsh, ks, vs, btsb, osb, osh,
                                   scale, grid, ran, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dynamic shared memory of one split block (dtype as above) of the
// instance of width D that serves g query heads, 0 for an unknown width
extern "C" int paged_attention_smem_bytes(int dtype, int D, int g) {
  switch (D) {
#define PAGED_SMEM(DD)                                              \
  case DD:                                                          \
    return static_cast<int>(dtype ? smem_bytes<__nv_bfloat16, DD>(g) \
                                  : smem_bytes<float, DD>(g));
    PAGED_SMEM(32)
    PAGED_SMEM(64)
    PAGED_SMEM(96)
    PAGED_SMEM(112)
    PAGED_SMEM(128)
    PAGED_SMEM(256)
#undef PAGED_SMEM
    default:
      return 0;
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
