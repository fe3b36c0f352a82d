// flash_attention: blockwise online-softmax GQA attention (prefill).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py (flash_attention,
// pallas_call at :82) and the chunked jnp path it stands for in
// src/repro/models/attention.py (gqa_attention, _flash_fwd_impl).
//
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h // g]) v[b, j, h // g]
//
// over the keys j that the causal / sliding-window masks leave, with
// scale = D^-1/2, the running (m, l, acc) in f32 and the output in the
// input's type.  Inputs are strided views of a (B, S, heads, D) layout
// (D contiguous), so both the model's (B, S, H, D) and the reference
// kernel's (B, H, S, D) are passed without a copy.
//
// Bound on an H100 SXM: 4 * B * H * D * (unmasked (q, k) pairs) operations
// over 989 TFLOP/s (bf16, tensor cores) or 67 TFLOP/s (f32, CUDA cores),
// against the bytes of q, k, v and out over 3.35 TB/s.  At the prefill shape
// (B 2, S 4096, H 16, KH 8, D 128, causal) that is about 137 GFLOP,
// 0.14 ms in bf16: operations bound.
//
// Instances.  Each design is compiled at the widths W 32, 64, 80, 96, 112,
// 128 and 256, and a head dim D up to 256 (its rows whole 16-byte chunks)
// runs on the smallest W at or above it, the launcher's caller
// choosing it (ops.py's instance_of) and the kernel taking D at run time:
// columns D .. W - 1 of every tile load as zeros (TMA's out-of-bounds fill
// past the tensor maps' D columns, or the CUDA-core loads), every product
// runs at W over them, exact since they add nothing, and no column at or
// past D is stored.  Every published head dim is an instance of its own.
//
// bf16 design (tensor cores), at D 32, 64, 80, 96, 112, 128 and 256.  One
// block
// per (128-query tile, head, batch): two consumer warpgroups of 64 query
// rows each and a producer.  Blocks are numbered so that the q tiles with
// the most keys (the last ones under the causal mask) start first.
//  * Geometry (Geom<D>).  Up to D 128: 288 threads, the producer one warp,
//    a ring of three 64-key stages.  At D 256 a Q tile is 64 KB and a K+V
//    stage 64 KB, so the ring has two stages (197,672 bytes of shared
//    memory), and the output fragment alone is 64 x 256 f32, 128 registers
//    a consumer thread: the producer is a whole warpgroup (384 threads)
//    that gives its registers to the consumers by setmaxnreg (24 a producer
//    thread, 240 a consumer thread), as the backward does.
//  * Loads: the producer's first lane loads the Q tile once and the K/V
//    tiles into the ring with TMA
//    (cp.async.bulk.tensor, 4-D maps over (D, S, heads, B) encoded on the
//    host), each stage signalled by a "full" mbarrier that counts the
//    bytes and released by an "empty" mbarrier that every consumer thread
//    arrives on.  Rows past S come in as zeros (TMA's out-of-bounds fill).
//    Tiles use the 128-byte swizzle (64 columns a box; a D-128 row is two
//    boxes, a D-256 row four), 64-byte for D 32, matching the wgmma
//    descriptors below.
//  * D 80 and 96 are not whole 64-column boxes: a row is one 64-column box
//    (128-byte swizzle) and a tail box of its last 16 or 32 columns, whose
//    32- or 64-byte row is its own swizzle, loaded through a second tensor
//    map and read through descriptors of that swizzle (Cols<D>, shared
//    with the backward in attention_common.cuh).  Every
//    product then runs at the true width: S = Q K^T in D / 16 k-steps, O +=
//    P V as an n64 product and an n16 or n32 one (tiles padded to 128
//    columns would spend 1.6x and 1.33x the useful O += P V work).
//  * D 112's last 48 columns (96 bytes) have no swizzle of their width: a
//    row is two 64-column boxes (128-byte swizzle), the second reaching 16
//    columns past the row, which TMA fills with zeros, so a tile takes
//    D 128's shared memory.  The products still run at the true width: S =
//    Q K^T in 7 k-steps (the zero columns are never read), O += P V as one
//    m64n112k16 across both boxes, and nothing past column 111 is stored.
//  * S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory,
//    f32 accumulators in registers; the scale (times log2 e) is applied to
//    the f32 scores.
//  * Masks: only the tiles that cross the causal diagonal, the window's edge
//    or S are masked element by element; tiles wholly outside a warpgroup's
//    masks are skipped.  As in the reference, a masked score is the finite
//    -1e30 and m starts at -1e30, so a row that has seen only masked scores
//    adds exp(0) terms that the first valid score wipes; keys past S score
//    -INFINITY and never count.
//  * Online softmax in registers; a row's 4 threads reduce by shuffles.
//  * O += P V: wgmma m64nDk16 (at D 80 and 96 the main part's and the
//    tail's products; at D 112 m64n112k16; at D 256 the widest,
//    m64n256k16) with P from
//    registers (the accumulator layout of S is the A-fragment layout) and
//    V (N-major) from shared memory.  P is split
//    into bf16 hi = bf16(p) and lo = bf16(p - hi) and both are multiplied
//    into the same f32 accumulator: a single bf16 P puts about 5 % of the
//    outputs more than two bf16 ulps from the f32 reference, the split none
//    (tests/test_torch_kernel_designs.py).  The lo product costs half again
//    the useful operations, still at the tensor-core rate.
//
// CUDA-core design: f32 at every D (TF32 would miss the 2e-5 tolerance).
// The launcher reports which design it ran.  One block of 128 threads per
// (64-query tile, head, batch); Q and each 64-key K/V tile are staged in
// shared memory; a thread owns 8 query rows x 4 key columns of the score
// tile and 8 rows x D/16 columns of the output; every product an f32 FMA.
// Same masks and tile skipping.
//
// Past 256, both dtypes: the CUDA-core design in column passes
// (flash_fwd_cols).  A block owns a pass of 256 output columns of its
// query tile, ceil(D / 256) passes in the grid; for each key tile it sums
// S over the row's chunks of 256 columns (Q's and K's chunk staged as
// f32), then runs the softmax and accumulates its columns of O from V's
// chunk.  Each pass computes S, m and l with the same arithmetic, so they
// are the same bits in every pass and lse (pass 0's) fits each column's
// normalization; in bf16 o32 takes the output before its rounding.  Rows
// that are not whole 16-byte chunks, or views off 16-byte boundaries,
// never reach this file: the launcher's caller (ops.py) runs the kernels
// on dense zero-padded copies of them.
//
// On Hopper the blocks run in no order, so there is no carry between
// blocks: the TPU kernel's kv grid axis is the loop over key tiles inside
// the block.
//
// Both designs write, when given an `lse` buffer (f32, (B, H, S)
// contiguous; nullptr for none, as serving passes), each row's log-sum-exp
// of its scaled, masked scores in natural-log units, m + log(l): the
// residual that the backward (flash_attention_bwd.cu) recomputes P from.
// In bf16, when given an `o32` buffer (f32, the output's element strides;
// nullptr for none, as serving passes), the tensor-core kernel also writes
// the output before its rounding to bf16: the backward's delta = rowsum(dO * O) is taken from
// it, as the reference takes it from its f32 forward output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

using attn::kErrTensorMap;
using attn::load_chunk;

using attn::Strides;

// ---------------------------------------------------------------------------
// CUDA cores: f32
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 8 row groups x 16 column lanes

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_cc(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int H, int KH, int S, int hd,
             Strides qs, Strides ks, Strides vs, Strides os, int causal,
             int window, float scale) {
  // D: the instance's width; hd <= D: the head dim, columns past it zeros
  constexpr int LQ = D + 1, LK = D + 1, LV = D, LP = kBK + 1;
  // V elements per 16-byte chunk, C chunks per row, NJ output columns a
  // thread
  constexpr int V = 4, C = D / V, NJ = D / 16;
  static_assert(D % 16 == 0 && D % V == 0, "D must be a multiple of 16");
  extern __shared__ float smem[];
  float* Qs = smem;            // [kBQ][LQ], pre-scaled
  float* Ks = Qs + kBQ * LQ;   // [kBK][LK]
  float* Vs = Ks + kBK * LK;   // [kBK][LV]
  float* Ps = Vs + kBK * LV;   // [kBQ][LP]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / KH);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  for (int idx = tid; idx < kBQ * C; idx += kThreads) {
    const int r = idx / C, c = idx % C, pos = q0 + r;
    float e[V];
    if (pos < S && c * V < hd) {
      load_chunk(qb + pos * qs.s + c * V, e);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) e[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) Qs[r * LQ + c * V + i] = e[i] * scale;
  }

  float acc[8][NJ], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // key tiles that hold at least one unmasked key for some row of the tile
  int kt_end = (S + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (min(q0 + kBQ, S) + kBK - 1) / kBK);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K/V/P are no longer read
    for (int idx = tid; idx < kBK * C; idx += kThreads) {
      const int r = idx / C, c = idx % C, pos = k0 + r;
      float ek[V], ev[V];
      if (pos < S && c * V < hd) {
        load_chunk(kb + pos * ks.s + c * V, ek);
        load_chunk(vb + pos * vs.s + c * V, ev);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) ek[i] = ev[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        Ks[r * LK + c * V + i] = ek[i];
        Vs[r * LV + c * V + i] = ev[i];
      }
    }
    __syncthreads();

    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = Qs[(ty * 8 + i) * LQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LK + d];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qpos = q0 + ty * 8 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = true;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        sc[i][j] = kpos >= S ? -INFINITY : (ok ? sc[i][j] : kNegInf);
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty * 8 + i) * LP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[8], vv[NJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = Ps[(ty * 8 + i) * LP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[kk * LV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qpos = q0 + ty * 8 + i;
    if (qpos < S) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (tx + 16 * j < hd)
          ob[qpos * os.s + tx + 16 * j] = acc[i][j] / denom;
      if (lse != nullptr && tx == 0)
        lse[(static_cast<long long>(b) * H + h) * S + qpos] =
            m[i] + logf(denom);
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA cores, head dims past 256: column passes, f32 and bf16
// ---------------------------------------------------------------------------

constexpr int kCW = 256;  // columns of a score chunk and of an output pass

// rows [pos0, pos0 + rows) of columns [0, cw) of a (S, .) slice at `src`
// (row stride `stride`, 16-byte chunks) into `dst` as f32 times `mul`, row
// pitch `pitch`, kCW columns: rows past S and columns cw .. kCW - 1 zeros
template <typename T>
__device__ __forceinline__ void stage_cols(float* dst, int pitch,
                                           const T* src, long long stride,
                                           int pos0, int rows, int S, int cw,
                                           float mul) {
  constexpr int V = 16 / sizeof(T), C = kCW / V;
  for (int idx = threadIdx.x; idx < rows * C; idx += kThreads) {
    const int r = idx / C, c = idx % C, pos = pos0 + r;
    float e[V];
    if (pos < S && c * V < cw) {
      load_chunk(src + pos * stride + c * V, e);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) e[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) dst[r * pitch + c * V + i] = e[i] * mul;
  }
}

// flash_fwd_cc's design at a head dim hd past 256: one block per (64-query
// tile, column pass, head, batch).  For each key tile the block sums S =
// Q K^T over the row's chunks of kCW columns (Q's and K's chunk staged
// together, then their products), then runs the online softmax and
// accumulates O over its pass's columns [pass kCW, pass kCW + kCW) of V,
// staged with the tile's first chunk.  Every pass computes the same
// scores in the same order, so m and l are the same bits in each, and
// pass 0 alone writes lse.  In bf16 the output is rounded once at the
// store, and `o32` (or nullptr) takes it in f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_cols(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ o32, float* __restrict__ lse, int H,
               int KH, int S, int hd, int n_pass, Strides qs, Strides ks,
               Strides vs, Strides os, int causal, int window, float scale) {
  constexpr int D = kCW, LQ = D + 1, LK = D + 1, LV = D, LP = kBK + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;            // [kBQ][LQ]: a chunk, pre-scaled
  float* Ks = Qs + kBQ * LQ;   // [kBK][LK]: a chunk
  float* Vs = Ks + kBK * LK;   // [kBK][LV]: the pass's columns
  float* Ps = Vs + kBK * LV;   // [kBQ][LP]

  const int pass = static_cast<int>(blockIdx.x) % n_pass;
  const int q0 = static_cast<int>(blockIdx.x) / n_pass * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / KH);
  const int nc = (hd + D - 1) / D, c0 = pass * D, pw = min(D, hd - c0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  float acc[8][NJ], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int kt_end = (S + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (min(q0 + kBQ, S) + kBK - 1) / kBK);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int kc = 0; kc < nc; ++kc) {
      const int cw = min(D, hd - kc * D);
      __syncthreads();  // the previous chunk's (tile's) tiles are read
      stage_cols(Qs, LQ, qb + kc * D, qs.s, q0, kBQ, S, cw, scale);
      stage_cols(Ks, LK, kb + kc * D, ks.s, k0, kBK, S, cw, 1.f);
      if (kc == 0) stage_cols(Vs, LV, vb + c0, vs.s, k0, kBK, S, pw, 1.f);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < cw; ++d) {
        float qv[8], kv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) qv[i] = Qs[(ty * 8 + i) * LQ + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LK + d];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qpos = q0 + ty * 8 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = true;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        sc[i][j] = kpos >= S ? -INFINITY : (ok ? sc[i][j] : kNegInf);
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty * 8 + i) * LP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[8], vv[NJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = Ps[(ty * 8 + i) * LP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[kk * LV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + b * os.b + h * os.h + c0;
  float* o32b = o32 == nullptr ? nullptr : o32 + b * os.b + h * os.h + c0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qpos = q0 + ty * 8 + i;
    if (qpos < S) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (tx + 16 * j < pw) {
          const float x = acc[i][j] / denom;
          ob[qpos * os.s + tx + 16 * j] = attn::from_f32<T>(x);
          if (o32b != nullptr) o32b[qpos * os.s + tx + 16 * j] = x;
        }
      if (lse != nullptr && tx == 0 && pass == 0)
        lse[(static_cast<long long>(b) * H + h) * S + qpos] =
            m[i] + logf(denom);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), tiles fed by TMA
// ---------------------------------------------------------------------------

namespace tc {

using namespace attn;  // the Hopper helpers

constexpr int kBQ = 128;                     // query rows per block
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kBK = 64;                      // keys per K/V tile
constexpr int kConsumerRegs = 240, kProducerRegs = 24;  // by setmaxnreg

// The block's geometry at head dim D.  D <= 128: 64-key tiles in a ring of
// three stages, one producer warp (288 threads; 224 registers a thread at
// most).  D 256: a Q tile is 64 KB and a K+V stage 64 KB, so two stages
// fit (197,672 bytes); the output fragment alone is 128 f32 registers a
// consumer thread, so the producer is a warpgroup that gives up its
// registers (setmaxnreg: 24 a producer thread, 240 a consumer thread, 384
// threads).
template <int D>
struct Geom {
  static constexpr int STAGES = D > 128 ? 2 : 3;  // K/V ring
  static constexpr bool PRODUCER_WG = D > 128;
  static constexpr int THREADS = kConsumers + (PRODUCER_WG ? 128 : 32);
  static constexpr int Q_BYTES = kBQ * Cols<D>::ROW_BYTES;
  static constexpr int KV_BYTES = kBK * Cols<D>::ROW_BYTES;  // one of K, V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_BYTES = 8 * (1 + 2 * STAGES);
  // the tiles start on a 1024-byte boundary (the swizzle pattern's period;
  // every tile's and tail box's size is a multiple of it)
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES +
                              BAR_BYTES;
};

template <int D>
__global__ void __launch_bounds__(Geom<D>::THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tq_tail,
               const __grid_constant__ CUtensorMap tk_tail,
               const __grid_constant__ CUtensorMap tv_tail,
               __nv_bfloat16* __restrict__ o, float* __restrict__ o32,
               float* __restrict__ lse, int H, int KH, int B, int S, int hd,
               Strides os, int causal, int window,
               float scale_log2) {
  using G = Geom<D>;
  using C = Cols<D>;
  constexpr int MAIN = C::MAIN, TAIL = C::TAIL;
  constexpr int STAGES = G::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + G::Q_BYTES;  // stage s: K, then V
  const uint32_t bar_q = sKV + STAGES * G::STAGE_BYTES;
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + STAGES + s); };

  // longest q tiles first: the q tile is the slowest-varying block index
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / (H * B);
  const int hb = static_cast<int>(blockIdx.x) % (H * B);
  const int h = hb % H, b = hb / H, hk = h / (H / KH);
  const int q0 = qt * kBQ;
  int lo, hi;
  key_tiles<kBK>(q0, min(q0 + kBQ, S), S, causal, window, lo, hi);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // producer warp(group): one lane issues every load
    if constexpr (G::PRODUCER_WG) setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      mbar_expect_tx(bar_q, G::Q_BYTES);
      load_tile<D>(sQ, &tq, &tq_tail, bar_q, kBQ, q0, h, b);
      for (int i = 0, kt = lo; kt < hi; ++i, ++kt) {
        const int s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), G::STAGE_BYTES);
        const uint32_t sk = sKV + s * G::STAGE_BYTES, sv = sk + G::KV_BYTES;
        load_tile<D>(sk, &tk, &tk_tail, full(s), kBK, kt * kBK, hk, b);
        load_tile<D>(sv, &tv, &tv_tail, full(s), kBK, kt * kBK, hk, b);
      }
    }
    return;
  }
  if constexpr (G::PRODUCER_WG) setmaxnreg_inc<kConsumerRegs>();

  // consumers: warpgroup wg owns rows [wr_lo, wr_lo + 64) of the tile; in
  // the accumulator layout a thread holds rows r0 and r0 + 8, columns
  // 8 j + c0 and 8 j + c0 + 1 of each 8-column group j
  const int wg = tid / 128, t = tid % 128, lane = t % 32;
  const int wr_lo = q0 + 64 * wg, wr_hi = min(wr_lo + 64, S);
  const int r0 = wr_lo + 16 * (t / 32) + lane / 4, c0 = 2 * (lane % 4);
  int wlo = 0, whi = 0;  // this warpgroup's key tiles (none past S)
  if (wr_lo < S) key_tiles<kBK>(wr_lo, wr_hi, S, causal, window, wlo, whi);

  // the output's main columns, and its tail's (acc_t, unused at TAIL 0)
  float acc[MAIN / 2], acc_t[TAIL > 0 ? TAIL / 2 : 1];
#pragma unroll
  for (int j = 0; j < MAIN / 2; ++j) acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < TAIL / 2; ++j) acc_t[j] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const Rows64<D> qa(sQ, kBQ, 64 * wg);  // this warpgroup's rows
  mbar_wait(bar_q, 0);

  for (int i = 0, kt = lo; kt < hi; ++i, ++kt) {
    const int s = i % STAGES;
    mbar_wait(full(s), (i / STAGES) & 1);
    if (kt >= wlo && kt < whi) {
      const uint32_t sk = sKV + s * G::STAGE_BYTES, sv = sk + G::KV_BYTES;
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.f;
      wg_fence();
      wgmma_over_d<D>(sc, qa, kBQ, Rows64<D>(sk, kBK, 0), kBK);
      wg_commit();
      wg_wait();
      reg_fence(sc);

      const int k0 = kt * kBK;
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] *= scale_log2;
      const bool edge = (causal && k0 + kBK - 1 > wr_lo) ||
                        (window > 0 && k0 <= wr_hi - 1 - window) ||
                        k0 + kBK > S;
      if (edge) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int kpos = k0 + 8 * (j / 4) + c0 + (j & 1);
          const int qpos = r0 + 8 * ((j >> 1) & 1);
          bool ok = true;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          sc[j] = kpos >= S ? -INFINITY : (ok ? sc[j] : kNegInf);
        }
      }

      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 32; ++j)
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
      }
      // P in the A-fragment layout: pair j / 2 holds columns (j, j + 1)
      uint32_t phi[16], plo[16];
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int r = (j >> 1) & 1;
        const float p0 = exp2f(sc[j] - m[r]), p1 = exp2f(sc[j + 1] - m[r]);
        rs[r] += p0 + p1;
        split_bf16(p0, p1, phi[j / 2], plo[j / 2]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int j = 0; j < MAIN / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
#pragma unroll
      for (int j = 0; j < TAIL / 2; ++j) acc_t[j] *= alpha[(j >> 1) & 1];

      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)  // keys 16 kk .. 16 kk + 15
        wgmma_rs_d<D>(acc, acc_t, phi + 4 * kk, plo + 4 * kk, sv, kBK, kk);
      wg_commit();
      wg_wait();
      reg_fence(acc);
      if constexpr (TAIL > 0) reg_fence(acc_t);
    }
    mbar_arrive(empty(s));
  }

  if (wr_lo >= S) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  if (lse != nullptr && lane % 4 == 0) {
    // m is in log2 units of the scaled scores: m ln 2 + log l
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (r0 + 8 * r < S)
        lse[(static_cast<long long>(b) * H + h) * S + r0 + 8 * r] =
            m[r] * 0.6931471805599453f + logf(l[r]);
  }
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
  float* o32b = o32 == nullptr ? nullptr : o32 + b * os.b + h * os.h;
  // columns (col, col + 1) of row `row`, none at or past hd (even, as col)
  auto store = [&](float x0, float x1, int row, int col) {
    if (col >= hd) return;
    const float2 x = make_float2(x0, x1);
    const long long at = row * os.s + col;
    *reinterpret_cast<__nv_bfloat162*>(ob + at) =
        __floats2bfloat162_rn(x.x, x.y);
    if (o32b != nullptr) *reinterpret_cast<float2*>(o32b + at) = x;
  };
#pragma unroll
  for (int j = 0; j < MAIN / 2; j += 2) {
    const int r = (j >> 1) & 1, row = r0 + 8 * r;
    if (row < S)
      store(acc[j] / l[r], acc[j + 1] / l[r], row, 8 * (j / 4) + c0);
  }
#pragma unroll
  for (int j = 0; j < TAIL / 2; j += 2) {
    const int r = (j >> 1) & 1, row = r0 + 8 * r;
    if (row < S)
      store(acc_t[j] / l[r], acc_t[j + 1] / l[r], row,
            MAIN + 8 * (j / 4) + c0);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

using attn::kTensorCoresFwd;

template <int D>
int launch_cc(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int H, int KH, int S, int hd, Strides qs,
              Strides ks,
              Strides vs, Strides os, int causal, int window, float scale,
              cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_cc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_cc<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, KH, S,
      hd, qs, ks, vs, os, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* o32, float* lse, int B, int H, int KH, int S, int hd,
                Strides qs, Strides ks, Strides vs, Strides os, int causal,
                int window, float scale, cudaStream_t stream) {
  // maps over the views' hd columns in the instance's boxes; at D 80 and
  // 96 each has a tail map over its view from column 64 on (at D 112 none:
  // the main map's second box reads past the row as zeros)
  CUtensorMap tq, tk, tv, tq_tail{}, tk_tail{}, tv_tail{};
  using G = tc::Geom<D>;
  if (!attn::encode_cols<D>(&tq, &tq_tail, q, hd, S, H, B, qs, tc::kBQ) ||
      !attn::encode_cols<D>(&tk, &tk_tail, k, hd, S, KH, B, ks, tc::kBK) ||
      !attn::encode_cols<D>(&tv, &tv_tail, v, hd, S, KH, B, vs, tc::kBK))
    return kErrTensorMap;
  const long long blocks =
      static_cast<long long>((S + tc::kBQ - 1) / tc::kBQ) * H * B;
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = G::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      tc::flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  tc::flash_fwd_bf16<D><<<static_cast<unsigned>(blocks), G::THREADS, bytes,
                          stream>>>(
      tq, tk, tv, tq_tail, tk_tail, tv_tail, static_cast<__nv_bfloat16*>(o),
      o32, lse, H, KH, B, S, hd, os, causal, window,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// head dims past 256 on the CUDA cores (flash_fwd_cols), in n_pass
// column passes of kCW columns
template <typename T>
int launch_cols(const void* q, const void* k, const void* v, void* o,
                float* o32, float* lse, int B, int H, int KH, int S, int hd,
                int n_pass, Strides qs, Strides ks, Strides vs, Strides os,
                int causal, int window, float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats<kCW>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_cols<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((S + kBQ - 1) / kBQ) * n_pass;
  if (tiles >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), H, B);
  flash_fwd_cols<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), o32, lse, H, KH, S, hd,
      n_pass, qs, ks, vs, os, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// the instance of width D at head dim hd; *design: 1 for the tensor-core
// kernel, 0 for the CUDA-core one
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           float* o32, float* lse, int B, int H, int KH, int S, int hd,
           Strides qs, Strides ks, Strides vs, Strides os, int causal,
           int window, float scale, int* design, cudaStream_t stream) {
  static_assert(kTensorCoresFwd<D>, "bf16 runs the tensor cores at every D");
  *design = 0;
  if (dtype == 0)  // the output is f32 itself
    return launch_cc<D>(q, k, v, o, lse, B, H, KH, S, hd, qs, ks, vs, os,
                        causal, window, scale, stream);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  *design = 1;
  return launch_bf16<D>(q, k, v, o, o32, lse, B, H, KH, S, hd, qs, ks, vs, os,
                        causal, window, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// Strides are in elements; the D axis is contiguous and every row starts on
// a 16-byte boundary.  lse: f32 (B, H, S) contiguous, or nullptr.  o32: in
// bf16, f32 with out's element strides, or nullptr; ignored in f32.
// D is the head dim, its rows whole 16-byte chunks, and W the instance it
// runs on: a compiled width at or above it up to 256, 256 past it.
// *design is set to the design launched: 1 = the tensor-core kernel (bf16
// at every W), 0 = the CUDA-core one (f32), 2 = the CUDA-core column
// passes (D past 256, both dtypes); *instance to the W it dispatched on
// and *passes to its column passes (ceil(D / 256) past 256, else 1).
extern "C" int flash_attention_launch(
    int device, int dtype, const void* q, const void* k, const void* v,
    void* o, int B, int H, int KH, int S, int D, int W, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb, long long oss,
    long long osh,
    int causal, int window, float scale, float* lse, float* o32, int* design,
    int* instance, int* passes, cudaStream_t stream) {
  *design = 0;
  *instance = 0;
  *passes = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || S == 0 || H == 0) return 0;
  if (D < 1 || (D <= 256 ? D > W : W != 256) ||
      D * (dtype ? 2 : 4) % 16 != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  if (D > 256) {
    *design = 2;
    *instance = 256;
    *passes = (D + kCW - 1) / kCW;
    return dtype == 0
               ? launch_cols<float>(q, k, v, o, nullptr, lse, B, H, KH, S, D,
                                    *passes, qs, ks, vs, os, causal, window,
                                    scale, stream)
               : launch_cols<__nv_bfloat16>(q, k, v, o, o32, lse, B, H, KH,
                                            S, D, *passes, qs, ks, vs, os,
                                            causal, window, scale, stream);
  }
  *passes = 1;
  switch (W) {
#define FLASH_CASE(WW)                                                      \
  case WW:                                                                  \
    *instance = WW;                                                         \
    return launch<WW>(dtype, q, k, v, o, o32, lse, B, H, KH, S, D, qs, ks,   \
                      vs, os, causal, window, scale, design, stream);
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(96)
    FLASH_CASE(112)
    FLASH_CASE(128)
    FLASH_CASE(256)
#undef FLASH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dynamic shared memory of one block of the instance of width D (dtype as
// above), 0 for an unknown width
extern "C" int flash_attention_smem_bytes(int dtype, int D) {
  switch (D) {
#define FLASH_SMEM(DD)                                          \
  case DD:                                                      \
    return dtype ? tc::Geom<DD>::SMEM                           \
                 : static_cast<int>(smem_floats<DD>() * sizeof(float));
    FLASH_SMEM(32)
    FLASH_SMEM(64)
    FLASH_SMEM(80)
    FLASH_SMEM(96)
    FLASH_SMEM(112)
    FLASH_SMEM(128)
    FLASH_SMEM(256)
#undef FLASH_SMEM
    default:
      return 0;
  }
}

extern "C" const char* kernel_error_string(int err) {
  if (err == kErrTensorMap) return "cuTensorMapEncodeTiled refused a map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
