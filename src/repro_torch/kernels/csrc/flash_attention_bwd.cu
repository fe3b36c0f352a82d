// flash_attention_bwd: the FlashAttention backward of flash_attention.cu.
//
// Replaces the jnp FlashAttention backward of the reference,
// src/repro/models/attention.py (_flash_vjp_bwd, the jax.custom_vjp
// backward of _flash; not a Pallas kernel).  Given q, k, v, the forward's
// output o in f32 (in bf16 the one before its rounding, which the forward
// writes with `lse`, as the reference keeps its f32 output: delta from the
// rounded one misses the f32 gradient), its gradient dO and the forward's
// per-row log-sum-exp `lse`
// (natural log of the scaled, masked scores; written by flash_attention.cu),
// it recomputes P = exp(scale * q k^T - lse) per tile pair instead of
// reading a saved S x S matrix, and computes
//
//   delta = rowsum(dO * o)
//   dV    = P^T dO                 dP = dO V^T
//   dS    = P * (dP - delta)
//   dQ    = scale * dS K           dK = scale * dS^T Q
//
// with GQA: query head h reads kv head h / g, and a kv head's dK and dV sum
// over its g query heads.  Masks as in the forward (causal, sliding window;
// keys and queries past S count nothing), accumulation in f32, one rounding
// to the input's type at the store.  Inputs are strided views of a (B, S,
// heads, D) layout with a contiguous, 16-byte aligned D axis; lse and delta
// are f32 (B, H, S) contiguous.
//
// Bound on an H100 SXM: five products of 2 * B * H * D * (unmasked (q, k)
// pairs) operations: at the training shape (B 2, S 4096, H 16, KH 8, D 128,
// causal) about 344 GFLOP, 0.35 ms at 989 TFLOP/s (bf16, tensor cores) or
// 5.1 ms at 67 TFLOP/s (f32, CUDA cores); the bytes (q, k, v, o, dO and
// the three gradients, about 0.1 GB in bf16) are far below that.
//
// Three launches (four where D 256 splits the dK/dV pass over head
// groups, below), no atomics, so the result does not depend on the order
// the blocks run in: (a) flash_bwd_delta, one warp per row, delta =
// rowsum(dO * o) in f32; (b) a dK/dV pass, one block per (key tile, kv
// head, batch) that loops over the query tiles its masks leave and the g
// query heads of the group; (c) a dQ pass, one block per (query tile,
// head, batch) that loops over the key tiles its masks leave.  S and dP
// are recomputed in both passes: 7 products where an atomic dQ would take
// 5, which keeps every output owned by one block.
//
// Instances: as in the forward, each kernel is compiled at the widths W
// 32, 64, 80, 96, 112, 128 and 256, and a head dim D up to 256 runs on
// the smallest W at or above it with D as a run-time argument: the loads
// fill columns D .. W - 1 with zeros (TMA's fill past the maps' D columns;
// the f32 staging), the products run at W over them, delta sums D
// columns, and no gradient column at or past D is stored.  Below, D is the
// instance's W.
//
// bf16 at every D (32, 64, 80, 96, 112, 128 and 256): tensor cores.  Both
// passes have the forward's shape: blocks of 384 threads, two consumer
// warpgroups and a producer warpgroup, one warp of which issues the TMA
// loads (setmaxnreg: 240 registers a consumer thread, 24 a producer
// thread, for the f32 accumulators); the block's two own tiles (K and V,
// or Q and dO) are loaded once, and a ring of stages streams the other
// two in 64-row tiles (Q and dO with their lse and delta rows, or K and
// V), each stage signalled by a "full" mbarrier that counts the bytes and
// released by an "empty" one every consumer thread arrives on.  Tiles use
// the forward's swizzled boxes (128-byte, 64-byte at D 32; at D 80 and 96
// a row is one 64-column box and a tail box of its last 16 or 32 columns
// with its own tensor map and 32- or 64-byte swizzle; at D 112 two
// 64-column boxes, the second's last 16 columns TMA's zeros past the row,
// Cols<D> of attention_common.cuh), rows past S come in as zeros (TMA's
// out-of-bounds fill), blocks with the most work start first, and tiles
// wholly outside the masks are skipped; only those that cross the
// diagonal, the window's edge or S are masked element by element.  Every
// product is a wgmma in one of the forward's two forms, at the true width
// (a reduction over D in MAIN / 16 k-steps through the main boxes and
// TAIL / 16 through the tail boxes; a product with N = D as an n64 product
// and an n16 or n32 one into a tail accumulator of its own, at D 112 as
// one n112 product):
//   (b) S^T = K Q^T and dP^T = V dO^T, both operands K-major in shared
//       memory (the forward's S = Q K^T); P^T = exp2(scale log2e S^T -
//       log2e lse) and dS^T = P^T (dP^T - delta) in registers, where the
//       accumulator layout of S^T is the A-fragment layout; dV += P^T dO
//       and dK += dS^T Q with the A operand from registers and the same Q
//       and dO tiles read N-major (the forward's O += P V).
//   (c) S = Q K^T and dP = dO V^T, K-major; dS = P (dP - delta); dQ += dS K
//       with K read N-major.
// P and dS are split into bf16 hi = bf16(x) and lo = bf16(x - hi), both
// multiplied into the same f32 accumulator: one bf16 P or dS puts hundreds
// of elements of dV, or of dQ and dK, beyond BWD_TOL at the tests' shapes,
// the split none (tests/test_torch_kernel_designs.py).  That doubles the
// three register-operand products: 10 products' worth of tensor work,
// about 690 GFLOP at the training shape, 0.70 ms at the tensor-core rate:
// the design is held to that (and to its 0.35 ms bound) by keeping every
// product on the tensor cores, every operand tile in shared memory once,
// and P^T / dS^T in registers (PERF.md has its measured time).
// Two geometries (Geom<D>):
//  * D <= 128: a block owns 128 rows (keys in (b), queries in (c)), 64 a
//    consumer warpgroup, and three stages stream.  Each warpgroup runs
//    every product of its rows; the two shared-memory products of an
//    iteration are two wgmma groups, P (P^T) computed while dP (dP^T) is
//    still on the tensor cores.  At D 96 dK and dV take 2 x 48 f32
//    registers a consumer thread, at D 112 2 x 56, at D 128 2 x 64.
//  * D 256: a warpgroup's f32 dK and dV of 64 keys would take 256
//    registers a thread, past setmaxnreg's 240, and two 128-row own tiles
//    with three 64-row stages about 321 KB of shared memory.  So a block
//    owns 64 rows, two stages stream (231,464 bytes with two 16 KB
//    exchange buffers), and the two warpgroups split each tile pair's
//    products instead of its rows.  (b): warpgroup 0 computes S^T, makes
//    P^T, writes it to an exchange buffer and accumulates dV += P^T dO
//    (4 x 2 m64n256k16); warpgroup 1 computes dP^T, reads P^T, makes dS^T
//    and accumulates dK += dS^T Q.  (c): warpgroup 0 computes S and makes
//    P; warpgroup 1 computes dP, reads P, makes dS (hi and lo) and writes
//    it back; each accumulates dQ += dS K over half of dQ's columns (an
//    m64n128k16 through the K tile's boxes 2 wg and 2 wg + 1).  Both
//    warpgroups hold the same (row, column) in the same register, so the
//    buffers are [register][thread] words that a thread writes and its
//    twin reads back, conflict-free; named barriers over the 256 consumer
//    threads order them (in (b) two buffers, so that warpgroup 0 runs a
//    tile pair ahead).  A thread holds 128 (b) or 64 (c) f32 of
//    accumulator, 32 of S or dP and 32 hi/lo words.
//    At recurrentgemma's MQA (B 1, KH 1, S 4096) the dK/dV grid would be
//    64 blocks on 132 SMs: a kv head's g query heads are then split over
//    n_groups blocks (the fewest, a divisor of g, that fill the card; the
//    launcher's caller picks it), each writing f32 partial dK and dV to a
//    scratch, and a fourth launch, (d) flash_bwd_reduce_bf16, adds the
//    groups in a fixed order and rounds once.
//
// CUDA cores: f32 at every D: the same three launches with f32 FMAs.
// (b) one block per (64-key tile, kv head, batch) stages K and V as f32
// once, then Q and dO of each query tile and head, recomputes P^T and dS^T
// (in shared memory) and accumulates dK and dV in registers: a thread owns
// RK key rows x D/16 columns of each; (c) one block per (query tile, head,
// batch) stages Q, dO, lse and delta once, and per key tile recomputes P
// and dP, stores dS in shared memory and accumulates dQ in registers.  At
// D 256 the query tile is 32 rows and a block 256 threads, so that the
// staged tiles fit in shared memory and the accumulators in registers.
//
// Past 256, both dtypes: the CUDA-core passes in D 256's geometry, in
// column passes (flash_bwd_dkdv_cols, flash_bwd_dq_cols): a block owns 256
// columns of its rows' gradients, ceil(D / 256) blocks per rows, and for
// each tile pair sums S and dP over the row's chunks of 256 columns (the
// four operands' chunks staged together), then accumulates its columns
// from the operand chunk of those columns.  Still three launches and no
// atomics: every gradient element has one block.  Rows that are not
// whole 16-byte chunks, or views off 16-byte boundaries, reach no kernel
// here: ops.py runs them on dense zero-padded copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using attn::from_f32;
using attn::kErrTensorMap;
using attn::load_chunk;
using attn::Strides;

template <int D>
struct Cfg {
  static constexpr int NT = D > 128 ? 256 : 128;  // threads a block
  static constexpr int BQ = D > 128 ? 32 : 64;    // query rows a tile
  static constexpr int BK = 64;                   // keys a tile
  static constexpr int RG = NT / 16;              // row groups of 16 lanes
  static constexpr int RK = BK / RG;              // key rows a thread, (b)
  static constexpr int RQ = BQ / RG;              // query rows a thread, (c)
  static constexpr int CQ = BQ / 16;              // query columns a thread, (b)
  static constexpr int CK = BK / 16;              // key columns a thread, (c)
  static constexpr int L = D + 1;                 // staged row pitch (floats)
  static constexpr int NJ = D / 16;               // output columns a thread
  // (b): K, V, Q, dO tiles, P^T and dS^T, lse and delta of the query tile
  static constexpr int SMEM_DKDV =
      4 * (2 * BK * L + 2 * BQ * L + 2 * BK * (BQ + 1) + 2 * BQ);
  // (c): Q, dO, K, V tiles, dS, lse and delta of the query tile
  static constexpr int SMEM_DQ =
      4 * (2 * BQ * L + 2 * BK * L + BQ * (BK + 1) + 2 * BQ);
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  static_assert(SMEM_DKDV <= 232448 && SMEM_DQ <= 232448, "shared memory");
};

// rows [pos0, pos0 + rows) of a (S, hd) slice at `src` (row stride
// `stride`) into `dst` as f32 with row pitch D + 1; rows past S and
// columns hd .. D - 1 as zeros
template <typename T, int D, int NT>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int pos0, int rows,
                                      int S, int hd) {
  constexpr int V = 16 / sizeof(T), C = D / V;
  for (int idx = threadIdx.x; idx < rows * C; idx += NT) {
    const int r = idx / C, c = idx % C, pos = pos0 + r;
    float e[V];
    if (pos < S && c * V < hd) {
      load_chunk(src + pos * stride + c * V, e);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) e[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) dst[r * (D + 1) + c * V + i] = e[i];
  }
}

// lse and delta of rows [pos0, pos0 + rows) of one (b, h) into shared
// memory; rows past S as zeros
template <int NT>
__device__ __forceinline__ void stage_rows(float* lse_s, float* delta_s,
                                           const float* lse,
                                           const float* delta, int pos0,
                                           int rows, int S) {
  for (int r = threadIdx.x; r < rows; r += NT) {
    const bool in = pos0 + r < S;
    lse_s[r] = in ? lse[pos0 + r] : 0.f;
    delta_s[r] = in ? delta[pos0 + r] : 0.f;
  }
}

__device__ __forceinline__ bool unmasked(int qpos, int kpos, int S,
                                         int causal, int window) {
  return qpos < S && kpos < S && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// (a) delta[b, h, s] = sum_d dO * o over the hd <= D columns, o in f32; 4
// warps a block, one row a warp
template <typename T, int D>
__global__ void __launch_bounds__(128)
flash_bwd_delta(const float* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, int H, int S, int hd,
                long long rows, Strides os, Strides ds) {
  constexpr int V = 16 / sizeof(T);
  const int C = hd / V;
  const long long row = blockIdx.x * 4ll + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int s = static_cast<int>(row % S);
  const long long bh = row / S;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  const float* orow = o + b * os.b + h * os.h + s * os.s;
  const T* drow = dout + b * ds.b + h * ds.h + s * ds.s;
  float acc = 0.f;
  for (int c = lane; c < C; c += 32) {
    float eo[V], ed[V];
#pragma unroll
    for (int i = 0; i < V; i += 4) load_chunk(orow + c * V + i, eo + i);
    load_chunk(drow + c * V, ed);
#pragma unroll
    for (int i = 0; i < V; ++i) acc = fmaf(eo[i], ed[i], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// (b) dK and dV of one (64-key tile, kv head, batch)
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::NT)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int H, int KH, int B,
               int S, int hd, Strides qs, Strides ks, Strides vs, Strides ds,
               Strides dks, Strides dvs, int causal, int window,
               float scale) {
  using C = Cfg<D>;
  constexpr int L = C::L, LP = C::BQ + 1, RK = C::RK, CQ = C::CQ,
                NJ = C::NJ, BQ = C::BQ, BK = C::BK, NT = C::NT;
  extern __shared__ float smem[];
  float* Ks = smem;               // [BK][L]
  float* Vs = Ks + BK * L;        // [BK][L]
  float* Qs = Vs + BK * L;        // [BQ][L]
  float* dOs = Qs + BQ * L;       // [BQ][L]
  float* Ps = dOs + BQ * L;       // [BK][LP]: P^T
  float* dSs = Ps + BK * LP;      // [BK][LP]: dS^T
  float* lse_s = dSs + BK * LP;   // [BQ]
  float* delta_s = lse_s + BQ;    // [BQ]

  const int kt = static_cast<int>(blockIdx.x) / (KH * B);
  const int rem = static_cast<int>(blockIdx.x) % (KH * B);
  const int hk = rem % KH, b = rem / KH, g = H / KH;
  const int k0 = kt * BK;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  stage<T, D, NT>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, BK, S, hd);
  stage<T, D, NT>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, BK, S, hd);

  // the query tiles holding a query that sees a key of this tile
  const int kmax = min(k0 + BK, S) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, kmax + window) : S;
  const int qt_lo = q_lo / BQ, qt_hi = (q_hi + BQ - 1) / BQ;

  float akk[RK][NJ], avv[RK][NJ];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) akk[i][j] = avv[i][j] = 0.f;

  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int q0 = qt * BQ;
    for (int hh = 0; hh < g; ++hh) {
      const int h = hk * g + hh;
      const long long bh = static_cast<long long>(b) * H + h;
      __syncthreads();  // the previous tile's Q, dO, P, dS are read
      stage<T, D, NT>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, BQ, S, hd);
      stage<T, D, NT>(dOs, dout + b * ds.b + h * ds.h, ds.s, q0, BQ, S, hd);
      stage_rows<NT>(lse_s, delta_s, lse + bh * S, delta + bh * S, q0, BQ,
                     S);
      __syncthreads();

      // P^T = exp(scale K Q^T - lse) under the masks
      float st[RK][CQ];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) st[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[RK], qv[CQ];
#pragma unroll
        for (int i = 0; i < RK; ++i) kv[i] = Ks[(ty * RK + i) * L + d];
#pragma unroll
        for (int j = 0; j < CQ; ++j) qv[j] = Qs[(tx + 16 * j) * L + d];
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < CQ; ++j) st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          const int kpos = k0 + ty * RK + i, qc = tx + 16 * j;
          Ps[(ty * RK + i) * LP + qc] =
              unmasked(q0 + qc, kpos, S, causal, window)
                  ? expf(st[i][j] * scale - lse_s[qc])
                  : 0.f;
        }

      // dS^T = P^T * (V dO^T - delta); a thread reads back the P^T
      // elements it wrote, so that no P^T stays in registers meanwhile
      float dpt[RK][CQ];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float vv[RK], dov[CQ];
#pragma unroll
        for (int i = 0; i < RK; ++i) vv[i] = Vs[(ty * RK + i) * L + d];
#pragma unroll
        for (int j = 0; j < CQ; ++j) dov[j] = dOs[(tx + 16 * j) * L + d];
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < CQ; ++j)
            dpt[i][j] = fmaf(vv[i], dov[j], dpt[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          const int qc = tx + 16 * j;
          const int at = (ty * RK + i) * LP + qc;
          dSs[at] = Ps[at] * (dpt[i][j] - delta_s[qc]);
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q (the scale at the store)
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[RK], sv[RK], dov[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pv[i] = Ps[(ty * RK + i) * LP + qq];
          sv[i] = dSs[(ty * RK + i) * LP + qq];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dov[j] = dOs[qq * L + tx + 16 * j];
          qv[j] = Qs[qq * L + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            avv[i][j] = fmaf(pv[i], dov[j], avv[i][j]);
            akk[i][j] = fmaf(sv[i], qv[j], akk[i][j]);
          }
      }
    }
  }

  T* dkb = dk + b * dks.b + hk * dks.h;
  T* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kpos = k0 + ty * RK + i;
    if (kpos < S) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (tx + 16 * j >= hd) continue;
        dkb[kpos * dks.s + tx + 16 * j] = from_f32<T>(akk[i][j] * scale);
        dvb[kpos * dvs.s + tx + 16 * j] = from_f32<T>(avv[i][j]);
      }
    }
  }
}

// (c) dQ of one (query tile, head, batch)
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::NT)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int H, int KH, int B, int S, int hd,
             Strides qs, Strides ks, Strides vs, Strides ds, Strides dqs,
             int causal, int window, float scale) {
  using C = Cfg<D>;
  constexpr int L = C::L, LS = C::BK + 1, RQ = C::RQ, CK = C::CK,
                NJ = C::NJ, BQ = C::BQ, BK = C::BK, NT = C::NT;
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][L]
  float* dOs = Qs + BQ * L;       // [BQ][L]
  float* Ks = dOs + BQ * L;       // [BK][L]
  float* Vs = Ks + BK * L;        // [BK][L]
  float* dSs = Vs + BK * L;       // [BQ][LS]
  float* lse_s = dSs + BQ * LS;   // [BQ]
  float* delta_s = lse_s + BQ;    // [BQ]

  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / (H * B);
  const int hb = static_cast<int>(blockIdx.x) % (H * B);
  const int h = hb % H, b = hb / H, hk = h / (H / KH);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long bh = static_cast<long long>(b) * H + h;

  stage<T, D, NT>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, BQ, S, hd);
  stage<T, D, NT>(dOs, dout + b * ds.b + h * ds.h, ds.s, q0, BQ, S, hd);
  stage_rows<NT>(lse_s, delta_s, lse + bh * S, delta + bh * S, q0, BQ, S);

  // key tiles holding an unmasked key for some row of the tile
  int kt_hi = (S + BK - 1) / BK;
  if (causal) kt_hi = min(kt_hi, (min(q0 + BQ, S) + BK - 1) / BK);
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  float aq[RQ][NJ];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) aq[i][j] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and dS are read
    stage<T, D, NT>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, BK, S, hd);
    stage<T, D, NT>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, BK, S, hd);
    __syncthreads();

    // P = exp(scale Q K^T - lse) under the masks
    float p[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) p[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty * RQ + i) * L + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = Ks[(tx + 16 * j) * L + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) p[i][j] = fmaf(qv[i], kv[j], p[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int r = ty * RQ + i;
        p[i][j] = unmasked(q0 + r, k0 + tx + 16 * j, S, causal, window)
                      ? expf(p[i][j] * scale - lse_s[r])
                      : 0.f;
      }

    // dS = P * (dO V^T - delta)
    float dp[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float dov[RQ], vv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dov[i] = dOs[(ty * RQ + i) * L + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) vv[j] = Vs[(tx + 16 * j) * L + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int r = ty * RQ + i;
        dSs[r * LS + tx + 16 * j] = p[i][j] * (dp[i][j] - delta_s[r]);
      }
    __syncthreads();

    // dQ += dS K (the scale at the store)
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sv[RQ], kv[NJ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) sv[i] = dSs[(ty * RQ + i) * LS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = Ks[kk * L + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) aq[i][j] = fmaf(sv[i], kv[j], aq[i][j]);
    }
  }

  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qpos = q0 + ty * RQ + i;
    if (qpos < S) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (tx + 16 * j < hd)
          dqb[qpos * dqs.s + tx + 16 * j] = from_f32<T>(aq[i][j] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA cores, head dims past 256: column passes, f32 and bf16
// ---------------------------------------------------------------------------

// The CUDA-core passes at a head dim hd past 256, in Cfg<kCW>'s geometry
// and shared memory: each block owns a column pass [c0, c0 + kCW) of its
// rows' gradients.  For each tile pair it sums S (S^T) and dP (dP^T) over
// the row's chunks of kCW columns, staging the four operands' chunk
// together, then makes P and dS as the passes above and accumulates its
// pass's columns from the operand chunk of those columns (restaged unless
// it is the last chunk, still in place).  No block writes another's
// columns; the scale is in dK and dQ at the store.
constexpr int kCW = 256;
using CW = Cfg<kCW>;

// (b) the column pass of dK and dV of one (64-key tile, kv head, batch)
template <typename T>
__global__ void __launch_bounds__(CW::NT)
flash_bwd_dkdv_cols(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int H, int KH, int B, int S, int hd,
                    int n_pass, Strides qs, Strides ks, Strides vs,
                    Strides ds, Strides dks, Strides dvs, int causal,
                    int window, float scale) {
  constexpr int D = kCW, L = CW::L, LP = CW::BQ + 1, RK = CW::RK,
                CQ = CW::CQ, NJ = CW::NJ, BQ = CW::BQ, BK = CW::BK,
                NT = CW::NT;
  extern __shared__ float smem[];
  float* Ks = smem;               // [BK][L]: a chunk
  float* Vs = Ks + BK * L;        // [BK][L]: a chunk
  float* Qs = Vs + BK * L;        // [BQ][L]: a chunk
  float* dOs = Qs + BQ * L;       // [BQ][L]: a chunk
  float* Ps = dOs + BQ * L;       // [BK][LP]: P^T
  float* dSs = Ps + BK * LP;      // [BK][LP]: dS^T
  float* lse_s = dSs + BK * LP;   // [BQ]
  float* delta_s = lse_s + BQ;    // [BQ]

  const int pass = static_cast<int>(blockIdx.x) % n_pass;
  const int blk = static_cast<int>(blockIdx.x) / n_pass;
  const int kt = blk / (KH * B), rem = blk % (KH * B);
  const int hk = rem % KH, b = rem / KH, g = H / KH;
  const int k0 = kt * BK;
  const int nc = (hd + D - 1) / D, c0 = pass * D, pw = min(D, hd - c0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  const int kmax = min(k0 + BK, S) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, kmax + window) : S;
  const int qt_lo = q_lo / BQ, qt_hi = (q_hi + BQ - 1) / BQ;

  float akk[RK][NJ], avv[RK][NJ];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) akk[i][j] = avv[i][j] = 0.f;

  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int q0 = qt * BQ;
    for (int hh = 0; hh < g; ++hh) {
      const int h = hk * g + hh;
      const long long bh = static_cast<long long>(b) * H + h;
      const T* qb = q + b * qs.b + h * qs.h;
      const T* db = dout + b * ds.b + h * ds.h;
      float st[RK][CQ], dpt[RK][CQ];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) st[i][j] = dpt[i][j] = 0.f;
      for (int kc = 0; kc < nc; ++kc) {
        const int cw = min(D, hd - kc * D);
        __syncthreads();  // the previous chunk's (tile pair's) tiles are read
        stage<T, D, NT>(Ks, kb + kc * D, ks.s, k0, BK, S, cw);
        stage<T, D, NT>(Vs, vb + kc * D, vs.s, k0, BK, S, cw);
        stage<T, D, NT>(Qs, qb + kc * D, qs.s, q0, BQ, S, cw);
        stage<T, D, NT>(dOs, db + kc * D, ds.s, q0, BQ, S, cw);
        if (kc == 0)
          stage_rows<NT>(lse_s, delta_s, lse + bh * S, delta + bh * S, q0,
                         BQ, S);
        __syncthreads();
#pragma unroll 4
        for (int d = 0; d < cw; ++d) {
          float kv[RK], vv[RK], qv[CQ], dov[CQ];
#pragma unroll
          for (int i = 0; i < RK; ++i) {
            kv[i] = Ks[(ty * RK + i) * L + d];
            vv[i] = Vs[(ty * RK + i) * L + d];
          }
#pragma unroll
          for (int j = 0; j < CQ; ++j) {
            qv[j] = Qs[(tx + 16 * j) * L + d];
            dov[j] = dOs[(tx + 16 * j) * L + d];
          }
#pragma unroll
          for (int i = 0; i < RK; ++i)
#pragma unroll
            for (int j = 0; j < CQ; ++j) {
              st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
              dpt[i][j] = fmaf(vv[i], dov[j], dpt[i][j]);
            }
        }
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          const int kpos = k0 + ty * RK + i, qc = tx + 16 * j;
          const int at = (ty * RK + i) * LP + qc;
          const float p = unmasked(q0 + qc, kpos, S, causal, window)
                              ? expf(st[i][j] * scale - lse_s[qc])
                              : 0.f;
          Ps[at] = p;
          dSs[at] = p * (dpt[i][j] - delta_s[qc]);
        }
      __syncthreads();
      if (pass != nc - 1) {  // the pass's columns of Q and dO
        stage<T, D, NT>(Qs, qb + c0, qs.s, q0, BQ, S, pw);
        stage<T, D, NT>(dOs, db + c0, ds.s, q0, BQ, S, pw);
        __syncthreads();
      }

      // dV += P^T dO, dK += dS^T Q over the pass's columns
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[RK], sv[RK], dov[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pv[i] = Ps[(ty * RK + i) * LP + qq];
          sv[i] = dSs[(ty * RK + i) * LP + qq];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dov[j] = dOs[qq * L + tx + 16 * j];
          qv[j] = Qs[qq * L + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            avv[i][j] = fmaf(pv[i], dov[j], avv[i][j]);
            akk[i][j] = fmaf(sv[i], qv[j], akk[i][j]);
          }
      }
    }
  }

  T* dkb = dk + b * dks.b + hk * dks.h + c0;
  T* dvb = dv + b * dvs.b + hk * dvs.h + c0;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kpos = k0 + ty * RK + i;
    if (kpos < S) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (tx + 16 * j >= pw) continue;
        dkb[kpos * dks.s + tx + 16 * j] = from_f32<T>(akk[i][j] * scale);
        dvb[kpos * dvs.s + tx + 16 * j] = from_f32<T>(avv[i][j]);
      }
    }
  }
}

// (c) the column pass of dQ of one (query tile, head, batch)
template <typename T>
__global__ void __launch_bounds__(CW::NT)
flash_bwd_dq_cols(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq, int H,
                  int KH, int B, int S, int hd, int n_pass, Strides qs,
                  Strides ks, Strides vs, Strides ds, Strides dqs, int causal,
                  int window, float scale) {
  constexpr int D = kCW, L = CW::L, LS = CW::BK + 1, RQ = CW::RQ,
                CK = CW::CK, NJ = CW::NJ, BQ = CW::BQ, BK = CW::BK,
                NT = CW::NT;
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][L]: a chunk
  float* dOs = Qs + BQ * L;       // [BQ][L]: a chunk
  float* Ks = dOs + BQ * L;       // [BK][L]: a chunk
  float* Vs = Ks + BK * L;        // [BK][L]: a chunk
  float* dSs = Vs + BK * L;       // [BQ][LS]
  float* lse_s = dSs + BQ * LS;   // [BQ]
  float* delta_s = lse_s + BQ;    // [BQ]

  const int pass = static_cast<int>(blockIdx.x) % n_pass;
  const int blk = static_cast<int>(blockIdx.x) / n_pass;
  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = n_qt - 1 - blk / (H * B);
  const int hb = blk % (H * B);
  const int h = hb % H, b = hb / H, hk = h / (H / KH);
  const int q0 = qt * BQ;
  const int nc = (hd + D - 1) / D, c0 = pass * D, pw = min(D, hd - c0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long bh = static_cast<long long>(b) * H + h;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* db = dout + b * ds.b + h * ds.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  stage_rows<NT>(lse_s, delta_s, lse + bh * S, delta + bh * S, q0, BQ, S);

  int kt_hi = (S + BK - 1) / BK;
  if (causal) kt_hi = min(kt_hi, (min(q0 + BQ, S) + BK - 1) / BK);
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  float aq[RQ][NJ];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) aq[i][j] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    float p[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) p[i][j] = dp[i][j] = 0.f;
    for (int kc = 0; kc < nc; ++kc) {
      const int cw = min(D, hd - kc * D);
      __syncthreads();  // the previous chunk's (tile's) tiles are read
      stage<T, D, NT>(Qs, qb + kc * D, qs.s, q0, BQ, S, cw);
      stage<T, D, NT>(dOs, db + kc * D, ds.s, q0, BQ, S, cw);
      stage<T, D, NT>(Ks, kb + kc * D, ks.s, k0, BK, S, cw);
      stage<T, D, NT>(Vs, vb + kc * D, vs.s, k0, BK, S, cw);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < cw; ++d) {
        float qv[RQ], dov[RQ], kv[CK], vv[CK];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          qv[i] = Qs[(ty * RQ + i) * L + d];
          dov[i] = dOs[(ty * RQ + i) * L + d];
        }
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          kv[j] = Ks[(tx + 16 * j) * L + d];
          vv[j] = Vs[(tx + 16 * j) * L + d];
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < CK; ++j) {
            p[i][j] = fmaf(qv[i], kv[j], p[i][j]);
            dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int r = ty * RQ + i;
        const float pr = unmasked(q0 + r, k0 + tx + 16 * j, S, causal, window)
                             ? expf(p[i][j] * scale - lse_s[r])
                             : 0.f;
        dSs[r * LS + tx + 16 * j] = pr * (dp[i][j] - delta_s[r]);
      }
    __syncthreads();
    if (pass != nc - 1) {  // the pass's columns of K
      stage<T, D, NT>(Ks, kb + c0, ks.s, k0, BK, S, pw);
      __syncthreads();
    }

    // dQ += dS K over the pass's columns
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sv[RQ], kv[NJ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) sv[i] = dSs[(ty * RQ + i) * LS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = Ks[kk * L + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) aq[i][j] = fmaf(sv[i], kv[j], aq[i][j]);
    }
  }

  T* dqb = dq + b * dqs.b + h * dqs.h + c0;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qpos = q0 + ty * RQ + i;
    if (qpos < S) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (tx + 16 * j < pw)
          dqb[qpos * dqs.s + tx + 16 * j] = from_f32<T>(aq[i][j] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at every D: tensor cores (wgmma), tiles fed by TMA
// ---------------------------------------------------------------------------

namespace tc {

using namespace attn;  // the Hopper helpers

constexpr int kRows = 64;                   // rows of a product, a streamed tile
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
constexpr float kLog2e = 1.4426950408889634f;
// named barriers between the consumer warpgroups of the D-256 geometry
// (0 is __syncthreads'): P (P^T) written to exchange buffer b, at kBarP
// + b; buffer b read, at kBarRead + b (dK/dV pass); dS written (dQ pass)
constexpr int kBarP = 1, kBarRead = 3, kBarDs = 5;

// The block's geometry at head dim D (the source's header): up to D 128
// a block owns 128 rows, 64 a consumer warpgroup, and three stages
// stream; at D 256 (SPLIT) it owns 64 rows, both warpgroups' rows, two
// stages stream, and the warpgroups split each tile pair's products,
// handing P or dS over through two exchange buffers of 32 words a
// consumer thread ([register][thread]).  Shared memory: the two own
// tiles, the stages and their (lse, delta) rows (read in the dK/dV pass),
// the exchange buffers, the mbarriers.  A tile holds its main part's
// boxes, then at D 80 and 96 its tail box (Cols<D>; at D 112 its two
// boxes take D 128's bytes).
template <int D>
struct Geom {
  static constexpr bool SPLIT = D > 128;
  static constexpr int OWN_ROWS = SPLIT ? kRows : 2 * kRows;
  static constexpr int STAGES = SPLIT ? 2 : 3;
  static constexpr int OWN_BYTES = OWN_ROWS * Cols<D>::ROW_BYTES;
  static constexpr int TILE_BYTES = kRows * Cols<D>::ROW_BYTES;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int ROWS_BYTES = 2 * kRows * 4;
  static constexpr int XCHG_WORDS = 32 * 128;  // one buffer
  static constexpr int XCHG_BYTES = SPLIT ? 2 * XCHG_WORDS * 4 : 0;
  static constexpr int BAR_BYTES = 8 * (1 + 2 * STAGES);
  // the tiles start on a 1024-byte boundary (the swizzle pattern's period;
  // every tile's main part and tail box is a multiple of it)
  static constexpr int SMEM = 1024 + 2 * OWN_BYTES +
                              STAGES * (STAGE_BYTES + ROWS_BYTES) +
                              XCHG_BYTES + BAR_BYTES;
  static_assert(SMEM <= 232448, "shared memory");
};

// The shared-memory map of a block: own tiles at `own0`, `own1`; stage s at
// stage(s) (its two tiles one after the other) with its rows at rows(s);
// the exchange buffers at `xchg` (SPLIT); the barrier of the own tiles,
// full(s) and empty(s).
template <int D>
struct Smem {
  using G = Geom<D>;
  uint32_t own0, own1, stage0, rows0, bar;
  float* rows_ptr;
  float* xchg;
  __device__ __forceinline__ explicit Smem(uint8_t* raw) {
    const uint32_t base = smem_u32(raw);
    own0 = (base + 1023) & ~1023u;
    own1 = own0 + G::OWN_BYTES;
    stage0 = own1 + G::OWN_BYTES;
    rows0 = stage0 + G::STAGES * G::STAGE_BYTES;
    const uint32_t xchg0 = rows0 + G::STAGES * G::ROWS_BYTES;
    bar = xchg0 + G::XCHG_BYTES;
    rows_ptr = reinterpret_cast<float*>(raw + (rows0 - base));
    xchg = reinterpret_cast<float*>(raw + (xchg0 - base));
  }
  __device__ __forceinline__ uint32_t stage(int s) const {
    return stage0 + s * G::STAGE_BYTES;
  }
  __device__ __forceinline__ float* rows(int s) const {
    return rows_ptr + s * 2 * kRows;
  }
  __device__ __forceinline__ uint32_t full(int s) const {
    return bar + 8 * (1 + s);
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bar + 8 * (1 + G::STAGES + s);
  }
  // thread 0: the barriers, `full_count` arrivals completing a full phase
  __device__ __forceinline__ void init(int full_count) const {
    mbar_init(bar, 1);
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(full(s), full_count);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// named barrier `id` over the 256 consumer threads: wait at it, or arrive
// and go on; every thread of a warpgroup executes the same one
__device__ __forceinline__ void bar_sync(int id) {
  static_assert(kConsumers == 256, "the barriers' thread count");
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// rows kr0 and kr0 + 8 of an accumulator of N columns times `scale`,
// columns (c0, c0 + 1) of each 8-column group, stored as bf16 from column
// col0 of `dst` (row stride `stride`), but none at or past column hd
// (even, as every column pair's first)
template <int N>
__device__ __forceinline__ void store_cols(__nv_bfloat16* dst,
                                           long long stride, int kr0, int c0,
                                           int S, const float (&acc)[N / 2],
                                           int col0, float scale, int hd) {
#pragma unroll
  for (int j = 0; j < N / 2; j += 2) {
    const int row = kr0 + 8 * ((j >> 1) & 1), col = col0 + 8 * (j / 4) + c0;
    if (row < S && col < hd)
      *reinterpret_cast<__nv_bfloat162*>(dst + row * stride + col) =
          __floats2bfloat162_rn(acc[j] * scale, acc[j + 1] * scale);
  }
}

// the main columns' accumulator and the tail's (Cols<D>) of rows kr0 and
// kr0 + 8, stored by store_cols
template <int D>
__device__ __forceinline__ void store_rows(
    __nv_bfloat16* dst, long long stride, int kr0, int c0, int S,
    const float (&acc)[Cols<D>::MAIN / 2],
    const float (&acc_t)[Cols<D>::TAIL > 0 ? Cols<D>::TAIL / 2 : 1],
    float scale, int hd) {
  using C = Cols<D>;
  store_cols<C::MAIN>(dst, stride, kr0, c0, S, acc, 0, scale, hd);
  if constexpr (C::TAIL > 0)
    store_cols<C::TAIL>(dst, stride, kr0, c0, S, acc_t, C::MAIN, scale, hd);
}

// (b) dK and dV of one (key tile, group of a kv head's query heads, kv
// head, batch); one group (n_groups 1) but at D 256, where n_groups > 1
// makes each group write its f32 partial sums to `part` ([dK, dV][group]
// [B][KH][S][hd]) for (d) to add up
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tq_tail,
                    const __grid_constant__ CUtensorMap tk_tail,
                    const __grid_constant__ CUtensorMap tv_tail,
                    const __grid_constant__ CUtensorMap tdo_tail,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, float* __restrict__ part,
                    int H, int KH, int B, int S, int hd, int n_groups,
                    Strides dks, Strides dvs, int causal, int window,
                    float scale, float scale_log2) {
  using G = Geom<D>;
  using C = Cols<D>;
  constexpr int OWN = G::OWN_ROWS, STAGES = G::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const Smem<D> sm(smem_raw);  // own tiles K, V; stages Q, dO

  // key tile 0 first: under the causal mask it sees the most queries
  const int per_tile = n_groups * KH * B;
  const int kt = static_cast<int>(blockIdx.x) / per_tile;
  const int rem = static_cast<int>(blockIdx.x) % per_tile;
  const int hk = rem % KH, b = rem / KH % B, grp = rem / (KH * B);
  const int gn = H / KH / n_groups;     // the group's query heads
  const int h0 = hk * (H / KH) + grp * gn;
  const int k0 = kt * OWN;
  // the query tiles holding a query that sees a key of the block, each
  // once for every query head of the group
  const int kmax = min(k0 + OWN, S) - 1;
  const int qt_lo = (causal ? k0 : 0) / kRows;
  const int qt_hi =
      ((window > 0 ? min(S, kmax + window) : S) + kRows - 1) / kRows;
  const int n_iter = (qt_hi - qt_lo) * gn;

  const int tid = threadIdx.x;
  if (tid == 0) sm.init(32);  // every lane of the producer warp arrives
  __syncthreads();

  if (tid >= kConsumers) {  // producer warpgroup: its first warp loads
    setmaxnreg_dec<kProducerRegs>();
    if (tid >= kConsumers + 32) return;
    const int lane = tid - kConsumers;
    if (lane == 0) {
      mbar_expect_tx(sm.bar, 2 * G::OWN_BYTES);
      load_tile<D>(sm.own0, &tk, &tk_tail, sm.bar, OWN, k0, hk, b);
      load_tile<D>(sm.own1, &tv, &tv_tail, sm.bar, OWN, k0, hk, b);
    }
    for (int i = 0; i < n_iter; ++i) {
      const int s = i % STAGES;
      const int q0 = (qt_lo + i / gn) * kRows, h = h0 + i % gn;
      const long long row0 = (static_cast<long long>(b) * H + h) * S + q0;
      mbar_wait(sm.empty(s), ((i / STAGES) & 1) ^ 1);
      // lse (in log2 units) and delta of the tile's rows; rows past S as 0
      float* rows = sm.rows(s);
      for (int r = lane; r < kRows; r += 32) {
        const bool in = q0 + r < S;
        rows[r] = in ? lse[row0 + r] * kLog2e : 0.f;
        rows[kRows + r] = in ? delta[row0 + r] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(sm.full(s), G::STAGE_BYTES);
        load_tile<D>(sm.stage(s), &tq, &tq_tail, sm.full(s), kRows, q0, h,
                     b);
        load_tile<D>(sm.stage(s) + G::TILE_BYTES, &tdo, &tdo_tail,
                     sm.full(s), kRows, q0, h, b);
      } else {
        mbar_arrive(sm.full(s));
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  // in the accumulator layout a thread holds rows kr0 and kr0 + 8, columns
  // 8 j + c0 and 8 j + c0 + 1 of each 8-column group j
  const int wg = tid / 128, t = tid % 128, lane = t % 32;
  const int c0 = 2 * (lane % 4);

  if constexpr (G::SPLIT) {
    // The block's 64 keys are both warpgroups' rows.  Warpgroup 0: S^T =
    // K Q^T, P^T to the exchange buffer, dV += P^T dO; warpgroup 1: dP^T
    // = V dO^T, P^T from the buffer, dK += dS^T Q.  Whether a tile is
    // skipped depends on the block's keys alone, so both warpgroups meet
    // the same barriers.
    const int kr0 = k0 + 16 * (t / 32) + lane / 4;
    const Rows64<D> own(wg == 0 ? sm.own0 : sm.own1, OWN, 0);
    float acc[D / 2], unused[1] = {0.f};  // dV (warpgroup 0), dK (1)
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    mbar_wait(sm.bar, 0);

    int n = 0;  // tile pairs handed over
    for (int i = 0; i < n_iter; ++i) {
      const int s = i % STAGES;
      const int q0 = (qt_lo + i / gn) * kRows;
      mbar_wait(sm.full(s), (i / STAGES) & 1);
      const bool skip = (causal && q0 + kRows - 1 < k0) ||
                        (window > 0 && q0 >= kmax + window);
      if (!skip) {
        const uint32_t sq = sm.stage(s), sdo = sq + G::TILE_BYTES;
        const float* rows = sm.rows(s);
        float* buf = sm.xchg + (n & 1) * G::XCHG_WORDS;
        float x[32];  // S^T (warpgroup 0) or dP^T (warpgroup 1)
#pragma unroll
        for (int j = 0; j < 32; ++j) x[j] = 0.f;
        wg_fence();
        wgmma_over_d<D>(x, own, OWN, Rows64<D>(wg == 0 ? sq : sdo, kRows, 0),
                        kRows);
        wg_commit();
        wg_wait();
        reg_fence(x);
        uint32_t hi[16], lo[16];  // P^T or dS^T in the A-fragment layout
        if (wg == 0) {
          const bool edge = (causal && q0 < k0 + kRows - 1) ||
                            (window > 0 && q0 + kRows - 1 >= k0 + window) ||
                            q0 + kRows > S || k0 + kRows > S;
          // P^T in place of S^T; column j of the accumulator is query
          // column 8 (j / 4) + c0 + (j & 1) of the tile
#pragma unroll
          for (int j = 0; j < 32; j += 2) {
            const int col = 8 * (j / 4) + c0;
            const float2 l2 = *reinterpret_cast<const float2*>(rows + col);
            x[j] = exp2f(fmaf(x[j], scale_log2, -l2.x));
            x[j + 1] = exp2f(fmaf(x[j + 1], scale_log2, -l2.y));
            if (edge) {
              const int kpos = kr0 + 8 * ((j >> 1) & 1), qpos = q0 + col;
              if (!unmasked(qpos, kpos, S, causal, window)) x[j] = 0.f;
              if (!unmasked(qpos + 1, kpos, S, causal, window))
                x[j + 1] = 0.f;
            }
          }
          // the twin has read what this buffer held two tile pairs ago
          if (n >= 2) bar_sync(kBarRead + (n & 1));
#pragma unroll
          for (int j = 0; j < 32; ++j) buf[j * 128 + t] = x[j];
          bar_arrive(kBarP + (n & 1));
#pragma unroll
          for (int j = 0; j < 32; j += 2)
            split_bf16(x[j], x[j + 1], hi[j / 2], lo[j / 2]);
        } else {
          bar_sync(kBarP + (n & 1));
#pragma unroll
          for (int j = 0; j < 32; j += 2) {
            const float2 d2 = *reinterpret_cast<const float2*>(
                rows + kRows + 8 * (j / 4) + c0);
            split_bf16(buf[j * 128 + t] * (x[j] - d2.x),
                       buf[(j + 1) * 128 + t] * (x[j + 1] - d2.y),
                       hi[j / 2], lo[j / 2]);
          }
          bar_arrive(kBarRead + (n & 1));
        }

        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk)
          // queries 16 kk .. 16 kk + 15 of the dO (Q) tile, read N-major
          wgmma_rs_d<D>(acc, unused, hi + 4 * kk, lo + 4 * kk,
                        wg == 0 ? sdo : sq, kRows, kk);
        wg_commit();
        wg_wait();
        reg_fence(acc);
        ++n;
      }
      mbar_arrive(sm.empty(s));
    }
    // the reads of the last two hand-overs: every arrival has its wait
    if (wg == 0)
      for (int m = max(0, n - 2); m < n; ++m) bar_sync(kBarRead + (m & 1));

    if (n_groups == 1) {
      if (wg == 0)
        store_rows<D>(dv + b * dvs.b + hk * dvs.h, dvs.s, kr0, c0, S, acc,
                      unused, 1.f, hd);
      else
        store_rows<D>(dk + b * dks.b + hk * dks.h, dks.s, kr0, c0, S, acc,
                      unused, scale, hd);
      return;
    }
    float* dst = part + ((static_cast<long long>(wg == 0) * n_groups + grp) *
                             B * KH + b * KH + hk) *
                            S * hd;
#pragma unroll
    for (int j = 0; j < D / 2; j += 2) {
      const int row = kr0 + 8 * ((j >> 1) & 1), col = 8 * (j / 4) + c0;
      if (row < S && col < hd)
        *reinterpret_cast<float2*>(dst + static_cast<long long>(row) * hd +
                                   col) = make_float2(acc[j], acc[j + 1]);
    }
  } else {
    // warpgroup wg owns keys [wk0, wk0 + 64)
    const int wk0 = k0 + kRows * wg, wk_hi = min(wk0 + kRows, S);
    const int kr0 = wk0 + 16 * (t / 32) + lane / 4;
    const Rows64<D> ka(sm.own0, OWN, kRows * wg);
    const Rows64<D> va(sm.own1, OWN, kRows * wg);
    // dK and dV: the main columns', and the tail's (unused at TAIL 0)
    constexpr int NT = C::TAIL > 0 ? C::TAIL / 2 : 1;
    float acc_k[C::MAIN / 2], acc_v[C::MAIN / 2], acc_kt[NT], acc_vt[NT];
#pragma unroll
    for (int j = 0; j < C::MAIN / 2; ++j) acc_k[j] = acc_v[j] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) acc_kt[j] = acc_vt[j] = 0.f;
    mbar_wait(sm.bar, 0);

    for (int i = 0; i < n_iter; ++i) {
      const int s = i % STAGES;
      const int q0 = (qt_lo + i / gn) * kRows;
      mbar_wait(sm.full(s), (i / STAGES) & 1);
      // skip a tile whose pairs the masks cover wholly: keys past S, every
      // query before every key, or every query past its keys' window
      const bool skip = wk0 >= S || (causal && q0 + kRows - 1 < wk0) ||
                        (window > 0 && q0 >= wk_hi - 1 + window);
      if (!skip) {
        const uint32_t sq = sm.stage(s), sdo = sq + G::TILE_BYTES;
        float st[32], dpt[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.f;
        wg_fence();
        wgmma_over_d<D>(st, ka, OWN, Rows64<D>(sq, kRows, 0), kRows);
        wg_commit();
        wgmma_over_d<D>(dpt, va, OWN, Rows64<D>(sdo, kRows, 0), kRows);
        wg_commit();
        wg_wait<1>();  // S^T is in; dP^T runs on while P^T is computed
        reg_fence(st);

        const bool edge = (causal && q0 < wk0 + kRows - 1) ||
                          (window > 0 && q0 + kRows - 1 >= wk0 + window) ||
                          q0 + kRows > S || wk0 + kRows > S;
        const float* rows = sm.rows(s);
        // P^T in place of S^T; column j of the accumulator is query column
        // 8 (j / 4) + c0 + (j & 1) of the tile
#pragma unroll
        for (int j = 0; j < 32; j += 2) {
          const int col = 8 * (j / 4) + c0;
          const float2 l2 = *reinterpret_cast<const float2*>(rows + col);
          st[j] = exp2f(fmaf(st[j], scale_log2, -l2.x));
          st[j + 1] = exp2f(fmaf(st[j + 1], scale_log2, -l2.y));
          if (edge) {
            const int kpos = kr0 + 8 * ((j >> 1) & 1), qpos = q0 + col;
            if (!unmasked(qpos, kpos, S, causal, window)) st[j] = 0.f;
            if (!unmasked(qpos + 1, kpos, S, causal, window)) st[j + 1] = 0.f;
          }
        }
        wg_wait();
        reg_fence(dpt);
        // P^T and dS^T in the A-fragment layout: pair j / 2 holds columns
        // (j, j + 1)
        uint32_t phi[16], plo[16], shi[16], slo[16];
#pragma unroll
        for (int j = 0; j < 32; j += 2) {
          const float2 d2 = *reinterpret_cast<const float2*>(
              rows + kRows + 8 * (j / 4) + c0);
          split_bf16(st[j], st[j + 1], phi[j / 2], plo[j / 2]);
          split_bf16(st[j] * (dpt[j] - d2.x), st[j + 1] * (dpt[j + 1] - d2.y),
                     shi[j / 2], slo[j / 2]);
        }

        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          // queries 16 kk .. 16 kk + 15 of the dO and Q tiles, read N-major
          wgmma_rs_d<D>(acc_v, acc_vt, phi + 4 * kk, plo + 4 * kk, sdo, kRows,
                        kk);
          wgmma_rs_d<D>(acc_k, acc_kt, shi + 4 * kk, slo + 4 * kk, sq, kRows,
                        kk);
        }
        wg_commit();
        wg_wait();
        reg_fence(acc_k);
        reg_fence(acc_v);
        if constexpr (C::TAIL > 0) {
          reg_fence(acc_kt);
          reg_fence(acc_vt);
        }
      }
      mbar_arrive(sm.empty(s));
    }

    if (wk0 >= S) return;
    store_rows<D>(dk + b * dks.b + hk * dks.h, dks.s, kr0, c0, S, acc_k,
                  acc_kt, scale, hd);
    store_rows<D>(dv + b * dvs.b + hk * dvs.h, dvs.s, kr0, c0, S, acc_v,
                  acc_vt, 1.f, hd);
  }
}

// (c) dQ of one (query tile, head, batch): 128 queries, or 64 at D 256
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tq_tail,
                  const __grid_constant__ CUtensorMap tk_tail,
                  const __grid_constant__ CUtensorMap tv_tail,
                  const __grid_constant__ CUtensorMap tdo_tail,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int H, int KH, int B, int S,
                  int hd, Strides dqs, int causal, int window, float scale,
                  float scale_log2) {
  using G = Geom<D>;
  using C = Cols<D>;
  constexpr int OWN = G::OWN_ROWS, STAGES = G::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const Smem<D> sm(smem_raw);  // own tiles Q, dO; stages K, V

  // longest query tiles first: the query tile is the slowest-varying index
  const int n_qt = (S + OWN - 1) / OWN;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / (H * B);
  const int hb = static_cast<int>(blockIdx.x) % (H * B);
  const int h = hb % H, b = hb / H, hk = h / (H / KH);
  const int q0 = qt * OWN;
  int lo, hi;  // the 64-key tiles of the block
  key_tiles<kRows>(q0, min(q0 + OWN, S), S, causal, window, lo, hi);

  const int tid = threadIdx.x;
  if (tid == 0) sm.init(1);
  __syncthreads();

  if (tid >= kConsumers) {  // producer warpgroup: one lane loads
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      mbar_expect_tx(sm.bar, 2 * G::OWN_BYTES);
      load_tile<D>(sm.own0, &tq, &tq_tail, sm.bar, OWN, q0, h, b);
      load_tile<D>(sm.own1, &tdo, &tdo_tail, sm.bar, OWN, q0, h, b);
      for (int i = 0, kt = lo; kt < hi; ++i, ++kt) {
        const int s = i % STAGES;
        mbar_wait(sm.empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(sm.full(s), G::STAGE_BYTES);
        load_tile<D>(sm.stage(s), &tk, &tk_tail, sm.full(s), kRows,
                     kt * kRows, hk, b);
        load_tile<D>(sm.stage(s) + G::TILE_BYTES, &tv, &tv_tail, sm.full(s),
                     kRows, kt * kRows, hk, b);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  // a thread holds rows r0 and r0 + 8 of the accumulators
  const int wg = tid / 128, t = tid % 128, lane = t % 32;
  // the rows of warpgroup wg: [wr_lo, wr_hi); at D 256 both warpgroups'
  const int wr_lo = q0 + (G::SPLIT ? 0 : kRows * wg);
  const int wr_hi = min(wr_lo + kRows, S);
  const int r0 = wr_lo + 16 * (t / 32) + lane / 4, c0 = 2 * (lane % 4);
  const long long row0 = (static_cast<long long>(b) * H + h) * S;
  float lse2[2], dl[2];  // lse (log2 units) and delta of rows r0, r0 + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    lse2[r] = row < S ? lse[row0 + row] * kLog2e : 0.f;
    dl[r] = row < S ? delta[row0 + row] : 0.f;
  }

  if constexpr (G::SPLIT) {
    // The block's 64 queries are both warpgroups' rows.  Warpgroup 0: S =
    // Q K^T, P to the exchange buffer, dS (hi, lo) from the other one;
    // warpgroup 1: dP = dO V^T, P from the buffer, dS to the other one.
    // Each accumulates dQ += dS K over D / 2 columns from column D / 2 wg,
    // the K tile's boxes 2 wg and 2 wg + 1.
    const Rows64<D> own(wg == 0 ? sm.own0 : sm.own1, OWN, 0);
    float acc[D / 4];
#pragma unroll
    for (int j = 0; j < D / 4; ++j) acc[j] = 0.f;
    float* px = sm.xchg;
    uint32_t* sx = reinterpret_cast<uint32_t*>(sm.xchg + G::XCHG_WORDS);
    mbar_wait(sm.bar, 0);

    for (int i = 0, kt = lo; kt < hi; ++i, ++kt) {
      const int s = i % STAGES;
      mbar_wait(sm.full(s), (i / STAGES) & 1);
      const uint32_t sk = sm.stage(s), sv = sk + G::TILE_BYTES;
      float x[32];  // S (warpgroup 0) or dP (warpgroup 1)
#pragma unroll
      for (int j = 0; j < 32; ++j) x[j] = 0.f;
      wg_fence();
      wgmma_over_d<D>(x, own, OWN, Rows64<D>(wg == 0 ? sk : sv, kRows, 0),
                      kRows);
      wg_commit();
      wg_wait();
      reg_fence(x);
      uint32_t shi[16], slo[16];  // dS in the A-fragment layout
      if (wg == 0) {
        const int k0 = kt * kRows;
        const bool edge = (causal && k0 + kRows - 1 > wr_lo) ||
                          (window > 0 && k0 <= wr_hi - 1 - window) ||
                          k0 + kRows > S;
#pragma unroll
        for (int j = 0; j < 32; j += 2) {  // P in place of S
          const int r = (j >> 1) & 1;
          x[j] = exp2f(fmaf(x[j], scale_log2, -lse2[r]));
          x[j + 1] = exp2f(fmaf(x[j + 1], scale_log2, -lse2[r]));
          if (edge) {
            const int kpos = k0 + 8 * (j / 4) + c0, qpos = r0 + 8 * r;
            if (!unmasked(qpos, kpos, S, causal, window)) x[j] = 0.f;
            if (!unmasked(qpos, kpos + 1, S, causal, window)) x[j + 1] = 0.f;
          }
        }
        // the twin read the last P before it wrote the last dS, which this
        // warpgroup read before this P
#pragma unroll
        for (int j = 0; j < 32; ++j) px[j * 128 + t] = x[j];
        bar_arrive(kBarP);
        bar_sync(kBarDs);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          shi[j] = sx[j * 128 + t];
          slo[j] = sx[(16 + j) * 128 + t];
        }
      } else {
        bar_sync(kBarP);
#pragma unroll
        for (int j = 0; j < 32; j += 2) {
          const int r = (j >> 1) & 1;
          split_bf16(px[j * 128 + t] * (x[j] - dl[r]),
                     px[(j + 1) * 128 + t] * (x[j + 1] - dl[r]), shi[j / 2],
                     slo[j / 2]);
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          sx[j * 128 + t] = shi[j];
          sx[(16 + j) * 128 + t] = slo[j];
        }
        bar_arrive(kBarDs);
      }

      wg_fence();
      // this warpgroup's D / 2 columns of the K tile: D / 128 boxes from
      // box D / 128 wg
      const uint32_t kcols = sk + wg * (D / 128) * kRows * Swz<D>::SW;
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        // keys 16 kk .. 16 kk + 15 of the K tile, read N-major
        const uint64_t bd = desc_nmajor<D>(kcols, kRows, kk);
        wgmma_rs<D / 2>(acc, shi + 4 * kk, bd);
        wgmma_rs<D / 2>(acc, slo + 4 * kk, bd);
      }
      wg_commit();
      wg_wait();
      reg_fence(acc);
      mbar_arrive(sm.empty(s));
    }

    store_cols<D / 2>(dq + b * dqs.b + h * dqs.h, dqs.s, r0, c0, S, acc,
                      wg * (D / 2), scale, hd);
  } else {
    int wlo = 0, whi = 0;  // this warpgroup's key tiles (none past S)
    if (wr_lo < S) key_tiles<kRows>(wr_lo, wr_hi, S, causal, window, wlo, whi);
    const Rows64<D> qa(sm.own0, OWN, kRows * wg);
    const Rows64<D> doa(sm.own1, OWN, kRows * wg);
    // dQ: the main columns', and the tail's (unused at TAIL 0)
    constexpr int NT = C::TAIL > 0 ? C::TAIL / 2 : 1;
    float acc[C::MAIN / 2], acc_t[NT];
#pragma unroll
    for (int j = 0; j < C::MAIN / 2; ++j) acc[j] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) acc_t[j] = 0.f;
    mbar_wait(sm.bar, 0);

    for (int i = 0, kt = lo; kt < hi; ++i, ++kt) {
      const int s = i % STAGES;
      mbar_wait(sm.full(s), (i / STAGES) & 1);
      if (kt >= wlo && kt < whi) {
        const uint32_t sk = sm.stage(s), sv = sk + G::TILE_BYTES;
        float sc[32], dp[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
        wg_fence();
        wgmma_over_d<D>(sc, qa, OWN, Rows64<D>(sk, kRows, 0), kRows);
        wg_commit();
        wgmma_over_d<D>(dp, doa, OWN, Rows64<D>(sv, kRows, 0), kRows);
        wg_commit();
        wg_wait<1>();  // S is in; dP runs on while P is computed
        reg_fence(sc);

        const int k0 = kt * kRows;
        const bool edge = (causal && k0 + kRows - 1 > wr_lo) ||
                          (window > 0 && k0 <= wr_hi - 1 - window) ||
                          k0 + kRows > S;
#pragma unroll
        for (int j = 0; j < 32; j += 2) {  // P in place of S
          const int r = (j >> 1) & 1;
          sc[j] = exp2f(fmaf(sc[j], scale_log2, -lse2[r]));
          sc[j + 1] = exp2f(fmaf(sc[j + 1], scale_log2, -lse2[r]));
          if (edge) {
            const int kpos = k0 + 8 * (j / 4) + c0, qpos = r0 + 8 * r;
            if (!unmasked(qpos, kpos, S, causal, window)) sc[j] = 0.f;
            if (!unmasked(qpos, kpos + 1, S, causal, window)) sc[j + 1] = 0.f;
          }
        }
        wg_wait();
        reg_fence(dp);
        uint32_t shi[16], slo[16];  // dS in the A-fragment layout
#pragma unroll
        for (int j = 0; j < 32; j += 2) {
          const int r = (j >> 1) & 1;
          split_bf16(sc[j] * (dp[j] - dl[r]), sc[j + 1] * (dp[j + 1] - dl[r]),
                     shi[j / 2], slo[j / 2]);
        }

        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk)
          // keys 16 kk .. 16 kk + 15 of the K tile, read N-major
          wgmma_rs_d<D>(acc, acc_t, shi + 4 * kk, slo + 4 * kk, sk, kRows, kk);
        wg_commit();
        wg_wait();
        reg_fence(acc);
        if constexpr (C::TAIL > 0) reg_fence(acc_t);
      }
      mbar_arrive(sm.empty(s));
    }

    if (wr_lo >= S) return;
    store_rows<D>(dq + b * dqs.b + h * dqs.h, dqs.s, r0, c0, S, acc, acc_t,
                  scale, hd);
  }
}

// (d) dK and dV of a dK/dV pass split over n_groups head groups: each
// element the sum of the groups' f32 partials (`part`, [dK, dV][group][B]
// [KH][S][hd]) in group order, dK times `scale`, rounded once; a thread
// takes 4 columns of a row of dK or dV
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_reduce_bf16(const float* __restrict__ part,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int n_groups, int B,
                      int KH, int S, int hd, Strides dks, Strides dvs,
                      float scale) {
  const int CH = hd / 4;  // chunks a row
  const long long rows = static_cast<long long>(B) * KH * S;
  const long long chunks = rows * CH;  // of dK, and of dV
  const long long idx = blockIdx.x * 256ll + threadIdx.x;
  if (idx >= 2 * chunks) return;
  const int which = idx >= chunks;  // 0: dK, 1: dV
  const long long e = idx - which * chunks, row = e / CH;
  const int col = static_cast<int>(e % CH) * 4;
  const float* src = part + (which * n_groups * rows + row) * hd + col;
  float4 a = *reinterpret_cast<const float4*>(src);
  for (int grp = 1; grp < n_groups; ++grp) {
    const float4 x =
        *reinterpret_cast<const float4*>(src + grp * rows * hd);
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  const float sc = which ? 1.f : scale;
  const int s = static_cast<int>(row % S);
  const long long bk = row / S;
  const int hk = static_cast<int>(bk % KH), b = static_cast<int>(bk / KH);
  const Strides st = which ? dvs : dks;
  __nv_bfloat16* dst = (which ? dv : dk) + b * st.b + hk * st.h + s * st.s +
                       col;
  const __nv_bfloat162 v0 = __floats2bfloat162_rn(a.x * sc, a.y * sc);
  const __nv_bfloat162 v1 = __floats2bfloat162_rn(a.z * sc, a.w * sc);
  uint2 out;
  out.x = *reinterpret_cast<const uint32_t*>(&v0);
  out.y = *reinterpret_cast<const uint32_t*>(&v1);
  *reinterpret_cast<uint2*>(dst) = out;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

using attn::kTensorCoresBwd;

struct Views {
  Strides q, k, v, o, dout, dq, dk, dv;
};

template <typename T, int D>
int launch_delta(const float* o, const void* dout, float* delta, int B,
                 int H, int S, int hd, const Views& st, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * H * S;
  const long long blocks = (rows + 3) / 4;
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_delta<T, D><<<static_cast<unsigned>(blocks), 128, 0, stream>>>(
      o, static_cast<const T*>(dout), delta, H, S, hd, rows, st.o, st.dout);
  return static_cast<int>(cudaGetLastError());
}

// f32 on the CUDA cores; plan[1] = the dK/dV pass's blocks
template <int D>
int launch_cc(const void* q, const void* k, const void* v, const float* o,
              const void* dout, const float* lse, float* delta, void* dq,
              void* dk, void* dv, int B, int H, int KH, int S, int hd,
              const Views& st, int causal, int window, float scale,
              int* plan, cudaStream_t stream) {
  using T = float;
  using C = Cfg<D>;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const long long n_dkdv = static_cast<long long>((S + C::BK - 1) / C::BK) *
                           KH * B;
  const long long n_dq = static_cast<long long>((S + C::BQ - 1) / C::BQ) * H *
                         B;
  if (n_dq >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = 1;
  plan[1] = static_cast<int>(n_dkdv);

  int code = launch_delta<T, D>(o, dout, delta, B, H, S, hd, st, stream);
  if (code != 0) return code;

  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM_DKDV);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv<T, D><<<static_cast<unsigned>(n_dkdv), C::NT, C::SMEM_DKDV,
                         stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      H, KH, B, S, hd, st.q, st.k, st.v, st.dout, st.dk, st.dv, causal,
      window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_bwd_dq<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM_DQ);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq<T, D><<<static_cast<unsigned>(n_dq), C::NT, C::SMEM_DQ,
                       stream>>>(tq, tk, tv, tdo, lse, delta,
                                 static_cast<T*>(dq), H, KH, B, S, hd, st.q,
                                 st.k, st.v, st.dout, st.dq, causal, window,
                                 scale);
  return static_cast<int>(cudaGetLastError());
}

// head dims past 256 on the CUDA cores, both dtypes: delta, then the dK/dV
// and dQ passes in n_pass column passes; plan[1] = the dK/dV pass's blocks
template <typename T>
int launch_cols(const void* q, const void* k, const void* v, const float* o,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int B, int H, int KH, int S, int hd,
                int n_pass, const Views& st, int causal, int window,
                float scale, int* plan, cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const long long n_dkdv =
      static_cast<long long>((S + CW::BK - 1) / CW::BK) * KH * B * n_pass;
  const long long n_dq =
      static_cast<long long>((S + CW::BQ - 1) / CW::BQ) * H * B * n_pass;
  if (n_dq >= (1ll << 31) || n_dkdv >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = 1;
  plan[1] = static_cast<int>(n_dkdv);

  int code = launch_delta<T, kCW>(o, dout, delta, B, H, S, hd, st, stream);
  if (code != 0) return code;

  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_cols<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      CW::SMEM_DKDV);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_cols<T><<<static_cast<unsigned>(n_dkdv), CW::NT,
                           CW::SMEM_DKDV, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      H, KH, B, S, hd, n_pass, st.q, st.k, st.v, st.dout, st.dk, st.dv,
      causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_bwd_dq_cols<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CW::SMEM_DQ);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_cols<T><<<static_cast<unsigned>(n_dq), CW::NT, CW::SMEM_DQ,
                         stream>>>(tq, tk, tv, tdo, lse, delta,
                                   static_cast<T*>(dq), H, KH, B, S, hd,
                                   n_pass, st.q, st.k, st.v, st.dout, st.dq,
                                   causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16 on the tensor cores, the dK/dV pass over n_groups head groups (1
// but at D 256; more need `part`, n_groups x B x KH x S x hd x 2 f32);
// plan = {n_groups, the dK/dV pass's blocks}
template <int D>
int launch_tc(const void* q, const void* k, const void* v, const float* o,
              const void* dout, const float* lse, float* delta, void* dq,
              void* dk, void* dv, float* part, int B, int H, int KH, int S,
              int hd, int n_groups, const Views& st, int causal, int window,
              float scale, int* plan, cudaStream_t stream) {
  using G = tc::Geom<D>;
  using tc::kRows;
  constexpr int OWN = G::OWN_ROWS;
  if (n_groups < 1 || (H / KH) % n_groups != 0 ||
      (n_groups > 1 && (!G::SPLIT || part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the dK/dV pass streams 64-row Q and dO tiles past OWN-row K and V
  // tiles; the dQ pass the other way round.  The maps cover the views' hd
  // columns in the instance's boxes; at D 80 and 96 each has a tail map
  // over its view from column 64 on (Cols<D>).
  CUtensorMap q_s, do_s, k_own, v_own, q_own, do_own, k_s, v_s;
  CUtensorMap q_st{}, do_st{}, k_ownt{}, v_ownt{}, q_ownt{}, do_ownt{},
      k_st{}, v_st{};
  if (!attn::encode_cols<D>(&q_s, &q_st, q, hd, S, H, B, st.q, kRows) ||
      !attn::encode_cols<D>(&do_s, &do_st, dout, hd, S, H, B, st.dout,
                            kRows) ||
      !attn::encode_cols<D>(&k_own, &k_ownt, k, hd, S, KH, B, st.k, OWN) ||
      !attn::encode_cols<D>(&v_own, &v_ownt, v, hd, S, KH, B, st.v, OWN) ||
      !attn::encode_cols<D>(&q_own, &q_ownt, q, hd, S, H, B, st.q, OWN) ||
      !attn::encode_cols<D>(&do_own, &do_ownt, dout, hd, S, H, B, st.dout,
                            OWN) ||
      !attn::encode_cols<D>(&k_s, &k_st, k, hd, S, KH, B, st.k, kRows) ||
      !attn::encode_cols<D>(&v_s, &v_st, v, hd, S, KH, B, st.v, kRows))
    return kErrTensorMap;
  const long long n_tiles = (S + OWN - 1) / OWN;
  const long long n_dkdv = n_tiles * n_groups * KH * B;
  const long long n_reduce =
      (2ll * B * KH * S * (hd / 4) + 255) / 256;  // (d), when split
  if (n_tiles * H * B >= (1ll << 31) || n_dkdv >= (1ll << 31) ||
      n_reduce >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = n_groups;
  plan[1] = static_cast<int>(n_dkdv);

  int code = launch_delta<__nv_bfloat16, D>(o, dout, delta, B, H, S, hd, st,
                                            stream);
  if (code != 0) return code;

  const int bytes = G::SMEM;
  const float scale_log2 = scale * tc::kLog2e;
  cudaError_t err = cudaFuncSetAttribute(
      tc::flash_bwd_dkdv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  tc::flash_bwd_dkdv_bf16<D>
      <<<static_cast<unsigned>(n_dkdv), tc::kThreads, bytes, stream>>>(
          q_s, k_own, v_own, do_s, q_st, k_ownt, v_ownt, do_st, lse, delta,
          static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
          part, H, KH, B, S, hd, n_groups, st.dk, st.dv, causal, window,
          scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (n_groups > 1) {
    tc::flash_bwd_reduce_bf16<D>
        <<<static_cast<unsigned>(n_reduce), 256, 0, stream>>>(
            part, static_cast<__nv_bfloat16*>(dk),
            static_cast<__nv_bfloat16*>(dv), n_groups, B, KH, S, hd, st.dk,
            st.dv, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  err = cudaFuncSetAttribute(tc::flash_bwd_dq_bf16<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  tc::flash_bwd_dq_bf16<D>
      <<<static_cast<unsigned>(n_tiles * H * B), tc::kThreads, bytes,
         stream>>>(q_own, k_s, v_s, do_own, q_ownt, k_st, v_st, do_ownt,
                   lse, delta, static_cast<__nv_bfloat16*>(dq), H, KH, B, S,
                   hd, st.dq, causal, window, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// the instances of width D at head dim hd; *design: 1 for the
// tensor-core kernels, 0 for the CUDA-core ones
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v,
           const float* o, const void* dout, const float* lse, float* delta,
           void* dq, void* dk, void* dv, float* part, int B, int H, int KH,
           int S, int hd, int n_groups, const Views& st, int causal,
           int window, float scale, int* design, int* plan,
           cudaStream_t stream) {
  static_assert(kTensorCoresBwd<D>, "bf16 runs the tensor cores at every D");
  *design = 0;
  if (dtype == 0) {
    if (n_groups != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_cc<D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KH,
                        S, hd, st, causal, window, scale, plan, stream);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  *design = 1;
  return launch_tc<D>(q, k, v, o, dout, lse, delta, dq, dk, dv, part, B, H,
                      KH, S, hd, n_groups, st, causal, window, scale, plan,
                      stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients share
// it); o is f32 (the forward's output before its rounding, from which delta
// is taken).  Strides are in elements, each view's (batch, position, head);
// the D axis is contiguous and every row starts on a 16-byte boundary.  lse
// (the forward's) and delta (scratch) are f32 (B, H, S) contiguous.
// D is the head dim, its rows whole 16-byte chunks, and W the instances it
// runs on: a compiled width at or above it up to 256, 256 past it.
// n_groups: the head groups of the dK/dV pass, 1 but in bf16 at W 256 up
// to D 256, where more need `part`, f32 scratch of n_groups x B x KH x S x
// D x 2.  *design is set to the design launched: 1 = the tensor-core
// kernels (bf16 at every W), 0 = the CUDA-core ones (f32), 2 = the
// CUDA-core column passes (D past 256, both dtypes); plan[0] to the head
// groups and plan[1] to the dK/dV pass's blocks; *instance to the W it
// dispatched on and *passes to its column passes (ceil(D / 256) past 256,
// else 1).
extern "C" int flash_attention_bwd_launch(
    int device, int dtype, const void* q, const void* k, const void* v,
    const float* o, const void* dout, const float* lse, float* delta,
    void* dq, void* dk, void* dv, float* part, int B, int H, int KH, int S,
    int D, int W, int n_groups, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, long long dsb,
    long long dss, long long dsh, long long dqsb, long long dqss,
    long long dqsh, long long dksb, long long dkss, long long dksh,
    long long dvsb, long long dvss, long long dvsh, int causal, int window,
    float scale, int* design, int* plan, int* instance, int* passes,
    cudaStream_t stream) {
  *design = 0;
  *instance = 0;
  *passes = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = plan[1] = 0;
  if (B == 0 || S == 0 || H == 0) return 0;
  if (D < 1 || (D <= 256 ? D > W : W != 256) ||
      D * (dtype ? 2 : 4) % 16 != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Views st{{qsb, qss, qsh},    {ksb, kss, ksh},    {vsb, vss, vsh},
                 {osb, oss, osh},    {dsb, dss, dsh},    {dqsb, dqss, dqsh},
                 {dksb, dkss, dksh}, {dvsb, dvss, dvsh}};
  if (D > 256) {
    if (n_groups != 1) return static_cast<int>(cudaErrorInvalidValue);
    *design = 2;
    *instance = 256;
    *passes = (D + kCW - 1) / kCW;
    return dtype == 0
               ? launch_cols<float>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    B, H, KH, S, D, *passes, st, causal,
                                    window, scale, plan, stream)
               : launch_cols<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq,
                                            dk, dv, B, H, KH, S, D, *passes,
                                            st, causal, window, scale, plan,
                                            stream);
  }
  *passes = 1;
  switch (W) {
#define BWD_CASE(WW)                                                        \
  case WW:                                                                  \
    *instance = WW;                                                         \
    return launch<WW>(dtype, q, k, v, o, dout, lse, delta, dq, dk, dv, part, \
                      B, H, KH, S, D, n_groups, st, causal, window, scale,   \
                      design, plan, stream);
    BWD_CASE(32)
    BWD_CASE(64)
    BWD_CASE(80)
    BWD_CASE(96)
    BWD_CASE(112)
    BWD_CASE(128)
    BWD_CASE(256)
#undef BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dynamic shared memory of one block (dtype as above) of the dK/dV
// (which = 0) or the dQ (which = 1) kernel of the instance of width D, 0
// for an unknown width
extern "C" int flash_attention_bwd_smem_bytes(int dtype, int D, int which) {
  switch (D) {
#define BWD_SMEM(DD)                                 \
  case DD:                                           \
    if (dtype) return tc::Geom<DD>::SMEM;            \
    return which ? Cfg<DD>::SMEM_DQ : Cfg<DD>::SMEM_DKDV;
    BWD_SMEM(32)
    BWD_SMEM(64)
    BWD_SMEM(80)
    BWD_SMEM(96)
    BWD_SMEM(112)
    BWD_SMEM(128)
    BWD_SMEM(256)
#undef BWD_SMEM
    default:
      return 0;
  }
}

extern "C" const char* kernel_error_string(int err) {
  if (err == kErrTensorMap) return "cuTensorMapEncodeTiled refused a map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
