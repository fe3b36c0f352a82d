// flash_attention_bwd: the FlashAttention backward of flash_attention.cu.
//
// Replaces the jnp FlashAttention backward of the reference,
// src/repro/models/attention.py (_flash_vjp_bwd, the jax.custom_vjp
// backward of _flash; not a Pallas kernel).  Given q, k, v, the forward's
// output o, its gradient dO and the forward's per-row log-sum-exp `lse`
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
// Design (a first, simple one: f32 FMAs on the CUDA cores at every D, in
// f32 and in bf16).  Three launches, no atomics, so the result does not
// depend on the order the blocks run in:
//  (a) flash_bwd_delta: one warp per row, delta = rowsum(dO * o) in f32.
//  (b) flash_bwd_dkdv: one block per (64-key tile, kv head, batch), the key
//      tiles whose queries see the most keys (the first ones under the
//      causal mask) first.  K and V of the tile are staged once in shared
//      memory as f32; the block loops over the query tiles its masks leave
//      (from the diagonal on under the causal mask, up to the window's
//      reach) and over the g query heads of the group, stages Q and dO of
//      each, recomputes P^T and dS^T for the tile pair (stored in shared
//      memory) and accumulates dK and dV in registers: a thread owns RK
//      key rows x D/16 columns of each.
//  (c) flash_bwd_dq: one block per (query tile, head, batch), the query
//      tiles with the most keys first; Q, dO, lse and delta staged once;
//      a loop over the key tiles its masks leave recomputes P and dP,
//      stores dS in shared memory and accumulates dQ in registers.
// At D 256 the query tile is 32 rows and a block 256 threads, so that the
// staged tiles fit in shared memory and the accumulators in registers.
// The tensor cores (wgmma, with TMA-fed tiles) are left to a later design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using attn::from_f32;
using attn::load_chunk;

struct Strides {  // element strides of a (B, S, heads, D) view
  long long b, s, h;
};

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

// rows [pos0, pos0 + rows) of a (S, D) slice at `src` (row stride
// `stride`) into `dst` as f32 with row pitch D + 1; rows past S as zeros
template <typename T, int D, int NT>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int pos0, int rows,
                                      int S) {
  constexpr int V = 16 / sizeof(T), C = D / V;
  for (int idx = threadIdx.x; idx < rows * C; idx += NT) {
    const int r = idx / C, c = idx % C, pos = pos0 + r;
    float e[V];
    if (pos < S) {
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

// (a) delta[b, h, s] = sum_d dO * o; 4 warps a block, one row a warp
template <typename T, int D>
__global__ void __launch_bounds__(128)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, int H, int S, long long rows,
                Strides os, Strides ds) {
  constexpr int V = 16 / sizeof(T), C = D / V;
  const long long row = blockIdx.x * 4ll + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int s = static_cast<int>(row % S);
  const long long bh = row / S;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  const T* orow = o + b * os.b + h * os.h + s * os.s;
  const T* drow = dout + b * ds.b + h * ds.h + s * ds.s;
  float acc = 0.f;
  for (int c = lane; c < C; c += 32) {
    float eo[V], ed[V];
    load_chunk(orow + c * V, eo);
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
               int S, Strides qs, Strides ks, Strides vs, Strides ds,
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

  stage<T, D, NT>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, BK, S);
  stage<T, D, NT>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, BK, S);

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
      stage<T, D, NT>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, BQ, S);
      stage<T, D, NT>(dOs, dout + b * ds.b + h * ds.h, ds.s, q0, BQ, S);
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
             T* __restrict__ dq, int H, int KH, int B, int S, Strides qs,
             Strides ks, Strides vs, Strides ds, Strides dqs, int causal,
             int window, float scale) {
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

  stage<T, D, NT>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, BQ, S);
  stage<T, D, NT>(dOs, dout + b * ds.b + h * ds.h, ds.s, q0, BQ, S);
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
    stage<T, D, NT>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, BK, S);
    stage<T, D, NT>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, BK, S);
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
        dqb[qpos * dqs.s + tx + 16 * j] = from_f32<T>(aq[i][j] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

struct Views {
  Strides q, k, v, o, dout, dq, dk, dv;
};

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int KH, int S, const Views& st,
           int causal, int window, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(B) * H * S;
  const long long n_delta = (rows + 3) / 4;
  const long long n_dkdv = static_cast<long long>((S + C::BK - 1) / C::BK) *
                           KH * B;
  const long long n_dq = static_cast<long long>((S + C::BQ - 1) / C::BQ) * H *
                         B;
  if (n_delta >= (1ll << 31) || n_dq >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);

  flash_bwd_delta<T, D><<<static_cast<unsigned>(n_delta), 128, 0, stream>>>(
      static_cast<const T*>(o), tdo, delta, H, S, rows, st.o, st.dout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM_DKDV);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv<T, D><<<static_cast<unsigned>(n_dkdv), C::NT, C::SMEM_DKDV,
                         stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      H, KH, B, S, st.q, st.k, st.v, st.dout, st.dk, st.dv, causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_bwd_dq<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM_DQ);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq<T, D><<<static_cast<unsigned>(n_dq), C::NT, C::SMEM_DQ,
                       stream>>>(tq, tk, tv, tdo, lse, delta,
                                 static_cast<T*>(dq), H, KH, B, S, st.q, st.k,
                                 st.v, st.dout, st.dq, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const float* lse,
                 float* delta, void* dq, void* dk, void* dv, int B, int H,
                 int KH, int S, const Views& st, int causal, int window,
                 float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,
                            KH, S, st, causal, window, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, D>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    B, H, KH, S, st, causal, window, scale,
                                    stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout and the gradients
// share it).  Strides are in elements, each view's (batch, position, head);
// the D axis is contiguous and every row starts on a 16-byte boundary.  lse
// (the forward's) and delta (scratch) are f32 (B, H, S) contiguous.
extern "C" int flash_attention_bwd_launch(
    int device, int dtype, const void* q, const void* k, const void* v,
    const void* o, const void* dout, const float* lse, float* delta,
    void* dq, void* dk, void* dv, int B, int H, int KH, int S, int D,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, long long dsb, long long dss, long long dsh,
    long long dqsb, long long dqss, long long dqsh, long long dksb,
    long long dkss, long long dksh, long long dvsb, long long dvss,
    long long dvsh, int causal, int window, float scale,
    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || S == 0 || H == 0) return 0;
  const Views st{{qsb, qss, qsh},    {ksb, kss, ksh},    {vsb, vss, vsh},
                 {osb, oss, osh},    {dsb, dss, dsh},    {dqsb, dqss, dqsh},
                 {dksb, dkss, dksh}, {dvsb, dvss, dvsh}};
  switch (D) {
#define BWD_CASE(DD)                                                         \
  case DD:                                                                   \
    return launch_dtype<DD>(dtype, q, k, v, o, dout, lse, delta, dq, dk, dv, \
                            B, H, KH, S, st, causal, window, scale, stream);
    BWD_CASE(32)
    BWD_CASE(64)
    BWD_CASE(80)
    BWD_CASE(96)
    BWD_CASE(128)
    BWD_CASE(256)
#undef BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dynamic shared memory of one block of the dK/dV (which = 0) or the dQ
// (which = 1) kernel, 0 for an unknown D
extern "C" int flash_attention_bwd_smem_bytes(int D, int which) {
  switch (D) {
#define BWD_SMEM(DD) \
  case DD:           \
    return which ? Cfg<DD>::SMEM_DQ : Cfg<DD>::SMEM_DKDV;
    BWD_SMEM(32)
    BWD_SMEM(64)
    BWD_SMEM(80)
    BWD_SMEM(96)
    BWD_SMEM(128)
    BWD_SMEM(256)
#undef BWD_SMEM
    default:
      return 0;
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
