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
// Design (a simple kernel, right first): one block of 128 threads per
// (64-query tile, head, batch).  The Q tile (pre-scaled) and each 64-key
// K/V tile are staged in shared memory as f32; a thread owns 8 query rows
// x 4 key columns of the score tile and 8 rows x D/16 columns of the
// output, so every product is an f32 FMA on the CUDA cores (no tensor
// cores yet).  The 16 threads of a row group sit in one half-warp, so the
// row max and row sum are shuffle reductions.  On Hopper the blocks run in
// no order, so there is no carry between blocks: the TPU kernel's kv grid
// axis becomes the loop over key tiles inside the block.
//
// Masks: like the reference, a masked score is the finite -1e30 and m
// starts at -1e30, so a row that has seen only masked scores adds exp(0)
// terms that the first valid score wipes (alpha = exp(-1e30 - m) = 0);
// -INFINITY would give exp(-inf + inf) = NaN there.  Key tiles that the
// causal or window mask covers wholly are skipped (they change nothing),
// and padded keys past S score -INFINITY so that they never count.  S need
// not be a multiple of the tile: rows and keys past S are zero-filled and
// never stored.
//
// Bound on an H100 SXM: 4 * B * H * D * (unmasked (q, k) pairs) operations
// over 989 TFLOP/s (bf16) or 67 TFLOP/s (f32, CUDA cores), against the
// bytes of q, k, v and out over 3.35 TB/s.  At the prefill shape (B 2,
// S 4096, H 16, KH 8, D 128, causal) that is about 137 GFLOP, 0.14 ms in
// bf16; this kernel runs its products at the f32 CUDA-core rate, far below
// it.  Tensor cores (mma / wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 8 row groups x 16 column lanes
constexpr float kNegInf = -1e30f;

using attn::from_f32;
using attn::load_chunk;

struct Strides {  // element strides of a (B, S, heads, D) view
  long long b, s, h;
};

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KH,
                 int S, Strides qs, Strides ks, Strides vs, Strides os,
                 int causal, int window, float scale) {
  constexpr int LQ = D + 1, LK = D + 1, LV = D, LP = kBK + 1;
  constexpr int V = 16 / sizeof(T), C = D / V, NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;            // [kBQ][LQ], pre-scaled
  float* Ks = Qs + kBQ * LQ;   // [kBK][LK]
  float* Vs = Ks + kBK * LK;   // [kBK][LV]
  float* Ps = Vs + kBK * LV;   // [kBQ][LP]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / KH);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int idx = tid; idx < kBQ * C; idx += kThreads) {
    const int r = idx / C, c = idx % C, pos = q0 + r;
    float e[V];
    if (pos < S) {
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
      if (pos < S) {
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

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qpos = q0 + ty * 8 + i;
    if (qpos < S) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        ob[qpos * os.s + tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KH, int S, Strides qs, Strides ks, Strides vs,
           Strides os, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, S, qs, ks, vs, os,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             int B, int H, int KH, int S, Strides qs, Strides ks, Strides vs,
             Strides os, int causal, int window, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KH, S, qs, ks, vs, os, causal,
                           window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KH, S, qs, ks, vs, os, causal,
                           window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KH, S, qs, ks, vs, os, causal,
                            window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// Strides are in elements; the D axis is contiguous and every row starts on
// a 16-byte boundary.
extern "C" int flash_attention_launch(
    int device, int dtype, const void* q, const void* k, const void* v,
    void* o, int B, int H, int KH, int S, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long oss, long long osh,
    int causal, int window, float scale, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || S == 0 || H == 0) return 0;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, B, H, KH, S, qs, ks, vs, os, causal,
                           window, scale, stream);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, B, H, KH, S, qs, ks, vs, os,
                                   causal, window, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
