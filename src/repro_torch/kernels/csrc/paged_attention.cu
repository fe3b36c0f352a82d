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
// in f32; output in q's type.  The pools are strided views of
// (NPOOL, page, KH, D) with D contiguous.
//
// Design (a simple kernel, right first): one block of 128 threads per
// (kv head, sequence), serving the g query heads of that kv head, so each
// K/V row is read once from device memory.  The block walks the sequence in
// tiles of 64 positions, whatever the page size: each row's page id comes
// from the block table as it is loaded, and a page may end inside a tile.
// Per tile: K/V rows are staged in shared memory as f32, one thread per
// (head, position) takes the dot product, one warp per head does the
// online-softmax update, and one thread per (head, d) accumulates P.V.
// Only the block-table entries of pages below ceil(length / page) are read;
// entries past that may hold any id.  The TPU kernel carries (m, l, acc)
// across its page grid axis; here that axis is the loop inside the block.
//
// Masks follow the reference: a position at or past the length scores the
// finite -1e30 (a sequence of length <= 0 therefore averages every row of
// its pages, as the reference does), and the padding of the last tile past
// the block table's span scores -INFINITY and never counts.
//
// Bound on an H100 SXM: the K and V rows of the valid positions
// (2 * sum(length) * KH * D * sizeof(T) bytes) over 3.35 TB/s; the
// 4 * sum(length) * H * D operations are far below the line.  At decode_32k
// (B 8, KH 8, D 128, bf16, lengths up to 32768) that is up to 1.07 GB,
// 0.32 ms.  With one block per (kv head, sequence) only B * KH blocks load;
// splitting the sequence across blocks (flash decoding) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_common.cuh"

namespace {

constexpr int kTP = 64;        // positions per tile (two per lane)
constexpr int kThreads = 128;  // four warps
constexpr float kNegInf = -1e30f;

using attn::from_f32;
using attn::load_chunk;

struct Pool {  // element strides of a (NPOOL, page, KH, D) view
  long long p, o, h;
};

template <int D>
size_t smem_bytes(int g) {
  // Qs[g][D], Ks[kTP][D+1], Vs[kTP][D], Ss[g][kTP], Acc[g][D], m/l/alpha[g]
  return sizeof(float) *
         (size_t(g) * D + kTP * (D + 1) + kTP * D + size_t(g) * kTP +
          size_t(g) * D + 3 * size_t(g));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ lengths, T* __restrict__ o,
                    int H, int KH, int page, int NP, long long qsb,
                    long long qsh, Pool ks, Pool vs, long long btsb,
                    long long osb, long long osh, float scale) {
  constexpr int LK = D + 1;
  constexpr int V = 16 / sizeof(T), C = D / V;
  const int g = H / KH;
  extern __shared__ float smem[];
  float* Qs = smem;             // [g][D], pre-scaled
  float* Ks = Qs + g * D;       // [kTP][LK]
  float* Vs = Ks + kTP * LK;    // [kTP][D]
  float* Ss = Vs + kTP * D;     // [g][kTP]: scores, then probabilities
  float* Acc = Ss + g * kTP;    // [g][D]
  float* Ms = Acc + g * D;      // [g] running max
  float* Ls = Ms + g;           // [g] running sum
  float* As = Ls + g;           // [g] this tile's rescale

  const int hk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int length = lengths[b];
  const int span = NP * page;
  const int n_valid = min(length, span);           // unmasked positions
  const int n_pos = length >= 1 ? n_valid : span;  // positions read
  const int* btb = bt + b * btsb;

  for (int idx = tid; idx < g * C; idx += kThreads) {
    const int gi = idx / C, c = idx % C;
    float e[V];
    load_chunk(q + b * qsb + (hk * g + gi) * qsh + c * V, e);
#pragma unroll
    for (int i = 0; i < V; ++i) Qs[gi * D + c * V + i] = e[i] * scale;
  }
  for (int idx = tid; idx < g * D; idx += kThreads) Acc[idx] = 0.f;
  for (int gi = tid; gi < g; gi += kThreads) {
    Ms[gi] = kNegInf;
    Ls[gi] = 0.f;
  }

  for (int t0 = 0; t0 < n_pos; t0 += kTP) {
    __syncthreads();  // Q/init written; the previous tile is no longer read
    for (int idx = tid; idx < kTP * C; idx += kThreads) {
      const int r = idx / C, c = idx % C, t = t0 + r;
      float ek[V], ev[V];
      if (t < n_pos) {
        const long long pid = btb[t / page];
        const int off = t % page;
        load_chunk(kp + pid * ks.p + off * ks.o + hk * ks.h + c * V, ek);
        load_chunk(vp + pid * vs.p + off * vs.o + hk * vs.h + c * V, ev);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) ek[i] = ev[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        Ks[r * LK + c * V + i] = ek[i];
        Vs[r * D + c * V + i] = ev[i];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < g * kTP; idx += kThreads) {
      const int gi = idx / kTP, r = idx % kTP, t = t0 + r;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(Qs[gi * D + d], Ks[r * LK + d], s);
      Ss[idx] = t >= n_pos ? -INFINITY : (t < n_valid ? s : kNegInf);
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += kThreads / 32) {
      const float s0 = Ss[gi * kTP + lane], s1 = Ss[gi * kTP + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[gi];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      Ss[gi * kTP + lane] = p0;
      Ss[gi * kTP + lane + 32] = p1;
      float sum = p0 + p1;
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
    for (int idx = tid; idx < g * D; idx += kThreads) {
      const int gi = idx / D, d = idx % D;
      float a = Acc[idx] * As[gi];
#pragma unroll 8
      for (int r = 0; r < kTP; ++r) a = fmaf(Ss[gi * kTP + r], Vs[r * D + d], a);
      Acc[idx] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < g * D; idx += kThreads) {
    const int gi = idx / D, d = idx % D;
    o[b * osb + (hk * g + gi) * osh + d] =
        from_f32<T>(Acc[idx] / fmaxf(Ls[gi], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* lengths, void* o, int B, int H, int KH, int page,
           int NP, long long qsb, long long qsh, Pool ks, Pool vs,
           long long btsb, long long osb, long long osh, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(H / KH);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(KH, B);
  paged_decode_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, lengths, static_cast<T*>(o), H, KH, page,
      NP, qsb, qsh, ks, vs, btsb, osb, osh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* kp, const void* vp,
             const int* bt, const int* lengths, void* o, int B, int H, int KH,
             int page, int NP, long long qsb, long long qsh, Pool ks, Pool vs,
             long long btsb, long long osb, long long osh, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, kp, vp, bt, lengths, o, B, H, KH, page, NP, qsb,
                           qsh, ks, vs, btsb, osb, osh, scale, stream);
    case 64:
      return launch<T, 64>(q, kp, vp, bt, lengths, o, B, H, KH, page, NP, qsb,
                           qsh, ks, vs, btsb, osb, osh, scale, stream);
    case 128:
      return launch<T, 128>(q, kp, vp, bt, lengths, o, B, H, KH, page, NP,
                            qsb, qsh, ks, vs, btsb, osb, osh, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, the pools and out share it).
// Strides are in elements; the D axis is contiguous and every row starts on
// a 16-byte boundary; block_table's page axis is contiguous; block_table
// and lengths are int32.
extern "C" int paged_attention_launch(
    int device, int dtype, const void* q, const void* kp, const void* vp,
    const int* bt, const int* lengths, void* o, int B, int H, int KH,
    int page, int NP, int D, long long qsb, long long qsh, long long ksp,
    long long kso, long long ksh, long long vsp, long long vso,
    long long vsh, long long btsb, long long osb, long long osh, float scale,
    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || H == 0) return 0;
  const Pool ks{ksp, kso, ksh}, vs{vsp, vso, vsh};
  if (dtype == 0)
    return launch_d<float>(D, q, kp, vp, bt, lengths, o, B, H, KH, page, NP,
                           qsb, qsh, ks, vs, btsb, osb, osh, scale, stream);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, kp, vp, bt, lengths, o, B, H, KH,
                                   page, NP, qsb, qsh, ks, vs, btsb, osb, osh,
                                   scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
