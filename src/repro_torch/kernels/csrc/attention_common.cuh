// Helpers shared by the attention kernels (flash_attention.cu,
// paged_attention.cu): f32 <-> input-type conversion and 16-byte chunk
// loads of one row of a (.., D) tensor with a contiguous, 16-byte aligned
// D axis.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T (one chunk) as f32, in one vector load: the launchers
// require every row to start on a 16-byte boundary.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* src, float* out) {
  constexpr int V = 16 / sizeof(T);
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f32(e[i]);
}

}  // namespace attn
