// Element helpers shared by the kernels: f32 <-> T (f32 or bf16)
// conversion, rounding an f32 value to T, and the reflect-pad index (K1,
// K5, K7).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ctk {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}
// reflect pad 1 of an index into [0, n): -1 -> 1, n -> n - 2
__device__ __forceinline__ int reflect1(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

}  // namespace ctk
