// Shared helpers of the kernels: element conversion and a cooperative,
// synchronous copy of a row tile from device memory into float32 shared
// memory.  load_tile widens every element to float32 and is meant for the
// CUDA-core kernels only: the float32 flash-attention path and ssd_scan.
// The bf16 attention paths keep their tiles in bf16 and load them
// asynchronously (cp.async) in their own sources.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float NEG_INF = -1e30f;  // finite mask value, as in the TPU kernels

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy `rows` rows of HD elements into dst (row stride dst_stride floats),
// multiplied by `scale`.  Rows at or past `rows_valid` are written as zeros,
// so padding never carries garbage into a dot product.  Each thread moves
// 16-byte chunks: HD * sizeof(T) is a multiple of 16 for every head dim the
// wrappers accept, and the wrappers check the base pointers' alignment.
template <typename T, int HD, int NT>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride,
                                          const T* src, long src_stride,
                                          int rows_valid, int rows,
                                          float scale, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = HD / VEC;  // 16-byte chunks per row
  static_assert(HD % VEC == 0, "head dim must fill whole 16-byte chunks");
  for (int c = tid; c < rows * CPR; c += NT) {
    const int r = c / CPR;
    const int e = (c - r * CPR) * VEC;
    float* out = dst + r * dst_stride + e;
    if (r < rows_valid) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (long)r * src_stride + e);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int t = 0; t < VEC; ++t) out[t] = to_float(vals[t]) * scale;
    } else {
#pragma unroll
      for (int t = 0; t < VEC; ++t) out[t] = 0.f;
    }
  }
}

}  // namespace repro
