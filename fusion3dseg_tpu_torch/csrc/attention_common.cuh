// Helpers shared by the attention kernels: conversions between the storage
// type T (float or __nv_bfloat16) and float32, vector loads of a lane's
// chunk of a row, and the strides of a [B, tokens, H, D] tensor.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace f3s {

constexpr int kLanes = 4;         // lanes sharing one query, a quarter of D each
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// DPL consecutive elements of type T at `p` (aligned to min(16, DPL *
// sizeof(T)) bytes) as float32.
template <typename T, int DPL>
__device__ __forceinline__ void load_chunk(const T* p, float (&out)[DPL]) {
  constexpr int W = DPL * static_cast<int>(sizeof(T)) / 4;  // 32-bit words
  uint32_t w[W];
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = x.x; w[4 * i + 1] = x.y; w[4 * i + 2] = x.z; w[4 * i + 3] = x.w;
    }
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      const uint2 x = reinterpret_cast<const uint2*>(p)[i];
      w[2 * i] = x.x; w[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
  }
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) out[i] = __uint_as_float(w[i]);
  } else {  // two bfloat16 per word, the first in the low half
#pragma unroll
    for (int i = 0; i < W; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

struct Strides {
  int64_t b, n, h;  // elements; the last axis is contiguous
};

}  // namespace f3s
