// Helpers shared by the attention kernels: conversions between the storage
// type T (float, __nv_bfloat16 or __half) and float32, vector loads of a
// lane's chunk of a row, the strides of a [B, tokens, H, D] tensor, the
// tensor-core product of the two 16-bit types (mma.sync m16n8k16, bfloat16
// or float16 in, float32 accumulators) with its fragment loads (ldmatrix),
// and 16-byte asynchronous copies into shared memory. Every conversion
// between a 16-bit type and float goes through the CUDA intrinsics; float16
// keeps its subnormals both ways (round to nearest, no flush to zero).

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
template <> __device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// The tensor-core element types: a pair of them in one 32-bit word, the
// first in the low half
template <typename E> constexpr bool kIsHalf = std::is_same<E, __half>::value;
template <typename E> __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  static_assert(std::is_same<E, __nv_bfloat16>::value || kIsHalf<E>, "a 16-bit float");
  uint32_t w;
  if constexpr (kIsHalf<E>) {
    const __half2 v = __floats2half2_rn(lo, hi);  // .x (low half) = lo
    w = *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    w = *reinterpret_cast<const uint32_t*>(&v);
  }
  return w;
}
template <typename E> __device__ __forceinline__ float2 unpack2(uint32_t w) {
  if constexpr (kIsHalf<E>) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  } else {
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
  }
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
  } else {  // two 16-bit floats per word, the first in the low half
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float2 x = unpack2<T>(w[i]);
      out[2 * i] = x.x;
      out[2 * i + 1] = x.y;
    }
  }
}

struct Strides {
  int64_t b, n, h;  // elements; the last axis is contiguous
};

// The grids put (batch, head) on gridDim.y, at most 65535 of them a launch:
// `launch(bh0, count)` runs for each run of them in turn (any B * H).
constexpr int kMaxGridY = 65535;
template <typename F>
int over_batch_heads(int64_t batch_heads, F launch) {
  for (int64_t bh0 = 0; bh0 < batch_heads; bh0 += kMaxGridY) {
    const int64_t count = batch_heads - bh0 < kMaxGridY ? batch_heads - bh0 : kMaxGridY;
    const int err = launch(static_cast<int>(bh0), static_cast<int>(count));
    if (err != 0) return err;
  }
  return 0;
}

// ---- bfloat16 and float16 on the tensor cores

constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one instruction: relative error about 2^-22, 0 for x = -inf
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// c[16x8] += a[16x16] * b[16x8], E (bfloat16 or float16) in, float32
// accumulators. A lane (g = lane / 4, t = lane % 4) holds: a0..a3 = rows g,
// g + 8, g, g + 8 at columns 2t, 2t + 1 (a0, a1) and 2t + 8, 2t + 9 (a2,
// a3); b0, b1 = column g at rows 2t, 2t + 1 and 2t + 8, 2t + 9; c0, c1 = row
// g, c2, c3 = row g + 8, at columns 2t, 2t + 1. The two types share the
// fragment layout.
#define F3S_MMA16816(TY)                                                        \
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "       \
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"        \
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])                 \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
template <typename E>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (kIsHalf<E>) {
    F3S_MMA16816("f16");
  } else {
    F3S_MMA16816("bf16");
  }
}
#undef F3S_MMA16816

// Four 8x8 matrices of 16-bit elements from shared memory: lane L gives the 16-byte
// row L % 8 of matrix L / 8; every lane receives, of each matrix, row
// lane / 4, columns 2 * (lane % 4) and the next. `.trans` hands out the
// transposed matrices: rows 2 * (lane % 4) and the next, column lane / 4.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// ---- asynchronous copies

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes to shared memory: the first `src_bytes` (0 or 16) from `src`,
// the rest zeros. `src` must be a valid 16-byte-aligned address either way.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(smem_dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace f3s
