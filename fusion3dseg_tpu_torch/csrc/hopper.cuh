// Hopper (sm_90a) primitives as inline PTX: mbarriers, TMA tensor copies
// between device and shared memory, shared-memory matrix descriptors and the
// warpgroup products (wgmma) of bfloat16 or float16 with float32
// accumulators.
//
// Shared-memory tiles here are rows of 128 bytes (64 16-bit elements) in TMA's
// 128-byte swizzle: the 16-byte piece c of row r lies at piece c ^ (r % 8),
// and every tile starts on a 1024-byte boundary.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing of libcuda is linked

#include "attention_common.cuh"  // smem_addr, kIsHalf

namespace f3s {

// ---- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}
// one arrival that also announces `bytes` of TMA transfers to come
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// returns once the phase of parity `parity` has completed; traps after
// 2^31 clocks (about a second) of waiting, so that a broken protocol faults
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  for (long long start = -1; !done;) {
    if (start < 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 31)) {
      __trap();
    }
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// ---- TMA over a 4-d tensor map (coordinates innermost first)

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// boxes outside the tensor are clipped: nothing is written there
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N committed stores still read their shared-memory source
template <int N> __device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
// until every committed store has completed
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory, made visible to TMA and wgmma
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the `count` threads that name barrier `id` (1..15; 0 is __syncthreads)
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
// counts this warp's threads towards barrier `id` without waiting
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// ---- warpgroup products

// Descriptor of a 128-byte-swizzled operand at `addr` (1024-byte aligned
// tile, or an offset into one along a row). `lbo`, `sbo` in bytes: K-major,
// sbo is the step between groups of 8 rows (lbo unused); MN-major, lbo is
// the step between 64-element column blocks, sbo between groups of 8 K rows.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;  // layout: 128-byte swizzle
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup's products are pending
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Pins registers that an asynchronous product reads or writes: the
// compiler may not move their other uses across this point.
template <int R> __device__ __forceinline__ void pin(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int R> __device__ __forceinline__ void pin(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// Accumulator layout of m64nN (thread t of the warpgroup, w = t / 32,
// g = t % 32 / 4, c = t % 4): d[4j], d[4j + 1] hold row 16w + g, columns
// 8j + 2c and 8j + 2c + 1; d[4j + 2], d[4j + 3] the same columns of row
// 16w + g + 8. Columns 16i .. 16i + 15 of it (d[8i .. 8i + 7], as pairs of
// the input type) are the register A operand of a k16 product, unchanged.
// E, the input type, is __nv_bfloat16 or __half: the products of the two
// are the same instruction with another type, the same shapes, fragment
// layouts and descriptors.
//
// The accumulator's operands: 8 from d[i] on, and its N / 2 register names
#define F3S_D8(d, i)                                                               \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),      \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define F3S_D16(d, i) F3S_D8(d, i), F3S_D8(d, i + 8)
#define F3S_D32(d, i) F3S_D16(d, i), F3S_D16(d, i + 16)
#define F3S_D64(d, i) F3S_D32(d, i), F3S_D32(d, i + 32)
#define F3S_D128(d) F3S_D64(d, 0), F3S_D64(d, 64)
#define F3S_R16                                                                     \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define F3S_R32                                                                     \
  F3S_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define F3S_R64                                                                     \
  F3S_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "   \
          "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define F3S_R128                                                                    \
  F3S_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "  \
          "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, " \
          "%95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "  \
          "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "    \
          "%122, %123, %124, %125, %126, %127"
// One wgmma of shape SHAPE on TY inputs: accumulator names REGS, then the
// A and B operands and the immediates (REST); the accumulate flag (scale-d)
// is the operand named PRED
#define F3S_WGMMA(SHAPE, TY, REGS, REST, PRED)                                       \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " PRED ", 0;\n"                                  \
  "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY "." TY " {" REGS "}, " REST ";\n}\n"
// The product for E: the float16 or the bfloat16 form of one asm statement
#define F3S_WGMMA_E(E, SHAPE, REGS, REST, PRED, OUTS, ...)                          \
  if constexpr (kIsHalf<E>) {                                                        \
    asm volatile(F3S_WGMMA(SHAPE, "f16", REGS, REST, PRED) : OUTS : __VA_ARGS__);   \
  } else {                                                                           \
    asm volatile(F3S_WGMMA(SHAPE, "bf16", REGS, REST, PRED) : OUTS : __VA_ARGS__);  \
  }

template <int N, typename E> struct Wgmma;

template <typename E> struct Wgmma<32, E> {
  // d[64 x 32] (+)= A[64 x 16] * B[16 x 32]; A and B from shared memory
  // (descriptors), both K-major
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b,
                                            int scale_d) {
    F3S_WGMMA_E(E, "m64n32k16", F3S_R16, "%16, %17, p, 1, 1, 0, 0", "%18",
                F3S_D16(d, 0), "l"(a), "l"(b), "r"(scale_d))
  }
};

template <typename E> struct Wgmma<64, E> {
  // d[64 x 64] (+)= A[64 x 16] * B[16 x 64]; A and B from shared memory
  // (descriptors), both K-major
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b,
                                            int scale_d) {
    F3S_WGMMA_E(E, "m64n64k16", F3S_R32, "%32, %33, p, 1, 1, 0, 0", "%34", F3S_D32(d, 0),
                "l"(a), "l"(b), "r"(scale_d))
  }
  // d[64 x 64] (+)= A[64 x 16] * B[16 x 64]; A from registers (fragment
  // layout of an m64nNk16 accumulator's 16 columns), B from shared memory,
  // MN-major
  static __device__ __forceinline__ void rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t b,
                                            int scale_d) {
    F3S_WGMMA_E(E, "m64n64k16", F3S_R32, "{%32, %33, %34, %35}, %36, p, 1, 1, 1", "%37",
                F3S_D32(d, 0), "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d))
  }
};

template <typename E> struct Wgmma<128, E> {
  // d[64 x 128] (+)= A[64 x 16] * B[16 x 128]; A and B from shared memory
  // (descriptors), both K-major
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b,
                                            int scale_d) {
    F3S_WGMMA_E(E, "m64n128k16", F3S_R64, "%64, %65, p, 1, 1, 0, 0", "%66", F3S_D64(d, 0),
                "l"(a), "l"(b), "r"(scale_d))
  }
  // d[64 x 128] (+)= A[64 x 16] * B[16 x 128]; A from registers (fragment
  // layout of an m64nNk16 accumulator's 16 columns), B from shared memory,
  // MN-major
  static __device__ __forceinline__ void rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t b,
                                            int scale_d) {
    F3S_WGMMA_E(E, "m64n128k16", F3S_R64, "{%64, %65, %66, %67}, %68, p, 1, 1, 1", "%69",
                F3S_D64(d, 0), "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d))
  }
};

template <typename E> struct Wgmma<256, E> {
  // d[64 x 256] (+)= A[64 x 16] * B[16 x 256]; A from registers (fragment
  // layout of an m64nNk16 accumulator's 16 columns), B from shared memory,
  // MN-major
  static __device__ __forceinline__ void rs(float (&d)[128], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t b,
                                            int scale_d) {
    F3S_WGMMA_E(E, "m64n256k16", F3S_R128, "{%128, %129, %130, %131}, %132, p, 1, 1, 1",
                "%133", F3S_D128(d), "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d))
  }
};

#undef F3S_WGMMA_E
#undef F3S_WGMMA
#undef F3S_R128
#undef F3S_R64
#undef F3S_R32
#undef F3S_R16
#undef F3S_D128
#undef F3S_D64
#undef F3S_D32
#undef F3S_D16
#undef F3S_D8

}  // namespace f3s
