// Per-point class histogram + thresholded argmax over the [F, N] uint8
// winner-class matrix C of the session label lifter (255 = no win).
//
// Replaces the TPU kernel fusion3dseg_tpu/ops/histogram.py `_hist_kernel`
// (Pallas). For every column n of C:
//   total   = number of rows != 255
//   vmax    = largest count over class ids 0..nclasses inclusive
//   cls     = lowest class id reaching vmax (strict > while scanning up)
//   classes = cls if total > 0 && vmax > 0 &&
//             float(vmax) / float(max(total, 1)) >= threshold, else nclasses
// Values in (nclasses, 255) count toward total but have no counter, as in
// the TPU kernel. The test is the float32 division, not a multiplied form,
// so thresholds such as 0.6 round the same way as the reference.
//
// Bound on an H100 (SXM, 3.35 TB/s): memory. At the headline shape
// F = 300, N = 1,000,000 the kernel must read F*N = 300 MB and write
// 3*4*N = 12 MB, about 93 us. The counting is close behind: an element costs
// about nine instructions, two thirds of them on the integer pipe (64 lanes
// a cycle an SM), and two 16-bit shared-memory accesses.
//
// Two kernels; the caller picks by the alignment of C alone.
//
// * `hist_tiled_kernel` (base and row pitch multiples of 16 bytes; the label
//   lifter allocates C so). A block of 128 threads owns 256 adjacent columns,
//   a thread two of them. The block streams its [8 rows, 256 columns] tiles
//   through a ring of four tiles in shared memory with 16-byte cp.async
//   copies (zero-filled past column N); a thread then reads its two columns
//   of a row as one 16-bit word. Counters are 16-bit, a thread's two columns
//   of one class in one 32-bit word at cnt[c * 128 + t]: bank t mod 32
//   whatever c is, so the 32 lanes of a warp never conflict, and every
//   element touches one counter. Rows are counted two at a time so that four
//   independent counter reads are in flight a thread.
//   Shared memory at 133 classes: 134 * 512 = 68,608 bytes of counters and
//   4 * 2,048 = 8,192 of ring, 76,800 a block and 1,024 the system's: three
//   blocks fill an SM's 228 KB exactly, 12 warps, with 3 * 3 * 2 KB = 18 KB
//   of loads in flight an SM (3.35 TB/s at 700 ns of latency needs about
//   18 KB an SM). The counters cap an SM at 768 columns, so warps are scarce:
//   three blocks of a shallow ring beat two of a deep one. Fewer classes
//   leave room for more blocks, more classes for fewer (one at 254). Rows
//   past F read as 255 and columns past N are not stored, so neither F nor N
//   needs padding.
// * `hist_bytes_kernel` (any base, any pitch): one thread a column, one
//   byte a load, counters at cnt[c * 128 + tid]. Correct everywhere, at
//   under a third of the memory rate.

#include <cstdint>
#include <cuda_runtime.h>

// Measurement builds (tools/kernel_parts.py): 1 leaves out the loads of the
// tiled kernel, 2 its counter updates. Results are then wrong by design.
#ifndef F3S_PARTS
#define F3S_PARTS 0
#endif

namespace {

constexpr int kInvalid = 255;

// ---- tiled: aligned rows through a cp.async ring

constexpr int kCols = 256;            // columns a block
constexpr int kT = kCols / 2;         // threads a block, two columns each
constexpr int kRows = 8;              // rows a tile
constexpr int kStages = 4;            // tiles in the ring
constexpr int kTileBytes = kRows * kCols;
constexpr int kChunksPerRow = kCols / 16;
static_assert(kT / kChunksPerRow == kRows, "one 16-byte copy a thread fills a tile");

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 0x01 in every byte of `w` that is 0xff (exact: no carry crosses a byte)
__device__ __forceinline__ uint32_t bytes_invalid(uint32_t w) {
  const uint32_t y = ~w;
  const uint32_t t = (y & 0x7f7f7f7fu) + 0x7f7f7f7fu;
  return (~(t | y | 0x7f7f7f7fu)) >> 7;
}

// 16-bit shared-memory accesses by 32-bit shared-window address, so that the
// compiler spends no instruction on generic pointers or on narrowing
__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts_u16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__global__ void __launch_bounds__(kT)
hist_tiled_kernel(const uint8_t* __restrict__ C, int F, int64_t N, int64_t stride,
                  int nclasses, float threshold, int32_t* __restrict__ total_out,
                  int32_t* __restrict__ vmax_out, int32_t* __restrict__ classes_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cnt_bytes = (nclasses + 1) * kCols * 2;
  uint8_t* ring = smem + cnt_bytes;  // [kStages][kRows][kCols]
  const uint32_t smem_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = threadIdx.x;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kCols;
  const int ncols = static_cast<int>(N - col0 < kCols ? N - col0 : kCols);
  const int nsteps = (F + kRows - 1) / kRows;

  // This thread's 16-byte chunk of every tile: row lr, bytes lc .. lc + 15 of
  // the block's columns, zero-filled past column N.
  const int lr = tid / kChunksPerRow, lc = (tid % kChunksPerRow) * 16;
  const int src_bytes = ncols - lc < 16 ? ncols - lc : 16;
  const uint8_t* src = C + col0 + lc + lr * stride;  // in the next tile to fetch
  const uint32_t dst0 = smem_s + cnt_bytes + lr * kCols + lc;
  auto fetch = [&](int step) {
    if (step < nsteps) {
      if (F3S_PARTS != 1 && step * kRows + lr < F && src_bytes > 0)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(dst0 + (step % kStages) * kTileBytes), "l"(src), "r"(src_bytes)
                     : "memory");
      src += kRows * stride;
    }
    cp_async_commit();  // an empty group keeps the count of groups uniform
  };
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < cnt_bytes / 16; i += kT) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // the 16-bit counter of (class x, this thread's column j) lies at shared
  // address cb[j] + x * 2 * kCols
  const uint32_t cb[2] = {smem_s + tid * 4, smem_s + tid * 4 + 2};
  const uint32_t nc = static_cast<uint32_t>(nclasses);
  int invalid[2] = {0, 0};  // rows past F count as invalid
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<kStages - 2>();  // tile `step` has landed (this thread's part)
    __syncthreads();               // everyone's part; and tile step-1 is consumed
    fetch(step + kStages - 1);     // into the slot of tile step-1
    const uint8_t* slot = ring + (step % kStages) * kTileBytes + tid * 2;
    const int rows = F - step * kRows;
    uint32_t w[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      w[r] = r < rows ? *reinterpret_cast<const uint16_t*>(slot + r * kCols) : 0xffffu;
    // Two rows at a time, packed into one word (bytes: row r column 0, 1,
    // row r + 1 column 0, 1). All four counters are read before any is
    // written. Where the two rows of a column hold the same class, both
    // reads saw the old count; the second row's store goes first and the
    // first row's, which adds two, lands last.
    uint32_t inv4 = 0;  // byte-wide counts of invalid entries, at most kRows / 2 each
#pragma unroll
    for (int r = 0; r < kRows; r += 2) {
      const uint32_t w2 = __byte_perm(w[r], w[r + 1], 0x5410);
      inv4 += bytes_invalid(w2);
      if (F3S_PARTS == 2) continue;
      uint32_t a0[2], a1[2], k0[2], k1[2];
      bool on0[2], on1[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t x0 = __byte_perm(w2, 0, 0x4440 + j);
        const uint32_t x1 = __byte_perm(w2, 0, 0x4442 + j);
        on0[j] = x0 <= nc;
        on1[j] = x1 <= nc;
        a0[j] = cb[j] + x0 * (2 * kCols);
        a1[j] = cb[j] + x1 * (2 * kCols);
        if (on0[j]) k0[j] = lds_u16(a0[j]);
        if (on1[j]) k1[j] = lds_u16(a1[j]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (on1[j]) sts_u16(a1[j], k1[j] + 1);
        if (on0[j]) sts_u16(a0[j], k0[j] + 1 + (a0[j] == a1[j]));
      }
    }
    invalid[0] += (inv4 & 0xff) + ((inv4 >> 16) & 0xff);
    invalid[1] += ((inv4 >> 8) & 0xff) + (inv4 >> 24);
  }

  // (count << 8 | 255 - class) is largest for the highest count and, among
  // equal counts, the lowest class id
  uint32_t best[2] = {0, 0};
  const uint32_t* cw = reinterpret_cast<const uint32_t*>(smem) + tid;
  for (int c = 0; c <= nclasses; ++c) {
    const uint32_t k = cw[c * kT], tag = 255u - c;  // one byte permute builds a key
    best[0] = max(best[0], __byte_perm(k, tag, 0x5104));
    best[1] = max(best[1], __byte_perm(k, tag, 0x5324));
  }
  int cls[2] = {255 - static_cast<int>(best[0] & 0xffu), 255 - static_cast<int>(best[1] & 0xffu)};
  int total[2];
  const int vmax[2] = {static_cast<int>(best[0] >> 8), static_cast<int>(best[1] >> 8)};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    total[j] = nsteps * kRows - invalid[j];
    const bool confident =
        total[j] > 0 && vmax[j] > 0 &&
        static_cast<float>(vmax[j]) / static_cast<float>(total[j] > 1 ? total[j] : 1) >= threshold;
    cls[j] = confident ? cls[j] : nclasses;
  }
  const int64_t col = col0 + tid * 2;
  if (col + 2 <= N) {  // the outputs are 8-byte aligned at even columns
    *reinterpret_cast<int2*>(total_out + col) = make_int2(total[0], total[1]);
    *reinterpret_cast<int2*>(vmax_out + col) = make_int2(vmax[0], vmax[1]);
    *reinterpret_cast<int2*>(classes_out + col) = make_int2(cls[0], cls[1]);
  } else if (col < N) {
    total_out[col] = total[0];
    vmax_out[col] = vmax[0];
    classes_out[col] = cls[0];
  }
}

// ---- bytes: any base and pitch

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
hist_bytes_kernel(const uint8_t* __restrict__ C, int64_t F, int64_t N,
                  int64_t stride, int nclasses, float threshold,
                  int32_t* __restrict__ total_out,
                  int32_t* __restrict__ vmax_out,
                  int32_t* __restrict__ classes_out) {
  extern __shared__ uint16_t cnt16[];  // [(nclasses + 1) * kThreads]
  const int tid = threadIdx.x;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  if (col >= N) return;  // ragged last block; no barrier follows

  for (int c = 0; c <= nclasses; ++c) cnt16[c * kThreads + tid] = 0;

  const uint8_t* p = C + col;
  int total = 0;
  int64_t f = 0;
  for (; f + kUnroll <= F; f += kUnroll) {
    uint8_t vals[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) vals[k] = __ldg(p + (f + k) * stride);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int x = vals[k];
      total += (x != kInvalid);
      if (x <= nclasses) ++cnt16[x * kThreads + tid];
    }
  }
  for (; f < F; ++f) {
    const int x = __ldg(p + f * stride);
    total += (x != kInvalid);
    if (x <= nclasses) ++cnt16[x * kThreads + tid];
  }

  int vmax = 0, cls = 0;
  for (int c = 0; c <= nclasses; ++c) {
    const int k = cnt16[c * kThreads + tid];
    if (k > vmax) {  // strict: ties keep the lowest class id
      vmax = k;
      cls = c;
    }
  }
  const bool confident =
      total > 0 && vmax > 0 &&
      static_cast<float>(vmax) / static_cast<float>(total > 1 ? total : 1) >= threshold;
  total_out[col] = total;
  vmax_out[col] = vmax;
  classes_out[col] = confident ? cls : nclasses;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// C: [F, N] uint8 rows `stride` bytes apart. Requires F <= 65535 (16-bit
// counters) and 0 <= nclasses <= 254; the caller checks both. `tiled`
// selects the kernel: non-zero needs C and `stride` to be multiples of 16
// bytes (-1 otherwise), zero takes any. total, vmax, classes: [N] int32,
// 16-byte aligned.
extern "C" int f3s_histogram_classify(const uint8_t* C, int64_t F, int64_t N,
                                      int64_t stride, int nclasses,
                                      float threshold, int32_t* total,
                                      int32_t* vmax, int32_t* classes,
                                      void* stream, int tiled) {
  if (N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiled) {
    if (reinterpret_cast<uintptr_t>(C) % 16 != 0 || (F > 1 && stride % 16 != 0)) return -1;
    const size_t smem = static_cast<size_t>(nclasses + 1) * kCols * 2 + kStages * kTileBytes;
    if (cudaError_t err = allow_smem(hist_tiled_kernel, smem)) return static_cast<int>(err);
    const int64_t blocks = (N + kCols - 1) / kCols;
    hist_tiled_kernel<<<static_cast<unsigned>(blocks), kT, smem, s>>>(
        C, static_cast<int>(F), N, stride, nclasses, threshold, total, vmax, classes);
  } else {
    const size_t smem = static_cast<size_t>(nclasses + 1) * kThreads * sizeof(uint16_t);
    if (cudaError_t err = allow_smem(hist_bytes_kernel, smem)) return static_cast<int>(err);
    const int64_t blocks = (N + kThreads - 1) / kThreads;
    hist_bytes_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        C, F, N, stride, nclasses, threshold, total, vmax, classes);
  }
  return static_cast<int>(cudaGetLastError());
}
