// The fusion engine's pixel match (`fusion/fusion.py` `_match_pixels`) in
// one launch: every pixel of a frame against the 18 candidates of its 3x3
// cell neighbourhood, two depth-ordered candidates a cell.
//
// Replaces no TPU kernel: the JAX package computes the match as XLA array
// code (`fusion3dseg_tpu/fusion/fusion.py` `_match_pixels`). The port's
// plain version of that code stacks 18 shifted views into a [P, 18, 6]
// float32 table (133 MB a VGA frame) and runs its distance and cosine
// chains on [P, 18] tensors in float64, about 45 launches and 3 GB of
// traffic a frame. What the match needs is small: the candidate grid
// ([gh, gw, 12] float32 and [gh, gw, 2] int32 ids, 17 MB at VGA with
// half = 1, each cell read by the 9 pixels around it), the pixels' points,
// normals and valid flags (7.7 MB) and the outputs (1.5 MB): about 27 MB,
// 8 us at 3.35 TB/s. So the kernel is bound by memory, and its design
// reads each byte of device memory about once.
//
// One thread a pixel. A block of kTx x kTy pixels stages the cells its
// pixels read, plus a one-cell halo, in shared memory: at most
// (kTx + 2) x (kTy + 2) cells at half = 1, fewer at half > 1. The cells
// are stored component-major (`s_data[k][cell]`), so the 32 lanes of a warp
// (one row of pixels, neighbouring cells) read neighbouring words. Cells
// outside the grid stage id -1.
//
// For pixel (v, u) the candidates are visited in the plain version's order,
// candidate-major, then the 3x3 offsets row-major, and the first candidate
// whose distance is strictly below every earlier passing one is kept: the
// tie rule of argmin over where(passes, dist, inf). A candidate passes when
// its id is at least 0, cos > min_cosine, dist < radius and the pixel is
// valid. The arithmetic repeats the plain version's operation by operation,
// rounding written out so that nvcc contracts nothing:
//   d = p - c, each component in float32;
//   dist = sqrt_f64(fma(d2, d2, fma(d1, d1, d0 * d0))) rounded to float32,
//     each fma's product exact in float64, its sum rounded to float64, then
//     to float32 (`quaternion.norm3_fma`);
//   cos = fma(n2, c5, fma(n1, c4, n0 * c3)) the same way (`_dot3_fma`);
//   radius and min_cosine compared as float32.
// So `match` and `matched` equal the plain version's bit for bit.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTx = 32;                // pixels a block row: one warp
constexpr int kTy = 8;                 // pixel rows a block (32 x 4 times alike)
constexpr int kCx = kTx + 2;           // most cells a block stages, a row
constexpr int kCy = kTy + 2;           // most cell rows a block stages
constexpr int kCells = kCx * kCy;
constexpr int kComp = 12;              // two candidates x (position, normal)

// a * b + acc as the plain version's `fma`: the product exact in float64,
// the sum rounded to float64, then to float32
__device__ __forceinline__ float fma_f64(float a, float b, float acc) {
  return __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                                     static_cast<double>(acc)));
}

__global__ void __launch_bounds__(kTx * kTy)
match_pixels_kernel(const float* __restrict__ grid, const int32_t* __restrict__ slotg,
                    const float* __restrict__ fpts, const float* __restrict__ fnrm,
                    const uint8_t* __restrict__ fvalid, int height, int width, int gh, int gw,
                    int half, float radius, float min_cosine, int32_t* __restrict__ match,
                    uint8_t* __restrict__ matched) {
  __shared__ float s_data[kComp][kCells];
  __shared__ int32_t s_id[2][kCells];

  const int u0 = blockIdx.x * kTx, v0 = blockIdx.y * kTy;
  // staged cells: columns cx0 .. cx0 + ncx - 1, rows cy0 .. cy0 + ncy - 1
  const int cx0 = u0 / half - 1, cy0 = v0 / half - 1;
  const int ncx = (min(u0 + kTx, width) - 1) / half - u0 / half + 3;
  const int ncy = (min(v0 + kTy, height) - 1) / half - v0 / half + 3;

  // a staged row of cells is one contiguous run of the grid
  for (int r = threadIdx.y; r < ncy; r += kTy) {  // ncy <= kCy, ncx <= kCx at every half
    const int gy = cy0 + r;
    const bool row_in = gy >= 0 && gy < gh;
    for (int j = threadIdx.x; j < ncx * kComp; j += kTx) {
      const int c = j / kComp, k = j - c * kComp;
      const int gx = cx0 + c;
      float val = 0.0f;
      if (row_in && gx >= 0 && gx < gw)
        val = grid[(static_cast<int64_t>(gy) * gw + gx) * kComp + k];
      s_data[k][r * ncx + c] = val;
    }
    for (int j = threadIdx.x; j < ncx * 2; j += kTx) {
      const int c = j >> 1, k = j & 1;
      const int gx = cx0 + c;
      int32_t id = -1;
      if (row_in && gx >= 0 && gx < gw) id = slotg[(static_cast<int64_t>(gy) * gw + gx) * 2 + k];
      s_id[k][r * ncx + c] = id;
    }
  }
  __syncthreads();

  const int u = u0 + threadIdx.x, v = v0 + threadIdx.y;
  if (u >= width || v >= height) return;
  const int64_t p = static_cast<int64_t>(v) * width + u;
  int32_t best_id = -1;
  if (fvalid[p]) {
    const float p0 = fpts[3 * p], p1 = fpts[3 * p + 1], p2 = fpts[3 * p + 2];
    const float n0 = fnrm[3 * p], n1 = fnrm[3 * p + 1], n2 = fnrm[3 * p + 2];
    // the staged index of the pixel's neighbourhood's top-left cell
    const int base = (v / half - cy0 - 1) * ncx + (u / half - cx0 - 1);
    float best = CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int s = base + dy * ncx + dx;
          const int32_t id = s_id[c][s];
          if (id < 0) continue;
          const int k = 6 * c;
          const float cosn =
              fma_f64(n2, s_data[k + 5][s],
                      fma_f64(n1, s_data[k + 4][s], __fmul_rn(n0, s_data[k + 3][s])));
          if (!(cosn > min_cosine)) continue;
          const float e0 = __fsub_rn(p0, s_data[k][s]);
          const float e1 = __fsub_rn(p1, s_data[k + 1][s]);
          const float e2 = __fsub_rn(p2, s_data[k + 2][s]);
          const float sq = fma_f64(e2, e2, fma_f64(e1, e1, __fmul_rn(e0, e0)));
          const float dist = __double2float_rn(__dsqrt_rn(static_cast<double>(sq)));
          if (dist < radius && dist < best) {
            best = dist;
            best_id = id;
          }
        }
      }
    }
  }
  match[p] = best_id;
  matched[p] = best_id >= 0;
}

}  // namespace

// The C entry point. Pointers to contiguous tensors: grid [gh, gw, 12]
// float32, slotg [gh, gw, 2] int32, fpts and fnrm [height * width, 3]
// float32, fvalid [height * width] bool; outputs match [height * width]
// int32 and matched [height * width] bool. Pixel (v, u) reads cell
// (v / half, u / half), so the grid covers the image: gh * half >= height,
// gw * half >= width. Launches on `stream`, allocates nothing, does not
// synchronise. Returns 0, -1 for shapes the kernel does not take, or the
// launch's cudaError.
extern "C" int f3s_match_pixels(const float* grid, const int32_t* slotg, const float* fpts,
                                const float* fnrm, const uint8_t* fvalid, int height, int width,
                                int gh, int gw, int half, float radius, float min_cosine,
                                int32_t* match, uint8_t* matched, void* stream) {
  if (half < 1 || static_cast<int64_t>(gh) * half < height ||
      static_cast<int64_t>(gw) * half < width)
    return -1;
  if (height <= 0 || width <= 0) return 0;
  const unsigned bx = (width + kTx - 1) / kTx, by = (height + kTy - 1) / kTy;
  if (by > 65535u) return -1;
  match_pixels_kernel<<<dim3(bx, by), dim3(kTx, kTy), 0, static_cast<cudaStream_t>(stream)>>>(
      grid, slotg, fpts, fnrm, fvalid, height, width, gh, gw, half, radius, min_cosine, match,
      matched);
  return static_cast<int>(cudaGetLastError());
}
