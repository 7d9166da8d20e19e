// Sliding-window (neighbourhood) attention on an image grid: every query
// attends to the window x window keys around it, masked at the image
// borders (a corner query sees only its in-image neighbours; the window is
// not shifted).
//
// Replaces the TPU kernel fusion3dseg_tpu/ops/attention.py `_nat_kernel`
// (Pallas, reached through `neighborhood_attention`). For q, k, v
// [B, N = height * width, H, D] of type T (bfloat16 or float32), per query:
//   qs = T(float(q) * scale)             scale = T(1 / sqrt(D)), given
//   s_j = sum_d qs_d * k_jd              float32, over the keys j of the
//                                        window that lie inside the image
//   p_j = exp(s_j - max_j s) / sum_j exp(s_j - max_j s)      float32
//   o = T(sum_j p_j * v_j)               float32 accumulation
// which is what the TPU kernel's online softmax computes, its -inf guards
// included (a query is always its own key, so no row is empty): scores,
// softmax and both products in float32; only q's scaling and the output
// round to T. Inputs are taken to be finite.
//
// Bound on an H100 (SXM): bytes. The function reads q, k, v and writes o
// once (4 * B*N*H*D elements; 16.8 MB, 5 us at [8, 64*64, 1, 64] bfloat16)
// and does 4 * window^2 * D operations per query, under a microsecond at the
// tensor cores' bfloat16 rate even when done densely over a tile's halo.
//
// Both kernels: a block owns an 8 x 8 tile of queries of one (batch, head)
// and stages the (8 + 2r)^2 halo of K and V in shared memory once, with
// 16-byte cp.async copies all in flight at once (zero-filled outside the
// image and past D), so each K/V element is read from L2 (1 + 2r/8)^2 times
// (3.06 at window 7) instead of window^2 times. Where D, the strides or the
// bases do not allow 16-byte copies the staging falls back to one element a
// load. No padded K/V copy in device memory, no [B*H, N, D] transposes
// (strides are read directly), no height % tile requirement: a ragged tile
// computes on zeros and does not store.
//
// * bfloat16 (`nat_mma_kernel`): both products on the tensor cores, mma.sync
//   m16n8k16. A warp owns 16 queries, two rows of the tile, and multiplies
//   them against every key of its own sub-halo: (2 + 2r) halo rows, each cut
//   into slots of 8 columns (128 key slots at window 7, of which 49 a query
//   are its window). Keys outside a query's window or outside the image
//   score -inf from coordinates; softmax runs online over steps of four
//   slots in the accumulator layout, in base 2; slots on halo rows outside
//   the image are skipped. K and V fragments come from the position-major
//   halo by ldmatrix (V's transposed by the instruction), rows of D + 8
//   elements so that the eight rows of a matrix fall on different banks. The
//   probabilities stay float32-grade: p is split into a bfloat16 high part
//   and a bfloat16 remainder and the second product runs on both, so
//   the plain version needs no rounding of p. The output goes through the K
//   halo's room in shared memory, so that a lane stores 16 bytes. The dense
//   work is 2.6 times the windowed work and still far below the bound.
//   Shared memory at window 7, D = 64: 2 * 196 * 72 * 2 = 56,448 bytes a
//   block, four blocks (16 warps, at most 128 registers a thread) an SM; the
//   512 blocks of [8, 64*64, 1, 64] and of [2, 128*128, 1, 64] are one wave
//   of the 528 slots, so every block stages at once (25.7 MB of halo from
//   L2) and then every block computes: the two do not overlap, and the
//   computing is the longer (`tools/kernel_parts.py` times the two apart).
//   It runs at under one instruction a cycle an SM: four warps a scheduler,
//   each a chain of mma.sync, shuffles and exponentials through a step.
// * float32 (`nat_f32_kernel`): FMAs on the CUDA cores (TF32 products would
//   not hold the 1e-4 agreement asked of float32). Four adjacent lanes share
//   a query, each with a quarter of D in registers; a score is a quarter dot
//   product plus two shuffles, softmax online per key.

#include "attention_common.cuh"

// Measurement builds (tools/kernel_parts.py): 1 leaves out the staging of K
// and V in the bfloat16 kernel, 2 its products. Results are then wrong by
// design.
#ifndef F3S_PARTS
#define F3S_PARTS 0
#endif

namespace {

using namespace f3s;

constexpr int kTile = 8;  // queries per tile side

// Stage the halo x halo positions around a tile, top-left at (y0, x0), of K
// and V of one (batch, head) into ks, vs [halo * halo][ld], Dp <= ld elements
// a row filled (zeros outside the image and at d >= D). The copies are
// committed as one cp.async group; the caller waits and synchronises.
template <typename T, int Dp>
__device__ __forceinline__ void stage_halo(T* ks, T* vs, int ld, const T* kb, const T* vb,
                                           int64_t skn, int64_t svn, int y0, int x0,
                                           int halo, int height, int width, int D,
                                           bool vec, int tid, int nthreads) {
  if (vec) {  // 16 bytes a copy: D, the strides and the bases allow it
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    constexpr int kChunks = Dp / kPer;
    // a thread keeps its column of the halo and its 16 bytes of D and walks
    // down the rows: one pointer step and two copies a row
    const int64_t krow = width * skn, vrow = width * svn;
    for (int it = tid; it < halo * kChunks; it += nthreads) {
      const int hx = it / kChunks, d = it % kChunks * kPer;
      const int gx = x0 + hx;
      const bool xin = gx >= 0 && gx < width && d < D;
      const T* kp = kb + gx * skn + d + y0 * krow;
      const T* vp = vb + gx * svn + d + y0 * vrow;
      T* kd = ks + hx * ld + d;
      T* vd = vs + hx * ld + d;
      for (int hy = 0; hy < halo; ++hy) {
        const bool in = xin && y0 + hy >= 0 && y0 + hy < height;
        cp_async16(kd, in ? kp : kb, in ? 16 : 0);
        cp_async16(vd, in ? vp : vb, in ? 16 : 0);
        kp += krow;
        vp += vrow;
        kd += halo * ld;
        vd += halo * ld;
      }
    }
  } else {
    const T zero = from_f32<T>(0.f);
    for (int idx = tid; idx < halo * halo * Dp; idx += nthreads) {
      const int pos = idx / Dp, d = idx % Dp;
      const int gy = y0 + pos / halo, gx = x0 + pos % halo;
      const bool in = gy >= 0 && gy < height && gx >= 0 && gx < width && d < D;
      const int64_t tok = static_cast<int64_t>(gy) * width + gx;
      ks[pos * ld + d] = in ? kb[tok * skn + d] : zero;
      vs[pos * ld + d] = in ? vb[tok * svn + d] : zero;
    }
  }
  cp_async_commit();
}

// ---- bfloat16: both products on the tensor cores

using BF = __nv_bfloat16;

constexpr int kMmaThreads = kTile / 2 * 32;  // a warp per two tile rows
constexpr int kSlots = 4;  // slots of 8 keys a softmax step

template <int NK2>  // head dim padded to 32 * NK2
__global__ void __launch_bounds__(kMmaThreads, NK2 <= 2 ? 4 : 1)
nat_mma_kernel(const BF* __restrict__ q, const BF* __restrict__ k,
               const BF* __restrict__ v, BF* __restrict__ o,
               int height, int width, int window, int H, int D, int tiles_x,
               Strides sq, Strides sk, Strides sv, Strides so, float scale,
               bool vec, bool pairs, bool vec_out) {
  constexpr int Dp = 32 * NK2;
  constexpr int NK = 2 * NK2;   // 16-wide chunks of the head dim
  constexpr int ND = Dp / 8;    // 8-wide chunks of the head dim
  constexpr int LD = Dp + 8;    // row of the staged halo, elements
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = window / 2;
  const int halo = kTile + 2 * r;  // halo side, in positions
  BF* ks = reinterpret_cast<BF*>(smem);  // [halo*halo][LD]
  BF* vs = ks + halo * halo * LD;        // [halo*halo][LD]

  const int tid = threadIdx.x;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  if (F3S_PARTS != 1)
    stage_halo<BF, Dp>(ks, vs, LD, k + b * sk.b + h * sk.h, v + b * sv.b + h * sv.h,
                       sk.n, sv.n, ty0 - r, tx0 - r, halo, height, width, D, vec, tid,
                       kMmaThreads);

  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wy = (tid / 32) * 2;  // this warp's two rows of the tile
  // the lane's queries: (row wy, column g) and (row wy + 1, column g)
  const int qx = tx0 + g, qy0 = ty0 + wy;
  const bool live0 = qx < width && qy0 < height, live1 = qx < width && qy0 + 1 < height;
  const int64_t tok0 = static_cast<int64_t>(qy0) * width + qx;

  // q * scale, rounded to bfloat16, as A fragments (while the halo lands)
  uint32_t qa[NK][4];
  {
    const BF* q0 = q + b * sq.b + h * sq.h + tok0 * sq.n;
    const BF* q1 = q0 + width * sq.n;
    auto ld2 = [&](const BF* row, bool live, int d) -> uint32_t {
      float x = 0.f, y = 0.f;
      if (live && pairs && d + 1 < D) {
        const __nv_bfloat162 xy = *reinterpret_cast<const __nv_bfloat162*>(row + d);
        x = __low2float(xy);
        y = __high2float(xy);
      } else if (live) {
        if (d < D) x = to_f32<BF>(row[d]);
        if (d + 1 < D) y = to_f32<BF>(row[d + 1]);
      }
      return pack_bf16(x * scale, y * scale);
    };
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {
      const int d = kc * 16 + 2 * t;
      qa[kc][0] = ld2(q0, live0, d);
      qa[kc][1] = ld2(q1, live1, d);
      qa[kc][2] = ld2(q0, live0, d + 8);
      qa[kc][3] = ld2(q1, live1, d + 8);
    }
  }

  // the keys of this warp: halo rows wy .. wy + 1 + 2r, every row in ntx
  // slots of 8 columns. Column hx of the halo is in the window of the query
  // in tile column g iff g <= hx <= g + 2r; row hy (counted from wy) in that
  // of the query in row wy + i iff i <= hy <= i + 2r.
  const int ntx = (halo + 7) / 8;
  uint32_t okx = 0;  // bit 2 * xb + e: column 8 * xb + 2t + e is a key of this lane's queries
  for (int xb = 0; xb < ntx; ++xb)
    for (int e = 0; e < 2; ++e) {
      const int hx = 8 * xb + 2 * t + e, gx = tx0 - r + hx;
      if (hx >= g && hx <= g + 2 * r && gx >= 0 && gx < width) okx |= 1u << (2 * xb + e);
    }

  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;  // maxima in base-2 units
  float acc[ND][4];
#pragma unroll
  for (int dc = 0; dc < ND; ++dc)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dc][i] = 0.f;

  cp_async_wait_all();
  __syncthreads();

  const uint32_t ks_s = smem_addr(ks), vs_s = smem_addr(vs);
  const int nslots = F3S_PARTS == 2 ? 0 : (2 + 2 * r) * ntx;
  int hy[kSlots], xb[kSlots];  // slot j of a step: halo row wy + hy[j], columns 8 * xb[j] ..
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    hy[j] = j / ntx;
    xb[j] = j % ntx;
  }
  for (int it = 0; it < nslots; it += kSlots) {
    bool rowin[kSlots], any = false;
    int pos[kSlots];  // this lane's ldmatrix row: key lane % 8 of the slot
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int gy = ty0 + wy - r + hy[j];
      rowin[j] = it + j < nslots && gy >= 0 && gy < height;
      any = any || rowin[j];
      const int hx = min(8 * xb[j] + lane % 8, halo - 1);  // slots past the halo repeat its edge
      pos[j] = rowin[j] ? (wy + hy[j]) * halo + hx : 0;
    }
    if (any) {
      float s[kSlots][4];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
        const uint32_t ka = ks_s + (pos[j] * LD + (lane / 8) * 8) * 2;
#pragma unroll
        for (int kc2 = 0; kc2 < NK2; ++kc2) {
          uint32_t kb4[4];
          ldmatrix_x4(kb4, ka + kc2 * 64);
          mma_bf16(s[j], qa[2 * kc2], kb4[0], kb4[1]);
          mma_bf16(s[j], qa[2 * kc2 + 1], kb4[2], kb4[3]);
        }
        // to base 2, -inf where the key is not in the query's window
        const bool y0ok = rowin[j] && hy[j] <= 2 * r, y1ok = rowin[j] && hy[j] >= 1;
        const bool x0ok = (okx >> (2 * xb[j])) & 1u, x1ok = (okx >> (2 * xb[j] + 1)) & 1u;
        s[j][0] = y0ok && x0ok ? s[j][0] * kLog2e : -CUDART_INF_F;
        s[j][1] = y0ok && x1ok ? s[j][1] * kLog2e : -CUDART_INF_F;
        s[j][2] = y1ok && x0ok ? s[j][2] * kLog2e : -CUDART_INF_F;
        s[j][3] = y1ok && x1ok ? s[j][3] * kLog2e : -CUDART_INF_F;
      }
      // online softmax: the four lanes of a row agree on its maximum; m stays
      // finite, so 2^(-inf - m) is 0 and nothing needs a guard
      float n0 = m0, n1 = m1;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        n0 = fmaxf(n0, fmaxf(s[j][0], s[j][1]));
        n1 = fmaxf(n1, fmaxf(s[j][2], s[j][3]));
      }
      n0 = fmaxf(n0, __shfl_xor_sync(0xffffffffu, n0, 1));
      n1 = fmaxf(n1, __shfl_xor_sync(0xffffffffu, n1, 1));
      n0 = fmaxf(n0, __shfl_xor_sync(0xffffffffu, n0, 2));
      n1 = fmaxf(n1, __shfl_xor_sync(0xffffffffu, n1, 2));
      const float c0 = ex2(m0 - n0), c1 = ex2(m1 - n1);
      m0 = n0;
      m1 = n1;
      l0 *= c0;
      l1 *= c1;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        s[j][0] = ex2(s[j][0] - n0);
        s[j][1] = ex2(s[j][1] - n0);
        s[j][2] = ex2(s[j][2] - n1);
        s[j][3] = ex2(s[j][3] - n1);
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
      if (__any_sync(0xffffffffu, c0 != 1.f || c1 != 1.f)) {  // a maximum moved
#pragma unroll
        for (int dc = 0; dc < ND; ++dc) {
          acc[dc][0] *= c0;
          acc[dc][1] *= c0;
          acc[dc][2] *= c1;
          acc[dc][3] *= c1;
        }
      }
#pragma unroll
      for (int jp = 0; jp < kSlots; jp += 2) {  // 16 keys a product
        // p = high + low, both bfloat16: the second product keeps float32-grade p
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float a = s[jp + j][2 * i], c = s[jp + j][2 * i + 1];
            const float ah = round_to<BF>(a), ch = round_to<BF>(c);
            ph[2 * j + i] = pack_bf16(ah, ch);
            pl[2 * j + i] = pack_bf16(a - ah, c - ch);
          }
        const uint32_t va = vs_s + (((lane / 8) & 1 ? pos[jp + 1] : pos[jp]) * LD + (lane / 16) * 8) * 2;
#pragma unroll
        for (int dc2 = 0; dc2 < ND / 2; ++dc2) {
          uint32_t vb4[4];
          ldmatrix_x4_trans(vb4, va + dc2 * 32);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            mma_bf16(acc[2 * dc2 + e], ph, vb4[2 * e], vb4[2 * e + 1]);
            mma_bf16(acc[2 * dc2 + e], pl, vb4[2 * e], vb4[2 * e + 1]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {  // kSlots slots on
      xb[j] += kSlots;
      while (xb[j] >= ntx) {
        xb[j] -= ntx;
        ++hy[j];
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float r0 = 1.f / fmaxf(l0, 1e-30f), r1 = 1.f / fmaxf(l1, 1e-30f);
  if (vec_out) {
    // through shared memory (the K halo's room), so that a lane stores 16
    // bytes and eight lanes a query's whole row
    __syncthreads();  // every warp is done with K and V
    BF* os = ks;      // [64 queries][LD]
    const int m0q = (tid / 32) * 16 + g;  // tile row m / 8, column m % 8
#pragma unroll
    for (int dc = 0; dc < ND; ++dc) {
      const int d = dc * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(os + m0q * LD + d) =
          __floats2bfloat162_rn(acc[dc][0] * r0, acc[dc][1] * r0);
      *reinterpret_cast<__nv_bfloat162*>(os + (m0q + 8) * LD + d) =
          __floats2bfloat162_rn(acc[dc][2] * r1, acc[dc][3] * r1);
    }
    __syncthreads();
    BF* ob = o + b * so.b + h * so.h;
    for (int idx = tid; idx < kTile * kTile * ND; idx += kMmaThreads) {
      const int m = idx / ND, d = idx % ND * 8;
      const int oy = ty0 + m / kTile, ox = tx0 + m % kTile;
      if (oy < height && ox < width && d < D)
        *reinterpret_cast<uint4*>(ob + (static_cast<int64_t>(oy) * width + ox) * so.n + d) =
            *reinterpret_cast<const uint4*>(os + m * LD + d);
    }
    return;
  }
  BF* o0 = o + b * so.b + h * so.h + tok0 * so.n;
  BF* o1 = o0 + width * so.n;
#pragma unroll
  for (int dc = 0; dc < ND; ++dc) {
    const int d = dc * 8 + 2 * t;
    auto st2 = [&](BF* row, bool live, float x, float y) {
      if (live && pairs && d + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(row + d) = __floats2bfloat162_rn(x, y);
      } else if (live) {
        if (d < D) row[d] = __float2bfloat16_rn(x);
        if (d + 1 < D) row[d + 1] = __float2bfloat16_rn(y);
      }
    };
    st2(o0, live0, acc[dc][0] * r0, acc[dc][1] * r0);
    st2(o1, live1, acc[dc][2] * r1, acc[dc][3] * r1);
  }
}

// ---- float32: FMAs on the CUDA cores

constexpr int kF32Threads = kTile * kTile * kLanes;  // 256

template <int DPL>
__global__ void __launch_bounds__(kF32Threads)
nat_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               int height, int width, int window, int H, int D, int tiles_x,
               Strides sq, Strides sk, Strides sv, Strides so, float scale, bool vec) {
  constexpr int Dp = DPL * kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = window / 2;
  const int halo = kTile + 2 * r;  // halo side, in positions
  float* ks = reinterpret_cast<float*>(smem);  // [halo*halo][Dp]
  float* vs = ks + halo * halo * Dp;           // [halo*halo][Dp]

  const int tid = threadIdx.x;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  stage_halo<float, Dp>(ks, vs, Dp, k + b * sk.b + h * sk.h, v + b * sv.b + h * sv.h,
                        sk.n, sv.n, ty0 - r, tx0 - r, halo, height, width, D, vec, tid,
                        kF32Threads);

  const int lane = tid % kLanes;
  const int qi = tid / kLanes;
  const int ly = qi / kTile, lx = qi % kTile;  // a warp holds one tile row
  const int qy = ty0 + ly, qx = tx0 + lx;
  const bool live = qy < height && qx < width;
  const int64_t tok = live ? static_cast<int64_t>(qy) * width + qx : 0;
  const int d0 = lane * DPL;

  float qr[DPL];
  {
    const float* qp = q + b * sq.b + tok * sq.n + h * sq.h;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = d0 + i;
      qr[i] = (live && d < D) ? qp[d] * scale : 0.f;
    }
  }

  float m = -CUDART_INF_F, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  cp_async_wait_all();
  __syncthreads();

  for (int dy = 0; dy < window; ++dy) {
    const int ny = qy + dy - r;
    const bool yok = ny >= 0 && ny < height;
    for (int dx = 0; dx < window; ++dx) {
      const int nx = qx + dx - r;
      const bool ok = yok && nx >= 0 && nx < width;
      const int pos = (ly + dy) * halo + (lx + dx);
      float kr[DPL], vr[DPL];
      load_chunk<float, DPL>(ks + pos * Dp + d0, kr);
      load_chunk<float, DPL>(vs + pos * Dp + d0, vr);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) s = fmaf(qr[i], kr[i], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s = ok ? s : -CUDART_INF_F;
      const float m_new = fmaxf(m, s);
      // exp(-inf - -inf) guards: nothing accumulated yet, or a masked key
      const float c = (m == -CUDART_INF_F) ? 0.f : expf(m - m_new);
      const float p = (s == -CUDART_INF_F) ? 0.f : expf(s - m_new);
      l = l * c + p;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] = fmaf(p, vr[i], acc[i] * c);
      m = m_new;
    }
  }

  if (live) {
    const float den = fmaxf(l, 1e-30f);
    float* op = o + b * so.b + tok * so.n + h * so.h;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = d0 + i;
      if (d < D) op[d] = acc[i] / den;
    }
  }
}

struct Geometry {
  int B, height, width, window, H, D;
};

// Whether K and V can be staged 16 bytes a copy: D and every stride whole
// numbers of 16-byte groups, both bases on 16-byte addresses.
bool can_vectorise(const void* k, const void* v, const int64_t* st, int D, int elem) {
  const int per = 16 / elem;
  bool vec = D % per == 0;
  for (int i = 3; i < 9; ++i) vec = vec && st[i] % per == 0;
  return vec && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

template <typename Kernel, typename T, typename... Flags>
int launch(Kernel kern, int threads, size_t smem, const T* q, const T* k, const T* v, T* o,
           const Geometry& gm, const int64_t* st, float scale, cudaStream_t stream,
           Flags... flags) {
  if (smem > static_cast<size_t>(kMaxSmem)) return -2;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_x = (gm.width + kTile - 1) / kTile;
  const int tiles_y = (gm.height + kTile - 1) / kTile;
  const dim3 grid(tiles_x * tiles_y, gm.B * gm.H);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]};
  const Strides sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  kern<<<grid, threads, smem, stream>>>(q, k, v, o, gm.height, gm.width, gm.window, gm.H,
                                        gm.D, tiles_x, sq, sk, sv, so, scale, flags...);
  return static_cast<int>(cudaGetLastError());
}

template <int NK2>
int launch_mma(const void* q, const void* k, const void* v, void* o, const Geometry& gm,
               const int64_t* st, float scale, cudaStream_t stream) {
  const int halo = kTile + 2 * (gm.window / 2);
  const size_t smem = 2 * static_cast<size_t>(halo) * halo * (32 * NK2 + 8) * sizeof(BF);
  // 4-byte loads of q and stores of o need even D, strides and addresses
  bool pairs = gm.D % 2 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
               reinterpret_cast<uintptr_t>(o) % 4 == 0;
  for (int i = 0; i < 3; ++i) pairs = pairs && st[i] % 2 == 0 && st[9 + i] % 2 == 0;
  // 16-byte stores of o: D and o's strides whole groups of 8, its base aligned
  bool vec_out = gm.D % 8 == 0 && reinterpret_cast<uintptr_t>(o) % 16 == 0;
  for (int i = 9; i < 12; ++i) vec_out = vec_out && st[i] % 8 == 0;
  return launch(nat_mma_kernel<NK2>, kMmaThreads, smem, static_cast<const BF*>(q),
                static_cast<const BF*>(k), static_cast<const BF*>(v), static_cast<BF*>(o),
                gm, st, scale, stream, can_vectorise(k, v, st, gm.D, sizeof(BF)), pairs,
                vec_out);
}

template <int DPL>
int launch_f32(const void* q, const void* k, const void* v, void* o, const Geometry& gm,
               const int64_t* st, float scale, cudaStream_t stream) {
  const int halo = kTile + 2 * (gm.window / 2);
  const size_t smem = 2 * static_cast<size_t>(halo) * halo * DPL * kLanes * sizeof(float);
  return launch(nat_f32_kernel<DPL>, kF32Threads, smem, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<float*>(o), gm, st, scale, stream,
                can_vectorise(k, v, st, gm.D, sizeof(float)));
}

}  // namespace

// Launches on `stream`. q, k, v, o: [B, height * width, H, D]; `strides`
// holds the (batch, token, head) strides in elements of q, k, v, o in that
// order (12 values); the last axis of each is contiguous. dtype: 0 float32,
// 1 bfloat16. `window` is odd. `scale` is 1/sqrt(D) already rounded to the
// dtype. Returns 0 on success, cudaGetLastError() otherwise, -1 when
// D > 128, -2 when the halo of one tile exceeds the shared memory of an SM,
// -3 for an unknown dtype. Requires B * H <= 65535; the caller checks.
extern "C" int f3s_neighborhood_attention(const void* q, const void* k,
                                          const void* v, void* o, int dtype,
                                          int B, int height, int width,
                                          int window, int H, int D,
                                          const int64_t* strides, float scale,
                                          void* stream) {
  if (B <= 0 || height <= 0 || width <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry gm{B, height, width, window, H, D};
  if (D > 128) return -1;
  if (dtype == 0) {
    if (D <= 8) return launch_f32<2>(q, k, v, o, gm, strides, scale, s);
    if (D <= 16) return launch_f32<4>(q, k, v, o, gm, strides, scale, s);
    if (D <= 32) return launch_f32<8>(q, k, v, o, gm, strides, scale, s);
    if (D <= 64) return launch_f32<16>(q, k, v, o, gm, strides, scale, s);
    return launch_f32<32>(q, k, v, o, gm, strides, scale, s);
  }
  if (dtype == 1) {
    if (D <= 32) return launch_mma<1>(q, k, v, o, gm, strides, scale, s);
    if (D <= 64) return launch_mma<2>(q, k, v, o, gm, strides, scale, s);
    if (D <= 96) return launch_mma<3>(q, k, v, o, gm, strides, scale, s);
    return launch_mma<4>(q, k, v, o, gm, strides, scale, s);
  }
  return -3;
}
