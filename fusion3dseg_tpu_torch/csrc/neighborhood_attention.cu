// Sliding-window (neighbourhood) attention on an image grid: every query
// attends to the window x window keys around it, masked at the image
// borders (a corner query sees only its in-image neighbours; the window is
// not shifted).
//
// Replaces the TPU kernel fusion3dseg_tpu/ops/attention.py `_nat_kernel`
// (Pallas, reached through `neighborhood_attention`). For q, k, v
// [B, N = height * width, H, D] of type T (float32, bfloat16 or float16), per
// query:
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
// and does 4 * window^2 * D operations per query: 0.4 us at the tensor
// cores' bfloat16 rate at window 7, 3.7 us at window 23 (both at that
// shape), so bytes bound it up to window 27 or so at D = 64.
//
// Both kernels: a block owns an 8 x 8 tile of queries of one (batch, head).
// The keys any of its queries sees lie in the tile's halo, (8 + 2r)^2
// positions around it clamped to the image (r = window / 2; positions
// outside the image are masked, so they are never staged). The block walks
// that clamped halo in chunks: bands of `band_rows` rows, each cut into
// pieces of `band_cols` columns where one whole row of K and V would not
// fit. Chunks go through a ring of two shared-memory buffers filled by
// 16-byte cp.async copies: while the block computes on one chunk, the next
// one's copies are in flight. The running maximum and sum of the online
// softmax carry from chunk to chunk, as the TPU kernel's carry across its
// rows of keys (`dy_step`). Where the whole clamped halo fits the budget
// (`kBudget`, four blocks an SM) it is one chunk in one buffer, staged once:
// window 7 at D <= 64 in bfloat16 or float16, as before. So any odd window runs, at
// any width, with at most kBudget bytes (or the 64 output rows of the
// two-byte kernel's store, whichever is more) of shared memory a block;
// `nat_plan` chooses and ops/attention.py `_nat_plan` mirrors it. Each K/V
// element is read from L2 once for every tile whose halo holds it, (1 +
// 2r/8)^2 times in the interior (3.06 at window 7) instead of window^2
// times. Where D, the strides or the bases do not allow 16-byte copies the
// staging falls back to one element a load. No padded K/V copy in device
// memory, no [B*H, N, D] transposes (strides are read directly), no
// height % tile requirement: a ragged tile computes on zeros and does not
// store.
//
// * bfloat16 and float16 (`nat_mma_kernel`, a template on the element type E
//   with an instance for each): both products on the tensor cores, mma.sync
//   m16n8k16. A warp owns 16 queries, two rows of the tile, and multiplies
//   them against every key of a chunk on the rows its queries see (at most
//   2 + 2r of them), each row cut into slots of 8 columns. Keys outside a
//   query's window score -inf from coordinates; softmax runs online over
//   steps of four slots in the accumulator layout, in base 2. Warps finish
//   a chunk at different times; the block meets at one __syncthreads before
//   a chunk (its copies have landed) and one after (its buffer may be
//   refilled), every warp through every chunk, so ragged tiles and warps
//   with no rows in a chunk cannot deadlock. K and V fragments come from the
//   position-major chunk by ldmatrix (V's transposed by the instruction),
//   rows of D + 8 elements so that the eight rows of a matrix fall on
//   different banks. The probabilities stay float32-grade: p is split into a
//   high part and a remainder, both in E, and the second product runs on
//   both, so the plain version needs no rounding of p. (In float16 the
//   remainder of a p below about 0.12 is a subnormal, kept to 2^-24: p is
//   still within 2^-24 of float32's, against output steps of 2^-11.) The output goes
//   through the first buffer's room in shared memory, so that a lane stores
//   16 bytes. The dense work (the chunk's width against every query of the
//   warp) is 2.6 times the windowed work at window 7 and still far below the
//   bound. At window 7, D = 64: 2 * 196 * 72 * 2 = 56,448 bytes a block, four
//   blocks (16 warps, at most 128 registers a thread) an SM; the 512 blocks
//   of [8, 64*64, 1, 64] and of [2, 128*128, 1, 64] are one wave of the 528
//   slots (`tools/kernel_parts.py` times the staging and the products
//   apart). It runs at under one instruction a cycle an SM: four warps a
//   scheduler, each a chain of mma.sync, shuffles and exponentials through a
//   step.
// * float32 (`nat_f32_kernel`): FMAs on the CUDA cores (TF32 products would
//   not hold the 1e-4 agreement asked of float32). Four adjacent lanes share
//   a query, each with a quarter of D in registers; a score is a quarter dot
//   product plus two shuffles, softmax online per key. A warp is one tile
//   row; it visits the chunk's columns that any of its queries' windows
//   holds, each lane masking the keys outside its own.
// * any D past 128: in bfloat16 and float16 `nat_mma_wide_kernel` on the
//   tensor cores, eight warps a strip of 2 x 8 queries owning all of D up to 320 (the
//   output in column blocks of 320 past it): q staged once, K, then V, in
//   units of 64 columns through a cp.async ring, each score taken once and
//   the softmax in shared memory (`mma_wide_plan`); in float32
//   `nat_f32_wide_kernel` on the CUDA cores, the same strip, units and
//   column blocks, each score taken once for the keys in its query's window
//   only, the softmax online over the halo's chunks (`f32_wide_plan`). See
//   their notes. Any B * H: launches take (batch, head) in runs of 65,535.

#include <cstring>

#include "attention_common.cuh"

// Measurement builds (tools/kernel_parts.py): 1 leaves out the staging of K
// and V in the two-byte kernels and the float32 wide kernel, 2 their
// products. Results are then wrong by design.
#ifndef F3S_PARTS
#define F3S_PARTS 0
#endif

namespace {

using namespace f3s;

constexpr int kTile = 8;       // queries per tile side
constexpr int kBudget = 57344;  // bytes of K and V a block stages: four blocks an SM

// How a block walks its tile's clamped halo: chunks of `rows` x `cols`
// positions (cols a multiple of 8 unless it is the whole clamped width),
// through `stages` buffers, `smem` bytes in all. ops/attention.py
// `_nat_plan` mirrors it.
struct Plan {
  int rows, cols, stages;
  int64_t smem;
};

// `ld` elements of `elem` bytes a staged row of K or V; `out_bytes` the
// room the kernel's epilogue needs.
Plan nat_plan(int window, int width, int ld, int elem, int64_t out_bytes) {
  const int halo = kTile + 2 * (window / 2);
  const int64_t pos = 2LL * ld * elem;  // one position of K and one of V
  const int wide = halo < width ? halo : width;  // the halo clamped to the image's width
  Plan p;
  if (static_cast<int64_t>(halo) * wide * pos <= kBudget) {
    p = {halo, wide, 1, static_cast<int64_t>(halo) * wide * pos};
  } else {
    const int64_t per = kBudget / 2;  // one buffer of the ring
    int cols = wide;
    if (cols * pos > per) cols = static_cast<int>(per / pos) / 8 * 8;
    const int64_t rows = per / (cols * pos);
    p = {static_cast<int>(rows < halo ? rows : halo), cols, 2, 0};
    p.smem = 2LL * p.rows * p.cols * pos;
  }
  if (p.smem < out_bytes) p.smem = out_bytes;
  return p;
}

// A chunk of the tile's clamped halo, in image coordinates: rows [y0, y1),
// columns [x0, x1).
struct Chunk {
  int y0, y1, x0, x1;
};

// The halo of the tile at (ty0, tx0) (`tile_rows` x 8 queries) clamped to
// the image, cut into chunks of at most rows x cols, rows outer.
struct Walk {
  int Y0, Y1, X0, X1, rows, cols, ncx, count;

  __device__ Walk(int ty0, int tx0, int r, int height, int width, int rows_, int cols_,
                  int tile_rows = kTile)
      : Y0(max(ty0 - r, 0)), Y1(min(ty0 + tile_rows + r, height)), X0(max(tx0 - r, 0)),
        X1(min(tx0 + kTile + r, width)), rows(rows_), cols(cols_) {
    ncx = (X1 - X0 + cols - 1) / cols;
    count = (Y1 - Y0 + rows - 1) / rows * ncx;
  }
  __device__ Chunk operator[](int c) const {
    Chunk ch;
    ch.y0 = Y0 + c / ncx * rows;
    ch.y1 = min(Y1, ch.y0 + rows);
    ch.x0 = X0 + c % ncx * cols;
    ch.x1 = min(X1, ch.x0 + cols);
    return ch;
  }
};

// Stage chunk `ch` of K and V of one (batch, head) into ks, vs, position-
// major [(y - y0) * (x1 - x0) + x - x0][ld], Dp <= ld elements a row filled
// (zeros at d >= D). Every position lies in the image. The copies are
// committed as one cp.async group.
template <typename T, int Dp>
__device__ __forceinline__ void stage_chunk(T* ks, T* vs, int ld, const T* kb, const T* vb,
                                            int64_t skn, int64_t svn, const Chunk& ch,
                                            int width, int D, bool vec, int tid, int nthreads) {
  const int rows = ch.y1 - ch.y0, cols = ch.x1 - ch.x0;
  if (vec) {  // 16 bytes a copy: D, the strides and the bases allow it
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    constexpr int kChunks = Dp / kPer;
    // a thread keeps its column of the chunk and its 16 bytes of D and walks
    // down the rows: one pointer step and two copies a row
    const int64_t krow = width * skn, vrow = width * svn;
    for (int it = tid; it < cols * kChunks; it += nthreads) {
      const int cx = it / kChunks, d = it % kChunks * kPer;
      const bool in = d < D;
      const int64_t gx = ch.x0 + cx;
      const T* kp = kb + gx * skn + d + ch.y0 * krow;
      const T* vp = vb + gx * svn + d + ch.y0 * vrow;
      T* kd = ks + cx * ld + d;
      T* vd = vs + cx * ld + d;
      for (int cy = 0; cy < rows; ++cy) {
        cp_async16(kd, in ? kp : kb, in ? 16 : 0);
        cp_async16(vd, in ? vp : vb, in ? 16 : 0);
        kp += krow;
        vp += vrow;
        kd += cols * ld;
        vd += cols * ld;
      }
    }
  } else {
    const T zero = from_f32<T>(0.f);
    for (int idx = tid; idx < rows * cols * Dp; idx += nthreads) {
      const int pos = idx / Dp, d = idx % Dp;
      const int64_t tok = static_cast<int64_t>(ch.y0 + pos / cols) * width + ch.x0 + pos % cols;
      ks[pos * ld + d] = d < D ? kb[tok * skn + d] : zero;
      vs[pos * ld + d] = d < D ? vb[tok * svn + d] : zero;
    }
  }
  cp_async_commit();
}

// ---- bfloat16 and float16: both products on the tensor cores

using BF = __nv_bfloat16;
using F16 = __half;

constexpr int kMmaThreads = kTile / 2 * 32;  // a warp per two tile rows
constexpr int kSlots = 4;  // slots of 8 keys a softmax step

template <typename E, int NK2>  // head dim padded to 32 * NK2
__global__ void __launch_bounds__(kMmaThreads, NK2 <= 2 ? 4 : 1)
nat_mma_kernel(const E* __restrict__ q, const E* __restrict__ k,
               const E* __restrict__ v, E* __restrict__ o,
               int height, int width, int window, int H, int D, int tiles_x,
               Strides sq, Strides sk, Strides sv, Strides so, float scale,
               int band_rows, int band_cols, int bh0, bool vec, bool pairs, bool vec_out) {
  constexpr int Dp = 32 * NK2;
  constexpr int NK = 2 * NK2;   // 16-wide chunks of the head dim
  constexpr int ND = Dp / 8;    // 8-wide chunks of the head dim
  constexpr int LD = Dp + 8;    // row of a staged position, elements
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = window / 2;
  // buffer s of the ring: K at base + 2 s * size, V after it
  const int size = band_rows * band_cols * LD;
  E* base = reinterpret_cast<E*>(smem);

  const int tid = threadIdx.x;
  const int b = (bh0 + blockIdx.y) / H;
  const int h = (bh0 + blockIdx.y) % H;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const E* kb = k + b * sk.b + h * sk.h;
  const E* vb = v + b * sv.b + h * sv.h;
  const Walk walk(ty0, tx0, r, height, width, band_rows, band_cols);
  if (F3S_PARTS != 1)
    stage_chunk<E, Dp>(base, base + size, LD, kb, vb, sk.n, sv.n, walk[0], width, D, vec,
                       tid, kMmaThreads);

  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wy = (tid / 32) * 2;  // this warp's two rows of the tile
  // the lane's queries: (row wy, column g) and (row wy + 1, column g)
  const int qx = tx0 + g, qy0 = ty0 + wy;
  const bool live0 = qx < width && qy0 < height, live1 = qx < width && qy0 + 1 < height;
  const int64_t tok0 = static_cast<int64_t>(qy0) * width + qx;

  // q * scale, rounded to E, as A fragments (while the chunk lands)
  uint32_t qa[NK][4];
  {
    const E* q0 = q + b * sq.b + h * sq.h + tok0 * sq.n;
    const E* q1 = q0 + width * sq.n;
    auto ld2 = [&](const E* row, bool live, int d) -> uint32_t {
      float x = 0.f, y = 0.f;
      if (live && pairs && d + 1 < D) {
        const float2 xy = unpack2<E>(*reinterpret_cast<const uint32_t*>(row + d));
        x = xy.x;
        y = xy.y;
      } else if (live) {
        if (d < D) x = to_f32<E>(row[d]);
        if (d + 1 < D) y = to_f32<E>(row[d + 1]);
      }
      return pack2<E>(x * scale, y * scale);
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

  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;  // maxima in base-2 units
  float acc[ND][4];
#pragma unroll
  for (int dc = 0; dc < ND; ++dc)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dc][i] = 0.f;

  for (int c = 0; c < walk.count; ++c) {
    if (c + 1 < walk.count) {  // the next chunk's copies fly under this one's products
      E* nk = base + 2 * ((c + 1) % 2) * size;
      if (F3S_PARTS != 1)
        stage_chunk<E, Dp>(nk, nk + size, LD, kb, vb, sk.n, sv.n, walk[c + 1], width, D,
                           vec, tid, kMmaThreads);
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();

    // this warp's keys in the chunk: rows [y0, y1) that a query of rows
    // qy0, qy0 + 1 sees, every row in nsx slots of 8 columns from ch.x0
    const Chunk ch = walk[c];
    const int cols = ch.x1 - ch.x0;
    const int y0 = max(ch.y0, qy0 - r), y1 = min(ch.y1, qy0 + 2 + r);
    const int nsx = (cols + 7) / 8;
    const int nslots = F3S_PARTS == 2 || y1 <= y0 ? 0 : (y1 - y0) * nsx;
    const uint32_t ks_s = smem_addr(base + 2 * (c % 2) * size);
    const uint32_t vs_s = ks_s + size * 2;
    int sy[kSlots], sx[kSlots];  // slot j of a step: row y0 + sy[j], columns ch.x0 + 8 sx[j] ..
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      sy[j] = j / nsx;
      sx[j] = j % nsx;
    }
    for (int it = 0; it < nslots; it += kSlots) {
      bool in[kSlots];
      int pos[kSlots];  // this lane's ldmatrix row: key lane % 8 of the slot
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        in[j] = it + j < nslots;
        const int cx = min(8 * sx[j] + lane % 8, cols - 1);  // slots past the chunk repeat its edge
        pos[j] = in[j] ? (y0 + sy[j] - ch.y0) * cols + cx : 0;
      }
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
          mma16816<E>(s[j], qa[2 * kc2], kb4[0], kb4[1]);
          mma16816<E>(s[j], qa[2 * kc2 + 1], kb4[2], kb4[3]);
        }
        // to base 2, -inf where the key is not in the query's window: row y
        // against query rows qy0 and qy0 + 1, columns x, x + 1 against qx
        const int y = y0 + sy[j];
        const bool y0ok = in[j] && y <= qy0 + r, y1ok = in[j] && y >= qy0 + 1 - r;
        const int x = ch.x0 + 8 * sx[j] + 2 * t;
        const bool x0ok = x < ch.x1 && abs(x - qx) <= r;
        const bool x1ok = x + 1 < ch.x1 && abs(x + 1 - qx) <= r;
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
        // p = high + low, both in E: the second product keeps float32-grade p
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float a = s[jp + j][2 * i], cc = s[jp + j][2 * i + 1];
            const float ah = round_to<E>(a), ch_ = round_to<E>(cc);
            ph[2 * j + i] = pack2<E>(ah, ch_);
            pl[2 * j + i] = pack2<E>(a - ah, cc - ch_);
          }
        const uint32_t va = vs_s + (((lane / 8) & 1 ? pos[jp + 1] : pos[jp]) * LD + (lane / 16) * 8) * 2;
#pragma unroll
        for (int dc2 = 0; dc2 < ND / 2; ++dc2) {
          uint32_t vb4[4];
          ldmatrix_x4_trans(vb4, va + dc2 * 32);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            mma16816<E>(acc[2 * dc2 + e], ph, vb4[2 * e], vb4[2 * e + 1]);
            mma16816<E>(acc[2 * dc2 + e], pl, vb4[2 * e], vb4[2 * e + 1]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {  // kSlots slots on
        sx[j] += kSlots;
        while (sx[j] >= nsx) {
          sx[j] -= nsx;
          ++sy[j];
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float r0 = 1.f / fmaxf(l0, 1e-30f), r1 = 1.f / fmaxf(l1, 1e-30f);
  if (vec_out) {
    // through shared memory (the first buffer's room), so that a lane stores
    // 16 bytes and eight lanes a query's whole row
    E* os = base;  // [64 queries][LD]
    const int m0q = (tid / 32) * 16 + g;  // tile row m / 8, column m % 8
#pragma unroll
    for (int dc = 0; dc < ND; ++dc) {
      const int d = dc * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(os + m0q * LD + d) =
          pack2<E>(acc[dc][0] * r0, acc[dc][1] * r0);
      *reinterpret_cast<uint32_t*>(os + (m0q + 8) * LD + d) =
          pack2<E>(acc[dc][2] * r1, acc[dc][3] * r1);
    }
    __syncthreads();
    E* ob = o + b * so.b + h * so.h;
    for (int idx = tid; idx < kTile * kTile * ND; idx += kMmaThreads) {
      const int m = idx / ND, d = idx % ND * 8;
      const int oy = ty0 + m / kTile, ox = tx0 + m % kTile;
      if (oy < height && ox < width && d < D)
        *reinterpret_cast<uint4*>(ob + (static_cast<int64_t>(oy) * width + ox) * so.n + d) =
            *reinterpret_cast<const uint4*>(os + m * LD + d);
    }
    return;
  }
  E* o0 = o + b * so.b + h * so.h + tok0 * so.n;
  E* o1 = o0 + width * so.n;
#pragma unroll
  for (int dc = 0; dc < ND; ++dc) {
    const int d = dc * 8 + 2 * t;
    auto st2 = [&](E* row, bool live, float x, float y) {
      if (live && pairs && d + 1 < D) {
        *reinterpret_cast<uint32_t*>(row + d) = pack2<E>(x, y);
      } else if (live) {
        if (d < D) row[d] = from_f32<E>(x);
        if (d + 1 < D) row[d + 1] = from_f32<E>(y);
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
               Strides sq, Strides sk, Strides sv, Strides so, float scale,
               int band_rows, int band_cols, int bh0, bool vec) {
  constexpr int Dp = DPL * kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = window / 2;
  const int size = band_rows * band_cols * Dp;  // a buffer's K (or V), floats
  float* base = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int b = (bh0 + blockIdx.y) / H;
  const int h = (bh0 + blockIdx.y) % H;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const Walk walk(ty0, tx0, r, height, width, band_rows, band_cols);
  stage_chunk<float, Dp>(base, base + size, Dp, kb, vb, sk.n, sv.n, walk[0], width, D, vec,
                         tid, kF32Threads);

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

  for (int c = 0; c < walk.count; ++c) {
    if (c + 1 < walk.count) {
      float* nk = base + 2 * ((c + 1) % 2) * size;
      stage_chunk<float, Dp>(nk, nk + size, Dp, kb, vb, sk.n, sv.n, walk[c + 1], width, D,
                             vec, tid, kF32Threads);
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();

    // rows of the chunk in the window of this warp's row; columns x = qx -
    // r + dx for the dx where some query of the row finds x in the chunk
    const Chunk ch = walk[c];
    const int cols = ch.x1 - ch.x0;
    const float* ks = base + 2 * (c % 2) * size;
    const float* vs = ks + size;
    const int y0 = max(ch.y0, qy - r), y1 = min(ch.y1, qy + r + 1);
    const int dx0 = max(0, ch.x0 - tx0 - (kTile - 1) + r), dx1 = min(window, ch.x1 - tx0 + r);
    for (int y = y0; y < y1; ++y) {
      for (int dx = dx0; dx < dx1; ++dx) {
        const int x = qx + dx - r;
        const bool ok = x >= ch.x0 && x < ch.x1;
        const int pos = (y - ch.y0) * cols + min(max(x, ch.x0), ch.x1 - 1) - ch.x0;
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
        const float cf = (m == -CUDART_INF_F) ? 0.f : expf(m - m_new);
        const float p = (s == -CUDART_INF_F) ? 0.f : expf(s - m_new);
        l = l * cf + p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] = fmaf(p, vr[i], acc[i] * cf);
        m = m_new;
      }
    }
    __syncthreads();  // every warp is done with this buffer
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

constexpr int kMaxNarrowD = 128;  // past it, the wide kernels below

// ---- bfloat16 and float16 past D = 128: one block owns all of D for a strip of
// queries
//
// A block of eight warps owns a strip of 2 x 8 queries (two rows of a tile:
// one mma.sync m16 tile) and kMmaWideOut columns of its output: all of D
// up to 320 (B2 re-headed), and past that the grid's z axis cuts the
// output into column blocks of 320, each taking the scores again (the cut:
// O of 320 columns is 40 float32 registers a thread, within the 128 that
// let two blocks share an SM). So [8, 16*16, 1, 320] runs 128 blocks. The
// strip's q (all of D) is staged once. Its halo, clamped to the image, goes in chunks
// (`mma_wide_plan`), and a stream of units goes through a cp.async ring of
// `stages` buffers (the next stages - 1 units' copies fly while the block
// works on one; one barrier a unit): K in units of kMmaWideCols columns
// over the whole D, V in units of kMmaWideCols of the block's columns. Each
// score is taken once for the block's columns, and K and V are each read
// once a block.
//
// The eight warps share the chunk's slots of 8 keys on the strip's rows,
// two each: mma.sync with q * scale rounded to E as A fragments and
// K's, both by ldmatrix, the sums held in registers over the chunk's K
// units, then written to the block's score rows in shared memory
// (float32). Sixteen threads a query take the softmax there (base 2) and
// write p of every slot of the chunk (0 outside the window) as a high part
// and remainder in E (the second product keeps p float32-grade, as in
// nat_mma_kernel), in rows of 16 slots x 8 keys that ldmatrix reads as A
// fragments. Each warp adds P V for each V unit to its 8 of the unit's 64
// columns (V by ldmatrix.trans, two slot pairs an instruction, into two
// accumulators so that the chains are half as long; p's fragments read
// again for each unit rather than held, which keeps a thread within 128
// registers, so that two blocks share an SM where the grid has more blocks
// than SMs). O stays in registers
// for the whole halo. The slot loops run over all kMmaWideSlots whether or
// not a slot holds keys (an empty slot's p is 0), so that ptxas interleaves
// their products.
//
// Two kinds of score rows (`kWin`):
// * the window's (windows up to 11, where 16 rows of window^2 floats take
//   at most a sixth of the budget): a row holds its query's window, every
//   chunk writes its keys there, all K units come first, then the maximum
//   over the window, then chunk by chunk p and its V units. Window 7's
//   halo (8 x 14) is one chunk.
// * the chunk's (wider windows): a row holds the chunk's positions, and the
//   softmax runs online over the chunks (K units, maximum and p, O rescaled
//   by the query's correction, V units, chunk by chunk), the running
//   maximum and sum kept by the query's threads, as the TPU kernel carries
//   them across its rows of keys.
constexpr int kStripRows = 2;                         // query rows of a block
constexpr int kStripQueries = kStripRows * kTile;     // 16: one m16 tile
constexpr int kMmaWideThreads = 256;                  // eight warps
constexpr int kMmaWideWarps = kMmaWideThreads / 32;
constexpr int kSoftLanes = kMmaWideThreads / kStripQueries;  // 16 threads a query
constexpr int kMmaWideCols = 64;               // columns of D a unit of K or V stages
constexpr int kMmaWideLd = kMmaWideCols + 8;   // a staged row: 4 mod 8 words, as LD above
constexpr int kMmaWideUnits = 5;               // V units of a block's output
constexpr int kMmaWideOut = kMmaWideUnits * kMmaWideCols;  // 320 output columns a block
constexpr int kMmaWideSlots = 16;              // slots of 8 keys a chunk: two a warp
constexpr int kPLd = kMmaWideSlots * 8 + 8;    // a row of p (16-bit): 4 mod 8 words
constexpr int kMmaWideStages = 4;              // the most buffers of the ring

// floats a score row takes for n entries: 4 mod 8 words, so that the lanes
// of a warp writing rows g = 0..7 fall on distinct banks
__host__ __device__ inline int score_ld(int n) { return n + (12 - n % 8) % 8; }

// the elements of a staged q row: all of D in units, and 8 against bank
// conflicts
__host__ __device__ inline int q_ld(int D) {
  return (D + kMmaWideCols - 1) / kMmaWideCols * kMmaWideCols + 8;
}

// bytes before the ring: the 16 score rows and corrections for n entries a
// row, q, and p's high parts and remainders
__host__ __device__ inline int fixed_bytes(int n, int D) {
  return kStripQueries * ((score_ld(n) + 1) * 4 + q_ld(D) * 2 + 2 * kPLd * 2);
}

// whether the two-byte wide kernel keeps each query's whole window of
// scores: its rows within a sixth of the budget
bool window_scores(int window) {
  return kStripQueries * (score_ld(window * window) + 1) * 4 <= kBudget / 6;
}

// The rows of a strip's chunks: the plan's `rows` of `cols` positions, or
// more where the strip's halo, clamped to the image, is narrower than
// `cols` (as many as the ring's buffers hold, within kMmaWideSlots slots).
// ops/attention.py `_nat_tile_rows` mirrors it.
__host__ __device__ inline int tile_rows(int rows, int cols, int halo_rows, int halo_cols) {
  const int piece = cols < halo_cols ? cols : halo_cols, nsx = (piece + 7) / 8;
  int t = rows * cols / piece;
  if (t > halo_rows) t = halo_rows;
  while (t > rows && t * nsx > kMmaWideSlots) --t;
  return t < 1 ? 1 : t;
}

// until at most n of this thread's committed cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n <= 0) cp_async_wait_group<0>();
  else if (n == 1) cp_async_wait_group<1>();
  else if (n == 2) cp_async_wait_group<2>();
  else cp_async_wait_group<3>();
}

template <typename E, bool kWin>
__global__ void __launch_bounds__(kMmaWideThreads, 2)
nat_mma_wide_kernel(const E* __restrict__ q, const E* __restrict__ k,
                    const E* __restrict__ v, E* __restrict__ o, int height, int width,
                    int window, int H, int D, int tiles_x, Strides sq, Strides sk, Strides sv,
                    Strides so, float scale, int band_rows, int band_cols, int bh0, int stages,
                    bool vec, bool pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int npos_max = band_rows * band_cols;
  const int entries = kWin ? window * window : npos_max;
  const int sld = score_ld(entries), qld = q_ld(D);
  float* sc = reinterpret_cast<float*>(smem);   // [16 queries][sld]: scores
  float* qrow = sc + kStripQueries * sld;       // [16]: a chunk's corrections; at the end 1 / l
  E* qs = reinterpret_cast<E*>(qrow + kStripQueries);  // [16][qld]: q as stored
  E* p_hi = qs + kStripQueries * qld;           // [16][kPLd]: p's high parts, by slot and key
  E* p_lo = p_hi + kStripQueries * kPLd;        // [16][kPLd]: and remainders
  E* ring = p_lo + kStripQueries * kPLd;        // stages x [npos_max][kMmaWideLd]
  const int unit_elems = npos_max * kMmaWideLd;

  const int r = window / 2;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = (bh0 + blockIdx.y) / H;
  const int h = (bh0 + blockIdx.y) % H;
  const int c0 = blockIdx.z * kMmaWideOut;  // this block's output columns c0 ..
  const int nk = (D + kMmaWideCols - 1) / kMmaWideCols;  // K units a chunk
  const int nv = (min(kMmaWideOut, D - c0) + kMmaWideCols - 1) / kMmaWideCols;  // V units
  const int ty0 = (blockIdx.x / tiles_x) * kStripRows;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const E* kb = k + b * sk.b + h * sk.h;
  const E* vb = v + b * sv.b + h * sv.h;
  const int halo_rows = min(ty0 + kStripRows + r, height) - max(ty0 - r, 0);
  const int halo_cols = min(tx0 + kTile + r, width) - max(tx0 - r, 0);
  const Walk walk(ty0, tx0, r, height, width,
                  tile_rows(band_rows, band_cols, halo_rows, halo_cols), band_cols, kStripRows);
  const int units = walk.count * (nk + nv);

  // 16 bytes of row `tok` of src from column d0 into dst: cp.async where
  // `vec` (zeros past D or where !live), else element by element
  const E zero = from_f32<E>(0.f);
  auto piece = [&](E* dst, const E* src, int64_t tok, int d0, bool live) {
    if (vec) {
      const bool in = live && d0 < D;
      cp_async16(dst, in ? src + tok + d0 : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i] = live && d0 + i < D ? src[tok + d0 + i] : zero;
    }
  };
  // the strip's q, all of D (zeros past D and outside the image)
  if (!(F3S_PARTS & 1)) {
    const E* qb = q + b * sq.b + h * sq.h;
    for (int i = tid; i < kStripQueries * (qld / 8); i += kMmaWideThreads) {
      const int m = i / (qld / 8), d = i % (qld / 8) * 8;
      const int y = ty0 + m / kTile, x = tx0 + m % kTile;
      const bool live = y < height && x < width;
      piece(qs + m * qld + d, qb, live ? (static_cast<int64_t>(y) * width + x) * sq.n : 0, d,
            live);
    }
  }

  // unit u: its chunk, K or V, its 64 columns' index. kWin: every chunk's K
  // units, then every chunk's V units; else chunk by chunk, K then V
  auto unit_of = [&](int u, int& c, bool& is_k, int& dc) {
    if (kWin) {
      is_k = u < walk.count * nk;
      const int w = is_k ? u : u - walk.count * nk, n = is_k ? nk : nv;
      c = w / n;
      dc = w % n;
    } else {
      c = u / (nk + nv);
      dc = u % (nk + nv);
      is_k = dc < nk;
      if (!is_k) dc -= nk;
    }
  };
  // unit u into buffer u % stages: the chunk's positions, 64 columns of K
  // or of the block's V, zeros past D; one cp.async group (empty past the
  // last unit, so that every step commits one)
  auto issue = [&](int u) {
    if (u < units && !(F3S_PARTS & 1)) {
      int c, dc;
      bool is_k;
      unit_of(u, c, is_k, dc);
      const Chunk ch = walk[c];
      const E* src = is_k ? kb : vb;
      const int64_t stride = is_k ? sk.n : sv.n;
      const int d0 = (is_k ? 0 : c0) + dc * kMmaWideCols;
      E* dst = ring + (u % stages) * unit_elems;
      const int cols = ch.x1 - ch.x0, npos = (ch.y1 - ch.y0) * cols;
      // a thread keeps its 16 bytes of a position's columns and steps over
      // the positions kStep at a time (row and column carried)
      constexpr int kPieces = kMmaWideCols / 8, kStep = kMmaWideThreads / kPieces;
      const int d = tid % kPieces * 8;
      int pos = tid / kPieces, py = pos / cols, px = pos % cols;
      for (; pos < npos; pos += kStep) {
        piece(dst + pos * kMmaWideLd + d, src,
              (static_cast<int64_t>(ch.y0 + py) * width + ch.x0 + px) * stride, d0 + d, true);
        for (px += kStep; px >= cols; px -= cols) ++py;
      }
    }
    cp_async_commit();
  };
  // into unit u: its copies have landed and the block has met (so every
  // warp is done with unit u - 1), then unit u + stages - 1 goes into the
  // buffer u - 1 left; returns the shared address of unit u's buffer
  int u = 0;
  auto begin = [&]() {
    cp_async_wait_pending(stages - 2);
    __syncthreads();
    issue(u + stages - 1);
    return smem_addr(ring + (u++ % stages) * unit_elems);
  };

  // the lane's queries: (row ty0, column g) and (row ty0 + 1, column g),
  // score rows g and g + 8
  const int qx = tx0 + g, qy0 = ty0;
  const bool live0 = qx < width && qy0 < height, live1 = qx < width && qy0 + 1 < height;
  const int qi0 = g, qi1 = g + kTile;

  // the strip's keys in chunk c: every row of the chunk in nsx slots of 8
  // columns from ch.x0 (nslots at most kMmaWideSlots, by the plan)
  struct Keys {
    Chunk ch;
    int cols, nsx, nslots;
  };
  auto keys_of = [&](int c) {
    Keys ks;
    ks.ch = walk[c];
    ks.cols = ks.ch.x1 - ks.ch.x0;
    ks.nsx = (ks.cols + 7) / 8;
    ks.nslots = (ks.ch.y1 - ks.ch.y0) * ks.nsx;
    return ks;
  };
  // this lane's ldmatrix row of slot j: key lane % 8 of it (slots past the
  // chunk's width repeat its edge; past nslots, the chunk's first position)
  auto slot_pos = [&](const Keys& ks, int j) {
    const int cx = min(8 * (j % ks.nsx) + lane % 8, ks.cols - 1);
    return j < ks.nslots ? j / ks.nsx * ks.cols + cx : 0;
  };
  // the score row entry of the query at (qy, qx_) for the key at (y, x) of
  // the chunk, or -1 outside its window
  auto entry = [&](const Chunk& ch, int qy, int qx_, int y, int x) {
    const int dy = y - qy + r, dx = x - qx_ + r;
    const bool in = dy >= 0 && dy < window && dx >= 0 && dx < window;
    return !in ? -1 : kWin ? dy * window + dx : (y - ch.y0) * (ch.x1 - ch.x0) + x - ch.x0;
  };

  // the K units of chunk c: the scores of this warp's slots (warp, warp +
  // 8) over D, then into score rows qi0, qi1
  const uint32_t qa_row = smem_addr(qs + ((lane / 8 % 2) * 8 + lane % 8) * qld + lane / 16 * 8);
  auto score_chunk = [&](int c) {
    const Keys ks = keys_of(c);
    constexpr int kMine = kMmaWideSlots / kMmaWideWarps;
    int pos[kMine];
    float s[kMine][4];
#pragma unroll
    for (int j = 0; j < kMine; ++j) {
      pos[j] = slot_pos(ks, warp + kMmaWideWarps * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
    for (int kd = 0; kd < nk; ++kd) {
      const uint32_t kbase = begin();
      // q * scale, rounded to E, as A fragments of columns 64 kd ..
      uint32_t qa[kMmaWideCols / 16][4];
#pragma unroll
      for (int kc = 0; kc < kMmaWideCols / 16; ++kc) {
        ldmatrix_x4(qa[kc], qa_row + (kd * kMmaWideCols + kc * 16) * 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack2<E>(qa[kc][e]);
          qa[kc][e] = pack2<E>(f.x * scale, f.y * scale);
        }
      }
#pragma unroll
      for (int j = 0; j < (F3S_PARTS & 2 ? 0 : kMine); ++j) {
        const uint32_t ka = kbase + (pos[j] * kMmaWideLd + (lane / 8) * 8) * 2;
#pragma unroll
        for (int kc2 = 0; kc2 < kMmaWideCols / 32; ++kc2) {
          uint32_t kb4[4];
          ldmatrix_x4(kb4, ka + kc2 * 64);
          mma16816<E>(s[j], qa[2 * kc2], kb4[0], kb4[1]);
          mma16816<E>(s[j], qa[2 * kc2 + 1], kb4[2], kb4[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMine; ++j) {
      const int ps = warp + kMmaWideWarps * j;
      if (ps < ks.nslots) {
        const int y = ks.ch.y0 + ps / ks.nsx, x = ks.ch.x0 + 8 * (ps % ks.nsx) + 2 * t;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (x + e >= ks.ch.x1) continue;
          const int e0 = entry(ks.ch, qy0, qx, y, x + e), e1 = entry(ks.ch, qy0 + 1, qx, y, x + e);
          if (e0 >= 0) sc[qi0 * sld + e0] = s[j][e];
          if (e1 >= 0) sc[qi1 * sld + e1] = s[j][2 + e];
        }
      }
    }
  };

  // the softmax's threads: kSoftLanes a query (mq: its score row), its
  // running maximum (base 2) and this thread's share of the running sum
  const int mq = tid / kSoftLanes, sub = tid % kSoftLanes;
  const int mqy = ty0 + mq / kTile, mqx = tx0 + mq % kTile;
  float m_run = -1e30f, l_run = 0.f;
  // the new maximum over the query's window keys in ch (kWin: the whole
  // clamped halo); the correction of the sum so far into qrow
  auto new_max = [&](const Chunk& ch) {
    const float* row = sc + mq * sld;
    const int wy0 = max(ch.y0, mqy - r), wy1 = min(ch.y1, mqy + r + 1);
    const int wx0 = max(ch.x0, mqx - r), ww = min(ch.x1, mqx + r + 1) - wx0;
    float mx = m_run;
    if (ww > 0)
      for (int i = sub; i < (wy1 - wy0) * ww; i += kSoftLanes) {
        const int e = entry(ch, mqy, mqx, wy0 + i / ww, wx0 + i % ww);
        mx = fmaxf(mx, row[e] * kLog2e);
      }
#pragma unroll
    for (int off = 1; off < kSoftLanes; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    // m stays finite, so 2^(m_old - m_new) needs no guard (0 at the first key)
    const float cr = ex2(m_run - mx);
    m_run = mx;
    l_run *= cr;
    if (sub == 0) qrow[mq] = cr;
  };
  // p of every slot and key of chunk c for query mq, 0 outside its window,
  // as high part and remainder; its sum
  auto write_p = [&](int c) {
    const Keys ks = keys_of(c);
    const float* row = sc + mq * sld;
    for (int i = sub; i < kMmaWideSlots * 8; i += kSoftLanes) {
      const int ps = i / 8, x = ks.ch.x0 + 8 * (ps % ks.nsx) + i % 8;
      const int e = ps < ks.nslots && x < ks.ch.x1
                        ? entry(ks.ch, mqy, mqx, ks.ch.y0 + ps / ks.nsx, x) : -1;
      const float p = e >= 0 ? ex2(row[e] * kLog2e - m_run) : 0.f;
      l_run += p;
      const E ph = from_f32<E>(p);
      p_hi[mq * kPLd + i] = ph;
      p_lo[mq * kPLd + i] = from_f32<E>(p - to_f32<E>(ph));
    }
  };

  float acc[kMmaWideUnits][2][4];  // O: V unit, two partial sums (even, odd slot pairs), fragment
#pragma unroll
  for (int vi = 0; vi < kMmaWideUnits; ++vi)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[vi][i][e] = 0.f;
  // the V units of chunk c (p written, the block met): this lane's
  // ldmatrix row of V for each two of the chunk's slot pairs (16 keys, a k
  // step of P V); then O += P V, unit by unit (unrolled, so that O stays in
  // registers), p's A fragments by ldmatrix where they are used
  const uint32_t pa = smem_addr(p_hi + (lane / 8 % 2 * 8 + lane % 8) * kPLd + lane / 16 * 8);
  const uint32_t p_lo_off = kStripQueries * kPLd * 2;  // bytes from p_hi to p_lo
  auto pv_chunk = [&](int c) {
    const Keys ks = keys_of(c);
    constexpr int kGroups = kMmaWideSlots / 2;
    int vrow[kGroups / 2];
#pragma unroll
    for (int jq = 0; jq < kGroups / 2; ++jq) vrow[jq] = slot_pos(ks, 4 * jq + lane / 8);
#pragma unroll
    for (int vi = 0; vi < kMmaWideUnits; ++vi) {
      if (vi >= nv) break;
      const uint32_t vcol = begin() + warp * 8 * 2;  // this warp's 8 columns
#pragma unroll
      for (int jq = 0; jq < (F3S_PARTS & 2 ? 0 : kGroups / 2); ++jq) {
        // slot pairs 2 jq and 2 jq + 1: B fragments (keys 0-7, 8-15) of each
        uint32_t vb4[4];
        ldmatrix_x4_trans(vb4, vcol + vrow[jq] * kMmaWideLd * 2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint32_t ph[4], pl[4];
          ldmatrix_x4(ph, pa + 32 * (2 * jq + e));
          ldmatrix_x4(pl, pa + p_lo_off + 32 * (2 * jq + e));
          mma16816<E>(acc[vi][e], ph, vb4[2 * e], vb4[2 * e + 1]);
          mma16816<E>(acc[vi][e], pl, vb4[2 * e], vb4[2 * e + 1]);
        }
      }
    }
  };

  for (int s = 0; s < stages - 1; ++s) issue(s);  // q rides in the first group
  if (kWin) {
    for (int c = 0; c < walk.count; ++c) score_chunk(c);
    __syncthreads();  // every chunk's scores are written
    Chunk all;  // the window's keys in the clamped halo
    all.y0 = walk.Y0;
    all.y1 = walk.Y1;
    all.x0 = walk.X0;
    all.x1 = walk.X1;
    new_max(all);
    for (int c = 0; c < walk.count; ++c) {
      if (c > 0) __syncthreads();  // every warp has read the last chunk's p
      write_p(c);
      __syncthreads();
      pv_chunk(c);
    }
  } else {
    for (int c = 0; c < walk.count; ++c) {
      score_chunk(c);
      __syncthreads();  // the chunk's scores are written, the last chunk's p read
      new_max(walk[c]);
      write_p(c);
      __syncthreads();
      const float cr0 = qrow[qi0], cr1 = qrow[qi1];
#pragma unroll
      for (int vi = 0; vi < kMmaWideUnits; ++vi)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[vi][i][0] *= cr0;
          acc[vi][i][1] *= cr0;
          acc[vi][i][2] *= cr1;
          acc[vi][i][3] *= cr1;
        }
      pv_chunk(c);
    }
  }
  cp_async_wait_group<0>();  // the empty groups past the last unit

#pragma unroll
  for (int off = 1; off < kSoftLanes; off <<= 1)
    l_run += __shfl_xor_sync(0xffffffffu, l_run, off);
  __syncthreads();  // every warp has read qrow's corrections
  if (sub == 0) qrow[mq] = 1.f / fmaxf(l_run, 1e-30f);
  __syncthreads();
  const float r0 = qrow[qi0], r1 = qrow[qi1];
  E* o0 = o + b * so.b + h * so.h + (static_cast<int64_t>(qy0) * width + qx) * so.n;
  E* o1 = o0 + width * so.n;
  auto st2 = [&](E* row, bool live, int d, float x, float y) {
    if (live && pairs && d + 1 < D) {
      *reinterpret_cast<uint32_t*>(row + d) = pack2<E>(x, y);
    } else if (live) {
      if (d < D) row[d] = from_f32<E>(x);
      if (d + 1 < D) row[d + 1] = from_f32<E>(y);
    }
  };
#pragma unroll
  for (int vi = 0; vi < kMmaWideUnits; ++vi) {
    if (vi >= nv) break;
    const int d = c0 + vi * kMmaWideCols + warp * 8 + 2 * t;
    const float* a = acc[vi][0];
    const float* z = acc[vi][1];
    st2(o0, live0, d, (a[0] + z[0]) * r0, (a[1] + z[1]) * r0);
    st2(o1, live1, d, (a[2] + z[2]) * r1, (a[3] + z[3]) * r1);
  }
}

// ---- float32 past D = 128: a strip of 2 x 8 queries a block, all of D up to 320
//
// `nat_f32_wide_kernel`: the structure of nat_mma_wide_kernel on the CUDA
// cores. A block of eight warps owns a strip of 2 x 8 queries (16 threads a
// query) and 320 columns of its output: all of D up to 320, past that the
// grid's z axis cuts the output into column blocks of 320, each taking the
// scores again. The strip's halo, clamped to the image, goes in chunks of
// at most kF32WidePos positions (`f32_wide_plan`: rows of pieces of at most
// 64 columns; a strip whose clamped halo is narrower than the pieces takes
// more rows a chunk, `f32_wide_rows`); window 7's 8 x 14 halo is one chunk.
// Units of 64 columns stream through a cp.async ring of 2 to 4 buffers, one
// barrier a unit: for each chunk, K units over all of D, each carrying the
// strip's q in the same 64 columns (so q is staged once where the halo is
// one chunk, and no D is too wide), then V units over the block's columns.
//
// Each score is taken once, and only for the keys in its query's window:
// a thread holds up to kF32WideEntries scores of its query (entries sub +
// 16 j of the query's window clamped to the chunk, row-major), summed over
// the K units. After the chunk's last K unit the query's 16 threads take
// the chunk's max by shuffles, rescale the running sum and O by exp(m_old
// - m_new), and write p to the query's row in shared memory. For each V
// unit a thread adds p v over the query's keys to 4 of the unit's 64
// columns, O (5 x 4 floats) staying in registers for the whole halo. So the
// softmax runs online over the chunks, as the TPU kernel carries it across
// its rows of keys, and the output is divided by the row sum at the end.
// At [8,16*16,1,320] window 7 the windowed FMAs take 1.5 us at 67 Tflop/s
// and the bytes 3.1 us: what sets the time is the chain of staged units of
// each of the 128 blocks (as for nat_mma_wide_kernel), so a block keeps up
// to 4 units in flight.
constexpr int kF32WideSubs = 16;                                // threads a query
constexpr int kF32WideThreads = kStripQueries * kF32WideSubs;
constexpr int kF32WideCols = 64;                                // columns of a unit
constexpr int kF32WideLd = kF32WideCols + 4;                    // a staged row: 4 mod 32 words
constexpr int kF32WideUnits = 5;                                // V units of a block's output
constexpr int kF32WideOut = kF32WideUnits * kF32WideCols;       // 320 output columns a block
constexpr int kF32WidePos = 128;                                // most positions of a chunk
constexpr int kF32WideEntries = kF32WidePos / kF32WideSubs;     // scores a thread
constexpr int kF32WideStages = 4;                               // the most buffers of the ring
constexpr int kF32WideBudget = kMaxSmem / 2 - 1024;             // half an SM

// shared bytes: the 16 queries' rows of p for npos entries, and `stages`
// units of the strip's q and npos positions, 64 columns each
__host__ __device__ inline int64_t f32_wide_smem(int npos, int stages) {
  return static_cast<int64_t>(kStripQueries) * score_ld(npos) * 4 +
         static_cast<int64_t>(stages) * (kStripQueries + npos) * kF32WideLd * 4;
}

// The rows of a strip's chunks: as many as fit the plan's positions in
// pieces as wide as the strip's clamped halo allows, within its rows.
// ops/attention.py `_nat_f32_rows` mirrors it.
__host__ __device__ inline int f32_wide_rows(int rows, int cols, int halo_rows, int halo_cols) {
  const int piece = cols < halo_cols ? cols : halo_cols;
  const int t = rows * cols / piece;
  return t < 1 ? 1 : t < halo_rows ? t : halo_rows;
}

__global__ void __launch_bounds__(kF32WideThreads, 1)
nat_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int height, int width,
                    int window, int H, int D, int tiles_x, Strides sq, Strides sk, Strides sv,
                    Strides so, float scale, int band_rows, int band_cols, int bh0, int stages,
                    bool vec, bool vec_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int npos_max = band_rows * band_cols;
  const int p_ld = score_ld(npos_max);
  float* ps = reinterpret_cast<float*>(smem);          // [16 queries][p_ld]: p
  float* ring = ps + kStripQueries * p_ld;             // stages x [16 + npos_max][kF32WideLd]
  const int unit_floats = (kStripQueries + npos_max) * kF32WideLd;

  const int r = window / 2;
  const int tid = threadIdx.x;
  const int b = (bh0 + blockIdx.y) / H;
  const int h = (bh0 + blockIdx.y) % H;
  const int c0 = blockIdx.z * kF32WideOut;  // this block's output columns c0 ..
  const int nk = (D + kF32WideCols - 1) / kF32WideCols;  // K units a chunk
  const int nv = (min(kF32WideOut, D - c0) + kF32WideCols - 1) / kF32WideCols;  // V units
  const int ty0 = (blockIdx.x / tiles_x) * kStripRows;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int halo_rows = min(ty0 + kStripRows + r, height) - max(ty0 - r, 0);
  const int halo_cols = min(tx0 + kTile + r, width) - max(tx0 - r, 0);
  const Walk walk(ty0, tx0, r, height, width,
                  f32_wide_rows(band_rows, band_cols, halo_rows, halo_cols), band_cols,
                  kStripRows);
  const int per_chunk = nk + nv;
  const int units = walk.count * per_chunk;

  // unit u into buffer u % stages: chunk u / per_chunk; a K unit holds the
  // strip's q (16 rows, zeros outside the image) and then the chunk's
  // positions, a V unit the positions; 64 columns, zeros past D. A thread
  // keeps one piece of the columns and walks down the rows. One cp.async
  // group (empty past the last unit, so that every step commits one)
  auto issue = [&](int u) {
    if (u >= units || (F3S_PARTS & 1)) return;
    const Chunk ch = walk[u / per_chunk];
    const int ru = u % per_chunk, cw = ch.x1 - ch.x0;
    const bool is_k = ru < nk;
    const int col0 = is_k ? ru * kF32WideCols : c0 + (ru - nk) * kF32WideCols;
    const float* src = is_k ? kb : vb;
    const int64_t stride = is_k ? sk.n : sv.n;
    const int qrows = is_k ? kStripQueries : 0;
    const int rows = qrows + (ch.y1 - ch.y0) * cw;
    float* dst = ring + (u % stages) * unit_floats;
    const int per = vec ? 4 : 1;          // floats a copy
    const int pieces = kF32WideCols / per;
    const int step = kF32WideThreads / pieces;  // rows a pass
    const int c = tid % pieces * per;
    const bool in_d = col0 + c < D;
    int py = -1, px = 0;  // the image position of the thread's position row
    for (int row = tid / pieces; row < rows; row += step) {
      const float* g;
      bool in = in_d;
      if (row < qrows) {
        const int y = ty0 + row / kTile, x = tx0 + row % kTile;
        in = in && y < height && x < width;
        g = qb + (static_cast<int64_t>(y) * width + x) * sq.n;
      } else {
        if (py < 0) {  // the thread's first position row
          py = ch.y0 + (row - qrows) / cw;
          px = ch.x0 + (row - qrows) % cw;
        }
        g = src + (static_cast<int64_t>(py) * width + px) * stride;
        px += step;
        while (px >= ch.x1) {
          px -= cw;
          ++py;
        }
      }
      if (vec)
        cp_async16(dst + row * kF32WideLd + c, in ? g + col0 + c : src, in ? 16 : 0);
      else
        dst[row * kF32WideLd + c] = in ? g[col0 + c] : 0.f;
    }
  };

  const int qi = tid / kF32WideSubs, sub = tid % kF32WideSubs;
  const int qy = ty0 + qi / kTile, qx = tx0 + qi % kTile;
  const bool live = qy < height && qx < width;
  float* prow = ps + qi * p_ld;

  float m_run = -CUDART_INF_F, l_part = 0.f;
  float acc[kF32WideUnits][4];  // O: the query's 4 columns 4 sub of each V unit
#pragma unroll
  for (int vi = 0; vi < kF32WideUnits; ++vi)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[vi][c] = 0.f;

  for (int u = 0; u < stages - 1; ++u) {
    issue(u);
    cp_async_commit();
  }
  int u = 0;
  // the next unit: it has landed, every thread is done with the one before
  // (whose buffer now takes the unit stages - 1 on)
  auto next_unit = [&]() {
    cp_async_wait_pending(stages - 2);
    __syncthreads();
    issue(u + stages - 1);
    cp_async_commit();
    return ring + (u++ % stages) * unit_floats;
  };

  for (int c = 0; c < walk.count; ++c) {
    const Chunk ch = walk[c];
    const int cw = ch.x1 - ch.x0;
    // this query's keys in the chunk: rows [ry0, ry0 + wy), columns [rx0, rx0 + wx)
    const int ry0 = max(ch.y0, qy - r), rx0 = max(ch.x0, qx - r);
    const int wy = live ? max(min(ch.y1, qy + r + 1) - ry0, 0) : 0;
    const int wx = max(min(ch.x1, qx + r + 1) - rx0, 0);
    const int count = wy * wx;
    const int ne = count > sub ? (count - sub + kF32WideSubs - 1) / kF32WideSubs : 0;
    // entries sub + subs j of the rectangle, row-major; past ne the first
    // position (its score is not used)
    int pos[kF32WideEntries];
#pragma unroll
    for (int j = 0; j < kF32WideEntries; ++j) {
      const int e = sub + kF32WideSubs * j, wd = wx > 0 ? wx : 1;
      pos[j] = j < ne ? (ry0 + e / wd - ch.y0) * cw + rx0 + e % wd - ch.x0 : 0;
    }

    float s[kF32WideEntries];
#pragma unroll
    for (int j = 0; j < kF32WideEntries; ++j) s[j] = 0.f;
    for (int ku = 0; ku < nk; ++ku) {
      const float* unit = next_unit();
      if (F3S_PARTS & 2) continue;
      const float* qr = unit + qi * kF32WideLd;
      const float* kr = unit + kStripQueries * kF32WideLd;
      const int ncols = min(kF32WideCols, D - ku * kF32WideCols);  // past D: not staged
      // entries in pairs: two independent chains a pass over the columns
#pragma unroll
      for (int j = 0; j < kF32WideEntries; j += 2) {
        if (j >= ne) break;
        const float* k0 = kr + pos[j] * kF32WideLd;
        const float* k1 = kr + pos[j + 1] * kF32WideLd;
        float s0 = 0.f, s1 = 0.f, t0 = 0.f, t1 = 0.f;  // two chains a key
#pragma unroll 4
        for (int c4 = 0; c4 < ncols; c4 += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qr + c4);
          const float4 x = *reinterpret_cast<const float4*>(k0 + c4);
          const float4 y = *reinterpret_cast<const float4*>(k1 + c4);
          s0 = fmaf(a.x * scale, x.x, s0);
          t0 = fmaf(a.y * scale, x.y, t0);
          s0 = fmaf(a.z * scale, x.z, s0);
          t0 = fmaf(a.w * scale, x.w, t0);
          s1 = fmaf(a.x * scale, y.x, s1);
          t1 = fmaf(a.y * scale, y.y, t1);
          s1 = fmaf(a.z * scale, y.z, s1);
          t1 = fmaf(a.w * scale, y.w, t1);
        }
        s[j] += s0 + t0;
        s[j + 1] += s1 + t1;
      }
    }

    // the chunk's max over the query's threads, the running sum and O
    // rescaled, p of the query's keys into its row
    float cmax = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kF32WideEntries; ++j)
      if (j < ne) cmax = fmaxf(cmax, s[j]);
#pragma unroll
    for (int off = 1; off < kF32WideSubs; off <<= 1)
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
    const float m_new = fmaxf(m_run, cmax);
    // no key yet (the query outside the image, or no key of the chunk in
    // its window before any other): nothing to rescale
    const float alpha = m_new == -CUDART_INF_F ? 1.f : expf(m_run - m_new);
    l_part *= alpha;
#pragma unroll
    for (int j = 0; j < kF32WideEntries; ++j)
      if (j < ne) {
        const float p = expf(s[j] - m_new);
        l_part += p;
        prow[sub + kF32WideSubs * j] = p;
      }
    m_run = m_new;
#pragma unroll
    for (int vi = 0; vi < kF32WideUnits; ++vi)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[vi][cc] *= alpha;
    __syncwarp();  // a query's threads share one warp

#pragma unroll
    for (int vi = 0; vi < kF32WideUnits; ++vi) {
      if (vi >= nv) break;  // the same in the whole block
      const float* unit = next_unit();
      if (F3S_PARTS & 2) continue;
      const float* vcol = unit + 4 * sub;
      int e = 0;
      for (int yy = ry0; yy < ry0 + wy; ++yy) {
        const float* vrow = vcol + ((yy - ch.y0) * cw - ch.x0) * kF32WideLd;
        int xx = rx0;
        // two keys a step into a sum of their own: half the chain on acc
        for (; xx + 1 < rx0 + wx; xx += 2, e += 2) {
          const float p0 = prow[e], p1 = prow[e + 1];
          const float4 x = *reinterpret_cast<const float4*>(vrow + xx * kF32WideLd);
          const float4 y = *reinterpret_cast<const float4*>(vrow + (xx + 1) * kF32WideLd);
          acc[vi][0] += fmaf(p1, y.x, p0 * x.x);
          acc[vi][1] += fmaf(p1, y.y, p0 * x.y);
          acc[vi][2] += fmaf(p1, y.z, p0 * x.z);
          acc[vi][3] += fmaf(p1, y.w, p0 * x.w);
        }
        if (xx < rx0 + wx) {
          const float p0 = prow[e++];
          const float4 x = *reinterpret_cast<const float4*>(vrow + xx * kF32WideLd);
          acc[vi][0] = fmaf(p0, x.x, acc[vi][0]);
          acc[vi][1] = fmaf(p0, x.y, acc[vi][1]);
          acc[vi][2] = fmaf(p0, x.z, acc[vi][2]);
          acc[vi][3] = fmaf(p0, x.w, acc[vi][3]);
        }
      }
    }
  }
  cp_async_wait_group<0>();  // the empty groups past the last unit

  float l = l_part;
#pragma unroll
  for (int off = 1; off < kF32WideSubs; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
  float* op = o + b * so.b + h * so.h + (static_cast<int64_t>(qy) * width + qx) * so.n;
#pragma unroll
  for (int vi = 0; vi < kF32WideUnits; ++vi) {
    const int d = c0 + vi * kF32WideCols + 4 * sub;
    if (vi >= nv || d >= D) continue;
    float x[4];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) x[cc] = acc[vi][cc] / den;
    if (vec_out) {
      *reinterpret_cast<float4*>(op + d) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        if (d + cc < D) op[d + cc] = x[cc];
    }
  }
}

// The float32 wide kernel's chunks: rows of the strip's clamped halo cut
// into pieces of at most 64 columns (a multiple of 8, or the whole clamped
// width), as many rows a chunk as keep it at kF32WidePos positions; then as
// many ring buffers (2 to 4) as fit kF32WideBudget beside the rows of p.
// Window 7 at D = 320 on a 16-wide image: the strip's 8 x 14 halo in one
// chunk, three buffers.
Plan f32_wide_plan(int window, int width) {
  const int halo_rows = kStripRows + 2 * (window / 2), halo = kTile + 2 * (window / 2);
  const int wide = halo < width ? halo : width;
  const int cols = wide < 64 ? wide : 64;
  const int by_pos = kF32WidePos / cols;
  const int rows = by_pos < halo_rows ? by_pos : halo_rows;
  int stages = kF32WideStages;
  while (stages > 2 && f32_wide_smem(rows * cols, stages) > kF32WideBudget) --stages;
  return {rows, cols, stages, f32_wide_smem(rows * cols, stages)};
}

// The two-byte wide kernel's chunks (bfloat16 and float16): rows of the
// strip's clamped halo cut into pieces of at most 64 columns (a multiple of
// 8, or the whole clamped width), as many rows a chunk as keep it at
// kMmaWideSlots slots of 8 columns and two ring buffers of kMmaWideLd
// elements a position within kBudget beside the score rows (of the window, or of the chunk's
// positions), q and p (`fixed_bytes`); then as many buffers as fit (at most
// kMmaWideStages). Window 7 at D = 320: the strip's 8 x 14 halo in one
// chunk, two buffers.
int64_t mma_wide_smem(int window, int D, int npos, int stages) {
  return fixed_bytes(window_scores(window) ? window * window : npos, D) +
         static_cast<int64_t>(stages) * npos * kMmaWideLd * 2;
}

Plan mma_wide_plan(int window, int D, int width) {
  const int halo_rows = kStripRows + 2 * (window / 2), halo = kTile + 2 * (window / 2);
  const int wide = halo < width ? halo : width;
  const int cols = wide < 64 ? wide : 64;
  const int by_slots = kMmaWideSlots / ((cols + 7) / 8);
  int rows = by_slots < halo_rows ? by_slots : halo_rows;
  while (rows > 1 && mma_wide_smem(window, D, rows * cols, 2) > kBudget) --rows;
  int stages = kMmaWideStages;
  while (stages > 2 && mma_wide_smem(window, D, rows * cols, stages) > kBudget) --stages;
  return {rows, cols, stages, mma_wide_smem(window, D, rows * cols, stages)};
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

// `col_blocks`: the grid's z axis (the wide kernels' column blocks of D);
// `block_rows`: the query rows of a block (a tile's 8, or a strip's 2)
template <typename Kernel, typename T, typename... Flags>
int launch(Kernel kern, int threads, const Plan& plan, int col_blocks, int block_rows,
           const T* q, const T* k, const T* v, T* o, const Geometry& gm, const int64_t* st,
           float scale, cudaStream_t stream, Flags... flags) {
  const int smem = static_cast<int>(plan.smem);  // at most kBudget or 64 rows of the output
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_x = (gm.width + kTile - 1) / kTile;
  const int tiles_y = (gm.height + block_rows - 1) / block_rows;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]};
  const Strides sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  return over_batch_heads(static_cast<int64_t>(gm.B) * gm.H, [&](int bh0, int count) {
    const dim3 grid(tiles_x * tiles_y, count, col_blocks);
    kern<<<grid, threads, smem, stream>>>(q, k, v, o, gm.height, gm.width, gm.window, gm.H,
                                          gm.D, tiles_x, sq, sk, sv, so, scale, plan.rows,
                                          plan.cols, bh0, flags...);
    return static_cast<int>(cudaGetLastError());
  });
}

template <int NK2>
Plan mma_plan(int window, int width) {
  constexpr int LD = 32 * NK2 + 8;
  return nat_plan(window, width, LD, sizeof(BF), kTile * kTile * LD * sizeof(BF));
}

template <int DPL>
Plan f32_plan(int window, int width) {
  return nat_plan(window, width, DPL * kLanes, sizeof(float), 0);
}

// 4-byte loads of q and stores of o need even D, strides and addresses
bool can_pair(const void* q, const void* o, const int64_t* st, int D) {
  bool pairs = D % 2 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
               reinterpret_cast<uintptr_t>(o) % 4 == 0;
  for (int i = 0; i < 3; ++i) pairs = pairs && st[i] % 2 == 0 && st[9 + i] % 2 == 0;
  return pairs;
}

template <typename E, int NK2>
int launch_mma(const void* q, const void* k, const void* v, void* o, const Geometry& gm,
               const int64_t* st, float scale, cudaStream_t stream) {
  const bool pairs = can_pair(q, o, st, gm.D);
  // 16-byte stores of o: D and o's strides whole groups of 8, its base aligned
  bool vec_out = gm.D % 8 == 0 && reinterpret_cast<uintptr_t>(o) % 16 == 0;
  for (int i = 9; i < 12; ++i) vec_out = vec_out && st[i] % 8 == 0;
  return launch(nat_mma_kernel<E, NK2>, kMmaThreads, mma_plan<NK2>(gm.window, gm.width), 1,
                kTile, static_cast<const E*>(q), static_cast<const E*>(k),
                static_cast<const E*>(v), static_cast<E*>(o), gm, st, scale, stream,
                can_vectorise(k, v, st, gm.D, sizeof(E)), pairs, vec_out);
}

template <int DPL>
int launch_f32(const void* q, const void* k, const void* v, void* o, const Geometry& gm,
               const int64_t* st, float scale, cudaStream_t stream) {
  return launch(nat_f32_kernel<DPL>, kF32Threads, f32_plan<DPL>(gm.window, gm.width), 1, kTile,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(o), gm, st, scale, stream,
                can_vectorise(k, v, st, gm.D, sizeof(float)));
}

// past D = 128 in float32: column blocks of 320 (one block at D <= 320)
int launch_f32_wide(const void* q, const void* k, const void* v, void* o, const Geometry& gm,
                    const int64_t* st, float scale, cudaStream_t stream) {
  const Plan plan = f32_wide_plan(gm.window, gm.width);
  // 16-byte copies of q too, and 16-byte stores of o
  bool vec = can_vectorise(k, v, st, gm.D, sizeof(float)) &&
             reinterpret_cast<uintptr_t>(q) % 16 == 0;
  bool vec_out = gm.D % 4 == 0 && reinterpret_cast<uintptr_t>(o) % 16 == 0;
  for (int i = 0; i < 3; ++i) {
    vec = vec && st[i] % 4 == 0;
    vec_out = vec_out && st[9 + i] % 4 == 0;
  }
  return launch(nat_f32_wide_kernel, kF32WideThreads, plan,
                (gm.D + kF32WideOut - 1) / kF32WideOut, kStripRows,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(o), gm, st, scale, stream,
                plan.stages, vec, vec_out);
}

// past D = 128 in bfloat16 or float16 (E): column blocks of 320 (one block at
// D <= 320)
template <typename E>
int launch_mma_wide(const void* q, const void* k, const void* v, void* o, const Geometry& gm,
                    const int64_t* st, float scale, cudaStream_t stream) {
  const Plan plan = mma_wide_plan(gm.window, gm.D, gm.width);
  // 16-byte copies of q too: its base and strides whole 16-byte pieces
  bool vec = can_vectorise(k, v, st, gm.D, sizeof(E)) && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  for (int i = 0; i < 3; ++i) vec = vec && st[i] % 8 == 0;
  return launch(window_scores(gm.window) ? nat_mma_wide_kernel<E, true>
                                         : nat_mma_wide_kernel<E, false>,
                kMmaWideThreads, plan, (gm.D + kMmaWideOut - 1) / kMmaWideOut, kStripRows,
                static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
                static_cast<E*>(o), gm, st, scale, stream, plan.stages, vec,
                can_pair(q, o, st, gm.D));
}

// the two-byte kernels of element type E at head dim D
template <typename E>
int launch_two_byte(const void* q, const void* k, const void* v, void* o, const Geometry& gm,
                    const int64_t* st, float scale, cudaStream_t stream) {
  if (gm.D > kMaxNarrowD) return launch_mma_wide<E>(q, k, v, o, gm, st, scale, stream);
  if (gm.D <= 32) return launch_mma<E, 1>(q, k, v, o, gm, st, scale, stream);
  if (gm.D <= 64) return launch_mma<E, 2>(q, k, v, o, gm, st, scale, stream);
  if (gm.D <= 96) return launch_mma<E, 3>(q, k, v, o, gm, st, scale, stream);
  return launch_mma<E, 4>(q, k, v, o, gm, st, scale, stream);
}

}  // namespace

// Launches on `stream`. q, k, v, o: [B, height * width, H, D]; `strides`
// holds the (batch, token, head) strides in elements of q, k, v, o in that
// order (12 values); the last axis of each is contiguous. dtype: 0 float32,
// 1 bfloat16, 2 float16. `window` is odd, of any size; any D, any B * H.
// `scale` is 1/sqrt(D) already rounded to the dtype. Returns 0 on success,
// cudaGetLastError() otherwise, -3 for an unknown dtype.
extern "C" int f3s_neighborhood_attention(const void* q, const void* k,
                                          const void* v, void* o, int dtype,
                                          int B, int height, int width,
                                          int window, int H, int D,
                                          const int64_t* strides, float scale,
                                          void* stream) {
  if (B <= 0 || height <= 0 || width <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry gm{B, height, width, window, H, D};
  if (dtype == 1) return launch_two_byte<BF>(q, k, v, o, gm, strides, scale, s);
  if (dtype == 2) return launch_two_byte<F16>(q, k, v, o, gm, strides, scale, s);
  if (dtype == 0) {
    if (D > kMaxNarrowD) return launch_f32_wide(q, k, v, o, gm, strides, scale, s);
    if (D <= 8) return launch_f32<2>(q, k, v, o, gm, strides, scale, s);
    if (D <= 16) return launch_f32<4>(q, k, v, o, gm, strides, scale, s);
    if (D <= 32) return launch_f32<8>(q, k, v, o, gm, strides, scale, s);
    if (D <= 64) return launch_f32<16>(q, k, v, o, gm, strides, scale, s);
    return launch_f32<32>(q, k, v, o, gm, strides, scale, s);
  }
  return -3;
}

// The plan a launch of `f3s_neighborhood_attention` takes, for checking
// ops/attention.py `_nat_plan`: plan = [rows, cols, stages, shared bytes]
// (bfloat16 and float16 share theirs). Returns 0, or -3 as the launcher
// would.
extern "C" int f3s_nat_plan(int dtype, int window, int D, int width, int64_t* plan) {
  Plan p;
  const bool two_byte = dtype == 1 || dtype == 2;
  if (D > kMaxNarrowD && (dtype == 0 || two_byte)) {
    p = two_byte ? mma_wide_plan(window, D, width) : f32_wide_plan(window, width);
  } else if (dtype == 0) {
    p = D <= 8 ? f32_plan<2>(window, width) : D <= 16 ? f32_plan<4>(window, width)
        : D <= 32 ? f32_plan<8>(window, width) : D <= 64 ? f32_plan<16>(window, width)
        : f32_plan<32>(window, width);
  } else if (two_byte) {
    p = D <= 32 ? mma_plan<1>(window, width) : D <= 64 ? mma_plan<2>(window, width)
        : D <= 96 ? mma_plan<3>(window, width) : mma_plan<4>(window, width);
  } else {
    return -3;
  }
  plan[0] = p.rows;
  plan[1] = p.cols;
  plan[2] = p.stages;
  plan[3] = p.smem;
  return 0;
}

// The resources of kernel `name` ("mma_wide", "mma_wide_online": bfloat16
// past D = 128 with the window's or the chunk's score rows; "f32_wide";
// "mma_<NK2>", "f32_<DPL>"; a two-byte name with "_f16" for its float16
// twin): out = [registers a thread, local (spilled) bytes a thread, static
// shared bytes, most threads a block]. Returns 0, -3 for an unknown name,
// or the CUDA error.
extern "C" int f3s_nat_resources(const char* name, int* out) {
  static const struct {
    const char* name;
    const void* fn;
  } kKernels[] = {
      {"mma_wide", reinterpret_cast<const void*>(nat_mma_wide_kernel<BF, true>)},
      {"mma_wide_online", reinterpret_cast<const void*>(nat_mma_wide_kernel<BF, false>)},
      {"mma_1", reinterpret_cast<const void*>(nat_mma_kernel<BF, 1>)},
      {"mma_2", reinterpret_cast<const void*>(nat_mma_kernel<BF, 2>)},
      {"mma_3", reinterpret_cast<const void*>(nat_mma_kernel<BF, 3>)},
      {"mma_4", reinterpret_cast<const void*>(nat_mma_kernel<BF, 4>)},
      {"mma_wide_f16", reinterpret_cast<const void*>(nat_mma_wide_kernel<F16, true>)},
      {"mma_wide_online_f16", reinterpret_cast<const void*>(nat_mma_wide_kernel<F16, false>)},
      {"mma_1_f16", reinterpret_cast<const void*>(nat_mma_kernel<F16, 1>)},
      {"mma_2_f16", reinterpret_cast<const void*>(nat_mma_kernel<F16, 2>)},
      {"mma_3_f16", reinterpret_cast<const void*>(nat_mma_kernel<F16, 3>)},
      {"mma_4_f16", reinterpret_cast<const void*>(nat_mma_kernel<F16, 4>)},
      {"f32_wide", reinterpret_cast<const void*>(nat_f32_wide_kernel)},
      {"f32_16", reinterpret_cast<const void*>(nat_f32_kernel<16>)},
  };
  const void* fn = nullptr;
  for (const auto& kernel : kKernels)
    if (!std::strcmp(name, kernel.name)) fn = kernel.fn;
  if (fn == nullptr) return -3;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = attr.maxThreadsPerBlock;
  return 0;
}
