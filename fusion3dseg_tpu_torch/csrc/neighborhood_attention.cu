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
// window 7 at D <= 64 in bfloat16, as before. So any odd window runs, at
// any width, with at most kBudget bytes (or the 64 output rows of the
// bfloat16 kernel's store, whichever is more) of shared memory a block;
// `nat_plan` chooses and ops/attention.py `_nat_plan` mirrors it. Each K/V
// element is read from L2 once for every tile whose halo holds it, (1 +
// 2r/8)^2 times in the interior (3.06 at window 7) instead of window^2
// times. Where D, the strides or the bases do not allow 16-byte copies the
// staging falls back to one element a load. No padded K/V copy in device
// memory, no [B*H, N, D] transposes (strides are read directly), no
// height % tile requirement: a ragged tile computes on zeros and does not
// store.
//
// * bfloat16 (`nat_mma_kernel`): both products on the tensor cores, mma.sync
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
//   bfloat16 high part and a bfloat16 remainder and the second product runs
//   on both, so the plain version needs no rounding of p. The output goes
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
// * any D past 128 (`nat_mma_wide_kernel` in bfloat16 on the tensor cores,
//   `nat_f32_wide_kernel` in float32 on the CUDA cores): the scores over D
//   in chunks of 128 and the output in column blocks of 128, the halo in
//   chunks of at most 8 slots of 8 keys a warp (`wide_plan`; see their
//   notes). Any B * H: launches take (batch, head) in runs of 65,535.

#include "attention_common.cuh"

// Measurement builds (tools/kernel_parts.py): 1 leaves out the staging of K
// and V in the bfloat16 kernel, 2 its products. Results are then wrong by
// design.
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

// The halo of the tile at (ty0, tx0) clamped to the image, cut into chunks
// of at most rows x cols, rows outer.
struct Walk {
  int Y0, Y1, X0, X1, rows, cols, ncx, count;

  __device__ Walk(int ty0, int tx0, int r, int height, int width, int rows_, int cols_)
      : Y0(max(ty0 - r, 0)), Y1(min(ty0 + kTile + r, height)), X0(max(tx0 - r, 0)),
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
               int band_rows, int band_cols, int bh0, bool vec, bool pairs, bool vec_out) {
  constexpr int Dp = 32 * NK2;
  constexpr int NK = 2 * NK2;   // 16-wide chunks of the head dim
  constexpr int ND = Dp / 8;    // 8-wide chunks of the head dim
  constexpr int LD = Dp + 8;    // row of a staged position, elements
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = window / 2;
  // buffer s of the ring: K at base + 2 s * size, V after it
  const int size = band_rows * band_cols * LD;
  BF* base = reinterpret_cast<BF*>(smem);

  const int tid = threadIdx.x;
  const int b = (bh0 + blockIdx.y) / H;
  const int h = (bh0 + blockIdx.y) % H;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const BF* kb = k + b * sk.b + h * sk.h;
  const BF* vb = v + b * sv.b + h * sv.h;
  const Walk walk(ty0, tx0, r, height, width, band_rows, band_cols);
  if (F3S_PARTS != 1)
    stage_chunk<BF, Dp>(base, base + size, LD, kb, vb, sk.n, sv.n, walk[0], width, D, vec,
                        tid, kMmaThreads);

  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wy = (tid / 32) * 2;  // this warp's two rows of the tile
  // the lane's queries: (row wy, column g) and (row wy + 1, column g)
  const int qx = tx0 + g, qy0 = ty0 + wy;
  const bool live0 = qx < width && qy0 < height, live1 = qx < width && qy0 + 1 < height;
  const int64_t tok0 = static_cast<int64_t>(qy0) * width + qx;

  // q * scale, rounded to bfloat16, as A fragments (while the chunk lands)
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

  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;  // maxima in base-2 units
  float acc[ND][4];
#pragma unroll
  for (int dc = 0; dc < ND; ++dc)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dc][i] = 0.f;

  for (int c = 0; c < walk.count; ++c) {
    if (c + 1 < walk.count) {  // the next chunk's copies fly under this one's products
      BF* nk = base + 2 * ((c + 1) % 2) * size;
      if (F3S_PARTS != 1)
        stage_chunk<BF, Dp>(nk, nk + size, LD, kb, vb, sk.n, sv.n, walk[c + 1], width, D,
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
          mma_bf16(s[j], qa[2 * kc2], kb4[0], kb4[1]);
          mma_bf16(s[j], qa[2 * kc2 + 1], kb4[2], kb4[3]);
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
        // p = high + low, both bfloat16: the second product keeps float32-grade p
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float a = s[jp + j][2 * i], cc = s[jp + j][2 * i + 1];
            const float ah = round_to<BF>(a), ch_ = round_to<BF>(cc);
            ph[2 * j + i] = pack_bf16(ah, ch_);
            pl[2 * j + i] = pack_bf16(a - ah, cc - ch_);
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
    BF* os = base;  // [64 queries][LD]
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

// ---- any D past 128: D in chunks of kWideCols, the output in column blocks
//
// The grid's z axis cuts the output into column blocks of kWideCols, each
// block taking the scores over the whole D again. The clamped halo goes in
// chunks (`wide_plan`) of at most kWideSlots slots of 8 columns for each
// warp's pair of query rows (64 positions); for each chunk the scores add
// up over D in chunks of kWideCols columns of K staged in one buffer, then
// the chunk's V columns (the block's) go through the same buffer and the
// online softmax takes the chunk's keys.
constexpr int kWideCols = 128;
constexpr int kWideDPL = kWideCols / kLanes;
constexpr int kWideSlots = 8;
constexpr int kWideLd = kWideCols + 8;  // a staged bfloat16 row: 4 mod 8 words, as LD above

// float32 on the CUDA cores: four lanes a query, as in the float32 kernel,
// each lane a quarter of q's chunk in registers, the partial sums in the
// block's score rows. Each warp is one tile row and scores only the chunk's
// rows its window holds, every column of them, masking the keys outside each
// query's window; the softmax takes the chunk's maximum first, then each
// key's exponential once.
__global__ void __launch_bounds__(kF32Threads)
nat_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int height, int width,
                    int window, int H, int D, int tiles_x, Strides sq, Strides sk, Strides sv,
                    Strides so, float scale, int band_rows, int band_cols, int bh0) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = window / 2;
  const int npos = band_rows * band_cols;  // at most 64
  float* buf = reinterpret_cast<float*>(smem);  // [npos][kWideCols]
  float* sc = buf + npos * kWideCols;           // [64 queries][npos + 1]

  const int tid = threadIdx.x;
  const int b = (bh0 + blockIdx.y) / H;
  const int h = (bh0 + blockIdx.y) % H;
  const int c0 = blockIdx.z * kWideCols;  // this block's output columns
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const Walk walk(ty0, tx0, r, height, width, band_rows, band_cols);
  // columns d0 .. d0 + kWideCols - 1 of the chunk's positions, as float32
  auto stage = [&](const float* src, int64_t stride, const Chunk& ch, int d0) {
    const int cols = ch.x1 - ch.x0;
#pragma unroll 4
    for (int idx = tid; idx < (ch.y1 - ch.y0) * cols * kWideCols; idx += kF32Threads) {
      const int pos = idx / kWideCols, d = idx % kWideCols;
      const int64_t tok = static_cast<int64_t>(ch.y0 + pos / cols) * width + ch.x0 + pos % cols;
      buf[idx] = d0 + d < D ? src[tok * stride + d0 + d] : 0.f;
    }
  };

  const int lane = tid % kLanes;
  const int qi = tid / kLanes;
  const int qy = ty0 + qi / kTile, qx = tx0 + qi % kTile;  // a warp holds one tile row
  const bool live = qy < height && qx < width;
  const int64_t tok = live ? static_cast<int64_t>(qy) * width + qx : 0;
  const float* qp = q + b * sq.b + tok * sq.n + h * sq.h;
  float* srow = sc + qi * (npos + 1);

  float m = -CUDART_INF_F, l = 0.f;
  float acc[kWideDPL];
#pragma unroll
  for (int i = 0; i < kWideDPL; ++i) acc[i] = 0.f;
  for (int c = 0; c < walk.count; ++c) {
    const Chunk ch = walk[c];
    const int cols = ch.x1 - ch.x0;
    const int y0 = max(ch.y0, qy - r), y1 = min(ch.y1, qy + r + 1);  // the same over the warp
    for (int d0 = 0; d0 < D; d0 += kWideCols) {
      __syncthreads();  // buf is free
      stage(kb, sk.n, ch, d0);
      __syncthreads();
      float qr[kWideDPL];
#pragma unroll
      for (int i = 0; i < kWideDPL; ++i) {
        const int d = d0 + lane * kWideDPL + i;
        qr[i] = (live && d < D) ? qp[d] * scale : 0.f;
      }
      for (int pos = (y0 - ch.y0) * cols; pos < (y1 - ch.y0) * cols; ++pos) {
        float kr[kWideDPL];
        load_chunk<float, kWideDPL>(buf + pos * kWideCols + lane * kWideDPL, kr);
        const float s = dot_quad<kWideDPL>(qr, kr);
        if ((pos % kLanes) == lane) srow[pos] = d0 == 0 ? s : srow[pos] + s;
      }
    }
    __syncthreads();  // buf is free; the scores are written
    stage(vb, sv.n, ch, c0);
    __syncthreads();
    const int p0 = (y0 - ch.y0) * cols, p1 = (y1 - ch.y0) * cols;
    auto in_window = [&](int pos) { return abs(ch.x0 + pos % cols - qx) <= r; };
    float m_new = m;
    for (int pos = p0; pos < p1; ++pos)
      if (in_window(pos)) m_new = fmaxf(m_new, srow[pos]);
    if (m_new != -CUDART_INF_F) {  // else no key of the chunk is in the window
      // exp(-inf - m) = 0: nothing accumulated yet
      const float cf = expf(m - m_new);
      l *= cf;
#pragma unroll
      for (int i = 0; i < kWideDPL; ++i) acc[i] *= cf;
      m = m_new;
      for (int pos = p0; pos < p1; ++pos) {
        if (!in_window(pos)) continue;
        const float p = expf(srow[pos] - m);
        l += p;
        float vr[kWideDPL];
        load_chunk<float, kWideDPL>(buf + pos * kWideCols + lane * kWideDPL, vr);
#pragma unroll
        for (int i = 0; i < kWideDPL; ++i) acc[i] = fmaf(p, vr[i], acc[i]);
      }
    }
  }

  if (live) {
    const float den = fmaxf(l, 1e-30f);
    float* op = o + b * so.b + tok * so.n + h * so.h;
#pragma unroll
    for (int i = 0; i < kWideDPL; ++i) {
      const int d = c0 + lane * kWideDPL + i;
      if (d < D) op[d] = acc[i] / den;
    }
  }
}

// bfloat16 on the tensor cores: as nat_mma_kernel, a warp owns 16 queries
// (two tile rows) and multiplies them against every key of the chunk on the
// rows they see, in slots of 8 columns, at most kWideSlots of them a warp, so
// the slots' scores stay in registers while they add up over D: for each
// chunk of kWideCols columns, K's columns staged (16-byte cp.async where D,
// the strides and the bases allow, else an element at a time) and q's as A
// fragments straight from device memory (q * scale rounded to bfloat16, as
// above). Then the block's columns of V through the same buffer, the online
// softmax over the chunk's slots in one step and P V, p as a bfloat16 high
// part and remainder, as in nat_mma_kernel.
__global__ void __launch_bounds__(kMmaThreads)
nat_mma_wide_kernel(const BF* __restrict__ q, const BF* __restrict__ k,
                    const BF* __restrict__ v, BF* __restrict__ o, int height, int width,
                    int window, int H, int D, int tiles_x, Strides sq, Strides sk, Strides sv,
                    Strides so, float scale, int band_rows, int band_cols, int bh0, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  BF* buf = reinterpret_cast<BF*>(smem);  // [band_rows * band_cols][kWideLd]
  const int r = window / 2;
  const int tid = threadIdx.x;
  const int b = (bh0 + blockIdx.y) / H;
  const int h = (bh0 + blockIdx.y) % H;
  const int c0 = blockIdx.z * kWideCols;  // this block's output columns
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const BF* kb = k + b * sk.b + h * sk.h;
  const BF* vb = v + b * sv.b + h * sv.h;
  const Walk walk(ty0, tx0, r, height, width, band_rows, band_cols);
  // columns d0 .. d0 + kWideCols - 1 of the chunk's positions into buf
  auto stage = [&](const BF* src, int64_t stride, const Chunk& ch, int d0) {
    const int cols = ch.x1 - ch.x0, npos = (ch.y1 - ch.y0) * cols;
    if (vec) {
      for (int it = tid; it < npos * (kWideCols / 8); it += kMmaThreads) {
        const int pos = it / (kWideCols / 8), d = it % (kWideCols / 8) * 8;
        const int64_t tok = static_cast<int64_t>(ch.y0 + pos / cols) * width + ch.x0 + pos % cols;
        const bool in = d0 + d < D;
        cp_async16(buf + pos * kWideLd + d, in ? src + tok * stride + d0 + d : src, in ? 16 : 0);
      }
    } else {
      const BF zero = __float2bfloat16_rn(0.f);
#pragma unroll 4
      for (int idx = tid; idx < npos * kWideCols; idx += kMmaThreads) {
        const int pos = idx / kWideCols, d = idx % kWideCols;
        const int64_t tok = static_cast<int64_t>(ch.y0 + pos / cols) * width + ch.x0 + pos % cols;
        buf[pos * kWideLd + d] = d0 + d < D ? src[tok * stride + d0 + d] : zero;
      }
    }
    cp_async_commit();
    cp_async_wait_all();
  };

  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wy = (tid / 32) * 2;  // this warp's two rows of the tile
  const int qx = tx0 + g, qy0 = ty0 + wy;
  const bool live0 = qx < width && qy0 < height, live1 = qx < width && qy0 + 1 < height;
  const int64_t tok0 = static_cast<int64_t>(qy0) * width + qx;
  const BF* q0 = q + b * sq.b + h * sq.h + tok0 * sq.n;
  const BF* q1 = q0 + width * sq.n;
  auto ld2 = [&](const BF* row, bool live, int d) -> uint32_t {
    const float x = live && d < D ? to_f32<BF>(row[d]) : 0.f;
    const float y = live && d + 1 < D ? to_f32<BF>(row[d + 1]) : 0.f;
    return pack_bf16(x * scale, y * scale);
  };

  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;  // maxima in base-2 units
  float acc[kWideCols / 8][4];
#pragma unroll
  for (int dc = 0; dc < kWideCols / 8; ++dc)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dc][i] = 0.f;
  const uint32_t buf_s = smem_addr(buf);
  for (int c = 0; c < walk.count; ++c) {
    // this warp's keys in the chunk: rows [y0, y1) that a query of rows
    // qy0, qy0 + 1 sees, every row in nsx slots of 8 columns from ch.x0
    const Chunk ch = walk[c];
    const int cols = ch.x1 - ch.x0;
    const int y0 = max(ch.y0, qy0 - r), y1 = min(ch.y1, qy0 + 2 + r);
    const int nsx = (cols + 7) / 8;
    const int nslots = y1 <= y0 ? 0 : (y1 - y0) * nsx;  // at most kWideSlots
    int pos[kWideSlots];  // this lane's ldmatrix row: key lane % 8 of slot j
#pragma unroll
    for (int j = 0; j < kWideSlots; ++j) {
      const int cx = min(8 * (j % nsx) + lane % 8, cols - 1);  // past the chunk: its edge
      pos[j] = j < nslots ? (y0 + j / nsx - ch.y0) * cols + cx : 0;
    }
    float s[kWideSlots][4];
#pragma unroll
    for (int j = 0; j < kWideSlots; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kWideCols) {
      __syncthreads();  // buf is free
      stage(kb, sk.n, ch, d0);
      __syncthreads();
      uint32_t qa[kWideCols / 16][4];
#pragma unroll
      for (int kc = 0; kc < kWideCols / 16; ++kc) {
        const int d = d0 + kc * 16 + 2 * t;
        qa[kc][0] = ld2(q0, live0, d);
        qa[kc][1] = ld2(q1, live1, d);
        qa[kc][2] = ld2(q0, live0, d + 8);
        qa[kc][3] = ld2(q1, live1, d + 8);
      }
#pragma unroll
      for (int j = 0; j < kWideSlots; ++j) {
        if (j >= nslots) break;
        const uint32_t ka = buf_s + (pos[j] * kWideLd + (lane / 8) * 8) * 2;
#pragma unroll
        for (int kc2 = 0; kc2 < kWideCols / 32; ++kc2) {
          uint32_t kb4[4];
          ldmatrix_x4(kb4, ka + kc2 * 64);
          mma_bf16(s[j], qa[2 * kc2], kb4[0], kb4[1]);
          mma_bf16(s[j], qa[2 * kc2 + 1], kb4[2], kb4[3]);
        }
      }
    }
    __syncthreads();  // buf is free
    stage(vb, sv.n, ch, c0);
    __syncthreads();

    // to base 2, -inf where the key is not in the query's window
    float n0 = m0, n1 = m1;
#pragma unroll
    for (int j = 0; j < kWideSlots; ++j) {
      const int y = y0 + j / nsx;
      const bool y0ok = j < nslots && y <= qy0 + r, y1ok = j < nslots && y >= qy0 + 1 - r;
      const int x = ch.x0 + 8 * (j % nsx) + 2 * t;
      const bool x0ok = x < ch.x1 && abs(x - qx) <= r;
      const bool x1ok = x + 1 < ch.x1 && abs(x + 1 - qx) <= r;
      s[j][0] = y0ok && x0ok ? s[j][0] * kLog2e : -CUDART_INF_F;
      s[j][1] = y0ok && x1ok ? s[j][1] * kLog2e : -CUDART_INF_F;
      s[j][2] = y1ok && x0ok ? s[j][2] * kLog2e : -CUDART_INF_F;
      s[j][3] = y1ok && x1ok ? s[j][3] * kLog2e : -CUDART_INF_F;
      n0 = fmaxf(n0, fmaxf(s[j][0], s[j][1]));
      n1 = fmaxf(n1, fmaxf(s[j][2], s[j][3]));
    }
    // online softmax: the four lanes of a row agree on its maximum; m stays
    // finite, so 2^(-inf - m) is 0 and nothing needs a guard
    n0 = fmaxf(n0, __shfl_xor_sync(0xffffffffu, n0, 1));
    n1 = fmaxf(n1, __shfl_xor_sync(0xffffffffu, n1, 1));
    n0 = fmaxf(n0, __shfl_xor_sync(0xffffffffu, n0, 2));
    n1 = fmaxf(n1, __shfl_xor_sync(0xffffffffu, n1, 2));
    const float cr0 = ex2(m0 - n0), cr1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
    l0 *= cr0;
    l1 *= cr1;
#pragma unroll
    for (int j = 0; j < kWideSlots; ++j) {
      s[j][0] = ex2(s[j][0] - n0);
      s[j][1] = ex2(s[j][1] - n0);
      s[j][2] = ex2(s[j][2] - n1);
      s[j][3] = ex2(s[j][3] - n1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int dc = 0; dc < kWideCols / 8; ++dc) {
      acc[dc][0] *= cr0;
      acc[dc][1] *= cr0;
      acc[dc][2] *= cr1;
      acc[dc][3] *= cr1;
    }
#pragma unroll
    for (int jp = 0; jp < kWideSlots; jp += 2) {  // 16 keys a product
      if (jp >= nslots) break;
      uint32_t ph[4], pl[4];  // p = high + low, both bfloat16
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float a = s[jp + j][2 * i], cc = s[jp + j][2 * i + 1];
          const float ah = round_to<BF>(a), ch_ = round_to<BF>(cc);
          ph[2 * j + i] = pack_bf16(ah, ch_);
          pl[2 * j + i] = pack_bf16(a - ah, cc - ch_);
        }
      const uint32_t va =
          buf_s + (((lane / 8) & 1 ? pos[jp + 1] : pos[jp]) * kWideLd + (lane / 16) * 8) * 2;
#pragma unroll
      for (int dc2 = 0; dc2 < kWideCols / 16; ++dc2) {
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

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float r0 = 1.f / fmaxf(l0, 1e-30f), r1 = 1.f / fmaxf(l1, 1e-30f);
  BF* o0 = o + b * so.b + h * so.h + tok0 * so.n;
  BF* o1 = o0 + width * so.n;
#pragma unroll
  for (int dc = 0; dc < kWideCols / 8; ++dc) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = c0 + dc * 8 + 2 * t + e;
      if (d >= D) continue;
      if (live0) o0[d] = __float2bfloat16_rn(acc[dc][e] * r0);
      if (live1) o1[d] = __float2bfloat16_rn(acc[dc][2 + e] * r1);
    }
  }
}

// The wide kernels' chunks: rows of the clamped halo cut into pieces of at
// most 64 columns (a multiple of 8, or the whole clamped width), as many rows
// a chunk as keep a warp at kWideSlots slots of 8 columns or fewer; one
// buffer of kWideCols columns a position (float32 beside the score rows, or
// bfloat16 rows of kWideLd).
Plan wide_plan(int window, int width, bool bf16) {
  const int halo = kTile + 2 * (window / 2);
  const int wide = halo < width ? halo : width;
  const int cols = wide < 64 ? wide : 64;
  const int by_slots = kWideSlots / ((cols + 7) / 8);
  const int rows = by_slots < halo ? by_slots : halo;
  const int64_t npos = static_cast<int64_t>(rows) * cols;
  return {rows, cols, 1,
          bf16 ? npos * kWideLd * 2
               : (npos * kWideCols + kTile * kTile * (npos + 1)) * static_cast<int64_t>(4)};
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

// `col_blocks`: the grid's z axis (the wide kernel's column blocks of D)
template <typename Kernel, typename T, typename... Flags>
int launch(Kernel kern, int threads, const Plan& plan, int col_blocks, const T* q, const T* k,
           const T* v, T* o, const Geometry& gm, const int64_t* st, float scale,
           cudaStream_t stream, Flags... flags) {
  const int smem = static_cast<int>(plan.smem);  // at most kBudget or 64 rows of the output
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_x = (gm.width + kTile - 1) / kTile;
  const int tiles_y = (gm.height + kTile - 1) / kTile;
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

template <int NK2>
int launch_mma(const void* q, const void* k, const void* v, void* o, const Geometry& gm,
               const int64_t* st, float scale, cudaStream_t stream) {
  // 4-byte loads of q and stores of o need even D, strides and addresses
  bool pairs = gm.D % 2 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
               reinterpret_cast<uintptr_t>(o) % 4 == 0;
  for (int i = 0; i < 3; ++i) pairs = pairs && st[i] % 2 == 0 && st[9 + i] % 2 == 0;
  // 16-byte stores of o: D and o's strides whole groups of 8, its base aligned
  bool vec_out = gm.D % 8 == 0 && reinterpret_cast<uintptr_t>(o) % 16 == 0;
  for (int i = 9; i < 12; ++i) vec_out = vec_out && st[i] % 8 == 0;
  return launch(nat_mma_kernel<NK2>, kMmaThreads, mma_plan<NK2>(gm.window, gm.width), 1,
                static_cast<const BF*>(q), static_cast<const BF*>(k),
                static_cast<const BF*>(v), static_cast<BF*>(o), gm, st, scale, stream,
                can_vectorise(k, v, st, gm.D, sizeof(BF)), pairs, vec_out);
}

template <int DPL>
int launch_f32(const void* q, const void* k, const void* v, void* o, const Geometry& gm,
               const int64_t* st, float scale, cudaStream_t stream) {
  return launch(nat_f32_kernel<DPL>, kF32Threads, f32_plan<DPL>(gm.window, gm.width), 1,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(o), gm, st, scale, stream,
                can_vectorise(k, v, st, gm.D, sizeof(float)));
}

int launch_wide(int dtype, const void* q, const void* k, const void* v, void* o,
                const Geometry& gm, const int64_t* st, float scale, cudaStream_t stream) {
  const int blocks = (gm.D + kWideCols - 1) / kWideCols;
  const Plan plan = wide_plan(gm.window, gm.width, dtype == 1);
  if (dtype == 0)
    return launch(nat_f32_wide_kernel, kF32Threads, plan, blocks, static_cast<const float*>(q),
                  static_cast<const float*>(k), static_cast<const float*>(v),
                  static_cast<float*>(o), gm, st, scale, stream);
  return launch(nat_mma_wide_kernel, kMmaThreads, plan, blocks, static_cast<const BF*>(q),
                static_cast<const BF*>(k), static_cast<const BF*>(v), static_cast<BF*>(o), gm,
                st, scale, stream, can_vectorise(k, v, st, gm.D, sizeof(BF)));
}

}  // namespace

// Launches on `stream`. q, k, v, o: [B, height * width, H, D]; `strides`
// holds the (batch, token, head) strides in elements of q, k, v, o in that
// order (12 values); the last axis of each is contiguous. dtype: 0 float32,
// 1 bfloat16. `window` is odd, of any size; any D, any B * H. `scale` is
// 1/sqrt(D) already rounded to the dtype. Returns 0 on success,
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
  if (D > kWideCols && (dtype == 0 || dtype == 1))
    return launch_wide(dtype, q, k, v, o, gm, strides, scale, s);
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

// The plan a launch of `f3s_neighborhood_attention` takes, for checking
// ops/attention.py `_nat_plan`: plan = [rows, cols, stages, shared bytes].
// Returns 0, or -3 as the launcher would.
extern "C" int f3s_nat_plan(int dtype, int window, int D, int width, int64_t* plan) {
  Plan p;
  if (D > kWideCols && (dtype == 0 || dtype == 1)) {
    p = wide_plan(window, width, dtype == 1);
  } else if (dtype == 0) {
    p = D <= 8 ? f32_plan<2>(window, width) : D <= 16 ? f32_plan<4>(window, width)
        : D <= 32 ? f32_plan<8>(window, width) : D <= 64 ? f32_plan<16>(window, width)
        : f32_plan<32>(window, width);
  } else if (dtype == 1) {
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
