// Spatial-reduction attention: a long query axis against a short, reduced
// key/value axis, scores and softmax never leaving the SM.
//
// Replaces the TPU kernel fusion3dseg_tpu/ops/attention.py `_attn_kernel`
// (Pallas, reached through `sr_attention`). For q [B, N, H, D] and
// k, v [B, M, H, D] of type T (float32, bfloat16 or float16), per (b, n, h):
//   qs  = T(float(q) * scale)            scale = T(1 / sqrt(D)), given
//   s_m = sum_d qs_d * k_md              float32 accumulation
//   p_m = T(exp(s_m - max_m s) / sum_m exp(s_m - max_m s))   softmax in f32
//   o_d = T(sum_m p_m * v_md)            float32 accumulation
// The roundings to T are the TPU kernel's: q scaled in its own type, the
// probabilities normalised over the full row and cast to v's type before
// the second product, the output in q's type. Any N, any M, any D, any
// B * H (launches take (batch, head) in runs of 65,535 where a grid axis
// holds them).
//
// Bound on an H100 (SXM; 3.35 TB/s, 989 Tflop/s in bfloat16, exponentials
// 16 a clock on each of 132 SMs, 1.98 GHz), bfloat16, D = 64:
//   [8,16384,1,64] x 256 keys (SegFormer-B2 stage 0 at 512x512): bytes
//     34.1 MB, 10.2 us; products 4*N*M*D = 8.6 Gop, 8.7 us; 33.6 M
//     exponentials, 8.0 us. All three about equal.
//   [8,65536,1,64] x 1024 keys (stage 0 at 1024x1024): bytes 136 MB,
//     40.7 us; products 137 Gop, 139 us; 537 M exponentials, 128 us. The
//     tensor cores and the exponential unit bound it together.
// So the bfloat16 kernel overlaps each warpgroup's exponentials with its
// own products and keeps the bytes to q in and o out. Measured
// (tools/kernel_parts.py): the K, V streams hide behind the arithmetic
// (loads left out: within 7% of the whole at 256 and 1024 keys), and no
// one unit within it bounds it (the exponentials, S or P V left out: 11-15%
// each at 1024 keys): the consumer warps' dependent chains do, at 41-48%
// of the bound at 1024 keys, 33-37% at 256; at 64 keys the fixed cost of
// launch, first loads and last stores.
//
// Three kernels; the caller (ops/attention._sr_route) names which. The two
// tensor-core kernels take bfloat16 and float16 alike: each is a template
// on its element type E, with an instance for each (the same shapes,
// registers and shared-memory plans; the products' and the TMA maps' type
// and the roundings to E differ). In float16 a p below 2^-14 rounds to a
// subnormal (kept, not flushed), as the plain version's p does; scores, the
// softmax and the accumulators are float32 in both, so float16's range
// (65504) binds only q * scale, K, V and the output, as in the TPU kernel.
//
// * bfloat16 and float16, `sr_attention_wgmma_kernel` (any M, D <= 320,
//   tensors TMA can describe; D padded to DP = 64, 128, 192, 256 or 320):
//   persistent blocks, at most one per SM, walk the 64-row query tiles in
//   (batch, head)-major order, each block a contiguous run of them
//   (the number of blocks chosen so that the busiest one has the fewest
//   item rounds). A run goes in items: up to C consecutive tiles of one
//   (batch, head), one for each of C consumer warpgroups (C = 3 at D <= 64,
//   2 above). One producer thread keeps TMA loads in flight: the item's q
//   tiles on a ring of two stages (one past D = 128, where O leaves through
//   the q tiles), and K, V in tiles of KT keys (128 at D <= 64 and M > 64,
//   32 past D = 256, else 64) on a ring of as many stages as shared memory
//   holds (4 at D <= 64 and KT = 128, 3 at D <= 128, 3 at DP = 192, 2 at
//   DP = 256, 3 at DP = 320). When all
//   of a (batch, head)'s key tiles fit the ring they stay resident across
//   its items (the producer passes each stage on without a load); else they
//   stream again for every item, out of L2. Every consumer takes every key
//   tile of its item: S = Q K^T by wgmma into registers (KT / 2 floats a
//   thread), a running row max and sum across the quad, each exponential
//   taken once, the accumulator O rescaled in registers by
//   exp(m_old - m_new). Within a warpgroup the next tile's S = Q K^T and
//   the previous tile's O += P V are issued together, and the softmax of
//   the new scores runs while P V is still on the tensor cores
//   (FlashAttention-3's intra-warpgroup overlap); across warpgroups the
//   consumers take turns at issuing products (its ping-pong), so that one
//   warpgroup's exponentials run while the next one's products hold the
//   tensor cores (10% at 1024 keys); p is packed into the
//   A-operand registers only once that P V is done (packing it earlier, or
//   a register touched between the products' issue and their wait, makes
//   ptxas serialize every wgmma). Where p is rounded: the one-pass softmax
//   rounds exp(s - m_running) to E (the register A operand of
//   O += P V, V as stored, [keys][D], MN-major) and divides O by the row
//   sum at the end, where the TPU kernel rounds the normalised p; the two
//   differ by rounding steps of p in E, held to the same bar against the
//   plain version. A JAX-order second pass would take every exponential and
//   Q K^T twice, and at 1024 keys the exponentials alone are about the
//   bound. O goes through shared memory to a TMA store that overlaps the
//   next item. Loads past N, M or D are zero-filled and stores past N or D
//   clipped, so any N works; keys past M score 0 there and are masked to
//   -inf. The scale: at D = 16 or 64, 1/sqrt(D) is a power of two, so
//   T(q * scale) . k = scale * (q . k) bit for bit (barring subnormals,
//   below 2^-14 in float16, where the kernel's product is the nearer) and
//   the scale goes onto the float32 scores, q straight from TMA to wgmma;
//   at other D the consumer rounds q * scale to E in shared memory
//   first, as the TPU kernel does. Past D = 320, where a consumer's
//   registers no longer hold O beside its scores, `sr_attention_wide_kernel`
//   (one warpgroup, S summed over D in chunks of 64, the output in column
//   blocks of 256; see its note) takes the wgmma route.
// * bfloat16 and float16, `sr_attention_mma_kernel` (layouts TMA cannot
//   describe, M up to what shared memory holds: 848 keys at D = 64, 432 at
//   D = 128; the caller copies larger ones into a TMA layout for the wgmma
//   kernel; D <= 128, the route's domain):
//   mma.sync m16n8k16, eight warps of 16 query rows a block, K and V of one
//   (batch, head) staged per block, two passes over the keys (max and sum,
//   then the normalised product).
// * float32, `sr_attention_f32_tile_kernel<DJ>` (every D): FMAs on the
//   CUDA cores (TF32 tensor-core products would not hold the 1e-4
//   agreement asked of float32), one pass over the keys in tiles of 32 with
//   a running softmax, each score taken once, SIMT-GEMM register tiles; see
//   its note. It replaced the two-pass kernels of PR 2 (four lanes a query;
//   past D = 128 column blocks of 128, each taking every score again),
//   which it beats 3.6-10.6x at D <= 128 and 37x at D = 320 (PERF.md).
//
// The tensor-core kernels and the float32 tile kernel read F3S_PARTS: 1 leaves
// the loads out, 2 the arithmetic (tools/kernel_parts.py times both; the
// results are wrong).

#include <algorithm>
#include <cmath>
#include <cstring>
#include <initializer_list>

#include "attention_common.cuh"
#include "hopper.cuh"

#ifndef F3S_PARTS
#define F3S_PARTS 0
#endif

namespace {

using namespace f3s;

using T = float;

// ---- float32, one pass: register-tiled FMAs on the CUDA cores
//
// `sr_attention_f32_tile_kernel<DJ>` takes every D: DP = 64 DJ columns, D
// padded up to DP (64 to 320); past D = 320, DP = 320, the output in column
// blocks of 320 (the grid's z axis) and the scores over D in chunks of 320,
// each block taking them again (registers hold O for 320 columns beside a
// tile's scores, not for more). A block owns 64 queries of one (batch,
// head) and all of its D (its column block past 320). q * scale (rounded to
// T, as the TPU kernel rounds it) is staged once. K and V stream through a
// cp.async ring of units, a unit one tile of 32 keys of K (a column chunk)
// or of V (the block's columns), 2-4 units in flight (`F32Tile`), one
// barrier a unit. The softmax is online: a running max and sum per query
// row, O rescaled in registers by exp(m_old - m_new) at each V unit and
// divided by the row sum at the end. The TPU kernel rounds the normalised p
// to v's dtype; in float32 that rounding is the identity, so the two differ
// by float32 rounding only, each score taken once.
//
// What bounds it at [8,1024,1,320]x256 (the re-headed B2's stage 2 at
// 512x512): the FMAs, 2 * 1024 * 256 * 320 a (batch, head), 0.040 ms at
// 67 Tflop/s; bytes are 0.007 ms. So it is written as a SIMT GEMM: a
// thread holds an 8 x 8 register tile, 16 FMAs for every 16-byte shared
// load, and the loads of a warp's quarter fall on 128 contiguous bytes.
// * S = Q K^T: warp w owns queries 8w .. 8w + 7 against all 32 keys of the
//   unit; lane = 8 kt + ds holds an 8 x 8 tile (those queries, keys 8 kt ..
//   8 kt + 7) summed over columns 4 ds + 32 t of the chunk: per 4 columns
//   8 + 8 loads and 256 FMAs. The eight column slices sum by shuffles in
//   three halving steps (56 a tile), after which lane ds holds query 8w +
//   ds against its 8 keys; the row max takes two more shuffles (over kt).
//   p goes to shared memory transposed, [key][query].
// * O += P V: warp w keeps its 8 queries; lane c holds them x 2 DJ columns
//   (4c + 128 i, and 2c + 128 (DJ / 2) when DJ is odd): per key 2 loads of
//   p and DJ / 2 + 1 of V for 16 DJ FMAs.
// O is 16 DJ registers a thread. At DP = 320, q 82 KB and three units of
// 41 KB fill the SM: one block of eight warps. There the copies are in
// before a unit starts; what sets the pace is the products themselves, at
// about half the FMA peak (with the loads left out the kernel keeps 85% of
// its time, tools/kernel_parts.py), then the copies' issue between the
// barrier and the products. Tried and not faster: 4 x 4 tiles, a
// warp-specialised split (scores on one warpgroup at 8 x 16 tiles, P V on
// two), a producer warpgroup with mbarriers in place of block barriers, a
// bulk copy a row, TMA boxes, the copies issued in two halves around the
// products.
constexpr int kTileThreads = 256;     // eight warps
constexpr int kTileQ = 64;            // queries a block
constexpr int kTileKeys = 32;         // keys a unit of K or V
constexpr int kTileMaxDJ = 5;         // DP up to 320
constexpr int kTilePLd = kTileQ + 4;  // a row of p^T, [key][query]
constexpr int kTileMaxStages = 4;

// The shape of instance DJ: DP = 64 DJ columns, staged rows of DP + 8
// floats, and as many units in the ring as fit an SM's shared memory (at
// most 4) beside q, p^T and the row statistics. ops/attention.py
// `_sr_f32_shape` mirrors it.
template <int DJ>
struct F32Tile {
  static constexpr int kDP = 64 * DJ;
  static constexpr int kLd = kDP + 8;
  static constexpr int kQFloats = kTileQ * kLd;
  static constexpr int kUnitFloats = kTileKeys * kLd;
  static constexpr int kFixedBytes = (kQFloats + kTileKeys * kTilePLd + 2 * kTileQ) * 4;
  static constexpr int kFit = (kMaxSmem - kFixedBytes) / (kUnitFloats * 4);
  static constexpr int kStages = kFit < kTileMaxStages ? kFit : kTileMaxStages;
  static constexpr int kSmem = kFixedBytes + kStages * kUnitFloats * 4;
  static_assert(kStages >= 2, "two units in flight at least");
};

// keep[i] = own[i + h n] + the partner's own[i + (1 - h) n] (lane ^ mask),
// i < n: one halving step of the sum over the column slices (h: this lane's
// half, the bit `mask` of its lane index)
template <int N2, int J>
__device__ __forceinline__ void halve(const float (&own)[2 * N2][J], float (&keep)[N2][J],
                                      bool h, int mask) {
#pragma unroll
  for (int i = 0; i < N2; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float send = h ? own[i][j] : own[i + N2][j];
      keep[i][j] = (h ? own[i + N2][j] : own[i][j]) + __shfl_xor_sync(0xffffffffu, send, mask);
    }
}

// O / l of query rows n0 .. n0 + 7 (those below N) from column c0 on: acc[i]
// holds lane c's 2 DJ columns, float4 chunks at 128 j + 4 c and, where DJ
// is odd, a float2 chunk at 128 (DJ / 2) + 2 c; columns past D are not
// stored. ob: the output of the (batch, head), son its token stride.
template <int DJ>
__device__ __forceinline__ void store_o(const float (&acc)[8][2 * DJ], const float (&ls)[8],
                                        T* ob, int64_t son, int n0, int N, int c0, int D,
                                        int lane, bool vec_out) {
  constexpr int C4 = DJ / 2, C2 = DJ % 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (n0 + i >= N) continue;
    T* op = ob + static_cast<int64_t>(n0 + i) * son + c0;
#pragma unroll
    for (int c4 = 0; c4 < C4; ++c4) {
      const int d = 128 * c4 + 4 * lane;
      if (c0 + d >= D) continue;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = acc[i][4 * c4 + e] / ls[i];
      if (vec_out) {
        *reinterpret_cast<float4*>(op + d) = make_float4(x[0], x[1], x[2], x[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + d + e < D) op[d + e] = from_f32<T>(x[e]);
      }
    }
    if (C2) {
      const int d = 128 * C4 + 2 * lane;
      if (c0 + d >= D) continue;
      const float x0 = acc[i][4 * C4] / ls[i], x1 = acc[i][4 * C4 + 1] / ls[i];
      if (vec_out) {
        *reinterpret_cast<float2*>(op + d) = make_float2(x0, x1);
      } else {
        op[d] = from_f32<T>(x0);
        if (c0 + d + 1 < D) op[d + 1] = from_f32<T>(x1);
      }
    }
  }
}

template <int DJ>
__global__ void __launch_bounds__(kTileThreads, 1)
sr_attention_f32_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o, int N, int M, int H,
                             int D, Strides sq, Strides sk, Strides sv, Strides so,
                             float scale, int bh0, bool vec, bool vec_out) {
  using S = F32Tile<DJ>;
  constexpr int DP = S::kDP, LD = S::kLd, STAGES = S::kStages;
  constexpr int C4 = DJ / 2, C2 = DJ % 2;  // O's float4 and float2 column chunks
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);        // [kTileQ][LD]: T(q * scale)
  float* ring = qs + S::kQFloats;                     // STAGES x [kTileKeys][LD]
  float* pt = ring + STAGES * S::kUnitFloats;         // [kTileKeys][kTilePLd]: p^T
  float* alpha_s = pt + kTileKeys * kTilePLd;         // [kTileQ]: O's rescale at this tile
  float* l_s = alpha_s + kTileQ;                      // [kTileQ]: the row sums

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = (bh0 + blockIdx.y) / H;
  const int h = (bh0 + blockIdx.y) % H;
  const int n0 = blockIdx.x * kTileQ;
  const int c0 = blockIdx.z * DP;        // the block's output columns
  const int nc = (D + DP - 1) / DP;      // column chunks of the scores: 1 up to D = 320
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const int units = (M + kTileKeys - 1) / kTileKeys * (nc + 1);

  // unit u: key tile u / (nc + 1); of K the column chunk u % (nc + 1), of V
  // the block's columns where that is nc. Rows past M and columns past D
  // are zeros. One cp.async group a unit (empty past the last).
  auto issue = [&](int u) {
    if (u >= units || F3S_PARTS == 1) return;
    const int key0 = u / (nc + 1) * kTileKeys, r = u % (nc + 1);
    const T* src = r < nc ? kb : vb;
    const int64_t stride = r < nc ? sk.n : sv.n;
    const int col0 = r < nc ? r * DP : c0;
    float* dst = ring + (u % STAGES) * S::kUnitFloats;
    if (vec) {  // a warp takes rows warp, warp + 8, ..., its lanes a row's 16-byte pieces
      for (int row = warp; row < kTileKeys; row += kTileThreads / 32) {
        const T* s = src + (key0 + row) * stride + col0;
        const bool live = key0 + row < M;
#pragma unroll
        for (int c = 4 * lane; c < DP; c += 128) {
          const bool in = live && col0 + c < D;
          cp_async16(dst + row * LD + c, in ? s + c : src, in ? 16 : 0);
        }
      }
    } else {
      for (int i = tid; i < kTileKeys * DP; i += kTileThreads) {
        const int row = i / DP, c = i % DP;
        dst[row * LD + c] =
            key0 + row < M && col0 + c < D ? src[(key0 + row) * stride + col0 + c] : 0.f;
      }
    }
  };
  // q's column chunk c, scaled and rounded, rows past N and columns past D zeros
  auto stage_q = [&](int c) {
    if (F3S_PARTS == 1) return;
    const int col0 = c * DP;
    for (int i = tid; i < kTileQ * (DP / 4); i += kTileThreads) {
      const int row = i / (DP / 4), cc = i % (DP / 4) * 4;
      const T* src = qb + static_cast<int64_t>(n0 + row) * sq.n + col0 + cc;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (n0 + row < N) {
        if (vec && col0 + cc < D) {
          const float4 y = *reinterpret_cast<const float4*>(src);
          x[0] = y.x; x[1] = y.y; x[2] = y.z; x[3] = y.w;
        } else if (!vec) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col0 + cc + e < D) x[e] = src[e];
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = round_to<T>(x[e] * scale);
      *reinterpret_cast<float4*>(qs + row * LD + cc) = make_float4(x[0], x[1], x[2], x[3]);
    }
  };

  // S: lane = 8 kt + ds; after the sum over the slices, query 8 warp + ds
  const int ds = lane & 7, kt = lane >> 3;
  const int qrow = 8 * warp + ds;

  float m_run = -CUDART_INF_F, l_part = 0.f;
  float acc[8][2 * DJ];  // O: queries 8 warp + i, columns as `col` below
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 2 * DJ; ++c) acc[i][c] = 0.f;
  float s[8][8];

  // q (where it is one chunk and its rows whole 16-byte pieces: copied with
  // the first unit, scaled in place once that has landed), then the ring's
  // first units
  const bool q_async = nc == 1 && vec && F3S_PARTS != 1;
  if (q_async) {
    for (int row = warp; row < kTileQ; row += kTileThreads / 32) {
      const T* s = qb + static_cast<int64_t>(n0 + row) * sq.n;
      const bool live = n0 + row < N;
#pragma unroll
      for (int c = 4 * lane; c < DP; c += 128) {
        const bool in = live && c < D;
        cp_async16(qs + row * LD + c, in ? s + c : qb, in ? 16 : 0);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < STAGES - 1; ++u) {
    issue(u);
    cp_async_commit();
  }
  if (nc == 1 && !q_async) stage_q(0);

  for (int u = 0; u < units; ++u) {
    cp_async_wait_group<STAGES - 2>();
    __syncthreads();  // unit u has landed; every thread is done with unit u - 1
    issue(u + STAGES - 1);
    cp_async_commit();
    const float* unit = ring + (u % STAGES) * S::kUnitFloats;
    const int r = u % (nc + 1);
    if (u == 0 && q_async) {  // q landed with unit 0
      for (int i = tid; i < kTileQ * (DP / 4); i += kTileThreads) {
        float4* x = reinterpret_cast<float4*>(qs + i / (DP / 4) * LD) + i % (DP / 4);
        const float4 y = *x;
        *x = make_float4(round_to<T>(y.x * scale), round_to<T>(y.y * scale),
                         round_to<T>(y.z * scale), round_to<T>(y.w * scale));
      }
      __syncthreads();
    }
    if (r < nc) {  // S += q K^T over the chunk's columns
      if (nc > 1) {
        stage_q(r);
        __syncthreads();
      }
      if (r == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      }
      if (F3S_PARTS != 2) {
        const float* qp = qs + 8 * warp * LD + 4 * ds;
        const float* kp = unit + 8 * kt * LD + 4 * ds;
#pragma unroll 1
        for (int d = 0; d < DP; d += 32) {
          float4 a[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(qp + i * LD + d);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 x = *reinterpret_cast<const float4*>(kp + j * LD + d);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              s[i][j] = fmaf(a[i].x, x.x, s[i][j]);
              s[i][j] = fmaf(a[i].y, x.y, s[i][j]);
              s[i][j] = fmaf(a[i].z, x.z, s[i][j]);
              s[i][j] = fmaf(a[i].w, x.w, s[i][j]);
            }
          }
        }
      }
      if (r == nc - 1) {
        // the eight column slices summed (lane bits 2, 1, 0 halve the
        // queries), keys past M masked, the running max and sum, p^T out
        float s4[4][8], s2[2][8], s1[1][8];
        halve<4, 8>(s, s4, lane & 4, 4);
        halve<2, 8>(s4, s2, lane & 2, 2);
        halve<1, 8>(s2, s1, lane & 1, 1);
        const int key0 = u / (nc + 1) * kTileKeys + 8 * kt;
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (key0 + j >= M) s1[0][j] = -CUDART_INF_F;
          mx = fmaxf(mx, s1[0][j]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m_run, mx);  // finite: a tile holds a key below M
        const float alpha = expf(m_run - m_new);  // 0 on the first tile
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p = expf(s1[0][j] - m_new);
          sum += p;
          pt[(8 * kt + j) * kTilePLd + qrow] = p;
        }
        l_part = l_part * alpha + sum;
        m_run = m_new;
        if (kt == 0) alpha_s[qrow] = alpha;
      }
    } else {  // O = O * alpha + P V over the block's columns
      const float* pp = pt + 8 * warp;
      const float4 a0 = *reinterpret_cast<const float4*>(alpha_s + 8 * warp);
      const float4 a1 = *reinterpret_cast<const float4*>(alpha_s + 8 * warp + 4);
      const float al[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 2 * DJ; ++c) acc[i][c] *= al[i];
      if (F3S_PARTS != 2) {
#pragma unroll 2
        for (int m = 0; m < kTileKeys; ++m) {
          const float4 p0 = *reinterpret_cast<const float4*>(pp + m * kTilePLd);
          const float4 p1 = *reinterpret_cast<const float4*>(pp + m * kTilePLd + 4);
          const float pm[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
          const float* vr = unit + m * LD;
#pragma unroll
          for (int c4 = 0; c4 < C4; ++c4) {
            const float4 x = *reinterpret_cast<const float4*>(vr + 128 * c4 + 4 * lane);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              acc[i][4 * c4] = fmaf(pm[i], x.x, acc[i][4 * c4]);
              acc[i][4 * c4 + 1] = fmaf(pm[i], x.y, acc[i][4 * c4 + 1]);
              acc[i][4 * c4 + 2] = fmaf(pm[i], x.z, acc[i][4 * c4 + 2]);
              acc[i][4 * c4 + 3] = fmaf(pm[i], x.w, acc[i][4 * c4 + 3]);
            }
          }
          if (C2) {
            const float2 x = *reinterpret_cast<const float2*>(vr + 128 * C4 + 2 * lane);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              acc[i][4 * C4] = fmaf(pm[i], x.x, acc[i][4 * C4]);
              acc[i][4 * C4 + 1] = fmaf(pm[i], x.y, acc[i][4 * C4 + 1]);
            }
          }
        }
      }
    }
  }
  cp_async_wait_group<0>();

  // the row sums over the four key groups, then O / l
  float l = l_part;
  l += __shfl_xor_sync(0xffffffffu, l, 8);
  l += __shfl_xor_sync(0xffffffffu, l, 16);
  if (kt == 0) l_s[qrow] = l;
  __syncwarp();
  const float4 l0 = *reinterpret_cast<const float4*>(l_s + 8 * warp);
  const float4 l1 = *reinterpret_cast<const float4*>(l_s + 8 * warp + 4);
  const float ls[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
  store_o<DJ>(acc, ls, o + b * so.b + h * so.h, so.n, n0 + 8 * warp, N, c0, D, lane, vec_out);
}

// 16-byte accesses: D a multiple of 4, the tensors' bases on 16 bytes and
// their strides whole 16-byte pieces (st: 3 strides a tensor)
bool aligned16(std::initializer_list<const void*> bases, const int64_t* st, int nst, int D) {
  bool ok = D % 4 == 0;
  for (const void* p : bases) ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (int i = 0; i < nst; ++i) ok = ok && st[i] % 4 == 0;
  return ok;
}

template <int DJ>
int launch_f32_tile(const void* q, const void* k, const void* v, void* o, int B, int N, int M,
                    int H, int D, const int64_t* st, float scale, cudaStream_t stream) {
  using S = F32Tile<DJ>;
  auto kern = sr_attention_f32_tile_kernel<DJ>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]};
  const Strides sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const bool vec = aligned16({q, k, v}, st, 9, D), vec_out = aligned16({o}, st + 9, 3, D);
  const int col_blocks = (D + S::kDP - 1) / S::kDP;
  return over_batch_heads(static_cast<int64_t>(B) * H, [&](int bh0, int count) {
    const dim3 grid((N + kTileQ - 1) / kTileQ, count, col_blocks);
    kern<<<grid, kTileThreads, S::kSmem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), N, M, H, D, sq, sk, sv, so, scale, bh0, vec, vec_out);
    return static_cast<int>(cudaGetLastError());
  });
}

// the float32 instance at head dim D: DJ = D / 64 rounded up, at most 5
int f32_dj(int D) { return D > 64 * kTileMaxDJ ? kTileMaxDJ : (D + 63) / 64; }

template <int DJ>
void f32_shape(int64_t* shape) {
  shape[0] = F32Tile<DJ>::kDP;
  shape[1] = kTileKeys;
  shape[2] = F32Tile<DJ>::kStages;
  shape[3] = F32Tile<DJ>::kSmem;
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o, int B, int N,
                 int M, int H, int D, const int64_t* st, float scale,
                 cudaStream_t stream) {
  switch (f32_dj(D)) {
    case 1: return launch_f32_tile<1>(q, k, v, o, B, N, M, H, D, st, scale, stream);
    case 2: return launch_f32_tile<2>(q, k, v, o, B, N, M, H, D, st, scale, stream);
    case 3: return launch_f32_tile<3>(q, k, v, o, B, N, M, H, D, st, scale, stream);
    case 4: return launch_f32_tile<4>(q, k, v, o, B, N, M, H, D, st, scale, stream);
    default: return launch_f32_tile<5>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  }
}

// ---- bfloat16 and float16 on the tensor cores: mma.sync m16n8k16 (any layout)
//
// Each kernel below takes its element type E (__nv_bfloat16 or __half) as a
// template parameter: the two types share the products' shapes and fragment
// layouts (only the instruction's type differs), the shared-memory plans and
// the roundings (q * scale, p and the output rounded to E).

using BF = __nv_bfloat16;
using F16 = __half;

constexpr int kMmaThreads = 256;
constexpr int kMmaQueries = kMmaThreads / 32 * 16;  // eight warps of 16 query rows
constexpr float kMasked = -1e30f;  // score of a padding key: exp() of it is 0

// Scores of this warp's 16 query rows against keys key0 .. key0 + 15, as two
// m16n8 accumulator fragments: s[j][0..1] row g, s[j][2..3] row g + 8, keys
// key0 + 8j + 2t, + 1 (g = lane / 4, t = lane % 4). Keys >= M are masked.
template <typename E, int NK>
__device__ __forceinline__ void scores16(const E* ks, int ldk,
                                         const uint32_t (&qa)[NK][4], int key0,
                                         int M, int g, int t, float (&s)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    const E* kr = ks + (key0 + 8 * j + g) * ldk + 2 * t;
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kc * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kc * 16 + 8);
      mma16816<E>(s[j], qa[kc], b0, b1);
    }
    const int key = key0 + 8 * j + 2 * t;
    if (key >= M) s[j][0] = s[j][2] = kMasked;
    if (key + 1 >= M) s[j][1] = s[j][3] = kMasked;
  }
}

// One warp owns 16 query rows; a lane holds, in mma fragment layout, rows
// g and g + 8. Pass 1 walks the keys once for each row's max and sum
// (thread-local online softmax over the lane's own columns, combined across
// the four lanes of a row at the end); pass 2 recomputes the scores,
// normalises and rounds them to E (the full-row softmax of the TPU
// kernel) and feeds them as the A operand of the second product, whose B
// operand is V staged transposed. Recomputing QK^T costs tensor-core time
// that is small beside keeping a [16, M] score tile in registers.
template <typename E, int NK>  // head dim padded to 16 * NK
__global__ void __launch_bounds__(kMmaThreads)
sr_attention_mma_kernel(const E* __restrict__ q, const E* __restrict__ k,
                        const E* __restrict__ v, E* __restrict__ o, int N, int M, int H, int D,
                        Strides sq, Strides sk, Strides sv, Strides so, float scale,
                        bool vec, int bh0) {
  constexpr int Dp = 16 * NK;
  const int Mp = (M + 15) & ~15;
  const int ldk = Dp + 8;  // row strides of 4 mod 8 words: fragment loads
  const int ldv = Mp + 8;  // hit 32 distinct banks
  extern __shared__ __align__(16) unsigned char smem[];
  E* ks = reinterpret_cast<E*>(smem);  // [Mp][ldk]
  E* vt = ks + Mp * ldk;               // [Dp][ldv], V transposed

  const int tid = threadIdx.x;
  const int b = (bh0 + blockIdx.y) / H;
  const int h = (bh0 + blockIdx.y) % H;
  if (F3S_PARTS != 1) {
    const E* kb = k + b * sk.b + h * sk.h;
    const E* vb = v + b * sv.b + h * sv.h;
    if (vec) {  // 8 elements (16 bytes) a load: D, the strides and the bases allow it
      for (int idx = tid; idx < Mp * (Dp / 8); idx += kMmaThreads) {
        const int m = idx / (Dp / 8), d = idx % (Dp / 8) * 8;
        const bool in = m < M && d < D;
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        const uint4 kv = in ? *reinterpret_cast<const uint4*>(kb + m * sk.n + d) : zero;
        const uint4 vv = in ? *reinterpret_cast<const uint4*>(vb + m * sv.n + d) : zero;
        *reinterpret_cast<uint4*>(ks + m * ldk + d) = kv;
        const E* ve = reinterpret_cast<const E*>(&vv);
#pragma unroll
        for (int i = 0; i < 8; ++i) vt[(d + i) * ldv + m] = ve[i];
      }
    } else {
      const E zero = from_f32<E>(0.f);
      for (int idx = tid; idx < Mp * Dp; idx += kMmaThreads) {
        const int m = idx / Dp, d = idx % Dp;
        const bool in = m < M && d < D;
        ks[m * ldk + d] = in ? kb[m * sk.n + d] : zero;
        vt[d * ldv + m] = in ? vb[m * sv.n + d] : zero;
      }
    }
  }
  __syncthreads();

  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * kMmaQueries + (tid / 32) * 16 + g;
  const int row1 = row0 + 8;

  // q * scale, rounded to E, as A fragments
  uint32_t qa[NK][4];
  {
    const E* qb = q + b * sq.b + h * sq.h;
    auto ld = [&](int row, int d) -> float {
      return (F3S_PARTS != 1 && row < N && d < D)
                 ? round_to<E>(to_f32<E>(qb[static_cast<int64_t>(row) * sq.n + d]) * scale)
                 : 0.f;
    };
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {
      const int d = kc * 16 + 2 * t;
      qa[kc][0] = pack2<E>(ld(row0, d), ld(row0, d + 1));
      qa[kc][1] = pack2<E>(ld(row1, d), ld(row1, d + 1));
      qa[kc][2] = pack2<E>(ld(row0, d + 8), ld(row0, d + 9));
      qa[kc][3] = pack2<E>(ld(row1, d + 8), ld(row1, d + 9));
    }
  }

  // Softmax in base 2: exp(s - m) = exp2((s - m) * log2(e)), one
  // multiply and one ex2.approx each (a relative error of about 2^-22, far
  // below the rounding of the probabilities to E).
  float s[2][4];
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;
  for (int key0 = 0; key0 < (F3S_PARTS == 2 ? 0 : Mp); key0 += 16) {
    scores16<E, NK>(ks, ldk, qa, key0, M, g, t, s);
    const float n0 = fmaxf(m0, fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1])));
    const float n1 = fmaxf(m1, fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3])));
    l0 = l0 * exp2f((m0 - n0) * kLog2e) + exp2f((s[0][0] - n0) * kLog2e) +
         exp2f((s[0][1] - n0) * kLog2e) + exp2f((s[1][0] - n0) * kLog2e) +
         exp2f((s[1][1] - n0) * kLog2e);
    l1 = l1 * exp2f((m1 - n1) * kLog2e) + exp2f((s[0][2] - n1) * kLog2e) +
         exp2f((s[0][3] - n1) * kLog2e) + exp2f((s[1][2] - n1) * kLog2e) +
         exp2f((s[1][3] - n1) * kLog2e);
    m0 = n0;
    m1 = n1;
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {  // the four lanes of a row
    const float om0 = __shfl_xor_sync(0xffffffffu, m0, off);
    const float ol0 = __shfl_xor_sync(0xffffffffu, l0, off);
    const float om1 = __shfl_xor_sync(0xffffffffu, m1, off);
    const float ol1 = __shfl_xor_sync(0xffffffffu, l1, off);
    const float n0 = fmaxf(m0, om0), n1 = fmaxf(m1, om1);
    l0 = l0 * exp2f((m0 - n0) * kLog2e) + ol0 * exp2f((om0 - n0) * kLog2e);
    l1 = l1 * exp2f((m1 - n1) * kLog2e) + ol1 * exp2f((om1 - n1) * kLog2e);
    m0 = n0;
    m1 = n1;
  }
  const float r0 = 1.f / l0, r1 = 1.f / l1;
  const float c0 = m0 * kLog2e, c1 = m1 * kLog2e;

  float acc[2 * NK][4];
#pragma unroll
  for (int dc = 0; dc < 2 * NK; ++dc)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dc][i] = 0.f;
  for (int key0 = 0; key0 < (F3S_PARTS == 2 ? 0 : Mp); key0 += 16) {
    scores16<E, NK>(ks, ldk, qa, key0, M, g, t, s);
    uint32_t pa[4];  // softmax probabilities, rounded to E, as A fragments
    pa[0] = pack2<E>(exp2f(fmaf(s[0][0], kLog2e, -c0)) * r0, exp2f(fmaf(s[0][1], kLog2e, -c0)) * r0);
    pa[1] = pack2<E>(exp2f(fmaf(s[0][2], kLog2e, -c1)) * r1, exp2f(fmaf(s[0][3], kLog2e, -c1)) * r1);
    pa[2] = pack2<E>(exp2f(fmaf(s[1][0], kLog2e, -c0)) * r0, exp2f(fmaf(s[1][1], kLog2e, -c0)) * r0);
    pa[3] = pack2<E>(exp2f(fmaf(s[1][2], kLog2e, -c1)) * r1, exp2f(fmaf(s[1][3], kLog2e, -c1)) * r1);
#pragma unroll
    for (int dc = 0; dc < 2 * NK; ++dc) {
      const E* vr = vt + (dc * 8 + g) * ldv + key0 + 2 * t;
      mma16816<E>(acc[dc], pa, *reinterpret_cast<const uint32_t*>(vr),
               *reinterpret_cast<const uint32_t*>(vr + 8));
    }
  }

  E* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int dc = 0; dc < 2 * NK; ++dc) {
    const int d = dc * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i < 2 ? row0 : row1;
      if (row < N && d + (i & 1) < D)
        ob[static_cast<int64_t>(row) * so.n + d + (i & 1)] = from_f32<E>(acc[dc][i]);
    }
  }
}

template <typename E, int NK>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int N,
               int M, int H, int D, const int64_t* st, float scale,
               cudaStream_t stream) {
  const int Mp = (M + 15) & ~15;
  const size_t smem = (static_cast<size_t>(Mp) * (16 * NK + 8) +
                       static_cast<size_t>(16 * NK) * (Mp + 8)) * sizeof(E);
  if (smem > static_cast<size_t>(kMaxSmem)) return -2;
  auto kern = sr_attention_mma_kernel<E, NK>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]};
  const Strides sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  // 16-byte staging loads need whole 8-element groups at 16-byte addresses
  bool vec = D % 8 == 0;
  for (int i = 3; i < 9; ++i) vec = vec && st[i] % 8 == 0;
  vec = vec && reinterpret_cast<uintptr_t>(k) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  return over_batch_heads(static_cast<int64_t>(B) * H, [&](int bh0, int count) {
    const dim3 grid((N + kMmaQueries - 1) / kMmaQueries, count);
    kern<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
        static_cast<E*>(o), N, M, H, D, sq, sk, sv, so, scale, vec, bh0);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename E>
int dispatch_mma(const void* q, const void* k, const void* v, void* o, int B, int N,
                 int M, int H, int D, const int64_t* st, float scale,
                 cudaStream_t stream) {
  if (D <= 16) return launch_mma<E, 1>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  if (D <= 32) return launch_mma<E, 2>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  if (D <= 64) return launch_mma<E, 4>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  if (D <= 128) return launch_mma<E, 8>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  return -1;  // the route's domain: D <= 128
}


// ---- bfloat16 and float16 on the tensor cores: wgmma fed by TMA, keys in tiles
// (any M)

constexpr int kTileRows = 64;  // query rows of a consumer's tile: one wgmma's M
constexpr int kMaxKvStages = 16;
constexpr int kSwizzleTile = kTileRows * 128;  // bytes of [64 rows][64] 16-bit elements

// Consumer warpgroups and the registers `setmaxnreg` gives each role. The
// pool is the block's launch allocation, threads x the registers ptxas
// reports (the launch bound's most: 128 at 512 threads, 168 at 384);
// `launch_wgmma` checks it before a launch, since an `.inc` past the pool
// blocks forever. kQStages: the q ring's stages, each one item's tiles.
// kOInQ: O goes out through the consumer's own q tile (its last S is done),
// which then returns to the producer only once the store has read it; else
// through two output tiles of each consumer's own.
template <int DP> struct WgShape;
template <> struct WgShape<64> {   // 128 x 24 + 3 x 128 x 160 <= 512 x 128
  static constexpr int kConsumers = 3, kProducerRegs = 24, kConsumerRegs = 160;
  static constexpr int kQStages = 2;
  static constexpr bool kOInQ = false;
};
template <> struct WgShape<128> {  // 128 x 40 + 2 x 128 x 232 <= 384 x 168
  static constexpr int kConsumers = 2, kProducerRegs = 40, kConsumerRegs = 232;
  static constexpr int kQStages = 2;
  static constexpr bool kOInQ = false;
};
// D <= 256, FlashAttention-3's Hopper shape for that width: two consumers of
// 64 rows, O [64 x 256] in 128 float32 registers a thread, key tiles of 64.
// A q tile is 32 KB and a stage of K and V 64 KB: one q stage (64 KB), O
// through the q tiles, two K, V stages.
template <> struct WgShape<256> {  // 128 x 24 + 2 x 128 x 240 <= 384 x 168
  static constexpr int kConsumers = 2, kProducerRegs = 24, kConsumerRegs = 240;
  static constexpr int kQStages = 1;
  static constexpr bool kOInQ = true;
};
// 128 < D <= 192 (D = 160, or 129 copied to rows of 136): the shape of
// WgShape<256> at three 64-column blocks, so that D = 160 no longer pays
// for 256 columns in both products. O [64 x 192] in 96 float32 registers a
// thread. A q tile is 24 KB and a K, V stage of 64 keys 48 KB: one q stage
// (48 KB), O through the q tiles, three K, V stages (144 KB); 193 KB.
template <> struct WgShape<192> {  // 128 x 24 + 2 x 128 x 240 <= 384 x 168
  static constexpr int kConsumers = 2, kProducerRegs = 24, kConsumerRegs = 240;
  static constexpr int kQStages = 1;
  static constexpr bool kOInQ = true;
};
// 256 < D <= 320 (B2 re-headed: D = 320): O [64 x 320] in 160 registers a
// thread, the scores of 32 keys in 16 and p in 8: 184 of the 240. A q tile
// is 40 KB and a K, V stage of 64 keys 80 KB, so two consumers take key
// tiles of 32 (a stage 40 KB): one q stage (80 KB), O through the q tiles,
// three K, V stages (120 KB); 201 KB. Where the cut lies: at D = 384 O
// alone would take 192 of the 240 registers, and the scores, p, the
// softmax's state and the addresses do not fit beside it; past 320
// `sr_attention_wide_kernel` takes D in column blocks.
template <> struct WgShape<320> {  // 128 x 24 + 2 x 128 x 240 <= 384 x 168
  static constexpr int kConsumers = 2, kProducerRegs = 24, kConsumerRegs = 240;
  static constexpr int kQStages = 1;
  static constexpr bool kOInQ = true;
};

// O += P V for one k step of 16 keys (p in a0..a3): DP columns in one
// product where a wgmma's N holds them (64, 128, 256), else in two: 192 =
// 128 + 64, 320 = 256 + 64. The pieces' accumulators are consecutive runs
// of oc, so oc keeps the layout of one m64nDP accumulator (columns 8j +
// 2c, + 1 in oc[4j], oc[4j + 1]). `va`: V's first 64-column block at this
// k step; `lbo`: the step between V's column blocks.
template <typename E, int DP>
__device__ __forceinline__ void pv_step(float (&oc)[DP / 2], uint32_t a0, uint32_t a1,
                                        uint32_t a2, uint32_t a3, uint32_t va, uint32_t lbo) {
  if constexpr (DP == 64 || DP == 128 || DP == 256) {
    Wgmma<DP, E>::rs(oc, a0, a1, a2, a3, sw128_desc(va, lbo, 1024), 1);
  } else {
    constexpr int kFirst = DP > 256 ? 256 : 128, kRest = DP - kFirst;
    Wgmma<kFirst, E>::rs(reinterpret_cast<float(&)[kFirst / 2]>(oc[0]), a0, a1, a2, a3,
                         sw128_desc(va, lbo, 1024), 1);
    Wgmma<kRest, E>::rs(reinterpret_cast<float(&)[kRest / 2]>(oc[kFirst / 2]), a0, a1, a2,
                        a3, sw128_desc(va + kFirst / 64 * lbo, lbo, 1024), 1);
  }
}

struct WgParams {
  int N, M, H, tiles_per_bh, total_tiles, key_tiles, kv_stages;
  float q_scale;      // > 0: q is rounded to E(q * q_scale) before the product
  float score_scale;  // raw score -> log2 units of the softmax
};

// Shared memory, from a 1024-byte boundary: `kv_stages` x [K | V] tiles of
// KT keys, each [KT keys][DP] as DP / 64 swizzled column blocks; kQStages x
// C q tiles [64][DP]; two output tiles for each consumer (none with kOInQ).
template <typename E, int DP, int KT>
__global__ void __launch_bounds__(128 * (WgShape<DP>::kConsumers + 1), 1)
sr_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to, WgParams p) {
  constexpr int kConsumers = WgShape<DP>::kConsumers;
  constexpr int kQStages = WgShape<DP>::kQStages;
  constexpr bool kOInQ = WgShape<DP>::kOInQ;
  constexpr int kKeyTile = KT;  // keys of a K or V tile
  constexpr int kBlocks = DP / 64;                  // 64-column blocks of a row
  constexpr uint32_t kQBytes = kTileRows * DP * 2;  // a q or o tile
  constexpr uint32_t kKvBytes = kKeyTile * DP * 2;  // a K or V tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[2 * kQStages + 2 * kMaxKvStages];
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + kQStages;
  uint64_t* kv_full = bars + 2 * kQStages;
  uint64_t* kv_empty = kv_full + kMaxKvStages;
  uint8_t* kv_s = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  uint8_t* q_s = kv_s + p.kv_stages * 2 * kKvBytes;
  uint8_t* o_s = q_s + kQStages * kConsumers * kQBytes;

  // this block's run of 64-row query tiles j0 .. j1 - 1; tile j is rows
  // 64 (j % tiles_per_bh) onwards of (batch, head) j / tiles_per_bh. The run
  // goes in items: up to C consecutive tiles of one (batch, head), consumer
  // c taking the item's c-th tile. Key tile t of item li (the run's li-th)
  // is use u = li * period + t of the K, V ring: stage u % kv_stages, phase
  // (u / kv_stages) & 1. When the ring holds every key tile, period =
  // kv_stages puts tile t in stage t for every item.
  const int j0 = static_cast<int>(static_cast<int64_t>(blockIdx.x) * p.total_tiles / gridDim.x);
  const int j1 =
      static_cast<int>(static_cast<int64_t>(blockIdx.x + 1) * p.total_tiles / gridDim.x);
  // the item starting at tile j: its (batch, head) and its number of tiles
  auto item = [&](int j, int& bh, int& count) {
    bh = j / p.tiles_per_bh;
    count = min(kConsumers, min(j1, (bh + 1) * p.tiles_per_bh) - j);
  };
  const bool resident = p.key_tiles <= p.kv_stages;
  const int period = resident ? p.kv_stages : p.key_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 4 * kConsumers);  // every warp of every consumer
    }
    for (int s = 0; s < p.kv_stages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // provably warp-uniform
  if (wg == kConsumers) {
    // ---- producer: one thread issues every load, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(WgShape<DP>::kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      int held = -1;  // the (batch, head) whose key tiles the ring holds
      for (int j = j0, li = 0, bh, count; j < j1; j += count, ++li) {
        item(j, bh, count);
        const int n0 = (j % p.tiles_per_bh) * kTileRows;
        const int b = bh / p.H, h = bh % p.H;
        const int s = li % kQStages;
        mbar_wait(&q_empty[s], ((li / kQStages) & 1) ^ 1);
        if (F3S_PARTS == 1) {
          mbar_arrive(&q_full[s]);
        } else {
          mbar_arrive_tx(&q_full[s], count * kQBytes);
          for (int c = 0; c < count; ++c)
#pragma unroll
            for (int cb = 0; cb < kBlocks; ++cb)
              tma_load_4d(q_s + (s * kConsumers + c) * kQBytes + cb * kSwizzleTile, &tq,
                          &q_full[s], 64 * cb, h, n0 + c * kTileRows, b);
        }
        const bool again = resident && bh == held;
        for (int t = 0; t < p.key_tiles; ++t) {
          const int u = li * period + t, ks = u % p.kv_stages;
          mbar_wait(&kv_empty[ks], ((u / p.kv_stages) & 1) ^ 1);
          if (again || F3S_PARTS == 1) {
            mbar_arrive(&kv_full[ks]);  // the stage already holds this tile
          } else {
            mbar_arrive_tx(&kv_full[ks], 2 * kKvBytes);
            uint8_t* kt = kv_s + ks * 2 * kKvBytes;
#pragma unroll
            for (int cb = 0; cb < kBlocks; ++cb) {
              tma_load_4d(kt + cb * kKeyTile * 128, &tk, &kv_full[ks], 64 * cb, h,
                          t * kKeyTile, b);
              tma_load_4d(kt + kKvBytes + cb * kKeyTile * 128, &tv, &kv_full[ks], 64 * cb,
                          h, t * kKeyTile, b);
            }
          }
        }
        held = bh;
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes the wg-th tile of every item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(WgShape<DP>::kConsumerRegs));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c4 = lane % 4;
    uint8_t* o_mine = o_s + wg * 2 * kQBytes;
    // each warp's arrival once its lanes are done with a stage
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    int stored = 0;
    // The consumers take turns at issuing their products (FlashAttention-3's
    // ping-pong): warpgroup wg waits on named barrier 4 + wg (its 128
    // threads and the 128 of the warpgroup before it) and, once its
    // products are issued, passes the turn on, so that one warpgroup's
    // exponentials run while the next one's products hold the tensor cores.
    // Every consumer takes key_tiles + 1 turns an item (the first S, each
    // S with the previous P V, the last P V), live or not; the last
    // consumer gives the first turn, the first takes the last.
    auto turn_wait = [&]() { named_bar_sync(4 + wg, 256); };
    auto turn_pass = [&]() { named_bar_arrive(4 + (wg + 1) % kConsumers, 256); };
    if (wg == kConsumers - 1) named_bar_arrive(4, 256);
    float sc[kKeyTile / 2];  // scores, then exponentials, of one key tile
#pragma unroll
    for (int x = 0; x < kKeyTile / 2; ++x) sc[x] = 0.f;
    for (int j = j0, li = 0, bh, count; j < j1; j += count, ++li) {
      item(j, bh, count);
      const int n0 = (j % p.tiles_per_bh + wg) * kTileRows;
      const int b = bh / p.H, h = bh % p.H;
      // an item with fewer tiles than consumers: the others keep the barriers' count
      const bool rows = wg < count, live = rows && F3S_PARTS != 2;
      const int s = li % kQStages;
      mbar_wait(&q_full[s], (li / kQStages) & 1);
      uint8_t* qt = q_s + (s * kConsumers + wg) * kQBytes;
      if (live && p.q_scale > 0.f) {  // round q * scale to E in place
#pragma unroll
        for (int x = tid; x < static_cast<int>(kQBytes / 16); x += 128) {
          uint4 w = reinterpret_cast<const uint4*>(qt)[x];
          uint32_t* e = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            const float2 f = unpack2<E>(e[y]);
            e[y] = pack2<E>(f.x * p.q_scale, f.y * p.q_scale);
          }
          reinterpret_cast<uint4*>(qt)[x] = w;
        }
        fence_async_shared();
        named_bar_sync(1 + wg, 128);
      }

      // rows 16 warp + g (sc[4j], sc[4j + 1]; oc likewise) and + 8
      // (sc[4j + 2], sc[4j + 3]), keys or columns 8j + 2 c4 and the next
      float oc[DP / 2];
#pragma unroll
      for (int x = 0; x < DP / 2; ++x) oc[x] = 0.f;
      uint32_t pa[kKeyTile / 4];  // p of the previous key tile: the A operand of P V
      float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
      auto stage_of = [&](int t) {  // waits for key tile t; returns its stage
        const int u = li * period + t, ks = u % p.kv_stages;
        mbar_wait(&kv_full[ks], (u / p.kv_stages) & 1);
        return ks;
      };
      // S = Q K^T of the key tile in stage ks: both K-major, k steps of 16 along D
      auto scores = [&](int ks) {
        const uint32_t qa = smem_addr(qt), ka = smem_addr(kv_s + ks * 2 * kKvBytes);
#pragma unroll
        for (int kd = 0; kd < DP / 16; ++kd)
          Wgmma<kKeyTile, E>::ss(
              sc, sw128_desc(qa + kd / 4 * kSwizzleTile + kd % 4 * 32, 16, 1024),
              sw128_desc(ka + kd / 4 * kKeyTile * 128 + kd % 4 * 32, 16, 1024), kd > 0);
        wgmma_commit();
      };
      // O += P V of the key tile in stage ks: V [keys][DP] is MN-major, 16
      // keys (2048 bytes) a k step
      auto accumulate = [&](int ks) {
        const uint32_t va = smem_addr(kv_s + ks * 2 * kKvBytes + kKvBytes);
#pragma unroll
        for (int kc = 0; kc < kKeyTile / 16; ++kc)
          pv_step<E, DP>(oc, pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2], pa[4 * kc + 3],
                      va + kc * 2048, kKeyTile * 128);
        wgmma_commit();
      };
      // the running softmax over key tile t's scores: the new row maxima,
      // O's corrections exp(m_old - m_new), the sums; the exponentials stay
      // in sc
      auto softmax = [&](int t, float& corr0, float& corr1) {
        if ((t + 1) * kKeyTile > p.M) {  // keys past M score -inf
#pragma unroll
          for (int j = 0; j < kKeyTile / 8; ++j) {
            const int key = t * kKeyTile + 8 * j + 2 * c4;
            if (key >= p.M) sc[4 * j] = sc[4 * j + 2] = -CUDART_INF_F;
            if (key + 1 >= p.M) sc[4 * j + 1] = sc[4 * j + 3] = -CUDART_INF_F;
          }
        }
        float a0[4], a1[4];  // four partial maxima and sums a row: shorter chains
#pragma unroll
        for (int x = 0; x < 4; ++x) a0[x] = a1[x] = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < kKeyTile / 8; ++j) {
          a0[j % 4] = fmaxf(a0[j % 4], fmaxf(sc[4 * j], sc[4 * j + 1]));
          a1[j % 4] = fmaxf(a1[j % 4], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        float t0 = fmaxf(fmaxf(a0[0], a0[1]), fmaxf(a0[2], a0[3]));
        float t1 = fmaxf(fmaxf(a1[0], a1[1]), fmaxf(a1[2], a1[3]));
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {  // the four lanes of a row
          t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, off));
          t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, off));
        }
        // every tile has a key below M, so the new maxima are finite and
        // the first tile's corrections are exp2(-inf) = 0
        t0 = fmaxf(m0, t0);
        t1 = fmaxf(m1, t1);
        corr0 = ex2((m0 - t0) * p.score_scale);
        corr1 = ex2((m1 - t1) * p.score_scale);
        m0 = t0;
        m1 = t1;
        const float c0 = t0 * p.score_scale, c1 = t1 * p.score_scale;
        float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kKeyTile / 8; ++j) {
          sc[4 * j] = ex2(fmaf(sc[4 * j], p.score_scale, -c0));
          sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], p.score_scale, -c0));
          sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], p.score_scale, -c1));
          sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], p.score_scale, -c1));
          s0[j % 4] += sc[4 * j] + sc[4 * j + 1];
          s1[j % 4] += sc[4 * j + 2] + sc[4 * j + 3];
        }
        const float e0 = (s0[0] + s0[1]) + (s0[2] + s0[3]);
        const float e1 = (s1[0] + s1[1]) + (s1[2] + s1[3]);
        l0 = fmaf(l0, corr0, e0);  // this lane's columns; summed across the quad at the end
        l1 = fmaf(l1, corr1, e1);
      };
      // p in E from the exponentials, 16 keys a k step, in the
      // A-operand layout (once the P V that reads pa is done)
      auto pack_p = [&]() {
#pragma unroll
        for (int kc = 0; kc < kKeyTile / 16; ++kc) {
          pa[4 * kc] = pack2<E>(sc[8 * kc], sc[8 * kc + 1]);
          pa[4 * kc + 1] = pack2<E>(sc[8 * kc + 2], sc[8 * kc + 3]);
          pa[4 * kc + 2] = pack2<E>(sc[8 * kc + 4], sc[8 * kc + 5]);
          pa[4 * kc + 3] = pack2<E>(sc[8 * kc + 6], sc[8 * kc + 7]);
        }
      };

      if (!live) {  // keep the barriers' count only
        for (int t = 0; t < p.key_tiles; ++t) {
          release(&kv_empty[stage_of(t)]);
          turn_wait();
          turn_pass();
        }
        turn_wait();
        turn_pass();
        if (!(kOInQ && rows)) release(&q_empty[s]);
      } else {
        int prev = stage_of(0);
        float corr0, corr1;
        turn_wait();
        wgmma_fence();
        scores(prev);
        turn_pass();
        wgmma_wait<0>();
        pin(sc);
        softmax(0, corr0, corr1);  // O is still 0: no correction
        pack_p();
        for (int t = 1; t < p.key_tiles; ++t) {
          const int ks = stage_of(t);
          // this tile's S and the previous tile's P V together; the
          // exponentials below run while P V is on the tensor cores
          turn_wait();
          wgmma_fence();
          scores(ks);
          accumulate(prev);
          turn_pass();
          wgmma_wait<1>();  // S is done
          pin(sc);
          softmax(t, corr0, corr1);
          wgmma_wait<0>();  // P V is done
          pin(oc);
          pin(pa);
          release(&kv_empty[prev]);
#pragma unroll
          for (int j = 0; j < DP / 8; ++j) {  // O into the new maxima's units
            oc[4 * j] *= corr0;
            oc[4 * j + 1] *= corr0;
            oc[4 * j + 2] *= corr1;
            oc[4 * j + 3] *= corr1;
          }
          pack_p();
          prev = ks;
        }
        if (!kOInQ) release(&q_empty[s]);  // every S is done
        turn_wait();
        wgmma_fence();
        accumulate(prev);
        turn_pass();
        wgmma_wait<0>();
        pin(oc);
        pin(pa);
        release(&kv_empty[prev]);
      }

      if (rows) {
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          l0 += __shfl_xor_sync(0xffffffffu, l0, off);
          l1 += __shfl_xor_sync(0xffffffffu, l1, off);
        }
        const float r0 = 1.f / l0, r1 = 1.f / l1;
        // O / l to a swizzled tile, then one TMA store (rows past N,
        // columns past D clipped); the store of two tiles ago must have
        // read this buffer
        uint8_t* ot = kOInQ ? qt : o_mine + (stored & 1) * kQBytes;
        if (!kOInQ && tid == 0) tma_store_wait_read<1>();
        named_bar_sync(1 + wg, 128);
        const int row = 16 * warp + g;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          uint8_t* dst = ot + j / 8 * kSwizzleTile + row * 128 + c4 * 4;
          const int piece = ((j % 8) ^ (row % 8)) * 16;  // rows row and row + 8 swizzle alike
          *reinterpret_cast<uint32_t*>(dst + piece) = pack2<E>(oc[4 * j] * r0, oc[4 * j + 1] * r0);
          *reinterpret_cast<uint32_t*>(dst + 8 * 128 + piece) =
              pack2<E>(oc[4 * j + 2] * r1, oc[4 * j + 3] * r1);
        }
        fence_async_shared();
        named_bar_sync(1 + wg, 128);
        if (tid == 0) {
#pragma unroll
          for (int cb = 0; cb < kBlocks; ++cb)
            tma_store_4d(&to, ot + cb * kSwizzleTile, 64 * cb, h, n0, b);
          tma_store_commit();
        }
        ++stored;
        if (kOInQ) {  // the q tile goes back to the producer once the store has read it
          if (tid == 0) tma_store_wait_read<0>();
          named_bar_sync(1 + wg, 128);
          release(&q_empty[s]);
        }
      }
    }
    if (wg == 0) turn_wait();  // the last turn
    if (tid == 0) tma_store_wait_all();
  }
}

// cuTensorMapEncodeTiled, from libcuda through the runtime's entry-point query (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// An E [B, T, H, D] tensor (bfloat16 or float16) with element strides st =
// (b, t, h), the last axis contiguous, as a 4-d map (D, H, T, B) whose box
// is 64 columns of `rows` tokens of one (batch, head), 128-byte swizzled. A
// stride of an axis of extent 1 is never stepped; it gets a value TMA
// accepts (whole 16-byte pieces).
template <typename E>
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* base, int B, int T, int H,
                int D, const int64_t* st, int rows) {
  const int64_t sh = H > 1 ? st[2] : (D + 7) / 8 * 8;
  const int64_t sn = T > 1 ? st[1] : sh * H;
  const int64_t sb = B > 1 ? st[0] : sn * T;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh * 2), static_cast<cuuint64_t>(sn * 2),
                                 static_cast<cuuint64_t>(sb * 2)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type =
      kIsHalf<E> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 4, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The number of persistent blocks, at most one per SM: the one whose
// busiest block has the fewest item rounds (a run of tiles splits into items
// of up to `consumers` tiles at every (batch, head) boundary, and every item
// takes a consumer through all the keys), then the fewest tiles, then the
// most blocks. 1024 tiles of 16 a (batch, head) take 3 rounds on 128 blocks
// and 4 on 132.
int choose_grid(int sms, int total, int tiles_per_bh, int consumers) {
  const int most = sms < total ? sms : total;
  int best = most, best_rounds = 0x7fffffff, best_tiles = 0x7fffffff;
  for (int g = most; g >= 1 && 2 * g >= most; --g) {
    int rounds = 0, tiles = 0;
    for (int b = 0; b < g; ++b) {
      const int j0 = static_cast<int>(static_cast<int64_t>(b) * total / g);
      const int j1 = static_cast<int>(static_cast<int64_t>(b + 1) * total / g);
      int r = 0;
      for (int j = j0; j < j1;) {
        const int end = std::min(j1, (j / tiles_per_bh + 1) * tiles_per_bh);
        r += (end - j + consumers - 1) / consumers;
        j = end;
      }
      rounds = std::max(rounds, r);
      tiles = std::max(tiles, j1 - j0);
    }
    if (rounds < best_rounds || (rounds == best_rounds && tiles < best_tiles)) {
      best = g;
      best_rounds = rounds;
      best_tiles = tiles;
    }
  }
  return best;
}

// What a wgmma instance takes: its padded width DP, key tile KT, consumer
// warpgroups, K, V stages and dynamic shared bytes (ops/attention.py
// `_sr_shape` mirrors it). `err` is 0, or what the launcher returns.
struct WgPlan {
  int dp, kt, consumers, stages;
  int64_t smem;
  int err;
};

template <typename E, int DP, int KT>
WgPlan wgmma_plan() {
  using Shape = WgShape<DP>;
  constexpr int kThreadsWg = 128 * (Shape::kConsumers + 1);
  WgPlan plan{DP, KT, Shape::kConsumers, 0, 0, 0};
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, sr_attention_wgmma_kernel<E, DP, KT>);
  if (err != cudaSuccess) {
    plan.err = static_cast<int>(err);
    return plan;
  }
  // the registers setmaxnreg hands out must lie within the launch's pool
  if (attr.numRegs * kThreadsWg <
      128 * (Shape::kProducerRegs + Shape::kConsumers * Shape::kConsumerRegs)) {
    plan.err = -6;
    return plan;
  }
  // as many K, V stages as fit beside the q ring and the output tiles
  const size_t tile = kTileRows * DP * 2, kv = 2 * static_cast<size_t>(KT) * DP * 2;
  const size_t fixed =
      1024 + (Shape::kQStages + (Shape::kOInQ ? 0 : 2)) * Shape::kConsumers * tile;
  const size_t room = static_cast<size_t>(kMaxSmem) - attr.sharedSizeBytes - fixed;
  plan.stages = std::min(static_cast<int>(room / kv), kMaxKvStages);
  plan.smem = static_cast<int64_t>(fixed + plan.stages * kv);
  if (plan.stages < 2) plan.err = -2;
  return plan;
}

template <typename E, int DP, int KT>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int N, int M,
                 int H, int D, const int64_t* st, float scale, cudaStream_t stream) {
  using Shape = WgShape<DP>;
  constexpr int kThreadsWg = 128 * (Shape::kConsumers + 1);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -5;
  CUtensorMap tq, tk, tv, to;
  if (!tensor_map<E>(encode, &tq, q, B, N, H, D, st, kTileRows) ||
      !tensor_map<E>(encode, &tk, k, B, M, H, D, st + 3, KT) ||
      !tensor_map<E>(encode, &tv, v, B, M, H, D, st + 6, KT) ||
      !tensor_map<E>(encode, &to, o, B, N, H, D, st + 9, kTileRows))
    return -4;
  auto kern = sr_attention_wgmma_kernel<E, DP, KT>;
  const WgPlan plan = wgmma_plan<E, DP, KT>();
  if (plan.err != 0) return plan.err;
  const int stages = plan.stages;
  const size_t smem = static_cast<size_t>(plan.smem);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  WgParams prm{};
  prm.N = N;
  prm.M = M;
  prm.H = H;
  prm.tiles_per_bh = (N + kTileRows - 1) / kTileRows;
  const int64_t total = static_cast<int64_t>(B) * H * prm.tiles_per_bh;
  if (total > 0x7fffffff / 2) return -7;
  prm.total_tiles = static_cast<int>(total);
  prm.key_tiles = (M + KT - 1) / KT;
  prm.kv_stages = stages;
  // a power-of-two scale moves onto the float32 scores exactly
  int e = 0;
  const bool pow2 = std::frexp(scale, &e) == 0.5f;
  prm.q_scale = pow2 ? 0.f : scale;
  prm.score_scale = pow2 ? scale * kLog2e : kLog2e;
  const int grid = choose_grid(sms, prm.total_tiles, prm.tiles_per_bh, Shape::kConsumers);
  kern<<<grid, kThreadsWg, smem, stream>>>(tq, tk, tv, to, prm);
  return static_cast<int>(cudaGetLastError());
}

// ---- bfloat16 and float16 at D > 320: wgmma over D in chunks, the output in
// column blocks
//
// Past D = 320 a consumer of the kernel above cannot hold O beside its
// scores (see WgShape<320>), so this kernel cuts the output into column
// blocks and takes S again for each. One warpgroup a block, one block for
// every (64-row query tile, column block of kWideOut outputs) of every
// (batch, head). S = Q K^T of a key tile
// of 64 keys adds up over D in chunks of 64 columns, each a unit of the
// ring: the q tile's chunk and the key tile's chunk, 8 KB each, loaded
// together (the q tile again for every key tile, from L2), so that no D is
// too wide for shared memory. Then the running softmax as in the kernel
// above, and O += P V over the block's columns of the key tile's V, 128 a
// unit. Thread 0 keeps kWideStages units in flight; the warpgroup meets at
// a barrier once it is done with a unit, and thread 0 then loads the unit
// kWideStages on into its stage. No producer warp, no overlap of a unit's
// products with the next: simple first.
constexpr int kWideOut = 256;  // output columns of a block: O in 128 registers a thread
constexpr int kWideStages = 4;
constexpr uint32_t kUnitBytes = 2 * kSwizzleTile;

struct WideParams {
  int N, M, H, D, tiles_per_bh, col_blocks, d_chunks, key_tiles;
  int64_t item0;      // the first item of this launch
  float q_scale;      // > 0: q is rounded to E(q * q_scale) before the product
  float score_scale;  // raw score -> log2 units of the softmax
  Strides so;
};

template <typename E>
__global__ void __launch_bounds__(128, 1)
sr_attention_wide_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, E* __restrict__ o,
                         WideParams p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kWideStages];
  uint8_t* ring = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;

  const int64_t item = p.item0 + blockIdx.x;  // (batch, head), column block, query tile
  const int tile = static_cast<int>(item % p.tiles_per_bh);
  const int cb = static_cast<int>(item / p.tiles_per_bh % p.col_blocks);
  const int bh = static_cast<int>(item / p.tiles_per_bh / p.col_blocks);
  const int b = bh / p.H, h = bh % p.H;
  const int n0 = tile * kTileRows, c0 = cb * kWideOut;
  const int vblocks = min(kWideOut / 64, (p.D - c0 + 63) / 64);  // V's 64-column blocks here
  const int vunits = (vblocks + 1) / 2;
  const int per_tile = p.d_chunks + vunits;  // units of a key tile
  const int units = p.key_tiles * per_tile;
  const int tid = threadIdx.x;

  // unit u into its stage: a chunk of q and of K, or up to two blocks of V
  // (a block wholly past D is not loaded; the product reads the stage's
  // stale bytes there, into columns that are never stored)
  auto issue = [&](int u) {
    const int t = u / per_tile, r = u % per_tile;
    uint8_t* dst = ring + (u % kWideStages) * kUnitBytes;
    uint64_t* bar = &full[u % kWideStages];
    if (r < p.d_chunks) {
      mbar_arrive_tx(bar, kUnitBytes);
      tma_load_4d(dst, &tq, bar, 64 * r, h, n0, b);
      tma_load_4d(dst + kSwizzleTile, &tk, bar, 64 * r, h, t * 64, b);
    } else {
      const int first = 2 * (r - p.d_chunks), count = min(2, vblocks - first);
      mbar_arrive_tx(bar, count * kSwizzleTile);
      for (int i = 0; i < count; ++i)
        tma_load_4d(dst + i * kSwizzleTile, &tv, bar, c0 + 64 * (first + i), h, t * 64, b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kWideStages; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int u = 0; u < min(kWideStages, units); ++u) issue(u);

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, c4 = lane % 4;
  int u = 0;  // the next unit
  auto wait_unit = [&]() {
    mbar_wait(&full[u % kWideStages], (u / kWideStages) & 1);
    return ring + (u % kWideStages) * kUnitBytes;
  };
  auto done_unit = [&]() {  // every thread is done with unit u: its stage takes u + kWideStages
    __syncthreads();
    if (tid == 0 && u + kWideStages < units) issue(u + kWideStages);
    ++u;
  };

  float oc[2][64];  // columns c0 + 128 i + ...: the accumulator layout of m64n128
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int x = 0; x < 64; ++x) oc[i][x] = 0.f;
  float sc[32];
  uint32_t pa[16];
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  for (int t = 0; t < p.key_tiles; ++t) {
    for (int c = 0; c < p.d_chunks; ++c) {
      uint8_t* st = wait_unit();
      if (p.q_scale > 0.f) {  // round q * scale to E in place
        for (int x = tid; x < static_cast<int>(kSwizzleTile / 16); x += 128) {
          uint4 w = reinterpret_cast<const uint4*>(st)[x];
          uint32_t* e = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            const float2 f = unpack2<E>(e[y]);
            e[y] = pack2<E>(f.x * p.q_scale, f.y * p.q_scale);
          }
          reinterpret_cast<uint4*>(st)[x] = w;
        }
        fence_async_shared();
        __syncthreads();
      }
      const uint32_t qa = smem_addr(st), ka = qa + kSwizzleTile;
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < 4; ++kd)
        Wgmma<64, E>::ss(sc, sw128_desc(qa + kd * 32, 16, 1024),
                         sw128_desc(ka + kd * 32, 16, 1024), c > 0 || kd > 0);
      wgmma_commit();
      wgmma_wait<0>();
      pin(sc);
      done_unit();
    }
    // the running softmax over this key tile (keys past M score -inf)
    if ((t + 1) * 64 > p.M) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = t * 64 + 8 * j + 2 * c4;
        if (key >= p.M) sc[4 * j] = sc[4 * j + 2] = -CUDART_INF_F;
        if (key + 1 >= p.M) sc[4 * j + 1] = sc[4 * j + 3] = -CUDART_INF_F;
      }
    }
    float t0 = -CUDART_INF_F, t1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      t0 = fmaxf(t0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      t1 = fmaxf(t1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {  // the four lanes of a row
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, off));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, off));
    }
    t0 = fmaxf(m0, t0);  // finite: every key tile has a key below M
    t1 = fmaxf(m1, t1);
    const float corr0 = ex2((m0 - t0) * p.score_scale), corr1 = ex2((m1 - t1) * p.score_scale);
    m0 = t0;
    m1 = t1;
    const float k0 = t0 * p.score_scale, k1 = t1 * p.score_scale;
    float e0 = 0.f, e1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j] = ex2(fmaf(sc[4 * j], p.score_scale, -k0));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], p.score_scale, -k0));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], p.score_scale, -k1));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], p.score_scale, -k1));
      e0 += sc[4 * j] + sc[4 * j + 1];
      e1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = fmaf(l0, corr0, e0);
    l1 = fmaf(l1, corr1, e1);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        oc[i][4 * j] *= corr0;
        oc[i][4 * j + 1] *= corr0;
        oc[i][4 * j + 2] *= corr1;
        oc[i][4 * j + 3] *= corr1;
      }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      pa[4 * kc] = pack2<E>(sc[8 * kc], sc[8 * kc + 1]);
      pa[4 * kc + 1] = pack2<E>(sc[8 * kc + 2], sc[8 * kc + 3]);
      pa[4 * kc + 2] = pack2<E>(sc[8 * kc + 4], sc[8 * kc + 5]);
      pa[4 * kc + 3] = pack2<E>(sc[8 * kc + 6], sc[8 * kc + 7]);
    }
    // O += P V, 128 of the block's columns a unit: V [64 keys][128] is
    // MN-major, two 64-column blocks 8 KB apart, 16 keys (2048 bytes) a k step
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i < vunits) {
        const uint32_t va = smem_addr(wait_unit());
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          Wgmma<128, E>::rs(oc[i], pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2], pa[4 * kc + 3],
                            sw128_desc(va + kc * 2048, kSwizzleTile, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        pin(oc[i]);
        done_unit();
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float r0 = 1.f / l0, r1 = 1.f / l1;
  E* ob = o + b * p.so.b + h * p.so.h;
  const int row0 = n0 + 16 * warp + g, row1 = row0 + 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = c0 + 128 * i + 8 * j + 2 * c4;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (col + e >= p.D) continue;
        if (row0 < p.N)
          ob[static_cast<int64_t>(row0) * p.so.n + col + e] =
              from_f32<E>(oc[i][4 * j + e] * r0);
        if (row1 < p.N)
          ob[static_cast<int64_t>(row1) * p.so.n + col + e] =
              from_f32<E>(oc[i][4 * j + 2 + e] * r1);
      }
    }
}

template <typename E>
int launch_wgmma_wide(const void* q, const void* k, const void* v, void* o, int B, int N, int M,
                      int H, int D, const int64_t* st, float scale, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -5;
  CUtensorMap tq, tk, tv;
  if (!tensor_map<E>(encode, &tq, q, B, N, H, D, st, kTileRows) ||
      !tensor_map<E>(encode, &tk, k, B, M, H, D, st + 3, 64) ||
      !tensor_map<E>(encode, &tv, v, B, M, H, D, st + 6, 64))
    return -4;
  const size_t smem = 1024 + kWideStages * static_cast<size_t>(kUnitBytes);
  cudaError_t err = cudaFuncSetAttribute(sr_attention_wide_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  WideParams prm{};
  prm.N = N;
  prm.M = M;
  prm.H = H;
  prm.D = D;
  prm.tiles_per_bh = (N + kTileRows - 1) / kTileRows;
  prm.col_blocks = (D + kWideOut - 1) / kWideOut;
  prm.d_chunks = (D + 63) / 64;
  prm.key_tiles = (M + 63) / 64;
  prm.so = Strides{st[9], st[10], st[11]};
  int e = 0;
  const bool pow2 = std::frexp(scale, &e) == 0.5f;
  prm.q_scale = pow2 ? 0.f : scale;
  prm.score_scale = pow2 ? scale * kLog2e : kLog2e;
  const int64_t total = static_cast<int64_t>(B) * H * prm.col_blocks * prm.tiles_per_bh;
  for (int64_t i0 = 0; i0 < total; i0 += 0x7fffffff) {  // gridDim.x's limit
    prm.item0 = i0;
    const unsigned grid = static_cast<unsigned>(std::min<int64_t>(total - i0, 0x7fffffff));
    sr_attention_wide_kernel<E><<<grid, 128, smem, stream>>>(tq, tk, tv, static_cast<E*>(o), prm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename E>
int dispatch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int N, int M,
                   int H, int D, const int64_t* st, float scale, cudaStream_t stream) {
  // at D <= 64 key tiles of 128 (the per-tile costs spread over more
  // keys), of 64 where there are no more keys than that; at D <= 128 tiles
  // of 64 (two stages of 128 would not fit beside the q and o tiles)
  if (D <= 64 && M <= 64) return launch_wgmma<E, 64, 64>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  if (D <= 64) return launch_wgmma<E, 64, 128>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  if (D <= 128) return launch_wgmma<E, 128, 64>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  if (D <= 192) return launch_wgmma<E, 192, 64>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  if (D <= 256) return launch_wgmma<E, 256, 64>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  if (D <= 320) return launch_wgmma<E, 320, 32>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  return launch_wgmma_wide<E>(q, k, v, o, B, N, M, H, D, st, scale, stream);
}

// The instance `dispatch_wgmma<E>` takes at head dim D and its plan; past D
// = 320 the column-block kernel: its block's columns, key tile, one
// warpgroup, its unit ring and shared bytes.
template <typename E>
WgPlan wgmma_shape(int D, int M) {
  if (D <= 64 && M <= 64) return wgmma_plan<E, 64, 64>();
  if (D <= 64) return wgmma_plan<E, 64, 128>();
  if (D <= 128) return wgmma_plan<E, 128, 64>();
  if (D <= 192) return wgmma_plan<E, 192, 64>();
  if (D <= 256) return wgmma_plan<E, 256, 64>();
  if (D <= 320) return wgmma_plan<E, 320, 32>();
  return {kWideOut, 64, 1, kWideStages, 1024 + kWideStages * static_cast<int64_t>(kUnitBytes), 0};
}

// cudaFuncAttributes of one kernel instance, by name
bool kernel_attributes(const char* name, cudaFuncAttributes* attr, cudaError_t* err) {
  static const struct {
    const char* name;
    const void* fn;
  } kKernels[] = {
      {"wgmma_64_64", reinterpret_cast<const void*>(sr_attention_wgmma_kernel<BF, 64, 64>)},
      {"wgmma_64_128", reinterpret_cast<const void*>(sr_attention_wgmma_kernel<BF, 64, 128>)},
      {"wgmma_128_64", reinterpret_cast<const void*>(sr_attention_wgmma_kernel<BF, 128, 64>)},
      {"wgmma_192_64", reinterpret_cast<const void*>(sr_attention_wgmma_kernel<BF, 192, 64>)},
      {"wgmma_256_64", reinterpret_cast<const void*>(sr_attention_wgmma_kernel<BF, 256, 64>)},
      {"wgmma_320_32", reinterpret_cast<const void*>(sr_attention_wgmma_kernel<BF, 320, 32>)},
      {"wide", reinterpret_cast<const void*>(sr_attention_wide_kernel<BF>)},
      {"mma_16", reinterpret_cast<const void*>(sr_attention_mma_kernel<BF, 1>)},
      {"mma_32", reinterpret_cast<const void*>(sr_attention_mma_kernel<BF, 2>)},
      {"mma_64", reinterpret_cast<const void*>(sr_attention_mma_kernel<BF, 4>)},
      {"mma_128", reinterpret_cast<const void*>(sr_attention_mma_kernel<BF, 8>)},
      {"wgmma_64_64_f16", reinterpret_cast<const void*>(sr_attention_wgmma_kernel<F16, 64, 64>)},
      {"wgmma_64_128_f16", reinterpret_cast<const void*>(sr_attention_wgmma_kernel<F16, 64, 128>)},
      {"wgmma_128_64_f16", reinterpret_cast<const void*>(sr_attention_wgmma_kernel<F16, 128, 64>)},
      {"wgmma_192_64_f16", reinterpret_cast<const void*>(sr_attention_wgmma_kernel<F16, 192, 64>)},
      {"wgmma_256_64_f16", reinterpret_cast<const void*>(sr_attention_wgmma_kernel<F16, 256, 64>)},
      {"wgmma_320_32_f16", reinterpret_cast<const void*>(sr_attention_wgmma_kernel<F16, 320, 32>)},
      {"wide_f16", reinterpret_cast<const void*>(sr_attention_wide_kernel<F16>)},
      {"mma_16_f16", reinterpret_cast<const void*>(sr_attention_mma_kernel<F16, 1>)},
      {"mma_32_f16", reinterpret_cast<const void*>(sr_attention_mma_kernel<F16, 2>)},
      {"mma_64_f16", reinterpret_cast<const void*>(sr_attention_mma_kernel<F16, 4>)},
      {"mma_128_f16", reinterpret_cast<const void*>(sr_attention_mma_kernel<F16, 8>)},
      {"f32_tile_64", reinterpret_cast<const void*>(sr_attention_f32_tile_kernel<1>)},
      {"f32_tile_128", reinterpret_cast<const void*>(sr_attention_f32_tile_kernel<2>)},
      {"f32_tile_192", reinterpret_cast<const void*>(sr_attention_f32_tile_kernel<3>)},
      {"f32_tile_256", reinterpret_cast<const void*>(sr_attention_f32_tile_kernel<4>)},
      {"f32_tile_320", reinterpret_cast<const void*>(sr_attention_f32_tile_kernel<5>)},
  };
  for (const auto& kernel : kKernels)
    if (!std::strcmp(name, kernel.name)) {
      *err = cudaFuncGetAttributes(attr, kernel.fn);
      return true;
    }
  return false;
}

}  // namespace

// Launches on `stream`. q, o: [B, N, H, D]; k, v: [B, M, H, D]; `strides`
// holds the (batch, token, head) strides in elements of q, k, v, o in that
// order (12 values); the last axis of each is contiguous. kernel: 0 the
// float32 tile kernel, 1 mma.sync, 2 wgmma (16-byte aligned bases, strides
// of whole 16-byte pieces); dtype: 0 float32 (kernel 0 only), 1 bfloat16, 2
// float16 (kernels 1 and 2). `scale` is 1/sqrt(D) already rounded to the
// dtype.
// Any B * H, any D. Returns 0 on success, cudaGetLastError() otherwise, -1
// when D > 128 on mma.sync (that route's domain), -2 when what a block
// stages exceeds the shared memory of an SM (mma.sync only), -3 for an
// unknown kernel or a dtype it does not take, -4 when TMA cannot describe a
// tensor, -5 when libcuda has no cuTensorMapEncodeTiled, -6 when the wgmma
// kernel's register allocation is smaller than its warpgroups ask for, -7
// when the wgmma kernel's work items overflow an int.
extern "C" int f3s_sr_attention(const void* q, const void* k, const void* v,
                                void* o, int kernel, int dtype, int B, int N, int M,
                                int H, int D, const int64_t* strides, float scale,
                                void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 0 && dtype == 0) return dispatch_f32(q, k, v, o, B, N, M, H, D, strides, scale, s);
  if (kernel == 1 && dtype == 1)
    return dispatch_mma<BF>(q, k, v, o, B, N, M, H, D, strides, scale, s);
  if (kernel == 1 && dtype == 2)
    return dispatch_mma<F16>(q, k, v, o, B, N, M, H, D, strides, scale, s);
  if (kernel == 2 && dtype == 1)
    return dispatch_wgmma<BF>(q, k, v, o, B, N, M, H, D, strides, scale, s);
  if (kernel == 2 && dtype == 2)
    return dispatch_wgmma<F16>(q, k, v, o, B, N, M, H, D, strides, scale, s);
  return -3;
}

// The float32 tile kernel's instance at head dim D, for checking
// ops/attention.py `_sr_f32_shape`: shape = [DP, keys a unit, units of the
// ring, shared bytes].
extern "C" int f3s_sr_f32_shape(int D, int64_t* shape) {
  switch (f32_dj(D)) {
    case 1: f32_shape<1>(shape); break;
    case 2: f32_shape<2>(shape); break;
    case 3: f32_shape<3>(shape); break;
    case 4: f32_shape<4>(shape); break;
    default: f32_shape<5>(shape);
  }
  return 0;
}

// The wgmma route's choice at head dim D and M keys in dtype 1 (bfloat16)
// or 2 (float16), for checking ops/attention.py `_sr_shape`: shape = [DP,
// KT, consumers, stages, shared bytes]. Returns 0, -3 for another dtype, or
// what the launcher would return instead of launching.
extern "C" int f3s_sr_shape(int dtype, int D, int M, int64_t* shape) {
  if (dtype != 1 && dtype != 2) return -3;
  const WgPlan p = dtype == 1 ? wgmma_shape<BF>(D, M) : wgmma_shape<F16>(D, M);
  shape[0] = p.dp;
  shape[1] = p.kt;
  shape[2] = p.consumers;
  shape[3] = p.stages;
  shape[4] = p.smem;
  return p.err;
}

// The resources of kernel instance `name` ("wgmma_<DP>_<KT>", "wide",
// "mma_<16 NK>", each with "_f16" for its float16 twin; "f32_tile_<DP>"):
// out = [registers a thread, local (spilled) bytes a thread, static shared
// bytes, most threads a block]. Returns 0, -3 for an unknown name, or the
// CUDA error.
extern "C" int f3s_sr_resources(const char* name, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaSuccess;
  if (!kernel_attributes(name, &attr, &err)) return -3;
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = attr.maxThreadsPerBlock;
  return 0;
}
