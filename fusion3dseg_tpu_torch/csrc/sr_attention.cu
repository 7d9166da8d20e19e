// Spatial-reduction attention: a long query axis against a short, reduced
// key/value axis, scores and softmax never leaving the SM.
//
// Replaces the TPU kernel fusion3dseg_tpu/ops/attention.py `_attn_kernel`
// (Pallas, reached through `sr_attention`). For q [B, N, H, D] and
// k, v [B, M, H, D] of type T (bfloat16 or float32), per (b, n, h):
//   qs  = T(float(q) * scale)            scale = T(1 / sqrt(D)), given
//   s_m = sum_d qs_d * k_md              float32 accumulation
//   p_m = T(exp(s_m - max_m s) / sum_m exp(s_m - max_m s))   softmax in f32
//   o_d = T(sum_m p_m * v_md)            float32 accumulation
// The roundings to T are the TPU kernel's: q scaled in its own type, the
// probabilities normalised over the full row and cast to v's type before
// the second product, the output in q's type.
//
// Bound on an H100 (SXM): bytes. At the segmenter's shapes (M = 64 or 256,
// D = 64, bfloat16) the function reads q and writes o once (K and V are a
// few percent of that): 2.5 us at [8, 4096, 1, 64]. At M = 256 its 4*N*M*D
// operations (2.2 us on the tensor cores) and N*M exponentials (16 a clock
// on each SM, about 2 us) come close to that. Measured (tools/kernel_parts.py):
// at M = 64 a fixed cost of launch, first loads and last stores dominates;
// at M = 256 the arithmetic does, each consumer running its two products
// and its exponentials in series, two tiles in flight an SM.
//
// Three kernels; the caller (ops/attention._sr_route) names which.
//
// * bfloat16, `sr_attention_wgmma_kernel` (M <= 256, tensors TMA can
//   describe): persistent blocks, one per SM, walk the 64-row query tiles
//   in (batch, head)-major order, each block a contiguous run of them, so
//   that it stages K and V of a (batch, head) once. One producer thread
//   keeps TMA loads of q tiles in flight on a ring of mbarriers and loads
//   K, V on a ring of their own; two consumer warpgroups take alternate
//   tiles. A tile makes one pass over the keys: S = Q K^T by wgmma into
//   registers (M / 2 floats a thread), the full-row max and sum across the
//   quad, each exponential taken once, p rounded to bfloat16 in registers
//   and fed as the register A operand of O = P V (V as stored, [M][D],
//   MN-major), O through shared memory to a TMA store that overlaps the
//   next tile. Loads past N, M or D are zero-filled and stores past N or D
//   clipped, so any N works; keys past M score 0 there and are masked to
//   -inf before the max. The scale: at D = 16 or 64, 1/sqrt(D) is a power
//   of two, so T(q * scale) . k = scale * (q . k) bit for bit (barring
//   subnormals) and the scale goes onto the float32 scores, q straight from
//   TMA to wgmma; at other D the consumer rounds q * scale to bfloat16 in
//   shared memory first, as the TPU kernel does.
// * bfloat16, `sr_attention_mma_kernel` (any other layout; M up to what
//   shared memory holds): mma.sync m16n8k16, eight warps of 16 query rows a
//   block, K and V of one (batch, head) staged per block, two passes over
//   the keys (max and sum, then the normalised product).
// * float32: FMAs on the CUDA cores (TF32 tensor-core products would not
//   hold the 1e-4 agreement asked of float32). A block owns 32 queries; four
//   adjacent lanes share a query, each holding a quarter of D in registers,
//   so a score is a quarter dot product plus two shuffles. The block's
//   scores live in shared memory ([32][S] float32, S padded to 4 mod 8
//   words against bank conflicts): row max, then sum, then normalise.
//
// The two bfloat16 kernels read F3S_PARTS: 1 leaves the loads out, 2 the
// arithmetic (tools/kernel_parts.py times both; the results are wrong).

#include <cmath>

#include "attention_common.cuh"
#include "hopper.cuh"

#ifndef F3S_PARTS
#define F3S_PARTS 0
#endif

namespace {

using namespace f3s;

// ---- float32: FMAs on the CUDA cores

using T = float;
constexpr int kThreads = 128;
constexpr int kQueries = kThreads / kLanes;   // queries per block

template <int DPL>
__global__ void __launch_bounds__(kThreads)
sr_attention_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    int N, int M, int H, int D,
                    Strides sq, Strides sk, Strides sv, Strides so,
                    float scale, int S) {
  constexpr int Dp = DPL * kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                           // [M][Dp]
  T* vs = ks + static_cast<size_t>(M) * Dp;                     // [M][Dp]
  float* sc = reinterpret_cast<float*>(vs + static_cast<size_t>(M) * Dp);  // [kQueries][S]

  const int tid = threadIdx.x;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;

  // stage K and V of this (batch, head): kThreads / Dp rows per step
  {
    const T* kb = k + b * sk.b + h * sk.h;
    const T* vb = v + b * sv.b + h * sv.h;
    const int d = tid % Dp;
    const T zero = from_f32<T>(0.f);
    for (int m = tid / Dp; m < M; m += kThreads / Dp) {
      ks[m * Dp + d] = d < D ? kb[m * sk.n + d] : zero;
      vs[m * Dp + d] = d < D ? vb[m * sv.n + d] : zero;
    }
  }
  __syncthreads();

  const int lane = tid % kLanes;
  const int qi = tid / kLanes;
  const int n = blockIdx.x * kQueries + qi;
  const bool live = n < N;
  const int d0 = lane * DPL;

  float qr[DPL];
  {
    const T* qp = q + b * sq.b + static_cast<int64_t>(live ? n : 0) * sq.n + h * sq.h;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = d0 + i;
      qr[i] = (live && d < D) ? round_to<T>(to_f32<T>(qp[d]) * scale) : 0.f;
    }
  }

  // scores of this query's row; lane j keeps the entries m = j mod 4
  float* srow = sc + qi * S;
  float mx = -CUDART_INF_F;
  for (int m = 0; m < M; ++m) {
    float kr[DPL];
    load_chunk<T, DPL>(ks + m * Dp + d0, kr);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) s = fmaf(qr[i], kr[i], s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    mx = fmaxf(mx, s);
    if ((m % kLanes) == lane) srow[m] = s;
  }

  float l = 0.f;
  for (int m = lane; m < M; m += kLanes) {
    const float e = expf(srow[m] - mx);
    srow[m] = e;
    l += e;
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  for (int m = lane; m < M; m += kLanes) srow[m] = round_to<T>(srow[m] / l);
  __syncwarp();  // the four lanes of a query sit in one warp

  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  for (int m = 0; m < M; ++m) {
    const float p = srow[m];
    float vr[DPL];
    load_chunk<T, DPL>(vs + m * Dp + d0, vr);
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = fmaf(p, vr[i], acc[i]);
  }

  if (live) {
    T* op = o + b * so.b + static_cast<int64_t>(n) * so.n + h * so.h;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = d0 + i;
      if (d < D) op[d] = from_f32<T>(acc[i]);
    }
  }
}

template <int DPL>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int N,
           int M, int H, int D, const int64_t* st, float scale,
           cudaStream_t stream) {
  constexpr int Dp = DPL * kLanes;
  int S = M + ((12 - M % 8) % 8);  // smallest S >= M with S % 8 == 4
  const size_t smem = 2 * static_cast<size_t>(M) * Dp * sizeof(T) +
                      static_cast<size_t>(kQueries) * S * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return -2;
  auto kern = sr_attention_f32_kernel<DPL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + kQueries - 1) / kQueries, B * H);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]};
  const Strides sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), N, M, H, D, sq, sk, sv, so, scale, S);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o, int B, int N,
                 int M, int H, int D, const int64_t* st, float scale,
                 cudaStream_t stream) {
  if (D <= 8) return launch_f32<2>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  if (D <= 16) return launch_f32<4>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  if (D <= 32) return launch_f32<8>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  if (D <= 64) return launch_f32<16>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  if (D <= 128) return launch_f32<32>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  return -1;
}

// ---- bfloat16 on the tensor cores: mma.sync m16n8k16 (any layout)

using BF = __nv_bfloat16;

constexpr int kMmaThreads = 256;
constexpr int kMmaQueries = kMmaThreads / 32 * 16;  // eight warps of 16 query rows
constexpr float kMasked = -1e30f;  // score of a padding key: exp() of it is 0

// Scores of this warp's 16 query rows against keys key0 .. key0 + 15, as two
// m16n8 accumulator fragments: s[j][0..1] row g, s[j][2..3] row g + 8, keys
// key0 + 8j + 2t, + 1 (g = lane / 4, t = lane % 4). Keys >= M are masked.
template <int NK>
__device__ __forceinline__ void scores16(const __nv_bfloat16* ks, int ldk,
                                         const uint32_t (&qa)[NK][4], int key0,
                                         int M, int g, int t, float (&s)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    const __nv_bfloat16* kr = ks + (key0 + 8 * j + g) * ldk + 2 * t;
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kc * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kc * 16 + 8);
      mma_bf16(s[j], qa[kc], b0, b1);
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
// normalises and rounds them to bfloat16 (the full-row softmax of the TPU
// kernel) and feeds them as the A operand of the second product, whose B
// operand is V staged transposed. Recomputing QK^T costs tensor-core time
// that is small beside keeping a [16, M] score tile in registers.
template <int NK>  // head dim padded to 16 * NK
__global__ void __launch_bounds__(kMmaThreads)
sr_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ o, int N, int M, int H, int D,
                        Strides sq, Strides sk, Strides sv, Strides so, float scale,
                        bool vec) {
  constexpr int Dp = 16 * NK;
  const int Mp = (M + 15) & ~15;
  const int ldk = Dp + 8;  // row strides of 4 mod 8 words: fragment loads
  const int ldv = Mp + 8;  // hit 32 distinct banks
  extern __shared__ __align__(16) unsigned char smem[];
  BF* ks = reinterpret_cast<BF*>(smem);  // [Mp][ldk]
  BF* vt = ks + Mp * ldk;               // [Dp][ldv], V transposed

  const int tid = threadIdx.x;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  if (F3S_PARTS != 1) {
    const BF* kb = k + b * sk.b + h * sk.h;
    const BF* vb = v + b * sv.b + h * sv.h;
    if (vec) {  // 8 elements (16 bytes) a load: D, the strides and the bases allow it
      for (int idx = tid; idx < Mp * (Dp / 8); idx += kMmaThreads) {
        const int m = idx / (Dp / 8), d = idx % (Dp / 8) * 8;
        const bool in = m < M && d < D;
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        const uint4 kv = in ? *reinterpret_cast<const uint4*>(kb + m * sk.n + d) : zero;
        const uint4 vv = in ? *reinterpret_cast<const uint4*>(vb + m * sv.n + d) : zero;
        *reinterpret_cast<uint4*>(ks + m * ldk + d) = kv;
        const BF* ve = reinterpret_cast<const BF*>(&vv);
#pragma unroll
        for (int i = 0; i < 8; ++i) vt[(d + i) * ldv + m] = ve[i];
      }
    } else {
      const BF zero = __float2bfloat16_rn(0.f);
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

  // q * scale, rounded to bfloat16, as A fragments
  uint32_t qa[NK][4];
  {
    const BF* qb = q + b * sq.b + h * sq.h;
    auto ld = [&](int row, int d) -> float {
      return (F3S_PARTS != 1 && row < N && d < D)
                 ? round_to<BF>(to_f32<BF>(qb[static_cast<int64_t>(row) * sq.n + d]) * scale)
                 : 0.f;
    };
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {
      const int d = kc * 16 + 2 * t;
      qa[kc][0] = pack_bf16(ld(row0, d), ld(row0, d + 1));
      qa[kc][1] = pack_bf16(ld(row1, d), ld(row1, d + 1));
      qa[kc][2] = pack_bf16(ld(row0, d + 8), ld(row0, d + 9));
      qa[kc][3] = pack_bf16(ld(row1, d + 8), ld(row1, d + 9));
    }
  }

  // Softmax in base 2: exp(s - m) = exp2((s - m) * log2(e)), one
  // multiply and one ex2.approx each (a relative error of about 2^-22, far
  // below the bfloat16 rounding of the probabilities).
  float s[2][4];
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;
  for (int key0 = 0; key0 < (F3S_PARTS == 2 ? 0 : Mp); key0 += 16) {
    scores16<NK>(ks, ldk, qa, key0, M, g, t, s);
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
    scores16<NK>(ks, ldk, qa, key0, M, g, t, s);
    uint32_t pa[4];  // softmax probabilities, rounded to bfloat16, as A fragments
    pa[0] = pack_bf16(exp2f(fmaf(s[0][0], kLog2e, -c0)) * r0, exp2f(fmaf(s[0][1], kLog2e, -c0)) * r0);
    pa[1] = pack_bf16(exp2f(fmaf(s[0][2], kLog2e, -c1)) * r1, exp2f(fmaf(s[0][3], kLog2e, -c1)) * r1);
    pa[2] = pack_bf16(exp2f(fmaf(s[1][0], kLog2e, -c0)) * r0, exp2f(fmaf(s[1][1], kLog2e, -c0)) * r0);
    pa[3] = pack_bf16(exp2f(fmaf(s[1][2], kLog2e, -c1)) * r1, exp2f(fmaf(s[1][3], kLog2e, -c1)) * r1);
#pragma unroll
    for (int dc = 0; dc < 2 * NK; ++dc) {
      const BF* vr = vt + (dc * 8 + g) * ldv + key0 + 2 * t;
      mma_bf16(acc[dc], pa, *reinterpret_cast<const uint32_t*>(vr),
               *reinterpret_cast<const uint32_t*>(vr + 8));
    }
  }

  BF* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int dc = 0; dc < 2 * NK; ++dc) {
    const int d = dc * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i < 2 ? row0 : row1;
      if (row < N && d + (i & 1) < D)
        ob[static_cast<int64_t>(row) * so.n + d + (i & 1)] = __float2bfloat16_rn(acc[dc][i]);
    }
  }
}

template <int NK>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int N,
               int M, int H, int D, const int64_t* st, float scale,
               cudaStream_t stream) {
  const int Mp = (M + 15) & ~15;
  const size_t smem = (static_cast<size_t>(Mp) * (16 * NK + 8) +
                       static_cast<size_t>(16 * NK) * (Mp + 8)) * sizeof(BF);
  if (smem > static_cast<size_t>(kMaxSmem)) return -2;
  auto kern = sr_attention_mma_kernel<NK>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + kMmaQueries - 1) / kMmaQueries, B * H);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]};
  const Strides sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  // 16-byte staging loads need whole 8-element groups at 16-byte addresses
  bool vec = D % 8 == 0;
  for (int i = 3; i < 9; ++i) vec = vec && st[i] % 8 == 0;
  vec = vec && reinterpret_cast<uintptr_t>(k) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const BF*>(q), static_cast<const BF*>(k), static_cast<const BF*>(v),
      static_cast<BF*>(o), N, M, H, D, sq, sk, sv, so, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_mma(const void* q, const void* k, const void* v, void* o, int B, int N,
                 int M, int H, int D, const int64_t* st, float scale,
                 cudaStream_t stream) {
  if (D <= 16) return launch_mma<1>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  if (D <= 32) return launch_mma<2>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  if (D <= 64) return launch_mma<4>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  if (D <= 128) return launch_mma<8>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  return -1;
}

// ---- bfloat16 on the tensor cores: wgmma fed by TMA (M <= 256)

constexpr int kTileRows = 64;  // query rows of a tile: one wgmma's M
constexpr int kConsumers = 2;  // consumer warpgroups; one more produces
constexpr int kWgThreads = 128 * (kConsumers + 1);
constexpr int kMaxQStages = 4, kMaxKvStages = 2;
constexpr int kSwizzleTile = kTileRows * 128;  // bytes of [64 rows][64] bfloat16

struct WgParams {
  int N, M, H, tiles_per_bh, total_tiles, qstages, kvstages;
  float q_scale;      // > 0: q is rounded to bfloat16(q * q_scale) before the product
  float score_scale;  // raw score -> log2 units of the softmax
};

// Shared memory, from a 1024-byte boundary: `kvstages` x [K | V] of one
// (batch, head), each [MP rows][DP] as DP / 64 swizzled column blocks;
// `qstages` q tiles [64][DP]; two output tiles for each consumer.
template <int MP, int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
sr_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to, WgParams p) {
  constexpr int kBlocks = DP / 64;                     // 64-column blocks of a row
  constexpr uint32_t kQBytes = kTileRows * DP * 2;     // a q or o tile
  constexpr uint32_t kKBytes = MP * DP * 2;            // K or V of one (batch, head)
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[2 * kMaxQStages + 2 * kMaxKvStages];
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + kMaxQStages;
  uint64_t* kv_full = bars + 2 * kMaxQStages;
  uint64_t* kv_empty = kv_full + kMaxKvStages;
  uint8_t* kv_s = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  uint8_t* q_s = kv_s + p.kvstages * 2 * kKBytes;
  uint8_t* o_s = q_s + p.qstages * kQBytes;

  // this block's run of tiles; tile j is rows 64 (j % tiles_per_bh) .. of
  // (batch, head) j / tiles_per_bh, and its K, V are the run's
  // (j / tiles_per_bh - bh0)-th
  const int t0 = static_cast<int>(static_cast<int64_t>(blockIdx.x) * p.total_tiles / gridDim.x);
  const int t1 =
      static_cast<int>(static_cast<int64_t>(blockIdx.x + 1) * p.total_tiles / gridDim.x);
  const int bh0 = t0 / p.tiles_per_bh;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.qstages; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 4);  // the four warps of the tile's consumer
    }
    for (int s = 0; s < p.kvstages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every load, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      int kvi = -1;
      for (int j = t0; j < t1; ++j) {
        const int i = j - t0, bh = j / p.tiles_per_bh;
        const int n0 = (j % p.tiles_per_bh) * kTileRows, b = bh / p.H, h = bh % p.H;
        if (bh - bh0 != kvi) {
          kvi = bh - bh0;
          const int s = kvi % p.kvstages;
          mbar_wait(&kv_empty[s], ((kvi / p.kvstages) & 1) ^ 1);
          uint8_t* ks = kv_s + s * 2 * kKBytes;
          if (F3S_PARTS == 1) {
            mbar_arrive(&kv_full[s]);
          } else {
            mbar_arrive_tx(&kv_full[s], 2 * kKBytes);
#pragma unroll
            for (int c = 0; c < kBlocks; ++c) {
              tma_load_4d(ks + c * MP * 128, &tk, &kv_full[s], 64 * c, h, 0, b);
              tma_load_4d(ks + kKBytes + c * MP * 128, &tv, &kv_full[s], 64 * c, h, 0, b);
            }
          }
        }
        const int s = i % p.qstages;
        mbar_wait(&q_empty[s], ((i / p.qstages) & 1) ^ 1);
        if (F3S_PARTS == 1) {
          mbar_arrive(&q_full[s]);
        } else {
          mbar_arrive_tx(&q_full[s], kQBytes);
#pragma unroll
          for (int c = 0; c < kBlocks; ++c)
            tma_load_4d(q_s + s * kQBytes + c * kSwizzleTile, &tq, &q_full[s], 64 * c, h, n0, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes tiles t0 + wg, t0 + wg + 2, ...
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c4 = lane % 4;
    uint8_t* o_mine = o_s + wg * 2 * kQBytes;
    int kvi = -1, stored = 0;
    // release K, V index kvi (each warp once) and wait for the next
    auto next_kv = [&]() {
      if (kvi >= 0 && lane == 0) mbar_arrive(&kv_empty[kvi % p.kvstages]);
      ++kvi;
      mbar_wait(&kv_full[kvi % p.kvstages], (kvi / p.kvstages) & 1);
    };
    for (int i = wg; t0 + i < t1; i += kConsumers) {
      const int j = t0 + i, bh = j / p.tiles_per_bh;
      const int n0 = (j % p.tiles_per_bh) * kTileRows, b = bh / p.H, h = bh % p.H;
      while (kvi < bh - bh0) next_kv();
      const int s = i % p.qstages;
      mbar_wait(&q_full[s], (i / p.qstages) & 1);
      uint8_t* qt = q_s + s * kQBytes;
      const uint8_t* kt = kv_s + (kvi % p.kvstages) * 2 * kKBytes;
      const uint8_t* vt = kt + kKBytes;

      if (p.q_scale > 0.f) {  // round q * scale to bfloat16 in place
#pragma unroll
        for (int x = tid; x < static_cast<int>(kQBytes / 16); x += 128) {
          uint4 w = reinterpret_cast<const uint4*>(qt)[x];
          uint32_t* e = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            e[u] = pack_bf16(__uint_as_float(e[u] << 16) * p.q_scale,
                             __uint_as_float(e[u] & 0xffff0000u) * p.q_scale);
          reinterpret_cast<uint4*>(qt)[x] = w;
        }
        fence_async_shared();
        named_bar_sync(1 + wg, 128);
      }

      float oc[DP / 2];
#pragma unroll
      for (int x = 0; x < DP / 2; ++x) oc[x] = 0.f;
      if (F3S_PARTS != 2) {
        // S = Q K^T: both K-major, k steps of 16 along D
        float sc[MP / 2];
#pragma unroll
        for (int x = 0; x < MP / 2; ++x) sc[x] = 0.f;
        pin(sc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < DP / 16; ++ks) {
          const uint32_t qa = smem_addr(qt) + ks / 4 * kSwizzleTile + ks % 4 * 32;
          const uint32_t ka = smem_addr(kt) + ks / 4 * MP * 128 + ks % 4 * 32;
          Wgmma<MP>::ss(sc, sw128_desc(qa, 16, 1024), sw128_desc(ka, 16, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(sc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&q_empty[s]);

        // softmax over the full row: rows 16 warp + g (sc[4j], sc[4j + 1])
        // and + 8 (sc[4j + 2], sc[4j + 3]), keys 8j + 2 c4 and the next
        if (p.M < MP) {
#pragma unroll
          for (int jj = 0; jj < MP / 8; ++jj) {
            const int key = 8 * jj + 2 * c4;
            if (key >= p.M) sc[4 * jj] = sc[4 * jj + 2] = -CUDART_INF_F;
            if (key + 1 >= p.M) sc[4 * jj + 1] = sc[4 * jj + 3] = -CUDART_INF_F;
          }
        }
        float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
#pragma unroll
        for (int jj = 0; jj < MP / 8; ++jj) {
          m0 = fmaxf(m0, fmaxf(sc[4 * jj], sc[4 * jj + 1]));
          m1 = fmaxf(m1, fmaxf(sc[4 * jj + 2], sc[4 * jj + 3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {  // the four lanes of a row
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
        }
        const float c0 = m0 * p.score_scale, c1 = m1 * p.score_scale;
        float l0 = 0.f, l1 = 0.f;
#pragma unroll
        for (int jj = 0; jj < MP / 8; ++jj) {
          sc[4 * jj] = ex2(fmaf(sc[4 * jj], p.score_scale, -c0));
          sc[4 * jj + 1] = ex2(fmaf(sc[4 * jj + 1], p.score_scale, -c0));
          sc[4 * jj + 2] = ex2(fmaf(sc[4 * jj + 2], p.score_scale, -c1));
          sc[4 * jj + 3] = ex2(fmaf(sc[4 * jj + 3], p.score_scale, -c1));
          l0 += sc[4 * jj] + sc[4 * jj + 1];
          l1 += sc[4 * jj + 2] + sc[4 * jj + 3];
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          l0 += __shfl_xor_sync(0xffffffffu, l0, off);
          l1 += __shfl_xor_sync(0xffffffffu, l1, off);
        }
        const float r0 = 1.f / l0, r1 = 1.f / l1;
        // p in bfloat16, 16 keys a k step, in the A-operand layout
        uint32_t pa[MP / 4];
#pragma unroll
        for (int kc = 0; kc < MP / 16; ++kc) {
          pa[4 * kc] = pack_bf16(sc[8 * kc] * r0, sc[8 * kc + 1] * r0);
          pa[4 * kc + 1] = pack_bf16(sc[8 * kc + 2] * r1, sc[8 * kc + 3] * r1);
          pa[4 * kc + 2] = pack_bf16(sc[8 * kc + 4] * r0, sc[8 * kc + 5] * r0);
          pa[4 * kc + 3] = pack_bf16(sc[8 * kc + 6] * r1, sc[8 * kc + 7] * r1);
        }

        // O = P V: V [keys][DP] is MN-major; 16 keys (2048 bytes) a k step
        pin(pa);
        pin(oc);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < MP / 16; ++kc)
          Wgmma<DP>::rs(oc, pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2], pa[4 * kc + 3],
                        sw128_desc(smem_addr(vt) + kc * 2048, MP * 128, 1024), 1);
        wgmma_commit();
        wgmma_wait_all();
        pin(pa);
        pin(oc);
      } else {
        __syncwarp();
        if (lane == 0) mbar_arrive(&q_empty[s]);
      }

      // O to a swizzled tile, then one TMA store (rows past N, columns past
      // D clipped); the store of two tiles ago must have read this buffer
      uint8_t* ot = o_mine + (stored & 1) * kQBytes;
      if (tid == 0) tma_store_wait_read<1>();
      named_bar_sync(1 + wg, 128);
      const int r0 = 16 * warp + g;
#pragma unroll
      for (int jj = 0; jj < DP / 8; ++jj) {
        uint8_t* row = ot + jj / 8 * kSwizzleTile + r0 * 128 + c4 * 4;
        const int piece = ((jj % 8) ^ (r0 % 8)) * 16;  // rows r0 and r0 + 8 swizzle alike
        *reinterpret_cast<uint32_t*>(row + piece) = pack_bf16(oc[4 * jj], oc[4 * jj + 1]);
        *reinterpret_cast<uint32_t*>(row + 8 * 128 + piece) =
            pack_bf16(oc[4 * jj + 2], oc[4 * jj + 3]);
      }
      fence_async_shared();
      named_bar_sync(1 + wg, 128);
      if (tid == 0) {
#pragma unroll
        for (int c = 0; c < kBlocks; ++c) tma_store_4d(&to, ot + c * kSwizzleTile, 64 * c, h, n0, b);
        tma_store_commit();
      }
      ++stored;
    }
    // walk (and release) every K, V index of the run, so that the producer
    // never waits on a warpgroup that had no tile of that (batch, head)
    const int last = (t1 - 1) / p.tiles_per_bh - bh0;
    while (kvi < last) next_kv();
    if (lane == 0) mbar_arrive(&kv_empty[kvi % p.kvstages]);
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

// A bfloat16 [B, T, H, D] tensor with element strides st = (b, t, h), the
// last axis contiguous, as a 4-d map (D, H, T, B) whose box is 64 columns
// of `rows` tokens of one (batch, head), 128-byte swizzled. A stride of an
// axis of extent 1 is never stepped; it gets a value TMA accepts.
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* base, int B, int T, int H,
                int D, const int64_t* st, int rows) {
  const int64_t sh = H > 1 ? st[2] : D;
  const int64_t sn = T > 1 ? st[1] : sh * H;
  const int64_t sb = B > 1 ? st[0] : sn * T;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh * 2), static_cast<cuuint64_t>(sn * 2),
                                 static_cast<cuuint64_t>(sb * 2)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MP, int DP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int N, int M,
                 int H, int D, const int64_t* st, float scale, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -5;
  CUtensorMap tq, tk, tv, to;
  if (!tensor_map(encode, &tq, q, B, N, H, D, st, kTileRows) ||
      !tensor_map(encode, &tk, k, B, M, H, D, st + 3, MP) ||
      !tensor_map(encode, &tv, v, B, M, H, D, st + 6, MP) ||
      !tensor_map(encode, &to, o, B, N, H, D, st + 9, kTileRows))
    return -4;
  // the deepest rings that fit: two K, V stages and four q stages at D <= 64
  const size_t tile = kTileRows * DP * 2, kv = 2 * static_cast<size_t>(MP) * DP * 2;
  WgParams prm{};
  size_t smem = 0;
  for (int ks = kMaxKvStages; ks >= 1 && smem == 0; --ks)
    for (int qs = kMaxQStages; qs >= 2 && smem == 0; --qs) {
      const size_t need = 1024 + ks * kv + qs * tile + 2 * kConsumers * tile;
      if (need + 128 <= static_cast<size_t>(kMaxSmem)) {  // 128: the barriers
        smem = need;
        prm.qstages = qs;
        prm.kvstages = ks;
      }
    }
  if (smem == 0) return -2;
  auto kern = sr_attention_wgmma_kernel<MP, DP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  prm.N = N;
  prm.M = M;
  prm.H = H;
  prm.tiles_per_bh = (N + kTileRows - 1) / kTileRows;
  prm.total_tiles = B * H * prm.tiles_per_bh;
  // a power-of-two scale moves onto the float32 scores exactly
  int e = 0;
  const bool pow2 = std::frexp(scale, &e) == 0.5f;
  prm.q_scale = pow2 ? 0.f : scale;
  prm.score_scale = pow2 ? scale * kLog2e : kLog2e;
  const int grid = sms < prm.total_tiles ? sms : prm.total_tiles;
  kern<<<grid, kWgThreads, smem, stream>>>(tq, tk, tv, to, prm);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int dispatch_wgmma_m(const void* q, const void* k, const void* v, void* o, int B, int N, int M,
                     int H, int D, const int64_t* st, float scale, cudaStream_t stream) {
  if (M <= 64) return launch_wgmma<64, DP>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  if (M <= 128) return launch_wgmma<128, DP>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  if (M <= 256) return launch_wgmma<256, DP>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  return -2;
}

int dispatch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int N, int M,
                   int H, int D, const int64_t* st, float scale, cudaStream_t stream) {
  if (D <= 64) return dispatch_wgmma_m<64>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  if (D <= 128) return dispatch_wgmma_m<128>(q, k, v, o, B, N, M, H, D, st, scale, stream);
  return -1;
}

}  // namespace

// Launches on `stream`. q, o: [B, N, H, D]; k, v: [B, M, H, D]; `strides`
// holds the (batch, token, head) strides in elements of q, k, v, o in that
// order (12 values); the last axis of each is contiguous. kernel: 0 float32,
// 1 bfloat16 on mma.sync, 2 bfloat16 on wgmma (M <= 256; 16-byte aligned
// bases, strides of whole 16-byte pieces, D a multiple of 8). `scale` is
// 1/sqrt(D) already rounded to the dtype.
// Returns 0 on success, cudaGetLastError() otherwise, -1 when D > 128, -2
// when what a block stages exceeds the shared memory of an SM, -3 for an
// unknown kernel, -4 when TMA cannot describe a tensor, -5 when libcuda
// has no cuTensorMapEncodeTiled. Requires B * H <= 65535; the caller checks.
extern "C" int f3s_sr_attention(const void* q, const void* k, const void* v,
                                void* o, int kernel, int B, int N, int M, int H,
                                int D, const int64_t* strides, float scale,
                                void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 0) return dispatch_f32(q, k, v, o, B, N, M, H, D, strides, scale, s);
  if (kernel == 1) return dispatch_mma(q, k, v, o, B, N, M, H, D, strides, scale, s);
  if (kernel == 2) return dispatch_wgmma(q, k, v, o, B, N, M, H, D, strides, scale, s);
  return -3;
}
