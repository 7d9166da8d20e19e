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
// few percent of that) and its 4*N*M*D operations per (batch, head) are far
// below the tensor cores' bfloat16 rate.
//
// Two kernels, chosen by the element type. Both stage K and V of one
// (batch, head) in shared memory once per block (zero-padded, so inner loops
// are unmasked), read q, k, v, o through their [B, tokens, H, D] strides (no
// [B*H, N, D] transposed copies) and take any N (a ragged block computes on
// zeros and does not store).
//
// * bfloat16 (the segmenter's type): both products on the tensor cores with
//   mma.sync m16n8k16, eight warps of 16 query rows a block; see
//   `sr_attention_mma_kernel`. wgmma and TMA are later work.
// * float32: FMAs on the CUDA cores (TF32 tensor-core products would not
//   hold the 1e-4 agreement asked of float32). A block owns 32 queries; four
//   adjacent lanes share a query, each holding a quarter of D in registers,
//   so a score is a quarter dot product plus two shuffles. The block's
//   scores live in shared memory ([32][S] float32, S padded to 4 mod 8
//   words against bank conflicts): row max, then sum, then normalise.

#include "attention_common.cuh"

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

// ---- bfloat16: both products on the tensor cores (mma.sync m16n8k16)

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
  {
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
      return (row < N && d < D)
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
  for (int key0 = 0; key0 < Mp; key0 += 16) {
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
  for (int key0 = 0; key0 < Mp; key0 += 16) {
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

}  // namespace

// Launches on `stream`. q, o: [B, N, H, D]; k, v: [B, M, H, D]; `strides`
// holds the (batch, token, head) strides in elements of q, k, v, o in that
// order (12 values); the last axis of each is contiguous. dtype: 0 float32,
// 1 bfloat16. `scale` is 1/sqrt(D) already rounded to the dtype.
// Returns 0 on success, cudaGetLastError() otherwise, -1 when D > 128, -2
// when what a block stages exceeds the shared memory of an SM,
// -3 for an unknown dtype. Requires B * H <= 65535; the caller checks.
extern "C" int f3s_sr_attention(const void* q, const void* k, const void* v,
                                void* o, int dtype, int B, int N, int M, int H,
                                int D, const int64_t* strides, float scale,
                                void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(q, k, v, o, B, N, M, H, D, strides, scale, s);
  if (dtype == 1) return dispatch_mma(q, k, v, o, B, N, M, H, D, strides, scale, s);
  return -3;
}
