// Sliding-window (neighbourhood) attention on an image grid: every query
// attends to the window x window keys around it, masked at the image
// borders (a corner query sees only its in-image neighbours; the window is
// not shifted).
//
// Replaces the TPU kernel fusion3dseg_tpu/ops/attention.py `_nat_kernel`
// (Pallas, reached through `neighborhood_attention`). For q, k, v
// [B, N = height * width, H, D] of type T (bfloat16 or float32), per query:
//   qs = T(float(q) * scale)             scale = T(1 / sqrt(D)), given
//   for dy, dx over the window, rows outer:
//     s = sum_d qs_d * k_d(neighbour)    float32; -inf outside the image
//     m' = max(m, s)
//     c = (m == -inf) ? 0 : exp(m - m')
//     p = (s == -inf) ? 0 : exp(s - m')
//     l = l * c + p;  acc = acc * c + p * v(neighbour);  m = m'
//   o = T(acc / max(l, 1e-30))
// which is the TPU kernel's online softmax, guards included, all in
// float32; only q's scaling and the output round to T.
//
// Bound on an H100 (SXM): bytes. The function reads q, k, v and writes o
// once (4 * B*N*H*D elements) and does 4 * window^2 * D operations per
// query, far below the tensor cores' bfloat16 rate. This first design does
// the products as float32 FMAs on the CUDA cores (about 12.5k per query at
// window 7, D = 64), so its own floor is the 67 TFLOP/s float32 rate, above
// the byte bound; tensor-core products are later work.
//
// Design: a block owns an 8 x 8 tile of queries of one (batch, head) and
// stages the (8 + 2r)^2 halo of K and V in shared memory once (zeros
// outside the image, never read as values because the coordinates mask
// them), so each K/V element is read from L2 about (1 + 2r/8)^2 times
// instead of window^2 times. Four adjacent lanes share a query, each with
// a quarter of D in registers (q chunk and accumulator); a score is a
// quarter dot product plus two shuffles. No padded K/V copy in device
// memory, no [B*H, N, D] transposes (strides are read directly), and no
// height % tile requirement: a ragged tile computes on zeros and does not
// store.

#include "attention_common.cuh"

namespace {

using namespace f3s;

constexpr int kTile = 8;                          // queries per tile side
constexpr int kThreads = kTile * kTile * kLanes;  // 256

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
nat_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           int height, int width, int window, int H, int D, int tiles_x,
           Strides sq, Strides sk, Strides sv, Strides so, float scale) {
  constexpr int Dp = DPL * kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = window / 2;
  const int halo = kTile + 2 * r;  // halo side, in positions
  T* ks = reinterpret_cast<T*>(smem);                         // [halo*halo][Dp]
  T* vs = ks + static_cast<size_t>(halo) * halo * Dp;         // [halo*halo][Dp]

  const int tid = threadIdx.x;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;

  // stage the halo of K and V: kThreads / Dp positions per step
  {
    const T* kb = k + b * sk.b + h * sk.h;
    const T* vb = v + b * sv.b + h * sv.h;
    const int d = tid % Dp;
    const T zero = from_f32<T>(0.f);
    for (int pos = tid / Dp; pos < halo * halo; pos += kThreads / Dp) {
      const int gy = ty0 - r + pos / halo;
      const int gx = tx0 - r + pos % halo;
      const bool in = gy >= 0 && gy < height && gx >= 0 && gx < width && d < D;
      const int64_t tok = static_cast<int64_t>(gy) * width + gx;
      ks[pos * Dp + d] = in ? kb[tok * sk.n + d] : zero;
      vs[pos * Dp + d] = in ? vb[tok * sv.n + d] : zero;
    }
  }
  __syncthreads();

  const int lane = tid % kLanes;
  const int qi = tid / kLanes;
  const int ly = qi / kTile, lx = qi % kTile;  // a warp holds one tile row
  const int qy = ty0 + ly, qx = tx0 + lx;
  const bool live = qy < height && qx < width;
  const int64_t tok = live ? static_cast<int64_t>(qy) * width + qx : 0;
  const int d0 = lane * DPL;

  float qr[DPL];
  {
    const T* qp = q + b * sq.b + tok * sq.n + h * sq.h;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = d0 + i;
      qr[i] = (live && d < D) ? round_to<T>(to_f32<T>(qp[d]) * scale) : 0.f;
    }
  }

  float m = -CUDART_INF_F, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int dy = 0; dy < window; ++dy) {
    const int ny = qy + dy - r;
    const bool yok = ny >= 0 && ny < height;
    for (int dx = 0; dx < window; ++dx) {
      const int nx = qx + dx - r;
      const bool ok = yok && nx >= 0 && nx < width;
      const int pos = (ly + dy) * halo + (lx + dx);
      float kr[DPL], vr[DPL];
      load_chunk<T, DPL>(ks + pos * Dp + d0, kr);
      load_chunk<T, DPL>(vs + pos * Dp + d0, vr);
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
    T* op = o + b * so.b + tok * so.n + h * so.h;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = d0 + i;
      if (d < D) op[d] = from_f32<T>(acc[i] / den);
    }
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int height, int width, int window, int H, int D, const int64_t* st,
           float scale, cudaStream_t stream) {
  constexpr int Dp = DPL * kLanes;
  const int halo = kTile + 2 * (window / 2);
  const size_t smem = 2 * static_cast<size_t>(halo) * halo * Dp * sizeof(T);
  if (smem > static_cast<size_t>(kMaxSmem)) return -2;
  auto kern = nat_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_x = (width + kTile - 1) / kTile;
  const int tiles_y = (height + kTile - 1) / kTile;
  const dim3 grid(tiles_x * tiles_y, B * H);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]};
  const Strides sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), height, width, window, H, D, tiles_x, sq, sk, sv, so, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int height, int width, int window, int H, int D, const int64_t* st,
             float scale, cudaStream_t stream) {
#define F3S_NAT_LAUNCH(DPL) \
  return launch<T, DPL>(q, k, v, o, B, height, width, window, H, D, st, scale, stream)
  if (D <= 8) F3S_NAT_LAUNCH(2);
  if (D <= 16) F3S_NAT_LAUNCH(4);
  if (D <= 32) F3S_NAT_LAUNCH(8);
  if (D <= 64) F3S_NAT_LAUNCH(16);
  if (D <= 128) F3S_NAT_LAUNCH(32);
#undef F3S_NAT_LAUNCH
  return -1;
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
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, height, width, window, H, D, strides, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, height, width, window, H, D, strides, scale, s);
  return -3;
}
