// Fused RMSNorm: the forward (y and the saved r) and the backward dx, for
// rows of any width and any number of rows.
//
// Replaces the TPU kernels of paddle_tpu/kernels/rms_norm.py, both launched
// through `_row_call` over blocks of up to 256 rows that stay resident in
// VMEM for their two passes:
//   forward  `_fwd_kernel`: r = rsqrt(mean(x^2) + eps), y = x * r * w,
//            r saved as one f32 a row;
//   backward `_bwd_kernel`: dx = r * g*w - x * r^3 * (sum(g*w*x) / H).
// dw = sum over rows of g * x * r stays a PyTorch reduction, as it stayed
// an XLA einsum outside the Pallas kernel.
//
// Bound on the H100: bytes. The forward reads x once and writes y (and 4
// bytes of r) a row, the backward reads x and g and writes dx; the weight
// is read once for all rows. At 8192 rows x 4096 in bf16 that is 134 MB
// forward (0.040 ms at 3.35 TB/s) and 201 MB backward (0.060 ms); a few
// flops an element are far below any compute bound.
//
// Design: a row is the work of one warp when H <= 1024 (8 rows a 256-thread
// block) and of one 256-thread block otherwise, so any width runs (the TPU
// path gave up above H = 32768, where even 8 rows overflowed VMEM, and ran
// the XLA composition) and any row count (the TPU path padded the rows to
// its row block). A thread loads 16 bytes at a time (8 bf16 or 4 f32) when
// the row's bytes and the pointers allow it, else one element. Pass 1 sums
// x^2 (forward) or g*w*x (backward) in f32: each thread over its elements in
// a fixed order, then a warp shuffle tree, then, for a block row, the 8 warp
// sums from shared memory in a fixed order, so results repeat bit for bit.
// Pass 2 re-reads the row (a 7B row of 8 KB stays in L1/L2) and writes y or
// dx, computed in f32 in the TPU kernel's operation order and rounded once
// to the activation type.
#include <initializer_list>

#include "common.cuh"

namespace ptt {

constexpr int RN_THREADS = 256;
constexpr int RN_WARP_MAX_H = 1024;   // widths up to this: a warp a row

template <typename T, int V>
struct alignas(sizeof(T) * V) RnVec {
  T v[V];
};

// V consecutive elements at p as f32 (one 16-byte load when V > 1)
template <typename T, int V>
__device__ __forceinline__ void rn_load(const T* __restrict__ p,
                                        float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f(p[0]);
  } else {
    const RnVec<T, V> x = *reinterpret_cast<const RnVec<T, V>*>(p);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f(x.v[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void rn_store(T* __restrict__ p,
                                         const float (&f)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f<T>(f[0]);
  } else {
    RnVec<T, V> x;
#pragma unroll
    for (int i = 0; i < V; ++i) x.v[i] = from_f<T>(f[i]);
    *reinterpret_cast<RnVec<T, V>*>(p) = x;
  }
}

// The sum of one value a thread over the TPR threads of a row (a warp, or
// the whole block through `red`), the same on every thread and in a fixed
// order. Called once a kernel.
template <int TPR>
__device__ __forceinline__ float rn_row_sum(float v, float* red) {
  v = warp_sum(v);
  if constexpr (TPR == 32) {
    return v;
  } else {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < TPR / 32; ++w) s += red[w];
    return s;
  }
}

// T: activation type; V: elements a load; TPR: threads a row (32 or 256)
template <typename T, int V, int TPR>
__global__ void __launch_bounds__(RN_THREADS)
    rms_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        T* __restrict__ y, float* __restrict__ r, int N,
                        int H, float eps) {
  __shared__ float red[RN_THREADS / 32];
  constexpr int RPB = RN_THREADS / TPR;
  const int lane = threadIdx.x % TPR;
  const int row = blockIdx.x * RPB + threadIdx.x / TPR;
  if (row >= N) return;  // only a warp-per-row block has a ragged end
  const T* xr = x + (size_t)row * H;
  float ss = 0.f;
  for (int c = lane * V; c < H; c += TPR * V) {
    float f[V];
    rn_load<T, V>(xr + c, f);
#pragma unroll
    for (int i = 0; i < V; ++i) ss = fmaf(f[i], f[i], ss);
  }
  ss = rn_row_sum<TPR>(ss, red);
  const float rr = rsqrtf(ss / (float)H + eps);
  T* yr = y + (size_t)row * H;
  for (int c = lane * V; c < H; c += TPR * V) {
    float f[V], wf[V];
    rn_load<T, V>(xr + c, f);
    rn_load<T, V>(w + c, wf);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = f[i] * rr * wf[i];
    rn_store<T, V>(yr + c, f);
  }
  if (lane == 0) r[row] = rr;
}

template <typename T, int V, int TPR>
__global__ void __launch_bounds__(RN_THREADS)
    rms_norm_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const T* __restrict__ g,
                           const float* __restrict__ r, T* __restrict__ dx,
                           int N, int H) {
  __shared__ float red[RN_THREADS / 32];
  constexpr int RPB = RN_THREADS / TPR;
  const int lane = threadIdx.x % TPR;
  const int row = blockIdx.x * RPB + threadIdx.x / TPR;
  if (row >= N) return;
  const size_t base = (size_t)row * H;
  float dot = 0.f;
  for (int c = lane * V; c < H; c += TPR * V) {
    float xf[V], gf[V], wf[V];
    rn_load<T, V>(x + base + c, xf);
    rn_load<T, V>(g + base + c, gf);
    rn_load<T, V>(w + c, wf);
#pragma unroll
    for (int i = 0; i < V; ++i) dot = fmaf(gf[i] * wf[i], xf[i], dot);
  }
  dot = rn_row_sum<TPR>(dot, red);
  const float rr = r[row];
  const float r3 = rr * rr * rr;
  const float c_dot = dot / (float)H;
  for (int c = lane * V; c < H; c += TPR * V) {
    float xf[V], gf[V], wf[V];
    rn_load<T, V>(x + base + c, xf);
    rn_load<T, V>(g + base + c, gf);
    rn_load<T, V>(w + c, wf);
#pragma unroll
    for (int i = 0; i < V; ++i)
      xf[i] = rr * (gf[i] * wf[i]) - xf[i] * r3 * c_dot;
    rn_store<T, V>(dx + base + c, xf);
  }
}

// 16-byte loads when every row starts 16-byte aligned
template <typename T>
bool rn_vector_ok(int H, std::initializer_list<const void*> ptrs) {
  if ((H * sizeof(T)) % 16) return false;
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16) return false;
  return true;
}

template <typename T, int V>
int rn_fwd(const void* x, const void* w, void* y, void* r, int N, int H,
           float eps, cudaStream_t st) {
  if (H <= RN_WARP_MAX_H) {
    constexpr int RPB = RN_THREADS / 32;
    rms_norm_fwd_kernel<T, V, 32><<<(N + RPB - 1) / RPB, RN_THREADS, 0, st>>>(
        (const T*)x, (const T*)w, (T*)y, (float*)r, N, H, eps);
  } else {
    rms_norm_fwd_kernel<T, V, RN_THREADS><<<N, RN_THREADS, 0, st>>>(
        (const T*)x, (const T*)w, (T*)y, (float*)r, N, H, eps);
  }
  return (int)cudaGetLastError();
}

template <typename T, int V>
int rn_bwd_dx(const void* x, const void* w, const void* g, const void* r,
              void* dx, int N, int H, cudaStream_t st) {
  if (H <= RN_WARP_MAX_H) {
    constexpr int RPB = RN_THREADS / 32;
    rms_norm_bwd_dx_kernel<T, V, 32>
        <<<(N + RPB - 1) / RPB, RN_THREADS, 0, st>>>(
            (const T*)x, (const T*)w, (const T*)g, (const float*)r, (T*)dx,
            N, H);
  } else {
    rms_norm_bwd_dx_kernel<T, V, RN_THREADS><<<N, RN_THREADS, 0, st>>>(
        (const T*)x, (const T*)w, (const T*)g, (const float*)r, (T*)dx, N,
        H);
  }
  return (int)cudaGetLastError();
}

}  // namespace ptt

PTT_EXPORT int ptt_rms_norm_fwd(int dtype, const void* x, const void* w,
                                void* y, void* r, int N, int H, float eps,
                                void* stream) {
  if (N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ptt::DT_F32) {
    if (ptt::rn_vector_ok<float>(H, {x, w, y}))
      return ptt::rn_fwd<float, 4>(x, w, y, r, N, H, eps, st);
    return ptt::rn_fwd<float, 1>(x, w, y, r, N, H, eps, st);
  }
  if (dtype == ptt::DT_BF16) {
    if (ptt::rn_vector_ok<__nv_bfloat16>(H, {x, w, y}))
      return ptt::rn_fwd<__nv_bfloat16, 8>(x, w, y, r, N, H, eps, st);
    return ptt::rn_fwd<__nv_bfloat16, 1>(x, w, y, r, N, H, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}

PTT_EXPORT int ptt_rms_norm_bwd_dx(int dtype, const void* x, const void* w,
                                   const void* g, const void* r, void* dx,
                                   int N, int H, void* stream) {
  if (N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ptt::DT_F32) {
    if (ptt::rn_vector_ok<float>(H, {x, w, g, dx}))
      return ptt::rn_bwd_dx<float, 4>(x, w, g, r, dx, N, H, st);
    return ptt::rn_bwd_dx<float, 1>(x, w, g, r, dx, N, H, st);
  }
  if (dtype == ptt::DT_BF16) {
    if (ptt::rn_vector_ok<__nv_bfloat16>(H, {x, w, g, dx}))
      return ptt::rn_bwd_dx<__nv_bfloat16, 8>(x, w, g, r, dx, N, H, st);
    return ptt::rn_bwd_dx<__nv_bfloat16, 1>(x, w, g, r, dx, N, H, st);
  }
  return (int)cudaErrorInvalidValue;
}
