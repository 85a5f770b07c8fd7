// Shared helpers for the port's Hopper kernels: element conversion, warp
// reductions, and the f32 causal prefill block routine that
// flash_prefill.cu and paged_chunk_attention.cu run for fp32 (bf16 runs
// prefill_mma.cuh's tensor-core routine; one-token decode attention is
// decode_split.cuh's). Every KV-reading routine is templated on the pool's
// storage type S: the activation type (a native pool) or int8_t (an int8
// pool, whose rows carry one f32 scale each, dequantized as they are
// read).
//
// Every entry point is a plain C function (loaded with ctypes): it takes
// raw device pointers and the caller's CUDA stream, launches, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define PTT_EXPORT extern "C" __attribute__((visibility("default")))

namespace ptt {

// dtype codes and KV pool codes shared with the Python wrappers
enum { DT_F32 = 0, DT_BF16 = 1 };
enum { KV_NATIVE = 0, KV_INT8 = 1 };

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename S>
__host__ __device__ constexpr bool is_int8_pool() {
  return std::is_same<S, int8_t>::value;
}

// Pool element `idx` of row `row` as f32: a native element converted; an
// int8 payload element times its row's f32 scale (the plain version's
// q.float() * scale, the TPU kernel's k * ks_ref). `scale` is unused for a
// native pool.
template <typename S>
__device__ __forceinline__ float kv_load(const S* p, const float* scale,
                                         size_t idx, size_t row) {
  if constexpr (is_int8_pool<S>()) return to_f(p[idx]) * scale[row];
  else return to_f(p[idx]);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Causal prefill attention in f32 on the CUDA cores (the fp32 route; bf16
// takes prefill_mma.cuh) for one (batch row, query head, tile of FP_BQ
// query rows), the work of one thread block of FP_WARPS warps. Query row i
// (0 <= i < S) of the head lies at q[row0 + i * row_stride .. + D) and sits
// at absolute position qpos0 + i; it sees every kv row at a position <= its
// own and below kv_len. `kv_row(pos)` is the row index of kv row `pos` of
// the block's kv head, the same in K and V (its elements start at row * D,
// an int8 pool's scale is ks/vs[row]): a contiguous cache, or a page found
// through the block table. A loop inside the block walks the kv
// rows in tiles of FP_BK through shared memory and stops at the last tile
// its rows can see; each warp owns FP_RPW query rows and keeps their online
// softmax (m, l) and f32 accumulators in registers. Shared memory (dynamic,
// fp_smem_bytes(D)):
//   Q [BQ][D]   K [BK][D + 1] (padded: conflict-free dots)   V [BK][D]
//   P [BQ][BK]
constexpr int FP_BQ = 32;       // query rows per block
constexpr int FP_BK = 64;       // kv rows per tile (2 per lane)
constexpr int FP_WARPS = 4;
constexpr int FP_RPW = FP_BQ / FP_WARPS;  // rows per warp
constexpr int FP_DPL = 4;       // head-dim elements per lane (D <= 128)

inline size_t fp_smem_bytes(int D) {
  return sizeof(float) * ((size_t)FP_BQ * D + (size_t)FP_BK * (D + 1) +
                          (size_t)FP_BK * D + (size_t)FP_BQ * FP_BK);
}

template <typename T, typename KS, typename KvRow>
__device__ inline void prefill_block(const T* __restrict__ q,
                                     T* __restrict__ out, size_t row0,
                                     size_t row_stride, int S, int q0,
                                     int qpos0, int kv_len,
                                     const KS* __restrict__ k,
                                     const KS* __restrict__ v,
                                     const float* __restrict__ ks,
                                     const float* __restrict__ vs,
                                     const KvRow& kv_row, int D,
                                     float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                     // [BQ][D]
  float* Ks = Qs + FP_BQ * D;           // [BK][D + 1]
  float* Vs = Ks + FP_BK * (D + 1);     // [BK][D]
  float* Ps = Vs + FP_BK * D;           // [BQ][BK]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int idx = threadIdx.x; idx < FP_BQ * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    const int qi = q0 + r;
    Qs[idx] = qi < S ? to_f(q[row0 + (size_t)qi * row_stride + d]) * scale
                     : 0.f;
  }

  float m[FP_RPW], l[FP_RPW], acc[FP_RPW][FP_DPL];
#pragma unroll
  for (int rr = 0; rr < FP_RPW; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int dd = 0; dd < FP_DPL; ++dd) acc[rr][dd] = 0.f;
  }

  // kv rows this block can see: up to the last valid row's position
  const int q_last = min(q0 + FP_BQ, S) - 1;
  const int kv_end = min(kv_len, qpos0 + q_last + 1);

  for (int j0 = 0; j0 < kv_end; j0 += FP_BK) {
    const int n = min(FP_BK, kv_len - j0);
    __syncthreads();  // previous tile consumed (and the q tile stored)
    for (int idx = threadIdx.x; idx < n * D; idx += blockDim.x) {
      const int t = idx / D, d = idx - t * D;
      const size_t r = kv_row(j0 + t);
      Ks[t * (D + 1) + d] = kv_load(k, ks, r * D + d, r);
      Vs[t * D + d] = kv_load(v, vs, r * D + d, r);
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < FP_RPW; ++rr) {
      const int r = warp * FP_RPW + rr;
      const int qi = q0 + r;
      const int qpos = qpos0 + qi;
      const float* qr = Qs + r * D;
      float s0 = NEG_INF, s1 = NEG_INF;
      const int c0 = lane, c1 = lane + 32;
      if (qi < S) {
        if (c0 < n && j0 + c0 <= qpos) {
          const float* kr = Ks + c0 * (D + 1);
          float a = 0.f;
          for (int d = 0; d < D; ++d) a += qr[d] * kr[d];
          s0 = a;
        }
        if (c1 < n && j0 + c1 <= qpos) {
          const float* kr = Ks + c1 * (D + 1);
          float a = 0.f;
          for (int d = 0; d < D; ++d) a += qr[d] * kr[d];
          s1 = a;
        }
      }
      const float mx = warp_max(fmaxf(s0, s1));
      float m_new = fmaxf(m[rr], mx);
      if (m_new <= NEG_INF / 2) m_new = 0.f;
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float alpha = expf(m[rr] - m_new);
      l[rr] = alpha * l[rr] + warp_sum(p0 + p1);
      m[rr] = m_new;
      Ps[r * FP_BK + c0] = p0;
      Ps[r * FP_BK + c1] = p1;
      __syncwarp();
      const float* pr = Ps + r * FP_BK;
#pragma unroll
      for (int dd = 0; dd < FP_DPL; ++dd) {
        const int d = lane + 32 * dd;
        if (d < D) {
          float a = acc[rr][dd] * alpha;
          for (int t = 0; t < n; ++t) a += pr[t] * Vs[t * D + d];
          acc[rr][dd] = a;
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int rr = 0; rr < FP_RPW; ++rr) {
    const int qi = q0 + warp * FP_RPW + rr;
    if (qi >= S) continue;
    const float inv = 1.f / (l[rr] == 0.f ? 1.f : l[rr]);
    T* o = out + row0 + (size_t)qi * row_stride;
#pragma unroll
    for (int dd = 0; dd < FP_DPL; ++dd) {
      const int d = lane + 32 * dd;
      if (d < D) o[d] = from_f<T>(acc[rr][dd] * inv);
    }
  }
}

}  // namespace ptt
