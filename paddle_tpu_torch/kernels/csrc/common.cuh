// Shared helpers for the port's Hopper kernels: element conversion, warp
// reductions, the one-token decode-attention tile routine that
// paged_attention.cu and the fused block decode kernels run, and the f32
// causal prefill block routine that flash_prefill.cu and
// paged_chunk_attention.cu run for fp32 (bf16 runs prefill_mma.cuh's
// tensor-core routine). Every KV-reading routine is templated on the pool's storage type S:
// the activation type (a native pool) or int8_t (an int8 pool, whose rows
// carry one f32 scale each, dequantized as they enter shared memory).
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
// One-token decode attention for one (batch row, kv head) pair, the work of
// one thread block. The block's `rep` query heads share every key/value row
// it streams (GQA reads the pool unexpanded). State lives in shared memory:
//   q   [rep][D]        query rows, pre-multiplied by the softmax scale
//   k   [tile][D + 1]   current key tile (padded row: conflict-free dots)
//   v   [tile][D]       current value tile
//   s   [rep][tile]     scores, then probabilities
//   acc [rep][D]        f32 output accumulator
//   m, l, alpha [rep]   online-softmax running max, sum and rescale factor
struct DecodeSmem {
  float *q, *k, *v, *s, *acc, *m, *l, *alpha;
};

__host__ __device__ inline size_t decode_smem_floats(int rep, int D,
                                                     int tile) {
  return (size_t)rep * D + (size_t)tile * (D + 1) + (size_t)tile * D +
         (size_t)rep * tile + (size_t)rep * D + 3 * (size_t)rep;
}

__device__ inline DecodeSmem decode_smem_carve(float* base, int rep, int D,
                                               int tile) {
  DecodeSmem sm;
  sm.q = base;
  sm.k = sm.q + rep * D;
  sm.v = sm.k + tile * (D + 1);
  sm.s = sm.v + tile * D;
  sm.acc = sm.s + rep * tile;
  sm.m = sm.acc + rep * D;
  sm.l = sm.m + rep;
  sm.alpha = sm.l + rep;
  return sm;
}

// Load `n` consecutive (key, value) rows of width D into the tile; an int8
// pool's rows with their scales ks/vs (one per row).
template <typename S>
__device__ inline void decode_load_rows(const DecodeSmem& sm, const S* k,
                                        const S* v, const float* ks,
                                        const float* vs, int n, int D) {
  __syncthreads();  // the previous tile's readers are done
  for (int idx = threadIdx.x; idx < n * D; idx += blockDim.x) {
    int t = idx / D, d = idx - t * D;
    sm.k[t * (D + 1) + d] = kv_load(k, ks, idx, t);
    sm.v[t * D + d] = kv_load(v, vs, idx, t);
  }
  __syncthreads();
}

// Fold the first `n_valid` rows of the loaded tile into the online softmax.
__device__ inline void decode_tile(const DecodeSmem& sm, int rep, int D,
                                   int tile, int n_valid) {
  for (int idx = threadIdx.x; idx < rep * tile; idx += blockDim.x) {
    int h = idx / tile, t = idx - h * tile;
    float s = NEG_INF;
    if (t < n_valid) {
      const float* qh = sm.q + h * D;
      const float* kt = sm.k + t * (D + 1);
      float a = 0.f;
      for (int d = 0; d < D; ++d) a += qh[d] * kt[d];
      s = a;
    }
    sm.s[idx] = s;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int h = warp; h < rep; h += nw) {
    float* sh = sm.s + h * tile;
    float mx = NEG_INF;
    for (int t = lane; t < tile; t += 32) mx = fmaxf(mx, sh[t]);
    mx = warp_max(mx);
    const float m_prev = sm.m[h];
    float m_new = fmaxf(m_prev, mx);
    if (m_new <= NEG_INF / 2) m_new = 0.f;  // fully masked so far
    float sum = 0.f;
    for (int t = lane; t < tile; t += 32) {
      float p = expf(sh[t] - m_new);
      sh[t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    const float alpha = expf(m_prev - m_new);
    __syncwarp();
    if (lane == 0) {
      sm.m[h] = m_new;
      sm.l[h] = alpha * sm.l[h] + sum;
      sm.alpha[h] = alpha;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rep * D; idx += blockDim.x) {
    int h = idx / D, d = idx - h * D;
    const float* ph = sm.s + h * tile;
    float a = sm.acc[idx] * sm.alpha[h];
    for (int t = 0; t < n_valid; ++t) a += ph[t] * sm.v[t * D + d];
    sm.acc[idx] = a;
  }
  __syncthreads();
}

// Initialise q (scaled), the accumulator and the softmax state.
template <typename TQ>
__device__ inline void decode_init(const DecodeSmem& sm, const TQ* q, int rep,
                                   int D, float scale) {
  for (int idx = threadIdx.x; idx < rep * D; idx += blockDim.x) {
    sm.q[idx] = to_f(q[idx]) * scale;
    sm.acc[idx] = 0.f;
  }
  for (int h = threadIdx.x; h < rep; h += blockDim.x) {
    sm.m[h] = NEG_INF;
    sm.l[h] = 0.f;
    sm.alpha[h] = 1.f;
  }
  __syncthreads();
}

// Stream the first `len` tokens of one sequence's pages (kv head g); for an
// int8 pool ks/vs are its (Hkv, P, page) row scales, else unused.
template <typename S>
__device__ inline void decode_pages(const DecodeSmem& sm, const S* kp,
                                    const S* vp, const float* ks,
                                    const float* vs, const int* bt_row,
                                    int len, int g, int num_pages, int page,
                                    int maxp, int rep, int D) {
  int n_pages = (len + page - 1) / page;
  if (n_pages > maxp) n_pages = maxp;
  for (int j = 0; j < n_pages; ++j) {
    const size_t row = ((size_t)g * num_pages + bt_row[j]) * page;
    const int n_valid = min(page, len - j * page);
    if constexpr (is_int8_pool<S>())
      decode_load_rows(sm, kp + row * D, vp + row * D, ks + row, vs + row,
                       n_valid, D);
    else
      decode_load_rows(sm, kp + row * D, vp + row * D, ks, vs, n_valid, D);
    decode_tile(sm, rep, D, page, n_valid);
  }
}

// out[h][d] = acc / l (a row with no visible token emits zeros).
template <typename TO>
__device__ inline void decode_emit(const DecodeSmem& sm, TO* out, int rep,
                                   int D) {
  for (int idx = threadIdx.x; idx < rep * D; idx += blockDim.x) {
    const float l = sm.l[idx / D];
    out[idx] = from_f<TO>(sm.acc[idx] / (l == 0.f ? 1.f : l));
  }
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
