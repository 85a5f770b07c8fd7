// Causal prefill attention against a contiguous cache, online softmax.
//
// Replaces the TPU kernel `_prefill_kernel` (paddle_tpu/kernels/
// decode_attention.py, launched by `flash_prefill`). There the grid
// (batch*head, q block, kv block) ran in order on one core and the softmax
// sum rode VMEM scratch from one kv grid step to the next; the kv index map
// sent query head h to kv head h // rep.
//
// Bound on the H100: at prompt lengths of a few hundred tokens the work is
// small on both axes (a 256-token 7B layer moves ~8 MB and does ~0.5 GFLOP);
// this first version computes on the CUDA cores in f32, so it is bound by
// its own f32 arithmetic, far above the data-sheet bound. Tensor-core
// (wgmma) tiles are later work.
//
// Design: one block per (batch*head, tile of 32 query rows); a loop inside
// the block walks the kv tiles (64 rows) through shared memory, which takes
// the place of the TPU's sequential kv grid axis. Each warp owns 8 query
// rows and keeps their online-softmax state (m, l) and f32 accumulators in
// registers. The block reads kv head h // rep (GQA unexpanded), stops at the
// last kv tile its rows can see (the causal diagonal shifted by
// cur_len - S), masks the ragged cache tail itself (any cache length T is
// taken, no fallback), applies the m_new <= -inf/2 -> 0 guard, and emits
// zeros for a row that sees no key (l == 0).
#include "common.cuh"

namespace ptt {

constexpr int FP_BQ = 32;       // query rows per block
constexpr int FP_BK = 64;       // kv rows per tile (2 per lane)
constexpr int FP_WARPS = 4;
constexpr int FP_RPW = FP_BQ / FP_WARPS;  // rows per warp
constexpr int FP_DPL = 4;       // head-dim elements per lane (D <= 128)

inline size_t fp_smem_bytes(int D) {
  return sizeof(float) * ((size_t)FP_BQ * D + (size_t)FP_BK * (D + 1) +
                          (size_t)FP_BK * D + (size_t)FP_BQ * FP_BK);
}

template <typename T>
__global__ void __launch_bounds__(FP_WARPS * 32)
    flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out, int S,
                         int Tk, int H, int Hkv, int D, int offset,
                         float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                     // [BQ][D]
  float* Ks = Qs + FP_BQ * D;           // [BK][D + 1]
  float* Vs = Ks + FP_BK * (D + 1);     // [BK][D]
  float* Ps = Vs + FP_BK * D;           // [BQ][BK]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / Hkv);
  const int q0 = blockIdx.x * FP_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int idx = threadIdx.x; idx < FP_BQ * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    const int qi = q0 + r;
    Qs[idx] = qi < S ? to_f(q[(((size_t)b * S + qi) * H + h) * D + d]) * scale
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
  const int kv_end = min(Tk, offset + q_last + 1);

  for (int j0 = 0; j0 < kv_end; j0 += FP_BK) {
    const int n = min(FP_BK, Tk - j0);
    __syncthreads();  // previous tile consumed (and the q tile stored)
    for (int idx = threadIdx.x; idx < n * D; idx += blockDim.x) {
      const int t = idx / D, d = idx - t * D;
      const size_t src = (((size_t)b * Tk + j0 + t) * Hkv + g) * D + d;
      Ks[t * (D + 1) + d] = to_f(k[src]);
      Vs[t * D + d] = to_f(v[src]);
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < FP_RPW; ++rr) {
      const int r = warp * FP_RPW + rr;
      const int qi = q0 + r;
      const int qpos = offset + qi;
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
    T* o = out + (((size_t)b * S + qi) * H + h) * D;
#pragma unroll
    for (int dd = 0; dd < FP_DPL; ++dd) {
      const int d = lane + 32 * dd;
      if (d < D) o[d] = from_f<T>(acc[rr][dd] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Tk, int H, int Hkv, int D, int offset, float scale,
           cudaStream_t stream) {
  const size_t smem = fp_smem_bytes(D);
  cudaFuncSetAttribute(flash_prefill_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((S + FP_BQ - 1) / FP_BQ, B * H);
  flash_prefill_kernel<T><<<grid, FP_WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, Tk, H, Hkv, D,
      offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace ptt

PTT_EXPORT int ptt_flash_prefill(int dtype, const void* q, const void* k,
                                 const void* v, void* out, int B, int S,
                                 int Tk, int H, int Hkv, int D, int offset,
                                 float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D > ptt::FP_DPL * 32) return (int)cudaErrorInvalidValue;
  if (dtype == ptt::DT_BF16)
    return ptt::launch<__nv_bfloat16>(q, k, v, out, B, S, Tk, H, Hkv, D,
                                      offset, scale, st);
  if (dtype == ptt::DT_F32)
    return ptt::launch<float>(q, k, v, out, B, S, Tk, H, Hkv, D, offset,
                              scale, st);
  return (int)cudaErrorInvalidValue;
}
