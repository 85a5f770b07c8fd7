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
// Design: one block per (batch*head, tile of 32 query rows) runs
// common.cuh's prefill_block: a loop inside the block walks the kv tiles
// (64 rows) through shared memory, which takes the place of the TPU's
// sequential kv grid axis. The block reads kv head h // rep (GQA
// unexpanded), stops at the last kv tile its rows can see (the causal
// diagonal shifted by cur_len - S), masks the ragged cache tail itself (any
// cache length T is taken, no fallback), applies the m_new <= -inf/2 -> 0
// guard, and emits zeros for a row that sees no key (l == 0).
#include "common.cuh"

namespace ptt {

// row index of kv row `pos` of a (B, T, Hkv, D) cache, for batch row b and
// kv head g
struct CacheRows {
  size_t row0;  // b * T
  int Hkv, g;
  __device__ size_t operator()(int pos) const {
    return (row0 + pos) * Hkv + g;
  }
};

template <typename T>
__global__ void __launch_bounds__(FP_WARPS * 32)
    flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out, int S,
                         int Tk, int H, int Hkv, int D, int offset,
                         float scale) {
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const CacheRows rows{(size_t)b * Tk, Hkv, h / (H / Hkv)};
  prefill_block(q, out, ((size_t)b * S * H + h) * D, (size_t)H * D, S,
                (int)blockIdx.x * FP_BQ, offset, Tk, k, v,
                (const float*)nullptr, (const float*)nullptr, rows, D, scale);
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
