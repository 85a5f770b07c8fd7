// Causal prefill attention against a contiguous cache, online softmax.
//
// Replaces the TPU kernel `_prefill_kernel` (paddle_tpu/kernels/
// decode_attention.py, launched by `flash_prefill`). There the grid
// (batch*head, q block, kv block) ran in order on one core and the softmax
// sum rode VMEM scratch from one kv grid step to the next; the kv index map
// sent query head h to kv head h // rep.
//
// Bound on the H100: bytes, at prompt lengths of a few hundred tokens: a
// 256-token layer at Llama-2-7B heads moves ≈ 8 MB (0.0025 ms at 3.35
// TB/s) and does ≈ 0.5 GFLOP.
//
// Design: one block per (batch*head, tile of 128 query rows) runs
// prefill_mma.cuh's tensor-core routine for bf16 (fp32 keeps common.cuh's
// f32 prefill_block): a loop inside the block walks the kv tiles (128 rows)
// through shared memory, which takes the place of the TPU's sequential kv
// grid axis. The block reads kv head h // rep (GQA unexpanded), stops at
// the last kv tile its rows can see (the causal diagonal shifted by
// cur_len - S), masks the ragged cache tail itself (any cache length T is
// taken, no fallback), applies the m_new <= -inf/2 -> 0 guard, and emits
// zeros for a row that sees no key (l == 0). Measured (chip_smoke.py,
// NVIDIA H100 80GB HBM3, 700 W): 0.021-0.034 ms at S = 256, against
// SDPA's 0.023-0.035 in the same runs; at this size a call is a few tiles
// a block, and launch and host time hold both.
#include "prefill_mma.cuh"

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

// DP: the padded head dim of the bf16 (tensor-core) route, 0 for fp32 (at
// most 128 registers a thread)
template <typename T, int DP>
__global__ void __launch_bounds__(DP == 0 ? FP_WARPS * 32 : PM_THREADS,
                                  DP == 0 ? 4 : PM_BLOCKS_PER_SM)
    flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out, int S,
                         int Tk, int H, int Hkv, int D, int offset,
                         float scale, int qunit, int kvunit,
                         float* __restrict__ po, float* __restrict__ pml) {
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const CacheRows rows{(size_t)b * Tk, Hkv, h / (H / Hkv)};
  if constexpr (DP == 0)
    prefill_block(q, out, ((size_t)b * S * H + h) * D, (size_t)H * D, S,
                  (int)blockIdx.x * FP_BQ, offset, Tk, k, v,
                  (const float*)nullptr, (const float*)nullptr, rows, D,
                  scale);
  else
    prefill_mma<DP>(q, out, (size_t)b * S * H + h, (size_t)H, S,
                    (int)blockIdx.x * PM_BQ, offset, Tk, k, v,
                    (const float*)nullptr, (const float*)nullptr, rows, D,
                    scale, qunit, kvunit, (int)blockIdx.z, (int)gridDim.z, po,
                    pml, (size_t)gridDim.y * S);
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Tk, int H, int Hkv, int D, int offset, int nsplit,
           float* po, float* pml, float scale, cudaStream_t stream) {
  const size_t smem = DP == 0 ? fp_smem_bytes(D) : pm_smem_bytes<DP, false>();
  const int bq = DP == 0 ? FP_BQ : PM_BQ;
  const size_t row = (size_t)D * sizeof(T);
  const int qunit = std::min(copy_unit(q, row), copy_unit(out, row));
  const int kvunit = std::min(copy_unit(k, row), copy_unit(v, row));
  cudaFuncSetAttribute(flash_prefill_kernel<T, DP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((S + bq - 1) / bq, B * H, nsplit);
  const int threads = DP == 0 ? FP_WARPS * 32 : PM_THREADS;
  flash_prefill_kernel<T, DP><<<grid, threads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, Tk, H, Hkv, D,
      offset, scale, qunit, kvunit, po, pml);
  if (nsplit > 1) {
    const size_t nrows = (size_t)B * S * H;
    const unsigned blocks = (unsigned)((nrows + 3) / 4);
    prefill_combine_kernel<T><<<blocks, 128, 0, stream>>>(
        po, pml, (T*)out, nrows, D, nsplit);
  }
  return (int)cudaGetLastError();
}

// the route by type: fp32 on the CUDA cores, bf16 on the tensor cores at
// the head dim padded to 32, 64, 96 or 128
template <typename T>
int launch_dt(const void* q, const void* k, const void* v, void* out, int B,
              int S, int Tk, int H, int Hkv, int D, int offset, int nsplit,
              float* po, float* pml, float scale, cudaStream_t stream) {
#define PTT_PREFILL_LAUNCH(DP, NS)                                           \
  launch<T, DP>(q, k, v, out, B, S, Tk, H, Hkv, D, offset, NS, po, pml,      \
                scale, stream)
  if constexpr (std::is_same<T, float>::value)
    return PTT_PREFILL_LAUNCH(0, 1);
  else switch (padded_head_dim(D)) {
    case 32: return PTT_PREFILL_LAUNCH(32, nsplit);
    case 64: return PTT_PREFILL_LAUNCH(64, nsplit);
    case 96: return PTT_PREFILL_LAUNCH(96, nsplit);
    default: return PTT_PREFILL_LAUNCH(128, nsplit);
  }
#undef PTT_PREFILL_LAUNCH
}

}  // namespace ptt

// nsplit > 1 (bf16 only) splits each block's kv walk into that many parts,
// merged by a second kernel: po and pml are f32 scratch of
// nsplit * B * S * H * D and nsplit * B * S * H * 2 elements.
PTT_EXPORT int ptt_flash_prefill(int dtype, const void* q, const void* k,
                                 const void* v, void* out, void* po,
                                 void* pml, int B, int S, int Tk, int H,
                                 int Hkv, int D, int offset, int nsplit,
                                 float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D > ptt::FP_DPL * 32 || nsplit < 1) return (int)cudaErrorInvalidValue;
  if (dtype == ptt::DT_BF16)
    return ptt::launch_dt<__nv_bfloat16>(q, k, v, out, B, S, Tk, H, Hkv, D,
                                         offset, nsplit, (float*)po,
                                         (float*)pml, scale, st);
  if (dtype == ptt::DT_F32)
    return ptt::launch_dt<float>(q, k, v, out, B, S, Tk, H, Hkv, D, offset,
                                 1, nullptr, nullptr, scale, st);
  return (int)cudaErrorInvalidValue;
}
