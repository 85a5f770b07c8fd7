// Chunked-prefill attention read through the block table (the paged pool).
//
// Replaces the TPU kernel `_paged_chunk_kernel` (paddle_tpu/kernels/
// paged_attention.py, launched by `paged_chunk_attention`). There the grid
// (batch, kv head, page) ran in order on one core: the block table and the
// chunk's start rode scalar prefetch into the kv index map, one pool page
// streamed through VMEM per grid step, and the rep * S query rows of a kv
// head (row r = rep head r // S, chunk token r % S) carried their online
// softmax in VMEM scratch across the page steps.
//
// Bound on the H100: bytes, by the data sheet. An S-token chunk at `start`
// reads the pool prefix of ceil((start + S) / page) pages once, plus q and
// out (≈ 63 MB for S = 256 at start 3328, Llama-2-7B heads, bf16: 0.019 ms
// at 3.35 TB/s), while its 4 * S * H * D * (start + S / 2) flops (≈ 14.5
// GFLOP) take 0.015 ms at the bf16 tensor-core rate. This first version
// computes on the CUDA cores in f32, as flash_prefill.cu does, so its own
// arithmetic bounds it far above either. Tensor-core tiles and cp.async
// are later work.
//
// Design: flash_prefill.cu's block routine (common.cuh's prefill_block) with
// K/V rows found through page ids and the causal diagonal moved by `start`.
// One block per (batch * query head, tile of 32 chunk rows) reads the
// block-table row and start[b] on the device (no host sync) and walks the
// kv positions 0 .. min(start + last row, max_pages * page - 1) in tiles of
// 64 rows, looking up each row's page itself, so no gathered (B, T, Hkv, D)
// view exists. The diagonal may fall mid-page (start % page != 0): the
// mask is by absolute position, kv_pos <= start + i. A padded final chunk
// can reach past the table: the walk stops at the table's width, as the
// TPU kernel clamps its page count; the pad rows still run and the caller
// drops them. Tiling over query rows (not rep * S rows a kv head) keeps
// shared memory fixed (≈ 90 KB at D = 128) for any S and any GQA ratio;
// GQA reads kv head h // rep of the unexpanded pool.
//
// int8 pools (the TPU kernel's `quant` branch): the payload and its per-row
// f32 scales arrive as four pointer parameters, and each element is
// dequantized (int8 -> f32, times its row's scale) as it enters the f32
// shared-memory tile, so the loop and everything after it are the native
// kernel's. The rows then cost D + 4 bytes instead of 2D (bf16).
#include "common.cuh"

namespace ptt {

// row index of kv row `pos` of one sequence in a (Hkv, P, page, D) pool,
// for kv head g
struct PagedRows {
  const int* bt_row;   // the sequence's block table row
  size_t g_base;       // g * num_pages
  int page;
  __device__ size_t operator()(int pos) const {
    const int j = pos / page;
    return (g_base + bt_row[j]) * page + (pos - j * page);
  }
};

// T: q/out type; S: pool storage (T, or int8_t with row scales ks/vs)
template <typename T, typename S>
__global__ void __launch_bounds__(FP_WARPS * 32)
    paged_chunk_kernel(const T* __restrict__ q, const S* __restrict__ kp,
                       const S* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ bt,
                       const int* __restrict__ start, T* __restrict__ out,
                       int Sq, int H, int Hkv, int D, int num_pages, int page,
                       int maxp, float scale) {
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / Hkv);
  const PagedRows rows{bt + (size_t)b * maxp, (size_t)g * num_pages, page};
  prefill_block(q, out, ((size_t)b * Sq * H + h) * D, (size_t)H * D, Sq,
                (int)blockIdx.x * FP_BQ, start[b], maxp * page, kp, vp, ks,
                vs, rows, D, scale);
}

template <typename T, typename S>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const int* bt, const int* start, void* out, int B,
           int Sq, int H, int Hkv, int D, int num_pages, int page, int maxp,
           float scale, cudaStream_t stream) {
  const size_t smem = fp_smem_bytes(D);
  cudaFuncSetAttribute(paged_chunk_kernel<T, S>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((Sq + FP_BQ - 1) / FP_BQ, B * H);
  paged_chunk_kernel<T, S><<<grid, FP_WARPS * 32, smem, stream>>>(
      (const T*)q, (const S*)kp, (const S*)vp, (const float*)ks,
      (const float*)vs, bt, start, (T*)out, Sq, H, Hkv, D, num_pages, page,
      maxp, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_kv(int kv, const void* q, const void* kp, const void* vp,
              const void* ks, const void* vs, const int* bt, const int* start,
              void* out, int B, int Sq, int H, int Hkv, int D, int num_pages,
              int page, int maxp, float scale, cudaStream_t stream) {
  if (kv == KV_INT8)
    return launch<T, int8_t>(q, kp, vp, ks, vs, bt, start, out, B, Sq, H,
                             Hkv, D, num_pages, page, maxp, scale, stream);
  if (kv == KV_NATIVE)
    return launch<T, T>(q, kp, vp, ks, vs, bt, start, out, B, Sq, H, Hkv, D,
                        num_pages, page, maxp, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ptt

// kv: KV_NATIVE (ks, vs unused) or KV_INT8 (int8 payloads kp, vp with f32
// row scales ks, vs)
PTT_EXPORT int ptt_paged_chunk_attention(int dtype, int kv, const void* q,
                                         const void* kp, const void* vp,
                                         const void* ks, const void* vs,
                                         const void* bt, const void* start,
                                         void* out, int B, int S, int H,
                                         int Hkv, int D, int num_pages,
                                         int page, int maxp, float scale,
                                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* bti = (const int*)bt;
  const int* sti = (const int*)start;
  if (D > ptt::FP_DPL * 32) return (int)cudaErrorInvalidValue;
  if (dtype == ptt::DT_BF16)
    return ptt::launch_kv<__nv_bfloat16>(kv, q, kp, vp, ks, vs, bti, sti,
                                         out, B, S, H, Hkv, D, num_pages,
                                         page, maxp, scale, st);
  if (dtype == ptt::DT_F32)
    return ptt::launch_kv<float>(kv, q, kp, vp, ks, vs, bti, sti, out, B, S,
                                 H, Hkv, D, num_pages, page, maxp, scale, st);
  return (int)cudaErrorInvalidValue;
}
