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
// out (≈ 63 MB for S = 256 at start 3328, Llama-2-7B heads, bf16: 0.0188
// ms at 3.35 TB/s), while its 4 * S * H * D * (start + S / 2) flops (≈ 14.5
// GFLOP) take 0.015 ms at the bf16 tensor-core rate.
//
// Design: bf16 runs prefill_mma.cuh's tensor-core routine (fp32 keeps
// common.cuh's f32 prefill_block) with K/V rows found through page ids and
// the causal diagonal moved by `start`. One block per (batch * query head,
// tile of 128 chunk rows, part of the kv walk) reads the block-table row
// and start[b] on the device (no host sync) and walks the kv positions
// 0 .. min(start + last row, max_pages * page - 1) in tiles of 128 rows,
// looking up each row's page itself, so no gathered (B, T, Hkv, D) view
// exists; cp.async stages the next tile while this one runs through
// mma.sync. The diagonal may fall mid-page (start % page != 0): the mask is
// by absolute position, kv_pos <= start + i. A padded final chunk can
// reach past the table: the walk stops at the table's width, as the TPU
// kernel clamps its page count; the pad rows still run and the caller
// drops them. GQA reads kv head h // rep of the unexpanded pool. At S = 256
// the 64 (query tile, head) blocks cannot fill the card, so the wrapper
// splits each walk in two (flash-decoding) and a second kernel of the same
// call merges the parts. Measured (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700 W): 0.104-0.106 ms at S = 256 from 3328, against SDPA's 0.105 on the
// gathered prefix, 5.6x its bytes bound: with one block of 8 warps an SM
// the tile copies and the math (Q K^T, softmax, the doubled P V of
// prefill_mma.cuh) run almost in series, neither at its own limit.
//
// int8 pools (the TPU kernel's `quant` branch): the payload and its per-row
// f32 scales arrive as four pointer parameters; the payload is staged as
// int8 and converted exactly to bf16 in shared memory, and the scales are
// applied in f32 to S's and P's columns, so everything after is the native
// kernel's arithmetic (1.10-1.11x its time). The rows then cost D + 4 bytes
// instead of 2D (bf16).
#include "prefill_mma.cuh"

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

// T: q/out type; S: pool storage (T, or int8_t with row scales ks/vs); DP:
// the padded head dim of the bf16 (tensor-core) route, 0 for fp32 (at most
// 128 registers a thread)
template <typename T, typename S, int DP>
__global__ void __launch_bounds__(DP == 0 ? FP_WARPS * 32 : PM_THREADS,
                                  DP == 0 ? 4 : PM_BLOCKS_PER_SM)
    paged_chunk_kernel(const T* __restrict__ q, const S* __restrict__ kp,
                       const S* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ bt,
                       const int* __restrict__ start, T* __restrict__ out,
                       int Sq, int H, int Hkv, int D, int num_pages, int page,
                       int maxp, float scale, int qunit, int kvunit,
                       float* __restrict__ po, float* __restrict__ pml) {
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / Hkv);
  const PagedRows rows{bt + (size_t)b * maxp, (size_t)g * num_pages, page};
  if constexpr (DP == 0)
    prefill_block(q, out, ((size_t)b * Sq * H + h) * D, (size_t)H * D, Sq,
                  (int)blockIdx.x * FP_BQ, start[b], maxp * page, kp, vp, ks,
                  vs, rows, D, scale);
  else
    prefill_mma<DP>(q, out, (size_t)b * Sq * H + h, (size_t)H, Sq,
                    (int)blockIdx.x * PM_BQ, start[b], maxp * page, kp, vp,
                    ks, vs, rows, D, scale, qunit, kvunit, (int)blockIdx.z,
                    (int)gridDim.z, po, pml, (size_t)gridDim.y * Sq);
}

template <typename T, typename S, int DP>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const int* bt, const int* start, void* out, int B,
           int Sq, int H, int Hkv, int D, int num_pages, int page, int maxp,
           int nsplit, float* po, float* pml, float scale,
           cudaStream_t stream) {
  const size_t smem = DP == 0 ? fp_smem_bytes(D)
                              : pm_smem_bytes<DP, is_int8_pool<S>()>();
  const int bq = DP == 0 ? FP_BQ : PM_BQ;
  const size_t row = (size_t)D * sizeof(T);
  const int qunit = std::min(copy_unit(q, row), copy_unit(out, row));
  const int kvunit = std::min(copy_unit(kp, (size_t)D * sizeof(S)),
                              copy_unit(vp, (size_t)D * sizeof(S)));
  cudaFuncSetAttribute(paged_chunk_kernel<T, S, DP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((Sq + bq - 1) / bq, B * H, nsplit);
  const int threads = DP == 0 ? FP_WARPS * 32 : PM_THREADS;
  paged_chunk_kernel<T, S, DP><<<grid, threads, smem, stream>>>(
      (const T*)q, (const S*)kp, (const S*)vp, (const float*)ks,
      (const float*)vs, bt, start, (T*)out, Sq, H, Hkv, D, num_pages, page,
      maxp, scale, qunit, kvunit, po, pml);
  if (nsplit > 1) {
    const size_t nrows = (size_t)B * Sq * H;
    const unsigned blocks = (unsigned)((nrows + 3) / 4);
    prefill_combine_kernel<T><<<blocks, 128, 0, stream>>>(
        po, pml, (T*)out, nrows, D, nsplit);
  }
  return (int)cudaGetLastError();
}

// the route by type: fp32 on the CUDA cores, bf16 on the tensor cores at
// the head dim padded to 32, 64, 96 or 128
template <typename T, typename S>
int launch_dt(const void* q, const void* kp, const void* vp, const void* ks,
              const void* vs, const int* bt, const int* start, void* out,
              int B, int Sq, int H, int Hkv, int D, int num_pages, int page,
              int maxp, int nsplit, float* po, float* pml, float scale,
              cudaStream_t stream) {
#define PTT_CHUNK_LAUNCH(DP, NS)                                             \
  launch<T, S, DP>(q, kp, vp, ks, vs, bt, start, out, B, Sq, H, Hkv, D,      \
                   num_pages, page, maxp, NS, po, pml, scale, stream)
  if constexpr (std::is_same<T, float>::value) return PTT_CHUNK_LAUNCH(0, 1);
  else switch (padded_head_dim(D)) {
    case 32: return PTT_CHUNK_LAUNCH(32, nsplit);
    case 64: return PTT_CHUNK_LAUNCH(64, nsplit);
    case 96: return PTT_CHUNK_LAUNCH(96, nsplit);
    default: return PTT_CHUNK_LAUNCH(128, nsplit);
  }
#undef PTT_CHUNK_LAUNCH
}

template <typename T>
int launch_kv(int kv, const void* q, const void* kp, const void* vp,
              const void* ks, const void* vs, const int* bt, const int* start,
              void* out, int B, int Sq, int H, int Hkv, int D, int num_pages,
              int page, int maxp, int nsplit, float* po, float* pml,
              float scale, cudaStream_t stream) {
  if (kv == KV_INT8)
    return launch_dt<T, int8_t>(q, kp, vp, ks, vs, bt, start, out, B, Sq, H,
                                Hkv, D, num_pages, page, maxp, nsplit, po,
                                pml, scale, stream);
  if (kv == KV_NATIVE)
    return launch_dt<T, T>(q, kp, vp, ks, vs, bt, start, out, B, Sq, H, Hkv,
                           D, num_pages, page, maxp, nsplit, po, pml, scale,
                           stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ptt

// kv: KV_NATIVE (ks, vs unused) or KV_INT8 (int8 payloads kp, vp with f32
// row scales ks, vs). nsplit > 1 (bf16 only) splits each block's kv walk
// into that many parts, merged by a second kernel: po and pml are f32
// scratch of nsplit * B * S * H * D and nsplit * B * S * H * 2 elements.
PTT_EXPORT int ptt_paged_chunk_attention(int dtype, int kv, const void* q,
                                         const void* kp, const void* vp,
                                         const void* ks, const void* vs,
                                         const void* bt, const void* start,
                                         void* out, void* po, void* pml,
                                         int B, int S, int H, int Hkv, int D,
                                         int num_pages, int page, int maxp,
                                         int nsplit, float scale,
                                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* bti = (const int*)bt;
  const int* sti = (const int*)start;
  if (D > ptt::FP_DPL * 32 || nsplit < 1) return (int)cudaErrorInvalidValue;
  if (dtype == ptt::DT_BF16)
    return ptt::launch_kv<__nv_bfloat16>(kv, q, kp, vp, ks, vs, bti, sti,
                                         out, B, S, H, Hkv, D, num_pages,
                                         page, maxp, nsplit, (float*)po,
                                         (float*)pml, scale, st);
  if (dtype == ptt::DT_F32)
    return ptt::launch_kv<float>(kv, q, kp, vp, ks, vs, bti, sti, out, B, S,
                                 H, Hkv, D, num_pages, page, maxp, 1, nullptr,
                                 nullptr, scale, st);
  return (int)cudaErrorInvalidValue;
}
