// One-token decode attention through block tables (the paged KV pool).
//
// Replaces the TPU kernel `_paged_kernel` (paddle_tpu/kernels/
// paged_attention.py, launched by `paged_attention`). There the grid
// (batch, kv head, page) ran in order on one core, the block table rode
// scalar prefetch into the kv index map, and the online-softmax state sat in
// VMEM scratch across the page steps.
//
// Bound on the H100: bytes. Each visited pool page is read once (one query
// token per head does 2 flops per key element), so the least time is the
// live pages' bytes over 3.35 TB/s.
//
// Design: one block per (batch row, kv head) covers that head's `rep` query
// heads, so each key/value row is read once for all of them (GQA reads the
// pool unexpanded). The block reads its page ids from the block table
// itself and loops over ceil(seq_len / page) pages through shared memory,
// carrying the online softmax in shared memory. A row with seq_len == 0
// visits no page and emits zeros; idle slots (all-zero block tables) never
// read past the null page. Splitting a long sequence over several blocks
// (flash-decoding) is later work.
//
// int8 pools (the TPU kernel's `quant` branch): payload and per-row f32
// scales arrive as four pointer parameters (a pointer read from memory would
// turn the pool loads generic), and common.cuh's loader dequantizes each
// element as it enters the f32 shared-memory tile: a row costs D + 4 bytes
// instead of 2D (bf16), the rest of the kernel is unchanged.
#include "common.cuh"

namespace ptt {

constexpr int PA_THREADS = 128;

// T: q/out type; S: pool storage (T, or int8_t with row scales ks/vs)
template <typename T, typename S>
__global__ void __launch_bounds__(PA_THREADS)
    paged_attention_kernel(const T* __restrict__ q, const S* __restrict__ kp,
                           const S* __restrict__ vp,
                           const float* __restrict__ ks,
                           const float* __restrict__ vs,
                           const int* __restrict__ bt,
                           const int* __restrict__ sl, T* __restrict__ out,
                           int H, int Hkv, int D, int num_pages, int page,
                           int maxp, float scale) {
  extern __shared__ float smem[];
  const int rep = H / Hkv;
  const int b = blockIdx.x / Hkv, g = blockIdx.x - b * Hkv;
  DecodeSmem sm = decode_smem_carve(smem, rep, D, page);
  const size_t qoff = ((size_t)b * H + (size_t)g * rep) * D;
  decode_init(sm, q + qoff, rep, D, scale);
  decode_pages(sm, kp, vp, ks, vs, bt + (size_t)b * maxp, sl[b], g,
               num_pages, page, maxp, rep, D);
  decode_emit(sm, out + qoff, rep, D);
}

template <typename T, typename S>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const int* bt, const int* sl, void* out, int B,
           int H, int Hkv, int D, int num_pages, int page, int maxp,
           float scale, cudaStream_t stream) {
  const int rep = H / Hkv;
  const size_t smem = decode_smem_floats(rep, D, page) * sizeof(float);
  cudaFuncSetAttribute(paged_attention_kernel<T, S>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  paged_attention_kernel<T, S><<<B * Hkv, PA_THREADS, smem, stream>>>(
      (const T*)q, (const S*)kp, (const S*)vp, (const float*)ks,
      (const float*)vs, bt, sl, (T*)out, H, Hkv, D, num_pages, page, maxp,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_kv(int kv, const void* q, const void* kp, const void* vp,
              const void* ks, const void* vs, const int* bt, const int* sl,
              void* out, int B, int H, int Hkv, int D, int num_pages,
              int page, int maxp, float scale, cudaStream_t stream) {
  if (kv == KV_INT8)
    return launch<T, int8_t>(q, kp, vp, ks, vs, bt, sl, out, B, H, Hkv, D,
                             num_pages, page, maxp, scale, stream);
  if (kv == KV_NATIVE)
    return launch<T, T>(q, kp, vp, ks, vs, bt, sl, out, B, H, Hkv, D,
                        num_pages, page, maxp, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ptt

// kv: KV_NATIVE (ks, vs unused) or KV_INT8 (int8 payloads kp, vp with f32
// row scales ks, vs)
PTT_EXPORT int ptt_paged_attention(int dtype, int kv, const void* q,
                                   const void* kp, const void* vp,
                                   const void* ks, const void* vs,
                                   const void* bt, const void* sl, void* out,
                                   int B, int H, int Hkv, int D,
                                   int num_pages, int page, int maxp,
                                   float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* bti = (const int*)bt;
  const int* sli = (const int*)sl;
  if (dtype == ptt::DT_BF16)
    return ptt::launch_kv<__nv_bfloat16>(kv, q, kp, vp, ks, vs, bti, sli,
                                         out, B, H, Hkv, D, num_pages, page,
                                         maxp, scale, st);
  if (dtype == ptt::DT_F32)
    return ptt::launch_kv<float>(kv, q, kp, vp, ks, vs, bti, sli, out, B, H,
                                 Hkv, D, num_pages, page, maxp, scale, st);
  return (int)cudaErrorInvalidValue;
}
