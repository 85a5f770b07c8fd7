// One-token decode attention through block tables (the paged KV pool).
//
// Replaces the TPU kernel `_paged_kernel` (paddle_tpu/kernels/
// paged_attention.py, launched by `paged_attention`). There the grid
// (batch, kv head, page) ran in order on one core, the block table rode
// scalar prefetch into the kv index map, and the online-softmax state sat in
// VMEM scratch across the page steps.
//
// Bound on the H100: bytes. Each live pool row is read once (one query
// token per head does 2 flops per key element), so the least time is the
// live rows' bytes over 3.35 TB/s: 0.0079 ms at chip_smoke.py's shape
// (B = 4, lengths 1024/517/79/0, Llama-2-7B heads, bf16), about 0.044 ms
// at serve_long's decode contexts (3500/2900/1800/700).
//
// Design: decode_split.cuh's split-KV (flash-decoding) routine. The walk
// over a sequence's pages is cut into parts of about 256 keys, one block
// per (batch row, kv head, head group, part), each key row loaded from the
// pool into registers by 16-byte loads and shared by the block's query
// heads (GQA reads the pool unexpanded); a second kernel in the same call
// merges the parts in part order. The part count comes from the shapes
// only (paged_attention.decode_splits: the table's width, the page size
// and the SM count), so the host reads no length. Blocks past a row's
// length exit at once; an idle row (seq_len 0) emits zeros, and an idle
// slot's all-zero block table is never read past its length. The fused
// decode kernels (#3, #5) run the same routine with their own q and
// output types and a length offset of 1 (decode_split.cuh's OWN); here
// the offset is 0. The first version (one block per (row, kv head) walking its
// pages in series through f32 shared memory) took 0.293 ms at chip_smoke's
// shape in bf16;
// this one takes 0.0155 ms of device time there (SDPA over the gathered
// pool 0.031) and 0.071 ms at serve_long's contexts against the 0.0435 ms
// bound (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py, PERF.md). A
// per-thread cp.async ring in shared memory in place of the register
// loads ran within 5 % either way and was not kept.
//
// int8 pools (the TPU kernel's `quant` branch): payload and per-row f32
// scales arrive as four pointer parameters (a pointer read from memory would
// turn the pool loads generic); a row costs D + 4 bytes instead of 2D
// (bf16), converted exactly to f32 in registers, with the scales applied
// in f32.
#include "decode_split.cuh"

namespace ptt {

template <typename T, typename S>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const int* bt, const int* sl, void* out,
           float* po, float* pml, int B, int H, int Hkv, int D,
           int num_pages, int page, int maxp, int part_pages, int nsplit,
           float scale, cudaStream_t st) {
  const DsCall<T, S> a{(const T*)q, (const S*)kp, (const S*)vp,
                       (const float*)ks, (const float*)vs, nullptr,
                       nullptr, nullptr, nullptr, bt, sl, (T*)out, po, pml,
                       B, H, Hkv, D, num_pages, page, maxp, part_pages,
                       nsplit, scale};
  return decode_split<T, S, false>(a, st);
}

template <typename T>
int launch_kv(int kv, const void* q, const void* kp, const void* vp,
              const void* ks, const void* vs, const int* bt, const int* sl,
              void* out, float* po, float* pml, int B, int H, int Hkv, int D,
              int num_pages, int page, int maxp, int part_pages, int nsplit,
              float scale, cudaStream_t st) {
  if (kv == KV_INT8)
    return launch<T, int8_t>(q, kp, vp, ks, vs, bt, sl, out, po, pml, B, H,
                             Hkv, D, num_pages, page, maxp, part_pages,
                             nsplit, scale, st);
  if (kv == KV_NATIVE)
    return launch<T, T>(q, kp, vp, ks, vs, bt, sl, out, po, pml, B, H, Hkv,
                        D, num_pages, page, maxp, part_pages, nsplit, scale,
                        st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ptt

// kv: KV_NATIVE (ks, vs unused) or KV_INT8 (int8 payloads kp, vp with f32
// row scales ks, vs). The walk: nsplit parts of part_pages pages each,
// covering the table (nsplit * part_pages >= maxp); with nsplit > 1, po
// (nsplit, B * H, D) and pml (nsplit, B * H, 2) are f32 scratch that a
// second kernel of the same call merges.
PTT_EXPORT int ptt_paged_attention(int dtype, int kv, const void* q,
                                   const void* kp, const void* vp,
                                   const void* ks, const void* vs,
                                   const void* bt, const void* sl, void* out,
                                   void* po, void* pml, int B, int H,
                                   int Hkv, int D, int num_pages, int page,
                                   int maxp, int part_pages, int nsplit,
                                   float scale, void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv || page < 1 ||
      !ptt::ds_split_ok(D, maxp, part_pages, nsplit) ||
      (nsplit > 1 && (po == nullptr || pml == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* bti = (const int*)bt;
  const int* sli = (const int*)sl;
  if (dtype == ptt::DT_BF16)
    return ptt::launch_kv<__nv_bfloat16>(kv, q, kp, vp, ks, vs, bti, sli,
                                         out, (float*)po, (float*)pml, B, H,
                                         Hkv, D, num_pages, page, maxp,
                                         part_pages, nsplit, scale, st);
  if (dtype == ptt::DT_F32)
    return ptt::launch_kv<float>(kv, q, kp, vp, ks, vs, bti, sli, out,
                                 (float*)po, (float*)pml, B, H, Hkv, D,
                                 num_pages, page, maxp, part_pages, nsplit,
                                 scale, st);
  return (int)cudaErrorInvalidValue;
}
