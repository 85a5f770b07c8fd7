// One Llama decoder layer's decode step for a batch of single tokens.
//
// Replaces the TPU kernel `_fused_block_kernel` (paddle_tpu/kernels/
// fused_block_decode.py, launched by `fused_block_decode_pallas`). There one
// pallas_call walked a flat grid of sequential phases (Q | K | V | RoPE |
// paged attention | O | gate/up | down) and every activation stayed in VMEM
// scratch between phases.
//
// Bound on the H100: bytes. At batch <= 32 each weight element feeds a few
// multiply-adds, far below the ~295 flops per byte where the tensor cores
// would become the limit, so the least time is the layer's weight bytes
// (about 405 MB for a 7B layer in bf16, ~0.12 ms at 3.35 TB/s) plus the live
// KV pages, over the memory rate.
//
// Design: Hopper blocks run in no order, so the single grid of phases
// becomes one C entry point that launches the phases in order on the
// caller's stream (block_decode.cuh's run(): rms, q/k/v GEMVs + RoPE, the
// append of the new token's k/v to the pool, paged attention over
// seq_lens + 1, o-proj + residual, rms, gate/up GEMVs + SwiGLU, down +
// residual), with the activations in an f32 scratch buffer the wrapper
// allocates. The GEMVs split the contraction over blocks and reduce the
// partial sums in a fixed order. The attention is decode_split.cuh's
// split-KV routine, the one #2 runs: blocks over (row, kv head, head
// group, part of the table), parts merged in part order, the part count
// (part_pages, nsplit) chosen by the wrapper from the shapes alone; the
// step's own key is read from the append kernel's scratch row, so idle
// rows that share the null page stay apart. The first version walked each
// row's pages in series in one block of 128 threads through f32 shared
// memory: at serve_long's contexts that phase took 88 % of a decode step
// (PERF.md). A persistent or cluster-fused single kernel is later work.
//
// int8 pools (the TPU kernel's `kv_quant` branch): the entry takes the
// payloads and their f32 row scales (kv = KV_INT8); the append kernel
// quantizes the new token's k/v row with the plain version's arithmetic
// and writes payload and scale; the attention reads the payloads and
// scales in registers, the new row at the value a re-read of the pool
// gives (the TPU kernel's _fake_quant_rows).
#include "block_decode.cuh"

// w4 is the N-layer kernel's int4 flag; the one-layer kernel takes native
// weights only (as the TPU kernel), so its callers pass 0. nsplit: the
// attention's part count.
PTT_EXPORT long long ptt_fused_block_decode_scratch(int dtype, int w4, int B,
                                                    int hidden, int nh,
                                                    int nkv, int d, int inter,
                                                    int nsplit) {
  return (long long)ptt::layout(dtype, w4 != 0, B, hidden, nh, nkv, d, inter,
                                nsplit)
      .total;
}

namespace ptt {

template <typename T, typename S>
int run_one(const void* x, const void* const* wp, void* const* pp,
            const int* bt, const int* sl, const float* inv, void* out,
            float* scratch, int dtype, int B, int hidden, int nh, int nkv,
            int d, int inter, int num_pages, int page, int maxp,
            int part_pages, int nsplit, float eps, float scale,
            cudaStream_t st) {
  LayerWeights<T> w;
  w.ln1 = (const T*)wp[0];
  w.wq = (const T*)wp[1];
  w.wk = (const T*)wp[2];
  w.wv = (const T*)wp[3];
  w.wo = (const T*)wp[4];
  w.ln2 = (const T*)wp[5];
  w.wg = (const T*)wp[6];
  w.wu = (const T*)wp[7];
  w.wd = (const T*)wp[8];
  w.ldq = nh * d;
  w.ldk = w.ldv = nkv * d;
  w.ldg = w.ldu = inter;
  const PoolRef<S> pools{(S*)pp[0], (S*)pp[1], (float*)pp[2], (float*)pp[3]};
  return run<T, S, false>((const T*)x, w, pools, bt, sl, inv, (T*)out,
                          scratch, dtype, B, hidden, nh, nkv, d, inter,
                          num_pages, page, maxp, part_pages, nsplit, eps,
                          scale, st);
}

template <typename T>
int run_kv(int kv, const void* x, const void* const* wp, void* const* pp,
           const int* bt, const int* sl, const float* inv, void* out,
           float* scratch, int dtype, int B, int hidden, int nh, int nkv,
           int d, int inter, int num_pages, int page, int maxp,
           int part_pages, int nsplit, float eps, float scale,
           cudaStream_t st) {
  if (kv == KV_INT8)
    return run_one<T, int8_t>(x, wp, pp, bt, sl, inv, out, scratch, dtype, B,
                              hidden, nh, nkv, d, inter, num_pages, page,
                              maxp, part_pages, nsplit, eps, scale, st);
  if (kv == KV_NATIVE)
    return run_one<T, T>(x, wp, pp, bt, sl, inv, out, scratch, dtype, B,
                         hidden, nh, nkv, d, inter, num_pages, page, maxp,
                         part_pages, nsplit, eps, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ptt

// kv: KV_NATIVE (ks, vs unused) or KV_INT8 (int8 payloads kp, vp with f32
// row scales ks, vs). The attention's walk: nsplit parts of part_pages
// pages, covering the table; scratch as ptt_fused_block_decode_scratch
// sizes it for nsplit.
PTT_EXPORT int ptt_fused_block_decode(
    int dtype, int kv, const void* x, const void* ln1, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* ln2,
    const void* wg, const void* wu, const void* wd, void* kp, void* vp,
    void* ks, void* vs, const void* bt, const void* sl, const void* inv_freq,
    void* out, void* scratch, int B, int hidden, int nh, int nkv, int d,
    int inter, int num_pages, int page, int maxp, int part_pages, int nsplit,
    float eps, float scale, void* stream) {
  if (B < 1 || nkv < 1 || nh % nkv || page < 1 ||
      !ptt::ds_split_ok(d, maxp, part_pages, nsplit))
    return (int)cudaErrorInvalidValue;
  const void* const wp[9] = {ln1, wq, wk, wv, wo, ln2, wg, wu, wd};
  void* const pp[4] = {kp, vp, ks, vs};
  cudaStream_t st = (cudaStream_t)stream;
  const int* bti = (const int*)bt;
  const int* sli = (const int*)sl;
  const float* inv = (const float*)inv_freq;
  float* scr = (float*)scratch;
  if (dtype == ptt::DT_BF16)
    return ptt::run_kv<__nv_bfloat16>(kv, x, wp, pp, bti, sli, inv, out, scr,
                                      dtype, B, hidden, nh, nkv, d, inter,
                                      num_pages, page, maxp, part_pages,
                                      nsplit, eps, scale, st);
  if (dtype == ptt::DT_F32)
    return ptt::run_kv<float>(kv, x, wp, pp, bti, sli, inv, out, scr, dtype,
                              B, hidden, nh, nkv, d, inter, num_pages, page,
                              maxp, part_pages, nsplit, eps, scale, st);
  return (int)cudaErrorInvalidValue;
}
