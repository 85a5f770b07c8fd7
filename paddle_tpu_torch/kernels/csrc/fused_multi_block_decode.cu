// N Llama decoder layers' decode step per call, over stacked weights.
//
// Replaces the TPU kernel `_fused_multi_block_kernel` (paddle_tpu/kernels/
// fused_block_decode.py, launched by `fused_multi_block_decode_pallas`).
// There one pallas_call ran a grid of n_layers x per-layer phases: the
// stacked weights streamed through VMEM under a layer-aware index map, the
// activation carried across layers in VMEM scratch, q|k|v and gate|up were
// one merged matmul each, and the new k/v of every layer left the kernel
// for the caller to write into the N per-layer pools.
//
// Bound on the H100: bytes, N times fused_block_decode.cu's: the group's
// stacked weights (N x ~405 MB for Llama-2-7B layers in bf16) plus each
// layer's live KV pages, over 3.35 TB/s.
//
// Design: one C entry per layer group runs the N layers' chain in order on
// the caller's stream with block_decode.cuh's run(), the same device code
// as the one-layer kernel: f32 rms; one merged GEMV launch over the layer's
// slice of wqkv (q, k and v as three column ranges of one matrix, read with
// its row stride); RoPE at each slot's position; the append of the new
// k/v to the layer's pool at seq_lens (an idle slot's all-zero block table
// sends its row to the null page), then decode_split.cuh's split-KV
// attention over seq_lens + 1, which reads the step's own key from the
// append's scratch row; o-GEMV + residual; rms; one merged GEMV over wgu;
// silu * up; down-GEMV + residual; the cast to x's dtype, which the next
// layer reads back as its f32 carry. Each output column of a merged GEMV
// is reduced with the split and order of the one-layer kernel's separate
// GEMV, and the attention's part count is the one-layer wrapper's (a
// function of the same shapes), so a group's step equals N one-layer
// launches bit for bit. The N per-layer pools arrive as a host array of
// pointers (below): the entry launches every layer's kernels itself, so
// each layer's append and attention kernels get its pools as pointer
// parameters, as the one-layer kernel's do (the TPU kernel needed a table
// because one pallas_call covered all N layers). A persistent single
// kernel across the group (clusters, distributed shared memory) is later
// work.
//
// The quantized branches of the TPU kernel (`kv_quant`, `wt_quant`), chosen
// per call: int8 pools arrive as 4N pointers (k, v, k-scale, v-scale per
// layer; a native pool's scales are 0), each layer's four handed to its
// append and attention launches as pointer parameters; int4 weights arrive
// as the four merged matrices' packed payloads (the native weight
// pointers) with their tile scales and tiles (tr, tc), and every GEMV of
// the group streams the packed bytes (block_decode.cuh's gemv4). The bound
// then drops to the packed bytes: Llama-2-7B layers at 4 bits a weight,
// ~101 MB a layer.
#include "block_decode.cuh"

PTT_EXPORT long long ptt_fused_multi_block_decode_scratch(
    int dtype, int w4, int B, int hidden, int nh, int nkv, int d, int inter,
    int nsplit) {
  return (long long)ptt::layout(dtype, w4 != 0, B, hidden, nh, nkv, d, inter,
                                nsplit)
      .total;
}

namespace ptt {

// The merged int4 matrices of layer i of a stacked group: layer i's packed
// rows and tile scales follow the earlier layers' (n, R/2, C) and
// (n, R/tr, C/tc) blocks.
inline Int4Mat int4_layer(const void* q, const void* sc, int i, int R, int C,
                          int tr, int tc) {
  return Int4Mat{(const uint8_t*)q + (size_t)i * (R / 2) * C,
                 (const float*)sc + (size_t)i * (R / tr) * (C / tc), C, tr,
                 tc};
}

template <typename T, typename S, bool W4>
int run_group(const void* x, const void* ln1, const void* wqkv,
              const void* wo, const void* ln2, const void* wgu,
              const void* wd, const void* const* wsc, const int* tiles,
              void* const* pools, const int* bt, const int* sl,
              const float* inv, void* out, float* scratch, int dtype,
              int n_layers, int B, int hidden, int nh, int nkv, int d,
              int inter, int num_pages, int page, int maxp, int part_pages,
              int nsplit, float eps, float scale, cudaStream_t st) {
  const int qw = nh * d, kvw = nkv * d, qkvw = qw + 2 * kvw;
  for (int i = 0; i < n_layers; ++i) {
    LayerWeights<T> w = {};
    w.ln1 = (const T*)ln1 + (size_t)i * hidden;
    w.ln2 = (const T*)ln2 + (size_t)i * hidden;
    if constexpr (W4) {
      w.qkv = int4_layer(wqkv, wsc[0], i, hidden, qkvw, tiles[0], tiles[1]);
      w.o = int4_layer(wo, wsc[1], i, qw, hidden, tiles[2], tiles[3]);
      w.gu = int4_layer(wgu, wsc[2], i, hidden, 2 * inter, tiles[4],
                        tiles[5]);
      w.dn = int4_layer(wd, wsc[3], i, inter, hidden, tiles[6], tiles[7]);
    } else {
      w.wq = (const T*)wqkv + (size_t)i * hidden * qkvw;
      w.wk = w.wq + qw;
      w.wv = w.wk + kvw;
      w.ldq = w.ldk = w.ldv = qkvw;
      w.wo = (const T*)wo + (size_t)i * qw * hidden;
      w.wg = (const T*)wgu + (size_t)i * hidden * 2 * inter;
      w.wu = w.wg + inter;
      w.ldg = w.ldu = 2 * inter;
      w.wd = (const T*)wd + (size_t)i * inter * hidden;
    }
    const PoolRef<S> pool{(S*)pools[4 * i], (S*)pools[4 * i + 1],
                          (float*)pools[4 * i + 2], (float*)pools[4 * i + 3]};
    // layer 0 reads x; every layer writes out, which the next one reads
    const T* xi = i == 0 ? (const T*)x : (const T*)out;
    const int rc = run<T, S, W4>(xi, w, pool, bt, sl, inv, (T*)out, scratch,
                                 dtype, B, hidden, nh, nkv, d, inter,
                                 num_pages, page, maxp, part_pages, nsplit,
                                 eps, scale, st);
    if (rc) return rc;
  }
  return 0;
}

// the (kv, w4) variants of one activation type
template <typename T>
int run_variant(int kv, int w4, const void* x, const void* ln1,
                const void* wqkv, const void* wo, const void* ln2,
                const void* wgu, const void* wd, const void* const* wsc,
                const int* tiles, void* const* pools, const int* bt,
                const int* sl, const float* inv, void* out, float* scratch,
                int dtype, int n_layers, int B, int hidden, int nh, int nkv,
                int d, int inter, int num_pages, int page, int maxp,
                int part_pages, int nsplit, float eps, float scale,
                cudaStream_t st) {
#define PTT_GROUP(S, W4)                                                    \
  return run_group<T, S, W4>(x, ln1, wqkv, wo, ln2, wgu, wd, wsc, tiles,   \
                             pools, bt, sl, inv, out, scratch, dtype,      \
                             n_layers, B, hidden, nh, nkv, d, inter,       \
                             num_pages, page, maxp, part_pages, nsplit,    \
                             eps, scale, st)
  if (kv == KV_NATIVE && !w4) PTT_GROUP(T, false);
  if (kv == KV_NATIVE && w4) PTT_GROUP(T, true);
  if (kv == KV_INT8 && !w4) PTT_GROUP(int8_t, false);
  if (kv == KV_INT8 && w4) PTT_GROUP(int8_t, true);
#undef PTT_GROUP
  return (int)cudaErrorInvalidValue;
}

}  // namespace ptt

// kv: KV_NATIVE or KV_INT8 (pools: 4N pointers k, v, k-scale, v-scale per
// layer). w4: wqkv, wo, wgu and wd are int4 payloads (uint8) with f32 tile
// scales sqkv, so, sgu, sd and tiles (tr, tc) x 4, host ints; otherwise
// native and the scales and tiles are unused. The attention's walk:
// nsplit parts of part_pages pages, covering the table; scratch as
// ptt_fused_multi_block_decode_scratch sizes it for nsplit.
PTT_EXPORT int ptt_fused_multi_block_decode(
    int dtype, int kv, int w4, const void* x, const void* ln1,
    const void* wqkv, const void* wo, const void* ln2, const void* wgu,
    const void* wd, const void* sqkv, const void* so, const void* sgu,
    const void* sd, const int* tiles, void* const* pools, const void* bt,
    const void* sl, const void* inv_freq, void* out, void* scratch,
    int n_layers, int B, int hidden, int nh, int nkv, int d, int inter,
    int num_pages, int page, int maxp, int part_pages, int nsplit, float eps,
    float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* bti = (const int*)bt;
  const int* sli = (const int*)sl;
  const float* inv = (const float*)inv_freq;
  float* scr = (float*)scratch;
  const void* const wsc[4] = {sqkv, so, sgu, sd};
  if (n_layers < 1 || B < 1 || nkv < 1 || nh % nkv || page < 1 ||
      !ptt::ds_split_ok(d, maxp, part_pages, nsplit))
    return (int)cudaErrorInvalidValue;
  if (w4) {
    for (int m = 0; m < 4; ++m)
      if (tiles[2 * m] < 2 || tiles[2 * m] % 2 || tiles[2 * m + 1] < 1)
        return (int)cudaErrorInvalidValue;
  }
  if (dtype == ptt::DT_BF16)
    return ptt::run_variant<__nv_bfloat16>(
        kv, w4, x, ln1, wqkv, wo, ln2, wgu, wd, wsc, tiles, pools, bti, sli,
        inv, out, scr, dtype, n_layers, B, hidden, nh, nkv, d, inter,
        num_pages, page, maxp, part_pages, nsplit, eps, scale, st);
  if (dtype == ptt::DT_F32)
    return ptt::run_variant<float>(
        kv, w4, x, ln1, wqkv, wo, ln2, wgu, wd, wsc, tiles, pools, bti, sli,
        inv, out, scr, dtype, n_layers, B, hidden, nh, nkv, d, inter,
        num_pages, page, maxp, part_pages, nsplit, eps, scale, st);
  return (int)cudaErrorInvalidValue;
}
