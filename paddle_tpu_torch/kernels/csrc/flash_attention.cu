// FlashAttention-2 forward and backward for training: (BH, S, D) layout,
// causal or full, GQA, any sequence length, f32 softmax and accumulation.
//
// Replaces the TPU kernels of paddle_tpu/kernels/flash_attention.py:
//   forward  `_fwd_kernel` (lane-replicated stats) and `_fwd_kernel_compact`
//            (compact (BH, S) lse): one kernel here, emitting out and the
//            compact f32 lse, so it covers both;
//   dq       `_bwd_dq_kernel`;
//   dk, dv   `_bwd_dkv_kernel`.
// On the TPU the kv (forward, dq) or q (dk/dv) sweep was the innermost,
// sequential grid axis, and the accumulators rode revisited output blocks
// or VMEM scratch from one grid step to the next. Hopper blocks run in no
// order, so each sweep is a loop inside one block, over tiles staged in
// shared memory, with the accumulators in registers.
//
// Bound on the H100: at training shapes (S = 4096, D = 128) attention is
// bound by operations, ~4·S²·D/2 per causal head forward, 1.5x that for dq
// and 2x for dk/dv (~0.14, 0.21 and 0.28 ms for a Llama-2-7B layer in bf16
// on the tensor cores). In bf16 all three run on the tensor cores (the
// fb_* kernels below: the forward fb_fwd_kernel, the backward fb_dq_kernel
// and fb_dkv_kernel; their times against the bound are there and in
// PERF.md). fp32 keeps the CUDA-core kernels (fa_*), which compute in f32
// (67 TFLOP/s peak), well above that bound: on the tensor cores fp32 would
// mean TF32. The C entries choose by dtype; there is no flag.
//
// Design of the CUDA-core kernels (fa_*): 64 x 64 tiles, 256 threads as a
// 16 x 16 grid; thread (ty, tx) owns rows ty + 16i and columns tx + 16j
// (i, j < 4) of every 64 x 64 score tile and columns tx + 16c of every
// (64, D) accumulator, so a row's 16 owners sit in one half-warp and the
// row max and sum are half-warp shuffles. Tiles that are contracted over
// the head dim are stored with a row stride of DP + 1 floats (bank-conflict
// free); the head dim is zero-padded to DP (64 or 128) in shared memory.
// Rows past the sequence end and keys past the kv end are masked in the
// kernel, so any S is taken (the TPU path required a multiple-of-128 block
// and otherwise fell back to dense attention). The causal mask is top-left
// aligned (key j visible to query i when j <= i), as in the TPU kernels,
// and the block loops stop at the diagonal. JAX's guards are kept: a row
// whose running max is still <= -1e30/2 takes max 0 (fully masked rows emit
// zeros), and l == 0 reads as 1.
//
// fa_dkv: one block per (b * Hkv, kv tile) loops over the `rep` query heads
// of its GQA group and over the q tiles from the diagonal down, and owns
// its output tile alone. No atomics: every gradient element is summed by
// one thread in a fixed order, so gradients repeat bit for bit from run to
// run.
//
// Segment ids (varlen / packed sequences; the TPU kernels' `seg_q_ref` /
// `seg_kv_ref` branch of `_masked_scores`): a compile-time variant of each
// kernel (SEG), chosen by the C entry when the two nullable id pointers are
// given. seg_q is (BH, Sq) and seg_kv (BHkv, Skv), int32; query row bh
// reads the ids of its kv row, as it reads its k/v. A pair is visible when
// it is causally visible and both ids are equal. In the fa_* kernels the
// ids a thread needs are
// those of the 4 rows and 4 columns of the score tile it owns, so they ride
// in registers, loaded from device memory (the 16 threads that share one
// read it once through L1); no shared memory is added, and the forward
// keeps its two blocks an SM. A tile in which no pair is visible is skipped
// whole, before its k/v (or q/dO) are loaded: every thread tests its 16
// pairs and `__syncthreads_or` decides for the block. On a pack of
// documents that drops the tiles between documents, which the TPU kernels
// swept up to the causal diagonal. Skipping changes no output: a masked
// tile adds p = 0 to every sum. A row that sees no key anywhere (a padding
// id no kv position carries) emits zeros with lse = 0, as the TPU kernels'
// guards make it, and gets zero dq and adds nothing to dk/dv.
#include <algorithm>
#include <initializer_list>

#include "mma.cuh"

namespace ptt {

constexpr int FA_B = 64;              // query rows and kv rows per tile
constexpr int FA_THREADS = 256;       // 16 x 16
constexpr int FA_PS = FA_B + 1;       // row stride of a 64 x 64 tile

// c[i][j] = sum_d A[(ty + 16i) * (DP + 1) + d] * B[(tx + 16j) * (DP + 1) + d]
template <int DP>
__device__ __forceinline__ void fa_abt(const float* __restrict__ A,
                                       const float* __restrict__ B,
                                       float c[4][4], int ty, int tx) {
  constexpr int DS = DP + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * DS + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * DS + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
  }
}

// acc[i][c] += sum_t P[(ty + 16i) * FA_PS + t] * M[t * ms + tx + 16c]
template <int DP>
__device__ __forceinline__ void fa_pm(const float* __restrict__ P,
                                      const float* __restrict__ M, int ms,
                                      float acc[4][DP / 16], int ty, int tx) {
#pragma unroll 4
  for (int t = 0; t < FA_B; ++t) {
    float p[4], m[DP / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * FA_PS + t];
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) m[c] = M[t * ms + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DP / 16; ++c) acc[i][c] = fmaf(p[i], m[c], acc[i][c]);
  }
}

// Stage rows [r0, r0 + 64) of a (rows, D) matrix into shared memory with row
// stride `ds`, times `scale`; rows past `n_rows` and columns past D read 0.
template <typename T, int DP>
__device__ __forceinline__ void fa_load(float* __restrict__ dst, int ds,
                                        const T* __restrict__ src, int r0,
                                        int n_rows, int D, float scale) {
  for (int idx = threadIdx.x; idx < FA_B * DP; idx += FA_THREADS) {
    const int r = idx / DP, d = idx - r * DP;
    const int row = r0 + r;
    float x = 0.f;
    if (row < n_rows && d < D) x = to_f(src[(size_t)row * D + d]) * scale;
    dst[r * ds + d] = x;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool fa_visible(int qi, int kj, int Sq, int Skv,
                                           int causal) {
  return qi < Sq && kj < Skv && (!causal || kj <= qi);
}

// The segment ids of positions p0 + 16j (j < 4) of one id row of length n
// (0 past its end, where fa_visible is false anyway).
__device__ __forceinline__ void fa_seg4(int ids[4],
                                        const int* __restrict__ seg, int p0,
                                        int n) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = p0 + 16 * j;
    ids[j] = p < n ? seg[p] : 0;
  }
}

// Query row qi sees key kj: causally visible and, with segment ids, in the
// same segment.
template <bool SEG>
__device__ __forceinline__ bool fa_pair(int qi, int kj, int Sq, int Skv,
                                        int causal, int seg_q, int seg_kv) {
  return fa_visible(qi, kj, Sq, Skv, causal) && (!SEG || seg_q == seg_kv);
}

// Whether any of a thread's 4 x 4 pairs (rows r0 + 16i, columns c0 + 16j) is
// visible; `rows_q` says whether the rows are queries (forward, dq) or keys
// (dk/dv).
__device__ __forceinline__ bool fa_any_pair(int r0, int c0, bool rows_q,
                                            const int rs[4], const int cs[4],
                                            int Sq, int Skv, int causal) {
  bool any = false;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = r0 + 16 * i, b = c0 + 16 * j;
      any |= rows_q ? fa_pair<true>(a, b, Sq, Skv, causal, rs[i], cs[j])
                    : fa_pair<true>(b, a, Sq, Skv, causal, cs[j], rs[i]);
    }
  return any;
}

// ------------------------------------------------------------------ forward
template <int DP>
constexpr size_t fa_fwd_smem() {
  // Q, K [64][DP + 1]; V [64][DP]; P [64][65]
  return sizeof(float) * (2 * FA_B * (DP + 1) + FA_B * DP + FA_B * FA_PS);
}

template <typename T, int DP, bool SEG>
__global__ void __launch_bounds__(FA_THREADS, 2)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ seg_q,
                  const int* __restrict__ seg_kv, T* __restrict__ out,
                  float* __restrict__ lse, int Sq, int Skv, int H, int Hkv,
                  int D, int causal, float scale) {
  constexpr int DS = DP + 1, NC = DP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + FA_B * DS;
  float* Vs = Ks + FA_B * DS;
  float* Ps = Vs + FA_B * DP;

  const int bh = blockIdx.y;
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  // heaviest (longest causal sweep) tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_B;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)kvh * Skv * D;
  const T* vb = v + (size_t)kvh * Skv * D;

  fa_load<T, DP>(Qs, DS, qb, q0, Sq, D, scale);
  // this thread's rows' and columns' segment ids (SEG)
  int sid_q[4] = {}, sid_kv[4] = {};
  if constexpr (SEG) fa_seg4(sid_q, seg_q + (size_t)bh * Sq, q0 + ty, Sq);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + FA_B, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  for (int j0 = 0; j0 < kv_end; j0 += FA_B) {
    if constexpr (SEG) {
      fa_seg4(sid_kv, seg_kv + (size_t)kvh * Skv, j0 + tx, Skv);
      // also: the previous tile's readers are done
      if (!__syncthreads_or(fa_any_pair(q0 + ty, j0 + tx, true, sid_q,
                                        sid_kv, Sq, Skv, causal)))
        continue;
    } else {
      __syncthreads();  // the previous tile's readers are done
    }
    fa_load<T, DP>(Ks, DS, kb, j0, Skv, D, 1.f);
    fa_load<T, DP>(Vs, DP, vb, j0, Skv, D, 1.f);
    __syncthreads();
    float s[4][4];
    fa_abt<DP>(Qs, Ks, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!fa_pair<SEG>(qi, j0 + tx + 16 * j, Sq, Skv, causal, sid_q[i],
                          sid_kv[j]))
          s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      float m_new = fmaxf(m[i], mx);
      if (m_new <= NEG_INF / 2) m_new = 0.f;  // fully masked so far
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * FA_PS + tx + 16 * j] = p;
        sum += p;
      }
      sum = half_warp_sum(sum);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    fa_pm<DP>(Ps, Vs, DP, acc, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    T* o = out + ((size_t)bh * Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) o[d] = from_f<T>(acc[i][c] / ls);
    }
    // a row no tile reached (every tile skipped) takes max 0, as the
    // guard gives a fully masked row
    const float mf = m[i] <= NEG_INF / 2 ? 0.f : m[i];
    if (tx == 0) lse[(size_t)bh * Sq + qi] = mf + logf(ls);
  }
}

// ----------------------------------------------------------------------- dq
template <int DP>
constexpr size_t fa_dq_smem() {
  // Q, dO, K, V [64][DP + 1]; dS [64][65]
  return sizeof(float) * (4 * FA_B * (DP + 1) + FA_B * FA_PS);
}

template <typename T, int DP, bool SEG>
__global__ void __launch_bounds__(FA_THREADS)
    fa_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_kv, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                 int Skv, int H, int Hkv, int D, int causal, float scale) {
  constexpr int DS = DP + 1, NC = DP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + FA_B * DS;
  float* Ks = dOs + FA_B * DS;
  float* Vs = Ks + FA_B * DS;
  float* Ps = Vs + FA_B * DS;

  const int bh = blockIdx.y;
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_B;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* kb = k + (size_t)kvh * Skv * D;
  const T* vb = v + (size_t)kvh * Skv * D;

  fa_load<T, DP>(Qs, DS, q + (size_t)bh * Sq * D, q0, Sq, D, scale);
  fa_load<T, DP>(dOs, DS, dout + (size_t)bh * Sq * D, q0, Sq, D, 1.f);
  int sid_q[4] = {}, sid_kv[4] = {};
  if constexpr (SEG) fa_seg4(sid_q, seg_q + (size_t)bh * Sq, q0 + ty, Sq);
  float row_lse[4], row_delta[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    row_lse[i] = qi < Sq ? lse[(size_t)bh * Sq + qi] : 0.f;
    row_delta[i] = qi < Sq ? delta[(size_t)bh * Sq + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + FA_B, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  for (int j0 = 0; j0 < kv_end; j0 += FA_B) {
    if constexpr (SEG) {
      fa_seg4(sid_kv, seg_kv + (size_t)kvh * Skv, j0 + tx, Skv);
      if (!__syncthreads_or(fa_any_pair(q0 + ty, j0 + tx, true, sid_q,
                                        sid_kv, Sq, Skv, causal)))
        continue;
    } else {
      __syncthreads();
    }
    fa_load<T, DP>(Ks, DS, kb, j0, Skv, D, 1.f);
    fa_load<T, DP>(Vs, DS, vb, j0, Skv, D, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    fa_abt<DP>(Qs, Ks, s, ty, tx);
    fa_abt<DP>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool vis = fa_pair<SEG>(qi, j0 + tx + 16 * j, Sq, Skv, causal,
                                      sid_q[i], sid_kv[j]);
        const float p = vis ? expf(s[i][j] - row_lse[i]) : 0.f;
        Ps[(ty + 16 * i) * FA_PS + tx + 16 * j] = p * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();
    fa_pm<DP>(Ps, Ks, DS, acc, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    T* o = dq + ((size_t)bh * Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) o[d] = from_f<T>(acc[i][c] * scale);
    }
  }
}

// -------------------------------------------------------------------- dk/dv
template <int DP>
constexpr size_t fa_dkv_smem() {
  // K, V, Q, dO [64][DP + 1]; P / dS [64][65]; lse, delta [64]
  return sizeof(float) * (4 * FA_B * (DP + 1) + FA_B * FA_PS + 2 * FA_B);
}

template <typename T, int DP, bool SEG>
__global__ void __launch_bounds__(FA_THREADS)
    fa_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ seg_q,
                  const int* __restrict__ seg_kv, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int Sq, int Skv, int H, int Hkv, int D,
                  int causal, float scale) {
  constexpr int DS = DP + 1, NC = DP / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + FA_B * DS;
  float* Qs = Vs + FA_B * DS;
  float* dOs = Qs + FA_B * DS;
  float* Ps = dOs + FA_B * DS;
  float* lse_s = Ps + FA_B * FA_PS;
  float* delta_s = lse_s + FA_B;

  const int kvh = blockIdx.y;
  const int b = kvh / Hkv, g = kvh - b * Hkv;
  const int rep = H / Hkv;
  const int k0 = blockIdx.x * FA_B;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  fa_load<T, DP>(Ks, DS, k + (size_t)kvh * Skv * D, k0, Skv, D, 1.f);
  fa_load<T, DP>(Vs, DS, v + (size_t)kvh * Skv * D, k0, Skv, D, 1.f);
  // rows of the transposed tiles are keys, columns queries
  int sid_kv[4] = {}, sid_q[4] = {};
  if constexpr (SEG)
    fa_seg4(sid_kv, seg_kv + (size_t)kvh * Skv, k0 + ty, Skv);
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // q tiles that can see this kv tile: from the one holding row k0 down
  const int q_begin = causal ? (k0 / FA_B) * FA_B : 0;
  for (int r = 0; r < rep; ++r) {
    const int bh = b * H + g * rep + r;
    const T* qb = q + (size_t)bh * Sq * D;
    const T* ob = dout + (size_t)bh * Sq * D;
    for (int q0 = q_begin; q0 < Sq; q0 += FA_B) {
      if constexpr (SEG) {
        fa_seg4(sid_q, seg_q + (size_t)bh * Sq, q0 + tx, Sq);
        // also: the previous tile's readers are done
        if (!__syncthreads_or(fa_any_pair(k0 + ty, q0 + tx, false, sid_kv,
                                          sid_q, Sq, Skv, causal)))
          continue;
      } else {
        __syncthreads();  // the previous tile's readers are done
      }
      fa_load<T, DP>(Qs, DS, qb, q0, Sq, D, scale);
      fa_load<T, DP>(dOs, DS, ob, q0, Sq, D, 1.f);
      for (int t = threadIdx.x; t < FA_B; t += FA_THREADS) {
        const int qi = q0 + t;
        lse_s[t] = qi < Sq ? lse[(size_t)bh * Sq + qi] : 0.f;
        delta_s[t] = qi < Sq ? delta[(size_t)bh * Sq + qi] : 0.f;
      }
      __syncthreads();
      // transposed tiles: rows are keys (ty + 16i), columns queries
      float st[4][4], dpt[4][4];
      fa_abt<DP>(Ks, Qs, st, ty, tx);
      fa_abt<DP>(Vs, dOs, dpt, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j;
          const bool vis = fa_pair<SEG>(q0 + qc, kj, Sq, Skv, causal,
                                        sid_q[j], sid_kv[i]);
          const float p = vis ? expf(st[i][j] - lse_s[qc]) : 0.f;
          Ps[(ty + 16 * i) * FA_PS + qc] = p;
          st[i][j] = p * (dpt[i][j] - delta_s[qc]);  // dS^T, kept for dk
        }
      }
      __syncthreads();
      fa_pm<DP>(Ps, dOs, DS, dv_acc, ty, tx);  // dv += P^T dO
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ps[(ty + 16 * i) * FA_PS + tx + 16 * j] = st[i][j];
      __syncthreads();
      fa_pm<DP>(Ps, Qs, DS, dk_acc, ty, tx);  // dk += dS^T (q * scale)
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= Skv) continue;
    const size_t row = ((size_t)kvh * Skv + kj) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dk[row + d] = from_f<T>(dk_acc[i][c]);
        dv[row + d] = from_f<T>(dv_acc[i][c]);
      }
    }
  }
}

// ------------------------------------------- dq and dk/dv on the tensor cores
// bf16 only (fp32 keeps fa_dq_kernel / fa_dkv_kernel above: on the tensor
// cores it would mean TF32). Every product is an m16n8k16 mma, bf16 in and
// f32 accumulators, with fragments by ldmatrix from padded shared rows
// (tile_stride) filled by cp.async, double-buffered along the walk.
//
//   dq kernel   a block of FB_WARPS warps owns FB_ROWS query rows of one
//               head, 16 rows a warp, and walks the kv tiles (FB_TILE
//               keys) its rows can see. Per tile and warp: S = Q K^T and
//               dP = dO V^T (Q, dO, K, V fragments by ldmatrix), then
//               p = 2^(s * scale * log2 e - lse * log2 e) in f32, masked
//               pairs 0, dS = p (dP - delta), and dQ += dS K with dS's C
//               fragments repacked in registers as the A fragments (bf16)
//               and K through ldmatrix.trans. dq = scale * dQ at the end.
//   dk/dv kernel
//               a block owns FB_ROWS keys of one kv head, 16 a warp, and
//               walks the rep query heads x the query tiles (FB_TILE
//               rows) that can see them. Per tile and warp the transposed
//               products, rows = keys: S^T = K Q^T, P^T in f32 (lse and
//               delta staged beside the q tile), dV += P^T dO (P^T's C
//               fragments as bf16 A fragments, dO through ldmatrix.trans),
//               dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q.
//               dk = scale * dK at the end.
//
// Filling the card: grid.x is the (batch x) head, grid.y the block's rank
// by causal work, heaviest first. Where the dk/dv blocks alone fill the
// card less than twice (GQA: Hkv heads only), each block's walk splits
// into grid.z parts that leave f32 sums, merged in part order by
// fb_dkv_combine_kernel in the same call (the wrapper's dkv_splits).
//
// Bound and measure (chip_smoke.py, NVIDIA H100 80GB HBM3, PERF.md): at
// Llama-2-7B heads, S = 4096 causal, dq 0.79-0.81 ms and dk/dv 1.06-1.08
// ms against 0.21 and 0.28 ms of operations (SDPA's whole backward ~0.80);
// a warp issues ~120-144 ldmatrix.x4 for 192-256 mma.sync a tile, so
// shared-memory reads, not the tensor cores, are the likely limit.
//
// Precision (tools/torch_flash_bwd_rounding.py, PERF.md): the scale enters
// in f32, in the exponent, never on a bf16 q; P and dS are rounded once to
// bf16 as mma operands (their hi + lo split buys nothing against the 2e-2
// gradient check); every sum is f32.
//
// No atomics: each output element is summed by one thread in a fixed
// order, so gradients repeat bit for bit. Segment ids (SEG): each pair is
// masked exactly by its two ids (the kv tile's ids, or the q tile's, ride
// beside it in shared memory); a whole tile is skipped, before it is
// loaded, when the id ranges of its 64-row pieces cannot meet the block's
// (tables `rng_q` / `rng_kv` of (min, max) per FB_SEG_TILE rows, built by
// the wrapper); in dk/dv a tile whose ranges are both the one same id skips
// the per-pair id test. The walk's bits (visit, mixed ids) are made once
// at the block's start, a ballot per 32 tiles, so every thread finds the
// next tile the same way without a barrier. With one segment nothing is
// skipped and the variant computes the native kernels' values bit for bit.
constexpr int FB_WARPS = 8;
constexpr int FB_THREADS = FB_WARPS * 32;
constexpr int FB_ROWS = FB_WARPS * 16;  // rows a block owns: q (dq), k (dk/dv)
constexpr int FB_TILE = 64;             // rows a tile of the walk holds
constexpr int FB_SEG_TILE = 64;         // rows per (min, max) id range
static_assert(FB_ROWS % FB_SEG_TILE == 0 && FB_TILE == FB_SEG_TILE,
              "a walk tile is one range, a block's rows whole ranges");
using bf16 = __nv_bfloat16;

// A fragments (16 rows x 16 k) of a row-major shared tile: rows r0..,
// columns (k) c0..
__device__ __forceinline__ void frag_a(const bf16* t, int sr, int r0, int c0,
                                       uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(smem_addr(t + (r0 + (lane & 15)) * sr + c0 + (lane >> 4) * 8), a[0],
          a[1], a[2], a[3]);
}

// B fragments of two n-tiles (b0, b1: n0..n0+7; b2, b3: n0+8..n0+15) of a
// shared tile stored n-major ([n][k], rows n0.., columns k0..k0+15)
__device__ __forceinline__ void frag_b(const bf16* t, int sr, int n0, int k0,
                                       uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(smem_addr(t + (n0 + (lane >> 4) * 8 + (lane & 7)) * sr + k0 +
                    ((lane >> 3) & 1) * 8),
          b[0], b[1], b[2], b[3]);
}

// the same from a tile stored k-major ([k][n], rows k0..k0+15, columns
// n0..n0+15), through ldmatrix.trans
__device__ __forceinline__ void frag_bt(const bf16* t, int sr, int k0, int n0,
                                        uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(smem_addr(t + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * sr +
                          n0 + (lane >> 4) * 8),
                b[0], b[1], b[2], b[3]);
}

// c[n] += A B over the head dim for a warp's 16 rows (A rows r0.. of `at`)
// against NT n-tiles (B rows 0.. of `bt`, stored n-major): S = Q K^T,
// dP = dO V^T and their transposes
template <int DP, int NT>
__device__ __forceinline__ void fb_abt(const bf16* at, const bf16* bt, int r0,
                                       float (&c)[NT][4]) {
  constexpr int SR = tile_stride(DP);
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    uint32_t a[4];
    frag_a(at, SR, r0, kd * 16, a);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      frag_b(bt, SR, np * 16, kd * 16, b);
      mma_bf16(c[2 * np], a, b[0], b[1]);
      mma_bf16(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  return bf16x2_bits(__floats2bfloat162_rn(x0, x1));
}

// acc += X M for a warp's 16 rows: X (16 x 16 KT) in C fragments x[2 KT]
// (rounded once to bf16 as A fragments), M (16 KT rows of `mt`, stored
// k-major, head-dim columns) through ldmatrix.trans: dQ += dS K,
// dV += P^T dO, dK += dS^T Q
template <int DP, int KT>
__device__ __forceinline__ void fb_pm(const float (&x)[2 * KT][4],
                                      const bf16* mt,
                                      float (&acc)[DP / 8][4]) {
  constexpr int SR = tile_stride(DP);
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t b[4];
      frag_bt(mt, SR, kk * 16, dp * 16, b);
      mma_bf16(acc[2 * dp], a, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// rows [r0, r0 + nrows) of one (n, D) matrix of a head (row i at element
// (base + i) * D) into shared rows of tile_stride(DP); rows past n zeros
template <int DP>
__device__ __forceinline__ void fb_copy_tile(bf16* dst, const bf16* src,
                                             long long base, int r0, int n,
                                             int nrows, int D, int unit) {
  auto id = [=](int r) -> long long {
    return r0 + r < n ? base + r0 + r : -1ll;
  };
  if (unit == 16 && D == DP)
    copy_rows16<DP / 8>(dst, tile_stride(DP), src, nrows, id);
  else
    copy_rows(dst, tile_stride(DP), src, D, nrows, id, unit);
}

// the same for one 4-byte value a row (lse, delta, segment ids)
template <typename E>
__device__ __forceinline__ void fb_copy_vec(E* dst, const E* src,
                                            long long base, int r0, int n,
                                            int nrows) {
  auto id = [=](int r) -> long long {
    return r0 + r < n ? base + r0 + r : -1ll;
  };
  copy_rows(dst, 1, src, 1, nrows, id, 4);
}

// zero the head-dim padding (columns D..DP) of `rows` shared rows: copies
// never write it
template <int DP>
__device__ __forceinline__ void fb_zero_pad(bf16* t, int rows, int D) {
  constexpr int SR = tile_stride(DP);
  if (D < DP)
    for (int idx = threadIdx.x; idx < rows * DP; idx += blockDim.x) {
      const int r = idx / DP, d = idx - r * DP;
      if (d >= D) t[r * SR + d] = __float2bfloat16(0.f);
    }
}

// stage `rows` f32 C-fragment rows of the warps (warp w's rows 16w + g and
// + 8, x[n] at columns 8n + 2t) times `mul` as bf16 into the shared tile
template <int DP>
__device__ __forceinline__ void fb_stage(bf16* t, const float (&x)[DP / 8][4],
                                         float mul) {
  constexpr int SR = tile_stride(DP);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* row = t + (warp * 16 + (lane >> 2)) * SR + 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(row + n * 8) =
        __floats2bfloat162_rn(x[n][0] * mul, x[n][1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(row + 8 * SR + n * 8) =
        __floats2bfloat162_rn(x[n][2] * mul, x[n][3] * mul);
  }
}

// store shared rows [0, nrows) to rows r0.. of one (n, D) matrix (rows
// past n dropped)
template <int DP>
__device__ __forceinline__ void fb_store_tile(bf16* dst, const bf16* t,
                                              long long base, int r0, int n,
                                              int nrows, int D, int unit) {
  const int row_bytes = D * (int)sizeof(bf16);
  const int upr = row_bytes / unit;
  for (int c = threadIdx.x; c < nrows * upr; c += blockDim.x) {
    const int r = c / upr, off = (c - r * upr) * unit;
    if (r0 + r >= n) continue;
    store_unit(reinterpret_cast<char*>(dst) + (base + r0 + r) * row_bytes + off,
               reinterpret_cast<const char*>(t + r * tile_stride(DP)) + off,
               unit);
  }
}

__device__ __forceinline__ bool fb_meet(int2 a, int2 b) {
  return max(a.x, b.x) <= min(a.y, b.y);
}

// the id range of rows [r0, r0 + FB_ROWS) of one range table row (n rows)
__device__ __forceinline__ int2 fb_block_range(const int2* __restrict__ rng,
                                               int r0, int n) {
  int2 r = __ldg(rng + r0 / FB_SEG_TILE);
#pragma unroll
  for (int i = 1; i < FB_ROWS / FB_SEG_TILE; ++i)
    if (r0 + i * FB_SEG_TILE < n) {
      const int2 o = __ldg(rng + r0 / FB_SEG_TILE + i);
      r = make_int2(min(r.x, o.x), max(r.y, o.y));
    }
  return r;
}

// the words of a walk's bits for n steps
__host__ __device__ constexpr int fb_words(int n) { return (n + 31) / 32; }

// The walk's bits for its n steps, from the block's id range `own` and the
// range other(s) of step s's tile: visit bit s when the two meet; and
// where `mixed` is given, mixed bit s when, besides, they are not both the
// one same id (the step's pairs need their ids tested). One ballot per 32
// steps; publish with a barrier.
template <typename Other>
__device__ __forceinline__ void fb_walk_bits(unsigned* visit,
                                             unsigned* mixed, int n,
                                             int2 own, const Other& other) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int w = warp; w * 32 < n; w += FB_WARPS) {
    const int s = w * 32 + lane;
    const int2 o = s < n ? other(s) : make_int2(1, 0);  // empty
    const bool meet = s < n && fb_meet(own, o);
    const bool one = own.x == own.y && o.x == o.y && own.x == o.x;
    const unsigned m = __ballot_sync(0xffffffffu, meet);
    const unsigned x = __ballot_sync(0xffffffffu, meet && !one);
    if (lane == 0) {
      visit[w] = m;
      if (mixed) mixed[w] = x;
    }
  }
}

__device__ __forceinline__ bool fb_bit(const unsigned* bits, int s) {
  return (bits[s >> 5] >> (s & 31)) & 1u;
}

// the first step >= from with its bit set, or n
__device__ __forceinline__ int fb_next(const unsigned* bits, int from, int n) {
  for (int w = from >> 5; w * 32 < n; ++w) {
    unsigned m = bits[w];
    if (w == (from >> 5)) m &= 0xffffffffu << (from & 31);
    if (m) return w * 32 + __ffs(m) - 1;
  }
  return n;
}

// dynamic shared memory: the block's two tiles (Q, dO for dq; K, V for
// dk/dv), two stages of the walk's two tiles, two stages of FB_TILE f32
// or int32 values (dk/dv: lse, delta, segment ids; dq: segment ids), and
// the walk's visit and mixed bits (SEG): 139-141 KB at DP = 128
template <int DP>
__host__ __device__ constexpr size_t fb_smem_bytes(int walk_steps) {
  return sizeof(bf16) * tile_stride(DP) * (2 * FB_ROWS + 4 * FB_TILE) +
         sizeof(float) * 3 * 2 * FB_TILE +
         sizeof(unsigned) * 2 * fb_words(walk_steps);
}

template <int DP, bool SEG>
__global__ void __launch_bounds__(FB_THREADS, 1)
    fb_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_kv,
                 const int2* __restrict__ rng_q,
                 const int2* __restrict__ rng_kv,
                 const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int Sq, int Skv, int H, int Hkv, int D, int causal,
                 float scale, int unit) {
  constexpr int SR = tile_stride(DP), NK = FB_TILE / 8;
  extern __shared__ __align__(16) unsigned char fb_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fb_smem);     // [ROWS][SR]
  bf16* dOs = Qs + FB_ROWS * SR;                   // [ROWS][SR]
  bf16* Ks = dOs + FB_ROWS * SR;                   // [2][TILE][SR]
  bf16* Vs = Ks + 2 * FB_TILE * SR;                // [2][TILE][SR]
  int* kv_ids = reinterpret_cast<int*>(Vs + 2 * FB_TILE * SR);  // [2][TILE]
  unsigned* bits = reinterpret_cast<unsigned*>(kv_ids + 6 * FB_TILE);

  const int bh = blockIdx.x;
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  // heaviest (longest causal walk) tiles first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * FB_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float scale2 = scale * LOG2E;
  const long long qbase = (long long)bh * Sq, kbase = (long long)kvh * Skv;

  const int q_last = min(q0 + FB_ROWS, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int n_tiles = (kv_end + FB_TILE - 1) / FB_TILE;

  fb_zero_pad<DP>(Qs, 2 * FB_ROWS + 4 * FB_TILE, D);
  fb_copy_tile<DP>(Qs, q, qbase, q0, Sq, FB_ROWS, D, unit);
  fb_copy_tile<DP>(dOs, dout, qbase, q0, Sq, FB_ROWS, D, unit);
  cp_async_commit();
  if constexpr (SEG) {
    const int2 qr = fb_block_range(rng_q + bh * ((Sq + FB_SEG_TILE - 1) /
                                                 FB_SEG_TILE), q0, Sq);
    const int2* kr = rng_kv + kvh * ((Skv + FB_SEG_TILE - 1) / FB_SEG_TILE);
    fb_walk_bits(bits, nullptr, n_tiles, qr,
                 [&](int s) { return __ldg(kr + s); });
  }
  // this thread's rows g and g + 8 of its warp: lse (log2 units), delta
  // and segment ids
  const int wr0 = q0 + warp * 16;
  float lse2[2], dlt[2];
  int sid[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = wr0 + g + 8 * i;
    lse2[i] = qi < Sq ? lse[qbase + qi] * LOG2E : 0.f;
    dlt[i] = qi < Sq ? delta[qbase + qi] : 0.f;
    if constexpr (SEG) sid[i] = qi < Sq ? seg_q[qbase + qi] : 0;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  __syncthreads();  // the skip bits

  auto next = [&](int from) {
    if constexpr (SEG) return fb_next(bits, from, n_tiles);
    else return from;
  };
  auto load = [&](int tile, int stage) {
    const int j0 = tile * FB_TILE;
    fb_copy_tile<DP>(Ks + stage * FB_TILE * SR, k, kbase, j0, Skv, FB_TILE,
                     D, unit);
    fb_copy_tile<DP>(Vs + stage * FB_TILE * SR, v, kbase, j0, Skv, FB_TILE,
                     D, unit);
    if constexpr (SEG)
      fb_copy_vec(kv_ids + stage * FB_TILE, seg_kv, kbase, j0, Skv,
                  FB_TILE);
  };
  int tile = next(0), stage = 0;
  if (tile < n_tiles) load(tile, 0);
  cp_async_commit();
  const int wr_last = min(wr0 + 15, Sq - 1);
  while (tile < n_tiles) {
    const int tn = next(tile + 1);
    cp_async_wait<0>();
    __syncthreads();  // tile landed; the other stage's readers are done
    if (tn < n_tiles) load(tn, stage ^ 1);
    cp_async_commit();
    const int j0 = tile * FB_TILE;
    if (wr0 < Sq && (!causal || j0 <= wr_last)) {
      const bf16* Kt = Ks + stage * FB_TILE * SR;
      const bf16* Vt = Vs + stage * FB_TILE * SR;
      float s[NK][4], dp[NK][4];
      fb_abt<DP, NK>(Qs, Kt, warp * 16, s);
      fb_abt<DP, NK>(dOs, Vt, warp * 16, dp);
      // mask where the tile straddles this warp's diagonal or the kv end,
      // and everywhere with segment ids (measured on the H100: testing the
      // ids only on mixed tiles, or the masked and unmasked loops apart,
      // made this kernel slower, unlike dk/dv)
      const bool masked = SEG || j0 + FB_TILE > Skv ||
                          (causal && j0 + FB_TILE - 1 > wr0);
      const int* ids = kv_ids + stage * FB_TILE;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, col = n * 8 + 2 * t4 + (e & 1);
          float p = exp2_approx(fmaf(s[n][e], scale2, -lse2[i]));
          if (masked) {
            const int kj = j0 + col, qi = wr0 + g + 8 * i;
            const bool vis = kj < Skv && (!causal || kj <= qi) &&
                             (!SEG || sid[i] == ids[col]);
            if (!vis) p = 0.f;
          }
          s[n][e] = p * (dp[n][e] - dlt[i]);  // dS
        }
      }
      fb_pm<DP, FB_TILE / 16>(s, Kt, acc);  // dQ += dS K
    }
    tile = tn;
    stage ^= 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the Q tile
  fb_stage<DP>(Qs, acc, scale);
  __syncthreads();
  fb_store_tile<DP>(dq, Qs, qbase, q0, Sq, FB_ROWS, D, unit);
}

template <int DP, bool SEG>
__global__ void __launch_bounds__(FB_THREADS, 1)
    fb_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ seg_q,
                  const int* __restrict__ seg_kv,
                  const int2* __restrict__ rng_q,
                  const int2* __restrict__ rng_kv,
                  const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, float* __restrict__ part, int Sq,
                  int Skv, int H, int Hkv, int D, int causal, float scale,
                  int unit) {
  constexpr int SR = tile_stride(DP), NQ = FB_TILE / 8;
  extern __shared__ __align__(16) unsigned char fb_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(fb_smem);     // [ROWS][SR]
  bf16* Vs = Ks + FB_ROWS * SR;                    // [ROWS][SR]
  bf16* Qs = Vs + FB_ROWS * SR;                    // [2][TILE][SR]
  bf16* dOs = Qs + 2 * FB_TILE * SR;               // [2][TILE][SR]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * FB_TILE * SR);
  float* dl_s = lse_s + 2 * FB_TILE;               // [2][TILE] each
  int* q_ids = reinterpret_cast<int*>(dl_s + 2 * FB_TILE);
  unsigned* bits = reinterpret_cast<unsigned*>(q_ids + 2 * FB_TILE);

  const int kvh = blockIdx.x;
  const int b = kvh / Hkv, grp = kvh - b * Hkv, rep = H / Hkv;
  const int k0 = blockIdx.y * FB_ROWS;  // the first kv tiles walk longest
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float scale2 = scale * LOG2E;
  const long long kbase = (long long)kvh * Skv;

  // the walk: rep heads x the q tiles from the one holding row k0 on
  const int qt0 = causal ? k0 / FB_TILE : 0;
  const int nq = max((Sq + FB_TILE - 1) / FB_TILE - qt0, 0);
  const int n_steps = rep * nq;
  unsigned* mixed = bits + fb_words(n_steps);  // after the visit bits
  // with a split (gridDim.z > 1) this block walks part blockIdx.z of them
  const int s_end =
      (int)((long long)n_steps * (blockIdx.z + 1) / gridDim.z);
  auto head_of = [&](int step) { return b * H + grp * rep + step / nq; };
  auto q0_of = [&](int step) { return (qt0 + step % nq) * FB_TILE; };

  fb_zero_pad<DP>(Ks, 2 * FB_ROWS + 4 * FB_TILE, D);
  fb_copy_tile<DP>(Ks, k, kbase, k0, Skv, FB_ROWS, D, unit);
  fb_copy_tile<DP>(Vs, v, kbase, k0, Skv, FB_ROWS, D, unit);
  cp_async_commit();
  if constexpr (SEG) {
    const int nqr = (Sq + FB_SEG_TILE - 1) / FB_SEG_TILE;
    const int2 kr = fb_block_range(
        rng_kv + kvh * ((Skv + FB_SEG_TILE - 1) / FB_SEG_TILE), k0, Skv);
    fb_walk_bits(bits, mixed, n_steps, kr, [&](int s) {
      return __ldg(rng_q + head_of(s) * nqr + q0_of(s) / FB_SEG_TILE);
    });
  }
  const int wk0 = k0 + warp * 16;
  int kid[2] = {0, 0};
  if constexpr (SEG)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kj = wk0 + g + 8 * i;
      kid[i] = kj < Skv ? seg_kv[kbase + kj] : 0;
    }
  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }
  __syncthreads();  // the skip bits

  auto next = [&](int from) {
    if constexpr (SEG) return fb_next(bits, from, s_end);
    else return from;
  };
  auto load = [&](int step, int stage) {
    const long long qbase = (long long)head_of(step) * Sq;
    const int q0 = q0_of(step);
    fb_copy_tile<DP>(Qs + stage * FB_TILE * SR, q, qbase, q0, Sq, FB_TILE,
                     D, unit);
    fb_copy_tile<DP>(dOs + stage * FB_TILE * SR, dout, qbase, q0, Sq,
                     FB_TILE, D, unit);
    fb_copy_vec(lse_s + stage * FB_TILE, lse, qbase, q0, Sq, FB_TILE);
    fb_copy_vec(dl_s + stage * FB_TILE, delta, qbase, q0, Sq, FB_TILE);
    if constexpr (SEG)
      fb_copy_vec(q_ids + stage * FB_TILE, seg_q, qbase, q0, Sq, FB_TILE);
  };
  int step = next((int)((long long)n_steps * blockIdx.z / gridDim.z));
  int stage = 0;
  if (step < s_end) load(step, 0);
  cp_async_commit();
  while (step < s_end) {
    const int sn = next(step + 1);
    cp_async_wait<0>();
    __syncthreads();  // tile landed; the other stage's readers are done
    if (sn < s_end) load(sn, stage ^ 1);
    cp_async_commit();
    const int q0 = q0_of(step);
    if (wk0 < Skv && (!causal || wk0 <= q0 + FB_TILE - 1)) {
      const bf16* Qt = Qs + stage * FB_TILE * SR;
      const bf16* dOt = dOs + stage * FB_TILE * SR;
      const float* ls = lse_s + stage * FB_TILE;
      const float* dl = dl_s + stage * FB_TILE;
      const int* ids = q_ids + stage * FB_TILE;
      // transposed tiles: rows are this warp's keys, columns queries
      float st[NQ][4], dpt[NQ][4];
      fb_abt<DP, NQ>(Ks, Qt, warp * 16, st);
      // mask where the tile straddles this warp's diagonal or an end, or
      // holds more than one segment id
      const bool masked = (SEG && fb_bit(mixed, step)) ||
                          q0 + FB_TILE > Sq || wk0 + 16 > Skv ||
                          (causal && wk0 + 15 > q0);
      // P^T; the masked and unmasked loops apart, each straight-line code
      auto pt = [&](auto mask) {
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, col = n * 8 + 2 * t4 + (e & 1);
            float p = exp2_approx(fmaf(st[n][e], scale2, -ls[col] * LOG2E));
            if constexpr (decltype(mask)::value) {
              const int qi = q0 + col, kj = wk0 + g + 8 * i;
              const bool vis = qi < Sq && kj < Skv &&
                               (!causal || kj <= qi) &&
                               (!SEG || kid[i] == ids[col]);
              p = vis ? p : 0.f;
            }
            st[n][e] = p;
          }
        }
      };
      if (masked) pt(std::true_type{});
      else pt(std::false_type{});
      fb_pm<DP, FB_TILE / 16>(st, dOt, dv_acc);  // dV += P^T dO
      fb_abt<DP, NQ>(Vs, dOt, warp * 16, dpt);
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[n][e] *= dpt[n][e] - dl[n * 8 + 2 * t4 + (e & 1)];  // dS^T
      fb_pm<DP, FB_TILE / 16>(st, Qt, dk_acc);  // dK += dS^T Q
    }
    step = sn;
    stage ^= 1;
  }
  cp_async_wait<0>();
  if (gridDim.z > 1) {
    // this part's f32 sums (dk unscaled) for fb_dkv_combine_kernel:
    // part[z][0 = dk, 1 = dv][kv row][D]
    const size_t n = (size_t)gridDim.x * Skv * D;
    float* pk = part + (size_t)blockIdx.z * 2 * n;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kj = wk0 + g + 8 * i;
      if (kj >= Skv) continue;
      const size_t row = (size_t)(kbase + kj) * D;
#pragma unroll
      for (int c = 0; c < DP / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = c * 8 + 2 * t4 + e;
          if (d >= D) continue;
          pk[row + d] = dk_acc[c][2 * i + e];
          pk[n + row + d] = dv_acc[c][2 * i + e];
        }
    }
    return;
  }
  __syncthreads();  // every warp is done with the K and V tiles
  fb_stage<DP>(Ks, dk_acc, scale);
  fb_stage<DP>(Vs, dv_acc, 1.f);
  __syncthreads();
  fb_store_tile<DP>(dk, Ks, kbase, k0, Skv, FB_ROWS, D, unit);
  fb_store_tile<DP>(dv, Vs, kbase, k0, Skv, FB_ROWS, D, unit);
}

// ----------------------------------------------- forward on the tensor cores
// bf16 only (fp32 keeps fa_fwd_kernel above). A block of FB_WARPS warps
// owns FB_ROWS query rows of one head, 16 a warp, and walks the kv tiles
// (FF_TILE keys, double-buffered by cp.async) its rows can see; each
// warp keeps its rows' online softmax (m, l), the f32 output accumulator
// and Q's A fragments in registers (FlashAttention-2's shape, as
// prefill_mma.cuh's routine for #1 and #4, here on the (BH, S, D) layout
// with the lse out, the non-causal walk and segment ids). Per tile and
// warp:
//
//   S = Q K^T     mma.m16n8k16 bf16 -> f32, K's B fragments by ldmatrix;
//                 the softmax scale (times log2 e, for ex2) enters in f32,
//                 in the exponent, never on a pre-rounded bf16 q;
//   O += P V      P about 16 bits wide: P_hi V + P_lo V, P_hi = bf16(p),
//                 P_lo = bf16(p - P_hi), two mmas a k-step, V's B
//                 fragments by ldmatrix.trans; l sums the unrounded f32 p.
//                 One bf16 P misses the forward's 1e-3 + one bf16 ulp
//                 check even at a spread q (tools/torch_flash_fwd_rounding
//                 .py, PERF.md).
//
// m is kept in raw score units; the lse is m * scale + ln l (natural log,
// the backward reads it), 0 for a row that saw no key, which emits zeros
// (JAX's guards). Only tiles that straddle the causal diagonal, the kv end
// or (SEG) a mixed segment boundary are masked pair by pair. Segment ids
// skip whole tiles by fb_walk_bits, as the dq kernel does (a tile's range
// the union of its FB_SEG_TILE pieces'). The q tile is staged through the
// first K stages and the output through them after the walk. Blocks go
// heaviest first (grid.y reversed when causal). No split of the kv walk:
// at the training shapes the grid holds 4-8 blocks an SM already.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): at
// Llama-2-7B heads, S = 4096 causal, 0.71 ms against SDPA's 0.26 and a
// 0.139 ms operations bound; 235-240 registers, no spills, one block an
// SM. 128-key tiles ran ~7 % faster than 64; a third stage, and tile
// i + 1's Q K^T issued before tile i's softmax, gained 0-3 % and were not
// kept. With 8 warps an SM the K/V fragment reads and the mmas run
// largely in series; FA3's warp-specialized wgmma shape is the next step.
constexpr int FF_TILE = 128;   // keys a tile of the walk (two stages)
static_assert(FF_TILE % FB_SEG_TILE == 0 && 2 * FF_TILE >= FB_ROWS,
              "a tile is whole ranges; the q tile fits the K stages");

template <int DP>
__host__ __device__ constexpr size_t ff_smem_bytes(int walk_steps) {
  return sizeof(bf16) * tile_stride(DP) * 4 * FF_TILE +
         sizeof(int) * 2 * FF_TILE +
         sizeof(unsigned) * 2 * fb_words(walk_steps);
}

template <int DP, bool SEG>
__global__ void __launch_bounds__(FB_THREADS, 1)
    fb_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ seg_q,
                  const int* __restrict__ seg_kv,
                  const int2* __restrict__ rng_q,
                  const int2* __restrict__ rng_kv, bf16* __restrict__ out,
                  float* __restrict__ lse, int Sq, int Skv, int H, int Hkv,
                  int D, int causal, float scale, int unit) {
  constexpr int SR = tile_stride(DP), NK = FF_TILE / 8, KD = DP / 16;
  constexpr int ND = DP / 8, PIECES = FF_TILE / FB_SEG_TILE;
  extern __shared__ __align__(16) unsigned char fb_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(fb_smem);     // [2][TILE][SR]
  bf16* Vs = Ks + 2 * FF_TILE * SR;                // [2][TILE][SR]
  int* kv_ids = reinterpret_cast<int*>(Vs + 2 * FF_TILE * SR);  // [2][TILE]
  unsigned* bits = reinterpret_cast<unsigned*>(kv_ids + 2 * FF_TILE);
  bf16* Qs = Ks;  // [ROWS][SR]: the q tile before the walk, out after it

  const int bh = blockIdx.x;
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  // heaviest (longest causal walk) tiles first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * FB_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float scale2 = scale * LOG2E;
  const long long qbase = (long long)bh * Sq, kbase = (long long)kvh * Skv;

  const int q_last = min(q0 + FB_ROWS, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int n_tiles = (kv_end + FF_TILE - 1) / FF_TILE;
  unsigned* mixed = bits + fb_words(n_tiles);

  fb_zero_pad<DP>(Ks, 4 * FF_TILE, D);
  fb_copy_tile<DP>(Qs, q, qbase, q0, Sq, FB_ROWS, D, unit);
  cp_async_commit();
  if constexpr (SEG) {
    const int2 qr = fb_block_range(rng_q + bh * ((Sq + FB_SEG_TILE - 1) /
                                                 FB_SEG_TILE), q0, Sq);
    const int nkr = (Skv + FB_SEG_TILE - 1) / FB_SEG_TILE;
    const int2* kr = rng_kv + kvh * nkr;
    fb_walk_bits(bits, mixed, n_tiles, qr, [&](int s) {
      int2 r = __ldg(kr + s * PIECES);
#pragma unroll
      for (int i = 1; i < PIECES; ++i)
        if (s * PIECES + i < nkr) {
          const int2 o = __ldg(kr + s * PIECES + i);
          r = make_int2(min(r.x, o.x), max(r.y, o.y));
        }
      return r;
    });
  }
  // this thread's rows g and g + 8 of its warp: segment ids
  const int wr0 = q0 + warp * 16;
  int sid[2] = {0, 0};
  if constexpr (SEG)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = wr0 + g + 8 * i;
      sid[i] = qi < Sq ? seg_q[qbase + qi] : 0;
    }
  cp_async_wait<0>();
  __syncthreads();  // the q tile and the skip bits
  uint32_t qf[KD][4];
  if (wr0 < Sq) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) frag_a(Qs, SR, warp * 16, kd * 16, qf[kd]);
  }
  __syncthreads();  // the q tile is in registers: its memory takes kv

  auto next = [&](int from) {
    if constexpr (SEG) return fb_next(bits, from, n_tiles);
    else return from;
  };
  auto load = [&](int tile, int stage) {
    const int j0 = tile * FF_TILE;
    fb_copy_tile<DP>(Ks + stage * FF_TILE * SR, k, kbase, j0, Skv, FF_TILE,
                     D, unit);
    fb_copy_tile<DP>(Vs + stage * FF_TILE * SR, v, kbase, j0, Skv, FF_TILE,
                     D, unit);
    if constexpr (SEG)
      fb_copy_vec(kv_ids + stage * FF_TILE, seg_kv, kbase, j0, Skv,
                  FF_TILE);
  };
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  // S = Q K^T of the tile in `st`: c[n] holds rows g, g + 8 x keys
  // n * 8 + 2t4, + 1
  auto qk = [&](int st, float (&c)[NK][4]) {
    const bf16* Kt = Ks + st * FF_TILE * SR;
#pragma unroll
    for (int n = 0; n < NK; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t b[4];
        frag_b(Kt, SR, np * 16, kd * 16, b);
        mma_bf16(c[2 * np], qf[kd], b[0], b[1]);
        mma_bf16(c[2 * np + 1], qf[kd], b[2], b[3]);
      }
    }
  };
  // mask the pairs of tile `tile` (in `st`) this warp's rows must not see
  // where it straddles their diagonal or the kv end, or holds more than one
  // segment id
  auto mask = [&](int tile, int st, float (&c)[NK][4]) {
    const int j0 = tile * FF_TILE;
    const bool masked = (SEG && fb_bit(mixed, tile)) ||
                        j0 + FF_TILE > Skv ||
                        (causal && j0 + FF_TILE - 1 > wr0);
    if (!masked) return;
    const int* ids = kv_ids + st * FF_TILE;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = n * 8 + 2 * t4 + (e & 1);
        const int kj = j0 + col, qi = wr0 + g + 8 * i;
        const bool vis = kj < Skv && (!causal || kj <= qi) &&
                         (!SEG || sid[i] == ids[col]);
        if (!vis) c[n][e] = NEG_INF;
      }
    }
  };
  // the online softmax over a masked score tile, then O += P V (V in
  // `st`): p = 2^((s - m) * scale * log2 e)
  auto softmax_pv = [&](int st, float (&c)[NK][4]) {
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(c[n][0], c[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(c[n][2], c[n][3]));
    }
    float alpha[2], msc[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      float m_new = fmaxf(m_r[r], mx[r]);
      if (m_new <= NEG_INF / 2) m_new = 0.f;  // fully masked so far
      alpha[r] = exp2_approx((m_r[r] - m_new) * scale2);
      m_r[r] = m_new;
      msc[r] = m_new * scale2;
    }
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(fmaf(c[n][e], scale2, -msc[e >> 1]));
        rs[e >> 1] += p;
        c[n][e] = p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = alpha[r] * l_r[r] + rs[r];
    // rescale O only when a row's max moved (rarely, after the first tiles)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }
    // 16 keys a k-step; P's C fragments are its A fragments
    const bf16* Vt = Vs + st * FF_TILE * SR;
#pragma unroll
    for (int kk = 0; kk < FF_TILE / 16; ++kk) {
      uint32_t ah[4], al[4];
      split_bf16(c[2 * kk][0], c[2 * kk][1], ah[0], al[0]);
      split_bf16(c[2 * kk][2], c[2 * kk][3], ah[1], al[1]);
      split_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1], ah[2], al[2]);
      split_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t b[4];
        frag_bt(Vt, SR, kk * 16, dp * 16, b);
        mma_bf16(o[2 * dp], ah, b[0], b[1]);
        mma_bf16(o[2 * dp], al, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], ah, b[2], b[3]);
        mma_bf16(o[2 * dp + 1], al, b[2], b[3]);
      }
    }
  };
  int tile = next(0), stage = 0;
  if (tile < n_tiles) load(tile, 0);
  cp_async_commit();
  const int wr_last = min(wr0 + 15, Sq - 1);
  while (tile < n_tiles) {
    const int tn = next(tile + 1);
    cp_async_wait<0>();
    __syncthreads();  // tile landed; the other stage's readers are done
    if (tn < n_tiles) load(tn, stage ^ 1);
    cp_async_commit();
    if (wr0 < Sq && (!causal || tile * FF_TILE <= wr_last)) {
      float sc[NK][4];
      qk(stage, sc);
      mask(tile, stage, sc);
      softmax_pv(stage, sc);
    }
    tile = tn;
    stage ^= 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the walk's tiles

  // out = O / l and lse = m * scale + ln l (a row that saw no key: zeros,
  // lse 0), out staged through the first K stages
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    const float ls = l_r[r] == 0.f ? 1.f : l_r[r];
    const float inv = 1.f / ls;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][2 * r] *= inv;
      o[n][2 * r + 1] *= inv;
    }
    const int qi = wr0 + g + 8 * r;
    const float mf = m_r[r] <= NEG_INF / 2 ? 0.f : m_r[r];
    if (t4 == 0 && qi < Sq) lse[qbase + qi] = mf * scale + logf(ls);
  }
  fb_stage<DP>(Qs, o, 1.f);
  __syncthreads();
  fb_store_tile<DP>(out, Qs, qbase, q0, Sq, FB_ROWS, D, unit);
}

// ------------------------------------------------------------------ launches
template <typename Kernel>
int fa_prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DP, bool SEG>
int fa_fwd(const void* q, const void* k, const void* v, const void* seg_q,
           const void* seg_kv, const void*, const void*, void* out,
           void* lse, int BH, int Sq, int Skv, int H, int Hkv, int D,
           int causal, float scale, cudaStream_t st) {
  const size_t smem = fa_fwd_smem<DP>();
  int rc = fa_prepare(fa_fwd_kernel<T, DP, SEG>, smem);
  if (rc) return rc;
  dim3 grid((Sq + FA_B - 1) / FA_B, BH);
  fa_fwd_kernel<T, DP, SEG><<<grid, FA_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)seg_q,
      (const int*)seg_kv, (T*)out, (float*)lse, Sq, Skv, H, Hkv, D, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int DP, bool SEG>
int fa_dq(const void* q, const void* k, const void* v, const void* seg_q,
          const void* seg_kv, const void*, const void*, const void* dout,
          const void* lse, const void* delta, void* dq, int BH, int Sq,
          int Skv, int H, int Hkv, int D, int causal, float scale,
          cudaStream_t st) {
  const size_t smem = fa_dq_smem<DP>();
  int rc = fa_prepare(fa_dq_kernel<T, DP, SEG>, smem);
  if (rc) return rc;
  dim3 grid((Sq + FA_B - 1) / FA_B, BH);
  fa_dq_kernel<T, DP, SEG><<<grid, FA_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)seg_q,
      (const int*)seg_kv, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dq, Sq, Skv, H, Hkv, D, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DP, bool SEG>
int fa_dkv(const void* q, const void* k, const void* v, const void* seg_q,
           const void* seg_kv, const void*, const void*, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int,
           void*, int BHkv, int Sq, int Skv, int H, int Hkv, int D,
           int causal, float scale, cudaStream_t st) {
  const size_t smem = fa_dkv_smem<DP>();
  int rc = fa_prepare(fa_dkv_kernel<T, DP, SEG>, smem);
  if (rc) return rc;
  dim3 grid((Skv + FA_B - 1) / FA_B, BHkv);
  fa_dkv_kernel<T, DP, SEG><<<grid, FA_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)seg_q,
      (const int*)seg_kv, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, Sq, Skv, H, Hkv, D, causal,
      scale);
  return (int)cudaGetLastError();
}

// dk = scale * sum_z dK_z, dv = sum_z dV_z over the nsplit parts of
// fb_dkv_kernel (n elements each), in part order
__global__ void __launch_bounds__(256)
    fb_dkv_combine_kernel(const float* __restrict__ part,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          size_t n, int nsplit, float scale) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = 0.f, c = 0.f;
    for (int z = 0; z < nsplit; ++z) {
      a += part[2 * z * n + i];
      c += part[(2 * z + 1) * n + i];
    }
    dk[i] = __float2bfloat16(a * scale);
    dv[i] = __float2bfloat16(c);
  }
}

// the narrowest copy piece of the tensors' rows (D bf16 each)
inline int fb_unit(std::initializer_list<const void*> ptrs, int D) {
  int u = 16;
  for (const void* p : ptrs) u = std::min(u, copy_unit(p, (size_t)D * 2));
  return u;
}

template <int DP, bool SEG>
int fb_fwd(const void* q, const void* k, const void* v, const void* seg_q,
           const void* seg_kv, const void* rng_q, const void* rng_kv,
           void* out, void* lse, int BH, int Sq, int Skv, int H, int Hkv,
           int D, int causal, float scale, cudaStream_t st) {
  const size_t smem =
      ff_smem_bytes<DP>(SEG ? (Skv + FF_TILE - 1) / FF_TILE : 0);
  int rc = fa_prepare(fb_fwd_kernel<DP, SEG>, smem);
  if (rc) return rc;
  dim3 grid(BH, (Sq + FB_ROWS - 1) / FB_ROWS);
  fb_fwd_kernel<DP, SEG><<<grid, FB_THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)seg_q,
      (const int*)seg_kv, (const int2*)rng_q, (const int2*)rng_kv,
      (bf16*)out, (float*)lse, Sq, Skv, H, Hkv, D, causal, scale,
      fb_unit({q, k, v, out}, D));
  return (int)cudaGetLastError();
}

template <int DP, bool SEG>
int fb_dq(const void* q, const void* k, const void* v, const void* seg_q,
          const void* seg_kv, const void* rng_q, const void* rng_kv,
          const void* dout, const void* lse, const void* delta, void* dq,
          int BH, int Sq, int Skv, int H, int Hkv, int D, int causal,
          float scale, cudaStream_t st) {
  const size_t smem =
      fb_smem_bytes<DP>(SEG ? (Skv + FB_TILE - 1) / FB_TILE : 0);
  int rc = fa_prepare(fb_dq_kernel<DP, SEG>, smem);
  if (rc) return rc;
  dim3 grid(BH, (Sq + FB_ROWS - 1) / FB_ROWS);
  fb_dq_kernel<DP, SEG><<<grid, FB_THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)seg_q,
      (const int*)seg_kv, (const int2*)rng_q, (const int2*)rng_kv,
      (const bf16*)dout, (const float*)lse, (const float*)delta, (bf16*)dq,
      Sq, Skv, H, Hkv, D, causal, scale, fb_unit({q, k, v, dout, dq}, D));
  return (int)cudaGetLastError();
}

template <int DP, bool SEG>
int fb_dkv(const void* q, const void* k, const void* v, const void* seg_q,
           const void* seg_kv, const void* rng_q, const void* rng_kv,
           const void* dout, const void* lse, const void* delta, void* dk,
           void* dv, int nsplit, void* part, int BHkv, int Sq, int Skv,
           int H, int Hkv, int D, int causal, float scale, cudaStream_t st) {
  const int steps = (H / Hkv) * ((Sq + FB_TILE - 1) / FB_TILE);
  const size_t smem = fb_smem_bytes<DP>(SEG ? steps : 0);
  int rc = fa_prepare(fb_dkv_kernel<DP, SEG>, smem);
  if (rc) return rc;
  dim3 grid(BHkv, (Skv + FB_ROWS - 1) / FB_ROWS, nsplit);
  fb_dkv_kernel<DP, SEG><<<grid, FB_THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)seg_q,
      (const int*)seg_kv, (const int2*)rng_q, (const int2*)rng_kv,
      (const bf16*)dout, (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, (float*)part, Sq, Skv, H, Hkv, D, causal, scale,
      fb_unit({q, k, v, dout, dk, dv}, D));
  if (nsplit > 1) {
    const size_t n = (size_t)BHkv * Skv * D;
    const unsigned blocks = (unsigned)std::min<size_t>((n + 255) / 256,
                                                       (size_t)1 << 20);
    fb_dkv_combine_kernel<<<blocks, 256, 0, st>>>(
        (const float*)part, (bf16*)dk, (bf16*)dv, n, nsplit, scale);
  }
  return (int)cudaGetLastError();
}

inline bool fa_shape_ok(int rows, int Sq, int Skv, int H, int Hkv, int D) {
  return rows > 0 && rows <= 65535 && Sq > 0 && Skv > 0 && H > 0 &&
         Hkv > 0 && H % Hkv == 0 && D > 0 && D <= 128;
}

}  // namespace ptt

// The forward's route: fp32 on the CUDA cores (fa_fwd, padded head dim 64
// or 128), bf16 on the tensor cores (fb_fwd, padded head dim 32, 64, 96 or
// 128).
#define PTT_FA_FWD_SEG(SEG, ...)                                         \
  do {                                                                   \
    if (dtype == ptt::DT_F32 && D <= 64)                                 \
      return ptt::fa_fwd<float, 64, SEG>(__VA_ARGS__);                   \
    if (dtype == ptt::DT_F32)                                            \
      return ptt::fa_fwd<float, 128, SEG>(__VA_ARGS__);                  \
    if (dtype != ptt::DT_BF16) return (int)cudaErrorInvalidValue;        \
    switch (ptt::padded_head_dim(D)) {                                   \
      case 32: return ptt::fb_fwd<32, SEG>(__VA_ARGS__);                 \
      case 64: return ptt::fb_fwd<64, SEG>(__VA_ARGS__);                 \
      case 96: return ptt::fb_fwd<96, SEG>(__VA_ARGS__);                 \
      default: return ptt::fb_fwd<128, SEG>(__VA_ARGS__);                \
    }                                                                    \
  } while (0)

// The backward's: fp32 on the CUDA cores (FA, padded head dim 64 or 128),
// bf16 on the tensor cores (FB, padded head dim 32, 64, 96 or 128).
#define PTT_FA_BWD_SEG(SEG, FA, FB, ...)                                 \
  do {                                                                   \
    if (dtype == ptt::DT_F32 && D <= 64)                                 \
      return ptt::FA<float, 64, SEG>(__VA_ARGS__);                       \
    if (dtype == ptt::DT_F32)                                            \
      return ptt::FA<float, 128, SEG>(__VA_ARGS__);                      \
    if (dtype != ptt::DT_BF16) return (int)cudaErrorInvalidValue;        \
    switch (ptt::padded_head_dim(D)) {                                   \
      case 32: return ptt::FB<32, SEG>(__VA_ARGS__);                     \
      case 64: return ptt::FB<64, SEG>(__VA_ARGS__);                     \
      case 96: return ptt::FB<96, SEG>(__VA_ARGS__);                     \
      default: return ptt::FB<128, SEG>(__VA_ARGS__);                    \
    }                                                                    \
  } while (0)

// segment ids: both id pointers given (the SEG variant), or neither
#define PTT_FA_SEG(ROUTE, ...)                                           \
  do {                                                                   \
    if ((seg_q == nullptr) != (seg_kv == nullptr))                       \
      return (int)cudaErrorInvalidValue;                                 \
    if (seg_q != nullptr) ROUTE(true, __VA_ARGS__);                      \
    ROUTE(false, __VA_ARGS__);                                           \
  } while (0)

// the bf16 segment variants' range tables: given with the ids
inline bool fa_ranges_ok(int dtype, const void* seg_q, const void* rng_q,
                         const void* rng_kv) {
  return dtype != ptt::DT_BF16 || seg_q == nullptr ||
         (rng_q != nullptr && rng_kv != nullptr);
}

// seg_q / seg_kv: nullable int32 segment ids, (BH, Sq) and (BHkv, Skv);
// rng_q / rng_kv: for bf16 with segment ids, int32 (min, max) id pairs of
// every FB_SEG_TILE rows, (BH, ceil(Sq / 64), 2) and (BHkv, ceil(Skv / 64),
// 2); otherwise unused
PTT_EXPORT int ptt_flash_attention_fwd(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* seg_q, const void* seg_kv,
                                       const void* rng_q, const void* rng_kv,
                                       void* out, void* lse, int BH, int Sq,
                                       int Skv, int H, int Hkv, int D,
                                       int causal, float scale,
                                       void* stream) {
  if (!ptt::fa_shape_ok(BH, Sq, Skv, H, Hkv, D) ||
      !fa_ranges_ok(dtype, seg_q, rng_q, rng_kv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  PTT_FA_SEG(PTT_FA_FWD_SEG, q, k, v, seg_q, seg_kv, rng_q, rng_kv, out,
             lse, BH, Sq, Skv, H, Hkv, D, causal, scale, st);
}

// rng_q / rng_kv: the forward's range tables
PTT_EXPORT int ptt_flash_attention_bwd_dq(int dtype, const void* q,
                                          const void* k, const void* v,
                                          const void* seg_q,
                                          const void* seg_kv,
                                          const void* rng_q,
                                          const void* rng_kv,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dq, int BH,
                                          int Sq, int Skv, int H, int Hkv,
                                          int D, int causal, float scale,
                                          void* stream) {
  if (!ptt::fa_shape_ok(BH, Sq, Skv, H, Hkv, D) ||
      !fa_ranges_ok(dtype, seg_q, rng_q, rng_kv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  PTT_FA_SEG(PTT_FA_BWD_SEG, fa_dq, fb_dq, q, k, v, seg_q, seg_kv, rng_q,
             rng_kv, dout, lse, delta, dq, BH, Sq, Skv, H, Hkv, D, causal,
             scale, st);
}

// nsplit: parts each bf16 block's walk is split into (1: none); with more,
// part is f32 scratch of nsplit x 2 x BHkv x Skv x D that a second kernel
// of the same call merges
PTT_EXPORT int ptt_flash_attention_bwd_dkv(int dtype, const void* q,
                                           const void* k, const void* v,
                                           const void* seg_q,
                                           const void* seg_kv,
                                           const void* rng_q,
                                           const void* rng_kv,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk,
                                           void* dv, int nsplit,
                                           void* part, int BHkv, int Sq,
                                           int Skv, int H, int Hkv, int D,
                                           int causal, float scale,
                                           void* stream) {
  if (!ptt::fa_shape_ok(BHkv, Sq, Skv, H, Hkv, D) ||
      !fa_ranges_ok(dtype, seg_q, rng_q, rng_kv) || nsplit < 1 ||
      nsplit > 65535 || (nsplit > 1 && (dtype != ptt::DT_BF16 || !part)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  PTT_FA_SEG(PTT_FA_BWD_SEG, fa_dkv, fb_dkv, q, k, v, seg_q, seg_kv, rng_q,
             rng_kv, dout, lse, delta, dk, dv, nsplit, part, BHkv, Sq, Skv,
             H, Hkv, D, causal, scale, st);
}
