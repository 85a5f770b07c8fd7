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
// bound by operations, ~4·S²·D/2 per causal head forward and 2.5x that
// backward, ~0.14 ms forward for a Llama-2-7B layer in bf16 on the tensor
// cores. This first version computes on the CUDA cores in f32 for both
// input types (67 TFLOP/s peak), so it stays well above that bound: the
// design goal is a kernel that is right at every shape; tensor-core tiles
// (mma.sync / wgmma) and TMA are later work.
//
// Design, shared by the three kernels: 64 x 64 tiles, 256 threads as a
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
// dk/dv: one block per (b * Hkv, kv tile) loops over the `rep` query heads
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
// it is causally visible and both ids are equal. The ids a thread needs are
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
#include "common.cuh"

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

// ------------------------------------------------------------------ launches
template <typename Kernel>
int fa_prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DP, bool SEG>
int fa_fwd(const void* q, const void* k, const void* v, const void* seg_q,
           const void* seg_kv, void* out, void* lse, int BH, int Sq, int Skv,
           int H, int Hkv, int D, int causal, float scale, cudaStream_t st) {
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
          const void* seg_kv, const void* dout, const void* lse,
          const void* delta, void* dq, int BH, int Sq, int Skv, int H,
          int Hkv, int D, int causal, float scale, cudaStream_t st) {
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
           const void* seg_kv, const void* dout, const void* lse,
           const void* delta, void* dk, void* dv, int BHkv, int Sq, int Skv,
           int H, int Hkv, int D, int causal, float scale, cudaStream_t st) {
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

inline bool fa_shape_ok(int rows, int Sq, int Skv, int H, int Hkv, int D) {
  return rows > 0 && rows <= 65535 && Sq > 0 && Skv > 0 && H > 0 &&
         Hkv > 0 && H % Hkv == 0 && D > 0 && D <= 128;
}

}  // namespace ptt

// Dispatch on dtype (0 = f32, 1 = bf16), padded head dim (64 or 128) and
// segment ids (both id pointers given, or neither).
#define PTT_FA_DISPATCH_SEG(FN, SEG, ...)                                \
  do {                                                                   \
    if (dtype == ptt::DT_F32 && D <= 64)                                 \
      return ptt::FN<float, 64, SEG>(__VA_ARGS__);                       \
    if (dtype == ptt::DT_F32)                                            \
      return ptt::FN<float, 128, SEG>(__VA_ARGS__);                      \
    if (dtype == ptt::DT_BF16 && D <= 64)                                \
      return ptt::FN<__nv_bfloat16, 64, SEG>(__VA_ARGS__);               \
    if (dtype == ptt::DT_BF16)                                           \
      return ptt::FN<__nv_bfloat16, 128, SEG>(__VA_ARGS__);              \
    return (int)cudaErrorInvalidValue;                                   \
  } while (0)

#define PTT_FA_DISPATCH(FN, ...)                                         \
  do {                                                                   \
    if ((seg_q == nullptr) != (seg_kv == nullptr))                       \
      return (int)cudaErrorInvalidValue;                                 \
    if (seg_q != nullptr) PTT_FA_DISPATCH_SEG(FN, true, __VA_ARGS__);    \
    PTT_FA_DISPATCH_SEG(FN, false, __VA_ARGS__);                         \
  } while (0)

// seg_q / seg_kv: nullable int32 segment ids, (BH, Sq) and (BHkv, Skv)
PTT_EXPORT int ptt_flash_attention_fwd(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* seg_q, const void* seg_kv,
                                       void* out, void* lse, int BH, int Sq,
                                       int Skv, int H, int Hkv, int D,
                                       int causal, float scale,
                                       void* stream) {
  if (!ptt::fa_shape_ok(BH, Sq, Skv, H, Hkv, D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  PTT_FA_DISPATCH(fa_fwd, q, k, v, seg_q, seg_kv, out, lse, BH, Sq, Skv, H,
                  Hkv, D, causal, scale, st);
}

PTT_EXPORT int ptt_flash_attention_bwd_dq(int dtype, const void* q,
                                          const void* k, const void* v,
                                          const void* seg_q,
                                          const void* seg_kv,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dq, int BH,
                                          int Sq, int Skv, int H, int Hkv,
                                          int D, int causal, float scale,
                                          void* stream) {
  if (!ptt::fa_shape_ok(BH, Sq, Skv, H, Hkv, D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  PTT_FA_DISPATCH(fa_dq, q, k, v, seg_q, seg_kv, dout, lse, delta, dq, BH, Sq,
                  Skv, H, Hkv, D, causal, scale, st);
}

PTT_EXPORT int ptt_flash_attention_bwd_dkv(int dtype, const void* q,
                                           const void* k, const void* v,
                                           const void* seg_q,
                                           const void* seg_kv,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk,
                                           void* dv, int BHkv, int Sq,
                                           int Skv, int H, int Hkv, int D,
                                           int causal, float scale,
                                           void* stream) {
  if (!ptt::fa_shape_ok(BHkv, Sq, Skv, H, Hkv, D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  PTT_FA_DISPATCH(fa_dkv, q, k, v, seg_q, seg_kv, dout, lse, delta, dk, dv,
                  BHkv, Sq, Skv, H, Hkv, D, causal, scale, st);
}
