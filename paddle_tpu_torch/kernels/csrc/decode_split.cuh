// Split-KV (flash-decoding) one-token attention through block tables: the
// routine paged_attention.cu (#2) runs, and the attention phase of the fused
// decode kernels (#3, #5; block_decode.cuh's run()). It spreads the walk
// over a sequence's pages across many blocks and keeps every row in
// registers.
//
// Grid: (batch row x kv head x head group, part). A part is `part_pages`
// consecutive pages of the block table (about 256 keys); a block whose
// part starts at or past its row's length returns at once, so an idle row
// (length 0) launches blocks that only exit. A block serves the RG query
// heads of one group of its kv head (RG the power of two >= rep, at most
// 8; rep > 8 takes several groups) from one read of each K/V row.
//
// A row's length is sl[b] + OWN, clamped to the table: a compile-time
// length offset, 0 for #2 (whose code it leaves as it was) and 1 for the
// fused decode, which also hands over the step's own token, just written
// by its append kernel to the pool at position sl[b], as a row of its own
// (kn/vn, with the int8 scales kns/vns; row b * Hkv + g): the key at
// position sl[b] is read from there, not from the pool, so a row's output
// depends on its own inputs only, even where idle rows' appends meet on
// one slot of the null page. The values are the same bits the pool holds
// (what a re-read gives, as the TPU kernel's _fake_quant_rows).
//
// Inside a block of DS_WARPS warps each half-warp (16 lanes) owns one key
// row at a time: lane i holds elements [i EPL, (i + 1) EPL) of the row
// (EPL = DP / 16), loaded straight from the pool into registers, 16 bytes
// a load for bf16 at D = 128 (8 for an int8 pool, whose row scale rides
// beside it). The 8 half-warps take neighbouring rows, ds_chunk rows each
// a step, all loads of a step issued before any math, so many rows are in
// flight. Scores are dot products over the lane's elements summed by four
// xor shuffles within the half-warp, for each of the block's heads; q is
// pre-multiplied in f32 by scale * log2 e, so the online softmax (m, l)
// and the f32 accumulator (the lane's EPL elements of each head) use ex2
// and stay in registers. A max still <= -1e30 / 2 reads as 0, and a row
// with no key emits zeros. An int8 pool's payload converts exactly to
// f32; the key scale multiplies the dot product and the value scale the
// probability, both in f32.
//
// The block then merges its 8 half-warps' states through shared memory
// (max over the half-warps that saw a key, rescaled sums). With one part
// it writes out = O / l; with more it leaves its part's f32 (O, m, l)
// and decode_split_merge_kernel, in the same call, merges the parts in
// part order (deterministic; the merge reads the lengths on the device to
// know which parts ran, so the host reads none).
//
// q and out are of type TQ: the activation type for #2, f32 for the fused
// decode (its RoPE'd q and attention output live in its f32 scratch).
//
// Bound: bytes (one query token a head: 2 flops a key element). Tensor
// cores are not used: one query row with rep <= 8 fills little of an m16
// tile.
#pragma once

#include "common.cuh"

namespace ptt {

constexpr int DS_WARPS = 4;
constexpr int DS_THREADS = DS_WARPS * 32;
constexpr int DS_LANES = 16;                      // lanes a key row
constexpr int DS_ROWS = DS_THREADS / DS_LANES;    // rows a block takes at once

template <int BYTES> struct DsVec;
template <> struct DsVec<16> { using T = uint4; };
template <> struct DsVec<8> { using T = uint2; };
template <> struct DsVec<4> { using T = uint32_t; };

// the widest load piece of a lane's EPL elements of storage type S (EPL
// >= 4: the padded head dim is 64 or 128)
template <int EPL, typename S>
__host__ __device__ constexpr int ds_unit() {
  constexpr int b = EPL * (int)sizeof(S);
  return b % 16 == 0 ? 16 : b % 8 == 0 ? 8 : 4;
}

// A lane's piece of one pool row, as stored.
template <int EPL, typename S>
struct alignas(ds_unit<EPL, S>()) DsPiece {
  S x[EPL];
};

// rows a half-warp takes a step: fewer where a lane holds 8 heads
template <int RG>
__host__ __device__ constexpr int ds_chunk() {
  return RG >= 8 ? 2 : 4;
}

// Elements [col0, col0 + EPL) of the row at `row` (zeros where !valid or,
// in the element-wise route, past D). vec: the rows are exactly DP wide
// and aligned to the piece, so the piece travels in ds_unit loads.
template <int EPL, typename S>
__device__ __forceinline__ void ds_load(DsPiece<EPL, S>& p,
                                        const S* __restrict__ row, int col0,
                                        int D, bool vec, bool valid) {
  if (vec) {
    constexpr int U = ds_unit<EPL, S>();
    using V = typename DsVec<U>::T;
    const V* src = reinterpret_cast<const V*>(row + col0);
    V* dst = reinterpret_cast<V*>(p.x);
#pragma unroll
    for (int i = 0; i < EPL * (int)sizeof(S) / U; ++i)
      dst[i] = valid ? src[i] : V{};
  } else {
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      p.x[e] = valid && col0 + e < D ? row[col0 + e] : S{};
  }
}

// the sum of v over the 16 lanes of a half-warp
__device__ __forceinline__ float ds_half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block: kv head g of batch row b, query heads h0 .. h0 + nh (nh <=
// RG), keys of part `part` (of nsplit). q and out are (B, H, D); po and
// pml (nsplit, B * H, D) and (nsplit, B * H, 2) for a split. kn, vn (B *
// Hkv, D) and kns, vns (B * Hkv) hold the step's own rows when OWN (else
// unused). scale2 = scale * log2 e. DP: the padded head dim, 64 or 128.
template <typename TQ, typename S, int DP, int RG, bool OWN>
__global__ void __launch_bounds__(DS_THREADS)
    decode_split_kernel(const TQ* __restrict__ q, const S* __restrict__ kp,
                        const S* __restrict__ vp,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const S* __restrict__ kn, const S* __restrict__ vn,
                        const float* __restrict__ kns,
                        const float* __restrict__ vns,
                        const int* __restrict__ bt,
                        const int* __restrict__ sl, TQ* __restrict__ out,
                        float* __restrict__ po,
                        float* __restrict__ pml, int B, int H, int Hkv,
                        int D, int num_pages, int page, int maxp,
                        int part_pages, float scale2, int vec) {
  constexpr int EPL = DP / DS_LANES;
  constexpr int C = ds_chunk<RG>();
  constexpr bool INT8 = is_int8_pool<S>();
  using Piece = DsPiece<EPL, S>;
  __shared__ float s_acc[DS_ROWS][RG][DP];
  __shared__ float s_ml[DS_ROWS][RG][2];

  const int rep = H / Hkv, ng = (rep + RG - 1) / RG;
  const int hg = blockIdx.x % ng, bg = blockIdx.x / ng;
  const int g = bg % Hkv, b = bg / Hkv;
  const int h0 = g * rep + hg * RG, nh = min(RG, rep - hg * RG);
  const int part = blockIdx.y, nsplit = gridDim.y;
  const int len = min(sl[b] + (OWN ? 1 : 0), maxp * page);
  const size_t nrow = (size_t)b * Hkv + g;
  const int k0 = part * part_pages * page;
  const size_t qrow0 = (size_t)b * H + h0;
  if (k0 >= len) {
    // past the row's end: the merge skips this part; with no split the
    // block emits the row's zeros (an idle row)
    if (nsplit == 1)
      for (int i = threadIdx.x; i < nh * D; i += DS_THREADS)
        out[qrow0 * D + i] = from_f<TQ>(0.f);
    return;
  }
  const int nkeys = min(len, k0 + part_pages * page) - k0;
  const int hw = threadIdx.x / DS_LANES, ln = threadIdx.x % DS_LANES;
  const int col0 = ln * EPL;

  float qv[RG][EPL], acc[RG][EPL], m[RG], l[RG];
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int c = col0 + e;
      qv[r][e] = r < nh && c < D ? to_f(q[(qrow0 + r) * D + c]) * scale2
                                 : 0.f;
      acc[r][e] = 0.f;
    }
  }

  const int* btr = bt + (size_t)b * maxp;
  const size_t head_rows = (size_t)g * num_pages;
  // step by step: the block's next DS_ROWS * C keys, half-warp hw taking
  // keys hw + DS_ROWS * c, every load of the step issued before its math
  for (int base = 0; base < nkeys; base += DS_ROWS * C) {
    Piece kr[C], vr[C];
    float ksc[C], vsc[C];
    bool valid[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int t = base + c * DS_ROWS + hw;
      valid[c] = t < nkeys;
      const S* krow = kp;
      const S* vrow = vp;
      const float* ksrc = ks;
      const float* vsrc = vs;
      size_t row = 0;
      if (valid[c]) {
        const int pos = k0 + t, pg = pos / page;
        if (OWN && pos == sl[b]) {
          krow = kn;
          vrow = vn;
          ksrc = kns;
          vsrc = vns;
          row = nrow;
        } else {
          row = (head_rows + btr[pg]) * page + (pos - pg * page);
        }
      }
      ds_load(kr[c], krow + row * D, col0, D, vec, valid[c]);
      ds_load(vr[c], vrow + row * D, col0, D, vec, valid[c]);
      if constexpr (INT8) {
        ksc[c] = valid[c] ? ksrc[row] : 0.f;
        vsc[c] = valid[c] ? vsrc[row] : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      float s[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) a = fmaf(qv[r][e], to_f(kr[c].x[e]), a);
        a = ds_half_sum(a);
        if constexpr (INT8) a *= ksc[c];
        s[c] = valid[c] ? a : NEG_INF;
      }
      float mx = s[0];
#pragma unroll
      for (int c = 1; c < C; ++c) mx = fmaxf(mx, s[c]);
      float m_new = fmaxf(m[r], mx);
      if (m_new <= NEG_INF / 2) m_new = 0.f;  // fully masked so far
      const float alpha = exp2f(m[r] - m_new);
      float p[C], ps = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        p[c] = exp2f(s[c] - m_new);
        ps += p[c];
        if constexpr (INT8) p[c] *= vsc[c];
      }
      l[r] = alpha * l[r] + ps;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[r][e] * alpha;
#pragma unroll
        for (int c = 0; c < C; ++c) a = fmaf(p[c], to_f(vr[c].x[e]), a);
        acc[r][e] = a;
      }
    }
  }

  // merge the block's half-warps: M over those that saw a key
#pragma unroll
  for (int r = 0; r < RG; ++r) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) s_acc[hw][r][col0 + e] = acc[r][e];
    if (ln == 0) {
      s_ml[hw][r][0] = m[r];
      s_ml[hw][r][1] = l[r];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nh * DP; i += DS_THREADS) {
    const int r = i / DP, d = i - r * DP;
    if (d >= D) continue;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < DS_ROWS; ++w)
      if (s_ml[w][r][1] > 0.f) M = fmaxf(M, s_ml[w][r][0]);
    float O = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < DS_ROWS; ++w)
      if (s_ml[w][r][1] > 0.f) {
        const float f = exp2f(s_ml[w][r][0] - M);
        O = fmaf(f, s_acc[w][r][d], O);
        L = fmaf(f, s_ml[w][r][1], L);
      }
    const size_t row = qrow0 + r;
    if (nsplit == 1) {
      out[row * D + d] = from_f<TQ>(L > 0.f ? O / L : 0.f);
    } else {
      const size_t pr = (size_t)part * B * H + row;
      po[pr * D + d] = O;
      if (d == 0) {
        pml[2 * pr] = M;
        pml[2 * pr + 1] = L;
      }
    }
  }
}

// Merge the parts decode_split_kernel left for each (batch row, head): out
// = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s over the parts that ran
// (those starting below the row's length), in part order; zeros for an
// idle row. A warp a row. The lengths are sl + OWN, as the split kernel
// read them.
template <typename TQ, bool OWN>
__global__ void __launch_bounds__(128)
    decode_split_merge_kernel(const float* __restrict__ po,
                              const float* __restrict__ pml,
                              const int* __restrict__ sl,
                              TQ* __restrict__ out, int B, int H, int D,
                              int maxp, int page, int part_pages,
                              int nsplit) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B * H) return;
  const int len = min(sl[row / H] + (OWN ? 1 : 0), maxp * page);
  const int part_keys = part_pages * page;
  const int live = min(nsplit, (len + part_keys - 1) / part_keys);
  const size_t rows = (size_t)B * H;
  float M = NEG_INF;
  for (int s = 0; s < live; ++s) M = fmaxf(M, pml[2 * (s * rows + row)]);
  float L = 0.f;
  for (int s = 0; s < live; ++s) {
    const size_t pr = s * rows + row;
    L = fmaf(exp2f(pml[2 * pr] - M), pml[2 * pr + 1], L);
  }
  const float inv = L > 0.f ? 1.f / L : 0.f;
  for (int d = lane; d < D; d += 32) {
    float a = 0.f;
    for (int s = 0; s < live; ++s) {
      const size_t pr = s * rows + row;
      a = fmaf(exp2f(pml[2 * pr] - M), po[pr * D + d], a);
    }
    out[(size_t)row * D + d] = from_f<TQ>(a * inv);
  }
}

// One call of the routine (host side): the split kernel, and with nsplit >
// 1 the merge of the parts. kn .. vns: the step's own rows (OWN, the fused
// decode), null for #2. po and pml: f32 scratch of (nsplit, B * H, D) and
// (nsplit, B * H, 2) when nsplit > 1.
template <typename TQ, typename S>
struct DsCall {
  const TQ* q;
  const S *kp, *vp;
  const float *ks, *vs;  // an int8 pool's row scales
  const S *kn, *vn;
  const float *kns, *vns;
  const int *bt, *sl;
  TQ* out;
  float *po, *pml;
  int B, H, Hkv, D, num_pages, page, maxp, part_pages, nsplit;
  float scale;
};

template <typename TQ, typename S, bool OWN, int DP, int RG>
int ds_launch(const DsCall<TQ, S>& a, cudaStream_t st) {
  constexpr int U = ds_unit<DP / DS_LANES, S>();
  const bool vec = a.D == DP && (uintptr_t)a.kp % U == 0 &&
                   (uintptr_t)a.vp % U == 0 && (uintptr_t)a.kn % U == 0 &&
                   (uintptr_t)a.vn % U == 0;
  const int ng = (a.H / a.Hkv + RG - 1) / RG;
  const dim3 grid(a.B * a.Hkv * ng, a.nsplit);
  decode_split_kernel<TQ, S, DP, RG, OWN><<<grid, DS_THREADS, 0, st>>>(
      a.q, a.kp, a.vp, a.ks, a.vs, a.kn, a.vn, a.kns, a.vns, a.bt, a.sl,
      a.out, a.po, a.pml, a.B, a.H, a.Hkv, a.D, a.num_pages, a.page, a.maxp,
      a.part_pages, a.scale * 1.4426950408889634f, (int)vec);
  if (a.nsplit > 1)
    decode_split_merge_kernel<TQ, OWN><<<(a.B * a.H + 3) / 4, 128, 0, st>>>(
        a.po, a.pml, a.sl, a.out, a.B, a.H, a.D, a.maxp, a.page,
        a.part_pages, a.nsplit);
  return (int)cudaGetLastError();
}

// the head group: the power of two >= rep, at most 8
template <typename TQ, typename S, bool OWN, int DP>
int ds_launch_dp(const DsCall<TQ, S>& a, cudaStream_t st) {
  const int rep = a.H / a.Hkv;
  if (rep == 1) return ds_launch<TQ, S, OWN, DP, 1>(a, st);
  if (rep == 2) return ds_launch<TQ, S, OWN, DP, 2>(a, st);
  if (rep <= 4) return ds_launch<TQ, S, OWN, DP, 4>(a, st);
  return ds_launch<TQ, S, OWN, DP, 8>(a, st);
}

// the padded head dim: 64 or 128 (D <= 128)
template <typename TQ, typename S, bool OWN>
int decode_split(const DsCall<TQ, S>& a, cudaStream_t st) {
  return a.D <= 64 ? ds_launch_dp<TQ, S, OWN, 64>(a, st)
                   : ds_launch_dp<TQ, S, OWN, 128>(a, st);
}

// What a DsCall's split must satisfy: D <= 128 and parts that cover the
// table.
inline bool ds_split_ok(int D, int maxp, int part_pages, int nsplit) {
  return D >= 1 && D <= 128 && maxp >= 1 && part_pages >= 1 &&
         nsplit >= 1 && nsplit <= 65535 &&
         (long long)nsplit * part_pages >= maxp;
}

}  // namespace ptt
