// Causal prefill attention on the tensor cores, for bf16: the routine that
// flash_prefill.cu (#1) and paged_chunk_attention.cu (#4) run for
// __nv_bfloat16, in place of common.cuh's f32 prefill_block (which the fp32
// instantiations keep: on the tensor cores fp32 would mean TF32).
//
// The shape is FlashAttention-2's, written with mma.sync (the same routine
// on wgmma ran no faster on the H100: the tile copies and the math run
// almost in series, and the tensor-core rate is not the limit; see
// PERF.md). One block of
// PM_WARPS warps owns PM_BQ query rows of one query head, 16 rows a warp;
// each warp keeps its rows' online softmax (m, l), the f32 output
// accumulator and Q's fragments in registers. The block walks the kv rows
// in tiles of PM_BK through shared memory, stops at the last tile its last
// valid row can see, and masks only the tiles that straddle the causal
// diagonal or the ragged end. The 8 warps of a block share each K/V tile,
// so a tile crosses from L2 once for 128 query rows.
//
//   S = Q K^T     mma.m16n8k16 bf16 -> f32, fragments by ldmatrix; the
//                 softmax scale (times log2 e, for ex2) enters in f32, in
//                 the exponent, never on bf16 q (a peaked q pre-scaled and
//                 rounded to bf16 misses the chunk kernels' 1e-3 + one bf16
//                 ulp check);
//   O += P V      P stays about 16 bits wide: two mmas a k-step, P_hi V +
//                 P_lo V with P_hi = bf16(p) and P_lo = bf16(p - P_hi)
//                 (one bf16 P misses that check at a peaked q); l sums the
//                 unrounded f32 p.
//
// K and V tiles are staged in bf16 by cp.async (16-byte pieces where the
// rows' width and alignment allow, else 8 or 4; below 4 bytes plain
// copies), double-buffered so that tile j + 1 lands while tile j computes,
// with one barrier a tile (two for an int8 pool). Each kv row is found by
// the block itself through `kv_row(pos)` (a page of the block table, or a
// row of a contiguous cache), so any page size and any start work; the row
// ids of tile j + 2 are looked up while tile j computes. Rows past the
// block's last visible key are zero-filled, not read. Shared-memory rows
// are padded by 16 bytes, so the 8 rows an ldmatrix reads fall on distinct
// banks. A head dim D below DP (the next multiple of 32) is zero-padded in
// shared memory.
//
// Filling the card: the wrapper may split each block's kv walk into parts
// (grid.z); each part leaves f32 partial (O, m, l) and
// prefill_combine_kernel merges them in the same call.
//
// int8 pools: the payload is copied as it is (int8, its row's f32 scale
// beside it), converted to bf16 in shared memory (exact: |x| <= 127), and
// the scales stay f32: column j of S is multiplied by ks[row j] after the
// Q K^T mma and column j of P by vs[row j] before the hi/lo split, so the
// arithmetic is the native kernel's on exact payloads, as the plain
// version's q.float() * scale is.
#pragma once

#include <algorithm>

#include "mma.cuh"

namespace ptt {

constexpr int PM_BQ = 128;      // query rows per block
constexpr int PM_BK = 128;      // kv rows per tile
constexpr int PM_WARPS = PM_BQ / 16;
constexpr int PM_THREADS = PM_WARPS * 32;
constexpr int PM_BLOCKS_PER_SM = 1;   // by registers
static_assert(PM_BQ <= PM_BK, "the q tile lives in the K tiles");

// dynamic shared memory: K and V (two stages; one for an int8 pool, whose
// two stages are the int8 staging tiles; the q tile before the walk and
// the output tile after it use K's), the kv row ids of two tiles, and for
// an int8 pool the staging tiles and the row scales: 138 KB native and
// 136 KB int8 at DP = 128
template <int DP, bool INT8>
__host__ __device__ constexpr size_t pm_smem_bytes() {
  return 2 * (size_t)tile_stride(DP) * (INT8 ? 2 : 4) * PM_BK +
         sizeof(long long) * 2 * PM_BK +
         (INT8 ? 2 * 2 * (size_t)PM_BK * DP + sizeof(float) * 4 * PM_BK : 0);
}

// Four int8 (one word) as four bf16 (two words), exactly, on the integer
// and f32 pipes: byte b becomes the f32 2^23 + (b ^ 0x80) by its bits,
// minus 2^23 + 128; an integer of |x| <= 128 is exact in bf16, so its bits
// are that f32's upper half.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  w ^= 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | i)) -
           8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// The block's work. Query row i (0 <= i < S) of the head is row
// qrow0 + i * qrow_step of q and out (its elements at that row * D) and
// sits at absolute position qpos0 + i; it sees every kv row at a position
// <= its own and below kv_len. The block takes query rows q0 .. q0 + PM_BQ.
// `kv_row(pos)`: the row of kv position `pos` of the block's kv head in
// k and v (elements at row * D; an int8 pool's scale at ks/vs[row]).
// qunit / kvunit: copy piece widths (copy_unit) of q and out / of k and v.
// With nsplit > 1 the block walks only part `split` of its kv tiles and
// leaves its rows' unnormalised f32 O in po (nsplit x nrows x D, row
// qrow0 + i * qrow_step) and their (m, l) in pml (nsplit x nrows x 2), for
// prefill_combine_kernel.
template <int DP, typename KS, typename KvRow>
__device__ inline void prefill_mma(const __nv_bfloat16* __restrict__ q,
                                   __nv_bfloat16* __restrict__ out,
                                   size_t qrow0, size_t qrow_step, int S,
                                   int q0, int qpos0, int kv_len,
                                   const KS* __restrict__ k,
                                   const KS* __restrict__ v,
                                   const float* __restrict__ ks,
                                   const float* __restrict__ vs,
                                   const KvRow& kv_row, int D, float scale,
                                   int qunit, int kvunit, int split,
                                   int nsplit, float* __restrict__ po,
                                   float* __restrict__ pml, size_t nrows) {
  using bf16 = __nv_bfloat16;
  constexpr bool INT8 = is_int8_pool<KS>();
  constexpr int SR = tile_stride(DP);
  constexpr int NT = PM_BK / 8;   // key columns of S, in n-tiles of 8
  constexpr int KD = DP / 16;     // k-steps over the head dim
  constexpr int ND = DP / 8;      // head-dim columns of O, in n-tiles of 8
  constexpr int KV_STAGES = INT8 ? 1 : 2;

  extern __shared__ __align__(16) unsigned char pm_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(pm_smem);           // [stages][BK][SR]
  bf16* Vs = Ks + KV_STAGES * PM_BK * SR;                // [stages][BK][SR]
  long long* ids = reinterpret_cast<long long*>(Vs + KV_STAGES * PM_BK * SR);
  int8_t* K8 = reinterpret_cast<int8_t*>(ids + 2 * PM_BK);  // [2][BK][DP]
  int8_t* V8 = K8 + 2 * PM_BK * DP;
  float* Ksc = reinterpret_cast<float*>(V8 + 2 * PM_BK * DP);  // [2][BK]
  float* Vsc = Ksc + 2 * PM_BK;
  bf16* Qs = Ks;  // [BQ][SR] over the K tiles: the q tile before the
                  // walk, the output after it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // fragment row group, column pair
  const float scale2 = scale * LOG2E;      // raw scores -> log2 units

  // kv positions the block can see: up to its last valid row's
  const int q_last = min(q0 + PM_BQ, S) - 1;
  const int kv_end = min(kv_len, qpos0 + q_last + 1);
  const int n_tiles = kv_end > 0 ? (kv_end + PM_BK - 1) / PM_BK : 0;
  // this block's part of them
  const int t0 = (int)((long long)n_tiles * split / nsplit);
  const int nt = (int)((long long)n_tiles * (split + 1) / nsplit) - t0;
  auto kv_id = [&](int tile, int r) -> long long {
    const int pos = tile * PM_BK + r;
    return pos < kv_end ? (long long)kv_row(pos) : -1ll;
  };

  // zero the head-dim padding once: copies never write it
  if (D < DP) {
    for (int idx = tid; idx < 2 * KV_STAGES * PM_BK * DP; idx += blockDim.x) {
      const int r = idx / DP, d = idx - r * DP;
      if (d >= D) Ks[r * SR + d] = __float2bfloat16(0.f);
    }
    if constexpr (INT8)
      for (int idx = tid; idx < 4 * PM_BK * DP; idx += blockDim.x)
        if (idx % DP >= D) K8[idx] = 0;
  }
  if (tid < PM_BK) {
    ids[tid] = kv_id(t0, tid);
    ids[PM_BK + tid] = kv_id(t0 + 1, tid);
  }

  // the q tile, then this warp's 16 rows of it as A fragments in registers
  // (rows g and g + 8 of each fragment); the tile's memory then takes kv
  auto q_id = [&](int r) -> long long {
    return q0 + r < S ? (long long)(qrow0 + (size_t)(q0 + r) * qrow_step)
                      : -1ll;
  };
  if (qunit == 16 && D == DP)
    copy_rows16<DP / 8>(Qs, SR, q, PM_BQ, q_id);
  else
    copy_rows(Qs, SR, q, D, PM_BQ, q_id, qunit);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // the q tile and the row ids are visible
  const int wrow0 = q0 + warp * 16;
  const int wpos0 = qpos0 + wrow0;                      // its first position
  const int wpos_last = qpos0 + min(wrow0 + 15, S - 1);  // its last valid
  const bool warp_live = wrow0 < S;
  uint32_t qf[KD][4];
  if (warp_live) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      ldsm_x4(smem_addr(Qs + (warp * 16 + (lane & 15)) * SR + kd * 16 +
                        (lane >> 4) * 8),
              qf[kd][0], qf[kd][1], qf[kd][2], qf[kd][3]);
  }
  __syncthreads();  // the q tile is in registers

  const bool whole16 = kvunit == 16 && D == DP;  // rows of 16-byte pieces
  auto load_kv = [&](int stage) {
    const long long* sid = ids + stage * PM_BK;
    auto id = [sid](int r) { return sid[r]; };
    if constexpr (INT8) {
      int8_t* kd = K8 + stage * PM_BK * DP;
      int8_t* vd = V8 + stage * PM_BK * DP;
      if (whole16) {
        copy_rows16<DP / 16>(kd, DP, k, PM_BK, id);
        copy_rows16<DP / 16>(vd, DP, v, PM_BK, id);
      } else {
        copy_rows(kd, DP, k, D, PM_BK, id, kvunit);
        copy_rows(vd, DP, v, D, PM_BK, id, kvunit);
      }
      copy_rows(Ksc + stage * PM_BK, 1, ks, 1, PM_BK, id, 4);
      copy_rows(Vsc + stage * PM_BK, 1, vs, 1, PM_BK, id, 4);
    } else {
      bf16* kd = Ks + stage * PM_BK * SR;
      bf16* vd = Vs + stage * PM_BK * SR;
      if (whole16) {
        copy_rows16<DP / 8>(kd, SR, k, PM_BK, id);
        copy_rows16<DP / 8>(vd, SR, v, PM_BK, id);
      } else {
        copy_rows(kd, SR, k, D, PM_BK, id, kvunit);
        copy_rows(vd, SR, v, D, PM_BK, id, kvunit);
      }
    }
  };
  if (nt > 0) load_kv(0);
  cp_async_commit();

  // online softmax state of rows g (i = 0) and g + 8 (i = 1), m in raw
  // score units, and the f32 output accumulator
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  for (int i = 0; i < nt; ++i) {
    // the row ids of tile i + 2: looked up now, stored after the compute
    const long long nxt = (tid < PM_BK && i + 2 < nt)
                              ? kv_id(t0 + i + 2, tid) : -1ll;
    cp_async_wait<0>();
    __syncthreads();  // tile i landed; tile i - 1 consumed, so its buffers
                      // take tile i + 1
    if (i + 1 < nt) load_kv((i + 1) & 1);
    cp_async_commit();
    const int stage = i & 1;
    if constexpr (INT8) {
      // int8 payload -> bf16 (exact), 16 elements a step, both tiles
      const int8_t* k8 = K8 + stage * PM_BK * DP;
      const int8_t* v8 = V8 + stage * PM_BK * DP;
      for (int c = tid; c < PM_BK * DP / 16; c += blockDim.x) {
        const int r = c / (DP / 16), d = (c - r * (DP / 16)) * 16;
#pragma unroll
        for (int which = 0; which < 2; ++which) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              (which ? v8 : k8) + r * DP + d);
          uint4 w0, w1;
          int8x4_to_bf16(raw.x, w0.x, w0.y);
          int8x4_to_bf16(raw.y, w0.z, w0.w);
          int8x4_to_bf16(raw.z, w1.x, w1.y);
          int8x4_to_bf16(raw.w, w1.z, w1.w);
          uint4* dst = reinterpret_cast<uint4*>((which ? Vs : Ks) + r * SR + d);
          dst[0] = w0;
          dst[1] = w1;
        }
      }
      __syncthreads();
    }
    const bf16* Kt = Ks + (INT8 ? 0 : stage) * PM_BK * SR;
    const bf16* Vt = Vs + (INT8 ? 0 : stage) * PM_BK * SR;
    const int j0 = (t0 + i) * PM_BK;

    if (warp_live && j0 <= wpos_last) {
      // S = Q K^T: s[n] holds rows g, g + 8 x keys n * 8 + 2t, + 1
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(smem_addr(Kt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * SR +
                            kd * 16 + ((lane >> 3) & 1) * 8),
                  b0, b1, b2, b3);
          mma_bf16(s[2 * np], qf[kd], b0, b1);
          mma_bf16(s[2 * np + 1], qf[kd], b2, b3);
        }
      }
      // int8 key scales; the mask where the tile straddles the diagonal
      // or the end
      const bool masked = j0 + PM_BK - 1 > wpos0 || j0 + PM_BK > kv_end;
      const float* ksc = Ksc + stage * PM_BK;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t + (e & 1);
          if constexpr (INT8) s[n][e] *= ksc[col];
          if (masked) {
            const int kp = j0 + col, rp = wpos0 + g + (e >> 1) * 8;
            if (kp > rp || kp >= kv_end) s[n][e] = NEG_INF;
          }
        }
      }
      // online softmax over the tile; the scale enters in f32, in the
      // exponent: p = 2^((s - m) * scale * log2 e)
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
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
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(fmaf(s[n][e], scale2, -msc[e >> 1]));
          rs[e >> 1] += p;
          s[n][e] = p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = alpha[r] * l_r[r] + rs[r];
      // rescale O only when a row's max moved (rarely, after the first
      // tiles)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
      }
      // O += P V, 16 keys a k-step; P's S fragments are its A fragments
      const float* vsc = Vsc + stage * PM_BK;
#pragma unroll
      for (int kk = 0; kk < PM_BK / 16; ++kk) {
        float p[8] = {s[2 * kk][0],     s[2 * kk][1],     s[2 * kk][2],
                      s[2 * kk][3],     s[2 * kk + 1][0], s[2 * kk + 1][1],
                      s[2 * kk + 1][2], s[2 * kk + 1][3]};
        if constexpr (INT8) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            p[e] *= vsc[kk * 16 + (e >> 2) * 8 + 2 * t + (e & 1)];
        }
        uint32_t ah[4], al[4];
        split_bf16(p[0], p[1], ah[0], al[0]);   // row g,     keys 2t
        split_bf16(p[2], p[3], ah[1], al[1]);   // row g + 8, keys 2t
        split_bf16(p[4], p[5], ah[2], al[2]);   // row g,     keys 8 + 2t
        split_bf16(p[6], p[7], ah[3], al[3]);   // row g + 8, keys 8 + 2t
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_trans(
              smem_addr(Vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * SR +
                        dp * 16 + (lane >> 4) * 8),
              b0, b1, b2, b3);
          mma_bf16(o[2 * dp], ah, b0, b1);
          mma_bf16(o[2 * dp], al, b0, b1);
          mma_bf16(o[2 * dp + 1], ah, b2, b3);
          mma_bf16(o[2 * dp + 1], al, b2, b3);
        }
      }
    }
    // the ids of tile i + 2 take tile i's slot (its copies were issued
    // before this iteration's barrier); the next barrier publishes them
    if (tid < PM_BK && i + 2 < nt) ids[stage * PM_BK + tid] = nxt;
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its tiles

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  if (nsplit > 1) {
    // this part's unnormalised O and (m, l), m in log2 units, for the
    // combine pass
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = wrow0 + g + 8 * r;
      if (qi >= S) continue;
      const size_t row = (size_t)split * nrows + qrow0 + (size_t)qi * qrow_step;
      float* dst = po + row * D;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int c = n * 8 + 2 * t;
        if (c < D) dst[c] = o[n][2 * r];
        if (c + 1 < D) dst[c + 1] = o[n][2 * r + 1];
      }
      if (t == 0) {
        pml[2 * row] = m_r[r] * scale2;
        pml[2 * row + 1] = l_r[r];
      }
    }
    return;
  }

  // out = O / l (a row with no visible key emits zeros), through the q tile
  const float inv0 = l_r[0] == 0.f ? 0.f : 1.f / l_r[0];
  const float inv1 = l_r[1] == 0.f ? 0.f : 1.f / l_r[1];
  bf16* orow = Qs + (warp * 16 + g) * SR + 2 * t;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
        __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(orow + 8 * SR + n * 8) =
        __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
  __syncthreads();
  const int row_bytes = D * (int)sizeof(bf16);
  const int upr = row_bytes / qunit;
  for (int c = tid; c < PM_BQ * upr; c += blockDim.x) {
    const int r = c / upr, off = (c - r * upr) * qunit;
    if (q0 + r >= S) continue;
    char* d = reinterpret_cast<char*>(out) +
              (qrow0 + (size_t)(q0 + r) * qrow_step) * row_bytes + off;
    store_unit(d, reinterpret_cast<const char*>(Qs + r * SR) + off, qunit);
  }
}

// Merge the nsplit parts of each of nrows query rows (prefill_mma with
// nsplit > 1): out = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s over the
// parts that saw a key (M their largest m); a row no part saw emits zeros.
// A warp a row.
template <typename T>
__global__ void __launch_bounds__(128)
    prefill_combine_kernel(const float* __restrict__ po,
                           const float* __restrict__ pml,
                           T* __restrict__ out, size_t nrows, int D,
                           int nsplit) {
  const size_t row = (size_t)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= nrows) return;
  float M = NEG_INF;
  for (int s = 0; s < nsplit; ++s) {
    const float* ml = pml + 2 * ((size_t)s * nrows + row);
    if (ml[1] > 0.f) M = fmaxf(M, ml[0]);
  }
  float L = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float* ml = pml + 2 * ((size_t)s * nrows + row);
    if (ml[1] > 0.f) L += exp2f(ml[0] - M) * ml[1];
  }
  const float inv = L > 0.f ? 1.f / L : 0.f;
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t sr = (size_t)s * nrows + row;
      if (pml[2 * sr + 1] > 0.f)
        acc += exp2f(pml[2 * sr] - M) * po[sr * D + d];
    }
    out[row * D + d] = from_f<T>(acc * inv);
  }
}

}  // namespace ptt
