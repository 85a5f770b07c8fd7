// One Llama decoder layer's decode step for a batch of single tokens, the
// device code shared by fused_block_decode.cu (one layer a call) and
// fused_multi_block_decode.cu (a group of N stacked layers a call).
//
// run<T>() launches the layer's phases in order on the caller's stream,
// with the activations in an f32 scratch buffer the wrapper allocates (a
// few hundred KB, L2-resident between launches):
//   1. rms(x) * ln1, then the q/k/v GEMVs, then a RoPE epilogue at seq_lens;
//   2. the append of the new token's k/v to the pool at seq_lens (one small
//      kernel, which also leaves the rows as stored in the scratch), then
//      paged attention over seq_lens + 1 through decode_split.cuh's
//      split-KV routine (split kernel + merge), the step's own key read
//      from the scratch row;
//   3. o-proj GEMV + residual;
//   4. rms * ln2, then the gate/up GEMVs and silu(g) * u;
//   5. down GEMV + residual, cast to the activation dtype.
// Every GEMV block streams its weight tile once, with 16-byte loads, for all
// (up to 8) batch rows at once; the contraction is split over blocks so that
// enough loads are in flight to fill the card, and each split writes f32
// partial sums that the phase's epilogue reduces in a fixed order (the
// result does not depend on scheduling). A weight matrix is read with its
// own row stride, so q, k and v (and gate and up) may be column ranges of
// one merged matrix: the GEMV launch, its split and every column's
// reduction are the same as over separate matrices, bit for bit.
//
// Two quantized variants, chosen at compile time (run<T, S, W4>):
//   - an int8 KV pool (S = int8_t; the TPU kernels' `kv_quant`): the
//     append kernel quantizes the new token's k/v row with the plain
//     version's arithmetic (amax over D, IEEE division, rint, clamp) and
//     writes payload and scale; the attention reads payload and per-row f32
//     scales (pointer parameters), the new row at the value a re-read of
//     the pool gives (the TPU kernel's _fake_quant_rows);
//   - int4 weight tiles (W4; the N-layer TPU kernel's `wt_quant`): each
//     GEMV streams the packed bytes of an Int4Tiles matrix; a lane unpacks
//     both nibbles of a byte into contraction rows k_lo and k_lo + tr/2,
//     sign-extends them and multiplies by the tile's f32 scale, indexed by
//     the column's absolute position in the merged matrix.
#pragma once

#include <algorithm>

#include "decode_split.cuh"

namespace ptt {

constexpr int GV_THREADS = 256;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_UNROLL = 4;
constexpr int GV_MAXB = 8;
constexpr int GV_TARGET_BLOCKS = 1024;
constexpr int EPI_THREADS = 256;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

inline int cols_per_tile(int dtype) {
  return 32 * (dtype == DT_BF16 ? Vec<__nv_bfloat16>::N : Vec<float>::N);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Split {
  int ks, rows;
};

// Split the contraction K so that col_tiles * ks blocks fill the card.
inline Split gemv_split(int K, int col_tiles) {
  const int want = cdiv(GV_TARGET_BLOCKS, col_tiles);
  const int step = GV_WARPS * GV_UNROLL;
  const int rows = cdiv(cdiv(K, want), step) * step;
  return {cdiv(K, rows), rows};
}

template <typename T>
struct GemvSeg {
  const T* W;    // (K, N) columns of a row-major matrix, the (in, out) layout
  int N;         // columns
  int ld;        // row stride of W (elements; >= N)
  float* part;   // (ks, B, N) partial sums
  int tile0;     // first column tile of this segment in the launch
};

template <typename T>
struct GemvArgs {
  GemvSeg<T> seg[3];
  int nseg;
  const float* a;  // (B, K) activations, f32
  int K, B, b0, nb, rows;
};

template <typename T, int NB>
__global__ void __launch_bounds__(GV_THREADS)
    gemv_partial_kernel(GemvArgs<T> args) {
  constexpr int VEC = Vec<T>::N;
  constexpr int COLS = 32 * VEC;
  __shared__ float red[GV_WARPS][COLS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int tile = blockIdx.x;
  int si = 0;
  while (si + 1 < args.nseg && tile >= args.seg[si + 1].tile0) ++si;
  const GemvSeg<T> sg = args.seg[si];
  const int c_base = (tile - sg.tile0) * COLS;
  const int col = c_base + lane * VEC;
  const bool col_ok = col < sg.N;
  const int k0 = blockIdx.y * args.rows;
  const int k1 = min(args.K, k0 + args.rows);
  const float* a = args.a + (size_t)args.b0 * args.K;

  float acc[NB][VEC];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[b][c] = 0.f;

  for (int k = k0 + warp; k < k1; k += GV_WARPS * GV_UNROLL) {
    uint4 raw[GV_UNROLL];
#pragma unroll
    for (int u = 0; u < GV_UNROLL; ++u) {
      const int kk = k + u * GV_WARPS;
      raw[u] = (col_ok && kk < k1)
                   ? *reinterpret_cast<const uint4*>(sg.W + (size_t)kk * sg.ld +
                                                     col)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < GV_UNROLL; ++u) {
      const int kk = k + u * GV_WARPS;
      if (kk >= k1) break;
      const T* wv = reinterpret_cast<const T*>(&raw[u]);
      float w[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c) w[c] = to_f(wv[c]);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b < args.nb) {
          const float av = a[(size_t)b * args.K + kk];
#pragma unroll
          for (int c = 0; c < VEC; ++c) acc[b][c] += av * w[c];
        }
      }
    }
  }

#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if (b < args.nb) {
#pragma unroll
      for (int c = 0; c < VEC; ++c) red[warp][lane * VEC + c] = acc[b][c];
      __syncthreads();
      for (int cc = threadIdx.x; cc < COLS; cc += GV_THREADS) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < GV_WARPS; ++w) s += red[w][cc];
        const int n = c_base + cc;
        if (n < sg.N)
          sg.part[((size_t)blockIdx.y * args.B + args.b0 + b) * sg.N + n] = s;
      }
      __syncthreads();
    }
  }
}

// Launch one GEMV phase over 1-3 weight matrices that share the activation.
template <typename T>
int gemv(const float* a, int K, int B, const T* const* W, const int* N,
         const int* ld, float* const* part, int nseg, cudaStream_t stream) {
  constexpr int COLS = 32 * Vec<T>::N;
  GemvArgs<T> args;
  int tiles = 0;
  for (int i = 0; i < nseg; ++i) {
    args.seg[i] = GemvSeg<T>{W[i], N[i], ld[i], part[i], tiles};
    tiles += cdiv(N[i], COLS);
  }
  const Split sp = gemv_split(K, tiles);
  args.nseg = nseg;
  args.a = a;
  args.K = K;
  args.B = B;
  args.rows = sp.rows;
  const dim3 grid(tiles, sp.ks);
  for (int b0 = 0; b0 < B; b0 += GV_MAXB) {
    args.b0 = b0;
    args.nb = std::min(GV_MAXB, B - b0);
    if (args.nb == 1)
      gemv_partial_kernel<T, 1><<<grid, GV_THREADS, 0, stream>>>(args);
    else if (args.nb == 2)
      gemv_partial_kernel<T, 2><<<grid, GV_THREADS, 0, stream>>>(args);
    else if (args.nb <= 4)
      gemv_partial_kernel<T, 4><<<grid, GV_THREADS, 0, stream>>>(args);
    else
      gemv_partial_kernel<T, 8><<<grid, GV_THREADS, 0, stream>>>(args);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// int4 tiles. A matrix (K, C) is stored as uint8 (K/2, C): in each band of
// tr rows, packed row band * tr/2 + i holds row band * tr + i in its low
// nibble and row band * tr + i + tr/2 in its high one (two's complement,
// [-7, 7]); scale (K/tr, C/tc) f32 holds one value per (tr, tc) tile. A
// lane loads 8 packed bytes (8 columns, 16 weights) with one 8-byte load.
constexpr int I4_VEC = 8;
constexpr int I4_COLS = 32 * I4_VEC;

// One merged int4 matrix (host side): payload, scales, row stride (C, in
// bytes) and tile.
struct Int4Mat {
  const uint8_t* q;
  const float* scale;
  int ld, tr, tc;
};

// Byte c of x (a nibble xor 8, 0..15) minus 8 as f32, exactly: the byte is
// placed in the mantissa of 2^23 (one byte permute, one add) instead of an
// int-to-float conversion, which runs at a quarter of the FMA rate.
__device__ __forceinline__ float nibble_f32(uint32_t x, int c) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u | c)) -
         8388616.f;
}

struct Gemv4Seg {
  const uint8_t* W;  // the packed rows at this segment's first column
  int N;             // columns
  int col0;          // absolute column of the segment in the merged matrix
  float* part;       // (ks, B, N) partial sums
  int tile0;
};

struct Gemv4Args {
  Gemv4Seg seg[3];
  int nseg;
  const float* scale;  // the merged matrix's (K/tr, C/tc) scales
  int ld, tr2, tc, snc;  // row stride (bytes), tr/2, tc, C/tc
  const float* a;        // (B, K) activations, f32
  int K, B, b0, nb, rows;  // rows: packed rows per split
};

template <int NB>
__global__ void __launch_bounds__(GV_THREADS)
    gemv_int4_partial_kernel(Gemv4Args args) {
  __shared__ float red[GV_WARPS][I4_COLS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int tile = blockIdx.x;
  int si = 0;
  while (si + 1 < args.nseg && tile >= args.seg[si + 1].tile0) ++si;
  const Gemv4Seg sg = args.seg[si];
  const int c_base = (tile - sg.tile0) * I4_COLS;
  const int col = c_base + lane * I4_VEC;
  const bool col_ok = col < sg.N;  // N % 8 == 0: a lane's 8 columns or none
  const int half = args.K / 2;
  const int p0 = blockIdx.y * args.rows;
  const int p1 = min(half, p0 + args.rows);
  const float* a = args.a + (size_t)args.b0 * args.K;

  float acc[NB][I4_VEC];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < I4_VEC; ++c) acc[b][c] = 0.f;

  int band = -1;  // the band whose tile scales sc[] holds
  float sc[I4_VEC];
  // packed row p = r * tr/2 + i, stepped along without a division a row
  int r = (p0 + warp) / args.tr2, i = p0 + warp - r * args.tr2;
  for (int p = p0 + warp; p < p1; p += GV_WARPS * GV_UNROLL) {
    uint2 raw[GV_UNROLL];
#pragma unroll
    for (int u = 0; u < GV_UNROLL; ++u) {
      const int pp = p + u * GV_WARPS;
      raw[u] = (col_ok && pp < p1)
                   ? *reinterpret_cast<const uint2*>(sg.W + (size_t)pp * args.ld +
                                                     col)
                   : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < GV_UNROLL; ++u) {
      const int pp = p + u * GV_WARPS;
      if (pp >= p1) break;
      if (r != band) {
        band = r;
#pragma unroll
        for (int c = 0; c < I4_VEC; ++c)
          sc[c] = col_ok ? args.scale[(size_t)r * args.snc +
                                      (sg.col0 + col + c) / args.tc]
                         : 0.f;
      }
      const int k_lo = 2 * r * args.tr2 + i, k_hi = k_lo + args.tr2;
      const uint32_t words[2] = {raw[u].x, raw[u].y};
      float wl[I4_VEC], wh[I4_VEC];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the low and the high nibble of each of the word's 4 bytes, each
        // xor 8 (so that v - 8 is its two's-complement value)
        const uint32_t lo = (words[h] & 0x0F0F0F0Fu) ^ 0x08080808u;
        const uint32_t hi = ((words[h] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          wl[4 * h + c] = nibble_f32(lo, c) * sc[4 * h + c];
          wh[4 * h + c] = nibble_f32(hi, c) * sc[4 * h + c];
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b < args.nb) {
          const float al = a[(size_t)b * args.K + k_lo];
          const float ah = a[(size_t)b * args.K + k_hi];
#pragma unroll
          for (int c = 0; c < I4_VEC; ++c) {
            acc[b][c] += al * wl[c];
            acc[b][c] += ah * wh[c];
          }
        }
      }
      i += GV_WARPS;
      while (i >= args.tr2) {
        i -= args.tr2;
        ++r;
      }
    }
  }

#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if (b < args.nb) {
#pragma unroll
      for (int c = 0; c < I4_VEC; ++c) red[warp][lane * I4_VEC + c] = acc[b][c];
      __syncthreads();
      for (int cc = threadIdx.x; cc < I4_COLS; cc += GV_THREADS) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < GV_WARPS; ++w) s += red[w][cc];
        const int n = c_base + cc;
        if (n < sg.N)
          sg.part[((size_t)blockIdx.y * args.B + args.b0 + b) * sg.N + n] = s;
      }
      __syncthreads();
    }
  }
}

// Blocks an int4 GEMV aims for: its blocks carry twice the weights of a
// native one's per byte, so half as many fill the card.
constexpr int GV4_TARGET_BLOCKS = GV_TARGET_BLOCKS / 2;

// The split of an int4 GEMV: its K/2 packed rows over col_tiles tiles.
inline Split gemv4_split(int K, int col_tiles) {
  const int want = cdiv(GV4_TARGET_BLOCKS, col_tiles);
  const int step = GV_WARPS * GV_UNROLL;
  const int rows = cdiv(cdiv(K / 2, want), step) * step;
  return {cdiv(K / 2, rows), rows};
}

// Launch one GEMV phase over 1-3 column ranges [col0, col0 + N) of one
// int4 matrix that share the activation (its contraction split over the
// K/2 packed rows).
inline int gemv4(const float* a, int K, int B, const Int4Mat& m,
                 const int* col0, const int* N, float* const* part, int nseg,
                 cudaStream_t stream) {
  Gemv4Args args;
  int tiles = 0;
  for (int i = 0; i < nseg; ++i) {
    args.seg[i] = Gemv4Seg{m.q + col0[i], N[i], col0[i], part[i], tiles};
    tiles += cdiv(N[i], I4_COLS);
  }
  const Split sp = gemv4_split(K, tiles);
  args.nseg = nseg;
  args.scale = m.scale;
  args.ld = m.ld;
  args.tr2 = m.tr / 2;
  args.tc = m.tc;
  args.snc = m.ld / m.tc;
  args.a = a;
  args.K = K;
  args.B = B;
  args.rows = sp.rows;
  const dim3 grid(tiles, sp.ks);
  for (int b0 = 0; b0 < B; b0 += GV_MAXB) {
    args.b0 = b0;
    args.nb = std::min(GV_MAXB, B - b0);
    if (args.nb == 1)
      gemv_int4_partial_kernel<1><<<grid, GV_THREADS, 0, stream>>>(args);
    else if (args.nb == 2)
      gemv_int4_partial_kernel<2><<<grid, GV_THREADS, 0, stream>>>(args);
    else if (args.nb <= 4)
      gemv_int4_partial_kernel<4><<<grid, GV_THREADS, 0, stream>>>(args);
    else
      gemv_int4_partial_kernel<8><<<grid, GV_THREADS, 0, stream>>>(args);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The contraction split of one GEMV phase: K rows over tiles of `cols`
// columns (native), or K/2 packed rows over int4 tiles of I4_COLS (w4).
inline int phase_ks(bool w4, int K, const int* N, int nseg, int cols) {
  const int c = w4 ? I4_COLS : cols;
  int tiles = 0;
  for (int i = 0; i < nseg; ++i) tiles += cdiv(N[i], c);
  return w4 ? gemv4_split(K, tiles).ks : gemv_split(K, tiles).ks;
}

__device__ inline float psum(const float* part, int ks, int B, int N, int b,
                             int n) {
  float s = 0.f;
  for (int i = 0; i < ks; ++i) s += part[((size_t)i * B + b) * N + n];
  return s;
}

// rms(x) * w over each row of x (B rows of n), written as f32.
template <typename TI, typename TW>
__global__ void __launch_bounds__(EPI_THREADS)
    rms_kernel(const TI* __restrict__ x, const TW* __restrict__ w,
               float* __restrict__ out, int n, float eps) {
  __shared__ float red[EPI_THREADS / 32];
  const TI* xr = x + (size_t)blockIdx.x * n;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = to_f(xr[i]);
    s += v * v;
  }
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float tot = 0.f;
  for (int i = 0; i < EPI_THREADS / 32; ++i) tot += red[i];
  const float inv = rsqrtf(tot / n + eps);
  float* o = out + (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    o[i] = to_f(xr[i]) * inv * to_f(w[i]);
}

// Reduce the q/k/v partials; rotate q and k (neox halves) at seq_lens.
__global__ void __launch_bounds__(EPI_THREADS)
    qkv_epilogue_kernel(const float* __restrict__ pq,
                        const float* __restrict__ pk,
                        const float* __restrict__ pv, int ks, int B, int nh,
                        int nkv, int d, const int* __restrict__ sl,
                        const float* __restrict__ inv_freq,
                        float* __restrict__ q, float* __restrict__ kn,
                        float* __restrict__ vn) {
  const int half = d / 2;
  const int nq = B * nh * half, nk = B * nkv * half, nv = B * nkv * d;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nq + nk) {
    const bool isq = i < nq;
    const int j = isq ? i : i - nq;
    const int heads = isq ? nh : nkv;
    const int b = j / (heads * half);
    const int r = j - b * heads * half;
    const int head = r / half, e = r - head * half;
    const int N = heads * d;
    const int n0 = head * d + e, n1 = n0 + half;
    const float* p = isq ? pq : pk;
    const float u0 = psum(p, ks, B, N, b, n0);
    const float u1 = psum(p, ks, B, N, b, n1);
    const float ang = (float)sl[b] * inv_freq[e];
    const float c = cosf(ang), s = sinf(ang);
    float* o = (isq ? q : kn) + (size_t)b * N;
    o[n0] = u0 * c - u1 * s;
    o[n1] = u1 * c + u0 * s;
  } else if (i < nq + nk + nv) {
    const int j = i - nq - nk;
    const int N = nkv * d;
    const int b = j / N;
    vn[j] = psum(pv, ks, B, N, b, j - b * N);
  }
}

// A layer's KV pools (an int8 pool's payloads and row scales), passed to
// the append and attention kernels as pointer parameters: a pointer the
// kernel read from memory would be a generic pointer, and the pool loads
// would then be generic loads (LD), not global ones (LDG), which in bf16
// made the attention ~60 % slower on the H100.
template <typename S>
struct PoolRef {
  S* kp;
  S* vp;
  float* ks;  // int8 pools only
  float* vs;
};

// quantize_kv_rows' element: clamp(rint(u / safe scale), -127, 127)
__device__ __forceinline__ float quant_int8(float u, float scale) {
  return fminf(fmaxf(rintf(u / (scale > 0.f ? scale : 1.f)), -127.f), 127.f);
}

constexpr int APPEND_THREADS = 128;

// The new token's k/v row (kn/vn, f32) of one (batch row, kv head) as the
// pool stores it: rounded to the activation type T; for an int8 pool then
// quantized per row (amax over D, scale = amax / 127, q = clamp(rint(u /
// safe scale), -127, 127)), payload and raw scale. Written to the pool at
// position seq_lens[b] (page bt[b][len / page]; nothing past the table: a
// full table's row is not appended) and to the scratch rows kst/vst (B *
// Hkv, D) with scales kss/vss, from which the attention reads the step's
// own key (decode_split.cuh, OWN).
template <typename T, typename S>
__global__ void __launch_bounds__(APPEND_THREADS)
    append_kv_kernel(const float* __restrict__ kn,
                     const float* __restrict__ vn, S* kp, S* vp, float* ks,
                     float* vs, S* __restrict__ kst, S* __restrict__ vst,
                     float* __restrict__ kss, float* __restrict__ vss,
                     const int* __restrict__ bt, const int* __restrict__ sl,
                     int Hkv, int D, int num_pages, int page, int maxp) {
  const int b = blockIdx.x / Hkv, g = blockIdx.x - b * Hkv;
  const size_t nrow = blockIdx.x;  // b * Hkv + g
  const float* k = kn + nrow * D;
  const float* v = vn + nrow * D;
  float sk = 0.f, sv = 0.f;
  if constexpr (is_int8_pool<S>()) {
    __shared__ float red[2][APPEND_THREADS / 32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float mk = 0.f, mv = 0.f;
    for (int d = threadIdx.x; d < D; d += APPEND_THREADS) {
      mk = fmaxf(mk, fabsf(to_f(from_f<T>(k[d]))));
      mv = fmaxf(mv, fabsf(to_f(from_f<T>(v[d]))));
    }
    mk = warp_max(mk);
    mv = warp_max(mv);
    if (lane == 0) {
      red[0][warp] = mk;
      red[1][warp] = mv;
    }
    __syncthreads();
    mk = mv = 0.f;
    for (int w = 0; w < APPEND_THREADS / 32; ++w) {
      mk = fmaxf(mk, red[0][w]);
      mv = fmaxf(mv, red[1][w]);
    }
    sk = mk / 127.f;
    sv = mv / 127.f;
  }
  const int len = sl[b], j = len / page;
  const bool append = j < maxp;
  const size_t row =
      append ? ((size_t)g * num_pages + bt[(size_t)b * maxp + j]) * page +
                   (len - j * page)
             : 0;
  for (int d = threadIdx.x; d < D; d += APPEND_THREADS) {
    S kq, vq;
    if constexpr (is_int8_pool<S>()) {
      kq = (int8_t)quant_int8(to_f(from_f<T>(k[d])), sk);
      vq = (int8_t)quant_int8(to_f(from_f<T>(v[d])), sv);
    } else {
      kq = from_f<T>(k[d]);
      vq = from_f<T>(v[d]);
    }
    kst[nrow * D + d] = kq;
    vst[nrow * D + d] = vq;
    if (append) {
      kp[row * D + d] = kq;
      vp[row * D + d] = vq;
    }
  }
  if constexpr (is_int8_pool<S>()) {
    if (threadIdx.x == 0) {
      kss[nrow] = sk;
      vss[nrow] = sv;
      if (append) {
        ks[row] = sk;
        vs[row] = sv;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(EPI_THREADS)
    residual_epilogue_kernel(const T* __restrict__ x,
                             const float* __restrict__ part, int ks, int B,
                             int N, float* __restrict__ x2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  const int b = i / N;
  x2[i] = to_f(x[i]) + psum(part, ks, B, N, b, i - b * N);
}

__global__ void __launch_bounds__(EPI_THREADS)
    swiglu_epilogue_kernel(const float* __restrict__ pg,
                           const float* __restrict__ pu, int ks, int B, int N,
                           float* __restrict__ f) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  const int b = i / N, n = i - b * N;
  const float g = psum(pg, ks, B, N, b, n);
  const float u = psum(pu, ks, B, N, b, n);
  f[i] = g / (1.f + expf(-g)) * u;
}

template <typename T>
__global__ void __launch_bounds__(EPI_THREADS)
    down_epilogue_kernel(const float* __restrict__ x2,
                         const float* __restrict__ part, int ks, int B, int N,
                         T* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  const int b = i / N;
  out[i] = from_f<T>(x2[i] + psum(part, ks, B, N, b, i - b * N));
}

// Scratch layout (f32 elements), shared by the size query and the launch.
struct Layout {
  size_t h, q, kn, vn, ao, x2, f, kst, vst, kss, vss, part, total;
};

inline size_t phase_part(bool w4, int K, int B, const int* N, int nseg,
                         int cols) {
  size_t width = 0;
  for (int i = 0; i < nseg; ++i) width += (size_t)N[i];
  return (size_t)phase_ks(w4, K, N, nseg, cols) * B * width;
}

// w4: the layer's four matrices are int4 tiles (their GEMVs split as
// gemv4); nsplit: the attention's part count. The stored new rows (kst,
// vst) take B * nkv * d floats each, room for T or int8 at every offset a
// multiple of 8 floats (the widths are multiples of 8), so their rows
// travel in 16-byte loads. The part region holds the GEMVs' partial sums
// and, between the q/k/v epilogue and the o-proj GEMV, the attention's
// parts: po (nsplit, B * nh, d), then pml (nsplit, B * nh, 2).
inline Layout layout(int dtype, bool w4, int B, int hidden, int nh, int nkv,
                     int d, int inter, int nsplit) {
  const int cols = cols_per_tile(dtype);
  Layout L;
  size_t o = 0;
  L.h = o;  o += (size_t)B * hidden;
  L.q = o;  o += (size_t)B * nh * d;
  L.kn = o; o += (size_t)B * nkv * d;
  L.vn = o; o += (size_t)B * nkv * d;
  L.ao = o; o += (size_t)B * nh * d;
  L.x2 = o; o += (size_t)B * hidden;
  L.f = o;  o += (size_t)B * inter;
  L.kst = o; o += (size_t)B * nkv * d;
  L.vst = o; o += (size_t)B * nkv * d;
  L.kss = o; o += (size_t)B * nkv;
  L.vss = o; o += (size_t)B * nkv;
  L.part = o;
  const int nqkv[3] = {nh * d, nkv * d, nkv * d};
  const int no[1] = {hidden};
  const int ngu[2] = {inter, inter};
  size_t p = phase_part(w4, hidden, B, nqkv, 3, cols);
  p = std::max(p, phase_part(w4, nh * d, B, no, 1, cols));
  p = std::max(p, phase_part(w4, hidden, B, ngu, 2, cols));
  p = std::max(p, phase_part(w4, inter, B, no, 1, cols));
  if (nsplit > 1) p = std::max(p, (size_t)nsplit * B * nh * (d + 2));
  L.total = o + p;
  return L;
}

// One layer's weights, (in, out) layout. q, k and v are read with row
// strides ldq (= ldk = ldv when they are column ranges of one merged
// matrix), gate and up with ldg. With int4 tiles the four matrices are
// qkv (q|k|v merged), o, gu (gate|up merged) and d instead, and only the
// norms are read from the native pointers.
template <typename T>
struct LayerWeights {
  const T *ln1, *wq, *wk, *wv, *wo, *ln2, *wg, *wu, *wd;
  int ldq, ldk, ldv, ldg, ldu;
  Int4Mat qkv, o, gu, dn;
};

#define PTT_CHECK()                                   \
  do {                                                \
    const cudaError_t e_ = cudaGetLastError();        \
    if (e_ != cudaSuccess) return (int)e_;            \
  } while (0)

// One GEMV phase of run(): columns [col0[i], col0[i] + N[i]) of a merged
// int4 matrix m (W4), or the native matrices W with row strides ld.
template <typename T, bool W4>
int phase_gemv(const float* a, int K, int B, const T* const* W,
               const int* ld, const Int4Mat& m, const int* col0,
               const int* N, float* const* P, int nseg, cudaStream_t st) {
  if constexpr (W4) return gemv4(a, K, B, m, col0, N, P, nseg, st);
  else return gemv<T>(a, K, B, W, N, ld, P, nseg, st);
}

// One layer: x (B, hidden) -> out (B, hidden), both of type T. out may be x
// itself: x is last read by phase 3, out first written by phase 5. S is
// the KV pool's storage (T, or int8_t for an int8 pool); W4 reads the
// matrices as int4 tiles.
template <typename T, typename S, bool W4>
int run(const T* x, const LayerWeights<T>& w, PoolRef<S> pools,
        const int* bt, const int* sl, const float* inv_freq, T* out,
        float* scratch, int dtype, int B, int hidden, int nh, int nkv, int d,
        int inter, int num_pages, int page, int maxp, int part_pages,
        int nsplit, float eps, float scale, cudaStream_t st) {
  const Layout L = layout(dtype, W4, B, hidden, nh, nkv, d, inter, nsplit);
  float* h = scratch + L.h;
  float* q = scratch + L.q;
  float* kn = scratch + L.kn;
  float* vn = scratch + L.vn;
  float* ao = scratch + L.ao;
  float* x2 = scratch + L.x2;
  float* f = scratch + L.f;
  float* part = scratch + L.part;
  constexpr int COLS = 32 * Vec<T>::N;
  int rc;

  // 1. rms + q/k/v GEMVs + RoPE epilogue
  rms_kernel<T, T><<<B, EPI_THREADS, 0, st>>>(x, w.ln1, h, hidden, eps);
  PTT_CHECK();
  {
    const int N[3] = {nh * d, nkv * d, nkv * d};
    const int ld[3] = {w.ldq, w.ldk, w.ldv};
    const int c0[3] = {0, N[0], N[0] + N[1]};
    const int ks = phase_ks(W4, hidden, N, 3, COLS);
    float* P[3] = {part, part + (size_t)ks * B * N[0],
                   part + (size_t)ks * B * (N[0] + N[1])};
    const T* W[3] = {w.wq, w.wk, w.wv};
    if ((rc = phase_gemv<T, W4>(h, hidden, B, W, ld, w.qkv, c0, N, P, 3,
                                st)))
      return rc;
    const int items = B * nh * (d / 2) + B * nkv * (d / 2) + B * nkv * d;
    qkv_epilogue_kernel<<<cdiv(items, EPI_THREADS), EPI_THREADS, 0, st>>>(
        P[0], P[1], P[2], ks, B, nh, nkv, d, sl, inv_freq, q, kn, vn);
    PTT_CHECK();
  }
  // 2. append the new token's k/v, then attend over seq_lens + 1
  {
    S* kst = reinterpret_cast<S*>(scratch + L.kst);
    S* vst = reinterpret_cast<S*>(scratch + L.vst);
    float* kss = scratch + L.kss;
    float* vss = scratch + L.vss;
    append_kv_kernel<T, S><<<B * nkv, APPEND_THREADS, 0, st>>>(
        kn, vn, pools.kp, pools.vp, pools.ks, pools.vs, kst, vst, kss, vss,
        bt, sl, nkv, d, num_pages, page, maxp);
    PTT_CHECK();
    float* po = scratch + L.part;
    float* pml = po + (size_t)nsplit * B * nh * d;
    const DsCall<float, S> a{q, pools.kp, pools.vp, pools.ks, pools.vs,
                             kst, vst, kss, vss, bt, sl, ao, po, pml, B, nh,
                             nkv, d, num_pages, page, maxp, part_pages,
                             nsplit, scale};
    if ((rc = decode_split<float, S, true>(a, st))) return rc;
  }
  // 3. o-proj GEMV + residual
  {
    const int N[1] = {hidden};
    const int ld[1] = {hidden};
    const int c0[1] = {0};
    const int ks = phase_ks(W4, nh * d, N, 1, COLS);
    float* P[1] = {part};
    const T* W[1] = {w.wo};
    if ((rc = phase_gemv<T, W4>(ao, nh * d, B, W, ld, w.o, c0, N, P, 1, st)))
      return rc;
    residual_epilogue_kernel<T>
        <<<cdiv(B * hidden, EPI_THREADS), EPI_THREADS, 0, st>>>(
            x, part, ks, B, hidden, x2);
    PTT_CHECK();
  }
  // 4. rms + gate/up GEMVs + silu(g) * u
  rms_kernel<float, T><<<B, EPI_THREADS, 0, st>>>(x2, w.ln2, h, hidden, eps);
  PTT_CHECK();
  {
    const int N[2] = {inter, inter};
    const int ld[2] = {w.ldg, w.ldu};
    const int c0[2] = {0, inter};
    const int ks = phase_ks(W4, hidden, N, 2, COLS);
    float* P[2] = {part, part + (size_t)ks * B * inter};
    const T* W[2] = {w.wg, w.wu};
    if ((rc = phase_gemv<T, W4>(h, hidden, B, W, ld, w.gu, c0, N, P, 2, st)))
      return rc;
    swiglu_epilogue_kernel<<<cdiv(B * inter, EPI_THREADS), EPI_THREADS, 0,
                             st>>>(P[0], P[1], ks, B, inter, f);
    PTT_CHECK();
  }
  // 5. down GEMV + residual
  {
    const int N[1] = {hidden};
    const int ld[1] = {hidden};
    const int c0[1] = {0};
    const int ks = phase_ks(W4, inter, N, 1, COLS);
    float* P[1] = {part};
    const T* W[1] = {w.wd};
    if ((rc = phase_gemv<T, W4>(f, inter, B, W, ld, w.dn, c0, N, P, 1, st)))
      return rc;
    down_epilogue_kernel<T>
        <<<cdiv(B * hidden, EPI_THREADS), EPI_THREADS, 0, st>>>(
            x2, part, ks, B, hidden, out);
    PTT_CHECK();
  }
  return 0;
}

}  // namespace ptt
