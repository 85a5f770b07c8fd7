// The tensor-core and async-copy primitives the port's bf16 attention
// kernels share: prefill_mma.cuh (#1, #4) and flash_attention.cu's backward
// (#8, #9). mma.sync.m16n8k16 (bf16 in, f32 accumulators) with fragments
// by ldmatrix (plain, or transposed for an operand stored k-major), f32 ->
// bf16 pairs (one rounding, or hi + lo for about 16 bits), cp.async copies
// of tensor rows into padded shared-memory rows (zero-filled where a row
// does not exist), and stores of staged rows back to device memory.
#pragma once

#include "common.cuh"

namespace ptt {

constexpr float LOG2E = 1.4426950408889634f;

// shared-memory row stride (elements) of a bf16 tile of head dim DP
__host__ __device__ constexpr int tile_stride(int dp) { return dp + 8; }

// the head dim a tile is padded to: one of the four instantiations
inline int padded_head_dim(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 96 ? 96 : 128;
}

// the widest copy piece (16, 8, 4, 2 or 1 bytes) that every row of a
// tensor at `p` with `row_bytes` a row starts on
inline int copy_unit(const void* p, size_t row_bytes) {
  int u = 16;
  while (u > 1 && (((uintptr_t)p | row_bytes) % (uintptr_t)u)) u >>= 1;
  return u;
}

// 2^x (approximate, flushing subnormal results to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// `bytes` (4, 8 or 16) from global to shared; zeros when !valid
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes, bool valid) {
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c += a b, one m16n8k16 bf16 product with f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as two bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Copy `nrows` rows of `n` elements each into shared rows of stride `sr`
// elements: row r is src[row_id(r) * n ..], or zeros where row_id(r) < 0.
// Pieces of `unit` bytes: cp.async for 4, 8 and 16, plain copies below.
template <typename E, typename RowId>
__device__ __forceinline__ void copy_rows(E* dst, int sr, const E* src,
                                          int n, int nrows,
                                          const RowId& row_id, int unit) {
  const int row_bytes = n * (int)sizeof(E);
  const int upr = row_bytes / unit;
  for (int c = threadIdx.x; c < nrows * upr; c += blockDim.x) {
    const int r = c / upr, off = (c - r * upr) * unit;
    const long long id = row_id(r);
    const char* s = reinterpret_cast<const char*>(src) +
                    (id >= 0 ? id * row_bytes + off : 0);
    char* d = reinterpret_cast<char*>(dst + (size_t)r * sr) + off;
    if (unit >= 4) {
      cp_async(smem_addr(d), s, unit, id >= 0);
    } else {
      for (int i = 0; i < unit; ++i) d[i] = id >= 0 ? s[i] : (char)0;
    }
  }
}

// The same for rows of exactly UPR 16-byte pieces (the common case: a
// head dim that is its padded width, rows aligned to 16 bytes), with the
// piece arithmetic known at compile time.
template <int UPR, typename E, typename RowId>
__device__ __forceinline__ void copy_rows16(E* dst, int sr, const E* src,
                                            int nrows, const RowId& row_id) {
  for (int c = threadIdx.x; c < nrows * UPR; c += blockDim.x) {
    const int r = c / UPR, off = (c % UPR) * 16;
    const long long id = row_id(r);
    const char* s = reinterpret_cast<const char*>(src) +
                    (id >= 0 ? id * (UPR * 16) + off : 0);
    cp_async(smem_addr(reinterpret_cast<char*>(dst + (size_t)r * sr) + off),
             s, 16, id >= 0);
  }
}

// `unit` bytes from shared `s` to global `d`
__device__ __forceinline__ void store_unit(char* d, const char* s, int unit) {
  if (unit == 16) *reinterpret_cast<uint4*>(d) =
      *reinterpret_cast<const uint4*>(s);
  else if (unit == 8) *reinterpret_cast<uint2*>(d) =
      *reinterpret_cast<const uint2*>(s);
  else if (unit == 4) *reinterpret_cast<uint32_t*>(d) =
      *reinterpret_cast<const uint32_t*>(s);
  else for (int i = 0; i < unit; ++i) d[i] = s[i];
}

}  // namespace ptt
