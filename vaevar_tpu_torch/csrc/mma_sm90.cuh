// Tensor-core and copy helpers shared by the flash kernels (sm_90a).
//
// - cp.async copies of 16 and 4 bytes, with zero-fill for rows past the end;
// - mma.sync products: m16n8k8 TF32 and m16n8k16 bf16, f32 accumulate;
// - the split-TF32 product ("3xTF32", CUTLASS's OpMultiplyAddFastF32 in
//   cutlass/gemm/warp/mma_tensor_op_fast_f32.h): x = hi + lo with
//   hi = tf32(x) rounded to nearest and lo = x - hi (exact in f32, passed
//   as is: the tensor core reads the top 19 bits of a TF32 operand, which
//   truncates lo, CUTLASS's round_toward_zero for the small part);
//   a*b ~ lo_a*hi_b + hi_a*lo_b + hi_a*hi_b, the two small products first,
//   all in one f32 accumulator. It drops lo_a*lo_b and the truncation of lo
//   (~2^-21 relative), so an f32 product stays f32-accurate. An
//   operand that holds bf16 values is exact in TF32 (lo = 0) and skips the
//   products with its lo;
// - fragment loads from shared memory, named by the layout they read.
//
// Long sums: the tensor core adds each product into its accumulator with
// truncation, so a chain of thousands of mma on one accumulator drifts
// toward zero (dK summed over 16200 q rows in one chain was off by 1.3e-4 of
// its largest entry on the H100). The kernels therefore take each tile's
// products in a fresh accumulator (a chain of a few mma) and add it to the
// running f32 sum with one rounding to nearest (`add_tile`). Chains of
// dozens drift too, where a sum feeds an exponential or a difference: the
// dq kernel's S and dP summed over d = 192 in one chain (72 and 48 mma) left
// dq at 7.6e-6 of its largest entry, in chains of 32 columns at 2.6e-6.
//
// Fragment layouts (PTX ISA, warp-level mma), with g = lane / 4 and
// t = lane % 4:
//   m16n8k8 tf32:  A a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
//                  B b0 (k t, n g), b1 (k t+4, n g);
//   m16n8k16 bf16: A a0 (g, 2t..2t+1), a1 (g+8, ..), a2 (g, 2t+8..), a3
//                  (g+8, 2t+8..); B b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
//   C (both):      c0, c1 (g, 2t and 2t+1), c2, c3 (g+8, 2t and 2t+1).
// A TF32 product may permute its k index as long as A and B agree. The
// "paired" loads use k slot t <-> column 2t and slot t+4 <-> column 2t+1,
// which is the column pair a C fragment holds, so a C fragment becomes an A
// fragment in registers and a B operand stored (k, n) row-major reads
// without bank conflicts.
//
// Shared-memory row strides (elements): f32 tiles D + 4 (stride = 4 mod 32
// words: the row-wise pattern g*LD + t and the paired column pattern
// 2t*LD + g hit 32 distinct banks); bf16 tiles D + 8 (stride = 16 mod 128
// bytes: the 8 rows of an ldmatrix 8x8 hit 8 distinct 16-byte bank groups).
// The probability tiles of the dkv kernel and the exchange tiles of the dq
// kernel use their width + 8: for 32 f32 columns 40 (= 8 mod 32), so a
// float2 read or write at (g, 2t) hits distinct banks in each half-warp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_sm90 {

// ---- types ----------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
constexpr bool is_f32 = sizeof(T) == 4;

// Row stride in elements of a shared tile of D columns (see the note above).
template <typename T>
__host__ __device__ constexpr int tile_ld(int d) {
  return is_f32<T> ? d + 4 : d + 8;
}

// Two values rounded to nearest bf16, packed low-first (an mma bf16 pair).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stores the pair (x0, x1) at p as T (p is 2-element aligned).
__device__ __forceinline__ void store_pair(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x0, float x1) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(x0, x1);
}

// ---- asynchronous copies ------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !valid (src must still be mapped).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zero when !valid.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of a row-major (n, D) matrix into a shared tile with
// row stride LD; rows >= n are zero-filled. All NT threads take part.
template <typename T, int ROWS, int D, int LD, int NT>
__device__ __forceinline__ void copy_rows_async(T* dst, const T* __restrict__ src, int r0,
                                                int n) {
  constexpr int PER = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CH = D / PER;          // chunks per row
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * PER;
    const bool ok = r0 + r < n;
    cp_async_16(dst + r * LD + c, src + (size_t)(ok ? r0 + r : 0) * D + c, ok);
  }
}

// ---- tensor-core products -----------------------------------------------

// d += a * b, m16n8k8, TF32 operands, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b, m16n8k16, bf16 operands, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc = acc * scale + tile for a C fragment whose rows g and g+8 take
// scale[0] and scale[1]; f32 operations, rounded to nearest.
__device__ __forceinline__ void add_tile(float (&acc)[4], const float (&tile)[4],
                                         float scale0 = 1.f, float scale1 = 1.f) {
  acc[0] = fmaf(acc[0], scale0, tile[0]);
  acc[1] = fmaf(acc[1], scale0, tile[1]);
  acc[2] = fmaf(acc[2], scale1, tile[2]);
  acc[3] = fmaf(acc[3], scale1, tile[3]);
}

// An f32 operand fragment split for the 3xTF32 product.
template <int N>
struct Tf32Split {
  uint32_t hi[N], lo[N];
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// hi = tf32(x) rounded to nearest (ties away), lo = x - hi (the tensor core
// truncates it to TF32). EXACT: the values are exact in TF32 (bf16 origin),
// so lo is not needed.
template <bool EXACT = false, int N>
__device__ __forceinline__ Tf32Split<N> split_tf32(const float (&x)[N]) {
  Tf32Split<N> s;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (EXACT) {
      s.hi[i] = __float_as_uint(x[i]);
      s.lo[i] = 0u;
    } else {
      s.hi[i] = tf32_rna(x[i]);
      s.lo[i] = __float_as_uint(x[i] - __uint_as_float(s.hi[i]));
    }
  }
  return s;
}

// d += a * b to f32 accuracy from split operands (3 TF32 products, small
// ones first as CUTLASS orders them); an operand marked exact skips the
// product with its lo (2 products; 1 when both are exact).
template <bool A_EXACT = false, bool B_EXACT = false>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Tf32Split<4>& a,
                                           const Tf32Split<2>& b) {
  if constexpr (!A_EXACT) mma_tf32(d, a.lo, b.hi);
  if constexpr (!B_EXACT) mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// d[j] += a * b[j] for J fragments, as mma_3xtf32, run pass by pass so
// that consecutive mma write different accumulators and need not wait for
// each other.
template <bool A_EXACT = false, bool B_EXACT = false, int J>
__device__ __forceinline__ void mma_3xtf32(float (&d)[J][4], const Tf32Split<4>& a,
                                           const Tf32Split<2> (&b)[J]) {
  if constexpr (!A_EXACT) {
#pragma unroll
    for (int j = 0; j < J; ++j) mma_tf32(d[j], a.lo, b[j].hi);
  }
  if constexpr (!B_EXACT) {
#pragma unroll
    for (int j = 0; j < J; ++j) mma_tf32(d[j], a.hi, b[j].lo);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) mma_tf32(d[j], a.hi, b[j].hi);
}

// ---- fragment loads ----------------------------------------------------

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// A (16 x 8) of a row-major tile at s (row stride LD), standard layout.
template <int LD, typename T>
__device__ __forceinline__ void load_a_rows(float (&x)[4], const T* s) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  x[0] = to_f32(s[g * LD + t]);
  x[1] = to_f32(s[(g + 8) * LD + t]);
  x[2] = to_f32(s[g * LD + t + 4]);
  x[3] = to_f32(s[(g + 8) * LD + t + 4]);
}

// B (k 8 x n 8) of a tile stored (n, k) row-major at s: the rows of the
// tile are B's columns (K of Q.K^T), standard layout.
template <int LD, typename T>
__device__ __forceinline__ void load_b_rows(float (&x)[2], const T* s) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  x[0] = to_f32(s[g * LD + t]);
  x[1] = to_f32(s[g * LD + t + 4]);
}

// A (16 x 8) of an f32 row-major tile at s, paired k order (slot t <->
// column 2t, slot t+4 <-> column 2t+1): two float2 reads.
template <int LD>
__device__ __forceinline__ void load_a_paired(float (&x)[4], const float* s) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  const float2 u = *reinterpret_cast<const float2*>(s + g * LD + 2 * t);
  const float2 w = *reinterpret_cast<const float2*>(s + (g + 8) * LD + 2 * t);
  x[0] = u.x;
  x[1] = w.x;
  x[2] = u.y;
  x[3] = w.y;
}

// The A fragment of a C fragment c (16 x 8, f32) in the paired k order.
__device__ __forceinline__ void c_as_a_paired(float (&x)[4], const float (&c)[4]) {
  x[0] = c[0];
  x[1] = c[2];
  x[2] = c[1];
  x[3] = c[3];
}

// B (k 8 x n 8) of a tile stored (k, n) row-major at s (V of P.V), in the
// paired k order: b0 = s[2t][g], b1 = s[2t+1][g].
template <int LD, typename T>
__device__ __forceinline__ void load_b_cols_paired(float (&x)[2], const T* s) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  x[0] = to_f32(s[2 * t * LD + g]);
  x[1] = to_f32(s[(2 * t + 1) * LD + g]);
}

// ldmatrix .x4 of four 8 x 8 bf16 matrices; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A (16 x 16, bf16) of a row-major tile at s: a0..a3 of m16n8k16.
template <int LD>
__device__ __forceinline__ void load_a_bf16(uint32_t (&a)[4], const __nv_bfloat16* s) {
  const int l = lane_id();
  ldmatrix_x4(a, s + (((l >> 3) & 1) * 8 + (l & 7)) * LD + (l >> 4) * 8);
}

// B (k 16 x n 8) for two n tiles of a tile stored (n, k) row-major at s
// (K of Q.K^T): r0, r1 = b0, b1 of rows 0-7, r2, r3 of rows 8-15.
template <int LD>
__device__ __forceinline__ void load_b_bf16_rows(uint32_t (&b)[4], const __nv_bfloat16* s) {
  const int l = lane_id();
  ldmatrix_x4(b, s + ((l >> 4) * 8 + (l & 7)) * LD + ((l >> 3) & 1) * 8);
}

// B (k 16 x n 8) for two n tiles of a tile stored (k, n) row-major at s
// (V of P.V), transposed by ldmatrix: r0, r1 = b0, b1 of columns 0-7,
// r2, r3 of columns 8-15.
template <int LD>
__device__ __forceinline__ void load_b_bf16_cols(uint32_t (&b)[4], const __nv_bfloat16* s) {
  const int l = lane_id();
  ldmatrix_x4_trans(b, s + (((l >> 3) & 1) * 8 + (l & 7)) * LD + (l >> 4) * 8);
}

// The bf16 A fragment (16 x 16) of two f32 C fragments c0 (columns 0-7)
// and c1 (columns 8-15), rounded to nearest bf16.
__device__ __forceinline__ void c_as_a_bf16(uint32_t (&a)[4], const float (&c0)[4],
                                            const float (&c1)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

}  // namespace mma_sm90
