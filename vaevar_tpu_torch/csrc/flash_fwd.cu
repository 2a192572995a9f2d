// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel vaevar_tpu/ops/pallas_attn.py::_fwd_kernel (the
// flash-2 forward of the unmasked full-grid LG stage of the 0.25 deg forecast
// model: B*h = 6, N = 16200 tokens, head dim 192).
//
// What bounds it on this card: tensor-core operations. One call at
// N = 16200, d = 192, B*h = 6 does two (N x N x d) products per head,
// 2 * 6.05e11 FLOP, while it moves under 0.1 GB. With the main path's types
// (f32 q and k from the rope stage, bf16 v) Q.K^T has f32 operands, which
// need the TF32 rate (495 TFLOP/s) and P.V is bf16 (989 TFLOP/s): the bound
// is 1.83 ms; all-bf16 1.22 ms.
//
// Design: one CTA of NW warps per (b*h, 16*NW-row q tile); each warp owns
// 16 q rows. The q tile stays in shared memory; k/v tiles of BK rows stream
// through a two-stage cp.async ring (16-byte copies, zero-fill past N), each
// operand in its own storage type. At d = 192: bf16 8 warps and 64-key
// tiles (150 KiB); f32 q/k with bf16 v 4 warps and 64 keys (197 KiB); one
// CTA per SM either way. Products run on mma.sync (wgmma needs
// both operands' k-major layouts in shared memory and a warpgroup-wide
// accumulator of 64 rows, which the per-warp online softmax and the 3xTF32
// split do not map to simply; mma.sync keeps every product and the softmax
// in one warp's registers):
//   - S = Q.K^T: f32 q/k on m16n8k8 TF32 with the 3xTF32 split (a single
//     TF32 pass moves a logit by ~5e-4 at d = 192, beyond the tolerances);
//     bf16 q/k on m16n8k16 bf16 (ldmatrix);
//   - the online softmax on the S fragments: a row lives on the 4 lanes of
//     a quad, so max and sum reduce with shfl_xor 1 and 2;
//   - P.V: with bf16 v, P is rounded to bf16 straight from the S registers
//     into the A fragment and V comes through ldmatrix.trans (m16n8k16);
//     with f32 v, P stays f32 in registers (paired k order, mma_sm90.cuh)
//     and P.V runs on 3xTF32.
// No atomics and a fixed order: a block recomputed under remat gives the
// same O and lse bit for bit.
//
// Semantics (those of _fwd_kernel and ops/flash.py::_forward):
//   q is pre-scaled by 1/sqrt(d); no mask except keys >= n;
//   m, l and the accumulator are f32; P is rounded to v's type before P.V;
//   O = acc / l in q's type; lse = m + log(l) in f32.
// Inputs (BH, n, d), contiguous, 16-byte aligned. q and k share a type; v
// may be bf16 while q and k are f32 (the rope stage rotates q and k with f32
// tables). The kernel allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr int SMEM_MAX = 232448;

// Warps, q rows and shared memory of a CTA for (q/k type, v type, head
// dim): NW warps of 16 q rows and BK key rows per stage; the q tile and two
// stages of k and v must fit. 8 warps and 64 keys where they fit; else 64
// keys on 4 warps; else 32 keys on 8 warps (f32 v at d = 192).
template <typename TQK, typename TV, int D>
struct Fwd {
  static constexpr int LDQ = tile_ld<TQK>(D), LDV = tile_ld<TV>(D);
  static constexpr int bytes(int nw, int bk) {
    return (int)(sizeof(TQK) * (16 * nw + 2 * bk) * LDQ + sizeof(TV) * 2 * bk * LDV);
  }
  static constexpr int NW = bytes(8, 64) <= SMEM_MAX || bytes(4, 64) > SMEM_MAX ? 8 : 4;
  static constexpr int BK = bytes(NW, 64) <= SMEM_MAX ? 64 : 32;
  static constexpr int BQ = 16 * NW, NT = 32 * NW, SMEM = bytes(NW, BK);
};

// s[j] (16 x 8, keys 8j..8j+7) = Q (this warp's 16 rows at sq) . K^T (BK
// rows at sk), summed over the head dim.
template <typename TQK, int D, int LD, int NS>
__device__ __forceinline__ void qk_product(float (&s)[NS][4], const TQK* sq, const TQK* sk) {
  if constexpr (is_f32<TQK>) {
#pragma unroll 2
    for (int c = 0; c < D; c += 8) {
      float xa[4];
      load_a_rows<LD>(xa, sq + c);
      const Tf32Split<4> a = split_tf32(xa);
      Tf32Split<2> b[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float xb[2];
        load_b_rows<LD>(xb, sk + 8 * j * LD + c);
        b[j] = split_tf32(xb);
      }
      mma_3xtf32(s, a, b);
    }
  } else {
#pragma unroll 2
    for (int c = 0; c < D; c += 16) {
      uint32_t a[4];
      load_a_bf16<LD>(a, sq + c);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t b[4];
        load_b_bf16_rows<LD>(b, sk + 8 * j * LD + c);
        mma_bf16(s[j], a, b[0], b[1]);
        mma_bf16(s[j + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc[d] (16 x 8, head columns 8d..8d+7) = acc[d] * corr + P . V, with P
// (16 x BK in the S fragments p) rounded to v's type and V the BK rows at
// sv. Each fragment's products go to a fresh accumulator (add_tile).
template <typename TV, int D, int LD, int NS>
__device__ __forceinline__ void pv_product(float (&acc)[D / 8][4], const float (&corr)[2],
                                           const float (&p)[NS][4], const TV* sv) {
  if constexpr (is_f32<TV>) {
    Tf32Split<4> a[NS];
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      float xa[4];
      c_as_a_paired(xa, p[kk]);
      a[kk] = split_tf32(xa);
    }
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      float tile[4] = {};
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        float xb[2];
        load_b_cols_paired<LD>(xb, sv + 8 * kk * LD + 8 * d);
        mma_3xtf32(tile, a[kk], split_tf32(xb));
      }
      add_tile(acc[d], tile, corr[0], corr[1]);
    }
  } else {
    uint32_t a[NS / 2][4];
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) c_as_a_bf16(a[kk], p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int d = 0; d < D / 8; d += 2) {
      float t0[4] = {}, t1[4] = {};
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t b[4];
        load_b_bf16_cols<LD>(b, sv + 16 * kk * LD + 8 * d);
        mma_bf16(t0, a[kk], b[0], b[1]);
        mma_bf16(t1, a[kk], b[2], b[3]);
      }
      add_tile(acc[d], t0, corr[0], corr[1]);
      add_tile(acc[d + 1], t1, corr[0], corr[1]);
    }
  }
}

template <typename TQK, typename TV, int D>
__global__ void __launch_bounds__(Fwd<TQK, TV, D>::NT)
    flash_fwd_kernel(const TQK* __restrict__ q, const TQK* __restrict__ k,
                     const TV* __restrict__ v, TQK* __restrict__ o,
                     float* __restrict__ lse, int n) {
  using C = Fwd<TQK, TV, D>;
  constexpr int BQ = C::BQ, NT = C::NT, BK = C::BK, LDQ = C::LDQ, LDV = C::LDV;
  constexpr int NS = BK / 8;  // S fragments (key columns) per warp
  constexpr int ND = D / 8;   // O fragments (head columns) per warp
  extern __shared__ __align__(16) unsigned char smem[];
  TQK* sq = reinterpret_cast<TQK*>(smem);
  TQK* sk = sq + BQ * LDQ;                            // 2 stages of BK rows
  TV* sv = reinterpret_cast<TV*>(sk + 2 * BK * LDQ);  // 2 stages of BK rows

  const int warp = threadIdx.x >> 5, g = lane_id() >> 2, t = lane_id() & 3;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * n * D;
  const int nk = (n + BK - 1) / BK;

  auto load_kv = [&](int j) {
    const int st = j & 1;
    copy_rows_async<TQK, BK, D, LDQ, NT>(sk + st * BK * LDQ, k + base, j * BK, n);
    copy_rows_async<TV, BK, D, LDV, NT>(sv + st * BK * LDV, v + base, j * BK, n);
  };
  copy_rows_async<TQK, BQ, D, LDQ, NT>(sq, q + base, q0, n);
  load_kv(0);
  cp_async_commit();

  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  // rows g and g + 8 of this warp: running max, and this lane's share of
  // the running sum (its 2 columns per fragment; the quad sums at the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];

  for (int j = 0; j < nk; ++j) {
    if (j + 1 < nk) load_kv(j + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and the q tile) landed
    __syncthreads();
    const int st = j & 1;

    float s[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    qk_product<TQK, D, LDQ, NS>(s, sq + warp * 16 * LDQ, sk + st * BK * LDQ);
    if ((j + 1) * BK > n) {  // keys >= n of the ragged last tile
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * BK + 8 * i + 2 * t + (e & 1) >= n) s[i][e] = -INFINITY;
    }

    // Online softmax; element e of a fragment is row g + 8 (e >> 1).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < NS; ++i) mx = fmaxf(mx, fmaxf(s[i][2 * r], s[i][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);  // finite: every tile has a key < n
      corr[r] = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i][2 * r] = expf(s[i][2 * r] - m_new);
        s[i][2 * r + 1] = expf(s[i][2 * r + 1] - m_new);
        rs += s[i][2 * r] + s[i][2 * r + 1];
      }
      l[r] = l[r] * corr[r] + rs;
      m[r] = m_new;
    }

    pv_product<TV, D, LDV, NS>(acc, corr, s, sv + st * BK * LDV);
    __syncthreads();  // stage st is free for tile j + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row < n) {
      const float inv = 1.f / l[r];
      TQK* out = o + base + (size_t)row * D + 2 * t;
#pragma unroll
      for (int d = 0; d < ND; ++d)
        store_pair(out + 8 * d, acc[d][2 * r] * inv, acc[d][2 * r + 1] * inv);
      if (t == 0) lse[(size_t)blockIdx.y * n + row] = m[r] + logf(l[r]);
    }
  }
}

template <typename TQK, typename TV, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int n, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<TQK, TV, D>;
  using C = Fwd<TQK, TV, D>;
  constexpr int smem = C::SMEM;
  static_assert(smem <= SMEM_MAX, "shared-memory tiles exceed the block limit");
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + C::BQ - 1) / C::BQ, bh);
  kern<<<grid, C::NT, smem, stream>>>(
      static_cast<const TQK*>(q), static_cast<const TQK*>(k),
      static_cast<const TV*>(v), static_cast<TQK*>(o),
      static_cast<float*>(lse), n);
  return (int)cudaGetLastError();
}

template <typename TQK, typename TV>
int dispatch_d(const void* q, const void* k, const void* v, void* o, void* lse,
               int bh, int n, int d, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<TQK, TV, 32>(q, k, v, o, lse, bh, n, stream);
    case 64: return launch<TQK, TV, 64>(q, k, v, o, lse, bh, n, stream);
    case 128: return launch<TQK, TV, 128>(q, k, v, o, lse, bh, n, stream);
    case 192: return launch<TQK, TV, 192>(q, k, v, o, lse, bh, n, stream);
    default: return -1;
  }
}

}  // namespace

// Type codes: 0 = float32, 1 = bfloat16. Returns 0 on success, -1 for
// arguments the kernel does not take, else the cudaError_t of the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int n, int d, int qk_type,
                         int v_type, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qk_type == 0 && v_type == 0)
    return dispatch_d<float, float>(q, k, v, o, lse, bh, n, d, s);
  if (qk_type == 1 && v_type == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(q, k, v, o, lse, bh, n, d, s);
  if (qk_type == 0 && v_type == 1)
    return dispatch_d<float, __nv_bfloat16>(q, k, v, o, lse, bh, n, d, s);
  return -1;
}
