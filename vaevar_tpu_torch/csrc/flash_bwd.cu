// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernels vaevar_tpu/ops/pallas_attn.py::_dq_kernel and
// ::_dkv_kernel (the flash-2 backward of the unmasked full-grid LG stage of
// the 0.25 deg forecast model: B*h = 6, N = 16200 tokens, head dim 192),
// which training the forecast model reaches once per flash block and step.
//
// What bounds them on this card: tensor-core operations. At N = 16200,
// d = 192, B*h = 6 the dq kernel does three (N x N x d) products per head
// (1.8 TFLOP) and the dkv kernel four (2.4 TFLOP), while together they read
// and write ~0.3 GB, far above the H100's ~295 FLOP/byte ridge. A product
// with an f32 operand needs the TF32 rate (495 TFLOP/s), an all-bf16 one the
// bf16 rate (989 TFLOP/s): with the main path's types (f32 q, k, dO; bf16 v)
// every product has an f32 operand, so dq is bound at 3.66 ms and dkv at
// 4.89 ms; all-bf16 at 1.83 and 2.45 ms. What the design does about it: as
// on the TPU, two kernels, so that each gradient is summed inside one CTA
// and written once, with no atomics (two launches give bitwise-equal
// gradients):
//   - dq: one CTA per (b*h, 64-row q tile) keeps q, dO, lse, D and an f32 dQ
//     accumulator on chip and loops over 64-row k/v tiles. It still
//     multiplies with scalar f32 FMAs (float4 shared-memory reads);
//   - dkv: one CTA of 8 warps per (b*h, 64-row k tile) keeps k and v in
//     shared memory in their storage types and loops over 32-row q/dO tiles
//     (with lse and D) in a two-stage cp.async ring. Products run on
//     mma.sync (mma_sm90.cuh): 3xTF32 where an operand is f32 (V.dO^T with
//     bf16 v in two passes, since bf16 is exact in TF32), bf16 m16n8k16 in
//     all-bf16. Warp w = (key group w % 4, half w / 4): first it computes
//     S^T and dP^T for its 16 keys and 16 q columns and writes the rounded
//     P^T and dS^T tiles to shared memory; after a barrier it accumulates
//     dV and dK for its 16 keys and half of the head columns, so the two
//     f32 accumulators take 96 registers a thread at d = 192.
// The N x N probabilities are recomputed from the forward's lse and never
// leave the SM.
//
// Semantics (those of _dq_kernel, _dkv_kernel and _bwd_call):
//   q is pre-scaled by 1/sqrt(d); no mask except positions >= n;
//   P = exp(Q K^T - lse) with keys >= n giving 0; D = rowsum(dO * O) (f32,
//   computed by the caller); dP = dO V^T; dS = P * (dP - D), in f32;
//   dQ = sum dS K with dS rounded to k's type;
//   dV = sum P^T dO with P^T rounded to dO's type; rows >= n of P^T are 0;
//   dK = sum dS^T Q with dS^T rounded to q's type.
//   dQ and dK take q's (= k's) type, dV v's type.
// Inputs (BH, n, d), contiguous; lse and D (BH, n) f32. q, k and dO share a
// type; v may be bf16 while they are f32 (the rope stage rotates q and k with
// f32 tables, and dO comes in O's type, which is q's).
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr int BQ = 64;   // dq kernel: q rows per CTA
constexpr int BK = 64;   // k/v rows per tile (dq) and per CTA (dkv)
constexpr int BQ2 = 32;  // dkv kernel: q rows per tile of the q loop
constexpr int NT = 256;  // threads per CTA (dq: a 16 x 16 grid (tx, ty); dkv: 8 warps)
constexpr int PAD = 4;   // dq: row padding (floats), conflict-free float4 reads
constexpr int LDP = BQ2 + 8;  // dkv: row stride of the P^T and dS^T tiles

__device__ __forceinline__ float dot4(float4 a, float4 b, float t) {
  t = fmaf(a.x, b.x, t);
  t = fmaf(a.y, b.y, t);
  t = fmaf(a.z, b.z, t);
  return fmaf(a.w, b.w, t);
}

// rows [r0, r0 + rows) of a (n, D) matrix into a (rows, D + PAD) f32 tile;
// rows >= n read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int r0, int rows, int n) {
  constexpr int LD = D + PAD;
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D, c = i % D, gr = r0 + r;
    dst[r * LD + c] = gr < n ? to_f32(src[(size_t)gr * D + c]) : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (D + PAD) + (size_t)BQ * (BK + PAD));
}

// dkv shared memory: k and v tiles, two stages of q and dO tiles, the P^T
// and dS^T tiles (q's type) and two stages of lse and D.
template <typename TQK, typename TV, int D>
constexpr int dkv_smem_bytes() {
  return (int)(sizeof(TQK) * (BK * tile_ld<TQK>(D) + 4 * BQ2 * tile_ld<TQK>(D) +
                              2 * BK * LDP) +
               sizeof(TV) * BK * tile_ld<TV>(D) + sizeof(float) * 4 * BQ2);
}

template <typename TQK, typename TV, int D>
__global__ void __launch_bounds__(NT)
    flash_dq_kernel(const TQK* __restrict__ q, const TQK* __restrict__ k,
                    const TV* __restrict__ v, const TQK* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    TQK* __restrict__ dq, int n) {
  constexpr int LD = D + PAD;   // row stride of the q, dO, k and v tiles
  constexpr int LS = BK + PAD;  // row stride of the dS tile
  constexpr int DC = D / 16;    // dQ columns per thread
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sdo = sq + BQ * LD;
  float* sk = sdo + BQ * LD;
  float* sv = sk + BK * LD;
  float* sds = sv + BK * LD;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key column / dQ column lane
  const int ty = tid / 16;  // row lane: this thread owns rows ty + 16 i
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * n * D;
  const size_t rbase = (size_t)blockIdx.y * n;

  load_tile<TQK, D>(sq, q + base, q0, BQ, n);
  load_tile<TQK, D>(sdo, dout + base, q0, BQ, n);
  float rl[4], rd[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    rl[i] = r < n ? lse[rbase + r] : 0.f;
    rd[i] = r < n ? delta[rbase + r] : 0.f;
#pragma unroll
    for (int d = 0; d < DC; ++d) acc[i][d] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<TQK, D>(sk, k + base, k0, BK, n);
    load_tile<TV, D>(sv, v + base, k0, BK, n);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for rows ty + 16 i, key columns tx + 16 j.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      float4 a[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(&sq[(ty + 16 * i) * LD + c]);
        g[i] = *reinterpret_cast<const float4*>(&sdo[(ty + 16 * i) * LD + c]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(&sk[(tx + 16 * j) * LD + c]);
        const float4 w = *reinterpret_cast<const float4*>(&sv[(tx + 16 * j) * LD + c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = dot4(a[i], b, s[i][j]);
          dp[i][j] = dot4(g[i], w, dp[i][j]);
        }
      }
    }

    // dS = P (dP - D), P = exp(S - lse); keys >= n give P = 0. dS is
    // rounded to k's type before dS K, as _dq_kernel does.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = k0 + tx + 16 * j < n;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ok ? expf(s[i][j] - rl[i]) : 0.f;
        sds[(ty + 16 * i) * LS + tx + 16 * j] = round_to<TQK>(p * (dp[i][j] - rd[i]));
      }
    }
    __syncthreads();

    // dQ += dS K for rows ty + 16 i and head columns tx + 16 d.
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        da[i] = *reinterpret_cast<const float4*>(&sds[(ty + 16 * i) * LS + c]);
#pragma unroll
      for (int d = 0; d < DC; ++d) {
        const float4 kc = make_float4(
            sk[(c + 0) * LD + tx + 16 * d], sk[(c + 1) * LD + tx + 16 * d],
            sk[(c + 2) * LD + tx + 16 * d], sk[(c + 3) * LD + tx + 16 * d]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][d] = dot4(da[i], kc, acc[i][d]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < n) {
#pragma unroll
      for (int d = 0; d < DC; ++d)
        dq[base + (size_t)r * D + tx + 16 * d] = from_f32<TQK>(acc[i][d]);
    }
  }
}

// dS^T and P^T of this warp's 16 keys and 16 q columns, from S^T = K.Q^T
// and dP^T = V.dO^T summed over the head dim (sk, sv: the warp's key rows;
// sq, sdo: its q rows).
template <typename TQK, typename TV, int D>
__device__ __forceinline__ void dkv_scores(float (&st)[2][4], float (&dpt)[2][4],
                                           const TQK* sk, const TV* sv, const TQK* sq,
                                           const TQK* sdo) {
  constexpr int LDQ = tile_ld<TQK>(D), LDV = tile_ld<TV>(D);
  if constexpr (is_f32<TQK>) {
#pragma unroll 4
    for (int c = 0; c < D; c += 8) {
      float xk[4], xv[4];
      load_a_rows<LDQ>(xk, sk + c);
      load_a_rows<LDV>(xv, sv + c);
      const Tf32Split<4> a = split_tf32(xk);
      const Tf32Split<4> av = split_tf32<!is_f32<TV>>(xv);  // bf16 v: exact in TF32
      Tf32Split<2> bq[2], bo[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float xq[2], xo[2];
        load_b_rows<LDQ>(xq, sq + 8 * j * LDQ + c);
        load_b_rows<LDQ>(xo, sdo + 8 * j * LDQ + c);
        bq[j] = split_tf32(xq);
        bo[j] = split_tf32(xo);
      }
      mma_3xtf32(st, a, bq);
      mma_3xtf32<!is_f32<TV>>(dpt, av, bo);
    }
  } else {
#pragma unroll 2
    for (int c = 0; c < D; c += 16) {
      uint32_t a[4], av[4], b[4], bo[4];
      load_a_bf16<LDQ>(a, sk + c);
      load_a_bf16<LDV>(av, sv + c);
      load_b_bf16_rows<LDQ>(b, sq + c);
      load_b_bf16_rows<LDQ>(bo, sdo + c);
      mma_bf16(st[0], a, b[0], b[1]);
      mma_bf16(st[1], a, b[2], b[3]);
      mma_bf16(dpt[0], av, bo[0], bo[1]);
      mma_bf16(dpt[1], av, bo[2], bo[3]);
    }
  }
}

// dv[d] += P^T . dO and dk[d] += dS^T . Q for this warp's 16 keys (spt, sdst
// at its rows) and D/2 head columns (sdo, sq at its first column), over the
// BQ2 q rows of the tile; each fragment's products go to a fresh
// accumulator (add_tile), so the sums over N keep f32 accuracy.
template <typename TQK, int D>
__device__ __forceinline__ void dkv_accumulate(float (&dv)[D / 16][4], float (&dk)[D / 16][4],
                                               const TQK* spt, const TQK* sdst,
                                               const TQK* sdo, const TQK* sq) {
  constexpr int LDQ = tile_ld<TQK>(D), NH = D / 16;
  if constexpr (is_f32<TQK>) {
    constexpr int KS = BQ2 / 8;
    Tf32Split<4> ap[KS], ad[KS];
#pragma unroll
    for (int c = 0; c < KS; ++c) {
      float xp[4], xd[4];
      load_a_paired<LDP>(xp, spt + 8 * c);
      load_a_paired<LDP>(xd, sdst + 8 * c);
      ap[c] = split_tf32(xp);
      ad[c] = split_tf32(xd);
    }
#pragma unroll
    for (int d = 0; d < NH; d += 2) {
      float tv[2][4] = {}, tk[2][4] = {};
#pragma unroll
      for (int c = 0; c < KS; ++c) {
        Tf32Split<2> bo[2], bq[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float xo[2], xq[2];
          load_b_cols_paired<LDQ>(xo, sdo + 8 * c * LDQ + 8 * (d + h));
          load_b_cols_paired<LDQ>(xq, sq + 8 * c * LDQ + 8 * (d + h));
          bo[h] = split_tf32(xo);
          bq[h] = split_tf32(xq);
        }
        mma_3xtf32(tv, ap[c], bo);
        mma_3xtf32(tk, ad[c], bq);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        add_tile(dv[d + h], tv[h]);
        add_tile(dk[d + h], tk[h]);
      }
    }
  } else {
    constexpr int KS = BQ2 / 16;
    uint32_t ap[KS][4], ad[KS][4];
#pragma unroll
    for (int c = 0; c < KS; ++c) {
      load_a_bf16<LDP>(ap[c], spt + 16 * c);
      load_a_bf16<LDP>(ad[c], sdst + 16 * c);
    }
#pragma unroll
    for (int d = 0; d < NH; d += 2) {
      float tv[2][4] = {}, tk[2][4] = {};
#pragma unroll
      for (int c = 0; c < KS; ++c) {
        uint32_t bo[4], bq[4];
        load_b_bf16_cols<LDQ>(bo, sdo + 16 * c * LDQ + 8 * d);
        load_b_bf16_cols<LDQ>(bq, sq + 16 * c * LDQ + 8 * d);
        mma_bf16(tv[0], ap[c], bo[0], bo[1]);
        mma_bf16(tv[1], ap[c], bo[2], bo[3]);
        mma_bf16(tk[0], ad[c], bq[0], bq[1]);
        mma_bf16(tk[1], ad[c], bq[2], bq[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        add_tile(dv[d + h], tv[h]);
        add_tile(dk[d + h], tk[h]);
      }
    }
  }
}

template <typename TQK, typename TV, int D>
__global__ void __launch_bounds__(NT, 1)
    flash_dkv_kernel(const TQK* __restrict__ q, const TQK* __restrict__ k,
                     const TV* __restrict__ v, const TQK* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     TQK* __restrict__ dk, TV* __restrict__ dv, int n) {
  constexpr int LDQ = tile_ld<TQK>(D), LDV = tile_ld<TV>(D), NH = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  TQK* sk = reinterpret_cast<TQK*>(smem);
  TQK* sq = sk + BK * LDQ;         // 2 stages of BQ2 rows
  TQK* sdo = sq + 2 * BQ2 * LDQ;   // 2 stages of BQ2 rows
  TQK* spt = sdo + 2 * BQ2 * LDQ;  // P^T (BK x BQ2), rounded to dO's type
  TQK* sdst = spt + BK * LDP;      // dS^T (BK x BQ2), rounded to q's type
  TV* sv = reinterpret_cast<TV*>(sdst + BK * LDP);
  float* slse = reinterpret_cast<float*>(sv + BK * LDV);  // 2 stages of BQ2
  float* sdel = slse + 2 * BQ2;                            // 2 stages of BQ2

  const int warp = threadIdx.x >> 5, g = lane_id() >> 2, t = lane_id() & 3;
  const int kg = warp & 3, half = warp >> 2;  // key rows 16 kg.., q / head half
  const int k0 = blockIdx.x * BK;
  const size_t base = (size_t)blockIdx.y * n * D;
  const size_t rbase = (size_t)blockIdx.y * n;
  const int nq = (n + BQ2 - 1) / BQ2;

  auto load_q = [&](int i) {
    const int st = i & 1, r0 = i * BQ2;
    copy_rows_async<TQK, BQ2, D, LDQ, NT>(sq + st * BQ2 * LDQ, q + base, r0, n);
    copy_rows_async<TQK, BQ2, D, LDQ, NT>(sdo + st * BQ2 * LDQ, dout + base, r0, n);
    const int tid = threadIdx.x;
    if (tid < 2 * BQ2) {
      const int r = r0 + (tid % BQ2);
      const bool ok = r < n;
      const float* src = (tid < BQ2 ? lse : delta) + rbase + (ok ? r : 0);
      cp_async_4((tid < BQ2 ? slse : sdel) + st * BQ2 + tid % BQ2, src, ok);
    }
  };
  copy_rows_async<TQK, BK, D, LDQ, NT>(sk, k + base, k0, n);
  copy_rows_async<TV, BK, D, LDV, NT>(sv, v + base, k0, n);
  load_q(0);
  cp_async_commit();

  float dk_acc[NH][4], dv_acc[NH][4];
#pragma unroll
  for (int d = 0; d < NH; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.f;

  for (int i = 0; i < nq; ++i) {
    if (i + 1 < nq) load_q(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile i (and k, v) landed
    __syncthreads();
    const int st = i & 1, q0 = i * BQ2;
    const TQK* sqi = sq + st * BQ2 * LDQ;
    const TQK* sdoi = sdo + st * BQ2 * LDQ;

    // S^T and dP^T for keys 16 kg.. and q columns 16 half..; element e of a
    // fragment is key row g + 8 (e >> 1), q column 2t + (e & 1).
    float st4[2][4] = {}, dpt[2][4] = {};
    dkv_scores<TQK, TV, D>(st4, dpt, sk + 16 * kg * LDQ, sv + 16 * kg * LDV,
                           sqi + 16 * half * LDQ, sdoi + 16 * half * LDQ);
    // P^T = exp(S^T - lse), 0 for q rows >= n; dS^T = P^T (dP^T - D) from
    // the unrounded P^T; P^T rounded to dO's type and dS^T to q's type.
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = 16 * half + 8 * j + 2 * t, row = 16 * kg + g + 8 * r;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = col + e;
          p[e] = q0 + qc < n ? expf(st4[j][2 * r + e] - slse[st * BQ2 + qc]) : 0.f;
          ds[e] = p[e] * (dpt[j][2 * r + e] - sdel[st * BQ2 + qc]);
        }
        store_pair(spt + row * LDP + col, p[0], p[1]);
        store_pair(sdst + row * LDP + col, ds[0], ds[1]);
      }
    __syncthreads();

    dkv_accumulate<TQK, D>(dv_acc, dk_acc, spt + 16 * kg * LDP, sdst + 16 * kg * LDP,
                           sdoi + half * (D / 2), sqi + half * (D / 2));
    __syncthreads();  // stage st and the P^T, dS^T tiles are free
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + 16 * kg + g + 8 * r;
    if (row < n) {
      const size_t off = base + (size_t)row * D + half * (D / 2) + 2 * t;
#pragma unroll
      for (int d = 0; d < NH; ++d) {
        store_pair(dk + off + 8 * d, dk_acc[d][2 * r], dk_acc[d][2 * r + 1]);
        store_pair(dv + off + 8 * d, dv_acc[d][2 * r], dv_acc[d][2 * r + 1]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int bh, n;
  cudaStream_t stream;
};

template <typename TQK, typename TV, int D>
int launch_dq(const Args& a) {
  auto kern = flash_dq_kernel<TQK, TV, D>;
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + BQ - 1) / BQ, a.bh);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const TQK*>(a.q), static_cast<const TQK*>(a.k),
      static_cast<const TV*>(a.v), static_cast<const TQK*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<TQK*>(a.dq), a.n);
  return (int)cudaGetLastError();
}

template <typename TQK, typename TV, int D>
int launch_dkv(const Args& a) {
  auto kern = flash_dkv_kernel<TQK, TV, D>;
  constexpr int smem = dkv_smem_bytes<TQK, TV, D>();
  static_assert(smem <= 232448, "shared-memory tiles exceed the block limit");
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + BK - 1) / BK, a.bh);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const TQK*>(a.q), static_cast<const TQK*>(a.k),
      static_cast<const TV*>(a.v), static_cast<const TQK*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<TQK*>(a.dk), static_cast<TV*>(a.dv), a.n);
  return (int)cudaGetLastError();
}

template <bool DQ, typename TQK, typename TV, int D>
int launch(const Args& a) {
  if constexpr (DQ) return launch_dq<TQK, TV, D>(a);
  else return launch_dkv<TQK, TV, D>(a);
}

template <bool DQ, typename TQK, typename TV>
int dispatch_d(const Args& a, int d) {
  switch (d) {
    case 32: return launch<DQ, TQK, TV, 32>(a);
    case 64: return launch<DQ, TQK, TV, 64>(a);
    case 128: return launch<DQ, TQK, TV, 128>(a);
    case 192: return launch<DQ, TQK, TV, 192>(a);
    default: return -1;
  }
}

template <bool DQ>
int dispatch(const Args& a, int d, int qk_type, int v_type) {
  if (a.bh <= 0 || a.bh > 65535 || a.n <= 0) return -1;
  if (qk_type == 0 && v_type == 0) return dispatch_d<DQ, float, float>(a, d);
  if (qk_type == 1 && v_type == 1)
    return dispatch_d<DQ, __nv_bfloat16, __nv_bfloat16>(a, d);
  if (qk_type == 0 && v_type == 1) return dispatch_d<DQ, float, __nv_bfloat16>(a, d);
  return -1;
}

}  // namespace

// Type codes: 0 = float32, 1 = bfloat16 (q, k and dO share qk_type). Each
// returns 0 on success, -1 for arguments the kernel does not take, else the
// cudaError_t of the launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta,
                            void* dq, int bh, int n, int d, int qk_type,
                            int v_type, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh, n,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, d, qk_type, v_type);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             void* dk, void* dv, int bh, int n, int d, int qk_type,
                             int v_type, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, bh, n,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, d, qk_type, v_type);
}
