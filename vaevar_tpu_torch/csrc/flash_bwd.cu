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
// gradients). Products run on mma.sync (mma_sm90.cuh): 3xTF32 where an
// operand is f32 (a product with bf16 v in two passes, since bf16 is exact
// in TF32), bf16 m16n8k16 in all-bf16. Operands stay in their storage types
// in shared memory; k/v or q/dO tiles stream through a two-stage cp.async
// ring (zero-filled past n).
//   - dq (the forward's shape on the dq products): one CTA per (b*h, q tile)
//     keeps the q and dO tiles in shared memory and loops over k/v tiles.
//     A row group of 16 q rows holds its lse and D in registers and computes
//     S = Q.K^T and dP = dO.V^T on C fragments, dS = P (dP - D) in place,
//     then dQ += dS.K with dS going from the C fragments straight into the
//     A fragment (paired k order for f32 k, rounded to bf16 for bf16 k); K
//     is read row-wise for Q.K^T and by columns for dS.K. Each tile's dS.K
//     goes to a fresh accumulator added to the f32 dQ. In all-bf16 (8 warps,
//     64-key tiles at d = 192) a warp owns a row group and dQ takes 96
//     registers a thread; with f32 q and k (8 warps, 64 q rows, 32-key
//     tiles) a row group's two warps each sum S and dP over half of the head
//     dim, add the other's half through shared memory, and accumulate half
//     of the head columns of dQ (Dq);
//   - dkv: one CTA of 8 warps per (b*h, 64-row k tile) keeps k and v in
//     shared memory and loops over 32-row q/dO tiles (with lse and D).
//     Warp w = (key group w % 4, half w / 4): first it computes
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

constexpr int SMEM_MAX = 232448;  // shared memory a block can use
constexpr int BK = 64;   // dkv kernel: k/v rows per CTA
constexpr int BQ2 = 32;  // dkv kernel: q rows per tile of the q loop
constexpr int NT = 256;  // dkv kernel: threads per CTA (8 warps)
constexpr int LDP = BQ2 + 8;  // dkv: row stride of the P^T and dS^T tiles

// dkv shared memory: k and v tiles, two stages of q and dO tiles, the P^T
// and dS^T tiles (q's type) and two stages of lse and D.
template <typename TQK, typename TV, int D>
constexpr int dkv_smem_bytes() {
  return (int)(sizeof(TQK) * (BK * tile_ld<TQK>(D) + 4 * BQ2 * tile_ld<TQK>(D) +
                              2 * BK * LDP) +
               sizeof(TV) * BK * tile_ld<TV>(D) + sizeof(float) * 4 * BQ2);
}

// A dq CTA for (q/k type, v type, head dim): RG row groups of 16 q rows and
// KT keys per k/v tile. Without SPLIT one warp owns a row group. With SPLIT
// two warps share one: each sums S and dP over half of the head dim, the
// two hand each other their partial sums through shared memory (two f32
// tiles per half), and each then forms dS for the whole key tile and
// accumulates dQ for its half of the head columns. The q and dO tiles, two
// stages of k and v (and the exchange tiles) must fit: 8 row groups and 64
// keys where they fit, else 4 and 64, else 4 and 32; with SPLIT 4 row groups
// (8 warps). f32 q and k SPLIT where it fits (at d = 192 with bf16 v, not
// with f32 v): 4 row groups and 32-key tiles are all that fit, and twice the
// warps hide the latency of their 3xTF32 products; bf16 does not: 8 one-warp
// row groups and 64-key tiles fit, and beat the split
// (scripts/kernel_variants_flash.json, dq_other_design; PERF.md, section 6).
template <typename TQK, typename TV, int D>
struct Dq {
  static constexpr int LDQ = tile_ld<TQK>(D), LDV = tile_ld<TV>(D);
  static constexpr int bytes(bool split, int rg, int kt) {
    return (int)(sizeof(TQK) * (32 * rg + 2 * kt) * LDQ + sizeof(TV) * 2 * kt * LDV +
                 (split ? sizeof(float) * 4 * 16 * rg * (kt + 8) : 0));
  }
  static constexpr bool SPLIT = is_f32<TQK> && bytes(true, 4, 32) <= SMEM_MAX;
  static constexpr int RG = !SPLIT && bytes(false, 8, 64) <= SMEM_MAX ? 8 : 4;
  static constexpr int KT = bytes(SPLIT, RG, 64) <= SMEM_MAX ? 64 : 32;
  static constexpr int BQ = 16 * RG, NW = SPLIT ? 2 * RG : RG, NT = 32 * NW;
  static constexpr int LDX = KT + 8;  // row stride of the exchange tiles (see mma_sm90.cuh)
  static constexpr int SMEM = bytes(SPLIT, RG, KT);
};

// s[j] = Q.K^T and dp[j] = dO.V^T (16 x 8 each, keys 8j..8j+7) for the 16
// q rows at sq, sdo and the 8 NS keys at sk, sv, summed over DS head
// columns (tiles of D columns). f32 q, k and dO: 3xTF32, dO.V^T in two
// passes when v is bf16 (exact in TF32), each 64 (or 32) columns in fresh
// accumulators added to s and dp in f32 (long chains drift toward zero, see
// mma_sm90.cuh); all-bf16: m16n8k16.
template <typename TQK, typename TV, int D, int DS, int NS>
__device__ __forceinline__ void dq_scores(float (&s)[NS][4], float (&dp)[NS][4], const TQK* sq,
                                          const TQK* sdo, const TQK* sk, const TV* sv) {
  constexpr int LDQ = tile_ld<TQK>(D), LDV = tile_ld<TV>(D);
  if constexpr (is_f32<TQK>) {
    // head columns per fresh accumulator
    constexpr int CH = DS % 64 == 0 ? 64 : DS % 32 == 0 ? 32 : DS;
    for (int c0 = 0; c0 < DS; c0 += CH) {
      float ts[NS][4] = {}, tp[NS][4] = {};
#pragma unroll
      for (int c = c0; c < c0 + CH; c += 8) {
        float xq[4], xo[4];
        load_a_rows<LDQ>(xq, sq + c);
        load_a_rows<LDQ>(xo, sdo + c);
        const Tf32Split<4> a = split_tf32(xq), ao = split_tf32(xo);
        Tf32Split<2> bk[NS], bv[NS];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          float xk[2], xv[2];
          load_b_rows<LDQ>(xk, sk + 8 * j * LDQ + c);
          load_b_rows<LDV>(xv, sv + 8 * j * LDV + c);
          bk[j] = split_tf32(xk);
          bv[j] = split_tf32<!is_f32<TV>>(xv);
        }
        mma_3xtf32(ts, a, bk);
        mma_3xtf32<false, !is_f32<TV>>(tp, ao, bv);
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        add_tile(s[j], ts[j]);
        add_tile(dp[j], tp[j]);
      }
    }
  } else {
    static_assert(NS % 2 == 0, "bf16 B fragments come in pairs of 8 keys");
#pragma unroll 2
    for (int c = 0; c < DS; c += 16) {
      uint32_t a[4], ao[4];
      load_a_bf16<LDQ>(a, sq + c);
      load_a_bf16<LDQ>(ao, sdo + c);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t b[4], bv[4];
        load_b_bf16_rows<LDQ>(b, sk + 8 * j * LDQ + c);
        load_b_bf16_rows<LDV>(bv, sv + 8 * j * LDV + c);
        mma_bf16(s[j], a, b[0], b[1]);
        mma_bf16(s[j + 1], a, b[2], b[3]);
        mma_bf16(dp[j], ao, bv[0], bv[1]);
        mma_bf16(dp[j + 1], ao, bv[2], bv[3]);
      }
    }
  }
}

// The A fragments of dS (16 rows x 8 NK keys) for dS.K from dS's C
// fragments, dS rounded to k's type: f32 split in the paired k order, bf16
// packed in pairs.
template <typename T, int NK>
struct DsFrags;

template <int NK>
struct DsFrags<float, NK> {
  Tf32Split<4> a[NK];
  __device__ __forceinline__ void from_c(const float (&ds)[NK][4]) {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      float x[4];
      c_as_a_paired(x, ds[kk]);
      a[kk] = split_tf32(x);
    }
  }
};

template <int NK>
struct DsFrags<__nv_bfloat16, NK> {
  uint32_t a[NK / 2][4];
  __device__ __forceinline__ void from_c(const float (&ds)[NK][4]) {
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) c_as_a_bf16(a[kk], ds[2 * kk], ds[2 * kk + 1]);
  }
};

// acc[d] (16 x 8, head columns 8d..8d+7 of the tile at sk) += dS . K over
// the 8 NK keys (rows of sk); each pair of fragments takes the tile's
// products in a fresh accumulator (add_tile), so the sum over N keeps f32
// accuracy. K is B stored (k, n) row-major: paired columns for f32,
// ldmatrix.trans for bf16.
template <typename TQK, int D, int ND, int NK>
__device__ __forceinline__ void dq_accumulate(float (&acc)[ND][4], const DsFrags<TQK, NK>& f,
                                              const TQK* sk) {
  constexpr int LD = tile_ld<TQK>(D);
#pragma unroll
  for (int d = 0; d < ND; d += 2) {
    float tile[2][4] = {};
    if constexpr (is_f32<TQK>) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        Tf32Split<2> b[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x[2];
          load_b_cols_paired<LD>(x, sk + 8 * kk * LD + 8 * (d + h));
          b[h] = split_tf32(x);
        }
        mma_3xtf32(tile, f.a[kk], b);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
        uint32_t b[4];
        load_b_bf16_cols<LD>(b, sk + 16 * kk * LD + 8 * d);
        mma_bf16(tile[0], f.a[kk], b[0], b[1]);
        mma_bf16(tile[1], f.a[kk], b[2], b[3]);
      }
    }
    add_tile(acc[d], tile[0]);
    add_tile(acc[d + 1], tile[1]);
  }
}

template <typename TQK, typename TV, int D>
__global__ void __launch_bounds__(Dq<TQK, TV, D>::NT, 1)
    flash_dq_kernel(const TQK* __restrict__ q, const TQK* __restrict__ k,
                    const TV* __restrict__ v, const TQK* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    TQK* __restrict__ dq, int n) {
  using C = Dq<TQK, TV, D>;
  constexpr int BQ = C::BQ, KT = C::KT, LDQ = C::LDQ, LDV = C::LDV, LDX = C::LDX;
  constexpr int NK = KT / 8;                // key fragments of a k/v tile
  constexpr int DW = C::SPLIT ? D / 2 : D;  // head columns of S, dP and dQ per warp
  constexpr int ND = DW / 8;                // dQ fragments per warp
  extern __shared__ __align__(16) unsigned char smem[];
  TQK* sq = reinterpret_cast<TQK*>(smem);
  TQK* sdo = sq + BQ * LDQ;
  TQK* sk = sdo + BQ * LDQ;                                // 2 stages of KT rows
  TV* sv = reinterpret_cast<TV*>(sk + 2 * KT * LDQ);       // 2 stages of KT rows
  float* sx = reinterpret_cast<float*>(sv + 2 * KT * LDV);  // SPLIT: S, dP of each half

  const int warp = threadIdx.x >> 5, g = lane_id() >> 2, t = lane_id() & 3;
  const int rg = warp % C::RG, half = warp / C::RG;  // half is 0 without SPLIT
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * n * D;
  const size_t rbase = (size_t)blockIdx.y * n;
  const int nk = (n + KT - 1) / KT;

  auto load_kv = [&](int j) {
    const int st = j & 1;
    copy_rows_async<TQK, KT, D, LDQ, C::NT>(sk + st * KT * LDQ, k + base, j * KT, n);
    copy_rows_async<TV, KT, D, LDV, C::NT>(sv + st * KT * LDV, v + base, j * KT, n);
  };
  copy_rows_async<TQK, BQ, D, LDQ, C::NT>(sq, q + base, q0, n);
  copy_rows_async<TQK, BQ, D, LDQ, C::NT>(sdo, dout + base, q0, n);
  load_kv(0);
  cp_async_commit();

  // lse and D of rows g and g + 8 of the row group (rows >= n are not stored)
  float rl[2], rd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * rg + g + 8 * r;
    rl[r] = row < n ? lse[rbase + row] : 0.f;
    rd[r] = row < n ? delta[rbase + row] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int j = 0; j < nk; ++j) {
    if (j + 1 < nk) load_kv(j + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and the q and dO tiles) landed
    __syncthreads();
    const int st = j & 1;
    const TQK* skj = sk + st * KT * LDQ + DW * half;  // this warp's head columns

    // element e of a fragment is row g + 8 (e >> 1), key 2t + (e & 1)
    float s[NK][4] = {}, dp[NK][4] = {};
    dq_scores<TQK, TV, D, DW, NK>(s, dp, sq + 16 * rg * LDQ + DW * half,
                                  sdo + 16 * rg * LDQ + DW * half, skj,
                                  sv + st * KT * LDV + DW * half);
    if constexpr (C::SPLIT) {  // add the other warp's sums over the other half
      float* own = sx + (2 * half * BQ + 16 * rg) * LDX;   // S, then dP BQ rows on
      float* other = sx + (2 * (half ^ 1) * BQ + 16 * rg) * LDX;
#pragma unroll
      for (int i = 0; i < NK; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int at = (g + 8 * r) * LDX + 8 * i + 2 * t;
          store_pair(own + at, s[i][2 * r], s[i][2 * r + 1]);
          store_pair(own + BQ * LDX + at, dp[i][2 * r], dp[i][2 * r + 1]);
        }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NK; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int at = (g + 8 * r) * LDX + 8 * i + 2 * t;
          const float2 ps = *reinterpret_cast<const float2*>(other + at);
          const float2 pp = *reinterpret_cast<const float2*>(other + BQ * LDX + at);
          s[i][2 * r] += ps.x;
          s[i][2 * r + 1] += ps.y;
          dp[i][2 * r] += pp.x;
          dp[i][2 * r + 1] += pp.y;
        }
    }
    // dS = P (dP - D) in place of S, P = exp(S - lse) and 0 for keys >= n
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = j * KT + 8 * i + 2 * t + (e & 1) < n ? expf(s[i][e] - rl[e >> 1]) : 0.f;
        s[i][e] = p * (dp[i][e] - rd[e >> 1]);
      }
    DsFrags<TQK, NK> f;
    f.from_c(s);
    dq_accumulate<TQK, D, ND, NK>(acc, f, skj);
    __syncthreads();  // stage st (and the exchange tiles) is free for tile j + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * rg + g + 8 * r;
    if (row < n) {
      TQK* out = dq + base + (size_t)row * D + DW * half + 2 * t;
#pragma unroll
      for (int d = 0; d < ND; ++d) store_pair(out + 8 * d, acc[d][2 * r], acc[d][2 * r + 1]);
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
  int* cfg;  // dq: when set, receives the CTA's shape instead of a launch
};

template <typename TQK, typename TV, int D>
int launch_dq(const Args& a) {
  using C = Dq<TQK, TV, D>;
  static_assert(C::SMEM <= SMEM_MAX, "shared-memory tiles exceed the block limit");
  if (a.cfg) {
    const int cfg[4] = {C::NW, C::BQ, C::KT, C::SMEM};
    for (int i = 0; i < 4; ++i) a.cfg[i] = cfg[i];
    return 0;
  }
  auto kern = flash_dq_kernel<TQK, TV, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + C::BQ - 1) / C::BQ, a.bh);
  kern<<<grid, C::NT, C::SMEM, a.stream>>>(
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

// The dq CTA of an instance, written to cfg: {warps, q rows, keys per k/v
// tile, shared-memory bytes}. Returns 0, or -1 for one the kernel does not
// take.
extern "C" int flash_bwd_dq_config(int d, int qk_type, int v_type, int* cfg) {
  Args a{};
  a.bh = a.n = 1;
  a.cfg = cfg;
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
