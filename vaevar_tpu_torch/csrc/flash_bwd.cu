// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernels vaevar_tpu/ops/pallas_attn.py::_dq_kernel and
// ::_dkv_kernel (the flash-2 backward of the unmasked full-grid LG stage of
// the 0.25 deg forecast model: B*h = 6, N = 16200 tokens, head dim 192),
// which training the forecast model reaches once per flash block and step.
//
// What bounds them on this card: compute. At N = 16200, d = 192, B*h = 6 the
// dq kernel does 6*N^2*d*B*h ~ 1.8 TFLOP and the dkv kernel 8*N^2*d*B*h
// ~ 2.4 TFLOP, while together they read and write ~0.3 GB, far above the
// H100's ~295 FLOP/byte ridge. What the design does about it: as on the TPU,
// two kernels, so that each gradient is summed inside one CTA and written
// once, with no atomics (two launches give bitwise-equal gradients):
//   - dq: one CTA per (b*h, 64-row q tile) keeps q, dO, lse, D and an f32 dQ
//     accumulator on chip and loops over 64-row k/v tiles;
//   - dkv: one CTA per (b*h, 64-row k tile) keeps k, v and f32 dK, dV
//     accumulators on chip and loops over 32-row q/dO tiles (32 rows keep the
//     six tiles inside the 227 KB of shared memory at d = 192).
// The N x N probabilities are recomputed from the forward's lse and never
// leave the SM. This first version multiplies with scalar f32 FMAs (float4
// shared-memory reads along the head dim), like csrc/flash_fwd.cu;
// tensor-core MMA and TMA staging are later work.
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

namespace {

constexpr int BQ = 64;   // dq kernel: q rows per CTA
constexpr int BK = 64;   // k/v rows per tile (dq) and per CTA (dkv)
constexpr int BQ2 = 32;  // dkv kernel: q rows per tile of the q loop
constexpr int NT = 256;  // threads per CTA, a 16 x 16 grid (tx, ty)
constexpr int PAD = 4;   // row padding (floats): conflict-free float4 reads

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

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

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * ((size_t)(2 * BK + 2 * BQ2) * (D + PAD) +
                          (size_t)2 * BK * (BQ2 + PAD) + 2 * BQ2);
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

template <typename TQK, typename TV, int D>
__global__ void __launch_bounds__(NT)
    flash_dkv_kernel(const TQK* __restrict__ q, const TQK* __restrict__ k,
                     const TV* __restrict__ v, const TQK* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     TQK* __restrict__ dk, TV* __restrict__ dv, int n) {
  constexpr int LD = D + PAD;    // row stride of the k, v, q and dO tiles
  constexpr int LP = BQ2 + PAD;  // row stride of the P^T and dS^T tiles
  constexpr int DC = D / 16;     // dK / dV columns per thread
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + BK * LD;
  float* sq = sv + BK * LD;
  float* sdo = sq + BQ2 * LD;
  float* spt = sdo + BQ2 * LD;
  float* sdst = spt + BK * LP;
  float* slse = sdst + BK * LP;
  float* sdel = slse + BQ2;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // q column / head column lane
  const int ty = tid / 16;  // key-row lane: this thread owns rows ty + 16 i
  const int k0 = blockIdx.x * BK;
  const size_t base = (size_t)blockIdx.y * n * D;
  const size_t rbase = (size_t)blockIdx.y * n;

  load_tile<TQK, D>(sk, k + base, k0, BK, n);
  load_tile<TV, D>(sv, v + base, k0, BK, n);
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int d = 0; d < DC; ++d) dk_acc[i][d] = dv_acc[i][d] = 0.f;

  for (int q0 = 0; q0 < n; q0 += BQ2) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<TQK, D>(sq, q + base, q0, BQ2, n);
    load_tile<TQK, D>(sdo, dout + base, q0, BQ2, n);
    if (tid < BQ2) {
      const int r = q0 + tid;
      slse[tid] = r < n ? lse[rbase + r] : 0.f;
      sdel[tid] = r < n ? delta[rbase + r] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for key rows ty + 16 i, q columns tx + 16 j.
    float st[4][2], dpt[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      float4 b[2], g[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        b[j] = *reinterpret_cast<const float4*>(&sq[(tx + 16 * j) * LD + c]);
        g[j] = *reinterpret_cast<const float4*>(&sdo[(tx + 16 * j) * LD + c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(&sk[(ty + 16 * i) * LD + c]);
        const float4 w = *reinterpret_cast<const float4*>(&sv[(ty + 16 * i) * LD + c]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          st[i][j] = dot4(a, b[j], st[i][j]);
          dpt[i][j] = dot4(w, g[j], dpt[i][j]);
        }
      }
    }

    // P^T = exp(S^T - lse) with q rows >= n zeroed; dS^T = P^T (dP^T - D).
    // P^T is rounded to dO's type before P^T dO and dS^T to q's type before
    // dS^T Q, as _dkv_kernel does; dS^T uses the unrounded P^T.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = tx + 16 * j;
      const bool ok = q0 + col < n;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ok ? expf(st[i][j] - slse[col]) : 0.f;
        spt[(ty + 16 * i) * LP + col] = round_to<TQK>(p);
        sdst[(ty + 16 * i) * LP + col] = round_to<TQK>(p * (dpt[i][j] - sdel[col]));
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q for key rows ty + 16 i, head columns
    // tx + 16 d.
#pragma unroll 2
    for (int c = 0; c < BQ2; c += 4) {
      float4 pa[4], da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = *reinterpret_cast<const float4*>(&spt[(ty + 16 * i) * LP + c]);
        da[i] = *reinterpret_cast<const float4*>(&sdst[(ty + 16 * i) * LP + c]);
      }
#pragma unroll
      for (int d = 0; d < DC; ++d) {
        const int col = tx + 16 * d;
        const float4 oc = make_float4(sdo[(c + 0) * LD + col], sdo[(c + 1) * LD + col],
                                      sdo[(c + 2) * LD + col], sdo[(c + 3) * LD + col]);
        const float4 qc = make_float4(sq[(c + 0) * LD + col], sq[(c + 1) * LD + col],
                                      sq[(c + 2) * LD + col], sq[(c + 3) * LD + col]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][d] = dot4(pa[i], oc, dv_acc[i][d]);
          dk_acc[i][d] = dot4(da[i], qc, dk_acc[i][d]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r < n) {
#pragma unroll
      for (int d = 0; d < DC; ++d) {
        const size_t off = base + (size_t)r * D + tx + 16 * d;
        dk[off] = from_f32<TQK>(dk_acc[i][d]);
        dv[off] = from_f32<TV>(dv_acc[i][d]);
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
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
