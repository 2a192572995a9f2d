// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel vaevar_tpu/ops/pallas_attn.py::_fwd_kernel (the
// flash-2 forward of the unmasked full-grid LG stage of the 0.25 deg forecast
// model: B*h = 6, N = 16200 tokens, head dim 192).
//
// What bounds it on this card: compute. One call at N = 16200, d = 192,
// B*h = 6 does 4*N^2*d*B*h ~ 1.2 TFLOP while it reads and writes ~0.1 GB, so
// it sits far above the H100's ~295 FLOP/byte ridge. What the design does
// about it: every (b*h, 64-row q tile) is one CTA that keeps its q tile, the
// running max / sum and an f32 accumulator on chip for the whole key loop, so
// device memory sees each q row once and each k/v row once per q tile; the
// N x N logits never leave the SM. This first version multiplies with scalar
// f32 FMAs (4x4 logits and 4 x d/16 outputs per thread, float4 shared-memory
// reads along the head dim); tensor-core MMA (mma.sync / wgmma) and TMA
// staging are later work.
//
// Semantics (those of _fwd_kernel and ops/flash.py::_forward):
//   q is pre-scaled by 1/sqrt(d); no mask except keys >= n;
//   m, l and the accumulator are f32; P is rounded to v's type before P.V;
//   O = acc / l in q's type; lse = m + log(l) in f32.
// Inputs (BH, n, d), contiguous. q and k share a type; v may be bf16 while
// q and k are f32 (the rope stage rotates q and k with f32 tables).
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // q rows per CTA
constexpr int BK = 64;   // k/v rows per tile of the key loop
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

// P is rounded to v's type before P.V, as both JAX versions do.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + PAD) + (size_t)BQ * (BK + PAD));
}

template <typename TQK, typename TV, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const TQK* __restrict__ q, const TQK* __restrict__ k,
                     const TV* __restrict__ v, TQK* __restrict__ o,
                     float* __restrict__ lse, int n) {
  constexpr int LD = D + PAD;   // row stride of the q, k and v tiles
  constexpr int LP = BK + PAD;  // row stride of the P tile
  constexpr int DC = D / 16;    // output columns per thread
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + BQ * LD;
  float* sv = sk + BK * LD;
  float* sp = sv + BK * LD;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key column / output column lane
  const int ty = tid / 16;  // row lane: this thread owns rows ty + 16 i
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * n * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, gr = q0 + r;
    sq[r * LD + c] = gr < n ? to_f32(q[base + (size_t)gr * D + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DC; ++d) acc[i][d] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, gr = k0 + r;
      const size_t off = base + (size_t)gr * D + c;
      const bool ok = gr < n;
      sk[r * LD + c] = ok ? to_f32(k[off]) : 0.f;
      sv[r * LD + c] = ok ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for rows ty + 16 i and key columns tx + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&sq[(ty + 16 * i) * LD + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(&sk[(tx + 16 * j) * LD + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, b[j].x, t);
          t = fmaf(a[i].y, b[j].y, t);
          t = fmaf(a[i].z, b[j].z, t);
          t = fmaf(a[i].w, b[j].w, t);
          s[i][j] = t;
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + tx + 16 * j >= n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;

    // Online softmax; a row's 64 columns live on the 16 lanes of one
    // half-warp, so the row max and sum reduce with xor-shuffles.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sp[(ty + 16 * i) * LP + tx + 16 * j] = round_to<TV>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off, 16);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DC; ++d) acc[i][d] *= corr;
    }
    __syncthreads();

    // acc += P V for rows ty + 16 i and head columns tx + 16 d.
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&sp[(ty + 16 * i) * LP + c]);
#pragma unroll
      for (int d = 0; d < DC; ++d) {
        const float v0 = sv[(c + 0) * LD + tx + 16 * d];
        const float v1 = sv[(c + 1) * LD + tx + 16 * d];
        const float v2 = sv[(c + 2) * LD + tx + 16 * d];
        const float v3 = sv[(c + 3) * LD + tx + 16 * d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t = acc[i][d];
          t = fmaf(pa[i].x, v0, t);
          t = fmaf(pa[i].y, v1, t);
          t = fmaf(pa[i].z, v2, t);
          t = fmaf(pa[i].w, v3, t);
          acc[i][d] = t;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < n) {
#pragma unroll
      for (int d = 0; d < DC; ++d)
        o[base + (size_t)r * D + tx + 16 * d] = from_f32<TQK>(acc[i][d] / l[i]);
      if (tx == 0) lse[(size_t)blockIdx.y * n + r] = m[i] + logf(l[i]);
    }
  }
}

template <typename TQK, typename TV, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int n, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<TQK, TV, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + BQ - 1) / BQ, bh);
  kern<<<grid, NT, smem, stream>>>(
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
