// Hand-written Hopper (sm_90a) flash attention for prefill: the port of
// the reference's Pallas kernel `flash_attention`
// (src/repro/kernels/flash_attention/flash_attention.py).
//
// Computes, for q (B, Sq, H, hd) and k/v (B, Skv, KV, hd) in float32 or
// bfloat16, causal attention with an optional sliding window,
//
//   s[i, j] = (q_i . k_j) * scale,  scale = 1/sqrt(hd),
//   valid   = j <= i  and  (window <= 0 or j > i - window)  and  j < Skv,
//   s       = valid ? s : NEG_INF  (-1e30, finite),
//   out_i   = sum_j exp(s_ij - m_i) v_j / max(sum_j exp(s_ij - m_i), 1e-30)
//
// with the running max m and denominator l of the online softmax in
// float32, and the output written in q's dtype.  Query head h reads KV
// head h / (H / KV), as the reference's index_map has it.
//
// Design.  One CTA of 128 threads per (64-query tile, head, batch).  The
// CTA keeps its Q tile in shared memory and streams 64-key K/V tiles
// through shared memory in key order.  Each thread owns 4 query rows and
// 8 key columns of the 64 x 64 score tile (columns tx, tx+8, ..., so a
// quarter-warp reads 8 consecutive padded K rows without bank conflicts),
// and the same 4 rows times hd/8 output dims of the accumulator, so the
// row statistics m and l stay in registers; the 8 threads sharing a row
// are 8 consecutive lanes and reduce with shuffles.  The probabilities
// pass through shared memory to the P.V product.  All arithmetic is
// float32 on the CUDA cores (the inputs are converted as they are
// loaded), so bfloat16 and float32 inputs give the float32 semantics of
// the Pallas kernel; the inner products use explicit fmaf.
//
// Tiles wholly above the diagonal, or wholly before every row's window,
// are skipped.  This changes no result: a skipped tile would add
// exp(-1e30 - m) = 0 to a row that has seen a valid key, and a row whose
// first tiles are fully masked accumulates exp(0) weights that the first
// valid tile's corr = exp(-1e30 - m) = 0 wipes exactly.  Ragged Sq and
// Skv are masked in the kernel (rows past Sq are not stored, keys past
// Skv load as zeros and are masked), so prompts need no padding.  The
// wrapper requires Sq <= Skv, so every stored row has a valid key.
//
// What bounds it on an H100: at the serving path's shapes (hd = 64,
// Sq = Skv up to 2048) the causal work is 4 * hd * H * Sq^2 / 2 flops
// against a few MB of traffic, so the bound is the tensor cores' bf16
// rate; this kernel runs on the float32 CUDA cores instead, so it is
// compute-bound well above that bound.  A wgmma/TMA version is later
// work (ROADMAP queue A7).
//
// Plain C interface, bound from Python with ctypes
// (kernels/flash_attention/ops.py): launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;      // query rows per CTA
constexpr int BK = 64;      // keys per tile
constexpr int NT = 128;     // threads: a 16 (row groups) x 8 (columns) grid
constexpr int TR = 4;       // query rows per thread
constexpr int TC = 8;       // key columns per thread: tx + 8 * c
constexpr int LDP = BK + 4; // padded row of the probability tile

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 4) + 2 * BK * (HD + 4) + BQ * LDP;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
          int H, int KV, int window, float scale) {
  constexpr int LD = HD + 4;   // padded row of the Q/K/V tiles
  constexpr int DC = HD / 32;  // float4 groups of output dims per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // row group: rows ty*4 .. ty*4+3
  const int tx = tid & 7;   // key columns tx + 8c; dims tx*4 + 32g + e
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long qs = static_cast<long>(H) * HD;    // row stride of q / o
  const long kvs = static_cast<long>(KV) * HD;  // row stride of k / v
  const T* qb = q + static_cast<long>(b) * Sq * qs + static_cast<long>(h) * HD;
  const T* kb = k + static_cast<long>(b) * Skv * kvs + static_cast<long>(kvh) * HD;
  const T* vb = v + static_cast<long>(b) * Skv * kvs + static_cast<long>(kvh) * HD;
  T* ob = o + static_cast<long>(b) * Sq * qs + static_cast<long>(h) * HD;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, qr = q0 + r;
    Qs[r * LD + d] = qr < Sq ? to_f32<T>(qb[qr * qs + d]) : 0.0f;
  }

  float m[TR], l[TR], acc[TR][DC * 4];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC * 4; ++c) acc[i][c] = 0.0f;
  }

  // tiles that hold a valid key for some row of this query tile
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kt_end = q_last / BK;
  int kt_begin = 0;
  if (window > 0) {
    const int k_first = q0 - window + 1;
    kt_begin = k_first > 0 ? k_first / BK : 0;
  }

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, kr = k0 + r;
      const bool in = kr < Skv;
      Ks[r * LD + d] = in ? to_f32<T>(kb[kr * kvs + d]) : 0.0f;
      Vs[r * LD + d] = in ? to_f32<T>(vb[kr * kvs + d]) : 0.0f;
    }
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < TC; ++c) s[i][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[TR], kv[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * TR + i) * LD + d]);
#pragma unroll
      for (int c = 0; c < TC; ++c)
        kv[c] = *reinterpret_cast<const float4*>(&Ks[(tx + 8 * c) * LD + d]);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          float a = s[i][c];
          a = fmaf(qv[i].x, kv[c].x, a);
          a = fmaf(qv[i].y, kv[c].y, a);
          a = fmaf(qv[i].z, kv[c].z, a);
          a = fmaf(qv[i].w, kv[c].w, a);
          s[i][c] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qpos = q0 + ty * TR + i;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int kpos = k0 + tx + 8 * c;
        const bool ok = kpos <= qpos && kpos < Skv &&
                        (window <= 0 || kpos > qpos - window);
        s[i][c] = ok ? s[i][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float p = expf(s[i][c] - m_new);
        Ps[(ty * TR + i) * LDP + tx + 8 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC * 4; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty * TR + i) * LDP + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int g = 0; g < DC; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(j + jj) * LD + tx * 4 + 32 * g]);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                          : jj == 2 ? pv[i].z : pv[i].w;
            acc[i][g * 4 + 0] = fmaf(p, vv.x, acc[i][g * 4 + 0]);
            acc[i][g * 4 + 1] = fmaf(p, vv.y, acc[i][g * 4 + 1]);
            acc[i][g * 4 + 2] = fmaf(p, vv.z, acc[i][g * 4 + 2]);
            acc[i][g * 4 + 3] = fmaf(p, vv.w, acc[i][g * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qr = q0 + ty * TR + i;
    if (qr >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < DC; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ob[qr * qs + tx * 4 + 32 * g + e] =
            from_f32<T>(acc[i][g * 4 + e] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * smem_floats<HD>();
  // above 48 KB only after opting in (per device, so on every launch)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<T, HD><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KV, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Skv, int H, int KV, int hd, int window,
                float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, KV, window, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, KV, window, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, KV, window, scale,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Shapes as in the header; every
// tensor contiguous.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Skv, int H, int KV, int hd,
                        int window, float scale, int dtype,
                        cudaStream_t stream) {
  if (B < 1 || Sq < 1 || Skv < Sq || KV < 1 || H % KV != 0 || window < 0 ||
      H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, B, Sq, Skv, H, KV, hd, window,
                              scale, stream);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, KV, hd,
                                      window, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
