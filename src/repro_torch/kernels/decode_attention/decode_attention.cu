// Hand-written Hopper (sm_90a) flash-decode: the port of the reference's
// Pallas kernel `decode_attention`
// (src/repro/kernels/decode_attention/decode_attention.py).
//
// Computes, for one query token per sequence q (B, H, hd) against a
// cache k/v (B, S, KV, hd) in float32 or bfloat16 under a validity mask
// valid (S,) (bool bytes),
//
//   s[j]  = valid[j] ? (q . k_j) * scale : NEG_INF  (-1e30, finite),
//   out   = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30)
//
// with the online softmax in float32 and the output in q's dtype.  Query
// head h reads KV head h / (H / KV).  Any S is accepted.
//
// Design: split-KV flash-decoding in two launches.
//   1. decode_partial: one CTA of 128 threads per (split, head, batch)
//      walks its run of 128-key blocks.  Per block, groups of hd/8 lanes
//      take one key each (16 bytes of K a lane, coalesced) and reduce the
//      dot product with shuffles; then each thread owns one key of the
//      block for the block max, exp and sum (the online-softmax update,
//      as in the Pallas kernel with a 128-key block), and the P.V
//      product runs with threads on consecutive dims, so V is read
//      coalesced.  The split's (acc[hd], m, l) goes to a float32 scratch.
//   2. decode_combine: one CTA per (head, batch) merges the splits,
//      M = max m_s, out = sum acc_s e^(m_s - M) / max(sum l_s e^(m_s - M),
//      1e-30).
// The number of splits is chosen by the wrapper so that B * H * splits
// fills the card.
//
// Blocks with no valid key are skipped (their K/V are not read) when the
// row has a valid key anywhere; each CTA first ORs the whole mask.  That
// changes no result: such a block adds exp(-1e30 - m) = 0 after a valid
// key, and its exp(0) weights before the first valid key are wiped by
// that key's corr = 0.  A row with no valid key at all reads every block
// without skipping, which gives the mean of V over the S positions, as
// the reference's softmax over an all -1e30 row does.
//
// What bounds it on an H100: the bytes of K and V (2 * S * KV * hd
// elements a sequence) against 2 flops an element, so memory bandwidth;
// the split keeps 2 * 132 CTAs or more streaming at B * H = 32.
//
// Plain C interface, bound from Python with ctypes
// (kernels/decode_attention/ops.py): launches on the caller's stream,
// allocates nothing (the split scratch comes from the wrapper), does not
// synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 128;   // threads of a CTA
constexpr int NW = NT / 32;
constexpr int DBK = 128;  // keys per block: one per thread in the softmax

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

// 8 consecutive elements (16-byte aligned) as float32
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bfloat16 is the high half of a float32
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) r += red[w];
  __syncthreads();
  return r;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const uint8_t* __restrict__ valid,
               float* __restrict__ part, int S, int H, int KV,
               int n_split, int blocks_per_split, float scale) {
  constexpr int LPK = HD / 8;         // lanes per key in the dot product
  constexpr int KPW = 32 / LPK;       // keys per warp pass
  constexpr int DGRP = HD < NT ? HD : NT;
  constexpr int NPART = NT / DGRP;    // key partitions of the P.V step
  constexpr int DPT = HD / DGRP;      // output dims per thread
  constexpr int KPP = DBK / NPART;    // keys per partition
  __shared__ __align__(16) float q_s[HD];
  __shared__ float p_s[DBK];
  __shared__ float red[NW];
  __shared__ float acc_s[NPART][HD];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long rs = static_cast<long>(KV) * HD;  // row stride of k / v
  const T* kb = k + static_cast<long>(b) * S * rs + static_cast<long>(kvh) * HD;
  const T* vb = v + static_cast<long>(b) * S * rs + static_cast<long>(kvh) * HD;

  for (int d = tid; d < HD; d += NT)
    q_s[d] = to_f32<T>(q[(static_cast<long>(b) * H + h) * HD + d]);

  int any = 0;
  for (int j = tid; j < S; j += NT) any |= valid[j];
  const bool row_valid = __syncthreads_or(any) != 0;

  const int n_blk = (S + DBK - 1) / DBK;
  const int blk0 = split * blocks_per_split;
  const int blk1 = min(blk0 + blocks_per_split, n_blk);
  const int sub = lane % LPK, kk = lane / LPK;
  const int part_id = tid / DGRP, d0 = tid % DGRP;
  float q_r[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) q_r[e] = q_s[sub * 8 + e];

  float m = NEG_INF, l = 0.0f, acc[DPT];
#pragma unroll
  for (int e = 0; e < DPT; ++e) acc[e] = 0.0f;

  for (int blk = blk0; blk < blk1; ++blk) {
    const int j0 = blk * DBK;
    const int jt = j0 + tid;
    const bool in = jt < S;
    const bool ok = in && valid[jt] != 0;
    if (row_valid && !__syncthreads_or(ok)) continue;  // uniform branch

    // raw dot products, one key per group of LPK lanes
#pragma unroll
    for (int pass = 0; pass < LPK; ++pass) {
      const int jl = warp * 32 + pass * KPW + kk;
      const int j = j0 + jl;
      float dot = 0.0f;
      if (j < S) {
        float x[8];
        load8(kb + j * rs + sub * 8, x);
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(q_r[e], x[e], dot);
      }
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (sub == 0) p_s[jl] = dot;
    }
    __syncthreads();

    const float s = ok ? p_s[tid] * scale : NEG_INF;
    const float m_new = fmaxf(m, block_max(s, red));
    const float corr = expf(m - m_new);
    const float p = in ? expf(s - m_new) : 0.0f;
    p_s[tid] = p;
    l = l * corr + block_sum(p, red);  // its barriers publish p_s
    m = m_new;

#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[e] *= corr;
    const int jb = part_id * KPP;
    const int je = min(jb + KPP, S - j0);
#pragma unroll 4
    for (int jl = jb; jl < je; ++jl) {
      const float pj = p_s[jl];
      const T* vr = vb + (j0 + jl) * rs;
#pragma unroll
      for (int e = 0; e < DPT; ++e)
        acc[e] = fmaf(pj, to_f32<T>(vr[d0 + e * DGRP]), acc[e]);
    }
    __syncthreads();  // p_s is rewritten by the next block
  }

#pragma unroll
  for (int e = 0; e < DPT; ++e) acc_s[part_id][d0 + e * DGRP] = acc[e];
  __syncthreads();
  float* out = part + ((static_cast<long>(b) * H + h) * n_split + split) *
                          (HD + 2);
  for (int d = tid; d < HD; d += NT) {
    float a = 0.0f;
#pragma unroll
    for (int pi = 0; pi < NPART; ++pi) a += acc_s[pi][d];
    out[d] = a;
  }
  if (tid == 0) {
    out[HD] = m;
    out[HD + 1] = l;
  }
}

template <typename T, int HD>
__global__ void decode_combine(const float* __restrict__ part,
                               T* __restrict__ o, int H, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y;
  const float* pp = part + (static_cast<long>(b) * H + h) * n_split * (HD + 2);
  float M = NEG_INF;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, pp[s * (HD + 2) + HD]);
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float L = 0.0f, A = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      const float f = expf(pp[s * (HD + 2) + HD] - M);
      L = fmaf(pp[s * (HD + 2) + HD + 1], f, L);
      A = fmaf(pp[s * (HD + 2) + d], f, A);
    }
    o[(static_cast<long>(b) * H + h) * HD + d] = from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid,
           float* part, void* o, int B, int S, int H, int KV, int n_split,
           int blocks_per_split, float scale, cudaStream_t stream) {
  decode_partial<T, HD><<<dim3(n_split, H, B), NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, part, S, H, KV, n_split,
      blocks_per_split, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_combine<T, HD><<<dim3(H, B), HD, 0, stream>>>(
      part, static_cast<T*>(o), H, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v,
                const uint8_t* valid, float* part, void* o, int B, int S,
                int H, int KV, int hd, int n_split, int blocks_per_split,
                float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, valid, part, o, B, S, H, KV, n_split,
                           blocks_per_split, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, valid, part, o, B, S, H, KV, n_split,
                           blocks_per_split, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, valid, part, o, B, S, H, KV, n_split,
                            blocks_per_split, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  part: B * H * n_split * (hd + 2)
// float32 scratch.  The splits must cover every block exactly:
// n_split = ceil(ceil(S / 128) / blocks_per_split).
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const uint8_t* valid, float* part, void* o, int B,
                         int S, int H, int KV, int hd, int n_split,
                         int blocks_per_split, float scale, int dtype,
                         cudaStream_t stream) {
  const int n_blk = (S + DBK - 1) / DBK;
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || blocks_per_split < 1 ||
      n_split != (n_blk + blocks_per_split - 1) / blocks_per_split ||
      H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, valid, part, o, B, S, H, KV, hd,
                              n_split, blocks_per_split, scale, stream);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, valid, part, o, B, S, H, KV,
                                      hd, n_split, blocks_per_split, scale,
                                      stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int decode_attention_block(void) { return DBK; }

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
