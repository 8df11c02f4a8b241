// Hand-written Hopper (sm_90a) kernels for the ordering layer's fused
// score + ranking: the port of the reference's Pallas kernels in
// src/repro/kernels/sched_score/sched_score.py.
//
// All three kernels share one score function,
//
//     score = ((w1 * (wait / c) - w2 * (c / ref)) + w3 * urg) - w_route * route
//     c     = max(cost, 1),    masked lanes score NEG = -1e30,
//
// evaluated one IEEE-rounded operation at a time with the __f*_rn
// intrinsics.  The library is built with -fmad=false (and never with
// --use_fast_math), so the kernel's float32 bits equal the plain PyTorch
// version's (kernels/sched_score/ref.py) on the CPU and on CUDA.
//
// Ranking uses one 64-bit key per element,
//     (orderable_u32(score) << 32) | (0xFFFFFFFF - idx),
// so an unsigned max picks the highest score and, among equal scores,
// the lowest index: lax.top_k's first-occurrence order, which the Pallas
// kernel reproduces with its strict `>` eviction.  -0.0 is folded into
// +0.0 before packing, so the two zeros tie as IEEE `>` treats them; the
// score returned is decoded from the key (hence +0.0 for either zero).
//
// Plain C interface, bound from Python with ctypes
// (kernels/sched_score/ops.py).  Every entry point launches on the
// caller's stream, allocates nothing (outputs and scratch come from the
// wrapper), does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr float NEG = -1e30f;
constexpr int TPB = 256;          // threads per block of the top-b passes
constexpr int EPT = 8;            // elements per thread
constexpr int TILE = TPB * EPT;   // 2048 elements per block
constexpr int CTPB = 1024;        // threads of the one compaction CTA
constexpr int CEPT = 4;           // slots per thread
constexpr int WMAX = CTPB * CEPT; // largest slot pool: 4096
constexpr int BMAX = 128;         // largest b, as in the reference

__device__ __forceinline__ float sched_score(float wait, float cost,
                                             float urg, float route,
                                             const float* w, bool has_route) {
  const float c = fmaxf(cost, 1.0f);
  float s = __fsub_rn(__fmul_rn(w[0], __fdiv_rn(wait, c)),
                      __fmul_rn(w[1], __fdiv_rn(c, w[3])));
  s = __fadd_rn(s, __fmul_rn(w[2], urg));
  if (has_route) s = __fsub_rn(s, __fmul_rn(w[4], route));
  return s;
}

__device__ __forceinline__ uint32_t orderable(float s) {
  uint32_t u = __float_as_uint(s);
  if ((u << 1) == 0u) u = 0u;  // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 make_key(float s, uint32_t idx) {
  return (static_cast<u64>(orderable(s)) << 32) |
         static_cast<u64>(0xFFFFFFFFu - idx);
}

__device__ __forceinline__ int key_index(u64 k) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(k));
}

__device__ __forceinline__ float key_score(u64 k) {
  const uint32_t o = static_cast<uint32_t>(k >> 32);
  const uint32_t u = (o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o;
  return __uint_as_float(u);
}

__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a > b ? a : b; }

// Block-wide max of one key per thread: warp shuffles, then one warp
// over the per-warp maxima in shared memory.  red[0..31] holds the
// per-warp values and red[32] the result, so back-to-back calls need
// only the two barriers inside.
template <int NT>
__device__ __forceinline__ u64 block_max(u64 v, u64* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = umax(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    u64 x = lane < NT / 32 ? red[lane] : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = umax(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  return red[32];
}

// b rounds of "block max, remove the winner" over the E keys each
// thread holds in registers.  Writes the winners' keys to keys_out, or,
// when keys_out is null (the last level), decodes them into idx/score.
template <int NT, int E>
__device__ __forceinline__ void select_rounds(u64 (&k)[E], int b, u64* red,
                                              u64* keys_out, int* out_idx,
                                              float* out_score) {
  for (int r = 0; r < b; ++r) {
    u64 m = 0ull;
#pragma unroll
    for (int e = 0; e < E; ++e) m = umax(m, k[e]);
    const u64 best = block_max<NT>(m, red);
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (k[e] == best) k[e] = 0ull;
    if (threadIdx.x == 0) {
      if (keys_out != nullptr) {
        keys_out[r] = best;
      } else {
        out_idx[r] = key_index(best);
        out_score[r] = key_score(best);
      }
    }
  }
}

// ---------------------------------------------------------------------
// sched_score_topb, first pass.
// Replaces: src/repro/kernels/sched_score/sched_score.py:_topb_kernel
//   (public sched_score_topb), and with b = 1 its _kernel
//   (sched_score_argmax).
// Bound on the card: bytes.  It reads 4-5 float32 rows and a bool mask
//   once (17-21 bytes a lane: ~70-86 KB at n = 4096, tens of ns at
//   3.35 TB/s), so at the slice's sizes launch latency dominates.
// Design: the TPU kernel carries a best-b set across its sequential
//   grid; Hopper blocks share nothing across the grid, so each block of
//   256 threads x 8 lanes (coalesced loads: lane e*256 + tid) keeps its
//   keys in registers, runs b rounds of a block max, and writes its
//   local top-b keys to an (nb, b) scratch.  A second pass merges them.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(TPB)
topb_features_kernel(const float* __restrict__ wait,
                     const float* __restrict__ cost,
                     const float* __restrict__ urg,
                     const float* __restrict__ route,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ weights, int n, int b,
                     int has_route, u64* keys_out, int* out_idx,
                     float* out_score) {
  __shared__ u64 red[33];
  __shared__ float w[5];
  if (threadIdx.x < 5)
    w[threadIdx.x] = threadIdx.x < (has_route ? 5 : 4) ? weights[threadIdx.x] : 0.0f;
  __syncthreads();
  const int base = blockIdx.x * TILE;
  u64 k[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = base + e * TPB + static_cast<int>(threadIdx.x);
    if (i < n) {
      const float s = mask[i] ? sched_score(wait[i], cost[i], urg[i],
                                            has_route ? route[i] : 0.0f, w,
                                            has_route != 0)
                              : NEG;
      k[e] = make_key(s, static_cast<uint32_t>(i));
    } else {
      k[e] = 0ull;  // past the ragged edge: ranks below every real lane
    }
  }
  select_rounds<TPB, EPT>(k, b, red,
                          gridDim.x == 1 ? nullptr : keys_out + blockIdx.x * b,
                          out_idx, out_score);
}

// ---------------------------------------------------------------------
// sched_score_topb, merge pass: the same block selection over keys.
// Bound on the card: bytes (nb * b keys of 8 bytes: 6 KB at n = 1e5,
//   b = 16) — a single block, launch latency dominates.
// Design: repeated until one block remains, so any n works with b <= 128.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(TPB)
topb_keys_kernel(const u64* __restrict__ keys_in, int m, int b, u64* keys_out,
                 int* out_idx, float* out_score) {
  __shared__ u64 red[33];
  const int base = blockIdx.x * TILE;
  u64 k[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = base + e * TPB + static_cast<int>(threadIdx.x);
    k[e] = i < m ? keys_in[i] : 0ull;
  }
  select_rounds<TPB, EPT>(k, b, red,
                          gridDim.x == 1 ? nullptr : keys_out + blockIdx.x * b,
                          out_idx, out_score);
}

// ---------------------------------------------------------------------
// sched_compact_topb.
// Replaces: src/repro/kernels/sched_score/sched_score.py:_compact_topb_kernel
//   (public sched_compact_topb).
// Bound on the card: bytes.  It reads the (W,) pool once (slot ids, the
//   alive mask and 3-4 float32 rows: ~70-86 KB at W = 4096) and writes
//   the compacted (W,) ids; launch latency dominates at this size.
// Design: W <= 4096, so one CTA of 1024 threads holds the whole pool,
//   4 consecutive slots a thread.  A block exclusive scan of `alive`
//   (warp shuffles, then one warp over the 32 warp totals) gives each
//   survivor its compacted position; the CTA writes the live prefix,
//   the -1 tail and n_live.  The same CTA keys the alive slots by slot
//   index — compaction is stable, so slot order is compacted order and
//   first-occurrence ties carry over — runs b rounds of the block max,
//   and the winner's owner writes its compacted position.  Ranks at or
//   past n_live become (rank, NEG), as lax.top_k over the sentinel tail
//   gives them.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(CTPB)
compact_topb_kernel(const int* __restrict__ slot_req,
                    const uint8_t* __restrict__ alive,
                    const float* __restrict__ wait,
                    const float* __restrict__ cost,
                    const float* __restrict__ urg,
                    const float* __restrict__ route,
                    const float* __restrict__ weights, int w_total, int b,
                    int has_route, int* out_req, int* out_n, int* out_idx,
                    float* out_score) {
  __shared__ u64 red[33];
  __shared__ int warp_excl[32];
  __shared__ int s_nlive;
  __shared__ float w[5];
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid < 5) w[tid] = tid < (has_route ? 5 : 4) ? weights[tid] : 0.0f;

  const int i0 = tid * CEPT;
  bool a[CEPT];
  int cnt = 0;
#pragma unroll
  for (int e = 0; e < CEPT; ++e) {
    const int i = i0 + e;
    a[e] = i < w_total && alive[i] != 0;
    cnt += a[e] ? 1 : 0;
  }
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) warp_excl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = warp_excl[lane];
    int vi = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, vi, o);
      if (lane >= o) vi += x;
    }
    warp_excl[lane] = vi - v;
    if (lane == 31) s_nlive = vi;
  }
  __syncthreads();
  const int n_live = s_nlive;

  int pos[CEPT];
  int p = warp_excl[warp] + incl - cnt;
#pragma unroll
  for (int e = 0; e < CEPT; ++e) {
    pos[e] = p;
    if (a[e]) {
      out_req[p] = slot_req[i0 + e];
      ++p;
    }
  }
#pragma unroll
  for (int e = 0; e < CEPT; ++e) {
    const int j = i0 + e;
    if (j < w_total && j >= n_live) out_req[j] = -1;
  }
  if (tid == 0) *out_n = n_live;

  u64 k[CEPT];
#pragma unroll
  for (int e = 0; e < CEPT; ++e) {
    const int i = i0 + e;
    k[e] = a[e] ? make_key(sched_score(wait[i], cost[i], urg[i],
                                       has_route ? route[i] : 0.0f, w,
                                       has_route != 0),
                           static_cast<uint32_t>(i))
                : 0ull;
  }
  for (int r = 0; r < b; ++r) {
    if (r >= n_live) {  // uniform across the block: n_live is shared
      if (tid == 0) {
        out_idx[r] = r;
        out_score[r] = NEG;
      }
      continue;
    }
    u64 m = 0ull;
#pragma unroll
    for (int e = 0; e < CEPT; ++e) m = umax(m, k[e]);
    const u64 best = block_max<CTPB>(m, red);
#pragma unroll
    for (int e = 0; e < CEPT; ++e) {
      if (k[e] == best) {
        k[e] = 0ull;
        out_idx[r] = pos[e];
        out_score[r] = key_score(best);
      }
    }
  }
}

int topb_launch(const float* wait, const float* cost, const float* urg,
                const float* route, const uint8_t* mask, const float* weights,
                int n, int b, u64* scratch_a, u64* scratch_b, int* out_idx,
                float* out_score, cudaStream_t stream) {
  if (n < 1 || b < 1 || b > BMAX || b > n) return static_cast<int>(cudaErrorInvalidValue);
  int nb = (n + TILE - 1) / TILE;
  topb_features_kernel<<<nb, TPB, 0, stream>>>(
      wait, cost, urg, route, mask, weights, n, b, route != nullptr ? 1 : 0,
      scratch_a, out_idx, out_score);
  int m = nb * b;
  u64* src = scratch_a;
  u64* dst = scratch_b;
  while (nb > 1) {
    nb = (m + TILE - 1) / TILE;
    topb_keys_kernel<<<nb, TPB, 0, stream>>>(src, m, b, dst, out_idx, out_score);
    m = nb * b;
    u64* t = src;
    src = dst;
    dst = t;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sched_score_topb(const float* wait, const float* cost, const float* urg,
                     const float* route, const uint8_t* mask,
                     const float* weights, int n, int b, u64* scratch_a,
                     u64* scratch_b, int* out_idx, float* out_score,
                     cudaStream_t stream) {
  return topb_launch(wait, cost, urg, route, mask, weights, n, b, scratch_a,
                     scratch_b, out_idx, out_score, stream);
}

int sched_score_argmax(const float* wait, const float* cost, const float* urg,
                       const float* route, const uint8_t* mask,
                       const float* weights, int n, u64* scratch_a,
                       u64* scratch_b, int* out_idx, float* out_score,
                       cudaStream_t stream) {
  return topb_launch(wait, cost, urg, route, mask, weights, n, 1, scratch_a,
                     scratch_b, out_idx, out_score, stream);
}

int sched_compact_topb(const int* slot_req, const uint8_t* alive,
                       const float* wait, const float* cost, const float* urg,
                       const float* route, const float* weights, int w_total,
                       int b, int* out_req, int* out_n, int* out_idx,
                       float* out_score, cudaStream_t stream) {
  if (w_total < 1 || w_total > WMAX || b < 1 || b > BMAX || b > w_total)
    return static_cast<int>(cudaErrorInvalidValue);
  compact_topb_kernel<<<1, CTPB, 0, stream>>>(
      slot_req, alive, wait, cost, urg, route, weights, w_total, b,
      route != nullptr ? 1 : 0, out_req, out_n, out_idx, out_score);
  return static_cast<int>(cudaGetLastError());
}

int sched_score_tile(void) { return TILE; }

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
