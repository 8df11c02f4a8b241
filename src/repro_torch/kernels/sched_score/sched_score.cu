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
// The index makes every key unique, so any exact selection of the b
// largest keys returns the same bits, whatever order it compares in.
//
// Plain C interface, bound from Python with ctypes
// (kernels/sched_score/ops.py).  Every entry point launches on the
// caller's stream, allocates nothing (outputs and workspace come from
// the wrapper), does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr float NEG = -1e30f;
constexpr int NT = 1024;          // threads of a top-b / argmax CTA
constexpr int E = 4;              // lanes per thread
constexpr int TILE = NT * E;      // 4096 lanes per CTA
constexpr int WARPS = NT / 32;
constexpr int WLIST = 32 * E;     // keys a warp sorts: 128
constexpr int CAP = 128;          // candidates one warp sorts
constexpr int CTPB = 1024;        // threads of the one compaction CTA
constexpr int CEPT = 4;           // slots per thread
constexpr int WMAX = CTPB * CEPT; // largest slot pool: 4096
constexpr int BMAX = 128;         // largest b, as in the reference
static_assert(WLIST == BMAX, "a warp's sorted keys hold a whole list");

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
__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }

// Block-wide max of one key per thread: warp shuffles, then one warp
// over the per-warp maxima in shared memory.  red[0..31] holds the
// per-warp values and red[32] the result, so back-to-back calls need
// only the two barriers inside.
template <int NTH>
__device__ __forceinline__ u64 block_max(u64 v, u64* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = umax(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    u64 x = lane < NTH / 32 ? red[lane] : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = umax(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  return red[32];
}

// The keys of this thread's E lanes of the CTA's tile: lane
// blockIdx.x * TILE + e * NT + threadIdx.x (coalesced), 0 past n (0
// ranks below every real key).  Each thread reads the weights itself, so
// no barrier stands before the first score.  A thread whose E lanes all
// lie inside the queue starts all its loads before its first score; at
// the queue's ragged edge each lane branches, so lanes past n cost
// neither loads nor divisions (the paper cell's 256 lanes leave 15/16
// of the CTA idle).
__device__ __forceinline__ void load_keys(u64 (&k)[E],
                                          const float* __restrict__ wait,
                                          const float* __restrict__ cost,
                                          const float* __restrict__ urg,
                                          const float* __restrict__ route,
                                          const uint8_t* __restrict__ mask,
                                          const float* __restrict__ weights,
                                          int n, int has_route) {
  float w[5];
#pragma unroll
  for (int j = 0; j < 5; ++j)
    w[j] = j < (has_route ? 5 : 4) ? __ldg(weights + j) : 0.0f;
  const int i0 = blockIdx.x * TILE + static_cast<int>(threadIdx.x);
  const auto key = [&](int i, float a, float c, float u, float r,
                       uint8_t m) {
    const float s = sched_score(a, c, u, r, w, has_route != 0);
    return make_key(m ? s : NEG, static_cast<uint32_t>(i));
  };
  if (i0 + (E - 1) * NT < n) {
    float a[E], c[E], u[E], r[E];
    uint8_t m[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = i0 + e * NT;
      a[e] = __ldg(wait + i);
      c[e] = __ldg(cost + i);
      u[e] = __ldg(urg + i);
      r[e] = has_route ? __ldg(route + i) : 0.0f;
      m[e] = __ldg(mask + i);
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      k[e] = key(i0 + e * NT, a[e], c[e], u[e], r[e], m[e]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = i0 + e * NT;
      k[e] = i < n ? key(i, __ldg(wait + i), __ldg(cost + i), __ldg(urg + i),
                         has_route ? __ldg(route + i) : 0.0f, __ldg(mask + i))
                   : 0ull;
    }
  }
}

// A warp's keys in sort order: position p = lane * E + e.
__device__ __forceinline__ int wpos(int e) {
  return static_cast<int>(threadIdx.x & 31) * E + e;
}

// One compare-exchange stage of a bitonic network over the warp's
// positions: p and p ^ S swap so that the pair runs descending where
// (p & SIZE) == 0 and ascending elsewhere.  Strides of E or more pair
// lanes (shuffles), smaller ones pair a thread's own registers.
template <int SIZE, int S>
__device__ __forceinline__ void bitonic_stage(u64 (&k)[E]) {
  if constexpr (S >= E) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const u64 o = __shfl_xor_sync(0xffffffffu, k[e], S / E);
      const int p = wpos(e);
      const bool keep_max = ((p & SIZE) == 0) == ((p & S) == 0);
      k[e] = keep_max ? umax(k[e], o) : umin(k[e], o);
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((e & S) == 0) {
        const int f = e | S;
        const bool desc = (wpos(e) & SIZE) == 0;
        const u64 a = k[e], c = k[f];
        const bool sw = (a < c) == desc;
        k[e] = sw ? c : a;
        k[f] = sw ? a : c;
      }
    }
  }
}

// Strides S, S/2, ..., 1 of a bitonic network's SIZE step.
template <int SIZE, int S>
__device__ __forceinline__ void bitonic_steps(u64 (&k)[E]) {
  bitonic_stage<SIZE, S>(k);
  if constexpr (S > 1) bitonic_steps<SIZE, S / 2>(k);
}

// The warp's 128 keys sorted best first (a full bitonic sort in
// registers: 28 stages, 15 of them over shuffles, no barrier).
template <int SIZE = 2>
__device__ __forceinline__ void warp_sort(u64 (&k)[E]) {
  bitonic_steps<SIZE, SIZE / 2>(k);
  if constexpr (SIZE < WLIST) warp_sort<SIZE * 2>(k);
}

// Merge two lists of L keys, each best first, into the best L of both,
// best first: the warp holds list A at positions p < L; B is read
// reversed from shared memory, so max(A[p], B[L-1-p]) is a bitonic
// sequence holding the L largest keys of A and B, and log2(L)
// half-cleaner stages sort it.
template <int L>
__device__ __forceinline__ void merge_list(u64 (&k)[E], const u64* other) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = wpos(e);
    if (p < L) k[e] = umax(k[e], other[L - 1 - p]);
  }
  if constexpr (L > 1) bitonic_steps<2 * WLIST, L / 2>(k);
}

// The CTA's best L keys from each warp's sorted list (best first at
// positions p < L): a tree of pairwise merges over `lists` (WARPS * L
// keys of shared memory), log2(WARPS) levels of one barrier each.  The
// result is left in warp 0's registers.  The caller puts a barrier
// between two calls.
template <int L>
__device__ __forceinline__ void cta_merge(u64 (&k)[E], u64* lists) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (wpos(e) < L) lists[warp * L + wpos(e)] = k[e];
#pragma unroll
  for (int h = 1; h < WARPS; h <<= 1) {
    __syncthreads();
    if ((warp & (2 * h - 1)) == 0) {
      merge_list<L>(k, lists + (warp + h) * L);
      if ((warp & (4 * h - 1)) == 2 * h) {  // read at the next level
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (wpos(e) < L) lists[warp * L + wpos(e)] = k[e];
      }
    }
  }
}

// 32 keys, one a lane, sorted best first from lane 0 (15 stages).
__device__ __forceinline__ u64 warp_sort32(u64 v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int s = size >> 1; s > 0; s >>= 1) {
      const u64 o = __shfl_xor_sync(0xffffffffu, v, s);
      const bool keep_max = ((lane & size) == 0) == ((lane & s) == 0);
      v = keep_max ? umax(v, o) : umin(v, o);
    }
  }
  return v;
}

template <int L>
struct TopSmem {
  u64 lists[WARPS * L];  // cta_merge's tree
  u64 cand[CAP];         // the keys at or above the threshold
  u64 wmax[WARPS];       // each warp's best key
  u64 carry[L];          // the last CTA's running best between rounds
  u64 t0, t;
  unsigned int count;
};

// The best L of the CTA's keys (E a thread, 0 for none), best first at
// positions p < L of warp 0's registers.  For L <= 32 an exact filter
// first: the L-th best of the 32 warps' best keys, t1, and the L-th best
// of warp 0's 32 threads' best keys, t0, each leave at least L keys at
// or above them, so the best L all lie at or above t = max(t0, t1).
// Those keys are gathered in shared memory, and when there are at most
// CAP (on random scores ~L + 10; with the masked lanes' equal NEG scores
// t0 leaves exactly the L lowest indices) warp 0 sorts them: 3 barriers
// and three 32-key sorts on the critical path instead of a 128-key sort
// in every warp and 5 merge levels.  Otherwise (L > 32, or more than
// CAP keys pass) every warp sorts its keys and cta_merge merges them.
template <int L>
__device__ __forceinline__ void cta_top(u64 (&k)[E], TopSmem<L>& sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if constexpr (L <= 32) {
    u64 m = umax(umax(k[0], k[1]), umax(k[2], k[3]));
    if (warp == 0) {
      const u64 t0 = __shfl_sync(0xffffffffu, warp_sort32(m), L - 1);
      if (lane == 0) sm.t0 = t0;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = umax(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) sm.wmax[warp] = m;
    __syncthreads();
    if (warp == 0) {
      const u64 t1 = __shfl_sync(0xffffffffu, warp_sort32(sm.wmax[lane]), L - 1);
      if (lane == 0) {
        sm.t = umax(sm.t0, t1);
        sm.count = 0u;
      }
    }
    __syncthreads();
    const u64 t = sm.t;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (k[e] >= t && k[e] != 0ull) {
        const unsigned int slot = atomicAdd(&sm.count, 1u);
        if (slot < CAP) sm.cand[slot] = k[e];
      }
    }
    __syncthreads();
    const unsigned int count = sm.count;
    if (count <= CAP) {
      if (warp == 0) {
        if (count <= 32) {
          const u64 v = warp_sort32(lane < static_cast<int>(count) ? sm.cand[lane] : 0ull);
#pragma unroll
          for (int e = 0; e < E; ++e) k[e] = __shfl_sync(0xffffffffu, v, wpos(e) & 31);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e)
            k[e] = wpos(e) < static_cast<int>(count) ? sm.cand[wpos(e)] : 0ull;
          warp_sort(k);
        }
      }
      return;
    }
  }
  warp_sort(k);
  cta_merge<L>(k, sm.lists);
}

// After the CTA's result has been written to the workspace and fenced
// by its writers: counts this CTA in and tells every thread whether it
// was the last of the grid to arrive.
__device__ __forceinline__ bool last_to_arrive(unsigned int* done) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last != 0;
}

// ---------------------------------------------------------------------
// sched_score_argmax, and sched_score_topb at b = 1.
// Replaces: src/repro/kernels/sched_score/sched_score.py:_kernel (public
//   sched_score_argmax).
// Bound on the card: bytes.  It reads 4-5 float32 rows and a bool mask
//   once (17-21 bytes a lane: ~70-86 KB at n = 4096, tens of ns at
//   3.35 TB/s), so at the port's sizes launch latency dominates.
// Design: one launch at every n.  The TPU kernel carries its best key
//   across a sequential grid; here each CTA of 1024 threads x 4 lanes
//   scores its 4096-lane tile and takes a block max, and up to 4096
//   lanes (the scale window) that is the answer.  Past one tile each
//   CTA writes its key to ws[blockIdx.x] and counts itself in on
//   `done`; the last CTA to arrive reduces the nb keys, writes the
//   answer and sets `done` back to 0 for the next call (or a graph
//   replay).
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
argmax_kernel(const float* __restrict__ wait, const float* __restrict__ cost,
              const float* __restrict__ urg, const float* __restrict__ route,
              const uint8_t* __restrict__ mask,
              const float* __restrict__ weights, int n, int has_route,
              u64* ws, unsigned int* done, int* out_idx, float* out_score) {
  __shared__ u64 red[33];
  u64 k[E];
  load_keys(k, wait, cost, urg, route, mask, weights, n, has_route);
  u64 m = k[0];
#pragma unroll
  for (int e = 1; e < E; ++e) m = umax(m, k[e]);
  u64 best = block_max<NT>(m, red);
  if (gridDim.x > 1) {
    if (threadIdx.x == 0) {
      ws[blockIdx.x] = best;
      __threadfence();
    }
    if (!last_to_arrive(done)) return;
    m = 0ull;
    for (int j = threadIdx.x; j < static_cast<int>(gridDim.x); j += NT)
      m = umax(m, __ldcg(ws + j));
    best = block_max<NT>(m, red);
    if (threadIdx.x == 0) *done = 0u;
  }
  if (threadIdx.x == 0) {
    out_idx[0] = key_index(best);
    out_score[0] = key_score(best);
  }
}

// ---------------------------------------------------------------------
// sched_score_topb, 2 <= b <= 128.
// Replaces: src/repro/kernels/sched_score/sched_score.py:_topb_kernel
//   (public sched_score_topb).
// Bound on the card: bytes, as argmax_kernel (plus b outputs).
// Design: one launch at every n, no round per pick.  The TPU kernel
//   takes b successive argmaxes a block and merges them into a running
//   set across its sequential grid; here a CTA of 1024 threads x 4
//   lanes keys its 4096-lane tile and cta_top leaves its best L (b
//   rounded up to a power of two) in warp 0, which up to 4096 lanes is
//   the answer.  Past one tile each CTA writes its list to
//   ws[blockIdx.x * L ...] and counts itself in on `done`; the last CTA
//   to arrive loads the nb lists position-major (slot s holds position
//   s / m of list s % m, so the lists' heads come first) up to TILE
//   keys a round, its running best as one more list after the first,
//   and runs cta_top on them; then it writes the answer and sets `done`
//   back to 0 for the next call (or a graph replay).
// ---------------------------------------------------------------------
template <int L>
__global__ void __launch_bounds__(NT)
topb_kernel(const float* __restrict__ wait, const float* __restrict__ cost,
            const float* __restrict__ urg, const float* __restrict__ route,
            const uint8_t* __restrict__ mask,
            const float* __restrict__ weights, int n, int b, int has_route,
            u64* ws, unsigned int* done, int* out_idx, float* out_score) {
  __shared__ TopSmem<L> sm;
  const int warp = threadIdx.x >> 5;
  u64 k[E];
  load_keys(k, wait, cost, urg, route, mask, weights, n, has_route);
  cta_top<L>(k, sm);
  if (gridDim.x > 1) {
    if (warp == 0) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (wpos(e) < L) ws[blockIdx.x * L + wpos(e)] = k[e];
      __threadfence();
    }
    if (!last_to_arrive(done)) return;
    const int nb = static_cast<int>(gridDim.x);
    for (int next = 0; next < nb;) {
      const int carry = next > 0 ? 1 : 0;  // the running best, list 0
      const int m = min(nb - next, TILE / L - carry) + carry;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int slot = e * NT + static_cast<int>(threadIdx.x);
        const int q = slot % m, p = slot / m;
        k[e] = p >= L ? 0ull
               : q < carry ? sm.carry[p]
                           : __ldcg(ws + (next + q - carry) * L + p);
      }
      next += m - carry;
      cta_top<L>(k, sm);
      if (next < nb) {
        if (warp == 0) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            if (wpos(e) < L) sm.carry[wpos(e)] = k[e];
        }
        __syncthreads();
      }
    }
    if (threadIdx.x == 0) *done = 0u;
  }
  if (warp == 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int p = wpos(e);
      if (p < b) {
        out_idx[p] = key_index(k[e]);
        out_score[p] = key_score(k[e]);
      }
    }
  }
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
                int n, int b, u64* ws, unsigned int* done, int* out_idx,
                float* out_score, cudaStream_t stream) {
  if (n < 1 || b < 1 || b > BMAX || b > n) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (n + TILE - 1) / TILE;
  const int hr = route != nullptr ? 1 : 0;
  if (b == 1) {
    argmax_kernel<<<nb, NT, 0, stream>>>(wait, cost, urg, route, mask,
                                         weights, n, hr, ws, done, out_idx,
                                         out_score);
  } else {
    // lists of L = b rounded up to a power of two keys
    const auto kernel = b <= 2    ? topb_kernel<2>
                        : b <= 4  ? topb_kernel<4>
                        : b <= 8  ? topb_kernel<8>
                        : b <= 16 ? topb_kernel<16>
                        : b <= 32 ? topb_kernel<32>
                        : b <= 64 ? topb_kernel<64>
                                  : topb_kernel<128>;
    kernel<<<nb, NT, 0, stream>>>(wait, cost, urg, route, mask, weights, n,
                                  b, hr, ws, done, out_idx, out_score);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ws: ceil(n / 4096) * 128 keys of scratch; done: one unsigned counter,
// 0 before the call and left 0 after it.  One (ws, done) pair serves one
// stream at a time.
int sched_score_topb(const float* wait, const float* cost, const float* urg,
                     const float* route, const uint8_t* mask,
                     const float* weights, int n, int b, u64* ws,
                     unsigned int* done, int* out_idx, float* out_score,
                     cudaStream_t stream) {
  return topb_launch(wait, cost, urg, route, mask, weights, n, b, ws, done,
                     out_idx, out_score, stream);
}

int sched_score_argmax(const float* wait, const float* cost, const float* urg,
                       const float* route, const uint8_t* mask,
                       const float* weights, int n, u64* ws,
                       unsigned int* done, int* out_idx, float* out_score,
                       cudaStream_t stream) {
  return topb_launch(wait, cost, urg, route, mask, weights, n, 1, ws, done,
                     out_idx, out_score, stream);
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
