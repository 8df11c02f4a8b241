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
// best first: the warp holds list A at positions p < L; B[q] is
// other(q), read reversed, so max(A[p], B[L-1-p]) is a bitonic sequence
// holding the L largest keys of A and B, and log2(L) half-cleaner
// stages sort it.
template <int L, typename F>
__device__ __forceinline__ void merge_with(u64 (&k)[E], F other) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = wpos(e);
    if (p < L) k[e] = umax(k[e], other(L - 1 - p));
  }
  if constexpr (L > 1) bitonic_steps<2 * WLIST, L / 2>(k);
}

template <int L>
__device__ __forceinline__ void merge_list(u64 (&k)[E], const u64* other) {
  merge_with<L>(k, [other](int q) { return other[q]; });
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

// The last CTA's merge of the nb CTAs' lists of L keys in ws (list c at
// ws[c * L ...], best first): it loads them position-major (slot s holds
// position s / m of list s % m, so the lists' heads come first) up to
// TILE keys a round, its running best as one more list after the first,
// and runs cta_top on them.  The best L are left in warp 0's registers.
template <int L>
__device__ __forceinline__ void merge_lists(u64 (&k)[E], TopSmem<L>& sm,
                                            const u64* ws, int nb) {
  const int warp = threadIdx.x >> 5;
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
//   to arrive merges the nb lists (merge_lists), writes the answer and
//   sets `done` back to 0 for the next call (or a graph replay).
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
    merge_lists<L>(k, sm, ws, static_cast<int>(gridDim.x));
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
// sched_compact_topb, 1 <= b <= 128, any pool width w >= 1.
// Replaces: src/repro/kernels/sched_score/sched_score.py:_compact_topb_kernel
//   (public sched_compact_topb).
// Bound on the card: bytes.  It reads the (w,) pool once (slot ids, the
//   alive mask and 3-4 float32 rows: 17-21 bytes a slot) and writes the
//   compacted (w,) ids; at the scale window's w = 4096 launch latency
//   dominates.
// Ranks: the two-pass oracle ranks the compacted pool's first w lanes,
//   live lanes with their scores and lanes n_live .. w-1 with NEG, ties
//   to the lowest compacted index.  So a live slot is keyed by its
//   compacted position (stable compaction keeps slot order, so ties
//   carry over), and the final selection adds the sentinel keys
//   make_key(NEG, j) for j in [n_live, min(w, n_live + L)): make_key's
//   index half ranks them after a live NEG and before a live score
//   below NEG (-inf, -3e30) exactly as lax.top_k does.
// Design: one launch at every w.  A CTA of 1024 threads takes a tile of 4096
//   slots, 4 consecutive slots a thread (16-byte loads where the pointers
//   allow), and counts its live slots with four ballots a warp and one
//   shuffle scan over the warp totals.  It keys its live slots by their
//   position in the tile and cta_top leaves its best L in warp 0 (a ragged
//   tile first spreads its keys over the warps through shared memory, so that
//   cta_top's exact filter does not fall back to a sort in every warp).  Up to
//   4096 slots that is the whole pool.  Past one tile the CTAs take their
//   tiles from an atomic ticket, in the order they start, and find the live
//   slots before their tile by a single-pass decoupled look-back over
//   per-tile status words: (epoch << 2 | state, count), state AGG (the tile's
//   own count), INC (the inclusive count) or TAIL (INC, and the tile's -1
//   lanes written).  A CTA waits only on tiles that took earlier tickets, so
//   on CTAs that have started.  The epoch, which the last CTA of every call
//   advances, tells this call's words from the last call's, so no call needs
//   a zeroing launch.  Each CTA shifts its keys by P_c, the live slots before
//   its tile, to compacted positions.  Output lanes: tile c fills its own
//   lanes at or past its inclusive count I_c with -1 and then publishes TAIL;
//   its live ids go, coalesced from shared memory, to [P_c, I_c), after the
//   earlier tiles whose lanes that range covers have published TAIL (their -1
//   lanes below n_live are the ones it overwrites).  Then each CTA writes its
//   list to the workspace and counts itself in; the last CTA to arrive merges
//   the lists (merge_lists), adds the sentinel keys, writes n_live and the
//   ranks, sets the ticket and the done counter back to 0 and advances the
//   epoch.  One workspace serves one stream at a time.
// ---------------------------------------------------------------------
constexpr uint32_t ST_AGG = 1u, ST_INC = 2u, ST_TAIL = 3u;
constexpr uint32_t TAG_MASK = 0x3FFFFFFFu;  // epoch bits a status word keeps
constexpr long long SPIN_LIMIT = 1ll << 24;  // polls before a wait traps

__device__ __forceinline__ u64 status_word(uint32_t tag, uint32_t state,
                                           int value) {
  return (static_cast<u64>((tag << 2) | state) << 32) |
         static_cast<uint32_t>(value);
}

// The word's state if it was written in this call (epoch tag `tag`), else
// 0.  The zeroed words of a new workspace have state 0.
__device__ __forceinline__ uint32_t word_state(u64 s, uint32_t tag) {
  const uint32_t hi = static_cast<uint32_t>(s >> 32);
  return (hi >> 2) == tag ? (hi & 3u) : 0u;
}

__device__ __forceinline__ u64 load_status(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

__device__ __forceinline__ void store_status(u64* p, u64 v) {
  *reinterpret_cast<volatile u64*>(p) = v;
}

// Polls tile c's status word until it has this call's tag and at least
// state `least`; a protocol fault (two streams sharing a workspace)
// traps instead of hanging the card.
__device__ __forceinline__ u64 wait_status(const u64* status, int c,
                                           uint32_t tag, uint32_t least) {
  for (long long spins = 0;; ++spins) {
    const u64 s = load_status(status + c);
    if (word_state(s, tag) >= least) return s;
    if (spins == SPIN_LIMIT) __trap();
  }
}

// The live slots before tile `tile` (warp 0, every lane): each lane
// reads one of the 32 tiles before it; the nearest inclusive count plus
// the aggregates after it is the answer, else all 32 aggregates are
// added and the window moves back.
__device__ __forceinline__ int look_back(const u64* status, int tile,
                                         uint32_t tag) {
  const int lane = threadIdx.x & 31;
  int excl = 0;
  for (int top = tile - 1;; top -= 32) {
    const int c = top - lane;
    uint32_t state = ST_INC, value = 0u;  // before tile 0: an inclusive 0
    if (c >= 0) {
      const u64 s = wait_status(status, c, tag, ST_AGG);
      state = word_state(s, tag);
      value = static_cast<uint32_t>(s);
    }
    const unsigned inc = __ballot_sync(0xffffffffu, state >= ST_INC);
    const int stop = inc != 0u ? __ffs(inc) - 1 : 31;
    int v = lane <= stop ? static_cast<int>(value) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    excl += v;
    if (inc != 0u) return excl;
  }
}

template <int L>
struct CompactSmem {
  union {
    TopSmem<L> top;  // cta_top and the last CTA's merge
    int ids[TILE];   // the tile's live ids, in compacted order
    u64 keys[TILE];  // a ragged tile's keys, spread over the warps
  };
  int wtot[WARPS];   // live slots of each warp
  int tile, excl;
  unsigned int epoch;
};

template <int L>
__global__ void __launch_bounds__(NT)
compact_topb_kernel(const int* __restrict__ slot_req,
                    const uint8_t* __restrict__ alive,
                    const float* __restrict__ wait,
                    const float* __restrict__ cost,
                    const float* __restrict__ urg,
                    const float* __restrict__ route,
                    const float* __restrict__ weights, int w_total, int b,
                    int has_route, u64* ws, unsigned int* ctr, u64* status,
                    int* out_req, int* out_n, int* out_idx,
                    float* out_score) {
  __shared__ CompactSmem<L> sm;
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool multi = gridDim.x > 1;
  // ctr: [0] done, [1] ticket, [2] epoch
  int tile = 0;
  uint32_t tag = 0u;
  if (multi) {
    if (tid == 0) {
      sm.tile = static_cast<int>(atomicAdd(ctr + 1, 1u));
      sm.epoch = *reinterpret_cast<volatile unsigned int*>(ctr + 2);
    }
    __syncthreads();
    tile = sm.tile;
    tag = sm.epoch & TAG_MASK;
  }
  float w[5];
#pragma unroll
  for (int j = 0; j < 5; ++j)
    w[j] = j < (has_route ? 5 : 4) ? __ldg(weights + j) : 0.0f;

  // this thread's E consecutive slots
  const int s0 = tile * TILE;
  const int i0 = s0 + E * tid;
  int req[E];
  bool a[E];
  float fw[E], fc[E], fu[E], fr[E];
  const bool vec =
      ((reinterpret_cast<uintptr_t>(slot_req) |
        reinterpret_cast<uintptr_t>(wait) | reinterpret_cast<uintptr_t>(cost) |
        reinterpret_cast<uintptr_t>(urg) |
        reinterpret_cast<uintptr_t>(route)) & 15u) == 0u &&
      (reinterpret_cast<uintptr_t>(alive) & 3u) == 0u;
  if (vec && i0 + E <= w_total) {
    const int4 r4 = __ldg(reinterpret_cast<const int4*>(slot_req + i0));
    const uchar4 a4 = __ldg(reinterpret_cast<const uchar4*>(alive + i0));
    const float4 w4 = __ldg(reinterpret_cast<const float4*>(wait + i0));
    const float4 c4 = __ldg(reinterpret_cast<const float4*>(cost + i0));
    const float4 u4 = __ldg(reinterpret_cast<const float4*>(urg + i0));
    const float4 t4 = has_route
                          ? __ldg(reinterpret_cast<const float4*>(route + i0))
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    req[0] = r4.x; req[1] = r4.y; req[2] = r4.z; req[3] = r4.w;
    a[0] = a4.x != 0; a[1] = a4.y != 0; a[2] = a4.z != 0; a[3] = a4.w != 0;
    fw[0] = w4.x; fw[1] = w4.y; fw[2] = w4.z; fw[3] = w4.w;
    fc[0] = c4.x; fc[1] = c4.y; fc[2] = c4.z; fc[3] = c4.w;
    fu[0] = u4.x; fu[1] = u4.y; fu[2] = u4.z; fu[3] = u4.w;
    fr[0] = t4.x; fr[1] = t4.y; fr[2] = t4.z; fr[3] = t4.w;
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = i0 + e;
      const bool in = i < w_total;
      req[e] = in ? __ldg(slot_req + i) : -1;
      a[e] = in && __ldg(alive + i) != 0;
      fw[e] = in ? __ldg(wait + i) : 0.0f;
      fc[e] = in ? __ldg(cost + i) : 1.0f;
      fu[e] = in ? __ldg(urg + i) : 0.0f;
      fr[e] = in && has_route ? __ldg(route + i) : 0.0f;
    }
  }

  // positions in the tile: four ballots a warp, then a scan of the 32
  // warp totals that every warp repeats (one barrier)
  const unsigned int below = (1u << lane) - 1u;
  int before = 0, wcount = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const unsigned int m = __ballot_sync(0xffffffffu, a[e]);
    before += __popc(m & below);
    wcount += __popc(m);
  }
  if (lane == 0) sm.wtot[warp] = wcount;
  __syncthreads();
  const int v = sm.wtot[lane];
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  const int cnt = __shfl_sync(0xffffffffu, incl, 31);
  int pos[E];
  pos[0] = __shfl_sync(0xffffffffu, incl - v, warp) + before;
#pragma unroll
  for (int e = 1; e < E; ++e) pos[e] = pos[e - 1] + (a[e - 1] ? 1 : 0);
  if (multi && tid == 0)
    store_status(status + tile,
                 status_word(tag, tile == 0 ? ST_INC : ST_AGG, cnt));

  u64 k[E];
#pragma unroll
  for (int e = 0; e < E; ++e)
    k[e] = a[e] ? make_key(sched_score(fw[e], fc[e], fu[e], fr[e], w,
                                       has_route != 0),
                           static_cast<uint32_t>(pos[e]))
                : 0ull;
  // cta_top's filter takes the L-th best of the 32 warps' best keys, so
  // it needs keys in at least L warps.  A ragged tile's slots lie in its
  // first warps only (4 consecutive a thread), and its filter would let
  // too many keys through, so its keys are spread over the warps, slot
  // e * NT + tid in thread tid, as top-b holds its lanes.
  const int s1 = min(s0 + TILE, w_total);
  if (s1 - s0 < TILE) {
#pragma unroll
    for (int e = 0; e < E; ++e) sm.keys[E * tid + e] = k[e];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) k[e] = sm.keys[e * NT + tid];
    __syncthreads();
  }
  cta_top<L>(k, sm.top);

  // live slots before the tile; keys to compacted positions
  if (warp == 0) {
    const int excl = multi && tile > 0 ? look_back(status, tile, tag) : 0;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (k[e] != 0ull) k[e] -= static_cast<u64>(excl);
    if (lane == 0) {
      if (multi && tile > 0)
        store_status(status + tile, status_word(tag, ST_INC, excl + cnt));
      sm.excl = excl;
    }
  }
  __syncthreads();
  const int excl = sm.excl;
  const int incl_all = excl + cnt;

  // -1 on this tile's lanes at or past its inclusive count; the live
  // ids into shared memory in compacted order
  for (int j = max(s0, incl_all) + tid; j < s1; j += NT) out_req[j] = -1;
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (a[e]) sm.ids[pos[e]] = req[e];
  __syncthreads();
  if (multi) {
    if (tid == 0) {
      __threadfence();
      store_status(status + tile, status_word(tag, ST_TAIL, incl_all));
      // the ids land on lanes of earlier tiles that they set to -1
      if (cnt > 0) {
        const int last_c = min(tile - 1, (incl_all - 1) / TILE);
        for (int c = excl / TILE; c <= last_c; ++c)
          wait_status(status, c, tag, ST_TAIL);
      }
      __threadfence();
    }
    __syncthreads();
  }
  for (int j = tid; j < cnt; j += NT) out_req[excl + j] = sm.ids[j];

  int n_live = cnt;
  if (multi) {
    if (warp == 0) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (wpos(e) < L) ws[tile * L + wpos(e)] = k[e];
      __threadfence();
    }
    if (!last_to_arrive(ctr)) return;
    merge_lists<L>(k, sm.top, ws, static_cast<int>(gridDim.x));
    n_live = static_cast<int>(static_cast<uint32_t>(
        load_status(status + gridDim.x - 1)));
    if (tid == 0) {  // ready for the next call (or a graph replay)
      ctr[0] = 0u;
      ctr[1] = 0u;
      ctr[2] = sm.epoch + 1u;
    }
  }
  if (tid == 0) *out_n = n_live;
  if (warp == 0) {
    merge_with<L>(k, [n_live, w_total](int q) {
      const int j = n_live + q;
      return j < w_total ? make_key(NEG, static_cast<uint32_t>(j)) : 0ull;
    });
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

// ws as for sched_score_topb; ctr: done, ticket and epoch, the first two
// 0 before the call and left 0 after it (a done counter of its own, not
// sched_score_topb's); status: ceil(w / 4096) status words, zeroed when
// made and never again.
int sched_compact_topb(const int* slot_req, const uint8_t* alive,
                       const float* wait, const float* cost, const float* urg,
                       const float* route, const float* weights, int w_total,
                       int b, u64* ws, unsigned int* ctr, u64* status,
                       int* out_req, int* out_n, int* out_idx,
                       float* out_score, cudaStream_t stream) {
  if (w_total < 1 || b < 1 || b > BMAX || b > w_total)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (w_total + TILE - 1) / TILE;
  const auto kernel = b <= 1    ? compact_topb_kernel<1>
                      : b <= 2  ? compact_topb_kernel<2>
                      : b <= 4  ? compact_topb_kernel<4>
                      : b <= 8  ? compact_topb_kernel<8>
                      : b <= 16 ? compact_topb_kernel<16>
                      : b <= 32 ? compact_topb_kernel<32>
                      : b <= 64 ? compact_topb_kernel<64>
                                : compact_topb_kernel<128>;
  kernel<<<nb, NT, 0, stream>>>(slot_req, alive, wait, cost, urg, route,
                                weights, w_total, b, route != nullptr ? 1 : 0,
                                ws, ctr, status, out_req, out_n, out_idx,
                                out_score);
  return static_cast<int>(cudaGetLastError());
}

int sched_score_tile(void) { return TILE; }

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
