// Fused REWAFL utility -> epsilon-greedy top-K selection, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `select_topk` in
// src/repro/kernels/rewafl_select/rewafl_select.py (body `_kernel`, entry
// points `select_topk_flat` / `select_topk_tiled`). Same function: the
// Eqn-2 utility computed from the raw (S,) leaves (stat, t, e, residual,
// e0), masked to -1e30 where a device is unavailable; the top `k_exploit`
// devices by utility; the top K by the epsilon-greedy uniform draw as
// explore candidates, resolved so explore slots exclude exploit picks;
// only (K,) indices and live flags are written. Ties go to the lower
// device index. Any K <= S.
//
// What bounds it on the card: it must read 21 bytes a device (five f32
// leaves and one bool; 25 when it explores, the uniform draw too), 21 MB
// at S = 1e6, about 6.3 us at 3.35 TB/s. At the main path's S = 100 it
// is bound by one launch.
//
// Design. Every device gets a 64-bit key whose order is (value desc,
// index asc): the high word is the value's order-preserving bits (the
// IEEE total order), inverted, the low word the index. Keys are unique, so any exact
// selection of the k smallest keys returns the same set, and sorting that
// set gives the reference's rank order with its tie rule.
//
// A block selects the k smallest of n keys without k passes:
//   - n <= COUNT_MAX (192): each key's rank is the number of smaller
//     keys; a key of rank < k goes to slot rank. One barrier. Up to ~200
//     keys this is faster than the radix select on an H100 (PERF.md).
//   - otherwise a radix select finds the k-th smallest key a digit of 8
//     bits at a time from the top (a 256-bin shared histogram of the keys
//     that still match the digits found so far, and a one-warp scan over
//     it), and stops at the first digit where the bin that holds the k-th
//     key holds exactly the keys still needed; the keys at or below that
//     cut are compacted (exactly k: the keys are unique) and sorted, by
//     rank counting when k fits the block's threads, else by a bitonic
//     sort. Two barriers a digit, at most 8 digits, then 2 for the count
//     sort or log2(k)(log2(k)+1)/2 for the bitonic one: the barriers
//     depend on the digits and on log k, not on k.
// Explore slots are resolved as `_resolve` does: the first k_explore live
// candidates, in rank order, that are not live exploit picks, found by a
// block-wide prefix count over the ranked candidates. A candidate g is an
// exploit pick if its utility key is at or below the k_exploit-th.
//
// The last kernel of a call (select_one, select_merge) starts with
// griddepcontrol.launch_dependents, so that a kernel launched after it
// with programmatic dependent launch is scheduled while it runs.
//
// Launches. Up to TILE devices one block does everything (keys in shared
// memory, selection, sort, resolution, write): one launch, sized to the
// fleet (128 threads at S = 100). Above, two launches: one block per TILE
// devices writes its min(K, n) smallest keys of each kind to scratch the
// wrapper allocates; one block then selects over those candidates, in
// shared memory when they fit, else in global memory, where a sort buffer
// too large for shared memory also lies. That block's time grows with
// its candidates, K a tile, so a tile is as many devices as one block
// holds anyway: 123 tiles and 2,460 candidates at S = 1e6 and K = 20. A
// ragged last tile just has fewer keys; nothing is padded. Dead slots are
// written as (0, 0). A slot is live unless its value is at or below
// LIVE_THR (an unavailable device's -1e30): a NaN utility of an available
// device ranks last and is selected when the ranking reaches it, as the
// reference's `lax.top_k` selection does with a negative NaN.
//
// The utility (`utility`, `pow_s`) follows the plain version op for op,
// so its values, and the selection, are bitwise the plain version's.
//
// Batched: B independent selections over (B, S) leaves (a seed batch's
// fleets; B = 1 for one) in the same one or two launches, one block (or
// one set of tile blocks and one merging block) a selection: selection b
// reads its leaves at offset b * S, writes its K slots at b * K and, when
// tiled, uses its own scratch at b * scratch. Each is computed exactly as
// a launch of that selection alone.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int TILE = 8192;   // the keys one block holds: the whole fleet up
                             // to this size (one launch), else one tile
constexpr int MAX_THREADS = 1024;
constexpr int COUNT_MAX = 192;      // key sets up to this size ranked by counting
constexpr int TOP_SMEM_MAX = 8192;   // sort buffer keys kept in shared memory
constexpr size_t SMEM_BUDGET = 200 * 1024;   // dynamic shared memory a block
constexpr float NEG = -1e30f;
constexpr float LIVE_THR = -1e29f;
constexpr u64 NO_KEY = ~0ull;   // after every real key

// The IEEE total order of the bits, as lax.top_k ranks (+0 above -0),
// with every NaN below every number (core.selection.desc_order).
__device__ __forceinline__ unsigned int ordered_bits(float v) {
  if (isnan(v)) return 0u;
  unsigned int u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 make_key(float v, int idx) {
  return ((u64)(~ordered_bits(v)) << 32) | (unsigned int)idx;
}

__device__ __forceinline__ float key_value(u64 key) {
  unsigned int o = ~(unsigned int)(key >> 32);
  unsigned int u = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_index(u64 key) {
  return (int)(unsigned int)(key & 0xffffffffull);
}

__device__ __forceinline__ bool key_live(u64 key) {
  return key != NO_KEY && !(key_value(key) <= LIVE_THR);   // NaN is live
}

// jnp.maximum(x, lo) for a constant lo: a NaN x stays NaN.
__device__ __forceinline__ float max_keep_nan(float x, float lo) {
  return x < lo ? lo : x;
}

// base ** p as PyTorch's tensor ** scalar computes it on the card, so the
// plain version's utilities match bitwise for every exponent: 1 leaves the
// base as it is, 0 gives 1, and 0.5, -0.5, -1, 2, 3 and -2 are special
// cases (sqrt, rsqrt, reciprocal, products) rather than powf, which is not
// correctly rounded. 1/(b*b) in float equals PyTorch's double quotient
// rounded to float: double rounding of a quotient is exact at 53 bits.
__device__ __forceinline__ float pow_s(float b, float p) {
  if (p == 1.0f) return b;
  if (p == 0.0f) return 1.0f;
  if (p == 0.5f) return sqrtf(b);
  if (p == -0.5f) return rsqrtf(b);
  if (p == -1.0f) return 1.0f / b;
  if (p == 2.0f) return b * b;
  if (p == 3.0f) return b * b * b;
  if (p == -2.0f) return 1.0f / (b * b);
  return powf(b, p);
}

__device__ __forceinline__ float utility(float stat, float t, float e,
                                         float residual, float e0,
                                         float T_round, float alpha,
                                         float beta) {
  float lat = t > T_round ? pow_s(T_round / max_keep_nan(t, 1e-9f), alpha)
                          : 1.0f;
  float head = residual - e0;
  float eng = e < head
                  ? pow_s(max_keep_nan(head / max_keep_nan(e, 1e-9f), 1e-9f),
                          beta)
                  : 0.0f;
  return (stat * lat) * eng;
}

struct Leaves {
  const float *stat, *t, *e, *residual, *e0;
  const unsigned char* avail;
  const float* rnd;   // read only when exploring
  float T_round, alpha, beta;
};

// Selection b's leaves, at offset b * S of (B, S) ones.
__device__ __forceinline__ Leaves batch_leaves(Leaves L, int b, int S) {
  const size_t o = (size_t)b * S;
  L.stat += o;
  L.t += o;
  L.e += o;
  L.residual += o;
  L.e0 += o;
  L.avail += o;
  L.rnd += o;
  return L;
}

// Device g's key by utility (NEG where unavailable), as load_keys makes it.
__device__ __forceinline__ u64 exploit_key(const Leaves& L, int g) {
  const float u = L.avail[g] != 0
                      ? utility(L.stat[g], L.t[g], L.e[g], L.residual[g],
                                L.e0[g], L.T_round, L.alpha, L.beta)
                      : NEG;
  return make_key(u, g);
}

// The keys of devices g0 + i, i < n, into ux[i] (by utility, when xk)
// and ur[i] (by the uniform draw, when rk), PER devices a thread, i =
// threadIdx.x + j * blockDim.x: every leaf of the PER devices is loaded
// before any key is computed, so that the loads overlap.
template <int PER>
__device__ void load_chunk(const Leaves& L, int g0, int n, bool xk, bool rk,
                           u64* ux, u64* ur) {
  float st[PER], tt[PER], ee[PER], re[PER], e0[PER], rn[PER];
  bool av[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * blockDim.x, g = g0 + i;
    av[j] = i < n && L.avail[g] != 0;
    if (i < n && xk) {
      st[j] = L.stat[g];
      tt[j] = L.t[g];
      ee[j] = L.e[g];
      re[j] = L.residual[g];
      e0[j] = L.e0[g];
    }
    if (i < n && rk) rn[j] = L.rnd[g];
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i >= n) continue;
    if (xk)
      ux[i] = make_key(av[j] ? utility(st[j], tt[j], ee[j], re[j], e0[j],
                                       L.T_round, L.alpha, L.beta)
                             : NEG,
                       g0 + i);
    if (rk) ur[i] = make_key(av[j] ? rn[j] : NEG, g0 + i);
  }
}

// The keys of devices g0 .. g0 + n - 1, four a thread at a time.
__device__ void load_keys(const Leaves& L, int g0, int n, bool xk, bool rk,
                          u64* ux, u64* ur) {
  const int step = 4 * blockDim.x;
  for (int c = 0; c < n; c += step)
    load_chunk<4>(L, g0 + c, min(step, n - c), xk, rk, ux + c, ur + c);
}

// Shared scratch of the block-wide steps.
struct Work {
  int hist[2][256];   // radix histograms, one filled while the other clears
  int info[3];        // the digit found: bin, keys before it, keys in it
  int wsum[32];       // per-warp counts of a block scan
  int count;          // compaction cursor
};

// Exclusive prefix count of `flag` over the block, in thread order; the
// block's total in `total`. Every thread must call it.
__device__ int block_scan(bool flag, int& total, Work& w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned b = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) w.wsum[warp] = __popc(b);
  __syncthreads();
  int before = 0;
  total = 0;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
    const int s = w.wsum[i];
    total += s;
    before += i < warp ? s : 0;
  }
  __syncthreads();   // wsum is reused by the next call
  return before + __popc(b & ((1u << lane) - 1u));
}

// The keys at or below a cut: (key >> shift) <= pre.
struct Cut {
  u64 pre;
  int shift;
};

// The cut that keeps exactly the k smallest of the n unique keys src[i].
// Radix select, 8 bits a digit from the top; stops at the first digit
// whose bin holding the k-th key holds exactly the keys still needed.
// Also zeroes the compaction cursor.
__device__ Cut radix_cut(const u64* src, int n, int k, Work& w) {
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31;
  for (int i = tid; i < 512; i += T) (&w.hist[0][0])[i] = 0;
  if (tid == 0) w.count = 0;
  __syncthreads();
  if (k >= n) return Cut{NO_KEY, 0};
  u64 pre = 0;
  int cur = 0;
  for (int shift = 56;; shift -= 8) {
    int* h = w.hist[cur];
    for (int i = tid; i < n; i += T) {
      const u64 key = src[i];
      if (shift == 56 || (key >> (shift + 8)) == pre)
        atomicAdd(&h[(int)(key >> shift) & 255], 1);
    }
    __syncthreads();
    if (tid < 32) {   // find the bin of the k-th key: lane l scans bins 8l..8l+7
      int c[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = h[lane * 8 + j];
        s += c[j];
      }
      int incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      int before = incl - s;
      if (before < k && k <= incl) {
        bool found = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (found) continue;
          if (before + c[j] >= k) {
            found = true;
            w.info[0] = lane * 8 + j;
            w.info[1] = before;
            w.info[2] = c[j];
          } else {
            before += c[j];
          }
        }
      }
    } else {          // meanwhile the other warps clear the next histogram
      int* o = w.hist[cur ^ 1];
      for (int i = tid - 32; i < 256; i += T - 32) o[i] = 0;
    }
    __syncthreads();
    k -= w.info[1];
    pre = (pre << 8) | (u64)w.info[0];
    // at the last digit the bin is one key (the keys are unique)
    if (w.info[2] == k || shift == 0) return Cut{pre, shift};
    cur ^= 1;
  }
}

// The keys of src[0..n) at or below `cut` into dst[0..cap), in no order.
// The cursor was zeroed by radix_cut. Each thread loads R keys before it
// places any, so that the loads overlap.
template <int R>
__device__ void compact(const u64* src, int n, Cut cut, u64* dst, int cap,
                        Work& w) {
  const int lane = threadIdx.x & 31;
  for (int c = 0; c < n; c += R * blockDim.x) {
    u64 keys[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = c + threadIdx.x + j * blockDim.x;
      keys[j] = i < n ? src[i] : NO_KEY;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = c + threadIdx.x + j * blockDim.x;
      const u64 key = keys[j];
      const bool take = i < n && (key >> cut.shift) <= cut.pre;
      const unsigned b = __ballot_sync(0xffffffffu, take);
      if (b == 0) continue;
      const int leader = __ffs(b) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(&w.count, __popc(b));
      base = __shfl_sync(0xffffffffu, base, leader);
      const int pos = base + __popc(b & ((1u << lane) - 1u));
      if (take && pos < cap) dst[pos] = key;
    }
  }
  __syncthreads();
}

// The k smallest of n unique keys, ranked by counting: a key of rank r < k
// goes to top[r].
__device__ void rank_select(const u64* src, int n, int k, u64* top) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const u64 key = src[i];
    int r = 0;
    for (int j = 0; j < n; ++j) r += src[j] < key;
    if (r < k) top[r] = key;
  }
  __syncthreads();
}

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

__host__ __device__ inline int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// top[0..k) sorted ascending in place: by rank counting when each thread
// holds one key, else by a bitonic sort over pow2_ceil(k) slots (top must
// hold that many; the tail is padded with NO_KEY).
__device__ void sort_keys(u64* top, int k) {
  const int tid = threadIdx.x, T = blockDim.x;
  if (k <= T) {
    const u64 mine = tid < k ? top[tid] : NO_KEY;
    int r = 0;
    if (tid < k)
      for (int j = 0; j < k; ++j) r += top[j] < mine;
    __syncthreads();
    if (tid < k) top[r] = mine;
    __syncthreads();
    return;
  }
  const int P = pow2_ceil(k);
  for (int i = k + tid; i < P; i += T) top[i] = NO_KEY;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P / 2; i += T) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const u64 a = top[lo], b = top[hi];
        if ((a > b) == up) {
          top[lo] = b;
          top[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The k smallest of the n unique keys src[0..n), ascending, into top.
__device__ void select_sorted(const u64* src, int n, int k, u64* top,
                              Work& w) {
  if (n <= COUNT_MAX) {
    rank_select(src, n, k, top);
    return;
  }
  const Cut cut = radix_cut(src, n, k, w);
  compact<4>(src, n, cut, top, k, w);
  sort_keys(top, k);
}

// Exploit slots from the ranked top[0..kx); returns the kx-th key (the
// largest exploit pick) to every thread.
__device__ u64 write_exploit(const u64* top, int kx, int* out_idx,
                             int* out_live) {
  for (int j = threadIdx.x; j < kx; j += blockDim.x) {
    const u64 key = top[j];
    const bool live = key_live(key);
    out_idx[j] = live ? key_index(key) : 0;
    out_live[j] = live ? 1 : 0;
  }
  const u64 thr = top[kx - 1];
  __syncthreads();   // top is reused
  return thr;
}

// Explore slots: the first kr live candidates of the ranked top[0..kc)
// that are not live exploit picks (xkey(g) <= thr_x), in rank order; the
// rest dead.
template <typename XKey>
__device__ void write_explore(const u64* top, int kc, int kx, int kr,
                              u64 thr_x, XKey xkey, int* out_idx,
                              int* out_live, Work& w) {
  int base = 0;   // explore slots filled so far (uniform)
  for (int m0 = 0; m0 < kc && base < kr; m0 += blockDim.x) {
    const int m = m0 + threadIdx.x;
    bool pick = false;
    int g = 0;
    if (m < kc && key_live(top[m])) {
      g = key_index(top[m]);
      const u64 xk = kx > 0 ? xkey(g) : NO_KEY;
      pick = !(xk <= thr_x && key_live(xk));
    }
    int total;
    const int pos = base + block_scan(pick, total, w);
    if (pick && pos < kr) {
      out_idx[kx + pos] = g;
      out_live[kx + pos] = 1;
    }
    base += total;
  }
  for (int j = min(base, kr) + (int)threadIdx.x; j < kr; j += blockDim.x) {
    out_idx[kx + j] = 0;
    out_live[kx + j] = 0;
  }
}

// A kernel launched after this one with programmatic stream
// serialization (fedavg_indexed, in `select_aggregate`) may start: it
// waits for this grid to finish before it reads idx and live, so the
// trigger can come first, and its blocks are then resident when the
// selection ends. A no-op when no such kernel follows.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// S <= TILE: the whole selection in one block. Dynamic shared memory:
// ux[S] (when kx > 0), ur[S] (when kr > 0), top[pow2_ceil(sel)].
__global__ void __launch_bounds__(MAX_THREADS)
select_one(Leaves L, int S, int kx, int kr, int* __restrict__ out_idx,
           int* __restrict__ out_live) {
  extern __shared__ u64 dyn[];
  __shared__ Work w;
  launch_dependents();
  L = batch_leaves(L, blockIdx.x, S);   // one block a selection
  out_idx += (size_t)blockIdx.x * (kx + kr);
  out_live += (size_t)blockIdx.x * (kx + kr);
  u64* ux = dyn;
  u64* ur = ux + (kx > 0 ? S : 0);
  u64* top = ur + (kr > 0 ? S : 0);
  load_keys(L, 0, S, kx > 0, kr > 0, ux, ur);
  __syncthreads();
  u64 thr_x = 0;
  if (kx > 0) {
    select_sorted(ux, S, kx, top, w);
    thr_x = write_exploit(top, kx, out_idx, out_live);
  }
  if (kr > 0) {
    const int kc = kx + kr;
    select_sorted(ur, S, kc, top, w);
    write_explore(top, kc, kx, kr, thr_x, [&](int g) { return ux[g]; },
                  out_idx, out_live, w);
  }
}

// Stage 1: tile b's min(k, n) smallest keys of each kind, in no order, to
// cand_x + b * min(kx, TILE) and cand_r + b * min(kc, TILE). Dynamic
// shared memory: ux[TILE] (when kx > 0), ur[TILE] (when kc > 0). The
// selection is blockIdx.y; its candidates start `stride` keys apart.
__global__ void __launch_bounds__(MAX_THREADS)
select_tiles(Leaves L, int S, int kx, int kc, u64* __restrict__ cand_x,
             u64* __restrict__ cand_r, size_t stride) {
  extern __shared__ u64 dyn[];
  __shared__ Work w;
  L = batch_leaves(L, blockIdx.y, S);
  cand_x += blockIdx.y * stride;
  cand_r += blockIdx.y * stride;
  u64* ux = dyn;
  u64* ur = ux + (kx > 0 ? TILE : 0);
  const int base = blockIdx.x * TILE;
  const int n = min(TILE, S - base);
  load_keys(L, base, n, kx > 0, kc > 0, ux, ur);
  __syncthreads();
  if (kx > 0)
    compact<4>(ux, n, radix_cut(ux, n, min(kx, n), w),
               cand_x + (size_t)blockIdx.x * min(kx, TILE), min(kx, n), w);
  if (kc > 0)
    compact<4>(ur, n, radix_cut(ur, n, min(kc, n), w),
               cand_r + (size_t)blockIdx.x * min(kc, TILE), min(kc, n), w);
}

// Stage 2: one block selects over the tiles' candidates, ranks them and
// resolves the slots. top is top_g when given, else the start of dynamic
// shared memory; the candidates are copied after it when keys_in_smem.
// One block a selection (blockIdx.x), its scratch `stride` keys apart.
__global__ void __launch_bounds__(MAX_THREADS)
select_merge(Leaves L, int S, const u64* __restrict__ cand_x, int n_cx,
             const u64* __restrict__ cand_r, int n_cr, int kx, int kr,
             int keys_in_smem, u64* top_g, size_t stride,
             int* __restrict__ out_idx, int* __restrict__ out_live) {
  extern __shared__ u64 dyn[];
  __shared__ Work w;
  launch_dependents();
  L = batch_leaves(L, blockIdx.x, S);
  cand_x += blockIdx.x * stride;
  cand_r += blockIdx.x * stride;
  if (top_g != nullptr) top_g += blockIdx.x * stride;
  out_idx += (size_t)blockIdx.x * (kx + kr);
  out_live += (size_t)blockIdx.x * (kx + kr);
  const int kc = kr > 0 ? kx + kr : 0;
  u64* top = top_g != nullptr ? top_g : dyn;
  u64* buf = top_g != nullptr ? dyn : dyn + pow2_ceil(kc > 0 ? kc : kx);
  auto load = [&](const u64* cand, int n) -> const u64* {
    if (!keys_in_smem) return cand;
    for (int c = 0; c < n; c += 8 * blockDim.x) {   // 8 loads in flight a thread
      u64 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = c + threadIdx.x + j * blockDim.x;
        v[j] = i < n ? cand[i] : NO_KEY;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = c + threadIdx.x + j * blockDim.x;
        if (i < n) buf[i] = v[j];
      }
    }
    __syncthreads();
    return buf;
  };
  u64 thr_x = 0;
  if (kx > 0) {
    select_sorted(load(cand_x, n_cx), n_cx, kx, top, w);
    thr_x = write_exploit(top, kx, out_idx, out_live);
  }
  if (kr > 0) {
    select_sorted(load(cand_r, n_cr), n_cr, kc, top, w);
    write_explore(top, kc, kx, kr, thr_x,
                  [&](int g) { return exploit_key(L, g); }, out_idx, out_live,
                  w);
  }
}

// How a call is laid out; shared by the scratch query and the launch.
struct Plan {
  bool one_block;
  int threads, n_tiles, n_cx, n_cr, top_keys;   // top_keys: pow2_ceil(sel)
  bool top_in_smem, keys_in_smem;
  size_t smem, scratch;   // dynamic shared bytes; scratch in 8-byte keys
};

Plan make_plan(int S, int kx, int kr) {
  Plan p{};
  const int kc = kr > 0 ? kx + kr : 0;
  p.top_keys = pow2_ceil(kc > 0 ? kc : kx);
  p.one_block = S <= TILE;
  if (p.one_block) {
    const int t = pow2_ceil(S);   // 128 threads at least, 1,024 at most
    p.threads = t < 128 ? 128 : (t > MAX_THREADS ? MAX_THREADS : t);
    p.smem = 8 * ((size_t)(kx > 0) * S + (size_t)(kr > 0) * S + p.top_keys);
    return p;
  }
  p.threads = MAX_THREADS;
  p.n_tiles = (S + TILE - 1) / TILE;
  const int n_last = S - (p.n_tiles - 1) * TILE;
  auto n_cand = [&](int k) {
    return k > 0 ? (p.n_tiles - 1) * imin(k, TILE) + imin(k, n_last) : 0;
  };
  p.n_cx = n_cand(kx);
  p.n_cr = n_cand(kc);
  p.top_in_smem = p.top_keys <= TOP_SMEM_MAX;
  const size_t top_bytes = p.top_in_smem ? 8 * (size_t)p.top_keys : 0;
  const size_t keys_bytes = 8 * (size_t)(p.n_cx > p.n_cr ? p.n_cx : p.n_cr);
  p.keys_in_smem = top_bytes + keys_bytes <= SMEM_BUDGET;
  p.smem = top_bytes + (p.keys_in_smem ? keys_bytes : 0);
  p.scratch = (size_t)p.n_cx + p.n_cr + (p.top_in_smem ? 0 : p.top_keys);
  return p;
}

bool valid(int S, int kx, int kr) {
  return S >= 1 && kx >= 0 && kr >= 0 && kx + kr >= 1 && kx + kr <= S;
}

}  // namespace

// 8-byte scratch keys the call needs (0 when one block holds the fleet),
// or -1 for arguments the kernel does not take.
extern "C" long long rewafl_select_scratch(int S, int kx, int kr) {
  if (!valid(S, kx, kr)) return -1;
  return (long long)make_plan(S, kx, kr).scratch;
}

// B selections over (B, S) leaves, contiguous (B = 1 for one); rnd is
// read only when kr > 0. scratch: at least B * rewafl_select_scratch(S,
// kx, kr) keys. out_idx, out_live: (B, kx + kr). Returns a cudaError_t.
extern "C" int rewafl_select(
    const float* stat, const float* t, const float* e, const float* residual,
    const float* e0, const unsigned char* avail, const float* rnd, int B,
    int S, int kx, int kr, float T_round, float alpha, float beta,
    unsigned long long* scratch, int* out_idx, int* out_live, void* stream) {
  if (!valid(S, kx, kr) || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  static bool smem_set[64] = {};   // the opt-in above 48 KB, once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    for (const void* f : {(const void*)select_one, (const void*)select_tiles,
                          (const void*)select_merge}) {
      err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)SMEM_BUDGET);
      if (err != cudaSuccess) return (int)err;
    }
    smem_set[dev] = true;
  }
  const Leaves L{stat, t, e, residual, e0, avail, rnd, T_round, alpha, beta};
  const Plan p = make_plan(S, kx, kr);
  cudaStream_t st = (cudaStream_t)stream;
  if (p.one_block) {
    select_one<<<B, p.threads, p.smem, st>>>(L, S, kx, kr, out_idx, out_live);
    return (int)cudaGetLastError();
  }
  const int kc = kr > 0 ? kx + kr : 0;
  u64* cand_x = scratch;
  u64* cand_r = cand_x + p.n_cx;
  u64* top_g = p.top_in_smem ? nullptr : cand_r + p.n_cr;
  const size_t tile_smem = 8 * (size_t)TILE * ((kx > 0) + (kc > 0));
  select_tiles<<<dim3(p.n_tiles, B), MAX_THREADS, tile_smem, st>>>(
      L, S, kx, kc, cand_x, cand_r, p.scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  select_merge<<<B, p.threads, p.smem, st>>>(
      L, S, cand_x, p.n_cx, cand_r, p.n_cr, kx, kr, p.keys_in_smem ? 1 : 0,
      top_g, p.scratch, out_idx, out_live);
  return (int)cudaGetLastError();
}
