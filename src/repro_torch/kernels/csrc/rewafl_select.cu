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
// device index.
//
// What bounds it on the card: it must read 21 bytes per device (five f32
// leaves and one bool; 4 more when it explores), 21 MB at S = 1e6, about
// 6.3 us at 3.35 TB/s. At the main path's S = 100 it is bound by the
// launch itself.
//
// Design. The TPU grid runs in order and carries the running candidates
// in VMEM; Hopper's blocks run in parallel, so this is two stages:
//   1. One block per tile of TILE devices computes the utility (op for op
//      as `_tile_utility`: (stat*lat)*eng, the exponent's power as
//      PyTorch computes it (`pow_s`), IEEE division) and keys each device by a 64-bit key whose order is
//      (value desc, index asc): the high word is the value's order-
//      preserving bits, inverted, the low word the index. The block then
//      writes its k smallest keys — its local top-k — to a scratch array
//      the wrapper allocates, by k passes of a block-wide min over the
//      keys above the previous pass's.
//   2. One block merges all blocks' candidates the same way and resolves
//      the explore slots as `_resolve` does: the first k_explore live
//      candidates, in rank order, that are not exploit picks.
// One total order on unique keys makes both stages keep the tie rule,
// whatever order the blocks finish in. A ragged last tile just has
// fewer keys; nothing is padded. Dead slots are written as (0, 0).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 2048;      // devices per stage-1 block (keys in smem)
constexpr int THREADS = 1024;   // threads per block, both stages
constexpr int MAX_K = 256;      // largest K the merge supports
constexpr float NEG = -1e30f;
constexpr float LIVE_THR = -1e29f;
constexpr unsigned long long NO_KEY = ~0ull;   // after every real key

__device__ __forceinline__ unsigned int ordered_bits(float v) {
  v = v + 0.0f;                                 // -0 -> +0: they tie
  if (isnan(v)) v = __int_as_float(0x7fc00000);  // NaN ranks first
  unsigned int u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long make_key(float v, int idx) {
  return ((unsigned long long)(~ordered_bits(v)) << 32) | (unsigned int)idx;
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  unsigned int o = ~(unsigned int)(key >> 32);
  unsigned int u = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(unsigned int)(key & 0xffffffffull);
}

__device__ __forceinline__ bool key_live(unsigned long long key) {
  return key != NO_KEY && key_value(key) > LIVE_THR;
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

// Block-wide min; every thread gets the result. red: 33 shared words.
__device__ unsigned long long block_min(unsigned long long v,
                                        unsigned long long* red) {
  for (int off = 16; off > 0; off >>= 1) {
    unsigned long long o = __shfl_down_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : NO_KEY;
    for (int off = 16; off > 0; off >>= 1) {
      unsigned long long o = __shfl_down_sync(0xffffffffu, v, off);
      v = o < v ? o : v;
    }
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();  // red is reused by the next call
  return v;
}

// The k smallest of n unique keys (load(i), i < n) in ascending order into
// out[0..k); NO_KEY where there are fewer than k. Pass j takes the
// smallest key above pass j-1's.
template <typename Load>
__device__ void block_smallest_k(int n, int k, Load load,
                                 unsigned long long* out,
                                 unsigned long long* red) {
  unsigned long long prev = 0;
  for (int j = 0; j < k; ++j) {
    unsigned long long best = NO_KEY;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      unsigned long long key = load(i);
      if ((j == 0 || key > prev) && key < best) best = key;
    }
    best = block_min(best, red);
    if (threadIdx.x == 0) out[j] = best;
    prev = best;
  }
}

__global__ void __launch_bounds__(THREADS)
select_stage1(const float* __restrict__ stat, const float* __restrict__ t,
              const float* __restrict__ e, const float* __restrict__ residual,
              const float* __restrict__ e0,
              const unsigned char* __restrict__ avail,
              const float* __restrict__ rnd, int S, int kx, int kc,
              float T_round, float alpha, float beta,
              unsigned long long* __restrict__ cand_x,
              unsigned long long* __restrict__ cand_r) {
  __shared__ unsigned long long ux[TILE];
  __shared__ unsigned long long ur[TILE];
  __shared__ unsigned long long red[33];
  const int base = blockIdx.x * TILE;
  const int n = min(TILE, S - base);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int g = base + i;
    const bool a = avail[g] != 0;
    const float u = a ? utility(stat[g], t[g], e[g], residual[g], e0[g],
                                T_round, alpha, beta)
                      : NEG;
    ux[i] = make_key(u, g);
    if (kc > 0) ur[i] = make_key(a ? rnd[g] : NEG, g);
  }
  __syncthreads();
  if (kx > 0)
    block_smallest_k(n, kx, [&](int i) { return ux[i]; },
                     cand_x + (size_t)blockIdx.x * kx, red);
  if (kc > 0)
    block_smallest_k(n, kc, [&](int i) { return ur[i]; },
                     cand_r + (size_t)blockIdx.x * kc, red);
}

__global__ void __launch_bounds__(THREADS)
select_stage2(const unsigned long long* __restrict__ cand_x,
              const unsigned long long* __restrict__ cand_r, int n_blocks,
              int kx, int kr, int kc, int* __restrict__ out_idx,
              int* __restrict__ out_live) {
  __shared__ unsigned long long top_x[MAX_K];
  __shared__ unsigned long long top_r[MAX_K];
  __shared__ unsigned long long red[33];
  if (kx > 0)
    block_smallest_k(n_blocks * kx, kx, [&](int i) { return cand_x[i]; },
                     top_x, red);
  if (kc > 0)
    block_smallest_k(n_blocks * kc, kc, [&](int i) { return cand_r[i]; },
                     top_r, red);
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int j = 0; j < kx; ++j) {
    const bool live = key_live(top_x[j]);
    out_idx[j] = live ? key_index(top_x[j]) : 0;
    out_live[j] = live ? 1 : 0;
  }
  int cnt = 0;
  for (int m = 0; m < kc && cnt < kr; ++m) {
    if (!key_live(top_r[m])) continue;
    const int g = key_index(top_r[m]);
    bool taken = false;
    for (int j = 0; j < kx; ++j)
      taken |= key_live(top_x[j]) && key_index(top_x[j]) == g;
    if (taken) continue;
    out_idx[kx + cnt] = g;
    out_live[kx + cnt] = 1;
    ++cnt;
  }
  for (; cnt < kr; ++cnt) {
    out_idx[kx + cnt] = 0;
    out_live[kx + cnt] = 0;
  }
}

}  // namespace

extern "C" int rewafl_select_tile() { return TILE; }

extern "C" int rewafl_select_max_k() { return MAX_K; }

// scratch: n_blocks * (kx + kc) keys, n_blocks = ceil(S / TILE), kc = K when
// kr > 0 else 0. rnd is read only when kr > 0. Returns a cudaError_t.
extern "C" int rewafl_select(const float* stat, const float* t, const float* e,
                             const float* residual, const float* e0,
                             const unsigned char* avail, const float* rnd,
                             int S, int kx, int kr, float T_round, float alpha,
                             float beta, unsigned long long* scratch,
                             int* out_idx, int* out_live, void* stream) {
  const int K = kx + kr;
  if (S < 1 || kx < 0 || kr < 0 || K < 1 || K > MAX_K || K > S)
    return (int)cudaErrorInvalidValue;
  const int kc = kr > 0 ? K : 0;
  const int n_blocks = (S + TILE - 1) / TILE;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* cand_x = scratch;
  unsigned long long* cand_r = scratch + (size_t)n_blocks * kx;
  select_stage1<<<n_blocks, THREADS, 0, st>>>(stat, t, e, residual, e0, avail,
                                              rnd, S, kx, kc, T_round, alpha,
                                              beta, cand_x, cand_r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  select_stage2<<<1, THREADS, 0, st>>>(cand_x, cand_r, n_blocks, kx, kr, kc,
                                       out_idx, out_live);
  return (int)cudaGetLastError();
}
