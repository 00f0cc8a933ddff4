// Weighted FedAvg aggregation out[p] = sum_k w[k] * x[k, p], for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `weighted_aggregate_flat` in
// src/repro/kernels/fedavg/fedavg.py (body `_kernel`): f32 accumulation,
// output in x's dtype, x f32 or bf16.
//
// What bounds it on the card: bytes. It reads K*P elements once and
// writes P, doing 2 flops per element read — at K = 20, P = 206,922 f32
// that is (K+1)*P*4 = 17.4 MB, about 5.2 us at 3.35 TB/s, against 8.3
// MFLOP (0.12 us at 67 TFLOP/s f32).
//
// Design: one thread per 4 consecutive parameters, threads along P so a
// warp reads 512 contiguous bytes of each row; each thread loops over the
// K rows with an f32 fused multiply-add per element (the sum order is k =
// 0..K-1). Rows may have a padded stride `ld`: when ld is a multiple of 4
// and both x and out are aligned, each thread moves its 4 elements with
// one vector load (16 B f32, 8 B bf16) per row and one vector store; any
// other layout, and the ragged tail of P, takes scalar loads. No shared
// memory: every element is used once, so there is nothing to reuse.
//
// Batched: C independent aggregations (a campaign grid's cells; C = 1
// for one) in one launch, out[c, p] = sum_k w[c, k] * x[c, k, p], with
// cell c's rows at x + c * cld and a second grid dimension over the
// cells. Each cell's sum runs in the same order as a launch of that cell
// alone, so the results are bitwise equal.
//
// fedavg_indexed: the FedAvg of K rows picked by index from an (S, P)
// stack, as `select_aggregate` needs it after the selection kernel
// (replaces the gather, the weight arithmetic and the mask ops around
// `weighted_aggregate_flat` in src/repro/kernels/rewafl_select/ops.py
// `select_aggregate`, lines 170-176). Given (K,) idx and live flags (dead
// slots are index 0, live 0) and (S,) weights:
//   w_k = weights[idx_k] * (live_k > 0), wn_k = w_k / max(sum_k w_k, 1e-9),
//   out[p] = sum_k wn_k * x[idx_k * ld + p]  (f32, k = 0..K-1, fmaf),
//   mask[i] = (some live slot holds i),
// op for op as the reference: the sum of the weights runs in slot order,
// NaN propagates through the max, a dead slot reads row 0 at weight 0
// (so a non-finite row 0 gives NaN where the reference's does).
//
// What bounds it: bytes, K * P elements read in place and P f32 written,
// the same as fedavg_kernel's; no K-row copy is made. Each block loads
// the slots (at most KT at a time) and their weights into shared memory,
// thread 0 sums the weights in slot order, and every thread then reads A
// consecutive parameters of each selected row with one load (A = 2 when
// ld and the base are even: 8-byte f32 loads, P / 2 threads; else 1),
// UNROLL rows' loads issued together. Measured on the H100 (PERF.md §6):
// two parameters a thread beat four, with 8-byte loads and with 16-byte
// ones on rows whose stride allows them (more warps, fewer registers),
// and beat one; neither a cap on the grid, nor a second batch in flight,
// nor 256 threads a block helped. Block b also owns a contiguous share
// of the (S,) mask: it zeroes it, then marks the live slots that fall in
// it.
//
// The kernel first waits on the grid it depends on (griddepcontrol.wait,
// a no-op when it was launched without programmatic serialization), so
// it can be launched while the selection kernel that writes idx and live
// is still running.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;   // parameters per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void load4(const float* p, float v[VEC]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[VEC]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[VEC]) {
  uint2 q;
  *reinterpret_cast<__nv_bfloat162*>(&q.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&q.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = q;
}

template <typename T, bool VECTORISED>
__global__ void __launch_bounds__(THREADS)
fedavg_kernel(const T* __restrict__ x, long long ld, long long cld,
              const float* __restrict__ w, T* __restrict__ out, int K,
              long long P) {
  const long long p0 =
      ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (p0 >= P) return;
  x += (long long)blockIdx.y * cld;   // this cell's rows, weights, output
  w += (long long)blockIdx.y * K;
  out += (long long)blockIdx.y * P;
  float acc[VEC] = {0.f, 0.f, 0.f, 0.f};
  if (VECTORISED && p0 + VEC <= P) {
    for (int k = 0; k < K; ++k) {
      const float wk = __ldg(w + k);
      float v[VEC];
      load4(x + k * ld + p0, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = fmaf(wk, v[j], acc[j]);
    }
    store4(out + p0, acc);
    return;
  }
  const int n = (int)min((long long)VEC, P - p0);
  for (int k = 0; k < K; ++k) {
    const float wk = __ldg(w + k);
    const T* row = x + k * ld + p0;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (j < n) acc[j] = fmaf(wk, to_f32(row[j]), acc[j]);
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    if (j < n) from_f32(acc[j], out + p0 + j);
}

template <typename T>
int launch(const T* x, long long ld, long long cld, const float* w, T* out,
           int C, int K, long long P, void* stream) {
  if (C < 0 || C > 65535 || K < 0 || P < 0 || (K > 1 && ld < P) ||
      (C > 1 && cld < (long long)(K > 0 ? K - 1 : 0) * ld + P))
    return (int)cudaErrorInvalidValue;
  if (P == 0 || C == 0) return (int)cudaSuccess;
  const long long threads = (P + VEC - 1) / VEC;
  const dim3 blocks((unsigned int)((threads + THREADS - 1) / THREADS), C);
  const uintptr_t align = VEC * sizeof(T);
  // every row, and every cell's output, must start aligned
  const bool vec = ld % VEC == 0 && (uintptr_t)x % align == 0 &&
                   (uintptr_t)out % align == 0 &&
                   (C == 1 || (cld % VEC == 0 && P % VEC == 0));
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    fedavg_kernel<T, true><<<blocks, THREADS, 0, st>>>(x, ld, cld, w, out, K, P);
  else
    fedavg_kernel<T, false><<<blocks, THREADS, 0, st>>>(x, ld, cld, w, out, K,
                                                        P);
  return (int)cudaGetLastError();
}

constexpr int IX_THREADS = 128;
constexpr int KT = 1024;    // slots a block holds in shared memory at a time
constexpr int UNROLL = 8;   // rows a batch: their loads are issued together

// A consecutive elements at p (A in {2, 1}: one 8- or 4-byte f32 load, 4
// or 2 bytes of bf16), to f32
template <int A>
__device__ __forceinline__ void loadv(const float* p, float* v) {
  if constexpr (A == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = *p;
  }
}
template <int A>
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float* v) {
  if constexpr (A == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// slots c..c+n-1 into shared memory: row offsets and raw weights; marks
// the live ones that fall in this block's mask share [m0, m1)
__device__ __forceinline__ void load_slots(
    const int* __restrict__ idx, const int* __restrict__ live,
    const float* __restrict__ weights, long long ld, int c, int n,
    long long* s_off, float* s_w, unsigned char* mask, int m0, int m1) {
  for (int j = threadIdx.x; j < n; j += IX_THREADS) {
    const int i = idx[c + j];
    const bool l = live[c + j] > 0;
    s_off[j] = (long long)i * ld;
    s_w[j] = weights[i] * (l ? 1.f : 0.f);
    if (mask != nullptr && l && i >= m0 && i < m1) mask[i] = 1;
  }
}

// A thread takes A consecutive parameters (one load a row).
template <typename T, int A>
__global__ void __launch_bounds__(IX_THREADS)
fedavg_indexed_kernel(const T* __restrict__ x, long long ld,
                      const int* __restrict__ idx, const int* __restrict__ live,
                      const float* __restrict__ weights, float* __restrict__ out,
                      unsigned char* __restrict__ mask, int K, long long P,
                      int S) {
  __shared__ long long s_off[KT];
  __shared__ float s_w[KT];
  __shared__ float s_den;
  // idx and live are the output of the kernel this one may overlap
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int per_m = (S + (int)gridDim.x - 1) / (int)gridDim.x;
  const int m0 = min(S, (int)blockIdx.x * per_m), m1 = min(S, m0 + per_m);
  for (int i = m0 + (int)threadIdx.x; i < m1; i += IX_THREADS) mask[i] = 0;
  // pass 1: the weights' sum in slot order, and the mask
  float sum = 0.f;
  for (int c = 0; c < K; c += KT) {
    const int n = min(KT, K - c);
    __syncthreads();   // the mask share is zeroed; the last chunk is summed
    load_slots(idx, live, weights, ld, c, n, s_off, s_w, mask, m0, m1);
    __syncthreads();
    if (threadIdx.x == 0)
      for (int j = 0; j < n; ++j) sum += s_w[j];
  }
  if (threadIdx.x == 0) s_den = isnan(sum) ? sum : fmaxf(sum, 1e-9f);
  // pass 2: out[p] = sum_k wn_k * x[off_k + p], in slot order; above KT
  // slots each chunk of slots continues the sums kept in out
  const long long p0 = ((long long)blockIdx.x * IX_THREADS + threadIdx.x) * A;
  const int nv = p0 < P ? (int)min((long long)A, P - p0) : 0;
  for (int c = 0; c < K; c += KT) {
    const int n = min(KT, K - c);
    __syncthreads();   // s_den written; the last chunk is consumed
    if (K > KT)        // else the one chunk is still in shared memory
      load_slots(idx, live, weights, ld, c, n, s_off, s_w, nullptr, 0, 0);
    __syncthreads();
    const float den = s_den;
    for (int j = threadIdx.x; j < n; j += IX_THREADS) s_w[j] = s_w[j] / den;
    __syncthreads();
    float acc[A];
#pragma unroll
    for (int j = 0; j < A; ++j) acc[j] = (c > 0 && j < nv) ? out[p0 + j] : 0.f;
    if (nv == A) {
      // UNROLL rows' loads issued together, then their FMAs in slot order;
      // the last batch is predicated
      for (int k = 0; k < n; k += UNROLL) {
        float v[UNROLL][A];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (k + u < n) loadv<A>(x + s_off[k + u] + p0, v[u]);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (k + u < n) {
            const float wk = s_w[k + u];
#pragma unroll
            for (int j = 0; j < A; ++j) acc[j] = fmaf(wk, v[u][j], acc[j]);
          }
        }
      }
      if constexpr (A == 2) {
        *reinterpret_cast<float2*>(out + p0) = make_float2(acc[0], acc[1]);
      } else {
        out[p0] = acc[0];
      }
    } else if (nv > 0) {   // the ragged tail of P
      for (int k = 0; k < n; ++k) {
        const T* row = x + s_off[k] + p0;
        const float wk = s_w[k];
#pragma unroll
        for (int j = 0; j < A; ++j)
          if (j < nv) acc[j] = fmaf(wk, to_f32(row[j]), acc[j]);
      }
#pragma unroll
      for (int j = 0; j < A; ++j)
        if (j < nv) out[p0 + j] = acc[j];
    }
  }
}

template <typename T, int A>
int launch_indexed_as(const T* x, long long ld, const int* idx,
                      const int* live, const float* weights, float* out,
                      unsigned char* mask, int K, long long P, int S, int pdl,
                      cudaStream_t st) {
  long long blocks = ((P + A - 1) / A + IX_THREADS - 1) / IX_THREADS;
  if (blocks < 1) blocks = 1;   // the mask is written whatever P is
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)blocks);
  cfg.blockDim = dim3(IX_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = pdl ? 1 : 0;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, fedavg_indexed_kernel<T, A>, x, ld, idx,
                                 live, weights, out, mask, K, P, S);
}

template <typename T>
int launch_indexed(const T* x, long long ld, const int* idx, const int* live,
                   const float* weights, float* out, unsigned char* mask,
                   int K, long long P, int S, int pdl, void* stream) {
  if (K < 1 || P < 0 || S < 1 || (S > 1 && ld < P) ||
      (uintptr_t)out % (2 * sizeof(float)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (ld % 2 == 0 && (uintptr_t)x % (2 * sizeof(T)) == 0)
    return launch_indexed_as<T, 2>(x, ld, idx, live, weights, out, mask, K, P,
                                   S, pdl, st);
  return launch_indexed_as<T, 1>(x, ld, idx, live, weights, out, mask, K, P, S,
                                 pdl, st);
}

}  // namespace

// C cells, cell c's K rows of P elements at x + c * cld, row stride ld
// (elements); w (C, K) f32 contiguous; out (C, P) contiguous; C <= 65535.
// Returns a cudaError_t.
extern "C" int fedavg_f32(const void* x, long long ld, long long cld,
                          const void* w, void* out, int C, int K, long long P,
                          void* stream) {
  return launch(static_cast<const float*>(x), ld, cld,
                static_cast<const float*>(w), static_cast<float*>(out), C, K,
                P, stream);
}

extern "C" int fedavg_bf16(const void* x, long long ld, long long cld,
                           const void* w, void* out, int C, int K, long long P,
                           void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(x), ld, cld,
                static_cast<const float*>(w), static_cast<__nv_bfloat16*>(out),
                C, K, P, stream);
}

// The aggregate of the K rows idx[0..K) (live flags `live`, dead slots
// index 0) of an (S, P) stack x with row stride ld (elements), weighted by
// weights[idx] normalised over the live slots: out (P,) f32, 16-byte
// aligned; mask (S,) bytes, 1 where a live slot holds the row. pdl != 0
// launches with programmatic stream serialization: the kernel may start
// while the previous kernel on the stream (the selection) runs, and waits
// for it before it reads idx. Returns a cudaError_t.
extern "C" int fedavg_indexed_f32(const void* x, long long ld, const void* idx,
                                  const void* live, const void* weights,
                                  void* out, void* mask, int K, long long P,
                                  int S, int pdl, void* stream) {
  return launch_indexed(static_cast<const float*>(x), ld,
                        static_cast<const int*>(idx),
                        static_cast<const int*>(live),
                        static_cast<const float*>(weights),
                        static_cast<float*>(out),
                        static_cast<unsigned char*>(mask), K, P, S, pdl, stream);
}

extern "C" int fedavg_indexed_bf16(const void* x, long long ld, const void* idx,
                                   const void* live, const void* weights,
                                   void* out, void* mask, int K, long long P,
                                   int S, int pdl, void* stream) {
  return launch_indexed(static_cast<const __nv_bfloat16*>(x), ld,
                        static_cast<const int*>(idx),
                        static_cast<const int*>(live),
                        static_cast<const float*>(weights),
                        static_cast<float*>(out),
                        static_cast<unsigned char*>(mask), K, P, S, pdl, stream);
}
