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
