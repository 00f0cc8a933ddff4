// Statistical utility |B_i| * sqrt(max(mean_k loss[i, k]^2, 0)) for Hopper
// (sm_90a): the first factor of the REWAFL utility (Eqn 2).
//
// Replaces the Pallas TPU kernel `stat_utility_blocked` in
// src/repro/kernels/stat_util/stat_util.py (body `_kernel`): per row of an
// (S, n) block of per-sample losses (f32 or bf16), square and sum in f32,
// divide by n, clamp at 0, take the square root and scale by sizes[row]
// (f32); output (S,) f32.
//
// What bounds it on this card: bytes, and at the FL round's shape (K 20 x
// probe 32 f32, 2.7 KB) not even those: one launch is all that is left. Off
// the path, at S = 1e6 x n = 32 f32, it reads 128 MB and writes 4 MB (40 us
// at 3.35 TB/s) for 3 flops a loss.
//
// Design: one warp per row; the lanes stride over the row (a warp reads 32
// consecutive losses at a time), sum their squares in f32 and combine by
// shuffles; lane 0 writes the row's utility. Rows may have a padded stride
// `ld`. No shared memory: every loss is used once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = THREADS / 32;   // rows per block, one per warp

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
stat_util_kernel(const T* __restrict__ losses, long long ld,
                 const float* __restrict__ sizes, float* __restrict__ out,
                 long long S, int n) {
  const long long row = (long long)blockIdx.x * ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= S) return;
  const T* l = losses + row * ld;
  float s = 0.f;
  for (int k = lane; k < n; k += 32) {
    const float v = to_f32(l[k]);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[row] = sizes[row] * sqrtf(fmaxf(s / (float)n, 0.f));
}

template <typename T>
int launch(const void* losses, long long ld, const void* sizes, void* out,
           long long S, int n, void* stream) {
  if (S < 0 || n < 1 || (S > 1 && ld < n)) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  const long long blocks = (S + ROWS - 1) / ROWS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  stat_util_kernel<T><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(losses), ld, static_cast<const float*>(sizes),
      static_cast<float*>(out), S, n);
  return (int)cudaGetLastError();
}

}  // namespace

// losses: S rows of n values, row stride ld (elements); sizes (S,) f32;
// out (S,) f32. Returns a cudaError_t.
extern "C" int stat_util_f32(const void* losses, long long ld, const void* sizes,
                             void* out, long long S, int n, void* stream) {
  return launch<float>(losses, ld, sizes, out, S, n, stream);
}

extern "C" int stat_util_bf16(const void* losses, long long ld,
                              const void* sizes, void* out, long long S, int n,
                              void* stream) {
  return launch<__nv_bfloat16>(losses, ld, sizes, out, S, n, stream);
}
