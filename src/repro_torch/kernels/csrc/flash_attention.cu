// Flash-attention forward for Hopper (sm_90a): GQA, causal mask, sliding
// window, gemma2 logit softcap.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/flash_attention.py (body `_kernel`):
// o = softmax(mask(softcap(scale * q k^T))) v with the online-softmax state
// (m, l, acc) in f32, masked scores at -1e30, the denominator clamped at
// 1e-30, output in q's dtype. q (B, Sq, H, hd), k/v (B, Sk, n_kv, hd), f32
// or bf16; query head h reads KV head h / (H / n_kv) in place (no repeated
// KV in memory). Query i sits at position i and key j at position j, as in
// the TPU kernel; unlike it, Sq and Sk need not be multiples of the tile:
// the ragged last tiles are masked here.
//
// What bounds it on this card: operations. Causal prefill at B 4, S 2048,
// H 24, hd 128 is 4*B*H*hd*S^2/2 = 103 GFLOP against 0.2 GB of q/k/v/o, so
// the tensor cores' 989 TFLOP/s (0.10 ms) bound it, not the 3.35 TB/s
// (0.06 ms). This first version does not reach the tensor cores: it does
// every product as an f32 FMA on the CUDA cores (67 TFLOP/s peak, 1.5 ms
// at that shape) and reads its operands from shared memory, which caps it
// well below even that. mma.sync / wgmma, TMA loads and pipelining are
// later work.
//
// Design: one block of 256 threads per (q tile of 64 rows, head, batch)
// loops over KV tiles of 64 keys -- the loop takes the place of the TPU's
// sequential innermost grid axis. The scaled q tile (transposed, f32) stays
// in shared memory; each KV tile is converted to f32 into shared memory
// (k transposed, v row-major). A 16 x 16 thread grid computes the 64 x 64
// score tile as a register-blocked product (each thread 4 rows x 4 keys,
// float4 operand loads), applies softcap and masks, and updates the row
// state with warp shuffles over the 16 threads that share a row; P goes
// back to shared memory (over the k tile) and each thread accumulates 4
// rows x hd/16 output columns of P v. KV tiles that lie wholly above the
// causal diagonal or wholly outside the window are skipped: they would add
// exactly nothing. A q tile with a row that sees no key at all (possible
// only with a window, or Sq > Sk with a window) sweeps every key instead,
// so such a row gets the reference's answer (the mean of v over all keys).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per KV tile
constexpr int THREADS = 256;    // 16 x 16: ty owns 4 rows, tx 4 keys / columns
constexpr int PAD = 4;          // transposed tiles' row pad (keeps float4 alignment)
constexpr int LDQ = BQ + PAD;   // row stride of the q^T tile (and of P^T)
constexpr int LDK = BK + PAD;   // row stride of the k^T tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

struct Problem {
  int Sq, Sk, H, n_kv;
  float scale, softcap;     // softcap <= 0: none
  bool causal, has_window;
  long long window;
};

// Keys row q may attend to: [lo, hi], empty when lo > hi.
__device__ __forceinline__ void key_range(long long q, const Problem& p,
                                          long long& lo, long long& hi) {
  lo = 0;
  hi = (long long)p.Sk - 1;
  if (p.causal && q < hi) hi = q;
  if (p.has_window && q - p.window + 1 > lo) lo = q - p.window + 1;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Problem p) {
  constexpr int NC = HD / 64;   // float4 column groups of the output per thread
  extern __shared__ float4 smem4[];
  float* QT = reinterpret_cast<float*>(smem4);   // [HD][LDQ]  scaled q^T
  float* KT = QT + HD * LDQ;                     // [HD][LDK]  k^T; P^T [BK][LDQ]
  float* VS = KT + HD * LDK;                     // [BK][HD]
  float* PT = KT;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // heaviest causal tiles (the last rows) first
  const long long q0 = (long long)(gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, kvh = h / (p.H / p.n_kv);
  const long long b = blockIdx.z;
  const long long q_last = min(q0 + BQ, (long long)p.Sq) - 1;

  long long lo0, hi0, lo1, hi1, k_begin, k_end;
  key_range(q0, p, lo0, hi0);
  key_range(q_last, p, lo1, hi1);
  if (lo1 > hi1) {   // a row with no key: sweep them all, as the reference does
    k_begin = 0;
    k_end = p.Sk;
  } else {           // rows' ranges move right with q: first row's lo, last row's hi
    k_begin = lo0;
    k_end = hi1 + 1;
  }

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const long long qq = q0 + r;
    float x = 0.f;
    if (qq < p.Sq) x = to_f32(q[((b * p.Sq + qq) * p.H + h) * HD + d]) * p.scale;
    QT[d * LDQ + r] = x;
  }

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (long long k0 = k_begin / BK * BK; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's P^T and v are no longer read
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int c = i / HD, d = i % HD;
      const long long kk = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (kk < p.Sk) {
        const long long off = ((b * p.Sk + kk) * p.n_kv + kvh) * HD + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      KT[d * LDK + c] = kx;
      VS[c * HD + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(QT + d * LDQ + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(KT + d * LDK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long kpos = k0 + tx * 4 + j;
        float x = s[i][j];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        const long long dd = qpos - kpos;
        const bool keep = (!p.causal || dd >= 0) && (!p.has_window || dd < p.window);
        x = keep ? x : NEG;
        if (kpos >= p.Sk) x = -INFINITY;   // past the last key: weight exactly 0
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= corr;
    }

    __syncthreads();   // every thread is done with k^T: P^T goes over it
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(PT + (tx * 4 + j) * LDQ + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pp = *reinterpret_cast<const float4*>(PT + c * LDQ + ty * 4);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int g = 0; g < NC; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(VS + c * HD + g * 64 + tx * 4);
        const float vx[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][g * 4 + j] = fmaf(pv[i], vx[j], acc[i][g * 4 + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* out = o + ((b * p.Sq + row) * p.H + h) * HD;
#pragma unroll
    for (int g = 0; g < NC; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        from_f32(acc[i][g * 4 + j] / den, out + g * 64 + tx * 4 + j);
  }
}

template <typename T, int HD>
int launch_hd(const T* q, const T* k, const T* v, T* o, int B, const Problem& p,
              cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (HD * LDQ + HD * LDK + BK * HD);
  static bool attr_set[64] = {};   // per device; set before any graph capture
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  const dim3 grid((unsigned)((p.Sq + BQ - 1) / BQ), (unsigned)p.H, (unsigned)B);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(q, k, v, o, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int H, int n_kv, int hd, float scale, int causal,
           int has_window, long long window, float softcap, void* stream) {
  if (B < 0 || Sq < 0 || Sk < 0 || H <= 0 || n_kv <= 0 || H % n_kv != 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  const Problem p{Sq, Sk, H, n_kv, scale, softcap, causal != 0,
                  has_window != 0, window};
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 64) return launch_hd<T, 64>(qq, kk, vv, oo, B, p, st);
  if (hd == 128) return launch_hd<T, 128>(qq, kk, vv, oo, B, p, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, Sq, H, hd), k/v (B, Sk, n_kv, hd), o (B, Sq, H, hd), all contiguous;
// hd 64 or 128. has_window = 0: no window. softcap <= 0: none. Returns a
// cudaError_t.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Sk, int H,
                                   int n_kv, int hd, float scale, int causal,
                                   int has_window, long long window,
                                   float softcap, void* stream) {
  return launch<float>(q, k, v, o, B, Sq, Sk, H, n_kv, hd, scale, causal,
                       has_window, window, softcap, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, int B, int Sq, int Sk, int H,
                                    int n_kv, int hd, float scale, int causal,
                                    int has_window, long long window,
                                    float softcap, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, n_kv, hd, scale,
                               causal, has_window, window, softcap, stream);
}
