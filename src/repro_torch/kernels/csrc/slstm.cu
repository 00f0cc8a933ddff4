// sLSTM recurrence over T steps for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `slstm_scan` in
// src/repro/kernels/slstm/slstm.py (body `_kernel`): per step,
// pre = x_pre_t + h_{t-1} R (per head, R block-diagonal (NH, hd, 4hd), gate
// columns z, i, f, o within each head), then z = tanh, o = sigmoid,
// log f = log-sigmoid, the exponential input gate stabilised by m, and
// h = o c / max(n, 1e-6). Unlike the TPU kernel it starts from a given state
// and returns the final (h, c, n, m) in f32, which prefill hands to decode.
// Rounding follows the model's cell (`_slstm_cell` in src/repro/nn/xlstm.py):
// h_{t-1} is rounded to R's type before the product and the product, summed
// in f32, is rounded to R's type before it is added to x_pre in f32. With
// f32 weights both roundings are the identity (the TPU kernel's arithmetic).
//
// What bounds it on this card: operations, by a little. At xlstm-1.3b's
// prefill (B 4, T 2048, NH 4, hd 512, bf16) one call moves 176 MB
// (x_pre 134 MB, h 34 MB, R 8.4 MB: 53 us at 3.35 TB/s) and does 68.7 GFLOP
// of h R (69 us at 989 TFLOP/s bf16). It also has a latency floor that the
// bound does not count: T sequential steps, each ending in a barrier across
// the blocks of a head.
//
// Design: R (8.4 MB at full width) does not fit one SM's 227 KB, so the
// heads are split across blocks. A persistent kernel, launched
// cooperatively so that every block is resident at once; block (head, j0)
// owns hidden units j0 .. j0+J-1 of one head, i.e. the 4J gate columns
// g*hd + j0 + jj, keeps that hd x 4J slice of R in shared memory for the
// whole call, and keeps the cell state (c, n, m, h) of its units in shared
// memory. Each step it
//   1. prefetches its x_pre values into registers,
//   2. reads h_{t-1} of its head, all B rows, from a double-buffered f32
//      array in device memory (L2-resident: B x hd x 4 bytes per head),
//   3. forms its B x 4J dot products of length hd: 256 threads, KS =
//      256 / 4J of them per column each summing hd / KS terms for 4 batch
//      rows at a time, then the KS partial sums in a fixed order,
//   4. updates the cell and writes h_t to the output (x_pre's type) and to
//      the f32 buffer,
//   5. waits at a barrier of the blocks of its head (a counter per head in
//      device memory): only they read the h it wrote.
// The products are f32 FMAs on the CUDA cores with operands from shared
// memory, and the step is one barrier long at least, so this first version
// is far from its bound; tensor-core products and fewer, larger steps are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int XPT = 4;     // x_pre values a thread prefetches: B * 4J <= 1024
constexpr int BT = 4;      // batch rows per register tile of the products
constexpr int MAX_B = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}
// round an f32 value to T's precision and back
__device__ __forceinline__ float rnd(float v, const float*) { return v; }
__device__ __forceinline__ float rnd(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Args {
  const void* x;     // (B, T, NH, 4hd) x_pre
  const void* r;     // (NH, hd, 4hd)
  void* out;         // (B, T, NH, hd) h, in x_pre's type
  float* hbuf;       // (2, B, NH, hd): h_{t-1} by step parity; [0] = initial h
  float* c;          // (B, NH, hd) each: the initial state in, the final out
  float* n;
  float* m;
  float* h_last;     // (B, NH, hd): the final h
  unsigned* bar;     // (NH,) arrival counters, zero at launch
  int B, T, NH, hd, J;
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

__host__ __device__ inline size_t smem_bytes(int B, int hd, int J, size_t elem) {
  const size_t bp = (size_t)(B + BT - 1) / BT * BT;
  return align16((size_t)hd * 4 * J * elem)        // R slice [hd][4J]
         + bp * hd * sizeof(float)                 // h_{t-1} [B/BT][hd][BT]
         + (size_t)THREADS * B * sizeof(float)     // partial sums [KS][B][4J]
         + (size_t)B * 4 * J * sizeof(float)       // pre-activations [B][4J]
         + (size_t)4 * B * J * sizeof(float);      // c, n, m, h [B][J]
}

// Every block of one head arrives once per step; wait until all `target`
// arrivals of this step are in. The fences order each block's h writes
// before its arrival and the other blocks' reads after theirs.
__device__ __forceinline__ void head_barrier(unsigned* ctr, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1u);
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(v) : "l"(ctr) : "memory");
    } while (v < target);
    __threadfence();
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS) slstm_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, T_len = a.T, NH = a.NH, hd = a.hd, J = a.J;
  const int C4 = 4 * J;             // gate columns of this block
  const int KS = THREADS / C4;      // threads per column
  const int nbh = hd / J;           // blocks per head
  const int head = blockIdx.x / nbh;
  const int j0 = (blockIdx.x % nbh) * J;
  const int tid = threadIdx.x;
  const T* x = static_cast<const T*>(a.x);
  const T* r = static_cast<const T*>(a.r);
  T* out = static_cast<T*>(a.out);

  T* r_s = reinterpret_cast<T*>(smem);
  float* h_s = reinterpret_cast<float*>(smem + align16((size_t)hd * C4 * sizeof(T)));
  const int BP = (B + BT - 1) / BT * BT;
  float* part = h_s + (size_t)BP * hd;
  float* pre = part + (size_t)THREADS * B;
  float* st_c = pre + B * C4;
  float* st_n = st_c + B * J;
  float* st_m = st_n + B * J;
  float* st_h = st_m + B * J;

  // R slice: r_s[d][g*J + jj] = r[head][d][g*hd + j0 + jj]
  for (int e = tid; e < hd * C4; e += THREADS) {
    const int d = e / C4, col = e % C4, g = col / J, jj = col % J;
    r_s[e] = r[((size_t)head * hd + d) * 4 * hd + (size_t)g * hd + j0 + jj];
  }
  // padded batch rows of h_s stay zero
  for (int e = tid; e < (BP - B) * hd; e += THREADS) {
    const int b = B + e / hd, d = e % hd;
    h_s[((size_t)(b / BT) * hd + d) * BT + b % BT] = 0.f;
  }
  // the initial state; thread tid owns items tid, tid + 256, ... throughout
  for (int e = tid; e < B * J; e += THREADS) {
    const size_t gi = ((size_t)(e / J) * NH + head) * hd + j0 + e % J;
    st_c[e] = a.c[gi];
    st_n[e] = a.n[gi];
    st_m[e] = a.m[gi];
    st_h[e] = a.hbuf[gi];
  }

  const int col = tid % C4, ks = tid / C4;
  const int dl = hd / KS;
  const int d0 = ks * dl;
  const size_t hstride = (size_t)B * NH * hd;
  for (int t = 0; t < T_len; ++t) {
    const float* hin = a.hbuf + (size_t)(t & 1) * hstride;
    float* hout = a.hbuf + (size_t)((t + 1) & 1) * hstride;
    // 1. this step's x_pre values, element e = b * 4J + col
    float xv[XPT];
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int e = tid + i * THREADS;
      xv[i] = 0.f;
      if (e < B * C4) {
        const int b = e / C4, cc = e % C4, g = cc / J, jj = cc % J;
        xv[i] = to_f32(x[(((size_t)b * T_len + t) * NH + head) * 4 * hd +
                         (size_t)g * hd + j0 + jj]);
      }
    }
    // 2. h_{t-1} of this head, rounded to R's type, as [b/BT][d][b%BT]
    for (int e = tid; e < B * hd; e += THREADS) {
      const int b = e / hd, d = e % hd;
      h_s[((size_t)(b / BT) * hd + d) * BT + b % BT] =
          rnd(__ldcg(hin + ((size_t)b * NH + head) * hd + d), r_s);
    }
    __syncthreads();
    // 3. partial dot products over d0 .. d0+dl-1, BT rows at a time
    for (int b0 = 0; b0 < B; b0 += BT) {
      float acc[BT] = {0.f, 0.f, 0.f, 0.f};
      const float4* hv = reinterpret_cast<const float4*>(h_s + (size_t)b0 * hd);
      for (int d = d0; d < d0 + dl; ++d) {
        const float rv = to_f32(r_s[d * C4 + col]);
        const float4 h4 = hv[d];
        acc[0] = fmaf(h4.x, rv, acc[0]);
        acc[1] = fmaf(h4.y, rv, acc[1]);
        acc[2] = fmaf(h4.z, rv, acc[2]);
        acc[3] = fmaf(h4.w, rv, acc[3]);
      }
#pragma unroll
      for (int bb = 0; bb < BT; ++bb)
        if (b0 + bb < B) part[((size_t)ks * B + b0 + bb) * C4 + col] = acc[bb];
    }
    __syncthreads();
    // the partial sums in order, rounded to R's type, plus x_pre
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int e = tid + i * THREADS;
      if (e < B * C4) {
        const int b = e / C4, cc = e % C4;
        float s = 0.f;
        for (int k = 0; k < KS; ++k) s += part[((size_t)k * B + b) * C4 + cc];
        pre[e] = xv[i] + rnd(s, r_s);
      }
    }
    __syncthreads();
    // 4. the cell
    for (int e = tid; e < B * J; e += THREADS) {
      const int b = e / J, jj = e % J;
      const float* p = pre + b * C4;
      const float zt = tanhf(p[jj]);
      const float ip = p[J + jj], fp = p[2 * J + jj];
      const float ot = 1.f / (1.f + expf(-p[3 * J + jj]));
      const float logf_ = fminf(fp, 0.f) - log1pf(expf(-fabsf(fp)));
      const float m = st_m[e];
      const float m_new = fmaxf(logf_ + m, ip);
      const float fw = expf(logf_ + m - m_new);
      const float iw = expf(ip - m_new);
      const float c = fw * st_c[e] + iw * zt;
      const float n = fw * st_n[e] + iw;
      const float h = ot * c / fmaxf(n, 1e-6f);
      st_c[e] = c;
      st_n[e] = n;
      st_m[e] = m_new;
      st_h[e] = h;
      __stcg(hout + ((size_t)b * NH + head) * hd + j0 + jj, h);
      from_f32(h, out + (((size_t)b * T_len + t) * NH + head) * hd + j0 + jj);
    }
    // 5. the other blocks of this head read this step's h next step
    if (t + 1 < T_len) head_barrier(a.bar + head, (unsigned)(t + 1) * nbh);
  }
  for (int e = tid; e < B * J; e += THREADS) {
    const size_t gi = ((size_t)(e / J) * NH + head) * hd + j0 + e % J;
    a.c[gi] = st_c[e];
    a.n[gi] = st_n[e];
    a.m[gi] = st_m[e];
    a.h_last[gi] = st_h[e];
  }
}

// The barrier alone, T - 1 times, on the same grid: the latency floor of
// the recurrence.
__global__ void __launch_bounds__(THREADS)
barrier_loop_kernel(unsigned* bar, int T_len, int nbh) {
  const int head = blockIdx.x / nbh;
  for (int t = 0; t + 1 < T_len; ++t)
    head_barrier(bar + head, (unsigned)(t + 1) * nbh);
}

// Shape checks shared by both entries; returns a cudaError_t.
int check_shape(int B, int T_len, int NH, int hd, int J) {
  if (B < 1 || B > MAX_B || T_len < 0 || NH < 1 || hd < 1) return (int)cudaErrorInvalidValue;
  if (J < 1 || J > THREADS / 4 || (THREADS / 4) % J != 0) return (int)cudaErrorInvalidValue;
  if (hd % J != 0 || hd % (THREADS / (4 * J)) != 0) return (int)cudaErrorInvalidValue;
  if (B * 4 * J > THREADS * XPT) return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// Launch `kernel` cooperatively on NH * hd / J blocks, after checking that
// they can all be resident (cudaErrorCooperativeLaunchTooLarge if not).
// `attr_set` is the caller's per-device flag for `kernel`'s shared-memory
// limit, so that it is set once, before any graph capture.
template <typename Kernel, typename... A>
int coop_launch(Kernel kernel, bool (&attr_set)[64], int blocks, size_t smem,
                cudaStream_t stream, A... args) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
      (err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if ((long long)per_sm * sms < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* r, void* out, void* hbuf, void* c,
           void* n, void* m, void* h_last, void* bar, int B, int T_len, int NH,
           int hd, int J, void* stream) {
  const int bad = check_shape(B, T_len, NH, hd, J);
  if (bad) return bad;
  Args a{x, r, out, static_cast<float*>(hbuf), static_cast<float*>(c),
         static_cast<float*>(n), static_cast<float*>(m),
         static_cast<float*>(h_last), static_cast<unsigned*>(bar),
         B, T_len, NH, hd, J};
  static bool attr_set[64] = {};
  return coop_launch(slstm_kernel<T>, attr_set, NH * (hd / J),
                     smem_bytes(B, hd, J, sizeof(T)), (cudaStream_t)stream, a);
}

}  // namespace

// x (B, T, NH, 4hd), r (NH, hd, 4hd), out (B, T, NH, hd) of one type, all
// contiguous; hbuf (2, B, NH, hd) f32 with the initial h in hbuf[0]; c, n, m
// (B, NH, hd) f32, the initial state, overwritten with the final one;
// h_last (B, NH, hd) f32; bar (NH,) zeroed 32-bit counters. J hidden units
// per block: a power of two <= 64 that divides hd, with 64 / J dividing hd
// and B * J <= 256; 1 <= B <= 16. Returns a cudaError_t:
// cudaErrorCooperativeLaunchTooLarge when the NH * hd / J blocks cannot all
// be resident.
extern "C" int slstm_f32(const void* x, const void* r, void* out, void* hbuf,
                         void* c, void* n, void* m, void* h_last, void* bar,
                         int B, int T, int NH, int hd, int J, void* stream) {
  return launch<float>(x, r, out, hbuf, c, n, m, h_last, bar, B, T, NH, hd, J,
                       stream);
}

extern "C" int slstm_bf16(const void* x, const void* r, void* out, void* hbuf,
                          void* c, void* n, void* m, void* h_last, void* bar,
                          int B, int T, int NH, int hd, int J, void* stream) {
  return launch<__nv_bfloat16>(x, r, out, hbuf, c, n, m, h_last, bar, B, T, NH,
                               hd, J, stream);
}

// The barrier loop alone on the grid and shared memory of an slstm call of
// the same shape (elem_size 4 for f32, 2 for bf16): the recurrence's
// latency floor. bar (NH,) zeroed.
extern "C" int slstm_barrier_loop(void* bar, int B, int T, int NH, int hd,
                                  int J, int elem_size, void* stream) {
  const int bad = check_shape(B, T, NH, hd, J);
  if (bad) return bad;
  static bool attr_set[64] = {};
  return coop_launch(barrier_loop_kernel, attr_set, NH * (hd / J),
                     smem_bytes(B, hd, J, (size_t)elem_size),
                     (cudaStream_t)stream, static_cast<unsigned*>(bar), T,
                     hd / J);
}
