// sLSTM recurrence over T steps for Hopper (sm_90a): two kernels.
//
// Both replace the Pallas TPU kernel `slstm_scan` in
// src/repro/kernels/slstm/slstm.py (body `_kernel`): per step,
// pre = x_pre_t + h_{t-1} R (per head, R block-diagonal (NH, hd, 4hd), gate
// columns z, i, f, o within each head), then z = tanh, o = sigmoid,
// log f = log-sigmoid, the exponential input gate stabilised by m, and
// h = o c / max(n, 1e-6). Unlike the TPU kernel they start from a given
// state and return the final (h, c, n, m) in f32, which prefill hands to
// decode. Rounding follows the model's cell (`_slstm_cell` in
// src/repro/nn/xlstm.py): h_{t-1} is rounded to R's type before the product
// and the product, summed in f32, is rounded to R's type before it is added
// to x_pre in f32. With f32 weights both roundings are the identity (the
// TPU kernel's arithmetic).
//
// What bounds them on this card: not bytes or operations but the length of
// one step. At xlstm-1.3b's prefill (B 4, T 2048, NH 4, hd 512, bf16) one
// call moves 176 MB (x_pre 134 MB, h 34 MB, R 8.4 MB: 53 us at 3.35 TB/s)
// and does 68.7 GFLOP of h R (69 us at 989 TFLOP/s bf16), but its 2,048
// steps are sequential, each ending when every block of a head has h_t.
//
// bf16: `slstm_tc_kernel`, one thread-block cluster per head. Block rank r
// of a cluster of CL owns hidden units j0 = r J .. j0+J-1 (J = hd / CL),
// i.e. the 4J gate columns g*hd + j0 + jj. At hd 512: CL 16 (a non-portable
// cluster size), J 32, 128 of R's columns a block, 256 threads. What each
// part of the design takes off a step (the f32 kernel's step, run as bf16,
// took 6.1 us at xlstm-1.3b's prefill on an H100):
//   1. x_pre is not read on the step: a ring of NS = 8 steps in shared
//      memory is filled by cp.async; the copies for a slot are issued at the
//      end of the step after the one that read it, so they overlap the
//      exchange and no HBM latency is on a step's path;
//   2. h_{t-1} of the whole head, bf16, is already in the block's own
//      shared memory (the peers wrote it there, see 4): no L2 round trip;
//   3. the product runs on the tensor cores, transposed:
//      D[4J, B] = R^T[4J, hd] . h_{t-1}^T[hd, B] with mma.sync m16n8k16
//      (bf16 in, f32 sums); M the block's gate columns, N the batch padded
//      to 8 (two n8 tiles for B 9..16), K = hd. R^T is the A operand and
//      stays in registers for the whole call, loaded once into the
//      fragment layout (at hd 512: 8 m-tiles, one a warp, x 32 k-steps =
//      128 registers a thread; the kernel is templated on hd / 16 so that
//      every fragment index is a compile-time constant); h comes from
//      shared memory by ldmatrix, its rows padded by 16 bytes against bank
//      conflicts. 256 MMAs a block a step at hd 512, four independent
//      chains a warp, in place of ~2,000 shared-memory cycles of CUDA-core
//      FMAs;
//   4. the cell (the same f32 functions as the f32 kernel: tanhf, expf, the
//      stable log-sigmoid, no fast math) updates c, n, m in shared memory;
//      each warp sends its cells' h_t, bf16, as soon as it has them, in
//      16-byte st.async stores into the h buffer of every block of the
//      cluster (distributed shared memory), with no block barrier first;
//   5. no barrier ends the step: each block waits on its own mbarrier for
//      the bytes of the whole h_t (the `Exchange` below), in place of the
//      f32 kernel's counter barrier in device memory and of a cluster
//      barrier (measured slower: the stores' release and the barrier came
//      one after the other).
// Heads are independent, so the clusters need not be resident together.
// At hd 512, B 4: 29,200 bytes of shared memory a block (h buffers 16.6 KB,
// the x_pre ring 8 KB, products 2 KB, state 2 KB), 253 registers a thread
// (R's 128 among them; ptxas's count is printed by chip_smoke.py), one
// block an SM, 7 clusters of 16 resident at once on an H100. Measured and
// not kept (tools/slstm_tc/): wgmma m64n8k16 with R from registers, h in
// wgmma's core-matrix layout, cp.async.bulk sends, fewer or more chains.
//
// f32: `slstm_kernel`, for the reduced configurations: a persistent kernel,
// launched cooperatively so that every block is resident at once; block
// (head, j0) owns hidden units j0 .. j0+J-1 of one head, keeps that
// hd x 4J slice of R in shared memory for the whole call, and keeps the
// cell state (c, n, m, h) of its units in shared memory. Each step it
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int XPT = 4;     // x_pre values a thread prefetches: B * 4J <= 1024
constexpr int BT = 4;      // batch rows per register tile of the products
constexpr int MAX_B = 16;


struct Args {
  const float* x;    // (B, T, NH, 4hd) x_pre
  const float* r;    // (NH, hd, 4hd)
  float* out;        // (B, T, NH, hd) h
  float* hbuf;       // (2, B, NH, hd): h_{t-1} by step parity; [0] = initial h
  float* c;          // (B, NH, hd) each: the initial state in, the final out
  float* n;
  float* m;
  float* h_last;     // (B, NH, hd): the final h
  unsigned* bar;     // (NH,) arrival counters, zero at launch
  int B, T, NH, hd, J;
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

__host__ __device__ inline size_t smem_bytes(int B, int hd, int J) {
  const size_t bp = (size_t)(B + BT - 1) / BT * BT;
  return align16((size_t)hd * 4 * J * sizeof(float))   // R slice [hd][4J]
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

__global__ void __launch_bounds__(THREADS) slstm_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, T_len = a.T, NH = a.NH, hd = a.hd, J = a.J;
  const int C4 = 4 * J;             // gate columns of this block
  const int KS = THREADS / C4;      // threads per column
  const int nbh = hd / J;           // blocks per head
  const int head = blockIdx.x / nbh;
  const int j0 = (blockIdx.x % nbh) * J;
  const int tid = threadIdx.x;
  const float* x = a.x;
  const float* r = a.r;
  float* out = a.out;

  float* r_s = reinterpret_cast<float*>(smem);
  float* h_s = reinterpret_cast<float*>(smem + align16((size_t)hd * C4 * sizeof(float)));
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
        xv[i] = x[(((size_t)b * T_len + t) * NH + head) * 4 * hd + (size_t)g * hd + j0 +
                  jj];
      }
    }
    // 2. h_{t-1} of this head as [b/BT][d][b%BT]
    for (int e = tid; e < B * hd; e += THREADS) {
      const int b = e / hd, d = e % hd;
      h_s[((size_t)(b / BT) * hd + d) * BT + b % BT] =
          __ldcg(hin + ((size_t)b * NH + head) * hd + d);
    }
    __syncthreads();
    // 3. partial dot products over d0 .. d0+dl-1, BT rows at a time
    for (int b0 = 0; b0 < B; b0 += BT) {
      float acc[BT] = {0.f, 0.f, 0.f, 0.f};
      const float4* hv = reinterpret_cast<const float4*>(h_s + (size_t)b0 * hd);
      for (int d = d0; d < d0 + dl; ++d) {
        const float rv = r_s[d * C4 + col];
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
    // the partial sums in order, plus x_pre
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int e = tid + i * THREADS;
      if (e < B * C4) {
        const int b = e / C4, cc = e % C4;
        float s = 0.f;
        for (int k = 0; k < KS; ++k) s += part[((size_t)k * B + b) * C4 + cc];
        pre[e] = xv[i] + s;
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
      out[(((size_t)b * T_len + t) * NH + head) * hd + j0 + jj] = h;
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

int launch(const void* x, const void* r, void* out, void* hbuf, void* c,
           void* n, void* m, void* h_last, void* bar, int B, int T_len, int NH,
           int hd, int J, void* stream) {
  const int bad = check_shape(B, T_len, NH, hd, J);
  if (bad) return bad;
  Args a{static_cast<const float*>(x), static_cast<const float*>(r),
         static_cast<float*>(out), static_cast<float*>(hbuf), static_cast<float*>(c),
         static_cast<float*>(n), static_cast<float*>(m),
         static_cast<float*>(h_last), static_cast<unsigned*>(bar),
         B, T_len, NH, hd, J};
  static bool attr_set[64] = {};
  return coop_launch(slstm_kernel, attr_set, NH * (hd / J), smem_bytes(B, hd, J),
                     (cudaStream_t)stream, a);
}

}  // namespace

// x (B, T, NH, 4hd), r (NH, hd, 4hd), out (B, T, NH, hd) f32, all
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
  return launch(x, r, out, hbuf, c, n, m, h_last, bar, B, T, NH, hd, J, stream);
}

// The barrier loop alone on the grid and shared memory of an slstm_f32 call
// of the same shape: the recurrence's latency floor. bar (NH,) zeroed.
extern "C" int slstm_barrier_loop(void* bar, int B, int T, int NH, int hd,
                                  int J, void* stream) {
  const int bad = check_shape(B, T, NH, hd, J);
  if (bad) return bad;
  static bool attr_set[64] = {};
  return coop_launch(barrier_loop_kernel, attr_set, NH * (hd / J),
                     smem_bytes(B, hd, J),
                     (cudaStream_t)stream, static_cast<unsigned*>(bar), T,
                     hd / J);
}

// --------------------------------------------------------------------------
// bf16: one thread-block cluster per head, R in registers, h by distributed
// shared memory (the note at the top of this file).

namespace {
namespace tc {

// THREADS (256) and MAX_B (16: two n8 tiles) as for the f32 kernel
constexpr int WARPS = THREADS / 32;
constexpr int NS = 8;           // steps of x_pre in flight in the ring
constexpr int MAX_CL = 16;      // the largest (non-portable) cluster
constexpr int MAX_FRAGS = 32;   // A fragments a warp: 128 registers a thread
constexpr int NO_CLUSTER = -1;  // returned when no cluster of CL fits

struct Plan {
  int cl, j;
};

// The launch plan for head width hd: the smallest power-of-two cluster
// CL <= 16 whose J = hd / CL hidden units a block are a multiple of 8
// (16-byte runs of h and x_pre) and whose share of R^T a warp, ceil(J / 32)
// m-tiles x hd / 16 k-steps, is at most 32 fragments; {0, 0} when none
// fits. The wrapper's `tc_plan` computes the same.
__host__ __device__ constexpr Plan plan(int hd) {
  if (hd < 16 || hd % 16 != 0 || hd > 512) return {0, 0};
  for (int cl = 1; cl <= MAX_CL; cl *= 2) {
    if (hd % cl != 0) continue;
    const int j = hd / cl;
    if (j % 8 == 0 && (j + 31) / 32 * (hd / 16) <= MAX_FRAGS) return {cl, j};
  }
  return {0, 0};
}

// Shared memory of a block, byte offsets (all multiples of 16): from 0 the
// two h buffers [2][BP][hd + 8] bf16 (batch rows padded to BP = 8 or 16 and
// zero past B; each row padded by 16 bytes, so that ldmatrix's eight rows
// fall in distinct banks), then the x_pre ring [NS][B][4J] bf16, the
// products [B][4J] f32, the state c, n, m, h [B][J] f32, this block's h_t
// [B][J] bf16, and an mbarrier an h buffer.
struct Smem {
  size_t ring, pre, st, hloc, bar, total;
};
__host__ __device__ inline int pad_rows(int B) { return B > 8 ? 16 : 8; }
__host__ __device__ inline int hstride(int hd) { return hd + 8; }
__host__ __device__ inline Smem layout(int B, int hd, int J) {
  Smem s{};
  s.ring = (size_t)2 * pad_rows(B) * hstride(hd) * 2;
  s.pre = s.ring + (size_t)NS * B * 4 * J * 2;
  s.st = s.pre + (size_t)B * 4 * J * 4;
  s.hloc = s.st + (size_t)4 * B * J * 4;
  s.bar = s.hloc + (size_t)B * J * 2;
  s.total = s.bar + 16;
  return s;
}

struct Args {
  const __nv_bfloat16* x;   // (B, T, NH, 4hd) x_pre
  const __nv_bfloat16* r;   // (NH, hd, 4hd)
  __nv_bfloat16* out;       // (B, T, NH, hd) h
  const float* h0;          // (B, NH, hd) the initial h
  float* c;                 // (B, NH, hd) each: the initial state in, the final out
  float* n;
  float* m;
  float* h_last;            // (B, NH, hd) the final h
  int B, T, NH;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// every thread of every block of the cluster meets here
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}
// A wait that has not completed after ~9 s of clock traps: a lost exchange
// ends the kernel with an error instead of hanging the card.
constexpr long long WAIT_LIMIT = 1ll << 34;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > WAIT_LIMIT) __trap();
}
// 16 bytes into the shared memory of block `rank` of this cluster, at the
// offset that `local` has in this block's, counted in bytes on that block's
// mbarrier at the offset of `bar`
__device__ __forceinline__ void st_async(uint32_t local, uint32_t bar, uint32_t rank, uint4 v) {
  uint32_t dst, dbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(dst) : "r"(local), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(dbar) : "r"(bar), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];"
      :: "r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(dbar) : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&b)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t (&b)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(b[0]), "=r"(b[1]) : "r"(addr));
}
// d += a b: m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The exchange of h between the blocks of a cluster. Block rank r's h_t,
// B x J bf16, goes into h buffer (t + 1) & 1 of every block of the cluster
// (this one included) by st.async, each 16-byte store counted on the
// receiving block's mbarrier of that buffer, which expects the B x hd x 2
// bytes of the whole h_t: a block waits only for the data it reads, with
// no cluster-wide barrier. Two buffers are enough: a block writes h_{t+1}
// into a peer's buffer t & 1 only after receiving the peer's h_t, which the
// peer sends only after its step-t product has read h_{t-1} from that
// buffer (and after a barrier of its block). Each mbarrier completes a
// phase an h it receives; its next receipt can start only after every
// thread of the block has passed the wait for this one (the block's own
// h_{t+1} is part of it), so a phase parity is never waited on twice.
struct Exchange {
  uint32_t hbuf;        // shared address of h buffer 0; buffer 1 follows
  uint32_t buf_bytes;   // of one h buffer
  uint32_t bar;         // shared address of buffer 0's mbarrier; buffer 1's follows
  uint32_t bytes;       // the bytes of one h_t: B x hd x 2
  int BJ, J, j0, HS, CL;

  // thread 0, before the cluster barrier that precedes any exchange
  __device__ void init() const {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar, bytes);
    mbar_expect_tx(bar + 8, bytes);
  }
  // This warp's cells e_base .. e_base + 31 of step t, already in hloc, to
  // every block of the cluster: 4 runs of 8 units a destination
  __device__ void send(const __nv_bfloat16* hloc, int e_base, int t, int lane) const {
    const uint32_t x = (uint32_t)((t + 1) & 1);
    for (int q = lane; q < 4 * CL; q += 32) {
      const int e0 = e_base + (q & 3) * 8;
      if (e0 < BJ) {
        const int b = e0 / J, jj = e0 % J;
        st_async(hbuf + x * buf_bytes + (uint32_t)((b * HS + j0 + jj) * 2), bar + 8 * x,
                 (uint32_t)(q >> 2), *reinterpret_cast<const uint4*>(hloc + e0));
      }
    }
  }
  // every thread: wait for h_{t-1} (t >= 1) in buffer t & 1; then thread 0
  // expects the buffer's next receipt
  __device__ void wait(int t) const {
    const uint32_t b = bar + 8 * (uint32_t)(t & 1);
    mbar_wait(b, (uint32_t)((t - 1) >> 1) & 1u);
    if (threadIdx.x == 0) mbar_expect_tx(b, bytes);
  }
};

// This warp's products D[rows of its m-tiles, batch] = R^T h_{t-1}^T, summed
// in f32 and stored to pre[b][m] for b < B. NT n8 tiles of the batch; k-step
// s accumulates into chain s % CH, the chains are added in order.
template <int KS, int MPW, int CH, int NT>
__device__ __forceinline__ void products(uint32_t (&ra)[MPW][KS][4], uint32_t hin,
                                         uint32_t lrow, int first_mt, int MT, int B,
                                         int C4, float* pre) {
  constexpr int HS = 16 * KS + 8;
  float acc[MPW][NT][CH][4];
#pragma unroll
  for (int i = 0; i < MPW; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int ch = 0; ch < CH; ++ch)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][nt][ch][e] = 0.f;
#pragma unroll
  for (int s = 0; s < KS; s += 2) {
    uint32_t bf[NT][4];
    // ldmatrix: lane l addresses row l % 8 of the n-tile, k columns
    // s * 16 + 8 * (l / 8); x4 gives k-steps s and s + 1
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t addr = hin + lrow + (uint32_t)((nt * 8 * HS + s * 16) * 2);
      if (s + 1 < KS) ldsm_x4(addr, bf[nt]);
      else ldsm_x2(addr, bf[nt]);
    }
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      if (first_mt + i >= MT) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma(acc[i][nt][s % CH], ra[i][s], bf[nt][0], bf[nt][1]);
        if (s + 1 < KS) mma(acc[i][nt][(s + 1) % CH], ra[i][s + 1], bf[nt][2], bf[nt][3]);
      }
    }
  }
  const int lane = threadIdx.x % 32, g = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int i = 0; i < MPW; ++i) {
    if (first_mt + i >= MT) continue;
    const int m_lo = (first_mt + i) * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d[e] = acc[i][nt][0][e];
#pragma unroll
        for (int ch = 1; ch < CH; ++ch) d[e] += acc[i][nt][ch][e];
      }
      const int b = nt * 8 + 2 * cq;
      if (b < B) {
        pre[b * C4 + m_lo] = d[0];
        pre[b * C4 + m_lo + 8] = d[2];
      }
      if (b + 1 < B) {
        pre[(b + 1) * C4 + m_lo] = d[1];
        pre[(b + 1) * C4 + m_lo + 8] = d[3];
      }
    }
  }
}

template <int KS>
__global__ void __launch_bounds__(THREADS, 1) slstm_tc_kernel(Args a) {
  constexpr int HD = 16 * KS;
  constexpr Plan P = plan(HD);
  constexpr int CL = P.cl, J = P.j, C4 = 4 * J;
  constexpr int MT = C4 / 16;                       // m-tiles of the block
  constexpr int MPW = (MT + WARPS - 1) / WARPS;     // m-tiles a warp
  constexpr int CH = MPW >= 4 ? 1 : 4 / MPW;        // independent chains a tile
  constexpr int HS = HD + 8;
  constexpr int RUN = J / 8;                        // 16-byte chunks of a row of h
  static_assert(CL >= 1 && MPW * KS <= MAX_FRAGS, "no launch plan for this head width");
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, T_len = a.T, NH = a.NH;
  const int BP = pad_rows(B);
  const Smem L = layout(B, HD, J);
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + L.ring);
  float* pre = reinterpret_cast<float*>(smem + L.pre);
  float* st_c = reinterpret_cast<float*>(smem + L.st);
  float* st_n = st_c + B * J;
  float* st_m = st_n + B * J;
  float* st_h = st_m + B * J;
  __nv_bfloat16* hloc = reinterpret_cast<__nv_bfloat16*>(smem + L.hloc);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, cq = lane & 3;
  const int head = blockIdx.x / CL;
  const int j0 = (int)cluster_rank() * J;

  // R^T's A fragments, once: rows m = gate columns g'*J + jj of this block
  // (R's columns g'*hd + j0 + jj), k = hd
  uint32_t ra[MPW][KS][4];
  const unsigned short* rg =
      reinterpret_cast<const unsigned short*>(a.r) + (size_t)head * HD * 4 * HD;
#pragma unroll
  for (int i = 0; i < MPW; ++i) {
    const int mt = warp * MPW + i;
    const bool live = mt < MT;
    const int m_lo = mt * 16 + g, m_hi = m_lo + 8;
    const int col_lo = live ? (m_lo / J) * HD + j0 + m_lo % J : 0;
    const int col_hi = live ? (m_hi / J) * HD + j0 + m_hi % J : 0;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int k = s * 16 + 2 * cq;
      auto e = [&](int kk, int col) -> uint32_t {
        return live ? (uint32_t)rg[(size_t)kk * 4 * HD + col] : 0u;
      };
      ra[i][s][0] = e(k, col_lo) | e(k + 1, col_lo) << 16;
      ra[i][s][1] = e(k, col_hi) | e(k + 1, col_hi) << 16;
      ra[i][s][2] = e(k + 8, col_lo) | e(k + 9, col_lo) << 16;
      ra[i][s][3] = e(k + 8, col_hi) | e(k + 9, col_hi) << 16;
    }
  }
  // h buffer 0 holds h_{-1} of the head rounded to bf16; padding rows zero
  for (int e = tid; e < 2 * BP * HS; e += THREADS) {
    const int buf = e / (BP * HS), rr = e % (BP * HS), b = rr / HS, d = rr % HS;
    const float v = buf == 0 && b < B && d < HD ? a.h0[((size_t)b * NH + head) * HD + d] : 0.f;
    hbuf[e] = __float2bfloat16_rn(v);
  }
  // the state of this block's units; thread tid owns items tid, tid + 256, ...
  for (int e = tid; e < B * J; e += THREADS) {
    const size_t gi = ((size_t)(e / J) * NH + head) * HD + j0 + e % J;
    st_c[e] = a.c[gi];
    st_n[e] = a.n[gi];
    st_m[e] = a.m[gi];
    st_h[e] = a.h0[gi];
  }
  // x_pre of step t into ring slot t % NS, one commit group a step (empty
  // past the end, so that the count of groups stays one a step)
  auto prefetch = [&](int t) {
    if (t < T_len) {
      __nv_bfloat16* slot = ring + (size_t)(t % NS) * B * C4;
      for (int q = tid; q < B * C4 / 8; q += THREADS) {
        const int b = q / (C4 / 8), rr = q % (C4 / 8), gate = rr / RUN, ch = rr % RUN;
        cp_async16(smem_u32(slot + b * C4 + gate * J + ch * 8),
                   a.x + (((size_t)b * T_len + t) * NH + head) * 4 * HD + gate * HD + j0 +
                       ch * 8);
      }
    }
    cp_async_commit();
  };
  const Exchange ex{smem_u32(hbuf), (uint32_t)(BP * HS * 2), smem_u32(smem + L.bar),
                    (uint32_t)(B * HD * 2), B * J, J, j0, HS, CL};
  if (tid == 0) ex.init();
  for (int t = 0; t < NS; ++t) prefetch(t);
  // every block of the cluster has started and set up its buffers and
  // mbarriers before any block writes into them
  cluster_sync();

  const uint32_t lrow = (uint32_t)(((lane & 7) * HS + (lane >> 3) * 8) * 2);
  for (int t = 0; t < T_len; ++t) {
    if (t > 0) ex.wait(t);
    if (warp * MPW < MT) {
      const uint32_t hin = ex.hbuf + (uint32_t)(t & 1) * ex.buf_bytes;
      if (B > 8) products<KS, MPW, CH, 2>(ra, hin, lrow, warp * MPW, MT, B, C4, pre);
      else products<KS, MPW, CH, 1>(ra, hin, lrow, warp * MPW, MT, B, C4, pre);
    }
    cp_async_wait<NS - 2>();   // this thread's copies of step t have landed
    __syncthreads();
    // the cell, in f32, the product rounded to bf16 first; a warp takes
    // cells e_base .. e_base + 31 and sends their h as soon as it has them
    const __nv_bfloat16* xs = ring + (size_t)(t % NS) * B * C4;
    for (int e_base = warp * 32; e_base < B * J; e_base += THREADS) {
      const int e = e_base + lane;
      if (e < B * J) {
        const int b = e / J, jj = e % J;
        const float* p = pre + b * C4;
        const __nv_bfloat16* xb = xs + b * C4;
        const float zp = __bfloat162float(xb[jj]) + round_bf16(p[jj]);
        const float ip = __bfloat162float(xb[J + jj]) + round_bf16(p[J + jj]);
        const float fp = __bfloat162float(xb[2 * J + jj]) + round_bf16(p[2 * J + jj]);
        const float op = __bfloat162float(xb[3 * J + jj]) + round_bf16(p[3 * J + jj]);
        const float zt = tanhf(zp);
        const float ot = 1.f / (1.f + expf(-op));
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
        const __nv_bfloat16 hb = __float2bfloat16_rn(h);
        hloc[e] = hb;
        a.out[(((size_t)b * T_len + t) * NH + head) * HD + j0 + jj] = hb;
      }
      if (t + 1 < T_len) {
        __syncwarp();
        ex.send(hloc, e_base, t, lane);
      }
    }
    // every cell of step t - 1 is done (its h came in with this step's
    // wait), so its ring slot takes step t - 1 + NS; issued here, the copies
    // overlap the exchange
    if (t > 0) prefetch(t - 1 + NS);
  }
  cp_async_wait<0>();
  for (int e = tid; e < B * J; e += THREADS) {
    const size_t gi = ((size_t)(e / J) * NH + head) * HD + j0 + e % J;
    a.c[gi] = st_c[e];
    a.n[gi] = st_n[e];
    a.m[gi] = st_m[e];
    a.h_last[gi] = st_h[e];
  }
}

// The step's exchange alone, T - 1 times, on the clusters and shared memory
// of an slstm_tc call of the same shape: each warp that holds cells sends
// them to every block of its cluster, and every thread waits for the whole
// h. The recurrence's latency floor.
__global__ void __launch_bounds__(THREADS, 1)
exchange_loop_kernel(int B, int T_len, int hd, int J, int CL) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = layout(B, hd, J);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int HS = hstride(hd);
  __nv_bfloat16* hloc = reinterpret_cast<__nv_bfloat16*>(smem + L.hloc);
  for (int e = tid; e < B * J; e += THREADS) hloc[e] = __float2bfloat16_rn(0.f);
  const Exchange ex{smem_u32(smem), (uint32_t)(pad_rows(B) * HS * 2), smem_u32(smem + L.bar),
                    (uint32_t)(B * hd * 2), B * J, J, (int)cluster_rank() * J, HS, CL};
  if (tid == 0) ex.init();
  cluster_sync();
  for (int t = 0; t < T_len; ++t) {
    if (t > 0) ex.wait(t);
    if (t + 1 < T_len)
      for (int e_base = warp * 32; e_base < B * J; e_base += THREADS)
        ex.send(hloc, e_base, t, lane);
  }
}

// Configure `kernel` for clusters of `cl` blocks with `smem` bytes each
// (once per device: before any graph capture), and count how many such
// clusters the card can hold at once (`*n_clusters`). NO_CLUSTER if none.
template <typename Kernel>
int cluster_config(Kernel kernel, bool (&attr_set)[64], int cl, int blocks, size_t smem,
                   cudaStream_t stream, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                   int* n_clusters) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return (int)err;
  if (smem > (size_t)optin) return NO_CLUSTER;
  if (!attr_set[dev]) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    optin)) ||
        (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                    1)))
      return (int)err;
    attr_set[dev] = true;
  }
  *cfg = {};
  cfg->gridDim = dim3((unsigned)blocks);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(n_clusters, kernel, cfg);
  if (err != cudaSuccess) return (int)err;
  return *n_clusters >= 1 ? (int)cudaSuccess : NO_CLUSTER;
}

int check_tc_shape(int B, int T_len, int NH, int hd, int CL, int J) {
  const Plan p = plan(hd);
  if (B < 1 || B > MAX_B || T_len < 0 || NH < 1 || p.cl == 0) return (int)cudaErrorInvalidValue;
  if (CL != p.cl || J != p.j) return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// kind 0: launch the recurrence; 1: launch the exchange loop; 2: only count
// the clusters that fit (`*n_clusters`)
template <int KS>
int tc_run(int kind, const Args& a, int hd, int CL, int J, cudaStream_t stream,
           int* n_clusters) {
  if constexpr (plan(16 * KS).cl == 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    static bool attr_set[64] = {}, loop_attr_set[64] = {};
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    const size_t smem = layout(a.B, hd, J).total;
    int n = 0;
    int err = kind == 1
                  ? cluster_config(exchange_loop_kernel, loop_attr_set, CL, a.NH * CL, smem,
                                   stream, &cfg, attr, &n)
                  : cluster_config(slstm_tc_kernel<KS>, attr_set, CL, a.NH * CL, smem, stream,
                                   &cfg, attr, &n);
    if (n_clusters) *n_clusters = n;
    if (err || kind == 2) return err;
    cudaError_t e = kind == 1
                        ? cudaLaunchKernelEx(&cfg, exchange_loop_kernel, a.B, a.T, hd, J, CL)
                        : cudaLaunchKernelEx(&cfg, slstm_tc_kernel<KS>, a);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
}

template <int KS = 1>
int tc_dispatch(int kind, const Args& a, int hd, int CL, int J, cudaStream_t stream,
                int* n_clusters) {
  if constexpr (KS > 32) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (hd == 16 * KS) return tc_run<KS>(kind, a, hd, CL, J, stream, n_clusters);
    return tc_dispatch<KS + 1>(kind, a, hd, CL, J, stream, n_clusters);
  }
}

}  // namespace tc
}  // namespace

// bf16 x (B, T, NH, 4hd) with a 16-byte-aligned base, r (NH, hd, 4hd), out
// (B, T, NH, hd), all contiguous; h0, c, n, m (B, NH, hd) f32, the initial
// state (c, n, m overwritten with the final one); h_last (B, NH, hd) f32.
// CL, J: the launch plan (`tc::plan`, the wrapper's `tc_plan`), checked
// here; 1 <= B <= 16. Returns a cudaError_t, or -1 when not one cluster of
// CL blocks fits on the card.
extern "C" int slstm_tc(const void* x, const void* r, void* out, const void* h0, void* c,
                        void* n, void* m, void* h_last, int B, int T, int NH, int hd,
                        int CL, int J, void* stream) {
  const int bad = tc::check_tc_shape(B, T, NH, hd, CL, J);
  if (bad) return bad;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0) return (int)cudaErrorInvalidValue;
  tc::Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(r),
             static_cast<__nv_bfloat16*>(out), static_cast<const float*>(h0),
             static_cast<float*>(c), static_cast<float*>(n), static_cast<float*>(m),
             static_cast<float*>(h_last), B, T, NH};
  return tc::tc_dispatch(0, a, hd, CL, J, (cudaStream_t)stream, nullptr);
}

// The exchange and cluster barrier of an slstm_tc call of that shape alone,
// T - 1 times: the bf16 recurrence's latency floor.
extern "C" int slstm_tc_exchange_loop(int B, int T, int NH, int hd, int CL, int J,
                                      void* stream) {
  const int bad = tc::check_tc_shape(B, T, NH, hd, CL, J);
  if (bad) return bad;
  tc::Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, B, T, NH};
  return tc::tc_dispatch(1, a, hd, CL, J, (cudaStream_t)stream, nullptr);
}

// cudaOccupancyMaxActiveClusters for slstm_tc at that shape, into *n.
extern "C" int slstm_tc_max_clusters(int B, int NH, int hd, int CL, int J, int* n) {
  const int bad = tc::check_tc_shape(B, 1, NH, hd, CL, J);
  if (bad) return bad;
  tc::Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, B, 1, NH};
  const int err = tc::tc_dispatch(2, a, hd, CL, J, nullptr, n);
  return err == tc::NO_CLUSTER ? 0 : err;
}
