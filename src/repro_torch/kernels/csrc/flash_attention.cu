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
// the ragged last tiles are masked here. A q tile with a row that sees no
// key at all (possible only with a window) sweeps every key, so such a row
// gets the reference's answer, the mean of v over all keys. Key tiles that
// lie wholly above the causal diagonal or outside the window are skipped:
// they would add exactly nothing.
//
// Head widths 64, 112 and 128. Both kernels lay tiles out in 64-wide hd
// boxes; hd 112 (zamba2-7b's shared attention) runs in the layout for 128
// with the columns past 112 zero: they add nothing to q k^T, give zero
// output columns, and are never written to o.
//
// Two kernels, chosen by dtype:
//
// bf16: `flash_fwd_tc_kernel`, on the tensor cores. What bounds it:
// operations. The llama3.2-3b prefill layer (B 4, S 2048, H 24, n_kv 8,
// hd 128, causal) is 4*B*H*hd*S(S+1)/2 = 103.1 GFLOP against 0.2 GB of
// q/k/v/o: 0.104 ms at 989 TFLOP/s against 0.06 ms at 3.35 TB/s.
// The plain version computes p.v in f32, as the Pallas kernel does, and
// the kernel is held to it at one bf16 step (|d| <= 2^-7 |plain| + 1e-5)
// element by element. Rounding p to bf16 for a single tensor-core product
// breaks that on ~10% of outputs (sums of p.v that cancel); so p is split
// into p_hi = bf16(p) and p_lo = bf16(p - p_hi) and both products go into
// the same f32 accumulator, which leaves p exact to ~2^-17. That issues
// 1.5x the function's operations (154.6 GFLOP at that shape, a 0.156 ms
// floor). Design, one CTA of 384 threads per (128-row q tile, head,
// batch), heaviest causal tiles first:
//   - warpgroup 0 is the producer: one thread issues TMA loads (Q once,
//     then K and V tiles of 64 keys through a ring of 4 stages, with full
//     barriers for K and for V and an empty barrier a stage), and the
//     warpgroup gives its registers back (setmaxnreg);
//   - warpgroups 1 and 2 each own 64 query rows: S = Q K^T by wgmma
//     (m64n64k16, both operands from shared memory, 128-byte swizzle);
//     scale, softcap and masks on S in registers (masks only on tiles
//     that cross the diagonal, the window's edge or the last key); row max
//     and sum over the quad of threads that hold a row; then
//     O += P_hi V + P_lo V by wgmma with P from registers (the S
//     accumulator's layout is the A operand's) and V from shared memory as
//     an MN-major operand, one m64n64k16 per 64-wide hd box. The loop is
//     software-pipelined: S of tile t is issued before P V of tile t - 1,
//     and the softmax of t runs while that product does;
//   - the epilogue stages O in the warpgroup's Q buffer and writes it with
//     a TMA store;
//   - tensor maps view q and o as (hd, H, Sq, B) and k/v as
//     (hd, n_kv, Sk, B) with their real strides; TMA zero-fills the rows
//     past Sq or Sk on load and drops them on store.
// Measured on the H100 (PERF.md), what holds it is the consumers'
// instruction stream around the products (the softmax and the split),
// not the tensor cores: without any P V product it is barely faster.
// ptxas holds the consumers to the launch bound's 168 registers, which
// caps the key tile at 64.
//
// f32: `flash_fwd_kernel`, on the CUDA cores (f32 FMAs from shared
// memory; tensor cores could meet its atol 1e-5 only through a three-way
// split). One block of 256 threads per (64-row q tile, head, batch) loops
// over 64-key tiles; a 16 x 16 thread grid computes each 64 x 64 score
// tile as a register-blocked product, P goes through shared memory and
// each thread accumulates 4 rows x hd/16 output columns of P v. It serves
// the reduced configurations, not the full-width path.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;

// Keys row q may attend to: [lo, hi], empty when lo > hi. The rows whose
// range is empty are a suffix of the rows, so a tile's last row tells.
__device__ __forceinline__ void key_range(long long q, int Sk, bool causal,
                                          bool has_window, long long window,
                                          long long& lo, long long& hi) {
  lo = 0;
  hi = (long long)Sk - 1;
  if (causal && q < hi) hi = q;
  if (has_window && q - window + 1 > lo) lo = q - window + 1;
}

// ------------------------------------------------------------------ f32

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per KV tile
constexpr int THREADS = 256;    // 16 x 16: ty owns 4 rows, tx 4 keys / columns
constexpr int PAD = 4;          // transposed tiles' row pad (keeps float4 alignment)
constexpr int LDQ = BQ + PAD;   // row stride of the q^T tile (and of P^T)
constexpr int LDK = BK + PAD;   // row stride of the k^T tile

struct Problem {
  int Sq, Sk, H, n_kv;
  int hd;                   // the true head width, <= HD: the rows' stride
  float scale, softcap;     // softcap <= 0: none
  bool causal, has_window;
  long long window;
};

// HD: the tiles' width (64 or 128); the columns past p.hd stay zero.
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, Problem p) {
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
  key_range(q0, p.Sk, p.causal, p.has_window, p.window, lo0, hi0);
  key_range(q_last, p.Sk, p.causal, p.has_window, p.window, lo1, hi1);
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
    if (qq < p.Sq && d < p.hd) x = q[((b * p.Sq + qq) * p.H + h) * p.hd + d] * p.scale;
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
      if (kk < p.Sk && d < p.hd) {
        const long long off = ((b * p.Sk + kk) * p.n_kv + kvh) * p.hd + d;
        kx = k[off];
        vx = v[off];
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
    float* out = o + ((b * p.Sq + row) * p.H + h) * p.hd;
#pragma unroll
    for (int g = 0; g < NC; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = g * 64 + tx * 4 + j;
        if (col < p.hd) out[col] = acc[i][g * 4 + j] / den;
      }
  }
}

// Sets a kernel's dynamic shared-memory limit once per device (before any
// graph capture, where the first call is made eagerly).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int HD>
int launch_f32_hd(const float* q, const float* k, const float* v, float* o, int B,
                  const Problem& p, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (HD * LDQ + HD * LDK + BK * HD);
  static bool attr_set[64] = {};
  cudaError_t err = allow_smem(flash_fwd_kernel<HD>, smem, attr_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p.Sq + BQ - 1) / BQ), (unsigned)p.H, (unsigned)B);
  flash_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(q, k, v, o, p);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- bf16

constexpr int TC_BQ = 128;              // query rows per CTA: 64 per consumer warpgroup
// Keys per K/V tile. The consumers get 168 registers (ptxas holds them to
// the launch bound whatever setmaxnreg asks): O (hd/2), S and P_hi/P_lo of
// two tiles (BK/2 each) fit at BK 64 and spill at 128.
constexpr int TC_BK = 64;
constexpr int TC_NST = 4;               // stages of the K/V ring
constexpr int TC_THREADS = 384;         // producer warpgroup + 2 consumer warpgroups
constexpr int ROW_BYTES = 128;          // one swizzled smem row: 64 bf16 of hd
constexpr int Q_BOX_BYTES = 64 * ROW_BYTES;        // 64 q rows x 64 of hd
constexpr float LOG2E = 1.4426950408889634f;
// A barrier wait this long (cycles, ~9 s) is a fault: trap rather than hang.
constexpr long long WAIT_LIMIT = 1LL << 34;

struct TcProblem {
  int B, Sq, Sk, H, n_kv;
  float scale, softcap;     // softcap <= 0: none
  int causal, has_window;
  int window;               // clamped to [-Sk, Sq]: the same masks, in 32 bits
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > WAIT_LIMIT) __trap();
}

// One box of a 4-D tensor map into shared memory; completion is counted in
// bytes on `bar`. Coordinates innermost first; out-of-bounds parts are zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// One box from shared memory to a 4-D tensor map (out-of-bounds parts are
// not written); completion is tracked by the bulk-async group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: rows of
// 128 bytes, 8-row groups `sbo` bytes apart; `lbo` is the stride between
// 64-element blocks along MN for an MN-major operand (unused for K-major).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>   // until at most N committed groups are pending
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void pin(float (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(r[i]);
}
template <int N, int M>
__device__ __forceinline__ void pin(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x 64, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q K^T for one K tile, issued (the caller commits and waits): hd/16
// products of k16, four in each 64-wide hd box, 32 bytes apart in its rows.
template <int HD, int N>
__device__ __forceinline__ void issue_qk(float (&sc)[N], uint32_t q_smem, uint32_t k_smem) {
  constexpr int BK = 2 * N;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss(sc, sw128_desc(q_smem + (kk / 4) * Q_BOX_BYTES + off, 16, 1024),
             sw128_desc(k_smem + (kk / 4) * BK * ROW_BYTES + off, 16, 1024), kk > 0);
  }
}

// O += P_hi V + P_lo V for one V tile, issued: V is an MN-major operand
// (keys x hd, hd contiguous), one product for each 64-wide hd box; a k16
// slice is 16 rows, 2048 bytes on.
template <int NB, int NK>
__device__ __forceinline__ void issue_pv(float (&acc)[NB][32], const uint32_t (&p_hi)[NK][4],
                                         const uint32_t (&p_lo)[NK][4], uint32_t v_smem) {
  constexpr int BK = 16 * NK;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const uint64_t dv =
          sw128_desc(v_smem + j * BK * ROW_BYTES + kk * 16 * ROW_BYTES, BK * ROW_BYTES, 1024);
      wgmma_rs(acc[j], p_hi[kk], dv);
      wgmma_rs(acc[j], p_lo[kk], dv);
    }
}

// One tile of the online softmax, in place: scores -> weights. Scores are
// taken to base 2 (scale * log2 e folded into one product; the softcap,
// where there is one, on the natural-unit score first), masked, then
// m (the running row maximum, base 2) moves and the weights are
// 2^(x - m). corr is each row's rescale of what came before. A tile with
// no mask and no softcap takes the product inside the exponent's FMA: the
// row maximum of the raw scores times the scale is the maximum of the
// scaled ones (rounding is monotonic and the scale positive).
template <int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const TcProblem& p,
                                             bool need_mask, int k0, const int (&row)[2],
                                             int quad) {
  const float scale_log2 = p.scale * LOG2E;
  const bool plain = !need_mask && !(p.softcap > 0.f);
  if (!plain) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      float x = p.softcap > 0.f ? p.softcap * tanhf(sc[e] * p.scale / p.softcap) * LOG2E
                                : sc[e] * scale_log2;
      if (need_mask) {
        const int kpos = k0 + 8 * (e / 4) + 2 * quad + (e % 2);
        const int d = row[(e / 2) % 2] - kpos;
        const bool keep = (!p.causal || d >= 0) && (!p.has_window || d < p.window);
        x = keep ? x : NEG;
        if (kpos >= p.Sk) x = -INFINITY;   // past the last key: weight exactly 0
      }
      sc[e] = x;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < N / 4; ++c)
      mx = fmaxf(mx, fmaxf(sc[4 * c + 2 * i], sc[4 * c + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));   // the quad holds the row
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (plain) mx *= scale_log2;
    const float m_new = fmaxf(m[i], mx);
    corr[i] = exp2_approx(m[i] - m_new);
    m[i] = m_new;
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < N / 4; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * c + 2 * i + j;
        sc[e] = exp2_approx(plain ? fmaf(sc[e], scale_log2, -m_new) : sc[e] - m_new);
        rs += sc[e];
      }
    l[i] = l[i] * corr[i] + rs;   // this thread's part; the quad sums at the end
  }
}

// P as the A operand of k16 slice kk: registers 8kk..8kk+7 of S, in pairs,
// split into hi = bf16(p) and lo = bf16(p - hi).
template <int N>
__device__ __forceinline__ void split_p(const float (&sc)[N], uint32_t (&p_hi)[N / 8][4],
                                        uint32_t (&p_lo)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      p_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
      p_lo[kk][r] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
    }
}

// Shared memory, from a 1024-byte-aligned base (the 128-byte swizzle repeats
// every 1024 bytes and the wgmma descriptors assume that phase): Q as
// [warpgroup][hd/64][64 rows][128 B], then K and V each as
// [stage][hd/64][BK rows][128 B], then the barriers.
template <int HD>
struct TcLayout {
  static constexpr int NB = HD / 64;                        // 64-wide hd boxes
  static constexpr int BK = TC_BK;
  static constexpr int KV_BOX = BK * ROW_BYTES;             // BK keys x 64 of hd
  static constexpr int Q = 0;
  static constexpr int K = Q + 2 * NB * Q_BOX_BYTES;
  static constexpr int V = K + TC_NST * NB * KV_BOX;
  static constexpr int BAR = V + TC_NST * NB * KV_BOX;
  static constexpr int BYTES = BAR + 8 * (3 * TC_NST + 1) + 1024;   // + alignment
};

template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_o, TcProblem p, int n_qt) {
  using L = TcLayout<HD>;
  constexpr int NB = L::NB, BK = L::BK, KV_BOX_BYTES = L::KV_BOX;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_full_k = base + L::BAR;               // [TC_NST]
  const uint32_t bar_full_v = bar_full_k + 8 * TC_NST;     // [TC_NST]
  const uint32_t bar_empty = bar_full_v + 8 * TC_NST;      // [TC_NST]
  const uint32_t bar_q = bar_empty + 8 * TC_NST;

  // the q tile is the slowest index, so every head's heaviest causal
  // tiles (the last rows) start first; the heads of a KV group are neighbours
  const int tile_rank = blockIdx.x / (p.H * p.B), hb = blockIdx.x % (p.H * p.B);
  const int h = hb % p.H, b = hb / p.H, kvh = h / (p.H / p.n_kv);
  const int q0 = (n_qt - 1 - tile_rank) * TC_BQ;
  const int q_last = min(q0 + TC_BQ, p.Sq) - 1;

  long long lo0, hi0, lo1, hi1;
  key_range(q0, p.Sk, p.causal, p.has_window, p.window, lo0, hi0);
  key_range(q_last, p.Sk, p.causal, p.has_window, p.window, lo1, hi1);
  const bool sweep = lo1 > hi1;   // a row with no key: every key, masked
  // otherwise the rows' ranges move right with q: first row's lo, last row's hi
  const int k_begin = sweep ? 0 : (int)(lo0 / BK) * BK;
  const int k_end = sweep ? p.Sk : (int)hi1 + 1;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_NST; ++s) {
      mbar_init(bar_full_k + 8 * s, 1);
      mbar_init(bar_full_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);   // one arrival per consumer warp
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // warp-uniform as ptxas can prove it (a broadcast from lane 0), so the
  // role branches below are compiled as uniform
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x != 0) return;
    mbar_expect_tx(bar_q, 2 * NB * Q_BOX_BYTES);
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int j = 0; j < NB; ++j)
        tma_load(base + L::Q + (w * NB + j) * Q_BOX_BYTES, &tm_q, bar_q, 64 * j, h,
                 q0 + 64 * w, b);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % TC_NST;
      const int k0 = k_begin + t * BK;
      // the consumers' release of this stage's previous use (the first
      // use's wait, on parity 1, passes at once)
      mbar_wait(bar_empty + 8 * s, ((t / TC_NST) & 1) ^ 1);
      mbar_expect_tx(bar_full_k + 8 * s, NB * KV_BOX_BYTES);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        tma_load(base + L::K + (s * NB + j) * KV_BOX_BYTES, &tm_k, bar_full_k + 8 * s,
                 64 * j, kvh, k0, b);
      mbar_expect_tx(bar_full_v + 8 * s, NB * KV_BOX_BYTES);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        tma_load(base + L::V + (s * NB + j) * KV_BOX_BYTES, &tm_v, bar_full_v + 8 * s,
                 64 * j, kvh, k0, b);
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int cw = wg - 1;                     // this warpgroup's 64 rows
  const int lt = threadIdx.x % 128;
  const int warp = lt / 32, lane = lt % 32, quad = lane % 4;
  const int r_first = q0 + 64 * cw;          // the warpgroup's first row
  const int r_last = min(r_first + 63, p.Sq - 1);
  // this thread's rows (accumulator registers 4c + 2i + j hold row
  // row[i], column 8c + 2 quad + j)
  const int row[2] = {r_first + 16 * warp + lane / 4, r_first + 16 * warp + lane / 4 + 8};
  const uint32_t q_smem = base + L::Q + cw * NB * Q_BOX_BYTES;
  auto stage = [](int t) { return t % TC_NST; };
  auto parity = [](int t) { return (uint32_t)((t / TC_NST) & 1); };
  auto k_smem = [&](int t) { return base + L::K + stage(t) * NB * KV_BOX_BYTES; };
  auto v_smem = [&](int t) { return base + L::V + stage(t) * NB * KV_BOX_BYTES; };
  auto release = [&](int t) {   // this warp is done with tile t's stage
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * stage(t));
  };
  // a tile the warpgroup does not use is still waited for in full before
  // it is released: the CTA must not exit with a copy into it in flight
  auto pass = [&](int t) {
    mbar_wait(bar_full_k + 8 * stage(t), parity(t));
    mbar_wait(bar_full_v + 8 * stage(t), parity(t));
    release(t);
  };
  // a tile no row of this warpgroup sees adds exactly nothing
  auto unseen = [&](int t) {
    const int k0 = k_begin + t * BK;
    return !sweep && ((p.causal && k0 > r_last) ||
                      (p.has_window && r_first - (k0 + BK - 1) >= p.window));
  };
  auto need_mask = [&](int t) {
    const int k0 = k_begin + t * BK;
    return sweep || k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > r_first) ||
           (p.has_window && r_last - k0 >= p.window);
  };

  // the warpgroup's own tiles [t_lo, t_hi]; the unseen ones around them
  // (above the diagonal, before the window) it only passes on
  int t_lo = 0, t_hi = n_tiles - 1;
  if (r_first >= p.Sq) t_lo = n_tiles;       // no row of this warpgroup exists
  while (t_lo <= t_hi && unseen(t_lo)) ++t_lo;
  while (t_hi >= t_lo && unseen(t_hi)) --t_hi;

  float acc[NB][32];   // O, one accumulator for each 64-wide hd box
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, corr[2];

  mbar_wait(bar_q, 0);
  for (int t = 0; t < t_lo; ++t) pass(t);
  if (t_lo <= t_hi) {
    // Software pipeline: S of tile t is computed while P V of tile t - 1
    // runs, and the softmax of tile t while that product finishes.
    float sc[BK / 2];
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
    mbar_wait(bar_full_k + 8 * stage(t_lo), parity(t_lo));
    wgmma_fence();
    issue_qk<HD>(sc, q_smem, k_smem(t_lo));
    wgmma_commit();
    wgmma_wait<0>();
    pin(sc);
    softmax_tile(sc, m, l, corr, p, need_mask(t_lo), k_begin + t_lo * BK, row, quad);
    split_p(sc, p_hi, p_lo);
    for (int t = t_lo + 1; t <= t_hi; ++t) {
      mbar_wait(bar_full_k + 8 * stage(t), parity(t));
      pin(p_hi);
      pin(p_lo);
      pin(acc);
      wgmma_fence();
      issue_qk<HD>(sc, q_smem, k_smem(t));
      wgmma_commit();
      mbar_wait(bar_full_v + 8 * stage(t - 1), parity(t - 1));
      issue_pv(acc, p_hi, p_lo, v_smem(t - 1));
      wgmma_commit();
      wgmma_wait<1>();   // S of tile t is in
      pin(sc);
      softmax_tile(sc, m, l, corr, p, need_mask(t), k_begin + t * BK, row, quad);
      uint32_t n_hi[BK / 16][4], n_lo[BK / 16][4];
      split_p(sc, n_hi, n_lo);
      wgmma_wait<0>();   // P V of tile t - 1 is in
      pin(acc);
      pin(p_hi);
      pin(p_lo);
      release(t - 1);
      // O of the tiles before t, rescaled to tile t's row maxima (skipped
      // by a warp whose maxima did not move)
      if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[j][e] *= corr[(e / 2) % 2];
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          p_hi[kk][c] = n_hi[kk][c];
          p_lo[kk][c] = n_lo[kk][c];
        }
    }
    mbar_wait(bar_full_v + 8 * stage(t_hi), parity(t_hi));
    pin(p_hi);
    pin(p_lo);
    pin(acc);
    wgmma_fence();
    issue_pv(acc, p_hi, p_lo, v_smem(t_hi));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    pin(p_hi);
    pin(p_lo);
    release(t_hi);
  }
  for (int t = t_hi + 1; t < n_tiles; ++t) pass(t);
  if (r_first >= p.Sq) return;

  // epilogue: O / max(l, 1e-30) rounded to bf16, staged in this
  // warpgroup's Q buffer (no product reads it any more) in the layout of a
  // 128-byte-swizzled box, then written by TMA, which drops rows past Sq
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float den = fmaxf(l[i], 1e-30f);
    const int r = row[i] - r_first;          // the row in the box
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint32_t at = q_smem + j * Q_BOX_BYTES + r * ROW_BYTES +
                            ((c ^ (r & 7)) * 16) + 4 * quad;
        st_shared(at, pack_bf16(acc[j][4 * c + 2 * i] / den, acc[j][4 * c + 2 * i + 1] / den));
      }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");   // visible to TMA
  asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");    // the warpgroup's rows
  if (lt == 0) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_store(&tm_o, q_smem + j * Q_BOX_BYTES, 64 * j, h, r_first, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");   // before smem goes
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A (hd, heads, S, B) view of a contiguous (B, S, heads, hd) bf16 tensor,
// read in boxes of 64 of hd x `rows` positions, 128-byte swizzled.
bool encode_view(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int hd, int heads,
                 int S, int B, int rows) {
  const cuuint64_t dim[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S,
                             (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dim, stride,
             box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// HD: the layout's width (64 or 128); the tensor maps take the true hd, so
// TMA loads zeros into the columns past it and the store drops them.
template <int HD>
int launch_tc_hd(const void* q, const void* k, const void* v, void* o, int hd,
                 const TcProblem& p, cudaStream_t stream) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv, to;
  if (!encode_view(enc, &tq, q, hd, p.H, p.Sq, p.B, 64) ||
      !encode_view(enc, &to, o, hd, p.H, p.Sq, p.B, 64) ||
      !encode_view(enc, &tk, k, hd, p.n_kv, p.Sk, p.B, TcLayout<HD>::BK) ||
      !encode_view(enc, &tv, v, hd, p.n_kv, p.Sk, p.B, TcLayout<HD>::BK))
    return (int)cudaErrorInvalidValue;
  static bool attr_set[64] = {};
  cudaError_t err = allow_smem(flash_fwd_tc_kernel<HD>, TcLayout<HD>::BYTES, attr_set);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (p.Sq + TC_BQ - 1) / TC_BQ;
  const long long blocks = (long long)n_qt * p.H * p.B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_fwd_tc_kernel<HD><<<(unsigned)blocks, TC_THREADS, TcLayout<HD>::BYTES, stream>>>(
      tq, tk, tv, to, p, n_qt);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Sq, int Sk, int H, int n_kv) {
  return B < 0 || Sq < 0 || Sk < 0 || H <= 0 || n_kv <= 0 || H % n_kv != 0 ||
         H > 65535 || B > 65535;
}

}  // namespace

// q (B, Sq, H, hd), k/v (B, Sk, n_kv, hd), o (B, Sq, H, hd), all contiguous;
// hd 64, 112 or 128 (112 in the layout for 128, the columns past 112
// zero). has_window = 0: no window. softcap <= 0: none. Returns a
// cudaError_t.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Sk, int H,
                                   int n_kv, int hd, float scale, int causal,
                                   int has_window, long long window,
                                   float softcap, void* stream) {
  if (bad_shape(B, Sq, Sk, H, n_kv)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  const Problem p{Sq, Sk, H, n_kv, hd, scale, softcap, causal != 0, has_window != 0, window};
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  float* oo = static_cast<float*>(o);
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 64) return launch_f32_hd<64>(qq, kk, vv, oo, B, p, st);
  if (hd == 112 || hd == 128) return launch_f32_hd<128>(qq, kk, vv, oo, B, p, st);
  return (int)cudaErrorInvalidValue;
}

// The same for bf16, on the tensor cores; q, k, v, o 16-byte aligned (TMA).
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, int B, int Sq, int Sk, int H,
                                    int n_kv, int hd, float scale, int causal,
                                    int has_window, long long window,
                                    float softcap, void* stream) {
  if (bad_shape(B, Sq, Sk, H, n_kv)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  if (Sk == 0)   // softmax over no key: the reference's einsum gives zeros
    return (int)cudaMemsetAsync(o, 0, (size_t)B * Sq * H * hd * 2, st);
  // |i - j| < max(Sq, Sk): a window beyond [-Sk, Sq] masks as its bound does
  const long long w = window < -(long long)Sk ? -(long long)Sk
                      : window > (long long)Sq ? (long long)Sq : window;
  const TcProblem p{B, Sq, Sk, H, n_kv, scale, softcap, causal != 0, has_window != 0, (int)w};
  if (hd == 64) return launch_tc_hd<64>(q, k, v, o, 64, p, st);
  if (hd == 112 || hd == 128) return launch_tc_hd<128>(q, k, v, o, hd, p, st);
  return (int)cudaErrorInvalidValue;
}
