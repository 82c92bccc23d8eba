// K1: log-domain Sinkhorn iterations with uniform marginals.
//
// Replaces: aclswarm_tpu/ops/sinkhorn_pallas.py:sinkhorn_log_pallas (its
// _kernel) — and computes what aclswarm_tpu/assignment/sinkhorn.py:
// sinkhorn_log computes: logK = -cost / tau, log_mu = -log n, then n_iters
// times  f = log_mu - lse_rows(logK + g),  g = log_mu - lse_cols(logK + f),
// and finally plan = (logK + f) + g.
//
// What bounds it on this card: the work is ~10 n^2 float operations per
// iteration over a loop-invariant (n, n) matrix (4 MB at n = 1000), but
// each half-iteration needs the whole of the other half's result, so a
// solve is 2 n_iters dependent steps of ~1 us of work each: latency, not
// bytes or operations, sets the pace. One launch per half-iteration (the
// multi-launch design below) made launch latency the bound: 402 launches
// per solve.
//
// Design (sinkhorn_persistent_kernel): one cooperative launch per solve —
// cooperative so that every block is resident at once, which the waits
// below need. The grid is G = min(n, SMs) blocks of 1024 threads, one per
// SM; with r = ceil(n / G), block b owns rows [b r, (b+1) r) and the same
// range of columns. While loading, a block computes -cost / tau into two
// stripes in dynamic shared memory — its r rows (r x n) and its r columns
// stored transposed (r x n) — and keeps them there for every iteration, as
// the TPU kernel keeps logK in VMEM. A half-iteration gathers the other
// potential (n values) into shared memory, runs four warps per owned row
// (column) through the max-shifted logsumexp (a non-finite max shifts by
// 0, as the reference), and publishes its f (g) entries. No partial sums
// cross blocks and there is no (n, n) scratch.
//
// Synchronisation without a grid barrier: each published entry is one
// 64-bit word, the iteration that produced it (1-based; 0 = the caller's
// zeros) in the high half and the float's bits in the low half, stored and
// read with gpu-scope relaxed accesses, so a word is never torn. A block
// that needs potential t spins on each entry until its tag reads t. That
// replaces a grid barrier plus a separate load of the potential (two or
// three L2 round trips) by one, and a block waits only for the entries,
// not for every block's arrival. An entry cannot be overwritten while
// another block still needs it: writing f of iteration t + 1 needs all of
// g of iteration t, and every block computes its g only after it has read
// all of f of iteration t (the same holds for g). More blocks per SM
// would fit, but a block's work per half-iteration is only ~r n exps, and
// fewer blocks mean fewer producers to wait on. A spin that outlives any
// legitimate wait (2^24 polls, seconds) traps, so a fault surfaces as a
// CUDA error instead of a hang. The L2 round trip of the published
// potentials, not the arithmetic, then sets the pace.
//
// Stripe limit and fallback: the stripes take (2 r n + n) 4 bytes with
// r = ceil(n / SMs). Where that exceeds the card's shared memory per
// block (n above 1,849 on 132 SMs with 227 KB), sinkhorn_log_launch runs
// the multi-launch design instead, choosing by size as the reference
// routes by its VMEM budget. Both report the launches they made: 1, or
// 2 n_iters + 2.
//
// Multi-launch design (sinkhorn_log_multi_launch): one kernel per
// half-iteration. logK is written once into the output buffer and the
// final pass adds f and g to it in place. Row pass: one block per row,
// block-wide max then sum of exp. Column pass: one block per tile of
// COL_TILE columns, threads across columns so loads coalesce, rows split
// over COL_ROWS thread rows and reduced in shared memory.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROW_THREADS = 256;
constexpr int COL_TILE = 8;    // columns per block (threadIdx.x)
constexpr int COL_ROWS = 64;   // row lanes per block (threadIdx.y)
constexpr int P_THREADS = 1024;  // persistent kernel: one block per SM
constexpr int P_WARPS = P_THREADS / 32;
constexpr int P_WPR = 4;          // warps per row (column) in a half-step
constexpr int P_LINES = P_WARPS / P_WPR;   // lines one round handles

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_allmax(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_allsum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A potential entry with the iteration that produced it (see the note).
__device__ __forceinline__ void publish(unsigned long long* p, float v,
                                        unsigned tag) {
  const unsigned long long word =
      (unsigned long long)tag << 32 | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(word)
               : "memory");
}

__device__ __forceinline__ float await_entry(const unsigned long long* p,
                                       unsigned tag) {
  unsigned long long word;
  for (long long spin = 0;; ++spin) {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(word) : "l"(p) : "memory");
    if ((unsigned)(word >> 32) == tag) break;
    if (spin > (1ll << 24)) __trap();
  }
  return __uint_as_float((unsigned)word);
}

// out[i0 + a] = log_mu - lse_j(K[a, j] + vec[j]) for the block's lines,
// max-shifted, P_WPR warps per line, all in shared memory, published
// with `tag`. Every thread runs the same rounds so the block barriers
// inside stay uniform.
__device__ __forceinline__ void half_step(const float* K, const float* vec,
                                          unsigned long long* out, int i0,
                                          int lines, int n, float log_mu,
                                          float* red, unsigned tag) {
  constexpr int STRIDE = P_WPR * 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp / P_WPR, sub = warp % P_WPR;
  for (int base = 0; base < lines; base += P_LINES) {
    const int a = base + grp;
    const bool on = a < lines;
    const float* k = K + (size_t)(on ? a : 0) * n;
    float m0 = -INFINITY, m1 = -INFINITY;
    int j = sub * 32 + lane;
    if (on) {
      for (; j + STRIDE < n; j += 2 * STRIDE) {
        m0 = fmaxf(m0, k[j] + vec[j]);
        m1 = fmaxf(m1, k[j + STRIDE] + vec[j + STRIDE]);
      }
      if (j < n) m0 = fmaxf(m0, k[j] + vec[j]);
    }
    float m = warp_allmax(fmaxf(m0, m1));
    if (lane == 0) red[warp] = m;
    __syncthreads();
    m = red[grp * P_WPR];
    for (int q = 1; q < P_WPR; ++q) m = fmaxf(m, red[grp * P_WPR + q]);
    const float shift = isfinite(m) ? m : 0.0f;
    float s0 = 0.0f, s1 = 0.0f;
    j = sub * 32 + lane;
    if (on) {
      for (; j + STRIDE < n; j += 2 * STRIDE) {
        s0 += expf(k[j] + vec[j] - shift);
        s1 += expf(k[j + STRIDE] + vec[j + STRIDE] - shift);
      }
      if (j < n) s0 += expf(k[j] + vec[j] - shift);
    }
    float s = warp_allsum(s0 + s1);
    if (lane == 0) red[P_WARPS + warp] = s;
    __syncthreads();
    s = red[P_WARPS + grp * P_WPR];
    for (int q = 1; q < P_WPR; ++q) s += red[P_WARPS + grp * P_WPR + q];
    if (on && sub == 0 && lane == 0)
      publish(out + i0 + a, log_mu - (shift + logf(s)), tag);
  }
}

// One solve per launch; launched cooperatively with ceil(n / r) blocks.
// f, g: n tagged entries each, zeroed by the caller.
__global__ void __launch_bounds__(P_THREADS)
sinkhorn_persistent_kernel(const float* __restrict__ cost,
                           float* __restrict__ plan, unsigned long long* f,
                           unsigned long long* g, int n, int r, float tau,
                           int n_iters, float log_mu) {
  extern __shared__ float smem[];
  __shared__ float red[2 * P_WARPS];          // per-warp partial max, sum
  float* rowK = smem;                         // [lines][n]: logK[i0 + a, :]
  float* colK = smem + (size_t)r * n;         // [lines][n]: logK[:, i0 + a]
  float* vec = smem + 2 * (size_t)r * n;      // [n]: the staged potential
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * r;
  const int lines = max(0, min(r, n - i0));
  const int span = lines * n;

  for (int k = tid; k < span; k += P_THREADS)
    rowK[k] = -cost[(size_t)i0 * n + k] / tau;
  for (int k = tid; k < span; k += P_THREADS) {
    const int i = k / lines, a = k % lines;
    colK[(size_t)a * n + i] = -cost[(size_t)i * n + i0 + a] / tau;
  }

  for (int it = 0; it < n_iters; ++it) {
    // f[i] = log_mu - lse_j(logK[i, j] + g[j]) for the owned rows
    for (int j = tid; j < n; j += P_THREADS)
      vec[j] = await_entry(g + j, it);
    __syncthreads();
    half_step(rowK, vec, f, i0, lines, n, log_mu, red, it + 1);
    // g[j] = log_mu - lse_i(logK[i, j] + f[i]) for the owned columns
    for (int i = tid; i < n; i += P_THREADS)
      vec[i] = await_entry(f + i, it + 1);
    __syncthreads();
    half_step(colK, vec, g, i0, lines, n, log_mu, red, it + 1);
    __syncthreads();
  }

  // plan[i, j] = (logK[i, j] + f[i]) + g[j] for the owned rows
  for (int j = tid; j < n; j += P_THREADS)
    vec[j] = await_entry(g + j, n_iters);
  __syncthreads();
  for (int k = tid; k < span; k += P_THREADS) {
    const int a = k / n, j = k % n;
    plan[(size_t)i0 * n + k] =
        (rowK[k] + await_entry(f + i0 + a, n_iters)) + vec[j];
  }
}

// Block-wide reduction over ROW_THREADS threads; every thread gets the
// result.
template <bool kMax>
__device__ float block_reduce(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < ROW_THREADS / 32 ? sh[lane] : (kMax ? -INFINITY : 0.0f);
    v = kMax ? warp_max(v) : warp_sum(v);
    if (lane == 0) sh[0] = v;
  }
  __syncthreads();
  v = sh[0];
  __syncthreads();
  return v;
}

__global__ void neg_scale_kernel(const float* __restrict__ cost,
                                 float* __restrict__ logK, long long total,
                                 float tau) {
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < total; k += (long long)gridDim.x * blockDim.x)
    logK[k] = -cost[k] / tau;
}

// f[i] = log_mu - lse_j(logK[i, j] + g[j])
__global__ void row_lse_kernel(const float* __restrict__ logK,
                               const float* __restrict__ g,
                               float* __restrict__ f, int n, float log_mu) {
  __shared__ float sh[32];
  const float* row = logK + (size_t)blockIdx.x * n;
  float m = -INFINITY;
  for (int j = threadIdx.x; j < n; j += ROW_THREADS)
    m = fmaxf(m, row[j] + g[j]);
  m = block_reduce<true>(m, sh);
  const float shift = isfinite(m) ? m : 0.0f;
  float s = 0.0f;
  for (int j = threadIdx.x; j < n; j += ROW_THREADS)
    s += expf(row[j] + g[j] - shift);
  s = block_reduce<false>(s, sh);
  if (threadIdx.x == 0) f[blockIdx.x] = log_mu - (shift + logf(s));
}

// g[j] = log_mu - lse_i(logK[i, j] + f[i])
__global__ void col_lse_kernel(const float* __restrict__ logK,
                               const float* __restrict__ f,
                               float* __restrict__ g, int n, float log_mu) {
  __shared__ float red[COL_ROWS][COL_TILE + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * COL_TILE + tx;
  float m = -INFINITY;
  if (j < n)
    for (int i = ty; i < n; i += COL_ROWS)
      m = fmaxf(m, logK[(size_t)i * n + j] + f[i]);
  red[ty][tx] = m;
  __syncthreads();
  for (int st = COL_ROWS / 2; st > 0; st >>= 1) {
    if (ty < st) red[ty][tx] = fmaxf(red[ty][tx], red[ty + st][tx]);
    __syncthreads();
  }
  m = red[0][tx];
  __syncthreads();
  const float shift = isfinite(m) ? m : 0.0f;
  float s = 0.0f;
  if (j < n)
    for (int i = ty; i < n; i += COL_ROWS)
      s += expf(logK[(size_t)i * n + j] + f[i] - shift);
  red[ty][tx] = s;
  __syncthreads();
  for (int st = COL_ROWS / 2; st > 0; st >>= 1) {
    if (ty < st) red[ty][tx] += red[ty + st][tx];
    __syncthreads();
  }
  if (ty == 0 && j < n) g[j] = log_mu - (shift + logf(red[0][tx]));
}

// plan[i, j] = (logK[i, j] + f[i]) + g[j], in place over logK
__global__ void add_potentials_kernel(float* __restrict__ plan,
                                      const float* __restrict__ f,
                                      const float* __restrict__ g, int n) {
  const long long total = (long long)n * n;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < total; k += (long long)gridDim.x * blockDim.x)
    plan[k] = plan[k] + f[k / n] + g[k % n];
}

int elementwise_blocks(long long total) {
  long long b = (total + 255) / 256;
  return (int)(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

}  // namespace

// Both entry points: cost (n, n) f32 in; out (n, n) f32 plan; f, g
// scratch of n 8-byte words each, zeroed by the caller (the iteration
// starts from g = 0): the persistent design keeps its tagged entries there,
// the multi-launch design n floats in each. They count each launch into
// the host int *launched and return the first CUDA error.

// The multi-launch design: 2 * n_iters + 2 kernels on `stream`.
extern "C" int sinkhorn_log_multi_launch(const float* cost, float* out,
                                         void* f_scratch, void* g_scratch,
                                         int n, float tau, int n_iters,
                                         float log_mu, int* launched,
                                         void* stream) {
  float* f = static_cast<float*>(f_scratch);
  float* g = static_cast<float*>(g_scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)n * n;
  *launched = 0;
  neg_scale_kernel<<<elementwise_blocks(total), 256, 0, s>>>(cost, out,
                                                             total, tau);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  const dim3 col_block(COL_TILE, COL_ROWS);
  const int col_grid = (n + COL_TILE - 1) / COL_TILE;
  for (int it = 0; it < n_iters; ++it) {
    row_lse_kernel<<<n, ROW_THREADS, 0, s>>>(out, g, f, n, log_mu);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++*launched;
    col_lse_kernel<<<col_grid, col_block, 0, s>>>(out, f, g, n, log_mu);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++*launched;
  }
  add_potentials_kernel<<<elementwise_blocks(total), 256, 0, s>>>(out, f, g,
                                                                  n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ++*launched;
  return cudaSuccess;
}

// The solve: one cooperative launch where the stripes fit in shared
// memory, the multi-launch design where they do not.
extern "C" int sinkhorn_log_launch(const float* cost, float* out, void* f,
                                   void* g, int n, float tau, int n_iters,
                                   float log_mu, int* launched,
                                   void* stream) {
  *launched = 0;
  int dev, sms, smem_max;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  int r = (n + sms - 1) / sms;                // one block per SM
  auto* ft = static_cast<unsigned long long*>(f);
  auto* gt = static_cast<unsigned long long*>(g);
  const int blocks = (n + r - 1) / r;
  const size_t smem = (2 * (size_t)r * n + n) * sizeof(float);
  // the static `red` array shares the block's shared memory
  if (smem + 2 * P_WARPS * sizeof(float) > (size_t)smem_max)
    return sinkhorn_log_multi_launch(cost, out, f, g, n, tau, n_iters, log_mu,
                                     launched, stream);
  err = cudaFuncSetAttribute(sinkhorn_persistent_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sinkhorn_persistent_kernel, P_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&cost, &out, &ft, &gt, &n, &r, &tau, &n_iters, &log_mu};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(sinkhorn_persistent_kernel), dim3(blocks),
      dim3(P_THREADS), args, smem, static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  *launched = 1;
  return cudaSuccess;
}
