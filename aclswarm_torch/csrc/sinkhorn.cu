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
// Batched (sinkhorn_log_batched_launch): B independent solves, the trials
// of a wave. A block's work is the same whatever r is: each line runs
// through the same four warps, the same strided partial sums and the same
// combine, and the plan entry is (logK + f) + g as above. So a problem
// whose blocks own more lines (larger r, fewer blocks) computes the same
// bits as a single launch, and one cooperative launch can hold several
// problems, block b serving problem b / bpp. What bounds it is residency:
// every block of a launch must be resident, and a problem at r lines per
// block needs ceil(n / r) blocks of (2 r n + n) 4 bytes. So the problems
// go in residency waves: the most problems per launch for which some r
// within the shared-memory limit fits them all on the card, each wave at
// the smallest such r (n = 1000 on 132 SMs: 3 problems at r = 23, so
// B = 5 is a wave of 3 and a wave of 2). Where even one problem's stripes
// do not fit, every problem runs the multi-launch design below, as a
// single solve would at that size: the batched route never changes the
// design, and so never the bits, that a single solve of the same n gets.
//
// Multi-launch design (sinkhorn_log_multi_launch): one kernel per
// half-iteration. logK is written once into the output buffer and the
// final pass adds f and g to it in place. Row pass: one block per row,
// block-wide max then sum of exp. Column pass: one block per tile of
// COL_TILE columns, threads across columns so loads coalesce, rows split
// over COL_ROWS thread rows and reduced in shared memory.
#include <cuda_runtime.h>
#include <math.h>

#include <vector>

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

// Solves problems blockIdx.x / bpp, bpp = ceil(n / r) blocks each;
// launched cooperatively. f, g: n tagged entries per problem, zeroed by
// the caller.
__global__ void __launch_bounds__(P_THREADS)
sinkhorn_persistent_kernel(const float* __restrict__ cost,
                           float* __restrict__ plan, unsigned long long* f,
                           unsigned long long* g, int n, int r, int bpp,
                           float tau, int n_iters, float log_mu) {
  extern __shared__ float smem[];
  __shared__ float red[2 * P_WARPS];          // per-warp partial max, sum
  float* rowK = smem;                         // [lines][n]: logK[i0 + a, :]
  float* colK = smem + (size_t)r * n;         // [lines][n]: logK[:, i0 + a]
  float* vec = smem + 2 * (size_t)r * n;      // [n]: the staged potential
  const int tid = threadIdx.x;
  const int prob = blockIdx.x / bpp;
  cost += (size_t)prob * n * n;
  plan += (size_t)prob * n * n;
  f += (size_t)prob * n;
  g += (size_t)prob * n;
  const int i0 = (blockIdx.x % bpp) * r;
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

namespace {

size_t stripe_bytes(int n, int r) {
  // the static `red` array shares the block's shared memory
  return (2 * (size_t)r * n + n) * sizeof(float) + 2 * P_WARPS * sizeof(float);
}

size_t dynamic_bytes(int n, int r) {
  return (2 * (size_t)r * n + n) * sizeof(float);
}

// How a batch of B solves of size n is launched on this device: waves of
// per_wave problems at r lines per block, the last wave (of B mod
// per_wave problems, if any) at r_last. r = 0 means the multi-launch design.
struct Plan {
  int dev, n, batch, per_wave, r, r_last;
};

cudaError_t plan_for(int dev, int n, int batch, Plan* out) {
  static Plan cache[8];
  static int filled = 0, next = 0;
  for (int k = 0; k < filled; ++k)
    if (cache[k].dev == dev && cache[k].n == n && cache[k].batch == batch) {
      *out = cache[k];
      return cudaSuccess;
    }
  int sms, smem_max;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  Plan p = {dev, n, batch, 0, 0, 0};
  const int r_lo = (n + sms - 1) / sms;       // a single solve: one block per SM
  if (stripe_bytes(n, r_lo) <= (size_t)smem_max) {
    // resident blocks per SM at each r that fits
    int r_hi = r_lo;
    while (r_hi < n && stripe_bytes(n, r_hi + 1) <= (size_t)smem_max) ++r_hi;
    std::vector<int> per_sm(r_hi - r_lo + 1);
    for (int r = r_lo; r <= r_hi; ++r) {
      err = cudaFuncSetAttribute(sinkhorn_persistent_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)dynamic_bytes(n, r));
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm[r - r_lo], sinkhorn_persistent_kernel, P_THREADS,
            dynamic_bytes(n, r));
      if (err != cudaSuccess) return err;
    }
    // the smallest r at which `problems` solves are all resident, or 0
    auto lines_for = [&](int problems) {
      for (int r = r_lo; r <= r_hi; ++r)
        if ((long long)problems * ((n + r - 1) / r) <=
            (long long)sms * per_sm[r - r_lo])
          return r;
      return 0;
    };
    for (int q = batch; q >= 1 && p.per_wave == 0; --q)
      if ((p.r = lines_for(q)) > 0) p.per_wave = q;
    if (p.per_wave == 0) return cudaErrorCooperativeLaunchTooLarge;
    p.r_last = batch % p.per_wave ? lines_for(batch % p.per_wave) : p.r;
  }
  cache[next] = p;
  next = (next + 1) % 8;
  if (filled < 8) ++filled;
  *out = p;
  return cudaSuccess;
}

}  // namespace

// B solves: cost (B, n, n) f32 in, out (B, n, n) plans, f and g scratch of
// B n zeroed 8-byte words each. One cooperative launch per residency wave
// where one solve's stripes fit in shared memory (see the note above), the
// multi-launch design for every problem where they do not. Counts every
// launch into *launched.
extern "C" int sinkhorn_log_batched_launch(const float* cost, float* out,
                                           void* f, void* g, int batch, int n,
                                           float tau, int n_iters,
                                           float log_mu, int* launched,
                                           void* stream) {
  *launched = 0;
  int dev;
  Plan plan;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = plan_for(dev, n, batch, &plan);
  if (err != cudaSuccess) return err;
  const size_t nn = (size_t)n * n;
  auto* ft = static_cast<unsigned long long*>(f);
  auto* gt = static_cast<unsigned long long*>(g);
  if (plan.r == 0) {
    for (int b = 0; b < batch; ++b) {
      int made = 0;
      err = static_cast<cudaError_t>(sinkhorn_log_multi_launch(
          cost + b * nn, out + b * nn, ft + (size_t)b * n, gt + (size_t)b * n,
          n, tau, n_iters, log_mu, &made, stream));
      *launched += made;
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }
  for (int b0 = 0; b0 < batch; b0 += plan.per_wave) {
    const bool last = batch - b0 < plan.per_wave;
    const int p = last ? batch - b0 : plan.per_wave;
    int r = last ? plan.r_last : plan.r;
    int bpp = (n + r - 1) / r;
    const size_t smem = dynamic_bytes(n, r);
    err = cudaFuncSetAttribute(sinkhorn_persistent_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const float* c = cost + b0 * nn;
    float* o = out + b0 * nn;
    unsigned long long* fw = ft + (size_t)b0 * n;
    unsigned long long* gw = gt + (size_t)b0 * n;
    void* args[] = {&c, &o, &fw, &gw, &n, &r, &bpp, &tau, &n_iters, &log_mu};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(sinkhorn_persistent_kernel), dim3(p * bpp),
        dim3(P_THREADS), args, smem, static_cast<cudaStream_t>(stream));
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  return cudaSuccess;
}

// One solve: the batched entry with B = 1 — one cooperative launch at
// r = ceil(n / SMs) where the stripes fit in shared memory, the
// multi-launch design where they do not.
extern "C" int sinkhorn_log_launch(const float* cost, float* out, void* f,
                                   void* g, int n, float tau, int n_iters,
                                   float log_mu, int* launched,
                                   void* stream) {
  return sinkhorn_log_batched_launch(cost, out, f, g, 1, n, tau, n_iters,
                                     log_mu, launched, stream);
}
