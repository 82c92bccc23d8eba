// K3: the flood merge's masked min over senders.
//
// Replaces: aclswarm_tpu/ops/flood_pallas.py:flood_merge_pallas (its
// _kernel), the merge that aclswarm_tpu/sim/localization.py:flood runs:
//   out[v, j] = min over senders s with comm[v, s] of packed[s, j],
// SENTINEL (2^31 - 1) where receiver v has no sender. packed is (n, w)
// int32 (age << 16 | sender id; w = n or a phased stripe), comm (nr, n)
// bool: nr receivers, nr = n for the whole swarm or a rank's row block of
// the sharded flood (the port's parallel/ package), whose packed table
// holds every sender. The result must be bit-identical to the plain
// masked min: it is an integer min, so any order of the fold gives the
// same bits.
//
// Batched: B independent problems (the trials of a wave) in one launch,
// problem b at grid z = b; its packed words, comm bytes and outputs sit at
// strides n w, nr n and nr w. Each problem's blocks run exactly the tile
// of a single launch, so a batched merge equals B single ones bit for bit.
//
// What bounds it on this card: a min/select "tropical GEMM" of n^2 w
// (receiver, sender, target) triples (5e8 at n = 1000, w = 500) against
// ~3 MB of inputs and outputs. There is no tensor-core instruction for
// min-plus, so the integer pipe's instruction issue bounds it. The first,
// byte-mask design (flood_merge_bytemask_kernel below) spent a shared
// byte load, a compare and a select per triple on the comm flag.
//
// Design (flood_merge_kernel):
// - The mask as bits. A block first turns the comm bytes of its TV
//   receivers into one 32-bit word per (receiver, 32-sender chunk): a warp
//   reads 32 consecutive bytes of one receiver and __ballot_sync packs
//   them. The words stay in shared memory for the whole sender walk.
// - No select. For a (receiver, sender) pair, top is 0 when s sends to v
//   and 0x80000000 when it does not; the fold is acc = umin(p + top, acc),
//   an unsigned min started at SENTINEL. PRECONDITION: every packed value
//   lies in [0, 0x7fffffff] — age <= AGE_CAP = 2^15 - 1 and ages are never
//   negative, the sender id is < 2^16 — so p + top == p | top never wraps,
//   a non-sender's p + 0x80000000 > SENTINEL never wins, and a receiver
//   with no sender keeps SENTINEL: bit-identical to the signed masked min.
//   One top serves all CJ targets a thread holds.
// - One DPX instruction per triple: __viaddmin_u32(p, top, acc), Hopper's
//   add-then-min, which the SASS shows as one VIADDMNMX.U32 per triple
//   (chip_smoke.py's build phase counts the min instructions of this
//   kernel). The first form of this design masked with an OR of an
//   all-ones word and folded two senders per __vimin3_u32 (one
//   VIMNMX3.U32): 1.5 ALU instructions per triple against 1 here, and
//   slower on the card (PERF.md).
// - A register tile: each thread holds RV receivers x CJ targets, reads
//   packed as int4 from shared memory (two 16-byte loads per sender) and
//   its receivers' mask words as one 16-byte load per chunk.
// - Staging overlapped with folding: every sender group double-buffers its
//   (TS senders x TJ targets) packed tile with cp.async, so chunk k + 1
//   arrives while chunk k folds.
// - Filling the card: a thread's 32 accumulators leave few warps at
//   n = 1000, w = 500 (500K outputs), so G sender groups in each block
//   fold disjoint sender chunks of the same output tile and combine their
//   accumulators through shared memory at the end: more warps per SM, no
//   atomics, no extra launch.
// - Ragged edges (n, w not multiples of the tile) are masked by bounds
//   checks: senders past n carry no mask bit, targets past w are never
//   stored. 16-byte copies need w % 4 == 0 and aligned rows; otherwise
//   the staging copies 4 bytes at a time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned SENTINEL = 0x7fffffffu;
constexpr int TS = 32;              // senders per chunk: one mask word
constexpr int RV = 4;               // receivers per thread
constexpr int CJ = 8;               // targets per thread (two int4)
constexpr int TXN = 8;              // thread columns of a group
constexpr int TYN = 8;              // thread rows of a group
constexpr int TJ = TXN * CJ;        // 64 targets per block
constexpr int TV = TYN * RV;        // 32 receivers per block
constexpr int GT = TXN * TYN;       // 64 threads per sender group
constexpr int G = 4;                // sender groups per block
constexpr int THREADS = G * GT;     // 256
constexpr int WARPS = THREADS / 32;
constexpr int TILE = TS * TJ;       // ints in one staged packed tile
constexpr size_t STAGE_BYTES = (size_t)G * 2 * TILE * sizeof(int);

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy packed[k*TS .. +TS, j0 .. j0+TJ) into dst (TS x TJ) by one group's
// GT threads. Out-of-range entries are zero-filled: a sender past n has no
// mask bit, a target past w is never stored, so their values never count.
__device__ __forceinline__ void stage(int* dst, const int* __restrict__ packed,
                                      int n, int w, int j0, int k, int lt,
                                      bool vec) {
  const int s0 = k * TS;
  if (vec) {
#pragma unroll
    for (int t = 0; t < TILE / 4 / GT; ++t) {
      const int idx = lt + t * GT, i = idx / (TJ / 4), q = idx % (TJ / 4);
      const int s = s0 + i, j = j0 + 4 * q;
      const bool ok = s < n && j < w;
      cp_async16(dst + i * TJ + 4 * q, ok ? packed + (size_t)s * w + j
                                          : packed, ok ? 16 : 0);
    }
  } else {
#pragma unroll 8
    for (int t = 0; t < TILE / GT; ++t) {
      const int idx = lt + t * GT, i = idx / TJ, c = idx % TJ;
      const int s = s0 + i, j = j0 + c;
      const bool ok = s < n && j < w;
      cp_async4(dst + idx, ok ? packed + (size_t)s * w + j : packed,
                ok ? 4 : 0);
    }
  }
}

// The target of a thread's accumulator column c: two runs of 4, 32 apart,
// so a quarter-warp's 16-byte shared loads are contiguous (no conflicts).
__device__ __forceinline__ int col_of(int tx, int c) {
  return (c / 4) * (TJ / 2) + tx * 4 + (c % 4);
}

__global__ void __launch_bounds__(THREADS, 2)
flood_merge_kernel(const int* __restrict__ packed,
                   const unsigned char* __restrict__ comm,
                   int* __restrict__ out, int n, int nr, int w, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* tiles = reinterpret_cast<int*>(smem);        // [G][2][TS][TJ]
  unsigned* words =                                 // [nchunks][TV]
      reinterpret_cast<unsigned*>(smem + STAGE_BYTES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / GT, lt = tid % GT, tx = lt % TXN, ty = lt / TXN;
  const int j0 = blockIdx.x * TJ, v0 = blockIdx.y * TV;
  const int nchunks = (n + TS - 1) / TS;
  const int iters = (nchunks + G - 1) / G;          // chunk k = it*G + grp
  packed += (size_t)blockIdx.z * n * w;             // this block's problem
  comm += (size_t)blockIdx.z * nr * n;
  out += (size_t)blockIdx.z * nr * w;
  int* mine = tiles + grp * 2 * TILE;

  if (grp < nchunks) stage(mine, packed, n, w, j0, grp, lt, vec);
  cp_async_commit();

  // Mask words for this block's receivers, all chunks, while chunk 0 lands.
  constexpr int U = 16;
  const int total = nchunks * TV;                   // word p = k*TV + v
  for (int base = warp; base < total; base += WARPS * U) {
    bool bit[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + u * WARPS;
      const int v = v0 + p % TV, s = (p / TV) * TS + lane;
      bit[u] = p < total && v < nr && s < n && comm[(size_t)v * n + s] != 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned word = __ballot_sync(0xffffffffu, bit[u]);
      const int p = base + u * WARPS;
      if (lane == 0 && p < total) words[p] = word;
    }
  }

  unsigned acc[RV][CJ];
#pragma unroll
  for (int r = 0; r < RV; ++r)
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[r][c] = SENTINEL;

  for (int it = 0; it < iters; ++it) {
    const int next = (it + 1) * G + grp;
    if (next < nchunks)
      stage(mine + ((it + 1) & 1) * TILE, packed, n, w, j0, next, lt, vec);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const int k = it * G + grp;
    if (k < nchunks) {
      const int* P = mine + (it & 1) * TILE;
      const uint4 wv =
          *reinterpret_cast<const uint4*>(words + k * TV + ty * RV);
      // bit s of nw[r] set: sender k*TS + s does NOT send to the receiver
      const unsigned nw[RV] = {~wv.x, ~wv.y, ~wv.z, ~wv.w};
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        const uint4 a = *reinterpret_cast<const uint4*>(P + s * TJ + tx * 4);
        const uint4 b =
            *reinterpret_cast<const uint4*>(P + s * TJ + TJ / 2 + tx * 4);
        const unsigned p[CJ] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < RV; ++r) {
          // bit s of nw moved to the top: 0 or 0x80000000
          const unsigned top = (nw[r] << (31 - s)) & 0x80000000u;
#pragma unroll
          for (int c = 0; c < CJ; ++c)
            acc[r][c] = __viaddmin_u32(p[c], top, acc[r][c]);
        }
      }
    }
    __syncthreads();
  }

  // Combine the G groups' partial mins through the (now idle) tiles.
  unsigned* part = reinterpret_cast<unsigned*>(tiles);   // [G-1][TV][TJ]
  if (grp > 0) {
#pragma unroll
    for (int r = 0; r < RV; ++r)
#pragma unroll
      for (int c = 0; c < CJ; ++c)
        part[((grp - 1) * TV + ty * RV + r) * TJ + col_of(tx, c)] = acc[r][c];
  }
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < RV; ++r) {
      const int v = v0 + ty * RV + r;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        unsigned m = acc[r][c];
#pragma unroll
        for (int q = 0; q < G - 1; ++q)
          m = min(m, part[(q * TV + ty * RV + r) * TJ + col_of(tx, c)]);
        const int j = j0 + col_of(tx, c);
        if (v < nr && j < w) out[(size_t)v * w + j] = (int)m;
      }
    }
  }
}

// The first design, kept as the baseline chip_smoke.py times the bit-packed
// kernel against: a TV x TJ output tile per block stages comm bytes and
// packed columns in shared memory; each thread folds a select and a signed
// min per (receiver, sender, target) triple for BRV receivers of one target.
constexpr int BTJ = 64;
constexpr int BRV = 4;
constexpr int BTY = 8;
constexpr int BTV = BRV * BTY;
constexpr int BTS = 32;
constexpr int BTHREADS = BTJ * BTY;

__global__ void __launch_bounds__(BTHREADS)
flood_merge_bytemask_kernel(const int* __restrict__ packed,
                            const unsigned char* __restrict__ comm,
                            int* __restrict__ out, int n, int w) {
  __shared__ int sp[BTS][BTJ];
  __shared__ unsigned char sc[BTV][BTS];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * BTJ + tx;
  const int j0 = blockIdx.x * BTJ, v0 = blockIdx.y * BTV;
  packed += (size_t)blockIdx.z * n * w;
  comm += (size_t)blockIdx.z * n * n;
  out += (size_t)blockIdx.z * n * w;
  int acc[BRV];
#pragma unroll
  for (int r = 0; r < BRV; ++r) acc[r] = (int)SENTINEL;

  for (int s0 = 0; s0 < n; s0 += BTS) {
    for (int k = tid; k < BTS * BTJ; k += BTHREADS) {
      const int s = s0 + k / BTJ, j = j0 + k % BTJ;
      sp[k / BTJ][k % BTJ] =
          (s < n && j < w) ? packed[(size_t)s * w + j] : (int)SENTINEL;
    }
    for (int k = tid; k < BTV * BTS; k += BTHREADS) {
      const int v = v0 + k / BTS, s = s0 + k % BTS;
      sc[k / BTS][k % BTS] = (v < n && s < n) ? comm[(size_t)v * n + s] : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int s = 0; s < BTS; ++s) {
      const int p = sp[s][tx];
#pragma unroll
      for (int r = 0; r < BRV; ++r)
        acc[r] = sc[ty * BRV + r][s] ? min(acc[r], p) : acc[r];
    }
    __syncthreads();
  }
  const int j = j0 + tx;
  if (j < w) {
#pragma unroll
    for (int r = 0; r < BRV; ++r) {
      const int v = v0 + ty * BRV + r;
      if (v < n) out[(size_t)v * w + j] = acc[r];
    }
  }
}

}  // namespace

// packed (batch, n, w) int32 with values in [0, 2^31 - 1], comm (batch,
// nr, n) bytes {0, 1} (row stride n) -> out (batch, nr, w) int32; batch =
// 1 is a single problem, nr = n the whole swarm's receivers. One launch;
// its shared memory grows by 128 bytes per 32 senders (the mask words), so
// n is bounded by the card's shared memory per block (about 40,000 on an
// H100): past that the attribute call fails and its error is returned.
// batch is bounded by the grid's z extent (65,535).
extern "C" int flood_merge_launch(const int* packed, const unsigned char* comm,
                                  int* out, int batch, int n, int nr, int w,
                                  void* stream) {
  const int nchunks = (n + TS - 1) / TS;
  const size_t smem = STAGE_BYTES + (size_t)nchunks * TV * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      flood_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // every problem's rows start 16-byte aligned when w % 4 == 0
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const dim3 grid((w + TJ - 1) / TJ, (nr + TV - 1) / TV, batch);
  flood_merge_kernel<<<grid, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(packed, comm, out,
                                                            n, nr, w, vec);
  return cudaGetLastError();
}

// The byte-mask baseline, same arguments and result.
extern "C" int flood_merge_bytemask_launch(const int* packed,
                                           const unsigned char* comm,
                                           int* out, int batch, int n, int w,
                                           void* stream) {
  const dim3 grid((w + BTJ - 1) / BTJ, (n + BTV - 1) / BTV, batch);
  flood_merge_bytemask_kernel<<<grid, dim3(BTJ, BTY), 0,
                                static_cast<cudaStream_t>(stream)>>>(
      packed, comm, out, n, w);
  return cudaGetLastError();
}
