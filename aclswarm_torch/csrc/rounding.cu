// K2: dominant-pair rounding of an (n, n) log transport plan to a
// permutation.
//
// Replaces: aclswarm_tpu/ops/rounding_pallas.py:round_dominant_pallas (its
// _kernel), which reproduces aclswarm_tpu/assignment/sinkhorn.py:
// round_dominant. Each round: every unassigned row's max and first-hit
// argmax (lowest column among equals) over the columns not yet struck,
// every column's first-hit argmax (lowest row) over the rows not yet
// assigned, commit every unassigned row whose pick is mutual and whose max
// is > -inf, strike the committed rows and columns. Loop until every row
// is assigned or max_rounds rounds ran (the reference passes n); rows left
// over stay -1. The result must be bit-identical to the reference.
//
// PRECONDITION: no NaN in the plan (it comes from K1's Sinkhorn solve).
// -inf entries and signed zeros are valid inputs.
//
// Stale-only rescans, and why they are exact. Every line (row or column)
// keeps its first-hit argmax from the round that last scanned it. A row's
// entries change only when a column is struck, and striking turns an entry
// into -inf: it lowers entries that were below the row's max or tied with
// it after the first hit, so while the row's argmax column stays live its
// max and first hit stay where they were (the first hit among the equal
// values of a subset of the columns is still the same lowest column). So
// in round r > 1 a live row needs a rescan only if its cached argmax
// column was struck in round r - 1. By the same argument over rows, a live
// column needs one only if its cached argmax row was committed in round
// r - 1. Both tests are lazy — struck[rowarg[i]], assigned[colarg[j]] —
// because a line whose argmax was struck earlier was rescanned then, and
// its new argmax is live. The row and column rescans of a round read only
// the previous round's commits, so they run in one phase.
//
// Ties. Comparisons are float compares, so -0.0 == +0.0 as in argmax; a
// lane keeps the first hit with a strict >, and partial results combine
// by (larger value, else lower index). Across blocks, round 1's column
// maxima combine through one 64-bit atomicMax per (block, column) on the
// key (ordered_bits(v) << 32) | (0xffffffff - i), which puts the larger
// value first and the lower row first on ties; ordered_bits maps -0.0 to
// the bits of +0.0 first, or the key would split that tie.
//
// Lines that are all -inf. The reference's argmax of such a line is 0.
// Here its cached argmax is n ("dead"), which no row and no column equals.
// That changes nothing: a row commits only with a finite max, and a row
// with a finite max picks a column whose max is finite, so a dead row or
// column is never part of a commit; and a line whose live entries are all
// -inf stays so, so it never needs a rescan either.
//
// What bounds it on this card: the function needs the plan read once (4 MB
// at n = 1000, ~1.2 us at the memory rate) and a few compares per entry of
// a rescanned line. But the rounds are serial (tens at n = 1000, n on the
// all-ties plan) and each needs every block's result of the round before,
// so after round 1 a round's chain of dependent L2 round trips (publish,
// read, read, rescan), not bytes, sets the pace.
//
// Design (round_persistent_kernel, round_dominant_launch): one cooperative
// launch with one 1024-thread block per SM — cooperative so that every
// block is resident at once, which the waits below need. Block b owns rows
// and columns [b r, (b + 1) r), r = ceil(n / SMs), and keeps their current
// argmaxes in shared memory. Round 1: the block scans its rows (warps per
// row) and folds its rows into every column's partial max, one atomicMax
// per column, then all blocks meet once at a counter barrier so that the
// column keys are final. Each round k then runs three steps in every
// block, with no barrier:
// - publish: every live line the block owns, stale-rescanned or not, is
//   written as one 64-bit word, the round k in the high half and the
//   argmax in the low half, into buffer k & 1 (gpu-scope relaxed stores,
//   so a word is never torn; the wrapper's zeroed scratch is round 0);
// - commit: every block decides every commit itself. For each live row it
//   spins until the row's word for round k arrives, then on its column's
//   word, and commits where the pick is mutual; so each block keeps the
//   whole assigned and struck bitmaps in shared memory and never waits for
//   another's commits, only for the words it reads. The owner writes the
//   output;
// - rescan: the block checks its own lines against its bitmaps (shared
//   memory only) and rescans the stale ones, rows and columns at once on
//   two halves of the block — rows with groups of warps along the row,
//   columns with lanes across the listed columns and rows, so a warp's
//   load covers neighbouring columns, 8 loads in flight per lane.
// A word of round k + 2 overwrites one of round k only after its writer
// has seen every block's beat of round k + 1 (a word per block, written
// with the block's round k + 1 words), and every block writes that beat
// only after it has finished reading round k. A spin past 2^24 polls
// traps, so a fault is a CUDA error and not a hang (the longest legitimate
// wait is one block's rescan, well under a millisecond at n = 14,000).
// Shared memory holds two n-bit bitmaps, the block's own lines and two
// lists of 1024 lines, so no size short of device memory is refused.
//
// The single-block design (round_dominant_kernel,
// round_dominant_single_block_launch; the first port of this kernel, kept
// for timing only): the whole loop in one block, every live line
// rescanned every round, 17 bytes per row of shared memory.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 1024;      // every kernel here: one 1024-thread block
constexpr int NW = THREADS / 32;   // warps per block
// ordered_bits(-inf): keys at or below it mean "no finite entry"
constexpr unsigned ORD_NEG_INF = 0x007fffffu;

// (v, i) beats (best, bi): larger value, or equal value and lower index.
__device__ __forceinline__ void take_better(float& best, int& bi, float v,
                                            int i) {
  if (v > best || (v == best && i < bi)) {
    best = v;
    bi = i;
  }
}

// The warp's best (value, index) into lane 0.
__device__ __forceinline__ void warp_better(float& best, int& bi) {
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_down_sync(0xffffffffu, best, off);
    const int i2 = __shfl_down_sync(0xffffffffu, bi, off);
    take_better(best, bi, v2, i2);
  }
}

__device__ __forceinline__ bool bit(const unsigned* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

// Order-preserving bits of a float, with -0.0 taken as +0.0.
__device__ __forceinline__ unsigned ordered_bits(float v) {
  unsigned u = __float_as_uint(v);
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long col_key(float v, int i) {
  return (unsigned long long)ordered_bits(v) << 32 |
         (0xffffffffu - (unsigned)i);
}

// A column key's argmax row, n when the column has no finite live entry
// (also the zeroed key of a column nothing was folded into).
__device__ __forceinline__ int key_arg(unsigned long long key, int n) {
  return (unsigned)(key >> 32) <= ORD_NEG_INF
             ? n
             : (int)(0xffffffffu - (unsigned)key);
}

// Round state in the wrapper's zeroed scratch (see `carve`).
struct State {
  unsigned long long* colkey;     // [n] round 1's column keys
  unsigned long long* rowpub[2];  // [n] (round, row argmax) by round parity
  unsigned long long* colpub[2];  // [n] (round, column argmax)
  unsigned* beat;                 // [blocks] the last round each published
  unsigned long long* entries;    // entries read by rescans after round 1
  unsigned* ctr;                  // barrier, rows and columns rescanned
                                  // after round 1
};

struct Shared {
  int rows[THREADS];            // rows to scan in this window
  int cols[THREADS];            // columns to scan in this window
  float red_v[NW * 32];         // per-warp partials
  int red_i[NW * 32];
  int nrows, ncols, count;
};

constexpr int U = 8;            // loads a lane keeps in flight

// Fold the entries first, first + step, ... (< n) of one line into
// (best, bi), U predicated loads at a time, in ascending order with a
// strict >, so the lane keeps its first hit. Entry k sits at line[k * ld];
// skip(k) reads it as -inf (a struck column, an assigned row).
template <typename Skip>
__device__ __forceinline__ void fold_line(const float* __restrict__ line,
                                          size_t ld, int first, int step,
                                          int n, Skip skip, float& best,
                                          int& bi) {
  for (int k0 = first; k0 < n; k0 += U * step) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * step;
      v[u] = (k < n && !skip(k)) ? __ldg(line + (size_t)k * ld) : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (v[u] > best) {
        best = v[u];
        bi = k0 + u * step;
      }
  }
}

// Scan rows s.rows[0, nr) (max and first-hit argmax over the columns not
// struck) and columns s.cols[0, nc) (first-hit argmax over the rows not
// assigned) at the same time; the argmaxes go to own_row / own_col at
// [line - lo], n where every live entry is -inf. Half the warps take the
// rows, half the columns (all of them when the other list is empty). A
// row gets wpl warps along it; a warp covers cg columns (a power of two
// up to 32) by 32 / cg rows, so few columns still fill its lanes and a
// load covers neighbouring columns. Partials combine by shuffles, then
// across warps by shuffles again (one warp per line). Block-wide: every
// thread runs the same batches, so the barriers stay uniform.
__device__ void scan_lines(const float* __restrict__ plan, int n,
                           const unsigned* abits, const unsigned* cbits,
                           int lo, int* own_row, int* own_col, Shared& s,
                           int nr, int nc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = nc == 0 ? NW : (nr == 0 ? 0 : NW / 2);   // row warps
  const int cw = NW - rw;
  const int wpl = nr == 0 ? 1 : max(1, rw / nr);
  const int rpb = max(1, rw / wpl);                        // rows a batch
  int cg = 1;
  while (cg < 32 && cg < nc) cg <<= 1;
  int batches = nr == 0 ? 0 : (nr + rpb - 1) / rpb;
  if (nc > 0) batches = max(batches, (nc + cg - 1) / cg);
  const bool masked = cbits != nullptr;
  for (int b = 0; b < batches; ++b) {
    float best = -INFINITY;
    int bi = n;
    if (warp < rw) {
      const int grp = warp / wpl, sub = warp % wpl, a = b * rpb + grp;
      if (grp < rpb && a < nr)
        fold_line(plan + (size_t)s.rows[a] * n, 1, sub * 32 + lane,
                  wpl * 32, n,
                  [&](int j) { return masked && bit(cbits, j); }, best, bi);
      warp_better(best, bi);
      if (lane == 0) {
        s.red_v[warp * 32] = best;
        s.red_i[warp * 32] = bi;
      }
    } else {
      const int cl = lane & (cg - 1), rl = lane / cg, a = b * cg + cl;
      if (a < nc)
        fold_line(plan + s.cols[a], n, (warp - rw) * (32 / cg) + rl,
                  cw * (32 / cg), n,
                  [&](int i) { return bit(abits, i); }, best, bi);
      for (int off = cg; off < 32; off <<= 1) {
        const float v2 = __shfl_xor_sync(0xffffffffu, best, off);
        const int i2 = __shfl_xor_sync(0xffffffffu, bi, off);
        take_better(best, bi, v2, i2);
      }
      if (rl == 0) {
        s.red_v[warp * 32 + cl] = best;
        s.red_i[warp * 32 + cl] = bi;
      }
    }
    __syncthreads();
    // combine: a row's first warp, or one warp per column, folds the
    // partials by shuffles (lane q holds partial q)
    if (warp < rw) {
      const int grp = warp / wpl, a = b * rpb + grp;
      if (warp % wpl == 0 && grp < rpb && a < nr) {
        best = lane < wpl ? s.red_v[(warp + lane) * 32] : -INFINITY;
        bi = lane < wpl ? s.red_i[(warp + lane) * 32] : n;
        warp_better(best, bi);
        if (lane == 0) own_row[s.rows[a] - lo] = best > -INFINITY ? bi : n;
      }
    } else {
      for (int c = warp - rw; c < cg; c += cw) {
        if (b * cg + c >= nc) break;
        best = lane < cw ? s.red_v[(rw + lane) * 32 + c] : -INFINITY;
        bi = lane < cw ? s.red_i[(rw + lane) * 32 + c] : n;
        warp_better(best, bi);
        if (lane == 0)
          own_col[s.cols[b * cg + c] - lo] = best > -INFINITY ? bi : n;
      }
    }
    __syncthreads();
  }
}

// All blocks meet once, after round 1's column folds.
__device__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar)
                 : "memory");
    for (long long spin = 0;; ++spin) {
      unsigned v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(v) : "l"(bar) : "memory");
      if (v >= gridDim.x) break;
      if (spin > (1ll << 24)) __trap();
    }
  }
  __syncthreads();
}

// Round 1 for the block's lines [i0, i0 + lines): its rows' argmaxes into
// own_row, its rows folded into every column's key (one atomicMax per
// column with a finite partial; the keys start at zero), then — after the
// barrier — its columns' argmaxes into own_col. Also sets its rows'
// outputs to -1.
__device__ void full_scan(const float* __restrict__ plan, int* out, int n,
                          int i0, int lines, const State& st, int* own_row,
                          int* own_col, Shared& s) {
  for (int j = threadIdx.x; j < n; j += THREADS) {
    float best = -INFINITY;
    int bi = 0;
    fold_line(plan + (size_t)i0 * n + j, n, 0, 1, lines,
              [](int) { return false; }, best, bi);
    if (best > -INFINITY) atomicMax(st.colkey + j, col_key(best, i0 + bi));
  }
  for (int w = 0; w < lines; w += THREADS) {
    const int c = min(THREADS, lines - w);
    if (threadIdx.x < c) {
      s.rows[threadIdx.x] = i0 + w + threadIdx.x;
      out[i0 + w + threadIdx.x] = -1;
    }
    __syncthreads();
    scan_lines(plan, n, nullptr, nullptr, i0, own_row, own_col, s, c, 0);
  }
  grid_sync(st.ctr);
  for (int a = threadIdx.x; a < lines; a += THREADS)
    own_col[a] = key_arg(__ldcg(st.colkey + i0 + a), n);
  __syncthreads();
}

__device__ __forceinline__ void publish(unsigned long long* p, int value,
                                        unsigned round) {
  const unsigned long long word =
      (unsigned long long)round << 32 | (unsigned)value;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(word)
               : "memory");
}

__device__ __forceinline__ int await_word(const unsigned long long* p,
                                          unsigned round) {
  unsigned long long word;
  for (long long spin = 0;; ++spin) {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(word) : "l"(p) : "memory");
    if ((unsigned)(word >> 32) == round) break;
    if (spin > (1ll << 24)) __trap();
  }
  return (int)(unsigned)word;
}

// Round `round`: publish the block's live lines and its beat, then decide
// every commit from the published words (the bitmaps in shared memory
// gain this round's rows and columns; the owner writes the output), and
// wait for every block's beat of this round: a block whose rows are all
// assigned is otherwise awaited by nobody, and could still be reading
// the words of round - 1 when a faster block overwrites them in round
// + 1. Returns (to every thread) the number of commits.
__device__ int publish_and_commit(int* out, int n, int i0, int lines,
                                  unsigned* abits, unsigned* cbits,
                                  const State& st, const int* own_row,
                                  const int* own_col, unsigned round,
                                  Shared& s) {
  unsigned long long* rowpub = st.rowpub[round & 1];
  unsigned long long* colpub = st.colpub[round & 1];
  for (int a = threadIdx.x; a < lines; a += THREADS) {
    if (!bit(abits, i0 + a)) publish(rowpub + i0 + a, own_row[a], round);
    if (!bit(cbits, i0 + a)) publish(colpub + i0 + a, own_col[a], round);
  }
  // a release after the block's last reads of round - 1 (ordered before
  // it by the barriers since), matched by the acquire below
  if (threadIdx.x == 0)
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(
                     st.beat + blockIdx.x), "r"(round)
                 : "memory");
  if (threadIdx.x == 0) s.count = 0;
  __syncthreads();
  int mine = 0;
  // a row's own bit is set only by the thread that reads it, so one pass
  // decides on the last round's state
  for (int i = threadIdx.x; i < n; i += THREADS) {
    if (bit(abits, i)) continue;
    const int j = await_word(rowpub + i, round);
    if (j < n && await_word(colpub + j, round) == i) {
      // distinct rows commit distinct columns
      atomicOr(abits + (i >> 5), 1u << (i & 31));
      atomicOr(cbits + (j >> 5), 1u << (j & 31));
      if (i >= i0 && i < i0 + lines) out[i] = j;
      ++mine;
    }
  }
  for (int b = threadIdx.x; b < gridDim.x; b += THREADS)
    for (long long spin = 0;; ++spin) {
      unsigned v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(v) : "l"(st.beat + b) : "memory");
      if (v >= round) break;
      if (spin > (1ll << 24)) __trap();
    }
  if (mine) atomicAdd(&s.count, mine);
  __syncthreads();
  const int c = s.count;
  __syncthreads();
  return c;
}

// The rescans of a round > 1 for the block's lines [i0, i0 + lines): the
// live rows whose argmax column is struck and the live columns whose
// argmax row is assigned, found from shared memory alone and rescanned.
// Windows of THREADS lines. Returns (to every thread) the rows and the
// columns rescanned.
__device__ int2 rescan_stale(const float* __restrict__ plan, int n, int i0,
                             int lines, const unsigned* abits,
                             const unsigned* cbits, int* own_row,
                             int* own_col, Shared& s) {
  int2 count = make_int2(0, 0);
  for (int w = 0; w < lines; w += THREADS) {
    if (threadIdx.x == 0) s.nrows = s.ncols = 0;
    __syncthreads();
    const int a = w + threadIdx.x, x = i0 + a;
    if (a < lines) {
      const int j = own_row[a], i = own_col[a];
      if (!bit(abits, x) && j < n && bit(cbits, j))
        s.rows[atomicAdd(&s.nrows, 1)] = x;
      if (!bit(cbits, x) && i < n && bit(abits, i))
        s.cols[atomicAdd(&s.ncols, 1)] = x;
    }
    __syncthreads();
    const int nr = s.nrows, nc = s.ncols;
    scan_lines(plan, n, abits, cbits, i0, own_row, own_col, s, nr, nc);
    count.x += nr;
    count.y += nc;
    __syncthreads();
  }
  return count;
}

// One block per SM, launched cooperatively with ceil(n / r) blocks; block
// b owns rows and columns [b r, (b + 1) r). Dynamic shared memory: the
// assigned and struck bitmaps (W words each), then the block's own rows'
// and columns' argmaxes (r ints each).
__global__ void __launch_bounds__(THREADS)
round_persistent_kernel(const float* __restrict__ plan, int* __restrict__ out,
                        int* __restrict__ rounds_out, State st, int n, int r,
                        int max_rounds) {
  extern __shared__ unsigned sbits[];
  __shared__ Shared s;
  const int nwords = (n + 31) / 32;
  unsigned* abits = sbits;
  unsigned* cbits = sbits + nwords;
  int* own_row = reinterpret_cast<int*>(cbits + nwords);
  int* own_col = own_row + r;
  const int i0 = blockIdx.x * r, lines = min(r, n - i0);
  long long rows = 0, cols = 0, entries = 0;
  int rounds = 0, remaining = n;
  for (int w = threadIdx.x; w < 2 * nwords; w += THREADS) sbits[w] = 0u;
  __syncthreads();
  if (max_rounds > 0) {
    full_scan(plan, out, n, i0, lines, st, own_row, own_col, s);
    for (;;) {
      ++rounds;
      remaining -= publish_and_commit(out, n, i0, lines, abits, cbits, st,
                                      own_row, own_col, rounds, s);
      if (remaining == 0 || rounds == max_rounds) break;
      const int2 c = rescan_stale(plan, n, i0, lines, abits, cbits, own_row,
                                  own_col, s);
      rows += c.x;
      cols += c.y;
      entries += (long long)(c.x + c.y) * remaining;
    }
  } else {
    for (int a = threadIdx.x; a < lines; a += THREADS) out[i0 + a] = -1;
  }
  if (threadIdx.x == 0) {
    atomicAdd(st.ctr + 1, (unsigned)rows);
    atomicAdd(st.ctr + 2, (unsigned)cols);
    atomicAdd(st.entries, (unsigned long long)entries);
    if (blockIdx.x == 0) *rounds_out = rounds;
  }
}

// The single-block design: the whole loop in one block, every live line
// rescanned
// every round; rowmax, rowarg, colarg, assign and a struck flag per line
// in shared memory (17 bytes per row).
__global__ void __launch_bounds__(THREADS)
round_dominant_kernel(const float* __restrict__ plan, int* __restrict__ out,
                      int* __restrict__ rounds_out, int n, int max_rounds) {
  extern __shared__ unsigned char smem[];
  float* rowmax = reinterpret_cast<float*>(smem);
  int* rowarg = reinterpret_cast<int*>(rowmax + n);
  int* colarg = rowarg + n;
  int* assign = colarg + n;
  unsigned char* struck = reinterpret_cast<unsigned char*>(assign + n);
  __shared__ int remaining;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < n; i += THREADS) {
    assign[i] = -1;
    struck[i] = 0;
  }
  if (tid == 0) remaining = n;
  __syncthreads();

  int rounds = 0;
  while (remaining > 0 && rounds < max_rounds) {
    for (int i = warp; i < n; i += NW) {
      if (assign[i] >= 0) continue;  // warp-uniform
      const float* row = plan + (size_t)i * n;
      float best = -INFINITY;
      int bi = 0;
      for (int j = lane; j < n; j += 32) {
        const float v = struck[j] ? -INFINITY : row[j];
        if (v > best) {
          best = v;
          bi = j;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float v2 = __shfl_down_sync(0xffffffffu, best, off);
        const int i2 = __shfl_down_sync(0xffffffffu, bi, off);
        take_better(best, bi, v2, i2);
      }
      if (lane == 0) {
        rowmax[i] = best;
        rowarg[i] = bi;
      }
    }
    for (int j = tid; j < n; j += THREADS) {
      int bi = 0;
      if (!struck[j]) {
        float best = -INFINITY;
        for (int i = 0; i < n; ++i) {
          if (assign[i] >= 0) continue;
          const float v = plan[(size_t)i * n + j];
          if (v > best) {
            best = v;
            bi = i;
          }
        }
      }
      colarg[j] = bi;
    }
    __syncthreads();
    for (int i = tid; i < n; i += THREADS) {
      if (assign[i] >= 0) continue;
      const int j = rowarg[i];
      if (colarg[j] == i && rowmax[i] > -INFINITY) {
        assign[i] = j;
        struck[j] = 1;
        atomicSub(&remaining, 1);
      }
    }
    ++rounds;
    __syncthreads();
  }
  for (int i = tid; i < n; i += THREADS) out[i] = assign[i];
  if (tid == 0) *rounds_out = rounds;
}

// The scratch: 6 n + 3 zeroed 8-byte words — the column keys, two
// buffers of published row words, two of column words, the beats (n
// 4-byte words, blocks <= n), the entry count and four 4-byte counters
// (ops/rounding.py sizes and reads it the same way).
State carve(void* scratch, int n) {
  State st;
  auto* w = static_cast<unsigned long long*>(scratch);
  st.colkey = w;
  st.rowpub[0] = w + (size_t)n;
  st.rowpub[1] = w + 2 * (size_t)n;
  st.colpub[0] = w + 3 * (size_t)n;
  st.colpub[1] = w + 4 * (size_t)n;
  st.beat = reinterpret_cast<unsigned*>(w + 5 * (size_t)n);
  st.entries = w + 6 * (size_t)n;
  st.ctr = reinterpret_cast<unsigned*>(st.entries + 1);
  return st;
}

}  // namespace

// Both entry points: plan (n, n) f32 in; out (n,) int32 permutation (-1
// where unassigned); rounds_out () int32.

// The current design: one cooperative launch on `stream`, with the zeroed
// scratch (see carve). Counts its launch into the host int *launched and
// returns the first CUDA error.
extern "C" int round_dominant_launch(const float* plan, int* out,
                                     int* rounds_out, void* scratch, int n,
                                     int max_rounds, int* launched,
                                     void* stream) {
  *launched = 0;
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int r = (n + sms - 1) / sms;                // one block per SM
  const int blocks = (n + r - 1) / r;
  const size_t smem = (2 * (size_t)((n + 31) / 32) + 2 * (size_t)r) *
                      sizeof(unsigned);
  if (smem + sizeof(Shared) > 48 * 1024)
    err = cudaFuncSetAttribute(round_persistent_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, round_persistent_kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  State st = carve(scratch, n);
  void* args[] = {&plan, &out, &rounds_out, &st, &n, &r, &max_rounds};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(round_persistent_kernel), dim3(blocks),
      dim3(THREADS), args, smem, static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  *launched = 1;
  return cudaSuccess;
}

// The single-block design; needs 17 n bytes of shared memory (n <= 13,673 on an
// H100) and returns cudaErrorInvalidValue past that.
extern "C" int round_dominant_single_block_launch(const float* plan, int* out,
                                                  int* rounds_out, int n,
                                                  int max_rounds,
                                                  void* stream) {
  const size_t smem = 17 * (size_t)n;
  if (smem + sizeof(int) > 232448) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        round_dominant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  round_dominant_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(
                                                stream)>>>(
      plan, out, rounds_out, n, max_rounds);
  return cudaGetLastError();
}
