// K9 — lexicographic sort of int32 triples (replaces
// fast_limo_tpu/ops/sort.py:sort3_tpu, TPU body _sort_kernel).
//
// Sorts (k1, k2, v) ascending by the key (k1, k2, v), signed int32
// compares, exactly for any multiset (a repeated v included): with a
// unique v (the callers pass an arange) the result is the stable 2-key
// sort by (k1, k2).
//
// On the H100 the work is bound by moving 24 bytes an element (three int32
// read, three written): 0.23 us at N = 32768.  What costs at the callers'
// sizes (10^4 to 2.6·10^5 elements a scan, 2^18 in a map rebuild) is
// latency: launches, passes over device memory, grid-wide barriers.  So
// the design is ONE cooperative launch of co-resident blocks, one 512-thread
// block an SM, for every N from 1 to 2^31 - 1: a stable LSD radix sort over
// 8-bit digits, least significant first — v, then k2, then k1, each digit
// of the sign-flipped bits — in the Onesweep style (Adinets & Merrill 2022;
// decoupled look-back: Merrill & Garland 2016), the triples in device
// memory (at 262 144 triples the two buffers, 6.3 MB, stay in the 50 MB L2):
//   * one read of the input first takes the skip rule's AND / OR and
//     out-of-order flags and the 256-bin counts of all twelve digits (a
//     pass only permutes the array, so each pass's digit totals are the
//     input's); the blocks add theirs into a global table, and after a
//     grid barrier every block holds every taken pass's digit bases;
//   * passes that cannot move anything are skipped, by every block alike: a
//     digit whose 8 bits agree in every element (its AND equals its OR) is
//     constant, so a stable pass over it is the identity, and so are the v
//     passes of an input already in v order and the v and k2 passes of one
//     in (k2, v) order.  The voxel sort (k2 = v = arange) thus runs its 4
//     passes over k1 only, the insert sort (v = arange) the passes over k1
//     and k2 whose digits vary;
//   * a pass walks tiles of FL_SORTG_TILE elements, block b taking tiles
//     b, b + G, ... in increasing order, the next tile's loads in flight
//     while this one is ranked.  Inside a tile each warp ranks its
//     contiguous segment stably (rounds of 32 in order; a lane's peers of
//     the same digit from eight ballots, one a digit bit), the warps'
//     counts are scanned in warp order, and the tile is reordered by digit
//     in shared memory;
//   * each tile publishes its 256 digit counts to a status table ("aggregate"),
//     looks back over the lower tiles' words — a window of FL_SORTG_LOOK at
//     a time — until it meets an "inclusive prefix", and publishes its own.
//     Every block is resident and a tile waits only on lower tiles, which
//     their blocks reach without waiting on higher ones, so the wait ends;
//     every position is still an integer sum (digit base, the lower tiles'
//     counts, the place in the reordered tile), so no atomic decides where
//     an element goes;
//   * from the reordered tile, thread i writes element i to its digit's
//     run: consecutive threads write consecutive addresses of a run;
//   * one grid barrier ends each pass but the last.  The passes ping-pong
//     between the output and one scratch of N triples, chosen so that the
//     last pass lands in the output.
// The kernel therefore sorts exactly as sort3_plain, for any int32 values
// (tests/test_torch_k9_grid_schedule.py emulates its schedule on the CPU).
// A pass's bytes (24 an element at 3.35 TB/s) take 0.002 ms at 2^18 and
// 0.03 ms at 2^22; what costs beyond them is the grid barriers, the
// look-back over the tiles in flight and the warps' ranks (k9_phases.py
// splits a pass).  Below one tile a single block sorts the whole input.
#include "common.cuh"

__device__ __forceinline__ unsigned fl_digit(int x, int shift) {
  return (((unsigned)x ^ 0x80000000u) >> shift) & 0xFFu;
}

// ------------------------------------------------ the tile and the table
// (PERF.md §6: 512 × 4 measured against 256 × 8 two blocks an SM, 512 × 6,
// 512 × 8 and 256 × 16; windows of 8 against 4, 16 and 32)
#define FL_SORTG_THREADS 512                                   // threads a block
#define FL_SORTG_ITEMS 4                                       // elements a thread holds, a tile
#define FL_SORTG_LOOK 8                                        // status words read at once
#define FL_SORTG_WARPS (FL_SORTG_THREADS / 32)
#define FL_SORTG_SEG (32 * FL_SORTG_ITEMS)                     // a warp's contiguous segment
#define FL_SORTG_TILE (FL_SORTG_THREADS * FL_SORTG_ITEMS)      // elements a tile
#define FL_SORTG_HEAD (12 * 256 + 8)   // ints of the table before the status words
#define FL_SORTG_DYN (3 * FL_SORTG_TILE * sizeof(int))   // dynamic shared memory: the tile

static_assert(FL_SORTG_THREADS % 256 == 0 && FL_SORTG_THREADS <= 1024,
              "the grid kernel's first 256 threads take one digit each");

static_assert(FL_SORTG_TILE >= 4 * 256, "the input's digit counts share the tile's memory");

// static shared memory of one block; the dynamic part holds the tile
// reordered by digit [3][FL_SORTG_TILE], and before the passes the input's
// digit counts [12][256]
struct FlSortGridShared {
  int warp_cnt[FL_SORTG_WARPS][256];   // per-warp digit counts, then the lower warps' in the tile
  int start[256];                      // where each digit's run starts in the reordered tile
  int to[256];                         // where tile index 0 of each digit's run would go
  int base[12][256];                   // each pass's count of smaller digits over the array
  int scan[FL_SORTG_WARPS];
  unsigned red[FL_SORTG_WARPS][8];     // per-warp AND ×3, OR ×3, out-of-order flags ×2
  unsigned all[8];                     // the block's, then the grid's
};

// Whether pass p (operand 2 - p/4, digit p%4) can move nothing: the skip
// rule on the grid's reduced AND / OR and order flags.
__device__ __forceinline__ bool fl_sort_skip(const unsigned* all, int p) {
  const int op = 2 - p / 4, shift = 8 * (p % 4);
  const bool constant = (((all[op] ^ all[3 + op]) >> shift) & 0xFFu) == 0u;
  const bool in_order = (op == 2 && all[6] == 0u) || (op >= 1 && all[7] == 0u);
  return constant || in_order;
}

// The exclusive prefix of x over the block's threads in thread order (the
// first 256 read theirs); every thread calls it, and `scan` is free again
// after the next barrier.
__device__ __forceinline__ int fl_sortg_excl(int x, int* scan) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FL_FULL, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) scan[wid] = incl;
  __syncthreads();
  int add = 0;
  for (int w = 0; w < wid; ++w) add += scan[w];
  return incl - x + add;
}

// A tile's elements of this thread: warp w's segment [w·SEG, (w+1)·SEG) of
// the tile at t0, round q at w·SEG + 32q + lane.  Buffers written earlier
// in the launch are read through L2 (__ldcg), never the non-coherent path.
__device__ __forceinline__ void fl_sortg_load(const int* a, const int* b, const int* c,
                                              long long t0, int N, int seg0,
                                              int (&x)[3][FL_SORTG_ITEMS]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < FL_SORTG_ITEMS; ++q) {
    const long long e = t0 + seg0 + q * 32 + lane;
    const bool ok = e < N;
    x[0][q] = ok ? __ldcg(a + e) : 0;
    x[1][q] = ok ? __ldcg(b + e) : 0;
    x[2][q] = ok ? __ldcg(c + e) : 0;
  }
}

// The lanes of the warp whose 8-bit digit equals this lane's, among the
// lanes in `live`: one ballot a bit (__match_any_sync costs more the more
// distinct values a warp holds; eight ballots cost the same for any).
__device__ __forceinline__ unsigned fl_sortg_peers(unsigned d, unsigned live) {
  unsigned m = live;
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    const unsigned on = __ballot_sync(FL_FULL, (d >> bit) & 1u);
    m &= ((d >> bit) & 1u) ? on : ~on;
  }
  return m;
}

// The look-back's status words: the pass code in the high half (2·taken + 1
// "aggregate", 2·taken + 2 "inclusive prefix"; any other value — the zero
// the launch starts from, an earlier pass's — is not ready), a count in the
// low half.  Relaxed loads and stores at device scope: the word carries its
// own count, so no other data is ordered by it.
__device__ __forceinline__ unsigned long long fl_sortg_peek(const unsigned long long* p) {
  unsigned long long x;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(x) : "l"(p) : "memory");
  return x;
}
__device__ __forceinline__ void fl_sortg_post(unsigned long long* p, unsigned long long x) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(x) : "memory");
}

// table: the twelve passes' digit totals [12][256], the grid's skip words
// [8] (AND ×3, OR ×3, order flags ×2), then one 64-bit status word a tile
// and digit [ntiles][256], all set up by the launch itself.  o1..o3 and
// t1..t3 are the two buffers of N triples.
__global__ void __launch_bounds__(FL_SORTG_THREADS, 1)
fl_sort3_grid_kernel(const int* __restrict__ k1, const int* __restrict__ k2,
                     const int* __restrict__ v, int N, int* o1, int* o2, int* o3, int* t1,
                     int* t2, int* t3, int* table) {
  extern __shared__ int dyn[];
  int(*const tile)[FL_SORTG_TILE] = reinterpret_cast<int(*)[FL_SORTG_TILE]>(dyn);
  int(*const hist)[256] = reinterpret_cast<int(*)[256]>(dyn);
  __shared__ FlSortGridShared s;
  cg::grid_group grid = cg::this_grid();
  const int G = (int)gridDim.x, b = (int)blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int seg0 = wid * FL_SORTG_SEG;
  const bool dig = tid < 256;   // the thread of digit tid
  const int ntiles = (int)(((long long)N + FL_SORTG_TILE - 1) / FL_SORTG_TILE);
  int* totals = table;
  unsigned* words = reinterpret_cast<unsigned*>(table + 12 * 256);
  unsigned long long* status = reinterpret_cast<unsigned long long*>(table + FL_SORTG_HEAD);

  // ---- set the table up; read the input once: skip words, digit counts ----
  {
    const long long nstat = (long long)ntiles * 256;
    for (long long i = (long long)b * FL_SORTG_THREADS + tid; i < nstat;
         i += (long long)G * FL_SORTG_THREADS)
      status[i] = 0ull;
    if (b == 0) {
      for (int i = tid; i < 12 * 256; i += FL_SORTG_THREADS) totals[i] = 0;
      if (tid < 8) words[tid] = tid < 3 ? ~0u : 0u;
    }
  }
  for (int i = tid; i < 12 * 256; i += FL_SORTG_THREADS) (&hist[0][0])[i] = 0;
  __syncthreads();
  unsigned r[8] = {~0u, ~0u, ~0u, 0u, 0u, 0u, 0u, 0u};
  for (int t = b; t < ntiles; t += G) {
    const long long t0 = (long long)t * FL_SORTG_TILE;
    int x[3][FL_SORTG_ITEMS];
    fl_sortg_load(k1, k2, v, t0, N, seg0, x);
    // the element before the warp's segment, for its first element's order
    const long long e0 = t0 + seg0;
    const bool head = lane == 0 && e0 > 0 && e0 <= N;
    const int hb = head ? __ldcg(k2 + e0 - 1) : 0, hc = head ? __ldcg(v + e0 - 1) : 0;
#pragma unroll
    for (int q = 0; q < FL_SORTG_ITEMS; ++q) {
      const long long e = t0 + seg0 + q * 32 + lane;
      if (t0 + seg0 + q * 32 >= N) break;   // warp-uniform
      const bool ok = e < N;
      const int a = x[0][q], bb = x[1][q], c = x[2][q];
      int pb = __shfl_up_sync(FL_FULL, bb, 1), pc = __shfl_up_sync(FL_FULL, c, 1);
      if (q == 0) {   // element e against e - 1: lane 0 of a round takes the last round's lane 31
        pb = lane == 0 ? hb : pb;
        pc = lane == 0 ? hc : pc;
      } else {
        const int lb = __shfl_sync(FL_FULL, x[1][q > 0 ? q - 1 : 0], 31);
        const int lc = __shfl_sync(FL_FULL, x[2][q > 0 ? q - 1 : 0], 31);
        pb = lane == 0 ? lb : pb;
        pc = lane == 0 ? lc : pc;
      }
      if (ok) {
        r[0] &= (unsigned)a; r[1] &= (unsigned)bb; r[2] &= (unsigned)c;
        r[3] |= (unsigned)a; r[4] |= (unsigned)bb; r[5] |= (unsigned)c;
        if (e > 0) {
          r[6] |= pc > c ? 1u : 0u;
          r[7] |= (pb > bb || (pb == bb && pc > c)) ? 1u : 0u;
        }
      }
#pragma unroll
      for (int p = 0; p < 12; ++p) {   // a digit the whole warp shares is added once
        const int y = p < 4 ? c : (p < 8 ? bb : a);
        const unsigned d = fl_digit(y, 8 * (p & 3));
        const unsigned d0 = __shfl_sync(FL_FULL, d, 0);   // every lane, before the vote
        const bool one = __all_sync(FL_FULL, ok && d == d0);
        if (ok && (!one || lane == 0)) atomicAdd(&hist[p][d], one ? 32 : 1);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) r[j] = __reduce_and_sync(FL_FULL, r[j]);
#pragma unroll
  for (int j = 3; j < 8; ++j) r[j] = __reduce_or_sync(FL_FULL, r[j]);
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < 8; ++j) s.red[wid][j] = r[j];
  __syncthreads();
  if (tid < 8) {
    unsigned m = tid < 3 ? ~0u : 0u;
    for (int w = 0; w < FL_SORTG_WARPS; ++w) m = tid < 3 ? (m & s.red[w][tid]) : (m | s.red[w][tid]);
    s.all[tid] = m;
  }
  grid.sync();   // the table is set up
  for (int i = tid; i < 12 * 256; i += FL_SORTG_THREADS) {
    const int c = (&hist[0][0])[i];
    if (c) atomicAdd(totals + i, c);
  }
  if (tid < 8) {
    if (tid < 3) atomicAnd(words + tid, s.all[tid]);
    else atomicOr(words + tid, s.all[tid]);
  }
  grid.sync();   // every count and word is in
  if (tid < 8) s.all[tid] = __ldcg(words + tid);
  __syncthreads();   // every block holds the same words, so takes the same passes
  int P = 0;
  for (int p = 0; p < 12; ++p) P += fl_sort_skip(s.all, p) ? 0 : 1;
  {   // each taken pass's count of smaller digits over the array
    int total[12];
#pragma unroll
    for (int p = 0; p < 12; ++p)
      total[p] = dig && !fl_sort_skip(s.all, p) ? __ldcg(totals + p * 256 + tid) : 0;
#pragma unroll
    for (int p = 0; p < 12; ++p) {
      if (fl_sort_skip(s.all, p)) continue;   // block-uniform
      const int below = fl_sortg_excl(total[p], s.scan);
      if (dig) s.base[p][tid] = below;
      __syncthreads();   // s.scan is free again
    }
  }

  // ---- the passes: v, k2, k1; 8-bit digits, least significant first ----
  const int *s0 = k1, *s1 = k2, *s2 = v;
  int taken = 0;
  for (int p = 0; p < 12; ++p) {
    if (fl_sort_skip(s.all, p)) continue;
    const int op = 2 - p / 4, shift = 8 * (p % 4);
    const bool odd = ((P - 1 - taken) & 1) != 0;   // the last pass lands in o
    int* const d0 = odd ? t1 : o1;
    int* const d1 = odd ? t2 : o2;
    int* const d2 = odd ? t3 : o3;
    const unsigned long long agg = (unsigned long long)(2 * taken + 1) << 32;
    const unsigned long long inc = agg + (1ull << 32);
    int nx[3][FL_SORTG_ITEMS];
    if (b < ntiles) fl_sortg_load(s0, s1, s2, (long long)b * FL_SORTG_TILE, N, seg0, nx);
    for (int t = b; t < ntiles; t += G) {
      const long long t0 = (long long)t * FL_SORTG_TILE;
      const int cnt = (int)min((long long)FL_SORTG_TILE, (long long)N - t0);
      int x[3][FL_SORTG_ITEMS];
#pragma unroll
      for (int q = 0; q < FL_SORTG_ITEMS; ++q)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          x[j][q] = nx[j][q];
          asm volatile("" : "+r"(x[j][q]));   // here, so nx is free for the next tile's loads
        }
      if (t + G < ntiles)   // the next tile's loads, in flight while this one is ranked
        fl_sortg_load(s0, s1, s2, (long long)(t + G) * FL_SORTG_TILE, N, seg0, nx);

      // stable rank of each element among its warp segment's of its digit
      for (int j = lane; j < 256; j += 32) s.warp_cnt[wid][j] = 0;
      __syncwarp();
      int rk[FL_SORTG_ITEMS];
      unsigned dg[FL_SORTG_ITEMS];
#pragma unroll
      for (int q = 0; q < FL_SORTG_ITEMS; ++q) {
        rk[q] = 0;
        dg[q] = 256u;
        if (seg0 + q * 32 < cnt) {   // warp-uniform
          const int e = seg0 + q * 32 + lane;
          const bool ok = e < cnt;
          const int key = op == 0 ? x[0][q] : (op == 1 ? x[1][q] : x[2][q]);
          const unsigned d = ok ? fl_digit(key, shift) : 256u;
          const unsigned peers = fl_sortg_peers(d, __ballot_sync(FL_FULL, ok));
          const int below = __popc(peers & ((1u << lane) - 1u));
          const int before = ok ? s.warp_cnt[wid][d] : 0;
          __syncwarp();
          if (ok && below == 0) s.warp_cnt[wid][d] = before + __popc(peers);
          __syncwarp();
          rk[q] = before + below;
          dg[q] = d;
        }
      }
      __syncthreads();
      // the tile's count of digit tid and the lower warps' in the tile; publish
      int own = 0;
      unsigned long long* const mine = status + (size_t)t * 256 + (dig ? tid : 0);
      if (dig) {
        for (int w = 0; w < FL_SORTG_WARPS; ++w) {
          const int c = s.warp_cnt[w][tid];
          s.warp_cnt[w][tid] = own;
          own += c;
        }
        fl_sortg_post(mine, (t == 0 ? inc : agg) | (unsigned)own);
      }
      const int run0 = fl_sortg_excl(own, s.scan);
      if (dig) s.start[tid] = run0;
      __syncthreads();
      // reorder the tile by digit in shared memory
#pragma unroll
      for (int q = 0; q < FL_SORTG_ITEMS; ++q)
        if (dg[q] < 256u) {
          const int at = s.start[dg[q]] + s.warp_cnt[wid][dg[q]] + rk[q];
          tile[0][at] = x[0][q];
          tile[1][at] = x[1][q];
          tile[2][at] = x[2][q];
        }

      // look back over the lower tiles' counts of digit tid, a window of
      // words at a time, from the nearest down to the first inclusive prefix
      unsigned prefix = 0;
      if (dig && t > 0) {
        int j = t - 1;
        bool done = false;
        while (!done) {
          unsigned long long w[FL_SORTG_LOOK];
#pragma unroll
          for (int k = 0; k < FL_SORTG_LOOK; ++k)
            w[k] = j - k >= 0 ? fl_sortg_peek(status + (size_t)(j - k) * 256 + tid) : 0ull;
          int used = 0;
#pragma unroll
          for (int k = 0; k < FL_SORTG_LOOK; ++k) {
            const unsigned f = (unsigned)(w[k] >> 32) - 2u * (unsigned)taken;
            if (f != 1u && f != 2u) break;   // not ready: read again from here
            prefix += (unsigned)w[k];
            used = k + 1;
            if (f == 2u) {
              done = true;
              break;
            }
          }
          j -= used;
        }
        fl_sortg_post(mine, inc | (prefix + (unsigned)own));
      }
      if (dig) s.to[tid] = s.base[p][tid] + (int)prefix - s.start[tid];
      __syncthreads();

      // thread i writes element i of the reordered tile to its digit's run
#pragma unroll
      for (int q = 0; q < FL_SORTG_ITEMS; ++q) {
        const int i = q * FL_SORTG_THREADS + tid;
        if (i < cnt) {
          const int pos = s.to[fl_digit(tile[op][i], shift)] + i;
          d0[pos] = tile[0][i];
          d1[pos] = tile[1][i];
          d2[pos] = tile[2][i];
        }
      }
      __syncthreads();   // the next tile reuses the shared arrays
    }
    s0 = d0;
    s1 = d1;
    s2 = d2;
    if (++taken < P) {
      grid.sync();   // every element has landed
    }
  }

  if (P == 0)   // nothing to move: the input is the result
    for (long long i = (long long)b * FL_SORTG_THREADS + tid; i < N;
         i += (long long)G * FL_SORTG_THREADS) {
      o1[i] = k1[i];
      o2[i] = k2[i];
      o3[i] = v[i];
    }
}

// The kernel's resident block count, one a streaming multiprocessor,
// or the (negated) CUDA error that keeps them from being resident at once.
// Asked once; a launch takes min(this, tiles) blocks.
extern "C" int fl_sort3_grid_blocks() {
  static int blocks = 0;
  static const cudaError_t e = [] {
    cudaError_t r = cudaFuncSetAttribute(fl_sort3_grid_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)FL_SORTG_DYN);
    if (r != cudaSuccess) return r;
    return fl_grid_blocks(fl_sort3_grid_kernel, FL_SORTG_THREADS, FL_SORTG_DYN, &blocks);
  }();
  return e == cudaSuccess ? blocks : -(int)e;
}

// Ints of the kernel's table for N elements: the digit totals, the skip
// words and two ints a status word (one a tile and digit).
extern "C" int fl_sort3_grid_table(int N) {
  const long long ntiles = ((long long)N + FL_SORTG_TILE - 1) / FL_SORTG_TILE;
  return (int)(FL_SORTG_HEAD + 2 * 256 * ntiles);
}

// Sorts the N triples (k1, k2, v) into o1..o3 (N elements each) with t1..t3
// (N elements each) and the table (fl_sort3_grid_table(N) ints) as
// scratch, in one launch of min(fl_sort3_grid_blocks(), tiles) blocks.
// Returns a CUDA error code (0 on success); N < 1 is refused.
extern "C" int fl_sort3(const int* k1, const int* k2, const int* v, int N, int* o1, int* o2,
                        int* o3, int* t1, int* t2, int* t3, int* table, cudaStream_t stream) {
  if (N < 1 || !t1 || !t2 || !t3 || !table) return (int)cudaErrorInvalidValue;
  const int G = fl_sort3_grid_blocks();
  if (G < 0) return -G;
  const int ntiles = (int)(((long long)N + FL_SORTG_TILE - 1) / FL_SORTG_TILE);
  FlGridLaunch L(G < ntiles ? G : ntiles, FL_SORTG_THREADS, stream);
  L.cfg.dynamicSmemBytes = FL_SORTG_DYN;
  cudaError_t e = cudaLaunchKernelEx(&L.cfg, fl_sort3_grid_kernel, k1, k2, v, N, o1, o2, o3, t1,
                                     t2, t3, table);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
