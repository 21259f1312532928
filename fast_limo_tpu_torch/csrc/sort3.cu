// K9 — lexicographic sort of int32 triples (replaces
// fast_limo_tpu/ops/sort.py:sort3_tpu, TPU body _sort_kernel).
//
// Sorts (k1, k2, v) ascending by the key (k1, k2, v), signed int32
// compares, exactly for any multiset (a repeated v included): with a
// unique v (the callers pass an arange) the result is the stable 2-key
// sort by (k1, k2).
//
// On the H100 the work is bound by moving 24 bytes an element (three int32
// read, three written): 0.23 us at N = 32768.  What costs at these sizes
// (10^4 to 10^5 elements) is latency: launches, passes over device memory,
// grid-wide barriers.  So the design is ONE launch of ONE thread-block
// cluster of 16 blocks that keeps the triples on chip for the whole sort:
//   * block r owns the contiguous slice [r·per, (r+1)·per) of the array,
//     per = ceil(N / 16) <= 8192, its three operands double-buffered in its
//     shared memory (24 B an element: 192 KB at the cap);
//   * a stable LSD radix sort over 8-bit digits, least significant first:
//     v, then k2, then k1, each digit of the sign-flipped bits.  A pass
//     ranks the block's elements stably by warp ballots (__match_any_sync)
//     in element order — each warp a contiguous segment, rounds of 32 in
//     order, per-warp digit counts scanned in warp order — publishes the
//     block's digit counts, and after a cluster barrier every block reads
//     all 16 blocks' counts through distributed shared memory: an
//     element's destination is the count of smaller digits over the whole
//     array, plus the count of its digit in lower-ranked blocks, plus its
//     rank in its block.  It is scattered straight into the destination
//     block's other buffer (DSMEM), and a second cluster barrier ends the
//     pass.  No pass touches device memory: the input is read once and the
//     result written once.
//   * passes that cannot move anything are skipped, by every block alike:
//     one cluster reduction first takes the AND and the OR of each operand
//     (a digit whose 8 bits agree in every element is constant: a stable
//     pass over it is the identity) and whether the input is already in v
//     order and in (k2, v) order (then the v passes, or the v and k2
//     passes, are the identity too).  The voxel sort (k2 = v = arange) thus
//     runs its 4 passes over k1 only, the insert sort (v = arange) the
//     passes over k1 and k2 whose digits vary.  Every block reads the same
//     reduced values after the same barrier, so all take the same passes
//     and meet at the same barriers.
// The cluster holds N <= FL_SORT_MAXN (2^17, 16 blocks × 8192) triples:
// the voxel sort of an HDL-64 scan (~125 000 points).
//
// Above 2^17 (a 128-beam scan of 262 144 points, a SLAM map rebuild of 32
// keyframe clouds) the triples no longer fit on chip, and fl_sort3 takes
// a second kernel, fl_sort3_grid_kernel: the same LSD radix sort, the same
// digits, order and skip rule, as ONE cooperative launch of one block a
// streaming multiprocessor that meets at grid barriers and keeps the
// triples in device memory (at 262 144 triples the two buffers, 6.3 MB,
// stay in the 50 MB L2):
//   * block b owns the contiguous tile [b·per, (b+1)·per), per = ceil(N/G);
//   * the skip rule's AND / OR and out-of-order flags are reduced over the
//     grid through a global table (each tile's first element compared
//     with the previous tile's last), so every block takes the same passes;
//   * a pass counts the tile's digits (shared-memory counts of warp
//     ballots), publishes them to a global [G][256] table, and after a grid
//     barrier every block sums all blocks' counts in block order: an
//     element's destination is the count of smaller digits over the whole
//     array, plus the count of its digit in lower blocks, plus its rank in
//     its tile.  The tile is ranked and scattered a chunk of 4096 elements
//     at a time (each warp a contiguous 256, rounds of 32 in order, ranks by
//     __match_any_sync, per-warp counts scanned in warp order) with a
//     running offset per digit carried from chunk to chunk, so the scatter
//     is stable in element order and no atomic decides a position.  The
//     scatter writes the other of two buffers, the output and a scratch of
//     the same size, chosen so that the last pass lands in the output; a
//     second grid barrier ends the pass.
// Both kernels therefore sort exactly as sort3_plain, for any int32 values
// (tests/test_torch_k9_grid_schedule.py emulates the grid kernel's
// schedule on the CPU).
#include "common.cuh"

#define FL_SORT_CLUSTER 16
#define FL_SORT_THREADS 512
#define FL_SORT_WARPS (FL_SORT_THREADS / 32)
#define FL_SORT_MAXN (1 << 17)
#define FL_SORT_PER (FL_SORT_MAXN / FL_SORT_CLUSTER)       // elements a block, at most
#define FL_SORT_ROUNDS (FL_SORT_PER / FL_SORT_THREADS)     // rounds of 32 a warp, at most
#define FL_SORT_SMEM_MAX (6 * sizeof(int) * FL_SORT_PER)   // the double buffer at the cap

// static shared memory of one block (the double buffer is dynamic)
struct FlSortShared {
  int warp_cnt[FL_SORT_WARPS][256];   // per-warp digit counts, then their warp offsets
  int count[256];                     // the block's digit counts, read by every rank
  int offset[256];                    // where the block's first element of each digit goes
  int scan[8];                        // totals of the 8 warps that scan the 256 digits
  unsigned red[FL_SORT_WARPS][8];     // per-warp AND ×3, OR ×3, out-of-order flags ×2
  unsigned mine[8];                   // the block's, read by every rank
  unsigned all[8];                    // the cluster's
};

__device__ __forceinline__ unsigned fl_digit(int x, int shift) {
  return (((unsigned)x ^ 0x80000000u) >> shift) & 0xFFu;
}

__global__ void __launch_bounds__(FL_SORT_THREADS, 1)
fl_sort3_kernel(const int* __restrict__ k1, const int* __restrict__ k2, const int* __restrict__ v,
                int N, int per, int* __restrict__ o1, int* __restrict__ o2,
                int* __restrict__ o3) {
  extern __shared__ int buf[];   // [2][3][per]: two copies of (k1, k2, v)
  __shared__ FlSortShared s;
  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int base = (int)rank * per;
  const int cnt = max(0, min(per, N - base));

  // ---- load the slice; AND / OR of each operand; order of (k2, v) ----
  unsigned r[8] = {~0u, ~0u, ~0u, 0u, 0u, 0u, 0u, 0u};
  for (int i = tid; i < cnt; i += FL_SORT_THREADS) {
    const int g = base + i;
    const int a = k1[g], b = k2[g], c = v[g];
    buf[i] = a;
    buf[per + i] = b;
    buf[2 * per + i] = c;
    r[0] &= (unsigned)a; r[1] &= (unsigned)b; r[2] &= (unsigned)c;
    r[3] |= (unsigned)a; r[4] |= (unsigned)b; r[5] |= (unsigned)c;
    if (g > 0) {
      const int pb = k2[g - 1], pc = v[g - 1];
      r[6] |= pc > c ? 1u : 0u;
      r[7] |= (pb > b || (pb == b && pc > c)) ? 1u : 0u;
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
    for (int w = 0; w < FL_SORT_WARPS; ++w) m = tid < 3 ? (m & s.red[w][tid]) : (m | s.red[w][tid]);
    s.mine[tid] = m;
  }
  cl.sync();
  if (tid < 8) {
    unsigned m = tid < 3 ? ~0u : 0u;
    for (unsigned q = 0; q < cl.num_blocks(); ++q) {
      const unsigned x = cl.map_shared_rank(&s.mine[0], q)[tid];
      m = tid < 3 ? (m & x) : (m | x);
    }
    s.all[tid] = m;
  }
  cl.sync();   // every block has read every s.mine; the values in s.all agree

  // ---- the passes: v, k2, k1; 8-bit digits, least significant first ----
  const int S = (cnt + FL_SORT_WARPS - 1) / FL_SORT_WARPS;   // a warp's segment
  const int w0 = min(wid * S, cnt), w1 = min(w0 + S, cnt);
  int cur = 0;
  for (int p = 0; p < 12; ++p) {
    const int op = 2 - p / 4;          // operand: 2 = v, 1 = k2, 0 = k1
    const int shift = 8 * (p % 4);
    const bool constant = (((s.all[op] ^ s.all[3 + op]) >> shift) & 0xFFu) == 0u;
    const bool in_order = (op == 2 && s.all[6] == 0u) || (op >= 1 && s.all[7] == 0u);
    if (constant || in_order) continue;   // the same for every block

    const int* src = buf + cur * 3 * per;
    int* dst = buf + (cur ^ 1) * 3 * per;
    const int* key = src + op * per;

    // stable rank of each element among the block's elements of its digit
    for (int j = tid; j < FL_SORT_WARPS * 256; j += FL_SORT_THREADS) (&s.warp_cnt[0][0])[j] = 0;
    __syncthreads();
    int rk[FL_SORT_ROUNDS];
#pragma unroll
    for (int q = 0; q < FL_SORT_ROUNDS; ++q) {
      rk[q] = 0;
      if (w0 + q * 32 < w1) {   // warp-uniform
        const int e = w0 + q * 32 + lane;
        const bool in = e < w1;
        const unsigned d = in ? fl_digit(key[e], shift) : 256u;
        const unsigned peers = __match_any_sync(FL_FULL, d);
        const int below = __popc(peers & ((1u << lane) - 1u));
        const int before = in ? s.warp_cnt[wid][d] : 0;
        __syncwarp();
        if (in && below == 0) s.warp_cnt[wid][d] = before + __popc(peers);
        __syncwarp();
        rk[q] = before + below;
      }
    }
    __syncthreads();
    if (tid < 256) {   // warp offsets in warp order; the block's counts
      int run = 0;
      for (int w = 0; w < FL_SORT_WARPS; ++w) {
        const int c = s.warp_cnt[w][tid];
        s.warp_cnt[w][tid] = run;
        run += c;
      }
      s.count[tid] = run;
    }
    cl.sync();
    if (tid < 256) {   // digit totals of the cluster, and of the lower ranks
      int total = 0, lower = 0;
      for (unsigned q = 0; q < cl.num_blocks(); ++q) {
        const int c = cl.map_shared_rank(&s.count[0], q)[tid];
        total += c;
        lower += q < rank ? c : 0;
      }
      int incl = total;   // exclusive scan of the totals over the 256 digits
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FL_FULL, incl, off);
        if (lane >= off) incl += y;
      }
      if (lane == 31) s.scan[wid] = incl;
      s.offset[tid] = incl - total + lower;
    }
    __syncthreads();
    if (tid < 256) {
      int add = 0;
      for (int w = 0; w < wid; ++w) add += s.scan[w];
      s.offset[tid] += add;
    }
    __syncthreads();

    // scatter into the destination block's other buffer
#pragma unroll
    for (int q = 0; q < FL_SORT_ROUNDS; ++q) {
      const int e = w0 + q * 32 + lane;
      if (w0 + q * 32 < w1 && e < w1) {
        const unsigned d = fl_digit(key[e], shift);
        const int pos = s.offset[d] + s.warp_cnt[wid][d] + rk[q];
        const int to = pos / per, at = pos - to * per;
        int* rd = cl.map_shared_rank(dst, (unsigned)to);
        rd[at] = src[e];
        rd[per + at] = src[per + e];
        rd[2 * per + at] = src[2 * per + e];
      }
    }
    cl.sync();   // every element has landed; no block reads a count any more
    cur ^= 1;
  }

  // ---- write the slice ----
  const int* fin = buf + cur * 3 * per;
  for (int i = tid; i < cnt; i += FL_SORT_THREADS) {
    o1[base + i] = fin[i];
    o2[base + i] = fin[per + i];
    o3[base + i] = fin[2 * per + i];
  }
}

// ------------------------------------------------ above 2^17: the grid
#define FL_SORTG_THREADS 512
#define FL_SORTG_WARPS (FL_SORTG_THREADS / 32)
#define FL_SORTG_ROUNDS 8                                      // rounds of 32 a warp, a chunk
#define FL_SORTG_SEG (32 * FL_SORTG_ROUNDS)                    // a warp's segment of a chunk
#define FL_SORTG_CHUNK (FL_SORTG_THREADS * FL_SORTG_ROUNDS)    // elements ranked at once

struct FlSortGridShared {
  int warp_cnt[FL_SORTG_WARPS][256];   // per-warp digit counts, then where each warp's go
  int count[256];                      // the block's digit counts
  int run[256];                        // where the block's next element of each digit goes
  int scan[8];                         // totals of the 8 warps that scan the 256 digits
  unsigned red[FL_SORTG_WARPS][8];     // per-warp AND ×3, OR ×3, out-of-order flags ×2
  unsigned all[8];                     // the grid's
};

// Whether pass p (operand 2 - p/4, digit p%4) can move nothing: the rule of
// fl_sort3_kernel on the grid's reduced AND / OR and order flags.
__device__ __forceinline__ bool fl_sort_skip(const unsigned* all, int p) {
  const int op = 2 - p / 4, shift = 8 * (p % 4);
  const bool constant = (((all[op] ^ all[3 + op]) >> shift) & 0xFFu) == 0u;
  const bool in_order = (op == 2 && all[6] == 0u) || (op >= 1 && all[7] == 0u);
  return constant || in_order;
}

// table: [G][256] digit counts, then [G][8] reduction words.  o1..o3 and
// t1..t3 are the two buffers of N triples; they are written and read
// again in the launch, so they are read through L2 (__ldcg), never through
// the non-coherent path.
__global__ void __launch_bounds__(FL_SORTG_THREADS, 1)
fl_sort3_grid_kernel(const int* __restrict__ k1, const int* __restrict__ k2,
                     const int* __restrict__ v, int N, int per, int* o1, int* o2, int* o3,
                     int* t1, int* t2, int* t3, int* table) {
  __shared__ FlSortGridShared s;
  cg::grid_group grid = cg::this_grid();
  const int G = (int)gridDim.x, b = (int)blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const long long lo64 = min((long long)b * per, (long long)N);
  const int lo = (int)lo64;
  const int cnt = (int)(min(lo64 + per, (long long)N) - lo64);
  int* cnt_tab = table;
  unsigned* red_tab = reinterpret_cast<unsigned*>(table + (size_t)G * 256);

  // ---- AND / OR of each operand; order of v and of (k2, v) ----
  unsigned r[8] = {~0u, ~0u, ~0u, 0u, 0u, 0u, 0u, 0u};
  for (int i = tid; i < cnt; i += FL_SORTG_THREADS) {
    const int g = lo + i;
    const int a = k1[g], bb = k2[g], c = v[g];
    r[0] &= (unsigned)a; r[1] &= (unsigned)bb; r[2] &= (unsigned)c;
    r[3] |= (unsigned)a; r[4] |= (unsigned)bb; r[5] |= (unsigned)c;
    if (g > 0) {   // the tile's first element against the previous tile's last
      const int pb = k2[g - 1], pc = v[g - 1];
      r[6] |= pc > c ? 1u : 0u;
      r[7] |= (pb > bb || (pb == bb && pc > c)) ? 1u : 0u;
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
    red_tab[b * 8 + tid] = m;
  }
  grid.sync();
  if (tid < 8) {
    unsigned m = tid < 3 ? ~0u : 0u;
    for (int q = 0; q < G; ++q) {
      const unsigned x = __ldcg(red_tab + q * 8 + tid);
      m = tid < 3 ? (m & x) : (m | x);
    }
    s.all[tid] = m;
  }
  __syncthreads();   // every block holds the same s.all, so takes the same passes
  int P = 0;
  for (int p = 0; p < 12; ++p) P += fl_sort_skip(s.all, p) ? 0 : 1;

  // ---- the passes: v, k2, k1; 8-bit digits, least significant first ----
  const int* src[3] = {k1, k2, v};
  int* const outs[3] = {o1, o2, o3};
  int* const tmps[3] = {t1, t2, t3};
  int taken = 0;
  for (int p = 0; p < 12; ++p) {
    if (fl_sort_skip(s.all, p)) continue;
    const int op = 2 - p / 4, shift = 8 * (p % 4);
    int* const* dst = ((P - 1 - taken) & 1) ? tmps : outs;   // the last pass lands in o
    const int* key = src[op];

    // the tile's digit counts
    if (tid < 256) s.count[tid] = 0;
    __syncthreads();
    for (int i0 = wid * 32; i0 < cnt; i0 += FL_SORTG_THREADS) {   // warp-uniform
      const int e = i0 + lane;
      const bool in = e < cnt;
      const unsigned d = in ? fl_digit(__ldcg(key + lo + e), shift) : 256u;
      const unsigned peers = __match_any_sync(FL_FULL, d);
      if (in && (peers & ((1u << lane) - 1u)) == 0u) atomicAdd(&s.count[d], __popc(peers));
    }
    __syncthreads();
    if (tid < 256) cnt_tab[b * 256 + tid] = s.count[tid];
    grid.sync();

    // where the tile's first element of each digit goes: the digit totals
    // of the grid and of the lower blocks, summed in block order
    if (tid < 256) {
      int total = 0, lower = 0;
      for (int q = 0; q < G; ++q) {
        const int c = __ldcg(cnt_tab + q * 256 + tid);
        total += c;
        lower += q < b ? c : 0;
      }
      int incl = total;   // exclusive scan of the totals over the 256 digits
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FL_FULL, incl, off);
        if (lane >= off) incl += y;
      }
      if (lane == 31) s.scan[wid] = incl;
      s.run[tid] = incl - total + lower;
    }
    __syncthreads();
    if (tid < 256) {
      int add = 0;
      for (int w = 0; w < wid; ++w) add += s.scan[w];
      s.run[tid] += add;
    }

    // the stable scatter, a chunk at a time in tile order
    for (int c0 = 0; c0 < cnt; c0 += FL_SORTG_CHUNK) {
      for (int j = tid; j < FL_SORTG_WARPS * 256; j += FL_SORTG_THREADS)
        (&s.warp_cnt[0][0])[j] = 0;
      __syncthreads();
      const int w0 = min(c0 + wid * FL_SORTG_SEG, cnt), w1 = min(w0 + FL_SORTG_SEG, cnt);
      int rk[FL_SORTG_ROUNDS];
      unsigned dg[FL_SORTG_ROUNDS];
#pragma unroll
      for (int q = 0; q < FL_SORTG_ROUNDS; ++q) {
        rk[q] = 0;
        dg[q] = 256u;
        if (w0 + q * 32 < w1) {   // warp-uniform
          const int e = w0 + q * 32 + lane;
          const bool in = e < w1;
          const unsigned d = in ? fl_digit(__ldcg(key + lo + e), shift) : 256u;
          const unsigned peers = __match_any_sync(FL_FULL, d);
          const int below = __popc(peers & ((1u << lane) - 1u));
          const int before = in ? s.warp_cnt[wid][d] : 0;
          __syncwarp();
          if (in && below == 0) s.warp_cnt[wid][d] = before + __popc(peers);
          __syncwarp();
          rk[q] = before + below;
          dg[q] = d;
        }
      }
      __syncthreads();
      if (tid < 256) {   // each warp's first destination of each digit, in warp order
        int run = s.run[tid];
        for (int w = 0; w < FL_SORTG_WARPS; ++w) {
          const int c = s.warp_cnt[w][tid];
          s.warp_cnt[w][tid] = run;
          run += c;
        }
        s.run[tid] = run;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < FL_SORTG_ROUNDS; ++q) {
        if (dg[q] < 256u) {
          const int e = lo + w0 + q * 32 + lane;
          const int pos = s.warp_cnt[wid][dg[q]] + rk[q];
          dst[0][pos] = __ldcg(src[0] + e);
          dst[1][pos] = __ldcg(src[1] + e);
          dst[2][pos] = __ldcg(src[2] + e);
        }
      }
      __syncthreads();   // the counts are zeroed again only after every read
    }
    grid.sync();   // every element has landed; no block reads a count any more
#pragma unroll
    for (int j = 0; j < 3; ++j) src[j] = dst[j];
    ++taken;
  }

  if (P == 0)   // nothing to move: the input is the result
    for (int i = tid; i < cnt; i += FL_SORTG_THREADS) {
      o1[lo + i] = k1[lo + i];
      o2[lo + i] = k2[lo + i];
      o3[lo + i] = v[lo + i];
    }
}

// The grid fl_sort3 launches above 2^17: one block a streaming
// multiprocessor, or the (negated) CUDA error that keeps every block from
// being resident at once.  Asked once; the wrapper sizes the table by it.
extern "C" int fl_sort3_grid_blocks() {
  static int blocks = 0;
  static const cudaError_t e =
      fl_grid_blocks(fl_sort3_grid_kernel, FL_SORTG_THREADS, 0, &blocks);
  return e == cudaSuccess ? blocks : -(int)e;
}

// Sorts the N triples (k1, k2, v) into o1..o3 (N elements each), through
// the cluster kernel for N <= FL_SORT_MAXN and the grid kernel above it;
// the grid kernel takes t1..t3 (N elements each) and the table (G × 264
// ints, G = fl_sort3_grid_blocks()) as scratch, the cluster kernel none.
// Returns a CUDA error code (0 on success); N < 1 is refused.
extern "C" int fl_sort3(const int* k1, const int* k2, const int* v, int N, int* o1, int* o2,
                        int* o3, int* t1, int* t2, int* t3, int* table, int G,
                        cudaStream_t stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  if (N > FL_SORT_MAXN) {
    const int want = fl_sort3_grid_blocks();
    if (want < 0) return -want;
    if (G != want || !t1 || !t2 || !t3 || !table) return (int)cudaErrorInvalidValue;
    const int per = (int)(((long long)N + G - 1) / G);
    FlGridLaunch L(G, FL_SORTG_THREADS, stream);
    cudaError_t e = cudaLaunchKernelEx(&L.cfg, fl_sort3_grid_kernel, k1, k2, v, N, per, o1, o2,
                                       o3, t1, t2, t3, table);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  const int per = (N + FL_SORT_CLUSTER - 1) / FL_SORT_CLUSTER;
  FlClusterLaunch L(FL_SORT_CLUSTER, FL_SORT_THREADS, stream);
  // the cluster must fit at the cap's shared memory (then it fits below it)
  static const cudaError_t fits = [] {
    cudaError_t e = cudaFuncSetAttribute(fl_sort3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)FL_SORT_SMEM_MAX);
    if (e != cudaSuccess) return e;
    FlClusterLaunch M(FL_SORT_CLUSTER, FL_SORT_THREADS, 0);
    M.cfg.dynamicSmemBytes = FL_SORT_SMEM_MAX;
    M.cfg.attrs = &M.attr;
    return fl_cluster_fits(fl_sort3_kernel, &M.cfg);
  }();
  if (fits != cudaSuccess) return (int)fits;
  L.cfg.dynamicSmemBytes = 6 * sizeof(int) * (size_t)per;
  cudaError_t e = cudaLaunchKernelEx(&L.cfg, fl_sort3_kernel, k1, k2, v, N, per, o1, o2, o3);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
