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
// The cap N <= FL_SORT_MAXN (2^17, 16 blocks × 8192) covers the voxel
// sort of an HDL-64 scan (~125 000 points); beyond it the wrapper raises.
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

// Sorts the N triples (k1, k2, v) into o1..o3 (N elements each).  Returns a
// CUDA error code (0 on success); N outside 1 … FL_SORT_MAXN is refused.
extern "C" int fl_sort3(const int* k1, const int* k2, const int* v, int N, int* o1, int* o2,
                        int* o3, cudaStream_t stream) {
  if (N < 1 || N > FL_SORT_MAXN) return (int)cudaErrorInvalidValue;
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
