// K9 — lexicographic sort of int32 triples (replaces
// fast_limo_tpu/ops/sort.py:sort3_tpu, TPU body _sort_kernel).
//
// Sorts (k1, k2, v) ascending by the key (k1, k2, v), signed int32
// compares.  The input is padded to the next power of two Np with
// INT32_MAX in all three operands; the padding sorts after every real
// element (a real triple is at most equal to it, and equal triples are
// interchangeable), and the wrapper slices it off.  A bitonic network
// sorts the multiset exactly, so with a unique v (the callers pass an
// arange) the result is the stable 2-key sort.
//
// On the H100 the work is bound by moving 24 bytes an element (three
// int32 read, three written): 0.23 us at N = 32768.  The network itself
// is O(N log^2 N) compare-exchanges, so the design keeps as many stages as
// it can in shared memory: the three operands of a tile of FL_SORT_TILE
// elements (48 KB) sit in one block's shared memory, where
//   * fl_sort3_tile sorts each tile (every stage with distance < TILE), its
//     direction from the global index, so the tiles leave as the
//     alternating runs a bitonic merge of 2·TILE expects;
//   * each merge level k > TILE then runs one fl_sort3_global launch per
//     distance j >= TILE (one thread a pair, the data L2-resident) and one
//     fl_sort3_merge launch for all distances j < TILE.
// At N = 32768 (Np = 32768, TILE = 4096) that is 1 + (2 + 3 + 4) = 10
// launches in one wrapper call; at N = 10000 (Np = 16384) 1 + 2 + 3 = 6.
// The bitonic network is latency-bound at these sizes (each launch moves
// the whole array once); CUB's radix sort, which torch.sort uses, needs
// fewer passes, so K9 is expected to lose to it.
#include <cuda_runtime.h>
#include <stdint.h>

#define FL_SORT_TILE 4096
#define FL_SORT_THREADS 1024
#define FL_SORT_MAXN (1 << 24)

struct Fl3 {
  int a, b, c;
};

__device__ __forceinline__ bool fl_less3(const Fl3& x, const Fl3& y) {
  return x.a < y.a || (x.a == y.a && (x.b < y.b || (x.b == y.b && x.c < y.c)));
}

// compare-exchange of the pair (i, i + j) of stage (k, j) in three arrays
__device__ __forceinline__ void fl_cmpx(int* a, int* b, int* c, int i, int l, bool up) {
  Fl3 x = {a[i], b[i], c[i]}, y = {a[l], b[l], c[l]};
  if (fl_less3(y, x) == up) {
    a[i] = y.a; b[i] = y.b; c[i] = y.c;
    a[l] = x.a; b[l] = x.b; c[l] = x.c;
  }
}

// stages (k, j) for j from j0 down to 1 on one tile in shared memory; base
// is the tile's global index (the direction bit reads the global index)
__device__ void fl_tile_stages(int* a, int* b, int* c, int n, int base, int k, int j0) {
  for (int j = j0; j >= 1; j >>= 1) {
    for (int p = threadIdx.x; p < n / 2; p += blockDim.x) {
      const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
      fl_cmpx(a, b, c, i, i + j, ((base + i) & k) == 0);
    }
    __syncthreads();
  }
}

// load one tile (padding INT32_MAX past N) into shared memory, sort it
// with every stage of distance < n, write it to the working arrays
__global__ void __launch_bounds__(FL_SORT_THREADS)
fl_sort3_tile(const int* __restrict__ k1, const int* __restrict__ k2, const int* __restrict__ v,
              int N, int n, int* __restrict__ w1, int* __restrict__ w2, int* __restrict__ w3) {
  extern __shared__ int sh[];
  int *a = sh, *b = sh + n, *c = sh + 2 * n;
  const int base = blockIdx.x * n;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int g = base + t;
    const bool in = g < N;
    a[t] = in ? k1[g] : INT32_MAX;
    b[t] = in ? k2[g] : INT32_MAX;
    c[t] = in ? v[g] : INT32_MAX;
  }
  __syncthreads();
  for (int k = 2; k <= n; k <<= 1) fl_tile_stages(a, b, c, n, base, k, k >> 1);
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    w1[base + t] = a[t];
    w2[base + t] = b[t];
    w3[base + t] = c[t];
  }
}

// one stage (k, j), j >= TILE, over the whole working array: a thread a pair
__global__ void fl_sort3_global(int* __restrict__ w1, int* __restrict__ w2, int* __restrict__ w3,
                                int half, int k, int j) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= half) return;
  const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
  fl_cmpx(w1, w2, w3, i, i + j, (i & k) == 0);
}

// the stages (k, j) with j < TILE of merge level k, one tile a block
__global__ void __launch_bounds__(FL_SORT_THREADS)
fl_sort3_merge(int* __restrict__ w1, int* __restrict__ w2, int* __restrict__ w3, int k) {
  extern __shared__ int sh[];
  const int n = FL_SORT_TILE;
  int *a = sh, *b = sh + n, *c = sh + 2 * n;
  const int base = blockIdx.x * n;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    a[t] = w1[base + t];
    b[t] = w2[base + t];
    c[t] = w3[base + t];
  }
  __syncthreads();
  fl_tile_stages(a, b, c, n, base, k, n >> 1);
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    w1[base + t] = a[t];
    w2[base + t] = b[t];
    w3[base + t] = c[t];
  }
}

// Sorts the N triples (k1, k2, v) into the working arrays w1..w3 of Np
// (the next power of two >= N) elements each; their first N entries are
// the result.  Returns a CUDA error code (0 on success).
extern "C" int fl_sort3(const int* k1, const int* k2, const int* v, int N, int Np, int* w1,
                        int* w2, int* w3, cudaStream_t stream) {
  if (N < 1 || N > FL_SORT_MAXN || Np < N || (Np & (Np - 1)) || Np >= 2 * N)
    return (int)cudaErrorInvalidValue;
  // a tile's three operands: at most 48 KB, the default dynamic limit
  const int n = Np < FL_SORT_TILE ? Np : FL_SORT_TILE;
  const size_t smem = 3 * sizeof(int) * (size_t)n;
  const int threads = n / 2 < FL_SORT_THREADS ? (n / 2 > 32 ? n / 2 : 32) : FL_SORT_THREADS;
  fl_sort3_tile<<<Np / n, threads, smem, stream>>>(k1, k2, v, N, n, w1, w2, w3);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int half = Np / 2;
  for (int k = 2 * n; k <= Np; k <<= 1) {
    for (int j = k >> 1; j >= n; j >>= 1) {
      fl_sort3_global<<<(half + 255) / 256, 256, 0, stream>>>(w1, w2, w3, half, k, j);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    fl_sort3_merge<<<Np / n, FL_SORT_THREADS, smem, stream>>>(w1, w2, w3, k);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}
