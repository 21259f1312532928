// K2 — k nearest candidates from planar block rows (replaces
// fast_limo_tpu/ops/knn_rows.py:topk_from_rows_tpu, TPU body _kernel).
//
// Per query: decode its V planar group rows
// [vx×E | vy×E | vz×E | cnt×E | x slot-major E·B | y | z], keep every entry
// whose stored voxel lies in the wanted block (floor(v/2) == block coord)
// and every filled bucket slot, and return the k smallest squared
// distances, ascending, ties to the lowest candidate column.  Columns are
// ordered exactly as the TPU kernel's: v-major, then slot-major s·E + e.
//
// The rows are read straight from the map's planar table through an
// (N, V) int32 row index: row (q, v) lies at ptable + row_idx[q·V + v]·WP.
// The block-row gather then never lands in device memory (10112 × 8 × 352
// floats, 114 MB a scan at the bench configuration), and each block reads
// only the rows of its query.
//
// On the H100 the kernel is bound by reading its query's rows
// (N·V·WP floats — 11 MB at N = 10000, V = 8, WP = 352) once.  One block
// of 128 threads per query: neighbouring threads decode neighbouring
// candidates (coalesced) into a row of V·E·B masked distances in shared
// memory, then the block selects the k smallest by radix
// (topk_select.cuh, K7's select) and ranks them.  Candidates that fail the
// masks enter with +inf, so the result equals a stable sort of the masked
// distance row, invalid tail included.  (Per-lane sorted lists, one warp
// a query, were slower at every k the port uses: the lane-0 merge is
// serial, and lists longer than 16 spill out of the registers.)
//
// `active` (optional, one byte on the device): when set and 0, every block
// returns before any load and the outputs keep whatever their allocation
// held.  The exact update loop launches K2 on every scan with such a flag
// (K6's certificates failed / the stale count chose this branch) and
// discards the outputs of a clear flag with a torch.where, so they are
// never read.
#include "topk_select.cuh"

#define FL_KNN_THREADS 128

__global__ void __launch_bounds__(FL_KNN_THREADS)
fl_knn_rows_kernel(const float* __restrict__ ptable, const int* __restrict__ row_idx,
                   const int* __restrict__ nc, const float* __restrict__ qs, int V, int WP,
                   int E, int B, int k, const uint8_t* __restrict__ active,
                   float* __restrict__ nbrs, float* __restrict__ sq,
                   uint8_t* __restrict__ valid) {
  extern __shared__ float d2s[];   // the query's V·E·B masked distances
  __shared__ FlSelect sh;
  if (active != nullptr && *active == 0) return;
  const int q = blockIdx.x, tid = threadIdx.x, EB = E * B, C = V * EB;
  // row (q, v) of the map table
  auto row = [&](int v) { return ptable + (size_t)row_idx[(size_t)q * V + v] * WP; };
  const float qx = qs[3 * q], qy = qs[3 * q + 1], qz = qs[3 * q + 2];
  for (int c = tid; c < C; c += blockDim.x) {
    int v = c / EB, r = c - v * EB, s = r / E, e = r - s * E;
    const float* base = row(v);
    const int* b = nc + ((size_t)q * V + v) * 3;
    float cnt = base[3 * E + e];
    bool ok = (cnt > 0.0f) && (floorf(base[e] * 0.5f) == (float)b[0]) &&
              (floorf(base[E + e] * 0.5f) == (float)b[1]) &&
              (floorf(base[2 * E + e] * 0.5f) == (float)b[2]) && (cnt > (float)s);
    float d = INFINITY;
    if (ok) {
      float dx = base[4 * E + s * E + e] - qx;
      float dy = base[4 * E + EB + s * E + e] - qy;
      float dz = base[4 * E + 2 * EB + s * E + e] - qz;
      d = dx * dx + dy * dy + dz * dz;
    }
    d2s[c] = d;
  }
  __syncthreads();

  fl_select_k([&](int c) { return __float_as_uint(d2s[c]); }, C, k, sh);

  if (tid < k) {
    // the survivor's stored point, whatever its mask (as the plain gather)
    const int c = sh.c[tid], v = c / EB, r = c - v * EB, s = r / E, e = r - s * E;
    const float* base = row(v);
    const unsigned u = sh.u[tid];
    const size_t o = (size_t)q * k + fl_select_rank(sh, k, tid);
    sq[o] = __uint_as_float(u);
    valid[o] = u < 0x7F800000u ? 1 : 0;
    nbrs[3 * o] = base[4 * E + s * E + e];
    nbrs[3 * o + 1] = base[4 * E + EB + s * E + e];
    nbrs[3 * o + 2] = base[4 * E + 2 * EB + s * E + e];
  }
}

// ptable (G, WP) the planar table, row_idx (N, V) its row of each (query,
// block); active may be null ("always run").
extern "C" int fl_knn_rows(const float* ptable, const int* row_idx, const int* nc, const float* qs,
                           int N, int V, int WP, int E, int B, int k, const uint8_t* active,
                           float* nbrs, float* sq, uint8_t* valid, cudaStream_t stream) {
  if (k < 1 || k > FL_SELECT_KMAX || k > V * E * B) return (int)cudaErrorInvalidValue;
  // the distance row beside the select state; above 48 KB only by opt-in
  size_t smem = (size_t)V * E * B * sizeof(float);
  if (smem + sizeof(FlSelect) > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024 - sizeof(FlSelect)) {
    cudaError_t err = cudaFuncSetAttribute(fl_knn_rows_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (N > 0)
    fl_knn_rows_kernel<<<N, FL_KNN_THREADS, smem, stream>>>(ptable, row_idx, nc, qs, V, WP, E, B,
                                                            k, active, nbrs, sq, valid);
  return (int)cudaGetLastError();
}
