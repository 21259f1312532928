// K7 — masked k nearest over dense per-query candidate sets (replaces
// fast_limo_tpu/ops/knn.py:masked_topk, TPU body _topk_kernel).
//
// Per query q: d[c] = (dx² + dy²) + dz² for every valid candidate column c
// of its C candidates (+inf where invalid); return the k smallest,
// ascending, ties to the lowest column — a stable sort of the masked
// distance row cut at k, which is what the TPU kernel's repeated argmin
// and the reference's lax.top_k give.
//
// On the H100 the kernel is bound by reading the candidates once
// (N·C·13 bytes: 1.56 GB for radius_search's widest chunked branch at
// 10 000 queries, C = 12 000).  C is large (12 000 to 211 000) and k is
// up to 128, so per-thread sorted lists (K2's layout for k <= 16) would not
// stay exact in registers.  Instead one block of 256 threads takes one
// query and selects by radix (topk_select.cuh), then ranks the k survivors
// in shared memory.  Each of the select's five passes recomputes the
// distances from the candidates (the same float32 operations, built with
// --fmad=false), which L2 serves after the first pass for all but the
// widest queries.
#include "topk_select.cuh"

#define FL_TOPK_THREADS 256

__global__ void __launch_bounds__(FL_TOPK_THREADS)
fl_masked_topk_kernel(const float* __restrict__ cand, const uint8_t* __restrict__ cvalid,
                      const float* __restrict__ qs, int C, int k, float* __restrict__ nbrs,
                      float* __restrict__ sq, uint8_t* __restrict__ valid) {
  __shared__ FlSelect sh;
  const int q = blockIdx.x, tid = threadIdx.x;
  const float* pts = cand + (size_t)q * C * 3;
  const uint8_t* vq = cvalid + (size_t)q * C;
  const float qx = qs[3 * q], qy = qs[3 * q + 1], qz = qs[3 * q + 2];

  fl_select_k([&](int c) -> unsigned {
    if (!vq[c]) return 0x7F800000u;   // +inf
    float dx = pts[3 * (size_t)c] - qx, dy = pts[3 * (size_t)c + 1] - qy,
          dz = pts[3 * (size_t)c + 2] - qz;
    return __float_as_uint((dx * dx + dy * dy) + dz * dz);
  }, C, k, sh);

  if (tid < k) {
    const unsigned u = sh.u[tid];
    const size_t c = sh.c[tid], o = (size_t)q * k + fl_select_rank(sh, k, tid);
    const bool fin = u < 0x7F800000u;
    sq[o] = fin ? __uint_as_float(u) : INFINITY;
    valid[o] = fin ? 1 : 0;
    nbrs[3 * o] = pts[3 * c];
    nbrs[3 * o + 1] = pts[3 * c + 1];
    nbrs[3 * o + 2] = pts[3 * c + 2];
  }
}

extern "C" int fl_masked_topk(const float* cand, const uint8_t* cvalid, const float* qs, int N,
                              int C, int k, float* nbrs, float* sq, uint8_t* valid,
                              cudaStream_t stream) {
  if (k < 1 || k > FL_SELECT_KMAX || k > C || N < 0) return (int)cudaErrorInvalidValue;
  if (N > 0)
    fl_masked_topk_kernel<<<N, FL_TOPK_THREADS, 0, stream>>>(cand, cvalid, qs, C, k, nbrs, sq,
                                                             valid);
  return (int)cudaGetLastError();
}
