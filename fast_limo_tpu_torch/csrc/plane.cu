// K3 — standalone plane fit (replaces fast_limo_tpu/ops/plane_kernel.py:
// fit_planes_tpu, TPU body fit_math).
//
// One thread per query runs fl_fit_math (plane_fit.cuh), the same device
// function the whole-loop kernel runs per point.  Bound on the H100 by
// its input reads (N·k·5 values) — a few µs at N = 10000; serves the exact
// per-iteration fallback loop (measurement._window_fit / _patched_match).
//
// `active` (optional, one byte on the device): when set and 0, every block
// returns before any load and n_abcd / good keep whatever their allocation
// held.  The exact update loop launches K3 on every scan with such a flag
// and discards the outputs of a clear flag with a torch.where, so they are
// never read.
#include "plane_fit.cuh"

__global__ void fl_fit_planes_kernel(const float* __restrict__ nbrs,
                                     const float* __restrict__ sq,
                                     const uint8_t* __restrict__ valid, int N, int k,
                                     int num_match_points, float max_dist_plane,
                                     float plane_threshold, float thr2,
                                     const uint8_t* __restrict__ active,
                                     float* __restrict__ n_abcd, uint8_t* __restrict__ good) {
  if (active != nullptr && *active == 0) return;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float nx[FL_FIT_KMAX], ny[FL_FIT_KMAX], nz[FL_FIT_KMAX], nv[FL_FIT_KMAX];
  for (int j = 0; j < k; ++j) {
    nx[j] = nbrs[((size_t)i * k + j) * 3];
    ny[j] = nbrs[((size_t)i * k + j) * 3 + 1];
    nz[j] = nbrs[((size_t)i * k + j) * 3 + 2];
    nv[j] = valid[(size_t)i * k + j] ? 1.0f : 0.0f;
  }
  float kth = FLT_MAX;
  if (num_match_points <= k) {
    kth = sq[(size_t)i * k + num_match_points - 1];
    if (isnan(kth)) kth = FLT_MAX;   // NaN must fail the `kth < max_dist` gate
  }
  FlPlane o = fl_fit_math(nx, ny, nz, nv, k, kth, num_match_points, max_dist_plane,
                          plane_threshold, thr2);
  n_abcd[4 * i] = o.ux;
  n_abcd[4 * i + 1] = o.uy;
  n_abcd[4 * i + 2] = o.uz;
  n_abcd[4 * i + 3] = o.d;
  good[i] = o.good ? 1 : 0;
}

extern "C" int fl_fit_planes(const float* nbrs, const float* sq, const uint8_t* valid, int N,
                             int k, int num_match_points, float max_dist_plane,
                             float plane_threshold, float thr2, const uint8_t* active,
                             float* n_abcd, uint8_t* good, cudaStream_t stream) {
  if (k < 1 || k > FL_FIT_KMAX) return (int)cudaErrorInvalidValue;
  int threads = 128;
  int blocks = (N + threads - 1) / threads;
  if (blocks > 0)
    fl_fit_planes_kernel<<<blocks, threads, 0, stream>>>(nbrs, sq, valid, N, k,
                                                         num_match_points, max_dist_plane,
                                                         plane_threshold, thr2, active, n_abcd,
                                                         good);
  return (int)cudaGetLastError();
}
