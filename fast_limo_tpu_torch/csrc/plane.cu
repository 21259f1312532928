// K3 — the plane fit (replaces fast_limo_tpu/ops/plane_kernel.py:
// fit_planes_tpu, TPU body fit_math), with the exact update loop's
// re-match branches selected on the device.
//
// One thread a query runs fl_fit_math (plane_fit.cuh), the same device
// function the whole-loop kernel runs per point.  Bound on the H100 by its
// input reads (N·k·5 values, a few µs at N = 10000) and, in practice, by
// its launch: so the exact update loop launches it ONCE an evaluation for
// all three branches of its re-match (the JAX package's lax.cond chain,
// models/measurement.py:292-318), and the kernel fits each query on the
// one row the branch gives it and writes the merged result:
//
//   branch = 0 if viol == 0 (window), 1 if viol ≤ B (patched), else 2 (full)
//   threads 0..N-1      query t: branch 2 → the full set's row t; else the
//                       window row t, except a stale query in branch 1
//   threads N..N+B-1    patch row r (branch 1 only): if query idx[r] is
//                       stale, its fit goes to idx[r]
//
// Since viol ≤ B in branch 1 and idx lists the stale queries first, every
// stale query is among the idx rows whose query is stale, and no query is
// written twice.  Each query runs the same device function on the same row
// as a one-set launch would, so the result is bit for bit the torch.where
// merge of three one-set launches.  The one-set entry (fl_fit_planes) is
// the same kernel with only the window set and its validity given.
//
// `active` (optional, one byte on the device): when set and 0, every block
// returns before any load and n_abcd / good keep whatever their allocation
// held.  The exact update loop launches K3 on every scan with such a flag
// and discards the outputs of a clear flag with a torch.where, so they are
// never read.
#include "plane_fit.cuh"

#define FL_FIT_THREADS 128

// One neighbour set: (rows, k, 3) coordinates, (rows, k) squared
// distances and validity (nullptr: valid where the distance is finite).
struct FlFitSet {
  const float* nbrs;
  const float* sq;
  const uint8_t* valid;
};

struct FlFitGates {
  int k, num_match_points;
  float max_dist_plane, plane_threshold, thr2;
};

FL_DEV FlPlane fl_fit_row(FlFitSet s, size_t i, FlFitGates f) {
  const int k = f.k;
  float nx[FL_FIT_KMAX], ny[FL_FIT_KMAX], nz[FL_FIT_KMAX], nv[FL_FIT_KMAX];
  for (int j = 0; j < k; ++j) {
    const size_t e = i * k + j;
    nx[j] = s.nbrs[e * 3];
    ny[j] = s.nbrs[e * 3 + 1];
    nz[j] = s.nbrs[e * 3 + 2];
    nv[j] = (s.valid != nullptr ? s.valid[e] != 0 : isfinite(s.sq[e])) ? 1.0f : 0.0f;
  }
  float kth = FLT_MAX;
  if (f.num_match_points <= k) {
    kth = s.sq[i * k + f.num_match_points - 1];
    if (isnan(kth)) kth = FLT_MAX;   // NaN must fail the `kth < max_dist` gate
  }
  return fl_fit_math(nx, ny, nz, nv, k, kth, f.num_match_points, f.max_dist_plane,
                     f.plane_threshold, f.thr2);
}

FL_DEV void fl_fit_store(float* n_abcd, uint8_t* good, size_t q, FlPlane o) {
  n_abcd[4 * q] = o.ux;
  n_abcd[4 * q + 1] = o.uy;
  n_abcd[4 * q + 2] = o.uz;
  n_abcd[4 * q + 3] = o.d;
  good[q] = o.good ? 1 : 0;
}

__global__ void fl_fit_planes_kernel(FlFitSet win, FlFitSet patch, const int64_t* __restrict__ idx,
                                     const uint8_t* __restrict__ stale, FlFitSet full,
                                     const int* __restrict__ viol, int N, int B, FlFitGates f,
                                     const uint8_t* __restrict__ active,
                                     float* __restrict__ n_abcd, uint8_t* __restrict__ good) {
  if (active != nullptr && *active == 0) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = viol != nullptr ? *viol : 0;
  const int branch = v == 0 ? 0 : (v <= B ? 1 : 2);
  FlFitSet set;     // the set, its row and the query this thread fits
  size_t row, q;
  if (t < N) {
    if (branch == 1 && stale[t]) return;   // its patched row is fitted below
    set = branch == 2 ? full : win;
    row = q = t;
  } else if (t < N + B && branch == 1) {
    row = t - N;
    q = idx[row];
    if (!stale[q]) return;
    set = patch;
  } else {
    return;
  }
  // k = 5 (every shipped config's NUM_MATCH_POINTS) as a constant: the
  // fit's loops unroll and its arrays stay in registers
  if (f.k == 5) {
    FlFitGates f5 = f;
    f5.k = 5;
    fl_fit_store(n_abcd, good, q, fl_fit_row(set, row, f5));
  } else {
    fl_fit_store(n_abcd, good, q, fl_fit_row(set, row, f));
  }
}

static int fl_fit_launch(FlFitSet win, FlFitSet patch, const int64_t* idx, const uint8_t* stale,
                         FlFitSet full, const int* viol, int N, int B, int k,
                         int num_match_points, float max_dist_plane, float plane_threshold,
                         float thr2, const uint8_t* active, float* n_abcd, uint8_t* good,
                         cudaStream_t stream) {
  if (k < 1 || k > FL_FIT_KMAX || N < 0 || B < 0) return (int)cudaErrorInvalidValue;
  const FlFitGates f{k, num_match_points, max_dist_plane, plane_threshold, thr2};
  const int blocks = (N + B + FL_FIT_THREADS - 1) / FL_FIT_THREADS;
  if (blocks > 0)
    fl_fit_planes_kernel<<<blocks, FL_FIT_THREADS, 0, stream>>>(win, patch, idx, stale, full, viol,
                                                                N, B, f, active, n_abcd, good);
  return (int)cudaGetLastError();
}

// One neighbour set (N, k) with its validity.
extern "C" int fl_fit_planes(const float* nbrs, const float* sq, const uint8_t* valid, int N,
                             int k, int num_match_points, float max_dist_plane,
                             float plane_threshold, float thr2, const uint8_t* active,
                             float* n_abcd, uint8_t* good, cudaStream_t stream) {
  const FlFitSet none{nullptr, nullptr, nullptr};
  return fl_fit_launch(FlFitSet{nbrs, sq, valid}, none, nullptr, nullptr, none, nullptr, N, 0,
                       k, num_match_points, max_dist_plane, plane_threshold, thr2, active,
                       n_abcd, good, stream);
}

// The re-match's three sets, merged by the branch of the device count viol.
extern "C" int fl_fit_planes_select(const float* nbrs_w, const float* sq_w, const float* nbrs_p,
                                    const float* sq_p, const uint8_t* valid_p,
                                    const int64_t* idx, const uint8_t* stale,
                                    const float* nbrs_f, const float* sq_f,
                                    const uint8_t* valid_f, const int* viol, int N, int B,
                                    int k, int num_match_points, float max_dist_plane,
                                    float plane_threshold, float thr2, const uint8_t* active,
                                    float* n_abcd, uint8_t* good, cudaStream_t stream) {
  return fl_fit_launch(FlFitSet{nbrs_w, sq_w, nullptr}, FlFitSet{nbrs_p, sq_p, valid_p}, idx,
                       stale, FlFitSet{nbrs_f, sq_f, valid_f}, viol, N, B, k, num_match_points,
                       max_dist_plane, plane_threshold, thr2, active, n_abcd, good, stream);
}
