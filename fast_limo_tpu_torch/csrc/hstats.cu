// K4 — measurement sufficient statistics HᵀH (12×12) and Hᵀh (12,)
// (replaces fast_limo_tpu/ops/hstats.py:hstats_tpu, TPU body stats_math).
//
// Input is the x-independent channel pack [px py pz nx ny nz nd keep]
// (8 planes of Np floats) and the 14 pose scalars of the iterate; output
// is one (156,) buffer: HᵀH row-major, then Hᵀh.  On the H100 the work is
// tiny (N·~290 flops, 32 bytes a point) and what costs is the 90-way
// reduction and the launch.  So ONE launch of ONE thread-block cluster
// does it all: each thread accumulates the 78 + 12 products of its points
// in registers, then fl_cluster_stats (hstats.cuh) reduces them in a fixed
// order — warp trees, warps in order, blocks in rank order through
// distributed shared memory — and rank 0 writes the result.  No scratch,
// no second kernel, no atomics: bit-reproducible run to run.  Serves the
// exact per-iteration fallback loop (measurement.h_stats).
//
// `active` (optional, one byte on the device): when set and 0, every block
// of the cluster reads it before its first load and before any cluster
// barrier, so all of them return together and none waits at a barrier
// that another skips; `out` then keeps whatever its allocation held.  The
// exact update loop launches K4 on every scan with such a flag and
// discards the output of a clear flag with a torch.where, so it is never
// read.
#include "hstats.cuh"

#define FL_HS_THREADS 256
#define FL_HS_CLUSTER 16   // blocks of the one cluster (PERF.md: measured against 8)

__global__ void __launch_bounds__(FL_HS_THREADS)
fl_hstats_kernel(const float* __restrict__ X, int Np, const float* __restrict__ sc, int ee,
                 const uint8_t* __restrict__ active, float* __restrict__ out) {
  __shared__ FlStatsRed<FL_HS_THREADS / 32> red;
  if (active != nullptr && *active == 0) return;   // the same byte for every block
  const FlPose s = fl_pose(sc);
  float acc[FL_NSTAT];
#pragma unroll
  for (int e = 0; e < FL_NSTAT; ++e) acc[e] = 0.0f;
  const int stride = gridDim.x * blockDim.x;   // the grid is the cluster
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < Np; i += stride) {
    float px = X[i], py = X[Np + i], pz = X[2 * Np + i];
    float g[3], H[12], hn;
    fl_glob(s, px, py, pz, g);
    fl_hrow(s, ee != 0, px, py, pz, X[3 * Np + i], X[4 * Np + i], X[5 * Np + i],
            X[6 * Np + i], X[7 * Np + i], g, H, &hn);
    fl_stats_add(acc, H, hn);
  }
  fl_cluster_stats(acc, &red, out, out + FL_M * FL_M);
  cg::this_cluster().sync();   // rank 0 has read every block's row
}

// out: 156 floats (HᵀH 144, Hᵀh 12)
extern "C" int fl_hstats(const float* X, int Np, const float* sc, int ee, const uint8_t* active,
                         float* out, cudaStream_t stream) {
  FlClusterLaunch L(FL_HS_CLUSTER, FL_HS_THREADS, stream);
  static const cudaError_t fits = fl_cluster_fits(fl_hstats_kernel, &L.cfg);
  if (fits != cudaSuccess) return (int)fits;
  cudaError_t e = cudaLaunchKernelEx(&L.cfg, fl_hstats_kernel, X, Np, sc, ee, active, out);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
