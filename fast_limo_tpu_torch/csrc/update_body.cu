// K5 — one fused iterated-EKF update iteration (replaces
// fast_limo_tpu/ops/update_body.py:update_body_tpu, TPU bodies _iter_core
// and jacobi_guard_head).
//
// One block runs fl_iter_body (iter_body.cuh) — the same device function
// the whole-loop kernel runs per iteration.  The work is ~10⁵ flops of
// 23×23 algebra, so on the H100 it is latency-bound: a single block keeps
// every matrix in shared memory, spreads the 23×23 products over its
// threads and leaves only the 12×12 factorizations, the pivot choice and
// the 6×6 Jacobi sweeps to one thread.  Unlike the TPU kernel, the chart
// difference dx = x ⊟ x_prop is computed in-kernel with atan2f.  Serves
// the exact per-iteration fallback loop (iekf.update_iterated).
#include "iter_body.cuh"

#define FL_UB_THREADS 256

__global__ void __launch_bounds__(FL_UB_THREADS)
fl_update_body_kernel(const float* __restrict__ HTH, const float* __restrict__ HTh,
                      const float* __restrict__ P, const float* __restrict__ x,
                      const float* __restrict__ x_prop, float inv_R, float D,
                      float* __restrict__ xn, float* __restrict__ Pf,
                      float* __restrict__ dxo, float* __restrict__ gm) {
  __shared__ FlIterWS w;
  const int tid = threadIdx.x;
  for (int i = tid; i < FL_NS * FL_NS; i += blockDim.x) w.P[i] = P[i];
  for (int i = tid; i < FL_M * FL_M; i += blockDim.x) w.g.HTH[i] = HTH[i];
  for (int i = tid; i < FL_M; i += blockDim.x) w.g.HTh[i] = HTh[i];
  for (int i = tid; i < FL_XF; i += blockDim.x) { w.x[i] = x[i]; w.xp[i] = x_prop[i]; }
  __syncthreads();
  if (tid == 0) fl_state_boxminus(w.x, w.xp, w.dx);
  __syncthreads();
  fl_iter_body(&w, inv_R, D);
  for (int i = tid; i < FL_XF; i += blockDim.x) xn[i] = w.xn[i];
  for (int i = tid; i < FL_NS * FL_NS; i += blockDim.x) Pf[i] = w.Pf[i];
  for (int i = tid; i < FL_NS; i += blockDim.x) dxo[i] = w.dxo[i];
  if (tid == 0) { gm[0] = w.gersh; gm[1] = w.min_eig; }
}

extern "C" int fl_update_body(const float* HTH, const float* HTh, const float* P,
                              const float* x, const float* x_prop, float inv_R, float D,
                              float* xn, float* Pf, float* dxo, float* gm, cudaStream_t stream) {
  fl_update_body_kernel<<<1, FL_UB_THREADS, 0, stream>>>(HTH, HTh, P, x, x_prop, inv_R, D, xn,
                                                         Pf, dxo, gm);
  return (int)cudaGetLastError();
}
