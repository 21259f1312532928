// K5 — one fused iterated-EKF update iteration (replaces
// fast_limo_tpu/ops/update_body.py:update_body_tpu, TPU bodies _iter_core
// and jacobi_guard_head).
//
// One block of eight warps runs fl_iter_body (iter_body.cuh) — the same
// device function the whole-loop kernel runs per iteration.  The work is
// ~10⁵ flops of 23×23 algebra, so on the H100 it is bound by the latency
// of its chain of dependent steps, not by bytes or flops: every matrix
// stays in shared memory, the 23×23 products spread over the threads, and
// the body's schedule runs the guard's 6×6 eigendecomposition on its own
// warp beside the chart projection and the gain (see iter_body.cuh).
// Unlike the TPU kernel, the chart difference dx = x ⊟ x_prop is computed
// in-kernel with atan2f, beside the Cholesky.  Serves the exact
// per-iteration fallback loop (iekf.update_iterated).
//
// `active` (optional, one byte on the device): when set and 0, the block
// returns before any load and the outputs keep whatever their allocation
// held.  The exact update loop launches K5 on every scan with such a flag
// (K6's certificates failed) and discards the outputs of a clear flag with
// a torch.where, so they are never read.
#include "iter_body.cuh"

__global__ void __launch_bounds__(FL_BODY_THREADS)
fl_update_body_kernel(const float* __restrict__ HTH, const float* __restrict__ HTh,
                      const float* __restrict__ P, const float* __restrict__ x,
                      const float* __restrict__ x_prop, float inv_R, float D,
                      const uint8_t* __restrict__ active, float* __restrict__ xn,
                      float* __restrict__ Pf,
                      float* __restrict__ dxo, float* __restrict__ gm) {
  __shared__ FlIterWS w;
  if (active != nullptr && *active == 0) return;
  const int tid = threadIdx.x;
  for (int i = tid; i < FL_NS * FL_NS; i += blockDim.x) w.P[i] = P[i];
  for (int i = tid; i < FL_M * FL_M; i += blockDim.x) w.g.HTH[i] = HTH[i];
  for (int i = tid; i < FL_M; i += blockDim.x) w.g.HTh[i] = HTh[i];
  for (int i = tid; i < FL_XF; i += blockDim.x) { w.x[i] = x[i]; w.xp[i] = x_prop[i]; }
  __syncthreads();
  fl_iter_body(&w, inv_R, D, true);
  for (int i = tid; i < FL_XF; i += blockDim.x) xn[i] = w.xn[i];
  for (int i = tid; i < FL_NS * FL_NS; i += blockDim.x) Pf[i] = w.Pf[i];
  for (int i = tid; i < FL_NS; i += blockDim.x) dxo[i] = w.dxo[i];
  if (tid == 0) { gm[0] = w.gersh; gm[1] = w.min_eig; }
}

extern "C" int fl_update_body(const float* HTH, const float* HTh, const float* P,
                              const float* x, const float* x_prop, float inv_R, float D,
                              const uint8_t* active, float* xn, float* Pf, float* dxo,
                              float* gm, cudaStream_t stream) {
  fl_update_body_kernel<<<1, FL_BODY_THREADS, 0, stream>>>(HTH, HTh, P, x, x_prop, inv_R, D,
                                                         active, xn, Pf, dxo, gm);
  return (int)cudaGetLastError();
}
