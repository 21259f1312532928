// K8 — the iEKF gain from the sufficient statistics (replaces
// fast_limo_tpu/ops/gain.py:gain_tpu).
//
// One block runs fl_gain_math (gain.cuh), the device function the update
// iteration K5/K6 runs inside its body.  Inputs HᵀH (12,12), Hᵀh (12,),
// P (23,23) of which columns 0:12 are read, 1/R by value; outputs K_x
// (23,12), K_h (23,), K (23,12).  The work is a serial 12×12 factorization
// and a pivoted elimination of ~10⁴ flops: latency-bound, so one block
// keeps everything in shared memory.  Serves the split-body configuration
// of iekf.update_iterated, where the chart projection, the guard and the
// Joseph covariance stay plain torch around it.
#include "gain.cuh"

#define FL_GAIN_THREADS 256

__global__ void __launch_bounds__(FL_GAIN_THREADS)
fl_gain_kernel(const float* __restrict__ HTH, const float* __restrict__ HTh,
               const float* __restrict__ P, float inv_R, float* __restrict__ Kx,
               float* __restrict__ Kh, float* __restrict__ K) {
  __shared__ FlGainWS g;
  __shared__ float Pm[FL_NS * FL_M];
  const int tid = threadIdx.x;
  for (int i = tid; i < FL_M * FL_M; i += blockDim.x) g.HTH[i] = HTH[i];
  for (int i = tid; i < FL_M; i += blockDim.x) g.HTh[i] = HTh[i];
  for (int o = tid; o < FL_NS * FL_M; o += blockDim.x)
    Pm[o] = P[(o / FL_M) * FL_NS + o % FL_M];
  __syncthreads();
  fl_gain_math(&g, Pm, FL_M, inv_R);
  for (int i = tid; i < FL_NS * FL_M; i += blockDim.x) { Kx[i] = g.Kx[i]; K[i] = g.K[i]; }
  for (int i = tid; i < FL_NS; i += blockDim.x) Kh[i] = g.Kh[i];
}

extern "C" int fl_gain(const float* HTH, const float* HTh, const float* P, float inv_R,
                       float* Kx, float* Kh, float* K, cudaStream_t stream) {
  fl_gain_kernel<<<1, FL_GAIN_THREADS, 0, stream>>>(HTH, HTh, P, inv_R, Kx, Kh, K);
  return (int)cudaGetLastError();
}
