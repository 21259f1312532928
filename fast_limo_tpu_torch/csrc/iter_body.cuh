// K5's body: ONE iterated-EKF update iteration (transcribes
// fast_limo_tpu/ops/update_body.py:_iter_core and gain.py:gain_math;
// reference esekfom.hpp:1650-1819), run by one thread block on a shared-
// memory workspace:
//
//   J₁ chart projection   dx_new = J₁·dx ; P_it = J₁·P·J₁ᵀ
//   gain                  fl_gain_math (gain.cuh): masked Cholesky compression
//                         of HᵀH, Gauss-Jordan WITH partial pivoting on Sᵀ
//   dx_                   = K_h + K_x·dx_new[:12] − dx_new
//   degeneracy guard      6×6 cyclic Jacobi eigh, ascending sort, spectral
//                         projector on the pose head
//   boxplus, Joseph P     J₂·(A·P_it·Aᵀ + R·K·Kᵀ)·J₂ᵀ, symmetrized
//
// The 23×23 products run block-parallel (one output per thread); the
// inherently serial steps run on warps with their rows in registers: the
// 12×12 Cholesky and the pivoted elimination (gain.cuh) and the 6×6
// Jacobi sweeps on warp 0; the three chart blocks, and the boxplus, one
// lane each on four warps at once.  Every step repeats, in their order,
// the float operations of a one-thread version, so it gives that version's
// bits.
// Shared by the standalone body kernel (update_body.cu) and the whole-loop
// kernel; needs at least 128 threads.
#pragma once

#include "common.cuh"
#include "gain.cuh"

struct FlIterWS {
  float P[FL_NS * FL_NS];     // P_prop (in)
  float Pit[FL_NS * FL_NS];
  float J[FL_NS * FL_NS];
  float T[FL_NS * FL_NS];
  float M0[FL_NS * FL_NS];
  float Pf[FL_NS * FL_NS];    // out
  FlGainWS g;                 // HTH, HTh (in); K, Kx, Kh (gain.cuh)
  float x[FL_XF];             // current iterate (in)
  float xp[FL_XF];            // prior x_prop (in)
  float dx[FL_NS];            // x ⊟ x_prop (in)
  float dxn[FL_NS];
  float dxo[FL_NS];           // dx_ (out, pre-guard)
  float xn[FL_XF];            // out
  float blk[22];              // chart blocks: A (9), A (9), res2 (4)
  float head[6];              // guarded pose head of dx_
  float gersh, min_eig;       // out
};

// Fill J (23×23): identity with A at 3:6, A' at 6:9 and res2 at 21:23.
FL_DEV void fl_fill_J(float* J, const float* blk) {
  for (int o = threadIdx.x; o < FL_NS * FL_NS; o += blockDim.x) {
    int i = o / FL_NS, j = o % FL_NS;
    float v = (i == j) ? 1.0f : 0.0f;
    if (i >= 3 && i < 6 && j >= 3 && j < 6) v = blk[(i - 3) * 3 + (j - 3)];
    else if (i >= 6 && i < 9 && j >= 6 && j < 9) v = blk[9 + (i - 6) * 3 + (j - 6)];
    else if (i >= 21 && j >= 21) v = blk[18 + (i - 21) * 2 + (j - 21)];
    J[o] = v;
  }
  __syncthreads();
}

// out ← A(v)ᵀ (3×3) — one thread
FL_DEV void fl_A_T(const float* v, float* out) {
  float A[9];
  fl_A_matrix(v, A);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) out[i * 3 + j] = A[j * 3 + i];
}

// out ← Nx_yy(g)·Mx(gp, d2) (2×2) — one thread
FL_DEV void fl_res2(const float* g, const float* gp, const float* d2, float* out) {
  float N[6], Mx[6];
  fl_nx_yy(g, N);
  fl_mx(gp, d2, Mx);
  fl_mm(N, Mx, out, 2, 3, 2);
}

// blk ← (A(a)ᵀ, A(b)ᵀ, Nx_yy(g)·Mx(gp, d2)), one lane of each of warps 0-2
FL_DEV void fl_chart_blocks(const float* a, const float* b, const float* g, const float* gp,
                            const float* d2, float* blk) {
  const int tid = threadIdx.x;
  if (tid == 0) fl_A_T(a, blk);
  else if (tid == 32) fl_A_T(b, blk + 9);
  else if (tid == 64) fl_res2(g, gp, d2, blk + 18);
}

// The degeneracy guard on the pose head (update_body.jacobi_guard_head) by
// ONE warp (all 32 lanes call it): 6×6 cyclic Jacobi eigh (5 sweeps),
// eigenpairs sorted ascending (update_body._jacobi_eigh6 + _sort_eig6),
// spectral projector.  Lane i < 6 holds row i of A and of V in registers;
// a rotation takes its pivots and the rows p, q by shuffles.  The same
// float operations, in their order, of one-thread sweeps, so their bits.
// Lanes 0-5 write out6, lane 0 *min_eig_out.
FL_DEV void fl_guard_head_warp(const float* HTH, const float* dx6, float D, float* out6,
                               float* min_eig_out) {
  const int lane = threadIdx.x & 31;
  const int r = lane < 6 ? lane : 0;
  float a[6], v[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    a[j] = HTH[r * FL_M + j];
    v[j] = r == j ? 1.0f : 0.0f;
  }
  for (int sweep = 0; sweep < 5; ++sweep) {
#pragma unroll
    for (int p = 0; p < 5; ++p)
#pragma unroll
      for (int q = p + 1; q < 6; ++q) {
        float app = __shfl_sync(FL_FULL, a[p], p), aqq = __shfl_sync(FL_FULL, a[q], q);
        float apq = __shfl_sync(FL_FULL, a[q], p);
        bool small = fabsf(apq) <= 1e-30f;
        float safe = small ? 1.0f : apq;
        float tau = (aqq - app) / (2.0f * safe);
        float sgn = tau < 0 ? -1.0f : 1.0f;
        float t = sgn / (fabsf(tau) + sqrtf(1.0f + tau * tau));
        if (small) t = 0.0f;
        float c = 1.0f / sqrtf(1.0f + t * t);
        float s = t * c;
        // A ← A·G (columns p, q), V ← V·G, then Gᵀ·A (rows p, q)
        float aip = a[p], aiq = a[q];
        a[p] = aip * c + aiq * (-s);
        a[q] = aip * s + aiq * c;
        float vip = v[p], viq = v[q];
        v[p] = vip * c + viq * (-s);
        v[q] = vip * s + viq * c;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          float apj = __shfl_sync(FL_FULL, a[j], p), aqj = __shfl_sync(FL_FULL, a[j], q);
          if (lane == p) a[j] = c * apj + (-s) * aqj;
          if (lane == q) a[j] = s * apj + c * aqj;
        }
      }
  }
  float wr = 0.0f;
#pragma unroll
  for (int j = 0; j < 6; ++j)
    if (j == r) wr = a[j];
  float w[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) w[j] = __shfl_sync(FL_FULL, wr, j);
#pragma unroll
  for (int rnd = 0; rnd < 5; ++rnd)
#pragma unroll
    for (int j = 0; j < 5 - rnd; ++j)
      if (w[j] > w[j + 1]) {
        float tw = w[j]; w[j] = w[j + 1]; w[j + 1] = tw;
        float tv = v[j]; v[j] = v[j + 1]; v[j + 1] = tv;
      }
  // spectral projector
  const float dxr = dx6[r];
  float m[6], y[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    m[j] = w[j] >= D ? 1.0f : 0.0f;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) acc += __shfl_sync(FL_FULL, v[j], i) * dx6[i];
    y[j] = acc;
  }
  float wprod = w[0] * w[1] * w[2] * w[3] * w[4] * w[5];
  float min_eig = w[0];
#pragma unroll
  for (int j = 1; j < 6; ++j) min_eig = fminf(min_eig, w[j]);
  float gh = 0.0f, mr = 0.0f;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    gh += (v[j] * m[j]) * y[j];
    if (j == r) mr = m[j];
  }
  if (wprod < 1e-20f) gh = mr * dxr;
  if (lane < 6) out6[r] = min_eig >= D ? dxr : gh;
  if (lane == 0) *min_eig_out = min_eig;
}

// One full iteration on the workspace; every thread of the block calls it.
FL_DEV void fl_iter_body(FlIterWS* w, float inv_R, float D) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int NS = FL_NS, M = FL_M;

  // ---- chart projection J₁ ----
  fl_chart_blocks(w->dx + 3, w->dx + 6, w->x + 23, w->xp + 23, w->dx + 21, w->blk);
  __syncthreads();
  fl_fill_J(w->J, w->blk);
  for (int i = tid; i < NS; i += nt) {
    float acc = 0.0f;
    for (int k = 0; k < NS; ++k) acc += w->J[i * NS + k] * w->dx[k];
    w->dxn[i] = acc;
  }
  fl_blk_mm(w->T, w->J, NS, false, w->P, NS, false, NS, NS, NS);
  fl_blk_mm(w->Pit, w->T, NS, false, w->J, NS, true, NS, NS, NS);

  // ---- gain (gain.cuh): K_x, K_h, K from (HᵀH, Hᵀh, P_it[:, :12], 1/R) ----
  fl_gain_math(&w->g, w->Pit, NS, inv_R);

  // ---- dx_ = K_h + K_x·dx_new[:12] − dx_new ----
  for (int i = tid; i < NS; i += nt) {
    float acc = 0.0f;
    for (int j = 0; j < M; ++j) acc += w->g.Kx[i * M + j] * w->dxn[j];
    w->dxo[i] = w->g.Kh[i] + acc - w->dxn[i];
  }
  __syncthreads();

  // ---- guard (warp 0), Gershgorin telemetry (warp 1) ----
  if (tid < 32) {
    fl_guard_head_warp(w->g.HTH, w->dxo, D, w->head, &w->min_eig);
  } else if (tid == 32) {
    float gm = INFINITY;
    for (int i = 0; i < 6; ++i) {
      float r = 0.0f;
      for (int j = 0; j < 6; ++j) r += fabsf(w->g.HTH[i * M + j]);
      float di = w->g.HTH[i * M + i];
      gm = fminf(gm, di - (r - fabsf(di)));
    }
    w->gersh = gm;
  }
  __syncthreads();
  // ---- boxplus and the J₂ chart blocks, one lane of each of warps 0-3 ----
  {
    const float* d = w->dxo;
    const float* x = w->x;
    if (tid == 0) {
      fl_A_T(d + 3, w->blk);
    } else if (tid == 32) {
      fl_A_T(d + 6, w->blk + 9);
    } else if (tid == 64) {
      fl_s2_boxplus(x + 23, d + 21, w->xn + 23);
      fl_res2(w->xn + 23, w->xp + 23, d + 21, w->blk + 18);
    } else if (tid == 96) {
      float q[4];
      for (int i = 0; i < 3; ++i) w->xn[i] = x[i] + w->head[i];
      fl_exp_quat(w->head + 3, 0.5f, q);
      fl_qmul(x + 3, q, w->xn + 3);
      fl_exp_quat(d + 6, 0.5f, q);
      fl_qmul(x + 7, q, w->xn + 7);
      for (int i = 0; i < 12; ++i) w->xn[11 + i] = x[11 + i] + d[9 + i];
    }
  }
  __syncthreads();

  // ---- Joseph form: M0 = A·P_it·Aᵀ + R·K·Kᵀ, A = I − [K_x | 0] ----
  for (int o = tid; o < NS * NS; o += nt) {
    int i = o / NS, j = o % NS;
    w->J[o] = (i == j ? 1.0f : 0.0f) - (j < M ? w->g.Kx[i * M + j] : 0.0f);
  }
  __syncthreads();
  fl_blk_mm(w->T, w->J, NS, false, w->Pit, NS, false, NS, NS, NS);
  fl_blk_mm(w->M0, w->T, NS, false, w->J, NS, true, NS, NS, NS);
  const float Rv = 1.0f / inv_R;
  for (int o = tid; o < NS * NS; o += nt) {
    int i = o / NS, j = o % NS;
    float kk = 0.0f;
    for (int m = 0; m < M; ++m) kk += w->g.K[i * M + m] * w->g.K[j * M + m];
    w->M0[o] = w->M0[o] + Rv * kk;
  }
  __syncthreads();
  // ---- J₂ chart projection, symmetrize ----
  fl_fill_J(w->J, w->blk);
  fl_blk_mm(w->T, w->J, NS, false, w->M0, NS, false, NS, NS, NS);
  fl_blk_mm(w->Pit, w->T, NS, false, w->J, NS, true, NS, NS, NS);
  for (int o = tid; o < NS * NS; o += nt) {
    int i = o / NS, j = o % NS;
    w->Pf[o] = 0.5f * (w->Pit[o] + w->Pit[j * NS + i]);
  }
  __syncthreads();
}
