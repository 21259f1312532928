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
// inherently serial steps (12×12 Cholesky, pivot choice, Jacobi sweeps,
// manifold charts) run on thread 0 between barriers.  Shared by the
// standalone body kernel (update_body.cu) and the whole-loop kernel.
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

// blk ← (A(a)ᵀ, A(b)ᵀ, Nx_yy(g)·Mx(gp, d2)) — thread 0 only
FL_DEV void fl_chart_blocks(const float* a, const float* b, const float* g, const float* gp,
                            const float* d2, float* blk) {
  float A[9], N[6], Mx[6];
  fl_A_matrix(a, A);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) blk[i * 3 + j] = A[j * 3 + i];
  fl_A_matrix(b, A);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) blk[9 + i * 3 + j] = A[j * 3 + i];
  fl_nx_yy(g, N);
  fl_mx(gp, d2, Mx);
  fl_mm(N, Mx, blk + 18, 2, 3, 2);
}

// 6×6 symmetric eigh by cyclic Jacobi (5 sweeps), eigenpairs sorted
// ascending (update_body._jacobi_eigh6 + _sort_eig6) — thread 0 only
FL_DEV void fl_jacobi_eigh6(const float* H, float* w, float* V) {
  float A[36];
  for (int i = 0; i < 36; ++i) { A[i] = H[i]; V[i] = (i % 7 == 0) ? 1.0f : 0.0f; }
  for (int sweep = 0; sweep < 5; ++sweep)
    for (int p = 0; p < 5; ++p)
      for (int q = p + 1; q < 6; ++q) {
        float app = A[p * 6 + p], aqq = A[q * 6 + q], apq = A[p * 6 + q];
        bool small = fabsf(apq) <= 1e-30f;
        float safe = small ? 1.0f : apq;
        float tau = (aqq - app) / (2.0f * safe);
        float sgn = tau < 0 ? -1.0f : 1.0f;
        float t = sgn / (fabsf(tau) + sqrtf(1.0f + tau * tau));
        if (small) t = 0.0f;
        float c = 1.0f / sqrtf(1.0f + t * t);
        float s = t * c;
        // A ← A·G (columns p, q), then Gᵀ·A (rows p, q); V ← V·G
        for (int i = 0; i < 6; ++i) {
          float aip = A[i * 6 + p], aiq = A[i * 6 + q];
          A[i * 6 + p] = aip * c + aiq * (-s);
          A[i * 6 + q] = aip * s + aiq * c;
          float vip = V[i * 6 + p], viq = V[i * 6 + q];
          V[i * 6 + p] = vip * c + viq * (-s);
          V[i * 6 + q] = vip * s + viq * c;
        }
        for (int j = 0; j < 6; ++j) {
          float apj = A[p * 6 + j], aqj = A[q * 6 + j];
          A[p * 6 + j] = c * apj + (-s) * aqj;
          A[q * 6 + j] = s * apj + c * aqj;
        }
      }
  for (int i = 0; i < 6; ++i) w[i] = A[i * 6 + i];
  for (int rnd = 0; rnd < 5; ++rnd)
    for (int j = 0; j < 5 - rnd; ++j)
      if (w[j] > w[j + 1]) {
        float tw = w[j]; w[j] = w[j + 1]; w[j + 1] = tw;
        for (int i = 0; i < 6; ++i) {
          float tv = V[i * 6 + j]; V[i * 6 + j] = V[i * 6 + j + 1]; V[i * 6 + j + 1] = tv;
        }
      }
}

// The degeneracy guard on the pose head (update_body.jacobi_guard_head)
FL_DEV float fl_guard_head(const float* HTH, const float* dx6, float D, float* out6) {
  float H6[36], w[6], V[36];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) H6[i * 6 + j] = HTH[i * FL_M + j];
  fl_jacobi_eigh6(H6, w, V);
  float m[6], y[6];
  for (int j = 0; j < 6; ++j) {
    m[j] = w[j] >= D ? 1.0f : 0.0f;
    float acc = 0.0f;
    for (int i = 0; i < 6; ++i) acc += V[i * 6 + j] * dx6[i];
    y[j] = acc;
  }
  float wprod = w[0] * w[1] * w[2] * w[3] * w[4] * w[5];
  float min_eig = w[0];
  for (int j = 1; j < 6; ++j) min_eig = fminf(min_eig, w[j]);
  for (int i = 0; i < 6; ++i) {
    float g = 0.0f;
    for (int j = 0; j < 6; ++j) g += (V[i * 6 + j] * m[j]) * y[j];
    if (wprod < 1e-20f) g = m[i] * dx6[i];
    out6[i] = min_eig >= D ? dx6[i] : g;
  }
  return min_eig;
}

// One full iteration on the workspace; every thread of the block calls it.
FL_DEV void fl_iter_body(FlIterWS* w, float inv_R, float D) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int NS = FL_NS, M = FL_M;

  // ---- chart projection J₁ ----
  if (tid == 0) fl_chart_blocks(w->dx + 3, w->dx + 6, w->x + 23, w->xp + 23, w->dx + 21, w->blk);
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

  // ---- Gershgorin telemetry, guard, boxplus, J₂ blocks (serial) ----
  if (tid == 0) {
    float gm = INFINITY;
    for (int i = 0; i < 6; ++i) {
      float r = 0.0f;
      for (int j = 0; j < 6; ++j) r += fabsf(w->g.HTH[i * M + j]);
      float di = w->g.HTH[i * M + i];
      gm = fminf(gm, di - (r - fabsf(di)));
    }
    w->gersh = gm;
    float head[6];
    w->min_eig = fl_guard_head(w->g.HTH, w->dxo, D, head);
    const float* d = w->dxo;
    const float* x = w->x;
    float q[4];
    for (int i = 0; i < 3; ++i) w->xn[i] = x[i] + head[i];
    fl_exp_quat(head + 3, 0.5f, q);
    fl_qmul(x + 3, q, w->xn + 3);
    fl_exp_quat(d + 6, 0.5f, q);
    fl_qmul(x + 7, q, w->xn + 7);
    for (int i = 0; i < 12; ++i) w->xn[11 + i] = x[11 + i] + d[9 + i];
    fl_s2_boxplus(x + 23, d + 21, w->xn + 23);
    fl_chart_blocks(d + 3, d + 6, w->xn + 23, w->xp + 23, d + 21, w->blk);
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
