// K5's body: ONE iterated-EKF update iteration (transcribes
// fast_limo_tpu/ops/update_body.py:_iter_core and gain.py:gain_math;
// reference esekfom.hpp:1650-1819), run by one block of eight warps on a
// shared-memory workspace:
//
//   J₁ chart projection   dx_new = J₁·dx ; P_it = J₁·P·J₁ᵀ
//   gain                  fl_gain_math's steps (gain.cuh): masked Cholesky
//                         compression of HᵀH, Gauss-Jordan WITH partial
//                         pivoting on Sᵀ
//   dx_                   = K_h + K_x·dx_new[:12] − dx_new
//   degeneracy guard      6×6 cyclic Jacobi eigh of HᵀH[:6, :6], ascending
//                         sort, spectral projector on the pose head
//   boxplus, Joseph P     J₂·(A·P_it·Aᵀ + R·K·Kᵀ)·J₂ᵀ, symmetrized
//
// The work is a few 10⁵ flops of dependent small algebra, so the card's
// time is the length of the chain of steps, not their flops.  The schedule
// cuts that chain:
//  - the last warp (the guard warp) runs the guard's eigendecomposition
//    from the start — it reads only HᵀH — while the other seven warps (the
//    team, FlTeam with named barrier FL_BAR_TEAM) run J₁, the gain and dx_;
//    the team ARRIVES at FL_BAR_DXO when dx_ is written, the guard warp
//    waits there, then projects the pose head and applies it;
//  - warp 0 factors HᵀH while three lanes build J₁'s chart blocks;
//  - the pivoted elimination spreads over the team (gain.cuh).
// The guard's 75 dependent rotations (each two divisions and two square
// roots) are then the longest chain; the team waits for them at the join.
// The 23×23 products are team-parallel, one output a thread.  Every value
// sees, in their order, the float operations of a one-thread version
// (build with --fmad=false), so it gets that version's bits.
// Shared by the standalone body kernel (update_body.cu) and the whole-loop
// kernel; both launch FL_BODY_THREADS threads a block.
#pragma once

#include "common.cuh"
#include "gain.cuh"

#define FL_BODY_THREADS 256            // eight warps: the team and the guard warp
#define FL_BODY_TEAM (FL_BODY_THREADS - 32)
#define FL_BAR_TEAM 1                  // the team (warps 0-6)
#define FL_BAR_DXO 2                   // dx_ written: the team arrives, the guard warp waits

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
FL_DEV void fl_fill_J(float* J, const float* blk, FlTeam team) {
  for (int o = threadIdx.x; o < FL_NS * FL_NS; o += team.n) {
    int i = o / FL_NS, j = o % FL_NS;
    float v = (i == j) ? 1.0f : 0.0f;
    if (i >= 3 && i < 6 && j >= 3 && j < 6) v = blk[(i - 3) * 3 + (j - 3)];
    else if (i >= 6 && i < 9 && j >= 6 && j < 9) v = blk[9 + (i - 6) * 3 + (j - 6)];
    else if (i >= 21 && j >= 21) v = blk[18 + (i - 21) * 2 + (j - 21)];
    J[o] = v;
  }
  fl_sync(team);
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

// blk ← (A(a)ᵀ, A(b)ᵀ, Nx_yy(g)·Mx(gp, d2)), lane 0 of each of warps 1-3
FL_DEV void fl_chart_blocks(const float* a, const float* b, const float* g, const float* gp,
                            const float* d2, float* blk) {
  const int tid = threadIdx.x;
  if (tid == 32) fl_A_T(a, blk);
  else if (tid == 64) fl_A_T(b, blk + 9);
  else if (tid == 96) fl_res2(g, gp, d2, blk + 18);
}

// ------------------------------------------------ the guard warp's steps

// Gershgorin lower bound of HᵀH[:6, :6]'s eigenvalues (telemetry).
FL_DEV float fl_gershgorin6(const float* HTH) {
  float gm = INFINITY;
  for (int i = 0; i < 6; ++i) {
    float r = 0.0f;
    for (int j = 0; j < 6; ++j) r += fabsf(HTH[i * FL_M + j]);
    float di = HTH[i * FL_M + i];
    gm = fminf(gm, di - (r - fabsf(di)));
  }
  return gm;
}

// 6×6 cyclic Jacobi eigh (5 sweeps) of HᵀH[:6, :6] by ONE warp, eigenpairs
// sorted ascending (update_body._jacobi_eigh6 + _sort_eig6): lane i < 6
// holds row i of A and of V in registers (lanes ≥ 6 shadow row 0) and a
// rotation takes its pivots and the rows p, q by shuffles; every lane ends
// with the eigenvalues w, lane i with row i of V.  The float operations of
// one-thread sweeps in their order, so their bits.  (Every lane holding
// all of A and V instead — no shuffle — measured slower: PERF.md, PR 7.)
FL_DEV void fl_eigh6(const float* HTH, float (&v)[6], float (&w)[6]) {
  const int lane = threadIdx.x & 31, r = lane < 6 ? lane : 0;
  float a[6];
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
}

// The spectral projector on the pose head (update_body.jacobi_guard_head)
// from fl_eigh6's rows: head = dx6 where min_eig ≥ D, else
// V·diag(w ≥ D)·Vᵀ·dx6 (mask·dx6 where the eigenvalues' product is under
// 1e-20).  Every lane ends with all six entries.
FL_DEV void fl_project6(const float (&v)[6], const float (&w)[6], float min_eig,
                        const float* dx6, float D, float (&head)[6]) {
  const int lane = threadIdx.x & 31, r = lane < 6 ? lane : 0;
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
  const float wprod = w[0] * w[1] * w[2] * w[3] * w[4] * w[5];
  float gh = 0.0f, mr = 0.0f;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    gh += (v[j] * m[j]) * y[j];
    if (j == r) mr = m[j];
  }
  if (wprod < 1e-20f) gh = mr * dxr;
  const float out = min_eig >= D ? dxr : gh;
#pragma unroll
  for (int j = 0; j < 6; ++j) head[j] = __shfl_sync(FL_FULL, out, j);
}

// The guard warp: eigh6 (with the Gershgorin telemetry) from the body's
// start, then — once the team has written dx_ — the projector and the pose
// part of the boxplus (x.pos + head[0:3], x.rot ⊗ exp(head[3:6])).
FL_DEV void fl_guard_warp(FlIterWS* w, float D) {
  const bool lane0 = (threadIdx.x & 31) == 0;
  float v[6], ev[6];
  // ==== eigh6 ====
  const float gm = fl_gershgorin6(w->g.HTH);
  fl_eigh6(w->g.HTH, v, ev);
  float min_eig = ev[0];
#pragma unroll
  for (int j = 1; j < 6; ++j) min_eig = fminf(min_eig, ev[j]);
  if (lane0) {
    w->gersh = gm;
    w->min_eig = min_eig;
  }
  // ==== wait for dx_ ====
  fl_bar_sync(FL_BAR_DXO, FL_BODY_THREADS);
  // ==== projector, pose boxplus ====
  float head[6];
  fl_project6(v, ev, min_eig, w->dxo, D, head);
  if (lane0) {
    float q[4];
    for (int i = 0; i < 3; ++i) w->xn[i] = w->x[i] + head[i];
    fl_exp_quat(head + 3, 0.5f, q);
    fl_qmul(w->x + 3, q, w->xn + 3);
  }
  // ==== join ====
}

// The team's steps: J₁, the gain, dx_ (then arrive at FL_BAR_DXO), the
// rest of the boxplus, the Joseph form and J₂.  dx_from_x: dx = x ⊟ x_prop
// first (beside the Cholesky); otherwise w->dx holds it.
FL_DEV void fl_iter_team(FlIterWS* w, float inv_R, bool dx_from_x) {
  const FlTeam team{FL_BODY_TEAM, FL_BAR_TEAM};
  const int tid = threadIdx.x, nt = team.n;
  const int NS = FL_NS, M = FL_M;

  // ---- chart projection J₁ (its blocks beside the masked Cholesky) ----
  if (tid < 32) fl_chol_warp(&w->g);
  else if (dx_from_x && tid == 32) fl_state_boxminus(w->x, w->xp, w->dx);
  if (dx_from_x) fl_sync(team);
  fl_chart_blocks(w->dx + 3, w->dx + 6, w->x + 23, w->xp + 23, w->dx + 21, w->blk);
  fl_sync(team);
  fl_fill_J(w->J, w->blk, team);
  for (int i = tid; i < NS; i += nt) {
    float acc = 0.0f;
    for (int k = 0; k < NS; ++k) acc += w->J[i * NS + k] * w->dx[k];
    w->dxn[i] = acc;
  }
  fl_blk_mm(w->T, w->J, NS, false, w->P, NS, false, NS, NS, NS, team);
  fl_blk_mm(w->Pit, w->T, NS, false, w->J, NS, true, NS, NS, NS, team);

  // ---- gain (gain.cuh): K_x, K_h, K from (L, h̃, P_it[:, :12], 1/R) ----
  fl_gain_solve(&w->g, w->Pit, NS, inv_R, team);

  // ---- dx_ = K_h + K_x·dx_new[:12] − dx_new ----
  for (int i = tid; i < NS; i += nt) {
    float acc = 0.0f;
    for (int j = 0; j < M; ++j) acc += w->g.Kx[i * M + j] * w->dxn[j];
    w->dxo[i] = w->g.Kh[i] + acc - w->dxn[i];
  }
  fl_bar_arrive(FL_BAR_DXO, FL_BODY_THREADS);
  fl_sync(team);

  // ---- boxplus and the J₂ chart blocks, lane 0 of warps 1-3 ----
  const float* d = w->dxo;
  const float* x = w->x;
  if (tid == 32) {
    fl_A_T(d + 3, w->blk);
    for (int i = 0; i < 12; ++i) w->xn[11 + i] = x[11 + i] + d[9 + i];
  } else if (tid == 64) {
    float q[4];
    fl_A_T(d + 6, w->blk + 9);
    fl_exp_quat(d + 6, 0.5f, q);
    fl_qmul(x + 7, q, w->xn + 7);
  } else if (tid == 96) {
    fl_s2_boxplus(x + 23, d + 21, w->xn + 23);
    fl_res2(w->xn + 23, w->xp + 23, d + 21, w->blk + 18);
  }

  // ---- Joseph form: M0 = A·P_it·Aᵀ + R·K·Kᵀ, A = I − [K_x | 0] ----
  for (int o = tid; o < NS * NS; o += nt) {
    int i = o / NS, j = o % NS;
    w->J[o] = (i == j ? 1.0f : 0.0f) - (j < M ? w->g.Kx[i * M + j] : 0.0f);
  }
  fl_sync(team);
  fl_blk_mm(w->T, w->J, NS, false, w->Pit, NS, false, NS, NS, NS, team);
  fl_blk_mm(w->M0, w->T, NS, false, w->J, NS, true, NS, NS, NS, team);
  const float Rv = 1.0f / inv_R;
  for (int o = tid; o < NS * NS; o += nt) {
    int i = o / NS, j = o % NS;
    float kk = 0.0f;
    for (int m = 0; m < M; ++m) kk += w->g.K[i * M + m] * w->g.K[j * M + m];
    w->M0[o] = w->M0[o] + Rv * kk;
  }
  fl_sync(team);

  // ---- J₂ chart projection, symmetrize ----
  fl_fill_J(w->J, w->blk, team);
  fl_blk_mm(w->T, w->J, NS, false, w->M0, NS, false, NS, NS, NS, team);
  fl_blk_mm(w->Pit, w->T, NS, false, w->J, NS, true, NS, NS, NS, team);
  for (int o = tid; o < NS * NS; o += nt) {
    int i = o / NS, j = o % NS;
    w->Pf[o] = 0.5f * (w->Pit[o] + w->Pit[j * NS + i]);
  }
  // ---- join: the guard warp's pose ----
}

// One full iteration on the workspace; every thread of the block
// (FL_BODY_THREADS) calls it, with HᵀH, Hᵀh, P, x, x_prop and — unless
// dx_from_x — dx in the workspace.  Ends on a block barrier.
FL_DEV void fl_iter_body(FlIterWS* w, float inv_R, float D, bool dx_from_x) {
  if (threadIdx.x >= FL_BODY_TEAM) fl_guard_warp(w, D);
  else fl_iter_team(w, inv_R, dx_from_x);
  __syncthreads();
}
