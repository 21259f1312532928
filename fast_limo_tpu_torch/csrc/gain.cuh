// The iEKF gain (transcribes fast_limo_tpu/ops/gain.py:gain_math; reference
// esekfom.hpp:1701-1709) as device functions on a shared-memory workspace,
// run by a team of a block's threads (FlTeam, common.cuh):
//
//   L    = masked Cholesky of HᵀH (unit pivots on zero diagonals, columns
//          whose pivot is under 1e-12·max(diag) zeroed) ; H̃ = Lᵀ ; h̃ = L⁻¹Hᵀh
//   PH̃ᵀ  = P[:, :12]·H̃ᵀ ; S = H̃·PH̃ᵀ[:12]/R + I
//   K    = Gauss-Jordan WITH partial pivoting on [Sᵀ | PH̃ᵀᵀ] (exact row
//          moves; load-bearing: float32 P's slight asymmetry makes S
//          slightly indefinite), scaled by 1/R
//   K_x  = K·H̃ ; K_h = K·h̃
//
// The 12×12 factorization with its forward solve runs on ONE warp with the
// rows in registers (it reads only HᵀH and Hᵀh, so the update iteration
// runs it beside its chart projection).  The elimination spreads over the
// team: per pivot step one warp picks the pivot, then every element of
// [Sᵀ | PH̃ᵀᵀ] is updated by its own thread from the previous step's buffer
// (two buffers, one team barrier a step).  Every value sees the float
// operations of a one-thread loop in its order (build with --fmad=false),
// so the bits are that loop's.  Shared by the standalone gain kernel
// (gain.cu) and the update iteration (iter_body.cuh), which embeds the
// workspace in its own.
#pragma once

#include "common.cuh"

struct FlGainWS {
  float HTH[FL_M * FL_M];     // in
  float HTh[FL_M];            // in
  float PHt[FL_NS * FL_M];
  float K[FL_NS * FL_M];      // out
  float Kx[FL_NS * FL_M];     // out
  float Kh[FL_NS];            // out
  float Ht[FL_M * FL_M];
  float L[FL_M * FL_M];
  float S[FL_M * FL_M];
  float Aug[FL_M * (FL_M + FL_NS)];   // out of the elimination
  float Aug2[FL_M * (FL_M + FL_NS)];  // its other buffer
  float fac[2][FL_M];                 // a step's row multipliers (after its swap)
  float inv_pk[2];                    // 1 / its pivot (0 for a zero pivot)
  int piv[2];                         // its pivot row
  float h[FL_M];
};

// Masked Cholesky compression by ONE warp (all 32 lanes call it): lane
// i < 12 holds row i of HᵀH and of L in registers and takes row j of L by
// shuffles for column j; lanes ≥ 12 shadow row 0 and store nothing.  It
// repeats, in their order, the float operations of a one-thread
// left-looking factorization and forward solve (gain.py:gain_math's
// algebra), so it gives that loop's bits.
// Leaves L, h̃ in the workspace.
FL_DEV void fl_chol_warp(FlGainWS* g) {
  const int M = FL_M, lane = threadIdx.x & 31;
  const int r = lane < M ? lane : 0;
  float A[FL_M], L[FL_M];
  float dr = 0.0f;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    A[m] = g->HTH[r * M + m];
    L[m] = 0.0f;
    if (m == r) dr = A[m];
  }
  const bool iszero = dr == 0.0f;
  float dmax = -INFINITY;
#pragma unroll
  for (int j = 0; j < M; ++j) dmax = fmaxf(dmax, __shfl_sync(FL_FULL, dr, j));
#pragma unroll
  for (int m = 0; m < M; ++m)
    if (m == r && iszero) A[m] = 1.0f;
  const float dead = 1e-12f * dmax;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int m = 0; m < M; ++m) acc += L[m] * __shfl_sync(FL_FULL, L[m], j);
    float a = A[j] - acc;
    float d = __shfl_sync(FL_FULL, a, j);
    float inv_p = d > dead ? 1.0f / sqrtf(fmaxf(d, 1e-30f)) : 0.0f;
    L[j] = r >= j ? a * inv_p : 0.0f;
  }
  // forward solve L·h̃ = Hᵀh: row i on lane i, h̃ broadcast as it grows
  float h[FL_M];
#pragma unroll
  for (int m = 0; m < M; ++m) h[m] = 0.0f;
  const float u = g->HTh[r];
  float mine = 0.0f;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int m = 0; m < M; ++m) acc += L[m] * h[m];
    acc = u - acc;
    float dd = L[i];
    float hi = acc * (dd != 0.0f ? 1.0f / dd : 0.0f);
    if (i == r) mine = hi;
    h[i] = __shfl_sync(FL_FULL, hi, i);
  }
  if (lane < M) {
#pragma unroll
    for (int m = 0; m < M; ++m) g->L[r * M + m] = L[m];
    g->h[r] = iszero ? 0.0f : mine;
  }
}

// The pivot of column `col` by ONE warp: lane i < 12 passes v =
// Aug[i][col]; the first row ≥ col with the largest |v| wins (a butterfly
// argmax, ties to the lowest row; NaN is never a pivot).  Writes control
// slot s: the pivot row, 1 / its value, and every row's multiplier as the
// row holds it after the swap (row col: 0; the pivot row: Aug[col][col]).
FL_DEV void fl_gj_pivot(float v, int col, FlGainWS* g, int s) {
  const int lane = threadIdx.x & 31;
  float bv = fabsf(v);
  if (!(lane < FL_M && lane >= col && bv >= 0.0f)) bv = -1.0f;
  int bi = lane;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(FL_FULL, bv, off);
    int oi = __shfl_xor_sync(FL_FULL, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
  }
  const int piv = bv > -1.0f ? bi : col;
  const float pkv = __shfl_sync(FL_FULL, v, piv);
  const float vk = __shfl_sync(FL_FULL, v, col);
  if (lane < FL_M) g->fac[s][lane] = lane == col ? 0.0f : (lane == piv ? vk : v);
  if (lane == 0) {
    g->piv[s] = piv;
    g->inv_pk[s] = pkv != 0.0f ? 1.0f / pkv : 0.0f;
  }
}

// Gauss-Jordan WITH partial pivoting on Aug = [Sᵀ | PH̃ᵀᵀ] (12 × 35) by the
// team (warp 0 in it).  Step k reads one buffer and writes the other: row k
// becomes the pivot row times 1/pivot, every other row i its row after the
// swap minus fac_i times the new row k — per element, the operations of
// the one-thread loop (swap, normalise, eliminate).  Elements are dealt
// out column by column from column k + 1, so lanes 0-11 of warp 0 compute
// column k + 1 first and pick step k + 1's pivot from their registers
// before the step's barrier.  Twelve steps end in g->Aug.
FL_DEV void fl_gauss_jordan(FlGainWS* g, FlTeam team) {
  const int M = FL_M, AW = FL_M + FL_NS, tid = threadIdx.x;
  if (tid < 32) fl_gj_pivot(tid < M ? g->Aug[tid * AW] : 0.0f, 0, g, 0);
  fl_sync(team);
  for (int k = 0; k < M; ++k) {
    const float* src = (k & 1) ? g->Aug2 : g->Aug;
    float* dst = (k & 1) ? g->Aug : g->Aug2;
    const int s = k & 1, piv = g->piv[s];
    const float inv_pk = g->inv_pk[s];
    float next = 0.0f;   // lanes 0-11: row `lane` of column k + 1
    for (int e = tid; e < M * AW; e += team.n) {
      const int i = e % M;
      int j = k + 1 + e / M;
      if (j >= AW) j -= AW;
      const float rkj = src[piv * AW + j] * inv_pk;
      const float v = i == k ? rkj : (i == piv ? src[k * AW + j] : src[i * AW + j])
                                          - g->fac[s][i] * rkj;
      dst[i * AW + j] = v;
      if (e < M) next = v;
    }
    if (tid < 32 && k + 1 < M) fl_gj_pivot(next, k + 1, g, s ^ 1);
    fl_sync(team);
  }
}

// After fl_chol_warp: g->HTH, g->L, g->h hold the factor; P is (23, ≥12)
// with row stride ldp (shared or global memory), of which columns 0:12 are
// read.  Leaves K, Kx, Kh in the workspace, ending on the team's barrier.
FL_DEV void fl_gain_solve(FlGainWS* g, const float* P, int ldp, float inv_R, FlTeam team) {
  const int tid = threadIdx.x, nt = team.n;
  const int NS = FL_NS, M = FL_M;

  // ---- H̃ ; PH̃ᵀ = P[:, :12]·H̃ᵀ ; S = H̃·PH̃ᵀ[:12]/R + I ; Aug ----
  for (int o = tid; o < M * M; o += nt) {
    int i = o / M, j = o % M;
    g->Ht[o] = g->HTH[i * M + i] == 0.0f ? 0.0f : g->L[j * M + i];
  }
  fl_sync(team);
  fl_blk_mm(g->PHt, P, ldp, false, g->Ht, M, true, NS, M, M, team);
  fl_blk_mm(g->S, g->Ht, M, false, g->PHt, M, false, M, M, M, team);
  const int AW = M + NS;
  for (int o = tid; o < M * AW; o += nt) {
    int i = o / AW, j = o % AW;
    g->Aug[o] = j < M ? g->S[j * M + i] * inv_R + (i == j ? 1.0f : 0.0f)
                      : g->PHt[(j - M) * M + i];
  }
  fl_sync(team);
  // ---- Gauss-Jordan with partial pivoting on [Sᵀ | PH̃ᵀᵀ] ----
  fl_gauss_jordan(g, team);
  // ---- K = Aug[:, 12:]ᵀ/R ; K_x = K·H̃ ; K_h = K·h̃ ----
  for (int o = tid; o < NS * M; o += nt) {
    int i = o / M, j = o % M;
    g->K[o] = g->Aug[j * AW + M + i] * inv_R;
  }
  fl_sync(team);
  fl_blk_mm(g->Kx, g->K, M, false, g->Ht, M, false, NS, M, M, team);
  for (int i = tid; i < NS; i += nt) {
    float acc = 0.0f;
    for (int j = 0; j < M; ++j) acc += g->K[i * M + j] * g->h[j];
    g->Kh[i] = acc;
  }
  fl_sync(team);
}

// The whole gain from g->HTH, g->HTh and P by the team (warp 0 in it).
FL_DEV void fl_gain_math(FlGainWS* g, const float* P, int ldp, float inv_R, FlTeam team) {
  if (threadIdx.x < 32) fl_chol_warp(g);
  fl_sync(team);
  fl_gain_solve(g, P, ldp, inv_R, team);
}
