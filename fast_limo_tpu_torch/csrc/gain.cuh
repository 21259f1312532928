// The iEKF gain (transcribes fast_limo_tpu/ops/gain.py:gain_math; reference
// esekfom.hpp:1701-1709) as ONE device function on a shared-memory
// workspace, run by every thread of one block:
//
//   L    = masked Cholesky of HᵀH (unit pivots on zero diagonals, columns
//          whose pivot is under 1e-12·max(diag) zeroed) ; H̃ = Lᵀ ; h̃ = L⁻¹Hᵀh
//   PH̃ᵀ  = P[:, :12]·H̃ᵀ ; S = H̃·PH̃ᵀ[:12]/R + I
//   K    = Gauss-Jordan WITH partial pivoting on [Sᵀ | PH̃ᵀᵀ] (exact row
//          moves; load-bearing: float32 P's slight asymmetry makes S
//          slightly indefinite), scaled by 1/R
//   K_x  = K·H̃ ; K_h = K·h̃
//
// The 12×12 factorization with its forward solve, and the elimination,
// run on ONE warp with the rows in registers (shuffles in place of a
// thread-0 loop over shared memory); the products spread over the block.
// Shared by the standalone gain kernel (gain.cu) and the update iteration
// (iter_body.cuh), which embeds the workspace in its own.
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
  float Aug[FL_M * (FL_M + FL_NS)];
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

// Gauss-Jordan WITH partial pivoting on Aug = [Sᵀ | PH̃ᵀᵀ] (12 × 35) by ONE
// warp: lane i < 12 holds row i in registers; the pivot (the first row
// ≥ k with the largest |Aug[i][k]|) by a butterfly argmax, the row swap
// and the elimination by shuffles.  It repeats the float operations of a
// one-thread elimination (gain.py:gain_math's algebra), so it gives that
// loop's bits.
FL_DEV void fl_gauss_jordan_warp(FlGainWS* g) {
  const int M = FL_M, AW = FL_M + FL_NS, lane = threadIdx.x & 31;
  const int r = lane < M ? lane : 0;
  float row[FL_M + FL_NS];
#pragma unroll
  for (int j = 0; j < AW; ++j) row[j] = g->Aug[r * AW + j];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    float bv = fabsf(row[k]);
    if (!(lane < M && lane >= k && bv >= 0.0f)) bv = -1.0f;   // NaN is never a pivot
    int bi = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_xor_sync(FL_FULL, bv, off);
      int oi = __shfl_xor_sync(FL_FULL, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    }
    const int piv = bv > -1.0f ? bi : k;
    const float pkv = __shfl_sync(FL_FULL, row[k], piv);
    const float inv_pk = pkv != 0.0f ? 1.0f / pkv : 0.0f;
#pragma unroll
    for (int j = 0; j < AW; ++j) {
      float rp = __shfl_sync(FL_FULL, row[j], piv), rk = __shfl_sync(FL_FULL, row[j], k);
      if (lane == piv) row[j] = rk;
      if (lane == k) row[j] = rp * inv_pk;
    }
    const float fac = lane == k ? 0.0f : row[k];
#pragma unroll
    for (int j = 0; j < AW; ++j) {
      float rkj = __shfl_sync(FL_FULL, row[j], k);
      if (lane != k) row[j] = row[j] - fac * rkj;
    }
  }
  if (lane < M)
#pragma unroll
    for (int j = 0; j < AW; ++j) g->Aug[r * AW + j] = row[j];
}

// g->HTH and g->HTh hold the statistics; P is (23, ≥12) with row stride
// ldp (shared or global memory), of which columns 0:12 are read.  Leaves
// K, Kx, Kh in the workspace, ending on a barrier.
FL_DEV void fl_gain_math(FlGainWS* g, const float* P, int ldp, float inv_R) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int NS = FL_NS, M = FL_M;

  // ---- masked Cholesky compression (warp 0, 12×12) ----
  if (tid < 32) fl_chol_warp(g);
  __syncthreads();
  for (int o = tid; o < M * M; o += nt) {
    int i = o / M, j = o % M;
    g->Ht[o] = g->HTH[i * M + i] == 0.0f ? 0.0f : g->L[j * M + i];
  }
  __syncthreads();
  // ---- PH̃ᵀ = P[:, :12]·H̃ᵀ ; S = H̃·PH̃ᵀ[:12]/R + I ----
  fl_blk_mm(g->PHt, P, ldp, false, g->Ht, M, true, NS, M, M);
  fl_blk_mm(g->S, g->Ht, M, false, g->PHt, M, false, M, M, M);
  const int AW = M + NS;
  for (int o = tid; o < M * AW; o += nt) {
    int i = o / AW, j = o % AW;
    g->Aug[o] = j < M ? g->S[j * M + i] * inv_R + (i == j ? 1.0f : 0.0f)
                      : g->PHt[(j - M) * M + i];
  }
  __syncthreads();
  // ---- Gauss-Jordan with partial pivoting on [Sᵀ | PH̃ᵀᵀ] (warp 0) ----
  if (tid < 32) fl_gauss_jordan_warp(g);
  __syncthreads();
  // ---- K = Aug[:, 12:]ᵀ/R ; K_x = K·H̃ ; K_h = K·h̃ ----
  for (int o = tid; o < NS * M; o += nt) {
    int i = o / M, j = o % M;
    g->K[o] = g->Aug[j * AW + M + i] * inv_R;
  }
  __syncthreads();
  fl_blk_mm(g->Kx, g->K, M, false, g->Ht, M, false, NS, M, M);
  for (int i = tid; i < NS; i += nt) {
    float acc = 0.0f;
    for (int j = 0; j < M; ++j) acc += g->K[i * M + j] * g->h[j];
    g->Kh[i] = acc;
  }
  __syncthreads();
}
