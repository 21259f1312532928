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
// The 12×12 factorization, the forward solve and the pivot choice are
// serial (thread 0 between barriers); the products and the elimination
// sweeps spread over the block.  Shared by the standalone gain kernel
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
  float Aug[FL_M * (FL_M + FL_NS)];
  float h[FL_M];
  float fac[FL_M];
};

// g->HTH and g->HTh hold the statistics; P is (23, ≥12) with row stride
// ldp (shared or global memory), of which columns 0:12 are read.  Leaves
// K, Kx, Kh in the workspace, ending on a barrier.
FL_DEV void fl_gain_math(FlGainWS* g, const float* P, int ldp, float inv_R) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int NS = FL_NS, M = FL_M;

  // ---- masked Cholesky compression (serial, 12×12) ----
  if (tid == 0) {
    float A[FL_M * FL_M];
    bool iszero[FL_M];
    float dmax = -INFINITY;
    for (int i = 0; i < M * M; ++i) A[i] = g->HTH[i];
    for (int j = 0; j < M; ++j) {
      float dj = A[j * M + j];
      iszero[j] = dj == 0.0f;
      dmax = fmaxf(dmax, dj);
      if (iszero[j]) A[j * M + j] = 1.0f;
    }
    float dead = 1e-12f * dmax;
    for (int i = 0; i < M * M; ++i) g->L[i] = 0.0f;
    for (int j = 0; j < M; ++j) {
      float a[FL_M];
      for (int i = 0; i < M; ++i) {
        float acc = 0.0f;
        for (int m = 0; m < M; ++m) acc += g->L[i * M + m] * g->L[j * M + m];
        a[i] = A[i * M + j] - acc;
      }
      float d = a[j];
      float inv_p = d > dead ? 1.0f / sqrtf(fmaxf(d, 1e-30f)) : 0.0f;
      for (int i = 0; i < M; ++i) g->L[i * M + j] = i >= j ? a[i] * inv_p : 0.0f;
    }
    for (int i = 0; i < M; ++i)
      for (int j = 0; j < M; ++j) g->Ht[i * M + j] = iszero[i] ? 0.0f : g->L[j * M + i];
    for (int i = 0; i < M; ++i) g->h[i] = 0.0f;
    for (int i = 0; i < M; ++i) {
      float acc = 0.0f;
      for (int m = 0; m < M; ++m) acc += g->L[i * M + m] * g->h[m];
      acc = g->HTh[i] - acc;
      float dd = g->L[i * M + i];
      g->h[i] = acc * (dd != 0.0f ? 1.0f / dd : 0.0f);
    }
    for (int i = 0; i < M; ++i)
      if (iszero[i]) g->h[i] = 0.0f;
  }
  __syncthreads();
  // PH̃ᵀ = P[:, :12]·H̃ᵀ ; S = H̃·PH̃ᵀ[:12]/R + I
  fl_blk_mm(g->PHt, P, ldp, false, g->Ht, M, true, NS, M, M);
  fl_blk_mm(g->S, g->Ht, M, false, g->PHt, M, false, M, M, M);
  const int AW = M + NS;
  for (int o = tid; o < M * AW; o += nt) {
    int i = o / AW, j = o % AW;
    g->Aug[o] = j < M ? g->S[j * M + i] * inv_R + (i == j ? 1.0f : 0.0f)
                      : g->PHt[(j - M) * M + i];
  }
  __syncthreads();
  // ---- Gauss-Jordan with partial pivoting on [Sᵀ | PH̃ᵀᵀ] ----
  for (int k = 0; k < M; ++k) {
    if (tid == 0) {
      int piv = k;
      float best = -1.0f;
      for (int i = 0; i < M; ++i) {
        float c = i >= k ? fabsf(g->Aug[i * AW + k]) : -1.0f;
        if (c > best) { best = c; piv = i; }
      }
      float pkv = g->Aug[piv * AW + k];
      float inv_pk = pkv != 0.0f ? 1.0f / pkv : 0.0f;
      for (int j = 0; j < AW; ++j) {
        float rp = g->Aug[piv * AW + j], rk = g->Aug[k * AW + j];
        g->Aug[piv * AW + j] = rk;
        g->Aug[k * AW + j] = rp * inv_pk;
      }
      for (int i = 0; i < M; ++i) g->fac[i] = i == k ? 0.0f : g->Aug[i * AW + k];
    }
    __syncthreads();
    for (int o = tid; o < M * AW; o += nt) {
      int i = o / AW, j = o % AW;
      if (i != k) g->Aug[o] = g->Aug[o] - g->fac[i] * g->Aug[k * AW + j];
    }
    __syncthreads();
  }
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
