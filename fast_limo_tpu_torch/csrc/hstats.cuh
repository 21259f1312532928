// K4's per-point body: world transform, point-to-plane residual and the
// keep-masked 12-column Jacobian row (transcribes fast_limo_tpu/ops/
// hstats.py:glob_math/stats_math; reference Localizer.cpp:537-577), its
// 78 + 12 products, and their reduction over a thread-block cluster.
// Shared by the standalone statistics kernel (hstats.cu) and the
// whole-loop update kernel (update_loop.cu).
#pragma once

#include "common.cuh"

// pose constants of one iterate: 14 scalars [rot(wxyz), pos, rot_LI(wxyz), t_LI]
struct FlPose {
  float R[9], E[9], t[3], tl[3];
};

FL_DEV FlPose fl_pose(const float* s) {
  FlPose o;
  fl_rotm(s[0], s[1], s[2], s[3], o.R);
  fl_rotm(s[7], s[8], s[9], s[10], o.E);
  o.t[0] = s[4]; o.t[1] = s[5]; o.t[2] = s[6];
  o.tl[0] = s[11]; o.tl[1] = s[12]; o.tl[2] = s[13];
  return o;
}

// glob = R·p + t
FL_DEV void fl_glob(const FlPose& s, float px, float py, float pz, float* g) {
  g[0] = s.R[0] * px + s.R[1] * py + s.R[2] * pz + s.t[0];
  g[1] = s.R[3] * px + s.R[4] * py + s.R[5] * pz + s.t[1];
  g[2] = s.R[6] * px + s.R[7] * py + s.R[8] * pz + s.t[2];
}

// H row (12, keep-masked) and −dist·keep for one point with world tile g
FL_DEV void fl_hrow(const FlPose& s, bool ee, float px, float py, float pz, float nx, float ny,
                    float nz, float nd, float keep, const float* g, float* H, float* hneg) {
  const float* R = s.R;
  const float* E = s.E;
  float dist = nx * g[0] + ny * g[1] + nz * g[2] + nd;
  float cx = R[0] * nx + R[3] * ny + R[6] * nz;
  float cy = R[1] * nx + R[4] * ny + R[7] * nz;
  float cz = R[2] * nx + R[5] * ny + R[8] * nz;
  H[0] = nx * keep; H[1] = ny * keep; H[2] = nz * keep;
  H[3] = (py * cz - pz * cy) * keep;
  H[4] = (pz * cx - px * cz) * keep;
  H[5] = (px * cy - py * cx) * keep;
  if (ee) {
    float ux = px - s.tl[0], uy = py - s.tl[1], uz = pz - s.tl[2];
    float plx = E[0] * ux + E[3] * uy + E[6] * uz;
    float ply = E[1] * ux + E[4] * uy + E[7] * uz;
    float plz = E[2] * ux + E[5] * uy + E[8] * uz;
    float clx = E[0] * cx + E[3] * cy + E[6] * cz;
    float cly = E[1] * cx + E[4] * cy + E[7] * cz;
    float clz = E[2] * cx + E[5] * cy + E[8] * cz;
    H[6] = (ply * clz - plz * cly) * keep;
    H[7] = (plz * clx - plx * clz) * keep;
    H[8] = (plx * cly - ply * clx) * keep;
    H[9] = cx * keep; H[10] = cy * keep; H[11] = cz * keep;
  } else {
    for (int j = 6; j < 12; ++j) H[j] = 0.0f;
  }
  *hneg = -dist * keep;
}

// entry e < 78 of the packed upper triangle → (a, b), a ≤ b; e ≥ 78 → Hᵀh[e−78]
FL_DEV void fl_tri_pair(int e, int* a, int* b) {
  int r = 0, base = 0;
  while (e >= base + (12 - r)) { base += 12 - r; ++r; }
  *a = r;
  *b = r + (e - base);
}

#define FL_NSTAT 90   // 78 upper-triangle HᵀH entries (fl_tri_pair order) + 12 Hᵀh

// acc += the 78 + 12 products of one H row and its −dist
FL_DEV void fl_stats_add(float (&acc)[FL_NSTAT], const float* H, float hn) {
  int e = 0;
#pragma unroll
  for (int a = 0; a < 12; ++a)
#pragma unroll
    for (int b = a; b < 12; ++b) acc[e++] += H[a] * H[b];
#pragma unroll
  for (int a = 0; a < 12; ++a) acc[78 + a] += H[a] * hn;
}

// One block's scratch for fl_cluster_stats (NW warps).
template <int NW>
struct FlStatsRed {
  float warp[NW][FL_NSTAT];
  float row[FL_NSTAT];   // the block's sums, read by rank 0
};

// Reduces every thread's 90 products over the cluster into HᵀH (12×12,
// both triangles, row stride 12) and Hᵀh (12), in three fixed-order steps:
// a __shfl_down_sync tree inside each warp; the warps' rows summed in warp
// order into the block's row; after a cluster barrier, rank 0 sums every
// block's row in rank order through distributed shared memory and writes
// the result.  No float atomics: bit-reproducible run to run (not bit-equal
// to a two-pass order).  Every thread of every block calls it; only rank 0
// writes.  Rank 0 has read the rows when it reaches its next cluster
// barrier: until every block has passed that barrier, none may rewrite
// r->row or exit.
template <int NW>
FL_DEV void fl_cluster_stats(float (&acc)[FL_NSTAT], FlStatsRed<NW>* r, float* HTH, float* HTh) {
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x;
#pragma unroll
  for (int e = 0; e < FL_NSTAT; ++e) acc[e] = fl_warp_sum(acc[e]);
  if ((tid & 31) == 0)
#pragma unroll
    for (int e = 0; e < FL_NSTAT; ++e) r->warp[tid >> 5][e] = acc[e];
  __syncthreads();
  if (tid < FL_NSTAT) {
    float s = 0.0f;
    for (int w = 0; w < NW; ++w) s += r->warp[w][tid];
    r->row[tid] = s;
  }
  cl.sync();
  if (cl.block_rank() == 0 && tid < FL_NSTAT) {
    float s = 0.0f;
    for (unsigned q = 0; q < cl.num_blocks(); ++q) s += cl.map_shared_rank(&r->row[0], q)[tid];
    if (tid < 78) {
      int a, b;
      fl_tri_pair(tid, &a, &b);
      HTH[a * FL_M + b] = s;
      HTH[b * FL_M + a] = s;
    } else {
      HTh[tid - 78] = s;
    }
  }
}
