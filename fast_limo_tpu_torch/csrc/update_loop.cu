// K6 — the whole iterated update in ONE launch, window mode (replaces
// fast_limo_tpu/ops/update_loop.py:update_loop_tpu, TPU bodies
// _loop_kernel, _window_match_math and _boxminus).
//
// All MAX_NUM_ITERS+1 masked iterations of iekf.update_iterated, each with
// the EXACT per-iteration window re-match: true distances over every
// query's frozen top-W window at the current iterate, exact k-smallest
// selection (ties to the lowest slot), a fresh plane fit (plane_fit.cuh),
// the two-pass dynamic gate, the point-order MAX_NUM_MATCHES cap, the
// staleness certificates cert_a/cert_b, the HᵀH/Hᵀh statistics
// (hstats.cuh) and the iteration body (iter_body.cuh).
//
// On the H100 this is latency-bound: ~10⁴ queries × ~2·10³ flops an
// iteration is microseconds of the card, and what costs is each thread's
// serial walk over its points and the chain of dependent grid-wide
// reductions (gate sums, prefix count, 90 statistics, the stale count)
// between which the 23×23 step has to run.  So ONE thread-block cluster
// of FL_UL_CLUSTER blocks runs everything:
//  - block r owns the points [⌊r·Np/C⌋, ⌊(r+1)·Np/C⌋) for the whole launch
//    and runs their re-match, fit, certificates, gate passes and H rows;
//    their intermediates live in the block's slice of an L2-resident
//    scratch (any Np);
//  - every grid-wide quantity is a block reduction in a fixed order and a
//    rank-ordered exchange through distributed shared memory
//    (fl_cluster_sum, fl_cluster_stats: no float atomics, bit-reproducible);
//  - the cap's prefix count stays in point order: a warp scan over
//    contiguous per-thread chunks, the warps' offsets, the lower ranks'
//    counts; each thread adds its kept points' H rows to its 90 products;
//  - rank 0 runs the iteration body and publishes the new iterate and
//    `done`; after a cluster barrier every block reads them, so all blocks
//    leave the loop on the same iteration.
//
// The chart difference uses atan2f, so the TPU kernel's atan series and
// its z² ≤ 0.0625 certificate are gone: `ok` covers the staleness
// certificates alone (any active iteration with a stale query → the
// caller re-runs the exact per-iteration loop).
#include "hstats.cuh"
#include "iter_body.cuh"
#include "plane_fit.cuh"

#define FL_UL_THREADS 256
#define FL_UL_CLUSTER 16   // blocks of the one cluster (PERF.md: measured against 8)
#define FL_UL_WARPS (FL_UL_THREADS / 32)
#define FL_BIG 3.0e38f
#define FL_WMAX 16

struct FlWindow {
  int k, W, max_num_matches;
  float h, max_dist_plane, plane_threshold, thr2, dynamic_gate;
};

// scratch planes (column-major, Np each): plane 4 | frozen 10 | residual 1
// (|n·g + d| of a good plane, −1 for a point without one)
#define FL_SC_PLANE 0
#define FL_SC_FROZEN 4
#define FL_SC_AD 14
#define FL_SC_COLS 15

// fl_cluster_sum call sites
#define FL_SITE_MATCH 0
#define FL_SITE_GATE 1

// flat-state index of pose scalar j of [rot(wxyz), pos, rot_LI(wxyz), t_LI]
FL_DEV int fl_pose_src(int j) { return j < 4 ? 3 + j : (j < 7 ? j - 4 : j); }

__global__ void __launch_bounds__(FL_UL_THREADS, 1)
fl_update_loop_kernel(const float* __restrict__ X, int Np, const float* __restrict__ P,
                      const float* __restrict__ xprop, float inv_R, float limit, float D,
                      FlWindow win, int max_iters, int ee, float* __restrict__ scr,
                      float* __restrict__ xo, float* __restrict__ Po, float* __restrict__ aux) {
  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank(), C = cl.num_blocks();
  __shared__ FlIterWS w;                          // the body's workspace (rank 0)
  __shared__ FlClusterRed red;
  __shared__ FlStatsRed<FL_UL_WARPS> sred;
  __shared__ int s_wcnt[FL_UL_WARPS];             // kept counts → offsets of the warps
  __shared__ int s_cnt, s_off;                    // the block's kept count; lower ranks'
  __shared__ float s_pub[15];                     // rank 0's iterate: pose 14 | done
  __shared__ float s_pose[15];                    // this block's copy of it
  __shared__ float s_state[8];   // rank 0: done, ok, t, nit, gersh_min, min_eig, bad_total

  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, wid = tid >> 5;
  const int lo = (int)((long long)rank * Np / C), hi = (int)((long long)(rank + 1) * Np / C);
  const int W = win.W, k = win.k;
  const float h = win.h;
  const bool gate = win.dynamic_gate > 0.0f;
  if (tid < 14) s_pose[tid] = xprop[fl_pose_src(tid)];
  if (tid == 14) s_pose[14] = 0.0f;
  if (rank == 0) {
    for (int i = tid; i < FL_NS * FL_NS; i += nt) w.P[i] = P[i];
    for (int i = tid; i < FL_XF; i += nt) { w.x[i] = xprop[i]; w.xp[i] = xprop[i]; }
    for (int i = tid; i < FL_NS; i += nt) w.dx[i] = 0.0f;
    if (tid == 0) {
      s_state[0] = 0.0f; s_state[1] = 1.0f; s_state[2] = 0.0f; s_state[3] = 0.0f;
      s_state[4] = INFINITY; s_state[5] = INFINITY; s_state[6] = 0.0f;
    }
  }
  __syncthreads();

  const float* px_ = X;
  const float* py_ = X + Np;
  const float* pz_ = X + 2 * Np;
  const float* pv_ = X + 3 * Np;
  const float* cn_ = X + 4 * Np;
  float* splane = scr + (size_t)FL_SC_PLANE * Np;
  float* sfroz = scr + (size_t)FL_SC_FROZEN * Np;
  float* sres = scr + (size_t)FL_SC_AD * Np;

  for (int it = 0; it <= max_iters; ++it) {
    if (s_pose[14] != 0.0f) break;   // the same published `done` on every block
    const FlPose pose = fl_pose(s_pose);

    // ---- per-point window re-match, fit, staleness ----
    float v3[3] = {0.0f, 0.0f, 0.0f};   // Σ residual·good, Σ good, stale queries
    for (int i = lo + tid; i < hi; i += nt) {
      float p[3] = {px_[i], py_[i], pz_[i]};
      float pvld = pv_[i], cnt = cn_[i];
      float g[3];
      fl_glob(pose, p[0], p[1], p[2], g);
      float d2[FL_WMAX];
      for (int j = 0; j < W; ++j) {
        bool slot_ok = cnt > (float)j + 0.5f;
        const float* wc = X + (size_t)(5 + 3 * j) * Np;
        float dx = g[0] - wc[i], dy = g[1] - wc[Np + i], dz = g[2] - wc[2 * Np + i];
        d2[j] = slot_ok ? dx * dx + dy * dy + dz * dz : FL_BIG;
      }
      if (it == 0) {
        float dmax = d2[0];
        for (int j = 1; j < W; ++j) dmax = fmaxf(dmax, d2[j]);
        for (int a = 0; a < 3; ++a) {
          float v = floorf(g[a] / h);
          float b = floorf((v - 1.0f) * 0.5f);
          sfroz[(size_t)a * Np + i] = g[a];
          sfroz[(size_t)(3 + a) * Np + i] = b;
          sfroz[(size_t)(6 + a) * Np + i] = (2.0f * b + 1.0f) * h;
        }
        sfroz[(size_t)9 * Np + i] = sqrtf(dmax);
      }
      // exact k-smallest selection, ties to the lowest slot
      float sx[FL_FIT_KMAX], sy[FL_FIT_KMAX], sz[FL_FIT_KMAX], sv[FL_FIT_KMAX];
      unsigned taken = 0u;
      float kth = FL_BIG;
      for (int s = 0; s < k; ++s) {
        float m = FL_BIG;
        for (int j = 0; j < W; ++j)
          if (!((taken >> j) & 1u)) m = fminf(m, d2[j]);
        sx[s] = 0.0f; sy[s] = 0.0f; sz[s] = 0.0f; sv[s] = 0.0f;
        if (m < FL_BIG) {
          for (int j = 0; j < W; ++j)
            if (!((taken >> j) & 1u) && d2[j] == m) {
              taken |= 1u << j;
              const float* wc = X + (size_t)(5 + 3 * j) * Np;
              sx[s] = wc[i]; sy[s] = wc[Np + i]; sz[s] = wc[2 * Np + i];
              sv[s] = 1.0f;
              break;
            }
        }
        kth = m;
      }
      FlPlane pl = fl_fit_math(sx, sy, sz, sv, k, kth, k, win.max_dist_plane,
                               win.plane_threshold, win.thr2);
      bool good = pl.good && pvld > 0.0f;
      splane[i] = pl.ux;
      splane[(size_t)Np + i] = pl.uy;
      splane[(size_t)2 * Np + i] = pl.uz;
      splane[(size_t)3 * Np + i] = pl.d;
      float ad = fabsf(pl.ux * g[0] + pl.uy * g[1] + pl.uz * g[2] + pl.d);
      float gf = good ? 1.0f : 0.0f;
      sres[i] = good ? ad : -1.0f;
      v3[0] += ad * gf;
      v3[1] += gf;
      if (it > 0) {
        float ddx = g[0] - sfroz[i], ddy = g[1] - sfroz[(size_t)Np + i],
              ddz = g[2] - sfroz[(size_t)2 * Np + i];
        float delta = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz);
        float kth_d = sqrtf(kth);
        bool cert_a = (cnt < (float)W - 0.5f) || (kth_d < sfroz[(size_t)9 * Np + i] - delta);
        bool b0same = true;
        float leave = 0.0f;
        for (int a = 0; a < 3; ++a) {
          float v = floorf(g[a] / h);
          b0same = b0same && (floorf((v - 1.0f) * 0.5f) == sfroz[(size_t)(3 + a) * Np + i]);
          float lo_a = sfroz[(size_t)(6 + a) * Np + i];
          leave = fmaxf(leave, fmaxf(lo_a - g[a], g[a] - (lo_a + 2.0f * h)));
        }
        bool cert_b = kth_d < h - fmaxf(leave, 0.0f);
        if (pvld > 0.0f && !(cert_a && (b0same || cert_b))) v3[2] += 1.0f;
      }
    }
    fl_cluster_sum(v3, &red, FL_SITE_MATCH);

    // ---- two-pass dynamic gate (robust residual mean) ----
    float tau = 0.0f;
    if (gate) {
      float m1 = v3[0] / fmaxf(v3[1], 1.0f);
      float v2[2] = {0.0f, 0.0f};
      for (int i = lo + tid; i < hi; i += nt) {
        float ad = sres[i];
        float trim = ad >= 0.0f && ad <= 3.0f * m1 + 0.05f ? 1.0f : 0.0f;
        v2[0] += ad * trim;
        v2[1] += trim;
      }
      fl_cluster_sum(v2, &red, FL_SITE_GATE);
      tau = fmaxf(win.dynamic_gate * (v2[0] / fmaxf(v2[1], 1.0f)), 0.05f);
    }

    // ---- MAX_NUM_MATCHES cap in point order, H rows, their products ----
    const int cs = (hi - lo + nt - 1) / nt;
    const int c0 = min(lo + tid * cs, hi), c1 = min(c0 + cs, hi);
    int c = 0;
    for (int i = c0; i < c1; ++i) {
      float ad = sres[i];
      c += (ad >= 0.0f && (!gate || ad <= tau)) ? 1 : 0;
    }
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(FL_FULL, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_wcnt[wid] = incl;
    __syncthreads();
    if (tid == 0) {
      int run = 0;
      for (int q = 0; q < FL_UL_WARPS; ++q) { int v = s_wcnt[q]; s_wcnt[q] = run; run += v; }
      s_cnt = run;
    }
    cl.sync();
    if (tid == 0) {
      int off = 0;
      for (unsigned q = 0; q < rank; ++q) off += *cl.map_shared_rank(&s_cnt, q);
      s_off = off;
    }
    __syncthreads();
    int cum = s_off + s_wcnt[wid] + incl - c;   // kept points before this thread's chunk
    float acc[FL_NSTAT];
#pragma unroll
    for (int e = 0; e < FL_NSTAT; ++e) acc[e] = 0.0f;
    for (int i = c0; i < c1 && cum < win.max_num_matches; ++i) {
      float ad = sres[i];
      if (!(ad >= 0.0f && (!gate || ad <= tau))) continue;
      ++cum;
      float g[3], H[12], hn;
      float px = px_[i], py = py_[i], pz = pz_[i];
      fl_glob(pose, px, py, pz, g);
      fl_hrow(pose, ee != 0, px, py, pz, splane[i], splane[(size_t)Np + i],
              splane[(size_t)2 * Np + i], splane[(size_t)3 * Np + i], 1.0f, g, H, &hn);
      fl_stats_add(acc, H, hn);
    }

    // ---- statistics: 78 + 12 sums over the cluster into rank 0 ----
    fl_cluster_stats(acc, &sred, w.g.HTH, w.g.HTh);

    // ---- the iteration body on the prior P (rank 0) ----
    if (rank == 0) {
      __syncthreads();
      fl_iter_body(&w, inv_R, D);
      // ---- convergence, boxminus to the prior, commit (rank 0) ----
      if (tid == 0) {
        float mx = 0.0f;
        for (int i = 0; i < FL_NS; ++i) mx = fmaxf(mx, fabsf(w.dxo[i]));
        bool conv = mx <= limit;
        float t_next = s_state[2] + (conv ? 1.0f : 0.0f);
        bool done_now = (t_next > 1.0f) || (it == max_iters);
        if (v3[2] != 0.0f) s_state[1] = 0.0f;
        s_state[6] += v3[2];
        fl_state_boxminus(w.xn, w.xp, w.dx);
        for (int i = 0; i < FL_XF; ++i) w.x[i] = w.xn[i];
        s_state[2] = t_next;
        s_state[3] = (float)(it + 1);
        s_state[4] = fminf(s_state[4], w.gersh);
        s_state[5] = fminf(s_state[5], w.min_eig);
        s_state[0] = done_now ? 1.0f : 0.0f;
        for (int j = 0; j < 14; ++j) s_pub[j] = w.x[fl_pose_src(j)];
        s_pub[14] = s_state[0];
      }
      __syncthreads();
      if (s_state[0] != 0.0f)
        for (int i = tid; i < FL_NS * FL_NS; i += nt) Po[i] = w.Pf[i];
    }

    // ---- publish: every block reads rank 0's iterate and done ----
    cl.sync();
    if (tid < 15) s_pose[tid] = cl.map_shared_rank(&s_pub[0], 0)[tid];
    __syncthreads();
  }
  cl.sync();   // no block reads another's shared memory any more

  if (rank == 0) {
    for (int i = tid; i < FL_XF; i += nt) xo[i] = w.x[i];
    if (tid == 0) {
      aux[0] = s_state[3];
      aux[1] = s_state[1];
      aux[2] = s_state[4];
      aux[3] = s_state[5];
      aux[4] = s_state[6];
      aux[5] = 0.0f; aux[6] = 0.0f; aux[7] = 0.0f;
    }
  }
}

extern "C" int fl_update_loop_scratch(int Np) { return FL_SC_COLS * Np; }

extern "C" int fl_update_loop(const float* X, int Np, const float* P, const float* xprop,
                              float inv_R, float limit, float D, int k, int W, float h,
                              float max_dist_plane, float plane_threshold, float thr2,
                              int max_num_matches, float dynamic_gate, int max_iters, int ee,
                              float* scr, float* xo, float* Po, float* aux,
                              cudaStream_t stream) {
  if (W < 1 || W > FL_WMAX || k < 1 || k > W || k > FL_FIT_KMAX)
    return (int)cudaErrorInvalidValue;
  FlWindow win;
  win.k = k; win.W = W; win.max_num_matches = max_num_matches;
  win.h = h; win.max_dist_plane = max_dist_plane; win.plane_threshold = plane_threshold;
  win.thr2 = thr2; win.dynamic_gate = dynamic_gate;
  FlClusterLaunch L(FL_UL_CLUSTER, FL_UL_THREADS, stream);
  static const cudaError_t fits = fl_cluster_fits(fl_update_loop_kernel, &L.cfg);
  if (fits != cudaSuccess) return (int)fits;
  cudaError_t e = cudaLaunchKernelEx(&L.cfg, fl_update_loop_kernel, X, Np, P, xprop, inv_R,
                                     limit, D, win, max_iters, ee, scr, xo, Po, aux);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
