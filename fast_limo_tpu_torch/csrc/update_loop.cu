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
// On the H100 this is latency-bound: ~10⁴ queries × ~2·10³ flops per
// iteration is microseconds of one SM, and what costs is the chain of
// dependent grid-wide reductions (gate means, prefix count, 90 sums, the
// stale count) between which the 23×23 step has to run.  So ONE block of
// 1024 threads runs everything: every grid-wide quantity is a
// deterministic block reduction (shared-memory trees, a serial scan of
// per-thread counts — never float atomics), per-point intermediates live
// in an L2-resident scratch buffer, and a finished loop exits early
// (its remaining iterations are masked no-ops).
//
// The chart difference uses atan2f, so the TPU kernel's atan series and
// its z² ≤ 0.0625 certificate are gone: `ok` covers the staleness
// certificates alone (any active iteration with a stale query → the
// caller re-runs the exact per-iteration loop).
#include "hstats.cuh"
#include "iter_body.cuh"
#include "plane_fit.cuh"

#define FL_UL_THREADS 1024
#define FL_BIG 3.0e38f
#define FL_WMAX 16

struct FlWindow {
  int k, W, max_num_matches;
  float h, max_dist_plane, plane_threshold, thr2, dynamic_gate;
};

// scratch planes (column-major, Np each): plane 4 | frozen 10 | H cols 13
#define FL_SC_PLANE 0
#define FL_SC_FROZEN 4
#define FL_SC_H 14
#define FL_SC_COLS 27

// sc: x_prop (26), inv_R, limit, D
__global__ void __launch_bounds__(FL_UL_THREADS)
fl_update_loop_kernel(const float* __restrict__ X, int Np, const float* __restrict__ P,
                      const float* __restrict__ sc, FlWindow win, int max_iters, int ee,
                      float* __restrict__ scr, float* __restrict__ xo, float* __restrict__ Po,
                      float* __restrict__ aux) {
  extern __shared__ unsigned char ushm[];
  FlIterWS* w = (FlIterWS*)ushm;
  float* red = (float*)(ushm + sizeof(FlIterWS));
  uint8_t* flag = (uint8_t*)(red + blockDim.x);
  __shared__ float s_state[8];   // done, ok, t, nit, gersh_min, min_eig, bad_total
  __shared__ float s_pose[14];

  const int tid = threadIdx.x, nt = blockDim.x;
  const float inv_R = sc[FL_XF], limit = sc[FL_XF + 1], D = sc[FL_XF + 2];
  const int W = win.W, k = win.k;
  const float h = win.h;
  for (int i = tid; i < FL_NS * FL_NS; i += nt) { w->P[i] = P[i]; Po[i] = P[i]; }
  for (int i = tid; i < FL_XF; i += nt) { w->x[i] = sc[i]; w->xp[i] = sc[i]; }
  for (int i = tid; i < FL_NS; i += nt) w->dx[i] = 0.0f;
  if (tid == 0) {
    s_state[0] = 0.0f; s_state[1] = 1.0f; s_state[2] = 0.0f; s_state[3] = 0.0f;
    s_state[4] = INFINITY; s_state[5] = INFINITY; s_state[6] = 0.0f;
  }
  __syncthreads();

  const float* px_ = X;
  const float* py_ = X + Np;
  const float* pz_ = X + 2 * Np;
  const float* pv_ = X + 3 * Np;
  const float* cn_ = X + 4 * Np;
  float* splane = scr + (size_t)FL_SC_PLANE * Np;
  float* sfroz = scr + (size_t)FL_SC_FROZEN * Np;
  float* sH = scr + (size_t)FL_SC_H * Np;

  for (int it = 0; it <= max_iters; ++it) {
    if (s_state[0] != 0.0f) break;   // finished: later iterations are no-ops
    if (tid == 0) {
      // pose scalars [rot, pos, rot_LI, t_LI] of the iterate
      for (int i = 0; i < 4; ++i) s_pose[i] = w->x[3 + i];
      for (int i = 0; i < 3; ++i) s_pose[4 + i] = w->x[i];
      for (int i = 0; i < 4; ++i) s_pose[7 + i] = w->x[7 + i];
      for (int i = 0; i < 3; ++i) s_pose[11 + i] = w->x[11 + i];
    }
    __syncthreads();
    const FlPose pose = fl_pose(s_pose);

    // ---- per-point window re-match, fit, staleness ----
    float sad = 0.0f, sgf = 0.0f, nbad = 0.0f;
    for (int i = tid; i < Np; i += nt) {
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
      flag[i] = good ? 1 : 0;
      float ad = fabsf(pl.ux * g[0] + pl.uy * g[1] + pl.uz * g[2] + pl.d);
      float gf = good ? 1.0f : 0.0f;
      sad += ad * gf;
      sgf += gf;
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
          float lo = sfroz[(size_t)(6 + a) * Np + i];
          leave = fmaxf(leave, fmaxf(lo - g[a], g[a] - (lo + 2.0f * h)));
        }
        bool cert_b = kth_d < h - fmaxf(leave, 0.0f);
        if (pvld > 0.0f && !(cert_a && (b0same || cert_b))) nbad += 1.0f;
      }
    }

    // ---- two-pass dynamic gate (robust residual mean) ----
    if (win.dynamic_gate > 0.0f) {
      float s1 = fl_block_sum(sad, red);
      float n1 = fl_block_sum(sgf, red);
      float m1 = s1 / fmaxf(n1, 1.0f);
      float s2 = 0.0f, n2 = 0.0f;
      for (int i = tid; i < Np; i += nt) {
        float g[3];
        fl_glob(pose, px_[i], py_[i], pz_[i], g);
        float ad = fabsf(splane[i] * g[0] + splane[(size_t)Np + i] * g[1] +
                         splane[(size_t)2 * Np + i] * g[2] + splane[(size_t)3 * Np + i]);
        float gf = flag[i] ? 1.0f : 0.0f;
        float trim = ad <= 3.0f * m1 + 0.05f ? gf : 0.0f;
        s2 += ad * trim;
        n2 += trim;
      }
      s2 = fl_block_sum(s2, red);
      n2 = fl_block_sum(n2, red);
      float tau = fmaxf(win.dynamic_gate * (s2 / fmaxf(n2, 1.0f)), 0.05f);
      for (int i = tid; i < Np; i += nt) {
        if (!flag[i]) continue;
        float g[3];
        fl_glob(pose, px_[i], py_[i], pz_[i], g);
        float ad = fabsf(splane[i] * g[0] + splane[(size_t)Np + i] * g[1] +
                         splane[(size_t)2 * Np + i] * g[2] + splane[(size_t)3 * Np + i]);
        if (!(ad <= tau)) flag[i] = 0;
      }
      __syncthreads();
    }

    // ---- MAX_NUM_MATCHES cap: inclusive point-order prefix count ----
    {
      const int C = (Np + nt - 1) / nt;
      const int lo = tid * C, hi = min(lo + C, Np);
      __syncthreads();   // flags were written by their strided owners
      float c = 0.0f;
      for (int i = lo; i < hi; ++i) c += flag[i] ? 1.0f : 0.0f;
      __syncthreads();
      red[tid] = c;
      __syncthreads();
      if (tid == 0) {
        float run = 0.0f;
        for (int t = 0; t < nt; ++t) { float v = red[t]; red[t] = run; run += v; }
      }
      __syncthreads();
      float cum = red[tid];
      for (int i = lo; i < hi; ++i) {
        if (!flag[i]) continue;
        cum += 1.0f;
        if (!(cum <= (float)win.max_num_matches)) flag[i] = 0;
      }
    }
    float nbad_all = fl_block_sum(nbad, red);   // syncs the cap writes too

    // ---- H rows → scratch columns; 78 + 12 sums by lane groups ----
    for (int i = tid; i < Np; i += nt) {
      float g[3], H[12], hn;
      float px = px_[i], py = py_[i], pz = pz_[i];
      fl_glob(pose, px, py, pz, g);
      fl_hrow(pose, ee != 0, px, py, pz, splane[i], splane[(size_t)Np + i],
              splane[(size_t)2 * Np + i], splane[(size_t)3 * Np + i],
              flag[i] ? 1.0f : 0.0f, g, H, &hn);
      for (int c = 0; c < 12; ++c) sH[(size_t)c * Np + i] = H[c];
      sH[(size_t)12 * Np + i] = hn;
    }
    __syncthreads();
    {
      const int gs = nt < 32 ? nt : 32, ng = nt / gs;
      const int lane = tid % gs, grp = tid / gs;
      for (int r = 0; r * ng < 90; ++r) {
        int e = grp + r * ng;
        float acc = 0.0f;
        if (e < 90) {
          int a, b;
          if (e < 78) fl_tri_pair(e, &a, &b); else { a = e - 78; b = 12; }
          const float* ca = sH + (size_t)a * Np;
          const float* cb = sH + (size_t)b * Np;
          for (int i = lane; i < Np; i += gs) acc += ca[i] * cb[i];
        }
        red[tid] = acc;
        __syncthreads();
        for (int s = gs / 2; s > 0; s >>= 1) {
          if (lane < s) red[tid] += red[tid + s];
          __syncthreads();
        }
        if (lane == 0 && e < 90) {
          float v = red[tid];
          if (e < 78) {
            int a, b;
            fl_tri_pair(e, &a, &b);
            w->g.HTH[a * FL_M + b] = v;
            w->g.HTH[b * FL_M + a] = v;
          } else {
            w->g.HTh[e - 78] = v;
          }
        }
        __syncthreads();
      }
    }

    // ---- the iteration body on the prior P ----
    fl_iter_body(w, inv_R, D);

    // ---- convergence, boxminus to the prior, masked commits ----
    if (tid == 0) {
      float mx = 0.0f;
      for (int i = 0; i < FL_NS; ++i) mx = fmaxf(mx, fabsf(w->dxo[i]));
      bool conv = mx <= limit;
      float t_next = s_state[2] + (conv ? 1.0f : 0.0f);
      bool done_now = (t_next > 1.0f) || (it == max_iters);
      if (nbad_all != 0.0f) s_state[1] = 0.0f;
      s_state[6] += nbad_all;
      fl_state_boxminus(w->xn, w->xp, w->dx);
      for (int i = 0; i < FL_XF; ++i) w->x[i] = w->xn[i];
      s_state[2] = t_next;
      s_state[3] = (float)(it + 1);
      s_state[4] = fminf(s_state[4], w->gersh);
      s_state[5] = fminf(s_state[5], w->min_eig);
      s_state[0] = done_now ? 1.0f : 0.0f;
    }
    __syncthreads();
    if (s_state[0] != 0.0f)
      for (int i = tid; i < FL_NS * FL_NS; i += nt) Po[i] = w->Pf[i];
    __syncthreads();
  }

  for (int i = tid; i < FL_XF; i += nt) xo[i] = w->x[i];
  if (tid == 0) {
    aux[0] = s_state[3];
    aux[1] = s_state[1];
    aux[2] = s_state[4];
    aux[3] = s_state[5];
    aux[4] = s_state[6];
    aux[5] = 0.0f; aux[6] = 0.0f; aux[7] = 0.0f;
  }
}

extern "C" int fl_update_loop_scratch(int Np) { return FL_SC_COLS * Np; }

extern "C" int fl_update_loop(const float* X, int Np, const float* P, const float* sc, int k,
                              int W, float h, float max_dist_plane, float plane_threshold,
                              float thr2, int max_num_matches, float dynamic_gate,
                              int max_iters, int ee, float* scr, float* xo, float* Po,
                              float* aux, cudaStream_t stream) {
  if (W < 1 || W > FL_WMAX || k < 1 || k > W || k > FL_FIT_KMAX)
    return (int)cudaErrorInvalidValue;
  FlWindow win;
  win.k = k; win.W = W; win.max_num_matches = max_num_matches;
  win.h = h; win.max_dist_plane = max_dist_plane; win.plane_threshold = plane_threshold;
  win.thr2 = thr2; win.dynamic_gate = dynamic_gate;
  size_t smem = sizeof(FlIterWS) + FL_UL_THREADS * sizeof(float) + (size_t)Np;
  cudaError_t e = cudaFuncSetAttribute(fl_update_loop_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fl_update_loop_kernel<<<1, FL_UL_THREADS, smem, stream>>>(X, Np, P, sc, win, max_iters, ee,
                                                            scr, xo, Po, aux);
  return (int)cudaGetLastError();
}
