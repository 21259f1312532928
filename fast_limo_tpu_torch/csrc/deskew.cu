// K1 — fused deskew (replaces fast_limo_tpu/ops/deskew_kernel.py:deskew_tpu,
// TPU body _kernel), frame table included.
//
// Per point: select the frame = rightmost T_k ≤ t (left clip to frame 0)
// from the K-frame table, integrate that frame forward to the point time
// (exp-quat, compose, rotate), map LiDAR → baselink → world → Xt2.
//
// The frame fields come straight from the scan step's tensors, in up to
// two sources whose rows follow each other (the carry-in state, then the
// propagated IMU window), each field with its own row stride (0 for a
// field broadcast over the rows), so nothing is concatenated before the
// launch.  Every block builds the table [T, pos3, rot4, vel3, a0_world3,
// w_eff3] in shared memory: T the running max of the valid frame times
// (+inf from an invalid frame on, NaN propagating as torch.cummax does: a
// block scan over warps), a0_world = rotate(rot, a − ba) + grav, w_eff =
// w − bg; and thread 0 builds the two constant rotations (q_ext, and the
// conjugate of x_last.rot).  The TPU kernel's K×17 masked accumulation and
// its finite time sentinel were Mosaic workarounds (no gathers, 0·inf =
// NaN) and are not carried over: invalid frames carry +inf time here and
// are never selected.
//
// On the H100 this is bound by memory traffic: 32768 points read 5 floats
// and write 6 (~1.4 MB per scan) against ~200 flops each, so the time is
// the launch, the table build (one round trip for K ≈ 33 rows) and one
// pass over the points.  One thread a point; a block stages its points'
// AoS coordinates and both outputs through shared memory, so every global
// load and store is coalesced.
#include "common.cuh"

#define FL_FW 17   // frame row: [T, pos3, rot4, vel3, a0_world3, w_eff3]
#define FL_NF 9    // frame fields: time, pos, rot, vel, bg, ba, grav, w, a
#define FL_DESKEW_THREADS 256

struct FlFrameSrc {
  const float* f[FL_NF];   // row r of field i at f[i] + r·stride[i]
  int stride[FL_NF];       // row strides in floats (0: one row for all)
  const uint8_t* valid;    // row r's flag at valid[r·vstride]
  int vstride, rows;
};

struct FlDeskewArgs {
  FlFrameSrc src[2];       // rows of src[0], then rows of src[1]
  int nsrc;
  const float* pts;        // (N, 3)
  const float* t;          // (N,)
  const uint8_t* valid;    // (N,)
  int N;
  const float* q_ext;      // (4,) baselink←lidar
  const float* t_ext;      // (3,)
  const float* xl_rot;     // (4,) x_last.rot
  const float* xl_pos;     // (3,) x_last.pos
  float* out_xt2;          // (N, 3)
  float* out_w;            // (N, 3)
};

// max that keeps a NaN, as torch.cummax does (associative)
FL_DEV float fl_nmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__global__ void __launch_bounds__(FL_DESKEW_THREADS)
fl_deskew_kernel(const __grid_constant__ FlDeskewArgs a) {
  extern __shared__ float fsm[];                  // K rows of FL_FW floats
  __shared__ float xin[FL_DESKEW_THREADS * 3];   // the block's points, then its Xt2 outputs
  __shared__ float wout[FL_DESKEW_THREADS * 3];  // its world outputs
  __shared__ float cst[24];   // E (q_ext), t_ext, I (conj x_last.rot), x_last.pos
  __shared__ float wmax[FL_DESKEW_THREADS / 32 + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = a.src[0].rows, K = n0 + (a.nsrc > 1 ? a.src[1].rows : 0);

  if (tid == 0) {
    fl_rotm(a.q_ext[0], a.q_ext[1], a.q_ext[2], a.q_ext[3], cst);
    cst[9] = a.t_ext[0];
    cst[10] = a.t_ext[1];
    cst[11] = a.t_ext[2];
    fl_rotm(a.xl_rot[0], -a.xl_rot[1], -a.xl_rot[2], -a.xl_rot[3], cst + 12);
    cst[21] = a.xl_pos[0];
    cst[22] = a.xl_pos[1];
    cst[23] = a.xl_pos[2];
  }

  // ---- the frame table, FL_DESKEW_THREADS rows at a time ----
  float carry = -INFINITY;
  for (int r0 = 0; r0 < K; r0 += FL_DESKEW_THREADS) {
    const int r = r0 + tid;
    float T = -INFINITY;
    if (r < K) {
      const bool h = r < n0;
      const int lr = h ? r : r - n0;
      auto fld = [&](int i, int j) {
        const float* p = h ? a.src[0].f[i] : a.src[1].f[i];
        const int s = h ? a.src[0].stride[i] : a.src[1].stride[i];
        return p[(size_t)lr * s + j];
      };
      const uint8_t* vp = h ? a.src[0].valid : a.src[1].valid;
      const int vs = h ? a.src[0].vstride : a.src[1].vstride;
      T = vp[(size_t)lr * vs] != 0 ? fld(0, 0) : INFINITY;
      float* row = fsm + r * FL_FW;
      for (int j = 0; j < 3; ++j) row[1 + j] = fld(1, j);
      const float qw = fld(2, 0), qx = fld(2, 1), qy = fld(2, 2), qz = fld(2, 3);
      row[4] = qw;
      row[5] = qx;
      row[6] = qy;
      row[7] = qz;
      for (int j = 0; j < 3; ++j) row[8 + j] = fld(3, j);
      // a0_world = quat_rotate(rot, a − ba) + grav: v + w·t + qv × t, t = 2·(qv × v)
      const float vx = fld(8, 0) - fld(5, 0), vy = fld(8, 1) - fld(5, 1),
                  vz = fld(8, 2) - fld(5, 2);
      const float tx = 2.0f * (qy * vz - qz * vy), ty = 2.0f * (qz * vx - qx * vz),
                  tz = 2.0f * (qx * vy - qy * vx);
      row[11] = (vx + qw * tx) + (qy * tz - qz * ty) + fld(6, 0);
      row[12] = (vy + qw * ty) + (qz * tx - qx * tz) + fld(6, 1);
      row[13] = (vz + qw * tz) + (qx * ty - qy * tx) + fld(6, 2);
      for (int j = 0; j < 3; ++j) row[14 + j] = fld(7, j) - fld(4, j);
    }
    // inclusive running max of T: warps, then the warps' maxima, then the carry
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float x = __shfl_up_sync(FL_FULL, T, o);
      if (lane >= o) T = fl_nmax(x, T);
    }
    if (lane == 31) wmax[warp] = T;
    __syncthreads();
    float pre = carry;
    for (int w = 0; w < warp; ++w) pre = fl_nmax(pre, wmax[w]);
    T = fl_nmax(pre, T);
    if (r < K) fsm[r * FL_FW] = T;
    for (int w = warp; w < FL_DESKEW_THREADS / 32; ++w) pre = fl_nmax(pre, wmax[w]);
    carry = pre;   // the running max through this chunk's last row
    __syncthreads();
  }

  // ---- the block's points, staged through shared memory ----
  const int i0 = blockIdx.x * FL_DESKEW_THREADS;
  const int nb = min(FL_DESKEW_THREADS, a.N - i0);
  for (int j = tid; j < 3 * nb; j += FL_DESKEW_THREADS) xin[j] = a.pts[3 * (size_t)i0 + j];
  __syncthreads();

  if (tid < nb) {
    const int i = i0 + tid;
    const float ti = a.t[i];
    // searchsorted(T, t, side="right") - 1, clipped at 0 (T nondecreasing)
    int lo = 0, hi = K;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (fsm[mid * FL_FW] <= ti) lo = mid + 1;
      else hi = mid;
    }
    const float* f = fsm + (lo > 0 ? lo - 1 : 0) * FL_FW;

    const float dt = ti - f[0];
    const float gx = f[14] * dt, gy = f[15] * dt, gz = f[16] * dt;
    const float n2 = gx * gx + gy * gy + gz * gz;
    float c, sinc;
    fl_cos_sinc_sqrt(0.25f * n2, &c, &sinc);
    const float sw = c, sx = 0.5f * sinc * gx, sy = 0.5f * sinc * gy, sz = 0.5f * sinc * gz;
    const float qw = f[4], qx = f[5], qy = f[6], qz = f[7];
    // q = q0 ⊗ exp(ω dt)
    const float rw = qw * sw - qx * sx - qy * sy - qz * sz;
    const float rx = qw * sx + qx * sw + qy * sz - qz * sy;
    const float ry = qw * sy - qx * sz + qy * sw + qz * sx;
    const float rz = qw * sz + qx * sy - qy * sx + qz * sw;
    // p = pos + vel·dt + ½·a0·dt²
    const float h2 = 0.5f * dt * dt;
    const float pix = f[1] + f[8] * dt + f[11] * h2;
    const float piy = f[2] + f[9] * dt + f[12] * h2;
    const float piz = f[3] + f[10] * dt + f[13] * h2;

    const float* E = cst;
    const float* I = cst + 12;
    const float px = xin[3 * tid], py = xin[3 * tid + 1], pz = xin[3 * tid + 2];
    // lidar → baselink
    const float bx = E[0] * px + E[1] * py + E[2] * pz + cst[9];
    const float by = E[3] * px + E[4] * py + E[5] * pz + cst[10];
    const float bz = E[6] * px + E[7] * py + E[8] * pz + cst[11];
    // baselink → world: v' = v + 2w(q×v) + 2q×(q×v)
    const float cx1 = ry * bz - rz * by, cy1 = rz * bx - rx * bz, cz1 = rx * by - ry * bx;
    const float cx2 = ry * cz1 - rz * cy1, cy2 = rz * cx1 - rx * cz1, cz2 = rx * cy1 - ry * cx1;
    const float wxp = bx + 2.0f * (rw * cx1 + cx2) + pix;
    const float wyp = by + 2.0f * (rw * cy1 + cy2) + piy;
    const float wzp = bz + 2.0f * (rw * cz1 + cz2) + piz;
    // world → Xt2
    const float dx0 = wxp - cst[21], dy0 = wyp - cst[22], dz0 = wzp - cst[23];
    const float x2 = I[0] * dx0 + I[1] * dy0 + I[2] * dz0;
    const float y2 = I[3] * dx0 + I[4] * dy0 + I[5] * dz0;
    const float z2 = I[6] * dx0 + I[7] * dy0 + I[8] * dz0;
    const bool keep = a.valid[i] != 0;   // select, not multiply: invalid lanes may be NaN
    xin[3 * tid] = keep ? x2 : 0.0f;
    xin[3 * tid + 1] = keep ? y2 : 0.0f;
    xin[3 * tid + 2] = keep ? z2 : 0.0f;
    wout[3 * tid] = keep ? wxp : 0.0f;
    wout[3 * tid + 1] = keep ? wyp : 0.0f;
    wout[3 * tid + 2] = keep ? wzp : 0.0f;
  }
  __syncthreads();
  for (int j = tid; j < 3 * nb; j += FL_DESKEW_THREADS) {
    a.out_xt2[3 * (size_t)i0 + j] = xin[j];
    a.out_w[3 * (size_t)i0 + j] = wout[j];
  }
}

// a: the arguments in host memory, passed to the kernel by value (nothing
// is uploaded).  At most 512 frames (the table in 48 KB of shared memory
// beside the staging buffers).
extern "C" int fl_deskew(const FlDeskewArgs* a, cudaStream_t stream) {
  const int K = a->src[0].rows + (a->nsrc > 1 ? a->src[1].rows : 0);
  if (a->nsrc < 1 || a->nsrc > 2 || K < 1 || K > 512 || a->N < 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (a->N + FL_DESKEW_THREADS - 1) / FL_DESKEW_THREADS;
  if (blocks > 0)
    fl_deskew_kernel<<<blocks, FL_DESKEW_THREADS, (size_t)K * FL_FW * sizeof(float), stream>>>(*a);
  return (int)cudaGetLastError();
}
