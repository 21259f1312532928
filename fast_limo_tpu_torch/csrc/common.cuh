// Shared device helpers for the Hopper kernels of fast_limo_tpu_torch.
//
// Small-manifold math (quaternions, SO3/S2 charts, MTK semantics) as
// scalar device functions, transcribed from fast_limo_tpu/ops/so3.py,
// ops/s2.py and ops/update_body.py, plus block-parallel products,
// deterministic cluster reductions, the launch of one thread-block cluster
// and the cooperative launch of one block a streaming multiprocessor.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false.
// No fast-math: voxel/band keys use floorf(g / h) with IEEE division and
// must equal the plain versions bit for bit; --fmad=false keeps a*b+c
// rounded like the CPU reference so distances and keys compare exactly.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#define FL_TOL 1e-5f
#define FL_S2_LEN ((float)(98090.0 / 10000.0))
#define FL_S2_LEN2 ((float)((98090.0 / 10000.0) * (98090.0 / 10000.0)))
#define FL_NS 23   // error-state dims
#define FL_M 12    // observed dims
#define FL_XF 26   // flat state values: pos3 rot4 rotLI4 tLI3 vel3 bg3 ba3 grav3

#define FL_DEV __device__ __forceinline__
#define FL_FULL 0xffffffffu   // every lane of a warp

namespace cg = cooperative_groups;

// ---------------------------------------------------------------- quats
FL_DEV void fl_qmul(const float* q, const float* p, float* o) {
  float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  float pw = p[0], px = p[1], py = p[2], pz = p[3];
  o[0] = qw * pw - qx * px - qy * py - qz * pz;
  o[1] = qw * px + qx * pw + qy * pz - qz * py;
  o[2] = qw * py - qx * pz + qy * pw + qz * px;
  o[3] = qw * pz + qx * py - qy * px + qz * pw;
}

// rotation matrix (row-major) of quaternion (w,a,b,c) — hstats.rot_mat
FL_DEV void fl_rotm(float w, float a, float b, float c, float* R) {
  R[0] = 1 - 2 * (b * b + c * c); R[1] = 2 * (a * b - w * c); R[2] = 2 * (a * c + w * b);
  R[3] = 2 * (a * b + w * c); R[4] = 1 - 2 * (a * a + c * c); R[5] = 2 * (b * c - w * a);
  R[6] = 2 * (a * c - w * b); R[7] = 2 * (b * c + w * a); R[8] = 1 - 2 * (a * a + b * b);
}

// MTK::cos_sinc_sqrt (mtkmath.hpp:143-174)
FL_DEV void fl_cos_sinc_sqrt(float x2, float* c, float* s) {
  const float bound = sqrtf(sqrtf(FLT_EPSILON));
  float x2s = fmaxf(x2, 0.0f);
  if (x2s >= bound) {
    float x = sqrtf(x2s);
    *c = cosf(x);
    *s = sinf(x) / x;
    return;
  }
  const float inv[6] = {1 / 3.0f, 1 / 4.0f, 1 / 5.0f, 1 / 6.0f, 1 / 7.0f, 1 / 8.0f};
  float cosi = 1.0f, sinc = 1.0f, term = -0.5f * x2s;
  for (int i = 0; i < 3; ++i) {
    cosi = cosi + term;
    term = term * inv[2 * i];
    sinc = sinc + term;
    term = term * (-inv[2 * i + 1]) * x2s;
  }
  *c = cosi;
  *s = sinc;
}

// so3.exp_quat with scale (default 0.5)
FL_DEV void fl_exp_quat(const float* v, float scale, float* q) {
  float n2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  float c, s;
  fl_cos_sinc_sqrt(scale * scale * n2, &c, &s);
  float f = s * scale;
  q[0] = c; q[1] = f * v[0]; q[2] = f * v[1]; q[3] = f * v[2];
}

// so3.log_quat with the true atan2 (the TPU kernel's atan series and its
// z² ≤ 0.0625 certificate existed only because Mosaic lacks atan2)
FL_DEV void fl_log_quat(const float* q, float* out) {
  float w = q[0];
  float n = sqrtf(q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  if (n <= FL_TOL) {
    float sw = fabsf(w) > 1e-30f ? w : 1.0f;
    out[0] = 2.0f * q[1] / sw; out[1] = 2.0f * q[2] / sw; out[2] = 2.0f * q[3] / sw;
    return;
  }
  float angle = 2.0f * atan2f(n, fabsf(w));
  float sgn = w < 0 ? -1.0f : 1.0f;
  float f = sgn * angle / fmaxf(n, 1e-30f);
  out[0] = f * q[1]; out[1] = f * q[2]; out[2] = f * q[3];
}

FL_DEV void fl_hat(const float* v, float* K) {
  K[0] = 0; K[1] = -v[2]; K[2] = v[1];
  K[3] = v[2]; K[4] = 0; K[5] = -v[0];
  K[6] = -v[1]; K[7] = v[0]; K[8] = 0;
}

// (n×m)·(m×p) small row-major product, k-ascending sums
FL_DEV void fl_mm(const float* A, const float* B, float* C, int n, int m, int p) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < p; ++j) {
      float acc = 0.0f;
      for (int k = 0; k < m; ++k) acc += A[i * m + k] * B[k * p + j];
      C[i * p + j] = acc;
    }
}

// MTK::A_matrix (mtkmath.hpp:236-247); identity for |v| < tol
FL_DEV void fl_A_matrix(const float* v, float* A) {
  float n2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  float n = sqrtf(n2);
  for (int i = 0; i < 9; ++i) A[i] = (i % 4 == 0) ? 1.0f : 0.0f;
  if (n < FL_TOL) return;
  float safe_n2 = n2 > FL_TOL * FL_TOL ? n2 : 1.0f;
  float K[9], K2[9];
  fl_hat(v, K);
  fl_mm(K, K, K2, 3, 3, 3);
  float c1 = (1.0f - cosf(n)) / safe_n2;
  float c2 = (1.0f - sinf(n) / (n > 0 ? n : 1.0f)) / safe_n2;
  for (int i = 0; i < 9; ++i) A[i] = A[i] + c1 * K[i] + c2 * K2[i];
}

// s2.Bx, S2_typ=1 chart (S2.hpp:215-231): (3,2) row-major
FL_DEV void fl_bx(const float* vec, float* B) {
  float x = vec[0], y = vec[1], z = vec[2];
  const float L = FL_S2_LEN;
  float denom_raw = L + x;
  if (denom_raw <= FL_TOL) {
    B[0] = 0; B[1] = 0; B[2] = 0; B[3] = -1; B[4] = 1; B[5] = 0;
    return;
  }
  float d = denom_raw;
  B[0] = -y / L; B[1] = -z / L;
  B[2] = (L - y * y / d) / L; B[3] = (-z * y / d) / L;
  B[4] = (-z * y / d) / L; B[5] = (L - z * z / d) / L;
}

// s2.Nx_yy = Bxᵀ·hat(vec)/L² : (2,3)
FL_DEV void fl_nx_yy(const float* vec, float* N) {
  float B[6], K[9];
  fl_bx(vec, B);
  fl_hat(vec, K);
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 3; ++j) {
      float acc = 0.0f;
      for (int k = 0; k < 3; ++k) acc += B[k * 2 + i] * K[k * 3 + j];
      N[i * 3 + j] = acc / FL_S2_LEN2;
    }
}

// s2.Mx (S2.hpp:266-280, integer-division exp quirk: exp_delta == I): (3,2)
FL_DEV void fl_mx(const float* vec, const float* d2, float* Mo) {
  float B[6], K[9];
  fl_bx(vec, B);
  fl_hat(vec, K);
  bool small = sqrtf(d2[0] * d2[0] + d2[1] * d2[1]) < FL_TOL;
  if (small) {
    fl_mm(K, B, Mo, 3, 3, 2);
  } else {
    float Bu[3];
    for (int i = 0; i < 3; ++i) Bu[i] = B[i * 2] * d2[0] + B[i * 2 + 1] * d2[1];
    float A[9], AT[9], KA[9];
    fl_A_matrix(Bu, A);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) AT[i * 3 + j] = A[j * 3 + i];
    fl_mm(K, AT, KA, 3, 3, 3);
    fl_mm(KA, B, Mo, 3, 3, 2);
  }
  for (int i = 0; i < 6; ++i) Mo[i] = -Mo[i];
}

// s2.boxplus: exp(Bx·delta)·vec
FL_DEV void fl_s2_boxplus(const float* vec, const float* d2, float* out) {
  float B[6], Bu[3], q[4], R[9];
  fl_bx(vec, B);
  for (int i = 0; i < 3; ++i) Bu[i] = B[i * 2] * d2[0] + B[i * 2 + 1] * d2[1];
  fl_exp_quat(Bu, 0.5f, q);
  fl_rotm(q[0], q[1], q[2], q[3], R);
  for (int i = 0; i < 3; ++i)
    out[i] = R[i * 3] * vec[0] + R[i * 3 + 1] * vec[1] + R[i * 3 + 2] * vec[2];
}

// s2.boxminus (S2.hpp:144-167) with the true atan2
FL_DEV void fl_s2_boxminus(const float* vec, const float* other, float* res) {
  float cx = vec[1] * other[2] - vec[2] * other[1];
  float cy = vec[2] * other[0] - vec[0] * other[2];
  float cz = vec[0] * other[1] - vec[1] * other[0];
  float v_sin = sqrtf(cx * cx + cy * cy + cz * cz);
  float v_cos = vec[0] * other[0] + vec[1] * other[1] + vec[2] * other[2];
  float theta = atan2f(v_sin, v_cos);
  if (v_sin < FL_TOL) {
    res[0] = fabsf(theta) > FL_TOL ? 3.1415926f : 0.0f;
    res[1] = 0.0f;
    return;
  }
  // hv = other × vec
  float hx = other[1] * vec[2] - other[2] * vec[1];
  float hy = other[2] * vec[0] - other[0] * vec[2];
  float hz = other[0] * vec[1] - other[1] * vec[0];
  float B[6];
  fl_bx(other, B);
  float f = theta / v_sin;
  res[0] = f * (B[0] * hx + B[2] * hy + B[4] * hz);
  res[1] = f * (B[1] * hx + B[3] * hy + B[5] * hz);
}

// state.boxminus on flat (XF,) states → (NS,)
FL_DEV void fl_state_boxminus(const float* x, const float* x0, float* dx) {
  for (int i = 0; i < 3; ++i) dx[i] = x[i] - x0[i];
  float c[4], r[4];
  c[0] = x0[3]; c[1] = -x0[4]; c[2] = -x0[5]; c[3] = -x0[6];
  fl_qmul(c, x + 3, r);
  fl_log_quat(r, dx + 3);
  c[0] = x0[7]; c[1] = -x0[8]; c[2] = -x0[9]; c[3] = -x0[10];
  fl_qmul(c, x + 7, r);
  fl_log_quat(r, dx + 6);
  for (int i = 0; i < 12; ++i) dx[9 + i] = x[11 + i] - x0[11 + i];
  fl_s2_boxminus(x + 23, x0 + 23, dx + 21);
}

// ------------------------------------------------------- block helpers
// A team: the block's first n threads (n a multiple of 32), which meet at
// the named barrier `bar` (bar.sync bar, n) while the other warps go on.
// FlTeam{blockDim.x, 0} is the whole block.
struct FlTeam {
  int n, bar;
};

FL_DEV void fl_bar_sync(int bar, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(n) : "memory");
}
// Counts the calling warp at barrier `bar` without waiting; its earlier
// shared-memory writes are visible to the threads that wait there.
FL_DEV void fl_bar_arrive(int bar, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(bar), "r"(n) : "memory");
}
FL_DEV void fl_sync(FlTeam t) { fl_bar_sync(t.bar, t.n); }

// Team-parallel C(n×p) = op(A)(n×m) · op(B)(m×p), row-major with leading
// dims; each output by one thread with k-ascending sums, so the bits do not
// depend on the team's size.  C must not alias.  Ends on the team's barrier.
FL_DEV void fl_blk_mm(float* C, const float* A, int lda, bool tA,
                      const float* B, int ldb, bool tB, int n, int m, int p, FlTeam team) {
  for (int o = threadIdx.x; o < n * p; o += team.n) {
    int i = o / p, j = o % p;
    float acc = 0.0f;
    for (int k = 0; k < m; ++k) {
      float a = tA ? A[k * lda + i] : A[i * lda + k];
      float b = tB ? B[j * ldb + k] : B[k * ldb + j];
      acc += a * b;
    }
    C[i * p + j] = acc;
  }
  fl_sync(team);
}

// ----------------------------------------------------- cluster reductions
// Fixed-order warp tree: lane 0 ends with the warp's sum.
FL_DEV float fl_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FL_FULL, v, off);
  return v;
}

#define FL_MAX_WARPS 32
#define FL_SUM_MAX 4     // values of one fl_cluster_sum call
#define FL_SUM_SITES 2   // call sites, each with its own slot

// One block's scratch for fl_cluster_sum.
struct FlClusterRed {
  float warp[FL_MAX_WARPS][FL_SUM_MAX];
  float slot[FL_SUM_SITES][FL_SUM_MAX];   // this block's sums, read by every rank
  float tot[FL_SUM_MAX];
};

// Sums N values of every thread of the cluster in a fixed order — a warp
// tree, the warps in order, then the blocks in rank order through
// distributed shared memory — so the result is bit-reproducible (no
// atomics) and the same on every block.  Every thread of every block calls
// it with the same N and site; on return v holds the cluster's sums.  One
// cluster barrier a call: a site's slot is rewritten only by the site's
// next call, which no block reaches before every block has passed a later
// cluster barrier (each kernel calls a site at most once between two
// other cluster barriers).
template <int N>
FL_DEV void fl_cluster_sum(float (&v)[N], FlClusterRed* r, int site) {
  static_assert(N <= FL_SUM_MAX, "fl_cluster_sum: too many values");
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, nw = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = fl_warp_sum(v[j]);
  if ((tid & 31) == 0)
#pragma unroll
    for (int j = 0; j < N; ++j) r->warp[tid >> 5][j] = v[j];
  __syncthreads();
  if (tid < N) {
    float s = 0.0f;
    for (int w = 0; w < nw; ++w) s += r->warp[w][tid];
    r->slot[site][tid] = s;
  }
  cl.sync();
  if (tid < N) {
    float s = 0.0f;
    for (unsigned q = 0; q < cl.num_blocks(); ++q) s += cl.map_shared_rank(&r->slot[site][0], q)[tid];
    r->tot[tid] = s;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = r->tot[j];
}

// ------------------------------------------------- one cluster, launched
// The launch of ONE cluster of `blocks` blocks (the grid is the cluster)
// through cudaLaunchKernelEx.  Used in place: cfg points at attr.
struct FlClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  FlClusterLaunch(int blocks, int threads, cudaStream_t stream) : cfg(), attr() {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = blocks;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// The cooperative launch of a grid of `blocks` blocks through
// cudaLaunchKernelEx, so that the kernel may meet at cg::this_grid().sync().
// Used in place: cfg points at attr.
struct FlGridLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  FlGridLaunch(int blocks, int threads, cudaStream_t stream) : cfg(), attr() {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeCooperative;
    attr.val.cooperative = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// One block a streaming multiprocessor, if the occupancy calculator says
// that every such block can be resident at once (a grid barrier needs all
// of them); else the error.  Nothing falls back.
template <typename Kernel>
inline cudaError_t fl_grid_blocks(Kernel kernel, int threads, size_t smem, int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e == cudaSuccess && (per_sm < 1 || sms < 1)) e = cudaErrorCooperativeLaunchTooLarge;
  *blocks = e == cudaSuccess ? sms : 0;
  return e;
}

// Whether one cluster of this launch fits the device: allows a non-portable
// cluster size (more than 8 blocks) first, then asks the occupancy
// calculator (cudaOccupancyMaxActiveClusters ≥ 1).  Nothing falls back.
template <typename Kernel>
inline cudaError_t fl_cluster_fits(Kernel kernel, const cudaLaunchConfig_t* cfg) {
  cudaError_t e = cudaSuccess;
  if (cfg->gridDim.x > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kernel, cfg);
  if (e == cudaSuccess && n < 1) e = cudaErrorLaunchOutOfResources;
  return e;
}
