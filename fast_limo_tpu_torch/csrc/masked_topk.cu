// K7 — masked k nearest (replaces fast_limo_tpu/ops/knn.py:masked_topk,
// TPU body _topk_kernel): one kernel, two entries:
//   fl_masked_topk        dense per-query candidates (N, C, 3) and a byte
//                         mask (N, C);
//   fl_masked_topk_table  the map's planar rows read through an (N, V)
//                         row index, decoded in the kernel (block match,
//                         bucket counts) — radius_search's wide branch, all
//                         N queries in one launch, nothing gathered.
//
// Per query q: d[c] = (dx² + dy²) + dz² for every valid column c of its C
// columns (+inf where invalid); return the k smallest, ascending, ties to
// the lowest column — the stable sort of the masked distance row cut at
// k, invalid tail included (the first invalid columns in column order
// when fewer than k are valid).  The table entry's columns are
// cands_from_rows' order: row v, then bucket slot s, then entry e
// (c = v·E·B + s·E + e).
//
// On the H100 a query is bound by one pass over its validity and the
// coordinates of its valid columns (radius_search at 3 m: 12 000 columns,
// ~9 % valid), and by the latency of that pass: one block of FL_K7_NT =
// 256 threads serves a query.  The block streams the validity once — the
// dense entry 16 mask bytes a 16-byte load, two loads a thread in flight; the table
// entry one thread a (row, entry) reading its four meta floats and block
// coordinates, the next tile's loads issued before this tile's scan — and
// compacts the valid columns into shared memory in column order (one
// block scan a tile; warp ballots order a row's slots), keeping the first
// k invalid columns for the tail.  The select then runs over the
// compacted entries in shared memory (compact_select.cuh).  A query with
// more valid columns than the shared capacity takes the multi-pass select
// over global memory inside the same launch.
#include "compact_select.cuh"

// 4-bit mask of the nonzero bytes of w
FL_DEV unsigned fl_nonzero4(unsigned w) {
  const unsigned t = __vcmpne4(w, 0u);
  return (t & 1u) | ((t >> 7) & 2u) | ((t >> 14) & 4u) | ((t >> 21) & 8u);
}

// Phase A, dense entry: the valid columns of the mask row into col[] (the
// first cap) and the first k invalid ones into sh.inv[]; returns the valid
// count.  Thread t of a tile reads the 16-byte-aligned chunks 2t and
// 2t + 1, so the compacted order is column order.
FL_DEV int fl_compact_dense(const uint8_t* mrow, int C, int k, int cap, int* col,
                            FlCompact& sh) {
  const int tid = threadIdx.x;
  const int off = (int)(reinterpret_cast<uintptr_t>(mrow) & 15u);
  const int nchunk = (C + off + 15) >> 4;   // chunk j: columns [16j − off, 16j − off + 16)
  int nbase = 0, ibase = 0, par = 0;
  for (int j0 = 0; j0 < nchunk; j0 += 2 * FL_K7_NT, par ^= 1) {
    unsigned vm = 0u, rm = 0u;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + 2 * tid + u, c0 = 16 * j - off;
      unsigned v16 = 0u, r16 = 0u;
      if (j < nchunk) {
        if (c0 >= 0 && c0 + 16 <= C) {
          const uint4 w = *reinterpret_cast<const uint4*>(mrow + c0);
          v16 = fl_nonzero4(w.x) | fl_nonzero4(w.y) << 4 | fl_nonzero4(w.z) << 8 |
                fl_nonzero4(w.w) << 12;
          r16 = 0xFFFFu;
        } else {   // the row's ragged ends, byte by byte
          for (int b = 0; b < 16; ++b) {
            const int c = c0 + b;
            if (c >= 0 && c < C) {
              r16 |= 1u << b;
              if (mrow[c]) v16 |= 1u << b;
            }
          }
        }
      }
      vm |= v16 << (16 * u);
      rm |= r16 << (16 * u);
    }
    const unsigned im = rm & ~vm;
    int ev, ei, tv, ti;
    fl_scan2(__popc(vm), __popc(im), ev, ei, tv, ti, sh.wsum[par]);
    const int cb = 16 * (j0 + 2 * tid) - off;
    int p = nbase + ev;
    for (unsigned mm = vm; mm && p < cap; mm &= mm - 1u, ++p) col[p] = cb + __ffs(mm) - 1;
    p = ibase + ei;
    for (unsigned mm = im; mm && p < k; mm &= mm - 1u, ++p) sh.inv[p] = cb + __ffs(mm) - 1;
    nbase += tv;
    ibase += ti;
  }
  return nbase;
}

// The arguments of both entries (a launch uses one set).
struct FlK7Args {
  const float* cand;        // dense: (N, C, 3) candidates
  const uint8_t* cvalid;    //        (N, C) mask
  const float* ptable;      // table: (G, WP) planar rows
  const int* row_idx;       //        (N, V) rows
  const int* nc;            //        (N, V, 3) block coordinates
  const float* qs;          // (N, 3) queries
  int C, V, WP, B, k, cap;  // C = V·16·B for the table entry
  float* nbrs;              // (N, k, 3)
  float* sq;                // (N, k)
  uint8_t* valid;           // (N, k)
};

FL_DEV void fl_k7_dense(const FlK7Args& a, int* dyn, FlCompact& sh) {
  const int q = blockIdx.x, C = a.C, k = a.k, cap = a.cap;
  unsigned* bits = reinterpret_cast<unsigned*>(dyn);
  int* col = dyn + cap;
  const float* pts = a.cand + (size_t)q * C * 3;
  const uint8_t* vq = a.cvalid + (size_t)q * C;
  const float qx = a.qs[3 * q], qy = a.qs[3 * q + 1], qz = a.qs[3 * q + 2];

  const int n = fl_compact_dense(vq, C, k, cap, col, sh);
  auto coord = [&](int c, float& x, float& y, float& z) {
    x = pts[3 * (size_t)c];
    y = pts[3 * (size_t)c + 1];
    z = pts[3 * (size_t)c + 2];
  };
  auto gbits = [&](int c) -> unsigned {
    if (!vq[c]) return 0x7F800000u;
    float x, y, z;
    coord(c, x, y, z);
    const float dx = x - qx, dy = y - qy, dz = z - qz;
    return __float_as_uint(dx * dx + dy * dy + dz * dz);
  };
  const size_t o = (size_t)q * k;
  fl_select_compacted(n, C, k, cap, qx, qy, qz, coord, gbits, bits, col, sh, a.nbrs + 3 * o,
                      a.sq + o, a.valid + o);
}

// Phase A, table entry (E = 16): thread t of a tile takes entry e = t % 16
// of row v = tile·FL_K7_NT/16 + t/16; a half-warp holds a row.  An entry is
// kept when its stored voxel lies in the wanted block and its count is
// positive; slot s of it is valid while s < count.  rows[v] is the row
// index of (q, v), staged in shared memory; ncq the query's (V, 3) block
// coordinates.
FL_DEV int fl_compact_table(const float* __restrict__ ptable, const int* rows,
                            const int* __restrict__ ncq, int V, int WP, int B, int k, int cap,
                            int* col, FlCompact& sh) {
  const int tid = threadIdx.x, lane = tid & 31, e = tid & 15, EB = 16 * B;
  const unsigned half = 0xFFFFu << (lane & 16), below = (1u << lane) - 1u;
  float vx = 0.f, vy = 0.f, vz = 0.f, cnt = 0.f;
  int b0 = 0, b1 = 0, b2 = 0;
  auto load = [&](int v) {
    if (v < V) {
      const float* r = ptable + (size_t)rows[v] * WP;
      vx = r[e];
      vy = r[16 + e];
      vz = r[32 + e];
      cnt = r[48 + e];
      b0 = ncq[3 * v];
      b1 = ncq[3 * v + 1];
      b2 = ncq[3 * v + 2];
    }
  };
  load(tid >> 4);
  int nbase = 0, ibase = 0, par = 0;
  for (int v0 = 0; v0 < V; v0 += FL_K7_NT / 16, par ^= 1) {
    const int v = v0 + (tid >> 4);
    const bool in = v < V;
    const bool ok = in && (cnt > 0.0f) && (floorf(vx * 0.5f) == (float)b0) &&
                    (floorf(vy * 0.5f) == (float)b1) && (floorf(vz * 0.5f) == (float)b2);
    const float n_cnt = cnt;
    load(v + FL_K7_NT / 16);   // the next tile's loads, in flight across this tile's scan
    int nv = 0;
    for (int s = 0; s < B; ++s) nv += (ok && (float)s < n_cnt) ? 1 : 0;
    const int ni = in ? B - nv : 0;
    int ev, ei, tv, ti;
    fl_scan2(nv, ni, ev, ei, tv, ti, sh.wsum[par]);
    // the row's bases: the exclusive sums at its entry 0
    int pv = nbase + __shfl_sync(FL_FULL, ev, lane & 16);
    int pi = ibase + __shfl_sync(FL_FULL, ei, lane & 16);
    const int cv = v * EB + e;
    for (int s = 0; s < B; ++s) {
      const bool isv = ok && (float)s < n_cnt, isi = in && !isv;
      const unsigned bv = __ballot_sync(FL_FULL, isv) & half;
      const unsigned bi = __ballot_sync(FL_FULL, isi) & half;
      if (isv) {
        const int p = pv + __popc(bv & below);
        if (p < cap) col[p] = cv + 16 * s;
      } else if (isi) {
        const int p = pi + __popc(bi & below);
        if (p < k) sh.inv[p] = cv + 16 * s;
      }
      pv += __popc(bv);
      pi += __popc(bi);
    }
    nbase += tv;
    ibase += ti;
  }
  return nbase;
}

FL_DEV void fl_k7_table(const FlK7Args& a, int* dyn, FlCompact& sh) {
  const int q = blockIdx.x, tid = threadIdx.x, V = a.V, WP = a.WP, B = a.B, k = a.k,
            cap = a.cap, EB = 16 * B, C = a.C;
  const float* ptable = a.ptable;
  unsigned* bits = reinterpret_cast<unsigned*>(dyn);
  int* col = dyn + cap;
  int* rows = dyn + 2 * cap;
  const int* ncq = a.nc + (size_t)q * V * 3;
  const float qx = a.qs[3 * q], qy = a.qs[3 * q + 1], qz = a.qs[3 * q + 2];
  for (int v = tid; v < V; v += FL_K7_NT) rows[v] = a.row_idx[(size_t)q * V + v];
  __syncthreads();

  const int n = fl_compact_table(ptable, rows, ncq, V, WP, B, k, cap, col, sh);
  // column c → (row v, slot s, entry e); the slot's point, whatever its mask
  auto slot = [&](int c) {
    const int v = c / EB, r = c - v * EB;
    return ptable + (size_t)rows[v] * WP + 64 + r;   // 4E + s·E + e, E = 16
  };
  auto coord = [&](int c, float& x, float& y, float& z) {
    const float* p = slot(c);
    x = p[0];
    y = p[EB];
    z = p[2 * EB];
  };
  auto gbits = [&](int c) -> unsigned {   // K2's decode of one column
    const int v = c / EB, r = c - v * EB, s = r >> 4, e = r & 15;
    const float* base = ptable + (size_t)rows[v] * WP;
    const int* b = ncq + 3 * v;
    const float cnt = base[48 + e];
    const bool ok = (cnt > 0.0f) && (floorf(base[e] * 0.5f) == (float)b[0]) &&
                    (floorf(base[16 + e] * 0.5f) == (float)b[1]) &&
                    (floorf(base[32 + e] * 0.5f) == (float)b[2]) && ((float)s < cnt);
    if (!ok) return 0x7F800000u;
    float x, y, z;
    coord(c, x, y, z);
    const float dx = x - qx, dy = y - qy, dz = z - qz;
    return __float_as_uint(dx * dx + dy * dy + dz * dz);
  };
  const size_t o = (size_t)q * k;
  fl_select_compacted(n, C, k, cap, qx, qy, qz, coord, gbits, bits, col, sh, a.nbrs + 3 * o,
                      a.sq + o, a.valid + o);
}

// One kernel for both entries: the table entry when a.ptable is set.
__global__ void __launch_bounds__(FL_K7_NT)
fl_masked_topk_kernel(const __grid_constant__ FlK7Args a) {
  extern __shared__ int dyn[];   // bits[cap] | col[cap] (| rows[V], table entry)
  __shared__ FlCompact sh;
  if (a.ptable != nullptr) fl_k7_table(a, dyn, sh);
  else fl_k7_dense(a, dyn, sh);
}

// One block a query, `cap` compacted entries in dynamic shared memory (8
// bytes each, + 4 a row for the table entry's row indices).
static int fl_k7_launch(const FlK7Args& a, int N, cudaStream_t stream) {
  if (a.k < 1 || a.k > FL_SELECT_KMAX || a.k > a.C || N < 0 || a.cap < a.k || a.cap > a.C)
    return (int)cudaErrorInvalidValue;
  const void* kern = (const void*)fl_masked_topk_kernel;
  const size_t smem = (size_t)a.cap * 8 + (a.ptable != nullptr ? (size_t)a.V * 4 : 0);
  if (smem + sizeof(FlCompact) > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024 - sizeof(FlCompact)) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (N > 0) {
    void* args[] = {const_cast<FlK7Args*>(&a)};
    cudaError_t err = cudaLaunchKernel(kern, dim3(N), dim3(FL_K7_NT), args, smem, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" int fl_masked_topk(const float* cand, const uint8_t* cvalid, const float* qs, int N,
                              int C, int k, int cap, float* nbrs, float* sq, uint8_t* valid,
                              cudaStream_t stream) {
  const FlK7Args a{cand, cvalid, nullptr, nullptr, nullptr, qs, C, 0, 0, 0, k, cap,
                   nbrs, sq, valid};
  return fl_k7_launch(a, N, stream);
}

// ptable (G, WP) the planar table, row_idx (N, V) its row of each (query,
// block), nc (N, V, 3) the block coordinates; E = 16 entries a row.
extern "C" int fl_masked_topk_table(const float* ptable, const int* row_idx, const int* nc,
                                    const float* qs, int N, int V, int WP, int E, int B, int k,
                                    int cap, float* nbrs, float* sq, uint8_t* valid,
                                    cudaStream_t stream) {
  const long long C = (long long)V * E * B;
  if (ptable == nullptr || E != 16 || B < 1 || WP != 4 * E + 3 * E * B || C > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const FlK7Args a{nullptr, nullptr, ptable, row_idx, nc, qs, (int)C, V, WP, B, k, cap,
                   nbrs, sq, valid};
  return fl_k7_launch(a, N, stream);
}
