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
// coordinates, the next tile's loads issued before this tile's scan, with
// the decoder K2 shares (table_rows.cuh) — and
// compacts the valid columns into shared memory in column order (one
// block scan a tile; warp ballots order a row's slots), keeping the first
// k invalid columns for the tail.  The select then runs over the
// compacted entries in shared memory (compact_select.cuh).  A query with
// more valid columns than the shared capacity takes the multi-pass select
// over global memory inside the same launch.
#include "table_rows.cuh"

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
    return fl_d2_bits(x, y, z, qx, qy, qz);
  };
  const size_t o = (size_t)q * k;
  fl_select_compacted<false>(n, C, k, cap, qx, qy, qz, coord, gbits, bits, col, sh,
                             a.nbrs + 3 * o, a.sq + o, a.valid + o);
}

// The table entry: table_rows.cuh's block schedule (K2's block schedule
// too), sq +inf wherever the distance is not finite.
FL_DEV void fl_k7_table(const FlK7Args& a, int* dyn, FlCompact& sh) {
  const size_t q = blockIdx.x, o = q * a.k;
  fl_table_topk<false>(a.ptable, a.row_idx + q * a.V, a.nc + q * a.V * 3, a.V, a.WP, a.B, a.k,
                       a.cap, a.qs + 3 * q, dyn, sh, a.nbrs + 3 * o, a.sq + o, a.valid + o);
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
