// K7's select: the k smallest (distance, column) pairs of one query, from
// its valid columns compacted into shared memory in column order
// (masked_topk.cu, both entries; K2's block schedule through
// table_rows.cuh).
//
// A caller first streams the query's validity once (its own Phase A:
// dense byte mask or map-table rows) and, for every tile of columns,
// writes the valid columns to col[] and the first k invalid ones to
// sh.inv[] at positions from one block scan, so both lists are in column
// order.  fl_select_compacted then
//   - computes the distance bits of the compacted entries, (dx² + dy²) +
//     dz² in float32 (the library builds with --fmad=false), and the
//     histogram of their top byte in the same loop;
//   - radix-selects the k-th smallest bit pattern over the compacted
//     entries in shared memory: 8-bit digits, each histogram scanned by
//     eight warps in parallel, stopping as soon as the chosen bucket holds
//     exactly the entries still wanted;
//   - collects the k survivors (ties at the k-th value by compact order,
//     which is column order) and ranks them by (bits, column);
//   - writes them, then the first invalid columns as the +inf tail when
//     fewer than k columns are valid.
// The result is the stable sort of the masked distance row cut at k,
// invalid tail included.  A query whose valid count exceeds the compacted
// capacity, or with a valid column at a non-finite distance (whose order
// against the invalid columns' +inf is the sort's, not the compaction's),
// takes the multi-pass select over all C columns in global memory
// instead (topk_select.cuh), inside the same launch.
#pragma once

#include "topk_select.cuh"

// Threads of a query's block: a query's passes are short (about a
// thousand valid columns at radius_search's 3 m) and every warp joins
// every barrier, so more threads a query buy little.
constexpr int FL_K7_NT = 256;

struct FlCompact {
  FlSelect sel;             // the global path's state; hist, u and c serve the shared path too
  int inv[FL_SELECT_KMAX];  // the first invalid columns, in column order
  int wsum[2][2][32];       // block-scan partials: two buffers of two values
  int htot[8];              // histogram scan: warp totals
  int digit, kk, cnt, nsurv, nonfinite;
};

// Exclusive block scan of the pair (a, b) in thread order, with the block
// totals.  w alternates between consecutive calls: a call's reads finish
// before the next call's barrier, so no barrier follows them.
FL_DEV void fl_scan2(int a, int b, int& ea, int& eb, int& ta, int& tb, int (*w)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int xa = __shfl_up_sync(FL_FULL, ia, o), xb = __shfl_up_sync(FL_FULL, ib, o);
    if (lane >= o) {
      ia += xa;
      ib += xb;
    }
  }
  if (lane == 31) {
    w[0][warp] = ia;
    w[1][warp] = ib;
  }
  __syncthreads();
  int pa = 0, pb = 0;
  ta = 0;
  tb = 0;
#pragma unroll
  for (int i = 0; i < FL_K7_NT / 32; ++i) {
    const int va = w[0][i], vb = w[1][i];
    if (i < warp) {
      pa += va;
      pb += vb;
    }
    ta += va;
    tb += vb;
  }
  ea = pa + ia - a;
  eb = pb + ib - b;
}

// The bin of sh.sel.hist that holds the kk-th smallest entry: threads
// 0-255 hold one bin each, scan by warps, and the bin whose range covers
// kk writes (digit, rank inside it, its count).  Every thread calls it.
FL_DEV void fl_hist_pick(FlCompact& sh, int kk) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int h = 0, inc = 0;
  if (tid < 256) {
    h = (int)sh.sel.hist[tid];
    inc = h;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(FL_FULL, inc, o);
      if (lane >= o) inc += x;
    }
    if (lane == 31) sh.htot[warp] = inc;
  }
  __syncthreads();
  if (tid < 256) {
    int base = 0;
    for (int w = 0; w < warp; ++w) base += sh.htot[w];
    const int hi = base + inc, lo = hi - h;
    if (lo < kk && kk <= hi) {
      sh.digit = tid;
      sh.kk = kk - lo;
      sh.cnt = h;
    }
  }
  __syncthreads();
}

// a point's squared distance bits, (dx² + dy²) + dz² (no contraction:
// the library builds with --fmad=false)
FL_DEV unsigned fl_d2_bits(float x, float y, float z, float qx, float qy, float qz) {
  const float dx = x - qx, dy = y - qy, dz = z - qz;
  return __float_as_uint(dx * dx + dy * dy + dz * dz);
}

FL_DEV unsigned fl_canon_nan(unsigned u) {
  return (u & 0x7FFFFFFFu) > 0x7F800000u ? 0x7FC00000u : u;   // every NaN after +inf, equal
}

// The select and the output of one query (one block of FL_K7_NT threads).
// n: the query's valid count (from the caller's scans, the same in every
// thread); col[0 .. min(n, cap)) its valid columns and sh.inv[0 .. k) its
// first invalid columns, both in column order, written before the call;
// bits[cap] scratch.  coord(c, x, y, z) loads column c's point; gbits(c)
// is column c's distance bits with +inf (0x7F800000) where invalid, for
// the global path.  Writes k rows of nbrs (3 floats), sq and valid; sq is
// +inf wherever the selected distance is not finite (K7's plain version)
// or, with kRawSq, the distance itself, NaN where it is NaN (K2's).
template <bool kRawSq, class Coord, class GBits>
FL_DEV void fl_select_compacted(int n, int C, int k, int cap, float qx, float qy, float qz,
                                const Coord& coord, const GBits& gbits, unsigned* bits,
                                int* col, FlCompact& sh, float* nbrs, float* sq,
                                uint8_t* valid) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int m = n < cap ? n : cap;

  // ---- distance bits of the compacted entries; the top byte's histogram ----
  for (int i = tid; i < 256; i += FL_K7_NT) sh.sel.hist[i] = 0u;
  if (tid == 0) sh.nonfinite = 0;
  __syncthreads();
  for (int i0 = 0; i0 < m; i0 += FL_K7_NT) {
    const int i = i0 + tid;
    unsigned dg = 256u;
    if (i < m) {
      float x, y, z;
      coord(col[i], x, y, z);
      const unsigned u = fl_d2_bits(x, y, z, qx, qy, qz);
      bits[i] = u;
      if (u >= 0x7F800000u) sh.nonfinite = 1;
      else dg = u >> 24;
    }
    if (n > k) {
      const unsigned peers = __match_any_sync(FL_FULL, dg);
      if (dg < 256u && lane == __ffs(peers) - 1) atomicAdd(&sh.sel.hist[dg], __popc(peers));
    }
  }
  __syncthreads();

  if (n > cap || sh.nonfinite) {
    // ---- the global path: the multi-pass select over all C columns ----
    fl_select_k([&](int c) { return fl_canon_nan(gbits(c)); }, C, k, sh.sel);
    if (tid < k) {
      const unsigned u = sh.sel.u[tid];
      const int c = sh.sel.c[tid], r = fl_select_rank(sh.sel, k, tid);
      const bool fin = u < 0x7F800000u;
      float x, y, z;
      coord(c, x, y, z);
      sq[r] = (kRawSq || fin) ? __uint_as_float(u) : INFINITY;
      valid[r] = fin ? 1 : 0;
      nbrs[3 * r] = x;
      nbrs[3 * r + 1] = y;
      nbrs[3 * r + 2] = z;
    }
    return;
  }

  if (n > k) {
    // ---- radix select of the k-th smallest bit pattern over the entries ----
    unsigned prefix = 0u, mask = 0u;
    int kk = k, cnt = n;
    for (int shift = 24;; shift -= 8) {
      if (shift < 24) {   // the top byte's histogram came with the distances
        for (int i = tid; i < 256; i += FL_K7_NT) sh.sel.hist[i] = 0u;
        __syncthreads();
        for (int i0 = 0; i0 < m; i0 += FL_K7_NT) {
          const int i = i0 + tid;
          unsigned dg = 256u;
          if (i < m) {
            const unsigned u = bits[i];
            if ((u & mask) == prefix) dg = (u >> shift) & 0xFFu;
          }
          const unsigned peers = __match_any_sync(FL_FULL, dg);
          if (dg < 256u && lane == __ffs(peers) - 1) atomicAdd(&sh.sel.hist[dg], __popc(peers));
        }
        __syncthreads();
      }
      fl_hist_pick(sh, kk);
      prefix |= (unsigned)sh.digit << shift;
      mask |= 0xFFu << shift;
      kk = sh.kk;
      cnt = sh.cnt;
      if (cnt == kk || shift == 0) break;
    }

    // ---- collect the k survivors ----
    if (tid == 0) sh.nsurv = 0;
    __syncthreads();
    if (cnt == kk) {
      // the bucket is taken whole: every entry at or below it
      for (int i = tid; i < m; i += FL_K7_NT) {
        const unsigned u = bits[i];
        if ((u & mask) <= prefix) {
          const int s = atomicAdd(&sh.nsurv, 1);
          sh.sel.u[s] = u;
          sh.sel.c[s] = col[i];
        }
      }
    } else {
      // everything below the k-th value, then kk of its cnt copies: the
      // first in column order
      for (int i = tid; i < m; i += FL_K7_NT) {
        const unsigned u = bits[i];
        if (u < prefix) {
          const int s = atomicAdd(&sh.nsurv, 1);
          sh.sel.u[s] = u;
          sh.sel.c[s] = col[i];
        }
      }
      const int nlt = k - kk;
      int neq = 0, par = 0;
      for (int i0 = 0; i0 < m && neq < kk; i0 += FL_K7_NT, par ^= 1) {
        const int i = i0 + tid;
        const unsigned u = i < m ? bits[i] : 0xFFFFFFFFu;
        int e, unused, te, unused2;
        fl_scan2(u == prefix ? 1 : 0, 0, e, unused, te, unused2, sh.wsum[par]);
        if (u == prefix && neq + e < kk) {
          sh.sel.u[nlt + neq + e] = u;
          sh.sel.c[nlt + neq + e] = col[i];
        }
        neq += te;
      }
    }
    __syncthreads();
  }

  // ---- rank and write: survivors by (bits, column), then the +inf tail ----
  const unsigned* su = n > k ? sh.sel.u : bits;
  const int* sc = n > k ? sh.sel.c : col;
  const int ms = n < k ? n : k;
  if (tid < k) {
    unsigned u = 0x7F800000u;
    int r = tid, c;
    if (tid < ms) {
      u = su[tid];
      c = sc[tid];
      r = 0;
      for (int i = 0; i < ms; ++i) r += (su[i] < u) || (su[i] == u && sc[i] < c);
    } else {
      c = sh.inv[tid - ms];
    }
    float x, y, z;
    coord(c, x, y, z);
    const bool fin = tid < ms;
    sq[r] = fin ? __uint_as_float(u) : INFINITY;
    valid[r] = fin ? 1 : 0;
    nbrs[3 * r] = x;
    nbrs[3 * r + 1] = y;
    nbrs[3 * r + 2] = z;
  }
}
