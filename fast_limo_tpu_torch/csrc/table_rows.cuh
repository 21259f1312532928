// The map table's planar rows decoded one (row, entry) a lane: one decoder
// for the one function that K2 (knn_rows.cu) and K7's table entry
// (masked_topk.cu) compute on them.
//
// A row of the planar table (FL_TE = 16 entries, B bucket slots) is
//   [vx×16 | vy×16 | vz×16 | cnt×16 | x slot-major 16·B | y | z].
// Entry e of a query's row v is kept when its count is positive and its
// stored voxel lies in the wanted block (floorf(coord·0.5f) equal to the
// block coordinate on each axis); slot s of a kept entry is valid while
// (float)s < cnt.  Columns are cands_from_rows' order: row v, then slot s,
// then entry e (c = v·16·B + s·16 + e).  The masked distance is
// (dx² + dy²) + dz² in float32 (the library builds with --fmad=false),
// +inf where the column is invalid.
//
// A half-warp holds a row: lane e of it owns entry e, reads the entry's
// four meta floats once, and the row's columns are placed in column order
// by one ballot a slot (fl_place_slots); only the filled slots'
// coordinates are read, after the placing.  fl_table_topk is the block schedule of a query
// (K7's): the valid columns compacted into shared memory by block scans,
// then compact_select.cuh's select.
#pragma once

#include "compact_select.cuh"

#define FL_TE 16   // entries a table row

struct FlMeta {
  float vx, vy, vz, cnt;
};

// entry e's meta floats of a row
FL_DEV FlMeta fl_load_meta(const float* row, int e) {
  return {row[e], row[FL_TE + e], row[2 * FL_TE + e], row[3 * FL_TE + e]};
}

// the entry is kept: a positive count and its voxel in block (b0, b1, b2)
FL_DEV bool fl_entry_ok(const FlMeta& m, int b0, int b1, int b2) {
  return (m.cnt > 0.0f) && (floorf(m.vx * 0.5f) == (float)b0) &&
         (floorf(m.vy * 0.5f) == (float)b1) && (floorf(m.vz * 0.5f) == (float)b2);
}

// the stored point of slot-major position r = s·16 + e of a row (EB = 16·B)
FL_DEV void fl_slot_point(const float* row, int EB, int r, float& x, float& y, float& z) {
  const float* p = row + 4 * FL_TE + r;
  x = p[0];
  y = p[EB];
  z = p[2 * EB];
}

// One column's masked distance bits (+inf, 0x7F800000, where invalid),
// decoded alone: the global paths.  b: the row's block coordinates.
FL_DEV unsigned fl_col_bits(const float* row, const int* b, int EB, int r, float qx, float qy,
                            float qz) {
  const FlMeta m = fl_load_meta(row, r & 15);
  if (!(fl_entry_ok(m, b[0], b[1], b[2]) && (float)(r >> 4) < m.cnt)) return 0x7F800000u;
  float x, y, z;
  fl_slot_point(row, EB, r, x, y, z);
  return fl_d2_bits(x, y, z, qx, qy, qz);
}

// The filled slots of a kept entry: slot s < B is valid while (float)s <
// cnt, i.e. the first min(ceil(cnt), B) slots (0 where not ok).
FL_DEV int fl_slots_filled(bool ok, float cnt, int B) {
  return ok ? (int)fminf(ceilf(cnt), (float)B) : 0;
}

// A (row, entry) lane's B slots placed in column order, every lane of the
// warp calling: nv its filled slots, in whether its row exists, inmask the
// ballot of in; half masks the lane's half-warp (its row), below the lanes
// under it; pv / pi are the row's next valid / invalid positions (the same
// in the half-warp) and advance by the row's counts, pi only while tail
// (the warp still wants invalid columns for the +inf tail).  putv(p, s)
// places the lane's valid slot s at p, puti(p, s) its invalid slot s, each
// checking its own capacity.  One ballot a slot.
template <class PutV, class PutI>
FL_DEV void fl_place_slots(int nv, bool in, unsigned inmask, bool tail, int B, unsigned half,
                           unsigned below, int& pv, int& pi, const PutV& putv,
                           const PutI& puti) {
  for (int s = 0; s < B; ++s) {
    const bool isv = s < nv;
    const unsigned bv = __ballot_sync(FL_FULL, isv) & half;
    if (isv) putv(pv + __popc(bv & below), s);
    pv += __popc(bv);
    if (tail) {
      const unsigned bi = inmask & half & ~bv;
      if (in && !isv) puti(pi + __popc(bi & below), s);
      pi += __popc(bi);
    }
  }
}

// Phase A of the block schedule: thread t of a tile takes entry e = t % 16
// of row v = tile·FL_K7_NT/16 + t/16.  The valid columns go to col[] (the
// first cap), the first k invalid ones to sh.inv[]; returns the valid
// count.  rows[v] is the row index of (q, v), staged in shared memory; ncq
// the query's (V, 3) block coordinates.
FL_DEV int fl_compact_table(const float* __restrict__ ptable, const int* rows,
                            const int* __restrict__ ncq, int V, int WP, int B, int k, int cap,
                            int* col, FlCompact& sh) {
  const int tid = threadIdx.x, lane = tid & 31, e = tid & 15, EB = FL_TE * B;
  const unsigned half = 0xFFFFu << (lane & 16), below = (1u << lane) - 1u;
  FlMeta m{0.f, 0.f, 0.f, 0.f};
  int b0 = 0, b1 = 0, b2 = 0;
  auto load = [&](int v) {
    if (v < V) {
      m = fl_load_meta(ptable + (size_t)rows[v] * WP, e);
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
    const int nv = fl_slots_filled(in && fl_entry_ok(m, b0, b1, b2), m.cnt, B);
    load(v + FL_K7_NT / 16);   // the next tile's loads, in flight across this tile's scan
    const int ni = in ? B - nv : 0;
    int ev, ei, tv, ti;
    fl_scan2(nv, ni, ev, ei, tv, ti, sh.wsum[par]);
    // the row's bases: the exclusive sums at its entry 0
    int pv = nbase + __shfl_sync(FL_FULL, ev, lane & 16);
    int pi = ibase + __shfl_sync(FL_FULL, ei, lane & 16);
    const int c0 = v * EB + e;
    fl_place_slots(
        nv, in, __ballot_sync(FL_FULL, in), ibase < k, B, half, below, pv, pi,
        [&](int p, int s) {
          if (p < cap) col[p] = c0 + FL_TE * s;
        },
        [&](int p, int s) {
          if (p < k) sh.inv[p] = c0 + FL_TE * s;
        });
    nbase += tv;
    ibase += ti;
  }
  return nbase;
}

// The block schedule of one query (one block of FL_K7_NT threads, every
// thread calling): rowq its V row indices, ncq its (V, 3) block
// coordinates, q its point; dyn holds bits[cap] | col[cap] | rows[V].
// Writes k rows of nbrs, sq and valid (kRawSq: see fl_select_compacted).
template <bool kRawSq>
FL_DEV void fl_table_topk(const float* __restrict__ ptable, const int* __restrict__ rowq,
                          const int* __restrict__ ncq, int V, int WP, int B, int k, int cap,
                          const float* q, int* dyn, FlCompact& sh, float* nbrs, float* sq,
                          uint8_t* valid) {
  const int tid = threadIdx.x, EB = FL_TE * B, C = V * EB;
  unsigned* bits = reinterpret_cast<unsigned*>(dyn);
  int* col = dyn + cap;
  int* rows = dyn + 2 * cap;
  const float qx = q[0], qy = q[1], qz = q[2];
  for (int v = tid; v < V; v += FL_K7_NT) rows[v] = rowq[v];
  __syncthreads();

  const int n = fl_compact_table(ptable, rows, ncq, V, WP, B, k, cap, col, sh);
  auto row = [&](int c) { return ptable + (size_t)rows[c / EB] * WP; };
  auto coord = [&](int c, float& x, float& y, float& z) {
    fl_slot_point(row(c), EB, c % EB, x, y, z);
  };
  auto gbits = [&](int c) -> unsigned {
    return fl_col_bits(row(c), ncq + 3 * (c / EB), EB, c % EB, qx, qy, qz);
  };
  fl_select_compacted<kRawSq>(n, C, k, cap, qx, qy, qz, coord, gbits, bits, col, sh, nbrs, sq,
                              valid);
}
