// K2 — k nearest candidates from the map table's block rows (replaces
// fast_limo_tpu/ops/knn_rows.py:topk_from_rows_tpu, TPU body _kernel).
//
// Per query: its V rows of the planar table, read through an (N, V) row
// index (row (q, v) at ptable + row_idx[q·V + v]·WP, never gathered),
// decoded as cands_from_rows does (table_rows.cuh); the k smallest
// squared distances (dx² + dy²) + dz², ascending, ties to the lowest
// column (v-major, then slot, then entry), the invalid tail included: the
// stable sort of the masked distance row cut at k.  sq carries NaN where
// a valid column's distance is NaN, as the plain version does.
//
// On the H100 the work of a query is small (at the window resolve V = 8
// rows, 768 columns, about a fifth of them valid) and its rows sit in L2
// (the queries share them), so what bounds the kernel is the instructions
// a query issues and their latency chain — row index, meta floats,
// coordinates, select — not bytes.  Two schedules, chosen by the host from
// (V, k) alone:
//  - warp (k ≤ 32): one warp a query, FL_K2_WARPS queries a block, no
//    block barrier.  A half-warp holds a row: lane e decodes entry e once;
//    one ballot a slot places the valid columns in column order into the
//    warp's list in shared memory (capacity cap) and the first k invalid
//    columns for the tail; then one dense pass over the list reads the
//    filled slots' coordinates and computes their distance bits with
//    every lane busy (most of a pair's lane-slots are empty or outside
//    the block, so the distances are not computed in the placing).  Then
//    either k rounds of a warp min (two __reduce_min_sync a round: the
//    bits, then the lowest list index among equal bits; only the winning
//    lane rescans its entries) or a radix select over the list (8-bit
//    digits, a 256-bin histogram a warp, stopping when the chosen bin
//    holds exactly the entries still wanted), the survivors ranked by
//    (bits, list index).  Lane j writes output row j.  A query with more
//    valid columns than cap, or with a valid column at a non-finite
//    distance, takes k rounds of a warp min over all C columns decoded
//    again each round, NaN after +inf (the stable sort's order; the same
//    bits, slower), in the same launch.
//  - block (any k ≤ 128): K7's table schedule (table_rows.cuh,
//    compact_select.cuh), one block of FL_K7_NT threads a query.
//
// `active` (optional, one byte on the device): when set and 0, every block
// returns before any load and the outputs keep whatever their allocation
// held (the exact update loop discards them).
//
// The select entry (viol non-null) is the exact loop's re-match in one
// launch: with viol == 0 every block returns; with 0 < viol ≤ budget work
// item i < budget computes query idx[i] (its row indices, block
// coordinates and point read at idx[i]) into the patch outputs and the
// other items return; otherwise every query computes into the full
// outputs.  The branch not taken leaves its outputs unspecified.
#include "table_rows.cuh"

#define FL_K2_WARPS 4      // queries a block on the warp schedule
#define FL_K2_WARP_KMAX 32 // one output row a lane

enum FlK2Mode { FL_K2_BLOCK = 0, FL_K2_WARP_MIN = 1, FL_K2_WARP_RADIX = 2 };

struct FlK2Args {
  const float* ptable;      // (G, WP) planar rows
  const int* row_idx;       // (N, V) rows of each query
  const int* nc;            // (N, V, 3) block coordinates
  const float* qs;          // (N, 3) queries
  const uint8_t* active;    // () flag, or null
  const int* viol;          // () stale count, or null: one output set
  const long long* idx;     // (budget,) the patch's queries
  int N, V, WP, B, k, cap, budget;
  float* nbrs;              // (N, k, 3) the full outputs
  float* sq;                // (N, k)
  uint8_t* valid;           // (N, k)
  float* pnbrs;             // (budget, k, 3) the patch outputs
  float* psq;               // (budget, k)
  uint8_t* pvalid;          // (budget, k)
};

struct FlK2Item {
  int q;                    // the query
  size_t o;                 // its output row
  float* nbrs;
  float* sq;
  uint8_t* valid;
};

// Work item i → the query it computes and where; false when it has none.
FL_DEV bool fl_k2_item(const FlK2Args& a, int i, FlK2Item& it) {
  if (i >= a.N) return false;
  if (a.viol != nullptr) {
    const int v = *a.viol;
    if (v == 0) return false;
    if (v <= a.budget) {
      if (i >= a.budget) return false;
      it = {(int)a.idx[i], (size_t)i * a.k, a.pnbrs, a.psq, a.pvalid};
      return true;
    }
  }
  it = {i, (size_t)i * a.k, a.nbrs, a.sq, a.valid};
  return true;
}

// ---------------------------------------------------------------- warp schedule

// A query's rows decoded by its warp: the valid columns into wc (the first
// cap, column order) as packed (row v << 16 | slot-major position r), then
// their distance bits into wb, the first k invalid columns into winv
// (packed alike); returns the valid count, and in nonfinite whether a
// valid distance is +inf or NaN.  wrow[V] / wnc[3V] stage the query's row
// indices and block coordinates (one coalesced load each); each pair of
// rows has its meta floats loaded during the previous pair's placing.
// The placing (one ballot a slot) writes positions only; the distances
// follow in one dense pass over the list, every lane busy and its
// coordinate loads independent.
FL_DEV int fl_k2_warp_decode(const FlK2Args& a, const int* rq, const int* ncq, float qx,
                             float qy, float qz, int* wrow, int* wnc, unsigned* wb, int* wc,
                             int* winv, bool& nonfinite) {
  const int lane = threadIdx.x & 31, e = lane & 15, h = lane >> 4, V = a.V, B = a.B,
            EB = FL_TE * B, k = a.k, cap = a.cap;
  const unsigned half = 0xFFFFu << (lane & 16), below = (1u << lane) - 1u;
  for (int i = lane; i < V; i += 32) wrow[i] = rq[i];
  for (int i = lane; i < 3 * V; i += 32) wnc[i] = ncq[i];
  __syncwarp();
  FlMeta m{0.f, 0.f, 0.f, 0.f};
  auto load = [&](int v) {
    if (v < V) m = fl_load_meta(a.ptable + (size_t)wrow[v] * a.WP, e);
  };
  load(h);
  int nbase = 0, ibase = 0;
  for (int v0 = 0; v0 < V; v0 += 2) {
    const int v = v0 + h;
    const bool in = v < V;
    const int nv =
        fl_slots_filled(in && fl_entry_ok(m, wnc[3 * v], wnc[3 * v + 1], wnc[3 * v + 2]),
                        m.cnt, B);
    load(v + 2);   // the next pair's meta floats, in flight across this pair's placing
    // the lower row's valid count, and the pair's; a row has 16·B columns
    const int lo = __reduce_add_sync(FL_FULL, h ? 0 : nv), tv = __reduce_add_sync(FL_FULL, nv);
    const bool pair = v0 + 1 < V;
    int pv = nbase + (h ? lo : 0), pi = ibase + (h ? EB - lo : 0);
    const int key = v << 16 | e;
    fl_place_slots(
        nv, in, pair ? FL_FULL : 0xFFFFu, ibase < k, B, half, below, pv, pi,
        [&](int p, int s) {
          if (p < cap) wc[p] = key + FL_TE * s;
        },
        [&](int p, int s) {
          if (p < k) winv[p] = key + FL_TE * s;
        });
    nbase += tv;
    ibase += (pair ? 2 : 1) * EB - tv;
  }
  __syncwarp();
  const int n = nbase < cap ? nbase : cap;
  bool nf = false;
  for (int i = lane; i < n; i += 32) {
    float x, y, z;
    fl_slot_point(a.ptable + (size_t)wrow[wc[i] >> 16] * a.WP, EB, wc[i] & 0xFFFF, x, y, z);
    const unsigned u = fl_d2_bits(x, y, z, qx, qy, qz);
    nf |= u >= 0x7F800000u;
    wb[i] = u;
  }
  nonfinite = __any_sync(FL_FULL, nf);
  __syncwarp();
  return nbase;
}

// k rounds of a warp min over the list wb[0 .. n): round j's winner (the
// smallest bits, then the lowest list index, which is column order) goes
// to lane j as (list index i, bits u).  Lanes own the entries i ≡ lane
// (mod 32); a taken entry is set to ~0, above every finite distance.
FL_DEV void fl_k2_min_rounds(unsigned* wb, int n, int k, int& i_out, unsigned& u_out) {
  const int lane = threadIdx.x & 31;
  unsigned bu = ~0u;
  int bi = -1;
  auto rescan = [&]() {
    bu = ~0u;
    bi = -1;
    for (int i = lane; i < n; i += 32) {
      const unsigned u = wb[i];
      if (u < bu) {
        bu = u;
        bi = i;
      }
    }
  };
  rescan();
  const int rounds = n < k ? n : k;
  for (int j = 0; j < rounds; ++j) {
    const unsigned g = __reduce_min_sync(FL_FULL, bu);
    const unsigned gi = __reduce_min_sync(FL_FULL, bu == g ? (unsigned)bi : ~0u);
    if (lane == j) {
      i_out = (int)gi;
      u_out = g;
    }
    if ((unsigned)bi == gi) {
      wb[bi] = ~0u;
      rescan();
    }
  }
}

// Radix select of the k smallest of the list wb[0 .. n), n > k: lane j < k
// gets survivor j (list index, bits) in list order; hist[256] and surv[k]
// are the warp's scratch.
FL_DEV void fl_k2_radix(const unsigned* wb, int n, int k, unsigned* hist, int* surv, int& i_out,
                        unsigned& u_out) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned prefix = 0u, mask = 0u;
  int kk = k, cnt = n;
  for (int shift = 24;; shift -= 8) {
    for (int j = lane; j < 256; j += 32) hist[j] = 0u;
    __syncwarp();
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      unsigned dg = 256u;
      if (i < n) {
        const unsigned u = wb[i];
        if ((u & mask) == prefix) dg = (u >> shift) & 0xFFu;
      }
      const unsigned peers = __match_any_sync(FL_FULL, dg);
      if (dg < 256u && lane == __ffs(peers) - 1) atomicAdd(&hist[dg], __popc(peers));
    }
    __syncwarp();
    // lane holds bins 8·lane .. 8·lane + 7: the bin whose range covers kk
    unsigned h8[8];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      h8[j] = hist[8 * lane + j];
      sum += (int)h8[j];
    }
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(FL_FULL, inc, o);
      if (lane >= o) inc += x;
    }
    int lo = inc - sum, dig = -1, nk = 0, nc = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int hi = lo + (int)h8[j];
      if (lo < kk && kk <= hi) {
        dig = 8 * lane + j;
        nk = kk - lo;
        nc = (int)h8[j];
      }
      lo = hi;
    }
    const int src = __ffs(__ballot_sync(FL_FULL, dig >= 0)) - 1;
    dig = __shfl_sync(FL_FULL, dig, src);
    kk = __shfl_sync(FL_FULL, nk, src);
    cnt = __shfl_sync(FL_FULL, nc, src);
    prefix |= (unsigned)dig << shift;
    mask |= 0xFFu << shift;
    if (cnt == kk || shift == 0) break;
    __syncwarp();   // every lane has read hist before it is cleared
  }
  // the survivors in list order: everything at or below the chosen bin
  // when it is taken whole, else everything below the k-th value and the
  // first kk copies of it
  int ns = 0, neq = 0;
  for (int i0 = 0; i0 < n && ns < k; i0 += 32) {
    const int i = i0 + lane;
    const unsigned u = i < n ? wb[i] : ~0u;
    bool take;
    if (cnt == kk) {
      take = i < n && (u & mask) <= prefix;
    } else {
      const bool eq = i < n && u == prefix;
      const unsigned be = __ballot_sync(FL_FULL, eq);
      take = (i < n && u < prefix) || (eq && neq + __popc(be & below) < kk);
      neq += __popc(be);
    }
    const unsigned bt = __ballot_sync(FL_FULL, take);
    if (take) surv[ns + __popc(bt & below)] = i;
    ns += __popc(bt);
  }
  __syncwarp();
  if (lane < k) {
    i_out = surv[lane];
    u_out = wb[i_out];
  }
}

// The exact path of a warp: k rounds of a warp min over all C columns,
// each decoded again every round (fl_col_bits), NaN canonical after +inf:
// round j's pick is the smallest (bits, column) above round j − 1's.  Lane
// j gets the j-th (column, bits).
FL_DEV void fl_k2_all_columns(const FlK2Args& a, const int* rq, const int* ncq, float qx,
                              float qy, float qz, int& c_out, unsigned& u_out) {
  const int lane = threadIdx.x & 31, EB = FL_TE * a.B, C = a.V * EB;
  unsigned lu = 0u;
  int lc = -1;   // the last pick
  for (int j = 0; j < a.k; ++j) {
    unsigned bu = ~0u;
    int bc = -1;
    for (int c = lane; c < C; c += 32) {
      const int v = c / EB, r = c - v * EB;
      const unsigned u = fl_canon_nan(
          fl_col_bits(a.ptable + (size_t)rq[v] * a.WP, ncq + 3 * v, EB, r, qx, qy, qz));
      if ((u > lu || (u == lu && c > lc)) && u < bu) {   // a lane's columns ascend
        bu = u;
        bc = c;
      }
    }
    const unsigned g = __reduce_min_sync(FL_FULL, bu);
    const unsigned gc = __reduce_min_sync(FL_FULL, bu == g ? (unsigned)bc : ~0u);
    if (lane == j) {
      c_out = (int)gc;
      u_out = g;
    }
    lu = g;
    lc = (int)gc;
  }
}

// 32-bit words of a warp's shared memory
__host__ __device__ inline int fl_k2_warp_words(int V, int cap, bool radix) {
  return 4 * V + 2 * cap + 32 + (radix ? 288 : 0);
}

template <bool kRadix>
__global__ void __launch_bounds__(32 * FL_K2_WARPS)
fl_k2_warp_kernel(const __grid_constant__ FlK2Args a) {
  // a warp's share: wrow[V] | wnc[3V] | wb[cap] | wc[cap] | winv[32] (| hist[256] | surv[32])
  extern __shared__ unsigned wdyn[];
  if (a.active != nullptr && *a.active == 0) return;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, k = a.k;
  FlK2Item it;
  if (!fl_k2_item(a, blockIdx.x * FL_K2_WARPS + w, it)) return;
  int* wrow = reinterpret_cast<int*>(wdyn) + (size_t)w * fl_k2_warp_words(a.V, a.cap, kRadix);
  int* wnc = wrow + a.V;
  unsigned* wb = reinterpret_cast<unsigned*>(wnc + 3 * a.V);
  int* wc = reinterpret_cast<int*>(wb + a.cap);
  int* winv = wc + a.cap;
  const int* rq = a.row_idx + (size_t)it.q * a.V;
  const int* ncq = a.nc + (size_t)it.q * a.V * 3;
  const float qx = a.qs[3 * it.q], qy = a.qs[3 * it.q + 1], qz = a.qs[3 * it.q + 2];

  bool nonfinite;
  const int n = fl_k2_warp_decode(a, rq, ncq, qx, qy, qz, wrow, wnc, wb, wc, winv, nonfinite);
  const int ms = n < k ? n : k;   // valid outputs; the invalid tail follows
  int c = -1, r = lane;           // lane's column (packed: row v << 16 | r) and output row
  unsigned u = 0x7F800000u;
  if (n > a.cap || nonfinite) {
    fl_k2_all_columns(a, rq, ncq, qx, qy, qz, c, u);
    const int EB = FL_TE * a.B;
    c = (c / EB) << 16 | c % EB;
  } else {
    int i = -1;
    if (!kRadix) {
      fl_k2_min_rounds(wb, n, k, i, u);   // lane j holds the j-th smallest
    } else {
      if (n > k) {
        unsigned* hist = reinterpret_cast<unsigned*>(winv + 32);
        fl_k2_radix(wb, n, k, hist, reinterpret_cast<int*>(hist + 256), i, u);
      } else if (lane < n) {
        i = lane;
        u = wb[lane];
      }
      int rank = 0;   // by (bits, list index) among the ms survivors
      for (int t = 0; t < ms; ++t) {
        const unsigned ut = __shfl_sync(FL_FULL, u, t);
        rank += (ut < u) || (ut == u && t < lane);
      }
      if (lane < ms) r = rank;
    }
    if (lane < ms) c = wc[i];
    else if (lane < k) {
      c = winv[lane - ms];
      u = 0x7F800000u;
    }
  }
  if (lane < k) {
    float x, y, z;
    fl_slot_point(a.ptable + (size_t)wrow[c >> 16] * a.WP, FL_TE * a.B, c & 0xFFFF, x, y, z);
    const size_t o = it.o + r;
    it.sq[o] = __uint_as_float(u);
    it.valid[o] = u < 0x7F800000u ? 1 : 0;
    it.nbrs[3 * o] = x;
    it.nbrs[3 * o + 1] = y;
    it.nbrs[3 * o + 2] = z;
  }
}

// ---------------------------------------------------------------- block schedule

__global__ void __launch_bounds__(FL_K7_NT) fl_k2_block_kernel(const __grid_constant__ FlK2Args a) {
  extern __shared__ int dyn[];   // bits[cap] | col[cap] | rows[V]
  __shared__ FlCompact sh;
  if (a.active != nullptr && *a.active == 0) return;
  FlK2Item it;
  if (!fl_k2_item(a, blockIdx.x, it)) return;
  const size_t q = it.q;
  fl_table_topk<true>(a.ptable, a.row_idx + q * a.V, a.nc + q * a.V * 3, a.V, a.WP, a.B, a.k,
                      a.cap, a.qs + 3 * q, dyn, sh, it.nbrs + 3 * it.o, it.sq + it.o,
                      it.valid + it.o);
}

// ptable (G, WP) the planar table (E = 16 entries a row), row_idx (N, V) its
// row of each (query, block), nc (N, V, 3) the block coordinates; active
// may be null ("always run"); viol null for one output set (nbrs, sq,
// valid), else the select entry over idx (budget,) with the patch outputs.
// mode: FlK2Mode; cap: the compacted capacity (a warp's list, or a block's).
extern "C" int fl_knn_rows(const float* ptable, const int* row_idx, const int* nc, const float* qs,
                           const uint8_t* active, const int* viol, const long long* idx, int N,
                           int V, int WP, int E, int B, int k, int mode, int cap, int budget,
                           float* nbrs, float* sq, uint8_t* valid, float* pnbrs, float* psq,
                           uint8_t* pvalid, cudaStream_t stream) {
  const long long C = (long long)V * E * B;
  if (E != FL_TE || B < 1 || WP != 4 * E + 3 * E * B || C > 0x7FFFFFFF || k < 1 ||
      k > FL_SELECT_KMAX || k > C || cap < 1 || cap > C || N < 0)
    return (int)cudaErrorInvalidValue;
  if (viol != nullptr && (idx == nullptr || budget < 1 || budget > N))
    return (int)cudaErrorInvalidValue;
  const FlK2Args a{ptable, row_idx, nc, qs, active, viol, idx, N, V, WP, B, k, cap, budget,
                   nbrs, sq, valid, pnbrs, psq, pvalid};
  const void* kern;
  size_t smem;
  int grid, threads;
  if (mode == FL_K2_WARP_MIN || mode == FL_K2_WARP_RADIX) {
    // a list entry packs (row << 16 | slot-major position)
    if (k > FL_K2_WARP_KMAX || E * B > 0xFFFF || V > 0x7FFF)
      return (int)cudaErrorInvalidValue;
    const bool radix = mode == FL_K2_WARP_RADIX;
    kern = radix ? (const void*)fl_k2_warp_kernel<true> : (const void*)fl_k2_warp_kernel<false>;
    smem = (size_t)FL_K2_WARPS * fl_k2_warp_words(V, cap, radix) * 4;
    grid = (N + FL_K2_WARPS - 1) / FL_K2_WARPS;
    threads = 32 * FL_K2_WARPS;
  } else if (mode == FL_K2_BLOCK) {
    if (cap < k) return (int)cudaErrorInvalidValue;
    kern = (const void*)fl_k2_block_kernel;
    smem = (size_t)cap * 8 + (size_t)V * 4;
    grid = N;
    threads = FL_K7_NT;
    if (smem + sizeof(FlCompact) > 227 * 1024) return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024 - (mode == FL_K2_BLOCK ? sizeof(FlCompact) : 0)) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (grid > 0) {
    void* args[] = {const_cast<FlK2Args*>(&a)};
    cudaError_t err = cudaLaunchKernel(kern, dim3(grid), dim3(threads), args, smem, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
