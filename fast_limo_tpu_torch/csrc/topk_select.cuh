// Exact block-wide selection of the k smallest (distance, column) pairs of
// one query, shared by K7 (masked_topk.cu) and K2 for k > 16 (knn_rows.cu).
//
// A non-negative float's bit pattern orders like the float, so four passes
// of an 8-bit digit histogram over the C candidate distances find the bit
// pattern T of the k-th smallest and how many copies of T belong to the
// result.  A fifth pass collects every distance below T (in any order) and
// the first copies of T in column order (a block scan), so ties go to the
// lowest column as in a stable sort.  Invalid candidates enter as +inf
// (0x7F800000) and fill the tail the same way.  Histogram updates are
// warp-aggregated (__match_any_sync), since most distances of a query share
// their exponent byte.
//
// Every thread of the block calls fl_select_k with the same arguments;
// blockDim.x is a multiple of 32, at most 1024, and 1 <= k <= min(C,
// FL_SELECT_KMAX).  bits(c) returns candidate c's distance bits and may be
// called several times for the same c.
#pragma once

#include "common.cuh"

#define FL_SELECT_KMAX 128

struct FlSelect {
  unsigned hist[256];
  unsigned u[FL_SELECT_KMAX];   // the k survivors' distance bits, unordered
  int c[FL_SELECT_KMAX];        // and their columns
  int wcnt[32];
  int digit, kk, nlt, neq;
};

template <class Bits>
FL_DEV void fl_select_k(const Bits& bits, int C, int k, FlSelect& sh) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;

  // ---- radix select of the k-th smallest bit pattern ----
  unsigned prefix = 0u, mask = 0u;
  int kk = k;                       // rank of the wanted element among those matching prefix
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += nt) sh.hist[i] = 0u;
    __syncthreads();
    for (int base = 0; base < C; base += nt) {
      int c = base + tid;
      unsigned digit = 256u;
      if (c < C) {
        unsigned u = bits(c);
        if ((u & mask) == prefix) digit = (u >> shift) & 0xFFu;
      }
      unsigned peers = __match_any_sync(0xFFFFFFFFu, digit);
      if (digit < 256u && lane == __ffs(peers) - 1) atomicAdd(&sh.hist[digit], __popc(peers));
    }
    __syncthreads();
    if (tid == 0) {
      int cum = 0, b = 0;
      for (; b < 255; ++b) {
        if (cum + (int)sh.hist[b] >= kk) break;
        cum += (int)sh.hist[b];
      }
      sh.digit = b;
      sh.kk = kk - cum;
    }
    __syncthreads();
    prefix |= (unsigned)sh.digit << shift;
    mask |= 0xFFu << shift;
    kk = sh.kk;
    __syncthreads();
  }
  const unsigned T = prefix;        // bits of the k-th smallest distance
  const int n_lt = k - kk;          // distances strictly below T; kk copies of T follow

  // ---- collect: everything below T, and the first kk copies of T by column ----
  if (tid == 0) { sh.nlt = 0; sh.neq = 0; }
  __syncthreads();
  for (int base = 0; base < C; base += nt) {
    int c = base + tid;
    unsigned u = c < C ? bits(c) : 0xFFFFFFFFu;
    bool lt = c < C && u < T, eq = c < C && u == T;
    if (lt) {
      int s = atomicAdd(&sh.nlt, 1);
      sh.u[s] = u;
      sh.c[s] = c;
    }
    unsigned bal = __ballot_sync(0xFFFFFFFFu, eq);
    if (lane == 0) sh.wcnt[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < nt / 32; ++w) {
      if (w < warp) before += sh.wcnt[w];
      total += sh.wcnt[w];
    }
    int r = sh.neq + before + __popc(bal & ((1u << lane) - 1u));
    if (eq && r < kk) {
      sh.u[n_lt + r] = u;
      sh.c[n_lt + r] = c;
    }
    __syncthreads();
    if (tid == 0) sh.neq += total;
    __syncthreads();
  }
}

// Output position of survivor j: its rank by (distance bits, column).
FL_DEV int fl_select_rank(const FlSelect& sh, int k, int j) {
  const unsigned u = sh.u[j];
  const int c = sh.c[j];
  int rank = 0;
  for (int i = 0; i < k; ++i) rank += (sh.u[i] < u) || (sh.u[i] == u && sh.c[i] < c);
  return rank;
}
