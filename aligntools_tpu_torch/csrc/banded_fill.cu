// Banded DP fill for Hopper (sm_90a): the O(m*V) window fill of global,
// local, fit (without the jump), overlap and edit, scores and (all but edit)
// pointers: a warp per pair for windows up to 32 * WARP_STRIP_MAX lanes, a
// team of warps per pair beyond (the CTA path).
//
// Replaces ops/pallas_banded.py:_banded_kernel (entries banded_pallas_scores
// and banded_pallas_full). Query row i keeps a window of V = 2W+1 lanes,
// lane k holding column j = i - W + k: the diagonal predecessor sits in the
// same lane of row i-1, the vertical one in lane k+1, and the horizontal
// chain (U for the affine family, the linear-gap row for overlap, the
// min-plus row for edit) is a prefix scan along the window with global-
// column slope normalisation. Column-0 borders come in at the lanes where
// j == 0 or j == 1. Outputs per pair: best, edge (the band-boundary lanes'
// best) and, with pointers, the start info a/b and one byte a cell in
// (B, m_pad, V_pad): layout.py's rows-per-byte-1 codes (overlap: 0-3), every
// byte written, pad lanes k >= V unset (7, overlap 3).
//
// The Pallas kernel gathers a (B, m_pad, V_pad) slab of per-row target
// windows in device memory and takes each row's query char with a one-hot
// matrix product: Mosaic cannot slice or index lanes dynamically. Here the
// window slides along the target in registers (below) and each row's query
// char is one scalar load, prefetched a row ahead.
//
// What bounds it here: the per-row chain, as in the flat fills. Bytes (one
// pointer byte a cell) and operations (~15-20 a cell) are far from it: BK1's
// 64 x 4,096 at W = 128 has 4,096 rows in sequence a pair and 64 pairs.
//
// Warp path (V <= 32 * S, S the smallest of 5, 9 and WARP_STRIP_MAX = 16
// that holds the window, so W <= 255): one warp owns one pair, lane l
// the S window lanes [l*S, (l+1)*S), and a CTA holds up to
// WARP_MAX_THREADS / 32 pairs whose warps never wait on each other (a warp past B exits at once; the warps of one CTA run
// different row counts). The row loop has no block barrier and no shared
// memory: the vertical predecessor of a thread's last lane (row i-1's lane
// k0+S) and the left neighbour's last lane of row i (which the U
// candidate and the pU bit at lane k0 read) come by one __shfl_down_sync
// and one __shfl_up_sync; the in-row chain is a five-step warp scan with
// shuffles; the linear modes' row values at lane k0+S, known only after
// the scan, are the next row's shuffle. The target window stays in
// registers: lane k of row i reads te[i-1+k], the char lane k+1 read in
// row i-1, so each thread shifts its strip's chars by one and takes its last
// lane's new char from its right neighbour; only the top lane loads one char
// a row, a row ahead (clipped to n_ext - 1 as Pair::tchar clips). Start info
// is latched per thread (local: the strict row-major first occurrence of
// the strip's maximum; fit and overlap: row m reduced by xor shuffles; global
// and edit: the one lane j == n of row m, found by a ballot) and reduced
// once by (largest value, smallest i, smallest j). A warp's cost a row is
// about S times a cell's ~20 instructions, the scan's five dependent
// shuffles and two exchanges; with one warp a scheduler (B < 4 x 132) that
// chain is the bound, with more the schedulers' issue. Pointer codes are
// stored as 4-byte words where S is a multiple of 4 (16), else as bytes.
//
// A row whose every lane of a warp lies at a column in [2, n] (and i <= m;
// warp-uniform) runs a FAST instance of the row with no column-0 border and
// no matrix test but the pad lanes'.
//
// CTA path (wider windows, up to MAX_LANES = 65,536: W <= 32,767; also the
// narrower ones of a batch below engine/select.banded_path's threshold). A
// CTA a pair with one __syncthreads and a block-wide scan a row makes every
// warp of the pair wait for the slowest each row, and a 1,024-thread launch
// bound leaves 64 registers, too few for 16-lane strips (they spill to the
// stack). Here a pair is a team of gw warps, each
// running the warp path's row on a strip of 32 x S lanes with its row
// state (M, L, U, the target window) in registers: S the narrowest of 4, 8
// and CTA_STRIP_MAX (16) whose team fits a cluster (a row's chain grows
// with S: spreading a pair over more warps and SMs shortens it more than
// the extra hand-offs cost, at tens of pairs); at most CTA_THREADS (256)
// threads a CTA, so ptxas may give a thread 255 registers (the 16-lane
// affine instances take ~200, as the warp path's do; the 4-lane ones
// 64-80) and no instance has a stack.
// A row's data crosses a warp edge twice:
//   - left to right, the chain's carry (the U chain's cummax through the
//     warp's last lane, and that lane's M for the next warp's first U
//     candidate; overlap's and edit's row scan), produced after the scan;
//   - right to left, row i-1's first lane of the right warp (M and L; for
//     overlap and edit the lane's scan input and edit's cand2, from which
//     the left warp finishes that lane's value with the carry it sent, as
//     the right warp does), produced after pass 1.
// Each goes through a two-slot ring (by row parity) in the receiving warp's
// shared memory, guarded by an mbarrier of count 1 per slot: the sender
// stores and arrives with release, the receiver waits on the row's phase
// parity with acquire, at CTA scope unless the two warps sit in different
// CTAs (a cluster-scope release also drains the sender's global stores).
// So warps wait only on their two neighbours, each
// half a row behind its left one, and no barrier spans the CTA. Two slots
// suffice: a sender cannot lap its receiver, because it first waits for
// the message the receiver sends it after reading the older slot. Within a
// warp the scan runs before the carry arrives (lane 0's first candidate,
// which needs the left warp's M, is left out and folded in with the carry),
// so the carry's path through a row of warps is one wait, two max and one
// store a warp. Pairs needing fewer warps share a CTA (P pairs, each with
// its own barriers); a pair wider than one CTA (V past 8 x 512 = 4,096
// lanes) spans a thread-block cluster of up to CLUSTER_MAX (16, past the
// 8 that are portable: the kernels allow it, and a CTA of ~200-register
// threads fills an SM, so a GPC of 16 or more SMs holds one) CTAs, its
// messages crossing CTAs through distributed shared memory (st.shared::
// cluster and remote mbarrier arrives; a cluster barrier after the
// barriers' init and before exit). After the last row each warp reduces
// its start info by shuffles and the team merges it along the same chain,
// left to right, by the same orders; the last warp writes the pair's.
//
// Exactness: values are integer-valued f32 with true infinite borders,
// built with --fmad=false and no fast math; every pointer is an explicit
// >= in the Pallas code's argument order. Both paths compute the same
// cells with the same operations in the same order: max and min are exact,
// so a scan split across warps gives the same bits as one warp's.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "block_scan.cuh"

namespace {

constexpr int BIG = 1 << 30;
constexpr int GLOBAL = 0, LOCAL = 1, FIT = 2, OVERLAP = 3, EDIT = 4;  // ops/banded.py
constexpr float POS = INFINITY;
constexpr unsigned FULL = 0xffffffffu;
// The warp path's strips (lanes a thread; the window's V <= 32 * S), the
// widest WARP_STRIP_MAX, and the most threads (pairs x 32) its CTA runs.
constexpr int WARP_STRIP_MAX = 16;
constexpr int WARP_MAX_THREADS = 128;
// The CTA path: strips of 4, 8 or CTA_STRIP_MAX lanes a thread, at most
// CTA_WARPS warps a CTA (the instances' launch bound) and CLUSTER_MAX CTAs a
// pair.
constexpr int CTA_STRIP_MAX = 16;
constexpr int CTA_WARPS = 8;
constexpr int CTA_THREADS = 32 * CTA_WARPS;
constexpr int CLUSTER_MAX = 16;
constexpr int CLUSTER_PORTABLE = 8;
constexpr int MAX_LANES = CLUSTER_MAX * CTA_THREADS * CTA_STRIP_MAX;  // ops/banded.MAX_LANES

struct MinF {
  __device__ static float op(float a, float b) { return fminf(a, b); }
};

struct Args {
  const int* qs;       // (B, m_pad) query, pad -1
  const int* te;       // (B, n_ext) W pad columns, then the target; pad -2
  const int* ns;       // (B,) true lengths
  const int* ms;
  const float* params;  // [match, mismatch, gap_open, gap_extend, ...]
  float* best;
  float* edge;
  int* a;
  int* b;
  uint8_t* ptrs;  // (B, m_pad, v_pad)
  int m_pad, n_ext, W, v_pad, B;
};

// One pair's view: row i's target char at lane k is te[i-1+k], clipped to
// the last column as the Pallas code's window gather clips it.
struct Pair {
  const int* q;
  const int* t;
  int n, m, n_ext, W, V;
  __device__ Pair(const Args& x, int b) {
    q = x.qs + (size_t)b * x.m_pad;
    t = x.te + (size_t)b * x.n_ext;
    n = x.ns[b];
    m = x.ms[b];
    n_ext = x.n_ext;
    W = x.W;
    V = 2 * x.W + 1;
  }
  __device__ int tchar(int i, int k) const { return t[min(i - 1 + k, n_ext - 1)]; }
  __device__ bool in_mat(int i, int jcol) const { return jcol >= 1 && jcol <= n && i <= m; }
};

// Store a strip's codes: lanes < V their code, lanes in [V, v_pad) `unset`,
// as 4-byte words where S is a multiple of 4 (k0 and v_pad are then
// multiples of 4), else byte by byte.
template <int S>
__device__ __forceinline__ void store_codes(uint8_t* row, const int (&code)[S], int k0, int V,
                                            int v_pad, int unset) {
  if (S % 4 == 0) {
#pragma unroll
    for (int g = 0; g < S; g += 4) {
      const int k = k0 + g;
      if (k < v_pad) {
        uint32_t w = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) w |= (uint32_t)(k + c < V ? code[g + c] : unset) << (8 * c);
        *reinterpret_cast<uint32_t*>(row + k) = w;
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (k0 + s < v_pad) row[k0 + s] = (uint8_t)(k0 + s < V ? code[s] : unset);
  }
}

// A strip's pointer codes as they are made: an int a lane (the warp path),
// or, PACKED (a team's instances, which have 128 registers a thread), four
// to a 32-bit word, stored as store_codes stores them.
template <int S, bool PACKED>
struct Codes {
  int c[S];
  __device__ void set(int s, int v) { c[s] = v; }
  __device__ void add(int s, int bits) { c[s] |= bits; }
  __device__ void store(uint8_t* row, int k0, int V, int v_pad, int unset) const {
    store_codes<S>(row, c, k0, V, v_pad, unset);
  }
};
template <int S>
struct Codes<S, true> {
  static_assert(S % 4 == 0, "packed codes take whole words");
  uint32_t w[S / 4];
  __device__ void set(int s, int v) {
    w[s / 4] = (s % 4 ? w[s / 4] : 0u) | (uint32_t)v << (8 * (s % 4));
  }
  __device__ void add(int s, int bits) { w[s / 4] |= (uint32_t)bits << (8 * (s % 4)); }
  __device__ void store(uint8_t* row, int k0, int V, int v_pad, int unset) const {
#pragma unroll
    for (int g = 0; g < S / 4; ++g) {
      const int k = k0 + 4 * g;
      if (k < v_pad) {
        uint32_t x = w[g];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (k + c >= V) x = (x & ~(0xffu << (8 * c))) | (uint32_t)unset << (8 * c);
        *reinterpret_cast<uint32_t*>(row + k) = x;
      }
    }
  }
};

// Warp-wide reductions (every lane gets the result).
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, d));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, d));
  return v;
}
__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = min(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

// Inclusive prefix over the warp's lanes, by Op.
template <class Op>
__device__ __forceinline__ float warp_inclusive(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = Op::op(v, y);
  }
  return v;
}

// Exclusive prefix over the warp's lanes (lane 0 gets `seed`), by Op.
template <class Op>
__device__ __forceinline__ float warp_exclusive(float v, float seed) {
  const float below = __shfl_up_sync(FULL, warp_inclusive<Op>(v), 1);
  return (threadIdx.x & 31) > 0 ? below : seed;
}

// The target window in registers: tc[s] is row i's char at lane k0+s; the
// shift to row i+1 takes the right neighbour's first char, and the top
// lane `nxt`, its load of te[min(i + top + 1, n_ext - 1)] (top: the warp's
// last lane) made a row ahead.
template <int S>
__device__ __forceinline__ void slide_chars(int (&tc)[S], int& nxt, const Pair& p, int i,
                                            int top) {
  const int from_right = __shfl_down_sync(FULL, tc[0], 1);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) tc[s] = tc[s + 1];
  const bool top_lane = (threadIdx.x & 31) == 31;
  tc[S - 1] = top_lane ? nxt : from_right;
  if (top_lane) nxt = p.t[min(i + top + 1, p.n_ext - 1)];  // row i+2's char at the top lane
}

// A start-info candidate: the value, its row and its column.
struct Cand {
  float v;
  int i, j;
};

__device__ __forceinline__ bool before(const Cand& y, const Cand& c) {
  return y.v > c.v || (y.v == c.v && (y.i < c.i || (y.i == c.i && y.j < c.j)));
}

// The warp's first candidate by (largest v, smallest i, smallest j).
__device__ __forceinline__ Cand warp_best(Cand c) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const Cand y = {__shfl_xor_sync(FULL, c.v, d), __shfl_xor_sync(FULL, c.i, d),
                    __shfl_xor_sync(FULL, c.j, d)};
    if (before(y, c)) c = y;
  }
  return c;
}

// M and L of one affine cell from row i-1's diagonal (dM, dL, dU) and
// vertical (vM, vL) values, with the mode's column-0 borders, and the pM/pL
// part of its pointer byte.
template <int MODE, bool BORDER = true>
__device__ __forceinline__ void affine_cell(int i, int jcol, bool in_mat, float sub, float o,
                                            float e, float dM, float dL, float dU, float vM,
                                            float vL, float& mv, float& lv, int& code) {
  if (!BORDER) {  // no column-0 border reaches this cell
  } else if (MODE == GLOBAL) {
    const float bl = o + e * ((float)i - 1.f);  // L(i-1, 0)
    if (jcol == 1) {
      dM = i == 1 ? 0.f : NEG;
      dL = bl;
      dU = i == 1 ? o : NEG;
    }
    if (jcol == 0) {
      vM = NEG;
      vL = bl;
    }
  } else if (MODE == FIT) {
    const float bmu = i == 1 ? 0.f : NEG;  // M(i-1, 0) = U(i-1, 0)
    if (jcol == 1) {
      dM = bmu;
      dL = NEG;
      dU = bmu;
    }
    if (jcol == 0) {
      vM = bmu;
      vL = NEG;
    }
  } else {
    if (jcol == 1) dM = dL = dU = 0.f;
    if (jcol == 0) vM = vL = 0.f;
  }
  const float cl = dL + sub, cm = dM + sub, cu = dU + sub;
  const float b3 = fmaxf(fmaxf(cl, cm), cu);
  mv = in_mat ? (MODE == LOCAL ? fmaxf(b3, 0.f) : b3) : NEG;
  const float la = vL + e, lb = vM + o;
  lv = in_mat ? fmaxf(la, lb) : NEG;
  int pm = cl >= b3 ? 0 : (cm >= b3 ? 1 : 2);
  if (MODE == LOCAL && !(b3 >= 0.f)) pm = 4;  // HOME: the last argument
  if (!(mv > NEG)) pm = 7;
  code = pm | (la >= lb ? 0 : 8);
}

// The U chain's candidate at lane k (column jcol, jf the same as a float),
// from M at lane k-1.
template <int MODE, bool BORDER = true>
__device__ __forceinline__ float u_cand(float mprev, int jcol, float jf, float o, float e) {
  float c = mprev + o - e * jf;
  if (BORDER && MODE == LOCAL) {  // U(i, 0) = 0 and the M(i, 0) = 0 open
    if (jcol == 0) c = 0.f - e * jf;
    if (jcol == 1) c = fmaxf(c, 0.f + o - e * jf);
  }
  return c;
}

// Row 0 of the affine family at lane k.
template <int MODE>
__device__ __forceinline__ void affine_row0(int k, int W, int V, float o, float e, float& mv,
                                            float& lv, float& uv) {
  const int j = k - W;
  mv = lv = uv = NEG;
  if (k >= V || j < 0) return;
  if (MODE == GLOBAL) {
    mv = j == 0 ? 0.f : NEG;
    lv = j == 0 ? o : NEG;
    uv = o + e * (float)j;
  } else if (MODE == FIT) {
    mv = uv = 0.f;
  } else {
    mv = lv = uv = 0.f;
  }
}

// Row 0 of overlap (0 at j = 0, -inf past it) and edit (M(0, j) = j) at lane k.
template <bool EDIT_MODE>
__device__ __forceinline__ float linear_row0(int k, int W, int V) {
  const int j = k - W;
  const float bad = EDIT_MODE ? POS : NEG;
  return k >= V || j < 0 ? bad : (EDIT_MODE ? (float)j : (j == 0 ? 0.f : NEG));
}

// ---------------------------------------------------------------------------
// Teams: the CTA path's warps of one pair and their mbarrier-guarded slots
// ---------------------------------------------------------------------------

// A team's start info after the last row: each mode's latch, merged left to
// right along the team (Team::finish).
struct Fin {
  float v0, v1, edge;
  int i0, i1, set;
};

// One warp's incoming messages, in its CTA's shared memory: from the left
// warp the chain's carry of row r in carry[r & 1], from the right warp its
// first lane of row r in right[r & 1], and the team's start info so far in
// fin; each slot behind an mbarrier of count 1.
struct Inbox {
  float2 carry[2];
  float2 right[2];
  Fin fin;
  unsigned long long bar_carry[2], bar_right[2], bar_fin;
};

// The CTA path's launch geometry (at_banded_fill): gw warps a pair, wpc
// warps a CTA, P pairs a CTA (C == 1) or C CTAs a pair (a cluster, P == 1).
struct Geo {
  int gw, wpc, P, C;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The phase parity of row r's slot (r & 1): its ((r - 1) >> 1)-th use.
__device__ __forceinline__ uint32_t row_parity(int r) { return ((r - 1) >> 1) & 1; }

// Wait for a slot's phase; acquire at cluster scope where the sender is in
// another CTA (`remote`), else at CTA scope.
__device__ __forceinline__ void wait_slot(const unsigned long long& bar, uint32_t parity,
                                          bool remote) {
  const uint32_t a = smem_addr(&bar);
  uint32_t done;
  do {
    if (remote)
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done)
          : "r"(a), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.acquire.cta.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done)
          : "r"(a), "r"(parity)
          : "memory");
  } while (!done);
}

__device__ __forceinline__ void init_bar(unsigned long long& bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar)) : "memory");
}

// Every thread of the cluster (not .aligned: a warp may arrive diverged).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Stores into another warp's inbox (in this CTA or another of the cluster)
// and the release-arrive that publishes them.
__device__ __forceinline__ void put(uint32_t a, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(a), "f"(x), "f"(y) : "memory");
}
__device__ __forceinline__ void put(uint32_t a, int x) {
  asm volatile("st.shared::cluster.s32 [%0], %1;" ::"r"(a), "r"(x) : "memory");
}
__device__ __forceinline__ void put(uint32_t a, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(a), "f"(x) : "memory");
}
// Release at cluster scope only to another CTA: a cluster-scope release
// also waits for the thread's global stores (the row's pointer bytes).
__device__ __forceinline__ void arrive(uint32_t bar, bool remote) {
  if (remote)
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(bar)
                 : "memory");
  else
    asm volatile("mbarrier.arrive.release.cta.shared::cluster.b64 _, [%0];" ::"r"(bar)
                 : "memory");
}

// Merge the left part's start info `a` into `f` (the orders the warp path
// reduces by: the value first, then the smaller row and column).
template <int MODE>
__device__ __forceinline__ Fin merge(const Fin& a, Fin f) {
  f.edge = MODE == EDIT ? fminf(a.edge, f.edge) : fmaxf(a.edge, f.edge);
  if (MODE == GLOBAL || MODE == EDIT) {  // the one lane j == n of row m
    if (a.set && !f.set) {
      f.v0 = a.v0;
      f.i0 = a.i0;
      f.set = 1;
    }
  } else if (MODE == LOCAL) {
    if (before(Cand{a.v0, a.i0, a.i1}, Cand{f.v0, f.i0, f.i1})) {
      f.v0 = a.v0;
      f.i0 = a.i0;
      f.i1 = a.i1;
    }
  } else {  // fit (M in v0/i0, L in v1/i1) and overlap (v0/i0): row m
    if (a.v0 > f.v0 || (a.v0 == f.v0 && a.i0 < f.i0)) {
      f.v0 = a.v0;
      f.i0 = a.i0;
    }
    if (a.v1 > f.v1 || (a.v1 == f.v1 && a.i1 < f.i1)) {
      f.v1 = a.v1;
      f.i1 = a.i1;
    }
    f.set |= a.set;
  }
  return f;
}

// A warp's place in its team and its neighbours' inboxes.
struct Team {
  int b, w, gw;
  Inbox* me;
  uint32_t left, right;  // the neighbours' inboxes (shared::cluster addresses)
  bool has_left, has_right;
  bool left_remote, right_remote;  // a neighbour in another CTA of the cluster

  // Set up the CTA's barriers (every warp of the CTA, before any returns).
  __device__ Team(const Geo& g, Inbox* boxes) {
    const int wi = threadIdx.x >> 5;
    me = boxes + wi;
    if ((threadIdx.x & 31) == 0) {
      init_bar(me->bar_carry[0]);
      init_bar(me->bar_carry[1]);
      init_bar(me->bar_right[0]);
      init_bar(me->bar_right[1]);
      init_bar(me->bar_fin);
      if (g.C > 1) asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    gw = g.gw;
    int base = 0;
    if (g.C > 1) {
      cluster_sync();
      b = blockIdx.x / g.C;
      w = (int)cluster_rank() * g.wpc + wi;
    } else {
      __syncthreads();
      const int ps = wi / gw;
      b = blockIdx.x * g.P + ps;
      w = wi - ps * gw;
      base = ps * gw;
    }
    has_left = w > 0;
    has_right = w + 1 < gw;
    left_remote = g.C > 1 && w % g.wpc == 0;
    right_remote = g.C > 1 && w % g.wpc == g.wpc - 1;
    // pair warp v sits in CTA rank v / wpc (0 without a cluster), warp base + v % wpc
    auto box = [&](int v) {
      uint32_t r;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(r)
                   : "r"(smem_addr(boxes + base + v % g.wpc)), "r"(v / g.wpc));
      return r;
    };
    left = has_left ? box(w - 1) : 0;
    right = has_right ? box(w + 1) : 0;
  }

  // Send this warp's first lane of row i (lane 0) to the left warp.
  __device__ void send_left(int i, float x, float y) const {
    put(left + offsetof(Inbox, right) + 8 * (i & 1), x, y);
    arrive(left + offsetof(Inbox, bar_right) + 8 * (i & 1), left_remote);
  }
  // Send the chain's carry through this warp's last lane of row i (lane 31).
  __device__ void send_right(int i, float x, float y) const {
    put(right + offsetof(Inbox, carry) + 8 * (i & 1), x, y);
    arrive(right + offsetof(Inbox, bar_carry) + 8 * (i & 1), right_remote);
  }
  __device__ float2 recv_right(int r) const {  // the right warp's first lane of row r
    wait_slot(me->bar_right[r & 1], row_parity(r), right_remote);
    return me->right[r & 1];
  }
  __device__ float2 recv_carry(int r) const {  // the left warp's carry of row r
    wait_slot(me->bar_carry[r & 1], row_parity(r), left_remote);
    return me->carry[r & 1];
  }

  // Lane 0: merge the left part's start info into this warp's `f` and pass
  // it on; the last warp returns true with the pair's.
  template <int MODE>
  __device__ bool finish(Fin& f) const {
    if (has_left) {
      wait_slot(me->bar_fin, 0, left_remote);
      f = merge<MODE>(me->fin, f);
    }
    if (!has_right) return true;
    const uint32_t d = right + offsetof(Inbox, fin);
    put(d + offsetof(Fin, v0), f.v0, f.v1);
    put(d + offsetof(Fin, edge), f.edge);
    put(d + offsetof(Fin, i0), f.i0);
    put(d + offsetof(Fin, i1), f.i1);
    put(d + offsetof(Fin, set), f.set);
    arrive(right + offsetof(Inbox, bar_fin), right_remote);
    return false;
  }
};

// The warp path's stand-in for a team: one warp, no neighbours.
struct Solo {
  int b;
  static constexpr bool has_left = false, has_right = false;
};

// ---------------------------------------------------------------------------
// The fills: one warp's strip of 32 * S lanes of pair t.b, lane l holding
// the window lanes [k0, k0 + S); TEAM: warp t.w of a team (CTA path)
// ---------------------------------------------------------------------------

// global / local / fit
template <int MODE, bool EMIT, int S, bool TEAM, class T>
__device__ __forceinline__ void fill_affine(const Args& x, const T& t, int w) {
  const Pair p(x, t.b);
  const int lane = threadIdx.x & 31, kw = w * 32 * S, k0 = kw + lane * S, V = p.V, W = p.W;
  const int top = kw + 32 * S - 1;  // the warp's last lane
  const float match = x.params[0], mis = x.params[1], o = x.params[2], e = x.params[3];
  uint8_t* out = EMIT ? x.ptrs + (size_t)t.b * x.m_pad * x.v_pad : nullptr;
  float M[S], L[S], U[S];
  int tc[S];  // row i's chars at lanes k0 .. k0+S-1
#pragma unroll
  for (int s = 0; s < S; ++s) {
    affine_row0<MODE>(k0 + s, W, V, o, e, M[s], L[s], U[s]);
    tc[s] = p.tchar(1, k0 + s);
  }
  int nxt = p.tchar(2, top);
  float edge = NEG, g_s = NEG;
  bool g_set = false;
  int g_a = 0;
  Cand lat = {NEG, 0, 0};
  // fit's row m: M's max and first column, L's (a team's; the warp path's
  // is M's), the first column -1 until row m comes
  float fm = NEG, fl = NEG;
  int fjm = -1, fjl = 0;
  // rows past m change nothing but their pointer bytes
  const int rows = EMIT ? x.m_pad : min(p.m, x.m_pad);
  int qn = rows > 0 ? p.q[0] : 0;
  // One row; FAST (warp-uniform): every window lane of the warp lies at a
  // column in [2, n] and i <= m, so a lane is in the matrix unless it is a
  // pad lane, and no column-0 border reaches the row.
  auto row = [&](int i, int qc, auto fast) {
    constexpr bool FAST = decltype(fast)::value;
    // lane k0+S of row i-1, the right neighbour's first
    float rM = __shfl_down_sync(FULL, M[0], 1), rL = __shfl_down_sync(FULL, L[0], 1);
    if (lane == 31) {
      rM = rL = NEG;
      if constexpr (TEAM) {
        if (!t.has_right) {
        } else if (i == 1) {
          float u;
          affine_row0<MODE>(k0 + S, W, V, o, e, rM, rL, u);
        } else {
          const float2 r = t.recv_right(i - 1);
          rM = r.x;
          rL = r.y;
        }
      }
    }
    // pass 1: M, L, pM, pL. No lane branches: a pad lane (k >= V) is out
    // of the matrix, so its M, L and U stay -inf, and no lane below it reads
    // it; its codes are stored as unset.
    const int j0 = i - W + k0;  // the column of lane k0
    const float jf0 = (float)j0;
    Codes<S, TEAM> code;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = k0 + s, jcol = j0 + s;
      const bool in_mat = k < V && (FAST || p.in_mat(i, jcol));
      const float sub = tc[s] == qc ? match : mis;
      const float vM = s + 1 < S ? M[s + 1] : rM, vL = s + 1 < S ? L[s + 1] : rL;
      float mv, lv;
      int cs;
      affine_cell<MODE, !FAST>(i, jcol, in_mat, sub, o, e, M[s], L[s], U[s], vM, vL, mv, lv, cs);
      code.set(s, cs);
      M[s] = mv;
      L[s] = lv;
      if (MODE == LOCAL && mv > lat.v) lat = {mv, i, jcol};  // row-major strict >
      if (k == 0 || k == V - 1) edge = fmaxf(edge, mv);
    }
    if constexpr (TEAM)
      if (lane == 0 && t.has_left && i < rows) t.send_left(i, M[0], L[0]);
    // M at lane k0-1 of row i: the U chain's candidate and the pU bit at k0
    float nlM = __shfl_up_sync(FULL, M[S - 1], 1);
    if (lane == 0) nlM = NEG;
    // the U chain's candidates: kept for pass 2 on the warp path; a team's
    // instance (128 registers a thread) computes them again there
    float C[S];
    float run;
    if constexpr (!TEAM) {
      float red = NEG;
#pragma unroll
      for (int s = 0; s < S; ++s) {  // a pad lane's candidate reaches only pad lanes
        C[s] = u_cand<MODE, !FAST>(s == 0 ? nlM : M[s - 1], j0 + s, jf0 + (float)s, o, e);
        red = fmaxf(red, C[s]);
      }
      // pass 2: U (the running max holds the chain's cummax at lane k0-1)
      run = warp_exclusive<MaxF>(red, NEG);
    } else {
      // the warp's scan leaves out lane 0's first candidate, which needs the
      // left warp's M: it comes with the left warp's carry
      float red = NEG;
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (s > 0 || lane > 0)
          red = fmaxf(red, u_cand<MODE, !FAST>(s == 0 ? nlM : M[s - 1], j0 + s, jf0 + (float)s,
                                               o, e));
      const float incl = warp_inclusive<MaxF>(red);
      float X = NEG;  // the cummax through lane k0-1 (lane 0)
      if (lane == 0 && t.has_left) {
        const float2 c = t.recv_carry(i);
        X = c.x;
        nlM = c.y;
      }
      // through lane 0's first candidate
      const float X1 = __shfl_sync(FULL, fmaxf(X, u_cand<MODE, !FAST>(nlM, j0, jf0, o, e)), 0);
      const float below = __shfl_up_sync(FULL, incl, 1);
      run = lane == 0 ? X : fmaxf(X1, below);
      if (lane == 31 && t.has_right) t.send_right(i, fmaxf(X1, incl), M[S - 1]);
    }
    const bool has_l = (lane > 0 || t.has_left) && k0 - 1 < V;
    const bool l_in = has_l && (FAST || p.in_mat(i, j0 - 1));
    float mh = has_l ? nlM : NEG;
    float uh = l_in ? (MODE == LOCAL ? fmaxf(run, 0.f) : run) + e * (jf0 - 1.f) : NEG;
    const bool latch = i == p.m;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = k0 + s, jcol = j0 + s;
      if constexpr (TEAM)
        C[s] = u_cand<MODE, !FAST>(s == 0 ? nlM : M[s - 1], jcol, jf0 + (float)s, o, e);
      run = fmaxf(run, C[s]);
      const float uv = k < V && (FAST || p.in_mat(i, jcol))
                           ? (MODE == LOCAL ? fmaxf(run, 0.f) : run) + e * (jf0 + (float)s)
                           : NEG;
      if (EMIT) {
        const bool home = !FAST && MODE == LOCAL && jcol == 1;  // M(i, 0) = U(i, 0) = 0
        const float ua = (home ? 0.f : mh) + o, ub = (home ? 0.f : uh) + e;
        code.add(s, ua >= ub ? 0 : 16);
      }
      if (MODE == GLOBAL && latch && jcol == p.n && k < V) {
        g_s = fmaxf(fmaxf(L[s], M[s]), uv);
        g_a = (L[s] >= M[s] && L[s] >= uv) ? 0 : (M[s] >= uv ? 1 : 2);
        g_set = true;
      }
      mh = M[s];
      uh = uv;
      U[s] = uv;
    }
    if (EMIT) code.store(out + (size_t)(i - 1) * x.v_pad, k0, V, x.v_pad, 7);
    if (MODE == FIT && latch) {
      // the bottom row over columns 1..n-1; M wins ties, then the smallest j
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int k = k0 + s, jcol = i - W + k;
        if (k < V && jcol <= p.n - 1) {
          mx0 = fmaxf(mx0, M[s]);
          mx1 = fmaxf(mx1, L[s]);
        }
      }
      mx0 = warp_max(mx0);
      mx1 = warp_max(mx1);
      if constexpr (TEAM) {  // M's and L's first columns, merged by Team::finish
        int jm = BIG, jl = BIG;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int k = k0 + s, jcol = i - W + k;
          if (k < V && jcol <= p.n - 1 && p.in_mat(i, jcol)) {
            if (jm == BIG && M[s] == mx0) jm = jcol;
            if (jl == BIG && L[s] == mx1) jl = jcol;
          }
        }
        fm = mx0;
        fl = mx1;
        fjm = warp_min(jm);
        fjl = warp_min(jl);
      } else {  // the winner's first column, in fjm
        const bool use_l = mx1 > mx0;
        const float f_s = fmaxf(mx0, mx1);
        int fj = BIG;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int k = k0 + s, jcol = i - W + k;
          if (k < V && fj == BIG && jcol <= p.n - 1 && p.in_mat(i, jcol) &&
              (use_l ? L[s] : M[s]) == f_s)
            fj = jcol;
        }
        fjm = warp_min(fj);
        fm = use_l ? NEG : f_s;
        fl = use_l ? f_s : NEG;
      }
    }
  };
  for (int i = 1; i <= rows; ++i) {
    const int qc = qn;
    if (i < rows) qn = p.q[i];
    const int jlo = i - W + kw, jhi = i - W + min(top, V - 1);
    if (jlo >= 2 && jhi <= p.n && i <= p.m)
      row(i, qc, std::true_type{});
    else
      row(i, qc, std::false_type{});
    slide_chars<S>(tc, nxt, p, i, top);
  }
  Fin f;
  f.edge = warp_max(edge);
  f.v1 = NEG;
  f.i1 = 0;
  if (MODE == LOCAL) {  // the larger value, then the smaller i, then the smaller j
    lat = warp_best(lat);
    f = {lat.v, NEG, f.edge, lat.i, lat.j, 1};
  } else if (MODE == GLOBAL) {  // the one lane that held column n at row m
    const unsigned who = __ballot_sync(FULL, g_set);
    const int src = who ? __ffs(who) - 1 : 0;
    f.v0 = __shfl_sync(FULL, g_s, src);
    f.i0 = __shfl_sync(FULL, g_a, src);
    f.set = who != 0;
  } else {
    f = {fm, fl, f.edge, fjm, TEAM ? fjl : fjm, fjm >= 0};
  }
  if (lane != 0) return;
  if constexpr (TEAM)
    if (!t.template finish<MODE>(f)) return;
  const int b = t.b;
  const bool use_l = f.v1 > f.v0;  // fit: M wins ties
  x.edge[b] = f.edge;
  x.best[b] = MODE == FIT ? (f.set ? fmaxf(f.v0, f.v1) : NEG) : f.v0;
  x.a[b] = MODE == FIT ? (f.set && use_l ? 1 : 0) : f.i0;
  x.b[b] = MODE == GLOBAL ? 0 : (MODE == FIT ? (f.set ? (use_l ? f.i1 : f.i0) : 0) : f.i1);
}

// overlap (linear gap o; codes LEFT/DIAG/RIGHT = 0/1/2, 3 where -inf) and
// edit (min-plus, +inf out of band, no pointers): the row is the scan
// itself. Lane k0+S's value of row i-1 is the right neighbour's, by
// shuffle; a team's last lane finishes it from the right warp's scan input
// (and edit's cand2) and the carry it sent that row, as the right warp did.
template <bool EDIT_MODE, bool EMIT, int S, bool TEAM, class T>
__device__ __forceinline__ void fill_linear(const Args& x, const T& t, int w) {
  using Op = std::conditional_t<EDIT_MODE, MinF, MaxF>;
  const Pair p(x, t.b);
  const int lane = threadIdx.x & 31, kw = w * 32 * S, k0 = kw + lane * S, V = p.V, W = p.W;
  const int top = kw + 32 * S - 1;
  const float match = x.params[0], mis = x.params[1], o = x.params[2];
  const float bad = EDIT_MODE ? POS : NEG;
  uint8_t* out = EMIT ? x.ptrs + (size_t)t.b * x.m_pad * x.v_pad : nullptr;
  float M[S];
  int tc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    M[s] = linear_row0<EDIT_MODE>(k0 + s, W, V);
    tc[s] = p.tchar(1, k0 + s);
  }
  int nxt = p.tchar(2, top);
  float edge = bad, g_s = POS, carry = bad;  // carry: lane 31's last, sent right
  bool g_set = false;
  float om = NEG;  // overlap's row m: the max, its first column, whether it came
  int oj = BIG;
  bool oset = false;
  const int rows = EMIT ? x.m_pad : min(p.m, x.m_pad);
  int qn = rows > 0 ? p.q[0] : 0;
  // One row; FAST as in fill_affine: no column-0 border, and every lane but
  // the pad lanes in the matrix.
  auto row = [&](int i, int qc, auto fast) {
    constexpr bool FAST = decltype(fast)::value;
    const float i_f = (float)i;
    float rM = __shfl_down_sync(FULL, M[0], 1);  // lane k0+S of row i-1
    if (lane == 31) {
      rM = bad;
      if constexpr (TEAM) {
        const int kr = k0 + S, jr = i - 1 - W + kr;
        if (!t.has_right) {
        } else if (i == 1) {
          rM = linear_row0<EDIT_MODE>(kr, W, V);
        } else {
          const float2 r = t.recv_right(i - 1);  // its scan input, cand2
          if (kr < V && p.in_mat(i - 1, jr))
            rM = EDIT_MODE ? fminf(fminf(carry, r.x) + (float)jr, r.y)
                           : fmaxf(carry, r.x) + o * (float)jr;
        }
      }
    }
    // no lane branches: a pad lane (k >= V) is out of the matrix, its
    // values stay `bad`, and it is stored as unset
    const int j0 = i - W + k0;  // the column of lane k0
    const float jf0 = (float)j0;
    float CD[S], C2[S];
    int dcode[S];
    float red = bad;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int jcol = j0 + s;
      const float jf = jf0 + (float)s;
      const bool in_mat = k0 + s < V && (FAST || p.in_mat(i, jcol));
      const bool eq = tc[s] == qc;
      const float vert = s + 1 < S ? M[s + 1] : rM;
      const bool j0_ = !FAST && jcol == 0, j1_ = !FAST && jcol == 1;
      if (EDIT_MODE) {
        const float diag = j1_ ? i_f - 1.f : M[s];  // M(i-1, 0) = i-1
        float c2 = fminf(diag + (eq ? 0.f : mis), vert + 1.f);
        c2 = in_mat ? c2 : POS;
        C2[s] = c2;
        CD[s] = j0_ ? i_f : (j1_ ? fminf(c2 - jf, i_f) : c2 - jf);
        red = fminf(red, CD[s]);
      } else {
        const float dd = (j1_ ? 0.f : M[s]) + (eq ? match : mis);
        const float vv = (j0_ ? 0.f : vert) + o;
        const float cand = in_mat ? fmaxf(dd, vv) : NEG;
        CD[s] = j0_ ? 0.f : cand - o * jf;
        dcode[s] = dd >= vv ? 1 : 2;
        red = fmaxf(red, CD[s]);
      }
    }
    float excl;
    if constexpr (!TEAM) {
      excl = warp_exclusive<Op>(red, bad);
    } else {
      if (lane == 0 && t.has_left && i < rows) t.send_left(i, CD[0], EDIT_MODE ? C2[0] : 0.f);
      const float incl = warp_inclusive<Op>(red);
      float X = bad;  // the row's scan through lane k0-1 (lane 0)
      if (lane == 0 && t.has_left) X = t.recv_carry(i).x;
      X = __shfl_sync(FULL, X, 0);
      const float below = __shfl_up_sync(FULL, incl, 1);
      excl = lane == 0 ? X : Op::op(X, below);
      if (lane == 31) {
        carry = Op::op(X, incl);
        if (t.has_right) t.send_right(i, carry, 0.f);
      }
    }
    float run = excl;
    // overlap's LEFT pointer: the row's value at lane k0-1
    float lh = (lane > 0 || t.has_left) && (FAST || p.in_mat(i, j0 - 1)) ? excl + o * (jf0 - 1.f)
                                                                         : NEG;
    int code[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = k0 + s, jcol = j0 + s;
      const float jf = jf0 + (float)s;
      const bool in_mat = k < V && (FAST || p.in_mat(i, jcol));
      float rv;
      code[s] = 3;
      if (EDIT_MODE) {
        run = fminf(run, CD[s]);
        rv = in_mat ? fminf(run + jf, C2[s]) : POS;
        if (i == p.m && jcol == p.n && k < V) {
          g_s = rv;
          g_set = true;
        }
        if (k == 0 || k == V - 1) edge = fminf(edge, rv);
      } else {
        run = fmaxf(run, CD[s]);
        rv = in_mat ? run + o * jf : NEG;
        if (EMIT) {
          const float left = (!FAST && jcol == 1 ? 0.f : lh) + o;  // M(i, 0) = 0
          code[s] = left >= rv ? 0 : dcode[s];
          if (!(rv > NEG)) code[s] = 3;
        }
        lh = rv;
        if (k == 0 || k == V - 1) edge = fmaxf(edge, rv);
      }
      M[s] = rv;
    }
    if (EMIT) store_codes<S>(out + (size_t)(i - 1) * x.v_pad, code, k0, V, x.v_pad, 3);
    if (!EDIT_MODE && i == p.m) {
      // the bottom row over columns 1..n-1, with the j = 0 zero candidate
      float mx = NEG;
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (k0 + s < V && i - W + k0 + s <= p.n - 1) mx = fmaxf(mx, M[s]);
      mx = warp_max(mx);
      int fj = BIG;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int jcol = i - W + k0 + s;
        if (k0 + s < V && fj == BIG && jcol <= p.n - 1 && p.in_mat(i, jcol) && M[s] == mx)
          fj = jcol;
      }
      om = mx;
      oj = warp_min(fj);
      oset = true;
    }
  };
  for (int i = 1; i <= rows; ++i) {
    const int qc = qn;
    if (i < rows) qn = p.q[i];
    const int jlo = i - W + kw, jhi = i - W + min(top, V - 1);
    if (jlo >= 2 && jhi <= p.n && i <= p.m)
      row(i, qc, std::true_type{});
    else
      row(i, qc, std::false_type{});
    slide_chars<S>(tc, nxt, p, i, top);
  }
  Fin f = {om, NEG, EDIT_MODE ? warp_min(edge) : warp_max(edge), oj, 0, oset};
  if (EDIT_MODE) {  // the one lane that held column n at row m
    const unsigned who = __ballot_sync(FULL, g_set);
    f.v0 = who ? __shfl_sync(FULL, g_s, __ffs(who) - 1) : POS;
    f.set = who != 0;
  }
  if (lane != 0) return;
  if constexpr (TEAM)
    if (!t.template finish<EDIT_MODE ? EDIT : OVERLAP>(f)) return;
  const int b = t.b;
  x.edge[b] = f.edge;
  x.best[b] = EDIT_MODE ? f.v0 : (f.set ? fmaxf(f.v0, 0.f) : NEG);
  x.a[b] = EDIT_MODE || !f.set ? 0 : (f.v0 > 0.f ? f.i0 : 0);
  x.b[b] = 0;
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// The kernels name a minimum of one CTA an SM: without it ptxas aims at an
// occupancy (64 registers for 256 threads, 96 for 128) and spills the fit
// score instances that need a few more.

// The warp path: a warp per pair, WARP_MAX_THREADS / 32 pairs a CTA at most.
__device__ __forceinline__ bool warp_pair(const Args& x, Solo& t) {
  t.b = blockIdx.x * (int)(blockDim.x >> 5) + (int)(threadIdx.x >> 5);
  return t.b < x.B;
}

template <int MODE, bool EMIT, int S>
__global__ void __launch_bounds__(WARP_MAX_THREADS, 1) banded_affine_warp(Args x) {
  Solo t;
  if (warp_pair(x, t)) fill_affine<MODE, EMIT, S, false>(x, t, 0);
}

template <bool EDIT_MODE, bool EMIT, int S>
__global__ void __launch_bounds__(WARP_MAX_THREADS, 1) banded_linear_warp(Args x) {
  Solo t;
  if (warp_pair(x, t)) fill_linear<EDIT_MODE, EMIT, S, false>(x, t, 0);
}

// The CTA path: a team of g.gw warps per pair, S lanes a thread.
template <int MODE, bool EMIT, int S>
__global__ void __launch_bounds__(CTA_THREADS, 1) banded_affine_cta(Args x, Geo g) {
  __shared__ Inbox boxes[CTA_WARPS];
  const Team t(g, boxes);
  if (t.b < x.B) fill_affine<MODE, EMIT, S, true>(x, t, t.w);
  if (g.C > 1) cluster_sync();  // no CTA leaves while a neighbour may write to it
}

template <bool EDIT_MODE, bool EMIT, int S>
__global__ void __launch_bounds__(CTA_THREADS, 1) banded_linear_cta(Args x, Geo g) {
  __shared__ Inbox boxes[CTA_WARPS];
  const Team t(g, boxes);
  if (t.b < x.B) fill_linear<EDIT_MODE, EMIT, S, true>(x, t, t.w);
  if (g.C > 1) cluster_sync();
}

template <int S>
void launch_warp(int mode, bool emit, int threads, cudaStream_t st, const Args& x) {
  const int pairs = threads / 32, ctas = (x.B + pairs - 1) / pairs;
  if (mode == OVERLAP) {
    if (emit)
      banded_linear_warp<false, true, S><<<ctas, threads, 0, st>>>(x);
    else
      banded_linear_warp<false, false, S><<<ctas, threads, 0, st>>>(x);
  } else if (mode == EDIT) {
    banded_linear_warp<true, false, S><<<ctas, threads, 0, st>>>(x);
  } else if (mode == GLOBAL) {
    if (emit)
      banded_affine_warp<GLOBAL, true, S><<<ctas, threads, 0, st>>>(x);
    else
      banded_affine_warp<GLOBAL, false, S><<<ctas, threads, 0, st>>>(x);
  } else if (mode == LOCAL) {
    if (emit)
      banded_affine_warp<LOCAL, true, S><<<ctas, threads, 0, st>>>(x);
    else
      banded_affine_warp<LOCAL, false, S><<<ctas, threads, 0, st>>>(x);
  } else {
    if (emit)
      banded_affine_warp<FIT, true, S><<<ctas, threads, 0, st>>>(x);
    else
      banded_affine_warp<FIT, false, S><<<ctas, threads, 0, st>>>(x);
  }
}

// The CTA path's geometry for V lanes at `threads` a CTA of `strip`-lane
// threads: gw, the fewest warps that hold V, share a CTA P at a time
// where a CTA holds them (its warps a multiple of gw), else a pair spans
// a cluster of C CTAs (the team's warps then C x wpc). False where no
// instance takes the shape.
bool cta_geometry(long long V, int threads, int strip, Geo& g) {
  const int need = (int)((V + 32 * strip - 1) / (32 * strip));
  g.wpc = threads / 32;
  if (threads > CTA_THREADS) return false;
  if (g.wpc >= need) {
    if (g.wpc % need) return false;
    g.gw = need;
    g.P = g.wpc / need;
    g.C = 1;
  } else {
    g.C = (need + g.wpc - 1) / g.wpc;
    if (g.C > CLUSTER_MAX) return false;
    g.gw = g.C * g.wpc;
    g.P = 1;
  }
  return true;
}

cudaError_t launch_cta_kernel(void (*kernel)(Args, Geo), const Geo& g, cudaStream_t st,
                              const Args& x) {
  if (g.C > CLUSTER_PORTABLE) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.C > 1 ? x.B * g.C : (x.B + g.P - 1) / g.P);
  cfg.blockDim = dim3(32 * g.wpc);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.C > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, x, g);
}

template <int S>
cudaError_t launch_cta(int mode, bool emit, const Geo& g, cudaStream_t st, const Args& x) {
  if (mode == OVERLAP)
    return launch_cta_kernel(
        emit ? &banded_linear_cta<false, true, S> : &banded_linear_cta<false, false, S>, g, st, x);
  if (mode == EDIT) return launch_cta_kernel(&banded_linear_cta<true, false, S>, g, st, x);
  if (mode == GLOBAL)
    return launch_cta_kernel(
        emit ? &banded_affine_cta<GLOBAL, true, S> : &banded_affine_cta<GLOBAL, false, S>, g, st,
        x);
  if (mode == LOCAL)
    return launch_cta_kernel(
        emit ? &banded_affine_cta<LOCAL, true, S> : &banded_affine_cta<LOCAL, false, S>, g, st, x);
  return launch_cta_kernel(
      emit ? &banded_affine_cta<FIT, true, S> : &banded_affine_cta<FIT, false, S>, g, st, x);
}

}  // namespace

// C entry point, bound with ctypes: launches one banded fill on `stream`
// without synchronising and returns the launch's error code. mode: 0
// global, 1 local, 2 fit, 3 overlap, 4 edit (scores only). `warp` 1: the warp
// path, a warp per pair, `threads` / 32 pairs a CTA (at most
// WARP_MAX_THREADS), `strip` lanes a thread (5, 9 or 16), 32 * strip >= V;
// `warp` 0: the CTA path, `strip` 4, 8 or CTA_STRIP_MAX, `threads` a CTA
// (at most CTA_THREADS; cta_geometry: several pairs a CTA, or a cluster of
// CTAs a pair, up to MAX_LANES). With pointers the lanes also cover v_pad.
extern "C" cudaError_t at_banded_fill(int mode, int emit, const int* qs, const int* te,
                                      const int* ns, const int* ms, const float* params,
                                      float* best, float* edge, int* a, int* b, uint8_t* ptrs,
                                      int B, int m_pad, int n_ext, int band, int v_pad,
                                      int threads, int strip, int warp, cudaStream_t stream) {
  const long long V = 2LL * band + 1;
  Geo g = {};
  const bool cta_ok = !warp && (strip == 4 || strip == 8 || strip == CTA_STRIP_MAX) &&
                      threads >= 32 && cta_geometry(V, threads, strip, g);
  const long long lanes = (long long)(warp ? 32 : 32 * g.gw) * strip;
  const bool bad_ptrs = emit && (mode == EDIT || v_pad < V || v_pad % 16 != 0 || lanes < v_pad);
  const bool bad_shape =
      warp ? (strip != 5 && strip != 9 && strip != WARP_STRIP_MAX) || threads > WARP_MAX_THREADS
           : !cta_ok;
  if (B < 0 || m_pad < 0 || n_ext < 1 || band < 0 || V > MAX_LANES || bad_shape ||
      threads < 32 || threads % 32 != 0 || lanes < V || mode < GLOBAL || mode > EDIT || bad_ptrs)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const Args x{qs, te, ns, ms, params, best, edge, a, b, ptrs, m_pad, n_ext, band, v_pad, B};
  const bool em = emit != 0;
  if (!warp) {
    const cudaError_t err = strip == 4   ? launch_cta<4>(mode, em, g, stream, x)
                            : strip == 8 ? launch_cta<8>(mode, em, g, stream, x)
                                         : launch_cta<CTA_STRIP_MAX>(mode, em, g, stream, x);
    if (err != cudaSuccess) return err;
  } else if (strip == 5) {
    launch_warp<5>(mode, em, threads, stream, x);
  } else if (strip == 9) {
    launch_warp<9>(mode, em, threads, stream, x);
  } else {
    launch_warp<WARP_STRIP_MAX>(mode, em, threads, stream, x);
  }
  return cudaGetLastError();
}
