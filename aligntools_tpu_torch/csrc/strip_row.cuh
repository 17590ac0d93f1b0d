// The register-strip row: the one body of every register-strip fill, flat
// (ptr_fill.cu, one CTA a pair) and blocked (blocked_fill.cu, one CTA a pair
// and column block), pointer and score fills alike. Thread t owns W
// consecutive columns and keeps their row state in registers; a row is a
// serial pass, warp scans with shuffles, one __syncthreads() and a second
// serial pass (ptr_fill.cu's header has the design).
//
// Three bodies, one for each recurrence:
//   AffineRow  global, local, fit(+jump): M, L, the U chain (fit's J chain),
//              D = max(L, M, U[, J]) and its argmax;
//   OverlapRow overlap: one matrix, the linear-gap left chain;
//   EditRow    edit: int32 (or double) min-plus, one chain.
// A kernel is a shell around one of them: it loads the strip (chars, the U
// chain's offsets and fit's gate, row 0), loops the rows through `row` and
// finishes (reduces the latched start info, writes the outputs). Two small
// policies of the shell's choosing fill in what differs:
//   Left  the strip row's left edge, which thread 0 reads each row before
//         the barrier: column 0's border in the flat fills, the previous
//         block's edge (or a chunk's left edge) in the blocked ones, with
//         the chains' seeds before warp 0 left in parity slots;
//   Sink  what pass 2 hands out besides the pointer bytes: the blocked
//         fills' right edge and state rows, and the latch of D(m, n).
// The pointer bytes (PTRS, packed across rpb rows, one 16-byte word a
// strip) and what is latched of the start info (LATCH) are template flags.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int GLOBAL = 0, LOCAL = 1, FIT = 2, OVERLAP = 3, EDIT = 4;
constexpr int BIG = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;

// The strip width the float32 fills are instantiated at, and the most
// threads a CTA runs, which sets the registers ptxas may give a thread
// (65,536 / 512).
constexpr int kWidth = 16;
constexpr int kMaxThreads = 512;
// The double instances' strip width: a double takes two registers, so W 16
// would hold twice float32's row state at the same 128 registers a thread
// (fit+jump's float32 W 16 already takes all 128). W 8 keeps the row state
// of one float32 strip: 512 x 8 = 4,096 columns a CTA.
constexpr int kWidth64 = 8;
// edit's most threads (65,536 / 1,024 = 64 registers: two words a column)
constexpr int kEditMaxThreads = 1024;

// What a fill latches of the start info while its rows run: nothing (a
// refill, and the score fills whose shells read it from the last row's
// registers); the pointer fills' candidates with their positions; the
// score fills' values alone.
constexpr int LATCH_NONE = 0, LATCH_PTR = 1, LATCH_SCORE = 2;

// max / min of the value types: FMNMX for float32
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ int vmin(int a, int b) { return min(a, b); }
__device__ __forceinline__ double vmin(double a, double b) { return fmin(a, b); }
// the min-plus fill's "no value": INT_MAX in int32, +inf in double
template <class T>
__device__ __forceinline__ T vtop();
template <>
__device__ __forceinline__ int vtop<int>() { return INT_MAX; }
template <>
__device__ __forceinline__ double vtop<double>() { return INFINITY; }

// A start-info candidate: the value, its row and its column.
template <class T>
struct Cand {
  T v;
  int i, j;
};

// x before y: the larger value, then the smaller row, then the smaller column
template <class T>
__device__ __forceinline__ bool before(const Cand<T>& x, const Cand<T>& y) {
  return x.v > y.v || (x.v == y.v && (x.i < y.i || (x.i == y.i && x.j < y.j)));
}

// The CTA's first candidate by `before`, in every thread; two barriers.
template <class T>
__device__ Cand<T> block_best(Cand<T> c, Cand<T> (&red)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const Cand<T> y = {__shfl_xor_sync(FULL, c.v, d), __shfl_xor_sync(FULL, c.i, d),
                       __shfl_xor_sync(FULL, c.j, d)};
    if (before(y, c)) c = y;
  }
  if (lane == 0) red[warp] = c;
  __syncthreads();
  Cand<T> r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    if (before(red[w], r)) r = red[w];
  __syncthreads();
  return r;
}

// The CTA's maximum of x, in every thread; two barriers.
template <class T>
__device__ __forceinline__ T block_max(T x, T (&red)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x = vmax(x, __shfl_xor_sync(FULL, x, d));
  if (lane == 0) red[warp] = x;
  __syncthreads();
  T r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = vmax(r, red[w]);
  __syncthreads();
  return r;
}

// Keep the strip's first maximum of one row over its first `kn` columns
// (columns <= n-1 of row m for fit and overlap): the first column holds the
// candidate even at -inf, as the plain version's first-equal search does.
template <int W, class T>
__device__ __forceinline__ void first_max(const T (&x)[W], int kn, int j0, Cand<T>& c) {
#pragma unroll
  for (int k = 0; k < W; ++k)
    if (k < kn && (x[k] > c.v || c.j == BIG)) c = {x[k], 0, j0 + k};
}

// Inclusive max / min over the warp's lanes (lanes below d read their own
// value).
template <class T>
__device__ __forceinline__ T warp_incl_max(T x) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) x = vmax(x, __shfl_up_sync(FULL, x, d));
  return x;
}
template <class T>
__device__ __forceinline__ T warp_incl_min(T x) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) x = vmin(x, __shfl_up_sync(FULL, x, d));
  return x;
}

// Inclusive max / min over the aggregates of warps 0..lane, in every warp.
template <class T>
__device__ __forceinline__ T warps_incl_max(const T* agg, int lane, int nw) {
  T y = lane < nw ? agg[lane] : (T)NEG;
  for (int d = 1; d < nw; d <<= 1) y = vmax(y, __shfl_up_sync(FULL, y, d));
  return y;
}
template <class T>
__device__ __forceinline__ T warps_incl_min(const T* agg, int lane, int nw) {
  T y = lane < nw ? agg[lane] : vtop<T>();
  for (int d = 1; d < nw; d <<= 1) y = vmin(y, __shfl_up_sync(FULL, y, d));
  return y;
}

// D = max(L, M, U[, J]) and its earliest-argument strict argmax: the first
// of the states that holds the maximum (LOW, MID, UPP, JUMP = 0..3).
template <bool JUMP, class T>
__device__ __forceinline__ T lmuj_max(T l, T m, T u, T j, int& a) {
  T d = l;
  a = 0;
  if (m > d) a = 1;
  d = vmax(d, m);
  if (u > d) a = 2;
  d = vmax(d, u);
  if (JUMP) {
    if (j > d) a = 3;
    d = vmax(d, j);
  }
  return d;
}

// Store a strip's packed byte-row of W bytes as 16-byte words (8 bytes for
// the double instances' W 8).
template <int W>
__device__ __forceinline__ void store_strip(uint8_t* dst, const uint32_t (&acc)[W / 4]) {
  static_assert(W % 16 == 0 || W == 8, "a strip is stored as whole 16- or 8-byte words");
  if constexpr (W == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(acc[0], acc[1]);
  } else {
#pragma unroll
    for (int w = 0; w < W / 4; w += 4)
      reinterpret_cast<uint4*>(dst)[w / 4] = make_uint4(acc[w], acc[w + 1], acc[w + 2], acc[w + 3]);
  }
}

// The strip's W target chars as 16-byte words, t 16-byte aligned (0 for a
// thread past the columns, whose columns are never stored or latched).
template <int W>
__device__ __forceinline__ void load_chars(const int* t, bool active, int (&tc)[W]) {
#pragma unroll
  for (int k = 0; k < W; k += 4) {
    const int4 x = active ? *reinterpret_cast<const int4*>(t + k) : make_int4(0, 0, 0, 0);
    tc[k] = x.x;
    tc[k + 1] = x.y;
    tc[k + 2] = x.z;
    tc[k + 3] = x.w;
  }
}

// Row 0 at column j >= 1: global M = L = -inf, U = o + e*j; local zeros;
// fit M = U = 0, L = -inf; J = -inf.
template <int MODE, class T>
__device__ __forceinline__ void row0(int j, T o, T e, T& m, T& l, T& u, T& jj) {
  m = MODE == GLOBAL ? (T)NEG : (T)0;
  l = MODE == LOCAL ? (T)0 : (T)NEG;
  u = MODE == GLOBAL ? o + e * (T)j : (T)0;
  jj = (T)NEG;
}

// Column 0's states M, L, U, J at row r: global L(r, 0) = o + e*r, M and U
// at row 0 only (U(0, 0) = o); local zeros; fit M = U = 0 at row 0.
template <int MODE, class T>
__device__ __forceinline__ void border0(int r, T o, T e, T& m, T& l, T& u, T& jj) {
  constexpr T NG = (T)NEG;
  jj = NG;
  if (MODE == LOCAL) {
    m = l = u = (T)0;
  } else {
    m = r == 0 ? (T)0 : NG;
    l = MODE == GLOBAL ? o + e * (T)r : NG;
    u = r == 0 ? (MODE == GLOBAL ? o : (T)0) : NG;
  }
}

// ---------------------------------------------------------------------------
// global / local / fit(+jump)
// ---------------------------------------------------------------------------

// The affine row (JUMP: fit's junction-gated J state, entry allowed where
// allow > 0 — the reference's inverted enum-bool quirk). Per row i:
//   pass 1  M and L of row i, the M/L pointer bits, the strip's terms of
//           the U chain (and fit's J chain);
//   scan    a warp scan with shuffles; lane 31 leaves the warp's aggregate,
//           its aggregate without the warp's last column, and that column's
//           M and L in parity slots; thread 0 reads the left edge (Left);
//           the row's one __syncthreads(); every warp scans the warps'
//           aggregates with shuffles;
//   pass 2  U and J of the row, the U/J bits, D and its argmax; the Sink
//           takes each column's states.
// The diagonal across a strip edge, row i-1 at column j0-1, comes from lane
// l-1's registers by __shfl_up_sync; lane 0 of warp w > 0 builds it itself
// after row i-1's barrier from warp w-1's slots, thread 0 from the left
// edge (eD, eA). Start info (LATCH) is latched per thread: local's strict
// row-major first occurrence of the strip's maximum over rows <= m and
// columns <= n (LATCH_SCORE: the maximum alone); fit's first maximum of M
// and of L on row m over columns <= n-1 (LATCH_SCORE: max(M, L)); global's
// D(m, n) and its argmax, handed to the Sink by the thread that holds
// column n.
template <int MODE, bool JUMP, int W, class T, bool PTRS, int LATCH>
struct AffineRow {
  static constexpr int NC = JUMP ? 2 : 1;  // in-row chains: U, fit's J
  static constexpr T NG = (T)NEG;
  // D's argmax is kept for the pointer bits and global's start state
  static constexpr bool ARG = PTRS || (LATCH == LATCH_PTR && MODE == GLOBAL);
  // by row parity: each warp's aggregate, its aggregate without the warp's
  // last column, and that column's M and L; the chains' seeds before warp 0
  // (the blocked fills' Left)
  struct Smem {
    T agg[2][NC][32], wo[2][NC][32], m[2][32], l[2][32], seed[2][NC];
  };
  int lane, warp, nw, j0, m, kn, rpb, lg;  // lg: log2(rpb), rpb 1, 2 or 4
  bool active;
  T match, mis, o, e, jp, ej0;
  int tc[W];
  T cu[W];  // o - e*(j+1): the U chain's term offset of column j
  // JUMP: bit k where J may be entered into column j0+k+1; into column j0
  uint32_t gate;
  bool gate0;
  T M[W], L[W], D[W];  // M and L of the previous row; D = max(L, M, U[, J])
  uint32_t A;          // D's argmax, two bits a column (ARG)
  T eD;                // lane 0: D(i-1, j0-1) and its argmax
  int eA;
  T mb;  // thread 0: M(i, j0-1), the left edge's
  uint8_t* out;  // this strip's bytes of pointer row 0 (PTRS); rows `pitch` apart
  int pitch;
  uint32_t acc[W / 4];
  Cand<T> lat, cm, cl;  // local's latch; fit's row-m M and L

  // j0 the strip's first (global) column, m the pair's rows, n its columns
  __device__ __forceinline__ AffineRow(const T* params, int j0_, bool active_, int m_, int n,
                                       int rpb_)
      : lane(threadIdx.x & 31), warp(threadIdx.x >> 5), nw(blockDim.x >> 5), j0(j0_), m(m_),
        kn(active_ ? n - j0_ + 1 : 0), rpb(rpb_), lg(rpb_ >> 1), active(active_),
        match(params[0]), mis(params[1]), o(params[2]), e(params[3]), jp(params[4]),
        ej0(params[3] * (T)j0_),
        gate(0), gate0(false), A(0), eD(NG), eA(0), mb(NG), out(nullptr), pitch(0),
        lat{NG, 0, 0}, cm{NG, 0, BIG}, cl{NG, 0, BIG} {
#pragma unroll
    for (int k = 0; k < W; ++k) cu[k] = o - e * (T)(j0 + k + 1);
  }

  // the strip's chars (t 16-byte aligned) and fit's gate from `al`, al[j]
  // gating the entry into column j+1 (j < lim)
  __device__ __forceinline__ void load(const int* t, const float* al, int lim) {
    load_chars<W>(t, active, tc);
    if (JUMP && active) {
#pragma unroll
      for (int k = 0; k < W; ++k)
        if (j0 + k < lim && al[j0 + k] > 0.f) gate |= 1u << k;
      gate0 = al[j0 - 1] > 0.f;
    }
  }

  // Row 0 from state0(j, M, L, U, J) at the strip's columns and, for lane 0
  // of a later warp, at column j0-1 (a thread past the columns holds -inf);
  // thread 0's diagonal is the Left's. DU: state0 hands D itself in U's
  // place (a score chunk's state rows: M, L, D).
  template <bool DU = false, class F>
  __device__ __forceinline__ void init(F state0) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      T u = NG, jj = NG;
      M[k] = L[k] = NG;
      if (active) state0(j0 + k, M[k], L[k], u, jj);
      int a;
      D[k] = DU ? u : lmuj_max<JUMP, T>(L[k], M[k], u, jj, a);
      if (ARG) A |= (uint32_t)a << (2 * k);
    }
    if (lane == 0 && threadIdx.x > 0 && active) {
      T lm, ll, lu, lj;
      state0(j0 - 1, lm, ll, lu, lj);
      eD = DU ? lu : lmuj_max<JUMP, T>(ll, lm, lu, lj, eA);
    }
  }

  // Row i (gi the pair's row; qc its query char).
  template <class Left, class Sink>
  __device__ __forceinline__ void row(int i, int gi, int qc, Smem& sh, Left& left, Sink& sink) {
    // rpb is a power of two: no division on the row's path
    const int p = i & 1, sub_row = PTRS ? (i - 1) & (rpb - 1) : 0;
    const int shift = sub_row << (3 - lg);
    const int k_home = rpb > 1 ? 3 : 4, k_unset = rpb > 1 ? 3 : 7;
    const int lbit = rpb > 1 ? 1 << 2 : 1 << 3, ubit = rpb > 1 ? 1 << 3 : 1 << 4;
    if (PTRS && sub_row == 0) {
#pragma unroll
      for (int x = 0; x < W / 4; ++x) acc[x] = 0;
    }
    left.begin(*this, i);
    // row i-1 at column j0-1: lane l-1's last column, or lane 0's own
    T dD = __shfl_up_sync(FULL, D[W - 1], 1);
    int dA = PTRS ? (int)(__shfl_up_sync(FULL, A, 1) >> (2 * (W - 1))) & 3 : 0;
    if (lane == 0) {
      dD = eD;
      dA = eA;
    }
    // pass 1: M, L and their bits; the strip's chain terms
    T vu = NG, vu_wo = NG, vj = NG, vj_wo = NG, rmax = NG;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const T sub = tc[k] == qc ? match : mis;
      // earliest-argument strict argmax: L, M, U, J (D's), then HOME
      T best = dD + sub;
      int pm = dA;
      if (MODE == LOCAL) {
        if ((T)0 > best) pm = k_home;  // the HOME candidate has no +sub
        best = vmax(best, (T)0);      // and so is never unset
      } else if (!(best > NG)) {
        pm = k_unset;
      }
      dD = D[k];
      dA = PTRS ? (int)(A >> (2 * k)) & 3 : 0;
      const T la = L[k] + e, lb = M[k] + o;
      L[k] = vmax(la, lb);
      M[k] = best;
      if (PTRS) acc[k >> 2] |= (uint32_t)(pm | (la >= lb ? 0 : lbit)) << (8 * (k & 3) + shift);
      if (k == W - 1) {
        vu_wo = vu;
        vj_wo = vj;
      }
      vu = vmax(vu, best + cu[k]);
      if (JUMP) vj = vmax(vj, (gate >> k & 1) ? best + jp : NG);
      if (MODE == LOCAL) rmax = vmax(rmax, best);
    }
    if (LATCH != LATCH_NONE && MODE == LOCAL && gi <= m) {
      // the strict row-major first occurrence of the strip's maximum
      if (kn < W) {  // the strip holds column n, or lies past it
        rmax = NG;
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (k < kn) rmax = vmax(rmax, M[k]);
      }
      if (LATCH == LATCH_SCORE) {
        lat.v = vmax(lat.v, rmax);  // the score alone
      } else if (rmax > lat.v) {
        int fj = BIG;
#pragma unroll
        for (int k = W - 1; k >= 0; --k)
          if (k < kn && M[k] == rmax) fj = j0 + k;
        lat = {rmax, gi, fj};
      }
    }
    if (LATCH != LATCH_NONE && MODE == FIT && gi == m) {  // the bottom row over columns <= n-1
      if (LATCH == LATCH_PTR) {
        first_max<W, T>(M, kn - 1, j0, cm);
        first_max<W, T>(L, kn - 1, j0, cl);
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (k < kn - 1) lat.v = vmax(lat.v, vmax(M[k], L[k]));
      }
    }
    // the warps' scans; lane 31 leaves the warp's part in shared memory
    const T in_u = warp_incl_max(vu), below_u = __shfl_up_sync(FULL, in_u, 1);
    T in_j = NG, below_j = NG;
    if (JUMP) {
      in_j = warp_incl_max(vj);
      below_j = __shfl_up_sync(FULL, in_j, 1);
    }
    if (lane == 31) {
      sh.agg[p][0][warp] = in_u;
      sh.wo[p][0][warp] = vmax(below_u, vu_wo);
      if (JUMP) {
        sh.agg[p][NC - 1][warp] = in_j;
        sh.wo[p][NC - 1][warp] = vmax(below_j, vj_wo);
      }
      sh.m[p][warp] = M[W - 1];
      sh.l[p][warp] = L[W - 1];
    }
    // row i of the left edge: M(i, j0-1) in mb, the next row's diagonal in
    // eD and eA, the chains' seeds
    if (threadIdx.x == 0) left.poll(*this, i, p, sh);
    __syncthreads();  // the row's one barrier
    // the exclusive prefixes: U's over columns < j0 (terms up to j0), J's
    // likewise (J(i, j0)); lane 0's left column's, without warp w-1's last
    const T useed = left.useed(sh, p);
    const T yu = warps_incl_max(sh.agg[p][0], lane, nw);
    const T pu = __shfl_sync(FULL, yu, max(warp - 1, 0));
    const T pu2 = __shfl_sync(FULL, yu, max(warp - 2, 0));
    T run_u = vmax(useed, warp > 0 ? pu : NG);
    if (lane > 0) run_u = vmax(run_u, below_u);
    T run_j = NG, pj2 = NG, jseed = NG;
    if (JUMP) {
      jseed = left.jseed(sh, p);
      const T yj = warps_incl_max(sh.agg[p][NC - 1], lane, nw);
      const T pj = __shfl_sync(FULL, yj, max(warp - 1, 0));
      pj2 = __shfl_sync(FULL, yj, max(warp - 2, 0));
      run_j = vmax(jseed, warp > 0 ? pj : NG);
      if (lane > 0) run_j = vmax(run_j, below_j);
    }
    T mprev = __shfl_up_sync(FULL, M[W - 1], 1);  // M(i, j0-1)
    if (lane == 0) {
      if (threadIdx.x == 0) {
        mprev = mb;
      } else {
        // row i at column j0-1, the next row's diagonal
        mprev = sh.m[p][warp - 1];
        const T uq = vmax(vmax(useed, warp > 1 ? pu2 : NG), sh.wo[p][0][warp - 1]);
        const T jl =
            JUMP ? vmax(vmax(jseed, warp > 1 ? pj2 : NG), sh.wo[p][NC - 1][warp - 1]) : NG;
        eD = lmuj_max<JUMP, T>(sh.l[p][warp - 1], mprev, uq + e * (T)(j0 - 1), jl, eA);
      }
    }
    // pass 2: U and J, their bits, D and its argmax; each column's states
    // to the Sink
    sink.row_begin(*this, i);
    T jcv = JUMP && gate0 ? mprev + jp : NG;  // J's entry into column j
    uint32_t an = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const T uv = run_u + (k == 0 ? ej0 : o - cu[k > 0 ? k - 1 : 0]);  // + e*j
      const T ua = mprev + o;
      // U(i,j) = max(ua, U(i,j-1) + e), so ua >= U(i,j-1) + e iff ua >= U(i,j)
      int code = ua >= uv ? 0 : ubit;
      T jv = NG;
      if (JUMP) {
        // J(i,j) = max(J(i,j-1), jcv): jcv >= J(i,j-1) iff jcv >= J(i,j)
        code |= (jcv > NG && jcv >= run_j) ? 0 : 1 << 5;
        jv = run_j;
        jcv = (gate >> k & 1) ? M[k] + jp : NG;
        run_j = vmax(run_j, jcv);
      }
      if (PTRS) acc[k >> 2] |= (uint32_t)code << (8 * (k & 3) + shift);
      int a;
      D[k] = lmuj_max<JUMP, T>(L[k], M[k], uv, jv, a);
      if (ARG) an |= (uint32_t)a << (2 * k);
      sink.cell(*this, i, k, uv, jv);
      run_u = vmax(run_u, M[k] + cu[k]);
      mprev = M[k];
    }
    if (ARG) A = an;
    sink.row_end(*this, i);
    if (LATCH != LATCH_NONE && MODE == GLOBAL && gi == m && kn >= 1 && kn <= W) {
      // (m, n): the start state is D's argmax at column n, the last column
      // k < kn. (Picked as k == kn - 1, the W picks are merged into one
      // load of D[kn-1], an indexed load that keeps the row in local
      // memory.)
      T gv = NG;
      int ga = 0;
#pragma unroll
      for (int k = 0; k < W; ++k)
        if (k < kn) {
          gv = D[k];
          ga = ARG ? (int)(A >> (2 * k)) & 3 : 0;
        }
      sink.global(gv, ga);
    }
    if (PTRS && sub_row == rpb - 1 && active)
      store_strip<W>(out + (size_t)((i - 1) >> lg) * (size_t)pitch, acc);
  }
};

// The flat fills' Left for the affine row: column 0's border (the strip row
// starts at column 1), which thread 0 makes at the start of each row.
// SCORES: the score fills' D(0, 0) = 0, whatever the sign of o. No seed
// needs a slot: U's is U(i, 0) folded in (local's max(o - e, 0)), J's -inf.
template <int MODE, bool JUMP, class T, bool SCORES>
struct BorderLeft {
  T o, e, useed_;
  __device__ __forceinline__ BorderLeft(T o_, T e_)
      : o(o_), e(e_), useed_(MODE == LOCAL ? vmax((T)0 + (o_ - e_ * (T)1), (T)0) : (T)NEG) {}
  // thread 0: row r's border as the next row's diagonal
  template <class R>
  __device__ __forceinline__ void at(R& r, int row) const {
    T mm, ll, uu, jj;
    border0<MODE, T>(row, o, e, mm, ll, uu, jj);
    r.eD = lmuj_max<JUMP, T>(ll, mm, uu, jj, r.eA);
    if (SCORES && MODE == GLOBAL && row == 0) r.eD = (T)0;
  }
  template <class R>
  __device__ __forceinline__ void init(R& r) const {
    r.mb = MODE == LOCAL ? (T)0 : (T)NEG;
  }
  template <class R>
  __device__ __forceinline__ void begin(R& r, int i) const {
    if (threadIdx.x == 0) at(r, i - 1);
  }
  template <class R, class S>
  __device__ __forceinline__ void poll(R&, int, int, S&) const {}
  template <class S>
  __device__ __forceinline__ T useed(const S&, int) const {
    return useed_;
  }
  template <class S>
  __device__ __forceinline__ T jseed(const S&, int) const {
    return (T)NEG;
  }
};

// ---------------------------------------------------------------------------
// overlap
// ---------------------------------------------------------------------------

// The overlap row: one matrix, linear gap o; pointer codes LEFT/DIAG/RIGHT =
// 0/1/2, 3 where the cell is -inf (alignment.h:944's argument order). Pass 1
// takes max(DIAG, RIGHT), which of the two, and the left chain's terms
// normalised by -o*j; the warp scan, the barrier and the warps' scan give the
// exclusive prefix, seeded before warp 0 by the left edge M(i, col0) -
// o*col0 (Left: 0 at column 0); pass 2 gives M and the codes. No slot carries
// the diagonal: M(i, j0-1) is the thread's own prefix plus o*(j0-1). LATCH_PTR
// latches row m's first maximum over columns <= n-1; LATCH_SCORE its maximum
// alone (the shells whose rows stop at m read it from M after the last row
// instead, so that no value of it stays live across the rows).
template <int W, class T, bool PTRS, int LATCH>
struct OverlapRow {
  static constexpr T NG = (T)NEG;
  struct Smem {
    T agg[2][32], seed[2];
  };
  int lane, warp, nw, j0, m, kn, rpb, lg;
  bool active;
  T match, mis, o, oj_left;
  int tc[W];
  T M[W], oj[W];  // M of the previous row; o*j
  T mleft;        // M(i-1, j0-1)
  uint8_t* out;
  int pitch;
  uint32_t acc[W / 4];
  Cand<T> best;  // row m's first maximum over j <= n-1 (LATCH_SCORE: .v alone)

  __device__ __forceinline__ OverlapRow(const T* params, int j0_, bool active_, int m_, int n,
                                        int rpb_)
      : lane(threadIdx.x & 31), warp(threadIdx.x >> 5), nw(blockDim.x >> 5), j0(j0_), m(m_),
        kn(active_ ? n - j0_ : 0), rpb(rpb_), lg(rpb_ >> 1), active(active_), match(params[0]),
        mis(params[1]), o(params[2]), oj_left(params[2] * (T)(j0_ - 1)), mleft(NG),
        out(nullptr), pitch(0), best{NG, 0, BIG} {
#pragma unroll
    for (int k = 0; k < W; ++k) oj[k] = o * (T)(j0 + k);
  }

  // the strip's chars and row 0 from state0(j) (-inf past the columns);
  // M(0, j0-1) from `left0` in thread 0, from state0 in the others
  template <class F>
  __device__ __forceinline__ void init(const int* t, F state0, T left0) {
    load_chars<W>(t, active, tc);
#pragma unroll
    for (int k = 0; k < W; ++k) M[k] = active ? state0(j0 + k) : NG;
    mleft = threadIdx.x == 0 ? left0 : active ? state0(j0 - 1) : NG;
  }

  template <class Left, class Sink>
  __device__ __forceinline__ void row(int i, int gi, int qc, Smem& sh, Left& left, Sink& sink) {
    // rpb is a power of two: no division on the row's path
    const int p = i & 1, sub_row = PTRS ? (i - 1) & (rpb - 1) : 0;
    const int shift = sub_row << (3 - lg);
    if (PTRS && sub_row == 0) {
#pragma unroll
      for (int x = 0; x < W / 4; ++x) acc[x] = 0;
    }
    // pass 1: max(DIAG, RIGHT) and which of the two; the left chain's terms
    T dM = mleft, dr[W], v = NG;
    uint32_t diag_wins = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const T sub = tc[k] == qc ? match : mis;
      const T diag = dM + sub, right = M[k] + o;
      dr[k] = vmax(diag, right);
      if (PTRS && diag >= right) diag_wins |= 1u << k;
      v = vmax(v, dr[k] - oj[k]);
      dM = M[k];
    }
    const T in = warp_incl_max(v), below = __shfl_up_sync(FULL, in, 1);
    if (lane == 31) sh.agg[p][warp] = in;
    if (threadIdx.x == 0) left.poll(i, p, sh);
    __syncthreads();  // the row's one barrier
    const T y = warps_incl_max(sh.agg[p], lane, nw);
    const T pw = __shfl_sync(FULL, y, max(warp - 1, 0));
    T run = vmax(left.seed(sh, p), warp > 0 ? pw : NG);
    if (lane > 0) run = vmax(run, below);
    // pass 2: M(i, j) and the codes; M(i, j0-1) is run + o*(j0-1)
    T mprev = run + oj_left;
    mleft = mprev;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (PTRS) {
        const T left_v = mprev + o;
        const T val = vmax(left_v, dr[k]);
        int code = left_v >= val ? 0 : ((diag_wins >> k & 1) ? 1 : 2);
        if (!(val > NG)) code = 3;
        acc[k >> 2] |= (uint32_t)code << (8 * (k & 3) + shift);
      }
      run = vmax(run, dr[k] - oj[k]);
      M[k] = run + oj[k];
      mprev = M[k];
    }
    sink.row_end(*this, i);
    if (LATCH != LATCH_NONE && gi == m) {  // the bottom row over j <= n-1
      if (LATCH == LATCH_PTR) {
        first_max<W, T>(M, kn, j0, best);
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (k < kn) best.v = vmax(best.v, M[k]);
      }
    }
    if (PTRS && sub_row == rpb - 1 && active)
      store_strip<W>(out + (size_t)((i - 1) >> lg) * (size_t)pitch, acc);
  }
};

// The flat fills' Left for overlap: M(i, 0) = 0 seeds the chain.
template <class T>
struct ZeroLeft {
  template <class S>
  __device__ __forceinline__ void poll(int, int, S&) const {}
  template <class S>
  __device__ __forceinline__ T seed(const S&, int) const {
    return (T)0;
  }
};

// ---------------------------------------------------------------------------
// edit
// ---------------------------------------------------------------------------

// The edit row (alignment.h:291-315): min-plus, indel cost 1, substitution
// cost 0 or u. M(i, j) = min(c(j), M(i, j-1) + 1) with c(j) = min(M(i-1, j-1)
// + sub, M(i-1, j) + 1), so M(i, j) - j is the running minimum of c - j over
// the row, seeded by the left edge's M(i, col0) - col0 (Left: i at column
// 0). Pass 1 leaves the strip's running minimum of c - j in place of M (one
// dependent min a column); the warp scan, the row's one barrier and the
// warps' scan give the exclusive prefix from the left; pass 2 is one min and
// one add a column, independent of each other. The diagonal across the
// strip's left edge, M(i-1, j0-1), is the prefix plus j0-1. T int32, or
// double (P the params row's type) with +inf in place of INT_MAX.
template <int W, class T>
struct EditRow {
  struct Smem {
    T agg[2][32], seed[2];
  };
  int lane, warp, nw, j0;
  T u;
  int tc[W];
  T M[W];  // the previous row's M; between the passes, the running minimum
  T mleft;  // M(i-1, j0-1)

  template <class P>
  __device__ __forceinline__ EditRow(const P* params, int j0_)
      : lane(threadIdx.x & 31), warp(threadIdx.x >> 5), nw(blockDim.x >> 5), j0(j0_),
        u((T)params[1]) {}

  // the strip's chars and row 0 from state0(j); M(0, j0-1) = left0
  template <class F>
  __device__ __forceinline__ void init(const int* t, bool active, F state0, T left0) {
    load_chars<W>(t, active, tc);
#pragma unroll
    for (int k = 0; k < W; ++k) M[k] = state0(j0 + k);
    mleft = left0;
  }

  template <class Left>
  __device__ __forceinline__ void row(int i, int qc, Smem& sh, Left& left) {
    const int p = i & 1;
    // pass 1: c - j and the strip's running minimum of it
    T dM = mleft, run = vtop<T>();
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const T sub = tc[k] == qc ? (T)0 : u;
      run = vmin(run, vmin(dM + sub, M[k] + (T)1) - (T)(j0 + k));
      dM = M[k];
      M[k] = run;
    }
    const T in = warp_incl_min(run), below = __shfl_up_sync(FULL, in, 1);
    if (lane == 31) sh.agg[p][warp] = in;
    if (threadIdx.x == 0) left.poll(i, p, sh);
    __syncthreads();  // the row's one barrier
    const T y = warps_incl_min(sh.agg[p], lane, nw);
    const T pw = __shfl_sync(FULL, y, max(warp - 1, 0));
    T pre = vmin(left.seed(sh, p, i), warp > 0 ? pw : vtop<T>());
    if (lane > 0) pre = vmin(pre, below);
    // pass 2: M(i, j) = min(the prefix, the strip's running minimum) + j
    mleft = pre + (T)(j0 - 1);
#pragma unroll
    for (int k = 0; k < W; ++k) M[k] = vmin(pre, M[k]) + (T)(j0 + k);
  }
};

// The flat edit fill's Left: M(i, 0) - 0 = i seeds the chain.
template <class T>
struct RowLeft {
  template <class S>
  __device__ __forceinline__ void poll(int, int, S&) const {}
  template <class S>
  __device__ __forceinline__ T seed(const S&, int, int i) const {
    return (T)i;
  }
};

}  // namespace
