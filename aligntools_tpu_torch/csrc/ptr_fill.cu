// Register-strip DP fills for Hopper (sm_90a): global, local, fit(+jump)
// and overlap, one CTA per pair. The pointer fill writes every pointer of
// the (m_pad, n_pad) grid; its score-only instances are the score fills of
// those modes, and an int32 min-plus kernel of the same design is edit's
// (Scores, below).
//
// Replaces ops/pallas_ptr.py:_ptr_kernel (entry pallas_ptr_fill). Outputs,
// per pair: the score, the traceback-start info a/b and the packed pointer
// tensor (B, m_pad/rpb, n_pad) of columns 1..n_pad, rpb DP rows per byte
// (row rpb*k in the low bits; layout.py). Every byte is written, pad rows
// and pad columns included: they read the sentinel chars (query pad -1,
// target pad -2) exactly as the Pallas kernel does.
//
// Design. Thread t owns the W consecutive columns [1 + t*W, 1 + (t+1)*W)
// of the whole n_pad (W a template parameter, instantiated at 16; threads *
// W >= n_pad, and threads past n_pad / W compute on pad and store nothing). A
// thread keeps its strip's row state in registers for the whole fill: the
// chars, M and L of the previous row, and D = max(L, M, U[, J]) with its
// earliest-argument argmax (two bits a column), which is all the next row's
// diagonal needs: every candidate of M(i, j) is a state of (i-1, j-1) plus
// the same substitution score, and on exact integer-valued f32 the argmax
// of the sums is the argmax of the states. U and J are made in pass 2 and
// folded into D at once. Per row i:
//   pass 1  M and L of row i, the M/L bits of each pointer, the strip's
//           terms of the U chain (and fit's J chain);
//   scan    a warp scan with shuffles; lane 31 leaves the warp's aggregate,
//           its aggregate without the warp's last column, and that column's
//           M and L in shared memory; the row's one __syncthreads(); every
//           warp scans the warps' aggregates with shuffles;
//   pass 2  U and J of the row, the U/J bits, D and its argmax.
// The diagonal across a strip edge, row i-1 at column j0-1, comes from
// lane l-1's registers by __shfl_up_sync. Lane 0 of warp w > 0 builds it
// itself after row i-1's barrier: M and L from warp w-1's slot; U(i-1,
// j0-1) and J(i-1, j0-1) from the aggregates of warps < w-1 and warp w-1's
// aggregate without its last column, which is the chain up to column
// j0-1. Every shared slot is double-buffered by row parity, so a warp
// already writing row i+1's slots never overwrites one that a slower warp
// reads for row i. Overlap needs no slot: M(i, j0-1) is the thread's own
// scan result plus o*(j0-1). A row's pointer bytes are packed in registers
// across rpb rows and stored by each thread as one 16-byte word,
// so a warp writes a contiguous run of the row. Start info is latched per
// thread in registers (local: the strict row-major first occurrence of the
// strip's maximum over i <= m, j <= n; fit and overlap: the strip's first
// maximum of row m over j <= n-1; global: the thread that holds column n at
// row m) and reduced across the CTA once, after the last row, by (largest
// value, smallest i, smallest j): the plain version's running strict row
// maximum and first column give the same.
//
// What bounds it here: the per-row chain. Each row pays one barrier, two
// warp scans a chain (the strip terms, then the warps' aggregates: five and
// log2(warps) dependent shuffles) and W serial cells a pass; the pointer
// bytes (m*n/rpb a pair, 0.5 B a cell at rpb 2) are far below HBM's rate.
// Row state never leaves the SM, and the registers it takes (M, L, D, the
// U chain's offset and the char: five words a column) bound W: ptxas gives
// W 16 104-128 registers a thread (fit+jump all 128, with an 8-byte stack
// frame), so its CTA runs at most 512 threads, 8,192 columns. A row costs
// each warp its scans, so W 16, the fewest warps, is the one instance: W 4
// and 8 were no faster on the H100 (PERF.md). With one CTA a pair the
// schedulers wait on that chain unless the batch keeps several CTAs on
// every SM.
//
// Scores. The same kernels with PTRS false are the score fills of global,
// local, fit(+jump) and overlap up to 8,192 columns (they replace
// ops/pallas_scan.py:328 _affine_kernel, :513 _fit_kernel and :421
// _overlap_kernel; one entry, at_score_fill, for ops/scan.scores and
// fit_scores): no pointer bits, no argmax of D and no stores, rows up to m.
// Their row state and chains are the pointer fill's, one barrier a row,
// and a score is one value a thread reduced once after the last row:
// local's latched maximum; fit's maximum of M and L on row m over columns
// <= n-1 (U and J excluded; -inf where no column qualifies); overlap's
// likewise of M, finished as max(r, 0) + 0 in every case, m = 0 included
// (the pointer fill's finish would give -inf there); global's D(m, n) (its
// (0, 0) diagonal border 0, as the score fill has it). Fit keeps the U and
// J chains and the entry gate from allow; its (0, 0) border is D = 0 at
// i = 1 and -inf after, which the pointer fill already has. Overlap takes
// row m's maximum after the last row, from the strip's registers. The edit
// score fill (:469 _edit_kernel, the entry's fifth mode) is overlap's
// one-chain shape in int32 min-plus, edit_score_kernel: two words a column
// (the char and M), one running minimum a row in pass 1 and a pass 2 of
// independent cells, so it may run 1,024 threads (16,384 columns) at the
// 64 registers that leaves a thread: up to there it beats the blocked
// fill on the H100 (PERF.md). ptxas gives the affine score instances
// 120-128 registers, overlap's 64 and edit's 61, none spilling.
//
// Exactness: values are integer-valued f32 below 2^24 with true -inf
// borders, built with --fmad=false and no fast math; each pointer is a
// comparison of such values in the Pallas code's own argument order, and
// the chains' terms are the plain version's own sums. Edit distances are
// int32, whose adds and minima are exact in any order.
//
// Double instances. A single pair past float32's exact integers
// (max|param| * (m+n+1) >= 2^24; api.align_pair sends it, as the JAX
// align_pair sends it to its double-precision spec engine) runs the same
// kernels with the value type T = double: params, scores, row state and
// the shared-memory aggregates in double, exact integers below 2^53 with
// true -inf borders (no sentinel), the same comparisons in the same order;
// the pointer bytes, start info and stores are float32's. A double takes
// two registers, so the double instances run strips of kWidth64 = 8
// columns (the row state of a float32 strip of 8), up to 512 x 8 = 4,096
// columns for the pointer fill and 1,024 x 8 = 8,192 for edit's, whose
// double instance replaces INT_MAX by +inf (entries at_ptr_fill64,
// at_edit_fill64).

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "strip_row.cuh"

namespace {

constexpr int GLOBAL = 0, LOCAL = 1, FIT = 2, OVERLAP = 3;
constexpr int EDIT = 4;  // a score fill alone: the pointer fill has no edit
// the edit score fill's most threads (65,536 / 1,024 = 64 registers)
constexpr int kEditMaxThreads = 1024;

// min of the min-plus fill's value types
__device__ __forceinline__ int vmin(int a, int b) { return min(a, b); }
__device__ __forceinline__ double vmin(double a, double b) { return fmin(a, b); }
// the min-plus fill's "no value": INT_MAX in int32, +inf in double
template <class T>
__device__ __forceinline__ T vtop();
template <>
__device__ __forceinline__ int vtop<int>() { return INT_MAX; }
template <>
__device__ __forceinline__ double vtop<double>() { return INFINITY; }

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

// Inclusive min over the warp's lanes (lanes below d read their own value).
template <class T>
__device__ __forceinline__ T warp_incl_min(T x) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) x = vmin(x, __shfl_up_sync(FULL, x, d));
  return x;
}

// Inclusive min over the aggregates of warps 0..lane, in every warp.
template <class T>
__device__ __forceinline__ T warps_incl_min(const T* agg, int lane, int nw) {
  T y = lane < nw ? agg[lane] : vtop<T>();
  for (int d = 1; d < nw; d <<= 1) y = vmin(y, __shfl_up_sync(FULL, y, d));
  return y;
}

// Row 0 at column j >= 1: global M = L = -inf, U = o + e*j; local zeros;
// fit M = U = 0, L = -inf; J = -inf. Returns D, its argmax in `a`.
template <int MODE, bool JUMP, class T>
__device__ __forceinline__ T row0(int j, T o, T e, T& m, T& l, int& a) {
  m = MODE == GLOBAL ? (T)NEG : (T)0;
  l = MODE == LOCAL ? (T)0 : (T)NEG;
  return lmuj_max<JUMP, T>(l, m, MODE == GLOBAL ? o + e * (T)j : (T)0, (T)NEG, a);
}

// global / local / fit (JUMP: fit's junction-gated J state, entry allowed
// where allow > 0 — the reference's inverted enum-bool quirk). PTRS false:
// the score-only instance (ops/pallas_scan.py:328 _affine_kernel, :513
// _fit_kernel), with no pointer bits, no argmax of D and no stores; its
// rows stop at m, local's score is the latched maximum, global's D(m, n),
// fit's the maximum of M and L on row m over columns <= n-1.
template <int MODE, bool JUMP, int W, bool PTRS = true, class T = float>
__global__ void __launch_bounds__(kMaxThreads)
ptr_affine_kernel(const int* __restrict__ qs, const int* __restrict__ ts,
                  const float* __restrict__ allow, const int* __restrict__ ns,
                  const int* __restrict__ ms, const T* __restrict__ params,
                  T* __restrict__ score_out, int* __restrict__ a_out,
                  int* __restrict__ b_out, uint8_t* __restrict__ ptrs, int m_pad, int n_pad,
                  int rpb) {
  constexpr int NC = JUMP ? 2 : 1;  // in-row chains: U, fit's J
  constexpr T NG = (T)NEG;
  // by row parity: each warp's aggregate, its aggregate without the warp's
  // last column, and that column's M and L
  __shared__ T s_agg[2][NC][32], s_wo[2][NC][32], s_m[2][32], s_l[2][32];
  __shared__ Cand<T> s_red[2][32];
  __shared__ T s_max[32];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int n = min(max(ns[b], 0), n_pad), m = min(max(ms[b], 0), m_pad);
  const int j0 = 1 + tid * W;
  const bool active = tid * W < n_pad;
  const T match = params[0], mis = params[1], o = params[2], e = params[3];
  const T jp = params[4];
  const int k_home = rpb > 1 ? 3 : 4, k_unset = rpb > 1 ? 3 : 7;
  const int lbit = rpb > 1 ? 1 << 2 : 1 << 3, ubit = rpb > 1 ? 1 << 3 : 1 << 4;
  const int bits = 8 / rpb;
  const int* q = qs + (size_t)b * m_pad;
  uint8_t* out = PTRS ? ptrs + (size_t)b * (m_pad / rpb) * n_pad + (size_t)tid * W : nullptr;

  int tc[W];
  load_chars<W>(ts + (size_t)b * n_pad + (size_t)tid * W, active, tc);
  T c[W];  // o - e*(j+1): the U chain's term offset of column j
#pragma unroll
  for (int k = 0; k < W; ++k) c[k] = o - e * (T)(j0 + k + 1);
  const T ej0 = e * (T)j0;
  // JUMP: bit k where J may be entered into column j0+k+1; into column j0
  uint32_t gate = 0;
  bool gate0 = false;
  if (JUMP && active) {
    const float* al = allow + (size_t)b * n_pad;
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (j0 + k < n_pad && al[j0 + k] > 0.f) gate |= 1u << k;
    gate0 = tid > 0 && al[j0 - 1] > 0.f;
  }
  // row 0; lane 0 of a later warp also needs its left column's D
  T M[W], L[W], D[W];
  uint32_t A = 0;  // argmax of D, two bits a column
#pragma unroll
  for (int k = 0; k < W; ++k) {
    int a;
    D[k] = row0<MODE, JUMP, T>(j0 + k, o, e, M[k], L[k], a);
    if (PTRS) A |= (uint32_t)a << (2 * k);
  }
  T eD, m_left, l_left;
  int eA;
  eD = row0<MODE, JUMP, T>(max(j0 - 1, 1), o, e, m_left, l_left, eA);
  // the U chain's seed: U(i, 0) folded in, local max(0 + o - e, 0)
  const T useed = MODE == LOCAL ? vmax((T)0 + (o - e * (T)1), (T)0) : NG;
  const T mborder = MODE == LOCAL ? (T)0 : NG;  // M(i, 0)
  const int kn = n - j0 + 1;                        // the strip's columns j <= n
  // start info: local's latch; fit's row-m M and L; global's (m, n)
  Cand<T> lat = {NG, 0, 0}, cm = {NG, 0, BIG}, cl = {NG, 0, BIG};
  T g_s = NG;
  int g_a = 0;
  bool g_set = false;
  uint32_t acc[W / 4];
  // every pointer row; the scores stop at m
  const int rows = PTRS ? m_pad : m;
  int qn = rows > 0 ? q[0] : 0;
  for (int i = 1; i <= rows; ++i) {
    const int p = i & 1, sub_row = (i - 1) % rpb, shift = sub_row * bits;
    const int qc = qn;
    if (i < rows) qn = q[i];
    if (PTRS && sub_row == 0) {
#pragma unroll
      for (int w = 0; w < W / 4; ++w) acc[w] = 0;
    }
    // row i-1 at column j0-1: lane l-1's last column, the border, or the
    // left column lane 0 built after row i-1's barrier
    T dD = __shfl_up_sync(FULL, D[W - 1], 1);
    int dA = (int)(__shfl_up_sync(FULL, A, 1) >> (2 * (W - 1))) & 3;
    if (lane == 0) {
      if (tid == 0) {
        T l, mm, u;
        if (MODE == GLOBAL) {
          l = o + e * ((T)i - (T)1);
          mm = i == 1 ? (T)0 : NG;
          u = i == 1 ? o : NG;
        } else if (MODE == LOCAL) {
          l = mm = u = (T)0;
        } else {
          l = NG;
          mm = u = i == 1 ? (T)0 : NG;
        }
        dD = lmuj_max<JUMP, T>(l, mm, u, NG, dA);
        // the score fill's border at (0, 0) is 0 whatever the sign of o
        if (!PTRS && MODE == GLOBAL && i == 1) dD = (T)0;
      } else {
        dD = eD;
        dA = eA;
      }
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
      dA = (int)(A >> (2 * k)) & 3;
      const T la = L[k] + e, lb = M[k] + o;
      L[k] = vmax(la, lb);
      M[k] = best;
      if (PTRS) acc[k >> 2] |= (uint32_t)(pm | (la >= lb ? 0 : lbit)) << (8 * (k & 3) + shift);
      if (k == W - 1) {
        vu_wo = vu;
        vj_wo = vj;
      }
      vu = vmax(vu, best + c[k]);
      if (JUMP) vj = vmax(vj, (gate >> k & 1) ? best + jp : NG);
      if (MODE == LOCAL) rmax = vmax(rmax, best);
    }
    if (MODE == LOCAL && i <= m) {
      // the strict row-major first occurrence of the strip's maximum
      if (kn < W) {  // the strip holds column n, or lies past it
        rmax = NG;
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (k < kn) rmax = vmax(rmax, M[k]);
      }
      if (!PTRS) {
        lat.v = vmax(lat.v, rmax);  // the score alone
      } else if (rmax > lat.v) {
        int fj = BIG;
#pragma unroll
        for (int k = W - 1; k >= 0; --k)
          if (k < kn && M[k] == rmax) fj = j0 + k;
        lat = {rmax, i, fj};
      }
    }
    if (MODE == FIT && i == m) {  // the bottom row over columns <= n-1
      if (PTRS) {
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
      s_agg[p][0][warp] = in_u;
      s_wo[p][0][warp] = vmax(below_u, vu_wo);
      if (JUMP) {
        s_agg[p][NC - 1][warp] = in_j;
        s_wo[p][NC - 1][warp] = vmax(below_j, vj_wo);
      }
      s_m[p][warp] = M[W - 1];
      s_l[p][warp] = L[W - 1];
    }
    __syncthreads();  // the row's one barrier
    // the exclusive prefixes: U's over columns < j0 (terms up to j0), J's
    // likewise (J(i, j0)); lane 0's left column's, without warp w-1's last
    const T yu = warps_incl_max(s_agg[p][0], lane, nw);
    const T pu = __shfl_sync(FULL, yu, max(warp - 1, 0));
    const T pu2 = __shfl_sync(FULL, yu, max(warp - 2, 0));
    T run_u = vmax(useed, warp > 0 ? pu : NG);
    if (lane > 0) run_u = vmax(run_u, below_u);
    T run_j = NG, pj2 = NG;
    if (JUMP) {
      const T yj = warps_incl_max(s_agg[p][NC - 1], lane, nw);
      const T pj = __shfl_sync(FULL, yj, max(warp - 1, 0));
      pj2 = __shfl_sync(FULL, yj, max(warp - 2, 0));
      run_j = warp > 0 ? pj : NG;
      if (lane > 0) run_j = vmax(run_j, below_j);
    }
    T mprev = __shfl_up_sync(FULL, M[W - 1], 1);  // M(i, j0-1)
    if (lane == 0) {
      if (tid == 0) {
        mprev = mborder;
      } else {
        // row i at column j0-1, the next row's diagonal
        mprev = s_m[p][warp - 1];
        const T uq = vmax(vmax(useed, warp > 1 ? pu2 : NG), s_wo[p][0][warp - 1]);
        const T jl = JUMP ? vmax(warp > 1 ? pj2 : NG, s_wo[p][NC - 1][warp - 1]) : NG;
        eD = lmuj_max<JUMP, T>(s_l[p][warp - 1], mprev, uq + e * (T)(j0 - 1), jl, eA);
      }
    }
    // pass 2: U and J, their bits, D and its argmax
    T jcv = JUMP && gate0 ? mprev + jp : NG;  // J's entry into column j
    uint32_t an = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const T uv = run_u + (k == 0 ? ej0 : o - c[k > 0 ? k - 1 : 0]);  // + e*j
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
      if (PTRS) an |= (uint32_t)a << (2 * k);
      run_u = vmax(run_u, M[k] + c[k]);
      mprev = M[k];
    }
    A = an;
    if (MODE == GLOBAL && i == m && kn >= 1 && kn <= W) {
      // (m, n): the start state is D's argmax at column n
#pragma unroll
      for (int k = 0; k < W; ++k)
        if (k == kn - 1) {
          g_s = D[k];
          g_a = (int)(A >> (2 * k)) & 3;
        }
      g_set = true;
    }
    if (PTRS && sub_row == rpb - 1 && active)
      store_strip<W>(out + (size_t)((i - 1) / rpb) * n_pad, acc);
  }
  // start info, reduced once
  if (!PTRS) {
    if (MODE == GLOBAL) {
      if (g_set)
        score_out[b] = g_s;
      else if (tid == 0 && (m == 0 || n == 0))
        score_out[b] = NG;
    } else {
      // local's + 0 turns a -0 into +0 (the score is printed with %f);
      // fit's score is -inf where row m holds no column <= n-1, m = 0 too
      const T r = block_max(lat.v, s_max);
      if (tid == 0) score_out[b] = MODE == LOCAL ? r + (T)0 : r;
    }
  } else if (MODE == GLOBAL) {
    if (g_set) {
      score_out[b] = g_s;
      a_out[b] = g_a;
      b_out[b] = 0;
    } else if (tid == 0 && (m == 0 || n == 0)) {
      score_out[b] = NG;
      a_out[b] = 0;
      b_out[b] = 0;
    }
  } else if (MODE == LOCAL) {
    const Cand<T> r = block_best(lat, s_red[0]);
    if (tid == 0) {
      score_out[b] = r.v;
      a_out[b] = r.i;
      b_out[b] = r.j;
    }
  } else {
    // fit: L wins only when strictly greater
    const Cand<T> rm = block_best(cm, s_red[0]), rl = block_best(cl, s_red[1]);
    if (tid == 0) {
      const bool use_l = rl.v > rm.v;
      score_out[b] = m > 0 ? vmax(rm.v, rl.v) : NG;
      a_out[b] = m > 0 && use_l ? 1 : 0;
      b_out[b] = m > 0 ? (use_l ? rl.j : rm.j) : 0;
    }
  }
}

// overlap: one matrix, linear gap o; codes LEFT/DIAG/RIGHT = 0/1/2, 3 where
// the cell is -inf (alignment.h:944's argument order). PTRS false: the
// score-only instance (ops/pallas_scan.py:421 _overlap_kernel), with no
// codes and no stores; its rows stop at m, its score max(row m's maximum
// over columns <= n-1, 0), 0 where m = 0.
template <int W, bool PTRS = true, class T = float>
__global__ void __launch_bounds__(kMaxThreads)
ptr_overlap_kernel(const int* __restrict__ qs, const int* __restrict__ ts,
                   const int* __restrict__ ns, const int* __restrict__ ms,
                   const T* __restrict__ params, T* __restrict__ score_out,
                   int* __restrict__ a_out, int* __restrict__ b_out, uint8_t* __restrict__ ptrs,
                   int m_pad, int n_pad, int rpb) {
  constexpr T NG = (T)NEG;
  __shared__ T s_agg[2][32], s_max[32];
  __shared__ Cand<T> s_red[32];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int n = min(max(ns[b], 0), n_pad), m = min(max(ms[b], 0), m_pad);
  const int j0 = 1 + tid * W;
  const bool active = tid * W < n_pad;
  const T match = params[0], mis = params[1], o = params[2];
  const int bits = 8 / rpb;
  const int* q = qs + (size_t)b * m_pad;
  uint8_t* out = PTRS ? ptrs + (size_t)b * (m_pad / rpb) * n_pad + (size_t)tid * W : nullptr;
  int tc[W];
  load_chars<W>(ts + (size_t)b * n_pad + (size_t)tid * W, active, tc);
  T M[W], oj[W];  // M of the previous row; o*j
#pragma unroll
  for (int k = 0; k < W; ++k) {
    M[k] = NG;  // row 0 is -inf past column 0
    oj[k] = o * (T)(j0 + k);
  }
  const T oj_left = o * (T)(j0 - 1);
  T mleft = j0 == 1 ? (T)0 : NG;  // M(i-1, j0-1); the column-0 border is 0
  Cand<T> best = {NG, 0, BIG};          // row m's first maximum over j <= n-1
  uint32_t acc[W / 4];
  // every pointer row; the score stops at m
  const int rows = PTRS ? m_pad : m;
  int qn = PTRS || m > 0 ? q[0] : 0;
  for (int i = 1; i <= rows; ++i) {
    const int p = i & 1, sub_row = (i - 1) % rpb, shift = sub_row * bits;
    const int qc = qn;
    if (i < rows) qn = q[i];
    if (PTRS && sub_row == 0) {
#pragma unroll
      for (int w = 0; w < W / 4; ++w) acc[w] = 0;
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
    if (lane == 31) s_agg[p][warp] = in;
    __syncthreads();  // the row's one barrier
    const T y = warps_incl_max(s_agg[p], lane, nw);
    const T pw = __shfl_sync(FULL, y, max(warp - 1, 0));
    T run = vmax((T)0, warp > 0 ? pw : NG);  // M(i, 0) = 0 seeds the chain
    if (lane > 0) run = vmax(run, below);
    // pass 2: M(i, j) and the codes; M(i, j0-1) is run + o*(j0-1)
    T mprev = run + oj_left;
    mleft = mprev;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (PTRS) {
        const T left = mprev + o;
        const T val = vmax(left, dr[k]);
        int code = left >= val ? 0 : ((diag_wins >> k & 1) ? 1 : 2);
        if (!(val > NG)) code = 3;
        acc[k >> 2] |= (uint32_t)code << (8 * (k & 3) + shift);
      }
      run = vmax(run, dr[k] - oj[k]);
      M[k] = run + oj[k];
      mprev = M[k];
    }
    if (PTRS && i == m)  // the bottom row over j <= n-1
      first_max<W, T>(M, n - j0, j0, best);
    if (PTRS && sub_row == rpb - 1 && active)
      store_strip<W>(out + (size_t)((i - 1) / rpb) * n_pad, acc);
  }
  if (!PTRS) {
    // the rows stopped at m, so M holds row m (row 0's -inf at m = 0): its
    // maximum over j <= n-1. n is read only here (the n above is the
    // pointer fill's), so that no value of the score stays live across the
    // rows: with one, ptxas held the instance to 64 registers by spilling
    // a value that it reloaded every row
    const int kn = min(max(ns[b], 0), n_pad) - j0;
    T top = NG;
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (k < kn) top = vmax(top, M[k]);
    // the j = 0 border's 0, m = 0 too; + 0 turns a -0 into +0
    const T r = block_max(top, s_max);
    if (tid == 0) score_out[b] = vmax(r, (T)0) + (T)0;
    return;
  }
  // the j = 0 zero candidate wins ties
  const Cand<T> r = block_best(best, s_red);
  if (tid == 0) {
    score_out[b] = m > 0 ? vmax(r.v, (T)0) : NG;
    a_out[b] = m > 0 && r.v > (T)0 ? r.j : 0;
    b_out[b] = 0;
  }
}

// edit distance (alignment.h:291-315), score only (ops/pallas_scan.py:469
// _edit_kernel): min-plus in int32, indel cost 1, substitution cost 0 or
// u = (int)params[1]. M(i, j) = min(c(j), M(i, j-1) + 1) with c(j) =
// min(M(i-1, j-1) + sub, M(i-1, j) + 1), so M(i, j) - j is the running
// minimum of c - j over the row, seeded by M(i, 0) - 0 = i. Pass 1 leaves
// the strip's running minimum of c - j in place of M (one dependent min a
// column); the warp scan, the row's one barrier and the warps' scan give
// the exclusive prefix from the left; pass 2 is one min and one add a
// column, independent of each other. The diagonal across the strip's left
// edge, M(i-1, j0-1), is the prefix plus j0-1 (i-1 for thread 0). The rows
// stop at m; the thread that owns column n writes M(m, n), 0 at m = 0 (the
// Pallas kernel's latch), and thread 0 writes INT_MAX at n = 0. T double
// (P double: the params row in double) is the instance for pairs past
// float32's exact range: the same function in double, u = params[1], +inf
// in place of INT_MAX.
template <int W, class T = int, class P = float>
__global__ void __launch_bounds__(kEditMaxThreads)
edit_score_kernel(const int* __restrict__ qs, const int* __restrict__ ts,
                  const int* __restrict__ ns, const int* __restrict__ ms,
                  const P* __restrict__ params, T* __restrict__ score_out, int m_pad,
                  int n_pad) {
  __shared__ T s_agg[2][32];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int m = min(max(ms[b], 0), m_pad);
  const int j0 = 1 + tid * W;
  const T u = (T)params[1];
  const int* q = qs + (size_t)b * m_pad;
  int tc[W];
  load_chars<W>(ts + (size_t)b * n_pad + (size_t)tid * W, tid * W < n_pad, tc);
  T M[W];  // the previous row's M; between the passes, the running minimum
#pragma unroll
  for (int k = 0; k < W; ++k) M[k] = (T)(j0 + k);  // M(0, j) = j
  T mleft = (T)(j0 - 1);                           // M(i-1, j0-1)
  int qn = m > 0 ? q[0] : 0;
  for (int i = 1; i <= m; ++i) {
    const int p = i & 1, qc = qn;
    if (i < m) qn = q[i];
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
    if (lane == 31) s_agg[p][warp] = in;
    __syncthreads();  // the row's one barrier
    const T y = warps_incl_min(s_agg[p], lane, nw);
    const T pw = __shfl_sync(FULL, y, max(warp - 1, 0));
    T pre = vmin((T)i, warp > 0 ? pw : vtop<T>());  // M(i, 0) - 0 = i seeds the chain
    if (lane > 0) pre = vmin(pre, below);
    // pass 2: M(i, j) = min(the prefix, the strip's running minimum) + j
    mleft = pre + (T)(j0 - 1);
#pragma unroll
    for (int k = 0; k < W; ++k) M[k] = vmin(pre, M[k]) + (T)(j0 + k);
  }
  // n is read only here, so that no value of the result stays live across
  // the rows
  const int n = min(max(ns[b], 0), n_pad), kn = n - j0 + 1;
  if (n == 0 && tid == 0) score_out[b] = vtop<T>();
  if (kn >= 1 && kn <= W) {
    T r = 0;  // M(0, n)'s latch value, the result at m = 0
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (m > 0 && k == kn - 1) r = M[k];
    score_out[b] = r;
  }
}

template <int W, bool PTRS, class T>
void launch_width(int mode, bool jump, int B, int threads, cudaStream_t stream, const int* qs,
                  const int* ts, const float* allow, const int* ns, const int* ms,
                  const T* params, T* score, int* a, int* b, uint8_t* ptrs, int m_pad,
                  int n_pad, int rpb) {
  if (mode == OVERLAP)
    ptr_overlap_kernel<W, PTRS, T><<<B, threads, 0, stream>>>(qs, ts, ns, ms, params, score, a,
                                                              b, ptrs, m_pad, n_pad, rpb);
  else if (mode == GLOBAL)
    ptr_affine_kernel<GLOBAL, false, W, PTRS, T><<<B, threads, 0, stream>>>(
        qs, ts, allow, ns, ms, params, score, a, b, ptrs, m_pad, n_pad, rpb);
  else if (mode == LOCAL)
    ptr_affine_kernel<LOCAL, false, W, PTRS, T><<<B, threads, 0, stream>>>(
        qs, ts, allow, ns, ms, params, score, a, b, ptrs, m_pad, n_pad, rpb);
  else if (jump)
    ptr_affine_kernel<FIT, true, W, PTRS, T><<<B, threads, 0, stream>>>(
        qs, ts, allow, ns, ms, params, score, a, b, ptrs, m_pad, n_pad, rpb);
  else
    ptr_affine_kernel<FIT, false, W, PTRS, T><<<B, threads, 0, stream>>>(
        qs, ts, allow, ns, ms, params, score, a, b, ptrs, m_pad, n_pad, rpb);
}

// The launch shapes the entries take: `width` the strip width W (kWidth 16
// for float32 and int32, kWidth64 8 for the double instances, passed as
// `want`), `threads` a multiple of 32 up to 512 (1,024 for edit), threads *
// W >= n_pad, n_pad a multiple of 16; and the mode 0 global, 1 local, 2
// fit, 3 overlap, 4 edit, with the jump only for fit.
bool bad_launch(int mode, int use_jump, int B, int n_pad, int threads, int width,
                int want = kWidth) {
  const int most = mode == EDIT ? kEditMaxThreads : kMaxThreads;
  return width != want || B < 0 || threads < 32 || threads > most || threads % 32 != 0 ||
         (long long)threads * width < n_pad || n_pad <= 0 || n_pad % 16 != 0 || mode < GLOBAL ||
         mode > EDIT || (use_jump && mode != FIT);
}

bool bad_ptr_layout(int mode, int use_jump, int rpb, int m_pad) {
  return mode == EDIT || (rpb != 1 && rpb != 2 && rpb != 4) || m_pad <= 0 || m_pad % rpb != 0 ||
         (rpb > 1 && use_jump) || (rpb == 4 && mode != OVERLAP);
}

}  // namespace

// C entry point of the score fills (global, local, fit(+jump), overlap,
// edit), bound with ctypes: launches the mode's score-only instance on
// `stream` without synchronising and returns the launch's error code.
// `score` is (B,) float32, int32 for edit; `allow` is read with the jump
// alone; ts 16-byte aligned.
extern "C" cudaError_t at_score_fill(int mode, int use_jump, const int* qs, const int* ts,
                                     const float* allow, const int* ns, const int* ms,
                                     const float* params, void* score, int B, int m_pad,
                                     int n_pad, int threads, int width, cudaStream_t stream) {
  if (bad_launch(mode, use_jump, B, n_pad, threads, width) || m_pad < 0)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  if (mode == EDIT)
    edit_score_kernel<kWidth><<<B, threads, 0, stream>>>(qs, ts, ns, ms, params,
                                                         static_cast<int*>(score), m_pad, n_pad);
  else
    launch_width<kWidth, false, float>(mode, use_jump != 0, B, threads, stream, qs, ts, allow,
                                       ns, ms, params, static_cast<float*>(score), nullptr,
                                       nullptr, nullptr, m_pad, n_pad, 1);
  return cudaGetLastError();
}

// The double instance of edit's score fill (for a pair past float32's exact
// range): `params` the (1, 8) float64 row, `score` (B,) float64; the launch
// shapes of bad_launch at width kWidth64.
extern "C" cudaError_t at_edit_fill64(const int* qs, const int* ts, const int* ns, const int* ms,
                                      const double* params, double* score, int B, int m_pad,
                                      int n_pad, int threads, int width, cudaStream_t stream) {
  if (bad_launch(EDIT, 0, B, n_pad, threads, width, kWidth64) || m_pad < 0)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  edit_score_kernel<kWidth64, double, double><<<B, threads, 0, stream>>>(qs, ts, ns, ms, params,
                                                                        score, m_pad, n_pad);
  return cudaGetLastError();
}

// C entry point of the pointer fill, bound with ctypes: launches one fill
// on `stream` without synchronising and returns the launch's error code;
// the launch shapes of bad_launch, rpb 1, 2 or 4 (4 overlap's alone, the
// jump at rpb 1); ts and ptrs 16-byte aligned.
extern "C" cudaError_t at_ptr_fill(int mode, int use_jump, int rpb, const int* qs,
                                   const int* ts, const float* allow, const int* ns,
                                   const int* ms, const float* params, float* score, int* a,
                                   int* b, uint8_t* ptrs, int B, int m_pad, int n_pad,
                                   int threads, int width, cudaStream_t stream) {
  if (bad_launch(mode, use_jump, B, n_pad, threads, width) ||
      bad_ptr_layout(mode, use_jump, rpb, m_pad))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  launch_width<kWidth, true, float>(mode, use_jump != 0, B, threads, stream, qs, ts, allow, ns,
                                    ms, params, score, a, b, ptrs, m_pad, n_pad, rpb);
  return cudaGetLastError();
}

// The double instances of the pointer fill (for a pair past float32's exact
// range): at_ptr_fill's arguments with `params` the (1, 8) float64 row and
// `score` (B,) float64, at width kWidth64; the pointer bytes and a, b are
// laid out as at_ptr_fill's.
extern "C" cudaError_t at_ptr_fill64(int mode, int use_jump, int rpb, const int* qs,
                                     const int* ts, const float* allow, const int* ns,
                                     const int* ms, const double* params, double* score, int* a,
                                     int* b, uint8_t* ptrs, int B, int m_pad, int n_pad,
                                     int threads, int width, cudaStream_t stream) {
  if (bad_launch(mode, use_jump, B, n_pad, threads, width, kWidth64) ||
      bad_ptr_layout(mode, use_jump, rpb, m_pad))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  launch_width<kWidth64, true, double>(mode, use_jump != 0, B, threads, stream, qs, ts, allow,
                                       ns, ms, params, score, a, b, ptrs, m_pad, n_pad, rpb);
  return cudaGetLastError();
}
