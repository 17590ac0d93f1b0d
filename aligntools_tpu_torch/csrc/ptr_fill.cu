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

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -INFINITY;
constexpr int BIG = 1 << 30;
constexpr int GLOBAL = 0, LOCAL = 1, FIT = 2, OVERLAP = 3;
constexpr int EDIT = 4;  // a score fill alone: the pointer fill has no edit
constexpr unsigned FULL = 0xffffffffu;

// The strip width the kernels are instantiated at, and the most threads a
// CTA runs, which sets the registers ptxas may give a thread (65,536 / 512).
constexpr int kWidth = 16;
constexpr int kMaxThreads = 512;
// the edit score fill's most threads (65,536 / 1,024 = 64 registers)
constexpr int kEditMaxThreads = 1024;

// A start-info candidate: the value, its row and its column.
struct Cand {
  float v;
  int i, j;
};

// x before y: the larger value, then the smaller row, then the smaller column
__device__ __forceinline__ bool before(const Cand& x, const Cand& y) {
  return x.v > y.v || (x.v == y.v && (x.i < y.i || (x.i == y.i && x.j < y.j)));
}

// The CTA's first candidate by `before`, in every thread; two barriers.
__device__ Cand block_best(Cand c, Cand (&red)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const Cand y = {__shfl_xor_sync(FULL, c.v, d), __shfl_xor_sync(FULL, c.i, d),
                    __shfl_xor_sync(FULL, c.j, d)};
    if (before(y, c)) c = y;
  }
  if (lane == 0) red[warp] = c;
  __syncthreads();
  Cand r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    if (before(red[w], r)) r = red[w];
  __syncthreads();
  return r;
}

// The CTA's maximum of x, in every thread; two barriers.
__device__ __forceinline__ float block_max(float x, float (&red)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, d));
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

// Keep the strip's first maximum of one row over its first `kn` columns
// (columns <= n-1 of row m for fit and overlap): the first column holds the
// candidate even at -inf, as the plain version's first-equal search does.
template <int W>
__device__ __forceinline__ void first_max(const float (&x)[W], int kn, int j0, Cand& c) {
#pragma unroll
  for (int k = 0; k < W; ++k)
    if (k < kn && (x[k] > c.v || c.j == BIG)) c = {x[k], 0, j0 + k};
}

// Inclusive max over the warp's lanes (lanes below d read their own value).
__device__ __forceinline__ float warp_incl_max(float x) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) x = fmaxf(x, __shfl_up_sync(FULL, x, d));
  return x;
}

// Inclusive max over the aggregates of warps 0..lane, in every warp.
__device__ __forceinline__ float warps_incl_max(const float* agg, int lane, int nw) {
  float y = lane < nw ? agg[lane] : NEG;
  for (int d = 1; d < nw; d <<= 1) y = fmaxf(y, __shfl_up_sync(FULL, y, d));
  return y;
}

// Inclusive min over the warp's lanes (lanes below d read their own value).
__device__ __forceinline__ int warp_incl_min(int x) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) x = min(x, __shfl_up_sync(FULL, x, d));
  return x;
}

// Inclusive min over the aggregates of warps 0..lane, in every warp.
__device__ __forceinline__ int warps_incl_min(const int* agg, int lane, int nw) {
  int y = lane < nw ? agg[lane] : INT_MAX;
  for (int d = 1; d < nw; d <<= 1) y = min(y, __shfl_up_sync(FULL, y, d));
  return y;
}

// D = max(L, M, U[, J]) and its earliest-argument strict argmax: the first
// of the states that holds the maximum (LOW, MID, UPP, JUMP = 0..3).
template <bool JUMP>
__device__ __forceinline__ float lmuj_max(float l, float m, float u, float j, int& a) {
  float d = l;
  a = 0;
  if (m > d) a = 1;
  d = fmaxf(d, m);
  if (u > d) a = 2;
  d = fmaxf(d, u);
  if (JUMP) {
    if (j > d) a = 3;
    d = fmaxf(d, j);
  }
  return d;
}

// Row 0 at column j >= 1: global M = L = -inf, U = o + e*j; local zeros;
// fit M = U = 0, L = -inf; J = -inf. Returns D, its argmax in `a`.
template <int MODE, bool JUMP>
__device__ __forceinline__ float row0(int j, float o, float e, float& m, float& l, int& a) {
  m = MODE == GLOBAL ? NEG : 0.f;
  l = MODE == LOCAL ? 0.f : NEG;
  return lmuj_max<JUMP>(l, m, MODE == GLOBAL ? o + e * (float)j : 0.f, NEG, a);
}

// Store a strip's packed byte-row of W bytes as 16-byte words.
template <int W>
__device__ __forceinline__ void store_strip(uint8_t* dst, const uint32_t (&acc)[W / 4]) {
  static_assert(W % 16 == 0, "a strip is stored as whole 16-byte words");
#pragma unroll
  for (int w = 0; w < W / 4; w += 4)
    reinterpret_cast<uint4*>(dst)[w / 4] = make_uint4(acc[w], acc[w + 1], acc[w + 2], acc[w + 3]);
}

// The strip's W target chars (0 for a thread past n_pad, whose columns are
// never stored or latched).
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

// global / local / fit (JUMP: fit's junction-gated J state, entry allowed
// where allow > 0 — the reference's inverted enum-bool quirk). PTRS false:
// the score-only instance (ops/pallas_scan.py:328 _affine_kernel, :513
// _fit_kernel), with no pointer bits, no argmax of D and no stores; its
// rows stop at m, local's score is the latched maximum, global's D(m, n),
// fit's the maximum of M and L on row m over columns <= n-1.
template <int MODE, bool JUMP, int W, bool PTRS = true>
__global__ void __launch_bounds__(kMaxThreads)
ptr_affine_kernel(const int* __restrict__ qs, const int* __restrict__ ts,
                  const float* __restrict__ allow, const int* __restrict__ ns,
                  const int* __restrict__ ms, const float* __restrict__ params,
                  float* __restrict__ score_out, int* __restrict__ a_out,
                  int* __restrict__ b_out, uint8_t* __restrict__ ptrs, int m_pad, int n_pad,
                  int rpb) {
  constexpr int NC = JUMP ? 2 : 1;  // in-row chains: U, fit's J
  // by row parity: each warp's aggregate, its aggregate without the warp's
  // last column, and that column's M and L
  __shared__ float s_agg[2][NC][32], s_wo[2][NC][32], s_m[2][32], s_l[2][32];
  __shared__ Cand s_red[2][32];
  __shared__ float s_max[32];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int n = min(max(ns[b], 0), n_pad), m = min(max(ms[b], 0), m_pad);
  const int j0 = 1 + tid * W;
  const bool active = tid * W < n_pad;
  const float match = params[0], mis = params[1], o = params[2], e = params[3];
  const float jp = params[4];
  const int k_home = rpb > 1 ? 3 : 4, k_unset = rpb > 1 ? 3 : 7;
  const int lbit = rpb > 1 ? 1 << 2 : 1 << 3, ubit = rpb > 1 ? 1 << 3 : 1 << 4;
  const int bits = 8 / rpb;
  const int* q = qs + (size_t)b * m_pad;
  uint8_t* out = PTRS ? ptrs + (size_t)b * (m_pad / rpb) * n_pad + (size_t)tid * W : nullptr;

  int tc[W];
  load_chars<W>(ts + (size_t)b * n_pad + (size_t)tid * W, active, tc);
  float c[W];  // o - e*(j+1): the U chain's term offset of column j
#pragma unroll
  for (int k = 0; k < W; ++k) c[k] = o - e * (float)(j0 + k + 1);
  const float ej0 = e * (float)j0;
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
  float M[W], L[W], D[W];
  uint32_t A = 0;  // argmax of D, two bits a column
#pragma unroll
  for (int k = 0; k < W; ++k) {
    int a;
    D[k] = row0<MODE, JUMP>(j0 + k, o, e, M[k], L[k], a);
    if (PTRS) A |= (uint32_t)a << (2 * k);
  }
  float eD, m_left, l_left;
  int eA;
  eD = row0<MODE, JUMP>(max(j0 - 1, 1), o, e, m_left, l_left, eA);
  // the U chain's seed: U(i, 0) folded in, local max(0 + o - e, 0)
  const float useed = MODE == LOCAL ? fmaxf(0.f + (o - e * 1.f), 0.f) : NEG;
  const float mborder = MODE == LOCAL ? 0.f : NEG;  // M(i, 0)
  const int kn = n - j0 + 1;                        // the strip's columns j <= n
  // start info: local's latch; fit's row-m M and L; global's (m, n)
  Cand lat = {NEG, 0, 0}, cm = {NEG, 0, BIG}, cl = {NEG, 0, BIG};
  float g_s = NEG;
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
    float dD = __shfl_up_sync(FULL, D[W - 1], 1);
    int dA = (int)(__shfl_up_sync(FULL, A, 1) >> (2 * (W - 1))) & 3;
    if (lane == 0) {
      if (tid == 0) {
        float l, mm, u;
        if (MODE == GLOBAL) {
          l = o + e * ((float)i - 1.f);
          mm = i == 1 ? 0.f : NEG;
          u = i == 1 ? o : NEG;
        } else if (MODE == LOCAL) {
          l = mm = u = 0.f;
        } else {
          l = NEG;
          mm = u = i == 1 ? 0.f : NEG;
        }
        dD = lmuj_max<JUMP>(l, mm, u, NEG, dA);
        // the score fill's border at (0, 0) is 0 whatever the sign of o
        if (!PTRS && MODE == GLOBAL && i == 1) dD = 0.f;
      } else {
        dD = eD;
        dA = eA;
      }
    }
    // pass 1: M, L and their bits; the strip's chain terms
    float vu = NEG, vu_wo = NEG, vj = NEG, vj_wo = NEG, rmax = NEG;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float sub = tc[k] == qc ? match : mis;
      // earliest-argument strict argmax: L, M, U, J (D's), then HOME
      float best = dD + sub;
      int pm = dA;
      if (MODE == LOCAL) {
        if (0.f > best) pm = k_home;  // the HOME candidate has no +sub
        best = fmaxf(best, 0.f);      // and so is never unset
      } else if (!(best > NEG)) {
        pm = k_unset;
      }
      dD = D[k];
      dA = (int)(A >> (2 * k)) & 3;
      const float la = L[k] + e, lb = M[k] + o;
      L[k] = fmaxf(la, lb);
      M[k] = best;
      if (PTRS) acc[k >> 2] |= (uint32_t)(pm | (la >= lb ? 0 : lbit)) << (8 * (k & 3) + shift);
      if (k == W - 1) {
        vu_wo = vu;
        vj_wo = vj;
      }
      vu = fmaxf(vu, best + c[k]);
      if (JUMP) vj = fmaxf(vj, (gate >> k & 1) ? best + jp : NEG);
      if (MODE == LOCAL) rmax = fmaxf(rmax, best);
    }
    if (MODE == LOCAL && i <= m) {
      // the strict row-major first occurrence of the strip's maximum
      if (kn < W) {  // the strip holds column n, or lies past it
        rmax = NEG;
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (k < kn) rmax = fmaxf(rmax, M[k]);
      }
      if (!PTRS) {
        lat.v = fmaxf(lat.v, rmax);  // the score alone
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
        first_max<W>(M, kn - 1, j0, cm);
        first_max<W>(L, kn - 1, j0, cl);
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (k < kn - 1) lat.v = fmaxf(lat.v, fmaxf(M[k], L[k]));
      }
    }
    // the warps' scans; lane 31 leaves the warp's part in shared memory
    const float in_u = warp_incl_max(vu), below_u = __shfl_up_sync(FULL, in_u, 1);
    float in_j = NEG, below_j = NEG;
    if (JUMP) {
      in_j = warp_incl_max(vj);
      below_j = __shfl_up_sync(FULL, in_j, 1);
    }
    if (lane == 31) {
      s_agg[p][0][warp] = in_u;
      s_wo[p][0][warp] = fmaxf(below_u, vu_wo);
      if (JUMP) {
        s_agg[p][NC - 1][warp] = in_j;
        s_wo[p][NC - 1][warp] = fmaxf(below_j, vj_wo);
      }
      s_m[p][warp] = M[W - 1];
      s_l[p][warp] = L[W - 1];
    }
    __syncthreads();  // the row's one barrier
    // the exclusive prefixes: U's over columns < j0 (terms up to j0), J's
    // likewise (J(i, j0)); lane 0's left column's, without warp w-1's last
    const float yu = warps_incl_max(s_agg[p][0], lane, nw);
    const float pu = __shfl_sync(FULL, yu, max(warp - 1, 0));
    const float pu2 = __shfl_sync(FULL, yu, max(warp - 2, 0));
    float run_u = fmaxf(useed, warp > 0 ? pu : NEG);
    if (lane > 0) run_u = fmaxf(run_u, below_u);
    float run_j = NEG, pj2 = NEG;
    if (JUMP) {
      const float yj = warps_incl_max(s_agg[p][NC - 1], lane, nw);
      const float pj = __shfl_sync(FULL, yj, max(warp - 1, 0));
      pj2 = __shfl_sync(FULL, yj, max(warp - 2, 0));
      run_j = warp > 0 ? pj : NEG;
      if (lane > 0) run_j = fmaxf(run_j, below_j);
    }
    float mprev = __shfl_up_sync(FULL, M[W - 1], 1);  // M(i, j0-1)
    if (lane == 0) {
      if (tid == 0) {
        mprev = mborder;
      } else {
        // row i at column j0-1, the next row's diagonal
        mprev = s_m[p][warp - 1];
        const float uq = fmaxf(fmaxf(useed, warp > 1 ? pu2 : NEG), s_wo[p][0][warp - 1]);
        const float jl = JUMP ? fmaxf(warp > 1 ? pj2 : NEG, s_wo[p][NC - 1][warp - 1]) : NEG;
        eD = lmuj_max<JUMP>(s_l[p][warp - 1], mprev, uq + e * (float)(j0 - 1), jl, eA);
      }
    }
    // pass 2: U and J, their bits, D and its argmax
    float jcv = JUMP && gate0 ? mprev + jp : NEG;  // J's entry into column j
    uint32_t an = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float uv = run_u + (k == 0 ? ej0 : o - c[k > 0 ? k - 1 : 0]);  // + e*j
      const float ua = mprev + o;
      // U(i,j) = max(ua, U(i,j-1) + e), so ua >= U(i,j-1) + e iff ua >= U(i,j)
      int code = ua >= uv ? 0 : ubit;
      float jv = NEG;
      if (JUMP) {
        // J(i,j) = max(J(i,j-1), jcv): jcv >= J(i,j-1) iff jcv >= J(i,j)
        code |= (jcv > NEG && jcv >= run_j) ? 0 : 1 << 5;
        jv = run_j;
        jcv = (gate >> k & 1) ? M[k] + jp : NEG;
        run_j = fmaxf(run_j, jcv);
      }
      if (PTRS) acc[k >> 2] |= (uint32_t)code << (8 * (k & 3) + shift);
      int a;
      D[k] = lmuj_max<JUMP>(L[k], M[k], uv, jv, a);
      if (PTRS) an |= (uint32_t)a << (2 * k);
      run_u = fmaxf(run_u, M[k] + c[k]);
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
        score_out[b] = NEG;
    } else {
      // local's + 0.f turns a -0 into +0 (the score is printed with %f);
      // fit's score is -inf where row m holds no column <= n-1, m = 0 too
      const float r = block_max(lat.v, s_max);
      if (tid == 0) score_out[b] = MODE == LOCAL ? r + 0.f : r;
    }
  } else if (MODE == GLOBAL) {
    if (g_set) {
      score_out[b] = g_s;
      a_out[b] = g_a;
      b_out[b] = 0;
    } else if (tid == 0 && (m == 0 || n == 0)) {
      score_out[b] = NEG;
      a_out[b] = 0;
      b_out[b] = 0;
    }
  } else if (MODE == LOCAL) {
    const Cand r = block_best(lat, s_red[0]);
    if (tid == 0) {
      score_out[b] = r.v;
      a_out[b] = r.i;
      b_out[b] = r.j;
    }
  } else {
    // fit: L wins only when strictly greater
    const Cand rm = block_best(cm, s_red[0]), rl = block_best(cl, s_red[1]);
    if (tid == 0) {
      const bool use_l = rl.v > rm.v;
      score_out[b] = m > 0 ? fmaxf(rm.v, rl.v) : NEG;
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
template <int W, bool PTRS = true>
__global__ void __launch_bounds__(kMaxThreads)
ptr_overlap_kernel(const int* __restrict__ qs, const int* __restrict__ ts,
                   const int* __restrict__ ns, const int* __restrict__ ms,
                   const float* __restrict__ params, float* __restrict__ score_out,
                   int* __restrict__ a_out, int* __restrict__ b_out, uint8_t* __restrict__ ptrs,
                   int m_pad, int n_pad, int rpb) {
  __shared__ float s_agg[2][32], s_max[32];
  __shared__ Cand s_red[32];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int n = min(max(ns[b], 0), n_pad), m = min(max(ms[b], 0), m_pad);
  const int j0 = 1 + tid * W;
  const bool active = tid * W < n_pad;
  const float match = params[0], mis = params[1], o = params[2];
  const int bits = 8 / rpb;
  const int* q = qs + (size_t)b * m_pad;
  uint8_t* out = PTRS ? ptrs + (size_t)b * (m_pad / rpb) * n_pad + (size_t)tid * W : nullptr;
  int tc[W];
  load_chars<W>(ts + (size_t)b * n_pad + (size_t)tid * W, active, tc);
  float M[W], oj[W];  // M of the previous row; o*j
#pragma unroll
  for (int k = 0; k < W; ++k) {
    M[k] = NEG;  // row 0 is -inf past column 0
    oj[k] = o * (float)(j0 + k);
  }
  const float oj_left = o * (float)(j0 - 1);
  float mleft = j0 == 1 ? 0.f : NEG;  // M(i-1, j0-1); the column-0 border is 0
  Cand best = {NEG, 0, BIG};          // row m's first maximum over j <= n-1
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
    float dM = mleft, dr[W], v = NEG;
    uint32_t diag_wins = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float sub = tc[k] == qc ? match : mis;
      const float diag = dM + sub, right = M[k] + o;
      dr[k] = fmaxf(diag, right);
      if (PTRS && diag >= right) diag_wins |= 1u << k;
      v = fmaxf(v, dr[k] - oj[k]);
      dM = M[k];
    }
    const float in = warp_incl_max(v), below = __shfl_up_sync(FULL, in, 1);
    if (lane == 31) s_agg[p][warp] = in;
    __syncthreads();  // the row's one barrier
    const float y = warps_incl_max(s_agg[p], lane, nw);
    const float pw = __shfl_sync(FULL, y, max(warp - 1, 0));
    float run = fmaxf(0.f, warp > 0 ? pw : NEG);  // M(i, 0) = 0 seeds the chain
    if (lane > 0) run = fmaxf(run, below);
    // pass 2: M(i, j) and the codes; M(i, j0-1) is run + o*(j0-1)
    float mprev = run + oj_left;
    mleft = mprev;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (PTRS) {
        const float left = mprev + o;
        const float val = fmaxf(left, dr[k]);
        int code = left >= val ? 0 : ((diag_wins >> k & 1) ? 1 : 2);
        if (!(val > NEG)) code = 3;
        acc[k >> 2] |= (uint32_t)code << (8 * (k & 3) + shift);
      }
      run = fmaxf(run, dr[k] - oj[k]);
      M[k] = run + oj[k];
      mprev = M[k];
    }
    if (PTRS && i == m)  // the bottom row over j <= n-1
      first_max<W>(M, n - j0, j0, best);
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
    float top = NEG;
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (k < kn) top = fmaxf(top, M[k]);
    // the j = 0 border's 0, m = 0 too; + 0.f turns a -0 into +0
    const float r = block_max(top, s_max);
    if (tid == 0) score_out[b] = fmaxf(r, 0.f) + 0.f;
    return;
  }
  // the j = 0 zero candidate wins ties
  const Cand r = block_best(best, s_red);
  if (tid == 0) {
    score_out[b] = m > 0 ? fmaxf(r.v, 0.f) : NEG;
    a_out[b] = m > 0 && r.v > 0.f ? r.j : 0;
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
// Pallas kernel's latch), and thread 0 writes INT_MAX at n = 0.
template <int W>
__global__ void __launch_bounds__(kEditMaxThreads)
edit_score_kernel(const int* __restrict__ qs, const int* __restrict__ ts,
                  const int* __restrict__ ns, const int* __restrict__ ms,
                  const float* __restrict__ params, int* __restrict__ score_out, int m_pad,
                  int n_pad) {
  __shared__ int s_agg[2][32];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int m = min(max(ms[b], 0), m_pad);
  const int j0 = 1 + tid * W;
  const int u = (int)params[1];
  const int* q = qs + (size_t)b * m_pad;
  int tc[W];
  load_chars<W>(ts + (size_t)b * n_pad + (size_t)tid * W, tid * W < n_pad, tc);
  int M[W];  // the previous row's M; between the passes, the running minimum
#pragma unroll
  for (int k = 0; k < W; ++k) M[k] = j0 + k;  // M(0, j) = j
  int mleft = j0 - 1;                           // M(i-1, j0-1)
  int qn = m > 0 ? q[0] : 0;
  for (int i = 1; i <= m; ++i) {
    const int p = i & 1, qc = qn;
    if (i < m) qn = q[i];
    // pass 1: c - j and the strip's running minimum of it
    int dM = mleft, run = INT_MAX;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int sub = tc[k] == qc ? 0 : u;
      run = min(run, min(dM + sub, M[k] + 1) - (j0 + k));
      dM = M[k];
      M[k] = run;
    }
    const int in = warp_incl_min(run), below = __shfl_up_sync(FULL, in, 1);
    if (lane == 31) s_agg[p][warp] = in;
    __syncthreads();  // the row's one barrier
    const int y = warps_incl_min(s_agg[p], lane, nw);
    const int pw = __shfl_sync(FULL, y, max(warp - 1, 0));
    int pre = min(i, warp > 0 ? pw : INT_MAX);  // M(i, 0) - 0 = i seeds the chain
    if (lane > 0) pre = min(pre, below);
    // pass 2: M(i, j) = min(the prefix, the strip's running minimum) + j
    mleft = pre + (j0 - 1);
#pragma unroll
    for (int k = 0; k < W; ++k) M[k] = min(pre, M[k]) + (j0 + k);
  }
  // n is read only here, so that no value of the result stays live across
  // the rows
  const int n = min(max(ns[b], 0), n_pad), kn = n - j0 + 1;
  if (n == 0 && tid == 0) score_out[b] = INT_MAX;
  if (kn >= 1 && kn <= W) {
    int r = 0;  // M(0, n)'s latch value, the result at m = 0
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (m > 0 && k == kn - 1) r = M[k];
    score_out[b] = r;
  }
}

template <int W, bool PTRS>
void launch_width(int mode, bool jump, int B, int threads, cudaStream_t stream, const int* qs,
                  const int* ts, const float* allow, const int* ns, const int* ms,
                  const float* params, float* score, int* a, int* b, uint8_t* ptrs, int m_pad,
                  int n_pad, int rpb) {
  if (mode == OVERLAP)
    ptr_overlap_kernel<W, PTRS><<<B, threads, 0, stream>>>(qs, ts, ns, ms, params, score, a, b,
                                                           ptrs, m_pad, n_pad, rpb);
  else if (mode == GLOBAL)
    ptr_affine_kernel<GLOBAL, false, W, PTRS><<<B, threads, 0, stream>>>(
        qs, ts, allow, ns, ms, params, score, a, b, ptrs, m_pad, n_pad, rpb);
  else if (mode == LOCAL)
    ptr_affine_kernel<LOCAL, false, W, PTRS><<<B, threads, 0, stream>>>(
        qs, ts, allow, ns, ms, params, score, a, b, ptrs, m_pad, n_pad, rpb);
  else if (jump)
    ptr_affine_kernel<FIT, true, W, PTRS><<<B, threads, 0, stream>>>(
        qs, ts, allow, ns, ms, params, score, a, b, ptrs, m_pad, n_pad, rpb);
  else
    ptr_affine_kernel<FIT, false, W, PTRS><<<B, threads, 0, stream>>>(
        qs, ts, allow, ns, ms, params, score, a, b, ptrs, m_pad, n_pad, rpb);
}

// The launch shapes the entries take: `width` the strip width W (16),
// `threads` a multiple of 32 up to 512 (1,024 for edit), threads * W >=
// n_pad, n_pad a multiple of 16; and the mode 0 global, 1 local, 2 fit, 3
// overlap, 4 edit, with the jump only for fit.
bool bad_launch(int mode, int use_jump, int B, int n_pad, int threads, int width) {
  const int most = mode == EDIT ? kEditMaxThreads : kMaxThreads;
  return width != kWidth || B < 0 || threads < 32 || threads > most || threads % 32 != 0 ||
         (long long)threads * width < n_pad || n_pad <= 0 || n_pad % 16 != 0 || mode < GLOBAL ||
         mode > EDIT || (use_jump && mode != FIT);
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
    launch_width<kWidth, false>(mode, use_jump != 0, B, threads, stream, qs, ts, allow, ns, ms,
                                params, static_cast<float*>(score), nullptr, nullptr, nullptr,
                                m_pad, n_pad, 1);
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
  const bool bad_layout = mode == EDIT || (rpb != 1 && rpb != 2 && rpb != 4) || m_pad <= 0 ||
                          m_pad % rpb != 0 || (rpb > 1 && use_jump) ||
                          (rpb == 4 && mode != OVERLAP);
  if (bad_launch(mode, use_jump, B, n_pad, threads, width) || bad_layout)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  launch_width<kWidth, true>(mode, use_jump != 0, B, threads, stream, qs, ts, allow, ns, ms,
                             params, score, a, b, ptrs, m_pad, n_pad, rpb);
  return cudaGetLastError();
}
