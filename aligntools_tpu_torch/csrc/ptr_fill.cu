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
// Design. The row is strip_row.cuh's (AffineRow, OverlapRow, EditRow, one
// body shared with blocked_fill.cu); the kernels here are its shells with
// column 0's border on the left. Thread t owns the W consecutive columns
// [1 + t*W, 1 + (t+1)*W) of the whole n_pad (W a template parameter,
// instantiated at 16; threads *
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
// one-chain shape in int32 min-plus, edit_score_kernel (EditRow): two words a column
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

// The flat fills' Sink: no edge and no state rows; D(m, n) goes out at once
// from the thread that holds column n (with the pointer fill's start state).
template <class T, bool PTRS>
struct FlatSink {
  T* score;
  int* a;
  int* b;
  int pair;
  template <class R>
  __device__ __forceinline__ void row_begin(R&, int) const {}
  template <class R>
  __device__ __forceinline__ void cell(R&, int, int, T, T) const {}
  template <class R>
  __device__ __forceinline__ void row_end(R&, int) const {}
  __device__ __forceinline__ void global(T d, int st) const {
    score[pair] = d;
    if (PTRS) {
      a[pair] = st;
      b[pair] = 0;
    }
  }
};

// global / local / fit(+jump): the affine row (strip_row.cuh) over columns
// 1..n_pad, column 0's border on the left. PTRS false: the score-only
// instance (ops/pallas_scan.py:328 _affine_kernel, :513 _fit_kernel), with
// no pointer bits and no stores; its rows stop at m, local's score is the
// latched maximum, global's D(m, n), fit's the maximum of M and L on row m
// over columns <= n-1.
template <int MODE, bool JUMP, int W, bool PTRS = true, class T = float>
__global__ void __launch_bounds__(kMaxThreads)
ptr_affine_kernel(const int* __restrict__ qs, const int* __restrict__ ts,
                  const float* __restrict__ allow, const int* __restrict__ ns,
                  const int* __restrict__ ms, const T* __restrict__ params,
                  T* __restrict__ score_out, int* __restrict__ a_out,
                  int* __restrict__ b_out, uint8_t* __restrict__ ptrs, int m_pad, int n_pad,
                  int rpb) {
  using Row = AffineRow<MODE, JUMP, W, T, PTRS, PTRS ? LATCH_PTR : LATCH_SCORE>;
  constexpr T NG = (T)NEG;
  __shared__ typename Row::Smem sh;
  __shared__ Cand<T> s_red[2][32];
  __shared__ T s_max[32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int n = min(max(ns[b], 0), n_pad), m = min(max(ms[b], 0), m_pad);
  const T o = params[2], e = params[3];
  Row r(params, 1 + tid * W, tid * W < n_pad, m, n, rpb);
  r.load(ts + (size_t)b * n_pad + (size_t)tid * W, JUMP ? allow + (size_t)b * n_pad : nullptr,
         n_pad);
  r.init([&](int j, T& mm, T& ll, T& uu, T& jj) { row0<MODE, T>(j, o, e, mm, ll, uu, jj); });
  BorderLeft<MODE, JUMP, T, !PTRS> left(o, e);
  left.init(r);
  const FlatSink<T, PTRS> sink{score_out, a_out, b_out, b};
  if (PTRS) {
    r.out = ptrs + (size_t)b * (m_pad / rpb) * n_pad + (size_t)tid * W;
    r.pitch = n_pad;
  }
  // every pointer row; the scores stop at m
  const int rows = PTRS ? m_pad : m;
  const int* q = qs + (size_t)b * m_pad;
  int qn = rows > 0 ? q[0] : 0;
  for (int i = 1; i <= rows; ++i) {
    const int qc = qn;
    if (i < rows) qn = q[i];
    r.row(i, i, qc, sh, left, sink);
  }
  // start info, reduced once (global's went out at (m, n))
  if (MODE == GLOBAL) {
    if (tid == 0 && (m == 0 || n == 0)) {
      score_out[b] = NG;
      if (PTRS) {
        a_out[b] = 0;
        b_out[b] = 0;
      }
    }
  } else if (!PTRS) {
    // local's + 0 turns a -0 into +0 (the score is printed with %f);
    // fit's score is -inf where row m holds no column <= n-1, m = 0 too
    const T v = block_max(r.lat.v, s_max);
    if (tid == 0) score_out[b] = MODE == LOCAL ? v + (T)0 : v;
  } else if (MODE == LOCAL) {
    const Cand<T> c = block_best(r.lat, s_red[0]);
    if (tid == 0) {
      score_out[b] = c.v;
      a_out[b] = c.i;
      b_out[b] = c.j;
    }
  } else {
    // fit: L wins only when strictly greater
    const Cand<T> rm = block_best(r.cm, s_red[0]), rl = block_best(r.cl, s_red[1]);
    if (tid == 0) {
      const bool use_l = rl.v > rm.v;
      score_out[b] = m > 0 ? vmax(rm.v, rl.v) : NG;
      a_out[b] = m > 0 && use_l ? 1 : 0;
      b_out[b] = m > 0 ? (use_l ? rl.j : rm.j) : 0;
    }
  }
}

// overlap: the overlap row (strip_row.cuh), M(i, 0) = 0 on the left. PTRS
// false: the score-only instance (ops/pallas_scan.py:421 _overlap_kernel),
// with no codes and no stores; its rows stop at m, its score max(row m's
// maximum over columns <= n-1, 0), 0 where m = 0.
template <int W, bool PTRS = true, class T = float>
__global__ void __launch_bounds__(kMaxThreads)
ptr_overlap_kernel(const int* __restrict__ qs, const int* __restrict__ ts,
                   const int* __restrict__ ns, const int* __restrict__ ms,
                   const T* __restrict__ params, T* __restrict__ score_out,
                   int* __restrict__ a_out, int* __restrict__ b_out, uint8_t* __restrict__ ptrs,
                   int m_pad, int n_pad, int rpb) {
  using Row = OverlapRow<W, T, PTRS, PTRS ? LATCH_PTR : LATCH_NONE>;
  constexpr T NG = (T)NEG;
  __shared__ typename Row::Smem sh;
  __shared__ T s_max[32];
  __shared__ Cand<T> s_red[32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int n = min(max(ns[b], 0), n_pad), m = min(max(ms[b], 0), m_pad);
  const int j0 = 1 + tid * W;
  Row r(params, j0, tid * W < n_pad, m, n, rpb);
  // row 0 is -inf past column 0; the column-0 border is 0
  r.init(ts + (size_t)b * n_pad + (size_t)tid * W, [](int) { return NG; }, (T)0);
  const ZeroLeft<T> left;
  const FlatSink<T, PTRS> sink{score_out, a_out, b_out, b};
  if (PTRS) {
    r.out = ptrs + (size_t)b * (m_pad / rpb) * n_pad + (size_t)tid * W;
    r.pitch = n_pad;
  }
  // every pointer row; the score stops at m
  const int rows = PTRS ? m_pad : m;
  const int* q = qs + (size_t)b * m_pad;
  int qn = rows > 0 ? q[0] : 0;
  for (int i = 1; i <= rows; ++i) {
    const int qc = qn;
    if (i < rows) qn = q[i];
    r.row(i, i, qc, sh, left, sink);
  }
  if (!PTRS) {
    // the rows stopped at m, so M holds row m (row 0's -inf at m = 0): its
    // maximum over j <= n-1. n is read again here, so that no value of the
    // score stays live across the rows: with one, ptxas held the instance
    // to 64 registers by spilling a value that it reloaded every row
    const int kn = min(max(ns[b], 0), n_pad) - j0;
    T top = NG;
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (k < kn) top = vmax(top, r.M[k]);
    // the j = 0 border's 0, m = 0 too; + 0 turns a -0 into +0
    const T v = block_max(top, s_max);
    if (tid == 0) score_out[b] = vmax(v, (T)0) + (T)0;
    return;
  }
  // the j = 0 zero candidate wins ties
  const Cand<T> c = block_best(r.best, s_red);
  if (tid == 0) {
    score_out[b] = m > 0 ? vmax(c.v, (T)0) : NG;
    a_out[b] = m > 0 && c.v > (T)0 ? c.j : 0;
    b_out[b] = 0;
  }
}

// edit distance, score only (ops/pallas_scan.py:469 _edit_kernel): the edit
// row (strip_row.cuh), M(i, 0) = i on the left, M(0, j) = j. The rows stop
// at m; the thread that owns column n writes M(m, n), 0 at m = 0 (the
// Pallas kernel's latch), and thread 0 writes INT_MAX at n = 0. T double (P
// double: the params row in double) is the instance for pairs past
// float32's exact range: the same function in double, u = params[1], +inf
// in place of INT_MAX.
template <int W, class T = int, class P = float>
__global__ void __launch_bounds__(kEditMaxThreads)
edit_score_kernel(const int* __restrict__ qs, const int* __restrict__ ts,
                  const int* __restrict__ ns, const int* __restrict__ ms,
                  const P* __restrict__ params, T* __restrict__ score_out, int m_pad,
                  int n_pad) {
  __shared__ typename EditRow<W, T>::Smem sh;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int m = min(max(ms[b], 0), m_pad);
  const int j0 = 1 + tid * W;
  EditRow<W, T> r(params, j0);
  r.init(ts + (size_t)b * n_pad + (size_t)tid * W, tid * W < n_pad, [](int j) { return (T)j; },
         (T)(j0 - 1));
  const RowLeft<T> left;
  const int* q = qs + (size_t)b * m_pad;
  int qn = m > 0 ? q[0] : 0;
  for (int i = 1; i <= m; ++i) {
    const int qc = qn;
    if (i < m) qn = q[i];
    r.row(i, qc, sh, left);
  }
  // n is read only here, so that no value of the result stays live across
  // the rows
  const int n = min(max(ns[b], 0), n_pad), kn = n - j0 + 1;
  if (n == 0 && tid == 0) score_out[b] = vtop<T>();
  if (kn >= 1 && kn <= W) {
    T v = 0;  // M(0, n)'s latch value, the result at m = 0
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (m > 0 && k == kn - 1) v = r.M[k];
    score_out[b] = v;
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
