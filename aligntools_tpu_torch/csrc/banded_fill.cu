// Banded DP fill for Hopper (sm_90a): the O(m*V) window fill of global,
// local, fit (without the jump), overlap and edit, scores and (all but edit)
// pointers: a warp per pair for windows up to 32 * WARP_STRIP_MAX lanes, a
// CTA per pair beyond.
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
// A row whose every lane lies at a column in [2, n] (i - W >= 2, i + W
// <= n, i <= m; warp-uniform) runs a FAST instance of the row with no
// column-0 border and no matrix test but the pad lanes'. A single warp's
// row chain grows with S: at 16 lanes a thread and a batch below one pair
// for each of the card's schedulers, the CTA path, which spreads a pair
// over four warps, fills pointers faster; ops/banded.py's launch_shape
// picks the path by the band alone, since the main path's slabs hold
// thousands of pairs.
//
// CTA path (wider windows, up to MAX_LANES): one CTA per pair, S lanes a
// thread (4 or 16), one barrier a row: a thread recomputes its left
// neighbour's last lane itself (M and L of a lane depend only on row i-1),
// the vertical predecessor of its last lane comes from the right neighbour's
// first lane through shared memory written before the row's block scan,
// and every shared buffer is double-buffered by row parity; for overlap and
// edit the right neighbour publishes its first lane's scan input before the
// barrier and the thread finishes that lane's value itself. Start info:
// global reads the one lane j == n of row m, fit and overlap reduce row m
// only, local keeps a running (value, i, j) per thread and reduces once.
//
// Exactness: values are integer-valued f32 with true infinite borders,
// built with --fmad=false and no fast math; every pointer is an explicit
// >= in the Pallas code's argument order. Both paths compute the same
// cells with the same operations in the same order.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "block_scan.cuh"

namespace {

constexpr int BIG = 1 << 30;
constexpr int GLOBAL = 0, LOCAL = 1, FIT = 2, OVERLAP = 3, EDIT = 4;  // ops/banded.py
constexpr float POS = INFINITY;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_LANES = 16384;
constexpr unsigned FULL = 0xffffffffu;
// The warp path's strips (lanes a thread; the window's V <= 32 * S), the
// widest WARP_STRIP_MAX, and the most threads (pairs x 32) its CTA runs.
constexpr int WARP_STRIP_MAX = 16;
constexpr int WARP_MAX_THREADS = 128;

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

// Exclusive prefix over the warp's lanes (lane 0 gets `seed`), by Op.
template <class Op>
__device__ __forceinline__ float warp_exclusive(float v, float seed) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = Op::op(v, y);
  }
  const float below = __shfl_up_sync(FULL, v, 1);
  return lane > 0 ? below : seed;
}

// The target window in registers: tc[s] is row i's char at lane k0+s; the
// shift to row i+1 takes the right neighbour's first char, and the top
// lane `nxt`, its load of te[min(i + 32*S - 1, n_ext - 1)] made a row ahead.
template <int S>
__device__ __forceinline__ void slide_chars(int (&tc)[S], int& nxt, const Pair& p, int i) {
  const int from_right = __shfl_down_sync(FULL, tc[0], 1);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) tc[s] = tc[s + 1];
  tc[S - 1] = (threadIdx.x & 31) == 31 ? nxt : from_right;
  nxt = p.t[min(i + 32 * S, p.n_ext - 1)];  // row i+2's char at the top lane
}

// A start-info candidate: the value, its row and its column.
struct Cand {
  float v;
  int i, j;
};

// The warp's first candidate by (largest v, smallest i, smallest j).
__device__ __forceinline__ Cand warp_best(Cand c) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const Cand y = {__shfl_xor_sync(FULL, c.v, d), __shfl_xor_sync(FULL, c.i, d),
                    __shfl_xor_sync(FULL, c.j, d)};
    if (y.v > c.v || (y.v == c.v && (y.i < c.i || (y.i == c.i && y.j < c.j)))) c = y;
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

// global / local / fit: S lanes a thread, lanes k0 .. k0+S-1.
template <int MODE, bool EMIT, int S>
__global__ void __launch_bounds__(MAX_THREADS) banded_affine(Args x) {
  __shared__ float nbr[2][2][MAX_THREADS];  // by row parity: first lane's M, L
  __shared__ float tot[2][1][32];
  __shared__ float red_fit[2][32], red_edge[32], red_lv[32];
  __shared__ int red_j[32], red_li[32], red_lj[32];
  __shared__ float g_s;
  __shared__ int g_a;
  const Pair p(x, blockIdx.x);
  const int tid = threadIdx.x, T = blockDim.x, k0 = tid * S, V = p.V, W = p.W;
  const float match = x.params[0], mis = x.params[1], o = x.params[2], e = x.params[3];
  uint8_t* out = EMIT ? x.ptrs + (size_t)blockIdx.x * x.m_pad * x.v_pad : nullptr;
  float M[S], L[S], U[S];
#pragma unroll
  for (int s = 0; s < S; ++s) affine_row0<MODE>(k0 + s, W, V, o, e, M[s], L[s], U[s]);
  // row i-1's values at lane k0-1, which this thread follows itself
  float lM = NEG, lL = NEG, lU = NEG;
  if (tid > 0) affine_row0<MODE>(k0 - 1, W, V, o, e, lM, lL, lU);
  nbr[0][0][tid] = M[0];
  nbr[0][1][tid] = L[0];
  if (tid == 0) {
    g_s = NEG;
    g_a = 0;
  }
  float edge = NEG, lb_v = NEG, f_s = NEG;
  int lb_i = 0, lb_j = 0, f_a = 0, f_b = 0;
  __syncthreads();
  // rows past m change nothing but their pointer bytes
  const int rows = EMIT ? x.m_pad : min(p.m, x.m_pad);
  for (int i = 1; i <= rows; ++i) {
    const int rp = (i - 1) & 1, wp = i & 1;
    const int qc = p.q[i - 1];
    const float rM = tid + 1 < T ? nbr[rp][0][tid + 1] : NEG;  // lane k0+S of row i-1
    const float rL = tid + 1 < T ? nbr[rp][1][tid + 1] : NEG;
    // lane k0-1 of row i: its M feeds lane k0's U candidate and pU bit
    float nlM = NEG, nlL = NEG;
    const int ljcol = i - W + k0 - 1;
    const bool l_ok = tid > 0 && k0 - 1 < V, l_in = l_ok && p.in_mat(i, ljcol);
    if (l_ok) {
      int unused;
      const float sub = p.tchar(i, k0 - 1) == qc ? match : mis;
      affine_cell<MODE>(i, ljcol, l_in, sub, o, e, lM, lL, lU, M[0], L[0], nlM, nlL, unused);
    }
    // pass 1: M, L, pM, pL and the U chain's candidates
    float C[S];
    int code[S];
    float red = NEG, mprev = nlM;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = k0 + s, jcol = i - W + k;
      C[s] = NEG;
      code[s] = 7;
      if (k < V) {
        const bool in_mat = p.in_mat(i, jcol);
        const float sub = p.tchar(i, k) == qc ? match : mis;
        const float vM = s + 1 < S ? M[s + 1] : rM, vL = s + 1 < S ? L[s + 1] : rL;
        float mv, lv;
        affine_cell<MODE>(i, jcol, in_mat, sub, o, e, M[s], L[s], U[s], vM, vL, mv, lv, code[s]);
        C[s] = u_cand<MODE>(mprev, jcol, (float)jcol, o, e);
        red = fmaxf(red, C[s]);
        mprev = mv;
        M[s] = mv;
        L[s] = lv;
        if (MODE == LOCAL && mv > lb_v) {  // row-major strict >: first (i, j)
          lb_v = mv;
          lb_i = i;
          lb_j = jcol;
        }
        if (k == 0 || k == V - 1) edge = fmaxf(edge, mv);
      }
    }
    nbr[wp][0][tid] = M[0];
    nbr[wp][1][tid] = L[0];
    float v[1] = {red};
    const float seed[1] = {NEG};
    block_exclusive<MaxF>(v, seed, tot[wp]);
    // pass 2: U (the running max holds the chain's cummax at lane k0-1)
    float run = v[0], mh = NEG, uh = NEG;
    if (l_ok) {
      const float ul = l_in ? (MODE == LOCAL ? fmaxf(run, 0.f) : run) + e * (float)ljcol : NEG;
      mh = nlM;
      uh = ul;
      lM = nlM;
      lL = nlL;
      lU = ul;
    }
    const bool latch = i == p.m;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = k0 + s, jcol = i - W + k;
      if (k < V) {
        run = fmaxf(run, C[s]);
        const float uv =
            p.in_mat(i, jcol) ? (MODE == LOCAL ? fmaxf(run, 0.f) : run) + e * (float)jcol : NEG;
        if (EMIT) {
          const bool home = MODE == LOCAL && jcol == 1;  // M(i, 0) = U(i, 0) = 0
          const float ua = (home ? 0.f : mh) + o, ub = (home ? 0.f : uh) + e;
          code[s] |= ua >= ub ? 0 : 16;
        }
        if (MODE == GLOBAL && latch && jcol == p.n) {
          g_s = fmaxf(fmaxf(L[s], M[s]), uv);
          g_a = (L[s] >= M[s] && L[s] >= uv) ? 0 : (M[s] >= uv ? 1 : 2);
        }
        mh = M[s];
        uh = uv;
        U[s] = uv;
      }
    }
    if (EMIT) store_codes<S>(out + (size_t)(i - 1) * x.v_pad, code, k0, V, x.v_pad, 7);
    if (MODE == FIT && latch) {
      // the bottom row over columns 1..n-1; M wins ties, then the smallest j
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int k = k0 + s, jcol = i - W + k;
        if (k < V && jcol <= p.n - 1) {
          mx[0] = fmaxf(mx[0], M[s]);
          mx[1] = fmaxf(mx[1], L[s]);
        }
      }
      block_reduce<MaxF>(mx, red_fit);
      const bool use_l = mx[1] > mx[0];
      f_s = fmaxf(mx[0], mx[1]);
      int fj = BIG;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int k = k0 + s, jcol = i - W + k;
        if (k < V && fj == BIG && jcol <= p.n - 1 && p.in_mat(i, jcol) &&
            (use_l ? L[s] : M[s]) == f_s)
          fj = jcol;
      }
      f_b = block_reduce<MinI>(fj, red_j);
      f_a = use_l ? 1 : 0;
    }
  }
  edge = block_reduce<MaxF>(edge, red_edge);
  if (MODE == LOCAL) {  // the larger value, then the smaller i, then the smaller j
    const float vb = block_reduce<MaxF>(lb_v, red_lv);
    const int ib = block_reduce<MinI>(lb_v == vb ? lb_i : BIG, red_li);
    const int jb = block_reduce<MinI>(lb_v == vb && lb_i == ib ? lb_j : BIG, red_lj);
    f_s = vb;
    f_a = ib;
    f_b = jb;
  }
  if (tid == 0) {
    const int b = blockIdx.x;
    x.best[b] = MODE == GLOBAL ? g_s : f_s;
    x.edge[b] = edge;
    x.a[b] = MODE == GLOBAL ? g_a : f_a;
    x.b[b] = MODE == GLOBAL ? 0 : f_b;
  }
}

// overlap (linear gap o; codes LEFT/DIAG/RIGHT = 0/1/2, 3 where -inf) and
// edit (min-plus, +inf out of band, no pointers): the row is the scan
// itself, so the right neighbour's first lane of row i is finished by this
// thread from that lane's published scan input (and, for edit, its cand2).
template <bool EDIT_MODE, bool EMIT, int S>
__global__ void __launch_bounds__(MAX_THREADS) banded_linear(Args x) {
  __shared__ float cdF[2][MAX_THREADS], c2F[2][MAX_THREADS];  // by row parity
  __shared__ float tot[2][1][32];
  __shared__ float red_mx[32], red_edge[32];
  __shared__ int red_j[32];
  __shared__ float g_s;
  const Pair p(x, blockIdx.x);
  const int tid = threadIdx.x, T = blockDim.x, k0 = tid * S, V = p.V, W = p.W;
  const float match = x.params[0], mis = x.params[1], o = x.params[2];
  const float bad = EDIT_MODE ? POS : NEG;
  uint8_t* out = EMIT ? x.ptrs + (size_t)blockIdx.x * x.m_pad * x.v_pad : nullptr;
  // row 0: edit M(0, j) = j; overlap 0 at j = 0, -inf past it
  auto row0 = [&](int k) {
    const int j = k - W;
    if (k >= V || j < 0) return bad;
    return EDIT_MODE ? (float)j : (j == 0 ? 0.f : NEG);
  };
  float M[S];
#pragma unroll
  for (int s = 0; s < S; ++s) M[s] = row0(k0 + s);
  float rM = tid + 1 < T ? row0(k0 + S) : bad;  // lane k0+S of row i-1
  if (tid == 0) g_s = POS;
  float edge = bad, f_s = NEG;
  int f_a = 0;
  __syncthreads();
  const int rows = EMIT ? x.m_pad : min(p.m, x.m_pad);
  for (int i = 1; i <= rows; ++i) {
    const int wp = i & 1;
    const int qc = p.q[i - 1];
    const float i_f = (float)i;
    float CD[S], C2[S];
    int dcode[S];
    float red = bad;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = k0 + s, jcol = i - W + k;
      const float jf = (float)jcol;
      CD[s] = C2[s] = bad;
      dcode[s] = 2;
      if (k < V) {
        const bool in_mat = p.in_mat(i, jcol);
        const bool eq = p.tchar(i, k) == qc;
        const float vert = s + 1 < S ? M[s + 1] : rM;
        if (EDIT_MODE) {
          const float diag = jcol == 1 ? i_f - 1.f : M[s];  // M(i-1, 0) = i-1
          float c2 = fminf(diag + (eq ? 0.f : mis), vert + 1.f);
          c2 = in_mat ? c2 : POS;
          C2[s] = c2;
          CD[s] = jcol == 0 ? i_f : (jcol == 1 ? fminf(c2 - jf, i_f) : c2 - jf);
          red = fminf(red, CD[s]);
        } else {
          const float dd = (jcol == 1 ? 0.f : M[s]) + (eq ? match : mis);
          const float vv = (jcol == 0 ? 0.f : vert) + o;
          const float cand = in_mat ? fmaxf(dd, vv) : NEG;
          CD[s] = jcol == 0 ? 0.f : cand - o * jf;
          dcode[s] = dd >= vv ? 1 : 2;
          red = fmaxf(red, CD[s]);
        }
      }
    }
    cdF[wp][tid] = CD[0];
    if (EDIT_MODE) c2F[wp][tid] = C2[0];
    float v[1] = {red};
    const float seed[1] = {bad};
    if (EDIT_MODE)
      block_exclusive<MinF>(v, seed, tot[wp]);
    else
      block_exclusive<MaxF>(v, seed, tot[wp]);
    const float excl = v[0];
    // the right neighbour's first lane of row i, as that thread computes it
    {
      const int kr = k0 + S, jr = i - W + kr;
      rM = bad;
      if (tid + 1 < T && kr < V && p.in_mat(i, jr)) {
        if (EDIT_MODE)
          rM = fminf(fminf(fminf(excl, red), cdF[wp][tid + 1]) + (float)jr, c2F[wp][tid + 1]);
        else
          rM = fmaxf(fmaxf(excl, red), cdF[wp][tid + 1]) + o * (float)jr;
      }
    }
    float run = excl;
    // overlap's LEFT pointer: the row's value at lane k0-1
    const int jl = i - W + k0 - 1;
    float lh = tid > 0 && p.in_mat(i, jl) ? excl + o * (float)jl : NEG;
    int code[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = k0 + s, jcol = i - W + k;
      const float jf = (float)jcol;
      code[s] = 3;
      if (k < V) {
        const bool in_mat = p.in_mat(i, jcol);
        float rv;
        if (EDIT_MODE) {
          run = fminf(run, CD[s]);
          rv = in_mat ? fminf(run + jf, C2[s]) : POS;
          if (i == p.m && jcol == p.n) g_s = rv;
          if (k == 0 || k == V - 1) edge = fminf(edge, rv);
        } else {
          run = fmaxf(run, CD[s]);
          rv = in_mat ? run + o * jf : NEG;
          if (EMIT) {
            const float left = (jcol == 1 ? 0.f : lh) + o;  // M(i, 0) = 0
            code[s] = left >= rv ? 0 : dcode[s];
            if (!(rv > NEG)) code[s] = 3;
          }
          lh = rv;
          if (k == 0 || k == V - 1) edge = fmaxf(edge, rv);
        }
        M[s] = rv;
      }
    }
    if (EMIT) store_codes<S>(out + (size_t)(i - 1) * x.v_pad, code, k0, V, x.v_pad, 3);
    if (!EDIT_MODE && i == p.m) {
      // the bottom row over columns 1..n-1, with the j = 0 zero candidate
      float mx = NEG;
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (k0 + s < V && i - W + k0 + s <= p.n - 1) mx = fmaxf(mx, M[s]);
      mx = block_reduce<MaxF>(mx, red_mx);
      int fj = BIG;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int jcol = i - W + k0 + s;
        if (k0 + s < V && fj == BIG && jcol <= p.n - 1 && p.in_mat(i, jcol) && M[s] == mx)
          fj = jcol;
      }
      fj = block_reduce<MinI>(fj, red_j);
      f_s = fmaxf(mx, 0.f);
      f_a = mx > 0.f ? fj : 0;
    }
  }
  if (EDIT_MODE)
    edge = block_reduce<MinF>(edge, red_edge);
  else
    edge = block_reduce<MaxF>(edge, red_edge);
  if (tid == 0) {
    const int b = blockIdx.x;
    x.best[b] = EDIT_MODE ? g_s : f_s;
    x.edge[b] = edge;
    x.a[b] = EDIT_MODE ? 0 : f_a;
    x.b[b] = 0;
  }
}

// ---------------------------------------------------------------------------
// Warp path: a warp per pair, lane l holding window lanes [l*S, (l+1)*S)
// ---------------------------------------------------------------------------

// The pair of this warp, or -1 for a warp past B.
__device__ __forceinline__ int warp_pair(const Args& x) {
  const int b = blockIdx.x * (int)(blockDim.x >> 5) + (int)(threadIdx.x >> 5);
  return b < x.B ? b : -1;
}

// global / local / fit, as banded_affine.
template <int MODE, bool EMIT, int S>
__global__ void __launch_bounds__(WARP_MAX_THREADS) banded_affine_warp(Args x) {
  const int b = warp_pair(x);
  if (b < 0) return;
  const Pair p(x, b);
  const int lane = threadIdx.x & 31, k0 = lane * S, V = p.V, W = p.W;
  const float match = x.params[0], mis = x.params[1], o = x.params[2], e = x.params[3];
  uint8_t* out = EMIT ? x.ptrs + (size_t)b * x.m_pad * x.v_pad : nullptr;
  float M[S], L[S], U[S];
  int tc[S];  // row i's chars at lanes k0 .. k0+S-1
#pragma unroll
  for (int s = 0; s < S; ++s) {
    affine_row0<MODE>(k0 + s, W, V, o, e, M[s], L[s], U[s]);
    tc[s] = p.tchar(1, k0 + s);
  }
  int nxt = p.tchar(2, 32 * S - 1);
  float edge = NEG, g_s = NEG, f_s = NEG;
  bool g_set = false;
  int g_a = 0, f_a = 0, f_b = 0;
  Cand lat = {NEG, 0, 0};
  // rows past m change nothing but their pointer bytes
  const int rows = EMIT ? x.m_pad : min(p.m, x.m_pad);
  int qn = rows > 0 ? p.q[0] : 0;
  // One row; FAST (warp-uniform): every window lane of row i lies at a
  // column in [2, n] and i <= m, so a lane is in the matrix unless it is a
  // pad lane, and no column-0 border reaches the row.
  auto row = [&](int i, int qc, auto fast) {
    constexpr bool FAST = decltype(fast)::value;
    // lane k0+S of row i-1, the right neighbour's first
    float rM = __shfl_down_sync(FULL, M[0], 1), rL = __shfl_down_sync(FULL, L[0], 1);
    if (lane == 31) rM = rL = NEG;
    // pass 1: M, L, pM, pL. No lane branches: a pad lane (k >= V) is out
    // of the matrix, so its M, L and U stay -inf, and no lane below it reads
    // it; its codes are stored as unset.
    const int j0 = i - W + k0;  // the column of lane k0
    const float jf0 = (float)j0;
    int code[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = k0 + s, jcol = j0 + s;
      const bool in_mat = k < V && (FAST || p.in_mat(i, jcol));
      const float sub = tc[s] == qc ? match : mis;
      const float vM = s + 1 < S ? M[s + 1] : rM, vL = s + 1 < S ? L[s + 1] : rL;
      float mv, lv;
      affine_cell<MODE, !FAST>(i, jcol, in_mat, sub, o, e, M[s], L[s], U[s], vM, vL, mv, lv,
                               code[s]);
      M[s] = mv;
      L[s] = lv;
      if (MODE == LOCAL && mv > lat.v) lat = {mv, i, jcol};  // row-major strict >
      if (k == 0 || k == V - 1) edge = fmaxf(edge, mv);
    }
    // M at lane k0-1 of row i: the U chain's candidate and the pU bit at k0
    float nlM = __shfl_up_sync(FULL, M[S - 1], 1);
    if (lane == 0) nlM = NEG;
    float C[S];
    float red = NEG;
#pragma unroll
    for (int s = 0; s < S; ++s) {  // a pad lane's candidate reaches only pad lanes
      C[s] = u_cand<MODE, !FAST>(s == 0 ? nlM : M[s - 1], j0 + s, jf0 + (float)s, o, e);
      red = fmaxf(red, C[s]);
    }
    // pass 2: U (the running max holds the chain's cummax at lane k0-1)
    float run = warp_exclusive<MaxF>(red, NEG);
    const bool l_in = lane > 0 && k0 - 1 < V && (FAST || p.in_mat(i, j0 - 1));
    float mh = lane > 0 && k0 - 1 < V ? nlM : NEG;
    float uh = l_in ? (MODE == LOCAL ? fmaxf(run, 0.f) : run) + e * (jf0 - 1.f) : NEG;
    const bool latch = i == p.m;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = k0 + s, jcol = j0 + s;
      run = fmaxf(run, C[s]);
      const float uv = k < V && (FAST || p.in_mat(i, jcol))
                           ? (MODE == LOCAL ? fmaxf(run, 0.f) : run) + e * (jf0 + (float)s)
                           : NEG;
      if (EMIT) {
        const bool home = !FAST && MODE == LOCAL && jcol == 1;  // M(i, 0) = U(i, 0) = 0
        const float ua = (home ? 0.f : mh) + o, ub = (home ? 0.f : uh) + e;
        code[s] |= ua >= ub ? 0 : 16;
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
    if (EMIT) store_codes<S>(out + (size_t)(i - 1) * x.v_pad, code, k0, V, x.v_pad, 7);
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
      const bool use_l = mx1 > mx0;
      f_s = fmaxf(mx0, mx1);
      int fj = BIG;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int k = k0 + s, jcol = i - W + k;
        if (k < V && fj == BIG && jcol <= p.n - 1 && p.in_mat(i, jcol) &&
            (use_l ? L[s] : M[s]) == f_s)
          fj = jcol;
      }
      f_b = warp_min(fj);
      f_a = use_l ? 1 : 0;
    }
  };
  for (int i = 1; i <= rows; ++i) {
    const int qc = qn;
    if (i < rows) qn = p.q[i];
    if (i - W >= 2 && i + W <= p.n && i <= p.m)
      row(i, qc, std::true_type{});
    else
      row(i, qc, std::false_type{});
    slide_chars<S>(tc, nxt, p, i);
  }
  edge = warp_max(edge);
  if (MODE == LOCAL) {  // the larger value, then the smaller i, then the smaller j
    lat = warp_best(lat);
    f_s = lat.v;
    f_a = lat.i;
    f_b = lat.j;
  }
  if (MODE == GLOBAL) {  // the one lane that held column n at row m
    const unsigned who = __ballot_sync(FULL, g_set);
    const int src = who ? __ffs(who) - 1 : 0;
    g_s = __shfl_sync(FULL, g_s, src);
    g_a = __shfl_sync(FULL, g_a, src);
  }
  if (lane == 0) {
    x.best[b] = MODE == GLOBAL ? g_s : f_s;
    x.edge[b] = edge;
    x.a[b] = MODE == GLOBAL ? g_a : f_a;
    x.b[b] = MODE == GLOBAL ? 0 : f_b;
  }
}

// overlap and edit, as banded_linear: lane k0+S's value of row i-1 is the
// right neighbour's, by shuffle.
template <bool EDIT_MODE, bool EMIT, int S>
__global__ void __launch_bounds__(WARP_MAX_THREADS) banded_linear_warp(Args x) {
  const int b = warp_pair(x);
  if (b < 0) return;
  const Pair p(x, b);
  const int lane = threadIdx.x & 31, k0 = lane * S, V = p.V, W = p.W;
  const float match = x.params[0], mis = x.params[1], o = x.params[2];
  const float bad = EDIT_MODE ? POS : NEG;
  uint8_t* out = EMIT ? x.ptrs + (size_t)b * x.m_pad * x.v_pad : nullptr;
  float M[S];
  int tc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {  // row 0: edit M(0, j) = j; overlap 0 at j = 0, -inf past it
    const int k = k0 + s, j = k - W;
    M[s] = k >= V || j < 0 ? bad : (EDIT_MODE ? (float)j : (j == 0 ? 0.f : NEG));
    tc[s] = p.tchar(1, k);
  }
  int nxt = p.tchar(2, 32 * S - 1);
  float edge = bad, g_s = POS, f_s = NEG;
  bool g_set = false;
  int f_a = 0;
  const int rows = EMIT ? x.m_pad : min(p.m, x.m_pad);
  int qn = rows > 0 ? p.q[0] : 0;
  // One row; FAST as in banded_affine_warp: no column-0 border, and every
  // lane but the pad lanes in the matrix.
  auto row = [&](int i, int qc, auto fast) {
    constexpr bool FAST = decltype(fast)::value;
    const float i_f = (float)i;
    float rM = __shfl_down_sync(FULL, M[0], 1);  // lane k0+S of row i-1
    if (lane == 31) rM = bad;
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
    const float excl = EDIT_MODE ? warp_exclusive<MinF>(red, bad) : warp_exclusive<MaxF>(red, bad);
    float run = excl;
    // overlap's LEFT pointer: the row's value at lane k0-1
    float lh = lane > 0 && (FAST || p.in_mat(i, j0 - 1)) ? excl + o * (jf0 - 1.f) : NEG;
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
      fj = warp_min(fj);
      f_s = fmaxf(mx, 0.f);
      f_a = mx > 0.f ? fj : 0;
    }
  };
  for (int i = 1; i <= rows; ++i) {
    const int qc = qn;
    if (i < rows) qn = p.q[i];
    if (i - W >= 2 && i + W <= p.n && i <= p.m)
      row(i, qc, std::true_type{});
    else
      row(i, qc, std::false_type{});
    slide_chars<S>(tc, nxt, p, i);
  }
  edge = EDIT_MODE ? warp_min(edge) : warp_max(edge);
  if (EDIT_MODE) {  // the one lane that held column n at row m
    const unsigned who = __ballot_sync(FULL, g_set);
    g_s = __shfl_sync(FULL, g_s, who ? __ffs(who) - 1 : 0);
    if (!who) g_s = POS;
  }
  if (lane == 0) {
    x.best[b] = EDIT_MODE ? g_s : f_s;
    x.edge[b] = edge;
    x.a[b] = EDIT_MODE ? 0 : f_a;
    x.b[b] = 0;
  }
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

template <int S>
void launch(int mode, bool emit, int B, int threads, cudaStream_t st, const Args& x) {
  if (mode == OVERLAP) {
    if (emit)
      banded_linear<false, true, S><<<B, threads, 0, st>>>(x);
    else
      banded_linear<false, false, S><<<B, threads, 0, st>>>(x);
  } else if (mode == EDIT) {
    banded_linear<true, false, S><<<B, threads, 0, st>>>(x);
  } else if (mode == GLOBAL) {
    if (emit)
      banded_affine<GLOBAL, true, S><<<B, threads, 0, st>>>(x);
    else
      banded_affine<GLOBAL, false, S><<<B, threads, 0, st>>>(x);
  } else if (mode == LOCAL) {
    if (emit)
      banded_affine<LOCAL, true, S><<<B, threads, 0, st>>>(x);
    else
      banded_affine<LOCAL, false, S><<<B, threads, 0, st>>>(x);
  } else {
    if (emit)
      banded_affine<FIT, true, S><<<B, threads, 0, st>>>(x);
    else
      banded_affine<FIT, false, S><<<B, threads, 0, st>>>(x);
  }
}

}  // namespace

// C entry point, bound with ctypes: launches one banded fill on `stream`
// without synchronising and returns the launch's error code. mode: 0
// global, 1 local, 2 fit, 3 overlap, 4 edit (scores only). `warp` 1: the warp
// path, a warp per pair, `threads` / 32 pairs a CTA (at most
// WARP_MAX_THREADS), `strip` lanes a thread (5, 9 or 16), 32 * strip >= V;
// `warp` 0: the CTA path, a CTA per pair of `threads`, `strip` 4 or 16,
// threads * strip >= V. With pointers the lanes also cover v_pad.
extern "C" cudaError_t at_banded_fill(int mode, int emit, const int* qs, const int* te,
                                      const int* ns, const int* ms, const float* params,
                                      float* best, float* edge, int* a, int* b, uint8_t* ptrs,
                                      int B, int m_pad, int n_ext, int band, int v_pad,
                                      int threads, int strip, int warp, cudaStream_t stream) {
  const long long V = 2LL * band + 1, lanes = (long long)(warp ? 32 : threads) * strip;
  const bool bad_ptrs = emit && (mode == EDIT || v_pad < V || v_pad % 16 != 0 || lanes < v_pad);
  const bool bad_shape =
      warp ? (strip != 5 && strip != 9 && strip != WARP_STRIP_MAX) ||
                 threads > WARP_MAX_THREADS
           : (strip != 4 && strip != 16) || threads > MAX_THREADS;
  if (B < 0 || m_pad < 0 || n_ext < 1 || band < 0 || V > MAX_LANES || bad_shape ||
      threads < 32 || threads % 32 != 0 || lanes < V || mode < GLOBAL || mode > EDIT || bad_ptrs)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const Args x{qs, te, ns, ms, params, best, edge, a, b, ptrs, m_pad, n_ext, band, v_pad, B};
  const bool em = emit != 0;
  if (!warp) {
    if (strip == 4)
      launch<4>(mode, em, B, threads, stream, x);
    else
      launch<16>(mode, em, B, threads, stream, x);
  } else if (strip == 5) {
    launch_warp<5>(mode, em, threads, stream, x);
  } else if (strip == 9) {
    launch_warp<9>(mode, em, threads, stream, x);
  } else {
    launch_warp<WARP_STRIP_MAX>(mode, em, threads, stream, x);
  }
  return cudaGetLastError();
}
