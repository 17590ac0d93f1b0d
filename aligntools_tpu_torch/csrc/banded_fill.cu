// Banded DP fill for Hopper (sm_90a): the O(m*V) window fill of global,
// local, fit (without the jump), overlap and edit, scores and (all but edit)
// pointers, one CTA per pair.
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
// matrix product: Mosaic cannot slice or index lanes dynamically. Here row i
// reads te[i-1 .. i-1+V) straight from the target (coalesced) and its query
// char as one scalar.
//
// What bounds it here: the per-row chain, as in the flat fills. A row is a
// serial pass over each thread's strip of S lanes, one block scan (one
// barrier) and a second pass; for the 64 x 4096 W = 128 shape a CTA has 96
// threads and ~4,100 rows in sequence, and one CTA per pair leaves SMs idle
// when B < 132. Bytes (one pointer byte a cell) and operations (~15-20 a
// cell) are far from it. The design keeps the row state in registers and
// needs ONE barrier a row: a thread recomputes its left neighbour's last
// lane itself (M and L of a lane depend only on row i-1, so the U chain's
// candidate and the pU bit at the strip's first lane need no exchange), the
// vertical predecessor of its last lane comes from the right neighbour's
// first lane through shared memory written before the row's scan, and every
// shared buffer is double-buffered by row parity. For overlap and edit,
// whose row values are known only after the scan, the right neighbour
// publishes its first lane's scan input before the barrier and the thread
// finishes that lane's value itself. Start info needs no per-row reduction:
// global reads the one lane j == n of row m, fit and overlap reduce row m
// only, local keeps a running (value, i, j) per thread and reduces once.
//
// Exactness: values are integer-valued f32 with true infinite borders,
// built with --fmad=false and no fast math; every pointer is an explicit
// >= in the Pallas code's argument order.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int BIG = 1 << 30;
constexpr int GLOBAL = 0, LOCAL = 1, FIT = 2, OVERLAP = 3, EDIT = 4;  // ops/banded.py
constexpr float POS = INFINITY;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_LANES = 16384;

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
  int m_pad, n_ext, W, v_pad;
};

// One pair's view: row i's target char at lane k is te[i-1+k], clipped to
// the last column as the Pallas code's window gather clips it.
struct Pair {
  const int* q;
  const int* t;
  int n, m, n_ext, W, V;
  __device__ Pair(const Args& x) {
    const int b = blockIdx.x;
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

// Store a strip's codes as 4-byte words: lanes < V their code, lanes in
// [V, v_pad) `unset`; k0 and v_pad are multiples of 4.
template <int S>
__device__ __forceinline__ void store_codes(uint8_t* row, const int (&code)[S], int k0, int V,
                                            int v_pad, int unset) {
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
}

// M and L of one affine cell from row i-1's diagonal (dM, dL, dU) and
// vertical (vM, vL) values, with the mode's column-0 borders, and the pM/pL
// part of its pointer byte.
template <int MODE>
__device__ __forceinline__ void affine_cell(int i, int jcol, bool in_mat, float sub, float o,
                                            float e, float dM, float dL, float dU, float vM,
                                            float vL, float& mv, float& lv, int& code) {
  if (MODE == GLOBAL) {
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

// The U chain's candidate at lane k (column jcol), from M at lane k-1.
template <int MODE>
__device__ __forceinline__ float u_cand(float mprev, int jcol, float o, float e) {
  const float jf = (float)jcol;
  float c = mprev + o - e * jf;
  if (MODE == LOCAL) {  // U(i, 0) = 0 and the M(i, 0) = 0 open
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
  const Pair p(x);
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
        C[s] = u_cand<MODE>(mprev, jcol, o, e);
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
  const Pair p(x);
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
// global, 1 local, 2 fit, 3 overlap, 4 edit (scores only). `strip` lanes a
// thread (4 or 16), threads * strip >= V (and >= v_pad with pointers).
extern "C" cudaError_t at_banded_fill(int mode, int emit, const int* qs, const int* te,
                                      const int* ns, const int* ms, const float* params,
                                      float* best, float* edge, int* a, int* b, uint8_t* ptrs,
                                      int B, int m_pad, int n_ext, int band, int v_pad,
                                      int threads, int strip, cudaStream_t stream) {
  const long long V = 2LL * band + 1, lanes = (long long)threads * strip;
  const bool bad_ptrs = emit && (mode == EDIT || v_pad < V || v_pad % 16 != 0 || lanes < v_pad);
  if (B < 0 || m_pad < 0 || n_ext < 1 || band < 0 || V > MAX_LANES ||
      (strip != 4 && strip != 16) || threads < 32 || threads > MAX_THREADS ||
      threads % 32 != 0 || lanes < V || mode < GLOBAL || mode > EDIT || bad_ptrs)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const Args x{qs, te, ns, ms, params, best, edge, a, b, ptrs, m_pad, n_ext, band, v_pad};
  if (strip == 4)
    launch<4>(mode, emit != 0, B, threads, stream, x);
  else
    launch<16>(mode, emit != 0, B, threads, stream, x);
  return cudaGetLastError();
}
