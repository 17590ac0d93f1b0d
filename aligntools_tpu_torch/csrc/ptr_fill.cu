// Pointer-emitting DP fill for Hopper (sm_90a): global, local, fit(+jump)
// and overlap, one CTA per pair, every pointer of the (m_pad, n_pad) grid.
//
// Replaces ops/pallas_ptr.py:_ptr_kernel (entry pallas_ptr_fill). Outputs,
// per pair: the score, the traceback-start info a/b and the packed pointer
// tensor (B, m_pad/rpb, n_pad) of columns 1..n_pad, rpb DP rows per byte
// (row rpb*k in the low bits; layout.py). Every byte is written, pad rows
// and pad columns included: they read the sentinel chars (query pad -1,
// target pad -2) exactly as the Pallas kernel does.
//
// What bounds it here: the same per-row chain as csrc/scan_fill.cu — a
// serial walk of each thread's strip, one block scan, a second serial walk
// and two block barriers per row — plus one pointer byte per cell to device
// memory (m*n/rpb bytes per pair, the only output that scales with the
// grid; at rpb 2 it is 0.5 B/cell, so HBM at 3.35 TB/s is not the limit
// below ~6.7 Tcells/s). The design keeps every cell's work in one thread,
// folds local's running row maximum into the row's block scan (no extra
// barrier), and stages each byte-row of pointers in shared memory: a
// thread packs its own columns there across rpb rows, and after the next
// barrier the CTA stores the byte-row to device memory as contiguous 16-byte
// words. The TPU kernel's 8-row super-rows and double-buffered DMA are not
// copied: a row's bytes leave shared memory one row later, behind the
// barrier that is there anyway.
//
// Layout: thread t owns the column strip [1 + t*W, 1 + (t+1)*W) of the
// whole n_pad (W = wmax, so threads * W >= n_pad). Row state lives in
// wrapper-allocated scratch, strip-transposed (column j0+k of thread t at
// slot k*T + t). Per row i (pass 1 / scan / pass 2):
//   pass 1  M by the earliest-argument strict argmax over (L, M, U[, J]
//           [, HOME]) of row i-1 at column j-1, and L from row i-1 at j;
//           the strip's reductions for the U chain, fit's J chain and
//           local's row maximum; the M/L part of each pointer;
//   scan    exclusive prefix over threads (first barrier);
//   pass 2  U and J of the row, the pU/pJ bits, the packed byte;
//   then the start info where the mode latches it, and the second barrier.
// The diagonal across a strip edge needs the left neighbour's row i-1
// values at its last column: U and J are read from scratch (written only
// in pass 2), M and L from a shared-memory copy made in pass 2 of row i-1
// (pass 1 overwrites M and L in scratch).
//
// Exactness: values are integer-valued f32 below 2^24 with true -inf
// borders, built with --fmad=false and no fast math; each pointer is a
// comparison of such values in the Pallas code's own argument order.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -INFINITY;
constexpr int BIG = 1 << 30;
constexpr int GLOBAL = 0, LOCAL = 1, FIT = 2, OVERLAP = 3;
constexpr int MAX_THREADS = 1024;

// Exclusive prefix-max over the block's threads of NV values each, seeded
// with the column-0 term, and the block-wide maximum of each value without
// the seed. One __syncthreads(); the caller syncs again before `tot` is
// reused.
template <int NV>
__device__ __forceinline__ void scan_max(float (&v)[NV], const float (&seed)[NV],
                                         float (&total)[NV], float (&tot)[NV][32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float below[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    float x = v[c];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x = fmaxf(x, y);
    }
    if (lane == 31) tot[c][warp] = x;
    below[c] = __shfl_up_sync(0xffffffffu, x, 1);
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    float p = seed[c], all = NEG;
    for (int w = 0; w < nw; ++w) {
      if (w < warp) p = fmaxf(p, tot[c][w]);
      all = fmaxf(all, tot[c][w]);
    }
    v[c] = lane > 0 ? fmaxf(p, below[c]) : p;
    total[c] = all;
  }
}

// Block-wide max of NV floats (red_f) or min of an int (red_i); the result
// is valid in every thread. One __syncthreads(); each scratch array is used
// at most once between two of the row's barriers.
template <int NV>
__device__ __forceinline__ void reduce_max(float (&v)[NV], float (&red)[NV][32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v[c] = fmaxf(v[c], __shfl_xor_sync(0xffffffffu, v[c], d));
    if (lane == 0) red[c][warp] = v[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    float r = red[c][0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = fmaxf(r, red[c][w]);
    v[c] = r;
  }
}

__device__ __forceinline__ int reduce_min(int v, int (&red)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, d));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = min(r, red[w]);
  return r;
}

// Store the staged byte-row (n_pad bytes, a multiple of 16) as 16-byte words.
__device__ __forceinline__ void store_row(const uint8_t* stage, uint8_t* dst, int n_pad) {
  const uint4* s = reinterpret_cast<const uint4*>(stage);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int w = threadIdx.x; w < n_pad / 16; w += blockDim.x) d[w] = s[w];
}

// Per-thread strip of the pair's whole padded row: columns j0 .. j0+cnt-1.
struct Strip {
  int n, m, j0, cnt;
  size_t S, left;
  __device__ Strip(const int* ns, const int* ms, int m_pad, int n_pad, int W) {
    const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
    n = min(max(ns[b], 0), n_pad);
    m = min(max(ms[b], 0), m_pad);
    j0 = 1 + tid * W;
    cnt = max(0, min(W, n_pad - j0 + 1));
    S = (size_t)T * W;
    left = (size_t)(W - 1) * T + (tid - 1);
  }
  __device__ size_t slot(int k) const { return (size_t)k * blockDim.x + threadIdx.x; }
};

// global / local / fit (JUMP: fit's junction-gated J state, entry allowed
// where allow > 0 — the reference's inverted enum-bool quirk).
template <int MODE, bool JUMP>
__global__ void __launch_bounds__(MAX_THREADS)
ptr_affine_kernel(const int* __restrict__ qs, const int* __restrict__ ts,
                  const float* __restrict__ allow, const int* __restrict__ ns,
                  const int* __restrict__ ms, const float* __restrict__ params,
                  float* __restrict__ score_out, int* __restrict__ a_out,
                  int* __restrict__ b_out, uint8_t* __restrict__ ptrs,
                  float* __restrict__ scratch, int m_pad, int n_pad, int W, int rpb) {
  extern __shared__ __align__(16) uint8_t stage[];  // the byte-row being packed
  __shared__ float tot[3][32];
  __shared__ float red_f[2][32];
  __shared__ int red_i[32];
  __shared__ float eM[MAX_THREADS], eL[MAX_THREADS];  // row i-1, last column
  const Strip s(ns, ms, m_pad, n_pad, W);
  const int b = blockIdx.x, tid = threadIdx.x;
  const float match = params[0], mis = params[1], o = params[2], e = params[3];
  const float jp = params[4];
  const int k_home = rpb > 1 ? 3 : 4, k_unset = rpb > 1 ? 3 : 7;
  const int lbit = rpb > 1 ? 1 << 2 : 1 << 3, ubit = rpb > 1 ? 1 << 3 : 1 << 4;
  const int bits = 8 / rpb, R = m_pad / rpb;
  float* Mr = scratch + (size_t)b * (JUMP ? 7 : 5) * s.S;
  float* Lr = Mr + s.S;
  float* Ur = Lr + s.S;
  int* Tc = reinterpret_cast<int*>(Ur + s.S);
  int* Cd = Tc + s.S;  // pass 1's part of the pointer code
  float* Jr = reinterpret_cast<float*>(Cd + s.S);
  float* Jb = Jr + s.S;  // jp where entry into column j+1 is allowed
  const int* q = qs + (size_t)b * m_pad;
  const int* t = ts + (size_t)b * n_pad;
  const float* al = allow + (size_t)b * n_pad;
  uint8_t* out = ptrs + (size_t)b * R * n_pad;
  // row 0: global M = L = -inf, U = o + e*j; local zeros; fit M = U = 0,
  // L = -inf; J = -inf
  for (int k = 0; k < s.cnt; ++k) {
    const int j = s.j0 + k;
    const size_t x = s.slot(k);
    Tc[x] = t[j - 1];
    Mr[x] = MODE == GLOBAL ? NEG : 0.f;
    Lr[x] = MODE == LOCAL ? 0.f : NEG;
    Ur[x] = MODE == GLOBAL ? o + e * (float)j : 0.f;
    if (JUMP) {
      Jr[x] = NEG;
      Jb[x] = (j < n_pad && al[j] > 0.f) ? jp : NEG;
    }
  }
  if (s.cnt > 0) {
    eM[tid] = MODE == GLOBAL ? NEG : 0.f;
    eL[tid] = MODE == LOCAL ? 0.f : NEG;
  }
  // the U chain's column-0 term, U(i,0) folded in: local max(0 + o - e, 0)
  const float useed = MODE == LOCAL ? fmaxf(0.f + (o - e * 1.f), 0.f) : NEG;
  const float mborder = MODE == LOCAL ? 0.f : NEG;  // M(i, 0) of the row
  float acc_s = NEG;
  int acc_a = 0, acc_b = 0;
  __shared__ float g_s;
  __shared__ int g_a;
  if (tid == 0) {
    g_s = NEG;
    g_a = 0;
  }
  __syncthreads();
  for (int i = 1; i <= m_pad; ++i) {
    const int idx = i - 1, sub_row = idx % rpb, shift = sub_row * bits;
    if (sub_row == 0 && i > 1) store_row(stage, out + (size_t)(idx / rpb - 1) * n_pad, n_pad);
    const int qc = q[idx];
    // row i-1 at column j0-1
    float dM, dL, dU, dJ = NEG;
    if (s.j0 == 1) {
      dM = (MODE == LOCAL || i == 1) ? 0.f : NEG;
      if (MODE == GLOBAL) {
        dL = o + e * ((float)i - 1.f);
        dU = i == 1 ? o : NEG;
      } else if (MODE == LOCAL) {
        dL = dU = 0.f;
      } else {
        dL = NEG;
        dU = i == 1 ? 0.f : NEG;
      }
    } else if (s.cnt > 0) {
      dM = eM[tid - 1];
      dL = eL[tid - 1];
      dU = Ur[s.left];
      if (JUMP) dJ = Jr[s.left];
    } else {
      dM = dL = dU = NEG;
    }
    float v[3] = {NEG, NEG, NEG};  // U chain, J chain, local row max (j <= n)
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j0 + k;
      const size_t x = s.slot(k);
      const float mo = Mr[x], lo = Lr[x], uo = Ur[x];
      const float jo = JUMP ? Jr[x] : NEG;
      const float sub = Tc[x] == qc ? match : mis;
      // earliest-argument strict argmax: L, M, U, J, HOME
      float best = dL + sub;
      int pm = 0;
      float c = dM + sub;
      if (c > best) pm = 1;
      best = fmaxf(best, c);
      c = dU + sub;
      if (c > best) pm = 2;
      best = fmaxf(best, c);
      if (JUMP) {
        c = dJ + sub;
        if (c > best) pm = 3;
        best = fmaxf(best, c);
      }
      if (MODE == LOCAL) {
        if (0.f > best) pm = k_home;  // the HOME candidate has no +sub
        best = fmaxf(best, 0.f);
      }
      if (!(best > NEG)) pm = k_unset;
      const float la = lo + e, lb2 = mo + o;
      Mr[x] = best;
      Lr[x] = fmaxf(la, lb2);
      Cd[x] = pm | (la >= lb2 ? 0 : lbit);
      v[0] = fmaxf(v[0], best + (o - e * (float)(j + 1)));
      if (JUMP) v[1] = fmaxf(v[1], best + Jb[x]);
      if (MODE == LOCAL && j <= s.n) v[2] = fmaxf(v[2], best);
      dM = mo;
      dL = lo;
      dU = uo;
      dJ = jo;
    }
    const float seed[3] = {useed, NEG, NEG};
    float total[3];
    scan_max<3>(v, seed, total, tot);
    float run_u = v[0], run_j = v[1];
    float mprev = mborder, jcv = NEG;  // M(i, j-1); J entry into column j
    if (s.j0 > 1 && s.cnt > 0) {
      mprev = Mr[s.left];
      if (JUMP) jcv = mprev + Jb[s.left];
    }
    const bool last_row = i == s.m;
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j0 + k;
      const size_t x = s.slot(k);
      const float mv = Mr[x];
      const float uv = run_u + e * (float)j;
      const float ua = mprev + o;
      // U(i,j) = max(ua, U(i,j-1) + e), so ua >= U(i,j-1) + e iff ua >= U(i,j)
      int code = Cd[x] | (ua >= uv ? 0 : ubit);
      Ur[x] = uv;
      if (JUMP) {
        // J(i,j) = run_j = max(J(i,j-1), jcv): jcv >= J(i,j-1) iff jcv >= J(i,j)
        code |= (jcv > NEG && jcv >= run_j) ? 0 : 1 << 5;
        Jr[x] = run_j;
        jcv = mv + Jb[x];
        run_j = fmaxf(run_j, jcv);
      }
      stage[j - 1] = (uint8_t)(sub_row == 0 ? code : stage[j - 1] | (code << shift));
      if (MODE == GLOBAL && last_row && j == s.n) {
        const float ln = Lr[x];
        g_s = fmaxf(fmaxf(ln, mv), uv);
        g_a = (ln >= mv && ln >= uv) ? 0 : (mv >= uv ? 1 : 2);
      }
      run_u = fmaxf(run_u, mv + (o - e * (float)(j + 1)));
      mprev = mv;
    }
    if (s.cnt > 0) {
      const size_t x = s.slot(s.cnt - 1);
      eM[tid] = Mr[x];
      eL[tid] = Lr[x];
    }
    if (MODE == LOCAL && i <= s.m && total[2] > acc_s) {
      // a strictly greater row maximum: its first column over j <= n
      int fj = BIG;
      for (int k = 0; k < s.cnt && fj == BIG; ++k)
        if (s.j0 + k <= s.n && Mr[s.slot(k)] == total[2]) fj = s.j0 + k;
      acc_b = reduce_min(fj, red_i);
      acc_s = total[2];
      acc_a = i;
    }
    if (MODE == FIT && last_row) {
      // the bottom row over columns 1..n-1; L wins only when strictly greater
      float mx[2] = {NEG, NEG};
      for (int k = 0; k < s.cnt; ++k) {
        if (s.j0 + k > s.n - 1) break;
        mx[0] = fmaxf(mx[0], Mr[s.slot(k)]);
        mx[1] = fmaxf(mx[1], Lr[s.slot(k)]);
      }
      reduce_max<2>(mx, red_f);
      const bool use_l = mx[1] > mx[0];
      const float want = use_l ? mx[1] : mx[0];
      const float* row = use_l ? Lr : Mr;
      int fj = BIG;
      for (int k = 0; k < s.cnt && fj == BIG; ++k)
        if (s.j0 + k <= s.n - 1 && row[s.slot(k)] == want) fj = s.j0 + k;
      acc_b = reduce_min(fj, red_i);
      acc_s = fmaxf(mx[0], mx[1]);
      acc_a = use_l ? 1 : 0;
    }
    __syncthreads();
  }
  store_row(stage, out + (size_t)(R - 1) * n_pad, n_pad);
  if (tid == 0) {
    score_out[b] = MODE == GLOBAL ? g_s : acc_s;
    a_out[b] = MODE == GLOBAL ? g_a : acc_a;
    b_out[b] = acc_b;
  }
}

// overlap: one matrix, linear gap o; codes LEFT/DIAG/RIGHT = 0/1/2, 3 where
// the cell is -inf (alignment.h:944's argument order).
__global__ void __launch_bounds__(MAX_THREADS)
ptr_overlap_kernel(const int* __restrict__ qs, const int* __restrict__ ts,
                   const int* __restrict__ ns, const int* __restrict__ ms,
                   const float* __restrict__ params, float* __restrict__ score_out,
                   int* __restrict__ a_out, int* __restrict__ b_out,
                   uint8_t* __restrict__ ptrs, float* __restrict__ scratch, int m_pad,
                   int n_pad, int W, int rpb) {
  extern __shared__ __align__(16) uint8_t stage[];
  __shared__ float tot[1][32];
  __shared__ float red_f[1][32];
  __shared__ int red_i[32];
  const Strip s(ns, ms, m_pad, n_pad, W);
  const int b = blockIdx.x, tid = threadIdx.x;
  const float match = params[0], mis = params[1], o = params[2];
  const int bits = 8 / rpb, R = m_pad / rpb;
  float* Mr = scratch + (size_t)b * 4 * s.S;
  float* Dr = Mr + s.S;  // max(DIAG, RIGHT) of the row
  int* Tc = reinterpret_cast<int*>(Dr + s.S);
  int* Cd = Tc + s.S;  // DIAG (1) or RIGHT (2)
  const int* q = qs + (size_t)b * m_pad;
  const int* t = ts + (size_t)b * n_pad;
  uint8_t* out = ptrs + (size_t)b * R * n_pad;
  for (int k = 0; k < s.cnt; ++k) {
    const size_t x = s.slot(k);
    Tc[x] = t[s.j0 + k - 1];
    Mr[x] = NEG;  // row 0 is -inf past column 0
  }
  float acc_s = NEG;
  int acc_a = 0;
  __syncthreads();
  for (int i = 1; i <= m_pad; ++i) {
    const int idx = i - 1, sub_row = idx % rpb, shift = sub_row * bits;
    if (sub_row == 0 && i > 1) store_row(stage, out + (size_t)(idx / rpb - 1) * n_pad, n_pad);
    const int qc = q[idx];
    // M(i-1, j0-1): the column-0 border is 0; Mr is rewritten only in pass 2
    float dM = s.j0 == 1 ? 0.f : (s.cnt > 0 ? Mr[s.left] : NEG);
    float v[1] = {NEG};
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j0 + k;
      const size_t x = s.slot(k);
      const float mp = Mr[x];
      const float sub = Tc[x] == qc ? match : mis;
      const float diag = dM + sub, right = mp + o;
      const float dr = fmaxf(diag, right);
      Dr[x] = dr;
      Cd[x] = diag >= right ? 1 : 2;
      v[0] = fmaxf(v[0], dr - o * (float)j);
      dM = mp;
    }
    const float seed[1] = {0.f};  // M(i, 0) = 0
    float total[1];
    scan_max<1>(v, seed, total, tot);
    float run = v[0];
    // M(i, j0-1), as the left neighbour computes it
    float mprev = run + o * (float)(s.j0 - 1);
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j0 + k;
      const size_t x = s.slot(k);
      const float dr = Dr[x];
      const float left = mprev + o;
      const float val = fmaxf(left, dr);
      int code = left >= val ? 0 : Cd[x];
      if (!(val > NEG)) code = 3;
      stage[j - 1] = (uint8_t)(sub_row == 0 ? code : stage[j - 1] | (code << shift));
      run = fmaxf(run, dr - o * (float)j);
      const float mv = run + o * (float)j;
      Mr[x] = mv;
      mprev = mv;
    }
    if (i == s.m) {
      // the bottom row over columns 1..n-1, with the j = 0 zero candidate
      float mx[1] = {NEG};
      for (int k = 0; k < s.cnt && s.j0 + k <= s.n - 1; ++k) mx[0] = fmaxf(mx[0], Mr[s.slot(k)]);
      reduce_max<1>(mx, red_f);
      int fj = BIG;
      for (int k = 0; k < s.cnt && fj == BIG; ++k)
        if (s.j0 + k <= s.n - 1 && Mr[s.slot(k)] == mx[0]) fj = s.j0 + k;
      fj = reduce_min(fj, red_i);
      acc_s = fmaxf(mx[0], 0.f);
      acc_a = mx[0] > 0.f ? fj : 0;
    }
    __syncthreads();
  }
  store_row(stage, out + (size_t)(R - 1) * n_pad, n_pad);
  if (tid == 0) {
    score_out[b] = acc_s;
    a_out[b] = acc_a;
    b_out[b] = 0;
  }
}

template <int MODE, bool JUMP>
void launch_affine(int B, int threads, size_t smem, cudaStream_t stream, const int* qs,
                   const int* ts, const float* allow, const int* ns, const int* ms,
                   const float* params, float* score, int* a, int* b, uint8_t* ptrs,
                   float* scratch, int m_pad, int n_pad, int wmax, int rpb) {
  ptr_affine_kernel<MODE, JUMP><<<B, threads, smem, stream>>>(
      qs, ts, allow, ns, ms, params, score, a, b, ptrs, scratch, m_pad, n_pad, wmax, rpb);
}

}  // namespace

// C entry point, bound with ctypes: launches one fill on `stream` without
// synchronising and returns the launch's error code. mode: 0 global,
// 1 local, 2 fit, 3 overlap.
extern "C" cudaError_t at_ptr_fill(int mode, int use_jump, int rpb, const int* qs,
                                   const int* ts, const float* allow, const int* ns,
                                   const int* ms, const float* params, float* score,
                                   int* a, int* b, uint8_t* ptrs, float* scratch, int B,
                                   int m_pad, int n_pad, int threads, int wmax,
                                   cudaStream_t stream) {
  const bool bad_layout = (rpb != 1 && rpb != 2 && rpb != 4) || m_pad <= 0 ||
                          m_pad % rpb != 0 || (rpb > 1 && use_jump) ||
                          (rpb == 4 && mode != OVERLAP) || (use_jump && mode != FIT);
  if (B < 0 || threads < 32 || threads > MAX_THREADS || threads % 32 != 0 ||
      (long long)threads * wmax < n_pad || n_pad % 16 != 0 || n_pad > 32768 ||
      mode < GLOBAL || mode > OVERLAP || bad_layout)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const size_t smem = (size_t)n_pad;  // the staged byte-row
  if (mode == OVERLAP)
    ptr_overlap_kernel<<<B, threads, smem, stream>>>(qs, ts, ns, ms, params, score, a, b,
                                                     ptrs, scratch, m_pad, n_pad, wmax, rpb);
  else if (mode == GLOBAL)
    launch_affine<GLOBAL, false>(B, threads, smem, stream, qs, ts, allow, ns, ms, params,
                                 score, a, b, ptrs, scratch, m_pad, n_pad, wmax, rpb);
  else if (mode == LOCAL)
    launch_affine<LOCAL, false>(B, threads, smem, stream, qs, ts, allow, ns, ms, params,
                                score, a, b, ptrs, scratch, m_pad, n_pad, wmax, rpb);
  else if (use_jump)
    launch_affine<FIT, true>(B, threads, smem, stream, qs, ts, allow, ns, ms, params,
                             score, a, b, ptrs, scratch, m_pad, n_pad, wmax, rpb);
  else
    launch_affine<FIT, false>(B, threads, smem, stream, qs, ts, allow, ns, ms, params,
                              score, a, b, ptrs, scratch, m_pad, n_pad, wmax, rpb);
  return cudaGetLastError();
}
