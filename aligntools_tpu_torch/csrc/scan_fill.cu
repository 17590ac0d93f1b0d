// Score-only DP fills for Hopper (sm_90a): overlap, edit and fit(+jump), one
// CTA per pair. (The global / local score fill is the score-only instance of
// csrc/ptr_fill.cu's register-strip kernel.)
//
// Layout shared by the three kernels. Thread t of a CTA owns the contiguous
// column strip j in [1 + t*W, 1 + (t+1)*W) of its pair, W = ceil(n / T).
// Each query row i = 1..m is one step:
//   pass 1  each thread walks its strip left to right: the cells that
//           depend only on row i-1 (diagonal, the L state) and the strip's
//           reduction of its contributions to the in-row chain;
//   scan    warp shuffles plus one shared-memory round give every thread
//           the exact prefix of the strips to its left (first sync);
//   pass 2  each thread finishes its strip's in-row chain (U, fit's J,
//           overlap's and edit's left chain) and stores the row;
//   then a second __syncthreads() makes the row visible to the neighbour
//   that reads its last column as the next row's diagonal.
// Every thread reaches both syncs; threads past the pair's n simply own
// an empty strip. Row state lives in wrapper-allocated scratch, stored
// strip-transposed (column j0+k of thread t at slot k*T + t) so a warp's
// accesses at one k are contiguous.
//
// Exactness: scores are integer-valued f32 below 2^24 with true -inf
// borders, so every max/min is exact and each add is performed in the
// same order as the plain PyTorch version (built with --fmad=false, never
// with fast math). Edit distances are computed in int32.

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

// This thread's strip of its pair: columns j0 .. j0+cnt-1 (1-based).
struct Strip {
  int n, m, W, j0, cnt;
  size_t S;     // slots per scratch row buffer
  size_t left;  // slot of the left neighbour's last column (tid > 0)
  __device__ Strip(const int* ns, const int* ms, int m_pad, int n_pad, int wmax) {
    const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
    n = min(max(ns[b], 0), n_pad);
    m = min(max(ms[b], 0), m_pad);
    W = (n + T - 1) / T;
    j0 = 1 + tid * W;
    cnt = max(0, min(W, n - j0 + 1));
    S = (size_t)T * wmax;
    left = (size_t)(W - 1) * T + (tid - 1);
  }
  __device__ size_t slot(int k) const { return (size_t)k * blockDim.x + threadIdx.x; }
};

// Replaces ops/pallas_scan.py:_overlap_kernel (one matrix, linear gap o).
// Bound by the per-row serial strip walk plus two block barriers; row state
// is ~12 B/cell of L1/L2 traffic (3 scratch rows of the pair, L2-resident at
// the slice's shapes), so neither HBM nor FLOPs bound it.
__global__ void __launch_bounds__(1024)
overlap_kernel(const int* __restrict__ qs, const int* __restrict__ ts,
               const int* __restrict__ ns, const int* __restrict__ ms,
               const float* __restrict__ params, float* __restrict__ out,
               float* __restrict__ scratch, int m_pad, int n_pad, int wmax) {
  __shared__ float tot[1][32];
  const Strip s(ns, ms, m_pad, n_pad, wmax);
  const int b = blockIdx.x;
  const float match = params[0], mis = params[1], o = params[2];
  float* Mr = scratch + (size_t)b * 3 * s.S;
  float* Cr = Mr + s.S;  // this row's candidates, normalized by -o*j
  int* Tc = reinterpret_cast<int*>(Cr + s.S);
  const int* q = qs + (size_t)b * m_pad;
  const int* t = ts + (size_t)b * n_pad;
  for (int k = 0; k < s.cnt; ++k) {
    const size_t x = s.slot(k);
    Tc[x] = t[s.j0 + k - 1];
    Mr[x] = NEG;  // row 0 is -inf past column 0
  }
  const float seed[1] = {0.f};  // M(i, 0) = 0
  float acc = NEG;
  __syncthreads();
  for (int i = 1; i <= s.m; ++i) {
    const int qc = q[i - 1];
    float diag = s.j0 == 1 ? 0.f : (s.cnt > 0 ? Mr[s.left] : NEG);
    float agg[1] = {NEG};
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j0 + k;
      const size_t x = s.slot(k);
      const float mp = Mr[x];
      const float sub = Tc[x] == qc ? match : mis;
      const float dr = fmaxf(diag + sub, mp + o);
      const float c = dr - o * (float)j;
      Cr[x] = c;
      agg[0] = fmaxf(agg[0], c);
      diag = mp;
    }
    block_exclusive<MaxF>(agg, seed, tot);
    float run = agg[0];
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j0 + k;
      const size_t x = s.slot(k);
      run = fmaxf(run, Cr[x]);
      const float mv = run + o * (float)j;
      Mr[x] = mv;
      if (i == s.m && j <= s.n - 1) acc = fmaxf(acc, mv);
    }
    __syncthreads();
  }
  const float r = block_reduce<MaxF>(acc, tot[0]);
  // the j = 0 border contributes its 0; + 0.f turns a -0 into +0
  if (threadIdx.x == 0) out[b] = fmaxf(r, 0.f) + 0.f;
}

// Replaces ops/pallas_scan.py:_edit_kernel (min-plus, indel 1, substitution
// cost params[1]), in int32. Bound like the overlap kernel.
__global__ void __launch_bounds__(1024)
edit_kernel(const int* __restrict__ qs, const int* __restrict__ ts,
            const int* __restrict__ ns, const int* __restrict__ ms,
            const float* __restrict__ params, int* __restrict__ out,
            float* __restrict__ scratch, int m_pad, int n_pad, int wmax) {
  __shared__ int tot[1][32];
  const Strip s(ns, ms, m_pad, n_pad, wmax);
  const int b = blockIdx.x;
  const int u = (int)params[1];
  int* Pr = reinterpret_cast<int*>(scratch) + (size_t)b * 3 * s.S;
  int* Cr = Pr + s.S;  // this row's candidates, normalized by -j
  int* Tc = Cr + s.S;
  const int* q = qs + (size_t)b * m_pad;
  const int* t = ts + (size_t)b * n_pad;
  for (int k = 0; k < s.cnt; ++k) {
    const size_t x = s.slot(k);
    Tc[x] = t[s.j0 + k - 1];
    Pr[x] = s.j0 + k;  // M(0, j) = j
  }
  // the thread owning column n holds the result; before any row it is
  // M(0, n)'s latch value 0, as in the Pallas kernel. INT_MAX is the
  // identity elsewhere (and the result when n == 0).
  const bool owns_n = s.cnt > 0 && s.j0 + s.cnt - 1 == s.n;
  int acc = owns_n ? 0 : INT_MAX;
  __syncthreads();
  for (int i = 1; i <= s.m; ++i) {
    const int qc = q[i - 1];
    int diag = s.j0 == 1 ? i - 1 : (s.cnt > 0 ? Pr[s.left] : 0);
    int agg[1] = {INT_MAX};
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j0 + k;
      const size_t x = s.slot(k);
      const int pp = Pr[x];
      const int sub = Tc[x] == qc ? 0 : u;
      const int c = min(diag + sub, pp + 1) - j;
      Cr[x] = c;
      agg[0] = min(agg[0], c);
      diag = pp;
    }
    const int seed[1] = {i};  // M(i, 0) = i
    block_exclusive<MinI>(agg, seed, tot);
    int run = agg[0];
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j0 + k;
      const size_t x = s.slot(k);
      run = min(run, Cr[x]);
      const int v = run + j;
      Pr[x] = v;
      if (i == s.m && j == s.n) acc = v;
    }
    __syncthreads();
  }
  const int r = block_reduce<MinI>(acc, tot[0]);
  if (threadIdx.x == 0) out[b] = r;
}

// Replaces ops/pallas_scan.py:_fit_kernel (M, L, U and, with JUMP, the
// junction-gated J state whose entry is allowed where allow > 0: the
// reference's inverted enum-bool quirk). Bound like the overlap kernel, with
// five scratch rows (M, L, max(L, M, U, J), the per-column jump bias, the
// chars) and a second value in the same block scan.
template <bool JUMP>
__global__ void __launch_bounds__(1024)
fit_kernel(const int* __restrict__ qs, const int* __restrict__ ts,
           const float* __restrict__ allow, const int* __restrict__ ns,
           const int* __restrict__ ms, const float* __restrict__ params,
           float* __restrict__ out, float* __restrict__ scratch, int m_pad,
           int n_pad, int wmax) {
  __shared__ float tot[2][32];
  const Strip s(ns, ms, m_pad, n_pad, wmax);
  const int b = blockIdx.x;
  const float match = params[0], mis = params[1], o = params[2], e = params[3];
  const float jp = params[4];
  float* Mr = scratch + (size_t)b * 5 * s.S;
  float* Lr = Mr + s.S;
  float* Br = Lr + s.S;
  float* Jb = Br + s.S;  // jump bias of M at column j: jp where allowed
  int* Tc = reinterpret_cast<int*>(Jb + s.S);
  const int* q = qs + (size_t)b * m_pad;
  const int* t = ts + (size_t)b * n_pad;
  const float* al = allow + (size_t)b * n_pad;
  // row 0: M = U = 0, L = J = -inf, so max(M, L, U, J) = 0
  for (int k = 0; k < s.cnt; ++k) {
    const int j = s.j0 + k;
    const size_t x = s.slot(k);
    Tc[x] = t[j - 1];
    Mr[x] = 0.f;
    Lr[x] = NEG;
    Br[x] = 0.f;
    if (JUMP) Jb[x] = (j < n_pad && al[j] > 0.f) ? jp : NEG;
  }
  const float seed[2] = {NEG, NEG};  // U(i,0) and J(i,0) are -inf
  float acc = NEG;
  __syncthreads();
  for (int i = 1; i <= s.m; ++i) {
    const int qc = q[i - 1];
    float diag;  // the column-0 diagonal border is 0 only at i = 1
    if (s.j0 == 1)
      diag = i == 1 ? 0.f : NEG;
    else
      diag = s.cnt > 0 ? Br[s.left] : NEG;
    float agg[2] = {NEG, NEG};
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j0 + k;
      const size_t x = s.slot(k);
      const float bold = Br[x];
      const float sub = Tc[x] == qc ? match : mis;
      const float mv = diag + sub;
      const float lv = fmaxf(Lr[x] + e, Mr[x] + o);
      Mr[x] = mv;
      Lr[x] = lv;
      agg[0] = fmaxf(agg[0], mv + (o - e * (float)(j + 1)));
      if (JUMP) agg[1] = fmaxf(agg[1], mv + Jb[x]);
      diag = bold;
    }
    block_exclusive<MaxF>(agg, seed, tot);
    float run_u = agg[0], run_j = agg[1];
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j0 + k;
      const size_t x = s.slot(k);
      const float mv = Mr[x], lv = Lr[x];
      const float uv = run_u + e * (float)j;
      const float bml = fmaxf(mv, lv);
      float best = fmaxf(bml, uv);
      if (JUMP) best = fmaxf(best, run_j);
      Br[x] = best;
      run_u = fmaxf(run_u, mv + (o - e * (float)(j + 1)));
      if (JUMP) run_j = fmaxf(run_j, mv + Jb[x]);
      // score: max(M, L) of row m over j in [1, n-1]; U is excluded
      if (i == s.m && j <= s.n - 1) acc = fmaxf(acc, bml);
    }
    __syncthreads();
  }
  const float r = block_reduce<MaxF>(acc, tot[0]);
  if (threadIdx.x == 0) out[b] = r;
}

bool bad_shape(int B, int threads, int wmax, int n_pad) {
  return B < 0 || threads < 32 || threads > 1024 || threads % 32 != 0 ||
         (long long)threads * wmax < n_pad;
}

}  // namespace

// C entry points, bound with ctypes. Each launches one kernel on `stream`
// without synchronising and returns the launch's error code.
extern "C" {

cudaError_t at_overlap_scores(const int* qs, const int* ts, const int* ns,
                              const int* ms, const float* params, float* out,
                              float* scratch, int B, int m_pad, int n_pad,
                              int threads, int wmax, cudaStream_t stream) {
  if (bad_shape(B, threads, wmax, n_pad)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  overlap_kernel<<<B, threads, 0, stream>>>(qs, ts, ns, ms, params, out, scratch,
                                            m_pad, n_pad, wmax);
  return cudaGetLastError();
}

cudaError_t at_edit_scores(const int* qs, const int* ts, const int* ns,
                           const int* ms, const float* params, int* out,
                           float* scratch, int B, int m_pad, int n_pad,
                           int threads, int wmax, cudaStream_t stream) {
  if (bad_shape(B, threads, wmax, n_pad)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  edit_kernel<<<B, threads, 0, stream>>>(qs, ts, ns, ms, params, out, scratch,
                                         m_pad, n_pad, wmax);
  return cudaGetLastError();
}

cudaError_t at_fit_scores(int use_jump, const int* qs, const int* ts,
                          const float* allow, const int* ns, const int* ms,
                          const float* params, float* out, float* scratch, int B,
                          int m_pad, int n_pad, int threads, int wmax,
                          cudaStream_t stream) {
  if (bad_shape(B, threads, wmax, n_pad)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  if (use_jump)
    fit_kernel<true><<<B, threads, 0, stream>>>(qs, ts, allow, ns, ms, params, out,
                                                scratch, m_pad, n_pad, wmax);
  else
    fit_kernel<false><<<B, threads, 0, stream>>>(qs, ts, allow, ns, ms, params,
                                                 out, scratch, m_pad, n_pad, wmax);
  return cudaGetLastError();
}

}  // extern "C"
