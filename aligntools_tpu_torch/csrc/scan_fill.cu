// Score-only edit-distance fill for Hopper (sm_90a), one CTA per pair.
// (The global, local, fit(+jump) and overlap score fills are the score-only
// instances of csrc/ptr_fill.cu's register-strip kernels.)
//
// Layout. Thread t of a CTA owns the contiguous column strip j in
// [1 + t*W, 1 + (t+1)*W) of its pair, W = ceil(n / T). Each query row
// i = 1..m is one step:
//   pass 1  each thread walks its strip left to right: the cells that
//           depend only on row i-1 (the diagonal, the cell above) and the
//           strip's reduction of its contributions to the in-row chain;
//   scan    warp shuffles plus one shared-memory round give every thread
//           the exact prefix of the strips to its left (first sync);
//   pass 2  each thread finishes its strip's left chain and stores the row;
//   then a second __syncthreads() makes the row visible to the neighbour
//   that reads its last column as the next row's diagonal.
// Every thread reaches both syncs; threads past the pair's n simply own
// an empty strip. Row state lives in wrapper-allocated scratch, stored
// strip-transposed (column j0+k of thread t at slot k*T + t) so a warp's
// accesses at one k are contiguous.
//
// Exactness: edit distances are computed in int32, each add in the same
// order as the plain PyTorch version.

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

// Replaces ops/pallas_scan.py:_edit_kernel (min-plus, indel 1, substitution
// cost params[1]), in int32. Bound by the per-row serial strip walk plus two
// block barriers; row state is ~12 B/cell of L1/L2 traffic (3 scratch rows
// of the pair, L2-resident at the slice's shapes), so neither HBM nor
// operations bound it.
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

bool bad_shape(int B, int threads, int wmax, int n_pad) {
  return B < 0 || threads < 32 || threads > 1024 || threads % 32 != 0 ||
         (long long)threads * wmax < n_pad;
}

}  // namespace

// C entry point, bound with ctypes: launches the kernel on `stream`
// without synchronising and returns the launch's error code.
extern "C" {

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

}  // extern "C"
