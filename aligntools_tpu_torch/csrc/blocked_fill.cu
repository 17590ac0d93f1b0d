// Column-blocked DP fills for Hopper (sm_90a): targets past the flat
// register-strip fills' widest (ops/scan.blocked_c_blk, ops/ptr.blocked_c_blk:
// 8,192 columns; 16,384 for edit's score fill), cut into c_blk-wide column
// blocks that run as a wavefront, one CTA per (pair, column block).
//
// Replaces ops/pallas_blocked.py:
//   :48 _blocked_affine_kernel (entry blocked_scores): the score fill of
//     global, local, fit(+jump), overlap and edit (edit in int32 here; the
//     Pallas kernel carries it in f32);
//   :375 _blocked_ptr_kernel (entry blocked_ptr_fill): the fill with packed
//     pointers and traceback-start info for global, local, fit(+jump) and
//     overlap, rpb DP rows per byte (1, 2, or 4 for overlap).
// Both compute exactly the flat fills' function (csrc/ptr_fill.cu; the
// plain versions ops/scan.py and ops/ptr.py): the same
// scores, start info and pointer bytes, pad rows and pad columns included.
//
// Design. The grid holds one CTA for each (pair, column block). Inside its
// block a CTA runs the flat kernels' strip machinery over c_blk columns:
// thread t owns the block-local columns [t*W, (t+1)*W), and each query row
// is a serial pass, a block scan for the in-row chain (U, fit's J, overlap's
// and edit's left chains), a second serial pass and a barrier. The block's
// row state (the previous row's values, the block's target chars, the jump
// bias, the pointer codes and the byte-row being packed) lives in dynamic
// shared memory, strip-transposed (block-local column t*W + k at slot
// k*T + t), so a cell's loads and stores never leave the SM.
//
// Between blocks the only state is each row's values at a block's last
// column: M, L, U, J (the score fills keep max(L, M, U, J) in place of L,
// which is all the next block's diagonal reads). Block c writes row i's edge
// to its own (pair, block) slice of a wrapper-allocated device buffer, and
// the thread that owns its last column then stores i to the block's progress
// counter with release semantics (st.release.gpu). Row i of block c+1 reads
// rows i-1 (the diagonal shift-in) and i (the chains' seeds) of that edge:
// after its first pass over row i, its thread 0 waits with acquire loads
// until block c's counter reaches i (it keeps the count it saw and polls
// again only when i passes it), reads the edge through L2 (__ldcg: another
// SM wrote it) and leaves it in shared memory, where the other threads read
// it behind the block scan's barrier. So block c+1 runs about a row behind
// block c, and all the blocks of a pair fill at once. Column-0 borders apply
// in block 0 only; the row-0 edge is analytic in every block; every in-row
// chain continues across blocks by its global column index (U's seed
// U(i, col0) - e*col0, overlap's M(i, col0) - o*col0, edit's
// M(i, col0) - col0, fit's J carried flat).
//
// No CTA waits on one that is not running, whatever order the hardware
// starts CTAs in: each CTA takes a ticket from a per-launch counter on entry
// and maps it block-major (block 0 of every pair, then block 1, ...), so the
// block it waits on took a lower ticket and is running or done (the
// decoupled look-back rule of single-pass scans). The wrapper zeroes the
// ticket, progress and done counters for every launch. A score fill's
// blocks past the pair's n exit at once: every later block of the pair is
// past n too, so none waits on them. A pointer fill fills every block, since
// every pointer byte is written.
//
// Start info merges across blocks as the Pallas kernel merges it, in block
// order: global latches in the block that holds column n; local keeps the
// block's strict running row-major maximum and takes a later block's only
// on a greater score or an equal one at a smaller row; fit takes block 0's
// bottom row, then a later block's on a greater score, or on an equal one
// from M where the kept one is from L, or from the same matrix at a smaller
// j; overlap's j = 0 zero candidate exists in block 0 only; the score fills
// take the maximum (edit the minimum) of the blocks' values. Each CTA leaves
// its block's candidate in a (pair, block) slot, and the CTA that finishes
// the pair's last block (a per-pair done counter behind __threadfence, as in
// CUDA's threadFenceReduction sample) merges them and writes the outputs.
// Pointer bytes are staged in shared memory as one c_blk-wide byte-row
// (row rpb*k in the low bits) and stored to ptrs[b, r, col0 : col0 + c_blk]
// as 16-byte words; every offset into the pointer tensor is 64-bit (a
// long-target bucket's tensor passes 2^31 bytes). The pointer fills take an
// n_pad that c_blk does not divide (flat buckets past
// ops/ptr.FLAT_REG_MAX_N_PAD): the last block is n_pad - col0 columns wide
// (a multiple of 16), which bounds its strips, its staged byte-row and its
// stores. So do the score fills (flat global / local buckets past
// ops/ptr.FLAT_REG_MAX_N_PAD): a block covers at most the pair's n columns,
// so the ragged last block only changes the grid.
//
// What bounds it on this card: the per-row chain, as in the flat fills: two
// barriers and a block scan per row and block, and W serial cells a thread
// in each pass, with the row state in shared memory; across blocks, one
// release store a row in the publishing block and an acquire poll a row in
// the next, which sit on that chain. The pointer bytes (m_pad*n_pad/rpb a
// pair) are far below HBM's rate. The grid is B x ceil(n_pad/c_blk) CTAs (a
// long-target bucket of ~10 pairs at c_blk 2,048: 240-640), in flight as
// far as shared memory allows (fit+jump's pointer fill takes 26 bytes a
// column: four CTAs an SM at 2,048) and, in a pair, by the wavefront's fill
// and drain: its last block starts its first row n_pad/c_blk - 1 rows after
// block 0.
//
// Exactness: values are integer-valued f32 below 2^24 with true -inf
// borders (edit: int32), built with --fmad=false and no fast math; each
// pointer is a comparison of such values in the Pallas code's argument
// order, so the results do not depend on c_blk.
//
// The checkpoint-rescan engine (engine/rescan.py, the counterpart of
// aligntools_tpu/engine/rescan.py's _forward_ckpt and _refill_block, which
// run engine/scan.py's row machines under lax.scan) takes two more
// instances of the pointer fills, a template phase each:
//   CKPT  the forward fill of the whole matrix with no pointer stores: start
//         info as in FILL, and every row that is a multiple of the stride S
//         (row 0, the border, included) written as the (M, L, U[, J]; overlap
//         M) state rows of its columns 0..n_pad into a (B, m_pad/S, states,
//         n_pad+1) float32 checkpoint tensor (entries at_blocked_ckpt_fill);
//   SEED  the refill of one row block: rows i0+1 .. i0+S, the block's row 0
//         read from its checkpoint in place of the analytic row 0 (block c
//         reads column col0 of it as its edge), column 0's borders at the
//         global row i0+i; pointers as in FILL, no start info
//         (at_blocked_refill).
// The recurrences, tie-breaks and the wavefront are FILL's, so a refilled
// block's bytes are the whole-matrix fill's rows i0+1 .. i0+S, bit for bit.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int BIG = 1 << 30;
constexpr int GLOBAL = 0, LOCAL = 1, FIT = 2, OVERLAP = 3, EDIT = 4;
constexpr int MAX_THREADS = 1024;

// This thread's strip of one column block: block-local columns k0 ..
// k0+cnt-1 of the block's first `ncols`, global columns col0+1+k0+k.
struct Strip {
  int col0, k0, cnt;
  size_t left;  // slot of the left neighbour's last column (tid > 0)
  __device__ Strip(int col0_, int ncols, int W)
      : col0(col0_), k0(threadIdx.x * W), cnt(max(0, min(W, ncols - (int)threadIdx.x * W))),
        left((size_t)(W - 1) * blockDim.x + (threadIdx.x - 1)) {}
  __device__ size_t slot(int k) const { return (size_t)k * blockDim.x + threadIdx.x; }
  __device__ int j(int k) const { return col0 + 1 + k0 + k; }  // global column
  // holds the block's last column
  __device__ bool owns_last(int ncols) const { return cnt > 0 && k0 + cnt == ncols; }
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The CTA's ticket, taken on entry; the same in every thread.
__device__ __forceinline__ int take_ticket(int* counter, int* shared_ticket) {
  if (threadIdx.x == 0) *shared_ticket = atomicAdd(counter, 1);
  __syncthreads();
  return *shared_ticket;
}

// This CTA's place in the wavefront, from its ticket. `flags` is the ticket
// counter, then per pair nblk progress counters (rows of the block's edge
// published) and one done counter (blocks finished); `edges` holds per
// (pair, block) four edge states of rows 0..m_pad; `cand` per (pair, block)
// the block's start-info candidate.
struct Wave {
  int b, c, rows;
  int* prog;
  int* done;
  int4* cand;
  const float* ep;  // block c-1's edges (c > 0)
  float* en;        // this block's edges
  int seen;         // thread 0: rows of block c-1's edge seen published
  __device__ Wave(int ticket, int nblk, int* flags, float* edges, int4* cand_, int m_pad) {
    const int B = gridDim.x / nblk;
    b = ticket % B;
    c = ticket / B;
    rows = m_pad + 1;
    prog = flags + 1 + (size_t)b * (nblk + 1);
    done = prog + nblk;
    cand = cand_ + (size_t)b * nblk;
    en = edges + ((size_t)b * nblk + c) * 4 * rows;
    ep = en - (size_t)4 * rows;
    seen = 0;
  }
  // thread 0, before it reads rows <= i of block c-1's edge
  __device__ void wait(int i) {
    while (seen < i) seen = ld_acquire(prog + c - 1);
  }
  __device__ float edge(int s, int i) const { return __ldcg(ep + (size_t)s * rows + i); }
  __device__ int edge_i(int i) const { return __ldcg(reinterpret_cast<const int*>(ep) + i); }
  __device__ void put(int s, int i, float v) const { en[(size_t)s * rows + i] = v; }
  // the owner of the block's last column, after its edge stores of row i
  __device__ void publish(int i) const { st_release(prog + c, i); }
  // thread 0: leave this block's candidate; true in the CTA that finishes
  // the pair's `parts`-th block, which may then read every candidate
  __device__ bool finish(int4 v, int parts) const {
    cand[c] = v;
    __threadfence();
    if (atomicAdd(done, 1) != parts - 1) return false;
    __threadfence();
    return true;
  }
  __device__ int4 candidate(int k) const { return __ldcg(cand + k); }
};

__device__ __forceinline__ int4 pack(float s, int a = 0, int b = 0) {
  return make_int4(__float_as_int(s), a, b, 0);
}

// ---------------------------------------------------------------------------
// Score fills
// ---------------------------------------------------------------------------

// Edge states of the affine score fills: max(L, M, U[, J]), M, U, J.
constexpr int SB = 0, SM = 1, SU = 2, SJ = 3;

// State s of (row i, column col0) as block c reads it: column 0's border in
// block 0, row 0's analytic value, else block c-1's edge.
template <int MODE>
__device__ __forceinline__ float score_edge(int s, int c, int i, int col0, float o, float e,
                                            const Wave& w) {
  if (c == 0) {
    if (s == SJ) return NEG;
    if (MODE == LOCAL) return 0.f;
    if (MODE == GLOBAL && s == SB) return i == 0 ? 0.f : o + e * (float)i;
    if (i > 0) return NEG;
    return (MODE == GLOBAL && s == SU) ? o : 0.f;
  }
  if (i == 0) {
    if (s == SJ) return NEG;
    if (MODE == GLOBAL) return s == SM ? NEG : o + e * (float)col0;
    return 0.f;
  }
  return w.edge(s, i);
}

// Replaces the global / local / fit(+jump) branches of
// _blocked_affine_kernel. Per slot: M, L, max(L, M, U[, J]) of the row, the
// jump bias (JUMP) and the target char.
template <int MODE, bool JUMP>
__global__ void __launch_bounds__(MAX_THREADS)
bscore_affine(const int* __restrict__ qs, const int* __restrict__ ts,
              const float* __restrict__ allow, const int* __restrict__ ns,
              const int* __restrict__ ms, const float* __restrict__ params,
              float* __restrict__ out, float* edges, int* flags, int4* cand, int m_pad,
              int n_pad, int c_blk, int W) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float tot[2][32];
  __shared__ float eg[4];  // row i's edge at col0, from thread 0
  __shared__ int ticket;
  Wave w(take_ticket(flags, &ticket), (n_pad + c_blk - 1) / c_blk, flags, edges, cand, m_pad);
  const int b = w.b, c = w.c, tid = threadIdx.x;
  const int n = min(max(ns[b], 0), n_pad), m = min(max(ms[b], 0), m_pad);
  const int nb = max(1, (n + c_blk - 1) / c_blk);  // the blocks that hold columns <= n
  if (c >= nb) return;
  const size_t S = (size_t)blockDim.x * W;
  float* Mr = reinterpret_cast<float*>(smem);
  float* Lr = Mr + S;
  float* Br = Lr + S;
  float* Jb = Br + S;  // jp where entry into column j+1 is allowed (JUMP)
  int* Tc = reinterpret_cast<int*>(Jb + (JUMP ? S : 0));
  const float match = params[0], mis = params[1], o = params[2], e = params[3];
  const float jp = params[4];
  const int* q = qs + (size_t)b * m_pad;
  const int* t = ts + (size_t)b * n_pad;
  const float* al = allow + (size_t)b * n_pad;
  const int col0 = c * c_blk, ncols = max(0, min(c_blk, n - col0));
  const bool feeds = c + 1 < nb;  // block c+1 reads this block's edges
  const Strip s(col0, ncols, W);
  float acc = NEG;
  // row 0: global M = L = -inf, U = o + e*j; local zeros; fit M = U = 0,
  // L = J = -inf
  for (int k = 0; k < s.cnt; ++k) {
    const int j = s.j(k);
    const size_t x = s.slot(k);
    Tc[x] = t[j - 1];
    Mr[x] = MODE == GLOBAL ? NEG : 0.f;
    Lr[x] = MODE == LOCAL ? 0.f : NEG;
    Br[x] = MODE == GLOBAL ? o + e * (float)j : 0.f;
    if (JUMP) Jb[x] = (j < n_pad && al[j] > 0.f) ? jp : NEG;
  }
  const float jb0 = (JUMP && col0 < n_pad && al[col0] > 0.f) ? jp : NEG;
  // thread 0's diagonal: max(L, M, U[, J]) at (i-1, col0)
  float dB = score_edge<MODE>(SB, c, 0, col0, o, e, w);
  __syncthreads();
  for (int i = 1; i <= (ncols > 0 ? m : 0); ++i) {
    const int qc = q[i - 1];
    float diag = tid == 0 ? dB : (s.cnt > 0 ? Br[s.left] : NEG);
    float agg[2] = {NEG, NEG};
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j(k);
      const size_t x = s.slot(k);
      const float bold = Br[x];
      const float sub = Tc[x] == qc ? match : mis;
      float mv = diag + sub;
      if (MODE == LOCAL) mv = fmaxf(mv, 0.f);
      const float lv = fmaxf(Lr[x] + e, Mr[x] + o);
      Mr[x] = mv;
      Lr[x] = lv;
      agg[0] = fmaxf(agg[0], mv + (o - e * (float)(j + 1)));
      if (JUMP) agg[1] = fmaxf(agg[1], mv + Jb[x]);
      diag = bold;
    }
    if (tid == 0) {
      if (c > 0) w.wait(i);
      for (int st = SB; st <= (JUMP ? SJ : SU); ++st)
        eg[st] = score_edge<MODE>(st, c, i, col0, o, e, w);
      dB = eg[SB];
    }
    const float none[2] = {NEG, NEG};
    block_exclusive<MaxF>(agg, none, tot);
    // the chains' column-col0 terms: U(i, col0) and M(i, col0) + o for U;
    // J(i, col0) and the entry from M(i, col0) for J
    const float em = eg[SM];
    float run_u = fmaxf(fmaxf(eg[SU] - e * (float)col0, em + (o - e * (float)(col0 + 1))), agg[0]);
    float run_j = JUMP ? fmaxf(fmaxf(eg[SJ], em + jb0), agg[1]) : NEG;
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j(k);
      const size_t x = s.slot(k);
      const float mv = Mr[x], lv = Lr[x];
      const float uv = run_u + e * (float)j;
      const float bml = fmaxf(mv, lv);
      float best = fmaxf(bml, uv);
      const float jv = run_j;
      if (JUMP) best = fmaxf(best, jv);
      Br[x] = best;
      run_u = fmaxf(run_u, mv + (o - e * (float)(j + 1)));
      if (JUMP) run_j = fmaxf(run_j, mv + Jb[x]);
      if (MODE == LOCAL)
        acc = fmaxf(acc, mv);
      else if (MODE == GLOBAL && i == m && j == n)
        acc = best;
      else if (MODE == FIT && i == m && j <= n - 1)  // U is excluded
        acc = fmaxf(acc, bml);
      if (feeds && k == s.cnt - 1 && s.owns_last(ncols)) {
        w.put(SB, i, best);
        w.put(SM, i, mv);
        w.put(SU, i, uv);
        if (JUMP) w.put(SJ, i, jv);
        w.publish(i);
      }
    }
    __syncthreads();
  }
  const float r = block_reduce<MaxF>(acc, tot[0]);
  if (tid == 0 && w.finish(pack(r), nb)) {
    float v = NEG;
    for (int k = 0; k < nb; ++k) v = fmaxf(v, __int_as_float(w.candidate(k).x));
    // + 0.f turns a -0 into +0: the score is printed with %f
    out[b] = MODE == LOCAL ? v + 0.f : v;
  }
}

// Replaces the overlap branch of _blocked_affine_kernel (one matrix, linear
// gap o). Per slot: M, the row's candidates normalized by -o*j, the char.
__global__ void __launch_bounds__(MAX_THREADS)
bscore_overlap(const int* __restrict__ qs, const int* __restrict__ ts,
               const int* __restrict__ ns, const int* __restrict__ ms,
               const float* __restrict__ params, float* __restrict__ out, float* edges,
               int* flags, int4* cand, int m_pad, int n_pad, int c_blk, int W) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float tot[1][32];
  __shared__ float eg;  // M(i, col0), from thread 0
  __shared__ int ticket;
  Wave w(take_ticket(flags, &ticket), (n_pad + c_blk - 1) / c_blk, flags, edges, cand, m_pad);
  const int b = w.b, c = w.c, tid = threadIdx.x;
  const int n = min(max(ns[b], 0), n_pad), m = min(max(ms[b], 0), m_pad);
  const int nb = max(1, (n + c_blk - 1) / c_blk);
  if (c >= nb) return;
  const size_t S = (size_t)blockDim.x * W;
  float* Mr = reinterpret_cast<float*>(smem);
  float* Cr = Mr + S;
  int* Tc = reinterpret_cast<int*>(Cr + S);
  const float match = params[0], mis = params[1], o = params[2];
  const int* q = qs + (size_t)b * m_pad;
  const int* t = ts + (size_t)b * n_pad;
  const int col0 = c * c_blk, ncols = max(0, min(c_blk, n - col0));
  const bool feeds = c + 1 < nb;
  const Strip s(col0, ncols, W);
  float acc = NEG;
  // M(i, col0): the column-0 border is 0; row 0 is -inf past column 0
  auto edge = [&](int i) { return c == 0 ? 0.f : (i == 0 ? NEG : w.edge(0, i)); };
  for (int k = 0; k < s.cnt; ++k) {
    const size_t x = s.slot(k);
    Tc[x] = t[s.j(k) - 1];
    Mr[x] = NEG;
  }
  float dM = edge(0);  // thread 0: M(i-1, col0)
  __syncthreads();
  for (int i = 1; i <= (ncols > 0 ? m : 0); ++i) {
    const int qc = q[i - 1];
    float diag = tid == 0 ? dM : (s.cnt > 0 ? Mr[s.left] : NEG);
    float agg[1] = {NEG};
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j(k);
      const size_t x = s.slot(k);
      const float mp = Mr[x];
      const float sub = Tc[x] == qc ? match : mis;
      const float dr = fmaxf(diag + sub, mp + o);
      const float cv = dr - o * (float)j;
      Cr[x] = cv;
      agg[0] = fmaxf(agg[0], cv);
      diag = mp;
    }
    if (tid == 0) {
      if (c > 0) w.wait(i);
      dM = eg = edge(i);
    }
    const float none[1] = {NEG};
    block_exclusive<MaxF>(agg, none, tot);
    float run = fmaxf(eg - o * (float)col0, agg[0]);
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j(k);
      const size_t x = s.slot(k);
      run = fmaxf(run, Cr[x]);
      const float mv = run + o * (float)j;
      Mr[x] = mv;
      if (i == m && j <= n - 1) acc = fmaxf(acc, mv);
      if (feeds && k == s.cnt - 1 && s.owns_last(ncols)) {
        w.put(0, i, mv);
        w.publish(i);
      }
    }
    __syncthreads();
  }
  const float r = block_reduce<MaxF>(acc, tot[0]);
  if (tid == 0 && w.finish(pack(r), nb)) {
    float v = NEG;
    for (int k = 0; k < nb; ++k) v = fmaxf(v, __int_as_float(w.candidate(k).x));
    // the j = 0 border contributes its 0; + 0.f turns a -0 into +0
    out[b] = fmaxf(v, 0.f) + 0.f;
  }
}

// Replaces the edit branch of _blocked_affine_kernel (min-plus, indel 1,
// substitution cost params[1]), in int32. Per slot: M, the row's candidates
// normalized by -j, the char; the edges are int32 in the float buffer.
__global__ void __launch_bounds__(MAX_THREADS)
bscore_edit(const int* __restrict__ qs, const int* __restrict__ ts,
            const int* __restrict__ ns, const int* __restrict__ ms,
            const float* __restrict__ params, int* __restrict__ out, float* edges, int* flags,
            int4* cand, int m_pad, int n_pad, int c_blk, int W) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int tot[1][32];
  __shared__ int eg;  // M(i, col0), from thread 0
  __shared__ int ticket;
  Wave w(take_ticket(flags, &ticket), (n_pad + c_blk - 1) / c_blk, flags, edges, cand, m_pad);
  const int b = w.b, c = w.c, tid = threadIdx.x;
  const int n = min(max(ns[b], 0), n_pad), m = min(max(ms[b], 0), m_pad);
  const int nb = max(1, (n + c_blk - 1) / c_blk);
  if (c >= nb) return;
  const size_t S = (size_t)blockDim.x * W;
  int* Pr = reinterpret_cast<int*>(smem);
  int* Cr = Pr + S;
  int* Tc = Cr + S;
  const int u = (int)params[1];
  const int* q = qs + (size_t)b * m_pad;
  const int* t = ts + (size_t)b * n_pad;
  const int col0 = c * c_blk, ncols = max(0, min(c_blk, n - col0));
  const bool feeds = c + 1 < nb;
  const Strip s(col0, ncols, W);
  int acc = INT_MAX;
  // M(i, col0): M(i, 0) = i, M(0, j) = j
  auto edge = [&](int i) { return c == 0 ? i : (i == 0 ? col0 : w.edge_i(i)); };
  for (int k = 0; k < s.cnt; ++k) {
    const size_t x = s.slot(k);
    Tc[x] = t[s.j(k) - 1];
    Pr[x] = s.j(k);
  }
  int dM = edge(0);  // thread 0: M(i-1, col0)
  __syncthreads();
  for (int i = 1; i <= (ncols > 0 ? m : 0); ++i) {
    const int qc = q[i - 1];
    int diag = tid == 0 ? dM : (s.cnt > 0 ? Pr[s.left] : 0);
    int agg[1] = {INT_MAX};
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j(k);
      const size_t x = s.slot(k);
      const int pp = Pr[x];
      const int sub = Tc[x] == qc ? 0 : u;
      const int cv = min(diag + sub, pp + 1) - j;
      Cr[x] = cv;
      agg[0] = min(agg[0], cv);
      diag = pp;
    }
    if (tid == 0) {
      if (c > 0) w.wait(i);
      dM = eg = edge(i);
    }
    const int none[1] = {INT_MAX};
    block_exclusive<MinI>(agg, none, tot);
    int run = min(eg - col0, agg[0]);
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j(k);
      const size_t x = s.slot(k);
      run = min(run, Cr[x]);
      const int v = run + j;
      Pr[x] = v;
      if (i == m && j == n) acc = v;
      if (feeds && k == s.cnt - 1 && s.owns_last(ncols)) {
        w.put(0, i, __int_as_float(v));
        w.publish(i);
      }
    }
    __syncthreads();
  }
  const int r = block_reduce<MinI>(acc, tot[0]);
  if (tid == 0 && w.finish(make_int4(r, 0, 0, 0), nb)) {
    int v = INT_MAX;
    for (int k = 0; k < nb; ++k) v = min(v, w.candidate(k).x);
    // before any row, the result is M(0, n)'s latch value 0, as in the flat
    // fills; INT_MAX when n == 0
    out[b] = (m == 0 && n > 0) ? 0 : v;
  }
}

// ---------------------------------------------------------------------------
// Pointer fills
// ---------------------------------------------------------------------------

// Edge states of the affine pointer fill: M, L, U, J (also the state rows
// of a checkpoint, in this order: engine/scan.py's carry layout).
constexpr int PM = 0, PL = 1, PU = 2, PJ = 3;

// The phases of the pointer fills: the whole matrix with pointers; the
// checkpoint forward; the seeded refill of one row block.
constexpr int FILL = 0, CKPT = 1, SEED = 2;

// State s of (row i, column col0) as block c reads it; column 0's border is
// taken at the global row i0 + i (i0 > 0 in a refill only).
template <int MODE>
__device__ __forceinline__ float ptr_edge(int s, int c, int i, int i0, int col0, float o,
                                          float e, const Wave& w) {
  if (c == 0) {  // column 0
    const int gi = i0 + i;
    if (s == PJ) return NEG;
    if (MODE == LOCAL) return 0.f;
    if (s == PL) return MODE == GLOBAL ? o + e * (float)gi : NEG;
    if (gi > 0) return NEG;
    return (MODE == GLOBAL && s == PU) ? o : 0.f;
  }
  if (i == 0) {  // row 0 past column 0
    if (s == PJ) return NEG;
    if (MODE == LOCAL) return 0.f;
    if (MODE == GLOBAL) return s == PU ? o + e * (float)col0 : NEG;
    return s == PL ? NEG : 0.f;  // fit: M = U = 0
  }
  return w.edge(s, i);
}

// Replaces the global / local / fit(+jump) branches of _blocked_ptr_kernel
// (JUMP: fit's junction-gated J state, entry allowed where allow > 0 — the
// reference's inverted enum-bool quirk). Per slot: M, L, U[, J, the jump
// bias] of the row, the target char and pass 1's part of the pointer code;
// per thread its last column's M and L of the previous row. PHASE: FILL;
// CKPT (no pointers; the state rows of every stride-th row into `ck`, (B,
// m_pad/S, states, n_pad+1)); SEED (rows i0+1 .. i0+m_pad from `ck`, (B,
// states, n_pad+1); no start info).
template <int MODE, bool JUMP, int PHASE>
__global__ void __launch_bounds__(MAX_THREADS)
bptr_affine(const int* __restrict__ qs, const int* __restrict__ ts,
            const float* __restrict__ allow, const int* __restrict__ ns,
            const int* __restrict__ ms, const float* __restrict__ params,
            float* __restrict__ score_out, int* __restrict__ a_out, int* __restrict__ b_out,
            uint8_t* __restrict__ ptrs, float* edges, int* flags, int4* cand, float* ck,
            int m_pad, int n_pad, int c_blk, int W, int rpb, int stride, int i0) {
  constexpr bool PTRS = PHASE != CKPT, LATCH = PHASE != SEED;
  // a checkpoint's state rows: M, L, U, and fit's J (-inf without the jump)
  constexpr int ST = MODE == FIT ? 4 : 3;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float tot[3][32];
  __shared__ float red_f[2][32];
  __shared__ int red_i[32];
  __shared__ float eg[4];  // row i's edge at col0, from thread 0
  __shared__ float g_s;
  __shared__ int g_a, ticket;
  const int nblk = (n_pad + c_blk - 1) / c_blk;
  Wave w(take_ticket(flags, &ticket), nblk, flags, edges, cand, m_pad);
  const int b = w.b, c = w.c, tid = threadIdx.x;
  const size_t S = (size_t)blockDim.x * W;
  uint8_t* stage = smem;  // the byte-row being packed, c_blk bytes
  float* eM = reinterpret_cast<float*>(smem + c_blk);  // row i-1, last column
  float* eL = eM + blockDim.x;
  float* Mr = eL + blockDim.x;
  float* Lr = Mr + S;
  float* Ur = Lr + S;
  float* Jr = Ur + S;
  float* Jb = Jr + (JUMP ? S : 0);  // jp where entry into column j+1 is allowed
  int* Tc = reinterpret_cast<int*>(Jb + (JUMP ? S : 0));
  uint8_t* Cd = reinterpret_cast<uint8_t*>(Tc + S);
  const float match = params[0], mis = params[1], o = params[2], e = params[3];
  const float jp = params[4];
  const int k_home = rpb > 1 ? 3 : 4, k_unset = rpb > 1 ? 3 : 7;
  const int lbit = rpb > 1 ? 1 << 2 : 1 << 3, ubit = rpb > 1 ? 1 << 3 : 1 << 4;
  const int bits = 8 / rpb, R = m_pad / rpb;
  const int n = min(max(ns[b], 0), n_pad), m = min(max(ms[b], 0), m_pad);
  const int* q = qs + (size_t)b * m_pad;
  const int* t = ts + (size_t)b * n_pad;
  const float* al = allow + (size_t)b * n_pad;
  uint8_t* out = PTRS ? ptrs + (size_t)b * R * n_pad : nullptr;
  // the block's columns: c_blk, or fewer in a ragged last block
  const int col0 = c * c_blk, bw = min(c_blk, n_pad - col0);
  const bool feeds = c + 1 < nblk;
  const Strip s(col0, bw, W);
  // the checkpoint's state rows: CKPT, of each pair and S-th row; SEED, the
  // one row this block starts from (64-bit offsets: the tensor passes 2^31)
  const size_t ck_row = (size_t)n_pad + 1;
  const int nck = PHASE == CKPT ? m_pad / stride : 1;
  const float* seed = PHASE == SEED ? ck + (size_t)b * ST * ck_row : nullptr;
  const int r0 = PHASE == SEED ? i0 : 0;  // the global row of row 0
  // CKPT: this thread's columns (and column 0's border, block 0's thread 0)
  // of row i as checkpoint i / stride
  auto put_ck = [&](int i) {
    float* dst = ck + ((size_t)b * nck + i / stride) * ST * ck_row;
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j(k);
      const size_t x = s.slot(k);
      dst[PM * ck_row + j] = Mr[x];
      dst[PL * ck_row + j] = Lr[x];
      dst[PU * ck_row + j] = Ur[x];
      if (ST > 3) dst[PJ * ck_row + j] = JUMP ? Jr[x] : NEG;
    }
    if (c == 0 && tid == 0)
      for (int st = 0; st < ST; ++st) dst[st * ck_row] = ptr_edge<MODE>(st, 0, i, 0, 0, o, e, w);
  };
  if (tid == 0) {
    g_s = NEG;
    g_a = 0;
  }
  // row 0: global M = L = -inf, U = o + e*j; local zeros; fit M = U = 0,
  // L = -inf; J = -inf. SEED: the checkpoint's row.
  for (int k = 0; k < s.cnt; ++k) {
    const int j = s.j(k);
    const size_t x = s.slot(k);
    Tc[x] = t[j - 1];
    if (PHASE == SEED) {
      Mr[x] = seed[PM * ck_row + j];
      Lr[x] = seed[PL * ck_row + j];
      Ur[x] = seed[PU * ck_row + j];
    } else {
      Mr[x] = MODE == GLOBAL ? NEG : 0.f;
      Lr[x] = MODE == LOCAL ? 0.f : NEG;
      Ur[x] = MODE == GLOBAL ? o + e * (float)j : 0.f;
    }
    if (JUMP) {
      Jr[x] = PHASE == SEED ? seed[PJ * ck_row + j] : NEG;
      Jb[x] = (j < n_pad && al[j] > 0.f) ? jp : NEG;
    }
  }
  if (s.cnt > 0) {
    eM[tid] = Mr[s.slot(s.cnt - 1)];
    eL[tid] = Lr[s.slot(s.cnt - 1)];
  }
  const float jb0 = (JUMP && al[col0] > 0.f) ? jp : NEG;
  // thread 0's diagonal: row i-1's M, L, U, J at col0 (SEED past block 0:
  // the checkpoint's column col0)
  const bool from_ck = PHASE == SEED && c > 0;
  float eM0 = from_ck ? seed[PM * ck_row + col0] : ptr_edge<MODE>(PM, c, 0, r0, col0, o, e, w);
  float eL0 = from_ck ? seed[PL * ck_row + col0] : ptr_edge<MODE>(PL, c, 0, r0, col0, o, e, w);
  float eU0 = from_ck ? seed[PU * ck_row + col0] : ptr_edge<MODE>(PU, c, 0, r0, col0, o, e, w);
  float eJ0 = (JUMP && from_ck) ? seed[PJ * ck_row + col0] : NEG;
  if (PHASE == CKPT) put_ck(0);
  // this block's start info: local's running maximum, fit's bottom row
  float blk_s = NEG;
  int blk_a = 0, blk_b = 0;
  __syncthreads();
  for (int i = 1; i <= m_pad; ++i) {
    const int idx = i - 1, sub_row = idx % rpb, shift = sub_row * bits;
    if (PTRS && sub_row == 0 && i > 1)
      store_row(stage, out + (size_t)(idx / rpb - 1) * n_pad + col0, bw);
    const int qc = q[idx];
    // row i-1 at column j0-1
    float dM, dL, dU, dJ = NEG;
    if (tid == 0) {
      dM = eM0;
      dL = eL0;
      dU = eU0;
      dJ = eJ0;
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
      const int j = s.j(k);
      const size_t x = s.slot(k);
      const float mo = Mr[x], lo = Lr[x], uo = Ur[x];
      const float jo = JUMP ? Jr[x] : NEG;
      const float sub = Tc[x] == qc ? match : mis;
      // earliest-argument strict argmax: L, M, U, J, HOME
      float best = dL + sub;
      int pm = 0;
      float cv = dM + sub;
      if (cv > best) pm = 1;
      best = fmaxf(best, cv);
      cv = dU + sub;
      if (cv > best) pm = 2;
      best = fmaxf(best, cv);
      if (JUMP) {
        cv = dJ + sub;
        if (cv > best) pm = 3;
        best = fmaxf(best, cv);
      }
      if (MODE == LOCAL) {
        if (0.f > best) pm = k_home;  // the HOME candidate has no +sub
        best = fmaxf(best, 0.f);
      }
      if (!(best > NEG)) pm = k_unset;
      const float la = lo + e, lb2 = mo + o;
      Mr[x] = best;
      Lr[x] = fmaxf(la, lb2);
      if (PTRS) Cd[x] = (uint8_t)(pm | (la >= lb2 ? 0 : lbit));
      v[0] = fmaxf(v[0], best + (o - e * (float)(j + 1)));
      if (JUMP) v[1] = fmaxf(v[1], best + Jb[x]);
      if (MODE == LOCAL && j <= n) v[2] = fmaxf(v[2], best);
      dM = mo;
      dL = lo;
      dU = uo;
      dJ = jo;
    }
    if (tid == 0) {
      if (c > 0) w.wait(i);
      eg[PM] = eM0 = ptr_edge<MODE>(PM, c, i, r0, col0, o, e, w);
      eg[PL] = eL0 = ptr_edge<MODE>(PL, c, i, r0, col0, o, e, w);
      eg[PU] = eU0 = ptr_edge<MODE>(PU, c, i, r0, col0, o, e, w);
      if (JUMP) eg[PJ] = eJ0 = ptr_edge<MODE>(PJ, c, i, r0, col0, o, e, w);
    }
    const float none[3] = {NEG, NEG, NEG};
    float total[3];
    block_exclusive<MaxF>(v, none, total, tot);
    // the chains' column-col0 terms (as in bscore_affine)
    const float em = eg[PM];
    float run_u = fmaxf(fmaxf(eg[PU] - e * (float)col0, em + (o - e * (float)(col0 + 1))), v[0]);
    float run_j = JUMP ? fmaxf(fmaxf(eg[PJ], em + jb0), v[1]) : NEG;
    // M(i, j-1) and J's entry into column j, at the strip's first column
    float mprev = em, jcv = JUMP ? em + jb0 : NEG;
    if (tid > 0 && s.cnt > 0) {
      mprev = Mr[s.left];
      if (JUMP) jcv = mprev + Jb[s.left];
    }
    const bool last_row = i == m;
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j(k);
      const size_t x = s.slot(k);
      const float mv = Mr[x];
      const float uv = run_u + e * (float)j;
      const float ua = mprev + o;
      // U(i,j) = max(ua, U(i,j-1) + e), so ua >= U(i,j-1) + e iff ua >= U(i,j)
      int code = PTRS ? Cd[x] | (ua >= uv ? 0 : ubit) : 0;
      Ur[x] = uv;
      if (JUMP) {
        // J(i,j) = max(J(i,j-1), jcv): jcv >= J(i,j-1) iff jcv >= J(i,j)
        code |= (jcv > NEG && jcv >= run_j) ? 0 : 1 << 5;
        Jr[x] = run_j;
        jcv = mv + Jb[x];
        run_j = fmaxf(run_j, jcv);
      }
      if (PTRS) {
        const int col = s.k0 + k;
        stage[col] = (uint8_t)(sub_row == 0 ? code : stage[col] | (code << shift));
      }
      if (LATCH && MODE == GLOBAL && last_row && j == n) {
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
      if (feeds && s.owns_last(bw)) {
        w.put(PM, i, Mr[x]);
        w.put(PL, i, Lr[x]);
        w.put(PU, i, Ur[x]);
        if (JUMP) w.put(PJ, i, Jr[x]);
        w.publish(i);
      }
    }
    if (PHASE == CKPT && i % stride == 0 && i < m_pad) put_ck(i);
    if (LATCH && MODE == LOCAL && i <= m && total[2] > blk_s) {
      // a strictly greater row maximum: its first column over j <= n
      int fj = BIG;
      for (int k = 0; k < s.cnt && fj == BIG; ++k)
        if (s.j(k) <= n && Mr[s.slot(k)] == total[2]) fj = s.j(k);
      blk_b = block_reduce<MinI>(fj, red_i);
      blk_s = total[2];
      blk_a = i;
    }
    if (LATCH && MODE == FIT && last_row) {
      // this block's bottom row over columns <= n-1; L wins only when
      // strictly greater
      float mx[2] = {NEG, NEG};
      for (int k = 0; k < s.cnt && s.j(k) <= n - 1; ++k) {
        mx[0] = fmaxf(mx[0], Mr[s.slot(k)]);
        mx[1] = fmaxf(mx[1], Lr[s.slot(k)]);
      }
      mx[0] = block_reduce<MaxF>(mx[0], red_f[0]);
      mx[1] = block_reduce<MaxF>(mx[1], red_f[1]);
      const bool use_l = mx[1] > mx[0];
      const float want = use_l ? mx[1] : mx[0];
      const float* row = use_l ? Lr : Mr;
      int fj = BIG;
      for (int k = 0; k < s.cnt && fj == BIG; ++k)
        if (s.j(k) <= n - 1 && row[s.slot(k)] == want) fj = s.j(k);
      blk_b = block_reduce<MinI>(fj, red_i);
      blk_s = fmaxf(mx[0], mx[1]);
      blk_a = use_l ? 1 : 0;
    }
    __syncthreads();
  }
  if (PTRS) store_row(stage, out + (size_t)(R - 1) * n_pad + col0, bw);
  if (!LATCH) return;
  if (tid == 0 && w.finish(MODE == GLOBAL ? pack(g_s, g_a) : pack(blk_s, blk_a, blk_b), nblk)) {
    float acc_s = NEG;
    int acc_a = 0, acc_b = 0;
    if (MODE == GLOBAL) {
      if (n > 0) {  // the block that holds column n latched (m, n)
        const int4 x = w.candidate((n - 1) / c_blk);
        acc_s = __int_as_float(x.x);
        acc_a = x.y;
      }
    } else if (MODE == LOCAL || m > 0) {  // fit's candidates come from row m
      for (int k = 0; k < nblk; ++k) {
        const int4 x = w.candidate(k);
        const float fs = __int_as_float(x.x);
        // local: ties keep the earlier block unless the later one's row is
        // smaller; fit: block 0 is taken as it is, a later block on a
        // greater score, or an equal one from M where the kept one is from
        // L, or from the same matrix at a smaller j
        const bool take =
            MODE == LOCAL
                ? fs > acc_s || (fs == acc_s && x.y < acc_a)
                : k == 0 || fs > acc_s ||
                      (fs == acc_s && (x.y < acc_a || (x.y == acc_a && x.z < acc_b)));
        if (take) {
          acc_s = fs;
          acc_a = x.y;
          acc_b = x.z;
        }
      }
    }
    score_out[b] = acc_s;
    a_out[b] = acc_a;
    b_out[b] = acc_b;
  }
}

// Replaces the overlap branch of _blocked_ptr_kernel: one matrix, linear gap
// o; codes LEFT/DIAG/RIGHT = 0/1/2, 3 where the cell is -inf (alignment.h:944's
// argument order). Per slot: M, max(DIAG, RIGHT), the char, DIAG or RIGHT.
// PHASE as in bptr_affine, with M the one state row.
template <int PHASE>
__global__ void __launch_bounds__(MAX_THREADS)
bptr_overlap(const int* __restrict__ qs, const int* __restrict__ ts,
             const int* __restrict__ ns, const int* __restrict__ ms,
             const float* __restrict__ params, float* __restrict__ score_out,
             int* __restrict__ a_out, int* __restrict__ b_out, uint8_t* __restrict__ ptrs,
             float* edges, int* flags, int4* cand, float* ck, int m_pad, int n_pad, int c_blk,
             int W, int rpb, int stride) {
  constexpr bool PTRS = PHASE != CKPT, LATCH = PHASE != SEED;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float tot[1][32];
  __shared__ float red_f[32];
  __shared__ int red_i[32];
  __shared__ float eg;  // M(i, col0), from thread 0
  __shared__ int ticket;
  const int nblk = (n_pad + c_blk - 1) / c_blk;
  Wave w(take_ticket(flags, &ticket), nblk, flags, edges, cand, m_pad);
  const int b = w.b, c = w.c, tid = threadIdx.x;
  const size_t S = (size_t)blockDim.x * W;
  uint8_t* stage = smem;
  float* Mr = reinterpret_cast<float*>(smem + c_blk);
  float* Dr = Mr + S;
  int* Tc = reinterpret_cast<int*>(Dr + S);
  uint8_t* Cd = reinterpret_cast<uint8_t*>(Tc + S);
  const float match = params[0], mis = params[1], o = params[2];
  const int bits = 8 / rpb, R = m_pad / rpb;
  const int n = min(max(ns[b], 0), n_pad), m = min(max(ms[b], 0), m_pad);
  const int* q = qs + (size_t)b * m_pad;
  const int* t = ts + (size_t)b * n_pad;
  uint8_t* out = PTRS ? ptrs + (size_t)b * R * n_pad : nullptr;
  const int col0 = c * c_blk, bw = min(c_blk, n_pad - col0);  // a ragged last block
  const bool feeds = c + 1 < nblk;
  const Strip s(col0, bw, W);
  const size_t ck_row = (size_t)n_pad + 1;
  const int nck = PHASE == CKPT ? m_pad / stride : 1;
  const float* seed = PHASE == SEED ? ck + (size_t)b * ck_row : nullptr;
  // CKPT: this thread's columns of row i as checkpoint i / stride; M(i, 0) = 0
  auto put_ck = [&](int i) {
    float* dst = ck + ((size_t)b * nck + i / stride) * ck_row;
    for (int k = 0; k < s.cnt; ++k) dst[s.j(k)] = Mr[s.slot(k)];
    if (c == 0 && tid == 0) dst[0] = 0.f;
  };
  // M(i, col0): the column-0 border is 0; row 0 is -inf past column 0
  auto edge = [&](int i) { return c == 0 ? 0.f : (i == 0 ? NEG : w.edge(0, i)); };
  for (int k = 0; k < s.cnt; ++k) {
    const size_t x = s.slot(k);
    Tc[x] = t[s.j(k) - 1];
    Mr[x] = PHASE == SEED ? seed[s.j(k)] : NEG;
  }
  // thread 0: M(i-1, col0) (SEED past block 0: the checkpoint's column col0)
  float dM0 = (PHASE == SEED && c > 0) ? seed[col0] : edge(0);
  if (PHASE == CKPT) put_ck(0);
  // this block's bottom row: its maximum over columns <= n-1, first column
  float blk_s = NEG;
  int blk_a = 0;
  __syncthreads();
  for (int i = 1; i <= m_pad; ++i) {
    const int idx = i - 1, sub_row = idx % rpb, shift = sub_row * bits;
    if (PTRS && sub_row == 0 && i > 1)
      store_row(stage, out + (size_t)(idx / rpb - 1) * n_pad + col0, bw);
    const int qc = q[idx];
    // M(i-1, j0-1); Mr is rewritten only in pass 2
    float dM = tid == 0 ? dM0 : (s.cnt > 0 ? Mr[s.left] : NEG);
    float v[1] = {NEG};
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j(k);
      const size_t x = s.slot(k);
      const float mp = Mr[x];
      const float sub = Tc[x] == qc ? match : mis;
      const float diag = dM + sub, right = mp + o;
      const float dr = fmaxf(diag, right);
      Dr[x] = dr;
      if (PTRS) Cd[x] = diag >= right ? 1 : 2;
      v[0] = fmaxf(v[0], dr - o * (float)j);
      dM = mp;
    }
    if (tid == 0) {
      if (c > 0) w.wait(i);
      dM0 = eg = edge(i);
    }
    const float none[1] = {NEG};
    block_exclusive<MaxF>(v, none, tot);
    float run = fmaxf(eg - o * (float)col0, v[0]);  // M(i, col0) seeds the chain
    // M(i, j0-1), as the left neighbour (or the previous block) has it
    float mprev = run + o * (float)(s.j(0) - 1);
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j(k);
      const size_t x = s.slot(k);
      const float dr = Dr[x];
      if (PTRS) {
        const float left = mprev + o;
        const float val = fmaxf(left, dr);
        int code = left >= val ? 0 : Cd[x];
        if (!(val > NEG)) code = 3;
        const int col = s.k0 + k;
        stage[col] = (uint8_t)(sub_row == 0 ? code : stage[col] | (code << shift));
      }
      run = fmaxf(run, dr - o * (float)j);
      const float mv = run + o * (float)j;
      Mr[x] = mv;
      mprev = mv;
      if (feeds && k == s.cnt - 1 && s.owns_last(bw)) {
        w.put(0, i, mv);
        w.publish(i);
      }
    }
    if (PHASE == CKPT && i % stride == 0 && i < m_pad) put_ck(i);
    if (LATCH && i == m) {
      float mx = NEG;
      for (int k = 0; k < s.cnt && s.j(k) <= n - 1; ++k) mx = fmaxf(mx, Mr[s.slot(k)]);
      mx = block_reduce<MaxF>(mx, red_f);
      int fj = BIG;
      for (int k = 0; k < s.cnt && fj == BIG; ++k)
        if (s.j(k) <= n - 1 && Mr[s.slot(k)] == mx) fj = s.j(k);
      blk_a = block_reduce<MinI>(fj, red_i);
      blk_s = mx;
    }
    __syncthreads();
  }
  if (PTRS) store_row(stage, out + (size_t)(R - 1) * n_pad + col0, bw);
  if (!LATCH) return;
  if (tid == 0 && w.finish(pack(blk_s, blk_a), nblk)) {
    float acc_s = NEG;
    int acc_a = 0;
    for (int k = 0; k < (m > 0 ? nblk : 0); ++k) {
      const int4 x = w.candidate(k);
      const float mx = __int_as_float(x.x);
      if (k == 0) {  // block 0 also holds the j = 0 zero candidate, which wins ties
        acc_s = fmaxf(mx, 0.f);
        acc_a = mx > 0.f ? x.y : 0;
      } else if (mx > acc_s) {
        acc_s = mx;
        acc_a = x.y;
      }
    }
    score_out[b] = acc_s;
    a_out[b] = acc_a;
    b_out[b] = 0;
  }
}

// Launch one CTA per (pair, column block) with `smem` bytes of dynamic
// shared memory (above 48 KiB only after the opt-in attribute; the carveout
// leaves the SM's L1 to shared memory, so CTAs fit by shared memory); returns
// the launch's error code.
template <class... P, class... A>
cudaError_t launch(void (*kernel)(P...), int ctas, int threads, size_t smem, cudaStream_t stream,
                   A... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Every fill takes a ragged last block, a multiple of 16 columns.
bool bad_blocks(int B, int threads, int wmax, int m_pad, int n_pad, int c_blk) {
  return B < 0 || threads < 32 || threads > MAX_THREADS || threads % 32 != 0 || m_pad <= 0 ||
         c_blk <= 0 || c_blk % 16 != 0 || n_pad <= 0 || n_pad % 16 != 0 ||
         (long long)threads * wmax < c_blk ||
         (long long)B * ((n_pad + c_blk - 1) / c_blk) > INT_MAX;
}

// One pointer fill of `PHASE` (FILL, CKPT or SEED): the checks of the
// layout, then the mode's instance; returns the launch's error code.
template <int PHASE>
cudaError_t launch_ptr(int mode, int use_jump, int rpb, const int* qs, const int* ts,
                       const float* allow, const int* ns, const int* ms, const float* params,
                       float* score, int* a, int* b, uint8_t* ptrs, float* edges, int* flags,
                       void* cand, float* ck, int B, int m_pad, int n_pad, int c_blk,
                       int threads, int wmax, int stride, int i0, cudaStream_t stream) {
  const bool bad_layout = (rpb != 1 && rpb != 2 && rpb != 4) || m_pad % (8 * rpb) != 0 ||
                          (rpb > 1 && use_jump) || (rpb == 4 && mode != OVERLAP) ||
                          (use_jump && mode != FIT);
  if (bad_blocks(B, threads, wmax, m_pad, n_pad, c_blk) || mode < GLOBAL || mode > OVERLAP ||
      bad_layout)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int ctas = B * ((n_pad + c_blk - 1) / c_blk);
  const size_t S = (size_t)threads * wmax;
  int4* cd = static_cast<int4*>(cand);
  if (mode == OVERLAP)  // stage, M, max(DIAG, RIGHT), char, code
    return launch(bptr_overlap<PHASE>, ctas, threads, c_blk + S * 13, stream, qs, ts, ns, ms,
                  params, score, a, b, ptrs, edges, flags, cd, ck, m_pad, n_pad, c_blk, wmax,
                  rpb, stride);
  // stage, the threads' last M and L, M, L, U[, J, jump bias], char, code
  const size_t smem = c_blk + (size_t)threads * 8 + S * (use_jump ? 25 : 17);
  if (mode == GLOBAL)
    return launch(bptr_affine<GLOBAL, false, PHASE>, ctas, threads, smem, stream, qs, ts, allow,
                  ns, ms, params, score, a, b, ptrs, edges, flags, cd, ck, m_pad, n_pad, c_blk,
                  wmax, rpb, stride, i0);
  if (mode == LOCAL)
    return launch(bptr_affine<LOCAL, false, PHASE>, ctas, threads, smem, stream, qs, ts, allow,
                  ns, ms, params, score, a, b, ptrs, edges, flags, cd, ck, m_pad, n_pad, c_blk,
                  wmax, rpb, stride, i0);
  if (use_jump)
    return launch(bptr_affine<FIT, true, PHASE>, ctas, threads, smem, stream, qs, ts, allow, ns,
                  ms, params, score, a, b, ptrs, edges, flags, cd, ck, m_pad, n_pad, c_blk, wmax,
                  rpb, stride, i0);
  return launch(bptr_affine<FIT, false, PHASE>, ctas, threads, smem, stream, qs, ts, allow, ns,
                ms, params, score, a, b, ptrs, edges, flags, cd, ck, m_pad, n_pad, c_blk, wmax,
                rpb, stride, i0);
}

}  // namespace

// C entry points, bound with ctypes. Each launches one fill on `stream`
// without synchronising and returns the launch's error code. With nblk =
// ceil(n_pad / c_blk): `edges` is the (B, nblk, 4, m_pad + 1) float32 block-edge
// buffer, `flags` the (1 + B * (nblk + 1)) int32 ticket, progress and done
// counters, zeroed, and `cand` the (B, nblk, 4) int32 start-info candidates.
extern "C" {

// mode: 0 global, 1 local, 2 fit, 3 overlap, 4 edit; `out` is (B,) float32,
// int32 for edit; the last column block may be narrower than c_blk (n_pad %
// 16 == 0).
cudaError_t at_blocked_scores(int mode, int use_jump, const int* qs, const int* ts,
                              const float* allow, const int* ns, const int* ms,
                              const float* params, void* out, float* edges, int* flags,
                              void* cand, int B, int m_pad, int n_pad, int c_blk, int threads,
                              int wmax, cudaStream_t stream) {
  if (bad_blocks(B, threads, wmax, m_pad, n_pad, c_blk) || mode < GLOBAL || mode > EDIT ||
      (use_jump && mode != FIT))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int ctas = B * ((n_pad + c_blk - 1) / c_blk);
  const size_t S = (size_t)threads * wmax;
  float* f_out = static_cast<float*>(out);
  int4* cd = static_cast<int4*>(cand);
  if (mode == OVERLAP)
    return launch(bscore_overlap, ctas, threads, S * 12, stream, qs, ts, ns, ms, params, f_out,
                  edges, flags, cd, m_pad, n_pad, c_blk, wmax);
  if (mode == EDIT)
    return launch(bscore_edit, ctas, threads, S * 12, stream, qs, ts, ns, ms, params,
                  static_cast<int*>(out), edges, flags, cd, m_pad, n_pad, c_blk, wmax);
  const size_t smem = S * (use_jump ? 20 : 16);
  if (mode == GLOBAL)
    return launch(bscore_affine<GLOBAL, false>, ctas, threads, smem, stream, qs, ts, allow, ns,
                  ms, params, f_out, edges, flags, cd, m_pad, n_pad, c_blk, wmax);
  if (mode == LOCAL)
    return launch(bscore_affine<LOCAL, false>, ctas, threads, smem, stream, qs, ts, allow, ns,
                  ms, params, f_out, edges, flags, cd, m_pad, n_pad, c_blk, wmax);
  if (use_jump)
    return launch(bscore_affine<FIT, true>, ctas, threads, smem, stream, qs, ts, allow, ns, ms,
                  params, f_out, edges, flags, cd, m_pad, n_pad, c_blk, wmax);
  return launch(bscore_affine<FIT, false>, ctas, threads, smem, stream, qs, ts, allow, ns, ms,
                params, f_out, edges, flags, cd, m_pad, n_pad, c_blk, wmax);
}

// mode: 0 global, 1 local, 2 fit, 3 overlap; rpb rows per byte (1, 2, or 4
// for overlap; 1 for fit+jump), m_pad % (8 * rpb) == 0; the last column
// block may be narrower than c_blk (n_pad % 16 == 0).
cudaError_t at_blocked_ptr_fill(int mode, int use_jump, int rpb, const int* qs, const int* ts,
                                const float* allow, const int* ns, const int* ms,
                                const float* params, float* score, int* a, int* b,
                                uint8_t* ptrs, float* edges, int* flags, void* cand, int B,
                                int m_pad, int n_pad, int c_blk, int threads, int wmax,
                                cudaStream_t stream) {
  return launch_ptr<FILL>(mode, use_jump, rpb, qs, ts, allow, ns, ms, params, score, a, b, ptrs,
                          edges, flags, cand, nullptr, B, m_pad, n_pad, c_blk, threads, wmax, 1,
                          0, stream);
}

// The checkpoint forward (CKPT) of the pointer fill: score, a and b as
// at_blocked_ptr_fill's, no pointers, and `ck` the (B, m_pad / S, states,
// n_pad + 1) float32 checkpoints (states: 3 global and local, 4 fit, 1
// overlap); S a positive multiple of 8 that divides m_pad.
cudaError_t at_blocked_ckpt_fill(int mode, int use_jump, const int* qs, const int* ts,
                                 const float* allow, const int* ns, const int* ms,
                                 const float* params, float* score, int* a, int* b, float* ck,
                                 float* edges, int* flags, void* cand, int B, int m_pad,
                                 int n_pad, int c_blk, int threads, int wmax, int stride,
                                 cudaStream_t stream) {
  if (stride <= 0 || stride % 8 != 0 || m_pad % stride != 0 || ck == nullptr)
    return cudaErrorInvalidValue;
  return launch_ptr<CKPT>(mode, use_jump, 1, qs, ts, allow, ns, ms, params, score, a, b, nullptr,
                          edges, flags, cand, ck, B, m_pad, n_pad, c_blk, threads, wmax, stride,
                          0, stream);
}

// The seeded refill (SEED) of rows i0+1 .. i0+S of the pointer fill: qs the
// (B, S) query chars of those rows, `ck` the (B, states, n_pad + 1) state
// rows of row i0 (a checkpoint of at_blocked_ckpt_fill), `ptrs` the (B, S /
// rpb, n_pad) pointer bytes as at_blocked_ptr_fill lays them out; no start
// info. ms is read by no phase here but must point at (B,) int32.
cudaError_t at_blocked_refill(int mode, int use_jump, int rpb, const int* qs, const int* ts,
                              const float* allow, const int* ns, const int* ms,
                              const float* params, const float* ck, int i0, uint8_t* ptrs,
                              float* edges, int* flags, void* cand, int B, int S, int n_pad,
                              int c_blk, int threads, int wmax, cudaStream_t stream) {
  if (i0 < 0 || ck == nullptr) return cudaErrorInvalidValue;
  return launch_ptr<SEED>(mode, use_jump, rpb, qs, ts, allow, ns, ms, params, nullptr, nullptr,
                          nullptr, ptrs, edges, flags, cand, const_cast<float*>(ck), B, S, n_pad,
                          c_blk, threads, wmax, S, i0, stream);
}

}  // extern "C"
