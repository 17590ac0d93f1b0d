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
// borders (edit: int32; the double instances below 2^53), built with
// --fmad=false and no fast math; each pointer is a comparison of such
// values in the Pallas code's argument order, so the results do not depend
// on c_blk.
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
//
// Double instances (the *64 entries). A single pair past float32's exact
// integers runs the pointer fill's three phases and edit's score fill with
// the value type T = double: params, row state in shared memory, block
// edges and checkpoints in double, exact integers below 2^53 with true -inf
// borders; a block candidate's double rides its int4 slot as two words (x
// and w). Each edge is a plain 8-byte store before the owner's
// st.release.gpu of the row count, and its reader's ld.acquire.gpu comes
// before its __ldcg, so the 8-byte values are ordered as the 4-byte ones
// are. Shared memory takes 45 bytes a column at fit+jump (184 KiB at 4,096
// columns), so the double column block is at most 4,096
// (ops/blocked.C_BLK_MAX64).

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

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
// (pair, block) four edge states of rows 0..m_pad, of the fill's value type
// T (float, int32 for edit, double in the double instances); `cand` per
// (pair, block) the block's start-info candidate.
template <class T = float>
struct Wave {
  int b, c, rows;
  int* prog;
  int* done;
  int4* cand;
  const T* ep;  // block c-1's edges (c > 0)
  T* en;        // this block's edges
  int seen;     // thread 0: rows of block c-1's edge seen published
  // `chunk` (the EDGE phase): a pair's edges hold nblk + 1 slots, slot 0
  // the launch's left edge (block 0 reads it, ready at launch) and slot c+1
  // block c's, the last one the right edge
  __device__ Wave(int ticket, int nblk, int* flags, T* edges, int4* cand_, int m_pad,
                  bool chunk = false) {
    const int B = gridDim.x / nblk;
    b = ticket % B;
    c = ticket / B;
    rows = m_pad + 1;
    prog = flags + 1 + (size_t)b * (nblk + 1);
    done = prog + nblk;
    cand = cand_ + (size_t)b * nblk;
    en = edges + ((size_t)b * (nblk + chunk) + c + chunk) * 4 * rows;
    ep = en - (size_t)4 * rows;
    seen = 0;
  }
  // thread 0, before it reads rows <= i of block c-1's edge
  __device__ void wait(int i) {
    while (seen < i) seen = ld_acquire(prog + c - 1);
  }
  __device__ T edge(int s, int i) const { return __ldcg(ep + (size_t)s * rows + i); }
  __device__ void put(int s, int i, T v) const { en[(size_t)s * rows + i] = v; }
  // the owner of the block's last column, after its edge stores of row i
  // (the release orders them, 4- or 8-byte values alike, before the count)
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

// A candidate's value in the int4 slot: a float or an int in x; a double's
// low word in x and its high word in w
__device__ __forceinline__ int4 pack(float s, int a = 0, int b = 0) {
  return make_int4(__float_as_int(s), a, b, 0);
}
__device__ __forceinline__ int4 pack(double s, int a = 0, int b = 0) {
  return make_int4(__double2loint(s), a, b, __double2hiint(s));
}
__device__ __forceinline__ int4 pack(int s, int a = 0, int b = 0) { return make_int4(s, a, b, 0); }
template <class T>
__device__ __forceinline__ T unpack(int4 x);
template <>
__device__ __forceinline__ float unpack<float>(int4 x) { return __int_as_float(x.x); }
template <>
__device__ __forceinline__ double unpack<double>(int4 x) { return __hiloint2double(x.w, x.x); }
template <>
__device__ __forceinline__ int unpack<int>(int4 x) { return x.x; }

// max / min of the value types (FMNMX for float32, as before) and their
// block-scan operators
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }
template <class T>
struct Ops;
template <>
struct Ops<float> {
  using Max = MaxF;
};
template <>
struct Ops<double> {
  using Max = MaxD;
  using Min = MinD;
};
template <>
struct Ops<int> {
  using Min = MinI;
};

// ---------------------------------------------------------------------------
// Score fills
// ---------------------------------------------------------------------------

// Edge states of the affine score fills: max(L, M, U[, J]), M, U, J.
constexpr int SB = 0, SM = 1, SU = 2, SJ = 3;

// State s of (row i, column col0) as block c reads it: column 0's border in
// block 0, row 0's analytic value, else block c-1's edge.
template <int MODE>
__device__ __forceinline__ float score_edge(int s, int c, int i, int col0, float o, float e,
                                            const Wave<float>& w) {
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

// The EDGE phase of the score fills (parallel/seqpar.py: one rank's column
// slice, one chunk of rows a launch). The launch fills rows i0+1 .. i0+R
// (qs (B, R)) of global columns col0g+1 .. col0g+nloc (ts, allow (B, nloc);
// here m_pad is R and n_pad nloc) in column blocks as FILL does, every row
// and column, pad ones included: row i0 comes from the state buffer `top`
// (B, states, nloc), row i0+R goes to `bottom`; block 0 reads the launch's
// left edge (the states at column col0g of rows i0 .. i0+R, slot 0 of the
// edges) and the last block writes the right edge (slot nblk); every chain
// continues by global column, and the column-0 border and row 0 are the
// caller's (in `top` and the left edge). Each block's candidate is its
// cells' over rows <= m and columns <= n (global), and the pair's last
// block to finish raises (edit: lowers) `out` (B,), the running candidate
// of the chunks, by their merge; the caller merges the ranks and finishes
// (local's + 0, overlap's j = 0 candidate).
struct Chunk {
  const void* top;
  void* bottom;
  int col0g, i0;
  int4* acc;      // the pointer fills' running start candidate (B,)
  int slab_rows;  // the pointer fills' slab: (B, slab_rows, nloc) bytes
};

// Replaces the global / local / fit(+jump) branches of
// _blocked_affine_kernel. Per slot: M, L, max(L, M, U[, J]) of the row, the
// jump bias (JUMP) and the target char. EDGE: the chunk phase above (top and
// bottom: M, L, max(L, M, U[, J])).
template <int MODE, bool JUMP, bool EDGE = false>
__global__ void __launch_bounds__(MAX_THREADS)
bscore_affine(const int* __restrict__ qs, const int* __restrict__ ts,
              const float* __restrict__ allow, const int* __restrict__ ns,
              const int* __restrict__ ms, const float* __restrict__ params,
              float* __restrict__ out, float* edges, int* flags, int4* cand, int m_pad,
              int n_pad, int c_blk, int W, Chunk ch = {}) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float tot[2][32];
  __shared__ float eg[4];  // row i's edge at col0, from thread 0
  __shared__ int ticket;
  const int nblk = (n_pad + c_blk - 1) / c_blk;
  Wave w(take_ticket(flags, &ticket), nblk, flags, edges, cand, m_pad, EDGE);
  const int b = w.b, c = w.c, tid = threadIdx.x;
  const int n = EDGE ? max(ns[b], 0) : min(max(ns[b], 0), n_pad);
  const int m = EDGE ? max(ms[b], 0) : min(max(ms[b], 0), m_pad);
  // the blocks that hold columns <= n (EDGE: every block)
  const int nb = EDGE ? nblk : max(1, (n + c_blk - 1) / c_blk);
  if (c >= nb) return;
  const size_t S = (size_t)blockDim.x * W;
  float* Mr = reinterpret_cast<float*>(smem);
  float* Lr = Mr + S;
  float* Br = Lr + S;
  float* Jb = Br + S;  // jp where entry into column j+1 is allowed (JUMP)
  int* Tc = reinterpret_cast<int*>(Jb + (JUMP ? S : 0));
  const float match = params[0], mis = params[1], o = params[2], e = params[3];
  const float jp = params[4];
  // columns: global col0g+1 .., at local index j - 1 - col0g of ts, allow
  // and the state rows (FILL: col0g 0, nloc n_pad)
  const int col0g = EDGE ? ch.col0g : 0, i0 = EDGE ? ch.i0 : 0;
  const int* q = qs + (size_t)b * m_pad;
  const int* t = ts + (size_t)b * n_pad - col0g;
  const float* al = allow + (size_t)b * n_pad - col0g;
  const float* top = EDGE ? static_cast<const float*>(ch.top) + (size_t)b * 3 * n_pad - col0g - 1
                          : nullptr;
  float* bot = EDGE ? static_cast<float*>(ch.bottom) + (size_t)b * 3 * n_pad - col0g - 1 : nullptr;
  const int col0 = col0g + c * c_blk;
  const int ncols = EDGE ? min(c_blk, n_pad - c * c_blk) : max(0, min(c_blk, n - col0));
  const int lim = col0g + n_pad;  // allow's columns end here
  const bool feeds = EDGE || c + 1 < nb;  // block c+1 (EDGE: or the right edge) reads them
  const Strip s(col0, ncols, W);
  float acc = NEG;
  // row 0: global M = L = -inf, U = o + e*j; local zeros; fit M = U = 0,
  // L = J = -inf. EDGE: row i0 from `top`.
  for (int k = 0; k < s.cnt; ++k) {
    const int j = s.j(k);
    const size_t x = s.slot(k);
    Tc[x] = t[j - 1];
    if (EDGE) {
      Mr[x] = top[j];
      Lr[x] = top[n_pad + j];
      Br[x] = top[2 * n_pad + j];
    } else {
      Mr[x] = MODE == GLOBAL ? NEG : 0.f;
      Lr[x] = MODE == LOCAL ? 0.f : NEG;
      Br[x] = MODE == GLOBAL ? o + e * (float)j : 0.f;
    }
    if (JUMP) Jb[x] = (j < lim && al[j] > 0.f) ? jp : NEG;
  }
  const float jb0 = (JUMP && col0 < lim && al[col0] > 0.f) ? jp : NEG;
  // thread 0's diagonal: max(L, M, U[, J]) at (i-1, col0); EDGE: the left
  // edge's row 0 in block 0, else the previous block's last column of `top`
  float dB = !EDGE ? score_edge<MODE>(SB, c, 0, col0, o, e, w)
                   : (c == 0 ? w.edge(SB, 0) : top[2 * n_pad + col0]);
  __syncthreads();
  for (int i = 1; i <= (EDGE ? m_pad : ncols > 0 ? m : 0); ++i) {
    const int gi = i0 + i;  // the global row
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
        eg[st] = EDGE ? w.edge(st, i) : score_edge<MODE>(st, c, i, col0, o, e, w);
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
      if (MODE == LOCAL && (!EDGE || (gi <= m && j <= n)))
        acc = fmaxf(acc, mv);
      else if (MODE == GLOBAL && gi == m && j == n)
        acc = best;
      else if (MODE == FIT && gi == m && j <= n - 1)  // U is excluded
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
  if (EDGE)
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j(k);
      const size_t x = s.slot(k);
      bot[j] = Mr[x];
      bot[n_pad + j] = Lr[x];
      bot[2 * n_pad + j] = Br[x];
    }
  const float r = block_reduce<MaxF>(acc, tot[0]);
  if (tid == 0 && w.finish(pack(r), nb)) {
    float v = EDGE ? out[b] : NEG;
    for (int k = 0; k < nb; ++k) v = fmaxf(v, __int_as_float(w.candidate(k).x));
    // + 0.f turns a -0 into +0: the score is printed with %f
    out[b] = MODE == LOCAL && !EDGE ? v + 0.f : v;
  }
}

// Replaces the overlap branch of _blocked_affine_kernel (one matrix, linear
// gap o). Per slot: M, the row's candidates normalized by -o*j, the char.
// EDGE: the chunk phase (top and bottom: M).
template <bool EDGE = false>
__global__ void __launch_bounds__(MAX_THREADS)
bscore_overlap(const int* __restrict__ qs, const int* __restrict__ ts,
               const int* __restrict__ ns, const int* __restrict__ ms,
               const float* __restrict__ params, float* __restrict__ out, float* edges,
               int* flags, int4* cand, int m_pad, int n_pad, int c_blk, int W, Chunk ch = {}) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float tot[1][32];
  __shared__ float eg;  // M(i, col0), from thread 0
  __shared__ int ticket;
  const int nblk = (n_pad + c_blk - 1) / c_blk;
  Wave w(take_ticket(flags, &ticket), nblk, flags, edges, cand, m_pad, EDGE);
  const int b = w.b, c = w.c, tid = threadIdx.x;
  const int n = EDGE ? max(ns[b], 0) : min(max(ns[b], 0), n_pad);
  const int m = EDGE ? max(ms[b], 0) : min(max(ms[b], 0), m_pad);
  const int nb = EDGE ? nblk : max(1, (n + c_blk - 1) / c_blk);
  if (c >= nb) return;
  const size_t S = (size_t)blockDim.x * W;
  float* Mr = reinterpret_cast<float*>(smem);
  float* Cr = Mr + S;
  int* Tc = reinterpret_cast<int*>(Cr + S);
  const float match = params[0], mis = params[1], o = params[2];
  const int col0g = EDGE ? ch.col0g : 0, i0 = EDGE ? ch.i0 : 0;
  const int* q = qs + (size_t)b * m_pad;
  const int* t = ts + (size_t)b * n_pad - col0g;
  const float* top = EDGE ? static_cast<const float*>(ch.top) + (size_t)b * n_pad - col0g - 1
                          : nullptr;
  float* bot = EDGE ? static_cast<float*>(ch.bottom) + (size_t)b * n_pad - col0g - 1 : nullptr;
  const int col0 = col0g + c * c_blk;
  const int ncols = EDGE ? min(c_blk, n_pad - c * c_blk) : max(0, min(c_blk, n - col0));
  const bool feeds = EDGE || c + 1 < nb;
  const Strip s(col0, ncols, W);
  float acc = NEG;
  // M(i, col0): the column-0 border is 0; row 0 is -inf past column 0;
  // EDGE: the left edge (block 0) or the previous block's
  auto edge = [&](int i) {
    return EDGE || c > 0 ? (!EDGE && i == 0 ? NEG : w.edge(0, i)) : 0.f;
  };
  for (int k = 0; k < s.cnt; ++k) {
    const size_t x = s.slot(k);
    Tc[x] = t[s.j(k) - 1];
    Mr[x] = EDGE ? top[s.j(k)] : NEG;
  }
  float dM = EDGE && c > 0 ? top[col0] : edge(0);  // thread 0: M(i-1, col0)
  __syncthreads();
  for (int i = 1; i <= (EDGE ? m_pad : ncols > 0 ? m : 0); ++i) {
    const int gi = i0 + i;
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
      if (gi == m && j <= n - 1) acc = fmaxf(acc, mv);
      if (feeds && k == s.cnt - 1 && s.owns_last(ncols)) {
        w.put(0, i, mv);
        w.publish(i);
      }
    }
    __syncthreads();
  }
  if (EDGE)
    for (int k = 0; k < s.cnt; ++k) bot[s.j(k)] = Mr[s.slot(k)];
  const float r = block_reduce<MaxF>(acc, tot[0]);
  if (tid == 0 && w.finish(pack(r), nb)) {
    float v = EDGE ? out[b] : NEG;
    for (int k = 0; k < nb; ++k) v = fmaxf(v, __int_as_float(w.candidate(k).x));
    // the j = 0 border contributes its 0 (EDGE: the caller's); + 0.f turns a
    // -0 into +0
    out[b] = EDGE ? v : fmaxf(v, 0.f) + 0.f;
  }
}

// Replaces the edit branch of _blocked_affine_kernel (min-plus, indel 1,
// substitution cost params[1]), in int32. Per slot: M, the row's candidates
// normalized by -j, the char; the edges are int32. T double (P double: the
// params row in double) is the instance for a pair past float32's exact
// range: the same function in double, +inf in place of INT_MAX, double
// edges. EDGE (int32 only): the chunk phase (top and bottom: M).
template <class T = int, class P = float, bool EDGE = false>
__global__ void __launch_bounds__(MAX_THREADS)
bscore_edit(const int* __restrict__ qs, const int* __restrict__ ts,
            const int* __restrict__ ns, const int* __restrict__ ms,
            const P* __restrict__ params, T* __restrict__ out, T* edges, int* flags,
            int4* cand, int m_pad, int n_pad, int c_blk, int W, Chunk ch = {}) {
  using Min = typename Ops<T>::Min;
  const T TOP = std::is_same<T, int>::value ? (T)INT_MAX : (T)INFINITY;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ T tot[1][32];
  __shared__ T eg;  // M(i, col0), from thread 0
  __shared__ int ticket;
  const int nblk = (n_pad + c_blk - 1) / c_blk;
  Wave<T> w(take_ticket(flags, &ticket), nblk, flags, edges, cand, m_pad, EDGE);
  const int b = w.b, c = w.c, tid = threadIdx.x;
  const int n = EDGE ? max(ns[b], 0) : min(max(ns[b], 0), n_pad);
  const int m = EDGE ? max(ms[b], 0) : min(max(ms[b], 0), m_pad);
  const int nb = EDGE ? nblk : max(1, (n + c_blk - 1) / c_blk);
  if (c >= nb) return;
  const size_t S = (size_t)blockDim.x * W;
  T* Pr = reinterpret_cast<T*>(smem);
  T* Cr = Pr + S;
  int* Tc = reinterpret_cast<int*>(Cr + S);
  const T u = (T)params[1];
  const int col0g = EDGE ? ch.col0g : 0, i0 = EDGE ? ch.i0 : 0;
  const int* q = qs + (size_t)b * m_pad;
  const int* t = ts + (size_t)b * n_pad - col0g;
  const T* top = EDGE ? static_cast<const T*>(ch.top) + (size_t)b * n_pad - col0g - 1 : nullptr;
  T* bot = EDGE ? static_cast<T*>(ch.bottom) + (size_t)b * n_pad - col0g - 1 : nullptr;
  const int col0 = col0g + c * c_blk;
  const int ncols = EDGE ? min(c_blk, n_pad - c * c_blk) : max(0, min(c_blk, n - col0));
  const bool feeds = EDGE || c + 1 < nb;
  const Strip s(col0, ncols, W);
  T acc = TOP;
  // M(i, col0): M(i, 0) = i, M(0, j) = j; EDGE: the left edge (block 0) or
  // the previous block's
  auto edge = [&](int i) {
    return EDGE || c > 0 ? (!EDGE && i == 0 ? (T)col0 : w.edge(0, i)) : (T)i;
  };
  for (int k = 0; k < s.cnt; ++k) {
    const size_t x = s.slot(k);
    Tc[x] = t[s.j(k) - 1];
    Pr[x] = EDGE ? top[s.j(k)] : (T)s.j(k);
  }
  T dM = EDGE && c > 0 ? top[col0] : edge(0);  // thread 0: M(i-1, col0)
  __syncthreads();
  for (int i = 1; i <= (EDGE ? m_pad : ncols > 0 ? m : 0); ++i) {
    const int gi = i0 + i;
    const int qc = q[i - 1];
    T diag = tid == 0 ? dM : (s.cnt > 0 ? Pr[s.left] : (T)0);
    T agg[1] = {TOP};
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j(k);
      const size_t x = s.slot(k);
      const T pp = Pr[x];
      const T sub = Tc[x] == qc ? (T)0 : u;
      const T cv = Min::op(diag + sub, pp + (T)1) - (T)j;
      Cr[x] = cv;
      agg[0] = Min::op(agg[0], cv);
      diag = pp;
    }
    if (tid == 0) {
      if (c > 0) w.wait(i);
      dM = eg = edge(i);
    }
    const T none[1] = {TOP};
    block_exclusive<Min>(agg, none, tot);
    T run = Min::op(eg - (T)col0, agg[0]);
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j(k);
      const size_t x = s.slot(k);
      run = Min::op(run, Cr[x]);
      const T v = run + (T)j;
      Pr[x] = v;
      if (gi == m && j == n) acc = v;
      if (feeds && k == s.cnt - 1 && s.owns_last(ncols)) {
        w.put(0, i, v);
        w.publish(i);
      }
    }
    __syncthreads();
  }
  if (EDGE)
    for (int k = 0; k < s.cnt; ++k) bot[s.j(k)] = Pr[s.slot(k)];
  const T r = block_reduce<Min>(acc, tot[0]);
  if (tid == 0 && w.finish(pack(r), nb)) {
    T v = EDGE ? out[b] : TOP;
    for (int k = 0; k < nb; ++k) v = Min::op(v, unpack<T>(w.candidate(k)));
    // before any row, the result is M(0, n)'s latch value 0, as in the flat
    // fills; INT_MAX (+inf) when n == 0
    out[b] = (!EDGE && m == 0 && n > 0) ? (T)0 : v;
  }
}

// ---------------------------------------------------------------------------
// Pointer fills
// ---------------------------------------------------------------------------

// Edge states of the affine pointer fill: M, L, U, J (also the state rows
// of a checkpoint, in this order: engine/scan.py's carry layout).
constexpr int PM = 0, PL = 1, PU = 2, PJ = 3;

// The phases of the pointer fills: the whole matrix with pointers; the
// checkpoint forward; the seeded refill of one row block; one chunk of one
// rank's column slice (as the score fills' EDGE above: top and bottom M, L,
// U[, J] of TOP_STATES, the pointer bytes into rows i0/rpb .. of the rank's
// slab, the start candidate merged into Chunk::acc).
constexpr int FILL = 0, CKPT = 1, SEED = 2, EDGE = 3;

// State s of (row i, column col0) as block c reads it; column 0's border is
// taken at the global row i0 + i (i0 > 0 in a refill only).
template <int MODE, class T>
__device__ __forceinline__ T ptr_edge(int s, int c, int i, int i0, int col0, T o,
                                          T e, const Wave<T>& w) {
  constexpr T NG = (T)NEG;
  if (c == 0) {  // column 0
    const int gi = i0 + i;
    if (s == PJ) return NG;
    if (MODE == LOCAL) return (T)0;
    if (s == PL) return MODE == GLOBAL ? o + e * (T)gi : NG;
    if (gi > 0) return NG;
    return (MODE == GLOBAL && s == PU) ? o : (T)0;
  }
  if (i == 0) {  // row 0 past column 0
    if (s == PJ) return NG;
    if (MODE == LOCAL) return (T)0;
    if (MODE == GLOBAL) return s == PU ? o + e * (T)col0 : NG;
    return s == PL ? NG : (T)0;  // fit: M = U = 0
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
template <int MODE, bool JUMP, int PHASE, class T = float>
__global__ void __launch_bounds__(MAX_THREADS)
bptr_affine(const int* __restrict__ qs, const int* __restrict__ ts,
            const float* __restrict__ allow, const int* __restrict__ ns,
            const int* __restrict__ ms, const T* __restrict__ params,
            T* __restrict__ score_out, int* __restrict__ a_out, int* __restrict__ b_out,
            uint8_t* __restrict__ ptrs, T* edges, int* flags, int4* cand, T* ck,
            int m_pad, int n_pad, int c_blk, int W, int rpb, int stride, int i0,
            Chunk ch = {}) {
  constexpr bool PTRS = PHASE != CKPT, LATCH = PHASE != SEED, CH = PHASE == EDGE;
  constexpr T NG = (T)NEG;
  using Max = typename Ops<T>::Max;
  // a checkpoint's state rows: M, L, U, and fit's J (-inf without the jump)
  constexpr int ST = MODE == FIT ? 4 : 3;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ T tot[3][32];
  __shared__ T red_f[2][32];
  __shared__ int red_i[32];
  __shared__ T eg[4];  // row i's edge at col0, from thread 0
  __shared__ T g_s;
  __shared__ int g_a, ticket;
  const int nblk = (n_pad + c_blk - 1) / c_blk;
  Wave<T> w(take_ticket(flags, &ticket), nblk, flags, edges, cand, m_pad, CH);
  const int b = w.b, c = w.c, tid = threadIdx.x;
  const size_t S = (size_t)blockDim.x * W;
  uint8_t* stage = smem;  // the byte-row being packed, c_blk bytes
  T* eM = reinterpret_cast<T*>(smem + c_blk);  // row i-1, last column
  T* eL = eM + blockDim.x;
  T* Mr = eL + blockDim.x;
  T* Lr = Mr + S;
  T* Ur = Lr + S;
  T* Jr = Ur + S;
  T* Jb = Jr + (JUMP ? S : 0);  // jp where entry into column j+1 is allowed
  int* Tc = reinterpret_cast<int*>(Jb + (JUMP ? S : 0));
  uint8_t* Cd = reinterpret_cast<uint8_t*>(Tc + S);
  const T match = params[0], mis = params[1], o = params[2], e = params[3];
  const T jp = params[4];
  const int k_home = rpb > 1 ? 3 : 4, k_unset = rpb > 1 ? 3 : 7;
  const int lbit = rpb > 1 ? 1 << 2 : 1 << 3, ubit = rpb > 1 ? 1 << 3 : 1 << 4;
  const int bits = 8 / rpb, R = m_pad / rpb;
  const int n = CH ? max(ns[b], 0) : min(max(ns[b], 0), n_pad);
  const int m = CH ? max(ms[b], 0) : min(max(ms[b], 0), m_pad);
  // EDGE: global columns col0g+1 .., local index j - 1 - col0g of ts,
  // allow and the state rows; the launch's rows are global i0+1 ..
  const int col0g = CH ? ch.col0g : 0, gi0 = CH ? i0 : 0;
  const int* q = qs + (size_t)b * m_pad;
  const int* t = ts + (size_t)b * n_pad - col0g;
  const float* al = allow + (size_t)b * n_pad - col0g;
  const T* top = CH ? static_cast<const T*>(ch.top) + (size_t)b * ST * n_pad - col0g - 1 : nullptr;
  uint8_t* out = !PTRS ? nullptr
                 : CH  ? ptrs + ((size_t)b * ch.slab_rows + i0 / rpb) * n_pad
                       : ptrs + (size_t)b * R * n_pad;
  // the block's columns: c_blk, or fewer in a ragged last block (lc0 its
  // first in the row's memory)
  const int lc0 = c * c_blk, col0 = col0g + lc0, bw = min(c_blk, n_pad - lc0);
  const int lim = col0g + n_pad;  // allow's columns end here
  const bool feeds = CH || c + 1 < nblk;
  const Strip s(col0, bw, W);
  // the checkpoint's state rows: CKPT, of each pair and S-th row; SEED, the
  // one row this block starts from (64-bit offsets: the tensor passes 2^31)
  const size_t ck_row = (size_t)n_pad + 1;
  const int nck = PHASE == CKPT ? m_pad / stride : 1;
  const T* seed = PHASE == SEED ? ck + (size_t)b * ST * ck_row : nullptr;
  const int r0 = PHASE == SEED ? i0 : 0;  // the global row of row 0
  // CKPT: this thread's columns (and column 0's border, block 0's thread 0)
  // of row i as checkpoint i / stride
  auto put_ck = [&](int i) {
    T* dst = ck + ((size_t)b * nck + i / stride) * ST * ck_row;
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j(k);
      const size_t x = s.slot(k);
      dst[PM * ck_row + j] = Mr[x];
      dst[PL * ck_row + j] = Lr[x];
      dst[PU * ck_row + j] = Ur[x];
      if (ST > 3) dst[PJ * ck_row + j] = JUMP ? Jr[x] : NG;
    }
    if (c == 0 && tid == 0)
      for (int st = 0; st < ST; ++st) dst[st * ck_row] = ptr_edge<MODE, T>(st, 0, i, 0, 0, o, e, w);
  };
  if (tid == 0) {
    g_s = NG;
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
    } else if (CH) {
      Mr[x] = top[PM * n_pad + j];
      Lr[x] = top[PL * n_pad + j];
      Ur[x] = top[PU * n_pad + j];
    } else {
      Mr[x] = MODE == GLOBAL ? NG : (T)0;
      Lr[x] = MODE == LOCAL ? (T)0 : NG;
      Ur[x] = MODE == GLOBAL ? o + e * (T)j : (T)0;
    }
    if (JUMP) {
      Jr[x] = PHASE == SEED ? seed[PJ * ck_row + j] : CH ? top[PJ * n_pad + j] : NG;
      Jb[x] = (j < lim && al[j] > 0.f) ? jp : NG;
    }
  }
  if (s.cnt > 0) {
    eM[tid] = Mr[s.slot(s.cnt - 1)];
    eL[tid] = Lr[s.slot(s.cnt - 1)];
  }
  const T jb0 = (JUMP && al[col0] > 0.f) ? jp : NG;
  // thread 0's diagonal: row i-1's M, L, U, J at col0 (SEED past block 0:
  // the checkpoint's column col0)
  // (EDGE: the left edge's row 0 in block 0, else the previous block's last
  // column of `top`)
  const bool from_ck = PHASE == SEED && c > 0, from_top = CH && c > 0;
  auto row0 = [&](int st) {
    return from_ck ? seed[st * ck_row + col0]
         : from_top ? top[st * n_pad + col0]
         : CH ? w.edge(st, 0) : ptr_edge<MODE, T>(st, c, 0, r0, col0, o, e, w);
  };
  T eM0 = row0(PM), eL0 = row0(PL), eU0 = row0(PU);
  T eJ0 = (JUMP && (from_ck || CH)) ? row0(PJ) : NG;
  if (PHASE == CKPT) put_ck(0);
  // this block's start info: local's running maximum, fit's bottom row
  T blk_s = NG;
  int blk_a = 0, blk_b = 0;
  __syncthreads();
  for (int i = 1; i <= m_pad; ++i) {
    const int idx = i - 1, sub_row = idx % rpb, shift = sub_row * bits;
    const int gi = gi0 + i;  // the global row (FILL, CKPT: i)
    if (PTRS && sub_row == 0 && i > 1)
      store_row(stage, out + (size_t)(idx / rpb - 1) * n_pad + lc0, bw);
    const int qc = q[idx];
    // row i-1 at column j0-1
    T dM, dL, dU, dJ = NG;
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
      dM = dL = dU = NG;
    }
    T v[3] = {NG, NG, NG};  // U chain, J chain, local row max (j <= n)
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j(k);
      const size_t x = s.slot(k);
      const T mo = Mr[x], lo = Lr[x], uo = Ur[x];
      const T jo = JUMP ? Jr[x] : NG;
      const T sub = Tc[x] == qc ? match : mis;
      // earliest-argument strict argmax: L, M, U, J, HOME
      T best = dL + sub;
      int pm = 0;
      T cv = dM + sub;
      if (cv > best) pm = 1;
      best = vmax(best, cv);
      cv = dU + sub;
      if (cv > best) pm = 2;
      best = vmax(best, cv);
      if (JUMP) {
        cv = dJ + sub;
        if (cv > best) pm = 3;
        best = vmax(best, cv);
      }
      if (MODE == LOCAL) {
        if ((T)0 > best) pm = k_home;  // the HOME candidate has no +sub
        best = vmax(best, (T)0);
      }
      if (!(best > NG)) pm = k_unset;
      const T la = lo + e, lb2 = mo + o;
      Mr[x] = best;
      Lr[x] = vmax(la, lb2);
      if (PTRS) Cd[x] = (uint8_t)(pm | (la >= lb2 ? 0 : lbit));
      v[0] = vmax(v[0], best + (o - e * (T)(j + 1)));
      if (JUMP) v[1] = vmax(v[1], best + Jb[x]);
      if (MODE == LOCAL && j <= n) v[2] = vmax(v[2], best);
      dM = mo;
      dL = lo;
      dU = uo;
      dJ = jo;
    }
    if (tid == 0) {
      if (c > 0) w.wait(i);
      auto at = [&](int st) {
        return CH ? w.edge(st, i) : ptr_edge<MODE, T>(st, c, i, r0, col0, o, e, w);
      };
      eg[PM] = eM0 = at(PM);
      eg[PL] = eL0 = at(PL);
      eg[PU] = eU0 = at(PU);
      if (JUMP) eg[PJ] = eJ0 = at(PJ);
    }
    const T none[3] = {NG, NG, NG};
    T total[3];
    block_exclusive<Max>(v, none, total, tot);
    // the chains' column-col0 terms (as in bscore_affine)
    const T em = eg[PM];
    T run_u = vmax(vmax(eg[PU] - e * (T)col0, em + (o - e * (T)(col0 + 1))), v[0]);
    T run_j = JUMP ? vmax(vmax(eg[PJ], em + jb0), v[1]) : NG;
    // M(i, j-1) and J's entry into column j, at the strip's first column
    T mprev = em, jcv = JUMP ? em + jb0 : NG;
    if (tid > 0 && s.cnt > 0) {
      mprev = Mr[s.left];
      if (JUMP) jcv = mprev + Jb[s.left];
    }
    const bool last_row = gi == m;
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j(k);
      const size_t x = s.slot(k);
      const T mv = Mr[x];
      const T uv = run_u + e * (T)j;
      const T ua = mprev + o;
      // U(i,j) = max(ua, U(i,j-1) + e), so ua >= U(i,j-1) + e iff ua >= U(i,j)
      int code = PTRS ? Cd[x] | (ua >= uv ? 0 : ubit) : 0;
      Ur[x] = uv;
      if (JUMP) {
        // J(i,j) = max(J(i,j-1), jcv): jcv >= J(i,j-1) iff jcv >= J(i,j)
        code |= (jcv > NG && jcv >= run_j) ? 0 : 1 << 5;
        Jr[x] = run_j;
        jcv = mv + Jb[x];
        run_j = vmax(run_j, jcv);
      }
      if (PTRS) {
        const int col = s.k0 + k;
        stage[col] = (uint8_t)(sub_row == 0 ? code : stage[col] | (code << shift));
      }
      if (LATCH && MODE == GLOBAL && last_row && j == n) {
        const T ln = Lr[x];
        g_s = vmax(vmax(ln, mv), uv);
        g_a = (ln >= mv && ln >= uv) ? 0 : (mv >= uv ? 1 : 2);
      }
      run_u = vmax(run_u, mv + (o - e * (T)(j + 1)));
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
    if (LATCH && MODE == LOCAL && gi <= m && total[2] > blk_s) {
      // a strictly greater row maximum: its first column over j <= n
      int fj = BIG;
      for (int k = 0; k < s.cnt && fj == BIG; ++k)
        if (s.j(k) <= n && Mr[s.slot(k)] == total[2]) fj = s.j(k);
      blk_b = block_reduce<MinI>(fj, red_i);
      blk_s = total[2];
      blk_a = gi;
    }
    if (LATCH && MODE == FIT && last_row) {
      // this block's bottom row over columns <= n-1; L wins only when
      // strictly greater
      T mx[2] = {NG, NG};
      for (int k = 0; k < s.cnt && s.j(k) <= n - 1; ++k) {
        mx[0] = vmax(mx[0], Mr[s.slot(k)]);
        mx[1] = vmax(mx[1], Lr[s.slot(k)]);
      }
      mx[0] = block_reduce<Max>(mx[0], red_f[0]);
      mx[1] = block_reduce<Max>(mx[1], red_f[1]);
      const bool use_l = mx[1] > mx[0];
      const T want = use_l ? mx[1] : mx[0];
      const T* row = use_l ? Lr : Mr;
      int fj = BIG;
      for (int k = 0; k < s.cnt && fj == BIG; ++k)
        if (s.j(k) <= n - 1 && row[s.slot(k)] == want) fj = s.j(k);
      blk_b = block_reduce<MinI>(fj, red_i);
      blk_s = vmax(mx[0], mx[1]);
      blk_a = use_l ? 1 : 0;
    }
    __syncthreads();
  }
  if (PTRS) store_row(stage, out + (size_t)(R - 1) * n_pad + lc0, bw);
  if (CH) {  // row i0 + m_pad's states for the next chunk
    T* bot = static_cast<T*>(ch.bottom) + (size_t)b * ST * n_pad - col0g - 1;
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j(k);
      const size_t x = s.slot(k);
      bot[PM * n_pad + j] = Mr[x];
      bot[PL * n_pad + j] = Lr[x];
      bot[PU * n_pad + j] = Ur[x];
      if (ST > 3) bot[PJ * n_pad + j] = JUMP ? Jr[x] : NG;
    }
  }
  if (!LATCH) return;
  if (CH) {
    if (tid == 0 && w.finish(MODE == GLOBAL ? pack(g_s, g_a) : pack(blk_s, blk_a, blk_b), nblk)) {
      // merge into the chunks' running candidate, as FILL's merge below: the
      // block holding (m, n); local's, after the earlier chunks'; fit's row m
      const bool holds_m = gi0 < m && m <= gi0 + m_pad;
      int4 acc = ch.acc[b];
      if (MODE == GLOBAL) {
        if (holds_m && n > col0g && n <= col0g + n_pad) acc = w.candidate((n - 1 - col0g) / c_blk);
      } else if (MODE == LOCAL || holds_m) {
        for (int k = 0; k < nblk; ++k) {
          const int4 x = w.candidate(k);
          const T fs = unpack<T>(x), as = unpack<T>(acc);
          const bool take =
              MODE == LOCAL
                  ? fs > as || (fs == as && x.y < acc.y)
                  : k == 0 || fs > as || (fs == as && (x.y < acc.y || (x.y == acc.y && x.z < acc.z)));
          if (take) acc = x;
        }
      }
      ch.acc[b] = acc;
    }
    return;
  }
  if (tid == 0 && w.finish(MODE == GLOBAL ? pack(g_s, g_a) : pack(blk_s, blk_a, blk_b), nblk)) {
    T acc_s = NG;
    int acc_a = 0, acc_b = 0;
    if (MODE == GLOBAL) {
      if (n > 0) {  // the block that holds column n latched (m, n)
        const int4 x = w.candidate((n - 1) / c_blk);
        acc_s = unpack<T>(x);
        acc_a = x.y;
      }
    } else if (MODE == LOCAL || m > 0) {  // fit's candidates come from row m
      for (int k = 0; k < nblk; ++k) {
        const int4 x = w.candidate(k);
        const T fs = unpack<T>(x);
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
template <int PHASE, class T = float>
__global__ void __launch_bounds__(MAX_THREADS)
bptr_overlap(const int* __restrict__ qs, const int* __restrict__ ts,
             const int* __restrict__ ns, const int* __restrict__ ms,
             const T* __restrict__ params, T* __restrict__ score_out,
             int* __restrict__ a_out, int* __restrict__ b_out, uint8_t* __restrict__ ptrs,
             T* edges, int* flags, int4* cand, T* ck, int m_pad, int n_pad, int c_blk,
             int W, int rpb, int stride, int i0 = 0, Chunk ch = {}) {
  constexpr bool PTRS = PHASE != CKPT, LATCH = PHASE != SEED, CH = PHASE == EDGE;
  constexpr T NG = (T)NEG;
  using Max = typename Ops<T>::Max;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ T tot[1][32];
  __shared__ T red_f[32];
  __shared__ int red_i[32];
  __shared__ T eg;  // M(i, col0), from thread 0
  __shared__ int ticket;
  const int nblk = (n_pad + c_blk - 1) / c_blk;
  Wave<T> w(take_ticket(flags, &ticket), nblk, flags, edges, cand, m_pad, CH);
  const int b = w.b, c = w.c, tid = threadIdx.x;
  const size_t S = (size_t)blockDim.x * W;
  uint8_t* stage = smem;
  T* Mr = reinterpret_cast<T*>(smem + c_blk);
  T* Dr = Mr + S;
  int* Tc = reinterpret_cast<int*>(Dr + S);
  uint8_t* Cd = reinterpret_cast<uint8_t*>(Tc + S);
  const T match = params[0], mis = params[1], o = params[2];
  const int bits = 8 / rpb, R = m_pad / rpb;
  const int n = CH ? max(ns[b], 0) : min(max(ns[b], 0), n_pad);
  const int m = CH ? max(ms[b], 0) : min(max(ms[b], 0), m_pad);
  const int col0g = CH ? ch.col0g : 0, gi0 = CH ? i0 : 0;
  const int* q = qs + (size_t)b * m_pad;
  const int* t = ts + (size_t)b * n_pad - col0g;
  const T* top = CH ? static_cast<const T*>(ch.top) + (size_t)b * n_pad - col0g - 1 : nullptr;
  uint8_t* out = !PTRS ? nullptr
                 : CH  ? ptrs + ((size_t)b * ch.slab_rows + i0 / rpb) * n_pad
                       : ptrs + (size_t)b * R * n_pad;
  // a ragged last block; lc0 its first column in the row's memory
  const int lc0 = c * c_blk, col0 = col0g + lc0, bw = min(c_blk, n_pad - lc0);
  const bool feeds = CH || c + 1 < nblk;
  const Strip s(col0, bw, W);
  const size_t ck_row = (size_t)n_pad + 1;
  const int nck = PHASE == CKPT ? m_pad / stride : 1;
  const T* seed = PHASE == SEED ? ck + (size_t)b * ck_row : nullptr;
  // CKPT: this thread's columns of row i as checkpoint i / stride; M(i, 0) = 0
  auto put_ck = [&](int i) {
    T* dst = ck + ((size_t)b * nck + i / stride) * ck_row;
    for (int k = 0; k < s.cnt; ++k) dst[s.j(k)] = Mr[s.slot(k)];
    if (c == 0 && tid == 0) dst[0] = (T)0;
  };
  // M(i, col0): the column-0 border is 0; row 0 is -inf past column 0
  // (EDGE: the left edge in block 0, else the previous block's)
  auto edge = [&](int i) {
    return CH || c > 0 ? (!CH && i == 0 ? NG : w.edge(0, i)) : (T)0;
  };
  for (int k = 0; k < s.cnt; ++k) {
    const size_t x = s.slot(k);
    Tc[x] = t[s.j(k) - 1];
    Mr[x] = PHASE == SEED ? seed[s.j(k)] : CH ? top[s.j(k)] : NG;
  }
  // thread 0: M(i-1, col0) (SEED past block 0: the checkpoint's column col0;
  // EDGE past block 0: the previous block's last column of `top`)
  T dM0 = (PHASE == SEED && c > 0) ? seed[col0] : (CH && c > 0) ? top[col0] : edge(0);
  if (PHASE == CKPT) put_ck(0);
  // this block's bottom row: its maximum over columns <= n-1, first column
  T blk_s = NG;
  int blk_a = 0;
  __syncthreads();
  for (int i = 1; i <= m_pad; ++i) {
    const int idx = i - 1, sub_row = idx % rpb, shift = sub_row * bits;
    if (PTRS && sub_row == 0 && i > 1)
      store_row(stage, out + (size_t)(idx / rpb - 1) * n_pad + lc0, bw);
    const int qc = q[idx];
    // M(i-1, j0-1); Mr is rewritten only in pass 2
    T dM = tid == 0 ? dM0 : (s.cnt > 0 ? Mr[s.left] : NG);
    T v[1] = {NG};
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j(k);
      const size_t x = s.slot(k);
      const T mp = Mr[x];
      const T sub = Tc[x] == qc ? match : mis;
      const T diag = dM + sub, right = mp + o;
      const T dr = vmax(diag, right);
      Dr[x] = dr;
      if (PTRS) Cd[x] = diag >= right ? 1 : 2;
      v[0] = vmax(v[0], dr - o * (T)j);
      dM = mp;
    }
    if (tid == 0) {
      if (c > 0) w.wait(i);
      dM0 = eg = edge(i);
    }
    const T none[1] = {NG};
    block_exclusive<Max>(v, none, tot);
    T run = vmax(eg - o * (T)col0, v[0]);  // M(i, col0) seeds the chain
    // M(i, j0-1), as the left neighbour (or the previous block) has it
    T mprev = run + o * (T)(s.j(0) - 1);
    for (int k = 0; k < s.cnt; ++k) {
      const int j = s.j(k);
      const size_t x = s.slot(k);
      const T dr = Dr[x];
      if (PTRS) {
        const T left = mprev + o;
        const T val = vmax(left, dr);
        int code = left >= val ? 0 : Cd[x];
        if (!(val > NG)) code = 3;
        const int col = s.k0 + k;
        stage[col] = (uint8_t)(sub_row == 0 ? code : stage[col] | (code << shift));
      }
      run = vmax(run, dr - o * (T)j);
      const T mv = run + o * (T)j;
      Mr[x] = mv;
      mprev = mv;
      if (feeds && k == s.cnt - 1 && s.owns_last(bw)) {
        w.put(0, i, mv);
        w.publish(i);
      }
    }
    if (PHASE == CKPT && i % stride == 0 && i < m_pad) put_ck(i);
    if (LATCH && gi0 + i == m) {
      T mx = NG;
      for (int k = 0; k < s.cnt && s.j(k) <= n - 1; ++k) mx = vmax(mx, Mr[s.slot(k)]);
      mx = block_reduce<Max>(mx, red_f);
      int fj = BIG;
      for (int k = 0; k < s.cnt && fj == BIG; ++k)
        if (s.j(k) <= n - 1 && Mr[s.slot(k)] == mx) fj = s.j(k);
      blk_a = block_reduce<MinI>(fj, red_i);
      blk_s = mx;
    }
    __syncthreads();
  }
  if (PTRS) store_row(stage, out + (size_t)(R - 1) * n_pad + lc0, bw);
  if (CH) {
    T* bot = static_cast<T*>(ch.bottom) + (size_t)b * n_pad - col0g - 1;
    for (int k = 0; k < s.cnt; ++k) bot[s.j(k)] = Mr[s.slot(k)];
  }
  if (!LATCH) return;
  if (CH) {  // row m's first greatest, raw (the j = 0 candidate is the caller's)
    if (tid == 0 && w.finish(pack(blk_s, blk_a), nblk) && gi0 < m && m <= gi0 + m_pad) {
      int4 acc = w.candidate(0);
      for (int k = 1; k < nblk; ++k) {
        const int4 x = w.candidate(k);
        if (unpack<T>(x) > unpack<T>(acc)) acc = x;
      }
      ch.acc[b] = acc;
    }
    return;
  }
  if (tid == 0 && w.finish(pack(blk_s, blk_a), nblk)) {
    T acc_s = NG;
    int acc_a = 0;
    for (int k = 0; k < (m > 0 ? nblk : 0); ++k) {
      const int4 x = w.candidate(k);
      const T mx = unpack<T>(x);
      if (k == 0) {  // block 0 also holds the j = 0 zero candidate, which wins ties
        acc_s = vmax(mx, (T)0);
        acc_a = mx > (T)0 ? x.y : 0;
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

// One pointer fill of `PHASE` (FILL, CKPT or SEED) in value type T: the
// checks of the layout, then the mode's instance; returns the launch's error
// code.
template <int PHASE, class T>
cudaError_t launch_ptr(int mode, int use_jump, int rpb, const int* qs, const int* ts,
                       const float* allow, const int* ns, const int* ms, const T* params,
                       T* score, int* a, int* b, uint8_t* ptrs, T* edges, int* flags, void* cand,
                       T* ck, int B, int m_pad, int n_pad, int c_blk, int threads, int wmax,
                       int stride, int i0, cudaStream_t stream) {
  const bool bad_layout = (rpb != 1 && rpb != 2 && rpb != 4) || m_pad % (8 * rpb) != 0 ||
                          (rpb > 1 && use_jump) || (rpb == 4 && mode != OVERLAP) ||
                          (use_jump && mode != FIT);
  if (bad_blocks(B, threads, wmax, m_pad, n_pad, c_blk) || mode < GLOBAL || mode > OVERLAP ||
      bad_layout)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int ctas = B * ((n_pad + c_blk - 1) / c_blk);
  const size_t S = (size_t)threads * wmax, V = sizeof(T);
  int4* cd = static_cast<int4*>(cand);
  if (mode == OVERLAP)  // stage, M, max(DIAG, RIGHT), char, code
    return launch(bptr_overlap<PHASE, T>, ctas, threads, c_blk + S * (2 * V + 5), stream, qs, ts,
                  ns, ms, params, score, a, b, ptrs, edges, flags, cd, ck, m_pad, n_pad, c_blk,
                  wmax, rpb, stride, 0, Chunk{});
  // stage, the threads' last M and L, M, L, U[, J, jump bias], char, code
  const size_t smem = c_blk + (size_t)threads * 2 * V + S * ((use_jump ? 5 : 3) * V + 5);
  if (mode == GLOBAL)
    return launch(bptr_affine<GLOBAL, false, PHASE, T>, ctas, threads, smem, stream, qs, ts,
                  allow, ns, ms, params, score, a, b, ptrs, edges, flags, cd, ck, m_pad, n_pad,
                  c_blk, wmax, rpb, stride, i0, Chunk{});
  if (mode == LOCAL)
    return launch(bptr_affine<LOCAL, false, PHASE, T>, ctas, threads, smem, stream, qs, ts,
                  allow, ns, ms, params, score, a, b, ptrs, edges, flags, cd, ck, m_pad, n_pad,
                  c_blk, wmax, rpb, stride, i0, Chunk{});
  if (use_jump)
    return launch(bptr_affine<FIT, true, PHASE, T>, ctas, threads, smem, stream, qs, ts, allow,
                  ns, ms, params, score, a, b, ptrs, edges, flags, cd, ck, m_pad, n_pad, c_blk,
                  wmax, rpb, stride, i0, Chunk{});
  return launch(bptr_affine<FIT, false, PHASE, T>, ctas, threads, smem, stream, qs, ts, allow,
                ns, ms, params, score, a, b, ptrs, edges, flags, cd, ck, m_pad, n_pad, c_blk,
                wmax, rpb, stride, i0, Chunk{});
}

// One EDGE-phase pointer fill (float32): the checks, then the mode's
// instance; the layout is launch_ptr's, with the chunk's rows (m_pad) and
// the slice's columns (n_pad).
cudaError_t launch_edge_ptr(int mode, int use_jump, int rpb, const int* qs, const int* ts,
                            const float* allow, const int* ns, const int* ms,
                            const float* params, uint8_t* slab, float* edges, int* flags,
                            void* cand, int B, int R, int nloc, int c_blk, int threads, int wmax,
                            Chunk ch, cudaStream_t stream) {
  const bool bad_layout = (rpb != 1 && rpb != 2 && rpb != 4) || R % (8 * rpb) != 0 ||
                          ch.i0 % (8 * rpb) != 0 || (rpb > 1 && use_jump) ||
                          (rpb == 4 && mode != OVERLAP) || (use_jump && mode != FIT) ||
                          ch.col0g < 0 || ch.col0g % 16 != 0 || ch.i0 < 0 ||
                          ch.slab_rows < (ch.i0 + R) / rpb || ch.top == nullptr ||
                          ch.bottom == nullptr || ch.acc == nullptr;
  if (bad_blocks(B, threads, wmax, R, nloc, c_blk) || mode < GLOBAL || mode > OVERLAP ||
      bad_layout)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int ctas = B * ((nloc + c_blk - 1) / c_blk);
  const size_t S = (size_t)threads * wmax, V = sizeof(float);
  int4* cd = static_cast<int4*>(cand);
  if (mode == OVERLAP)
    return launch(bptr_overlap<EDGE, float>, ctas, threads, c_blk + S * (2 * V + 5), stream, qs,
                  ts, ns, ms, params, nullptr, nullptr, nullptr, slab, edges, flags, cd, nullptr,
                  R, nloc, c_blk, wmax, rpb, 1, ch.i0, ch);
  const size_t smem = c_blk + (size_t)threads * 2 * V + S * ((use_jump ? 5 : 3) * V + 5);
  auto go = [&](auto kernel) {
    return launch(kernel, ctas, threads, smem, stream, qs, ts, allow, ns, ms, params, nullptr,
                  nullptr, nullptr, slab, edges, flags, cd, nullptr, R, nloc, c_blk, wmax, rpb, 1,
                  ch.i0, ch);
  };
  if (mode == GLOBAL) return go(bptr_affine<GLOBAL, false, EDGE, float>);
  if (mode == LOCAL) return go(bptr_affine<LOCAL, false, EDGE, float>);
  if (use_jump) return go(bptr_affine<FIT, true, EDGE, float>);
  return go(bptr_affine<FIT, false, EDGE, float>);
}

}  // namespace

// C entry points, bound with ctypes. Each launches one fill on `stream`
// without synchronising and returns the launch's error code. With nblk =
// ceil(n_pad / c_blk): `edges` is the (B, nblk, 4, m_pad + 1) block-edge
// buffer of the fill's value type (float32; float64 in the double entries,
// the *64 below), `flags` the (1 + B * (nblk + 1)) int32 ticket, progress
// and done counters, zeroed, and `cand` the (B, nblk, 4) int32 start-info
// candidates.
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
    return launch(bscore_overlap<false>, ctas, threads, S * 12, stream, qs, ts, ns, ms, params,
                  f_out, edges, flags, cd, m_pad, n_pad, c_blk, wmax, Chunk{});
  if (mode == EDIT)
    return launch(bscore_edit<int, float>, ctas, threads, S * 12, stream, qs, ts, ns, ms, params,
                  static_cast<int*>(out), reinterpret_cast<int*>(edges), flags, cd, m_pad, n_pad,
                  c_blk, wmax, Chunk{});
  const size_t smem = S * (use_jump ? 20 : 16);
  if (mode == GLOBAL)
    return launch(bscore_affine<GLOBAL, false>, ctas, threads, smem, stream, qs, ts, allow, ns,
                  ms, params, f_out, edges, flags, cd, m_pad, n_pad, c_blk, wmax, Chunk{});
  if (mode == LOCAL)
    return launch(bscore_affine<LOCAL, false>, ctas, threads, smem, stream, qs, ts, allow, ns,
                  ms, params, f_out, edges, flags, cd, m_pad, n_pad, c_blk, wmax, Chunk{});
  if (use_jump)
    return launch(bscore_affine<FIT, true>, ctas, threads, smem, stream, qs, ts, allow, ns, ms,
                  params, f_out, edges, flags, cd, m_pad, n_pad, c_blk, wmax, Chunk{});
  return launch(bscore_affine<FIT, false>, ctas, threads, smem, stream, qs, ts, allow, ns, ms,
                params, f_out, edges, flags, cd, m_pad, n_pad, c_blk, wmax, Chunk{});
}

// The double instance of edit's blocked score fill (a pair past float32's
// exact range): `params` the (1, 8) float64 row, `out` (B,) float64,
// `edges` float64.
cudaError_t at_blocked_edit64(const int* qs, const int* ts, const int* ns, const int* ms,
                              const double* params, double* out, double* edges, int* flags,
                              void* cand, int B, int m_pad, int n_pad, int c_blk, int threads,
                              int wmax, cudaStream_t stream) {
  if (bad_blocks(B, threads, wmax, m_pad, n_pad, c_blk)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int ctas = B * ((n_pad + c_blk - 1) / c_blk);
  const size_t S = (size_t)threads * wmax;
  return launch(bscore_edit<double, double>, ctas, threads, S * 20, stream, qs, ts, ns, ms,
                params, out, edges, flags, static_cast<int4*>(cand), m_pad, n_pad, c_blk, wmax,
                Chunk{});
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
  return launch_ptr<FILL, float>(mode, use_jump, rpb, qs, ts, allow, ns, ms, params, score, a, b,
                                 ptrs, edges, flags, cand, nullptr, B, m_pad, n_pad, c_blk,
                                 threads, wmax, 1, 0, stream);
}

// at_blocked_ptr_fill's double instance: `params` the (1, 8) float64 row,
// `score` (B,) float64, `edges` float64; the pointer bytes as its.
cudaError_t at_blocked_ptr_fill64(int mode, int use_jump, int rpb, const int* qs, const int* ts,
                                  const float* allow, const int* ns, const int* ms,
                                  const double* params, double* score, int* a, int* b,
                                  uint8_t* ptrs, double* edges, int* flags, void* cand, int B,
                                  int m_pad, int n_pad, int c_blk, int threads, int wmax,
                                  cudaStream_t stream) {
  return launch_ptr<FILL, double>(mode, use_jump, rpb, qs, ts, allow, ns, ms, params, score, a,
                                  b, ptrs, edges, flags, cand, nullptr, B, m_pad, n_pad, c_blk,
                                  threads, wmax, 1, 0, stream);
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
  return launch_ptr<CKPT, float>(mode, use_jump, 1, qs, ts, allow, ns, ms, params, score, a, b,
                                 nullptr, edges, flags, cand, ck, B, m_pad, n_pad, c_blk,
                                 threads, wmax, stride, 0, stream);
}

// at_blocked_ckpt_fill's double instance: params, score, ck and edges
// float64.
cudaError_t at_blocked_ckpt_fill64(int mode, int use_jump, const int* qs, const int* ts,
                                   const float* allow, const int* ns, const int* ms,
                                   const double* params, double* score, int* a, int* b,
                                   double* ck, double* edges, int* flags, void* cand, int B,
                                   int m_pad, int n_pad, int c_blk, int threads, int wmax,
                                   int stride, cudaStream_t stream) {
  if (stride <= 0 || stride % 8 != 0 || m_pad % stride != 0 || ck == nullptr)
    return cudaErrorInvalidValue;
  return launch_ptr<CKPT, double>(mode, use_jump, 1, qs, ts, allow, ns, ms, params, score, a, b,
                                  nullptr, edges, flags, cand, ck, B, m_pad, n_pad, c_blk,
                                  threads, wmax, stride, 0, stream);
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
  return launch_ptr<SEED, float>(mode, use_jump, rpb, qs, ts, allow, ns, ms, params, nullptr,
                                 nullptr, nullptr, ptrs, edges, flags, cand,
                                 const_cast<float*>(ck), B, S, n_pad, c_blk, threads, wmax, S, i0,
                                 stream);
}

// at_blocked_refill's double instance: params, ck and edges float64.
cudaError_t at_blocked_refill64(int mode, int use_jump, int rpb, const int* qs, const int* ts,
                                const float* allow, const int* ns, const int* ms,
                                const double* params, const double* ck, int i0, uint8_t* ptrs,
                                double* edges, int* flags, void* cand, int B, int S, int n_pad,
                                int c_blk, int threads, int wmax, cudaStream_t stream) {
  if (i0 < 0 || ck == nullptr) return cudaErrorInvalidValue;
  return launch_ptr<SEED, double>(mode, use_jump, rpb, qs, ts, allow, ns, ms, params, nullptr,
                                  nullptr, nullptr, ptrs, edges, flags, cand,
                                  const_cast<double*>(ck), B, S, n_pad, c_blk, threads, wmax, S,
                                  i0, stream);
}

// The EDGE phase of the score fills (parallel/seqpar.py): rows i0+1 .. i0+R
// of global columns col0+1 .. col0+nloc, qs (B, R), ts and allow (B, nloc),
// `top`/`bottom` the (B, states, nloc) state rows of rows i0 and i0+R (3
// states global, local and fit; 1 overlap and edit), `acc` the (B,) running
// candidate (int32 for edit, else float32), `edges` (B, nblk + 1, 4, R + 1)
// of the value type with the left edge in slot 0 (the right edge comes back
// in slot nblk), `flags` (1 + B * (nblk + 1)) zeroed, `cand` (B, nblk, 4).
cudaError_t at_blocked_edge_scores(int mode, int use_jump, const int* qs, const int* ts,
                                   const float* allow, const int* ns, const int* ms,
                                   const float* params, const void* top, void* bottom, void* acc,
                                   void* edges, int* flags, void* cand, int B, int R, int nloc,
                                   int c_blk, int threads, int wmax, int col0, int i0,
                                   cudaStream_t stream) {
  if (bad_blocks(B, threads, wmax, R, nloc, c_blk) || mode < GLOBAL || mode > EDIT ||
      (use_jump && mode != FIT) || col0 < 0 || col0 % 16 != 0 || i0 < 0 || top == nullptr ||
      bottom == nullptr || acc == nullptr)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int ctas = B * ((nloc + c_blk - 1) / c_blk);
  const size_t S = (size_t)threads * wmax;
  const Chunk ch = {top, bottom, col0, i0, nullptr, 0};
  float* f_acc = static_cast<float*>(acc);
  float* f_edges = static_cast<float*>(edges);
  int4* cd = static_cast<int4*>(cand);
  if (mode == OVERLAP)
    return launch(bscore_overlap<true>, ctas, threads, S * 12, stream, qs, ts, ns, ms, params,
                  f_acc, f_edges, flags, cd, R, nloc, c_blk, wmax, ch);
  if (mode == EDIT)
    return launch(bscore_edit<int, float, true>, ctas, threads, S * 12, stream, qs, ts, ns, ms,
                  params, static_cast<int*>(acc), static_cast<int*>(edges), flags, cd, R, nloc,
                  c_blk, wmax, ch);
  const size_t smem = S * (use_jump ? 20 : 16);
  auto go = [&](auto kernel) {
    return launch(kernel, ctas, threads, smem, stream, qs, ts, allow, ns, ms, params, f_acc,
                  f_edges, flags, cd, R, nloc, c_blk, wmax, ch);
  };
  if (mode == GLOBAL) return go(bscore_affine<GLOBAL, false, true>);
  if (mode == LOCAL) return go(bscore_affine<LOCAL, false, true>);
  if (use_jump) return go(bscore_affine<FIT, true, true>);
  return go(bscore_affine<FIT, false, true>);
}

// The EDGE phase of the pointer fills: as at_blocked_edge_scores, with rpb
// rows per byte (R and i0 multiples of 8 * rpb), `top`/`bottom` (B,
// states, nloc) float32 (3 states global and local, 4 fit, 1 overlap), the
// pointer bytes into rows i0/rpb .. (i0+R)/rpb of `slab` (B, slab_rows,
// nloc), and `acc` the (B, 4) int32 running start candidate (score bits, a,
// b, 0): global's where the slice holds (m, n), local's strict running
// row-major maximum, fit's and overlap's (raw) row m.
cudaError_t at_blocked_edge_ptr(int mode, int use_jump, int rpb, const int* qs, const int* ts,
                                const float* allow, const int* ns, const int* ms,
                                const float* params, const float* top, float* bottom, void* acc,
                                uint8_t* slab, int slab_rows, float* edges, int* flags,
                                void* cand, int B, int R, int nloc, int c_blk, int threads,
                                int wmax, int col0, int i0, cudaStream_t stream) {
  const Chunk ch = {top, bottom, col0, i0, static_cast<int4*>(acc), slab_rows};
  return launch_edge_ptr(mode, use_jump, rpb, qs, ts, allow, ns, ms, params, slab, edges, flags,
                         cand, B, R, nloc, c_blk, threads, wmax, ch, stream);
}

}  // extern "C"
