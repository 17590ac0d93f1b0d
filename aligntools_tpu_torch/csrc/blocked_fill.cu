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
// Design. The grid holds one CTA for each (pair, column block); thread t
// owns the block-local columns [t*W, (t+1)*W). Every fill runs the flat
// fills' register-strip row (strip_row.cuh: AffineRow, OverlapRow, EditRow,
// one body with ptr_fill.cu's; its header) over the block's columns, W 16
// (8 for double) and the fewest warps that cover c_blk (the pointer fills
// ops/ptr.launch_shape applied to c_blk, the score fills ops/scan.flat_shape:
// 128 threads at 2,048, 512 at 8,192). The row state lives in registers for
// the whole fill: the chars, M and L of the previous row, D = max(L, M, U[,
// J]) with its earliest-argument argmax, U's term offsets and fit's jump
// gate. Per row: pass 1 (M, L, their bits, the strip's chain terms), a warp
// scan with shuffles, the row's one __syncthreads(), the scan of the warps'
// aggregates, pass 2 (U, J, their bits, D); every shared slot is
// double-buffered by row parity. The block's left edge (EdgeLeft,
// SlopeLeft) stands where the flat fill has column 0's border: row i-1's
// edge gives thread 0's diagonal D(i-1, col0), row i's the chains' seeds
// before warp 0. Threads past the block's width (a ragged last block, a
// small c_blk) compute on pad and store nothing. The score fills are the
// pointer kernels' SCORE phase (and edit's bscore_edit): no pointer bits,
// rows up to m, the score latched per thread and reduced once.
//
// Between blocks the only state is each row's values at a block's last
// column: M, L, U, J (the score fills keep max(L, M, U, J) in place of L,
// which is all the next block's diagonal reads; overlap and edit M). Block c
// writes row i's edge to its own (pair, block) slice of a wrapper-allocated
// device buffer, and
// the thread that owns its last column then stores i to the block's progress
// counter with release semantics (st.release.gpu). Row i of block c+1 reads
// rows i-1 (the diagonal shift-in) and i (the chains' seeds) of that edge:
// after its first pass over row i, its thread 0 waits with acquire loads
// until block c's counter reaches i (it keeps the count it saw and polls
// again only when i passes it), reads the edge through L2 (__ldcg: another
// SM wrote it) and leaves the chains' seeds in a parity slot, which the
// other threads read behind the row's one barrier. So block c+1 runs about a row behind
// block c, and all the blocks of a pair fill at once. Column-0 borders apply
// in block 0 only; the row-0 edge is analytic in every block; every in-row
// chain continues across blocks by its global column index (U's seed
// U(i, col0) - e*col0, overlap's M(i, col0) - o*col0, edit's
// M(i, col0) - col0, fit's J carried flat). Thread 0 polls once it has
// finished its own pass 1, so the row keeps one barrier; the thread that
// owns the block's last column, (bw - 1) / W, stores row i's edge states to
// the block's edge slice and then the count.
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
// Every fill latches start info per thread in registers and reduces it
// once after the last row into the block's candidate. Pointer bytes are
// packed in registers across rpb rows (row rpb*k in the low bits) and each
// thread stores its strip as one 16-byte word (8 bytes at double's W 8);
// every offset into the pointer tensor is 64-bit (a long-target bucket's
// tensor passes 2^31 bytes). The pointer fills take an n_pad that c_blk
// does not divide (flat buckets past ops/ptr.FLAT_REG_MAX_N_PAD): the last
// block is n_pad - col0 columns wide (a multiple of 16, so a strip lies
// wholly inside it or past it). So do the score fills (flat buckets past
// ops/scan.flat_cap).
//
// What bounds it on this card: the per-row chain, as in the flat fills: a
// barrier, the warps' scans and W serial cells a thread in each pass;
// across blocks, one release store a row in the publishing block
// and an acquire poll a row in the next, which sit on that chain. The
// pointer bytes (m_pad*n_pad/rpb a pair) are far below HBM's rate. The grid
// is B x ceil(n_pad/c_blk) CTAs (a long-target bucket of ~10 pairs at c_blk
// 2,048: 240-640), in flight as far as registers allow (a thread takes up
// to 128: four CTAs of 128 threads an SM at 2,048) and, in a pair, by the
// wavefront's
// fill and drain: its last block starts its first row n_pad/c_blk - 1 rows
// after block 0.
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
// the value type T = double: params, row state, block edges and
// checkpoints in double, exact integers below 2^53 with true -inf borders;
// a block candidate's double rides its int4 slot as two words (x and w).
// Each edge is a plain 8-byte store before the owner's st.release.gpu of
// the row count, and its reader's ld.acquire.gpu comes before its __ldcg,
// so the 8-byte values are ordered as the 4-byte ones are. The double
// fills run strips of W 8 (a double takes two registers), so the double
// column block is at most 512 x 8 = 4,096 (ops/blocked.C_BLK_MAX64).

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "strip_row.cuh"

namespace {

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
    // kept as made here: left to the compiler, the hand-off's addresses
    // were remade from b, c and rows on each row's publish and poll, on the
    // wavefront's chain (RSF's overlap checkpoint forward 10% slower)
    asm volatile("" : "+l"(en), "+l"(ep), "+l"(prog), "+l"(cand), "+l"(done));
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

// Edge states, by slot: the pointer phases' M, L, U, J (also the state rows
// of a checkpoint, in this order: engine/scan.py's carry layout); the score
// phases' max(L, M, U[, J]), M, U, J (max(L, M, U, J) is all the next
// block's diagonal reads).
constexpr int PM = 0, PL = 1, PU = 2, PJ = 3;
constexpr int SD = 0, SM = 1, SU = 2, SJ = 3;

// The phases of the blocked fills: the pointer fill of the whole matrix; the
// checkpoint forward; the seeded refill of one row block; one chunk of one
// rank's column slice (Chunk: top and bottom M, L, U[, J] of TOP_STATES, the
// pointer bytes into rows i0/rpb .. of the rank's slab, the start candidate
// merged into Chunk::acc); the score fill (no pointers, rows up to m, blocks
// past n exit at once); and its chunk (top and bottom M, L, max(L, M, U[,
// J]), the running candidate raised in `out`).
constexpr int FILL = 0, CKPT = 1, SEED = 2, EDGE = 3, SCORE = 4, SEDGE = 5;

// The EDGE phases (parallel/seqpar.py: one rank's column slice, one chunk of
// rows a launch). The launch fills rows i0+1 .. i0+R (qs (B, R)) of global
// columns col0g+1 .. col0g+nloc (ts, allow (B, nloc); here m_pad is R and
// n_pad nloc) in column blocks, every row and column, pad ones included:
// row i0 comes from the state buffer `top` (B, states, nloc), row i0+R goes
// to `bottom`; block 0 reads the launch's left edge (the states at column
// col0g of rows i0 .. i0+R, slot 0 of the edges) and the last block writes
// the right edge (slot nblk); every chain continues by global column, and
// the column-0 border and row 0 are the caller's (in `top` and the left
// edge). Each block's candidate is its cells' over rows <= m and columns <=
// n (global); the pair's last block to finish merges them into the running
// candidate; the caller merges the ranks and finishes (local's + 0,
// overlap's j = 0 candidate).
struct Chunk {
  const void* top;
  void* bottom;
  int col0g, i0;
  int4* acc;      // the pointer fills' running start candidate (B,)
  int slab_rows;  // the pointer fills' slab: (B, slab_rows, nloc) bytes
};

// The blocked fills' Left for the affine row: the block's left edge, column
// col0 (strip_row.cuh's Left). Row i's states there: column 0's border in
// block 0 (at the global row r0 + i), row 0's analytic value past it (READ0:
// the checkpoint's or `top`'s, state0), else block c-1's edge (CH: every row
// from the edges, block 0's from the launch's left edge), for which thread 0
// waits. SC: the score phases' edge layout (and D(0, 0) = 0), else the
// pointer phases'. Thread 0 leaves the chains' seeds before warp 0 in a
// parity slot: U's U(i, col0) - e*col0 and M(i, col0)'s term; J(i, col0) and
// its entry from M(i, col0).
template <int MODE, bool JUMP, class T, bool SC, bool CH, bool READ0, class F>
struct EdgeLeft {
  static constexpr int NC = JUMP ? 2 : 1;
  static constexpr T NG = (T)NEG;
  Wave<T>& w;
  F state0;
  T o, e, jp;
  int c, col0, r0;

  // row i's M, U, J and D (D's argmax in ea) at column col0
  __device__ __forceinline__ void states(int i, T& em, T& eu, T& ej, T& ed, int& ea) const {
    T el;
    ea = 0;
    if (READ0 && i == 0 && c > 0) {
      state0(col0, em, el, eu, ej);
      if (SC) {  // a score chunk's state rows hand D in U's place
        ed = eu;
        return;
      }
    } else if (CH || (c > 0 && i > 0)) {
      if (SC) {
        ed = w.edge(SD, i);
        em = w.edge(SM, i);
        eu = w.edge(SU, i);
        ej = JUMP ? w.edge(SJ, i) : NG;
        return;
      }
      em = w.edge(PM, i);
      el = w.edge(PL, i);
      eu = w.edge(PU, i);
      ej = JUMP ? w.edge(PJ, i) : NG;
    } else if (c == 0) {
      border0<MODE, T>(r0 + i, o, e, em, el, eu, ej);
    } else {
      row0<MODE, T>(col0, o, e, em, el, eu, ej);
    }
    ed = lmuj_max<JUMP, T>(el, em, eu, ej, ea);
    // the score fills' border at (0, 0) is 0 whatever the sign of o
    if (SC && !CH && MODE == GLOBAL && c == 0 && i == 0) ed = (T)0;
  }
  template <class R>
  __device__ __forceinline__ void init(R& r) const {
    if (threadIdx.x == 0) {
      T em, eu, ej;
      states(0, em, eu, ej, r.eD, r.eA);
    }
  }
  template <class R>
  __device__ __forceinline__ void begin(R&, int) const {}
  template <class R, class S>
  __device__ __forceinline__ void poll(R& r, int i, int p, S& sh) {
    if (c > 0) w.wait(i);
    T em, eu, ej;
    states(i, em, eu, ej, r.eD, r.eA);
    sh.seed[p][0] = vmax(eu - e * (T)col0, em + (o - e * (T)(col0 + 1)));
    if (JUMP) sh.seed[p][NC - 1] = vmax(ej, r.gate0 ? em + jp : NG);
    r.mb = em;
  }
  template <class S>
  __device__ __forceinline__ T useed(const S& sh, int p) const {
    return sh.seed[p][0];
  }
  template <class S>
  __device__ __forceinline__ T jseed(const S& sh, int p) const {
    return sh.seed[p][NC - 1];
  }
};

template <int MODE, bool JUMP, class T, bool SC, bool CH, bool READ0, class F>
__device__ __forceinline__ EdgeLeft<MODE, JUMP, T, SC, CH, READ0, F> edge_left(
    Wave<T>& w, F state0, T o, T e, T jp, int c, int col0, int r0) {
  return {w, state0, o, e, jp, c, col0, r0};
}

// The blocked fills' Sink for the affine row: the owner of the block's last
// column stores row i's edge (SC: D, M, U[, J]; else M, L, U[, J]) and
// publishes the count; CKPT's every stride-th row and EDGE's last go out as
// state rows (M, L, U[, J]) of ST, their address made once a row (a store
// behind the W columns' own address arithmetic is not predicated but
// branched around, W branches on the row's chain) and CKPT's next row
// counted, not divided for; global's D(m, n) goes to s_glob.
template <int MODE, bool JUMP, int PHASE, int W, class T>
struct EdgeSink {
  static constexpr int ST = MODE == FIT ? 4 : 3;
  static constexpr bool ROWS = PHASE == CKPT || PHASE == EDGE;
  Wave<T>& w;
  bool feeds, owner;
  int m_pad, stride, c;
  // CKPT: the pair's checkpoint next / stride; EDGE: `bot` (columns by
  // global j)
  T* rows;
  int pitch;  // between two state rows
  int4* glob;
  T o, e;
  int next;  // CKPT: the next checkpoint's row
  bool at;   // this row goes out
  bool put;  // ... from this thread, at dst (this strip's first column)
  T* dst;

  template <class R>
  __device__ __forceinline__ void row_begin(R& r, int i) {
    if (!ROWS) return;
    at = PHASE == CKPT ? i == next && i < m_pad : i == m_pad;
    put = r.active && at;
    dst = rows + r.j0;
  }
  template <class R>
  __device__ __forceinline__ void cell(R& r, int i, int k, T uv, T jv) const {
    if (ROWS && put) {
      dst[(size_t)PM * pitch + k] = r.M[k];
      dst[(size_t)PL * pitch + k] = r.L[k];
      dst[(size_t)PU * pitch + k] = uv;
      if (ST > 3) dst[(size_t)PJ * pitch + k] = jv;
    }
    if (k == W - 1 && feeds && owner) {
      if (PHASE == SCORE || PHASE == SEDGE) {
        w.put(SD, i, r.D[k]);
        w.put(SM, i, r.M[k]);
        w.put(SU, i, uv);
        if (JUMP) w.put(SJ, i, jv);
      } else {
        w.put(PM, i, r.M[k]);
        w.put(PL, i, r.L[k]);
        w.put(PU, i, uv);
        if (JUMP) w.put(PJ, i, jv);
      }
      w.publish(i);
    }
  }
  // CKPT: column 0's states of a checkpoint row; the next checkpoint
  template <class R>
  __device__ __forceinline__ void row_end(R&, int i) {
    if (PHASE != CKPT || i != next) return;
    if (at && c == 0 && threadIdx.x == 0) {
      T st[4];
      border0<MODE, T>(i, o, e, st[PM], st[PL], st[PU], st[PJ]);
      for (int s = 0; s < ST; ++s) rows[(size_t)s * pitch] = st[s];
    }
    next += stride;
    rows += (size_t)ST * pitch;
  }
  __device__ __forceinline__ void global(T d, int a) const { *glob = pack(d, a); }
};

// Replaces the global / local / fit(+jump) branches of _blocked_ptr_kernel
// and _blocked_affine_kernel: the affine row (strip_row.cuh, JUMP: fit's J
// state) over the block's columns, the block's left edge on the left
// (EdgeLeft), its right edge out (EdgeSink). PHASE: FILL; CKPT (no pointers;
// the state rows of every stride-th row into `ck`, (B, m_pad/S, states,
// n_pad+1)); SEED (rows i0+1 .. i0+m_pad from `ck`, (B, states, n_pad+1); no
// start info); EDGE (Chunk); SCORE (no pointers, rows up to m, blocks past n
// exit, `score_out` the scores: local's maximum, fit's max(M, L) on row m
// over columns <= n-1, global's D(m, n)); SEDGE (SCORE's chunk, `score_out`
// the running candidate).
template <int MODE, bool JUMP, int PHASE, int W, class T>
__global__ void __launch_bounds__(kMaxThreads)
bptr_affine(const int* __restrict__ qs, const int* __restrict__ ts,
            const float* __restrict__ allow, const int* __restrict__ ns,
            const int* __restrict__ ms, const T* __restrict__ params,
            T* __restrict__ score_out, int* __restrict__ a_out, int* __restrict__ b_out,
            uint8_t* __restrict__ ptrs, T* edges, int* flags, int4* cand, T* ck,
            int m_pad, int n_pad, int c_blk, int rpb, int stride, int i0, Chunk ch) {
  constexpr bool SC = PHASE == SCORE || PHASE == SEDGE, CH = PHASE == EDGE || PHASE == SEDGE;
  constexpr bool PTRS = PHASE == FILL || PHASE == SEED || PHASE == EDGE;
  constexpr int LATCH = PHASE == SEED ? LATCH_NONE : SC ? LATCH_SCORE : LATCH_PTR;
  constexpr T NG = (T)NEG;
  // a checkpoint's state rows: M, L, U, and fit's J (-inf without the jump);
  // a chunk's: those, or the score phases' M, L, max(L, M, U[, J])
  constexpr int ST = MODE == FIT ? 4 : 3, NT = SC ? 3 : ST;
  using Row = AffineRow<MODE, JUMP, W, T, PTRS, LATCH>;
  __shared__ typename Row::Smem sh;
  __shared__ Cand<T> s_red[2][32];
  __shared__ T s_max[32];
  __shared__ int4 s_glob;  // global's candidate: D(m, n) and its argmax
  __shared__ int ticket;
  const int nblk = (n_pad + c_blk - 1) / c_blk;
  if (threadIdx.x == 0) s_glob = pack(NG);
  Wave<T> w(take_ticket(flags, &ticket), nblk, flags, edges, cand, m_pad, CH);
  const int b = w.b, c = w.c, tid = threadIdx.x;
  const int n = CH ? max(ns[b], 0) : min(max(ns[b], 0), n_pad);
  const int m = CH ? max(ms[b], 0) : min(max(ms[b], 0), m_pad);
  // the blocks a score fill runs: those that hold columns <= n (a chunk's
  // every block); every later block of the pair is past n too, so none
  // waits on one that exits. A pointer fill writes every byte.
  const int nb = PHASE == SCORE ? max(1, (n + c_blk - 1) / c_blk) : nblk;
  if (c >= nb) return;
  const T o = params[2], e = params[3];
  // EDGE: global columns col0g+1 .., local index j - 1 - col0g of ts,
  // allow and the state rows; the launch's rows are global i0+1 ..
  const int col0g = CH ? ch.col0g : 0, gi0 = CH ? i0 : 0;
  const int r0 = PHASE == SEED ? i0 : 0;  // the global row of row 0 (SEED)
  // the block's columns: c_blk, or fewer in a ragged last block (lc0 its
  // first in the row's memory); this thread's strip, global columns j0 ..
  // j0+W-1, lies wholly inside them (bw and c_blk are multiples of 16) or
  // past them
  const int lc0 = c * c_blk, col0 = col0g + lc0, bw = min(c_blk, n_pad - lc0);
  const int j0 = col0 + 1 + tid * W;
  Row r(params, j0, tid * W < bw, m, n, rpb);
  r.load(ts + (size_t)b * n_pad + lc0 + (size_t)tid * W,
         JUMP ? allow + (size_t)b * n_pad - col0g : nullptr, col0g + n_pad);
  // the checkpoint's state rows: CKPT, of each pair and S-th row; SEED, the
  // one row this block starts from (64-bit offsets: the tensor passes 2^31)
  const size_t ck_row = (size_t)n_pad + 1;
  const int nck = PHASE == CKPT ? m_pad / stride : 1;
  const T* seed = PHASE == SEED ? ck + (size_t)b * ST * ck_row : nullptr;
  const T* top = CH ? static_cast<const T*>(ch.top) + (size_t)b * NT * n_pad - col0g - 1 : nullptr;
  T* bot = CH ? static_cast<T*>(ch.bottom) + (size_t)b * NT * n_pad - col0g - 1 : nullptr;
  // row 0's states M, L, U, J at column j > col0: the analytic row 0;
  // SEED: the checkpoint's row; EDGE: `top`; SEDGE: `top`'s M, L, and D in
  // U's place
  auto state0 = [&](int j, T& mm, T& ll, T& uu, T& jj) {
    if (PHASE == SEED || (CH && !SC)) {
      const T* x = PHASE == SEED ? seed + j : top + j;
      const size_t rs = PHASE == SEED ? ck_row : (size_t)n_pad;
      mm = x[PM * rs];
      ll = x[PL * rs];
      uu = x[PU * rs];
      jj = JUMP ? x[PJ * rs] : NG;
    } else if (CH) {
      mm = top[j];
      ll = top[n_pad + j];
      uu = top[2 * n_pad + j];
      jj = NG;
    } else {
      row0<MODE, T>(j, o, e, mm, ll, uu, jj);
    }
  };
  r.template init<PHASE == SEDGE>(state0);
  if (PHASE == CKPT) {  // checkpoint 0, and column 0's border in block 0
    T* dst = ck + (size_t)b * nck * ST * ck_row;
    if (r.active)
#pragma unroll
      for (int k = 0; k < W; ++k) {
        T st[4];
        state0(j0 + k, st[PM], st[PL], st[PU], st[PJ]);
        for (int s = 0; s < ST; ++s) dst[s * ck_row + j0 + k] = st[s];
      }
    if (c == 0 && tid == 0) {
      T st[4];
      border0<MODE, T>(0, o, e, st[PM], st[PL], st[PU], st[PJ]);
      for (int s = 0; s < ST; ++s) dst[s * ck_row] = st[s];
    }
  }
  auto left = edge_left<MODE, JUMP, T, SC, CH, PHASE == SEED || CH>(w, state0, o, e, params[4],
                                                                     c, col0, r0);
  left.init(r);
  EdgeSink<MODE, JUMP, PHASE, W, T> sink{
      w, c + 1 < nb || CH, tid == (bw - 1) / W, m_pad, stride, c,
      PHASE == CKPT ? ck + ((size_t)b * nck + 1) * ST * ck_row : bot,  // CKPT: checkpoint 1
      PHASE == CKPT ? n_pad + 1 : n_pad, &s_glob, o, e, stride, false, false, nullptr};
  if (PTRS) {  // this strip's bytes of pointer row 0 (64-bit offsets)
    r.out = (CH ? ptrs + ((size_t)b * ch.slab_rows + i0 / rpb) * n_pad
                : ptrs + (size_t)b * (m_pad / rpb) * n_pad) + lc0 + (size_t)tid * W;
    r.pitch = n_pad;
  }
  // every row; the score fill stops at m
  const int rows = PHASE == SCORE ? m : m_pad;
  const int* q = qs + (size_t)b * m_pad;
  int qn = rows > 0 ? q[0] : 0;
  for (int i = 1; i <= rows; ++i) {
    const int qc = qn;
    if (i < rows) qn = q[i];
    r.row(i, gi0 + i, qc, sh, left, sink);
  }
  if (PHASE == SEDGE && r.active)  // row i0+R's M, L and D
#pragma unroll
    for (int k = 0; k < W; ++k) {
      bot[j0 + k] = r.M[k];
      bot[n_pad + j0 + k] = r.L[k];
      bot[2 * n_pad + j0 + k] = r.D[k];
    }
  if (PHASE == SEED) return;
  // this block's candidate, reduced once: global's (m, n) where it holds
  // column n; local's strict running row-major maximum (SC: the maximum);
  // fit's bottom row (L wins only when strictly greater; SC: max(M, L))
  int4 mine;
  if (MODE == GLOBAL) {
    __syncthreads();
    mine = s_glob;
  } else if (SC) {
    mine = pack(block_max(r.lat.v, s_max));
  } else if (MODE == LOCAL) {
    const Cand<T> x = block_best(r.lat, s_red[0]);
    mine = pack(x.v, x.i, x.j);
  } else {
    const Cand<T> rm = block_best(r.cm, s_red[0]), rl = block_best(r.cl, s_red[1]);
    const bool use_l = rl.v > rm.v;
    mine = gi0 < m && m <= gi0 + m_pad ? pack(vmax(rm.v, rl.v), use_l ? 1 : 0, use_l ? rl.j : rm.j)
                                       : pack(NG);
  }
  if (SC) {
    // the score fills take the maximum of the blocks' values (SEDGE: and of
    // the running candidate); + 0 turns local's -0 into +0: the score is
    // printed with %f
    if (tid == 0 && w.finish(mine, nb)) {
      T v = CH ? score_out[b] : NG;
      for (int k = 0; k < nb; ++k) v = vmax(v, unpack<T>(w.candidate(k)));
      score_out[b] = MODE == LOCAL && !CH ? v + (T)0 : v;
    }
    return;
  }
  if (CH) {
    if (tid == 0 && w.finish(mine, nblk)) {
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
  if (tid == 0 && w.finish(mine, nblk)) {
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

// The blocked fills' Left for the overlap and edit rows: thread 0 leaves
// the chain's seed before warp 0, the left edge's M(i, col0) less its
// column's slope (o*col0; col0 for edit), waiting for block c-1's edge.
template <class T, class F>
struct SlopeLeft {
  Wave<T>& w;
  F edge_at;  // M(i, col0)
  T slope;
  int c;
  template <class S>
  __device__ __forceinline__ void poll(int i, int p, S& sh) {
    if (c > 0) w.wait(i);
    sh.seed[p] = edge_at(i) - slope;
  }
  template <class S>
  __device__ __forceinline__ T seed(const S& sh, int p, int = 0) const {
    return sh.seed[p];
  }
};

template <class T, class F>
__device__ __forceinline__ SlopeLeft<T, F> slope_left(Wave<T>& w, F edge_at, T slope, int c) {
  return {w, edge_at, slope, c};
}

// The blocked fills' Sink for the overlap row: the owner of the block's
// last column stores row i's M and publishes the count; CKPT's every
// stride-th row goes out as a checkpoint (M(i, 0) = 0 in block 0), the next
// one counted, not divided for.
template <int PHASE, int W, class T>
struct OverlapSink {
  Wave<T>& w;
  bool feeds, owner;
  int m_pad, stride, c;
  T* ck;  // the pair's checkpoint `next / stride`
  size_t ck_row;
  int next;  // CKPT: the next checkpoint's row
  template <class R>
  __device__ __forceinline__ void row_end(R& r, int i) {
    if (feeds && owner) {
      w.put(0, i, r.M[W - 1]);
      w.publish(i);
    }
    if (PHASE == CKPT && i == next) {
      if (i < m_pad) {
        if (r.active)
#pragma unroll
          for (int k = 0; k < W; ++k) ck[r.j0 + k] = r.M[k];
        if (c == 0 && threadIdx.x == 0) ck[0] = (T)0;
      }
      next += stride;
      ck += ck_row;
    }
  }
};

// Replaces the overlap branches of _blocked_ptr_kernel and
// _blocked_affine_kernel: the overlap row (strip_row.cuh) over the block's
// columns, seeded before warp 0 by the block's left edge M(i, col0) -
// o*col0. PHASE as in bptr_affine, with M the one state row; SCORE's rows
// stop at m, so its score is read from row m's registers after the last row
// (max(row m's maximum over columns <= n-1, 0) + 0, 0 at m = 0); SEDGE
// latches row m's maximum (raw: the j = 0 candidate is the caller's). The
// arguments are bptr_affine's (allow unread), so that one launch serves both.
template <int PHASE, int W, class T>
__global__ void __launch_bounds__(kMaxThreads)
bptr_overlap(const int* __restrict__ qs, const int* __restrict__ ts,
             const float* __restrict__ allow, const int* __restrict__ ns,
             const int* __restrict__ ms, const T* __restrict__ params,
             T* __restrict__ score_out, int* __restrict__ a_out, int* __restrict__ b_out,
             uint8_t* __restrict__ ptrs, T* edges, int* flags, int4* cand, T* ck, int m_pad,
             int n_pad, int c_blk, int rpb, int stride, int i0, Chunk ch) {
  constexpr bool SC = PHASE == SCORE || PHASE == SEDGE, CH = PHASE == EDGE || PHASE == SEDGE;
  constexpr bool PTRS = PHASE == FILL || PHASE == SEED || PHASE == EDGE;
  constexpr int LATCH = PHASE == SEED || PHASE == SCORE ? LATCH_NONE
                        : PHASE == SEDGE               ? LATCH_SCORE
                                                       : LATCH_PTR;
  constexpr T NG = (T)NEG;
  using Row = OverlapRow<W, T, PTRS, LATCH>;
  __shared__ typename Row::Smem sh;
  __shared__ Cand<T> s_red[32];
  __shared__ T s_max[32];
  __shared__ int ticket;
  const int nblk = (n_pad + c_blk - 1) / c_blk;
  Wave<T> w(take_ticket(flags, &ticket), nblk, flags, edges, cand, m_pad, CH);
  const int b = w.b, c = w.c, tid = threadIdx.x;
  const int n = CH ? max(ns[b], 0) : min(max(ns[b], 0), n_pad);
  const int m = CH ? max(ms[b], 0) : min(max(ms[b], 0), m_pad);
  const int nb = PHASE == SCORE ? max(1, (n + c_blk - 1) / c_blk) : nblk;
  if (c >= nb) return;
  const T o = params[2];
  const int col0g = CH ? ch.col0g : 0, gi0 = CH ? i0 : 0;
  const int lc0 = c * c_blk, col0 = col0g + lc0, bw = min(c_blk, n_pad - lc0);
  const int j0 = col0 + 1 + tid * W;
  Row r(params, j0, tid * W < bw, m, n, rpb);
  const size_t ck_row = (size_t)n_pad + 1;
  const int nck = PHASE == CKPT ? m_pad / stride : 1;
  const T* seed = PHASE == SEED ? ck + (size_t)b * ck_row : nullptr;
  const T* top = CH ? static_cast<const T*>(ch.top) + (size_t)b * n_pad - col0g - 1 : nullptr;
  // row 0's M at column j > col0: -inf past column 0; SEED the checkpoint's,
  // EDGE `top`'s
  auto state0 = [&](int j) -> T { return PHASE == SEED ? seed[j] : CH ? top[j] : NG; };
  // M(i, col0): the column-0 border is 0; row 0 is -inf past column 0
  // (SEED and EDGE past block 0: the checkpoint's or `top`'s; EDGE's block
  // 0: the left edge, slot 0), else the previous block's edge
  auto edge_at = [&](int i) -> T {
    if (i == 0 && c > 0 && (PHASE == SEED || CH)) return state0(col0);
    return CH || c > 0 ? (!CH && i == 0 ? NG : w.edge(0, i)) : (T)0;
  };
  r.init(ts + (size_t)b * n_pad + lc0 + (size_t)tid * W, state0, tid == 0 ? edge_at(0) : NG);
  T* cks = PHASE == CKPT ? ck + (size_t)b * nck * ck_row : nullptr;
  if (PHASE == CKPT) {  // checkpoint 0; M(0, 0) = 0
    if (r.active)
#pragma unroll
      for (int k = 0; k < W; ++k) cks[j0 + k] = r.M[k];
    if (c == 0 && tid == 0) cks[0] = (T)0;
  }
  auto left = slope_left(w, edge_at, o * (T)col0, c);
  OverlapSink<PHASE, W, T> sink{
      w, c + 1 < nb || CH, tid == (bw - 1) / W, m_pad, stride, c,
      PHASE == CKPT ? cks + ck_row : nullptr,  // CKPT: checkpoint 1
      ck_row, stride};
  if (PTRS) {
    r.out = (CH ? ptrs + ((size_t)b * ch.slab_rows + i0 / rpb) * n_pad
                : ptrs + (size_t)b * (m_pad / rpb) * n_pad) + lc0 + (size_t)tid * W;
    r.pitch = n_pad;
  }
  const int rows = PHASE == SCORE ? m : m_pad;
  const int* q = qs + (size_t)b * m_pad;
  int qn = rows > 0 ? q[0] : 0;
  for (int i = 1; i <= rows; ++i) {
    const int qc = qn;
    if (i < rows) qn = q[i];
    r.row(i, gi0 + i, qc, sh, left, sink);
  }
  if (CH && r.active) {
    T* bot = static_cast<T*>(ch.bottom) + (size_t)b * n_pad - col0g - 1;
#pragma unroll
    for (int k = 0; k < W; ++k) bot[j0 + k] = r.M[k];
  }
  if (PHASE == SEED) return;
  if (SC) {
    T v = r.best.v;
    if (PHASE == SCORE) {
      // the rows stopped at m, so M holds row m (row 0's -inf at m = 0);
      // n is read again here, so that no value of the score stays live
      // across the rows
      const int kn = r.active ? min(max(ns[b], 0), n_pad) - j0 : 0;
#pragma unroll
      for (int k = 0; k < W; ++k)
        if (k < kn) v = vmax(v, r.M[k]);
    }
    v = block_max(v, s_max);
    if (tid == 0 && w.finish(pack(v), nb)) {
      v = CH ? score_out[b] : NG;
      for (int k = 0; k < nb; ++k) v = vmax(v, unpack<T>(w.candidate(k)));
      // the j = 0 border contributes its 0 (SEDGE: the caller's); + 0 turns
      // a -0 into +0
      score_out[b] = CH ? v : vmax(v, (T)0) + (T)0;
    }
    return;
  }
  const bool holds_m = gi0 < m && m <= gi0 + m_pad;
  const Cand<T> x = block_best(r.best, s_red);
  const int4 mine = holds_m ? pack(x.v, x.j) : pack(NG);
  if (CH) {  // row m's first greatest, raw (the j = 0 candidate is the caller's)
    if (tid == 0 && w.finish(mine, nblk) && holds_m) {
      int4 acc = w.candidate(0);
      for (int k = 1; k < nblk; ++k) {
        const int4 y = w.candidate(k);
        if (unpack<T>(y) > unpack<T>(acc)) acc = y;
      }
      ch.acc[b] = acc;
    }
    return;
  }
  if (tid == 0 && w.finish(mine, nblk)) {
    T acc_s = NG;
    int acc_a = 0;
    for (int k = 0; k < (m > 0 ? nblk : 0); ++k) {
      const int4 y = w.candidate(k);
      const T mx = unpack<T>(y);
      if (k == 0) {  // block 0 also holds the j = 0 zero candidate, which wins ties
        acc_s = vmax(mx, (T)0);
        acc_a = mx > (T)0 ? y.y : 0;
      } else if (mx > acc_s) {
        acc_s = mx;
        acc_a = y.y;
      }
    }
    score_out[b] = acc_s;
    a_out[b] = acc_a;
    b_out[b] = 0;
  }
}

// Replaces the edit branch of _blocked_affine_kernel (min-plus, indel 1,
// substitution cost params[1]): the edit row (strip_row.cuh) over the
// block's columns, seeded before warp 0 by the left edge's M(i, col0) -
// col0, in int32 at W 16; the edges are int32. T double (P double: the
// params row in double, W 8) is the instance for a pair past float32's
// exact range: +inf in place of INT_MAX, double edges, at most kMaxThreads
// (its row takes more than the 64 registers of 1,024 threads; C_BLK_MAX64
// needs 512). The rows stop at m
// and the block that holds column n latches M(m, n) (CH: every row, the
// latch at row m; top and bottom M); the blocks' values merge by their
// minimum.
template <class T, class P, bool CH>
__global__ void __launch_bounds__(sizeof(T) == 8 ? kMaxThreads : kEditMaxThreads)
bscore_edit(const int* __restrict__ qs, const int* __restrict__ ts,
            const int* __restrict__ ns, const int* __restrict__ ms,
            const P* __restrict__ params, T* __restrict__ out, T* edges, int* flags,
            int4* cand, int m_pad, int n_pad, int c_blk, Chunk ch) {
  constexpr int W = sizeof(T) == 8 ? kWidth64 : kWidth;
  __shared__ typename EditRow<W, T>::Smem sh;
  __shared__ int4 s_glob;  // M(m, n), from the thread that holds column n
  __shared__ int ticket;
  const int nblk = (n_pad + c_blk - 1) / c_blk;
  if (threadIdx.x == 0) s_glob = pack(vtop<T>());
  Wave<T> w(take_ticket(flags, &ticket), nblk, flags, edges, cand, m_pad, CH);
  const int b = w.b, c = w.c, tid = threadIdx.x;
  const int n = CH ? max(ns[b], 0) : min(max(ns[b], 0), n_pad);
  const int m = CH ? max(ms[b], 0) : min(max(ms[b], 0), m_pad);
  const int nb = CH ? nblk : max(1, (n + c_blk - 1) / c_blk);
  if (c >= nb) return;
  const int col0g = CH ? ch.col0g : 0, gi0 = CH ? ch.i0 : 0;
  const int lc0 = c * c_blk, col0 = col0g + lc0, bw = min(c_blk, n_pad - lc0);
  const int j0 = col0 + 1 + tid * W;
  const bool active = tid * W < bw, feeds = CH || c + 1 < nb, owner = tid == (bw - 1) / W;
  const T* top = CH ? static_cast<const T*>(ch.top) + (size_t)b * n_pad - col0g - 1 : nullptr;
  // M(i, col0): M(i, 0) = i, M(0, j) = j; CH: the left edge (block 0) or
  // `top` (row 0), else the previous block's edge
  auto edge_at = [&](int i) -> T {
    if (CH) return i == 0 && c > 0 ? top[col0] : w.edge(0, i);
    return c == 0 ? (T)i : i == 0 ? (T)col0 : w.edge(0, i);
  };
  EditRow<W, T> r(params, j0);
  r.init(ts + (size_t)b * n_pad + lc0 + (size_t)tid * W, active,
         [&](int j) { return CH ? (active ? top[j] : (T)0) : (T)j; },
         tid == 0 ? edge_at(0) : CH ? (active ? top[j0 - 1] : (T)0) : (T)(j0 - 1));
  auto left = slope_left(w, edge_at, (T)col0, c);
  const int rows = CH ? m_pad : m;
  const int* q = qs + (size_t)b * m_pad;
  int qn = rows > 0 ? q[0] : 0;
  for (int i = 1; i <= rows; ++i) {
    const int qc = qn;
    if (i < rows) qn = q[i];
    r.row(i, qc, sh, left);
    if (feeds && owner) {
      w.put(0, i, r.M[W - 1]);
      w.publish(i);
    }
    if (CH && gi0 + i == m) {  // M(m, n), picked as below
      const int kn = n - j0 + 1;
      T v = vtop<T>();
#pragma unroll
      for (int k = 0; k < W; ++k)
        if (k < kn) v = r.M[k];
      if (kn >= 1 && kn <= W) s_glob = pack(v);
    }
  }
  if (CH && active) {
    T* bot = static_cast<T*>(ch.bottom) + (size_t)b * n_pad - col0g - 1;
#pragma unroll
    for (int k = 0; k < W; ++k) bot[j0 + k] = r.M[k];
  }
  if (!CH && m > 0) {
    // the rows stopped at m; n is read again here, so that no value of the
    // result stays live across the rows. M(m, n) is the last column k < kn
    // (AffineRow's global latch says why not k == kn - 1)
    const int kn = min(max(ns[b], 0), n_pad) - j0 + 1;
    T v = vtop<T>();
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (k < kn) v = r.M[k];
    if (kn >= 1 && kn <= W) s_glob = pack(v);
  }
  __syncthreads();
  if (tid == 0 && w.finish(s_glob, nb)) {
    T v = CH ? out[b] : vtop<T>();
    for (int k = 0; k < nb; ++k) v = vmin(v, unpack<T>(w.candidate(k)));
    // before any row, the result is M(0, n)'s latch value 0, as in the flat
    // fills; INT_MAX (+inf) when n == 0
    out[b] = (!CH && m == 0 && n > 0) ? (T)0 : v;
  }
}

// The blocked fills' launch shapes: `width` the strip width W of the value
// type (kWidth for float32 and int32, kWidth64 for double), `threads` a
// multiple of 32 up to kMaxThreads (kEditMaxThreads for edit) with threads *
// W >= c_blk; the last column block may be ragged (n_pad % 16 == 0).
bool bad_blocks(int B, int threads, int width, int want, int most, int m_pad, int n_pad,
                int c_blk) {
  return width != want || B < 0 || threads < 32 || threads > most || threads % 32 != 0 ||
         m_pad <= 0 || c_blk <= 0 || c_blk % 16 != 0 || n_pad <= 0 || n_pad % 16 != 0 ||
         (long long)threads * width < c_blk ||
         (long long)B * ((n_pad + c_blk - 1) / c_blk) > INT_MAX;
}

// One fill of `PHASE` in value type T (EDGE, SEDGE: float32, with the
// chunk's rows as m_pad and the slice's columns as n_pad): the checks of the
// layout, then the mode's instance, one CTA per (pair, column block) and no
// dynamic shared memory; returns the launch's error code.
template <int PHASE, class T>
cudaError_t launch_fill(int mode, int use_jump, int rpb, const int* qs, const int* ts,
                        const float* allow, const int* ns, const int* ms, const T* params,
                        T* score, int* a, int* b, uint8_t* ptrs, T* edges, int* flags, void* cand,
                        T* ck, int B, int m_pad, int n_pad, int c_blk, int threads, int width,
                        int stride, int i0, Chunk ch, cudaStream_t stream) {
  constexpr int W = sizeof(T) == 8 ? kWidth64 : kWidth;
  constexpr bool SC = PHASE == SCORE || PHASE == SEDGE, CH = PHASE == EDGE || PHASE == SEDGE;
  const bool bad_layout =
      (use_jump && mode != FIT) || mode < GLOBAL || mode > OVERLAP ||
      (!SC && ((rpb != 1 && rpb != 2 && rpb != 4) || m_pad % (8 * rpb) != 0 ||
               (rpb > 1 && use_jump) || (rpb == 4 && mode != OVERLAP))) ||
      (CH && (ch.col0g < 0 || ch.col0g % 16 != 0 || ch.i0 < 0 || ch.top == nullptr ||
              ch.bottom == nullptr)) ||
      (PHASE == EDGE && (ch.i0 % (8 * rpb) != 0 || ch.slab_rows < (ch.i0 + m_pad) / rpb ||
                         ch.acc == nullptr));
  if (bad_blocks(B, threads, width, W, kMaxThreads, m_pad, n_pad, c_blk) || bad_layout)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int ctas = B * ((n_pad + c_blk - 1) / c_blk);
  int4* cd = static_cast<int4*>(cand);
  auto go = [&](auto kernel) {
    kernel<<<ctas, threads, 0, stream>>>(qs, ts, allow, ns, ms, params, score, a, b, ptrs, edges,
                                         flags, cd, ck, m_pad, n_pad, c_blk, rpb, stride, i0, ch);
    return cudaGetLastError();
  };
  if (mode == OVERLAP) return go(bptr_overlap<PHASE, W, T>);
  if (mode == GLOBAL) return go(bptr_affine<GLOBAL, false, PHASE, W, T>);
  if (mode == LOCAL) return go(bptr_affine<LOCAL, false, PHASE, W, T>);
  if (use_jump) return go(bptr_affine<FIT, true, PHASE, W, T>);
  return go(bptr_affine<FIT, false, PHASE, W, T>);
}

// Edit's blocked score fill (CH: its chunk) in value type T, params P.
template <class T, class P, bool CH>
cudaError_t launch_edit(const int* qs, const int* ts, const int* ns, const int* ms,
                        const P* params, T* out, T* edges, int* flags, void* cand, int B,
                        int m_pad, int n_pad, int c_blk, int threads, int width, Chunk ch,
                        cudaStream_t stream) {
  constexpr int W = sizeof(T) == 8 ? kWidth64 : kWidth;
  if (bad_blocks(B, threads, width, W, sizeof(T) == 8 ? kMaxThreads : kEditMaxThreads, m_pad,
                 n_pad, c_blk) ||
      (CH && (ch.col0g < 0 || ch.col0g % 16 != 0 || ch.i0 < 0 || ch.top == nullptr ||
              ch.bottom == nullptr)))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int ctas = B * ((n_pad + c_blk - 1) / c_blk);
  bscore_edit<T, P, CH><<<ctas, threads, 0, stream>>>(qs, ts, ns, ms, params, out, edges, flags,
                                                      static_cast<int4*>(cand), m_pad, n_pad,
                                                      c_blk, ch);
  return cudaGetLastError();
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
// int32 for edit; `width` kWidth, threads up to kMaxThreads (edit:
// kEditMaxThreads) with threads * width >= c_blk; ts 16-byte aligned; the
// last column block may be narrower than c_blk (n_pad % 16 == 0).
cudaError_t at_blocked_scores(int mode, int use_jump, const int* qs, const int* ts,
                              const float* allow, const int* ns, const int* ms,
                              const float* params, void* out, float* edges, int* flags,
                              void* cand, int B, int m_pad, int n_pad, int c_blk, int threads,
                              int width, cudaStream_t stream) {
  if (mode == EDIT)
    return launch_edit<int, float, false>(qs, ts, ns, ms, params, static_cast<int*>(out),
                                          reinterpret_cast<int*>(edges), flags, cand, B, m_pad,
                                          n_pad, c_blk, threads, width, Chunk{}, stream);
  return launch_fill<SCORE, float>(mode, use_jump, 1, qs, ts, allow, ns, ms, params,
                                   static_cast<float*>(out), nullptr, nullptr, nullptr, edges,
                                   flags, cand, nullptr, B, m_pad, n_pad, c_blk, threads, width,
                                   1, 0, Chunk{}, stream);
}

// The double instance of edit's blocked score fill (a pair past float32's
// exact range): `params` the (1, 8) float64 row, `out` (B,) float64,
// `edges` float64, `width` kWidth64.
cudaError_t at_blocked_edit64(const int* qs, const int* ts, const int* ns, const int* ms,
                              const double* params, double* out, double* edges, int* flags,
                              void* cand, int B, int m_pad, int n_pad, int c_blk, int threads,
                              int width, cudaStream_t stream) {
  return launch_edit<double, double, false>(qs, ts, ns, ms, params, out, edges, flags, cand, B,
                                            m_pad, n_pad, c_blk, threads, width, Chunk{},
                                            stream);
}

// mode: 0 global, 1 local, 2 fit, 3 overlap; rpb rows per byte (1, 2, or 4
// for overlap; 1 for fit+jump), m_pad % (8 * rpb) == 0; the last column
// block may be narrower than c_blk (n_pad % 16 == 0).
cudaError_t at_blocked_ptr_fill(int mode, int use_jump, int rpb, const int* qs, const int* ts,
                                const float* allow, const int* ns, const int* ms,
                                const float* params, float* score, int* a, int* b,
                                uint8_t* ptrs, float* edges, int* flags, void* cand, int B,
                                int m_pad, int n_pad, int c_blk, int threads, int width,
                                cudaStream_t stream) {
  return launch_fill<FILL, float>(mode, use_jump, rpb, qs, ts, allow, ns, ms, params, score, a, b,
                                 ptrs, edges, flags, cand, nullptr, B, m_pad, n_pad, c_blk,
                                 threads, width, 1, 0, Chunk{}, stream);
}

// at_blocked_ptr_fill's double instance: `params` the (1, 8) float64 row,
// `score` (B,) float64, `edges` float64; the pointer bytes as its.
cudaError_t at_blocked_ptr_fill64(int mode, int use_jump, int rpb, const int* qs, const int* ts,
                                  const float* allow, const int* ns, const int* ms,
                                  const double* params, double* score, int* a, int* b,
                                  uint8_t* ptrs, double* edges, int* flags, void* cand, int B,
                                  int m_pad, int n_pad, int c_blk, int threads, int width,
                                  cudaStream_t stream) {
  return launch_fill<FILL, double>(mode, use_jump, rpb, qs, ts, allow, ns, ms, params, score, a,
                                  b, ptrs, edges, flags, cand, nullptr, B, m_pad, n_pad, c_blk,
                                  threads, width, 1, 0, Chunk{}, stream);
}

// The checkpoint forward (CKPT) of the pointer fill: score, a and b as
// at_blocked_ptr_fill's, no pointers, and `ck` the (B, m_pad / S, states,
// n_pad + 1) float32 checkpoints (states: 3 global and local, 4 fit, 1
// overlap); S a positive multiple of 8 that divides m_pad.
cudaError_t at_blocked_ckpt_fill(int mode, int use_jump, const int* qs, const int* ts,
                                 const float* allow, const int* ns, const int* ms,
                                 const float* params, float* score, int* a, int* b, float* ck,
                                 float* edges, int* flags, void* cand, int B, int m_pad,
                                 int n_pad, int c_blk, int threads, int width, int stride,
                                 cudaStream_t stream) {
  if (stride <= 0 || stride % 8 != 0 || m_pad % stride != 0 || ck == nullptr)
    return cudaErrorInvalidValue;
  return launch_fill<CKPT, float>(mode, use_jump, 1, qs, ts, allow, ns, ms, params, score, a, b,
                                 nullptr, edges, flags, cand, ck, B, m_pad, n_pad, c_blk,
                                 threads, width, stride, 0, Chunk{},
                                 stream);
}

// at_blocked_ckpt_fill's double instance: params, score, ck and edges
// float64.
cudaError_t at_blocked_ckpt_fill64(int mode, int use_jump, const int* qs, const int* ts,
                                   const float* allow, const int* ns, const int* ms,
                                   const double* params, double* score, int* a, int* b,
                                   double* ck, double* edges, int* flags, void* cand, int B,
                                   int m_pad, int n_pad, int c_blk, int threads, int width,
                                   int stride, cudaStream_t stream) {
  if (stride <= 0 || stride % 8 != 0 || m_pad % stride != 0 || ck == nullptr)
    return cudaErrorInvalidValue;
  return launch_fill<CKPT, double>(mode, use_jump, 1, qs, ts, allow, ns, ms, params, score, a, b,
                                  nullptr, edges, flags, cand, ck, B, m_pad, n_pad, c_blk,
                                  threads, width, stride, 0, Chunk{},
                                 stream);
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
                              int c_blk, int threads, int width, cudaStream_t stream) {
  if (i0 < 0 || ck == nullptr) return cudaErrorInvalidValue;
  return launch_fill<SEED, float>(mode, use_jump, rpb, qs, ts, allow, ns, ms, params, nullptr,
                                 nullptr, nullptr, ptrs, edges, flags, cand,
                                 const_cast<float*>(ck), B, S, n_pad, c_blk, threads, width, S, i0,
                                 Chunk{}, stream);
}

// at_blocked_refill's double instance: params, ck and edges float64.
cudaError_t at_blocked_refill64(int mode, int use_jump, int rpb, const int* qs, const int* ts,
                                const float* allow, const int* ns, const int* ms,
                                const double* params, const double* ck, int i0, uint8_t* ptrs,
                                double* edges, int* flags, void* cand, int B, int S, int n_pad,
                                int c_blk, int threads, int width, cudaStream_t stream) {
  if (i0 < 0 || ck == nullptr) return cudaErrorInvalidValue;
  return launch_fill<SEED, double>(mode, use_jump, rpb, qs, ts, allow, ns, ms, params, nullptr,
                                  nullptr, nullptr, ptrs, edges, flags, cand,
                                  const_cast<double*>(ck), B, S, n_pad, c_blk, threads, width, S,
                                  i0, Chunk{}, stream);
}

// The EDGE phase of the score fills (parallel/seqpar.py): rows i0+1 .. i0+R
// of global columns col0+1 .. col0+nloc, qs (B, R), ts and allow (B, nloc),
// `top`/`bottom` the (B, states, nloc) state rows of rows i0 and i0+R (3
// states global, local and fit: M, L, max(L, M, U[, J]); 1 overlap and edit:
// M), `acc` the (B,) running candidate (int32 for edit, else float32),
// `edges` (B, nblk + 1, 4, R + 1) of the value type with the left edge in
// slot 0 (the right edge comes back in slot nblk), `flags` (1 + B * (nblk +
// 1)) zeroed, `cand` (B, nblk, 4); the launch shapes of at_blocked_scores.
cudaError_t at_blocked_edge_scores(int mode, int use_jump, const int* qs, const int* ts,
                                   const float* allow, const int* ns, const int* ms,
                                   const float* params, const void* top, void* bottom, void* acc,
                                   void* edges, int* flags, void* cand, int B, int R, int nloc,
                                   int c_blk, int threads, int width, int col0, int i0,
                                   cudaStream_t stream) {
  if (acc == nullptr) return cudaErrorInvalidValue;
  const Chunk ch = {top, bottom, col0, i0, nullptr, 0};
  if (mode == EDIT)
    return launch_edit<int, float, true>(qs, ts, ns, ms, params, static_cast<int*>(acc),
                                         static_cast<int*>(edges), flags, cand, B, R, nloc, c_blk,
                                         threads, width, ch, stream);
  return launch_fill<SEDGE, float>(mode, use_jump, 1, qs, ts, allow, ns, ms, params,
                                   static_cast<float*>(acc), nullptr, nullptr, nullptr,
                                   static_cast<float*>(edges), flags, cand, nullptr, B, R, nloc,
                                   c_blk, threads, width, 1, i0, ch, stream);
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
                                int width, int col0, int i0, cudaStream_t stream) {
  const Chunk ch = {top, bottom, col0, i0, static_cast<int4*>(acc), slab_rows};
  return launch_fill<EDGE, float>(mode, use_jump, rpb, qs, ts, allow, ns, ms, params, nullptr,
                                 nullptr, nullptr, slab, edges, flags, cand, nullptr, B, R, nloc,
                                 c_blk, threads, width, 1, i0, ch, stream);
}

}  // extern "C"
