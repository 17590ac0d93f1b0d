// Batched traceback walk for Hopper (sm_90a): a warp per pair, walking
// pointer tiles staged in shared memory.
//
// Replaces engine/device_tb.py:_walk_affine (global / local / fit) and
// _walk_overlap, XLA while_loops that stepped every pair of a bucket
// together and exited when none was active, and engine/banded.py's host
// loop _walk_banded (WINDOW). From the start (state, i, j) each pair reads
// one packed pointer byte of the fill's (B, m_pad/rpb, n_pad) tensor
// (columns 1..n_pad), decodes it as layout.py lays it out, moves up, left
// or both, and emits the step's (query, target) column into cols1/cols2
// (n_steps, B).
//
// What bounds it: latency. A step is a dependent chain (the pointer byte
// at (i, j), its decode, the next (i, j)) and a walk takes up to m + n
// steps; bytes and operations are far below the card's rates. The first
// design (a thread a pair) paid a device-memory miss on every step: a step
// up jumps a whole row of the pointer slab (n_pad bytes), and the ~10
// pairs of a long-target bucket shared one warp on one SM, each step
// waiting for the slowest lane. Here:
//
//   - One warp walks one pair, so no pair waits on another. The warp is
//     alone on its SM sub-partition: an iteration costs its instructions
//     one after another, so the layout (flat or window, mode, rows per
//     byte) is a template parameter, the next state a lookup in a register
//     (NEXT_MID) and a stay bit (STAY_BIT), and the count and the error
//     flag are read off the walk's end.
//   - An affine step's move is its state's, so a run of steps in one state
//     lies on one line of cells (LOW up, MID diagonal, UPP and JUMP left).
//     Lane l decodes the cell l steps down the line; two ballots find where
//     the run leaves its state or can go no further, and the warp takes
//     the whole run, up to 32 steps, in one iteration, each lane writing
//     its step's columns. The long J and U runs of a long target (an
//     intron, a gap) and the diagonals of similar pairs go 32 steps at a
//     time; a path that turns at every step goes one. Overlap's codes
//     move directly (its next cell waits for the byte), so its lanes run
//     the same step and keep one column of 32 each, written 32 at once.
//   - The warp stages a tile of the pointer bytes (tr byte-rows x tc
//     columns, 8 KB; see at_walk) that ends at the current cell, with the
//     query chars of its rows and the target chars of its columns, into
//     shared memory with cp.async, so a step reads shared memory. The walk
//     only moves up and left (in window coordinates: up, and a lane right
//     on an up step, left on a left step), so a tile serves every step
//     until the walk leaves it.
//   - Two buffers. On entering a tile the warp copies the next one into
//     the other buffer, beyond the edge its state moves to; halfway across,
//     it copies the one beyond the other edge instead if the walk has gone
//     that way. A wrong guess costs one synchronous tile load. The first
//     tile is loaded at the first step (a walk of no steps loads none).
//
// Semantics are the JAX walks', step for step: local's HOME code stops the
// walk after emitting its step (emit-then-stop), an unset code is an error
// for global and fit, overlap flags a walk that reaches row 0 before
// column 0 (and leaves that step out of the count), fit walks on with
// j <= 0 (reading column 0), and indices clamp as a JAX gather clamps.
// A flat walk's char indices always fall in the staged tile's; a window
// walk's that do not (only a clamped one can miss) are read from device
// memory.
//
// PAUSE (flat walks; the checkpoint-rescan engine's walk of one refilled
// row block, engine/rescan.py; the counterpart of _walk_overlap's
// pause_at_i0): the walk stops, with no error, where it reaches the
// block's row 0, and writes its final state as a fifth scalar, so that it
// resumes in the block above. Affine walks already stop at row 0 with their
// state kept (a pause is a state below DONE, where local's HOME stop is
// DONE); overlap's walk, which flags reaching row 0 before column 0 as an
// error, stops there instead, and its final state is DONE once it has
// ended (column 0 or an unset code), else LOW.
//
// Window mode (WINDOW, band >= 0) walks the banded fill's pointers: cell
// (i, j) at row i-1, lane k = j - i + band of a (B, m_pad, cols) byte
// tensor (rows per byte 1), target chars from the fill's te plane at
// band + j. A step whose lane falls outside [0, 2*band+1) ends the walk with
// error bit 2 (affine: no step is taken; overlap: as its unset code).
// Window tiles hold whole rows up to WHOLE_ROW_LANES lanes, else are
// centred on the lane; the prediction there is always the tile above.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LOW = 0, MID = 1, UPP = 2, JUMP = 3, DONE = 4, ERR = 5;
constexpr int GLOBAL = 0, LOCAL = 1, FIT = 2, OVERLAP = 3;
constexpr uint8_t GAP = '-';

constexpr int ERR_UNSET = 1, ERR_LEFT_BAND = 2;

constexpr int TILE_BYTES = 8192;     // pointer bytes a tile
constexpr int MAX_TILE_ROWS = 256;   // byte-rows a tile, at most
constexpr int WHOLE_ROW_LANES = 512;  // window rows this narrow are staged whole

// The state MID goes to, by the M code of the cell (4 bits a code, code 0
// lowest): rpb 1: LOW MID UPP JUMP, then HOME (4-6) ends the walk, 7 is
// unset; rpb 2: LOW MID UPP, then code 3 is HOME for local, else unset.
constexpr unsigned NEXT_MID_RPB1 = 0x54443210u;
constexpr unsigned NEXT_MID_RPB2_LOCAL = 0x4210u, NEXT_MID_RPB2 = 0x5210u;
// The bit of the byte (rpb 2: of the nibble) that keeps LOW / UPP / JUMP
// (4 bits a state, LOW lowest; MID's unused): LOW leaves for MID when it
// is set, UPP and JUMP stay. A nibble has no JUMP bit: bit 4 reads 0.
constexpr unsigned STAY_BIT_RPB1 = 0x5403u, STAY_BIT_RPB2 = 0x4302u;

// A staged tile: byte-rows [r0, r1), columns (lanes) [c0, c1), query chars
// [q0, q1) and target chars [t0, t1). An empty tile holds nothing.
struct Tile {
  int r0, r1, c0, c1, q0, q1, t0, t1;
  __device__ bool holds(int br, int c) const {
    return br >= r0 && br < r1 && c >= c0 && c < c1;
  }
};

// One launch's arguments (a kernel parameter; read from the constant bank).
struct Args {
  const uint8_t* ptrs;
  const int* qs;
  const int* ts;
  const int* starts;
  uint8_t* cols1;
  uint8_t* cols2;
  int* scal;
  int mode, B, m_pad, n_pad, R, cols, band, tr, tc, q_max, buf_bytes;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x, kept in a register: the compiler would load a kernel parameter from
// the constant bank again at every use in the loop, on the step's chain
__device__ __forceinline__ int pin(int x) {
  asm("" : "+r"(x));
  return x;
}

// The tile whose rows end at byte-row br and whose columns end at column c
// (flat: the walk only moves left) or are centred on lane c (window).
template <bool WINDOW, int LG>
__device__ Tile place(int br, int c, const Args& a) {
  Tile T;
  T.r1 = br + 1;
  T.r0 = max(T.r1 - a.tr, 0);
  if (WINDOW)
    T.c0 = min(max((c - a.tc / 2) & ~15, 0), max(a.cols - a.tc, 0));
  else
    T.c0 = max((c & ~15) + 16 - a.tc, 0);
  T.c1 = min(T.c0 + a.tc, a.cols);
  T.q0 = T.r0 << LG;
  T.q1 = min(T.r1 << LG, a.m_pad);
  if (WINDOW) {  // char band + j - 1 = lane + row
    T.t0 = min(T.r0 + T.c0, a.n_pad);
    T.t1 = min(T.r1 + T.c1 - 1, a.n_pad);
  } else {
    T.t0 = T.c0;
    T.t1 = T.c1;
  }
  return T;
}

// Issue (and commit) the cp.async copies of tile T into buffer `buf`:
// pointer rows in 16-byte chunks (c0 and cols are multiples of 16), chars
// a word each.
__device__ void load(uint8_t* buf, const Tile& T, const uint8_t* P, const int* q,
                     const int* t, const Args& a, int lane) {
  const int chunks = (T.c1 - T.c0) >> 4, n = (T.r1 - T.r0) * chunks;
  for (int x = lane; x < n; x += 32) {
    const int r = x / chunks, ch = x - r * chunks;
    cp_async16(buf + r * a.tc + ch * 16, P + (size_t)(T.r0 + r) * a.cols + T.c0 + ch * 16);
  }
  int* sq = reinterpret_cast<int*>(buf + a.tr * a.tc);
  int* st = sq + a.q_max;
  for (int x = lane; x < T.q1 - T.q0; x += 32) cp_async4(sq + x, q + T.q0 + x);
  for (int x = lane; x < T.t1 - T.t0; x += 32) cp_async4(st + x, t + T.t0 + x);
  cp_async_commit();
}

template <bool WINDOW, int MODE, int RPB, bool PAUSE>
__global__ void walk_kernel(const Args a) {
  constexpr bool OVL = MODE == OVERLAP;
  constexpr int LG = RPB == 4 ? 2 : RPB == 2 ? 1 : 0, BITS = 8 / RPB;
  constexpr unsigned NEXT_MID =
      RPB == 1 ? NEXT_MID_RPB1 : MODE == LOCAL ? NEXT_MID_RPB2_LOCAL : NEXT_MID_RPB2;
  constexpr unsigned STAY_BIT = RPB == 1 ? STAY_BIT_RPB1 : STAY_BIT_RPB2;
  extern __shared__ __align__(16) uint8_t smem[];
  const int* smem_i = reinterpret_cast<const int*>(smem);
  const int lane = threadIdx.x, b = blockIdx.x;  // a CTA is one warp, one pair
  const uint8_t* P = a.ptrs + (size_t)b * a.R * a.cols;
  const int* q = a.qs + (size_t)b * a.m_pad;
  const int* t = a.ts + (size_t)b * a.n_pad;
  const int m_pad = pin(a.m_pad), n_pad = pin(a.n_pad), R = pin(a.R), band = pin(a.band);
  const int tc = pin(a.tc), cols = pin(a.cols), n_steps = m_pad + n_pad + 1;
  int state = a.starts[b], i = a.starts[a.B + b], j = a.starts[2 * a.B + b];
  bool done = j <= 0, bad = false, out = false;

  Tile cur = {}, next = {};
  int cb = 0;                // the buffer that holds cur
  bool in_flight = false;    // next's copy was issued into buffer cb ^ 1
  bool next_top = false;     // next lies above cur (else to its left)
  int br_in = 0, jc_in = 0;  // where the walk entered cur
  // the step leaves the common path when br < lo_r or jc < lo_c (or, in a
  // window, jc >= hi_c): to switch tiles, or to issue the next one
  int lo_r = INT_MAX, lo_c = INT_MAX, hi_c = INT_MIN;
  int p_off = 0, q_off = 0, t_off = 0;  // cell (br, jc) at smem[p_off + br * tc + jc]
  int o1 = 0, o2 = 0;        // overlap: this lane's step of the batch of 32
  int k = 0;

  // The cell of (ci, cj): its row, column (window: lane, clamped) and byte
  // row, and whether it lies outside the band.
  auto cell = [&](int ci, int cj, int& row, int& jc, int& br, bool& o) {
    row = max(ci - 1, 0);
    jc = min(max(cj - 1, 0), n_pad - 1);
    if (WINDOW) {
      jc = cj - ci + band;
      o = jc < 0 || jc > 2 * band;
      jc = min(max(jc, 0), cols - 1);
    }
    br = min(row >> LG, R - 1);
  };
  // Issue the copy of the tile beyond cur's top edge (top) or left edge
  // into the spare buffer, once the copy in flight there has landed.
  auto prefetch = [&](bool top, int br, int jc) {
    if ((top || cur.c0 == 0) && cur.r0 > 0) {
      next = place<WINDOW, LG>(cur.r0 - 1, jc, a);
      next_top = true;
    } else if (!WINDOW && cur.c0 > 0) {
      next = place<WINDOW, LG>(br, cur.c0 - 1, a);
      next_top = false;
    } else {
      return;
    }
    if (in_flight) cp_async_wait_all();
    load(smem + (cb ^ 1) * a.buf_bytes, next, P, q, t, a, lane);
    in_flight = true;
  };
  // Make cur hold cell (row, jc) (byte row br): switch tiles when it does
  // not, and copy the next one at once, beyond the edge the walk's state
  // moves to (LOW up, UPP and JUMP left, MID and overlap the nearer edge);
  // halfway across cur, copy the other one if the walk has gone that way.
  auto ensure = [&](int row, int br, int jc) {
    if (br >= lo_r && jc >= lo_c && (!WINDOW || jc < hi_c)) return;
    if (!cur.holds(br, jc)) {
      __syncwarp();  // every lane is done with cur's buffer
      if (in_flight && next.holds(br, jc)) {
        cur = next;
        cb ^= 1;
      } else {
        cur = place<WINDOW, LG>(br, jc, a);
        load(smem + cb * a.buf_bytes, cur, P, q, t, a, lane);
      }
      cp_async_wait_all();
      __syncwarp();  // every lane's copies are visible to the warp
      in_flight = false;
      br_in = br;
      jc_in = jc;
      lo_r = (br + cur.r0 + 1) >> 1;
      lo_c = WINDOW ? cur.c0 : (jc + cur.c0 + 1) >> 1;
      hi_c = cur.c1;
      const int base = cb * a.buf_bytes;
      p_off = base - cur.r0 * tc - cur.c0;
      q_off = (base + a.tr * tc) / 4 - cur.q0;
      t_off = (base + a.tr * tc) / 4 + a.q_max - cur.t0;
      const bool nearer_top = row - (cur.r0 << LG) < jc - cur.c0;
      prefetch(WINDOW || (!OVL && state == LOW) ||
                   ((OVL || state == MID) && nearer_top),
               br, jc);
      return;
    }
    // rows and columns moved since cur was entered, and to its edges
    const int up = br_in - br, left = jc_in - jc;
    const int to_top = br - cur.r0 + 1, to_left = jc - cur.c0 + 1;
    // leaves through the top first at this pace, or the left edge
    const bool top = WINDOW || (long long)to_top * left < (long long)to_left * up;
    if (!in_flight || top != next_top) prefetch(top, br, jc);
    lo_r = cur.r0;
    lo_c = cur.c0;
  };
  // The pointer byte of cell (br, jc) and the chars a step up / left from
  // it would consume, clamped as a gather clamps: query row i-1 (= row),
  // target column j-1 (flat: = jc).
  auto fetch = [&](int row, int jc, int br, int cj, int& raw, int& qch, int& tch) {
    raw = smem[p_off + br * tc + jc];
    qch = smem_i[q_off + min(row, m_pad - 1)];
    if (WINDOW) {
      const int ti = min(max(cj - 1 + band, 0), n_pad - 1);
      tch = (ti >= cur.t0 && ti < cur.t1) ? smem_i[t_off + ti] : t[ti];
    } else {
      tch = smem_i[t_off + jc];
    }
  };
  if (OVL) {
    // overlap's codes move directly: the next cell waits for this byte
    for (; k < n_steps && !done && j > 0 && (!PAUSE || i > 0); ++k) {
      int row, jc, br, raw, qch, tch;
      cell(i, j, row, jc, br, out);
      ensure(row, br, jc);
      fetch(row, jc, br, j, raw, qch, tch);
      const int code = out ? 3 : (raw >> ((row & (RPB - 1)) * BITS)) & 0x3;
      bad = code == 3 || i <= 0;
      done = bad || (code != 2 && j == 1);  // nj == 0
      const bool takes_q = code != 0;  // DIAG and RIGHT consume a query char
      const bool takes_t = code != 2;  // LEFT and DIAG consume a target char
      // every lane has the step's columns, lane k % 32 keeps them (a
      // select: a branch on the lane would split the warp), and each 32nd
      // step the warp writes the batch
      const bool mine = lane == (k & 31);
      o1 = mine ? (takes_q ? qch : GAP) : o1;
      o2 = mine ? (takes_t ? tch : GAP) : o2;
      if ((k & 31) == 31) {
        const size_t at = (size_t)(k - 31 + lane) * a.B + b;
        a.cols1[at] = (uint8_t)o1;
        a.cols2[at] = (uint8_t)o2;
      }
      i -= takes_q;
      j -= takes_t;
    }
    if (lane < (k & 31)) {  // the last, partial batch: steps [k & ~31, k)
      const size_t at = (size_t)((k & ~31) + lane) * a.B + b;
      a.cols1[at] = (uint8_t)o1;
      a.cols2[at] = (uint8_t)o2;
    }
  } else {
    // An affine step's move is its state's, so a run of steps in one state
    // goes down one line of cells: LOW up, MID diagonally, UPP and JUMP
    // left. Lane l takes the cell l steps down the run's line and decodes
    // it in the run's state; two ballots find the first step that leaves
    // the state (taken, in the state) and the first that cannot be taken
    // (inactive, or outside the tile or the band: the run stops before
    // it). Each lane writes its step's columns; the warp takes the whole
    // run, up to 32 steps, at once.
    for (;;) {
      if (!(k < n_steps && state < DONE && i > 0 && (MODE == FIT || j > 0))) break;
      int row, jc, br;
      cell(i, j, row, jc, br, out);
      if (WINDOW && out) break;  // left the band: no step
      ensure(row, br, jc);
      const int dq = state <= MID;  // LOW and MID consume a query char
      const int dt = state != LOW;  // MID, UPP and JUMP a target char
      const int ci = i - lane * dq, cj = j - lane * dt;
      int lrow, ljc, lbr;
      bool lout = false;
      cell(ci, cj, lrow, ljc, lbr, lout);
      const bool inside = cur.holds(lbr, ljc);
      const bool ok = inside && k + lane < n_steps && ci > 0 && (MODE == FIT || cj > 0) &&
                      !(WINDOW && lout);
      int raw, qch, tch;  // a lane outside the tile reads lane 0's cell
      fetch(inside ? lrow : row, inside ? ljc : jc, inside ? lbr : br, inside ? cj : j, raw,
            qch, tch);
      const int byte = RPB == 2 ? (raw >> ((lrow & 1) << 2)) & 0xF : raw;
      const int nxt_mid = (NEXT_MID >> ((byte & (RPB == 1 ? 0x7 : 0x3)) << 2)) & 0xF;
      const int bit = (byte >> ((STAY_BIT >> (state << 2)) & 0xF)) & 1;
      const int nxt = state == MID ? nxt_mid : (bit ^ (state == LOW)) ? state : MID;
      const unsigned stop = __ballot_sync(~0u, !ok);
      const unsigned turn = __ballot_sync(~0u, ok && nxt != state);
      const int turn_at = turn ? __ffs(turn) - 1 : 32;
      const int n = min(stop ? __ffs(stop) - 1 : 32, turn_at + 1);  // >= 1: lane 0's is ok
      if (lane < n) {
        const size_t at = (size_t)(k + lane) * a.B + b;
        a.cols1[at] = dq ? (uint8_t)qch : GAP;
        a.cols2[at] = dt ? (uint8_t)tch : GAP;
      }
      if (turn_at < n) state = __shfl_sync(~0u, nxt, turn_at);
      i -= n * dq;
      j -= n * dt;
      k += n;
    }
  }
  cp_async_wait_all();  // a prefetch the walk never used
  if (lane == 0) {
    // every step counts, but overlap's unset one (its last); an error ends
    // the walk: the band's bit where the walk left it (overlap: where its
    // last step's lane fell outside), else the unset code's
    int count = k, err = 0;
    if (OVL) {
      count -= bad;
      err = bad ? (out ? ERR_LEFT_BAND : ERR_UNSET) : 0;
    } else if (WINDOW && out) {
      err = ERR_LEFT_BAND;
    } else if (k > 0 && state == ERR) {
      err = ERR_UNSET;
    }
    a.scal[b] = count;
    a.scal[a.B + b] = i;
    a.scal[2 * a.B + b] = j;
    a.scal[3 * a.B + b] = err;
    if (PAUSE) a.scal[4 * a.B + b] = OVL ? (done ? DONE : LOW) : state;
  }
}

template <bool WINDOW, int MODE, int RPB, bool PAUSE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  walk_kernel<WINDOW, MODE, RPB, PAUSE><<<a.B, 32, 2 * a.buf_bytes, stream>>>(a);
  return cudaGetLastError();
}

// The instantiation for the launch's mode (window: rows per byte 1).
template <bool WINDOW, int RPB, bool PAUSE>
cudaError_t launch_mode(const Args& a, cudaStream_t stream) {
  switch (a.mode) {
    case GLOBAL: return launch<WINDOW, GLOBAL, RPB, PAUSE>(a, stream);
    case LOCAL: return launch<WINDOW, LOCAL, RPB, PAUSE>(a, stream);
    case FIT: return launch<WINDOW, FIT, RPB, PAUSE>(a, stream);
    default: return launch<WINDOW, OVERLAP, RPB, PAUSE>(a, stream);
  }
}

// The flat instantiation for the launch's rows per byte.
template <bool PAUSE>
cudaError_t launch_flat(const Args& a, int rpb, cudaStream_t stream) {
  if (rpb == 4) return launch<false, OVERLAP, 4, PAUSE>(a, stream);
  return rpb == 2 ? launch_mode<false, 2, PAUSE>(a, stream)
                  : launch_mode<false, 1, PAUSE>(a, stream);
}

}  // namespace

// C entry point, bound with ctypes: launches one bucket's walk on `stream`
// without synchronising and returns the launch's error code. cols1/cols2
// arrive zeroed (the wrapper allocates them); steps past a walk stay 0.
// band < 0: the flat walk (cols == n_pad); band >= 0: the window walk over
// (B, m_pad, cols) pointers with rows per byte 1, cols >= 2*band+1, and
// ts the banded fill's te plane (n_pad its width). Rows of the pointer
// tensor are a multiple of 16 bytes and its base 16-byte aligned (the
// tiles are copied in 16-byte chunks). One pair a CTA of one warp, two
// tile buffers of shared memory (~20 KB). `tile_cols` (a multiple of 16,
// >= 32) is a tile's width where the row is wider, its rows TILE_BYTES /
// width (at most MAX_TILE_ROWS). `pause` (flat walks only): stop at row 0
// and write the final state; scal is then (5, B), else (4, B).
extern "C" cudaError_t at_walk(int mode, int rpb, const uint8_t* ptrs, const int* qs,
                               const int* ts, const int* starts, uint8_t* cols1,
                               uint8_t* cols2, int* scal, int B, int m_pad, int n_pad,
                               int R, int cols, int band, int tile_cols, int pause,
                               cudaStream_t stream) {
  const bool window = band >= 0, overlap = mode == OVERLAP;
  const bool bad_shape = window ? (rpb != 1 || (long long)cols < 2LL * band + 1)
                                : cols != n_pad;
  if (B < 0 || m_pad <= 0 || n_pad <= 0 || R <= 0 || bad_shape || mode < GLOBAL ||
      mode > OVERLAP || (rpb != 1 && rpb != 2 && !(rpb == 4 && overlap)) ||
      (long long)R * rpb != m_pad || cols % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ptrs) % 16 != 0 || tile_cols < 32 || tile_cols % 16 != 0 ||
      (pause && window))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  Args a = {ptrs, qs, ts, starts, cols1, cols2, scal, mode, B, m_pad, n_pad, R, cols, band};
  a.tc = (window && cols <= WHOLE_ROW_LANES) ? cols : (cols < tile_cols ? cols : tile_cols);
  a.tr = TILE_BYTES / a.tc < MAX_TILE_ROWS ? TILE_BYTES / a.tc : MAX_TILE_ROWS;
  a.q_max = a.tr * rpb;
  a.buf_bytes = (a.tr * a.tc + 4 * (a.q_max + a.tc + a.tr) + 15) & ~15;
  if (window) return launch_mode<true, 1, false>(a, stream);
  return pause ? launch_flat<true>(a, rpb, stream) : launch_flat<false>(a, rpb, stream);
}
