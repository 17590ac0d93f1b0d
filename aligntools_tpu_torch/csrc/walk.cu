// Batched traceback walk for Hopper (sm_90a): one thread per pair.
//
// Replaces engine/device_tb.py:_walk_affine (global / local / fit) and
// _walk_overlap, XLA while_loops that stepped every pair of a bucket
// together and exited when none was active. Here each thread walks its own
// pair to its own end: from the start (state, i, j) it reads one packed
// pointer byte of the fill's (B, m_pad/rpb, n_pad) tensor (columns
// 1..n_pad), decodes it as layout.py lays it out, moves, and writes the
// step's (query, target) column into cols1/cols2 (n_steps, B), so the
// threads of a warp write neighbouring bytes at each step. Chars come from
// the fill's own int32 planes on the device.
//
// What bounds it here: latency, not bytes or operations. A step is a
// dependent chain of a pointer load (device memory), a decode and the char
// loads; a walk takes up to m + n steps, and a bucket of B pairs has only
// B threads in flight. The design keeps every pair's walk in registers with
// no barrier and no cross-thread traffic, so a short walk (local on
// unrelated reads: tens of steps) ends as soon as its own pair ends.
//
// Semantics are the JAX walks', step for step: local's HOME code stops the
// walk after emitting its step (emit-then-stop), an unset code is an error
// for global and fit, overlap flags a walk that reaches row 0 before
// column 0 (and leaves that step out of the count), and indices clamp as a
// JAX gather clamps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LOW = 0, MID = 1, UPP = 2, JUMP = 3, DONE = 4, ERR = 5;
constexpr int GLOBAL = 0, LOCAL = 1, FIT = 2, OVERLAP = 3;
constexpr uint8_t GAP = '-';

__global__ void walk_kernel(int mode, int rpb, const uint8_t* __restrict__ ptrs,
                            const int* __restrict__ qs, const int* __restrict__ ts,
                            const int* __restrict__ starts, uint8_t* __restrict__ cols1,
                            uint8_t* __restrict__ cols2, int* __restrict__ scal, int B,
                            int m_pad, int n_pad, int R) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* P = ptrs + (size_t)b * R * n_pad;
  const int* q = qs + (size_t)b * m_pad;
  const int* t = ts + (size_t)b * n_pad;
  const int n_steps = m_pad + n_pad + 1, bits = 8 / rpb;
  const bool overlap = mode == OVERLAP;
  int state = starts[b], i = starts[B + b], j = starts[2 * B + b];
  int count = 0, err = 0;
  bool done = j <= 0;
  for (int k = 0; k < n_steps; ++k) {
    const bool active = overlap ? (!done && j > 0)
                                : (state < DONE && i > 0 && (mode == FIT || j > 0));
    if (!active) break;
    const int row = max(i - 1, 0), jc = min(max(j - 1, 0), n_pad - 1);
    bool takes_q, takes_t, bad = false;
    int nxt = state;
    if (overlap) {
      const int byte = P[(size_t)min(row / rpb, R - 1) * n_pad + jc];
      const int code = (byte >> ((row % rpb) * bits)) & 0x3;
      bad = code == 3 || i <= 0;
      takes_q = code != 0;  // DIAG and RIGHT consume a query char
      takes_t = code != 2;  // LEFT and DIAG consume a target char
    } else {
      int byte, nxt_mid;
      bool l_is_mid, u_is_upp;
      if (rpb == 2) {
        byte = P[(size_t)min(row >> 1, R - 1) * n_pad + jc];
        byte = ((row & 1) ? byte >> 4 : byte) & 0xF;
        const int code = byte & 0x3;
        nxt_mid = code == 3 ? (mode == LOCAL ? DONE : ERR) : code;
        l_is_mid = byte & 0x4;
        u_is_upp = byte & 0x8;
      } else {
        byte = P[(size_t)min(row, R - 1) * n_pad + jc];
        const int code = byte & 0x7;
        nxt_mid = code == 7 ? ERR : (code <= 3 ? code : DONE);
        l_is_mid = byte & 0x8;
        u_is_upp = byte & 0x10;
      }
      if (state == MID)
        nxt = nxt_mid;
      else if (state == LOW)
        nxt = l_is_mid ? MID : LOW;
      else if (state == UPP)
        nxt = u_is_upp ? UPP : MID;
      else
        nxt = (byte & 0x20) ? JUMP : MID;
      takes_q = state == LOW || state == MID;
      takes_t = state != LOW;
    }
    const int ni = takes_q ? i - 1 : i, nj = takes_t ? j - 1 : j;
    const size_t at = (size_t)k * B + b;
    cols1[at] = takes_q ? (uint8_t)q[min(max(ni, 0), m_pad - 1)] : GAP;
    cols2[at] = takes_t ? (uint8_t)t[min(max(nj, 0), n_pad - 1)] : GAP;
    if (overlap) {
      err |= bad;
      done = bad || nj == 0;
      count += !bad;
    } else {
      err |= nxt == ERR;
      state = nxt;
      ++count;
    }
    i = ni;
    j = nj;
  }
  scal[b] = count;
  scal[B + b] = i;
  scal[2 * B + b] = j;
  scal[3 * B + b] = err;
}

}  // namespace

// C entry point, bound with ctypes: launches one bucket's walk on `stream`
// without synchronising and returns the launch's error code. cols1/cols2
// arrive zeroed (the wrapper allocates them); steps past a walk stay 0.
extern "C" cudaError_t at_walk(int mode, int rpb, const uint8_t* ptrs, const int* qs,
                               const int* ts, const int* starts, uint8_t* cols1,
                               uint8_t* cols2, int* scal, int B, int m_pad, int n_pad,
                               int R, int threads, cudaStream_t stream) {
  if (B < 0 || m_pad <= 0 || n_pad <= 0 || R <= 0 || mode < GLOBAL || mode > OVERLAP ||
      (rpb != 1 && rpb != 2 && rpb != 4) || (long long)R * rpb != m_pad ||
      threads < 32 || threads > 1024 || threads % 32 != 0)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  walk_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
      mode, rpb, ptrs, qs, ts, starts, cols1, cols2, scal, B, m_pad, n_pad, R);
  return cudaGetLastError();
}
