// The register-strip row shared by the pointer fills: the flat fill
// (ptr_fill.cu, one CTA a pair) and the blocked one (blocked_fill.cu, one CTA
// a pair and column block). Thread t owns W consecutive columns and keeps
// their row state in registers; a row is a serial pass, warp scans with
// shuffles, one __syncthreads() and a second serial pass (ptr_fill.cu's
// header). Here: the strip widths, the argmax of D, the candidates of the
// start info and their reduction, the warps' scans, and the strip's loads and
// stores.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int BIG = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;

// The strip width the float32 pointer fills are instantiated at, and the
// most threads a CTA runs, which sets the registers ptxas may give a thread
// (65,536 / 512).
constexpr int kWidth = 16;
constexpr int kMaxThreads = 512;
// The double instances' strip width: a double takes two registers, so W 16
// would hold twice float32's row state at the same 128 registers a thread
// (fit+jump's float32 W 16 already takes all 128). W 8 keeps the row state
// of one float32 strip: 512 x 8 = 4,096 columns a CTA.
constexpr int kWidth64 = 8;

// max of the value types: FMNMX for float32
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }

// A start-info candidate: the value, its row and its column.
template <class T>
struct Cand {
  T v;
  int i, j;
};

// x before y: the larger value, then the smaller row, then the smaller column
template <class T>
__device__ __forceinline__ bool before(const Cand<T>& x, const Cand<T>& y) {
  return x.v > y.v || (x.v == y.v && (x.i < y.i || (x.i == y.i && x.j < y.j)));
}

// The CTA's first candidate by `before`, in every thread; two barriers.
template <class T>
__device__ Cand<T> block_best(Cand<T> c, Cand<T> (&red)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const Cand<T> y = {__shfl_xor_sync(FULL, c.v, d), __shfl_xor_sync(FULL, c.i, d),
                       __shfl_xor_sync(FULL, c.j, d)};
    if (before(y, c)) c = y;
  }
  if (lane == 0) red[warp] = c;
  __syncthreads();
  Cand<T> r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    if (before(red[w], r)) r = red[w];
  __syncthreads();
  return r;
}

// Keep the strip's first maximum of one row over its first `kn` columns
// (columns <= n-1 of row m for fit and overlap): the first column holds the
// candidate even at -inf, as the plain version's first-equal search does.
template <int W, class T>
__device__ __forceinline__ void first_max(const T (&x)[W], int kn, int j0, Cand<T>& c) {
#pragma unroll
  for (int k = 0; k < W; ++k)
    if (k < kn && (x[k] > c.v || c.j == BIG)) c = {x[k], 0, j0 + k};
}

// Inclusive max over the warp's lanes (lanes below d read their own value).
template <class T>
__device__ __forceinline__ T warp_incl_max(T x) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) x = vmax(x, __shfl_up_sync(FULL, x, d));
  return x;
}

// Inclusive max over the aggregates of warps 0..lane, in every warp.
template <class T>
__device__ __forceinline__ T warps_incl_max(const T* agg, int lane, int nw) {
  T y = lane < nw ? agg[lane] : (T)NEG;
  for (int d = 1; d < nw; d <<= 1) y = vmax(y, __shfl_up_sync(FULL, y, d));
  return y;
}

// D = max(L, M, U[, J]) and its earliest-argument strict argmax: the first
// of the states that holds the maximum (LOW, MID, UPP, JUMP = 0..3).
template <bool JUMP, class T>
__device__ __forceinline__ T lmuj_max(T l, T m, T u, T j, int& a) {
  T d = l;
  a = 0;
  if (m > d) a = 1;
  d = vmax(d, m);
  if (u > d) a = 2;
  d = vmax(d, u);
  if (JUMP) {
    if (j > d) a = 3;
    d = vmax(d, j);
  }
  return d;
}

// Store a strip's packed byte-row of W bytes as 16-byte words (8 bytes for
// the double instances' W 8).
template <int W>
__device__ __forceinline__ void store_strip(uint8_t* dst, const uint32_t (&acc)[W / 4]) {
  static_assert(W % 16 == 0 || W == 8, "a strip is stored as whole 16- or 8-byte words");
  if constexpr (W == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(acc[0], acc[1]);
  } else {
#pragma unroll
    for (int w = 0; w < W / 4; w += 4)
      reinterpret_cast<uint4*>(dst)[w / 4] = make_uint4(acc[w], acc[w + 1], acc[w + 2], acc[w + 3]);
  }
}

// The strip's W target chars as 16-byte words, t 16-byte aligned (0 for a
// thread past the columns, whose columns are never stored or latched).
template <int W>
__device__ __forceinline__ void load_chars(const int* t, bool active, int (&tc)[W]) {
#pragma unroll
  for (int k = 0; k < W; k += 4) {
    const int4 x = active ? *reinterpret_cast<const int4*>(t + k) : make_int4(0, 0, 0, 0);
    tc[k] = x.x;
    tc[k + 1] = x.y;
    tc[k + 2] = x.z;
    tc[k + 3] = x.w;
  }
}

}  // namespace
