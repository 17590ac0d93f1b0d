// Block-wide scans, reductions and the byte-row store shared by the DP fills
// (blocked_fill.cu, banded_fill.cu). Each fill
// runs one CTA per pair (the blocked fills one per pair and column block)
// and needs, once per row, the exclusive prefix of its threads' strip
// reductions (the in-row chain) and block-wide maxima / minima (start info).
// Warps scan with shuffles; one shared-memory round joins the warps.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -INFINITY;

struct MaxF {
  __device__ static float op(float a, float b) { return fmaxf(a, b); }
};
struct MinI {
  __device__ static int op(int a, int b) { return min(a, b); }
};

// Exclusive prefix over the block's threads (in thread order) of NV values
// each, combined with `seed`, and, where `total` is given, the block-wide
// combine of each value without the seed. One __syncthreads(); the caller
// syncs again before `tot` is reused. Without `total` a thread combines only
// the warps before its own, as the score fills need.
template <class Op, class T, int NV>
__device__ __forceinline__ void block_exclusive(T (&v)[NV], const T (&seed)[NV], T* total,
                                                T (&tot)[NV][32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T below[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    T x = v[c];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x = Op::op(x, y);
    }
    if (lane == 31) tot[c][warp] = x;
    below[c] = __shfl_up_sync(0xffffffffu, x, 1);
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    T p = seed[c];
    if (total) {
      T all = tot[c][0];
      for (int w = 0; w < nw; ++w) {
        if (w < warp) p = Op::op(p, tot[c][w]);
        if (w > 0) all = Op::op(all, tot[c][w]);
      }
      total[c] = all;
    } else {
      for (int w = 0; w < warp; ++w) p = Op::op(p, tot[c][w]);
    }
    v[c] = lane > 0 ? Op::op(p, below[c]) : p;
  }
}

template <class Op, class T, int NV>
__device__ __forceinline__ void block_exclusive(T (&v)[NV], const T (&seed)[NV],
                                                T (&tot)[NV][32]) {
  block_exclusive<Op, T, NV>(v, seed, nullptr, tot);
}

// Block-wide reduction; the result is valid in every thread. One
// __syncthreads(); `red` is used at most once between two barriers.
template <class Op, class T>
__device__ __forceinline__ T block_reduce(T v, T (&red)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = Op::op(v, __shfl_xor_sync(0xffffffffu, v, d));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = Op::op(r, red[w]);
  return r;
}

// NV reductions behind one __syncthreads(); each result replaces its value
// in every thread.
template <class Op, class T, int NV>
__device__ __forceinline__ void block_reduce(T (&v)[NV], T (&red)[NV][32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v[c] = Op::op(v[c], __shfl_xor_sync(0xffffffffu, v[c], d));
    if (lane == 0) red[c][warp] = v[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    T r = red[c][0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = Op::op(r, red[c][w]);
    v[c] = r;
  }
}

// Store a staged byte-row of `bytes` (a multiple of 16) as 16-byte words.
__device__ __forceinline__ void store_row(const uint8_t* stage, uint8_t* dst, int bytes) {
  const uint4* s = reinterpret_cast<const uint4*>(stage);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int w = threadIdx.x; w < bytes / 16; w += blockDim.x) d[w] = s[w];
}

}  // namespace
