// Chained max+add ceiling probe for Hopper (sm_90a): the counterpart of the
// three Pallas kernels of tools/vpu_probe.py, vmem_ceiling (:77, one
// dependent chain), roofline_ops_per_sec (:124) and vpu_roofline (:177)
// (WIDTH independent chains). They share one body, and so does this file:
//
//   every element e of the flat (a, b) starts WIDTH chains y_w = b + w
//   (y = b when WIDTH is 1, as vmem_ceiling starts from b), runs `chain`
//   links of y = max(y + a, b) - a on each, and stores
//   y_0 + y_1 + ... + y_{WIDTH-1}, summed in that order, in e's dtype.
//
// Each thread owns its elements (grid-stride over the flat size), loads a
// and b once (and a again, see Folding) and keeps the chains in registers;
// nothing but the one store touches memory. Per element every form computes exactly the JAX body:
//   f32            FADD, FMNMX, FADD
//   i32            IADD3, IMNMX, IADD3 (adds wrap, as the plain version's)
//   i32 dpx        __viaddmax_s32(y, a, b) - a: one fused add-max, one add
//   i16            scalar short, each result wrapped to 16 bits
//   i16 dpx (x2)   __viaddmax_s16x2 and __vsub2 on packed pairs
//   bf16 (x2)      __hadd2, __hmax2, __hsub2 on __nv_bfloat162
//   f64            DADD, a double max (DSETP.MAX with selects, or DMNMX),
//                  DADD: the double instances' arithmetic
// The packed forms take two elements a 32-bit word (4-byte aligned
// pointers); an odd count's last element runs the scalar form of its dtype
// in one thread.
//
// What bounds it on this card: issue. An SM's four schedulers issue one
// warp instruction a clock each, 128 lanes an SM a clock, which is the FP32
// rate (FADD); integer and min/max instructions may issue at a lower rate
// (the INT32 lanes are 64 an SM), which is what the probe measures. A fused
// add-max does two ops an instruction and a packed pair twice that. With
// WIDTH 1 each thread has one dependent chain, so the ALU latency (about 4
// clocks a link's step) bounds it at the JAX shapes' ~8 warps an SM; WIDTH 8
// gives each warp 8 independent chains (ILP 8), enough to saturate issue.
//
// Folding: in wrapping integer arithmetic one link's "- a" and the next
// link's "+ a" cancel, leaving y = max(y, b) a link, and max(y + a, b) - a
// equals max(y, b - a) where overflow is undefined. ptxas cancels the first
// even through empty asm statements (one VIADDMNMX a link, no subtract). So
// each thread loads a twice, once through a volatile pointer, and
// subtracts the second copy: no compiler can prove the two equal, and no
// algebra survives. chip_smoke.py reads each instantiation's chain loops in
// the SASS (cuobjdump -sass) and fails one with fewer than three adds,
// subtracts and maxes a max, or fewer than 4 * WIDTH maxes (the unroll
// below); its guard fails a rate above the issue ceiling.

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

// v reloaded through a volatile pointer: a value equal to *p that the
// compiler cannot prove equal to another load of it
template <class V>
__device__ __forceinline__ V reload(const V* p) {
  static_assert(sizeof(V) == 8 || sizeof(V) == 4 || sizeof(V) == 2,
                "64-, 32- or 16-bit values");
  V v;
  if constexpr (sizeof(V) == 8) {
    const unsigned long long u = *reinterpret_cast<const volatile unsigned long long*>(p);
    memcpy(&v, &u, 8);
  } else if constexpr (sizeof(V) == 4) {
    const unsigned u = *reinterpret_cast<const volatile unsigned*>(p);
    memcpy(&v, &u, 4);
  } else {
    const unsigned short u = *reinterpret_cast<const volatile unsigned short*>(p);
    memcpy(&v, &u, 2);
  }
  return v;
}

__device__ __forceinline__ int wrap_add(int x, int y) {
  return (int)((unsigned)x + (unsigned)y);
}
__device__ __forceinline__ int wrap_sub(int x, int y) {
  return (int)((unsigned)x - (unsigned)y);
}

// One form each: E the element, V what a register holds (E, or a packed
// pair), PACK elements a V, Tail the scalar form for an odd count's last
// element.
struct F32 {
  using E = float;
  using V = float;
  static constexpr int PACK = 1;
  __device__ static V splat(int w) { return (float)w; }
  __device__ static V add(V x, V y) { return x + y; }
  __device__ static V link(V y, V a, V b, V s) {
    return fmaxf(y + a, b) - s;
  }
};

// the double instances' type (csrc/ptr_fill.cu, blocked_fill.cu): DADD
// and a double max
struct F64 {
  using E = double;
  using V = double;
  static constexpr int PACK = 1;
  __device__ static V splat(int w) { return (double)w; }
  __device__ static V add(V x, V y) { return x + y; }
  __device__ static V link(V y, V a, V b, V s) {
    return fmax(y + a, b) - s;
  }
};

struct I32 {
  using E = int;
  using V = int;
  static constexpr int PACK = 1;
  __device__ static V splat(int w) { return w; }
  __device__ static V add(V x, V y) { return wrap_add(x, y); }
  __device__ static V link(V y, V a, V b, V s) {
    return wrap_sub(max(wrap_add(y, a), b), s);
  }
};

struct I32Dpx : I32 {
  __device__ static V link(V y, V a, V b, V s) {
    return wrap_sub(__viaddmax_s32(y, a, b), s);
  }
};

struct I16 {
  using E = short;
  using V = short;
  static constexpr int PACK = 1;
  __device__ static V splat(int w) { return (short)w; }
  __device__ static V add(V x, V y) { return (short)(x + y); }
  __device__ static V link(V y, V a, V b, V s) {
    const short t = (short)(y + a);
    return (short)((t > b ? t : b) - s);
  }
};

struct I16x2Dpx {
  using E = short;
  using V = unsigned;
  using Tail = I16;
  static constexpr int PACK = 2;
  __device__ static V splat(int w) {
    return ((unsigned)w & 0xffffu) | ((unsigned)w << 16);
  }
  __device__ static V add(V x, V y) { return __vadd2(x, y); }
  __device__ static V link(V y, V a, V b, V s) {
    return __vsub2(__viaddmax_s16x2(y, a, b), s);
  }
};

struct BF16 {  // BF16x2's tail only
  using E = __nv_bfloat16;
  using V = __nv_bfloat16;
  __device__ static V splat(int w) { return __float2bfloat16((float)w); }
  __device__ static V add(V x, V y) { return __hadd(x, y); }
  __device__ static V link(V y, V a, V b, V s) {
    return __hsub(__hmax(__hadd(y, a), b), s);
  }
};

struct BF16x2 {
  using E = __nv_bfloat16;
  using V = __nv_bfloat162;
  using Tail = BF16;
  static constexpr int PACK = 2;
  __device__ static V splat(int w) { return __float2bfloat162_rn((float)w); }
  __device__ static V add(V x, V y) { return __hadd2(x, y); }
  __device__ static V link(V y, V a, V b, V s) {
    return __hsub2(__hmax2(__hadd2(y, a), b), s);
  }
};

// The JAX body on one register's worth of elements; s is a, reloaded.
template <class Op, int WIDTH>
__device__ __forceinline__ typename Op::V run(typename Op::V a,
                                              typename Op::V b,
                                              typename Op::V s, int chain) {
  typename Op::V y[WIDTH];
  if (WIDTH == 1) {
    y[0] = b;
  } else {
#pragma unroll
    for (int w = 0; w < WIDTH; ++w) y[w] = Op::add(b, Op::splat(w));
  }
#pragma unroll 4
  for (int k = 0; k < chain; ++k) {
#pragma unroll
    for (int w = 0; w < WIDTH; ++w) y[w] = Op::link(y[w], a, b, s);
  }
  typename Op::V acc = y[0];
#pragma unroll
  for (int w = 1; w < WIDTH; ++w) acc = Op::add(acc, y[w]);
  return acc;
}

template <class Op, int WIDTH>
__global__ void __launch_bounds__(THREADS)
chain_kernel(const typename Op::E* __restrict__ a,
             const typename Op::E* __restrict__ b,
             typename Op::E* __restrict__ out, long long n, int chain) {
  using V = typename Op::V;
  const long long words = n / Op::PACK;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const V* av = reinterpret_cast<const V*>(a);
  const V* bv = reinterpret_cast<const V*>(b);
  V* ov = reinterpret_cast<V*>(out);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < words; i += stride)
    ov[i] = run<Op, WIDTH>(av[i], bv[i], reload(av + i), chain);
  if constexpr (Op::PACK == 2) {
    if ((n & 1) && blockIdx.x == 0 && threadIdx.x == 0)
      out[n - 1] = run<typename Op::Tail, WIDTH>(a[n - 1], b[n - 1],
                                                 reload(a + n - 1), chain);
  }
}

template <class Op, int WIDTH>
cudaError_t launch(const void* a, const void* b, void* out, long long n,
                   int chain, cudaStream_t stream) {
  using E = typename Op::E;
  const long long words = n / Op::PACK;
  long long blocks = (words + THREADS - 1) / THREADS;
  blocks = blocks < 1 ? 1 : (blocks > (1 << 20) ? (1 << 20) : blocks);
  chain_kernel<Op, WIDTH><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const E*>(a), static_cast<const E*>(b), static_cast<E*>(out),
      n, chain);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 int32, 2 int16, 3 bfloat16, 4 float64; form: 0
// plain, 1 dpx, 2 x2 (packed pairs); width 1 or 8. The ten instantiated
// variants: f32/1, f32/8, i32/1, i32/8, i32 dpx/8, i16/1, i16/8, i16
// dpx/8, bf16 x2/8, f64/8. Anything else is refused with
// cudaErrorInvalidValue.
cudaError_t at_vpu_chain(int dtype, int form, int width, const void* a,
                         const void* b, void* out, long long n, int chain,
                         cudaStream_t stream) {
  if (n < 0 || chain < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int key = dtype * 100 + form * 10 + width;
  switch (key) {
    case 1: return launch<F32, 1>(a, b, out, n, chain, stream);
    case 8: return launch<F32, 8>(a, b, out, n, chain, stream);
    case 101: return launch<I32, 1>(a, b, out, n, chain, stream);
    case 108: return launch<I32, 8>(a, b, out, n, chain, stream);
    case 118: return launch<I32Dpx, 8>(a, b, out, n, chain, stream);
    case 201: return launch<I16, 1>(a, b, out, n, chain, stream);
    case 208: return launch<I16, 8>(a, b, out, n, chain, stream);
    case 218: return launch<I16x2Dpx, 8>(a, b, out, n, chain, stream);
    case 328: return launch<BF16x2, 8>(a, b, out, n, chain, stream);
    case 408: return launch<F64, 8>(a, b, out, n, chain, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
