// What the DP fills share below their rows: the value type's -inf and the
// banded fill's block-wide maximum (banded_fill.cu; strip_row.cuh takes NEG
// from here).

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -INFINITY;

struct MaxF {
  __device__ static float op(float a, float b) { return fmaxf(a, b); }
};

}  // namespace
