// Complex float2 arithmetic and the row modes shared by every slice-step
// kernel (fused_step.cu, fused_step_odd.cu, resident.cu, the adjoint's).

#pragma once

#include <cuda_runtime.h>

namespace {

enum RowMode { kFirst = 0, kMid = 1, kLast = 2, kOnly = 3 };

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

}  // namespace
