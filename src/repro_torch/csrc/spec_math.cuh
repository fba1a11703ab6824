// The nodes of a generated K6 functor (repro_torch.stencil.spec_cuda) that
// torch runs by a kernel of several steps: floor division and remainder.
// Each computes what torch's CUDA kernel of the op computes, step by step,
// on f32 values (bf16 values widened exactly); R rounds to bf16 (`rpk`,
// cells.cuh) each step that torch takes in bf16 where the op is bf16 (only
// the result of the floor division by a number), so that with --fmad=false
// the functor equals torch's op on the card bitwise.
// The one-step nodes (the math functions, sigmoid, the powers, clamp) are
// emitted inline by the tracer. `chip_smoke.py` phase 54 holds every node
// against torch's op on the card over every bf16 operand pair and every
// f32 bit pattern (unary) or 2^28 random f32 pairs and the special values
// (binary), through a probe built from the same emitted code
// (`_build.load_probe`).
#pragma once

#include <cuda_runtime.h>

#include "cells.cuh"

// torch.remainder (`remainder_kernel_cuda`): the C fmod, moved into the
// divisor's sign where it differs; bf16 ops round once, where the functor
// rounds the node (fmod is exact, and rounding the sum once equals
// rounding the f32 sum that rounds first, f32 having 24 >= 2 * 8 + 2 bits)
__device__ __forceinline__ float k6_mod(float a, float b) {
  float mod = fmodf(a, b);
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) mod = mod + b;
  return mod;
}

// torch.floor_divide of two tensors, or of a number by a tensor
// (`div_floor_floating`): every step in f32 (the op's accumulate type, bf16
// operands widened), so a bf16 op rounds once, where the functor rounds
// the node. phase 54's probe found this over all 2^32 bf16 operand pairs:
// rounding each step to bf16 instead differs on 10,366,352 of them.
__device__ __forceinline__ float k6_fdiv(float a, float b) {
  if (b == 0.0f) return a / b;
  const float mod = fmodf(a, b);
  float div = (a - mod) / b;
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) div = div - 1.0f;
  float floordiv;
  if (div != 0.0f) {
    floordiv = floorf(div);
    if (div - floordiv > 0.5f) floordiv = floordiv + 1.0f;
  } else {
    floordiv = copysignf(0.0f, a / b);
  }
  return floordiv;
}

// torch.floor_divide of a tensor by a number (the CPU-scalar route of
// `div_floor_kernel_cuda`): the divisor b and its reciprocal inv_b in f32
// (the op's accumulate type), the steps in f32 but for the result, a value
// of the op's dtype: its floor rounds to bf16, and so does its +1
template <bool R>
__device__ __forceinline__ float k6_fdiv_scalar(float a, float b,
                                                float inv_b) {
  const float mod = fmodf(a, b);
  float div = (a - mod) * inv_b;
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) div = div - 1.0f;
  float floordiv;
  if (div != 0.0f) {
    floordiv = rpk<R>(floorf(div));
    if (div - floordiv > 0.5f) floordiv = rpk<R>(floordiv + 1.0f);
  } else {
    floordiv = copysignf(0.0f, a * inv_b);
  }
  return floordiv;
}
