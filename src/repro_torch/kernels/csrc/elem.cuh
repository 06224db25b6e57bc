// The grid's element type of a build, and the arithmetic on it.
//
// kernels/build.py compiles each source once per grid dtype, with
// -DREPRO_DTYPE=0 (float32), 1 (bfloat16) or 2 (float16), into a library
// of its own.  Global memory and the shared-memory rings hold `elem`, as
// the TPU kernels' VMEM windows hold the grid's dtype
// (repro/kernels/common.py:_superstep_pallas, _padded_superstep_pallas);
// cp.async and cp.async.bulk copy bytes and cannot convert.
//
// Arithmetic is in float, each multiply and each add rounded to `elem`
// (mul_r, add_r) in the canonical tap order, with no FMA contraction.
// That is what PyTorch's eager kernels do for a 16-bit tensor (an
// operation computes in float and rounds its result), so a kernel equals
// its plain version (repro_torch/kernels/common.py) bit for bit in every
// dtype.  A 16-bit product of two 16-bit values is exact in float, so
// mul_r rounds once.  The native __hmul/__hadd pairs are not used: their
// rounding sequence differs from the plain version's.  A float holds a
// 16-bit value exactly, so registers (the queues, the coefficients) keep
// floats.  For float32, rnd is the identity.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#ifndef REPRO_DTYPE
#define REPRO_DTYPE 0
#endif

#if REPRO_DTYPE == 1
using elem = __nv_bfloat16;
__device__ __forceinline__ float to_f(elem v) { return __bfloat162float(v); }
__device__ __forceinline__ elem to_e(float v) {
  return __float2bfloat16_rn(v);
}
#elif REPRO_DTYPE == 2
using elem = __half;
__device__ __forceinline__ float to_f(elem v) { return __half2float(v); }
__device__ __forceinline__ elem to_e(float v) { return __float2half_rn(v); }
#elif REPRO_DTYPE == 0
using elem = float;
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_e(float v) { return v; }
#else
#error "REPRO_DTYPE is 0 (float32), 1 (bfloat16) or 2 (float16)"
#endif

// Cells of one 16-byte copy: 4 in float32, 8 in 16 bits.
constexpr int kVecCells = 16 / (int)sizeof(elem);

// `x` rounded to the element type, as a float (exact).
__device__ __forceinline__ float rnd(float x) { return to_f(to_e(x)); }

// c * v and a + b, each rounded to the element type.
__device__ __forceinline__ float mul_r(float c, float v) {
  return rnd(__fmul_rn(c, v));
}
__device__ __forceinline__ float add_r(float a, float b) {
  return rnd(__fadd_rn(a, b));
}

// Four consecutive cells as floats and back: one 16-byte access in
// float32, one 8-byte access in 16 bits (`p` aligned to it).
struct alignas(4 * sizeof(elem)) elem4 {
  elem v[4];
};

__device__ __forceinline__ float4 ld4(const elem* p) {
#if REPRO_DTYPE == 0
  return *reinterpret_cast<const float4*>(p);
#else
  const elem4 q = *reinterpret_cast<const elem4*>(p);
  return make_float4(to_f(q.v[0]), to_f(q.v[1]), to_f(q.v[2]),
                     to_f(q.v[3]));
#endif
}

__device__ __forceinline__ void st4(elem* p, float4 f) {
#if REPRO_DTYPE == 0
  *reinterpret_cast<float4*>(p) = f;
#else
  elem4 q;
  q.v[0] = to_e(f.x), q.v[1] = to_e(f.y), q.v[2] = to_e(f.z);
  q.v[3] = to_e(f.w);
  *reinterpret_cast<elem4*>(p) = q;
#endif
}
