// The grid's element type of a build, and the arithmetic on it.
//
// kernels/build.py compiles each source once per grid dtype, with
// -DREPRO_DTYPE=0 (float32), 1 (bfloat16) or 2 (float16), into a library
// of its own.  Global memory and the shared-memory rings hold `elem`, as
// the TPU kernels' VMEM windows hold the grid's dtype
// (repro/kernels/common.py:_superstep_pallas, _padded_superstep_pallas);
// cp.async and cp.async.bulk copy bytes and cannot convert.
//
// Every output is acc = c0*v0, then acc = acc + ck*vk in the canonical tap
// order, each multiply and each add rounded to the grid's dtype, with no
// FMA contraction.  That is what PyTorch's eager kernels do for a 16-bit
// tensor (an operation computes in float and rounds its result), so a
// kernel equals its plain version (repro_torch/kernels/common.py) bit for
// bit in every dtype.
//
// The superstep bodies compute in lanes.  In float32 a lane is one cell
// and lmul/ladd are __fmul_rn/__fadd_rn.  In 16 bits a lane is two cells
// in one 32-bit register (__nv_bfloat162, __half2) and lmul/ladd are
// __hmul2_rn/__hadd2_rn: one instruction for two cells, no conversion.
// They equal the plain version's float-then-round operations: a product
// of two 16-bit values is exact in float (2p <= 24 bits, p = 8 for
// bfloat16, 11 for float16), so rounding it once to 16 bits is the
// correctly rounded product; a sum rounded to float and then to 16 bits
// is the correctly rounded sum, since 24 >= 2p + 2 makes the double
// rounding innocuous; where a bfloat16 product falls below float's
// normal range, float's rounding can only land on the one 16-bit
// midpoint there, 2^-134, from below, and both then round it to 0.  The
// _rn forms are never contracted into an FMA.  The card tests hold this
// on subnormals, rounding ties, signed zeros, infinities, NaN and
// overflow (tests/test_torch_cuda.py, the 16-bit edge cases).
// Coefficients come as a bank of (c, c) pairs (kernels/cuda.py:
// coefficient_bank), so a lane is multiplied by one coefficient.
//
// mul_r/add_r, the float path with a rounding after each operation, is
// left to the flat path of the streamed body (any tap set), whose outputs
// are not paired.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstring>

#ifndef REPRO_DTYPE
#define REPRO_DTYPE 0
#endif

#if REPRO_DTYPE == 1
using elem = __nv_bfloat16;
using lane = __nv_bfloat162;
__device__ __forceinline__ float to_f(elem v) { return __bfloat162float(v); }
__device__ __forceinline__ elem to_e(float v) {
  return __float2bfloat16_rn(v);
}
#elif REPRO_DTYPE == 2
using elem = __half;
using lane = __half2;
__device__ __forceinline__ float to_f(elem v) { return __half2float(v); }
__device__ __forceinline__ elem to_e(float v) { return __float2half_rn(v); }
#elif REPRO_DTYPE == 0
using elem = float;
using lane = float;
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_e(float v) { return v; }
#else
#error "REPRO_DTYPE is 0 (float32), 1 (bfloat16) or 2 (float16)"
#endif

// Cells of one 16-byte copy: 4 in float32, 8 in 16 bits.
constexpr int kVecCells = 16 / (int)sizeof(elem);
// Cells of one lane: 1 in float32, 2 in 16 bits.
constexpr int kLaneCells = (int)(sizeof(lane) / sizeof(elem));

// `x` rounded to the element type, as a float (exact).
__device__ __forceinline__ float rnd(float x) { return to_f(to_e(x)); }

// c * v and a + b, each rounded to the element type.
__device__ __forceinline__ float mul_r(float c, float v) {
  return rnd(__fmul_rn(c, v));
}
__device__ __forceinline__ float add_r(float a, float b) {
  return rnd(__fadd_rn(a, b));
}

// ---- lanes ---------------------------------------------------------------

// One entry of a coefficient bank as the host writes it (kernels/cuda.py:
// coefficient_bank): a float in float32, the bits of a (c, c) pair in 16
// bits.
#if REPRO_DTYPE == 0
using coef_t = float;
#else
using coef_t = unsigned;
#endif

__device__ __forceinline__ unsigned lane_bits(lane a) {
  unsigned u;
  memcpy(&u, &a, sizeof(u));
  return u;
}

__device__ __forceinline__ lane bits_lane(unsigned u) {
  lane a;
  memcpy(&a, &u, sizeof(a));
  return a;
}

// A bank entry as a lane, and as the float the flat path takes.
__device__ __forceinline__ lane coef_lane(coef_t c) {
#if REPRO_DTYPE == 0
  return c;
#else
  return bits_lane(c);
#endif
}

__device__ __forceinline__ float coef_float(coef_t c) {
#if REPRO_DTYPE == 0
  return c;
#else
  return to_f(bits_lane(c).x);
#endif
}

// c * v and a + b of each cell of a lane, rounded to the element type.
__device__ __forceinline__ lane lmul(lane c, lane v) {
#if REPRO_DTYPE == 0
  return mul_r(c, v);
#else
  return __hmul2_rn(c, v);
#endif
}

__device__ __forceinline__ lane ladd(lane a, lane b) {
#if REPRO_DTYPE == 0
  return add_r(a, b);
#else
  return __hadd2_rn(a, b);
#endif
}

// Every cell of a lane = `v` (a value of the element type).
__device__ __forceinline__ lane splat(elem v) {
#if REPRO_DTYPE == 0
  return v;
#else
  lane a;
  a.x = v;
  a.y = v;
  return a;
#endif
}

// The lane of cells (a, b).
__device__ __forceinline__ lane pair(elem a, elem b) {
#if REPRO_DTYPE == 0
  (void)b;
  return a;
#else
  lane l;
  l.x = a;
  l.y = b;
  return l;
#endif
}

// Cell i of a run of lanes, read and written.
__device__ __forceinline__ elem cell(const lane* l, int i) {
#if REPRO_DTYPE == 0
  return l[i];
#else
  return (i & 1) ? l[i >> 1].y : l[i >> 1].x;
#endif
}

__device__ __forceinline__ void set_cell(lane* l, int i, elem v) {
#if REPRO_DTYPE == 0
  l[i] = v;
#else
  if (i & 1)
    l[i >> 1].y = v;
  else
    l[i >> 1].x = v;
#endif
}

// The lane starting at cell k of a run of lanes: in 16 bits an odd k
// straddles two lanes, joined by one byte permute.
__device__ __forceinline__ lane lane_at(const lane* l, int k) {
#if REPRO_DTYPE == 0
  return l[k];
#else
  if (k & 1)
    return bits_lane(__byte_perm(lane_bits(l[k >> 1]),
                                 lane_bits(l[(k >> 1) + 1]), 0x5432));
  return l[k >> 1];
#endif
}

// Four consecutive cells as lanes (4 floats, or 2 pairs in 16 bits) and
// back: one 16-byte access in float32, one 8-byte access in 16 bits (`p`
// aligned to it).
constexpr int kStripLanes = 4 / kLaneCells;

struct alignas(4 * sizeof(elem)) lane4 {
  lane l[kStripLanes];
};

__device__ __forceinline__ void ld_lanes(const elem* p, lane* out) {
#if REPRO_DTYPE == 0
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x, out[1] = f.y, out[2] = f.z, out[3] = f.w;
#else
  const lane4 q = *reinterpret_cast<const lane4*>(p);
  out[0] = q.l[0], out[1] = q.l[1];
#endif
}

__device__ __forceinline__ void st_lanes(elem* p, const lane* in) {
#if REPRO_DTYPE == 0
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
#else
  lane4 q;
  q.l[0] = in[0], q.l[1] = in[1];
  *reinterpret_cast<lane4*>(p) = q;
#endif
}
