// Periodic ring refresh of the padded carry, every wrap axis in one launch,
// for sm_90a.
//
// Replaces the TPU kernel repro/kernels/common.py:_refresh_wrap_halo, which
// ran inside the superstep kernel's first grid step and rewrote the source
// buffer in place: safe there because a TPU core walks its grid in order.
// CTAs run concurrently, so on the H100 the refresh is its own launch on
// the superstep's stream, before it.  Plain PyTorch version:
// repro_torch/kernels/common.py:refresh_wrap_halo_plain, the axis-ordered
// copies of common.wrap_copies.
//
// Those copies compose to one map: every shell cell (a cell whose
// coordinate on some wrap axis lies outside [H, H + n)) takes the interior
// cell at its per-axis wrapped coordinate (c + n below H, c - n at H + n
// and above), corners included.  On a layout that is not wrap-degenerate
// every source is interior and every destination in the shell, so one
// launch copies them all with no order among its cells.  The host
// (kernels/cuda.py:wrap_boxes) cuts the shell into boxes: slab d is ring
// on wrap axis d, interior on the wrap axes before it and full on the axes
// after it; a slab splits into boxes on which the shift between source and
// destination is constant (the ring's two sides on axis d, and on every
// later wrap axis the low ring, the interior and the high ring).
//
// What bounds it: bytes.  It moves O(surface) cells, a read and a write
// each, with no arithmetic; at the paper's shapes that is a few MB, so
// the launch is short and its fixed cost dominates, which is why it is one
// launch per refresh and not one per axis.  Each CTA copies part of one
// box (found with one barrier, each thread testing one row): consecutive
// threads take consecutive cells of a row, 16 bytes each (kVecCells cells)
// where the box's rows are 16-byte aligned on both sides, else one cell.
// The copy moves the grid's cells as they are, in its dtype (one library
// per dtype, kernels/build.py).

#include <cuda_runtime.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 2;  // items of a box per thread

// One box per row of the host array (kernels/cuda.py:wrap_rows).
enum BoxField {
  kFirst,   // first CTA of the box
  kCount,   // items: batch x e0 x e1 x ex
  kLo0,     // destination origin (axes 0, 1, 2 of the padded grid)
  kLo1,
  kLo2,
  kE0,      // extent on axes 0 and 1
  kE1,
  kEx,      // items along axis 2 (cells, or 16-byte vectors)
  kDelta,   // source index - destination index
  kVec,     // 1: an item is kVecCells cells, 16-byte aligned on both sides
  kBoxFields
};

__global__ void __launch_bounds__(kThreads)
wrap_halo_kernel(elem* __restrict__ buf, const long long* __restrict__ boxes,
                 int nbox, long long P0, long long P1, long long P2) {
  // the CTA's box: the last whose first CTA is at or before this one (box
  // 0 starts at CTA 0), one row per thread and one barrier
  const int k = __syncthreads_count(
                    (int)threadIdx.x < nbox &&
                    (long long)blockIdx.x >=
                        boxes[threadIdx.x * kBoxFields + kFirst]) -
                1;
  const long long* b = boxes + k * kBoxFields;
  const unsigned count = (unsigned)b[kCount];
  const unsigned e0 = (unsigned)b[kE0], e1 = (unsigned)b[kE1];
  const unsigned ex = (unsigned)b[kEx];
  const long long lo0 = b[kLo0], lo1 = b[kLo1], lo2 = b[kLo2];
  const long long delta = b[kDelta];
  const bool vec = b[kVec] != 0;
  unsigned i = ((unsigned)blockIdx.x - (unsigned)b[kFirst]) *
                   (kThreads * kPerThread) +
               threadIdx.x;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j, i += kThreads) {
    if (i >= count) return;
    const unsigned x = i % ex;
    unsigned t = i / ex;
    const unsigned y = t % e1;
    t /= e1;
    const unsigned z = t % e0;
    const unsigned bi = t / e0;
    const long long at =
        ((bi * P0 + lo0 + z) * P1 + lo1 + y) * P2 + lo2 +
        (vec ? kVecCells * x : x);
    if (vec)
      *reinterpret_cast<float4*>(buf + at) =
          *reinterpret_cast<const float4*>(buf + at + delta);
    else
      buf[at] = buf[at + delta];
  }
}

}  // namespace

extern "C" {

const char* wrap_halo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Refresh every wrap axis of `buf`, viewed as (P0, P1, P2) padded cells per
// batch entry (a 2D grid has P0 = 1), in one launch of `blocks` CTAs over
// the `nbox` rows of the device array `boxes` (BoxField); returns a
// cudaError_t (0 on success).
int wrap_halo_launch(void* buf, const void* boxes, int nbox, int blocks,
                     long long P0, long long P1, long long P2, int device,
                     void* stream) {
  if (nbox < 1 || nbox > kThreads || blocks < 1)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  wrap_halo_kernel<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<elem*>(buf), static_cast<const long long*>(boxes), nbox,
      P0, P1, P2);
  return cudaGetLastError();
}

}  // extern "C"
