// Periodic ring refresh of the padded carry along one axis, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/common.py:_refresh_wrap_halo, which
// ran inside the superstep kernel's first grid step and rewrote the source
// buffer in place: safe there because a TPU core walks its grid in order.
// CTAs run concurrently, so on the H100 the refresh is its own launch on
// the superstep's stream, before it, one launch per wrap axis in axis order
// (the other axes span their full padded extent, so corners compose as a
// periodic pad does).  Plain PyTorch version:
// repro_torch/kernels/common.py:refresh_wrap_halo_plain.
//
// One launch executes the two RingCopy records of an axis (lo ring, then hi
// slack plus ring, see common.wrap_copies).  Their source and destination
// intervals are pairwise disjoint on a layout that is not wrap-degenerate,
// so both share the launch and no cell is read after it is written.
//
// What bounds it: bytes.  It moves O(surface) cells, a read and a write
// each, with no arithmetic; at the paper's shapes that is a few hundred KB
// per axis, so a launch is short and its fixed cost dominates.  The design
// is a grid-stride copy with 64-bit indices over (outer, cell, inner),
// where inner is contiguous in memory, so neighbouring threads touch
// neighbouring addresses on every axis but the last.

#include <cuda_runtime.h>

namespace {

__global__ void wrap_halo_kernel(float* buf, long long outer, long long Pd,
                                 long long inner, long long lo_src,
                                 long long lo_dst, long long lo_width,
                                 long long hi_src, long long hi_dst,
                                 long long hi_width) {
  const long long cells = lo_width + hi_width;
  const long long total = outer * cells * inner;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long i = e % inner;
    const long long rest = e / inner;
    const long long j = rest % cells;
    const long long o = rest / cells;
    const bool lo = j < lo_width;
    const long long s = lo ? lo_src + j : hi_src + (j - lo_width);
    const long long d = lo ? lo_dst + j : hi_dst + (j - lo_width);
    buf[(o * Pd + d) * inner + i] = buf[(o * Pd + s) * inner + i];
  }
}

}  // namespace

extern "C" {

const char* wrap_halo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Refresh one wrap axis of `buf`, viewed as (outer, Pd, inner); returns a
// cudaError_t (0 on success).  Intervals are in padded cells along the axis.
int wrap_halo_launch(void* buf, long long outer, long long Pd,
                     long long inner, long long lo_src, long long lo_dst,
                     long long lo_width, long long hi_src, long long hi_dst,
                     long long hi_width, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int threads = 256;
  const long long total = outer * (lo_width + hi_width) * inner;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65536) blocks = 65536;
  if (blocks < 1) blocks = 1;
  wrap_halo_kernel<<<(unsigned)blocks, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(buf), outer, Pd, inner, lo_src, lo_dst, lo_width,
      hi_src, hi_dst, hi_width);
  return cudaGetLastError();
}

}  // extern "C"
