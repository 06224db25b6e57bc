// One-shot pre-padded superstep kernel, for sm_90a: one CTA per output
// tile (device code in superstep_common.cuh).
//
// superstep_launch replaces the TPU kernel
// repro/kernels/common.py:build_superstep_kernel (`:181`, launched by
// _superstep_pallas at `:362`): one superstep of a grid that boundary_pad
// already padded by h.  Window at the tile origin, no t = 0 fixup, fixups
// between steps at global coordinates offs + origin - h + t*r (offs, the
// shard origin, is a launch argument), and every cell of the rounded
// output is stored into a separate grid.  Plain version:
// repro_torch/kernels/common.py:superstep_plain.
//
// What bounds it on the H100.  At the paper's shapes the minimal traffic
// (one read of the padded source, one write of the output) is about three
// times the FP32 work at the data-sheet rates, so device memory is the
// bound; inside the CTA every tap is a shared-memory read, so shared-memory
// bandwidth is the next limit.  The design keeps the fused steps' data in
// shared memory (one device-memory round trip per superstep, as on the TPU)
// and takes the CTA tile from the wrapper (kernels/cuda.py), which sizes it
// by the opt-in shared-memory limit: a TPU block of 1024x1024 needs
// megabytes, a CTA window at most 227 KB.  The padded carry (B1) and the
// pipelined pre-padded superstep (B6) stream planes instead:
// queued_superstep.cu.

#include "superstep_common.cuh"

namespace {

using namespace superstep;

__global__ void __launch_bounds__(kThreads)
superstep_kernel(const float* __restrict__ src, float* __restrict__ dst,
                 const float* __restrict__ coef, const int* __restrict__ offs,
                 int ntaps, int steps, int boundary, float bval, Geometry g) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + g.wvol;  // second buffer, present only when steps > 1
  float* s_coef = smem + (steps > 1 ? 2 : 1) * g.wvol;
  int* s_lin = reinterpret_cast<int*>(s_coef + ntaps);

  load_tables(coef, offs, ntaps, g, s_coef, s_lin);
  const Tile t = tile_of(g, blockIdx.x);
  load_window(src, cur, g, t);
  __syncthreads();
  fused_steps(cur, nxt, s_coef, s_lin, ntaps, steps, boundary, bval, g, t,
              dst);
}

}  // namespace

extern "C" {

const char* padded_superstep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Runs one launch on `stream` and returns a cudaError_t (0 on success).
// `geometry` is the host array of superstep_common.cuh:Field, `steps` the
// fused steps, `coef`/`offs` the device tap tables.
int superstep_launch(const void* src, void* dst, const void* coef,
                     const void* offs, int ntaps, int steps, int boundary,
                     float bval, const long long* geometry, int batch,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Geometry g;
  if (!make_geometry(geometry, steps, batch, &g))
    return cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(g, steps > 1 ? 2 : 1, ntaps);
  err = cudaFuncSetAttribute(superstep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  superstep_kernel<<<(unsigned)g.total, dim3(kThreadsX, kThreadsY), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst),
      static_cast<const float*>(coef), static_cast<const int*>(offs), ntaps,
      steps, boundary, bval, g);
  return cudaGetLastError();
}

}  // extern "C"
