// Persistent, double-buffered pre-padded superstep kernel, for sm_90a
// (device code in superstep_common.cuh).
//
// pipelined_superstep_launch replaces the TPU kernel
// repro/kernels/common.py:build_pipelined_kernel: the pre-padded superstep
// of padded_superstep.cu:superstep_launch with the window of the next tile
// prefetched while the current one computes.  Plain PyTorch version:
// repro_torch/kernels/common.py:superstep_plain (prefetching changes no
// value).  The padded-carry sibling (build_padded_pipelined_kernel) streams
// planes instead: streamed_superstep.cu.
//
// The TPU kernels carry two VMEM windows across the sequential grid steps
// of one core and start block g+1's DMA before block g computes.  CTAs
// share nothing across a grid, so here the grid is persistent: min(tiles x
// batch, resident CTAs) blocks (the resident count from the occupancy API
// times the SM count), each walking lin = blockIdx.x, += gridDim.x.  Before
// it computes tile lin, a CTA issues cp.async copies of tile lin +
// gridDim.x into its other window (cells past the source's end are zeroed
// by plain stores), commits them, and waits only for the group of the
// current tile.
//
// What bounds it on the H100: as for padded_superstep.cu, device-memory
// bytes at the data-sheet rates and shared-memory reads inside the CTA.
// Prefetch hides the window load behind the fused steps, but the extra
// window costs shared memory, so fewer CTAs are resident per SM than for
// the one-shot kernel at the same tile.

#include "superstep_common.cuh"

namespace {

using namespace superstep;

__global__ void __launch_bounds__(kThreads)
pipelined_kernel(const float* __restrict__ src, float* __restrict__ dst,
                 const float* __restrict__ coef, const int* __restrict__ offs,
                 int ntaps, int steps, int boundary, float bval, Geometry g) {
  extern __shared__ float smem[];
  // windows 0 and 1 alternate; the third buffer is the steps' ping-pong
  // partner, present only when steps > 1
  float* partner = smem + 2 * g.wvol;
  float* s_coef = smem + (steps > 1 ? 3 : 2) * g.wvol;
  int* s_lin = reinterpret_cast<int*>(s_coef + ntaps);

  load_tables(coef, offs, ntaps, g, s_coef, s_lin);
  long long lin = blockIdx.x;
  load_window<true>(src, smem, g, tile_of(g, lin));
  __pipeline_commit();
  for (int p = 0; lin < g.total; lin += gridDim.x, p ^= 1) {
    const long long next = lin + gridDim.x;
    if (next < g.total)
      load_window<true>(src, smem + (p ^ 1) * g.wvol, g, tile_of(g, next));
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this tile's group has landed
    __syncthreads();
    float* cur = smem + p * g.wvol;
    const Tile t = tile_of(g, lin);
    fused_steps(cur, partner, s_coef, s_lin, ntaps, steps, boundary, bval, g,
                t, dst);
    __syncthreads();  // `cur` and `partner` are free for the next tiles
  }
}

int launch(const void* src, void* dst, const void* coef, const void* offs,
           int ntaps, int steps, int boundary, float bval,
           const long long* geometry, int batch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Geometry g;
  if (!make_geometry(geometry, steps, batch, &g))
    return cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(g, steps > 1 ? 3 : 2, ntaps);
  err = cudaFuncSetAttribute(pipelined_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pipelined_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long resident = (long long)per_sm * sms;
  const long long blocks = g.total < resident ? g.total : resident;
  pipelined_kernel<<<(unsigned)blocks, dim3(kThreadsX, kThreadsY),
                             smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst),
      static_cast<const float*>(coef), static_cast<const int*>(offs), ntaps,
      steps, boundary, bval, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pipelined_superstep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Runs one launch on `stream` and returns a cudaError_t (0 on success);
// arguments as in padded_superstep.cu.

int pipelined_superstep_launch(const void* src, void* dst, const void* coef,
                               const void* offs, int ntaps, int steps,
                               int boundary, float bval,
                               const long long* geometry, int batch,
                               int device, void* stream) {
  return launch(src, dst, coef, offs, ntaps, steps, boundary, bval,
                       geometry, batch, device, stream);
}

}  // extern "C"
