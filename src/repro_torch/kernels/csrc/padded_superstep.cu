// One superstep of the padded-carry stencil run, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/common.py:build_padded_superstep_kernel
// (launched by _padded_superstep_pallas).  Plain PyTorch version:
// repro_torch/kernels/common.py:padded_superstep_plain.
//
// What it computes.  `src` and `dst` hold the carry in padded layout: per
// spatial axis a ring of depth H, the true cells [H, H+n), round-up slack,
// and the hi ring, P cells in all, behind an optional batch axis.  One CTA
// produces one output tile of the true grid:
//   1. load the tile's halo'd window (tile + 2h per axis, h = steps*radius)
//      from `src` at ring offset H - h into shared memory;
//   2. t = 0 boundary fixup from global coordinates (clamp copies the border
//      slab axis by axis in increasing axis order, each axis reading the
//      already-fixed window; constant fills; periodic does nothing, its ring
//      was refreshed by wrap_halo.cu before this launch);
//   3. `steps` tap updates over a region that shrinks by `radius` per side
//      per step, ping-ponging two shared buffers, with a fixup between
//      steps; the last step writes the tile's true cells into `dst` at H.
// Taps and coefficients are runtime arrays (up to 729 for a 3D box of
// radius 4) in canonical order, the center first; the sum is taken in that
// order with __fmul_rn/__fadd_rn, so no multiply-add is contracted into an
// FMA and the result is bitwise that of the plain version's mul-then-add.
//
// What bounds it on the H100.  At the paper's shapes the minimal traffic
// (one read of the padded carry, one write of the interior) is about three
// times the FP32 work at the data-sheet rates, so device memory is the
// bound; inside the CTA every tap is a shared-memory read, so shared-memory
// bandwidth is the next limit.  The design keeps the fused steps' data in
// shared memory (one device-memory round trip per superstep, as on the TPU)
// and picks the CTA tile in the wrapper (kernels/cuda.py) from the
// opt-in shared-memory limit: a TPU block of 1024x1024 needs megabytes, a
// CTA window at most 227 KB.  A 2D grid runs as 3D with one z plane and no
// z halo.  Index arithmetic on the carry is 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

enum Boundary { kClamp = 0, kPeriodic = 1, kConstant = 2 };

struct Geometry {
  long long n[3];   // true extent, axis order (z, y, x)
  long long P[3];   // padded extent
  long long H[3];   // ring depth of the layout
  int h[3];         // halo of this superstep, steps * r[d]
  int r[3];         // shrink per step
  int tile[3];      // output tile of one CTA
  int win[3];       // tile + 2h
  int tiles_z;      // z tiles per grid: blockIdx.z = batch * tiles_z + tz
};

// Re-impose the boundary on window cells whose global coordinate lies
// outside [0, n) inside the region [lo, hi).  `start[d]` is the global
// coordinate of window index 0.  Every branch on an axis is uniform across
// the CTA, so the barriers are reached by all threads.
__device__ void boundary_fixup(float* buf, const Geometry& g, int boundary,
                               float bval, const int lo[3], const int hi[3],
                               const long long start[3]) {
  if (boundary == kPeriodic) return;
  const int W1 = g.win[1], W2 = g.win[2];
  const int nry = hi[1] - lo[1];
  const int rows = (hi[0] - lo[0]) * nry;
  for (int d = 0; d < 3; ++d) {
    if (start[d] + lo[d] >= 0 && start[d] + hi[d] <= g.n[d]) continue;
    // window index of the border cells along d (clamp)
    const int first = (int)(-start[d]);
    const int last = (int)(g.n[d] - 1 - start[d]);
    for (int q = threadIdx.y; q < rows; q += kThreadsY) {
      int i[3] = {lo[0] + q / nry, lo[1] + q % nry, 0};
      for (int ix = lo[2] + threadIdx.x; ix < hi[2]; ix += kThreadsX) {
        i[2] = ix;
        const long long pos = start[d] + i[d];
        if (pos >= 0 && pos < g.n[d]) continue;
        const int at = (i[0] * W1 + i[1]) * W2 + i[2];
        if (boundary == kConstant) {
          buf[at] = bval;
          continue;
        }
        int j[3] = {i[0], i[1], i[2]};
        j[d] = pos < 0 ? first : last;
        buf[at] = buf[(j[0] * W1 + j[1]) * W2 + j[2]];
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
padded_superstep_kernel(const float* __restrict__ src, float* __restrict__ dst,
                        const float* __restrict__ coef,
                        const int* __restrict__ offs, int ntaps, int steps,
                        int boundary, float bval, Geometry g) {
  extern __shared__ float smem[];
  const int W0 = g.win[0], W1 = g.win[1], W2 = g.win[2];
  const int wvol = W0 * W1 * W2;
  float* cur = smem;
  float* nxt = smem + wvol;  // second buffer, present only when steps > 1
  float* s_coef = smem + (steps > 1 ? 2 : 1) * wvol;
  int* s_lin = reinterpret_cast<int*>(s_coef + ntaps);

  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int nthreads = kThreadsX * kThreadsY;
  for (int k = tid; k < ntaps; k += nthreads) {
    s_coef[k] = coef[k];
    s_lin[k] = (offs[3 * k] * W1 + offs[3 * k + 1]) * W2 + offs[3 * k + 2];
  }

  const int b = blockIdx.z / g.tiles_z;
  const long long origin[3] = {
      (long long)(blockIdx.z % g.tiles_z) * g.tile[0],
      (long long)blockIdx.y * g.tile[1], (long long)blockIdx.x * g.tile[2]};
  const long long plane = g.P[1] * g.P[2];
  const long long base = (long long)b * g.P[0] * plane;
  long long start[3];
  for (int d = 0; d < 3; ++d) start[d] = origin[d] - g.h[d];

  // 1. window load; cells past the buffer's end feed no true output
  for (int q = threadIdx.y; q < W0 * W1; q += kThreadsY) {
    const long long pz = g.H[0] + start[0] + q / W1;
    const long long py = g.H[1] + start[1] + q % W1;
    const bool row_ok = pz < g.P[0] && py < g.P[1];
    const long long row = base + pz * plane + py * g.P[2];
    for (int ix = threadIdx.x; ix < W2; ix += kThreadsX) {
      const long long px = g.H[2] + start[2] + ix;
      cur[q * W2 + ix] = (row_ok && px < g.P[2]) ? src[row + px] : 0.0f;
    }
  }
  __syncthreads();

  // 2. t = 0 fixup over the whole window
  {
    const int lo[3] = {0, 0, 0};
    const int hi[3] = {W0, W1, W2};
    boundary_fixup(cur, g, boundary, bval, lo, hi, start);
  }

  // 3. fused steps over the shrinking region
  for (int t = 1; t <= steps; ++t) {
    int lo[3], hi[3];
    for (int d = 0; d < 3; ++d) {
      lo[d] = t * g.r[d];
      hi[d] = g.win[d] - t * g.r[d];
    }
    const int nry = hi[1] - lo[1];
    const int rows = (hi[0] - lo[0]) * nry;
    const bool last = t == steps;
    for (int q = threadIdx.y; q < rows; q += kThreadsY) {
      const int iz = lo[0] + q / nry;
      const int iy = lo[1] + q % nry;
      // global true coordinates of this row (used by the last step)
      const long long gz = origin[0] + iz - g.h[0];
      const long long gy = origin[1] + iy - g.h[1];
      const long long out_row =
          base + (g.H[0] + gz) * plane + (g.H[1] + gy) * g.P[2] + g.H[2];
      const bool row_true = gz < g.n[0] && gy < g.n[1];
      for (int ix = lo[2] + threadIdx.x; ix < hi[2]; ix += kThreadsX) {
        const int at = (iz * W1 + iy) * W2 + ix;
        float acc = __fmul_rn(s_coef[0], cur[at + s_lin[0]]);
        for (int k = 1; k < ntaps; ++k)
          acc = __fadd_rn(acc, __fmul_rn(s_coef[k], cur[at + s_lin[k]]));
        if (!last) {
          nxt[at] = acc;
        } else {
          const long long gx = origin[2] + ix - g.h[2];
          if (row_true && gx < g.n[2]) dst[out_row + gx] = acc;
        }
      }
    }
    if (!last) {
      __syncthreads();
      boundary_fixup(nxt, g, boundary, bval, lo, hi, start);
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
}

}  // namespace

extern "C" {

const char* padded_superstep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch one superstep on `stream`; returns a cudaError_t (0 on success).
// Sizes are in (z, y, x) order; a 2D program passes ndim = 2, n0 = P0 = 1
// and t0 = 1.  `H` is the ring depth, `steps * radius` the superstep halo.
int padded_superstep_launch(const void* src, void* dst, const void* coef,
                            const void* offs, int ntaps, int steps,
                            int radius, int boundary, float bval, int ndim,
                            long long n0, long long n1, long long n2,
                            long long P0, long long P1, long long P2,
                            long long H, int t0, int t1, int t2, int batch,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Geometry g;
  const long long n[3] = {n0, n1, n2};
  const long long P[3] = {P0, P1, P2};
  const int tile[3] = {t0, t1, t2};
  for (int d = 0; d < 3; ++d) {
    const bool spatial = d >= 3 - ndim;
    g.n[d] = n[d];
    g.P[d] = P[d];
    g.H[d] = spatial ? H : 0;
    g.r[d] = spatial ? radius : 0;
    g.h[d] = steps * g.r[d];
    g.tile[d] = tile[d];
    g.win[d] = tile[d] + 2 * g.h[d];
  }
  const long long tiles[3] = {(n0 + t0 - 1) / t0, (n1 + t1 - 1) / t1,
                              (n2 + t2 - 1) / t2};
  g.tiles_z = (int)tiles[0];
  if (tiles[1] > 65535 || tiles[0] * batch > 65535 || tiles[2] > 2147483647LL)
    return cudaErrorInvalidConfiguration;
  const int wvol = g.win[0] * g.win[1] * g.win[2];
  const size_t smem = sizeof(float) * (size_t)wvol * (steps > 1 ? 2 : 1) +
                      (sizeof(float) + sizeof(int)) * (size_t)ntaps;
  err = cudaFuncSetAttribute(padded_superstep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)tiles[2], (unsigned)tiles[1],
                  (unsigned)(tiles[0] * batch));
  const dim3 block(kThreadsX, kThreadsY);
  padded_superstep_kernel<<<grid, block, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst),
      static_cast<const float*>(coef), static_cast<const int*>(offs), ntaps,
      steps, boundary, bval, g);
  return cudaGetLastError();
}

}  // extern "C"
