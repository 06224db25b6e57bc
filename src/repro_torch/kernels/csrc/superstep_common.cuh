// Device code of the whole-window superstep kernel (padded_superstep.cu,
// B5), for sm_90a.
//
// One CTA advances one output tile by `steps` fused time steps:
//   1. load the tile's halo'd window (tile + 2h per axis, h = steps*radius)
//      from the source into shared memory;
//   2. `steps` tap updates over a region that shrinks by `radius` per side
//      per step, ping-ponging two shared buffers with a fixup between steps;
//      the last step writes the tile into the output.
// The source is a grid that boundary_pad already padded by h (window at the
// tile origin, the output a separate grid of the rounded shape); `Geometry`
// holds it as offsets.
//
// Taps and coefficients are runtime arrays (up to 729 for a 3D box of
// radius 4) in canonical order, the center first; the sum is taken in that
// order with __fmul_rn/__fadd_rn, so no multiply-add is contracted into an
// FMA and every kernel is bitwise the plain version's mul-then-add.  A 2D
// grid runs as 3D with one z plane and no z halo.  Index arithmetic on the
// grids is 64-bit.

#pragma once

#include <cuda_runtime.h>

namespace superstep {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;

enum Boundary { kClamp = 0, kPeriodic = 1, kConstant = 2 };

// Rows of the host geometry array, three (z, y, x) values each, in this
// order (kernels/cuda.py:_geometry builds it).
enum Field {
  kTrue,     // global true extent: fixups act outside [0, n)
  kSrc,      // source extent per axis
  kLoad,     // source index of window cell 0 of the tile at origin 0
  kOrigin,   // global coordinate of output cell 0 (the shard origin)
  kDst,      // output extent per axis
  kStore,    // output index of output cell 0
  kWritten,  // output cells [0, written) are stored, the rest skipped
  kTile,     // output tile of one CTA
  kRadius,   // shrink per step (0 on the z axis of a 2D grid)
  kFields
};

struct Geometry {
  long long n[3], src[3], load[3], origin[3], dst[3], store[3], written[3];
  long long tiles[3];  // tiles per axis over `written`
  long long total;     // tiles of all axes times the batch
  int tile[3], r[3], h[3], win[3];
  int wvol;            // cells of one window
};

// Fill `g` from the host array `a`; false when the shape is not launchable.
inline bool make_geometry(const long long* a, int steps, int batch,
                          Geometry* g) {
  g->total = batch;
  long long wvol = 1;
  for (int d = 0; d < 3; ++d) {
    g->n[d] = a[3 * kTrue + d];
    g->src[d] = a[3 * kSrc + d];
    g->load[d] = a[3 * kLoad + d];
    g->origin[d] = a[3 * kOrigin + d];
    g->dst[d] = a[3 * kDst + d];
    g->store[d] = a[3 * kStore + d];
    g->written[d] = a[3 * kWritten + d];
    g->tile[d] = (int)a[3 * kTile + d];
    g->r[d] = (int)a[3 * kRadius + d];
    g->h[d] = steps * g->r[d];
    g->win[d] = g->tile[d] + 2 * g->h[d];
    if (g->tile[d] < 1 || g->written[d] < 1) return false;
    g->tiles[d] = (g->written[d] + g->tile[d] - 1) / g->tile[d];
    g->total *= g->tiles[d];
    wvol *= g->win[d];
  }
  g->wvol = (int)wvol;
  return batch >= 1 && steps >= 1 && wvol < (1LL << 31) &&
         g->total < (1LL << 31);
}

struct Tile {
  long long b;          // batch index
  long long at[3];      // output index of the tile's first cell
  long long start[3];   // global coordinate of window cell 0
};

__device__ __forceinline__ Tile tile_of(const Geometry& g, long long lin) {
  Tile t;
  for (int d = 2; d >= 0; --d) {
    t.at[d] = (lin % g.tiles[d]) * g.tile[d];
    lin /= g.tiles[d];
  }
  t.b = lin;
  for (int d = 0; d < 3; ++d) t.start[d] = g.origin[d] + t.at[d] - g.h[d];
  return t;
}

// Coefficients and linear window offsets of the taps, once per CTA; the
// barrier after the first window load publishes them.
__device__ __forceinline__ void load_tables(const float* coef, const int* offs,
                                            int ntaps, const Geometry& g,
                                            float* s_coef, int* s_lin) {
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  for (int k = tid; k < ntaps; k += kThreads) {
    s_coef[k] = coef[k];
    s_lin[k] = (offs[3 * k] * g.win[1] + offs[3 * k + 1]) * g.win[2] +
               offs[3 * k + 2];
  }
}

// Window of tile `t` into `buf`.  Cells past the source's end feed no
// output that is stored and are zero-filled.
__device__ __forceinline__ void load_window(const float* __restrict__ src,
                                            float* buf, const Geometry& g,
                                            const Tile& t) {
  const int W1 = g.win[1], W2 = g.win[2];
  const long long plane = g.src[1] * g.src[2];
  const long long base = t.b * g.src[0] * plane;
  for (int q = threadIdx.y; q < g.win[0] * W1; q += kThreadsY) {
    const long long pz = g.load[0] + t.at[0] + q / W1;
    const long long py = g.load[1] + t.at[1] + q % W1;
    const bool row_ok = pz < g.src[0] && py < g.src[1];
    const long long row = base + pz * plane + py * g.src[2];
    for (int ix = threadIdx.x; ix < W2; ix += kThreadsX) {
      const long long px = g.load[2] + t.at[2] + ix;
      float* cell = buf + q * W2 + ix;
      *cell = row_ok && px < g.src[2] ? src[row + px] : 0.0f;
    }
  }
}

__device__ __forceinline__ int clip(long long v, int lo, int hi) {
  return (int)(v < lo ? lo : (v > hi ? hi : v));
}

// Re-impose the boundary on window cells of the region [lo, hi) whose
// global coordinate lies outside [0, n).  clamp copies the border slab axis
// by axis in increasing axis order, each axis reading the already-fixed
// window (so corners take the corner cell); constant fills; periodic does
// nothing (its ring was refreshed or padded before the launch).  The border
// index is clipped into the region as the plain version clips it: that
// only bites in a tile lying wholly in the round-up slack, whose cells no
// caller reads.  Every branch on an axis is uniform across the CTA, so the
// barriers are reached by all threads.
__device__ void boundary_fixup(float* buf, const Geometry& g, int boundary,
                               float bval, const int lo[3], const int hi[3],
                               const long long start[3]) {
  if (boundary == kPeriodic) return;
  const int W1 = g.win[1], W2 = g.win[2];
  const int nry = hi[1] - lo[1];
  const int rows = (hi[0] - lo[0]) * nry;
  for (int d = 0; d < 3; ++d) {
    if (start[d] + lo[d] >= 0 && start[d] + hi[d] <= g.n[d]) continue;
    const int first = clip(-start[d], lo[d], hi[d] - 1);
    const int last = clip(g.n[d] - 1 - start[d], lo[d], hi[d] - 1);
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

// `steps` tap updates of the window in `cur` (loaded and visible to the
// CTA), with `nxt` as the ping-pong partner; the last step stores the
// tile's cells that lie below `written` into `dst`.  Both buffers are
// overwritten.
__device__ void fused_steps(float* cur, float* nxt, const float* s_coef,
                            const int* s_lin, int ntaps, int steps,
                            int boundary, float bval, const Geometry& g,
                            const Tile& t, float* __restrict__ dst) {
  const int W1 = g.win[1], W2 = g.win[2];
  const long long plane = g.dst[1] * g.dst[2];
  const long long base = t.b * g.dst[0] * plane;
  for (int s = 1; s <= steps; ++s) {
    int lo[3], hi[3];
    for (int d = 0; d < 3; ++d) {
      lo[d] = s * g.r[d];
      hi[d] = g.win[d] - s * g.r[d];
    }
    const int nry = hi[1] - lo[1];
    const int rows = (hi[0] - lo[0]) * nry;
    const bool last = s == steps;
    for (int q = threadIdx.y; q < rows; q += kThreadsY) {
      const int iz = lo[0] + q / nry;
      const int iy = lo[1] + q % nry;
      // output coordinates of this row (used by the last step)
      const long long oz = t.at[0] + iz - g.h[0];
      const long long oy = t.at[1] + iy - g.h[1];
      const long long out_row = base + (g.store[0] + oz) * plane +
                                (g.store[1] + oy) * g.dst[2] + g.store[2];
      const bool row_ok = oz < g.written[0] && oy < g.written[1];
      for (int ix = lo[2] + threadIdx.x; ix < hi[2]; ix += kThreadsX) {
        const int at = (iz * W1 + iy) * W2 + ix;
        float acc = __fmul_rn(s_coef[0], cur[at + s_lin[0]]);
        for (int k = 1; k < ntaps; ++k)
          acc = __fadd_rn(acc, __fmul_rn(s_coef[k], cur[at + s_lin[k]]));
        if (!last) {
          nxt[at] = acc;
        } else {
          const long long ox = t.at[2] + ix - g.h[2];
          if (row_ok && ox < g.written[2]) dst[out_row + ox] = acc;
        }
      }
    }
    if (!last) {
      __syncthreads();
      boundary_fixup(nxt, g, boundary, bval, lo, hi, t.start);
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
}

// Dynamic shared memory of one CTA: `windows` windows plus the tables.
inline size_t smem_bytes(const Geometry& g, int windows, int ntaps) {
  return sizeof(float) * (size_t)g.wvol * windows +
         (sizeof(float) + sizeof(int)) * (size_t)ntaps;
}

}  // namespace superstep
