// Streamed superstep kernels, for sm_90a.
//
// Two launchers share one kernel: temporal_superstep_launch runs a one-shot
// grid (one CTA per work item), padded_pipelined_launch persistent CTAs
// (min(items, resident CTAs), each walking item += gridDim.x).  Each
// launch runs one of two modes (kernels/streamed.py builds the geometry):
//
// * The padded carry: T fused steps read at ring offset H - h of the
//   source carry, the t = 0 boundary mapped plane by plane on load, the
//   true cells written into the other carry buffer at H.  Plain PyTorch
//   version: repro_torch/kernels/common.py:padded_superstep_plain.
//   - temporal_superstep_launch replaces the TPU kernel
//     repro/kernels/common.py:build_temporal_kernel (B3): one chunk of
//     T = TEMPORAL_CHUNK * par_time steps over the chunk-deep ring;
//   - padded_pipelined_launch replaces build_padded_pipelined_kernel
//     (B4): T = par_time steps.  The TPU kernel's point, the next block's
//     copy in flight while this one computes, is here at the plane level,
//     and both launchers have it: the copy of plane group i + 1 is issued
//     before group i computes;
//   - B1 (build_padded_superstep_kernel) runs tap sets that have no
//     register queue (queued_superstep.cu) on the one-shot launcher.
// * The sharded carry: the padded carry of one mesh shard, its t = 0
//   boundary mapped and its fixups made at global coordinates origin +
//   local (origin: the shard offsets) against the global extent, so the
//   ring cells the mesh exchanged at inner shard edges are read as they
//   are and only cells outside the global grid are mapped (the
//   reference's offsets= and global_shape=, core/distributed.py).  B1 on
//   the one-shot launcher, B4 on the persistent one; plain version:
//   padded_superstep_plain(offsets=, global_shape=).
// * Pre-padded: T fused steps of a grid that boundary_pad already padded
//   by h, copied as it is (no t = 0 mapping), fixups between steps at
//   global coordinates origin + local (origin: the shard offsets), every
//   cell of the rounded output stored into a separate grid.  Plain
//   version: common.py:superstep_plain.  For the same tap sets B5
//   (build_superstep_kernel) runs it on the one-shot launcher and B6
//   (build_pipelined_kernel) on the persistent one.
//
// How a CTA works (axes (streamed, y, x); a 2D grid streams along y and
// has a dummy y of extent 1).  A work item is a column tile (ty, tx) of
// output cells over the blocked axes and a segment [a, e) of output
// planes along the streamed axis.  The CTA walks the segment in groups of
// B planes (4 in 2D, 2 in 3D).  Stage 0 copies the source planes
// [a - h, e + h) (h = T*r) into a ring; stage s = 1..T computes, per
// group, the B planes r behind stage s-1's newest, over an in-plane region
// that shrinks by r per side per stage, into a ring of 2r + B planes
// clipped to that region (the loaded ring has B more planes, for the next
// group's copy in flight); stage T writes its planes straight into the
// output.  So the halo is recomputed only on the blocked axes, and only
// 2r + B planes per stage are held instead of a whole window.
//
// The boundary, plane by plane, gives exactly the cells that
// common.boundary_fixup gives a whole window (t = 0 for the carry, and
// between steps), at global coordinates:
//   - periodic: nothing; wrap_halo.cu refreshed the carry's ring before
//     the launch, or boundary_pad wrapped the pre-padded grid.
//   - constant: a cell outside the grid on any axis is the boundary value.
//   - clamp: a cell outside the grid is the cell at the clamped coordinate
//     on every axis (the axis-ordered copies compose to that), clipped into
//     the stage's region as the plain version clips it into its window.
//     The carry's stage 0 copies the clamped source cell; a computed stage
//     computes an in-plane ghost cell as the stencil at its clamped
//     in-plane coordinate (the same inputs and arithmetic as that true
//     cell, so the same bits).  A ghost plane below 0 is due before plane
//     0 exists, so when a stage emits plane 0 it copies it into the ring
//     slots of planes -1..-r; a ghost plane above n - 1 is copied from the
//     plane before it when it is due.
//   A tile or segment of the pre-padded output that lies wholly past the
//   grid holds no cell of the clamped coordinate: its cells (round-up slack
//   only) are finite but unspecified, as the plain version's window is the
//   whole grid.
//
// Arithmetic: every output is acc = c0*v0, then acc = acc + ck*vk in the
// canonical tap order, each multiply and add rounded to the grid's dtype
// with no FMA contraction (elem.cuh), so the kernel equals its plain
// version bit for bit.  The grid and the rings hold the grid's dtype (one
// library per dtype, kernels/build.py).  The fixed-tap path computes in
// lanes: in float32 a thread's P planes are P floats; in 16 bits planes
// (v, v + 1) are one bfloat162 / half2 pair, built from the two ring
// cells by one permute, multiplied and added by one __hmul2_rn /
// __hadd2_rn, with the coefficients as (c, c) pairs in registers: no
// conversion per tap.  The flat path (any other tap set) computes in
// float and rounds after each operation (mul_r, add_r), its coefficients
// floats in shared memory; in 16 bits it converts each operand and
// result.
//
// What bounds it on the H100.  At the paper's shapes one read of the
// source and one write of the output is a few milliseconds of device
// memory; inside the CTA the limit is issuing instructions: shared-memory
// reads, one per tap per cell computed, the multiplies and adds, and the
// index arithmetic around them.  The design cuts all three: the halo is
// recomputed on the blocked axes only (2D r4 over 8 steps: about 1.3 cell
// updates per output per step, against 3.4 for a whole-window kernel);
// for the tap sets of the paper (stars, small boxes) the offsets are
// compile-time constants and the coefficients registers, and a thread owns
// one in-plane cell of a pass and computes it on all B planes of the
// group, so its index arithmetic is paid once per B outputs and a ring
// cell that feeds several of its outputs is read once.  Any other tap set
// takes a flat path: up to kV outputs per thread, offsets from a table
// row per ring phase.  Loads go in chunks of 16 bytes (kVecCells cells:
// 4 in float32, 8 in 16 bits): one 16-byte cp.async where the source
// chunk is 16-byte aligned and needs no boundary mapping, else cell by
// cell (a 4-byte cp.async in float32; in 16 bits, which cp.async cannot
// copy, a plain load and store).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kV = 4;  // outputs per thread per pass of the flat path

enum Boundary { kClamp = 0, kPeriodic = 1, kConstant = 2 };

// Rows of the host geometry array, three (streamed, y, x) values each
// (kernels/streamed.py:StreamedGeometry.array builds it).
enum Field {
  kTrue,     // global true extent
  kSrc,      // source extent
  kSrcOff,   // source index of local coordinate 0
  kDst,      // output extent
  kDstOff,   // output index of local coordinate 0
  kWritten,  // output cells [0, written) are stored (local)
  kOrigin,   // global coordinate of local 0 (0 for the carry)
  kRadius,   // shrink per step (0 on a 2D grid's dummy y)
  kBlock,    // (segment length L, tile y, tile x)
  kRing,     // (planes per group B, fused steps T, shared-memory bytes)
  kMode,     // (fixed tap set: Shape code, or 0; pre-padded?; sharded?)
  kFields
};

// What a launch loads and where its boundary acts: the single device's
// carry (origin 0 at compile time), a mesh shard's carry (origin read at
// run time, the t = 0 mapping at global coordinates), or a pre-padded
// grid (copied as it is, the origin read at run time).
enum Mode { kCarry = 0, kPrepadded = 1, kSharded = 2 };

// Tap sets the kernel has fixed-offset instantiations for: their offsets
// are compile-time constants and their coefficients live in registers.
// Any other tap set reads a per-phase offset table (kAny).
enum Shape { kAny = 0, kStar = 1, kBox = 2 };

// Planes per group of the fixed-tap path: a thread's outputs per pass.
template <int ND>
__host__ __device__ constexpr int column_planes() {
  return ND == 2 ? 4 : 2;
}

struct Geo {
  long long n0, n1, n2;     // true extent
  long long s0, s1, s2;     // source extent
  long long so0, so1, so2;  // source index of local 0
  long long d0, d1, d2;     // output extent
  long long do0, do1, do2;  // output index of local 0
  long long w0, w1, w2;     // written extent
  long long o0, o1, o2;     // global coordinate of local 0
  long long tys, txs, segs, total;
  int r0, r1, r2;  // radius per axis
  int h0, h1, h2;  // T * radius
  int L, ty, tx;   // segment length, column tile
  int B, T;        // planes per group, fused steps
  int E1, E2;      // stage-0 (loaded) plane extent
  int D0, D;       // ring depth: loaded ring, computed rings
  int shape;       // fixed tap set (Shape) or kAny
  int prepadded;   // the source is copied as it is (no t = 0 mapping)
  int sharded;     // a mesh shard's carry (Mode kSharded)
};

// Ring s (stage s's output; 0: the loaded planes) is clipped to stage s's
// region: r fewer cells per side per stage on each blocked axis, rows
// `pitch` cells apart (a multiple of kVecCells, for 16-byte copies).
struct Ring {
  int pitch, plane;  // row pitch, cells per plane
  int oy, ox;        // stage-0 coordinate of the ring's cell (0, 0)
  int depth;
  int base;          // cell offset in shared memory
  int tab;           // int offset of its tap-offset table
};

// Ring 0 (the loaded planes, D0 deep) and the ring after `r` (D deep),
// laid out one after the other, their tables likewise.
__host__ __device__ inline Ring first_ring(const Geo& g) {
  Ring r;
  r.oy = r.ox = r.base = r.tab = 0;
  r.pitch = (g.E2 + kVecCells - 1) / kVecCells * kVecCells;
  r.plane = g.E1 * r.pitch;
  r.depth = g.D0;
  return r;
}

__host__ __device__ inline Ring next_ring(const Geo& g, const Ring& r,
                                          int ntaps) {
  Ring n;
  n.oy = r.oy + g.r1;
  n.ox = r.ox + g.r2;
  n.pitch = (g.E2 - 2 * n.ox + kVecCells - 1) / kVecCells * kVecCells;
  n.plane = (g.E1 - 2 * n.oy) * n.pitch;
  n.depth = g.D;
  n.base = r.base + r.depth * r.plane;
  n.tab = r.tab + r.depth * ntaps;
  return n;
}

__host__ __device__ inline Ring ring_of(const Geo& g, int s, int ntaps) {
  Ring r = first_ring(g);
  for (int t = 0; t < s; ++t) r = next_ring(g, r, ntaps);
  return r;
}

inline bool make_geo(const long long* a, int steps, int batch, Geo* g) {
  auto f = [a](int field, int i) { return a[3 * field + i]; };
  g->n0 = f(kTrue, 0), g->n1 = f(kTrue, 1), g->n2 = f(kTrue, 2);
  g->s0 = f(kSrc, 0), g->s1 = f(kSrc, 1), g->s2 = f(kSrc, 2);
  g->so0 = f(kSrcOff, 0), g->so1 = f(kSrcOff, 1), g->so2 = f(kSrcOff, 2);
  g->d0 = f(kDst, 0), g->d1 = f(kDst, 1), g->d2 = f(kDst, 2);
  g->do0 = f(kDstOff, 0), g->do1 = f(kDstOff, 1), g->do2 = f(kDstOff, 2);
  g->w0 = f(kWritten, 0), g->w1 = f(kWritten, 1), g->w2 = f(kWritten, 2);
  g->o0 = f(kOrigin, 0), g->o1 = f(kOrigin, 1), g->o2 = f(kOrigin, 2);
  g->r0 = (int)f(kRadius, 0), g->r1 = (int)f(kRadius, 1);
  g->r2 = (int)f(kRadius, 2);
  g->L = (int)f(kBlock, 0), g->ty = (int)f(kBlock, 1);
  g->tx = (int)f(kBlock, 2);
  g->B = (int)f(kRing, 0), g->T = (int)f(kRing, 1);
  g->shape = (int)f(kMode, 0);
  g->prepadded = (int)f(kMode, 1);
  g->sharded = (int)f(kMode, 2);
  if (g->T != steps || steps < 1 || batch < 1 || g->L < 1 || g->ty < 1 ||
      g->tx < 1 || g->B < 1 || g->w0 < 1 || g->w1 < 1 || g->w2 < 1 ||
      g->r0 < 1 || g->r2 < 1 || g->shape < kAny || g->shape > kBox ||
      (g->prepadded != 0 && g->prepadded != 1) ||
      (g->sharded != 0 && g->sharded != 1) ||
      (g->sharded && g->prepadded) || g->n0 > (1LL << 30) ||
      g->n1 > (1LL << 30) || g->n2 > (1LL << 30))
    return false;
  for (int i = 0; i < 3; ++i)
    if (f(kOrigin, i) < 0 || f(kOrigin, i) > (1LL << 30) ||
        (!g->prepadded && !g->sharded && f(kOrigin, i) != 0))
      return false;
  g->h0 = steps * g->r0, g->h1 = steps * g->r1, g->h2 = steps * g->r2;
  g->E1 = g->ty + 2 * g->h1;
  g->E2 = g->tx + 2 * g->h2;
  g->D = 2 * g->r0 + g->B;
  g->D0 = g->D + g->B;
  g->segs = (g->w0 + g->L - 1) / g->L;
  g->tys = (g->w1 + g->ty - 1) / g->ty;
  g->txs = (g->w2 + g->tx - 1) / g->tx;
  g->total = batch * g->segs * g->tys * g->txs;
  // flat cell counts of one stage pass stay exact in float division
  const long long plane0 = (long long)g->E1 * g->E2;
  return plane0 * g->B < (1LL << 22) && g->total < (1LL << 31);
}

// Dynamic shared memory: the rings, their tap-offset tables (one row per
// ring phase), the coefficients.  The host counts the same bytes
// (core/blocking.py:StreamedRings.bytes) to pick the tile and to refuse a
// plan; the launcher rejects a geometry whose count differs.
inline size_t smem_bytes(const Geo& g, int ntaps) {
  const Ring end = ring_of(g, g.T, ntaps);
  return sizeof(elem) * (size_t)end.base + sizeof(int) * (size_t)end.tab +
         sizeof(float) * ntaps;
}

struct Item {
  long long b;       // batch index
  long long a, e;    // output planes [a, e)
  long long y0, x0;  // output coordinate of the column tile's first cell
};

__device__ __forceinline__ Item item_of(const Geo& g, long long lin) {
  Item it;
  const long long xi = lin % g.txs;
  lin /= g.txs;
  const long long yi = lin % g.tys;
  lin /= g.tys;
  const long long si = lin % g.segs;
  it.b = lin / g.segs;
  it.a = si * g.L;
  it.e = it.a + g.L < g.w0 ? it.a + g.L : g.w0;
  it.y0 = yi * g.ty;
  it.x0 = xi * g.tx;
  return it;
}

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// q = f / d and *r = f % d for 0 <= f < 2^22, by a float reciprocal and
// one correction step.
__device__ __forceinline__ int divmod(int f, int d, float inv, int* r) {
  int q = __float2int_rz(__int2float_rn(f) * inv);
  int m = f - q * d;
  if (m < 0) {
    --q;
    m += d;
  } else if (m >= d) {
    ++q;
    m -= d;
  }
  *r = m;
  return q;
}

// Source planes [zlo, zhi) of item `it` into the loaded ring, in chunks of
// kVecCells cells: one 16-byte cp.async where the source chunk is aligned
// and needs no boundary mapping, else per cell the (clamped) source cell
// (a 4-byte cp.async in float32, a plain copy in 16 bits), the boundary
// value (constant) or zero (past the source's end, unmapped loads only:
// such cells feed no stored output).  `raw`
// copies the source as it is: a pre-padded source, or a periodic carry;
// any other carry maps the t = 0 boundary at global coordinates, (oz, oy,
// ox) being the global coordinate of local 0 (0 but on a mesh shard).
__device__ __forceinline__ void load_planes(
    const elem* __restrict__ src, elem* ring0, const Ring& r0,
    const Geo& g, const Item& it, long long z0, long long zlo,
    long long zhi, int boundary, float bval, bool raw, long long oz,
    long long oy, long long ox) {
  constexpr int C = kVecCells;
  const int nchunk = (g.E2 + C - 1) / C;
  const int rows = (int)(zhi - zlo) * g.E1;
  const int items = rows * nchunk;
  const long long gy0 = it.y0 - g.h1, gx0 = it.x0 - g.h2;
  const long long src_plane = g.s1 * g.s2;
  const elem* batch_src = src + it.b * g.s0 * src_plane;
  const int dz0 = (int)(zlo - z0);
  for (int w = threadIdx.x; w < items; w += kThreads) {
    const int row = w / nchunk, c = w - row * nchunk;
    const int jz = row / g.E1, iy = row - jz * g.E1;
    const long long z = zlo + jz, gy = gy0 + iy;
    elem* out = ring0 + ((dz0 + jz) % r0.depth) * r0.plane +
                iy * r0.pitch + C * c;
    bool fill = false;  // the whole row is the boundary value
    long long zs = z, ys = gy;
    if (!raw) {
      if (boundary == kConstant)
        fill = z + oz < 0 || z + oz >= g.n0 || gy + oy < 0 ||
               gy + oy >= g.n1;
      zs = clampll(z + oz, 0, g.n0 - 1) - oz;
      ys = clampll(gy + oy, 0, g.n1 - 1) - oy;
    }
    const long long pz = zs + g.so0, py = ys + g.so1;
    const bool row_ok = !fill && pz >= 0 && pz < g.s0 && py >= 0 &&
                        py < g.s1;
    const elem* srow = row_ok ? batch_src + pz * src_plane + py * g.s2
                              : batch_src;
    const long long gx = gx0 + C * c;
    const long long px = gx + g.so2;
    bool vec = row_ok && C * c + C <= g.E2 && px >= 0 && px + C - 1 < g.s2;
    if (vec && !raw) vec = gx + ox >= 0 && gx + ox + C - 1 < g.n2;
    if (vec) vec = (reinterpret_cast<size_t>(srow + px) & 15) == 0;
    if (vec) {
      __pipeline_memcpy_async(out, srow + px, 16);
      continue;
    }
    for (int k = 0; k < C && C * c + k < g.E2; ++k) {
      elem* cell = out + k;
      if (!row_ok) {
        *cell = to_e(fill ? bval : 0.0f);
        continue;
      }
      long long xs = gx + k;
      if (!raw) {
        if (boundary == kConstant && (xs + ox < 0 || xs + ox >= g.n2)) {
          *cell = to_e(bval);
          continue;
        }
        xs = clampll(xs + ox, 0, g.n2 - 1) - ox;
      }
      const long long q = xs + g.so2;
      if (q >= 0 && q < g.s2) {
#if REPRO_DTYPE == 0
        __pipeline_memcpy_async(cell, srow + q, sizeof(float));
#else
        *cell = srow[q];  // cp.async copies 4, 8 or 16 bytes, not 2
#endif
      } else {
        *cell = to_e(0.0f);
      }
    }
  }
}

// What one stage computes in one group: planes [qlo, qhi) over the
// in-plane region [ylo, yhi) x [xlo, xhi) (stage-0 coordinates), read
// from ring `ri` (its cells at `in`, its offset table at `tab`), written
// into ring `ro` (at `out`) or, for the last stage, into `dst`.
struct Pass {
  const elem* in;
  const int* tab;
  elem* out;
  Ring ri, ro;
  long long qlo, qhi;
  int ylo, yhi, xlo, xhi;
  int oy, ox;  // global coordinate of local (y, x) = 0: the shard origin
  bool last;
};

// In-plane geometry of a pass shared by both paths: where its cells lie
// in the grid, and the clamp/constant mapping of a cell outside it.
struct Plane {
  int gy0, gx0;  // global coordinate of stage-0 cell (0, 0)
  int n1, n2;
  bool edge;     // some cell of the pass lies outside the grid in-plane
  long long dst0;  // output index of stage-0 cell (0, 0) on plane qlo

  __device__ __forceinline__ Plane(const Pass& p, const Geo& g,
                                   const Item& it, int boundary) {
    const long long ly0 = it.y0 - g.h1, lx0 = it.x0 - g.h2;  // local
    gy0 = (int)ly0 + p.oy;
    gx0 = (int)lx0 + p.ox;
    n1 = (int)g.n1;
    n2 = (int)g.n2;
    edge = !p.last && boundary != kPeriodic &&
           (gy0 + p.ylo < 0 || gy0 + p.yhi > n1 || gx0 + p.xlo < 0 ||
            gx0 + p.xhi > n2);
    dst0 = ((it.b * g.d0 + p.qlo + g.do0) * g.d1 + g.do1 + ly0) * g.d2 +
           g.do2 + lx0;
  }

  // Cell (iy, ix) outside the grid: constant fills, clamp reads the cell
  // at the clamped coordinate (clipped into the pass's region, as the
  // plain version clips it).  Returns false for a fill.
  __device__ __forceinline__ bool map(const Pass& p, int boundary, int iy,
                                      int ix, int* my, int* mx) const {
    *my = iy;
    *mx = ix;
    if (!edge) return true;
    const int gy = gy0 + iy, gx = gx0 + ix;
    if (gy >= 0 && gy < n1 && gx >= 0 && gx < n2) return true;
    if (boundary == kConstant) return false;
    *my = min(max(min(max(gy, 0), n1 - 1) - gy0, p.ylo), p.yhi - 1);
    *mx = min(max(min(max(gx, 0), n2 - 1) - gx0, p.xlo), p.xhi - 1);
    return true;
  }
};

// Flat path (any tap set): kV-blocked outputs [base, base + NV*kThreads)
// of the pass's flat cells, offsets from the ring phase's table row.
template <int NV>
__device__ __forceinline__ void flat_cells(
    const Pass& p, const Plane& pl, int base, int count, const Geo& g,
    long long z0, const float* s_coef, int ntaps, int boundary, float bval,
    elem* __restrict__ dst) {
  const int nx = p.xhi - p.xlo;
  const int per_plane = (p.yhi - p.ylo) * nx;
  const float inv_pp = 1.0f / (float)per_plane, inv_nx = 1.0f / (float)nx;
  // ring slots of the pass's first plane: in the read ring, in the
  // written one (a group's planes wrap at most once: B <= depth)
  const int dq = (int)(p.qlo - z0);
  const int ph0 = dq % p.ri.depth, out0 = dq % p.ro.depth;
  const int safe = ph0 * p.ri.plane + (p.ylo - p.ri.oy) * p.ri.pitch +
                   p.xlo - p.ri.ox;
  int cen[NV];
  const int* trow[NV];
  long long at[NV];
  bool live[NV], fill[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int f = base + v * kThreads + (int)threadIdx.x;
    live[v] = f < count;
    int rem = 0, rx = 0;
    const int jz = live[v] ? divmod(f, per_plane, inv_pp, &rem) : 0;
    const int yy = divmod(rem, nx, inv_nx, &rx);
    const int iy = p.ylo + yy, ix = p.xlo + rx;
    int my, mx;
    fill[v] = !pl.map(p, boundary, iy, ix, &my, &mx);
    int slot = ph0 + jz;
    if (slot >= p.ri.depth) slot -= p.ri.depth;
    const bool reads = live[v] && !fill[v];
    cen[v] = reads ? slot * p.ri.plane + (my - p.ri.oy) * p.ri.pitch + mx -
                         p.ri.ox
                   : safe;
    trow[v] = p.tab + (reads ? slot : ph0) * ntaps;
    if (p.last) {
      at[v] = pl.dst0 + (long long)jz * g.d1 * g.d2 +
              (long long)iy * g.d2 + ix;
    } else {
      int os = out0 + jz;
      if (os >= p.ro.depth) os -= p.ro.depth;
      at[v] = os * p.ro.plane + (iy - p.ro.oy) * p.ro.pitch + ix - p.ro.ox;
    }
  }
  float acc[NV];
  const float c0 = s_coef[0];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = mul_r(c0, to_f(p.in[cen[v]]));
  for (int k = 1; k < ntaps; ++k) {
    const float c = s_coef[k];
#pragma unroll
    for (int v = 0; v < NV; ++v)
      acc[v] = add_r(acc[v], mul_r(c, to_f(p.in[cen[v] + trow[v][k]])));
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (!live[v]) continue;
    const elem val = to_e(fill[v] ? bval : acc[v]);
    if (p.last)
      dst[at[v]] = val;
    else
      p.out[at[v]] = val;
  }
}

__device__ __forceinline__ void flat_pass(const Pass& p, const Geo& g,
                                          const Item& it, long long z0,
                                          const float* s_coef, int ntaps,
                                          int boundary, float bval,
                                          elem* __restrict__ dst) {
  const Plane pl(p, g, it, boundary);
  const int count = (int)(p.qhi - p.qlo) * (p.yhi - p.ylo) *
                    (p.xhi - p.xlo);
  for (int base = 0; base < count; base += kThreads * kV) {
    if (base + (int)threadIdx.x >= count) break;  // no live output left
    const int left = (count - base + kThreads - 1) / kThreads;
    if (left >= 4)
      flat_cells<4>(p, pl, base, count, g, z0, s_coef, ntaps, boundary,
                    bval, dst);
    else if (left == 3)
      flat_cells<3>(p, pl, base, count, g, z0, s_coef, ntaps, boundary,
                    bval, dst);
    else if (left == 2)
      flat_cells<2>(p, pl, base, count, g, z0, s_coef, ntaps, boundary,
                    bval, dst);
    else
      flat_cells<1>(p, pl, base, count, g, z0, s_coef, ntaps, boundary,
                    bval, dst);
  }
}

template <int S, int R, int ND>
__host__ __device__ constexpr int num_taps() {
  if (S == kStar) return 1 + 2 * ND * R;
  if (S == kBox) return ND == 2 ? (2 * R + 1) * (2 * R + 1)
                                : (2 * R + 1) * (2 * R + 1) * (2 * R + 1);
  return 1;
}

// A fixed tap set's coefficients in registers, one lane each: a float,
// or a (c, c) pair in 16 bits.
template <int S, int R, int ND>
struct FixedCoef {
  lane c[num_taps<S, R, ND>()];
};

// The sum over a fixed tap set in its canonical order (core/program.py),
// in (streamed, y, x) axes: `val(dz, dy, dx)` is the cell at that offset.
//   star: center; x -1..-R; x +1..+R; then the next axis (y in 3D, the
//         streamed axis in 2D) - and +; then (3D) the streamed axis - and +.
//   box:  center; then every offset by Chebyshev shell 1..R, each shell in
//         lexicographic order of the grid's axes.
// acc = c0*v0, acc = acc + ck*vk, each rounded to the grid's dtype, a lane
// at a time (elem.cuh: lmul, ladd).
template <int S, int R, int ND, class Val>
__device__ __forceinline__ lane fixed_sum(const lane* c, Val val) {
  lane a = lmul(c[0], val(0, 0, 0));
  int k = 1;
  if constexpr (S == kStar) {
#pragma unroll
    for (int j = 1; j <= R; ++j)
      a = ladd(a, lmul(c[k++], val(0, 0, -j)));
#pragma unroll
    for (int j = 1; j <= R; ++j)
      a = ladd(a, lmul(c[k++], val(0, 0, j)));
    if constexpr (ND == 3) {
#pragma unroll
      for (int j = 1; j <= R; ++j)
        a = ladd(a, lmul(c[k++], val(0, -j, 0)));
#pragma unroll
      for (int j = 1; j <= R; ++j)
        a = ladd(a, lmul(c[k++], val(0, j, 0)));
    }
#pragma unroll
    for (int j = 1; j <= R; ++j)
      a = ladd(a, lmul(c[k++], val(-j, 0, 0)));
#pragma unroll
    for (int j = 1; j <= R; ++j)
      a = ladd(a, lmul(c[k++], val(j, 0, 0)));
  } else if constexpr (S == kBox) {
    constexpr int RY = ND == 3 ? R : 0;
#pragma unroll
    for (int n = 1; n <= R; ++n) {
#pragma unroll
      for (int z = -R; z <= R; ++z) {
#pragma unroll
        for (int y = -RY; y <= RY; ++y) {
#pragma unroll
          for (int x = -R; x <= R; ++x) {
            const int az = z < 0 ? -z : z, ay = y < 0 ? -y : y;
            const int ax = x < 0 ? -x : x;
            const int m = az > ay ? (az > ax ? az : ax) : (ay > ax ? ay : ax);
            if (m == n) a = ladd(a, lmul(c[k++], val(z, y, x)));
          }
        }
      }
    }
  }
  return a;
}

// Fixed-tap path: a thread owns one in-plane cell of the pass and computes
// it on all P planes of the group, P / kLaneCells lanes (planes C*v ..
// C*v + C - 1, C = kLaneCells).  The ring planes those read are one
// register array of plane offsets, so a ring cell that feeds several of
// its outputs is read once.  Planes past the group's end (a short group at
// the segment's ends) are computed and not stored.
template <int S, int R, int ND>
__device__ __forceinline__ void column_pass(
    const Pass& p, const Geo& g, const Item& it, long long z0,
    const FixedCoef<S, R, ND>& fc, int boundary, float bval,
    elem* __restrict__ dst) {
  constexpr int P = column_planes<ND>();
  constexpr int NB = P + 2 * R;  // ring planes read
  constexpr int C = kLaneCells;
  const Plane pl(p, g, it, boundary);
  const elem bv = to_e(bval);
  const int nq = (int)(p.qhi - p.qlo);
  const int dq = (int)(p.qlo - z0);
  const int pitch = p.ri.pitch;
  // read-ring offset of plane qlo - R + m
  int rb[NB];
  {
    int sl = (dq - R) % p.ri.depth;
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      rb[m] = sl * p.ri.plane;
      if (++sl == p.ri.depth) sl = 0;
    }
  }
  const int out0 = dq % p.ro.depth;
  const int nx = p.xhi - p.xlo;
  const int count = (p.yhi - p.ylo) * nx;
  const float inv_nx = 1.0f / (float)nx;
  const long long dplane = g.d1 * g.d2;
  for (int f = threadIdx.x; f < count; f += kThreads) {
    int rx = f;
    // a 2D plane is one row
    const int iy = p.ylo + (ND == 2 ? 0 : divmod(f, nx, inv_nx, &rx));
    const int ix = p.xlo + rx;
    int my, mx;
    const bool fill = !pl.map(p, boundary, iy, ix, &my, &mx);
    const elem* q = p.in + (my - p.ri.oy) * pitch + mx - p.ri.ox;
    lane acc[P / C];
#pragma unroll
    for (int v = 0; v < P / C; ++v)
      acc[v] = fixed_sum<S, R, ND>(fc.c, [&](int dz, int dy, int dx) {
        const int m = C * v + R + dz;
        return pair(q[rb[m] + dy * pitch + dx],
                    q[rb[m + C - 1] + dy * pitch + dx]);
      });
    int os = out0;
#pragma unroll
    for (int v = 0; v < P; ++v) {
      if (v < nq) {
        const elem val = fill ? bv : cell(acc, v);
        if (p.last)
          dst[pl.dst0 + v * dplane + (long long)iy * g.d2 + ix] = val;
        else
          p.out[os * p.ro.plane + (iy - p.ro.oy) * p.ro.pitch + ix -
                p.ro.ox] = val;
      }
      if (++os == p.ro.depth) os = 0;
    }
  }
}

// Plane `to` of computed ring `r` := plane `from` (or the boundary value,
// `fill`) over the region [ylo, yhi) x [xlo, xhi) (stage-0 coordinates;
// planes local, at or after the item's first loaded plane z0).  A thread
// copies the same cells in every call, so a chain of copies, each from
// the plane the one before wrote, needs no barrier.
__device__ __forceinline__ void ghost_plane(elem* ring, const Ring& r,
                                            long long z0, long long to,
                                            long long from, bool fill,
                                            float bval, int ylo, int yhi,
                                            int xlo, int xhi) {
  const int nx = xhi - xlo;
  const int count = (yhi - ylo) * nx;
  elem* dst = ring + (int)((to - z0) % r.depth) * r.plane;
  const elem* src = ring + (int)((from - z0) % r.depth) * r.plane;
  for (int f = threadIdx.x; f < count; f += kThreads) {
    const int yy = f / nx;
    const int at = (ylo + yy - r.oy) * r.pitch + xlo + (f - yy * nx) - r.ox;
    dst[at] = fill ? to_e(bval) : src[at];
  }
}

// At least two CTAs per SM: ptxas may then use up to 128 registers a
// thread, which every instantiation fits without spilling.  M is the Mode:
// in the single device's carry (kCarry) the origin is 0 at compile time
// (read at run time, it made the box runs 0.1-0.2 ms slower: PERF.md,
// tools/box_run_walls.py); a mesh shard's carry (kSharded) and the
// pre-padded mode read it.
template <int S, int R, int ND, int M>
__global__ void __launch_bounds__(kThreads, 2)
streamed_kernel(const elem* __restrict__ src, elem* __restrict__ dst,
                const coef_t* __restrict__ coef, const int* __restrict__ offs,
                int ntaps, int boundary, float bval, Geo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  elem* smem = reinterpret_cast<elem*>(smem_raw);
  bval = rnd(bval);  // the host rounded it to the grid's dtype already
  const Ring end = ring_of(g, g.T, ntaps);
  int* tabs = reinterpret_cast<int*>(smem + end.base);
  float* s_coef = reinterpret_cast<float*>(tabs + end.tab);

  // tap offsets per ring and phase: a cell of the plane in slot `ph`
  // reads tap (dz, dy, dx) at slot (ph + dz) mod depth (the flat path)
  if constexpr (S == kAny) {
    Ring r = first_ring(g);
    for (int t = 0; t < g.T; ++t, r = next_ring(g, r, ntaps)) {
      for (int i = threadIdx.x; i < r.depth * ntaps; i += kThreads) {
        const int ph = i / ntaps, k = i - ph * ntaps;
        const int slot = ((ph + offs[3 * k]) % r.depth + r.depth) % r.depth;
        tabs[r.tab + i] = (slot - ph) * r.plane + offs[3 * k + 1] * r.pitch +
                          offs[3 * k + 2];
      }
    }
  }
  for (int k = threadIdx.x; k < ntaps; k += kThreads)
    s_coef[k] = coef_float(coef[k]);
  FixedCoef<S, R, ND> fc;
  if constexpr (S != kAny) {
#pragma unroll
    for (int k = 0; k < num_taps<S, R, ND>(); ++k)
      fc.c[k] = coef_lane(coef[k]);
  }
  __syncthreads();

  constexpr bool PRE = M == kPrepadded;
  const bool periodic = boundary == kPeriodic;
  const bool raw = periodic || PRE;
  const Ring r0 = first_ring(g);
  const long long zero = M != kCarry ? -g.o0 : 0;  // local plane of global 0
  // global coordinate of local 0 where the t = 0 mapping acts
  const long long lo0 = M == kSharded ? g.o0 : 0;
  const long long lo1 = M == kSharded ? g.o1 : 0;
  const long long lo2 = M == kSharded ? g.o2 : 0;
  for (long long lin = blockIdx.x; lin < g.total; lin += gridDim.x) {
    const Item it = item_of(g, lin);
    const long long z0 = it.a - g.h0;        // first loaded plane
    const long long zend = it.e + g.h0;      // loaded planes end
    const int iters = (int)((it.e - it.a + 2 * g.h0 + g.B - 1) / g.B);
    load_planes(src, smem, r0, g, it, z0, z0,
                z0 + g.B < zend ? z0 + g.B : zend, boundary, bval, raw, lo0,
                lo1, lo2);
    __pipeline_commit();
    for (int i = 0; i < iters; ++i) {
      // the copy of group i + 1 is in flight while group i computes
      const long long glo = z0 + (long long)(i + 1) * g.B;
      const long long ghi = glo + g.B < zend ? glo + g.B : zend;
      if (glo < ghi)
        load_planes(src, smem, r0, g, it, z0, glo, ghi, boundary, bval,
                    raw, lo0, lo1, lo2);
      __pipeline_commit();
      __pipeline_wait_prior(1);  // group i has landed
      __syncthreads();
      // ring s - 1 is read and ring s written by stage s
      Ring ri = r0, ro;
      for (int s = 1; s <= g.T; ++s, ri = ro) {
        ro = next_ring(g, ri, ntaps);
        const bool last = s == g.T;
        const long long grow = (long long)(g.T - s) * g.r0;
        long long lo = z0 + (long long)i * g.B - (long long)s * g.r0;
        long long hi = lo + g.B;
        if (lo < it.a - grow) lo = it.a - grow;
        if (hi > it.e + grow) hi = it.e + grow;
        if (lo >= hi) continue;
        // the true planes are computed; ghost planes are filled below.
        // Planes from `top` on are ghosts above the grid: n0 on, or
        // (clamp) past the stage's first plane where all its planes lie
        // past the grid (that plane then stands in for plane n0 - 1, as
        // the plain version clips n0 - 1 into its window)
        long long top = g.n0 + zero;
        if (PRE && boundary == kClamp && top <= it.a - grow)
          top = it.a - grow + 1;
        long long clo = lo, chi = hi;
        if (!last && !periodic) {
          clo = lo > zero ? lo : zero;
          chi = hi < top ? hi : top;
        }
        Pass p;
        p.ri = ri;
        p.ro = ro;
        p.in = smem + p.ri.base;
        p.tab = tabs + p.ri.tab;
        p.out = smem + p.ro.base;
        p.qlo = clo;
        p.qhi = chi;
        p.oy = M != kCarry ? (int)g.o1 : 0;
        p.ox = M != kCarry ? (int)g.o2 : 0;
        p.last = last;
        if (last) {
          p.ylo = g.h1;
          p.yhi = g.h1 + (int)(it.y0 + g.ty < g.w1 ? g.ty : g.w1 - it.y0);
          p.xlo = g.h2;
          p.xhi = g.h2 + (int)(it.x0 + g.tx < g.w2 ? g.tx : g.w2 - it.x0);
        } else {
          p.ylo = s * g.r1;
          p.yhi = g.E1 - s * g.r1;
          p.xlo = s * g.r2;
          p.xhi = g.E2 - s * g.r2;
        }
        if (clo < chi) {
          if constexpr (S == kAny)
            flat_pass(p, g, it, z0, s_coef, ntaps, boundary, bval, dst);
          else
            column_pass<S, R, ND>(p, g, it, z0, fc, boundary, bval, dst);
        }
        __syncthreads();
        // ghost planes in this group, or plane 0 whose copies are the
        // ghost planes below it (due in an earlier group); uniform across
        // the CTA
        if (last || periodic ||
            (clo == lo && chi == hi &&
             !(lo <= zero && zero < hi && it.a - grow < zero)))
          continue;
        if (boundary == kConstant) {
          for (long long q = lo; q < hi; ++q)
            if (q < zero || q >= top)
              ghost_plane(p.out, p.ro, z0, q, q, true, bval, p.ylo, p.yhi,
                          p.xlo, p.xhi);
        } else {
          if (lo <= zero && zero < hi) {
            // the next stage reads r planes below 0 (the origin is >= 0,
            // so no stage's planes lie wholly below the grid)
            const long long bottom = it.a - grow > zero - g.r0
                                         ? it.a - grow
                                         : zero - g.r0;
            for (long long q = bottom; q < zero; ++q)
              ghost_plane(p.out, p.ro, z0, q, zero, false, bval, p.ylo,
                          p.yhi, p.xlo, p.xhi);
          }
          // the carry's next stage reads r planes above the grid; a
          // pre-padded stage may store any of its planes
          const long long qend = PRE || hi < top + g.r0 ? hi : top + g.r0;
          for (long long q = lo > top ? lo : top; q < qend; ++q)
            ghost_plane(p.out, p.ro, z0, q, q - 1, false, bval, p.ylo, p.yhi,
                        p.xlo, p.xhi);
        }
        __syncthreads();
      }
    }
  }
}

using KernelFn = void (*)(const elem*, elem*, const coef_t*, const int*,
                          int, int, float, Geo);

// The instantiation for the geometry: a fixed tap set (star of radius
// 1..4, box of radius 1..2 in 2D or 1 in 3D) in groups of its column
// planes, else the flat path; for the carry, a shard's carry or the
// pre-padded mode.
template <int M>
KernelFn choose_taps(const Geo& g) {
  const bool d2 = g.r1 == 0;
  if (g.B != (d2 ? column_planes<2>() : column_planes<3>()))
    return streamed_kernel<kAny, 0, 3, M>;
  switch (g.shape * 100 + g.r0 * 10 + (d2 ? 2 : 3)) {
    case 112: return streamed_kernel<kStar, 1, 2, M>;
    case 122: return streamed_kernel<kStar, 2, 2, M>;
    case 132: return streamed_kernel<kStar, 3, 2, M>;
    case 142: return streamed_kernel<kStar, 4, 2, M>;
    case 113: return streamed_kernel<kStar, 1, 3, M>;
    case 123: return streamed_kernel<kStar, 2, 3, M>;
    case 133: return streamed_kernel<kStar, 3, 3, M>;
    case 143: return streamed_kernel<kStar, 4, 3, M>;
    case 212: return streamed_kernel<kBox, 1, 2, M>;
    case 222: return streamed_kernel<kBox, 2, 2, M>;
    case 213: return streamed_kernel<kBox, 1, 3, M>;
    default: return streamed_kernel<kAny, 0, 3, M>;
  }
}

KernelFn choose(const Geo& g) {
  if (g.prepadded) return choose_taps<kPrepadded>(g);
  return g.sharded ? choose_taps<kSharded>(g) : choose_taps<kCarry>(g);
}

int launch(const void* src, void* dst, const void* coef, const void* offs,
           int ntaps, int steps, int boundary, float bval,
           const long long* geometry, int batch, int device, void* stream,
           bool persistent) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Geo g;
  if (!make_geo(geometry, steps, batch, &g))
    return cudaErrorInvalidConfiguration;
  const KernelFn fn = choose(g);
  const size_t smem = smem_bytes(g, ntaps);
  if ((long long)smem != geometry[3 * kRing + 2])
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  long long blocks = g.total;
  if (persistent) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(fn), kThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long resident = (long long)per_sm * sms;
    if (blocks > resident) blocks = resident;
  }
  fn<<<(unsigned)blocks, kThreads, smem,
       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const elem*>(src), static_cast<elem*>(dst),
      static_cast<const coef_t*>(coef), static_cast<const int*>(offs), ntaps,
      boundary, bval, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* streamed_superstep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launcher runs one launch on `stream` and returns a cudaError_t (0 on
// success).  `geometry` is the host array of Field, `steps` the fused
// steps T, `coef` the device coefficient bank (kernels/cuda.py:
// coefficient_bank: ntaps floats, or ntaps (c, c) pairs in 16 bits),
// `offs` the device tap table ((streamed, y, x) rows).

int temporal_superstep_launch(const void* src, void* dst, const void* coef,
                              const void* offs, int ntaps, int steps,
                              int boundary, float bval,
                              const long long* geometry, int batch,
                              int device, void* stream) {
  return launch(src, dst, coef, offs, ntaps, steps, boundary, bval,
                geometry, batch, device, stream, false);
}

int padded_pipelined_launch(const void* src, void* dst, const void* coef,
                            const void* offs, int ntaps, int steps,
                            int boundary, float bval,
                            const long long* geometry, int batch, int device,
                            void* stream) {
  return launch(src, dst, coef, offs, ntaps, steps, boundary, bval,
                geometry, batch, device, stream, true);
}

}  // extern "C"
