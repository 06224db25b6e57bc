// Register-queued superstep kernels, for sm_90a.
//
// One launcher (queued_superstep_launch) runs three TPU kernels of
// repro/kernels/common.py for stars within QUEUE_STEPS (core/blocking.py);
// every other tap set runs streamed_superstep.cu (kernels/cuda.py):
//
// * B1, build_padded_superstep_kernel (`:707`, launched by
//   _padded_superstep_pallas at `:1012`/`:1024`): one superstep of T fused
//   steps of the padded carry, read at ring offset H - h of `src`, the
//   t = 0 boundary applied plane by plane on load, the true cells written
//   into the other carry buffer `dst` at H; a one-shot grid.  Plain
//   PyTorch version: repro_torch/kernels/common.py:padded_superstep_plain.
//   A mesh shard's carry runs the sharded instantiation (SH): the t = 0
//   mapping on load at global coordinates origin + local against the
//   global extent (the reference's offsets= and global_shape=), so the
//   ring cells the mesh exchanged at inner shard edges load as they are.
//   The single device's instantiation maps at local coordinates.
// * B5, build_superstep_kernel (`:181`), and B6, build_pipelined_kernel
//   (`:223`), both launched by _superstep_pallas at `:362`: one superstep
//   of a grid that boundary_pad already padded by h.  Window at the tile
//   origin, no t = 0 mapping, fixups between steps at global coordinates
//   origin + local (origin: the shard offsets), every cell of the rounded
//   output written into a separate grid.  B5 runs a one-shot grid, B6
//   persistent CTAs: the first planes of a CTA's next work item are in
//   flight while the current one computes.  Plain version:
//   common.py:superstep_plain.
//
// Geometry (kernels/queued.py builds the host array): axes (streamed, y,
// x), a 2D grid streaming along y with a dummy y of extent 1.  A work item
// is a column tile (ty, tx) of output cells and a segment [a, e) of output
// planes.  Stage 0 is the source planes [a - h, e + h) (h = T*r), copied
// in groups of B = R planes into a ring of G groups of the stage-0 extent
// (ty + 2h, tx + 2h), rows P cells apart, stage-0 column c at shared
// column c + pad (pad in A..2A-1, A = kVecCells the cells of 16 bytes, so
// that a source row and its shared row are 16-byte aligned together).
// One barrier per group.
//
// A thread owns one strip of 4 consecutive x cells of the stage-1 region
// (tile + 2(h - r) per blocked axis).  For each stage s it keeps 3R values
// of its cells along the streamed axis in registers, q[s] (stage 0's only
// where T*3R <= 14: else those stay in the loaded ring).  At step k
// (stage-0 planes Z .. Z + R - 1 land, Z = a - h + kR), stage s >= 1
// computes planes Z - sR .. Z - sR + R - 1: their streamed-axis taps come
// from q[s-1], their in-plane taps from stage s-1's planes in shared
// memory: the loaded ring for s = 1, else a double-buffered group of
// centre planes that the threads write from q[s-1] at the start of the
// step.  So one barrier per group of R planes publishes the loaded group
// and every centre group.  A thread reads the 4 + 2R x values its strip
// needs with three 4-cell loads (16 bytes in float32, 8 in 16 bits) and
// each y row with one.
//
// Copies: warp 0 issues one cp.async.bulk per row of a group's planes,
// completing on the ring slot's mbarrier, `ahead` groups ahead of the step
// that reads them.  Row copies rather than a TMA tensor map: they need no
// driver entry point (cuTensorMapEncodeTiled would mean -lcuda or
// cudaGetDriverEntryPoint and a descriptor per launch), and the carry's
// boundary mapping picks a source row per row anyway.  The launcher checks
// the alignment before the launch: a row pitch that is not a multiple of
// 16 bytes (4 cells in float32, 8 in 16 bits: odd rings, no paper shape)
// loads every cell with plain loads.
// Cells a bulk copy cannot take (the clamp/constant mapping of the padded
// carry's ring, unaligned row ends) are loaded by all threads with plain
// loads; cells past the source's end are not loaded (no stored output
// reads them).
//
// The boundary gives exactly the cells common.boundary_fixup gives a
// whole window (t = 0 for the carry, and between steps):
//   - periodic: nothing (wrap_halo.cu refreshed the ring, or boundary_pad
//     wrapped the pre-padded grid);
//   - constant: a cell outside the global grid on any axis is bval;
//   - clamp: a cell outside is the cell at the clamped coordinate on every
//     axis (the axis-ordered copies compose to that), clipped into the
//     stage's region as the plain version clips it.  The carry loads the
//     clamped source cell.  Between steps the threads copy in-plane ghost
//     cells of a centre plane from their clamped cell (one more barrier,
//     on tiles that touch the in-plane boundary), push a copy of plane n-1
//     for planes above the grid and, when a stage computes plane 0,
//     overwrite the queue entries of planes -R..-1 with it.
//
// Arithmetic: acc = c0*v0, then acc = acc + ck*vk in canonical tap order,
// each multiply and add rounded to the grid's dtype with no FMA
// contraction, in lanes (elem.cuh): a thread's 4 cells are 4 float lanes
// in float32 and two (bfloat162 / half2) pairs in 16 bits, multiplied and
// added by one __hmul2_rn / __hadd2_rn per pair, so every output equals
// the plain version's bit for bit and a 16-bit tap costs no conversion.
// An x tap at an odd offset joins its pair from the two pairs it
// straddles with one byte permute.  The grid, the shared planes and the
// register queues hold the grid's dtype (one library per dtype,
// kernels/build.py): in 16 bits a queue entry is two pairs, half the
// registers of float32's four floats.  Coefficients sit in constant
// memory (copied on the launch's stream before the launch), floats in
// float32 and (c, c) pairs in 16 bits, so the fixed-tap multiplies take
// them as operands and spend no registers.  The bank is one per device:
// a launch's stream waits for the previous launch of this source before
// overwriting it (launch()), so launches on two streams take turns
// instead of reading each other's coefficients.
//
// What bounds it on the H100.  At the paper's shapes one read of the
// source and one write of the output is 0.64-0.90 ms of device memory;
// the FP32 work without FMA about as much.  The whole-window kernel
// took 6-15 ms, bound by shared-memory reads (three per tap: value,
// coefficient, offset) and index arithmetic.  Here a star's streamed-axis
// taps cost no shared read, an x tap a third of a 16-byte read per
// output, a y tap a quarter; index arithmetic is paid once per strip and
// step; coefficients are constant-bank operands.  What is left is the
// FP32 issue rate (33 to 49 instructions per output per step) and the
// queue shifts (2R moves per cell and stage).  B5 runs the one-shot grid
// because persistent CTAs measured slower for B1 in 3D (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "elem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kV = 4;  // x cells of one thread's strip (queue path)
constexpr int kMaxTaps = 1024;
constexpr int kGuard = 16;  // cells of slack after the last plane
// Queue values per cell a thread may hold over all stages: with more,
// stage 0's values stay in the loaded ring, which then holds 2R planes
// behind the current group, and stage 1 reads its streamed-axis taps from
// there (core/blocking.py: QUEUE_REGS).
constexpr int kQueueRegs = 14;

// A queue holds 2R + B planes of a stage: the B computed in a step and R
// on either side (the queue path's group is B = R planes).
__host__ __device__ constexpr int queue_len(int r) { return 3 * r; }

__host__ __device__ constexpr bool stage0_in_registers(int r, int t) {
  return t * queue_len(r) <= kQueueRegs;
}

enum Boundary { kClamp = 0, kPeriodic = 1, kConstant = 2 };

// Rows of the host geometry array, three (streamed, y, x) values each
// (kernels/queued.py:QueuedGeometry.array builds it).
enum Field {
  kTrue,     // global true extent
  kSrc,      // source extent
  kSrcOff,   // source index of local coordinate 0
  kDst,      // output extent
  kDstOff,   // output index of local coordinate 0
  kWritten,  // output cells [0, written) are stored
  kOrigin,   // global coordinate of local 0 (shard offsets)
  kRadius,   // shrink per step (0 on a 2D grid's dummy y)
  kBlock,    // (segment length L, tile y, tile x)
  kPlanes,   // (fused steps T, planes per group B, groups ahead)
  kMode,     // (padded carry?, persistent?, a shard's carry?)
  kBytes,    // (shared-memory bytes, 0, 0)
  kFields
};

// The coefficients of the running launch, rounded to the grid's dtype by
// the host (kernels/cuda.py:coefficient_bank; elem.cuh:coef_t): one bank
// per device, so launches on different streams take turns (launch()
// below).
__constant__ coef_t c_coef[kMaxTaps];

__device__ __forceinline__ lane coef(int k) {
  return coef_lane(c_coef[k]);
}

// Extents and offsets are 32-bit (the launcher checks they fit); flat
// indices into the grids are 64-bit (flat()).
struct Geo {
  int n0, n1, n2;     // global true extent
  int s0, s1, s2;     // source extent
  int so0, so1, so2;  // source index of local 0
  int d0, d1, d2;     // output extent
  int do0, do1, do2;  // output index of local 0
  int w0, w1, w2;     // written extent
  int o0, o1, o2;     // global coordinate of local 0
  int segs, tys, txs, total;
  int r0, r1, r2, h0, h1, h2;
  int L, ty, tx, T, B, ahead;
  int E1, E2, P, pad, plane;  // stage-0 extent, row pitch, x shift
  int G, D0;  // loaded groups and planes
  // all planes (plane_count), from the host: with the count inlined into
  // the kernel, ptxas spilled the 1-step radius-4 instantiations
  int carry, persistent;
  int sharded;  // a mesh shard's carry: the SH instantiation
  int Y1, NX, j0;  // strip rows, strips per row, first strip
  int planes;
  int bulk;  // rows may be copied with cp.async.bulk
};

// rounded up to whole 16-byte copies
__host__ __device__ inline int round_vec(int v) {
  return (v + kVecCells - 1) / kVecCells * kVecCells;
}

// Flat index of (b, z, y, x) in a grid of extent (e0, e1, e2) per batch.
__host__ __device__ inline long long flat(int b, int z, int y, int x, int e0,
                                          int e1, int e2) {
  return (((long long)b * e0 + z) * e1 + y) * e2 + x;
}

// Planes before the guard and the mbarriers: the loaded ring and, per
// later stage, two groups of centre planes.
inline int plane_count(const Geo& g) {
  return g.D0 + 2 * g.B * (g.T - 1);
}

// Dynamic shared memory: the planes, a guard, one mbarrier per loaded
// group.  The host counts the same bytes
// (core/blocking.py:QueuedPlanes.bytes).
inline size_t smem_bytes(const Geo& g) {
  return sizeof(elem) * ((size_t)g.plane * plane_count(g) + kGuard) +
         sizeof(unsigned long long) * g.G;
}

inline bool make_geo(const long long* a, int steps, int batch, int ntaps,
                     Geo* g) {
  for (int i = 0; i < 3 * kFields; ++i)
    if (a[i] < -(1LL << 30) || a[i] >= (1LL << 30)) return false;
  auto f = [a](int field, int i) { return (int)a[3 * field + i]; };
  g->n0 = f(kTrue, 0), g->n1 = f(kTrue, 1), g->n2 = f(kTrue, 2);
  g->s0 = f(kSrc, 0), g->s1 = f(kSrc, 1), g->s2 = f(kSrc, 2);
  g->so0 = f(kSrcOff, 0), g->so1 = f(kSrcOff, 1), g->so2 = f(kSrcOff, 2);
  g->d0 = f(kDst, 0), g->d1 = f(kDst, 1), g->d2 = f(kDst, 2);
  g->do0 = f(kDstOff, 0), g->do1 = f(kDstOff, 1), g->do2 = f(kDstOff, 2);
  g->w0 = f(kWritten, 0), g->w1 = f(kWritten, 1), g->w2 = f(kWritten, 2);
  g->o0 = f(kOrigin, 0), g->o1 = f(kOrigin, 1), g->o2 = f(kOrigin, 2);
  g->r0 = f(kRadius, 0), g->r1 = f(kRadius, 1), g->r2 = f(kRadius, 2);
  g->L = f(kBlock, 0), g->ty = f(kBlock, 1), g->tx = f(kBlock, 2);
  g->T = f(kPlanes, 0), g->B = f(kPlanes, 1), g->ahead = f(kPlanes, 2);
  g->carry = f(kMode, 0), g->persistent = f(kMode, 1);
  g->sharded = f(kMode, 2);
  if (g->T != steps || steps < 1 || batch < 1 || g->L < 1 || g->ty < 1 ||
      g->tx < 1 || g->tx % 4 != 0 || g->ahead < 1 || g->w0 < 1 ||
      g->w1 < 1 || g->w2 < 1 || g->r0 < 1 || g->r2 < 1 ||
      g->so2 < steps * g->r2 || ntaps < 1 || ntaps > kMaxTaps ||
      (g->carry != 0 && g->carry != 1) ||
      (g->persistent != 0 && g->persistent != 1) ||
      (g->sharded != 0 && g->sharded != 1) || (g->sharded && !g->carry) ||
      g->B != g->r0)
    return false;
  g->h0 = steps * g->r0, g->h1 = steps * g->r1, g->h2 = steps * g->r2;
  g->E1 = g->ty + 2 * g->h1;
  g->E2 = g->tx + 2 * g->h2;
  g->pad = kVecCells + ((g->so2 - g->h2) & (kVecCells - 1));
  g->P = round_vec(g->E2) + 3 * kVecCells;
  g->plane = g->E1 * g->P;
  // loaded planes read behind the current group's first: the centre
  // planes of stage 1 (R), or all its streamed-axis taps (2R)
  const int back = stage0_in_registers(g->r0, g->T) ? g->r0 : 2 * g->r0;
  g->G = (back + g->B - 1) / g->B + 1 + g->ahead;
  g->D0 = g->G * g->B;
  g->Y1 = g->E1 - 2 * g->r1;
  g->j0 = (g->r2 + g->pad) / 4;
  g->NX = (g->E2 - g->r2 + g->pad + 3) / 4 - g->j0;
  g->segs = (g->w0 + g->L - 1) / g->L;
  g->tys = (g->w1 + g->ty - 1) / g->ty;
  g->txs = (g->w2 + g->tx - 1) / g->tx;
  const long long total = (long long)batch * g->segs * g->tys * g->txs;
  g->total = (int)total;
  if (g->NX * g->Y1 > kThreads) return false;
  g->planes = plane_count(*g);
  return (long long)g->plane * plane_count(*g) < (1LL << 26) &&
         total < (1LL << 31);
}

struct Item {
  int b;       // batch index
  int a, e;    // output planes [a, e) (local)
  int y0, x0;  // local coordinate of the column tile's first cell
  int steps;   // plane groups: ceil((e - a + 2h) / B)
};

__device__ __forceinline__ Item item_of(const Geo& g, int lin) {
  Item it;
  const int xi = lin % g.txs;
  lin /= g.txs;
  const int yi = lin % g.tys;
  lin /= g.tys;
  const int si = lin % g.segs;
  it.b = lin / g.segs;
  it.a = si * g.L;
  it.e = it.a + g.L < g.w0 ? it.a + g.L : g.w0;
  it.y0 = yi * g.ty;
  it.x0 = xi * g.tx;
  it.steps = (it.e - it.a + 2 * g.h0 + g.B - 1) / g.B;
  return it;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---- mbarriers and bulk copies -------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(addr),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(elem* dst, const elem* src,
                                          uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- loading the stage-0 planes ------------------------------------------------

// How one stage-0 plane of an item reads the source.  Cells past the
// source's end (the last tiles of a ragged grid) feed no stored output and
// are not loaded at all.
struct PlaneLoad {
  int pz;          // source plane
  bool fill;       // the whole plane is the boundary value
  int sx0;         // source column of stage-0 column 0
  int sc0, sc1;    // shared columns [sc0, sc1) of the bulk row copies
  int in0, in1;    // stage-0 columns [in0, in1) inside the source
  bool bulk;       // rows are copied in bulk
  bool rows;       // every row, not only the edge columns, needs cells
  bool cells;      // some cell needs a plain load
};

// How row iy of plane `pl` reads the source: 0 = copy from source row
// `*row` (a flat index of its first cell), 1 = the boundary value, 2 =
// nothing (past the source's end).  SH: the carry's mapping acts at
// global coordinates (origin + local); else local == global.
template <bool SH>
__device__ __forceinline__ int row_source(const Geo& g, const Item& it,
                                          const PlaneLoad& pl, int iy,
                                          int boundary, long long* row) {
  if (pl.fill) return 1;
  int gy = it.y0 - g.h1 + iy;  // local
  if (g.carry && boundary != kPeriodic) {
    const int oy = SH ? g.o1 : 0;
    if (boundary == kConstant && (gy + oy < 0 || gy + oy >= g.n1)) return 1;
    gy = clampi(gy + oy, 0, g.n1 - 1) - oy;
  }
  const int py = gy + g.so1;
  if (pl.pz < 0 || pl.pz >= g.s0 || py < 0 || py >= g.s1) return 2;
  *row = flat(it.b, pl.pz, py, 0, g.s0, g.s1, g.s2);
  return 0;
}

// Plane k (counted from the item's first stage-0 plane) of item `it`.
template <bool SH>
__device__ __forceinline__ PlaneLoad plane_load(const Geo& g, const Item& it,
                                                int k, int boundary) {
  PlaneLoad pl;
  const int z = it.a - g.h0 + k;  // local plane
  // global coordinate of local 0 where the carry's mapping acts
  const int oz = SH ? g.o0 : 0, oy = SH ? g.o1 : 0, ox = SH ? g.o2 : 0;
  int zs = z;
  pl.fill = false;
  const bool mapped = g.carry && boundary != kPeriodic;
  if (mapped) {
    pl.fill = boundary == kConstant && (z + oz < 0 || z + oz >= g.n0);
    zs = clampi(z + oz, 0, g.n0 - 1) - oz;
  }
  pl.pz = zs + g.so0;
  // stage-0 columns [in0, in1) lie inside the source; columns [lo, hi)
  // (beyond the stage-0 extent too) read their own source cell unmapped
  const int gx0 = it.x0 - g.h2;
  pl.sx0 = gx0 + g.so2;
  pl.in0 = max(0, -pl.sx0);
  pl.in1 = min(g.E2, g.s2 - pl.sx0);
  int lo = -pl.sx0, hi = g.s2 - pl.sx0;
  if (mapped) {
    // the clamp/constant mapping reaches every column outside the grid
    pl.in0 = 0;
    pl.in1 = g.E2;
    lo = max(lo, -(gx0 + ox));
    hi = min(hi, g.n2 - (gx0 + ox));
  }
  // 16-byte aligned ends, at most kVecCells - 1 cells past the stage-0
  // extent
  int sc0 = lo + g.pad > kVecCells ? lo + g.pad : kVecCells;
  int sc1 = min(hi + g.pad, round_vec(g.E2 + g.pad));
  sc0 = round_vec(sc0);
  sc1 = sc1 / kVecCells * kVecCells;
  pl.bulk = g.bulk && !pl.fill && sc1 > sc0;
  pl.sc0 = pl.bulk ? sc0 : 0;
  pl.sc1 = pl.bulk ? sc1 : 0;
  // rows of the boundary value: the plane, or rows outside the grid
  const int gy0 = it.y0 - g.h1;
  pl.rows = !pl.bulk || pl.fill ||
            (mapped && boundary == kConstant &&
             (gy0 + oy < 0 || gy0 + oy + g.E1 > g.n1));
  pl.cells = pl.rows || pl.sc0 - g.pad > pl.in0 ||
             pl.sc1 - g.pad < pl.in1;
  return pl;
}

// Group `kg` of item `it` (planes kg*B .. kg*B + B - 1, those past the
// item's last plane too: they feed no stored output) into ring group slot
// `slot`: warp 0 issues the bulk row copies on the slot's mbarrier (its
// arrival, with the byte count, is always made, so every slot's phase
// completes once per group); all threads load the cells the bulk copies
// leave out with plain loads and stores: every cell of a plane without
// bulk copies or with rows of the boundary value, else only the columns
// left and right of the bulk range.
template <bool SH>
__device__ void issue_group(const elem* __restrict__ src, elem* ring0,
                            unsigned long long* bars, const Geo& g,
                            const Item& it, int kg, int slot, int boundary,
                            float bval) {
  unsigned long long* bar = bars + slot;
  long long row = 0;
  if (threadIdx.x < 32) {
    const int wl = threadIdx.x;  // lane of warp 0
    uint32_t bytes = 0;
    for (int j = 0; j < g.B; ++j) {
      const PlaneLoad pl = plane_load<SH>(g, it, kg * g.B + j, boundary);
      if (!pl.bulk) continue;
      for (int iy = wl; iy < g.E1; iy += 32)
        if (row_source<SH>(g, it, pl, iy, boundary, &row) == 0)
          bytes += (uint32_t)(pl.sc1 - pl.sc0) * sizeof(elem);
    }
    bytes = __reduce_add_sync(0xffffffffu, bytes);
    if (wl == 0) mbar_arrive_tx(bar, bytes);
    __syncwarp();
    // no proxy fence here: it would wait for this warp's earlier global
    // stores; the threads that wrote cells of a ring slot with plain
    // stores fenced after them (below), and barriers separate both
    for (int j = 0; j < g.B; ++j) {
      const PlaneLoad pl = plane_load<SH>(g, it, kg * g.B + j, boundary);
      if (!pl.bulk) continue;
      elem* out = ring0 + (slot * g.B + j) * g.plane;
      for (int iy = wl; iy < g.E1; iy += 32) {
        if (row_source<SH>(g, it, pl, iy, boundary, &row) != 0) continue;
        bulk_copy(out + iy * g.P + pl.sc0,
                  src + row + pl.sx0 + (pl.sc0 - g.pad),
                  (uint32_t)(pl.sc1 - pl.sc0) * sizeof(elem), bar);
      }
    }
  }
  bool wrote = false;
  const int gx0 = it.x0 - g.h2;
  const int ox = SH ? g.o2 : 0;
  for (int j = 0; j < g.B; ++j) {
    const PlaneLoad pl = plane_load<SH>(g, it, kg * g.B + j, boundary);
    if (!pl.cells) continue;
    wrote = true;
    elem* out = ring0 + (slot * g.B + j) * g.plane;
    // columns per row: all of [in0, in1), or the edges [in0, left) and
    // [right, in1) around the bulk range
    const int left = pl.rows ? pl.in1 : max(pl.in0, pl.sc0 - g.pad);
    const int right = pl.rows ? pl.in1 : min(pl.in1, pl.sc1 - g.pad);
    const int per_row = (left - pl.in0) + (pl.in1 - right);
    const int n = g.E1 * per_row;
    for (int w = threadIdx.x; w < n; w += kThreads) {
      const int iy = w / per_row;
      int c = pl.in0 + (w - iy * per_row);
      if (c >= left) c += right - left;
      const int how = row_source<SH>(g, it, pl, iy, boundary, &row);
      if (how == 2) continue;  // past the source: not read
      elem v = to_e(bval);
      if (how == 0) {
        int gx = gx0 + c;
        bool fill = false;
        if (g.carry && boundary != kPeriodic &&
            (gx + ox < 0 || gx + ox >= g.n2)) {
          fill = boundary == kConstant;
          gx = clampi(gx + ox, 0, g.n2 - 1) - ox;
        }
        v = fill ? to_e(bval) : src[row + gx + g.so2];
      }
      out[iy * g.P + c + g.pad] = v;
    }
  }
  if (wrote) fence_proxy_async();  // before a later bulk copy reuses them
}

// The loads run `ahead` groups in front of the steps that read them, over
// the CTA's sequence of work items: issue group `pos` counted from the
// start of item `lin` (= `it`), the `count`-th group of the CTA.  A
// position past the CTA's last item issues nothing.
template <bool SH>
__device__ __forceinline__ void issue_at(const elem* __restrict__ src,
                                         elem* ring0,
                                         unsigned long long* bars,
                                         const Geo& g, int lin, Item it,
                                         int pos, unsigned count,
                                         int boundary, float bval) {
  while (pos >= it.steps) {
    pos -= it.steps;
    lin += gridDim.x;
    if (lin >= g.total) return;
    it = item_of(g, lin);
  }
  issue_group<SH>(src, ring0, bars, g, it, pos, (int)(count % g.G),
                  boundary, bval);
}

// In-plane placement of one work item: global coordinate of stage-0 cell
// (0, 0) and whether the tile reaches past the grid in-plane.
struct Frame {
  int gy0, gx0;  // global
  bool edge;

  __device__ __forceinline__ Frame(const Geo& g, const Item& it) {
    gy0 = g.o1 + it.y0 - g.h1;
    gx0 = g.o2 + it.x0 - g.h2;
    edge = gy0 < 0 || gy0 + g.E1 > g.n1 || gx0 < 0 || gx0 + g.E2 > g.n2;
  }

  __device__ __forceinline__ bool outside(const Geo& g, int iy,
                                          int c) const {
    return gy0 + iy < 0 || gy0 + iy >= g.n1 || gx0 + c < 0 ||
           gx0 + c >= g.n2;
  }

  // The stage-0 row / column of the clamped coordinate of (iy, c),
  // clipped into the region [ylo, yhi) x [xlo, xhi).
  __device__ __forceinline__ int row(const Geo& g, int iy, int ylo,
                                     int yhi) const {
    return clampi(clampi(gy0 + iy, 0, g.n1 - 1) - gy0, ylo, yhi - 1);
  }
  __device__ __forceinline__ int col(const Geo& g, int c, int xlo,
                                     int xhi) const {
    return clampi(clampi(gx0 + c, 0, g.n2 - 1) - gx0, xlo, xhi - 1);
  }
};

__device__ __forceinline__ void init_barriers(unsigned long long* bars,
                                              int n) {
  if (threadIdx.x == 0)
    for (int i = 0; i < n; ++i) mbar_init(bars + i, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
}

// The first `ahead` groups of the CTA's first work item (or items).
template <bool SH>
__device__ __forceinline__ void issue_first(const elem* __restrict__ src,
                                           elem* ring0,
                                           unsigned long long* bars,
                                           const Geo& g, int boundary,
                                           float bval) {
  if ((int)blockIdx.x >= g.total) return;
  const Item it = item_of(g, blockIdx.x);
  for (int i = 0; i < g.ahead; ++i)
    issue_at<SH>(src, ring0, bars, g, blockIdx.x, it, i, i, boundary,
                 bval);
}

// ---- the queue path ------------------------------------------------------------

// Coefficient index of a star's taps in canonical order, (streamed, y, x)
// axes: centre 0; x -1..-R, x +1..+R; (3D) y -, y +; streamed -, +.
template <int R, int ND>
struct StarIdx {
  static constexpr int xm = 1, xp = 1 + R;
  static constexpr int ym = 1 + 2 * R, yp = 1 + 3 * R;
  static constexpr int zm = ND == 3 ? 1 + 4 * R : 1 + 2 * R;
  static constexpr int zp = zm + R;
};

// The lanes of a thread's strip of kV cells (elem.cuh): 4 in float32, 2
// in 16 bits.
constexpr int kL = kStripLanes;

// kL lanes, as a streamed-axis tap reader returns them.  In float32 it
// is aligned as a float4 (16 bytes): aligned to 4, ptxas allocates the 3D
// one-step queues' registers differently (tools/sass_diff.py).
struct alignas(kLaneCells == 1 ? 16 : alignof(lane)) Strip {
  lane l[kL];
};

// One stage's four outputs of a strip: in-plane taps from the plane `in`
// (cell at `at`), streamed-axis taps `zval(d)` (the stage before at plane
// offset d: from its queue, or for stage 1 from the loaded ring), summed
// in canonical order, each multiply and add rounded to the grid's dtype,
// one lane (a cell, or a pair of cells) at a time.
template <int R, int ND, class Z>
__device__ __forceinline__ void star_strip(const elem* in, int at, int P,
                                           Z zval, lane (&acc)[kL]) {
  using I = StarIdx<R, ND>;
  constexpr int C = kLaneCells;
  // cells at - 4 .. at + 7; lane v's x tap at offset d starts at cell
  // 4 + C*v + d (lane_at joins a pair that starts at an odd cell)
  lane w[3 * kL];
  ld_lanes(in + at - 4, w);
  ld_lanes(in + at, w + kL);
  ld_lanes(in + at + 4, w + 2 * kL);
#pragma unroll
  for (int v = 0; v < kL; ++v)
    acc[v] = lmul(coef(0), lane_at(w, 4 + C * v));
#pragma unroll
  for (int d = 1; d <= R; ++d)
#pragma unroll
    for (int v = 0; v < kL; ++v)
      acc[v] = ladd(acc[v],
                    lmul(coef(I::xm + d - 1), lane_at(w, 4 + C * v - d)));
#pragma unroll
  for (int d = 1; d <= R; ++d)
#pragma unroll
    for (int v = 0; v < kL; ++v)
      acc[v] = ladd(acc[v],
                    lmul(coef(I::xp + d - 1), lane_at(w, 4 + C * v + d)));
  if constexpr (ND == 3) {
#pragma unroll
    for (int d = 1; d <= R; ++d) {
      lane y[kL];
      ld_lanes(in + at - d * P, y);
#pragma unroll
      for (int v = 0; v < kL; ++v)
        acc[v] = ladd(acc[v], lmul(coef(I::ym + d - 1), y[v]));
    }
#pragma unroll
    for (int d = 1; d <= R; ++d) {
      lane y[kL];
      ld_lanes(in + at + d * P, y);
#pragma unroll
      for (int v = 0; v < kL; ++v)
        acc[v] = ladd(acc[v], lmul(coef(I::yp + d - 1), y[v]));
    }
  }
#pragma unroll
  for (int d = 1; d <= R; ++d) {
    const Strip z = zval(-d);
#pragma unroll
    for (int v = 0; v < kL; ++v)
      acc[v] = ladd(acc[v], lmul(coef(I::zm + d - 1), z.l[v]));
  }
#pragma unroll
  for (int d = 1; d <= R; ++d) {
    const Strip z = zval(d);
#pragma unroll
    for (int v = 0; v < kL; ++v)
      acc[v] = ladd(acc[v], lmul(coef(I::zp + d - 1), z.l[v]));
  }
}

// The queue path: a star of radius R, T fused steps, groups of B = R
// planes.  At step k stage-0 planes Z .. Z + R - 1 (Z = a - h + kR) land
// and stage s computes planes Z - sR + j, j < R, from the queue of stage
// s - 1, which then holds its planes Z - sR - R .. Z - sR + 2R - 1 (Q =
// 3R values a cell): the streamed-axis taps of output j at positions
// j .. j + 2R, its centre at R + j, which the threads wrote into shared
// memory at the start of the step (from position 2R + j, before the
// stage's push), double-buffered, so one barrier a step publishes the
// loaded group and every centre group.  SH is the sharded carry
// (row_source).
template <int ND, int R, int T, bool SH>
__global__ void __launch_bounds__(kThreads, 2)
queue_kernel(const elem* __restrict__ src, elem* __restrict__ dst,
             Geo g, int boundary, float bval) {
  constexpr int Q = queue_len(R);
  constexpr int S0 = stage0_in_registers(R, T) ? 0 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  elem* smem = reinterpret_cast<elem*>(smem_raw);
  elem* ring0 = smem;
  // centre plane j of stage s at parity p: group 2(s-1) + p
  elem* cbuf = smem + g.D0 * g.plane;
  bval = rnd(bval);  // the host rounded it to the grid's dtype already
  const elem bv = to_e(bval);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(
      smem + g.plane * g.planes + kGuard);
  init_barriers(bars, g.G);

  const int tid = threadIdx.x;
  const bool mine = tid < g.NX * g.Y1;
  const int sy = mine ? tid / g.NX : 0;
  const int iy = g.r1 + sy;                                   // stage-0 row
  const int col = 4 * (g.j0 + (mine ? tid - sy * g.NX : 0));  // shared col
  const int at = iy * g.P + col;
  const int c0 = col - g.pad;  // stage-0 column of the strip's cell 0
  const bool clamp = boundary == kClamp, constant = boundary == kConstant;

  // q[s - S0]: the queue of stage s (stage 0's only if it fits
  // kQueueRegs), kL lanes a plane
  lane q[T - S0][Q][kL];
#pragma unroll
  for (int s = 0; s < T - S0; ++s)
#pragma unroll
    for (int i = 0; i < Q; ++i)
#pragma unroll
      for (int v = 0; v < kL; ++v) q[s][i][v] = splat(to_e(0.0f));

  issue_first<SH>(src, ring0, bars, g, boundary, bval);
  unsigned step = 0;  // groups consumed by this CTA
  int slot = 0;       // step % G
  unsigned parity = 0;
  for (int lin = blockIdx.x; lin < g.total; lin += gridDim.x) {
    const Item it = item_of(g, lin);
    const Frame fr(g, it);
    const bool fix = clamp && T > 1 && fr.edge;
    // the tile's extent inside the written grid
    const int th = it.y0 + g.ty < g.w1 ? g.ty : g.w1 - it.y0;
    const int tw = it.x0 + g.tx < g.w2 ? g.tx : g.w2 - it.x0;
    for (int k = 0; k < it.steps; ++k) {
      const int z = it.a - g.h0 + k * R;  // first stage-0 plane of the step
      const int par = step & 1;
      // centre planes of stages 1..T-1 for this step: positions 2R + j of
      // q[s] before this step's push
#pragma unroll
      for (int s = 1; s < T; ++s) {
        if (!mine || k < 2 * (s + 1)) continue;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          lane val[kL];
#pragma unroll
          for (int v = 0; v < kL; ++v) val[v] = q[s - S0][2 * R + j][v];
#pragma unroll
          for (int v = 0; v < kV; ++v)
            if (constant && fr.outside(g, iy, c0 + v)) set_cell(val, v, bv);
          st_lanes(cbuf + ((2 * (s - 1) + par) * R + j) * g.plane + at, val);
        }
      }
      mbar_wait(bars + slot, parity);
      __syncthreads();
      if (fix) {
        // in-plane ghost cells of the centre planes := their clamped cell
#pragma unroll
        for (int s = 1; s < T; ++s) {
          if (!mine || k < 2 * (s + 1)) continue;
          const int ylo = s * g.r1, yhi = g.E1 - s * g.r1;
          const int xlo = s * g.r2, xhi = g.E2 - s * g.r2;
          if (iy < ylo || iy >= yhi) continue;
#pragma unroll
          for (int j = 0; j < R; ++j) {
            elem* pl = cbuf + ((2 * (s - 1) + par) * R + j) * g.plane;
#pragma unroll
            for (int v = 0; v < kV; ++v) {
              const int c = c0 + v;
              if (c < xlo || c >= xhi || !fr.outside(g, iy, c)) continue;
              pl[at + v] = pl[fr.row(g, iy, ylo, yhi) * g.P +
                              fr.col(g, c, xlo, xhi) + g.pad];
            }
          }
        }
        __syncthreads();
      }
      issue_at<SH>(src, ring0, bars, g, lin, it, k + g.ahead,
                   step + g.ahead, boundary, bval);
      // ring plane of stage-0 plane z + d (d >= -2R), d counted in planes
      const int base = (int)((step * R) % g.D0);
      auto ring = [&](int d) {
        int sl = base + d;
        sl += sl < 0 ? g.D0 : 0;
        return ring0 + sl * g.plane;
      };
      if (++slot == g.G) {
        slot = 0;
        parity ^= 1;
      }
      ++step;
      if (!mine) continue;
      if constexpr (S0 == 0) {
#pragma unroll
        for (int i = 0; i < Q - R; ++i)
#pragma unroll
          for (int v = 0; v < kL; ++v) q[0][i][v] = q[0][i + R][v];
#pragma unroll
        for (int j = 0; j < R; ++j) ld_lanes(ring(j) + at, q[0][Q - R + j]);
      }
#pragma unroll
      for (int s = 1; s <= T; ++s) {
        if (k < 2 * s) continue;
        bool live;
        if (s < T)
          live = iy >= s * g.r1 && iy < g.E1 - s * g.r1 &&
                 c0 + kV > s * g.r2 && c0 < g.E2 - s * g.r2;
        else
          live = iy >= g.h1 && iy < g.h1 + th && c0 + kV > g.h2 &&
                 c0 < g.h2 + tw;
        if (!live) continue;
        if (s < T) {
          // make room for this step's R planes
          auto& qs = q[s - S0 < T - S0 ? s - S0 : 0];
#pragma unroll
          for (int i = 0; i < Q - R; ++i)
#pragma unroll
            for (int v = 0; v < kL; ++v) qs[i][v] = qs[i + R][v];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int p = z - s * R + j;  // this output's plane (local)
          const elem* in =
              s == 1 ? ring(j - R) + 0
                     : cbuf + ((2 * (s - 2) + par) * R + j) * g.plane;
          lane acc[kL];
          if (s - 1 >= S0) {
            const auto& qp = q[s - 1 - S0 < 0 ? 0 : s - 1 - S0];
            star_strip<R, ND>(in, at, g.P, [&](int d) {
              Strip t;
#pragma unroll
              for (int v = 0; v < kL; ++v) t.l[v] = qp[R + j + d][v];
              return t;
            }, acc);
          } else {
            star_strip<R, ND>(in, at, g.P, [&](int d) {
              Strip t;
              ld_lanes(ring(j - R + d) + at, t.l);
              return t;
            }, acc);
          }
          if (s == T) {
            if (p < it.a || p >= it.e) continue;
            elem* row = dst + flat(it.b, p + g.do0,
                                    it.y0 + iy - g.h1 + g.do1,
                                    it.x0 - g.h2 + g.do2, g.d0, g.d1, g.d2);
#pragma unroll
            for (int v = 0; v < kV; ++v) {
              const int c = c0 + v;
              if (c >= g.h2 && c < g.h2 + tw) row[c] = cell(acc, v);
            }
            continue;
          }
          auto& qs = q[s - S0 < T - S0 ? s - S0 : 0];
          const int gp = g.o0 + p;
          if (constant && (gp < 0 || gp >= g.n0)) {
#pragma unroll
            for (int v = 0; v < kL; ++v) acc[v] = splat(bv);
          } else if (clamp && gp >= g.n0) {
            // a copy of plane n - 1: the plane before this one
#pragma unroll
            for (int v = 0; v < kL; ++v) acc[v] = qs[Q - R + j - 1][v];
          }
#pragma unroll
          for (int v = 0; v < kL; ++v) qs[Q - R + j][v] = acc[v];
          if (clamp && gp == 0) {
            // planes -R..-1 are copies of plane 0
#pragma unroll
            for (int d = 1; d <= R; ++d)
#pragma unroll
              for (int v = 0; v < kL; ++v) qs[Q - R + j - d][v] = acc[v];
          }
        }
      }
    }
  }
}

using QueueFn = void (*)(const elem*, elem*, Geo, int, float);

// The queue path's instantiations: stars of radius 1..4 in 2D and 3D,
// up to QUEUE_STEPS[ndim][R] fused steps (core/blocking.py), what fits
// 128 registers without spilling in every dtype; each for one device's
// carry and the pre-padded grids (SH false) and for a mesh shard's carry
// (SH true).
template <bool SH>
QueueFn choose_queue(int nd, int r, int t) {
  switch (nd * 100 + r * 10 + t) {
    case 211: return queue_kernel<2, 1, 1, SH>;
    case 212: return queue_kernel<2, 1, 2, SH>;
    case 213: return queue_kernel<2, 1, 3, SH>;
    case 214: return queue_kernel<2, 1, 4, SH>;
    case 221: return queue_kernel<2, 2, 1, SH>;
    case 222: return queue_kernel<2, 2, 2, SH>;
    case 223: return queue_kernel<2, 2, 3, SH>;
    case 231: return queue_kernel<2, 3, 1, SH>;
    case 232: return queue_kernel<2, 3, 2, SH>;
    case 241: return queue_kernel<2, 4, 1, SH>;
    case 242: return queue_kernel<2, 4, 2, SH>;
    case 311: return queue_kernel<3, 1, 1, SH>;
    case 312: return queue_kernel<3, 1, 2, SH>;
    case 313: return queue_kernel<3, 1, 3, SH>;
    case 314: return queue_kernel<3, 1, 4, SH>;
    case 321: return queue_kernel<3, 2, 1, SH>;
    case 322: return queue_kernel<3, 2, 2, SH>;
    case 323: return queue_kernel<3, 2, 3, SH>;
    case 331: return queue_kernel<3, 3, 1, SH>;
    case 332: return queue_kernel<3, 3, 2, SH>;
    case 341: return queue_kernel<3, 4, 1, SH>;
    default: return nullptr;
  }
}

// The coefficient bank (c_coef) is free for a launch once the previous
// launch of this source on the device has run: one event per device marks
// that, and the next launch's stream waits for it before its copy.  So two
// streams that launch these kernels take turns on the device; on one
// stream the wait costs nothing.
constexpr int kMaxDevices = 64;
std::mutex g_bank_mutex;
cudaEvent_t g_bank_free[kMaxDevices] = {};

int launch(const void* src, void* dst, const void* coef, int ntaps,
           int steps, int boundary, float bval, const long long* geometry,
           int batch, int device, void* stream) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Geo g;
  if (!make_geo(geometry, steps, batch, ntaps, &g))
    return cudaErrorInvalidConfiguration;
  g.bulk = g.s2 % kVecCells == 0 &&
           reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const int nd = g.r1 == 0 ? 2 : 3;
  const QueueFn q = g.sharded ? choose_queue<true>(nd, g.r0, g.T)
                              : choose_queue<false>(nd, g.r0, g.T);
  if (q == nullptr) return cudaErrorInvalidConfiguration;
  const void* fn = reinterpret_cast<const void*>(q);
  const size_t smem = smem_bytes(g);
  if ((long long)smem != geometry[3 * kBytes])
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long blocks = g.total;
  if (g.persistent) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                        smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long resident = (long long)per_sm * sms;
    if (blocks > resident) blocks = resident;
  }
  std::lock_guard<std::mutex> lock(g_bank_mutex);
  cudaEvent_t& bank_free = g_bank_free[device];
  if (bank_free == nullptr)
    err = cudaEventCreateWithFlags(&bank_free, cudaEventDisableTiming);
  else
    err = cudaStreamWaitEvent(st, bank_free, 0);
  if (err != cudaSuccess) return err;
  err = cudaMemcpyToSymbolAsync(c_coef, coef, sizeof(coef_t) * ntaps, 0,
                                cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return err;
  q<<<(unsigned)blocks, kThreads, smem, st>>>(
      static_cast<const elem*>(src), static_cast<elem*>(dst), g, boundary,
      bval);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cudaEventRecord(bank_free, st);
}

}  // namespace

extern "C" {

const char* queued_superstep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One launch on `stream` of B1, B5 or B6 (the geometry says which);
// returns a cudaError_t (0 on success).  `geometry` is the host array of
// Field, `steps` the fused steps T, `coef` the device coefficients in
// canonical order; `offs` (the other superstep launchers' tap table) is
// not read: a star's taps are compile-time constants here.
int queued_superstep_launch(const void* src, void* dst, const void* coef,
                            const void* offs, int ntaps, int steps,
                            int boundary, float bval,
                            const long long* geometry, int batch, int device,
                            void* stream) {
  (void)offs;
  return launch(src, dst, coef, ntaps, steps, boundary, bval, geometry,
                batch, device, stream);
}

}  // extern "C"
