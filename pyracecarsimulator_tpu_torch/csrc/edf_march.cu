// EDF ray march and its gradient: every ray sphere-traces the euclidean
// distance field in a loop of its own, in registers, until it stops.
//
// Replaces three XLA loops of the JAX package, none of them a Pallas
// kernel:
//   pyracecarsimulator_tpu/ops/raymarch_xla.py::march_rays, the fixed-trip
//     lax.scan at :139 (backends "edf" and "edf_bilinear"), and its
//     transpose under jax.grad (the gradient of "edf_bilinear", and of a
//     march whose EDF is differentiated), and
//   pyracecarsimulator_tpu/ops/raymarch_diff.py::_fwd_impl, the
//     lax.while_loop of _march_nearest at :116 (the bracket of
//     "edf_implicit") and the lax.fori_loop of _refine at :150 (its
//     bisection), fused: the lane that marched a ray refines its hit.
// and, in the backward of "edf_implicit" scans taken from poses, the XLA
// code of _mri_bwd (pyracecarsimulator_tpu/ops/raymarch_diff.py:214, the
// custom_vjp's backward of _fwd_impl) composed with the transpose of the
// beam fan (ops/common.py rays_from_poses), fused into one kernel of the
// pose cotangent (implicit_pose_vjp_kernel, below).
// The JAX package has no Pallas march because a TPU has no vector gather
// (raymarch_xla.py's module doc): every trip gathers the EDF at a
// data-dependent cell. Hopper gathers natively, and each bundled map's EDF
// (levine 6.8 MB, berlin 5.8 MB of float32) stays in the 50 MB L2.
//
// What the march computes, per ray i (origin x0/y0, direction cos/sin):
//     gx = (x - ox) * inv_res,  gy = (y - oy) * inv_res
//     d  = sample(gx, gy): the nearest cell's EDF value, or the bilinear
//          value in the cell-centre convention; -1 outside bounds (h, w)
//     d < 0            -> the ray left the map: total = max_range, stop
//     d <= eps         -> hit, stop
//     total >= max_range -> stop
//     else x += d * cos, y += d * sin, total += d, last = d
// for at most max_iters trips. The reference's fixed-trip loop steps a
// stopped ray by zero, which changes none of its values, so a ray that
// leaves its loop early has what the fixed-trip loop would. Variants (a
// template argument):
//   kNearest  : the clamped total ("edf"),
//   kBilinear : the clamped total of the bilinear march ("edf_bilinear"),
//   kImplicit : the range and hit flag of "edf_implicit"
//               (ops/raymarch_diff.py _fwd_impl): the nearest march gives
//               the bracket [max(total - last, 0), total + top] of a hit;
//               12 bisections of F(r) = E(p(r)) - tau, E the bilinear patch
//               (_bilinear_patch: no bounds test, the taps of the clamped
//               base), then one Newton step from the bracket's outside end
//               with a slope floor, clamped into the bracket; a miss keeps
//               its clamped total; the range is clamped to max_range and
//               the hit flag is the march's hit with a range below it.
//               tau, top (0.4 * resolution) and the slope floor come from
//               the host, each rounded once to float32, as the plain
//               version hands them to the card.
// With `walk_out` set, the march also writes what its gradient needs of
// each ray: the steps it took when its range has a gradient in its total,
// else -1 (it left the map, or the clamp cut its total).
//
// The gradient (edf_march_grad_kernel, variants kNearest and kBilinear):
// given the cotangent g of the clamped ranges, what autograd computes
// through the plain loop (ops/raymarch_xla.py march_rays_plain). A ray that
// left the map, or whose total passed max_range, has none; else gt = g.
//   kNearest : the ray's cells are integers, so only the EDF gets a
//              gradient: gt at the cell of each of the ray's steps.
//   kBilinear: the reverse of the trips, last to first, with the adjoints
//              (ax, ay) of the ray's position and gt of its total:
//                gd = gt + ay * sin + ax * cos     (the step d's adjoint)
//                g_cos += ax * d,  g_sin += ay * d
//                (ax, ay) += gd * grad d            (inside the clamps)
//                the EDF's 4 taps += gd * their bilinear weights
//              ending in the origin's adjoints (g_x0, g_y0) = (ax, ay).
// The gradient takes the forward's `walk` record (edf_march's, of the same
// rays), so a ray's steps and whether it has a gradient are known before
// its first trip: the nearest gradient walks each ray once, adding as it
// goes; the bilinear one walks it forward once, keeping each trip's
// position in the thread's kSlots (a local array: 512 bytes a thread,
// cached in L1), then reads them back in reverse. A ray longer than kSlots
// keeps kSlots / 2 checkpoints there and marches each segment again from
// its checkpoint, kSlots / 2 positions at a time (any length: a segment
// longer than that is marched again for each part).
//
// The pose VJP (implicit_pose_vjp_kernel): given the cotangent g of the
// ranges of a scan taken from poses (x0, y0, theta), the poses' cotangent
// (N, 3). The implicit function theorem at the refined hit r (the module
// doc of ops/raymarch_diff.py) gives, per ray, with scale = -g / (dE/dr)
// where the hit is on the level set and not grazing (else 0) and (ex, ey)
// the EDF's world-space slope at p(r): d/dx0 scale * ex, d/dy0 scale * ey,
// and d/dtheta scale * r * (ey * ct - ex * st), the derivative that autograd
// reaches through the fan's rotation and the heading's cos and sin
// (d ct / d theta = -st, d st / d theta = ct). Each agent sums its beams'
// terms. The port ran this as ~120 PyTorch passes over the (agents,
// beams) rays (the per-ray VJP, the fan's products and the sums over the
// beams: ~1.5 ms a step at 4096 x 1080). What bounds it on the H100: the
// bytes of g, r and the hit flag (9 B a ray, ~40 MB, ~12 us at 3.35 TB/s);
// the operations (~80 a hit ray) are a little less; the 4 taps of a hit
// come from the L2, where the EDF stays. So the kernel waits on memory:
// a ray's reads, then its taps (which depend on its range), two latencies
// a ray. The design: one block an agent, each thread a strided share of
// its beams (coalesced reads of g, r and the flag), kVjpBatch rays of a
// thread in flight at once (their reads issued together, then their taps,
// predicated on the hit: a miss reads no tap), the direction recomputed
// from the agent's cos and sin of the heading and the offsets' (6
// operations, where reading the forward's (N, B) cosines would cost 8 B a
// ray and their memory until the backward), and the sum in a fixed order
// (each thread's beams in order, a shuffle tree over a warp's lanes, the
// block's warps in order): no atomics, the same bits from run to run.
// Measured on an H100 at 4096 x 1080 (PERF.md): 128 threads and 3 rays in
// flight 0.031 ms, one ray at a time 0.039-0.041, 256 threads 0.040-0.041,
// 64 threads and 4 rays 0.038. The
// terms are _hit_scale's and _pose_terms' float32 operations in their
// order, so each equals the plain version's bit for bit; the sums differ
// from torch.sum's by their order.
//
// Exact arithmetic: built with -fmad=false and no fast math, every float32
// operation of the march in the order of the plain PyTorch loops
// (ops/raymarch_xla.py march_rays_plain, ops/raymarch_diff.py
// _march_nearest_plain and, for kImplicit, _fwd_plain: its bisection and
// Newton step in _refine's order, `f / safe` an IEEE division, every
// torch.clamp, torch.minimum and torch.maximum with torch's NaN rule, the
// patch's value and slope in _bilinear_patch's order): the march equals
// them bit for bit. Cell indices
// are 32-bit (the wrapper refuses a map or a ray layout past 2^31 - 1
// elements), with the plain loops' in-bounds decisions for every float,
// NaN and |g| past 2^31 included (nearest_cell says why). The gradient
// adds its terms in the order in which autograd accumulates them through
// the plain loop, so the rays' gradients equal autograd's bit for bit; the
// EDF's taps are summed with atomics, in another order than autograd's
// scatter: equal to float32 rounding of the sum, not bit for bit.
//
// Work distribution: persistent warps. A launch has about one wave of
// blocks (the SMs times the blocks an SM holds, from the occupancy API,
// computed once per kernel and device). A block takes groups of kGroup
// chunks of 32 consecutive rays (512 neighbouring beams) from a cursor in
// the launch's zeroed scratch, one atomicAdd a group, and hands their
// chunks to its warps through shared memory, so that the warps of an SM
// gather near each other (L1 hits). A warp takes a chunk, one ray a lane,
// when all its lanes are done, and each lane runs its ray to its end. No
// block barrier: a block no longer waits for its longest ray.
//
// Inputs: the ray tensors are read through their strides as (rows, cols)
// views, so the scan's expanded origin views (one origin per agent, stride
// 0 along the beams) are never copied. The map origin comes as two device
// scalars (no host read). Trips: with `trips_out` set, each ray's trip
// count; always, the largest trip count of the launch is added to
// counter[0] and 1 to counter[1]: each warp raises scratch[0] to its
// longest ray's trips (a warp reduction) and counts itself in scratch[1],
// and the last warp adds scratch[0] to the counter. The scratch is the
// launch's own, zeroed before it, so that launches on concurrent streams
// never share it; a replayed CUDA graph counts too, and the host reads the
// counter only when asked.
//
// Bound on the H100, and what the design does about it. Each trip is one
// dependent gather (four for bilinear) of a 32-byte sector plus a few
// dozen operations. At 4096 x 1080 rays the bytes (rays in and out, the
// EDF once) are ~60 MB, ~0.02 ms at 3.35 TB/s; the operations (the per-ray
// trips times the function's operations a trip) are the larger term, and
// the bound. What the card spends beyond it: the lanes a warp leaves idle
// while its longest ray marches (1.3x the per-ray trips, 2.7x on berlin's
// bilinear march), the latency of each trip's dependent gather, and the
// gathers' sectors (~30 B fetched for each 4 B used), which L1 serves only
// where the warps of an SM march neighbouring beams. The design: a trip
// loop that issues ~36 instructions (nearest; 59 with int64 indices and
// one ray a thread): 32-bit cell indices and floor-and-convert in one
// instruction, the reference's arithmetic unchanged (no incremental gx:
// it rounds differently); persistent warps (a block of one ray a thread
// held its SM's slot as long as its longest ray); block-shared groups of
// rays for L1 locality (warps that each take their next 32 rays from the
// launch's one cursor march unrelated beams side by side: the nearest and
// implicit marches measured up to 1.6x slower). Refilling single lanes as
// their rays stop, the lanes tripping together until one stops, measured
// slower than whole warps in every variant on both maps (each refill costs
// a ray load and a pass of bookkeeping), so the warps refill whole, in the
// gradient too. The gradient: it marched every ray twice and kept its
// trips in 768 bytes of local memory a thread (checkpoints and a segment
// indexed at run time); it now walks each ray forward once from the
// record, keeps 64 positions a thread, and adds the taps of the lanes that
// share a cell once per cell (__match_any_sync, then a tree sum over the
// group's lanes in rank order). The positions live in local memory: in
// shared memory (32 a thread, threadIdx-strided) the bilinear gradient
// measured 5% slower on levine and 19% on berlin, because the 64 KB a
// block takes from the SM's 256 KB of L1 and shared memory are the
// gathers' L1. scripts/march_variants_torch.py times both left-out
// designs beside this source. The implicit variant refines a hit in the
// lane that marched it: 13 patch evaluations (4 dependent gathers and ~45
// operations each) in registers, where the plain version ran ~1,090
// elementwise passes over the (rays,) tensors; a miss writes its range at
// once. Its bisection loop is not unrolled (#pragma unroll 1), so that the
// kernel keeps the march's register budget. Considered and left out:
// texture sampling (8-bit interpolation weights: not the function), a
// blocked EDF layout, TMA or shared-memory tiles of the EDF (the gathers
// depend on the data, and neither map's EDF fits in shared memory; both
// stay in L2). PERF.md holds the times measured on an H100, each with the
// card's power limit.

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kChunk = 32;  // rays a warp takes at once
constexpr int kGroup = 16;  // chunks a block takes from the cursor at once
constexpr int kNearest = 0;
constexpr int kBilinear = 1;
constexpr int kImplicit = 2;
// the implicit variant's bisections (ops/raymarch_diff.py _refine's iters)
constexpr int kBisections = 12;
// the march's blocks an SM holds at least (so at most 40 registers a
// thread: without it ptxas holds the march to 32 and spills)
constexpr int kMarchBlocks = 6;
// positions of a ray the bilinear gradient keeps (8 bytes each); a longer
// ray is marched again from kSlots / 2 checkpoints
constexpr int kSlots = 64;

struct Rays {
  const float* x0;
  const float* y0;
  const float* c;
  const float* s;
  int sx[2], sy[2], sc[2], ss[2];  // (row, col) strides, elements
};

struct Map {
  const float* edf;
  int hp, wp;  // the (padded) array
  int h, w;    // the real map: the in-bounds test
};

// What every launch of either kernel takes.
struct Args {
  Map m;
  Rays r;
  const float* ox;
  const float* oy;
  float inv_res, max_range, eps;
  // kImplicit: the level set tau, the bracket's top past the march stop
  // (0.4 * resolution) and the slope floor (_DENOM_FLOOR); 0 otherwise
  float tau, top, slope_floor;
  int max_iters;
  int n, cols;  // rays, and the columns of their (rows, cols) views
  // i / cols = (i * col_magic) >> col_shift for 0 <= i < 2^31
  unsigned long long col_magic;
  int col_shift;
};

// One ray's inputs, read through the strides.
struct Ray {
  float x, y, c, s;
};

__device__ __forceinline__ Ray load_ray(const Args& a, int i) {
  const int row = static_cast<int>(
      (static_cast<unsigned long long>(i) * a.col_magic) >> a.col_shift);
  const int col = i - row * a.cols;
  const Rays& r = a.r;
  return {__ldg(r.x0 + (row * r.sx[0] + col * r.sx[1])),
          __ldg(r.y0 + (row * r.sy[0] + col * r.sy[1])),
          __ldg(r.c + (row * r.sc[0] + col * r.sc[1])),
          __ldg(r.s + (row * r.ss[0] + col * r.ss[1]))};
}

// The nearest cell's flat index, or -1 outside the real map. The plain
// loops test floor(g) converted to int64 against [0, w). The same decision
// for every float: a NaN or negative g fails g >= 0 (NaN converts to
// INT64_MIN there), and for g >= 0 the 32-bit floor-and-convert
// (cvt.rmi.s32.f32, one instruction) saturates at 2^31 - 1 >= w, outside
// as in int64.
__device__ __forceinline__ int nearest_cell(const Map& m, float gx,
                                            float gy) {
  if (!(gx >= 0.0f && gy >= 0.0f)) return -1;
  const int ix = __float2int_rd(gx);
  const int iy = __float2int_rd(gy);
  if (ix >= m.w || iy >= m.h) return -1;
  return min(iy, m.hp - 1) * m.wp + min(ix, m.wp - 1);
}

__device__ __forceinline__ float sample_nearest(const Map& m, float gx,
                                                float gy) {
  const int cell = nearest_cell(m, gx, gy);
  return cell < 0 ? -1.0f : __ldg(m.edf + cell);
}

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  // torch.clamp: NaN passes through
  return v < lo ? lo : (v > hi ? hi : v);
}

// The bilinear sample's taps, weights and partial sums.
struct Bilinear {
  float fx, fy, gx1, gy1;  // the fractions and 1 - them
  float f00, f01, f10, f11;
  int base;                // the lower-left tap's flat index
  float lo, hi;            // the rows' blends: f00..f01 and f10..f11
  float value;             // lo * gy1 + hi * fy
};

// False outside the real map; else the taps at (gx, gy), the integer base
// clamped so that all 4 taps stay in bounds (ops/raymarch_xla.py
// _bilinear_taps).
__device__ __forceinline__ bool bilinear(const Map& m, float gx, float gy,
                                         Bilinear& b) {
  if (!(gx >= 0.0f && gy >= 0.0f && gx < static_cast<float>(m.w) &&
        gy < static_cast<float>(m.h))) {
    return false;
  }
  const float xs = clamp_nan(gx - 0.5f, 0.0f, static_cast<float>(m.wp - 1));
  const float ys = clamp_nan(gy - 0.5f, 0.0f, static_cast<float>(m.hp - 1));
  float x0 = floorf(xs);
  float y0 = floorf(ys);
  const float xmax = static_cast<float>(m.wp - 2);
  const float ymax = static_cast<float>(m.hp - 2);
  x0 = x0 > xmax ? xmax : x0;
  y0 = y0 > ymax ? ymax : y0;
  b.fx = xs - x0;
  b.fy = ys - y0;
  b.base = static_cast<int>(y0) * m.wp + static_cast<int>(x0);
  b.f00 = __ldg(m.edf + b.base);
  b.f01 = __ldg(m.edf + b.base + 1);
  b.f10 = __ldg(m.edf + b.base + m.wp);
  b.f11 = __ldg(m.edf + b.base + m.wp + 1);
  b.gx1 = 1.0f - b.fx;
  b.gy1 = 1.0f - b.fy;
  b.lo = b.f00 * b.gx1 + b.f01 * b.fx;
  b.hi = b.f10 * b.gx1 + b.f11 * b.fx;
  b.value = b.lo * b.gy1 + b.hi * b.fy;
  return true;
}

__device__ __forceinline__ float sample_bilinear(const Map& m, float gx,
                                                 float gy) {
  Bilinear b;
  return bilinear(m, gx, gy, b) ? b.value : -1.0f;
}

template <int V>
__device__ __forceinline__ float sample(const Map& m, float gx, float gy) {
  return V == kBilinear ? sample_bilinear(m, gx, gy)
                        : sample_nearest(m, gx, gy);
}

// torch.maximum and torch.minimum: a NaN operand gives NaN (fmaxf and fminf
// would return the other operand)
__device__ __forceinline__ float maximum_nan(float a, float b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

__device__ __forceinline__ float minimum_nan(float a, float b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}

// The 4 taps of ops/raymarch_diff.py _bilinear_patch at (gx, gy): the
// fractions and the EDF at the clamped base. No bounds test: the taps of
// the clamped base, as bilinear() takes them. A NaN coordinate converts to
// cell 0 (__float2int_rz), so the taps stay in the map. With `load` false
// the EDF is not read (the taps are 0).
struct Patch {
  float fx, fy;
  float f00, f01, f10, f11;
};

__device__ __forceinline__ void patch_taps(const Map& m, float gx, float gy,
                                           bool load, Patch& p) {
  const float xs = clamp_nan(gx - 0.5f, 0.0f, static_cast<float>(m.wp - 1));
  const float ys = clamp_nan(gy - 0.5f, 0.0f, static_cast<float>(m.hp - 1));
  float x0 = floorf(xs);
  float y0 = floorf(ys);
  const float xmax = static_cast<float>(m.wp - 2);
  const float ymax = static_cast<float>(m.hp - 2);
  x0 = x0 > xmax ? xmax : x0;
  y0 = y0 > ymax ? ymax : y0;
  p.fx = xs - x0;
  p.fy = ys - y0;
  const int base = __float2int_rz(y0) * m.wp + __float2int_rz(x0);
  p.f00 = load ? __ldg(m.edf + base) : 0.0f;
  p.f01 = load ? __ldg(m.edf + base + 1) : 0.0f;
  p.f10 = load ? __ldg(m.edf + base + m.wp) : 0.0f;
  p.f11 = load ? __ldg(m.edf + base + m.wp + 1) : 0.0f;
}

// _bilinear_patch's value and, with kSlope, its grid-space slope (dgx,
// dgy) from the taps, in its order of operations.
template <bool kSlope>
__device__ __forceinline__ float patch_value(const Patch& p, float& dgx,
                                             float& dgy) {
  const float gx1 = 1.0f - p.fx;
  const float gy1 = 1.0f - p.fy;
  if (kSlope) {
    dgx = (p.f01 - p.f00) * gy1 + (p.f11 - p.f10) * p.fy;
    dgy = (p.f10 - p.f00) * gx1 + (p.f11 - p.f01) * p.fx;
  }
  return (p.f00 * gx1 + p.f01 * p.fx) * gy1 +
         (p.f10 * gx1 + p.f11 * p.fx) * p.fy;
}

// ops/raymarch_diff.py _bilinear_patch at (gx, gy): the value and, with
// kSlope, the grid-space slope (dgx, dgy). A NaN coordinate gives NaN.
template <bool kSlope>
__device__ __forceinline__ float patch(const Map& m, float gx, float gy,
                                       float& dgx, float& dgy) {
  Patch p;
  patch_taps(m, gx, gy, true, p);
  return patch_value<kSlope>(p, dgx, dgy);
}

// ops/raymarch_diff.py _refine for a hit of ray `ray` whose march stopped
// at `total` after a last step `last`: kBisections halvings of the bracket,
// then the Newton step from its outside end, clamped into it.
__device__ __forceinline__ float refine(const Args& a, float ox, float oy,
                                        const Ray& ray, float total,
                                        float last) {
  float lo = total - last;
  lo = lo < 0.0f ? 0.0f : lo;  // torch.clamp(min=0): NaN passes
  float hi = total + a.top;
  float dgx, dgy;
#pragma unroll 1
  for (int k = 0; k < kBisections; ++k) {
    const float r = 0.5f * (lo + hi);
    const float gx = ((ray.x + r * ray.c) - ox) * a.inv_res;
    const float gy = ((ray.y + r * ray.s) - oy) * a.inv_res;
    // still outside (F > 0): the crossing is beyond r
    if (patch<false>(a.m, gx, gy, dgx, dgy) - a.tau > 0.0f) {
      lo = r;
    } else {
      hi = r;
    }
  }
  const float gx = ((ray.x + lo * ray.c) - ox) * a.inv_res;
  const float gy = ((ray.y + lo * ray.s) - oy) * a.inv_res;
  const float f = patch<true>(a.m, gx, gy, dgx, dgy) - a.tau;
  const float df = (dgx * ray.c + dgy * ray.s) * a.inv_res;
  const float safe = df > -a.slope_floor ? -a.slope_floor : df;
  return minimum_nan(maximum_nan(lo - f / safe, lo), hi);
}

// -- persistent warps ------------------------------------------------------

__device__ __forceinline__ unsigned warps_in_grid() {
  return gridDim.x * kWarps;
}

// The block's share of the rays: a group of kGroup chunks of 32 (a few
// hundred neighbouring beams, so that the warps of an SM gather from
// neighbouring cells: L1 hits), handed to its warps one chunk at a time.
// (group << 32) | chunks taken, in shared memory.
__device__ __forceinline__ void block_start(unsigned long long* group) {
  if (threadIdx.x == 0) {
    *group = (static_cast<unsigned long long>(blockIdx.x) << 32) | kWarps;
  }
  __syncthreads();
}

// The next chunk of the block's group; the warp that finds the group spent
// takes the next group from the cursor (one atomicAdd a group), and the
// others wait for it. Called by one lane of a warp.
__device__ __forceinline__ unsigned long long take_chunk(
    unsigned long long* group, unsigned long long* cursor) {
  for (;;) {
    const unsigned long long v = atomicAdd(group, 1ULL);
    const unsigned long long g = v >> 32;
    const unsigned long long taken = v & 0xffffffffULL;
    if (taken < kGroup) return g * kGroup + taken;
    if (taken == kGroup) {
      atomicExch(group, (gridDim.x + atomicAdd(cursor, 1ULL)) << 32);
      continue;
    }
    while ((*reinterpret_cast<volatile unsigned long long*>(group) >> 32) ==
           g) {
    }
  }
}

// The warp's first chunk: its block's first group's, by its place in the
// block.
__device__ __forceinline__ unsigned long long first_chunk() {
  return static_cast<unsigned long long>(blockIdx.x) * kGroup +
         threadIdx.x / 32;
}

// The warp's next chunk: lane 0 takes it, every lane gets it. Called by
// the whole warp.
__device__ __forceinline__ unsigned long long next_chunk(
    unsigned long long* group, unsigned long long* cursor) {
  unsigned long long chunk = 0;
  if ((threadIdx.x & 31) == 0) chunk = take_chunk(group, cursor);
  return __shfl_sync(kAll, chunk, 0);
}

// Adds the launch's largest trip count and one call to counter[0..1]: each
// warp raises scratch[0] to its longest ray's trips and counts itself in
// scratch[1]; the last warp to count adds scratch[0] to the counter.
// `scratch` is the launch's own, zeroed before it. Called by the whole
// warp.
__device__ __forceinline__ void count_trips(
    int trips, unsigned long long* __restrict__ counter,
    unsigned long long* __restrict__ scratch) {
  const int most = __reduce_max_sync(kAll, trips);
  if ((threadIdx.x & 31) != 0) return;
  atomicMax(&scratch[0], static_cast<unsigned long long>(most));
  __threadfence();
  const unsigned long long done = atomicAdd(&scratch[1], 1ULL);
  if (done == warps_in_grid() - 1ULL) {
    __threadfence();
    atomicAdd(&counter[0], atomicAdd(&scratch[0], 0ULL));
    atomicAdd(&counter[1], 1ULL);
  }
}

// -- the march ---------------------------------------------------------------

// One ray in flight: its state between trips.
struct March {
  float x, y, c, s;
  float total, last;
  float d;      // the last sample
  int it;       // trips so far
  bool tested;  // it stopped on a test (else it ran out of trips)
};

// One trip; true when the ray stops (the reference loop's order of tests).
template <int V>
__device__ __forceinline__ bool trip(const Args& a, float ox, float oy,
                                     March& r) {
  if (r.it >= a.max_iters) {
    r.tested = false;
    return true;
  }
  r.d = sample<V>(a.m, (r.x - ox) * a.inv_res, (r.y - oy) * a.inv_res);
  ++r.it;
  // d < 0: left the map; d <= eps: hit; total >= max_range (NaN d steps)
  if (r.d < 0.0f || r.d <= a.eps || !(r.total < a.max_range)) {
    r.tested = true;
    return true;
  }
  r.last = r.d;
  r.x = r.x + r.d * r.c;
  r.y = r.y + r.d * r.s;
  r.total = r.total + r.d;
  return false;
}

// A warp takes 32 rays at a time; each lane trips until its ray stops,
// and the warp takes the next 32 when all are done.
template <int V>
__global__ void __launch_bounds__(kThreads, kMarchBlocks) edf_march_kernel(
    Args a, float* __restrict__ total_out, bool* __restrict__ hit_out,
    int* __restrict__ trips_out, int* __restrict__ walk_out,
    unsigned long long* __restrict__ counter,
    unsigned long long* __restrict__ scratch) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned n = static_cast<unsigned>(a.n);
  const float ox = __ldg(a.ox);
  const float oy = __ldg(a.oy);
  __shared__ unsigned long long group;
  block_start(&group);
  int longest = 0;
  for (unsigned long long chunk = first_chunk(); chunk * kChunk < n;
       chunk = next_chunk(&group, scratch + 2)) {
    const unsigned long long ray_index = chunk * kChunk + lane;
    if (ray_index < n) {
      const int i = static_cast<int>(ray_index);
      const Ray ray = load_ray(a, i);
      March r{ray.x, ray.y, ray.c, ray.s, 0.0f, 0.0f, 0.0f, 0, false};
      while (!trip<V>(a, ox, oy, r)) {
      }
      const bool left = r.tested && r.d < 0.0f;
      if (left) r.total = a.max_range;
      if (V == kImplicit) {
        const bool hit = r.tested && !left && r.d <= a.eps;
        // torch.clamp(max=): NaN passes
        float range = r.total > a.max_range ? a.max_range : r.total;
        if (hit) {
          range = refine(a, ox, oy, ray, r.total, r.last);
          range = range > a.max_range ? a.max_range : range;
        }
        total_out[i] = range;
        hit_out[i] = hit && range < a.max_range;
      } else {
        total_out[i] = r.total > a.max_range ? a.max_range : r.total;
      }
      if (trips_out != nullptr) trips_out[i] = r.it;
      if (walk_out != nullptr) {
        walk_out[i] =
            (!left && r.total <= a.max_range) ? r.it - r.tested : -1;
      }
      longest = max(longest, r.it);
    }
  }
  count_trips(longest, counter, scratch);
}

// -- the gradient ------------------------------------------------------------

// The lane of rank `rank` among the set bits of `mask` (a binary search).
__device__ __forceinline__ int lane_of_rank(unsigned mask, int rank) {
  int lo = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const unsigned below = mask & ((1u << (lo + w)) - 1u);  // lo + w <= 31
    if (__popc(below) <= rank) lo += w;
  }
  return lo;
}

// Adds v[t] at g[key + off[t]] for the lanes of the warp that call it
// together (__activemask: the lanes of a loop whose rays have not ended):
// lanes with the same key are grouped (__match_any_sync) and summed in a
// tree over their ranks, fixed for a given group, and the group's first
// lane adds each sum once.
template <int N>
__device__ __forceinline__ void add_grouped(float* __restrict__ g, int key,
                                            const int (&off)[N],
                                            float (&v)[N]) {
  const unsigned mask = __activemask();
  const unsigned lane = threadIdx.x & 31;
  const unsigned group = __match_any_sync(mask, key);
  const int size = __popc(group);
  const int widest = __reduce_max_sync(mask, size);
  const int rank = __popc(group & ((1u << lane) - 1u));
  for (int step = 1; step < widest; step <<= 1) {
    const int from = rank + step;
    const int src = from < size ? lane_of_rank(group, from)
                                : static_cast<int>(lane);
    float got[N];
#pragma unroll
    for (int t = 0; t < N; ++t) got[t] = __shfl_sync(mask, v[t], src);
    if ((rank & (2 * step - 1)) == 0 && from < size) {
#pragma unroll
      for (int t = 0; t < N; ++t) v[t] = v[t] + got[t];
    }
  }
  if (rank == 0) {
#pragma unroll
    for (int t = 0; t < N; ++t) atomicAdd(g + key + off[t], v[t]);
  }
}

// The ray's adjoints before a trip at (gx, gy) with taps `b`, from those
// after it (one step of the reverse walk); the EDF's 4 tap gradients in
// `taps`. Sums in autograd's order through the plain loop (three or more
// terms: the step's, and the fraction fx's).
struct Adjoint {
  float ax, ay, gc, gs;
};

__device__ __forceinline__ void reverse_trip(const Map& m, float inv_res,
                                             float gt, float c, float s,
                                             float gx, float gy,
                                             const Bilinear& b, Adjoint& j,
                                             float (&taps)[4]) {
  const float gd = (gt + j.ay * s) + j.ax * c;
  j.gc = j.gc + j.ax * b.value;
  j.gs = j.gs + j.ay * b.value;
  const float ga = gd * b.gy1;
  const float gb = gd * b.fy;
  const float gfx = ((gb * b.f11 - gb * b.f10) + ga * b.f01) - ga * b.f00;
  const float gfy = gd * b.hi - gd * b.lo;
  // torch.clamp passes the gradient where lo <= v <= hi
  const float vx = gx - 0.5f;
  const float vy = gy - 0.5f;
  if (vx >= 0.0f && vx <= static_cast<float>(m.wp - 1)) {
    j.ax = j.ax + gfx * inv_res;
  }
  if (vy >= 0.0f && vy <= static_cast<float>(m.hp - 1)) {
    j.ay = j.ay + gfy * inv_res;
  }
  taps[0] = ga * b.gx1;
  taps[1] = ga * b.fx;
  taps[2] = gb * b.gx1;
  taps[3] = gb * b.fx;
}

// One reverse trip at position p, its taps added to the EDF's gradient.
__device__ __forceinline__ void reverse_at(const Args& a, float ox,
                                           float oy, float gt, float c,
                                           float s, float2 p, Adjoint& j,
                                           float* __restrict__ g_edf) {
  const float gx = (p.x - ox) * a.inv_res;
  const float gy = (p.y - oy) * a.inv_res;
  Bilinear b;
  bilinear(a.m, gx, gy, b);
  float taps[4];
  reverse_trip(a.m, a.inv_res, gt, c, s, gx, gy, b, j, taps);
  if (g_edf != nullptr) {
    const int off[4] = {0, 1, a.m.wp, a.m.wp + 1};
    add_grouped<4>(g_edf, b.base, off, taps);
  }
}

// One bilinear step of a known walk from (x, y): the march's own
// arithmetic.
__device__ __forceinline__ void step_bilinear(const Args& a, float ox,
                                              float oy, float c, float s,
                                              float& x, float& y) {
  const float d =
      sample_bilinear(a.m, (x - ox) * a.inv_res, (y - oy) * a.inv_res);
  x = x + d * c;
  y = y + d * s;
}

// The reverse walk of a bilinear ray of `steps` > kSlots steps from
// (x0, y0): kSlots / 2 checkpoints, each segment marched again from its
// checkpoint kSlots / 2 positions at a time.
__device__ void long_ray(const Args& a, float ox, float oy, float x0,
                         float y0, float c, float s, float gt, int steps,
                         float2 (&pos)[kSlots], float* __restrict__ g_edf,
                         Adjoint& j) {
  constexpr int nck = kSlots / 2;
  constexpr int part = kSlots - nck;
  const int seg = (steps + nck - 1) / nck;
  float x = x0, y = y0;
  for (int t = 0; t < steps; ++t) {
    if (t % seg == 0) pos[t / seg] = make_float2(x, y);
    step_bilinear(a, ox, oy, c, s, x, y);
  }
  for (int k = (steps - 1) / seg; k >= 0; --k) {
    const int lo = k * seg;
    const int hi = min(lo + seg, steps);
    for (int p0 = lo + (hi - lo - 1) / part * part; p0 >= lo; p0 -= part) {
      const float2 ck = pos[k];
      x = ck.x;
      y = ck.y;
      for (int t = lo; t < p0; ++t) step_bilinear(a, ox, oy, c, s, x, y);
      const int cnt = min(part, hi - p0);
      for (int t = 0; t < cnt; ++t) {
        pos[nck + t] = make_float2(x, y);
        step_bilinear(a, ox, oy, c, s, x, y);
      }
      for (int t = cnt - 1; t >= 0; --t) {
        reverse_at(a, ox, oy, gt, c, s, pos[nck + t], j, g_edf);
      }
    }
  }
}

// The gradient of ray i: its steps and gt from the forward's record, then
// the walk.
template <int V>
__device__ __forceinline__ void grad_ray(
    const Args& a, float ox, float oy, int i, const float* __restrict__ g_out,
    float* __restrict__ g_edf, float* __restrict__ g_x0,
    float* __restrict__ g_y0, float* __restrict__ g_c,
    float* __restrict__ g_s, const int* __restrict__ walk,
    float2 (&pos)[kSlots]) {
  const Ray ray = load_ray(a, i);
  const int steps = walk[i];
  const float gt = steps > 0 ? g_out[i] : 0.0f;
  Adjoint j{0.0f, 0.0f, 0.0f, 0.0f};
  if (gt != 0.0f && (g_edf != nullptr || V == kBilinear)) {
    float x = ray.x, y = ray.y;
    if constexpr (V == kNearest) {
      for (int k = 0; k < steps; ++k) {
        const int cell =
            nearest_cell(a.m, (x - ox) * a.inv_res, (y - oy) * a.inv_res);
        const float d = __ldg(a.m.edf + cell);
        const int off[1] = {0};
        float v[1] = {gt};
        add_grouped<1>(g_edf, cell, off, v);
        x = x + d * ray.c;
        y = y + d * ray.s;
      }
    } else if (steps <= kSlots) {
      for (int k = 0; k < steps; ++k) {
        pos[k] = make_float2(x, y);
        step_bilinear(a, ox, oy, ray.c, ray.s, x, y);
      }
      for (int k = steps - 1; k >= 0; --k) {
        reverse_at(a, ox, oy, gt, ray.c, ray.s, pos[k], j, g_edf);
      }
    } else {
      long_ray(a, ox, oy, ray.x, ray.y, ray.c, ray.s, gt, steps, pos, g_edf,
               j);
    }
  }
  if (V == kBilinear && g_x0 != nullptr) {
    g_x0[i] = j.ax;
    g_y0[i] = j.ay;
    g_c[i] = j.gc;
    g_s[i] = j.gs;
  }
}

// As the march: a warp takes 32 rays at a time; each lane walks its ray,
// forward and (bilinear) back, and the warp takes the next 32 when all are
// done.
template <int V>
__global__ void __launch_bounds__(kThreads, V == kBilinear ? 3 : 6)
    edf_march_grad_kernel(Args a, const float* __restrict__ g_out,
                          float* __restrict__ g_edf, float* __restrict__ g_x0,
                          float* __restrict__ g_y0, float* __restrict__ g_c,
                          float* __restrict__ g_s,
                          const int* __restrict__ walk,
                          unsigned long long* __restrict__ cursor) {
  float2 pos[kSlots];  // the ray's positions (local memory, L1-cached)
  const unsigned lane = threadIdx.x & 31;
  const unsigned n = static_cast<unsigned>(a.n);
  const float ox = __ldg(a.ox);
  const float oy = __ldg(a.oy);
  __shared__ unsigned long long group;
  block_start(&group);
  for (unsigned long long chunk = first_chunk(); chunk * kChunk < n;
       chunk = next_chunk(&group, cursor)) {
    const unsigned long long ray_index = chunk * kChunk + lane;
    if (ray_index < n) {
      grad_ray<V>(a, ox, oy, static_cast<int>(ray_index), g_out, g_edf,
                  g_x0, g_y0, g_c, g_s, walk, pos);
    }
  }
}

// -- the implicit march's VJP in the poses ----------------------------------

// threads of a block of the pose VJP: one block an agent, each thread a
// strided share of its beams (1080 beams: 8 or 9 a thread)
constexpr int kVjpThreads = 128;
// the rays a thread has in flight: their reads, then their taps, are
// issued together, so that a thread waits twice for kVjpBatch rays
constexpr int kVjpBatch = 3;

// What the pose VJP reads beside the map: the poses (n, 3), read at
// [a * ps0 + c * ps1], the fan's factors (cos and sin of each agent's
// heading, (n,); of each beam offset, (beams,)), and the ranges, hit flags
// and cotangent (n, beams), contiguous.
struct PoseVjp {
  const float* poses;
  int ps0, ps1;
  const float* cth;
  const float* sth;
  const float* cd;
  const float* sd;
  const float* r;
  const bool* hit;
  const float* g;
  float inv_res;
  float tau;          // the level set
  float gate;         // 0.6 tau, rounded in float32
  float denom_floor;  // _DENOM_FLOOR
  int beams;
};

// One ray of the pose VJP between its phases.
struct VjpRay {
  float r, g, ct, st;
  bool take;  // a hit on the map: its taps are read
  Patch p;
};

// Phase 1 of beam b of an agent at (x0, y0) with heading factors (cth,
// sth), whose range, cotangent and hit flag `ray` holds: the direction,
// the hit point and its taps (read for a hit on the map only), in
// ops/raymarch_diff.py _pose_terms' (and _hit_scale's) order.
__device__ __forceinline__ void pose_taps(const Map& m, const PoseVjp& v,
                                          float ox, float oy, float x0,
                                          float y0, float cth, float sth,
                                          int b, VjpRay& ray) {
  const float cd = __ldg(v.cd + b);
  const float sd = __ldg(v.sd + b);
  ray.ct = cth * cd - sth * sd;
  ray.st = sth * cd + cth * sd;
  const float gx = ((x0 + ray.r * ray.ct) - ox) * v.inv_res;
  const float gy = ((y0 + ray.r * ray.st) - oy) * v.inv_res;
  ray.take = ray.take && gx >= 0.0f && gy >= 0.0f &&
             gx < static_cast<float>(m.w) && gy < static_cast<float>(m.h);
  patch_taps(m, gx, gy, ray.take, ray.p);
}

// Phase 2: the three terms (d/dx0, d/dy0, d/dtheta) of the ray, left at 0
// where the hit is off the map, off the level set or grazing.
__device__ __forceinline__ void pose_terms(const PoseVjp& v,
                                           const VjpRay& ray, float (&t)[3]) {
  float dgx, dgy;
  const float val = patch_value<true>(ray.p, dgx, dgy);
  const float ex = dgx * v.inv_res;
  const float ey = dgy * v.inv_res;
  const float denom = ex * ray.ct + ey * ray.st;
  if (fabsf(val - v.tau) <= v.gate && fabsf(denom) >= v.denom_floor) {
    const float scale = -ray.g / denom;
    t[0] = scale * ex;
    t[1] = scale * ey;
    t[2] = (scale * ray.r) * (ey * ray.ct - ex * ray.st);
  }
}

// Block `agent`: each thread takes its beams (b = threadIdx.x, +
// kVjpThreads, ...) kVjpBatch at a time and sums their terms in order,
// then a shuffle tree over each warp's lanes and the warps in order give
// the agent's (d/dx0, d/dy0, d/dtheta). With `terms` set, also each ray's
// terms at [k * n_rays + ray].
__global__ void __launch_bounds__(kVjpThreads) implicit_pose_vjp_kernel(
    Map m, const float* __restrict__ ox_p, const float* __restrict__ oy_p,
    PoseVjp v, float* __restrict__ out, float* __restrict__ terms,
    long long n_rays) {
  const int agent = blockIdx.x;
  const float ox = __ldg(ox_p);
  const float oy = __ldg(oy_p);
  const float x0 = __ldg(v.poses + agent * v.ps0);
  const float y0 = __ldg(v.poses + (agent * v.ps0 + v.ps1));
  const float cth = __ldg(v.cth + agent);
  const float sth = __ldg(v.sth + agent);
  const int row = agent * v.beams;
  float sum[3] = {0.0f, 0.0f, 0.0f};
  for (int b0 = threadIdx.x; b0 < v.beams;
       b0 += kVjpThreads * kVjpBatch) {
    VjpRay ray[kVjpBatch];
#pragma unroll
    for (int k = 0; k < kVjpBatch; ++k) {
      const int b = b0 + k * kVjpThreads;
      const int i = row + (b < v.beams ? b : 0);
      ray[k].take = b < v.beams && v.hit[i];
      ray[k].r = __ldg(v.r + i);
      ray[k].g = __ldg(v.g + i);
    }
#pragma unroll
    for (int k = 0; k < kVjpBatch; ++k) {
      const int b = b0 + k * kVjpThreads;
      pose_taps(m, v, ox, oy, x0, y0, cth, sth, b < v.beams ? b : 0, ray[k]);
    }
#pragma unroll
    for (int k = 0; k < kVjpBatch; ++k) {
      const int b = b0 + k * kVjpThreads;
      float t[3] = {0.0f, 0.0f, 0.0f};
      if (ray[k].take) pose_terms(v, ray[k], t);
      if (b < v.beams) {
        if (terms != nullptr) {
#pragma unroll
          for (int c = 0; c < 3; ++c) terms[c * n_rays + row + b] = t[c];
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) sum[c] = sum[c] + t[c];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      sum[c] = sum[c] + __shfl_down_sync(kAll, sum[c], off);
    }
  }
  __shared__ float part[3][kVjpThreads / 32];
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) part[c][threadIdx.x / 32] = sum[c];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float s = part[threadIdx.x][0];
#pragma unroll
    for (int w = 1; w < kVjpThreads / 32; ++w) s = s + part[threadIdx.x][w];
    out[agent * 3 + threadIdx.x] = s;
  }
}

// -- launches ----------------------------------------------------------------

Rays make_rays(const void* x0, const void* y0, const void* cos_t,
               const void* sin_t, const long long (&st)[8]) {
  Rays r;
  r.x0 = static_cast<const float*>(x0);
  r.y0 = static_cast<const float*>(y0);
  r.c = static_cast<const float*>(cos_t);
  r.s = static_cast<const float*>(sin_t);
  int* dst[8] = {&r.sx[0], &r.sx[1], &r.sy[0], &r.sy[1],
                 &r.sc[0], &r.sc[1], &r.ss[0], &r.ss[1]};
  for (int t = 0; t < 8; ++t) *dst[t] = static_cast<int>(st[t]);
  return r;
}

// One wave of `kernel`'s blocks: the SMs times the blocks an SM holds, on
// the current device, computed once per (kernel, device). 0 on an error.
template <typename K>
int wave(K kernel) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> blocks;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const auto key = std::make_pair(reinterpret_cast<const void*>(kernel), dev);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = blocks.find(key);
  if (hit != blocks.end()) return hit->second;
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, 0) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  return blocks[key] = per_sm * sms;
}

// The blocks of a launch over n rays: one wave, or fewer for few rays.
int grid_of(int wave_blocks, int n) {
  const int needed = (n + kGroup * kChunk - 1) / (kGroup * kChunk);
  return wave_blocks < needed ? wave_blocks : needed;
}

template <int V>
int launch(const Args& a, float* total, bool* hit, int* trips, int* walk,
           unsigned long long* counter, unsigned long long* scratch,
           cudaStream_t stream) {
  const int w = wave(edf_march_kernel<V>);
  if (w <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  edf_march_kernel<V><<<grid_of(w, a.n), kThreads, 0, stream>>>(
      a, total, hit, trips, walk, counter, scratch);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_grad(const Args& a, const float* g, float* g_edf, float* gx0,
                float* gy0, float* gc, float* gs, const int* walk,
                unsigned long long* cursor, cudaStream_t stream) {
  const int w = wave(edf_march_grad_kernel<V>);
  if (w <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  edf_march_grad_kernel<V><<<grid_of(w, a.n), kThreads, 0, stream>>>(
      a, g, g_edf, gx0, gy0, gc, gs, walk, cursor);
  return static_cast<int>(cudaGetLastError());
}

bool fits(long long v) { return v >= 0 && v <= 0x7fffffffLL; }

// The launch's arguments, or false where a size passes 2^31 - 1 (the
// wrapper refuses those first, with a message).
bool make_args(const void* edf, long long hp, long long wp, long long h,
               long long w, const void* ox, const void* oy, float inv_res,
               float max_range, float eps, int max_iters, const void* x0,
               const void* y0, const void* cos_t, const void* sin_t,
               const long long (&st)[8], long long rows, long long cols,
               Args& a) {
  if (!fits(hp * wp) || !fits(h) || !fits(w) || !fits(rows * cols) ||
      cols <= 0) {
    return false;
  }
  for (int t = 0; t < 8; t += 2) {
    if (!fits((rows - 1) * st[t] + (cols - 1) * st[t + 1])) return false;
  }
  a.m = Map{static_cast<const float*>(edf), static_cast<int>(hp),
            static_cast<int>(wp), static_cast<int>(h), static_cast<int>(w)};
  a.r = make_rays(x0, y0, cos_t, sin_t, st);
  a.ox = static_cast<const float*>(ox);
  a.oy = static_cast<const float*>(oy);
  a.inv_res = inv_res;
  a.max_range = max_range;
  a.eps = eps;
  a.tau = a.top = a.slope_floor = 0.0f;
  a.max_iters = max_iters;
  a.n = static_cast<int>(rows * cols);
  a.cols = static_cast<int>(cols);
  // Granlund and Montgomery: with l = ceil(log2 cols) and m =
  // ceil(2^(31 + l) / cols) < 2^32, i / cols = (i * m) >> (31 + l) for
  // every i < 2^31
  int l = 0;
  while ((1LL << l) < cols) ++l;
  a.col_shift = 31 + l;
  a.col_magic = static_cast<unsigned long long>(
      ((1ULL << a.col_shift) + cols - 1) / cols);
  return true;
}

}  // namespace

// Launches the march of rows x cols rays on `stream` and returns
// cudaGetLastError() (0 = launched). variant: 0 nearest, 1 bilinear,
// 2 implicit. Device pointers: edf (hp, wp) f32 contiguous, at least 2 x 2
// for the bilinear and implicit variants; ox, oy f32 scalars; x0, y0, cos,
// sin f32 read at [row * s_row + col * s_col]; tau, top and slope_floor the
// implicit variant's scalars (ignored by the others); total (rows * cols,)
// f32 (the implicit variant's ranges); hit bool (rows * cols,) for the
// implicit variant, else null; trips i32 or null; walk i32 or null (the
// gradient's record); counter 2 x u64 (trips, calls); scratch 3 x u64,
// zeroed, this launch's own. Sizes and offsets below 2^31.
extern "C" int edf_march_launch(
    int variant, const void* edf, long long hp, long long wp,
    long long h, long long w, const void* ox, const void* oy, float inv_res,
    float max_range, float eps, int max_iters, const void* x0,
    const void* y0, const void* cos_t, const void* sin_t, long long sx0,
    long long sx1, long long sy0, long long sy1, long long sc0,
    long long sc1, long long ss0, long long ss1, long long rows,
    long long cols, float tau, float top, float slope_floor, void* total,
    void* hit, void* trips, void* walk, void* counter, void* scratch,
    void* stream) {
  if (rows * cols <= 0) return 0;
  const long long st[8] = {sx0, sx1, sy0, sy1, sc0, sc1, ss0, ss1};
  Args a;
  if (!make_args(edf, hp, wp, h, w, ox, oy, inv_res, max_range, eps,
                 max_iters, x0, y0, cos_t, sin_t, st, rows, cols, a) ||
      (variant != kNearest && (hp < 2 || wp < 2)) ||
      (variant == kImplicit && hit == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.tau = tau;
  a.top = top;
  a.slope_floor = slope_floor;
  float* t = static_cast<float*>(total);
  bool* hb = static_cast<bool*>(hit);
  int* tr = static_cast<int*>(trips);
  int* wk = static_cast<int*>(walk);
  unsigned long long* cnt = static_cast<unsigned long long*>(counter);
  unsigned long long* scr = static_cast<unsigned long long*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kNearest:
      return launch<kNearest>(a, t, hb, tr, wk, cnt, scr, s);
    case kBilinear:
      return launch<kBilinear>(a, t, hb, tr, wk, cnt, scr, s);
    case kImplicit:
      return launch<kImplicit>(a, t, hb, tr, wk, cnt, scr, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches the gradient of the march of rows x cols rays (variant 0
// nearest, 1 bilinear) on `stream` and returns cudaGetLastError(). The
// arguments up to `cols` are edf_march_launch's; g (rows * cols,) f32
// contiguous, the ranges' cotangent; g_edf (hp, wp) f32, zeroed, that the
// EDF's gradient is added into, or null; g_x0, g_y0, g_cos, g_sin
// (rows * cols,) f32 that receive the rays' gradients, all four or null
// (bilinear only); walk i32 (rows * cols,), the march's record of the same
// rays (edf_march_launch's `walk`); cursor 1 x u64, zeroed, this launch's
// own.
extern "C" int edf_march_grad_launch(
    int variant, const void* edf, long long hp, long long wp,
    long long h, long long w, const void* ox, const void* oy, float inv_res,
    float max_range, float eps, int max_iters, const void* x0,
    const void* y0, const void* cos_t, const void* sin_t, long long sx0,
    long long sx1, long long sy0, long long sy1, long long sc0,
    long long sc1, long long ss0, long long ss1, long long rows,
    long long cols, const void* g, void* g_edf, void* g_x0, void* g_y0,
    void* g_cos, void* g_sin, const void* walk, void* cursor,
    void* stream) {
  if (rows * cols <= 0) return 0;
  const long long st[8] = {sx0, sx1, sy0, sy1, sc0, sc1, ss0, ss1};
  Args a;
  if (walk == nullptr ||
      !make_args(edf, hp, wp, h, w, ox, oy, inv_res, max_range, eps,
                 max_iters, x0, y0, cos_t, sin_t, st, rows, cols, a) ||
      (variant == kBilinear && (hp < 2 || wp < 2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* fg = static_cast<const float*>(g);
  float* ge = static_cast<float*>(g_edf);
  const int* wk = static_cast<const int*>(walk);
  unsigned long long* cur = static_cast<unsigned long long*>(cursor);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kNearest:
      return launch_grad<kNearest>(a, fg, ge, nullptr, nullptr, nullptr,
                                   nullptr, wk, cur, s);
    case kBilinear:
      return launch_grad<kBilinear>(
          a, fg, ge, static_cast<float*>(g_x0), static_cast<float*>(g_y0),
          static_cast<float*>(g_cos), static_cast<float*>(g_sin), wk, cur,
          s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches the pose VJP of n agents' scans of `beams` rays each on `stream`
// (one block an agent) and returns cudaGetLastError(). edf (hp, wp) f32
// contiguous, at least 2 x 2, with the real map (h, w) for the in-bounds
// test; ox, oy f32 scalars; poses f32 read at [a * ps0 + c * ps1]; cth,
// sth (n,) and cd, sd (beams,) f32, the fan's factors; r f32, hit bool and
// g f32 (n, beams) contiguous: the ranges, hit flags and their cotangent;
// out (n, 3) f32, contiguous, receives (d/dx0, d/dy0, d/dtheta) of each
// agent; terms f32 (3, n, beams), contiguous, receives each ray's three
// terms, or null. Sizes and offsets below 2^31.
extern "C" int implicit_pose_vjp_launch(
    const void* edf, long long hp, long long wp, long long h, long long w,
    const void* ox, const void* oy, float inv_res, float tau, float gate,
    float denom_floor, const void* poses, long long ps0, long long ps1,
    const void* cth, const void* sth, const void* cd, const void* sd,
    const void* r, const void* hit, const void* g, long long n,
    long long beams, void* out, void* terms, void* stream) {
  if (n <= 0) return 0;
  if (hp < 2 || wp < 2 || beams <= 0 || !fits(hp * wp) || !fits(h) ||
      !fits(w) || !fits(n * beams) || !fits(3 * n) ||
      !fits((n - 1) * ps0 + ps1) || ps0 < 0 || ps1 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Map m{static_cast<const float*>(edf), static_cast<int>(hp),
              static_cast<int>(wp), static_cast<int>(h), static_cast<int>(w)};
  PoseVjp v;
  v.poses = static_cast<const float*>(poses);
  v.ps0 = static_cast<int>(ps0);
  v.ps1 = static_cast<int>(ps1);
  v.cth = static_cast<const float*>(cth);
  v.sth = static_cast<const float*>(sth);
  v.cd = static_cast<const float*>(cd);
  v.sd = static_cast<const float*>(sd);
  v.r = static_cast<const float*>(r);
  v.hit = static_cast<const bool*>(hit);
  v.g = static_cast<const float*>(g);
  v.inv_res = inv_res;
  v.tau = tau;
  v.gate = gate;
  v.denom_floor = denom_floor;
  v.beams = static_cast<int>(beams);
  implicit_pose_vjp_kernel<<<static_cast<unsigned>(n), kVjpThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      m, static_cast<const float*>(ox), static_cast<const float*>(oy), v,
      static_cast<float*>(out), static_cast<float*>(terms), n * beams);
  return static_cast<int>(cudaGetLastError());
}

// The persistent grid of a launch over many rays: the blocks of one wave
// (SMs x blocks per SM) of the march (kernel 0) or its gradient (1) in
// `variant` on the current device; 0 on an error or for a kernel that does
// not exist.
extern "C" int edf_march_wave(int kernel, int variant) {
  if (kernel == 0) {
    return variant == kNearest    ? wave(edf_march_kernel<kNearest>)
           : variant == kBilinear ? wave(edf_march_kernel<kBilinear>)
           : variant == kImplicit ? wave(edf_march_kernel<kImplicit>)
                                  : 0;
  }
  return variant == kNearest    ? wave(edf_march_grad_kernel<kNearest>)
         : variant == kBilinear ? wave(edf_march_grad_kernel<kBilinear>)
                                : 0;
}
