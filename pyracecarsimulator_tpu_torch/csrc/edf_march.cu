// EDF ray march and its gradient: every ray sphere-traces the euclidean
// distance field in a loop of its own, in registers, until it stops.
//
// Replaces two XLA loops of the JAX package, neither of them a Pallas
// kernel:
//   pyracecarsimulator_tpu/ops/raymarch_xla.py::march_rays, the fixed-trip
//     lax.scan at :139 (backends "edf" and "edf_bilinear"), and its
//     transpose under jax.grad (the gradient of "edf_bilinear", and of a
//     march whose EDF is differentiated), and
//   pyracecarsimulator_tpu/ops/raymarch_diff.py::_march_nearest, the
//     lax.while_loop at :116 (the bracket of "edf_implicit").
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
// stopped ray by zero, which changes none of its values, so a thread that
// leaves its loop early writes what the fixed-trip loop would. Variants
// (a template argument):
//   kNearest  : the clamped total ("edf"),
//   kBilinear : the clamped total of the bilinear march ("edf_bilinear"),
//   kBracket  : the unclamped total, the last step and the hit flag
//               (_march_nearest: [total - last, total] brackets the
//               boundary crossing that "edf_implicit" refines).
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
// The reverse needs each trip's position: a first pass marches forward
// and keeps the position every `seg` trips (kCheckpoints of them); then,
// segment by segment from the last, the thread marches the segment again
// from its checkpoint, keeping each trip's position (kSegment at most),
// and walks it backwards. Two forward passes and one reverse, no memory
// outside the thread; max_iters <= kCheckpoints * kSegment.
//
// Exact arithmetic: built with -fmad=false and no fast math, every float32
// operation of the march in the order of the plain PyTorch loops
// (ops/raymarch_xla.py march_rays_plain, ops/raymarch_diff.py
// _march_nearest_plain), the cell index through int64 as there: the march
// equals them bit for bit. The gradient adds its terms in the order in
// which autograd accumulates them through the plain loop, so the rays'
// gradients equal autograd's bit for bit; the EDF's taps are added with
// atomics, in another order than autograd's scatter: equal to float32
// rounding of the sum, not bit for bit.
//
// Inputs: the ray tensors are read through their strides as (rows, cols)
// views, so the scan's expanded origin views (one origin per agent, stride
// 0 along the beams) are never copied. The map origin comes as two device
// scalars (no host read). Trips: with `trips_out` set, each ray's trip
// count; always, the largest trip count of the launch is added to
// counter[0] and 1 to counter[1] by the launch's last block, through the
// launch's own zeroed scratch (its blocks' maximum and their count), so
// that launches on concurrent streams never share it. A replayed CUDA
// graph counts too, and the host reads the counter only when asked.
//
// Bound on the H100. Each trip is one dependent gather (four for
// bilinear) of a 32-byte L2 sector plus a few dozen operations; a
// thread's trips are serial, a warp runs as long as its longest ray. At
// 4096 x 1080 rays the bytes (rays in and out, the EDF once) are ~60 MB,
// ~0.02 ms at 3.35 TB/s; the operations (per-ray trips x the function's
// operations a trip) are the larger term: bound by issue, and by the
// warps' divergence above that bound. PERF.md holds the times measured on
// an H100, each with the card's power limit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNearest = 0;
constexpr int kBilinear = 1;
constexpr int kBracket = 2;
constexpr int kCheckpoints = 64;  // the gradient's kept positions
constexpr int kSegment = 32;      // trips marched again from one of them

struct Rays {
  const float* x0;
  const float* y0;
  const float* c;
  const float* s;
  long long sx[2], sy[2], sc[2], ss[2];  // (row, col) strides, elements
};

struct Map {
  const float* edf;
  long long hp, wp;  // the (padded) array
  long long h, w;    // the real map: the in-bounds test
};

// One ray's inputs, read through the strides.
struct Ray {
  float x, y, c, s;
};

__device__ __forceinline__ Ray load_ray(const Rays& r, long long i,
                                        long long cols) {
  const long long row = i / cols;
  const long long col = i - row * cols;
  return {__ldg(r.x0 + row * r.sx[0] + col * r.sx[1]),
          __ldg(r.y0 + row * r.sy[0] + col * r.sy[1]),
          __ldg(r.c + row * r.sc[0] + col * r.sc[1]),
          __ldg(r.s + row * r.ss[0] + col * r.ss[1])};
}

// The nearest cell's flat index, or -1 outside the real map.
__device__ __forceinline__ long long nearest_cell(const Map& m, float gx,
                                                  float gy) {
  const long long ix = static_cast<long long>(floorf(gx));
  const long long iy = static_cast<long long>(floorf(gy));
  if (!(ix >= 0 && iy >= 0 && ix < m.w && iy < m.h)) return -1;
  const long long cx = ix > m.wp - 1 ? m.wp - 1 : ix;
  const long long cy = iy > m.hp - 1 ? m.hp - 1 : iy;
  return cy * m.wp + cx;
}

__device__ __forceinline__ float sample_nearest(const Map& m, float gx,
                                                float gy) {
  const long long cell = nearest_cell(m, gx, gy);
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
  long long base;          // the lower-left tap's flat index
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
  b.base = static_cast<long long>(y0) * m.wp + static_cast<long long>(x0);
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

// Adds the launch's largest trip count and one call to counter[0..1]: each
// block raises scratch[0] to its maximum and counts itself in scratch[1];
// the last block to count adds scratch[0] to the counter. `scratch` is
// the launch's own, zeroed before it.
__device__ __forceinline__ void count_trips(
    int block_trips, unsigned long long* __restrict__ counter,
    unsigned long long* __restrict__ scratch) {
  if (threadIdx.x != 0) return;
  atomicMax(&scratch[0], static_cast<unsigned long long>(block_trips));
  __threadfence();
  const unsigned long long done = atomicAdd(&scratch[1], 1ULL);
  if (done == gridDim.x - 1ULL) {
    __threadfence();
    atomicAdd(&counter[0], atomicAdd(&scratch[0], 0ULL));
    atomicAdd(&counter[1], 1ULL);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads) edf_march_kernel(
    Map m, const float* __restrict__ origin_x,
    const float* __restrict__ origin_y, float inv_res, float max_range,
    float eps, int max_iters, Rays r, long long n, long long cols,
    float* __restrict__ total_out, float* __restrict__ last_out,
    bool* __restrict__ hit_out, int* __restrict__ trips_out,
    unsigned long long* __restrict__ counter,
    unsigned long long* __restrict__ scratch) {
  __shared__ int block_trips;
  if (threadIdx.x == 0) block_trips = 0;
  __syncthreads();

  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i < n) {
    const Ray ray = load_ray(r, i, cols);
    float x = ray.x;
    float y = ray.y;
    const float ox = __ldg(origin_x);
    const float oy = __ldg(origin_y);
    float total = 0.0f;
    float last = 0.0f;
    bool hit = false;
    int trips = max_iters;
    for (int it = 0; it < max_iters; ++it) {
      const float gx = (x - ox) * inv_res;
      const float gy = (y - oy) * inv_res;
      const float d = sample<V>(m, gx, gy);
      if (d < 0.0f) {  // left the map
        total = max_range;
        trips = it + 1;
        break;
      }
      if (d <= eps) {
        hit = true;
        trips = it + 1;
        break;
      }
      if (!(total < max_range)) {
        trips = it + 1;
        break;
      }
      last = d;
      x = x + d * ray.c;
      y = y + d * ray.s;
      total = total + d;
    }
    if (V == kBracket) {
      total_out[i] = total;
      last_out[i] = last;
      hit_out[i] = hit;
    } else {
      total_out[i] = total > max_range ? max_range : total;
    }
    if (trips_out != nullptr) trips_out[i] = trips;
    atomicMax(&block_trips, trips);
  }
  __syncthreads();
  count_trips(block_trips, counter, scratch);
}

template <int V>
__global__ void __launch_bounds__(kThreads) edf_march_grad_kernel(
    Map m, const float* __restrict__ origin_x,
    const float* __restrict__ origin_y, float inv_res, float max_range,
    float eps, int max_iters, int seg, Rays r, long long n, long long cols,
    const float* __restrict__ g_out, float* __restrict__ g_edf,
    float* __restrict__ g_x0, float* __restrict__ g_y0,
    float* __restrict__ g_c, float* __restrict__ g_s) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const Ray ray = load_ray(r, i, cols);
  const float ox = __ldg(origin_x);
  const float oy = __ldg(origin_y);

  // the forward march: its steps, how it ended, a checkpoint every seg
  // trips (bilinear)
  float2 ck[V == kBilinear ? kCheckpoints : 1];
  float x = ray.x;
  float y = ray.y;
  float total = 0.0f;
  bool left = false;
  int steps = 0;
  for (int it = 0; it < max_iters; ++it) {
    if (V == kBilinear && it % seg == 0) ck[it / seg] = make_float2(x, y);
    const float d = sample<V>(m, (x - ox) * inv_res, (y - oy) * inv_res);
    if (d < 0.0f) {
      left = true;
      break;
    }
    if (d <= eps || !(total < max_range)) break;
    x = x + d * ray.c;
    y = y + d * ray.s;
    total = total + d;
    ++steps;
  }
  // the range's cotangent reaches the total unless the ray left the map
  // (its range is the constant max_range) or the clamp cut it
  const float gt = (!left && total <= max_range) ? g_out[i] : 0.0f;

  if (V == kNearest) {
    if (g_edf == nullptr || gt == 0.0f) return;
    x = ray.x;
    y = ray.y;
    for (int k = 0; k < steps; ++k) {
      const long long cell =
          nearest_cell(m, (x - ox) * inv_res, (y - oy) * inv_res);
      atomicAdd(g_edf + cell, gt);
      const float d = __ldg(m.edf + cell);
      x = x + d * ray.c;
      y = y + d * ray.s;
    }
    return;
  }

  float ax = 0.0f, ay = 0.0f, gc = 0.0f, gs = 0.0f;
  if (gt != 0.0f && steps > 0) {
    const float wlim = static_cast<float>(m.wp - 1);
    const float hlim = static_cast<float>(m.hp - 1);
    float2 pos[kSegment];
    for (int sg = (steps - 1) / seg; sg >= 0; --sg) {
      const int start = sg * seg;
      const int count = min(steps - start, seg);
      float px = ck[sg].x;
      float py = ck[sg].y;
      for (int k = 0; k < count; ++k) {
        pos[k] = make_float2(px, py);
        const float d = sample_bilinear(m, (px - ox) * inv_res,
                                        (py - oy) * inv_res);
        px = px + d * ray.c;
        py = py + d * ray.s;
      }
      for (int k = count - 1; k >= 0; --k) {
        const float gx = (pos[k].x - ox) * inv_res;
        const float gy = (pos[k].y - oy) * inv_res;
        Bilinear b;
        bilinear(m, gx, gy, b);
        // sums in autograd's order through the plain loop (three or
        // more terms: the step's, and the fraction fx's)
        const float gd = (gt + ay * ray.s) + ax * ray.c;
        gc = gc + ax * b.value;
        gs = gs + ay * b.value;
        const float ga = gd * b.gy1;
        const float gb = gd * b.fy;
        const float gfx = ((gb * b.f11 - gb * b.f10) + ga * b.f01) - ga * b.f00;
        const float gfy = gd * b.hi - gd * b.lo;
        // torch.clamp passes the gradient where lo <= v <= hi
        const float vx = gx - 0.5f;
        const float vy = gy - 0.5f;
        if (vx >= 0.0f && vx <= wlim) ax = ax + gfx * inv_res;
        if (vy >= 0.0f && vy <= hlim) ay = ay + gfy * inv_res;
        if (g_edf != nullptr) {
          atomicAdd(g_edf + b.base, ga * b.gx1);
          atomicAdd(g_edf + b.base + 1, ga * b.fx);
          atomicAdd(g_edf + b.base + m.wp, gb * b.gx1);
          atomicAdd(g_edf + b.base + m.wp + 1, gb * b.fx);
        }
      }
    }
  }
  if (g_x0 != nullptr) {
    g_x0[i] = ax;
    g_y0[i] = ay;
    g_c[i] = gc;
    g_s[i] = gs;
  }
}

Rays make_rays(const void* x0, const void* y0, const void* cos_t,
               const void* sin_t, long long sx0, long long sx1,
               long long sy0, long long sy1, long long sc0, long long sc1,
               long long ss0, long long ss1) {
  Rays r;
  r.x0 = static_cast<const float*>(x0);
  r.y0 = static_cast<const float*>(y0);
  r.c = static_cast<const float*>(cos_t);
  r.s = static_cast<const float*>(sin_t);
  r.sx[0] = sx0; r.sx[1] = sx1;
  r.sy[0] = sy0; r.sy[1] = sy1;
  r.sc[0] = sc0; r.sc[1] = sc1;
  r.ss[0] = ss0; r.ss[1] = ss1;
  return r;
}

template <int V>
int launch(const Map& m, const float* ox, const float* oy, float inv_res,
           float max_range, float eps, int max_iters, const Rays& r,
           long long n, long long cols, float* total, float* last, bool* hit,
           int* trips, unsigned long long* counter,
           unsigned long long* scratch, cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  edf_march_kernel<V><<<static_cast<unsigned int>(blocks), kThreads, 0,
                        stream>>>(m, ox, oy, inv_res, max_range, eps,
                                  max_iters, r, n, cols, total, last, hit,
                                  trips, counter, scratch);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_grad(const Map& m, const float* ox, const float* oy,
                float inv_res, float max_range, float eps, int max_iters,
                int seg, const Rays& r, long long n, long long cols,
                const float* g, float* g_edf, float* gx0, float* gy0,
                float* gc, float* gs, cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  edf_march_grad_kernel<V><<<static_cast<unsigned int>(blocks), kThreads, 0,
                             stream>>>(m, ox, oy, inv_res, max_range, eps,
                                       max_iters, seg, r, n, cols, g, g_edf,
                                       gx0, gy0, gc, gs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the march of rows x cols rays on `stream` and returns
// cudaGetLastError() (0 = launched). variant: 0 nearest, 1 bilinear,
// 2 bracket. Device pointers: edf (hp, wp) f32 contiguous; ox, oy f32
// scalars; x0, y0, cos, sin f32 read at [row * s_row + col * s_col];
// total (rows * cols,) f32; last f32 and hit bool for the bracket (else
// null); trips i32 or null; counter 2 x u64 (trips, calls); scratch 2 x
// u64, zeroed, this launch's own.
extern "C" int edf_march_launch(
    int variant, const void* edf, long long hp, long long wp, long long h,
    long long w, const void* ox, const void* oy, float inv_res,
    float max_range, float eps, int max_iters, const void* x0,
    const void* y0, const void* cos_t, const void* sin_t, long long sx0,
    long long sx1, long long sy0, long long sy1, long long sc0,
    long long sc1, long long ss0, long long ss1, long long rows,
    long long cols, void* total, void* last, void* hit, void* trips,
    void* counter, void* scratch, void* stream) {
  const long long n = rows * cols;
  if (n <= 0) return 0;
  if ((n + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Map m{static_cast<const float*>(edf), hp, wp, h, w};
  const Rays r = make_rays(x0, y0, cos_t, sin_t, sx0, sx1, sy0, sy1, sc0,
                           sc1, ss0, ss1);
  const float* fox = static_cast<const float*>(ox);
  const float* foy = static_cast<const float*>(oy);
  float* t = static_cast<float*>(total);
  float* l = static_cast<float*>(last);
  bool* hb = static_cast<bool*>(hit);
  int* tr = static_cast<int*>(trips);
  unsigned long long* cnt = static_cast<unsigned long long*>(counter);
  unsigned long long* scr = static_cast<unsigned long long*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kNearest:
      return launch<kNearest>(m, fox, foy, inv_res, max_range, eps,
                              max_iters, r, n, cols, t, l, hb, tr, cnt, scr,
                              st);
    case kBilinear:
      return launch<kBilinear>(m, fox, foy, inv_res, max_range, eps,
                               max_iters, r, n, cols, t, l, hb, tr, cnt, scr,
                               st);
    case kBracket:
      return launch<kBracket>(m, fox, foy, inv_res, max_range, eps,
                              max_iters, r, n, cols, t, l, hb, tr, cnt, scr,
                              st);
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
// (bilinear only). Bilinear: max_iters <= 2048 (kCheckpoints * kSegment).
extern "C" int edf_march_grad_launch(
    int variant, const void* edf, long long hp, long long wp, long long h,
    long long w, const void* ox, const void* oy, float inv_res,
    float max_range, float eps, int max_iters, const void* x0,
    const void* y0, const void* cos_t, const void* sin_t, long long sx0,
    long long sx1, long long sy0, long long sy1, long long sc0,
    long long sc1, long long ss0, long long ss1, long long rows,
    long long cols, const void* g, void* g_edf, void* g_x0, void* g_y0,
    void* g_cos, void* g_sin, void* stream) {
  const long long n = rows * cols;
  if (n <= 0) return 0;
  const int seg = max_iters > kCheckpoints
                      ? (max_iters + kCheckpoints - 1) / kCheckpoints
                      : 1;
  if ((n + kThreads - 1) / kThreads > 0x7fffffffLL || seg > kSegment) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Map m{static_cast<const float*>(edf), hp, wp, h, w};
  const Rays r = make_rays(x0, y0, cos_t, sin_t, sx0, sx1, sy0, sy1, sc0,
                           sc1, ss0, ss1);
  const float* fox = static_cast<const float*>(ox);
  const float* foy = static_cast<const float*>(oy);
  const float* fg = static_cast<const float*>(g);
  float* ge = static_cast<float*>(g_edf);
  float* gx = static_cast<float*>(g_x0);
  float* gy = static_cast<float*>(g_y0);
  float* gc = static_cast<float*>(g_cos);
  float* gs = static_cast<float*>(g_sin);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kNearest:
      return launch_grad<kNearest>(m, fox, foy, inv_res, max_range, eps,
                                   max_iters, seg, r, n, cols, fg, ge,
                                   nullptr, nullptr, nullptr, nullptr, st);
    case kBilinear:
      return launch_grad<kBilinear>(m, fox, foy, inv_res, max_range, eps,
                                    max_iters, seg, r, n, cols, fg, ge, gx,
                                    gy, gc, gs, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
