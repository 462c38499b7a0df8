// Dense sweep: per-ray first-hit minima over every real segment of a map.
//
// Replaces the TPU kernel pyracecarsimulator_tpu/ops/raycast_pallas.py
// ::_kernel (called by _raycast_pallas_raw), and with it the XLA sweep
// raycast_segments.raycast_all, which computes the same clamped ranges.
//
// What it computes. Ray i starts at (x, y) with direction (cos, sin) and
// reciprocals inv_c, inv_s (NaN for a zero component). The (4, K) segment
// params (rows p, lo, hi, is_vertical) hold real vertical segments in
// slots [0, v_hi) and real horizontal ones in [h_lo, h_end), from the (3,)
// int32 sweep_meta that the kernel reads on the device (the host never
// synchronises to read it). Split layout: [n_v, KV, KV + n_h]; mixed
// layout: [n_v, n_v, n]. For a vertical segment x = p, y in [lo, hi]:
//     t = (p - x) * inv_c,  a = y + t * sin,
// for a horizontal one y = p, x in [lo, hi]:
//     t = (p - y) * inv_s,  a = x + t * cos;
// a hit is t >= 0 and (a - lo) * (hi - a) >= 0.
//
// Two entries, one kernel body (dense_sweep_kernel<kFromPoses>):
//   - rays given (dense_sweep_launch): flat rays, the caller's x, y, cos,
//     sin, inv_c and inv_s (n,), and the kernel writes the unclamped
//     vertical and horizontal minima bv, bh (3e38 where nothing is hit);
//     the caller clamps and takes isv = bv <= bh. Scans whose rays take a
//     gradient, the theta table's and the sharded wedges run this one.
//   - from poses (dense_scan_launch): ray i is agent i / num_beams, beam
//     i % num_beams, so the (a, num_beams) output's element i. Each thread
//     builds its ray from the agent's origin (x0, y0) and (cos theta,
//     sin theta) and the beam's offset (cos d, sin d), as
//     ops/common.rotate_fan does:
//         c = cth * cd - sth * sd,  s = sth * cd + cth * sd,
//     and its reciprocals 1 / c, 1 / s (NaN where the component is 0), as
//     ops/common._ray_invs does; and it writes the finished range
//     r = min(min(bv, bh), max_range), or max_range where the origin is
//     not inside the map's extent (ex0 <= x < ex1 and ey0 <= y < ey1), as
//     ops/common.finish_minima and apply_extent_mask do. Nothing of the
//     fan, the reciprocals or the minima goes through memory. Scans of
//     poses that take no gradient, on the exact fan, run this one.
//
// Exact arithmetic: as in sector_sweep.cu, built with -fmad=false (no
// contraction of a = y + t * sin, nor of the fan's c and s, into an FMA)
// and no fast math (1 / c is the correctly rounded quotient PyTorch's
// division takes), the two-sided interval product, min and the clamp as
// fminf; the result equals the plain PyTorch version bit for bit.
//
// Work count. Each block adds its live rays, and the pairs they test
// (v_hi + h_end - h_lo a ray, as clamped below: every live ray sweeps the
// same slots), to a (lanes, 3) int64 device counter, [rays, pairs, fanned]
// in lane blockIdx.x % lanes, which the host sums on read
// (ops/sweeps.DENSE_COUNTS); the entry from poses adds its rays to fanned
// too, the rays-given entry nothing. Thread 0 issues the adds as the block
// starts, with no return value, and spreading them over lanes keeps the
// ~17,000 blocks of a 4096 x 1080 launch off one address. Issued before
// the sweep, the count keeps no value live across it: the rays-given entry
// keeps the 40 registers it had before it counted (issued at its end it
// took 48). A replayed CUDA graph adds too. A change that skips pairs
// inside the loops has to count what it sweeps.
//
// Design. One thread per ray, kThreads rays per block; the last block
// masks its ragged edge (no padding of the ray count). Segments stream
// through shared memory in chunks of kChunk slots as [p, lo, hi] (12 KB),
// loaded by the whole block with coalesced reads, then every thread sweeps
// the chunk reading the same address (a broadcast) and keeps bv and bh in
// two registers. Any K works: the chunk loop covers the real slots, so
// levine's 82 and berlin-untiled's 4525 alike. The TPU kernel's
// workarounds are left out: no 4096-ray programs (ROWS x LANES padding),
// no SEG_BLK sublane groups, no scalar prefetch of the bounds.
//
// Bound on the H100. Levine at 4096 agents x 1080 beams: 4.4e6 rays x 82
// slots = 3.6e8 ray-segment tests (~0.2 ms at the list kernel's ~1.8e12
// tests/s). The rays-given entry moves 8 x 17.7 MB of ray inputs and
// outputs (~0.04 ms at 3.35 TB/s), the entry from poses one 17.7 MB range
// and a few KB of factors: both are bound by instruction issue. Berlin
// untiled (4442 real slots) is too, at ~2e10 tests per scan. PERF.md holds
// the times measured on an H100, each with the card's power limit.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kThreads = 256;
constexpr int kChunk = 1024;
constexpr int kCountColumns = 3;  // rays, pairs, fanned

// The entry from poses: per agent the origin and (cos theta, sin theta),
// (a,); per beam (cos d, sin d), (num_beams,); the output (a, num_beams);
// the clamp and the map's extent, as float32.
struct Fan {
  const float* x0;
  const float* y0;
  const float* cth;
  const float* sth;
  const float* cd;
  const float* sd;
  float* out;
  int num_beams;
  float max_range, ex0, ex1, ey0, ey1;
};

// _ray_invs' reciprocal: NaN where the component is zero.
__device__ __forceinline__ float ray_inv(float v) {
  return v == 0.0f ? __int_as_float(0x7fc00000) : 1.0f / v;
}

// Rays given: x .. inv_s are the (n,) rays, bv, bh the outputs, and `fan`
// is not read. From poses: x .. bh are not read and `fan` holds the rest.
template <bool kFromPoses>
__global__ void __launch_bounds__(kThreads) dense_sweep_kernel(
    const float* __restrict__ params, const int* __restrict__ meta,
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    const float* __restrict__ inv_c, const float* __restrict__ inv_s,
    float* __restrict__ bv, float* __restrict__ bh, int n, int k,
    unsigned long long* __restrict__ counts, int lanes, const Fan fan) {
  __shared__ float sp[kChunk];
  __shared__ float slo[kChunk];
  __shared__ float shi[kChunk];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  // threads past the ragged edge stay for the block's barriers and sweep
  // harmless values (zeros, or ray 0 rebuilt); they write nothing
  float ox, oy, c, sn, ic, is;
  if constexpr (kFromPoses) {
    const int ray = live ? i : 0;
    const int agent = ray / fan.num_beams;
    const int beam = ray - agent * fan.num_beams;
    ox = __ldg(fan.x0 + agent);
    oy = __ldg(fan.y0 + agent);
    const float ct = __ldg(fan.cth + agent);
    const float st = __ldg(fan.sth + agent);
    const float cd = __ldg(fan.cd + beam);
    const float sd = __ldg(fan.sd + beam);
    c = ct * cd - st * sd;
    sn = st * cd + ct * sd;
    ic = ray_inv(c);
    is = ray_inv(sn);
  } else {
    ox = live ? x[i] : 0.0f;
    oy = live ? y[i] : 0.0f;
    c = live ? cos_t[i] : 0.0f;
    sn = live ? sin_t[i] : 0.0f;
    ic = live ? inv_c[i] : 0.0f;
    is = live ? inv_s[i] : 0.0f;
  }
  const int v_hi = min(max(meta[0], 0), k);
  const int h_lo = min(max(meta[1], 0), k);
  const int h_end = min(max(meta[2], h_lo), k);
  if (threadIdx.x == 0) {
    const unsigned long long rays = static_cast<unsigned long long>(
        min(kThreads, n - static_cast<int>(blockIdx.x) * kThreads));
    unsigned long long* lane_c =
        counts + kCountColumns * (blockIdx.x % lanes);
    atomicAdd(&lane_c[0], rays);
    atomicAdd(&lane_c[1],
              rays * static_cast<unsigned long long>(v_hi + h_end - h_lo));
    if constexpr (kFromPoses) atomicAdd(&lane_c[2], rays);
  }

  float best_v = kBig;
  for (int base = 0; base < v_hi; base += kChunk) {
    const int m = min(kChunk, v_hi - base);
    __syncthreads();  // the previous chunk is swept by every thread
    for (int s = threadIdx.x; s < m; s += kThreads) {
      sp[s] = params[base + s];
      slo[s] = params[k + base + s];
      shi[s] = params[2 * k + base + s];
    }
    __syncthreads();
    for (int s = 0; s < m; ++s) {
      const float t = (sp[s] - ox) * ic;
      const float a = oy + t * sn;
      if (t >= 0.0f && (a - slo[s]) * (shi[s] - a) >= 0.0f && t < best_v) {
        best_v = t;
      }
    }
  }
  float best_h = kBig;
  for (int base = h_lo; base < h_end; base += kChunk) {
    const int m = min(kChunk, h_end - base);
    __syncthreads();
    for (int s = threadIdx.x; s < m; s += kThreads) {
      sp[s] = params[base + s];
      slo[s] = params[k + base + s];
      shi[s] = params[2 * k + base + s];
    }
    __syncthreads();
    for (int s = 0; s < m; ++s) {
      const float t = (sp[s] - oy) * is;
      const float a = ox + t * c;
      if (t >= 0.0f && (a - slo[s]) * (shi[s] - a) >= 0.0f && t < best_h) {
        best_h = t;
      }
    }
  }
  if (live) {
    if constexpr (kFromPoses) {
      const bool inside = ox >= fan.ex0 && ox < fan.ex1 && oy >= fan.ey0 &&
                          oy < fan.ey1;
      fan.out[i] = inside ? fminf(fminf(best_v, best_h), fan.max_range)
                          : fan.max_range;
    } else {
      bv[i] = best_v;
      bh[i] = best_h;
    }
  }
}

}  // namespace

// Launches the rays-given sweep over n rays on `stream` and returns
// cudaGetLastError() (0 = launched). Pointers are device pointers to
// contiguous tensors: params (4, k) f32, meta (3,) i32, x/y/cos/sin/inv_c/
// inv_s and bv/bh (n,) f32, counts (lanes, 3) u64 [rays, pairs, fanned],
// lanes >= 1.
extern "C" int dense_sweep_launch(
    const void* params, const void* meta, const void* x, const void* y,
    const void* cos_t, const void* sin_t, const void* inv_c,
    const void* inv_s, void* bv, void* bh, int n, int k, void* counts,
    int lanes, void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  dense_sweep_kernel<false><<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const int*>(meta),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const float*>(inv_c), static_cast<const float*>(inv_s),
      static_cast<float*>(bv), static_cast<float*>(bh), n, k,
      static_cast<unsigned long long*>(counts), lanes, Fan{});
  return static_cast<int>(cudaGetLastError());
}

// Launches the from-poses scan of a agents x num_beams rays on `stream`
// and returns cudaGetLastError() (0 = launched): params, meta and counts
// as above, x0/y0/cth/sth (a,) f32, cd/sd (num_beams,) f32, out
// (a, num_beams) f32, a * num_beams < 2^31.
extern "C" int dense_scan_launch(
    const void* params, const void* meta, const void* x0, const void* y0,
    const void* cth, const void* sth, const void* cd, const void* sd,
    void* out, int a, int num_beams, int k, float max_range, float ex0,
    float ex1, float ey0, float ey1, void* counts, int lanes, void* stream) {
  const int n = a * num_beams;
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const Fan fan{static_cast<const float*>(x0),  static_cast<const float*>(y0),
                static_cast<const float*>(cth), static_cast<const float*>(sth),
                static_cast<const float*>(cd),  static_cast<const float*>(sd),
                static_cast<float*>(out),       num_beams,
                max_range,                      ex0,
                ex1,                            ey0,
                ey1};
  dense_sweep_kernel<true><<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const int*>(meta),
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      n, k, static_cast<unsigned long long*>(counts), lanes, fan);
  return static_cast<int>(cudaGetLastError());
}
