// Dense sweep: per-ray first-hit minima over every real segment of a map.
//
// Replaces the TPU kernel pyracecarsimulator_tpu/ops/raycast_pallas.py
// ::_kernel (called by _raycast_pallas_raw), and with it the XLA sweep
// raycast_segments.raycast_all, which computes the same clamped ranges.
//
// What it computes. Rays are flat: ray i starts at (x[i], y[i]) with
// direction (cos[i], sin[i]) and the caller's reciprocals inv_c, inv_s
// (NaN for a zero component). The (4, K) segment params (rows p, lo, hi,
// is_vertical) hold real vertical segments in slots [0, v_hi) and real
// horizontal ones in [h_lo, h_end), from the (3,) int32 sweep_meta that the
// kernel reads on the device (the host never synchronises to read it).
// Split layout: [n_v, KV, KV + n_h]; mixed layout: [n_v, n_v, n]. For a
// vertical segment x = p, y in [lo, hi]:
//     t = (p - x) * inv_c,  a = y + t * sin,
// for a horizontal one y = p, x in [lo, hi]:
//     t = (p - y) * inv_s,  a = x + t * cos;
// a hit is t >= 0 and (a - lo) * (hi - a) >= 0. The kernel writes the
// unclamped vertical and horizontal minima bv, bh (3e38 where nothing is
// hit); the wrapper clamps and takes isv = bv <= bh.
//
// Exact arithmetic: as in sector_sweep.cu, built with -fmad=false and no
// fast math, the two-sided interval product, reciprocals from the caller;
// the result equals the plain PyTorch version bit for bit.
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
// tests/s) against 8 x 17.7 MB of ray inputs and outputs (~0.04 ms at
// 3.35 TB/s): bound by instruction issue. Berlin untiled (4442 real
// slots) is too, at ~2e10 tests per scan. PERF.md holds the times
// measured on an H100, each with the card's power limit.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kThreads = 256;
constexpr int kChunk = 1024;

__global__ void __launch_bounds__(kThreads) dense_sweep_kernel(
    const float* __restrict__ params, const int* __restrict__ meta,
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    const float* __restrict__ inv_c, const float* __restrict__ inv_s,
    float* __restrict__ bv, float* __restrict__ bh, int n, int k) {
  __shared__ float sp[kChunk];
  __shared__ float slo[kChunk];
  __shared__ float shi[kChunk];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  // threads past the ragged edge stay for the block's barriers and sweep
  // harmless zeros; they write nothing
  const float ox = live ? x[i] : 0.0f;
  const float oy = live ? y[i] : 0.0f;
  const float c = live ? cos_t[i] : 0.0f;
  const float sn = live ? sin_t[i] : 0.0f;
  const float ic = live ? inv_c[i] : 0.0f;
  const float is = live ? inv_s[i] : 0.0f;
  const int v_hi = min(max(meta[0], 0), k);
  const int h_lo = min(max(meta[1], 0), k);
  const int h_end = min(max(meta[2], h_lo), k);

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
    bv[i] = best_v;
    bh[i] = best_h;
  }
}

}  // namespace

// Launches the sweep over n rays on `stream` and returns cudaGetLastError()
// (0 = launched). Pointers are device pointers to contiguous tensors:
// params (4, k) f32, meta (3,) i32, x/y/cos/sin/inv_c/inv_s and bv/bh (n,)
// f32.
extern "C" int dense_sweep_launch(
    const void* params, const void* meta, const void* x, const void* y,
    const void* cos_t, const void* sin_t, const void* inv_c,
    const void* inv_s, void* bv, void* bh, int n, int k, void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  dense_sweep_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const int*>(meta),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const float*>(inv_c), static_cast<const float*>(inv_s),
      static_cast<float*>(bv), static_cast<float*>(bh), n, k);
  return static_cast<int>(cudaGetLastError());
}
