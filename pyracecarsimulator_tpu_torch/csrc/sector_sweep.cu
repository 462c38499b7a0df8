// List-routed sweep: per-ray first-hit minima over a ray row's cull list.
//
// Replaces four TPU kernels of pyracecarsimulator_tpu/ops/raycast_pallas.py,
// which all compute this function and differ only in how they route rows
// to lists and lay the lists out for the TPU:
//   _make_fused_tiles_kernel (sweep_sorted_tiles_fused: sector tables),
//   _make_sorted_tiles_kernel (sweep_sorted_tiles_pallas: mode sorted_pl),
//   _make_kernel_grp (_raycast_pallas_ids_grp_raw: use_pallas=True),
//   _kernel_tiled (_raycast_pallas_ids_raw: the dense backend's map tiles).
// It also replaces the XLA sweeps that compute the same function
// (raycast_sectors._sweep_xla, raycast_segments.raycast_tiled).
//
// What it computes. A ray row is a block of `bb` consecutive beams (bb =
// blockDim.x, 128 on every path of the port) from one origin (x0, y0). Row
// g sweeps list ids[g] of an (L, 4, K) table (rows p, lo, hi, is_vertical):
// vertical slots [0, n_v) and horizontal slots [h_lo, h_end), with
// meta[id] = [n_v, h_lo, h_end]. Sector tables and split-layout tile
// tables have h_lo = the V block's capacity; mixed-layout tile tables have
// h_lo = n_v. For a vertical segment x = p, y in [lo, hi]:
//     t = (p - x0) * inv_c,  a = y0 + t * sin,
// and for a horizontal one y = p, x in [lo, hi]:
//     t = (p - y0) * inv_s,  a = x0 + t * cos;
// a hit is t >= 0 and (a - lo) * (hi - a) >= 0. The kernel writes the
// unclamped vertical and horizontal minima bv, bh (3e38 where nothing is
// hit); the wrapper clamps and takes isv = bv <= bh.
//
// Work count. Each row adds its real slot count n_v + h_end - h_lo (as
// clamped below) and one row to a (lanes, 2) int64 device counter, [slots,
// rows] in lane blockIdx.x % lanes, which the host sums on read
// (ops/sweeps.SWEEP_COUNTS): one thread a block issues the two adds as it
// leaves, with no return value, and spreading them over lanes keeps tens
// of thousands of blocks a launch off one address. A replayed CUDA graph
// adds too.
//
// Exact arithmetic. The result must equal the plain PyTorch sweep bit for
// bit, so: the library is compiled with -fmad=false (no contraction of
// a = y0 + t * sin into an FMA) and without fast math; the interval test
// keeps the two-sided product form; the reciprocals come from the caller,
// where a zero direction component gives NaN, which every comparison
// rejects.
//
// Design. One thread block per ray row, one thread per beam. The block
// stages the [p, lo, hi] of its row's real slots (at most K, 3*K*4 bytes
// of shared memory: 6 KB for berlin's sector table, K = 496; 15 KB for its
// tile table, K = 1280), then every thread sweeps them from shared memory
// (all threads read the same address: a broadcast) keeping bv and bh in
// two registers. Rows loop to their own real counts, so work is bound by
// the mean list length, not by K. The TPU kernels' workarounds are left
// out: no sort of rows by list length, no tiles of rows, no chunk-grouped
// table_ck layout, no pre-gathered slot-major buffer, no grouping of rows
// per grid step, no SMEM prefetch caps or agent chunking.
//
// Bound on the H100. Sector tables, berlin x 4096 agents: 36,864 rows x
// ~198 real slots per visited list x 128 beams ~ 9.3e8 ray-segment tests
// per scan, ~14 instructions each on the FP32 pipes and shared-memory
// broadcasts; the issue floor at 132 SMs x 4 issues per clock x ~1.7 GHz
// is ~0.45 ms per scan. Berlin's tile table visits ~863 real slots per
// row, ~4.4x the sector work (both counts read from the work counter above
// on 4096 free poses, scripts/sweep_ab_torch.py). On levine's sector table
// (~5 slots per row) the ray tensors bound it. PERF.md holds the times
// measured on an H100, each with the card's power limit.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;

__global__ void list_sweep_kernel(
    const float* __restrict__ table, const int* __restrict__ meta,
    const int* __restrict__ ids, const float* __restrict__ x0,
    const float* __restrict__ y0, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const float* __restrict__ inv_c,
    const float* __restrict__ inv_s, float* __restrict__ bv,
    float* __restrict__ bh, int k, unsigned long long* __restrict__ counts,
    int lanes) {
  extern __shared__ float seg[];  // [p | lo | hi], each k floats
  float* sp = seg;
  float* slo = seg + k;
  float* shi = seg + 2 * k;

  const int row = blockIdx.x;
  const int b = threadIdx.x;
  const int bb = blockDim.x;
  const int id = ids[row];
  const int* m = meta + 3 * static_cast<size_t>(id);
  // clamped so that the staged slots fit the K-slot buffer whatever meta
  // holds: n_v <= h_lo <= h_end <= k
  const int h_lo = min(max(m[1], 0), k);
  const int nv = min(max(m[0], 0), h_lo);
  const int nh = min(max(m[2], h_lo), k) - h_lo;
  const int n = nv + nh;
  const float* list = table + static_cast<size_t>(id) * 4 * k;
  for (int s = b; s < n; s += bb) {
    const int slot = s < nv ? s : h_lo + (s - nv);
    sp[s] = list[slot];
    slo[s] = list[k + slot];
    shi[s] = list[2 * k + slot];
  }
  __syncthreads();

  const size_t ray = static_cast<size_t>(row) * bb + b;
  const float ox = x0[row];
  const float oy = y0[row];
  const float c = cos_t[ray];
  const float sn = sin_t[ray];
  const float ic = inv_c[ray];
  const float is = inv_s[ray];
  float best_v = kBig;
  float best_h = kBig;
  for (int s = 0; s < nv; ++s) {
    const float t = (sp[s] - ox) * ic;
    const float a = oy + t * sn;
    if (t >= 0.0f && (a - slo[s]) * (shi[s] - a) >= 0.0f && t < best_v) {
      best_v = t;
    }
  }
  for (int s = nv; s < n; ++s) {
    const float t = (sp[s] - oy) * is;
    const float a = ox + t * c;
    if (t >= 0.0f && (a - slo[s]) * (shi[s] - a) >= 0.0f && t < best_h) {
      best_h = t;
    }
  }
  bv[ray] = best_v;
  bh[ray] = best_h;
  if (b == 0) {
    unsigned long long* lane = counts + 2 * (row % lanes);
    atomicAdd(&lane[0], static_cast<unsigned long long>(n));
    atomicAdd(&lane[1], 1ULL);
  }
}

}  // namespace

// Launches the sweep over g rows of bb beams on `stream` and returns
// cudaGetLastError() (0 = launched). Pointers are device pointers to
// contiguous tensors: table (L, 4, k) f32, meta (L, 3) i32, ids (g,) i32
// (each in [0, L)), x0/y0 (g,) f32, cos/sin/inv_c/inv_s and bv/bh (g, bb)
// f32, counts (lanes, 2) u64 [slots, rows], lanes >= 1.
extern "C" int sector_sweep_launch(
    const void* table, const void* meta, const void* ids, const void* x0,
    const void* y0, const void* cos_t, const void* sin_t, const void* inv_c,
    const void* inv_s, void* bv, void* bh, int g, int bb, int k,
    void* counts, int lanes, void* stream) {
  if (g == 0) return 0;
  const size_t smem = 3 * static_cast<size_t>(k) * sizeof(float);
  list_sweep_kernel<<<g, bb, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(meta),
      static_cast<const int*>(ids), static_cast<const float*>(x0),
      static_cast<const float*>(y0), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<const float*>(inv_c),
      static_cast<const float*>(inv_s), static_cast<float*>(bv),
      static_cast<float*>(bh), k, static_cast<unsigned long long*>(counts),
      lanes);
  return static_cast<int>(cudaGetLastError());
}
