// General-segment sweep: per-ray first hit over segments at any angle, the
// "segments_simplified" backend (contour-simplified maps).
//
// Replaces XLA loops of the JAX package, none of them a Pallas kernel: the
// lax.scan over slot chunks of pyracecarsimulator_tpu/ops/raycast_general.py
// ::_fwd_general (:34, the winner, under autodiff), ::_fwd_general_plain
// (:73, the minimum only, outside autodiff) and ::_fwd_general_tiled
// (:145) with its plain twin (:188): the tile-culled lists.
//
// What it computes. Rays are a (rows, cols) layout read through each
// tensor's (row, col) strides, so the scan's expanded origin views (stride
// 0 along the beams) are never copied. Row r sweeps list ids[r] (list 0
// without ids) of the (L, 6, K) table, slots [p0x, p0y, ex, ey, len, pad]:
//     nx = -ey, ny = ex
//     denom  = cos * nx + sin * ny
//     d_safe = denom == 0 ? 1e-30 : denom
//     t  = ((p0x - x) * nx + (p0y - y) * ny) / d_safe
//     hx = (x + t * cos) - p0x,  hy = (y + t * sin) - p0y
//     s  = hx * ex + hy * ey
//     t  = 3e38 unless t >= 0, 0 <= s <= len and denom != 0
// (a padding slot has len = -1 and is never valid). Modes (a template
// argument):
//   min only: best, the smallest t (unclamped);
//   winner:   best and (wx, wy) = (nx, ny) / d_safe of the winning slot,
//             with the JAX scan's ties: the slots go in chunks of `chunk`
//             (raycast_segments._fit_chunk(K, 512)); within a chunk, each
//             of wx and wy is the largest over the slots tied at the
//             chunk's minimum (and -3e38 where some slot of the chunk is
//             not tied: the JAX select's fill); a chunk replaces the
//             earlier result only where its minimum is strictly smaller.
// A row whose id is outside [0, L) gets NaN.
//
// Exact arithmetic: built with -fmad=false and no fast math, every float32
// operation of ops/raycast_general.py _pairs in its order, the divisions
// IEEE divisions, the largest of ties with torch.amax's NaN rule: the
// kernel equals the plain version (general_sweep_plain) bit for bit.
//
// Design: one thread a ray, kThreads rays a block, one block per (row,
// block of kThreads columns), so all of a block's rays share one list. The
// block stages one chunk of its list (5 rows of at most kStage slots, 10
// KB) in shared memory, loaded with coalesced reads, and every thread
// sweeps it reading the same address (a broadcast). The winner's two
// divisions run only where t reaches the chunk's minimum. The TPU sweep's
// chunked (rays x slots) intermediates are gone: a ray's state is a few
// registers.
//
// Bound on the H100. At 4096 x 1080 rays the bytes (the rays' directions
// and outputs, the agents' origins, the visited lists once) are ~30-55 MB,
// ~0.01-0.02 ms at 3.35 TB/s; the operations (~27 a pair over the real
// slots of the visited lists) are the larger term, and the bound. The
// kernel also sweeps the padding slots of a list (levine 128 slots for 82
// segments) and spends ~10 instructions on each IEEE division. PERF.md holds
// the times measured on an H100, each with the card's power limit.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr float kTiny = 1.0e-30f;
constexpr int kThreads = 128;
constexpr int kStage = 512;  // the largest chunk: _fit_chunk(K, 512)

struct Rays {
  const float* x;
  const float* y;
  const float* c;
  const float* s;
  int sx[2], sy[2], sc[2], ss[2];  // (row, col) strides, elements
};

// torch.amax's maximum: a NaN operand gives NaN
__device__ __forceinline__ float maximum_nan(float a, float b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

template <bool kWinner>
__global__ void __launch_bounds__(kThreads) general_sweep_kernel(
    const float* __restrict__ table, int n_lists, int k, int chunk,
    const int* __restrict__ ids, Rays r, int cols, int col_blocks,
    float* __restrict__ best_out, float* __restrict__ wx_out,
    float* __restrict__ wy_out) {
  __shared__ float seg[5][kStage];

  const int row = blockIdx.x / col_blocks;
  const int col = (blockIdx.x - row * col_blocks) * kThreads + threadIdx.x;
  const bool live = col < cols;
  const int list = ids == nullptr ? 0 : ids[row];
  const bool known = list >= 0 && list < n_lists;
  // threads past the ragged edge stay for the block's barriers and sweep
  // harmless zeros; they write nothing
  const float x = live ? __ldg(r.x + (row * r.sx[0] + col * r.sx[1])) : 0.0f;
  const float y = live ? __ldg(r.y + (row * r.sy[0] + col * r.sy[1])) : 0.0f;
  const float c = live ? __ldg(r.c + (row * r.sc[0] + col * r.sc[1])) : 0.0f;
  const float sn = live ? __ldg(r.s + (row * r.ss[0] + col * r.ss[1])) : 0.0f;
  const float* lst =
      table + static_cast<long long>(known ? list : 0) * 6 * k;

  float best = kBig, wx = 0.0f, wy = 0.0f;
  for (int base = 0; base < k; base += chunk) {
    __syncthreads();  // the previous chunk is swept by every thread
    for (int j = threadIdx.x; j < 5 * chunk; j += kThreads) {
      const int q = j / chunk;
      const int slot = j - q * chunk;
      seg[q][slot] = lst[q * k + base + slot];
    }
    __syncthreads();
    // the chunk's minimum, its ties' largest (nx, ny) / d_safe, and how
    // many slots tie there
    float cmin = __int_as_float(0x7f800000);  // +inf: the first slot sets it
    float cwx = 0.0f, cwy = 0.0f;
    int tied = 0;
    for (int q = 0; q < chunk; ++q) {
      const float ex = seg[2][q];
      const float ey = seg[3][q];
      const float nx = -ey;
      const float ny = ex;
      const float denom = c * nx + sn * ny;
      const float d_safe = denom == 0.0f ? kTiny : denom;
      float t = ((seg[0][q] - x) * nx + (seg[1][q] - y) * ny) / d_safe;
      const float hx = (x + t * c) - seg[0][q];
      const float hy = (y + t * sn) - seg[1][q];
      const float s = hx * ex + hy * ey;
      if (!(t >= 0.0f && s >= 0.0f && s <= seg[4][q] && denom != 0.0f)) {
        t = kBig;
      }
      if (!kWinner) {
        best = t < best ? t : best;
      } else if (t <= cmin) {
        const float qx = nx / d_safe;
        const float qy = ny / d_safe;
        if (t < cmin) {
          cmin = t;
          cwx = qx;
          cwy = qy;
          tied = 1;
        } else {
          cwx = maximum_nan(cwx, qx);
          cwy = maximum_nan(cwy, qy);
          ++tied;
        }
      }
    }
    if (kWinner) {
      if (tied < chunk) {
        cwx = maximum_nan(cwx, -kBig);
        cwy = maximum_nan(cwy, -kBig);
      }
      if (cmin < best) {
        best = cmin;
        wx = cwx;
        wy = cwy;
      }
    }
  }
  if (!live) return;
  const long long i = static_cast<long long>(row) * cols + col;
  const float nan = __int_as_float(0x7fc00000);
  best_out[i] = known ? best : nan;
  if (kWinner) {
    wx_out[i] = known ? wx : nan;
    wy_out[i] = known ? wy : nan;
  }
}

bool fits(long long v) { return v >= 0 && v <= 0x7fffffffLL; }

}  // namespace

// Launches the sweep of rows x cols rays on `stream` and returns
// cudaGetLastError() (0 = launched). winner: 1 writes best, wx and wy, 0
// only best. Device pointers: table (n_lists, 6, k) f32 contiguous; ids
// (rows,) i32 or null (every row list 0); x, y, cos, sin f32 read at
// [row * s_row + col * s_col]; best, wx, wy (rows * cols,) f32 contiguous
// (wx and wy null without winner). chunk divides k and is at most 512.
// Sizes and offsets below 2^31.
extern "C" int general_sweep_launch(
    int winner, const void* table, long long n_lists, long long k,
    long long chunk, const void* ids, const void* x, const void* y,
    const void* cos_t, const void* sin_t, long long sx0, long long sx1,
    long long sy0, long long sy1, long long sc0, long long sc1,
    long long ss0, long long ss1, long long rows, long long cols,
    void* best, void* wx, void* wy, void* stream) {
  if (rows * cols <= 0) return 0;
  const long long st[8] = {sx0, sx1, sy0, sy1, sc0, sc1, ss0, ss1};
  const long long col_blocks = (cols + kThreads - 1) / kThreads;
  if (n_lists <= 0 || k <= 0 || chunk <= 0 || chunk > kStage ||
      k % chunk != 0 || !fits(n_lists * 6 * k) || !fits(rows * cols) ||
      !fits(rows * col_blocks) || (winner && (wx == nullptr || wy == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Rays r;
  r.x = static_cast<const float*>(x);
  r.y = static_cast<const float*>(y);
  r.c = static_cast<const float*>(cos_t);
  r.s = static_cast<const float*>(sin_t);
  int* dst[8] = {&r.sx[0], &r.sx[1], &r.sy[0], &r.sy[1],
                 &r.sc[0], &r.sc[1], &r.ss[0], &r.ss[1]};
  for (int t = 0; t < 8; t += 2) {
    if (!fits((rows - 1) * st[t] + (cols - 1) * st[t + 1])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    *dst[t] = static_cast<int>(st[t]);
    *dst[t + 1] = static_cast<int>(st[t + 1]);
  }
  const dim3 grid(static_cast<unsigned>(rows * col_blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tb = static_cast<const float*>(table);
  const int* id = static_cast<const int*>(ids);
  float* b = static_cast<float*>(best);
  if (winner) {
    general_sweep_kernel<true><<<grid, kThreads, 0, s>>>(
        tb, static_cast<int>(n_lists), static_cast<int>(k),
        static_cast<int>(chunk), id, r, static_cast<int>(cols),
        static_cast<int>(col_blocks), b, static_cast<float*>(wx),
        static_cast<float*>(wy));
  } else {
    general_sweep_kernel<false><<<grid, kThreads, 0, s>>>(
        tb, static_cast<int>(n_lists), static_cast<int>(k),
        static_cast<int>(chunk), id, r, static_cast<int>(cols),
        static_cast<int>(col_blocks), b, nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
