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
//     num    = (p0x - x) * nx + (p0y - y) * ny
//     t  = num / d_safe
//     hx = (x + t * cos) - p0x,  hy = (y + t * sin) - p0y
//     s  = hx * ex + hy * ey
//     t  = 3e38 unless t >= 0, 0 <= s <= len and denom != 0
// Modes (a template argument):
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
// IEEE divisions (correctly rounded, subnormals kept), the largest of ties
// with torch.amax's NaN rule: the kernel equals the plain version
// (general_sweep_plain) bit for bit.
//
// What bounds it on the H100. At 4096 x 1080 rays the bytes (the rays'
// directions and outputs, the agents' origins, the visited lists once) are
// ~30-55 MB, ~0.01-0.02 ms at 3.35 TB/s. The operations are the larger
// term: every real (ray, slot) pair needs its denominator and numerator
// and a test, and the few pairs that lower the running minimum need the
// whole pair (division, hit point, s, validity). So the design cuts the
// instructions a real pair issues.
//
// Design. kRays rays a thread, kThreads threads a block, one block per
// (row, block of kThreads * kRays columns), so all of a block's rays share
// one list. The block stages one chunk of its list in shared memory: the
// slots as float4 (p0x, p0y, ex, ey), one broadcast 16-byte load a pair,
// and the lengths apart, read only on the slow path. Each staged slot
// feeds the thread's kRays rays, whose chains are independent; the slot
// loop is unrolled twice. (4 rays a thread, and a slot loop unrolled 4
// times, were timed and lost in winner mode: PERF.md.)
//
// 1. Only the real slots are swept. Before staging, the block finds the
//    last slot of its list whose length is >= 0 (a max over its threads);
//    every thread sweeps only up to it, and a chunk wholly past it is
//    neither staged nor swept; a row with an unknown list sweeps nothing.
//    Exact: a slot whose length is not >= 0 (padding has -1) is never
//    valid, since 0 <= s <= len needs len >= 0. In min-only mode it cannot
//    lower best. In winner mode the plain version's t there is 3e38: it
//    ties at a chunk's minimum only when that minimum is 3e38, and a
//    chunk whose minimum is 3e38 never replaces best (best <= 3e38); so it
//    counts as a slot not tied, and `tied < chunk` still compares against
//    the chunk's full size. A chunk with no valid slot keeps its minimum
//    at +inf and never replaces best.
// 2. A division only where the pair can still win. Each ray keeps a
//    threshold thr (best in min-only mode, min(best, cmin) in winner
//    mode, cmin the current chunk's running minimum) and hi = the float
//    after |thr|. With b = |denom| and sq = num carrying the sign of
//    num * denom (the quotient's sign), a pair is skipped when
//      sq > RN(hi * b)            (the threshold test), or
//      sq < RN(-2^-149 * b)       (the sign test).
//    Exact: a float larger than a rounded product RN(x) is larger than x
//    itself, and one smaller than it is smaller than x (the floats are a
//    grid, and RN(x) lies within half a step of x), so sq > hi * b, or sq
//    < -2^-149 * b, exactly. Where denom == 0 the pair is invalid anyway.
//    Otherwise d_safe = denom, num / denom has the sign of sq and the
//    magnitude |sq| / b, and IEEE division is correctly rounded and
//    monotone: t >= hi > thr, so the pair can neither lower thr nor tie
//    it; or t <= -2^-149 < 0, invalid (a quotient that rounds to -0,
//    which t >= 0 admits, is never skipped). A skipped pair in winner
//    mode is thus one that is not at the chunk's final minimum, or one
//    whose chunk does not replace best, and counts as a slot not tied.
//    The tests hold through subnormal products and denominators (the
//    grid argument needs no relative margin), never skip on NaN (every
//    comparison with NaN is false), and never skip where hi * b
//    overflows to inf; thr is at most 3e38, so hi is finite.
// 3. The winner's two divisions run only where a valid t reaches the
//    chunk's running minimum.
// Work count. As the block ends, its thread 0 adds the block's live rays,
// and the pairs they test (n_real a ray: every ray of a block sweeps the
// same list up to its last real slot; 0 for a row whose list is unknown),
// to a (kLanes, 2) int64 device counter, [rays, pairs] in lane blockIdx.x %
// kLanes, which the host sums on read (ops/sweeps.GENERAL_COUNTS): two adds
// with no return value, spread over lanes to keep the blocks of a 4096 x
// 1080 launch off one address. A replayed CUDA graph adds too. The skips of
// 2 and 3 happen inside a pair: a skipped pair is still a pair tested. The
// count reads nothing the sweep keeps (n_real from shared memory, the first
// column from the block's index) and lives in a function kept out of line:
// so placed, both instantiations keep the registers they had before they
// counted (48 min-only, 56 winner); inline, before the sweep or after it,
// the min-only one took 56 registers and ran 1.2-2% slower on an H100
// (PERF.md).
// Tensor cores do not apply (2-term products whose rounding order must be
// the plain version's); TMA or cp.async do not pay (a list is at most a
// few KB, staged once a block). PERF.md holds the times measured on an
// H100, each with the card's power limit.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr float kTiny = 1.0e-30f;
constexpr float kNegTiny = -1.40129846e-45f;  // -2^-149, the least subnormal
constexpr int kSign = static_cast<int>(0x80000000u);
constexpr int kRays = 2;                  // rays a thread
constexpr int kThreads = 128 / kRays;     // a block spans 128 columns
constexpr int kCols = kThreads * kRays;
constexpr int kStage = 512;  // the largest chunk: _fit_chunk(K, 512)
constexpr int kLanes = 128;  // lanes of the work counter (a power of 2)

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

// the float after |v| (v >= 0 or -0 here): the skip test's threshold
__device__ __forceinline__ float above(float v) {
  return __int_as_float((__float_as_int(v) & 0x7fffffff) + 1);
}

// a ray's running state (wx, wy and the chunk's in winner mode only)
struct Ray {
  float x, y, c, s;
  float best, hi;            // hi = above(thr)
  float wx, wy;
  float cmin, cwx, cwy;      // the current chunk's
  int tied;
};

// the work count of a block of `cols`-column rows that sweeps `n_real`
// slots a ray (Work count above)
__device__ __noinline__ void count_block(unsigned long long* counts,
                                         int col_blocks, int cols,
                                         int n_real) {
  const int first = (blockIdx.x % col_blocks) * kCols;
  const unsigned long long rays =
      static_cast<unsigned long long>(min(kCols, cols - first));
  unsigned long long* lane_c = counts + 2 * (blockIdx.x & (kLanes - 1));
  atomicAdd(&lane_c[0], rays);
  atomicAdd(&lane_c[1], rays * static_cast<unsigned long long>(n_real));
}

template <bool kWinner>
__global__ void __launch_bounds__(kThreads) general_sweep_kernel(
    const float* __restrict__ table, int n_lists, int k, int chunk,
    const int* __restrict__ ids, Rays r, int cols, int col_blocks,
    float* __restrict__ best_out, float* __restrict__ wx_out,
    float* __restrict__ wy_out, unsigned long long* __restrict__ counts) {
  extern __shared__ float4 seg[];        // chunk slots (p0x, p0y, ex, ey)
  float* len = reinterpret_cast<float*>(seg + chunk);  // chunk lengths
  __shared__ int n_real;                 // 1 + the list's last real slot

  const int row = blockIdx.x / col_blocks;
  const int col0 = (blockIdx.x - row * col_blocks) * kCols + threadIdx.x;
  const int list = ids == nullptr ? 0 : ids[row];
  const bool known = list >= 0 && list < n_lists;
  const float* lst =
      table + static_cast<long long>(known ? list : 0) * 6 * k;

  // 1. the list's real extent: a max over the block's threads
  if (threadIdx.x == 0) n_real = 0;
  __syncthreads();
  int last = 0;
  if (known) {
    for (int j = threadIdx.x; j < k; j += kThreads) {
      if (__ldg(lst + 4 * k + j) >= 0.0f) last = j + 1;
    }
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0 && last > 0) atomicMax(&n_real, last);

  // threads past the ragged edge sweep harmless zeros and write nothing
  Ray ray[kRays];
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int col = col0 + j * kThreads;
    const bool live = col < cols;
    Ray& a = ray[j];
    a.x = live ? __ldg(r.x + (row * r.sx[0] + col * r.sx[1])) : 0.0f;
    a.y = live ? __ldg(r.y + (row * r.sy[0] + col * r.sy[1])) : 0.0f;
    a.c = live ? __ldg(r.c + (row * r.sc[0] + col * r.sc[1])) : 0.0f;
    a.s = live ? __ldg(r.s + (row * r.ss[0] + col * r.ss[1])) : 0.0f;
    a.best = kBig;
    a.hi = above(kBig);
    a.wx = a.wy = 0.0f;
  }
  __syncthreads();
  const int limit = n_real;

  for (int base = 0; base < limit; base += chunk) {
    const int m = min(chunk, limit - base);  // slots swept in this chunk
    if (base > 0) __syncthreads();  // the previous chunk is swept
    for (int q = threadIdx.x; q < m; q += kThreads) {
      const float* p = lst + base + q;
      seg[q] = make_float4(p[0], p[k], p[2 * k], p[3 * k]);
      len[q] = p[4 * k];
    }
    __syncthreads();
    if (kWinner) {
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        ray[j].cmin = __int_as_float(0x7f800000);  // +inf
        ray[j].cwx = ray[j].cwy = 0.0f;
        ray[j].tied = 0;
      }
    }
#pragma unroll 2
    for (int q = 0; q < m; ++q) {
      const float4 g = seg[q];  // p0x, p0y, ex, ey
      const float nx = -g.w;
      const float ny = g.z;
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        Ray& a = ray[j];
        const float denom = a.c * nx + a.s * ny;
        const float num = (g.x - a.x) * nx + (g.y - a.y) * ny;
        // 2: the quotient's sign is sq's, its magnitude |sq| / b
        const float b = fabsf(denom);
        const float sq = __int_as_float(__float_as_int(num) ^
                                        (__float_as_int(denom) & kSign));
        if (sq > a.hi * b || sq < kNegTiny * b) continue;  // cannot win
        const float d_safe = denom == 0.0f ? kTiny : denom;
        const float t = num / d_safe;
        const float hx = (a.x + t * a.c) - g.x;
        const float hy = (a.y + t * a.s) - g.y;
        const float sp = hx * g.z + hy * g.w;
        if (!(t >= 0.0f && sp >= 0.0f && sp <= len[q] && denom != 0.0f)) {
          continue;
        }
        if (!kWinner) {
          if (t < a.best) {
            a.best = t;
            a.hi = above(t);
          }
        } else if (t <= a.cmin) {
          const float qx = nx / d_safe;
          const float qy = ny / d_safe;
          if (t < a.cmin) {
            a.cmin = t;
            a.cwx = qx;
            a.cwy = qy;
            a.tied = 1;
            a.hi = above(fminf(a.best, t));
          } else {
            a.cwx = maximum_nan(a.cwx, qx);
            a.cwy = maximum_nan(a.cwy, qy);
            ++a.tied;
          }
        }
      }
    }
    if (kWinner) {
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        Ray& a = ray[j];
        if (a.tied < chunk) {
          a.cwx = maximum_nan(a.cwx, -kBig);
          a.cwy = maximum_nan(a.cwy, -kBig);
        }
        if (a.cmin < a.best) {
          a.best = a.cmin;
          a.wx = a.cwx;
          a.wy = a.cwy;
        }
        a.hi = above(a.best);
      }
    }
  }
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int col = col0 + j * kThreads;
    if (col >= cols) continue;
    const long long i = static_cast<long long>(row) * cols + col;
    best_out[i] = known ? ray[j].best : nan;
    if (kWinner) {
      wx_out[i] = known ? ray[j].wx : nan;
      wy_out[i] = known ? ray[j].wy : nan;
    }
  }
  if (threadIdx.x == 0) count_block(counts, col_blocks, cols, n_real);
}

bool fits(long long v) { return v >= 0 && v <= 0x7fffffffLL; }

}  // namespace

// Launches the sweep of rows x cols rays on `stream` and returns
// cudaGetLastError() (0 = launched). winner: 1 writes best, wx and wy, 0
// only best. Device pointers: table (n_lists, 6, k) f32 contiguous; ids
// (rows,) i32 or null (every row list 0); x, y, cos, sin f32 read at
// [row * s_row + col * s_col]; best, wx, wy (rows * cols,) f32 contiguous
// (wx and wy null without winner); counts (lanes, 2) u64 [rays, pairs],
// lanes 128. chunk divides k and is at most 512. Sizes and offsets below
// 2^31.
extern "C" int general_sweep_launch(
    int winner, const void* table, long long n_lists, long long k,
    long long chunk, const void* ids, const void* x, const void* y,
    const void* cos_t, const void* sin_t, long long sx0, long long sx1,
    long long sy0, long long sy1, long long sc0, long long sc1,
    long long ss0, long long ss1, long long rows, long long cols,
    void* best, void* wx, void* wy, void* counts, int lanes, void* stream) {
  if (rows * cols <= 0) return 0;
  const long long st[8] = {sx0, sx1, sy0, sy1, sc0, sc1, ss0, ss1};
  const long long col_blocks = (cols + kCols - 1) / kCols;
  if (n_lists <= 0 || k <= 0 || chunk <= 0 || chunk > kStage ||
      k % chunk != 0 || !fits(n_lists * 6 * k) || !fits(rows * cols) ||
      !fits(rows * col_blocks) || counts == nullptr || lanes != kLanes ||
      (winner && (wx == nullptr || wy == nullptr))) {
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
  const size_t smem = static_cast<size_t>(chunk) * (sizeof(float4) + 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tb = static_cast<const float*>(table);
  const int* id = static_cast<const int*>(ids);
  float* b = static_cast<float*>(best);
  unsigned long long* cnt = static_cast<unsigned long long*>(counts);
  if (winner) {
    general_sweep_kernel<true><<<grid, kThreads, smem, s>>>(
        tb, static_cast<int>(n_lists), static_cast<int>(k),
        static_cast<int>(chunk), id, r, static_cast<int>(cols),
        static_cast<int>(col_blocks), b, static_cast<float*>(wx),
        static_cast<float*>(wy), cnt);
  } else {
    general_sweep_kernel<false><<<grid, kThreads, smem, s>>>(
        tb, static_cast<int>(n_lists), static_cast<int>(k),
        static_cast<int>(chunk), id, r, static_cast<int>(cols),
        static_cast<int>(col_blocks), b, nullptr, nullptr, cnt);
  }
  return static_cast<int>(cudaGetLastError());
}
