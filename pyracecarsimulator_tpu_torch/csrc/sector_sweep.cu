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
// a hit is t >= 0 and (a - lo) * (hi - a) >= 0.
//
// Two entries, one kernel body (list_sweep_kernel<kFromPoses>):
//   - rays given (sector_sweep_launch): the caller hands each ray's cos, sin
//     and reciprocals as (g, bb) tensors, and the kernel writes the
//     unclamped vertical and horizontal minima bv, bh (3e38 where nothing
//     is hit); the caller clamps and takes isv = bv <= bh. Every scan whose
//     rays take a gradient, the stacked maps and the ring run this one.
//   - from poses (list_scan_launch): row g is agent g / nblk, beam block
//     g % nblk. Each thread builds its ray from the agent's (cos theta,
//     sin theta) and the beam's padded offset (cos d, sin d), as
//     ops/common.rotate_fan does:
//         c = cth * cd - sth * sd,  s = sth * cd + cth * sd,
//     and its reciprocals 1 / c, 1 / s (NaN where the component is 0), as
//     ops/common._ray_invs does; and it writes the finished range of each
//     real beam (beam < num_beams): r = min(min(bv, bh), max_range), or
//     max_range where the origin is not inside the map's extent
//     (ex0 <= x < ex1 and ey0 <= y < ey1), as ops/common.finish_minima and
//     apply_extent_mask do. Nothing of the fan, the reciprocals or the
//     minima goes through memory. Scans of poses that take no gradient run
//     this one.
//
// Work count. Each row adds its real slot count n_v + h_end - h_lo (as
// clamped below), one row, the slots it kept after the wedge cull (below)
// and whether it was built from poses to a (lanes, 4) int64 device counter,
// [slots, rows, kept, fanned] in lane blockIdx.x % lanes, which the host
// sums on read (ops/sweeps.SWEEP_COUNTS): one thread a block issues the
// adds as it leaves (the rays-given entry adds nothing to fanned), with no
// return value, and spreading them over lanes keeps tens of thousands of
// blocks a launch off one address. A replayed CUDA graph adds too.
//
// Exact arithmetic. The result must equal the plain PyTorch composition
// bit for bit, so: the library is compiled with -fmad=false (no
// contraction of a = y0 + t * sin, nor of the fan's c and s, into an FMA)
// and without fast math (1 / c is the correctly rounded IEEE quotient that
// PyTorch's division takes); the interval test keeps the two-sided product
// form; a zero direction component gives a NaN reciprocal, which every
// comparison rejects; min and the clamp are fminf, the instruction
// PyTorch's minimum and clamp take on finite values.
//
// Design. One thread block per ray row, one thread per beam. The block
// stages the [p, lo, hi] of its row's slots (at most K, 3*K*4 bytes of
// shared memory: 6 KB for berlin's sector table, K = 496; 15 KB for its
// tile table, K = 1280), then every thread sweeps them from shared memory
// (all threads read the same address: a broadcast) keeping bv and bh in
// two registers. Rows loop to their own counts, so work is bound by the
// mean list length, not by K. The TPU kernels' workarounds are left out:
// no sort of rows by list length, no tiles of rows, no chunk-grouped
// table_ck layout, no pre-gathered slot-major buffer, no grouping of rows
// per grid step, no SMEM prefetch caps or agent chunking.
//
// Wedge cull. A list serves a whole map cell (a 4 m tile, or a 2 m tile
// and a 22.5 degree sector widened by block_half), a row only its own
// ~32 degrees, so most slots of a list lie where no ray of the row goes.
// The block finds the row's wedge from its own rays: against a reference
// ray r (the middle thread's), each ray's signed sine sigma = r x d; the
// rays of least and greatest sigma are the edge rays d_lo and d_hi (ties:
// the lowest beam for d_lo, the highest for d_hi). While staging, a slot
// whose two endpoints e1, e2 (offsets from the origin) both have
// d_lo x e < -m, or both have d_hi x e > m, is dropped: a segment lies on
// the side of a line its endpoints lie on, and every ray of the row lies
// on the other side of both edge lines. Kept slots are compacted, vertical
// ones into [0, nv_kept) and horizontal ones into [n_v, n_v + nh_kept)
// (a warp ballot and a shared counter each; their order inside a region
// varies between runs, and the minimum does not depend on it), and the
// sweep loops over those alone, so bv and bh are those of the full list.
//
// Why nothing hit is dropped. The row culls only if every ray satisfies
// |c*c + s*s - 1| <= 2^-20 (finite and unit to ~9 ulps) and r . d >= 1/2
// (within 60 degrees of r): then sigma orders the rays by angle up to
// ~46 ulps of sine, so every ray d has d_lo x d >= -93u and d_hi x d <= 93u
// (u = 2^-24); otherwise (a row of 120 degrees or more, a non-finite or
// non-unit direction) the row keeps every slot. Let a ray of the row hit a
// vertical slot under the test above, at Q = (p - x0, a - y0); Q lies on
// the segment, and within u * (4|Q| + |y0|) of the ray's exact line
// (t, the reciprocal and a carry 4 roundings; the caller's inv_c is the
// rounded 1 / cos). So d_lo x Q >= -u * (98|Q| + |y0|), while the cull's
// float32 crosses are within 3u * (|ex| + |ey|) of the exact ones, and
// |Q| <= max|ex| + max|ey|; horizontal slots alike. The margin
//     m = 1e-3 + 2^-16 * ((max|ex| + max|ey|) + |x0| + |y0|)
// is 256u a metre of the slot's extent and the origin's coordinates,
// about 2.5 times that error, plus 1 mm: at berlin's <= 16 m offsets and
// ~60 m coordinates the error is under 2e-5 m. The cull's own arithmetic
// uses float32 operations the plain version repeats (ops/sweeps.py), so
// both count the same kept slots, and the plain version still sweeps
// every real slot: kernel against plain checks the cull.
//
// A row whose list holds fewer than kCullMinSlots real slots is not
// culled: finding the wedge costs two reductions and a block barrier,
// more than a few slots' sweep (levine's sector lists hold ~5).
//
// Bound on the H100. Berlin x 4096 agents, 36,864 rows of 128 beams. The
// rows' lists hold ~198 real slots (sector table) and ~863 (4 m tiles) on
// 4096 free poses; the cull keeps ~64 and ~73 of them. Kept-slot tests
// (128 a kept slot, ~14 instructions each on the FP32 pipes and
// shared-memory broadcasts) and the cull pass (~30 instructions a staged
// slot, once a row) bound the kernel; the staged bytes (12 a real slot a
// row, from L2) and the ray tensors bound it from below as well (the
// rays-given entry reads four (g, bb) ray tensors and writes two; the
// from-poses entry reads a few KB of factors and writes one (A, num_beams)
// range). The count of real slots no longer bounds it. PERF.md holds the
// times measured on an H100, each with the card's power limit.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;
// the wedge cull: the least real slots a row culls, the margin's absolute
// part (1 mm) and its part a metre (2^-16), the unit test's tolerance
// (2^-20) and the least cosine to the reference ray
constexpr int kCullMinSlots = 32;
constexpr float kCullAbs = 1.0e-3f;
constexpr float kCullRel = 1.52587890625e-5f;
constexpr float kUnitTol = 9.5367431640625e-7f;
constexpr float kMinDot = 0.5f;

// sigma's bits in an order that unsigned comparison keeps (-0 before +0)
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// True when no ray between the edge rays (lx, ly) and (hx, hy) can hit the
// segment from (ex1, ey1) to (ex2, ey2), offsets from the row's origin; ro
// is |x0| + |y0|. A NaN anywhere keeps the slot.
__device__ __forceinline__ bool outside_wedge(float ex1, float ey1,
                                              float ex2, float ey2, float lx,
                                              float ly, float hx, float hy,
                                              float ro) {
  const float m =
      kCullAbs + kCullRel * ((fmaxf(fabsf(ex1), fabsf(ex2)) +
                              fmaxf(fabsf(ey1), fabsf(ey2))) + ro);
  const float l1 = lx * ey1 - ly * ex1;
  const float l2 = lx * ey2 - ly * ex2;
  const float h1 = hx * ey1 - hy * ex1;
  const float h2 = hx * ey2 - hy * ex2;
  return (l1 < -m && l2 < -m) || (h1 > m && h2 > m);
}

// The fan of the from-poses entry: per agent (cos theta, sin theta), (A,);
// per beam of the padded fan (cos d, sin d), (nblk * bb,); the output
// (A, num_beams); the clamp and the map's extent, as float32.
struct Fan {
  const float* cth;
  const float* sth;
  const float* cd;
  const float* sd;
  float* out;
  int nblk;
  int num_beams;
  float max_range, ex0, ex1, ey0, ey1;
};

// The direction of the ray at beam `beam` of the padded fan, from agent
// `agent`'s heading: rotate_fan's operations, each separately rounded.
__device__ __forceinline__ void fan_ray(const Fan& f, int agent, int beam,
                                        float& c, float& s) {
  const float ct = __ldg(f.cth + agent);
  const float st = __ldg(f.sth + agent);
  const float cd = __ldg(f.cd + beam);
  const float sd = __ldg(f.sd + beam);
  c = ct * cd - st * sd;
  s = st * cd + ct * sd;
}

// _ray_invs' reciprocal: NaN where the component is zero.
__device__ __forceinline__ float ray_inv(float v) {
  return v == 0.0f ? __int_as_float(0x7fc00000) : 1.0f / v;
}

// Rays given: cos_t .. inv_s are (g, bb) rows, bv, bh the outputs, x0 and
// y0 a row's origin, and `fan` is not read. From poses: cos_t .. bh are
// not read, x0 and y0 are an agent's origin and `fan` holds the rest.
template <bool kFromPoses>
__global__ void list_sweep_kernel(
    const float* __restrict__ table, const int* __restrict__ meta,
    const int* __restrict__ ids, const float* __restrict__ x0,
    const float* __restrict__ y0, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const float* __restrict__ inv_c,
    const float* __restrict__ inv_s, float* __restrict__ bv,
    float* __restrict__ bh, int k, unsigned long long* __restrict__ counts,
    int lanes, const Fan fan) {
  extern __shared__ float seg[];  // [p | lo | hi], each k floats
  float* sp = seg;
  float* slo = seg + k;
  float* shi = seg + 2 * k;
  // per warp: least and greatest sigma key, their beams, all rays usable
  __shared__ unsigned w_min[32], w_max[32];
  __shared__ int w_imin[32], w_imax[32], w_ok[32];
  __shared__ int kept[2];  // vertical, horizontal slots kept

  const int row = blockIdx.x;
  const int b = threadIdx.x;
  const int bb = blockDim.x;
  const int lane = b & 31;
  const int warp = b >> 5;
  const int in_warp = min(32, bb - (warp << 5));
  const unsigned mask = in_warp == 32 ? 0xffffffffu : (1u << in_warp) - 1u;
  const int id = ids[row];
  const int* m = meta + 3 * static_cast<size_t>(id);
  // clamped so that the staged slots fit the K-slot buffer whatever meta
  // holds: n_v <= h_lo <= h_end <= k
  const int h_lo = min(max(m[1], 0), k);
  const int nv = min(max(m[0], 0), h_lo);
  const int nh = min(max(m[2], h_lo), k) - h_lo;
  const int n = nv + nh;
  const float* list = table + static_cast<size_t>(id) * 4 * k;

  const size_t first = static_cast<size_t>(row) * bb;
  const size_t ray = first + b;
  // from poses: the row's agent and the padded fan's beam of thread 0
  const int agent = kFromPoses ? row / fan.nblk : row;
  const int beam0 = kFromPoses ? (row - agent * fan.nblk) * bb : 0;
  const float ox = x0[agent];
  const float oy = y0[agent];

  bool cull = false;
  float lx = 0.0f, ly = 0.0f, hx = 0.0f, hy = 0.0f;
  if (n >= kCullMinSlots) {  // the same for every thread of the block
    // this ray's direction through L2 (or rebuilt) here and again for the
    // sweep, so that it is not held in registers across the staging (40
    // registers a thread against 32: a quarter fewer blocks resident,
    // levine's short rows 43% slower)
    float c, sn, rx, ry;
    if constexpr (kFromPoses) {
      fan_ray(fan, agent, beam0 + b, c, sn);
      fan_ray(fan, agent, beam0 + bb / 2, rx, ry);
    } else {
      c = __ldcg(cos_t + ray);
      sn = __ldcg(sin_t + ray);
      rx = cos_t[first + bb / 2];
      ry = sin_t[first + bb / 2];
    }
    const bool ok = fabsf((c * c + sn * sn) - 1.0f) <= kUnitTol &&
                    rx * c + ry * sn >= kMinDot;
    const unsigned key = order_key(rx * sn - ry * c);
    const unsigned kmin = __reduce_min_sync(mask, key);
    const unsigned kmax = __reduce_max_sync(mask, key);
    const unsigned at_min = __ballot_sync(mask, key == kmin);
    const unsigned at_max = __ballot_sync(mask, key == kmax);
    const bool all_ok = __all_sync(mask, ok);
    if (lane == 0) {
      w_min[warp] = kmin;
      w_imin[warp] = (warp << 5) + __ffs(at_min) - 1;
      w_max[warp] = kmax;
      w_imax[warp] = (warp << 5) + 31 - __clz(at_max);
      w_ok[warp] = all_ok;
    }
    if (b == 0) {
      kept[0] = 0;
      kept[1] = 0;
    }
    __syncthreads();
    unsigned best_min = w_min[0], best_max = w_max[0];
    int i_min = w_imin[0], i_max = w_imax[0];
    cull = w_ok[0];
    for (int w = 1; w < (bb + 31) >> 5; ++w) {
      if (w_min[w] < best_min) {
        best_min = w_min[w];
        i_min = w_imin[w];
      }
      if (w_max[w] >= best_max) {
        best_max = w_max[w];
        i_max = w_imax[w];
      }
      cull = cull && w_ok[w];
    }
    if constexpr (kFromPoses) {
      fan_ray(fan, agent, beam0 + i_min, lx, ly);
      fan_ray(fan, agent, beam0 + i_max, hx, hy);
    } else {
      lx = cos_t[first + i_min];
      ly = sin_t[first + i_min];
      hx = cos_t[first + i_max];
      hy = sin_t[first + i_max];
    }
  }

  int nv_k = nv;
  int nh_k = nh;
  if (cull) {
    const float ro = fabsf(ox) + fabsf(oy);
    const unsigned below = (1u << lane) - 1u;
    for (int s0 = 0; s0 < n; s0 += bb) {  // every thread, for the ballots
      const int s = s0 + b;
      const bool vert = s < nv;
      bool keep = false;
      float p = 0.0f, lo = 0.0f, hi = 0.0f;
      if (s < n) {
        const int slot = vert ? s : h_lo + (s - nv);
        p = list[slot];
        lo = list[k + slot];
        hi = list[2 * k + slot];
        keep = vert ? !outside_wedge(p - ox, lo - oy, p - ox, hi - oy, lx, ly,
                                     hx, hy, ro)
                    : !outside_wedge(lo - ox, p - oy, hi - ox, p - oy, lx, ly,
                                     hx, hy, ro);
      }
      const unsigned kv = __ballot_sync(mask, keep && vert);
      const unsigned kh = __ballot_sync(mask, keep && !vert);
      int base_v = 0, base_h = 0;
      if (lane == 0) {
        if (kv) base_v = atomicAdd(&kept[0], __popc(kv));
        if (kh) base_h = atomicAdd(&kept[1], __popc(kh));
      }
      base_v = __shfl_sync(mask, base_v, 0);
      base_h = __shfl_sync(mask, base_h, 0);
      if (keep) {
        const int at = vert ? base_v + __popc(kv & below)
                            : nv + base_h + __popc(kh & below);
        sp[at] = p;
        slo[at] = lo;
        shi[at] = hi;
      }
    }
    __syncthreads();
    nv_k = kept[0];
    nh_k = kept[1];
  } else {
    for (int s = b; s < n; s += bb) {
      const int slot = s < nv ? s : h_lo + (s - nv);
      sp[s] = list[slot];
      slo[s] = list[k + slot];
      shi[s] = list[2 * k + slot];
    }
    __syncthreads();
  }

  float c, sn, ic, is;
  if constexpr (kFromPoses) {
    fan_ray(fan, agent, beam0 + b, c, sn);
    ic = ray_inv(c);
    is = ray_inv(sn);
  } else {
    c = cos_t[ray];
    sn = sin_t[ray];
    ic = inv_c[ray];
    is = inv_s[ray];
  }
  float best_v = kBig;
  float best_h = kBig;
  for (int s = 0; s < nv_k; ++s) {
    const float t = (sp[s] - ox) * ic;
    const float a = oy + t * sn;
    if (t >= 0.0f && (a - slo[s]) * (shi[s] - a) >= 0.0f && t < best_v) {
      best_v = t;
    }
  }
  for (int s = nv; s < nv + nh_k; ++s) {
    const float t = (sp[s] - oy) * is;
    const float a = ox + t * c;
    if (t >= 0.0f && (a - slo[s]) * (shi[s] - a) >= 0.0f && t < best_h) {
      best_h = t;
    }
  }
  if constexpr (kFromPoses) {
    const int beam = beam0 + b;
    if (beam < fan.num_beams) {
      const bool inside = ox >= fan.ex0 && ox < fan.ex1 && oy >= fan.ey0 &&
                          oy < fan.ey1;
      fan.out[static_cast<size_t>(agent) * fan.num_beams + beam] =
          inside ? fminf(fminf(best_v, best_h), fan.max_range)
                 : fan.max_range;
    }
  } else {
    bv[ray] = best_v;
    bh[ray] = best_h;
  }
  if (b == 0) {
    unsigned long long* lane_c = counts + 4 * (row % lanes);
    atomicAdd(&lane_c[0], static_cast<unsigned long long>(n));
    atomicAdd(&lane_c[1], 1ULL);
    atomicAdd(&lane_c[2], static_cast<unsigned long long>(nv_k + nh_k));
    if constexpr (kFromPoses) atomicAdd(&lane_c[3], 1ULL);
  }
}

}  // namespace

// Launches the rays-given sweep over g rows of bb beams on `stream` and
// returns cudaGetLastError() (0 = launched). Pointers are device pointers
// to contiguous tensors: table (L, 4, k) f32, meta (L, 3) i32, ids (g,) i32
// (each in [0, L)), x0/y0 (g,) f32, cos/sin/inv_c/inv_s and bv/bh (g, bb)
// f32, counts (lanes, 4) u64 [slots, rows, kept, fanned], lanes >= 1.
extern "C" int sector_sweep_launch(
    const void* table, const void* meta, const void* ids, const void* x0,
    const void* y0, const void* cos_t, const void* sin_t, const void* inv_c,
    const void* inv_s, void* bv, void* bh, int g, int bb, int k,
    void* counts, int lanes, void* stream) {
  if (g == 0) return 0;
  const size_t smem = 3 * static_cast<size_t>(k) * sizeof(float);
  list_sweep_kernel<false>
      <<<g, bb, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(table), static_cast<const int*>(meta),
          static_cast<const int*>(ids), static_cast<const float*>(x0),
          static_cast<const float*>(y0), static_cast<const float*>(cos_t),
          static_cast<const float*>(sin_t), static_cast<const float*>(inv_c),
          static_cast<const float*>(inv_s), static_cast<float*>(bv),
          static_cast<float*>(bh), k,
          static_cast<unsigned long long*>(counts), lanes, Fan{});
  return static_cast<int>(cudaGetLastError());
}

// Launches the from-poses scan over a * nblk rows of bb beams on `stream`
// and returns cudaGetLastError() (0 = launched): table, meta and counts as
// above, ids (a * nblk,) i32, x0/y0/cth/sth (a,) f32, cd/sd (nblk * bb,)
// f32, out (a, num_beams) f32 with num_beams <= nblk * bb.
extern "C" int list_scan_launch(
    const void* table, const void* meta, const void* ids, const void* x0,
    const void* y0, const void* cth, const void* sth, const void* cd,
    const void* sd, void* out, int a, int nblk, int bb, int k,
    int num_beams, float max_range, float ex0, float ex1, float ey0,
    float ey1, void* counts, int lanes, void* stream) {
  const int g = a * nblk;
  if (g == 0) return 0;
  const size_t smem = 3 * static_cast<size_t>(k) * sizeof(float);
  const Fan fan{static_cast<const float*>(cth), static_cast<const float*>(sth),
                static_cast<const float*>(cd),  static_cast<const float*>(sd),
                static_cast<float*>(out),       nblk,
                num_beams,                      max_range,
                ex0,                            ex1,
                ey0,                            ey1};
  list_sweep_kernel<true><<<g, bb, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(meta),
      static_cast<const int*>(ids), static_cast<const float*>(x0),
      static_cast<const float*>(y0), nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, k, static_cast<unsigned long long*>(counts), lanes,
      fan);
  return static_cast<int>(cudaGetLastError());
}
