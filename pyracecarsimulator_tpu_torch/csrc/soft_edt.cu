// Chamfer stencil of soft_edt (occupancy -> EDF) and its gradient.
//
// Replaces XLA code of the JAX package, no Pallas kernel:
//   pyracecarsimulator_tpu/ops/soft_edt.py:110, the lax.scan over
//     `combine` (:97-105) that runs `iters` chamfer iterations, and
//   that scan's transpose under jax.grad.
// The port's plain versions, which these kernels are held against:
// ops/soft_edt.py chamfer_stencil_plain (the loop) and
// chamfer_stencil_grad_plain (its backward, written out as computed here).
//
// What an iteration computes, per cell o of the (h, w) field d: the 9
// candidates of ops/soft_edt.py _neighbor_candidates, in its order (slot
// 0 self, 1 up, 2 down, 3 left, 4 right, 5 up-left, 6 up-right, 7
// down-left, 8 down-right), each the neighbour's value plus its step (1,
// or 1.41421354f: the float32 of the Python float sqrt 2, as torch rounds
// it). Neighbour reads clamp to the grid (the replicate pad).
//   hard (temperature 0): out = minimum(...minimum(d, c1)..., c8), with
//     torch.minimum's NaN rule (a NaN operand gives NaN; fminf would not).
//     Every operation is one correctly rounded add or an exact min: equal
//     to the plain loop bit for bit.
//   soft: y_i = (-c_i) * inv_t (inv_t = float32 of 1 / T, rounded once
//     from the host's double), m = max_i y_i (NaN-propagating; +-inf sent
//     to 0, as torch.logsumexp does), L = log(sum_i exp(y_i - m)) + m, and
//     out = neg_t * L (neg_t = float32 of -T). The 9 exponentials are
//     summed in slot order; torch's reduction order is its own, so the
//     soft mode agrees to float32 rounding, not bit for bit.
//
// The gradient, per iteration in reverse, from the iteration's input
// field (the forward's history) and the cotangent g of its output:
//   slots: each output cell's g split over its 9 candidates as autograd
//     splits it through the plain loop. Hard: the minimum chain walked
//     back from its last link: at a tie both sides get g / 2, the larger
//     side gets 0, a NaN comparison passes g to both (torch.minimum's
//     derivative). Soft: -(((g * neg_t) * w_i) * inv_t), w_i = exp(y_i -
//     L), in autograd's order of the products.
//   gather: each source cell sums the slots that read it, in autograd's
//     order: each padded cell of the replicate pad adds the slots that
//     read it, slot 8 first (autograd runs the later candidates' slices
//     first); the pad's backward adds a source's padded cells in row-major
//     order (an edge cell collects the slots that fell off the grid); then
//     the cell's own slot 0 is added. No atomics: deterministic, and equal
//     to chamfer_stencil_grad_plain bit for bit in hard mode.
//
// Bound on the H100, and what the design does about it. The hard forward
// needs 16 operations a cell and iteration (8 adds, 8 mins): levine
// (1300 x 1300) at 64 iterations is 1.73e9 operations, 0.052 ms at the
// FP32 rate; the bytes (the field in and out once) 0.004 ms; with the
// history that the gradient needs (iters fields written once: 433 MB)
// the bytes bound it instead, 0.13 ms. The softmin adds 10 exponentials
// and logarithms a cell (the SFU's rate is 1/8 of the FP32 lanes'); the
// gradient recomputes the candidates from the history and reads it once
// (chip_smoke.py phase 13 counts each bound). What stands between this
// design and its bound: every iteration is a launch over the whole field
// (64-96 a call, each reading the field from L2: 6.8-7.9 MB, which stays
// in the 50 MB L2 between launches), and each thread computes 9 clamped
// neighbour indices beside its 16 operations. The design is the simple
// one: one launch an iteration, one thread a cell reading its 9
// neighbours through L1; all of a call's launches come from one C loop on
// the caller's stream, with no host synchronisation (a CUDA graph can
// capture a call). The gradient tiles the field in 32 x 8 blocks: the
// block loads its tile of the input field with a halo of 2 into shared
// memory, splits the cotangent of each output of the tile and its halo of
// 1 over its slots into shared memory, then each thread gathers its
// source cell from there. The tile and its halo hold 340 outputs for the
// block's 256 threads, so the slot phase takes two rounds (and the halo's
// outputs are computed by both neighbouring blocks). Temporal blocking
// (several iterations a launch on a tile with an iterations-wide halo) is
// left for later. PERF.md holds the times measured on an H100, each with
// the card's power limit.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTx = 32;  // a block's tile: 32 columns
constexpr int kTy = 8;   // by 8 rows, one thread a cell
constexpr float kSqrt2 = 1.41421354f;

// slot k's neighbour offset and step (ops/soft_edt.py _neighbor_candidates)
__device__ __forceinline__ int slot_dy(int k) {
  return (k == 1 || k == 5 || k == 6) ? -1 : (k == 2 || k == 7 || k == 8) ? 1 : 0;
}

__device__ __forceinline__ int slot_dx(int k) {
  return (k == 3 || k == 5 || k == 7) ? -1 : (k == 4 || k == 6 || k == 8) ? 1 : 0;
}

__device__ __forceinline__ float slot_step(int k) { return k < 5 ? 1.0f : kSqrt2; }

// torch.minimum and torch.maximum on CUDA: a NaN operand gives NaN
__device__ __forceinline__ float minimum_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float maximum_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

// The softmin's y_i and L (torch.logsumexp's order of operations).
__device__ __forceinline__ float softmin_terms(const float c[9], float inv_t, float y[9]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) y[k] = __fmul_rn(-c[k], inv_t);
  float m = y[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) m = maximum_nan(m, y[k]);
  if (fabsf(m) == __int_as_float(0x7f800000)) m = 0.0f;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 9; ++k) s = __fadd_rn(s, expf(__fsub_rn(y[k], m)));
  return __fadd_rn(logf(s), m);
}

template <bool kSoft>
__device__ __forceinline__ float combine(const float c[9], float inv_t, float neg_t) {
  if (kSoft) {
    float y[9];
    return __fmul_rn(softmin_terms(c, inv_t, y), neg_t);
  }
  float out = c[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) out = minimum_nan(out, c[k]);
  return out;
}

// One iteration: dst = combine(candidates of src), one thread a cell.
template <bool kSoft>
__global__ void __launch_bounds__(kTx * kTy)
    stencil_kernel(const float* __restrict__ src, float* __restrict__ dst, int h, int w,
                   float inv_t, float neg_t) {
  const int x = blockIdx.x * kTx + threadIdx.x;
  const int y = blockIdx.y * kTy + threadIdx.y;
  if (x >= w || y >= h) return;
  float c[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float v = __ldg(src + clampi(y + slot_dy(k), h - 1) * w + clampi(x + slot_dx(k), w - 1));
    c[k] = k == 0 ? v : __fadd_rn(v, slot_step(k));
  }
  dst[y * w + x] = combine<kSoft>(c, inv_t, neg_t);
}

// The cotangent go of one output cell split over its 9 candidates c.
template <bool kSoft>
__device__ __forceinline__ void slot_cotangents(const float c[9], float go, float inv_t,
                                                float neg_t, float gs[9]) {
  if (kSoft) {
    float y[9];
    const float l = softmin_terms(c, inv_t, y);
    const float gl = __fmul_rn(go, neg_t);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      gs[k] = -__fmul_rn(__fmul_rn(gl, expf(__fsub_rn(y[k], l))), inv_t);
    }
    return;
  }
  float run[9];
  run[0] = c[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) run[k] = minimum_nan(run[k - 1], c[k]);
  float gk = go;
#pragma unroll
  for (int k = 8; k >= 1; --k) {
    const float a = run[k - 1], b = c[k];
    const float split = a == b ? __fmul_rn(gk, 0.5f) : gk;
    gs[k] = a < b ? 0.0f : split;
    gk = a > b ? 0.0f : split;
  }
  gs[0] = gk;
}

// One iteration's gradient: gout (the cotangent of the iteration's input
// d) from g (its output's), a 32 x 8 tile of source cells a block.
template <bool kSoft>
__global__ void __launch_bounds__(kTx * kTy)
    stencil_grad_kernel(const float* __restrict__ d, const float* __restrict__ g,
                        float* __restrict__ gout, int h, int w, float inv_t, float neg_t) {
  __shared__ float sd[kTy + 4][kTx + 4];      // d, halo 2, clamped reads
  __shared__ float sc[9][kTy + 2][kTx + 2];   // slots of the outputs, halo 1
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kTy;
  const int tid = threadIdx.y * kTx + threadIdx.x;
  for (int i = tid; i < (kTy + 4) * (kTx + 4); i += kTx * kTy) {
    const int ly = i / (kTx + 4), lx = i % (kTx + 4);
    sd[ly][lx] = __ldg(d + clampi(y0 - 2 + ly, h - 1) * w + clampi(x0 - 2 + lx, w - 1));
  }
  __syncthreads();
  for (int i = tid; i < (kTy + 2) * (kTx + 2); i += kTx * kTy) {
    const int ly = i / (kTx + 2), lx = i % (kTx + 2);
    const int oy = y0 - 1 + ly, ox = x0 - 1 + lx;
    float gs[9];
    if (oy < 0 || oy >= h || ox < 0 || ox >= w) {
#pragma unroll
      for (int k = 0; k < 9; ++k) gs[k] = 0.0f;
    } else {
      // sd holds d at clamped coordinates, so sd at o + offset is the
      // replicate pad's value of that neighbour
      float c[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float v = sd[ly + 1 + slot_dy(k)][lx + 1 + slot_dx(k)];
        c[k] = k == 0 ? v : __fadd_rn(v, slot_step(k));
      }
      slot_cotangents<kSoft>(c, __ldg(g + oy * w + ox), inv_t, neg_t, gs);
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) sc[k][ly][lx] = gs[k];
  }
  __syncthreads();
  const int sx = x0 + threadIdx.x, sy = y0 + threadIdx.y;
  if (sx >= w || sy >= h) return;
  // the source's padded cells, as positions of the unpadded grid: its own,
  // and at an edge the row (column) -1 or h (w) beyond it, in row-major
  // order
  float acc = 0.0f;
  for (int vy = sy - (sy == 0); vy <= sy + (sy == h - 1); ++vy) {
    for (int vx = sx - (sx == 0); vx <= sx + (sx == w - 1); ++vx) {
      float pg = 0.0f;
#pragma unroll
      for (int k = 8; k >= 1; --k) {
        const int oy = vy - slot_dy(k), ox = vx - slot_dx(k);
        if (oy >= 0 && oy < h && ox >= 0 && ox < w) {
          pg = __fadd_rn(pg, sc[k][oy - y0 + 1][ox - x0 + 1]);
        }
      }
      acc = __fadd_rn(acc, pg);
    }
  }
  gout[sy * w + sx] = __fadd_rn(sc[0][threadIdx.y + 1][threadIdx.x + 1], acc);
}

dim3 grid_of(int h, int w) {
  return dim3(static_cast<unsigned>((w + kTx - 1) / kTx), static_cast<unsigned>((h + kTy - 1) / kTy));
}

}  // namespace

// The forward: `iters` iterations from d0 (h, w) into out, on `stream`.
// With `history` (iters, h, w), iteration k reads history[k] and writes
// history[k + 1] (the last writes out), d0 copied into history[0];
// without it the iterations alternate between out and tmp (an (h, w)
// scratch, needed when iters > 1) so that the last lands in out. soft: 0
// hard min, 1 softmin with inv_t and neg_t. One launch an iteration, no
// host synchronisation. Returns a cudaError_t.
extern "C" int soft_edt_launch(const float* d0, float* out, float* tmp, float* history, int h,
                               int w, int iters, int soft, float inv_t, float neg_t,
                               void* stream) {
  if (h <= 0 || w <= 0 || iters <= 0) return 0;
  if (history == nullptr && iters > 1 && tmp == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(h) * w;
  if (history != nullptr) {
    const cudaError_t err = cudaMemcpyAsync(history, d0, n * sizeof(float),
                                            cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid = grid_of(h, w), block(kTx, kTy);
  const float* src = d0;
  for (int k = 0; k < iters; ++k) {
    float* dst = k == iters - 1    ? out
                 : history != nullptr ? history + static_cast<size_t>(k + 1) * n
                 : (iters - 1 - k) % 2 == 0 ? out
                                            : tmp;
    if (soft) {
      stencil_kernel<true><<<grid, block, 0, s>>>(src, dst, h, w, inv_t, neg_t);
    } else {
      stencil_kernel<false><<<grid, block, 0, s>>>(src, dst, h, w, inv_t, neg_t);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

// The gradient: from the forward's history (iters, h, w) and the output's
// cotangent g (h, w), the input's cotangent into out, the iterations in
// reverse, alternating between tmp (needed when iters > 1) and out so that
// iteration 0 writes out. One launch an iteration, no host
// synchronisation. Returns a cudaError_t.
extern "C" int soft_edt_grad_launch(const float* history, const float* g, float* out, float* tmp,
                                    int h, int w, int iters, int soft, float inv_t, float neg_t,
                                    void* stream) {
  if (h <= 0 || w <= 0 || iters <= 0) return 0;
  if (iters > 1 && tmp == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(h) * w;
  const dim3 grid = grid_of(h, w), block(kTx, kTy);
  const float* src = g;
  for (int k = iters - 1; k >= 0; --k) {
    float* dst = k % 2 == 0 ? out : tmp;
    const float* d = history + static_cast<size_t>(k) * n;
    if (soft) {
      stencil_grad_kernel<true><<<grid, block, 0, s>>>(d, src, dst, h, w, inv_t, neg_t);
    } else {
      stencil_grad_kernel<false><<<grid, block, 0, s>>>(d, src, dst, h, w, inv_t, neg_t);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}
