// The car step: input processing, one single-track dynamics update, the
// collision latch's standstill and the lidar origin of every car, in one
// launch.
//
// Replaces no Pallas kernel. The JAX package leaves this step to XLA, which
// fuses pyracecarsimulator_tpu/models/dynamics.py (process_input, st_step or
// ks_step, apply_standstill) and the origin of simulator.advance into its
// step program. The port ran the same chain as ~125 PyTorch kernels a step
// ("bang" steering; ~120 "smooth"), each a pass over a few KB: at 4096 cars
// the chain took ~0.146 ms of device time a step, ~1.2 us a kernel, so
// launch latency set its pace, not bytes or operations.
//
// What it computes. Car i reads its state (x, y, theta, v, steer, yaw rate
// w, slip beta, the collision latch) and its desired (speed, steer), each of
// the two read at [i * stride] (stride 0: one command for every car, read
// without a copy), and writes the new state's nine fields and the lidar
// origin (sx, sy). The composition it equals, op for op
// (models/car_step.compose):
//   v_des, steer_des clamped to +-max_speed, +-max_steer (NaN passes);
//   a  = clamp((v_des - v) * kp, v > 0 ? -max_decel : -max_accel,
//              v < 0 ? max_decel : max_accel)  (torch.maximum/minimum);
//   sv = bang:   |d| > 1e-4 ? sign(d) * max_steer_vel : 0, d = steer_des -
//                steer;
//        smooth: clamp(d * steer_kp, +-max_steer_vel);
//   single track: |v| >= v_switch takes the dynamic branch (the slip and
//     yaw ODEs on v_safe, v with |v| < 1e-3 set to 1e-3), else the
//     kinematic one; kinematic: the kinematic Euler step, no yaw rate or
//     slip;
//   a latched car keeps its pose, stops (v, steer, w, beta 0) and leaves
//     the dynamic branch;
//   sx = x + cos(theta) * d, sy = y + sin(theta) * d, d the scanner's
//     distance ahead of the base link.
// Every scalar arrives as the float32 the plain code hands PyTorch (the
// host forms it in double, as Python does, and rounds once): kp, the load
// factors G * l_r and G * l_f, the products l_f * cs_f, l_r * cs_r,
// l_f * l_f * cs_f, l_r * l_r * cs_r, mu * m / (I_z * lwb), dt. A tensor
// divided by a Python number is, in PyTorch's CUDA kernel, a multiply by the
// number's reciprocal, taken in double and rounded to float32 (not the
// float32 quotient 1 / float32(number), which differs for 0.29): the host
// passes 1 / lwb (1 / wheelbase for the kinematic model) so. A number
// divided by a tensor is the tensor's reciprocal times the number.
//
// Exact arithmetic: built with -fmad=false (no multiply-add contraction)
// and no fast math (IEEE divisions and reciprocals; sinf, cosf, tanf and
// atanf the CUDA math library's, as PyTorch's kernels call them), every
// operation in the composition's order, the clamps, maxima, minima and sign
// with PyTorch's NaN rules: the kernel equals the composition on the card
// bit for bit.
//
// Work count. Thread 0 of each block adds the block's live cars to a
// (lanes, 1) int64 device counter in lane blockIdx.x % lanes
// (models/car_step.CAR_COUNTS, "steps"), as the block starts, with no
// return value; a replayed CUDA graph adds too.
//
// Design and bound. One thread a car, kThreads cars a block, every
// intermediate in registers; the last block masks its ragged edge. At 4096
// cars the step moves ~0.3 MB (9 fields and 2 commands in, 11 outputs),
// ~0.09 us at 3.35 TB/s, and takes a few hundred operations a car, well
// under a microsecond on 132 SMs: one launch's latency (a few us) bounds
// it. PERF.md holds its time measured on an H100 with the card's power
// limit.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 128;

// The scalars of one step, each the float32 PyTorch would be handed
// (models/car_step.constants writes them in this order).
struct Consts {
  float max_speed, max_steer;       // the desired values' clamps
  float speed_kp;                   // (v_des - v) * speed_kp
  float max_accel, max_decel;       // the acceleration's clamps
  float steer_kp;                   // "smooth" only
  float max_steer_vel;
  float steer_dead;                 // "bang": 1e-4
  float dt;
  float inv_lwb;                    // 1 / (l_f + l_r); kinematic: 1 / wheelbase
  float l_r, l_f;
  float v_guard;                    // 1e-3
  float v_switch;
  float h_cg;
  float g_lr, g_lf;                 // G * l_r, G * l_f
  float lf_csf, lr_csr;             // l_f * cs_f, l_r * cs_r
  float lf_lf_csf, lr_lr_csr;       // l_f * l_f * cs_f, l_r * l_r * cs_r
  float yaw_gain;                   // mu * m / (I_z * lwb)
  float lwb, mu, cs_f, cs_r;
  float scan_d;                     // scan_distance_to_base_link
};
constexpr int kNumConsts = sizeof(Consts) / sizeof(float);

struct In {
  const float *x, *y, *theta, *v, *steer, *w, *beta;
  const bool* collision;
  const float *v_des, *steer_des;
  int v_des_stride, steer_des_stride;
};

struct Out {
  float *x, *y, *theta, *v, *steer, *w, *beta;
  bool *st_dyn, *collision;
  float *sx, *sy;
};

// torch.clamp with number bounds: NaN passes, else min(max(v, lo), hi)
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.maximum / torch.minimum: a NaN operand wins, the first one first
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

template <bool kSingleTrack, bool kSmooth>
__global__ void __launch_bounds__(kThreads) car_step_kernel(
    const In in, const Out out, int n, const Consts c,
    unsigned long long* __restrict__ counts, int lanes) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (threadIdx.x == 0) {
    atomicAdd(counts + blockIdx.x % lanes,
              static_cast<unsigned long long>(
                  min(kThreads, n - static_cast<int>(blockIdx.x) * kThreads)));
  }
  if (i >= n) return;

  const float x = in.x[i], y = in.y[i], th = in.theta[i], v = in.v[i];
  const float st = in.steer[i];
  const bool latched = in.collision[i];

  // process_input
  const float vd = clamp_nan(in.v_des[i * in.v_des_stride], -c.max_speed,
                             c.max_speed);
  const float sd = clamp_nan(in.steer_des[i * in.steer_des_stride],
                             -c.max_steer, c.max_steer);
  float a = (vd - v) * c.speed_kp;
  a = minimum(maximum(a, v > 0.0f ? -c.max_decel : -c.max_accel),
              v < 0.0f ? c.max_decel : c.max_accel);
  const float dif = sd - st;
  float sv;
  if constexpr (kSmooth) {
    sv = clamp_nan(dif * c.steer_kp, -c.max_steer_vel, c.max_steer_vel);
  } else {
    const float sign = static_cast<float>((0.0f < dif) - (dif < 0.0f));
    sv = fabsf(dif) > c.steer_dead ? sign * c.max_steer_vel : 0.0f;
  }

  // the update: velocity and steer are the same in every branch
  const float v_new = v + a * c.dt;
  const float st_new = st + sv * c.dt;
  float x_new, y_new, th_new, w_new = 0.0f, beta_new = 0.0f;
  bool dynamic = false;
  if constexpr (kSingleTrack) {
    const float w = in.w[i], beta = in.beta[i];
    dynamic = fabsf(v) >= c.v_switch;
    if (dynamic) {
      const float v_safe = fabsf(v) < c.v_guard ? c.v_guard : v;
      const float ah = a * c.h_cg;
      const float rear = c.g_lr - ah;
      const float front = ah + c.g_lf;
      const float w_v = w / v_safe;
      const float lf_rear = rear * c.lf_csf;
      const float w_dot =
          (((lf_rear * st) + ((front * c.lr_csr) - lf_rear) * beta) -
           ((rear * c.lf_lf_csf) + (front * c.lr_lr_csr)) * w_v) *
          c.yaw_gain;
      const float coef = (1.0f / (v_safe * c.lwb)) * c.mu;
      const float f_rear = rear * c.cs_f;
      const float r_front = front * c.cs_r;
      const float beta_dot =
          coef * (((f_rear * st) - ((r_front + f_rear) * beta)) +
                  ((r_front * c.l_r) - (f_rear * c.l_f)) * w_v) -
          w;
      const float heading = th + beta;
      x_new = x + (v * cosf(heading)) * c.dt;
      y_new = y + (v * sinf(heading)) * c.dt;
      th_new = th + w * c.dt;
      w_new = w + w_dot * c.dt;
      beta_new = beta + beta_dot * c.dt;
    } else {
      x_new = x + (v * cosf(th)) * c.dt;
      y_new = y + (v * sinf(th)) * c.dt;
      th_new = th + ((v * c.inv_lwb) * tanf(st)) * c.dt;
      const float tan_new = tanf(st_new);
      w_new = (v_new * c.inv_lwb) * tan_new;
      beta_new = atanf((tan_new * c.l_r) * c.inv_lwb);
    }
  } else {
    x_new = x + (v * cosf(th)) * c.dt;
    y_new = y + (v * sinf(th)) * c.dt;
    th_new = th + ((v * c.inv_lwb) * tanf(st)) * c.dt;
  }

  // apply_standstill, then the lidar origin
  const float xo = latched ? x : x_new;
  const float yo = latched ? y : y_new;
  const float tho = latched ? th : th_new;
  out.x[i] = xo;
  out.y[i] = yo;
  out.theta[i] = tho;
  out.v[i] = latched ? 0.0f : v_new;
  out.steer[i] = latched ? 0.0f : st_new;
  out.w[i] = latched ? 0.0f : w_new;
  out.beta[i] = latched ? 0.0f : beta_new;
  out.st_dyn[i] = !latched && dynamic;
  out.collision[i] = latched;
  out.sx[i] = xo + cosf(tho) * c.scan_d;
  out.sy[i] = yo + sinf(tho) * c.scan_d;
}

template <bool kSingleTrack, bool kSmooth>
void launch(const In& in, const Out& out, int n, const Consts& c,
            unsigned long long* counts, int lanes, cudaStream_t stream) {
  car_step_kernel<kSingleTrack, kSmooth>
      <<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          in, out, n, c, counts, lanes);
}

}  // namespace

// Launches the step of n cars on `stream` and returns cudaGetLastError()
// (0 = launched; cudaErrorInvalidValue for a wrong count of constants).
// single_track: 1 the single-track model, 0 the kinematic one; smooth: 1
// the clamped P steering, 0 bang-bang. Device pointers: the state's x, y,
// theta, v, steer, w, beta (n,) f32 and collision (n,) bool; v_des and
// steer_des f32 read at [i * stride], stride 0 or 1; the outputs' seven
// float fields (n,) f32, st_dyn and collision (n,) bool, sx and sy (n,) f32;
// counts (lanes,) u64 [steps], lanes >= 1. consts: n_consts host floats in
// the order of struct Consts.
extern "C" int car_step_launch(
    int single_track, int smooth, const void* x, const void* y,
    const void* theta, const void* v, const void* steer, const void* w,
    const void* beta, const void* collision, const void* v_des,
    const void* steer_des, int v_des_stride, int steer_des_stride,
    void* x_out, void* y_out, void* theta_out, void* v_out, void* steer_out,
    void* w_out, void* beta_out, void* st_dyn_out, void* collision_out,
    void* sx, void* sy, int n, const void* consts, int n_consts,
    void* counts, int lanes, void* stream) {
  if (n_consts != kNumConsts || lanes < 1) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  Consts c;
  std::memcpy(&c, consts, sizeof c);
  const In in{static_cast<const float*>(x),     static_cast<const float*>(y),
              static_cast<const float*>(theta), static_cast<const float*>(v),
              static_cast<const float*>(steer), static_cast<const float*>(w),
              static_cast<const float*>(beta),
              static_cast<const bool*>(collision),
              static_cast<const float*>(v_des),
              static_cast<const float*>(steer_des), v_des_stride,
              steer_des_stride};
  const Out out{static_cast<float*>(x_out),     static_cast<float*>(y_out),
                static_cast<float*>(theta_out), static_cast<float*>(v_out),
                static_cast<float*>(steer_out), static_cast<float*>(w_out),
                static_cast<float*>(beta_out),  static_cast<bool*>(st_dyn_out),
                static_cast<bool*>(collision_out), static_cast<float*>(sx),
                static_cast<float*>(sy)};
  auto* cnt = static_cast<unsigned long long*>(counts);
  auto* s = static_cast<cudaStream_t>(stream);
  if (single_track) {
    if (smooth) launch<true, true>(in, out, n, c, cnt, lanes, s);
    else launch<true, false>(in, out, n, c, cnt, lanes, s);
  } else {
    if (smooth) launch<false, true>(in, out, n, c, cnt, lanes, s);
    else launch<false, false>(in, out, n, c, cnt, lanes, s);
  }
  return static_cast<int>(cudaGetLastError());
}
