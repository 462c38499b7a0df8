"""The car step: input processing, dynamics, standstill and lidar origin.

``compose`` is the step as the JAX package's ``simulator.advance`` writes
it, on tensors: ``dynamics.process_input``, the model's update
(``st_step``, ``ks_step`` or ``ackermann_step``), ``apply_standstill`` and
the scanner's origin ``scan_distance_to_base_link`` ahead of the base link.
Any device, dtype, autograd, and tensor-valued parameters.

On the card that chain is ~125 PyTorch kernels a step over a few KB each,
so launch latency sets its time. ``car_step`` runs the whole of it in one
launch of ``csrc/car_step.cu`` (one thread a car) on CUDA tensors, and its
plain twin ``car_step_plain`` (``compose``) on CPU tensors.
``fused_step`` says which steps may take it, from what it can see in the
input: the single-track or kinematic model, every parameter used a Python
number, float32 state fields of one shape with bool flags, float32
commands that broadcast to that shape, no gradient, and a CPU or CUDA
device. It is ``car_step``'s precondition, checked once a step, by the
caller (``simulator.advance``). Every other step runs ``compose`` as it
is: autograd (BPTT), float64, tensor parameters, ``"ackermann"``.

The kernel equals ``compose`` on the card bit for bit: the host forms every
scalar as the plain code hands it to PyTorch (``constants``), and the kernel
repeats each operation's order and rounding as PyTorch's CUDA kernels do
(the source's note says how).

``CAR_COUNTS["steps"]`` counts the car-steps that took ``car_step``: the
kernel a block at a time on a device counter (replayed CUDA graphs
included), the plain twin on the host. ``compose`` called directly counts
nothing, so in a rollout on the card ``steps / (agents x env steps)`` is
the share of car-steps that took the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import CarParams, SimParams
from ..ops import _kernels
from ..ops._kernels import COUNT_LANES
from ..state import CarState
from . import dynamics as dyn

CAR_COUNTS = _kernels.DeviceCounts(("steps",), COUNT_LANES)

_MODELS = ("st", "ks")
_FLOAT_FIELDS = ("x", "y", "theta", "velocity", "steer_angle",
                 "angular_velocity", "slip_angle")
_ST_FIELDS = ("l_f", "l_r", "h_cg", "mass", "I_z", "cs_f", "cs_r",
              "friction_coeff", "v_switch")


def compose(state: CarState, v_des, steer_des, car: CarParams,
            sim: SimParams):
    """Input processing, one dynamics update, the standstill of latched
    cars and the lidar origin. Returns ``(new_state, sx, sy)``."""
    accel, steer_vel = dyn.process_input(
        v_des, steer_des, state, car, kp=sim.speed_kp,
        steer_mode=sim.steer_mode, steer_kp=sim.steer_kp)
    if sim.dynamics == "st":
        new = dyn.st_step(state, accel, steer_vel, car, sim.dt)
    elif sim.dynamics == "ks":
        new = dyn.ks_step(state, accel, steer_vel, car, sim.dt)
    elif sim.dynamics == "ackermann":
        new = dyn.ackermann_step(state, v_des, steer_des, car, sim.dt)
    else:
        raise ValueError(f"unknown dynamics {sim.dynamics!r}")
    new = dyn.apply_standstill(state, new)
    sx = new.x + car.scan_distance_to_base_link * torch.cos(new.theta)
    sy = new.y + car.scan_distance_to_base_link * torch.sin(new.theta)
    return new, sx, sy


def _numbers(car: CarParams, sim: SimParams):
    """The parameters the kernel reads of ``car`` and ``sim``."""
    names = ["max_speed", "max_steer_angle", "max_accel", "max_decel",
             "max_steer_vel", "scan_distance_to_base_link"]
    names += list(_ST_FIELDS) if sim.dynamics == "st" else ["wheelbase"]
    values = [getattr(car, k) for k in names] + [sim.dt]
    values += [sim.speed_kp] if sim.speed_kp is not None else []
    if sim.steer_mode == "smooth" and sim.steer_kp is not None:
        values.append(sim.steer_kp)
    return values


def _broadcasts_to(shape, target) -> bool:
    """Whether ``shape`` broadcasts to ``target`` without enlarging it.
    (``torch.broadcast_shapes`` would do, but its first call imports
    ``torch.fx``'s symbolic shapes and sympy: seconds of a process's
    set-up.)"""
    return len(shape) <= len(target) and all(
        s in (1, t) for s, t in zip(reversed(shape), reversed(target)))


def fused_step(state: CarState, v_des, steer_des, car: CarParams,
               sim: SimParams) -> bool:
    """Whether a step may take ``car_step`` (module doc)."""
    if sim.dynamics not in _MODELS or not all(
            isinstance(v, (int, float)) for v in _numbers(car, sim)):
        return False
    floats = [getattr(state, f) for f in _FLOAT_FIELDS]
    flags = [state.st_dyn, state.collision]
    commands = [v_des, steer_des]
    if not all(torch.is_tensor(t) for t in floats + flags + commands):
        return False
    ref = state.x
    if (ref.device.type not in ("cpu", "cuda")
            or any(t.device != ref.device for t in floats + flags + commands)
            or any(t.dtype != torch.float32 for t in floats + commands)
            or any(t.dtype != torch.bool for t in flags)
            or any(t.shape != ref.shape for t in floats + flags)):
        return False
    if not all(_broadcasts_to(t.shape, ref.shape) for t in commands):
        return False
    return not (torch.is_grad_enabled() and any(
        t.requires_grad for t in floats + commands))


@functools.lru_cache(maxsize=64)
def constants(car: CarParams, sim: SimParams) -> tuple:
    """The kernel's scalars (``struct Consts`` of ``csrc/car_step.cu``, in
    its order), each the float32 that ``compose`` hands PyTorch: the
    products and quotients of numbers formed in double as Python forms
    them, then rounded once; a tensor divided by a number taken, as
    PyTorch's CUDA kernel takes it, as a multiply by the number's
    reciprocal, formed in double and rounded to float32 (measured on the
    card: for 0.29 that is 3.4482758, where 1 / float32(0.29) in float32
    would be 3.448276)."""
    f32 = np.float32
    kp = (sim.speed_kp if sim.speed_kp is not None
          else 2.0 * car.max_accel / car.max_speed)
    steer_kp = 0.0                     # read by "smooth" only
    if sim.steer_mode == "smooth":
        steer_kp = (sim.steer_kp if sim.steer_kp is not None
                    else 2.0 * car.max_steer_vel / car.max_steer_angle)
    if sim.dynamics == "st":
        lf, lr = car.l_f, car.l_r
        lwb = lf + lr
        mu, m, iz = car.friction_coeff, car.mass, car.I_z
        csf, csr = car.cs_f, car.cs_r
        st = (lr, lf, 1e-3, car.v_switch, car.h_cg, dyn.G * lr, dyn.G * lf,
              lf * csf, lr * csr, lf * lf * csf, lr * lr * csr,
              mu * m / (iz * lwb), lwb, mu, csf, csr)
    else:
        lwb = car.wheelbase
        st = (0.0,) * 16
    inv_lwb = 1.0 / lwb
    values = (car.max_speed, car.max_steer_angle, kp, car.max_accel,
              car.max_decel, steer_kp, car.max_steer_vel, 1e-4, sim.dt,
              inv_lwb, *st, car.scan_distance_to_base_link)
    return tuple(float(f32(v)) for v in values)


def car_step_plain(state: CarState, v_des, steer_des, car: CarParams,
                   sim: SimParams):
    """The kernel's plain twin: ``compose``, its car-steps counted in
    ``CAR_COUNTS.host``."""
    out = compose(state, v_des, steer_des, car, sim)
    CAR_COUNTS.host["steps"] += out[0].x.numel()
    return out


def _command(t, shape):
    """A command as the kernel reads it: (tensor, stride), stride 0 for
    one value broadcast to every car."""
    t = t.broadcast_to(shape)
    if all(s == 0 for s in t.stride()):
        return t, 0
    return t.contiguous(), 1


def car_step(state: CarState, v_des, steer_des, car: CarParams,
             sim: SimParams):
    """The step of ``compose`` for a step that ``fused_step`` admits (the
    caller's check, not repeated here): ``car_step_plain`` on CPU tensors,
    one launch of ``csrc/car_step.cu`` on CUDA tensors;
    ``car_step.launches`` counts the launches. Returns ``(new_state, sx,
    sy)``."""
    ref = state.x
    if not _kernels.on_cuda("car_step", ref):
        return car_step_plain(state, v_des, steer_des, car, sim)
    shape = ref.shape
    n = ref.numel()
    if n >= 2 ** 31:
        raise ValueError(f"car_step: {n} cars; one thread a car needs "
                         "fewer than 2^31")
    fields = [getattr(state, f).contiguous()
              for f in _FLOAT_FIELDS + ("collision",)]
    (vd, vd_stride), (sd, sd_stride) = (_command(t, shape)
                                        for t in (v_des, steer_des))
    out = {f: torch.empty(shape, dtype=torch.float32, device=ref.device)
           for f in _FLOAT_FIELDS}
    out["st_dyn"] = torch.empty(shape, dtype=torch.bool, device=ref.device)
    out["collision"] = torch.empty_like(out["st_dyn"])
    sx, sy = torch.empty_like(out["x"]), torch.empty_like(out["x"])
    consts = constants(car, sim)
    _kernels.launch(
        "car_step", "car_step", int(sim.dynamics == "st"),
        int(sim.steer_mode == "smooth"), *fields, vd, sd, vd_stride,
        sd_stride, *(out[f] for f in _FLOAT_FIELDS), out["st_dyn"],
        out["collision"], sx, sy, n, (ctypes.c_float * len(consts))(*consts),
        len(consts), CAR_COUNTS.counter(ref.device), COUNT_LANES)
    return CarState(**out), sx, sy


_kernels.register(car_step)
