"""Vehicle dynamics on tensors: Ackermann / KS / ST single-track models.

Counterpart of ``pyracecarsimulator_tpu/models/dynamics.py``, operation
for operation in the same order. Every function is elementwise over any
batch shape and branchless: the reference's ``if |v| < v_switch`` is a
``torch.where``, so the whole agent batch steps in lockstep.
"""

from __future__ import annotations

import torch

from ..config import CarParams
from ..state import CarState

G = 9.81


def _full(like, value):
    return torch.full_like(like, value) if not torch.is_tensor(value) \
        else value.to(like.dtype).expand_as(like)


def compute_accel(v_des, v, p: CarParams, kp=None):
    """Speed P-control with asymmetric accel/decel clamps
    (kp = 2*max_accel/max_speed unless overridden)."""
    if kp is None:
        kp = 2.0 * p.max_accel / p.max_speed
    a = kp * (v_des - v)
    # Forward motion: brake limit max_decel, throttle limit max_accel;
    # mirrored in reverse; at standstill symmetric max_accel.
    lo = torch.where(v > 0, _full(v, -p.max_decel), _full(v, -p.max_accel))
    hi = torch.where(v < 0, _full(v, p.max_decel), _full(v, p.max_accel))
    return torch.minimum(torch.maximum(a, lo), hi)


def compute_steer_vel(steer_des, steer, p: CarParams,
                      mode: str = "bang", kp=None):
    """Steering velocity toward the desired angle: ``"bang"`` is the
    reference's sign(err)*max law (zero derivative w.r.t. ``steer_des``
    almost everywhere), ``"smooth"`` clamped P-control with ``kp`` default
    2*max_steer_vel/max_steer_angle."""
    if mode not in ("bang", "smooth"):
        raise ValueError(
            f"steer_mode must be 'bang' or 'smooth' (got {mode!r}) — a "
            "typo here would silently reproduce the zero-gradient "
            "bang-bang training failure")
    dif = steer_des - steer
    if mode == "smooth":
        if kp is None:
            kp = 2.0 * p.max_steer_vel / p.max_steer_angle
        return torch.clamp(kp * dif, -p.max_steer_vel, p.max_steer_vel)
    return torch.where(torch.abs(dif) > 1e-4,
                       torch.sign(dif) * p.max_steer_vel,
                       torch.zeros_like(dif))


def process_input(v_des, steer_des, state: CarState, p: CarParams,
                  kp=None, steer_mode: str = "bang", steer_kp=None):
    """Desired (speed, steer) -> clamped (accel, steer_vel); the desired
    values are clamped to the actuator ranges first."""
    v_des = torch.clamp(v_des, -p.max_speed, p.max_speed)
    steer_des = torch.clamp(steer_des, -p.max_steer_angle,
                            p.max_steer_angle)
    accel = compute_accel(v_des, state.velocity, p, kp)
    steer_vel = compute_steer_vel(steer_des, state.steer_angle, p,
                                  steer_mode, steer_kp)
    return accel, steer_vel


def ackermann_step(state: CarState, speed, steer, p: CarParams, dt
                   ) -> CarState:
    """Direct kinematic update: inputs are (speed, steer), not (accel, sv)."""
    speed = torch.clamp(speed, -p.max_speed, p.max_speed)
    steer = torch.clamp(steer, -p.max_steer_angle, p.max_steer_angle)
    thd = speed * torch.tan(steer) / p.wheelbase
    return CarState(
        x=state.x + speed * torch.cos(state.theta) * dt,
        y=state.y + speed * torch.sin(state.theta) * dt,
        theta=state.theta + thd * dt,
        velocity=speed * torch.ones_like(state.velocity),
        steer_angle=steer * torch.ones_like(state.steer_angle),
        angular_velocity=thd * torch.ones_like(state.angular_velocity),
        slip_angle=torch.zeros_like(state.slip_angle),
        st_dyn=torch.zeros_like(state.st_dyn),
        collision=state.collision,
    )


def ks_step(state: CarState, accel, steer_vel, p: CarParams, dt
            ) -> CarState:
    """Kinematic single-track Euler step."""
    v, st = state.velocity, state.steer_angle
    return CarState(
        x=state.x + v * torch.cos(state.theta) * dt,
        y=state.y + v * torch.sin(state.theta) * dt,
        theta=state.theta + (v / p.wheelbase) * torch.tan(st) * dt,
        velocity=v + accel * dt,
        steer_angle=st + steer_vel * dt,
        angular_velocity=torch.zeros_like(state.angular_velocity),
        slip_angle=torch.zeros_like(state.slip_angle),
        st_dyn=torch.zeros_like(state.st_dyn),
        collision=state.collision,
    )


def st_step(state: CarState, accel, steer_vel, p: CarParams, dt
            ) -> CarState:
    """Dynamic single-track step with the branchless low-speed KS
    fallback: the ST slip/yaw ODEs divide by v, so they run on a guarded
    denominator and are discarded by ``torch.where`` below ``v_switch``.
    """
    x, y, th = state.x, state.y, state.theta
    v, st = state.velocity, state.steer_angle
    w, beta = state.angular_velocity, state.slip_angle
    lf, lr = p.l_f, p.l_r
    lwb = lf + lr
    mu, m, Iz, h = p.friction_coeff, p.mass, p.I_z, p.h_cg
    csf, csr = p.cs_f, p.cs_r
    a = accel

    # --- kinematic branch ---
    th_d_ks = (v / lwb) * torch.tan(st)
    v_ks = v + a * dt
    st_ks = st + steer_vel * dt
    ks = dict(
        x=x + v * torch.cos(th) * dt,
        y=y + v * torch.sin(th) * dt,
        theta=th + th_d_ks * dt,
        velocity=v_ks,
        steer_angle=st_ks,
        angular_velocity=(v_ks / lwb) * torch.tan(st_ks),
        slip_angle=torch.atan(torch.tan(st_ks) * lr / lwb),
    )

    # --- dynamic branch (safe divide; discarded below v_switch, the guard
    # only keeps NaN out of the where) ---
    v_safe = torch.where(torch.abs(v) < 1e-3, torch.full_like(v, 1e-3), v)
    rear = G * lr - a * h   # front-axle load factor
    front = G * lf + a * h  # rear-axle load factor
    w_dot = (mu * m / (Iz * lwb)) * (
        lf * csf * rear * st
        + (lr * csr * front - lf * csf * rear) * beta
        - (lf * lf * csf * rear + lr * lr * csr * front) * (w / v_safe))
    beta_dot = (mu / (v_safe * lwb)) * (
        csf * rear * st
        - (csr * front + csf * rear) * beta
        + (csr * front * lr - csf * rear * lf) * (w / v_safe)) - w
    dyn = dict(
        x=x + v * torch.cos(th + beta) * dt,
        y=y + v * torch.sin(th + beta) * dt,
        theta=th + w * dt,
        velocity=v + a * dt,
        steer_angle=st + steer_vel * dt,
        angular_velocity=w + w_dot * dt,
        slip_angle=beta + beta_dot * dt,
    )

    use_dyn = torch.abs(v) >= p.v_switch
    out = {k: torch.where(use_dyn, dyn[k], ks[k]) for k in dyn}
    return CarState(st_dyn=use_dyn, collision=state.collision, **out)


def apply_standstill(prev: CarState, new: CarState) -> CarState:
    """Collision latch: a latched car does not move (reference ``stop()``
    + early return)."""
    c = prev.collision
    z = torch.zeros_like(prev.velocity)
    pick = lambda a, b: torch.where(c, a, b)
    return CarState(
        x=pick(prev.x, new.x), y=pick(prev.y, new.y),
        theta=pick(prev.theta, new.theta),
        velocity=pick(z, new.velocity),
        steer_angle=pick(z, new.steer_angle),
        angular_velocity=pick(z, new.angular_velocity),
        slip_angle=pick(z, new.slip_angle),
        st_dyn=torch.where(c, torch.zeros_like(prev.st_dyn), new.st_dyn),
        collision=new.collision | c,
    )
