"""Plain PyTorch reference of the car: input processing, the single-track
model (CommonRoad's ST equations with the kinematic model below the
switching speed), the standstill latch and the time-to-collision check.

The state is a dict of tensors in one float dtype (``collision`` and
``st_dyn`` bool). Parameters are a plain dict with the names of the
configuration file's ``car`` group.
"""

from __future__ import annotations

import math

import torch

G = 9.81
FLOAT_FIELDS = ("x", "y", "theta", "velocity", "steer_angle",
                "angular_velocity", "slip_angle")


def process_input(v_des, steer_des, state, car, steer_mode):
    """Desired speed and steer, clamped to the actuators -> (accel,
    steer velocity): speed P-control with gain 2 max_accel / max_speed
    and asymmetric limits; steering bang-bang at max_steer_vel outside a
    1e-4 rad dead band, or clamped P-control with gain 2 max_steer_vel /
    max_steer_angle ("smooth")."""
    v = state["velocity"]
    v_des = torch.clamp(v_des, -car["max_speed"], car["max_speed"])
    steer_des = torch.clamp(steer_des, -car["max_steer_angle"],
                            car["max_steer_angle"])
    kp = 2.0 * car["max_accel"] / car["max_speed"]
    full = torch.full_like
    lo = torch.where(v > 0, full(v, -car["max_decel"]),
                     full(v, -car["max_accel"]))
    hi = torch.where(v < 0, full(v, car["max_decel"]),
                     full(v, car["max_accel"]))
    accel = torch.minimum(torch.maximum(kp * (v_des - v), lo), hi)
    dif = steer_des - state["steer_angle"]
    if steer_mode == "smooth":
        kps = 2.0 * car["max_steer_vel"] / car["max_steer_angle"]
        sv = torch.clamp(kps * dif, -car["max_steer_vel"],
                         car["max_steer_vel"])
    else:
        sv = torch.where(torch.abs(dif) > 1e-4,
                         torch.sign(dif) * car["max_steer_vel"],
                         torch.zeros_like(dif))
    return accel, sv


def single_track(state, accel, sv, car, dt):
    """One explicit Euler step of the ST model; below ``v_switch`` the
    kinematic single-track model (whose yaw rate and slip follow from the
    new speed and steer)."""
    x, y, th = state["x"], state["y"], state["theta"]
    v, st = state["velocity"], state["steer_angle"]
    w, beta = state["angular_velocity"], state["slip_angle"]
    lf, lr, h = car["l_f"], car["l_r"], car["h_cg"]
    lwb = lf + lr
    mu, m, iz = car["friction_coeff"], car["mass"], car["I_z"]
    csf, csr = car["cs_f"], car["cs_r"]
    v_new = v + accel * dt
    st_new = st + sv * dt
    ks = dict(x=x + v * torch.cos(th) * dt, y=y + v * torch.sin(th) * dt,
              theta=th + v / lwb * torch.tan(st) * dt,
              angular_velocity=v_new / lwb * torch.tan(st_new),
              slip_angle=torch.atan(torch.tan(st_new) * lr / lwb))
    vs = torch.where(torch.abs(v) < 1e-3, torch.full_like(v, 1e-3), v)
    fz_f = G * lr - accel * h
    fz_r = G * lf + accel * h
    w_dot = mu * m / (iz * lwb) * (
        lf * csf * fz_f * st + (lr * csr * fz_r - lf * csf * fz_f) * beta
        - (lf * lf * csf * fz_f + lr * lr * csr * fz_r) * w / vs)
    beta_dot = mu / (vs * lwb) * (
        csf * fz_f * st - (csr * fz_r + csf * fz_f) * beta
        + (csr * fz_r * lr - csf * fz_f * lf) * w / vs) - w
    dyn = dict(x=x + v * torch.cos(th + beta) * dt,
               y=y + v * torch.sin(th + beta) * dt, theta=th + w * dt,
               angular_velocity=w + w_dot * dt,
               slip_angle=beta + beta_dot * dt)
    use = torch.abs(v) >= car["v_switch"]
    out = {k: torch.where(use, dyn[k], ks[k]) for k in dyn}
    out.update(velocity=v_new, steer_angle=st_new, st_dyn=use,
               collision=state["collision"])
    return out


def standstill(prev, new):
    """A car whose latch was set before the step does not move."""
    c = prev["collision"]
    out = {}
    for k in ("x", "y", "theta"):
        out[k] = torch.where(c, prev[k], new[k])
    for k in ("velocity", "steer_angle", "angular_velocity", "slip_angle"):
        out[k] = torch.where(c, torch.zeros_like(new[k]), new[k])
    out["st_dyn"] = new["st_dyn"] & ~c
    out["collision"] = new["collision"] | c
    return out


def ttc_tables(offsets, car):
    """Per beam: cos of its offset, and the distance from the scanner to
    the edge of the car's rectangle along it (the scanner sits
    ``scan_distance_to_base_link`` ahead of the rear axle, the rectangle
    is centered on the wheelbase's middle)."""
    rear = (car["length"] - car["wheelbase"]) / 2.0
    xs = (-(car["scan_distance_to_base_link"] + rear),
          car["wheelbase"] + rear - car["scan_distance_to_base_link"])
    ys = (-car["width"] / 2.0, car["width"] / 2.0)
    out = []
    for o in offsets.tolist():
        c, s = math.cos(o), math.sin(o)
        tx = max(xs[0] / c, xs[1] / c) if c != 0 else 1e9
        ty = max(ys[0] / s, ys[1] / s) if s != 0 else 1e9
        out.append(min(tx, ty))
    cos = torch.cos(offsets)
    return cos, torch.tensor(out, dtype=offsets.dtype, device=offsets.device)


def ttc_hit(ranges, velocity, cos, car_dist, threshold):
    """True where some beam closes in (v cos > 0) with a time to
    collision in [0, threshold)."""
    proj = velocity[:, None] * cos[None, :]
    ttc = (ranges - car_dist[None, :]) / torch.where(proj > 0, proj,
                                                     torch.ones_like(proj))
    return ((proj > 0) & (ttc >= 0) & (ttc < threshold)).any(dim=-1)


def latch(state, hit):
    """Set the latch where the check tripped; a latched car stands."""
    lat = state["collision"] | hit
    out = dict(state)
    for k in ("velocity", "steer_angle", "angular_velocity", "slip_angle"):
        out[k] = torch.where(lat, torch.zeros_like(state[k]), state[k])
    out["collision"] = lat
    return out
