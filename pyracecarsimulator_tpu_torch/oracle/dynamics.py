"""CPU oracle vehicle dynamics (NumPy, scalar) — parity reference.

A copy of ``pyracecarsimulator_tpu/oracle/dynamics.py``. Implements the
reference's three dynamics tiers (lineage ``ackermann_kinematics /
ks_kinematics / st_kinematics`` and the facade's input processing):

* Ackermann: unicycle-with-wheelbase pose update.
* KS (kinematic single track): bicycle model, Euler step.
* ST (dynamic single track, CommonRoad): slip/yaw ODEs with load transfer,
  switching to the KS branch below ``v_switch``.
* Input processing: P-controller speed -> accel (kp = 2*max_accel/max_speed),
  bang-bang steering-angle -> steering-velocity, with actuator clamps.

Scalar, loop-free-of-cleverness NumPy so it can be audited and finite-
differenced; the tensor implementations in ``models/dynamics.py`` and
``models/ttc.py`` must match this to float tolerance
(tests/test_torch_utils.py).
"""

from __future__ import annotations

import numpy as np

G = 9.81


def compute_accel(v_des: float, v: float, p) -> float:
    """Reference facade speed P-control with asymmetric accel/decel clamps."""
    kp = 2.0 * p.max_accel / p.max_speed
    a = kp * (v_des - v)
    if v > 0:
        lo, hi = -p.max_decel, p.max_accel
    elif v < 0:
        lo, hi = -p.max_accel, p.max_decel
    else:
        lo, hi = -p.max_accel, p.max_accel
    return float(np.clip(a, lo, hi))


def compute_steer_vel(steer_des: float, steer: float, p) -> float:
    """Reference bang-bang steering velocity toward the desired angle."""
    dif = steer_des - steer
    if abs(dif) > 1e-4:
        return float(np.sign(dif) * p.max_steer_vel)
    return 0.0


def clip_inputs(accel: float, steer_vel: float, p):
    accel = float(np.clip(accel, -p.max_decel, p.max_accel))
    steer_vel = float(np.clip(steer_vel, -p.max_steer_vel, p.max_steer_vel))
    return accel, steer_vel


def ackermann_step(state: dict, speed: float, steer: float, p, dt: float):
    """Direct-drive kinematic update (reference AckermannKinematics)."""
    s = dict(state)
    x, y, th = s["x"], s["y"], s["theta"]
    thd = speed * np.tan(steer) / p.wheelbase
    s["x"] = x + speed * np.cos(th) * dt
    s["y"] = y + speed * np.sin(th) * dt
    s["theta"] = th + thd * dt
    s["velocity"] = speed
    s["steer_angle"] = steer
    s["angular_velocity"] = thd
    s["slip_angle"] = 0.0
    s["st_dyn"] = False
    return s


def ks_step(state: dict, accel: float, steer_vel: float, p, dt: float):
    """Kinematic single-track Euler step (reference KSKinematics::update)."""
    s = dict(state)
    x, y, th = s["x"], s["y"], s["theta"]
    v, st = s["velocity"], s["steer_angle"]
    s["x"] = x + v * np.cos(th) * dt
    s["y"] = y + v * np.sin(th) * dt
    s["theta"] = th + (v / p.wheelbase) * np.tan(st) * dt
    s["velocity"] = v + accel * dt
    s["steer_angle"] = st + steer_vel * dt
    s["angular_velocity"] = 0.0
    s["slip_angle"] = 0.0
    s["st_dyn"] = False
    return s


def st_step(state: dict, accel: float, steer_vel: float, p, dt: float):
    """Dynamic single-track Euler step with low-speed KS fallback
    (reference STKinematics::update; CommonRoad ST model)."""
    s = dict(state)
    x, y, th = s["x"], s["y"], s["theta"]
    v, st = s["velocity"], s["steer_angle"]
    w, beta = s["angular_velocity"], s["slip_angle"]
    lf, lr = p.l_f, p.l_r
    lwb = lf + lr
    mu, m, Iz, h = p.friction_coeff, p.mass, p.I_z, p.h_cg
    csf, csr = p.cs_f, p.cs_r

    if abs(v) < p.v_switch:
        # Kinematic branch; derive w/beta consistently from geometry.
        x_n = x + v * np.cos(th) * dt
        y_n = y + v * np.sin(th) * dt
        th_d = (v / lwb) * np.tan(st)
        th_n = th + th_d * dt
        v_n = v + accel * dt
        st_n = st + steer_vel * dt
        w_n = (v_n / lwb) * np.tan(st_n)
        beta_n = np.arctan(np.tan(st_n) * lr / lwb)
        return {**s, "x": x_n, "y": y_n, "theta": th_n, "velocity": v_n,
                "steer_angle": st_n, "angular_velocity": float(w_n),
                "slip_angle": float(beta_n), "st_dyn": False}

    a = accel
    # CommonRoad vehicleDynamics_ST yaw/slip ODEs with longitudinal load
    # transfer g*l_r -/+ a*h.
    w_dot = (mu * m / (Iz * lwb)) * (
        lf * csf * (G * lr - a * h) * st
        + (lr * csr * (G * lf + a * h) - lf * csf * (G * lr - a * h)) * beta
        - (lf * lf * csf * (G * lr - a * h)
           + lr * lr * csr * (G * lf + a * h)) * (w / v))
    beta_dot = (mu / (v * lwb)) * (
        csf * (G * lr - a * h) * st
        - (csr * (G * lf + a * h) + csf * (G * lr - a * h)) * beta
        + (csr * (G * lf + a * h) * lr - csf * (G * lr - a * h) * lf)
        * (w / v)) - w

    return {**s,
            "x": x + v * np.cos(th + beta) * dt,
            "y": y + v * np.sin(th + beta) * dt,
            "theta": th + w * dt,
            "velocity": v + a * dt,
            "steer_angle": st + steer_vel * dt,
            "angular_velocity": w + w_dot * dt,
            "slip_angle": beta + beta_dot * dt,
            "st_dyn": True}


def zero_state_dict():
    return {"x": 0.0, "y": 0.0, "theta": 0.0, "velocity": 0.0,
            "steer_angle": 0.0, "angular_velocity": 0.0,
            "slip_angle": 0.0, "st_dyn": False}


def ttc_tables(num_beams: int, fov: float, p):
    """Precompute per-beam cos(beam angle) and distance from scanner origin
    to the car's rectangular footprint edge along each beam (reference
    Precompute::get_cosines / get_car_distances, SURVEY.md §2a).

    Footprint in the scanner frame: the scanner sits
    ``scan_distance_to_base_link`` ahead of the rear axle; the rectangle
    spans [-(scan_dist + rear_overhang), front_edge] longitudinally and
    [-width/2, width/2] laterally, where the car rectangle is centered on
    the wheelbase midpoint with total length ``p.length``.
    """
    offs = np.linspace(-fov / 2.0, fov / 2.0, num_beams)
    cosines = np.cos(offs)
    # Rectangle bounds relative to the scanner origin (car frame, x forward)
    rear_overhang = (p.length - p.wheelbase) / 2.0
    x_min = -(p.scan_distance_to_base_link + rear_overhang)
    x_max = p.wheelbase + rear_overhang - p.scan_distance_to_base_link
    y_min, y_max = -p.width / 2.0, p.width / 2.0
    dists = np.empty(num_beams)
    for i, a in enumerate(offs):
        c, s = np.cos(a), np.sin(a)
        # Ray-from-inside-a-box exit distance (slab method)
        tx = np.inf if c == 0 else max(x_min / c, x_max / c)
        ty = np.inf if s == 0 else max(y_min / s, y_max / s)
        dists[i] = min(tx, ty)
    return cosines.astype(np.float64), dists.astype(np.float64)


def check_ttc(ranges: np.ndarray, velocity: float, cosines: np.ndarray,
              car_distances: np.ndarray, ttc_threshold: float) -> bool:
    """Reference per-beam TTC check (SURVEY.md §2a "TTC collision check")."""
    proj = velocity * cosines
    with np.errstate(divide="ignore", invalid="ignore"):
        ttc = (np.asarray(ranges, np.float64) - car_distances) / proj
    hit = (proj > 0.0) & (ttc >= 0.0) & (ttc < ttc_threshold)
    return bool(hit.any())
