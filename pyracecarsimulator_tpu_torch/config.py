"""Static configuration for the PyTorch port of the racecar simulator.

Counterpart of ``pyracecarsimulator_tpu/config.py``: the same three frozen
dataclasses with the same field names and F1TENTH defaults. Fields are
Python scalars (or tensors broadcastable against the agent batch for
per-agent variation); nothing here is traced, so no pytree registration.
"""

from __future__ import annotations

import dataclasses
from typing import Any

_STEER_MODES = ("bang", "smooth")


@dataclasses.dataclass(frozen=True)
class CarParams:
    """Vehicle body / dynamics parameters (F1TENTH single-track values)."""

    # Geometry
    wheelbase: Any = 0.3302        # l_f + l_r [m]
    width: Any = 0.2032            # car width [m]
    length: Any = 0.51             # car length [m] (bumper to bumper)
    l_f: Any = 0.15875             # CG -> front axle [m]
    l_r: Any = 0.17145             # CG -> rear axle [m]
    h_cg: Any = 0.074              # CG height [m]
    # Mass / inertia
    mass: Any = 3.47               # [kg]
    I_z: Any = 0.04712             # yaw moment of inertia [kg m^2]
    # Tire / friction (linear tire model, CommonRoad single-track)
    cs_f: Any = 4.718              # front cornering stiffness coeff [1/rad]
    cs_r: Any = 5.4562             # rear cornering stiffness coeff [1/rad]
    friction_coeff: Any = 0.523    # tire-road friction mu
    # Actuator limits
    max_speed: Any = 7.0           # [m/s]
    max_accel: Any = 7.51          # [m/s^2]
    max_decel: Any = 8.26          # [m/s^2]
    max_steer_angle: Any = 0.4189  # [rad]
    max_steer_vel: Any = 3.2       # [rad/s]
    # KS<->ST blending threshold (the slip-angle ODE is singular below it)
    v_switch: Any = 0.8            # [m/s]
    # Lidar mounting: distance from base_link (rear axle) to scanner origin
    scan_distance_to_base_link: Any = 0.275  # [m]


@dataclasses.dataclass(frozen=True)
class ScanParams:
    """Lidar scan-simulation parameters. ``max_march_iters`` and ``interp``
    belong to the EDF march backends, which are not ported yet; they are
    kept so that configurations carry over unchanged."""

    num_beams: Any = 1080            # beams per scan
    fov: Any = 4.712388980384690     # field of view [rad] (270 deg)
    scan_std_dev: Any = 0.01         # Gaussian range noise sigma [m]
    ray_tracing_epsilon: Any = 0.0001  # distance-transform hit threshold [m]
    theta_discretization: Any = 2000  # sin/cos table buckets
    max_range: Any = 10.0            # range clamp [m]
    max_march_iters: Any = 200       # EDF march trip count
    use_theta_table: Any = False     # True = reference theta-bucket trig
    interp: Any = "nearest"          # EDF sampling: "nearest" | "bilinear"


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Top-level step parameters for the closed-loop simulator facade."""

    dt: Any = 0.01                  # physics timestep [s]
    ttc_threshold: Any = 0.01       # time-to-collision latch threshold [s]
    dynamics: Any = "st"            # "st" | "ks" | "ackermann"
    speed_kp: Any = None            # default 2*max_accel/max_speed
    # "bang" = the reference's bang-bang steering velocity; "smooth" =
    # clamped P-control, differentiable near the target
    steer_mode: Any = "bang"
    steer_kp: Any = None            # default 2*max_steer_vel/max_steer_angle

    def __post_init__(self):
        if self.steer_mode not in _STEER_MODES:
            raise ValueError(
                f"steer_mode must be 'bang' or 'smooth' (got "
                f"{self.steer_mode!r})")


# Fields that change shapes or code paths (the JAX package hashes them into
# jit static arguments; kept for API parity).
STATIC_SCAN_FIELDS = (
    "num_beams",
    "theta_discretization",
    "max_march_iters",
    "use_theta_table",
    "interp",
)
STATIC_SIM_FIELDS = ("dynamics", "steer_mode")


def replace(params, **kw):
    """dataclasses.replace for the parameter classes."""
    return dataclasses.replace(params, **kw)
