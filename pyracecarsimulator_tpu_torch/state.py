"""Simulation state as a struct of tensors.

Counterpart of ``pyracecarsimulator_tpu/state.py``: every field is a tensor
of one common batch shape (agents are a leading batch dimension, not a
loop), float32 for the continuous fields and bool for the two flags.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .config import resolve_device

FIELDS = ("x", "y", "theta", "velocity", "steer_angle", "angular_velocity",
          "slip_angle", "st_dyn", "collision")
_BOOL_FIELDS = ("st_dyn", "collision")


@dataclasses.dataclass(frozen=True)
class CarState:
    """Full vehicle state. All fields share a common batch shape.

    ``collision`` is the standstill latch: once a TTC check trips, the car
    is stopped and stays stopped until the latch is cleared.
    """

    x: Any                 # world x [m]
    y: Any                 # world y [m]
    theta: Any             # heading [rad]
    velocity: Any          # longitudinal speed [m/s]
    steer_angle: Any       # front wheel steering angle [rad]
    angular_velocity: Any  # yaw rate [rad/s]
    slip_angle: Any        # slip angle beta [rad]
    st_dyn: Any            # bool: last step used the dynamic (ST) branch
    collision: Any         # bool: standstill latch

    @property
    def batch_shape(self):
        return tuple(self.x.shape)

    @property
    def device(self):
        return self.x.device

    @property
    def pose(self):
        """(..., 3) tensor of (x, y, theta) — the scan query pose."""
        return torch.stack([self.x, self.y, self.theta], dim=-1)

    def to(self, device) -> "CarState":
        return CarState(**{f: getattr(self, f).to(device) for f in FIELDS})

    def numpy(self) -> dict:
        """Field name -> host numpy array (the inverse of
        ``state_from_numpy``)."""
        return {f: getattr(self, f).detach().cpu().numpy() for f in FIELDS}


def zero_state(batch_shape=(), dtype=torch.float32,
               device=None) -> CarState:
    """All-zero state (reference initial condition: zeros, no collision).
    ``device=None`` is the card (``config.default_device``)."""
    device = resolve_device(device)
    z = torch.zeros(batch_shape, dtype=dtype, device=device)
    f = torch.zeros(batch_shape, dtype=torch.bool, device=device)
    return CarState(x=z, y=z, theta=z, velocity=z, steer_angle=z,
                    angular_velocity=z, slip_angle=z, st_dyn=f, collision=f)


def state_from_pose(x, y, theta, device=None) -> CarState:
    """State at a given pose with zero velocity (reference set-pose path).

    ``device=None`` keeps the device of a tensor ``x`` (CPU for numbers and
    numpy arrays)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    theta = torch.as_tensor(theta, dtype=torch.float32, device=x.device)
    z = torch.zeros_like(x)
    f = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    return CarState(x=x, y=y.expand(x.shape).clone(),
                    theta=theta.expand(x.shape).clone(), velocity=z,
                    steer_angle=z, angular_velocity=z, slip_angle=z,
                    st_dyn=f, collision=f)


def state_from_numpy(fields: dict, device=None) -> CarState:
    """Build a state from a dict of arrays keyed by field name (for example
    the leaves of the JAX package's state, converted with ``np.asarray``).
    ``device=None`` is the card (``config.default_device``)."""
    device = resolve_device(device)
    out = {}
    for f in FIELDS:
        dtype = torch.bool if f in _BOOL_FIELDS else torch.float32
        out[f] = torch.tensor(np.asarray(fields[f]), dtype=dtype,
                              device=device)
    return CarState(**out)


def set_field(state: CarState, **kw) -> CarState:
    return dataclasses.replace(state, **kw)
