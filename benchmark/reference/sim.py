"""The reference simulator: one closed-loop step of the port's semantics
(input processing, the single-track step, the scan from the lidar, the
time-to-collision latch), the traffic mixes' policies and loss, and Adam,
in plain PyTorch at any float dtype.

``World`` works the map out again from the occupancy grid with the scan
that the configuration names under ``reference_scan``: a module of
``scans/`` found by name (``scans/exact.py``, the first hit on the cell
boundary; ``scans/march_refined.py``, the distance-field march), so that
a backend whose semantics one of them states needs only its
configuration file, and a new semantics one new file. States are dicts
of tensors keyed by the port's field names.
"""

from __future__ import annotations

import importlib
import math

import torch

from . import car as carmod
from . import geometry


def reference_scan(name: str):
    """The module of ``scans/`` named ``name``."""
    if not name.replace("_", "").isalnum():
        raise ValueError(f"no reference scan {name!r}")
    try:
        return importlib.import_module(f"{__package__}.scans.{name}")
    except ModuleNotFoundError as e:
        raise ValueError(f"no reference scan {name!r}") from e


class World:
    def __init__(self, grid, config, device, dtype=torch.float64):
        self.grid = grid
        self.dtype = dtype
        self.device = torch.device(device)
        self.scan_p = config["scan"]
        self.car = config["car"]
        self.sim = config["sim"]
        self.occupied = torch.as_tensor(grid.occupied, device=self.device)
        self.edf = self.dist = None
        self.scan_kind = reference_scan(config["reference_scan"])
        self.scan_kind.prepare(self)
        nb, fov = self.scan_p["num_beams"], self.scan_p["fov"]
        self.offsets = torch.linspace(-fov / 2.0, fov / 2.0, nb,
                                      dtype=torch.float64, device=self.device)
        cos, dist = carmod.ttc_tables(self.offsets, self.car)
        self.ttc_cos, self.ttc_dist = cos.to(dtype), dist.to(dtype)

    # -- scan ---------------------------------------------------------
    def scanner(self, x, y, theta):
        d = self.car["scan_distance_to_base_link"]
        return x + d * torch.cos(theta), y + d * torch.sin(theta)

    def scan(self, sx, sy, theta, grad: bool = False):
        """Ranges (A, B) from scanner origins (A,) and headings (A,).
        ``grad``: the ranges carry the hit's first-order gradient in the
        origins and the heading."""
        dt = self.dtype
        sx, sy, theta = sx.to(dt), sy.to(dt), theta.to(dt)
        nb, fov = self.scan_p["num_beams"], self.scan_p["fov"]
        mr = float(self.scan_p["max_range"])
        c, s, _ = geometry.fan(theta, nb, fov)
        x0 = sx[:, None].expand(c.shape)
        y0 = sy[:, None].expand(c.shape)
        flat = [v.detach().reshape(-1) for v in (x0, y0, c, s)]
        with torch.no_grad():
            r, ok, nx, ny = self.scan_kind.hit(self, *flat, mr)
        r, ok, nx, ny = (v.reshape(c.shape) for v in (r, ok, nx, ny))
        # a scan from outside the map reads max_range on every beam
        h, w = self.grid.shape
        res, (ox, oy) = self.grid.resolution, self.grid.origin
        inside = ((sx >= ox) & (sx < ox + w * res) & (sy >= oy)
                  & (sy < oy + h * res))[:, None]
        ok = ok & inside
        r = torch.where(inside, r, torch.full_like(r, mr))
        if grad:
            r = geometry.differentiable(r, ok, nx, ny, x0, y0, c, s)
        return r

    # -- step ---------------------------------------------------------
    def advance(self, state, v_des, steer_des, steer_mode):
        accel, sv = carmod.process_input(v_des, steer_des, state, self.car,
                                         steer_mode)
        new = carmod.single_track(state, accel, sv, self.car,
                                  float(self.sim["dt"]))
        return carmod.standstill(state, new)

    def latch(self, state, ranges):
        hit = carmod.ttc_hit(ranges.detach(), state["velocity"].detach(),
                             self.ttc_cos, self.ttc_dist,
                             float(self.sim["ttc_threshold"]))
        return carmod.latch(state, hit)

    def cast(self, state):
        """A state in this world's dtype."""
        return {k: (v.to(self.dtype) if v.is_floating_point() else v.clone())
                for k, v in state.items()}


def gap_steer(offsets, ranges, gain):
    """The gap follower's steer: ``gain`` times the offset of the farthest
    beam, the first one on ties."""
    return gain * offsets[torch.argmax(ranges, dim=-1)]


def linear_steer(params, ranges):
    """``demo_train``'s head: tanh of the normalised ranges' dot product
    with one weight a beam, plus a bias."""
    return torch.tanh(((ranges - 5.0) / 10.0) @ params["w"] + params["b"])


def unroll_loss(world, params, start, horizon, speed, crash_weight,
                steer_mode):
    """The bptt mix's rollout loss under autograd: the mean over steps of
    the mean over agents of ``-mean(ranges) + crash_weight * latched``.
    Returns (loss, final state detached)."""
    dt = world.dtype
    state = world.cast(start)
    a = state["x"].shape[0]
    ranges = None
    losses = []
    v_des = torch.full((a,), speed, dtype=dt, device=world.device)
    for t in range(horizon):
        steer = (torch.zeros(a, dtype=dt, device=world.device) if t == 0
                 else linear_steer(params, ranges))
        new = world.advance(state, v_des, steer, steer_mode)
        sx, sy = world.scanner(new["x"], new["y"], new["theta"])
        ranges = world.scan(sx, sy, new["theta"], grad=True)
        state = world.latch(new, ranges)
        crash = state["collision"].to(dt)
        losses.append((-ranges.mean(dim=-1) + crash_weight * crash).mean())
    loss = torch.stack(losses).mean()
    return loss, {k: v.detach() for k, v in state.items()}


class Adam:
    """``torch.optim.Adam``'s update rule, written out: bias-corrected
    first and second moments, ``p -= lr m_hat / (sqrt(v_hat) + eps)``.
    ``m``, ``v`` and ``t`` start it from a state other than the first."""

    B1, B2 = 0.9, 0.999

    def __init__(self, params, lr, eps=1e-8, m=None, v=None, t=0):
        self.lr, self.b1, self.b2, self.eps = lr, self.B1, self.B2, eps
        self.m = {k: (m[k].to(p) if m else torch.zeros_like(p))
                  for k, p in params.items()}
        self.v = {k: (v[k].to(p) if v else torch.zeros_like(p))
                  for k, p in params.items()}
        self.t = int(t)

    def state(self):
        return {"m": {k: v.clone() for k, v in self.m.items()},
                "v": {k: v.clone() for k, v in self.v.items()}, "t": self.t}

    def step(self, params, grads):
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            denom = torch.sqrt(self.v[k]) / math.sqrt(c2) + self.eps
            out[k] = p - (self.lr / c1) * self.m[k] / denom
        return out


def train_step(world, params, opt, start, horizon, speed, crash_weight,
               steer_mode):
    """One train step of the bptt mix from ``start`` with the optimizer
    ``opt``: returns (loss, gradient, parameters after, final state)."""
    leaves = {k: v.detach().to(world.dtype).clone().requires_grad_(True)
              for k, v in params.items()}
    loss, final = unroll_loss(world, leaves, start, horizon, speed,
                              crash_weight, steer_mode)
    keys = sorted(leaves)
    grads = dict(zip(keys, torch.autograd.grad(
        loss, [leaves[k] for k in keys])))
    after = opt.step({k: v.detach() for k, v in leaves.items()}, grads)
    return loss.detach(), grads, after, final
