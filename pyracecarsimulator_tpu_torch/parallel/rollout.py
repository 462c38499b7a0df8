"""Closed-loop rollouts: a Python loop over the step, batched over agents.

Counterpart of ``pyracecarsimulator_tpu/parallel/rollout.py``. The JAX
package compiles the T-step loop into one ``lax.scan`` program; here each
step launches its kernels eagerly (capturing the loop in a CUDA graph is
later work). Trajectories are stacked along a leading time axis, as there.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.common import beam_angles
from ..state import CarState


def make_rollout_fn(step_fn: Callable, policy: Callable, num_steps: int,
                    num_beams: int, keep_scans: bool = False):
    """Build a reusable rollout: ``run(state0, generator=None) ->
    (final_state, traj)``. ``generator`` (a ``torch.Generator`` on the
    state's device) drives the scan noise; None = noiseless."""

    def run(state0: CarState, generator=None):
        state = state0
        ranges = torch.zeros(state0.batch_shape + (num_beams,),
                             dtype=torch.float32, device=state0.device)
        poses, collisions, scans = [], [], []
        for t in range(num_steps):
            action = policy(state, ranges, t)
            out = step_fn(state, action, generator)
            state, ranges = out.state, out.ranges
            poses.append(state.pose)
            collisions.append(out.collision)
            if keep_scans:
                scans.append(ranges)
        traj = {"pose": torch.stack(poses), "collision": torch.stack(
            collisions)}
        if keep_scans:
            traj["ranges"] = torch.stack(scans)
        return state, traj

    return run


def rollout(step_fn: Callable, state0: CarState, policy: Callable,
            num_steps: int, num_beams: int, generator=None,
            keep_scans: bool = False):
    """Run ``num_steps`` of closed-loop simulation.

    ``policy(state, ranges, t) -> (v_des, steer_des)``; at t=0 ranges are
    all zeros (no scan has happened yet). Returns (final_state, traj),
    traj holding poses (T, ..., 3) and collision (T, ...), plus ranges
    (T, ..., num_beams) if ``keep_scans``.
    """
    run = make_rollout_fn(step_fn, policy, num_steps, num_beams, keep_scans)
    return run(state0, generator)


def make_constant_policy(v_des, steer_des):
    """The same command at every step: each of ``v_des`` and ``steer_des``
    a number, or a tensor or array that broadcasts to the state's batch
    shape (one command per agent), as the JAX policy takes them."""
    def policy(state, ranges, t):
        v, s = (torch.as_tensor(c, dtype=torch.float32,
                                device=state.device).expand(state.batch_shape)
                for c in (v_des, steer_des))
        return v, s
    return policy


def make_gap_follower_policy(num_beams: int, fov: float, speed: float = 3.0,
                             steer_gain: float = 0.6):
    """Tiny reactive policy: steer toward the farthest-range beam (the
    first one on ties). Exercises ranges -> control in closed loop."""
    offs_by_device = {}

    def policy(state, ranges, t):
        dev = ranges.device
        if dev not in offs_by_device:
            offs_by_device[dev] = beam_angles(num_beams, fov, dev)
        v = torch.full(state.batch_shape, float(speed), device=dev)
        if t == 0:                      # no scan yet
            return v, torch.zeros(state.batch_shape, device=dev)
        best = torch.argmax(ranges, dim=-1)
        return v, steer_gain * offs_by_device[dev][best]
    return policy
