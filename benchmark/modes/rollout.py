"""Mode ``rollout``: RL data collection. A call is one closed-loop
rollout of the mix's ``horizon`` steps under the gap follower
(``policy.speed``, ``policy.steer_gain``), every step's scan kept.

The check: a seeded reservoir sample of ``check_calls`` window calls,
each followed by the reference step by step from its start state. Its
actions are the gap follower's on the side's own scan of the step before
(an argmax amplifies a last-bit difference into another beam, so a
free-running reference would leave the program's path); it advances its
own car with them, scans from the side's pose of that step and latches
on its own scan. Compared: every range (off by more than
``TOL_RANGE_M``), every pose (position off by more than ``TOL_POSE_M`` or
heading by more than ``TOL_ANGLE``), every latch, and the final state's
speeds and angles (off by more than ``TOL_STATE``), each as a share.
"""

from __future__ import annotations

import torch

from benchmark.core import faults, policies
from benchmark.core.checks import (TOL_ANGLE, TOL_POSE_M, TOL_RANGE_M,
                                   off_state)

FAULTS = {"frozen_step": faults.frozen_step,
          "half_batch": faults.half_batch,
          "altered_answer": faults.longer_first_scan}


def _policy(mix):
    pol = mix["policy"]
    return float(pol["speed"]), float(pol["steer_gain"])


def program(side, mix, config, gen):
    from pyracecarsimulator_tpu_torch.parallel import make_rollout_fn
    speed, gain = _policy(mix)
    run = make_rollout_fn(
        side.step, policies.gap_follower(side.num_beams, side.fov, speed,
                                         gain),
        int(mix["horizon"]), side.num_beams, keep_scans=True)

    def job(start):
        final, traj = run(side.car_state(start), None)
        return side.fields(final), traj
    job.final = lambda out: out[0]
    return job


def control(side, mix, config, gen):
    w, sim = side.world, side.sim
    offsets = w.offsets.to(w.dtype)
    speed, gain = _policy(mix)
    horizon = int(mix["horizon"])

    def job(start):
        state = w.cast(start)
        v = torch.full((state["x"].shape[0],), speed, dtype=w.dtype,
                       device=w.device)
        poses, cols, scans, ranges = [], [], [], None
        with torch.no_grad():
            for t in range(horizon):
                steer = (torch.zeros_like(v) if t == 0
                         else sim.gap_steer(offsets, ranges, gain))
                new = w.advance(state, v, steer, side.steer_mode)
                sx, sy = w.scanner(new["x"], new["y"], new["theta"])
                ranges = w.scan(sx, sy, new["theta"])
                state = w.latch(new, ranges)
                poses.append(torch.stack(
                    [state["x"], state["y"], state["theta"]], -1).float())
                cols.append(state["collision"])
                scans.append(ranges.float())
        traj = {"pose": torch.stack(poses), "collision": torch.stack(cols),
                "ranges": torch.stack(scans)}
        return side.out(state), traj
    job.final = lambda out: out[0]
    return job


def follow(world, start, final, traj, speed, gain, steer_mode):
    """Counts of what differs in one rollout call (module doc)."""
    from benchmark.reference import sim
    dt = world.dtype
    state = world.cast(start)
    a = state["x"].shape[0]
    v = torch.full((a,), speed, dtype=dt, device=world.device)
    offsets = world.offsets.to(dt)
    n = dict(range_off=0, ranges=0, pose_off=0, poses=0, latch_off=0)
    with torch.no_grad():
        for t in range(traj["pose"].shape[0]):
            steer = (torch.zeros_like(v) if t == 0 else
                     sim.gap_steer(offsets, traj["ranges"][t - 1], gain))
            new = world.advance(state, v, steer, steer_mode)
            px, py, pth = traj["pose"][t].to(dt).unbind(-1)
            sx, sy = world.scanner(px, py, pth)
            r = world.scan(sx, sy, pth)
            state = world.latch(new, r)
            n["range_off"] += int(((traj["ranges"][t].to(dt) - r).abs()
                                   > TOL_RANGE_M).sum())
            n["ranges"] += r.numel()
            off = ((px - state["x"]).abs() > TOL_POSE_M) \
                | ((py - state["y"]).abs() > TOL_POSE_M) \
                | ((pth - state["theta"]).abs() > TOL_ANGLE)
            n["pose_off"] += int(off.sum())
            n["poses"] += a
            n["latch_off"] += int((traj["collision"][t]
                                   != state["collision"]).sum())
    n["state_off"] = int(off_state(final, state).sum())
    n["states"] = a
    return n


class Check:
    setup_calls = 2

    def __init__(self, mix, config):
        self.mix = mix
        self.keep = int(mix["check_calls"])
        self.samples = [None] * self.keep

    def before(self, where, slot, job):
        pass

    def after(self, where, slot, job, start, out):
        if where == "window":
            self.samples[slot] = (start, out[0], out[1])

    def numbers(self, world) -> dict:
        speed, gain = _policy(self.mix)
        tot: dict = {}
        for start, final, traj in filter(None, self.samples):
            n = follow(world, start, final, traj, speed, gain,
                       self.mix["steer_mode"])
            for k, v in n.items():
                tot[k] = tot.get(k, 0) + v
        return {"range_off_share": tot["range_off"] / tot["ranges"],
                "pose_off_share": tot["pose_off"] / tot["poses"],
                "latch_off_share": tot["latch_off"] / tot["poses"],
                "state_off_share": tot["state_off"] / tot["states"]}
