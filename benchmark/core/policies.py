"""The traffic mixes' policies and loss, frozen here so that a change to
the program's examples cannot move the yardstick: the program's
``parallel.rollout.make_gap_follower_policy`` and
``examples/torch/demo_train.py``'s ``policy`` and ``loss_fn``, as they
stood when the benchmark was defined. They run inside the program's
rollout and train step (and its CUDA graphs), on its tensors.
"""

from __future__ import annotations

import torch


def gap_follower(num_beams: int, fov: float, speed: float, gain: float):
    """Steer toward the farthest beam (the first one on ties) at a fixed
    speed; no steer at t = 0, before the first scan. ``t`` after step 0
    is a device tensor under a CUDA graph, so the branch tests its type."""
    offsets = {}

    def policy(state, ranges, t):
        dev = ranges.device
        if dev not in offsets:
            offsets[dev] = torch.linspace(
                -fov / 2.0, fov / 2.0, num_beams,
                dtype=torch.float64).to(torch.float32).to(dev)
        v = torch.full(state.batch_shape, float(speed), device=dev)
        if not torch.is_tensor(t) and t == 0:
            return v, torch.zeros(state.batch_shape, device=dev)
        best = torch.argmax(ranges, dim=-1)
        return v, gain * offsets[dev][best]
    return policy


def linear_steer(speed: float):
    """``demo_train``'s policy: tanh of the normalised ranges' dot product
    with one weight a beam, plus a bias; no steer at t = 0."""
    def policy(params, state, ranges, t):
        if t == 0:
            steer = torch.zeros(state.batch_shape, device=state.device)
        else:
            steer = torch.tanh(((ranges - 5.0) / 10.0) @ params["w"]
                               + params["b"])
        return torch.full(state.batch_shape, float(speed),
                          device=state.device), steer
    return policy


def clearance_crash(crash_weight: float):
    """``demo_train``'s loss of one step: minus the mean range plus
    ``crash_weight`` per latched car, averaged over the agents."""
    def loss_fn(out, t):
        clearance = out.ranges.mean(dim=-1)
        crash = out.collision.float()
        return (-clearance + crash_weight * crash).mean()
    return loss_fn
