"""Demo: trajectory optimization by BPTT through the closed-loop rollout,
with the PyTorch port.

Gradient-descends a per-step steering sequence through T simulation steps
(dynamics + lidar + TTC latch, a Python loop under autograd) to maximize
worst-beam clearance along the path: the gradient-based counterpart of
the sampling MPC in ``demo_mpc.py``. The raycast backward is the analytic
O(rays) VJP (``ops/raycast_grad.py``). On the card the objective and its
gradient (T steps forward, one backward) are captured once in a CUDA
graph and replayed every iteration (``utils.graph.GraphedFunction``);
with ``--device cpu`` they run eagerly.

    python examples/torch/demo_bptt.py [--steps T] [--iters N]
                                       [--device cpu]

Without ``--device`` it runs on the CUDA card (and fails where there is
none).
"""

import argparse
import os
import sys

sys.path[:0] = [os.path.join(os.path.dirname(__file__), "..", ".."),
                os.path.dirname(os.path.abspath(__file__))]

SPEED = 3.0
LEARNING_RATE = 0.08


def make_objective(step, s0):
    """``(unroll, objective)`` over a (T,) steering sequence from ``s0``
    (one car). ``unroll(steers) -> (final, clear, coll)``: the worst-beam
    clearance (T,) and the collision flag (T, 1) of every step."""
    import torch

    def unroll(steers):
        state, clear, coll = s0, [], []
        v = torch.full((1,), SPEED, device=steers.device)
        for s_des in steers:
            out = step(state, (v, s_des.reshape(1)))
            state = out.state
            clear.append(out.ranges.amin())
            coll.append(out.collision)
        return state, torch.stack(clear), torch.stack(coll)

    def objective(steers):
        _, clear, _ = unroll(steers)
        # maximize worst clearance along the path; mild smoothness prior
        return -clear.mean() + 0.05 * (steers.diff() ** 2).sum()

    return unroll, objective


def main(argv=None):
    from _common import (add_device_arg, launches_since, load_track,
                         most_open_pose)
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--beams", type=int, default=256)
    ap.add_argument("--map", default="levine",
                    help="a bundled map's name or a map YAML's path")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch
    import pyracecarsimulator_tpu_torch as pt
    from pyracecarsimulator_tpu_torch.config import resolve_device
    from pyracecarsimulator_tpu_torch.ops import sweeps
    from pyracecarsimulator_tpu_torch.utils.graph import GraphedFunction

    device = resolve_device(args.device)
    # planner-scale timestep: T=30 x 50 ms x 3 m/s covers ~4.5 m of track
    bundle = pt.build_sim(load_track(args.map, device),
                          scan=pt.ScanParams(num_beams=args.beams),
                          sim=pt.SimParams(dynamics="ackermann", dt=0.05),
                          device=device)
    step = pt.make_step_fn(bundle, with_noise=False)

    # start in open space, heading at a wall-ish angle
    x, y, th = most_open_pose(bundle.track, 0.9)
    s0 = pt.state_from_pose(torch.tensor([x], device=device), y, th)
    unroll, objective = make_objective(step, s0)

    def value_and_grad(steers):
        steers = steers.detach().requires_grad_(True)
        value = objective(steers)
        return value.detach(), torch.autograd.grad(value, steers)[0]

    if device.type == "cuda":
        value_and_grad = GraphedFunction(value_and_grad, grad=True,
                                         name="objective and gradient")

    T = args.steps
    steers = torch.zeros(T, device=device)
    before = sweeps.launch_counts()
    l0, g0 = value_and_grad(steers)
    print(f"initial objective {float(l0):+.4f}")
    for i in range(args.iters):
        l, g = value_and_grad(steers)
        steers = (steers - LEARNING_RATE * g).clamp(-0.4, 0.4)
        if (i + 1) % 10 == 0:
            print(f"iter {i+1:3d}  objective {float(l):+.4f}  "
                  f"|g| {float(g.abs().max()):.3f}")
    with torch.no_grad():
        lT = float(objective(steers))
        _, clear0, _ = unroll(torch.zeros(T, device=device))
        _, clearT, coll = unroll(steers)
    print(f"final objective  {lT:+.4f}  (improved {float(l0) - lT:+.4f})")
    print(f"worst clearance along path: {float(clear0.min()):.3f} m -> "
          f"{float(clearT.min()):.3f} m; collisions: {int(coll.sum())}")
    assert lT < float(l0), "BPTT failed to improve the objective"
    return {"first_loss": float(l0), "first_grad_norm": float(g0.norm()),
            "final_loss": lT, "launches": launches_since(before)}


if __name__ == "__main__":
    main()
