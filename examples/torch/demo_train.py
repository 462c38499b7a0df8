"""Demo: train a reactive steering policy by BPTT through the simulator,
with the PyTorch port.

A linear scan->steer policy (one weight per beam + bias) is trained with
``parallel.train.make_bptt_train_fn``: each optimizer step back-propagates
a T-step closed-loop rollout of the full step (smooth-steering input
processing -> ST dynamics -> sector-culled raycast on the sector sweep
kernel -> TTC latch) and applies a ``torch.optim.Adam`` update. On the card
the whole train step replays as one CUDA graph (the default of
``make_bptt_train_fn``), which is why Adam is built with
``capturable=True`` there; with ``--device cpu`` it runs eagerly.

The objective rewards forward clearance: the policy learns to steer
toward open space. Collisions (latched cars) show up directly in the
loss trace.

    python examples/torch/demo_train.py [--agents N] [--steps T] [--iters K]
                                        [--device cpu]

Without ``--device`` it runs on the CUDA card (and fails where there is
none).
"""

import argparse
import os
import sys

import numpy as np

sys.path[:0] = [os.path.join(os.path.dirname(__file__), "..", ".."),
                os.path.dirname(os.path.abspath(__file__))]


def policy(params, state, ranges, tt):
    import torch
    if tt == 0:                                   # t=0: no scan yet
        steer = torch.zeros(state.batch_shape, device=state.device)
    else:
        # normalized range features keep the tanh head out of saturation
        feats = (ranges - 5.0) / 10.0
        steer = torch.tanh(feats @ params["w"] + params["b"])
    return torch.full(state.batch_shape, 2.5, device=state.device), steer


def loss_fn(out, tt):
    clearance = out.ranges.mean(dim=-1)           # (A,)
    crash = out.collision.float()
    return (-clearance + 25.0 * crash).mean()


def main(argv=None):
    from _common import add_device_arg, launches_since, load_track
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=64)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--beams", type=int, default=180)
    ap.add_argument("--map", default="levine",
                    help="a bundled map's name or a map YAML's path")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch
    import pyracecarsimulator_tpu_torch as pt
    from pyracecarsimulator_tpu_torch.config import resolve_device
    from pyracecarsimulator_tpu_torch.maps import sample_free_poses
    from pyracecarsimulator_tpu_torch.ops import sweeps
    from pyracecarsimulator_tpu_torch.parallel import make_bptt_train_fn

    device = resolve_device(args.device)
    B = args.beams
    bundle = pt.build_sim(
        load_track(args.map, device), scan=pt.ScanParams(num_beams=B),
        sim=pt.SimParams(dt=0.04, steer_mode="smooth"), backend="sectors",
        device=device)
    step = pt.make_step_fn(bundle, with_noise=False)

    # spawn in free space
    poses = torch.as_tensor(sample_free_poses(
        bundle.track, args.agents, np.random.RandomState(0), margin=0.5),
        device=device)
    s0 = pt.state_from_pose(poses[:, 0], poses[:, 1], poses[:, 2])

    train, init = make_bptt_train_fn(
        step, policy, loss_fn, num_steps=args.steps, num_beams=B,
        optimizer=lambda ps: torch.optim.Adam(
            ps, lr=1e-2, capturable=device.type == "cuda"))
    params = {"w": torch.zeros(B, device=device),
              "b": torch.zeros((), device=device)}
    opt_state = init(params)

    before = sweeps.launch_counts()
    losses = []
    for it in range(args.iters):
        params, opt_state, loss, final = train(params, opt_state, s0)
        losses.append(float(loss))
        if it == 0:
            first_grad_norm = float(torch.sqrt(sum(
                (p.grad ** 2).sum() for p in params.values())))
        if it % max(1, args.iters // 10) == 0 or it == args.iters - 1:
            crashed = int(final.collision.sum())
            print(f"iter {it:3d}  loss {losses[-1]:+.4f}  "
                  f"crashed {crashed}/{args.agents}")
    print("|w|_1 =", float(params["w"].detach().abs().sum()),
          " b =", float(params["b"].detach()))
    return {"losses": losses, "first_grad_norm": first_grad_norm,
            "launches": launches_since(before)}


if __name__ == "__main__":
    main()
