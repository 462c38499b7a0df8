"""Demo: differentiable simulation with the PyTorch port: localize a car
from a lidar scan.

Uses d(ranges)/d(pose) through the scan (the analytic backward of
``make_scan_fn``) to run gradient descent on the pose until the simulated
scan matches an observed scan.

    python examples/torch/demo_gradients.py [--iters 200] [--device cpu]

Without ``--device`` it runs on the CUDA card (and fails where there is
none).
"""

import argparse
import os
import sys

import numpy as np

# allow running straight from a checkout without installation
sys.path[:0] = [os.path.join(os.path.dirname(__file__), "..", ".."),
                os.path.dirname(os.path.abspath(__file__))]

GUESS_OFFSET = (0.4, -0.3, 0.15)     # the perturbed first guess
LEARNING_RATE = (0.05, 0.05, 0.01)


def make_loss(scan, observed):
    """``loss(pose)``: mean squared range residual against ``observed``."""
    return lambda pose: ((scan(pose) - observed) ** 2).mean()


def main(argv=None):
    from _common import (add_device_arg, launches_since, load_track,
                         most_open_pose)
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--beams", type=int, default=256)
    ap.add_argument("--map", default="levine",
                    help="a bundled map's name or a map YAML's path")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch
    import pyracecarsimulator_tpu_torch as pt
    from pyracecarsimulator_tpu_torch.config import resolve_device
    from pyracecarsimulator_tpu_torch.ops import sweeps

    device = resolve_device(args.device)
    bundle = pt.build_sim(load_track(args.map, device),
                          scan=pt.ScanParams(num_beams=args.beams),
                          device=device)
    scan = pt.make_scan_fn(bundle, backend="segments")

    # ground-truth pose in open space
    true_pose = torch.tensor(most_open_pose(bundle.track, 0.8),
                             dtype=torch.float32, device=device)
    with torch.no_grad():
        observed = scan(true_pose)
    loss = make_loss(scan, observed)

    pose = true_pose + torch.tensor(GUESS_OFFSET, device=device)
    lr = torch.tensor(LEARNING_RATE, device=device)
    print(f"start: err={(pose - true_pose).cpu().numpy()}")
    before = sweeps.launch_counts()
    first = None
    for i in range(args.iters):
        pose = pose.detach().requires_grad_(True)
        value = loss(pose)
        grad, = torch.autograd.grad(value, pose)
        if first is None:
            first = (float(value.detach()), float(grad.norm()))
        pose = pose - lr * grad
    err = (pose.detach() - true_pose).cpu().numpy()
    xy_err = float(np.hypot(*err[:2]))
    print(f"after {args.iters} GD steps: err={err}  "
          f"(|xy| = {xy_err:.4f} m)")
    return {"xy_err": xy_err, "theta_err": float(abs(err[2])),
            "first_loss": first[0], "first_grad_norm": first[1],
            "launches": launches_since(before)}


if __name__ == "__main__":
    main()
