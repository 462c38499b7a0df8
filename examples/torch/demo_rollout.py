"""Demo: thousands of cars driving the levine map in lockstep, with the
PyTorch port.

Every step advances all agents at once: input processing, dynamics, one
batched lidar scan on the default "segments" backend (one launch of the
dense sweep kernel on levine) and the TTC latch; a gap-follower policy
closes the loop (``parallel.rollout``). On the card the loop replays from
CUDA graphs, one launch from the host per step (``rollout``'s default);
with ``--device cpu`` it runs eagerly.

    python examples/torch/demo_rollout.py [--agents 4096] [--steps 500]
                                          [--device cpu]

Without ``--device`` it runs on the CUDA card (and fails where there is
none).
"""

import argparse
import os
import sys
import time

import numpy as np

# allow running straight from a checkout without installation
sys.path[:0] = [os.path.join(os.path.dirname(__file__), "..", ".."),
                os.path.dirname(os.path.abspath(__file__))]


def main(argv=None):
    from _common import (add_device_arg, launches_since, load_track,
                         sync_fn)
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--map", default="levine",
                    help="a bundled map's name or a map YAML's path")
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--render", default="",
                    help="write a PNG of trajectories + final scans")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch
    import pyracecarsimulator_tpu_torch as pt
    from pyracecarsimulator_tpu_torch.config import resolve_device
    from pyracecarsimulator_tpu_torch.maps import sample_free_poses
    from pyracecarsimulator_tpu_torch.ops import sweeps
    from pyracecarsimulator_tpu_torch.parallel import (
        rollout, make_gap_follower_policy)

    device = resolve_device(args.device)
    sync = sync_fn(device)
    bundle = pt.build_sim(load_track(args.map, device),
                          scan=pt.ScanParams(num_beams=args.beams),
                          device=device)
    step = pt.make_step_fn(bundle, backend="segments", with_noise=False)

    # spawn everyone at open poses
    poses = torch.as_tensor(sample_free_poses(
        bundle.track, args.agents, np.random.RandomState(0), margin=0.5),
        device=device)
    s0 = pt.state_from_pose(poses[:, 0], poses[:, 1], poses[:, 2])

    policy = make_gap_follower_policy(args.beams, float(bundle.scan.fov),
                                      speed=3.0)
    print(f"running {args.agents} agents x {args.steps} steps on "
          f"{device}...")
    before = sweeps.launch_counts()
    t0 = time.time()
    with torch.no_grad():
        final, traj = rollout(step, s0, policy, args.steps, args.beams,
                              keep_scans=bool(args.render))
    sync()
    wall = time.time() - t0
    crashed = float(final.collision.float().mean())
    steps_s = args.agents * args.steps / wall
    launches = launches_since(before)
    print(f"done in {wall:.1f}s  ({steps_s:.3e} agent-steps/s incl the "
          f"kernels' first build); kernel launches {launches}")
    print(f"crashed: {crashed * 100:.1f}%   "
          f"mean speed: {float(final.velocity.mean()):.2f} m/s")
    if args.render:
        from pyracecarsimulator_tpu_torch.utils.viz import render
        n_draw = min(args.agents, 16)
        render(bundle.track, poses=final.pose[:n_draw],
               scans=traj["ranges"][-1, :n_draw],
               trajectories=traj["pose"][:, :n_draw],
               path=args.render, fov=float(bundle.scan.fov))
        print(f"rendered {args.render}")
    return {"crashed": crashed, "mean_speed": float(final.velocity.mean()),
            "agent_steps_per_s": steps_s, "launches": launches}


if __name__ == "__main__":
    main()
