"""Demo: multitrack batched serving with the PyTorch port: one fleet, many
maps, one sweep.

Agents living on different tracks scan in a single call over the stacked
sector tables (``maps.sectors.stack_sector_maps``), so an RL training batch
can mix a whole track distribution without per-map dispatch.

    python examples/torch/demo_multitrack.py [--agents 4096] [--beams 1080]
                                             [--device cpu]

Without ``--device`` it runs on the CUDA card (and fails where there is
none). The last part runs the multitrack step on a 1 x 1 mesh; see
``demo_multihost.py`` for more ranks.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=4096,
                    help="total agents, split across the tracks")
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a card (default: the card)")
    args = ap.parse_args()

    import torch
    import pyracecarsimulator_tpu_torch as pt
    from pyracecarsimulator_tpu_torch.config import resolve_device
    from pyracecarsimulator_tpu_torch.maps import (sample_free_poses,
                                                   stack_sector_maps)
    from pyracecarsimulator_tpu_torch.ops import sweeps
    from pyracecarsimulator_tpu_torch.ops.raycast_sectors import (
        scan_poses_sectors, scan_poses_sectors_multi)
    from pyracecarsimulator_tpu_torch.parallel import (
        make_mesh, make_sharded_step, multihost)

    device = resolve_device(args.device)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    names = ("levine", "berlin")
    scan_p = pt.ScanParams(num_beams=args.beams)
    t0 = time.time()
    bundles = [pt.build_sim(n, scan=scan_p, backend="sectors", device=device)
               for n in names]
    stack = stack_sector_maps([b.segmap for b in bundles])
    print(f"stacked {len(names)} tracks in {time.time() - t0:.1f}s: table "
          f"{tuple(stack.table.shape)} "
          f"({stack.table.numel() * 4 / 1e6:.0f} MB) on {device}")

    per = args.agents // len(names)
    rng = np.random.RandomState(0)
    poses = torch.cat([torch.as_tensor(
        sample_free_poses(b.track, per, rng), device=device)
        for b in bundles])
    map_ids = torch.arange(len(names), device=device,
                           dtype=torch.int32).repeat_interleave(per)

    kw = dict(num_beams=args.beams)
    ranges = scan_poses_sectors_multi(stack, map_ids, poses, **kw)  # warm
    sync()
    t0 = time.time()
    ranges = scan_poses_sectors_multi(stack, map_ids, poses, **kw)
    sync()
    print(f"mixed-batch scan: {tuple(ranges.shape)} in "
          f"{(time.time() - t0) * 1e3:.2f} ms; sector kernel launches so "
          f"far {sweeps.sector_sweep.launches}")

    # parity with each track's own scan
    for i, (n, b) in enumerate(zip(names, bundles)):
        own = scan_poses_sectors(b.segmap, poses[i * per:(i + 1) * per], **kw)
        d = float((ranges[i * per:(i + 1) * per] - own).abs().max())
        print(f"  {n}: max |multi - own| = {d:.2e}")

    # gradients flow per agent into the right map's geometry
    p = poses.clone().requires_grad_(True)
    (scan_poses_sectors_multi(stack, map_ids, p, **kw) ** 2).sum().backward()
    print("pose-gradient norms per track: "
          f"{[float(p.grad[i * per:(i + 1) * per].norm()) for i in range(len(names))]}")

    # the full simulation step with per-agent map routing, on a mesh of
    # this one process (parallel.dryrun and demo_multihost.py run more)
    port = 29500 + os.getpid() % 1000
    multihost.initialize("nccl" if device.type == "cuda" else "gloo",
                         f"tcp://localhost:{port}", world_size=1, rank=0)
    mesh = make_mesh()
    step = make_sharded_step(mesh, bundles[0], with_noise=False, stack=stack)
    n = per * len(names)
    s0 = pt.state_from_pose(poses[:, 0], poses[:, 1], poses[:, 2])
    act = (torch.full((n,), 2.0, device=device),
           torch.zeros(n, device=device))
    out = step(s0, act, map_ids)
    sync()
    print(f"multitrack step on a {mesh.agents} x {mesh.beams} mesh: ranges "
          f"{tuple(out.ranges.shape)}, {int(out.collision.sum())} collisions")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
