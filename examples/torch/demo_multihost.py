"""Demo: a fleet sharded over ranks with the PyTorch port (the 65k-agent
configuration across hosts; agents x beams mesh on ``torch.distributed``).

One process per device; each joins the process group, owns a slab of
agents and, with ``--beams-axis`` > 1, a wedge of every scan. On a host
with several cards (NCCL, one card per rank):

    torchrun --nproc-per-node 4 examples/torch/demo_multihost.py \
        --backend nccl --agents 65536 --beams-axis 2

on several hosts add torchrun's ``--nnodes``/``--rdzv-endpoint``; or on
the CPU with gloo:

    torchrun --nproc-per-node 4 examples/torch/demo_multihost.py \
        --backend gloo --device cpu --agents 256 --steps 5 --beams 128

Without torchrun, ``--dryrun 4`` spawns four local gloo ranks through
``parallel.dryrun`` and runs every sharded path on a tiny case, on the one
card or, with ``--device cpu``, on the CPU.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=65536,
                    help="agents over the whole mesh")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--beams-axis", type=int, default=1,
                    help="ranks on the beam axis; must divide the ranks of "
                         "one host so beam collectives stay inside it")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default=None,
                    help="'cpu' with gloo (default: this rank's card; with "
                         "--dryrun, the one card all ranks share)")
    ap.add_argument("--dryrun", type=int, default=0, metavar="N",
                    help="spawn N local gloo ranks on a tiny case instead")
    args = ap.parse_args()

    import torch
    import pyracecarsimulator_tpu_torch as pt

    if args.dryrun:
        from pyracecarsimulator_tpu_torch.parallel.dryrun import dryrun
        res = dryrun(args.dryrun, beams_axis=args.beams_axis,
                     device=args.device)
        print(f"dry run on mesh {res['mesh']} ({res['backend']}, "
              f"{res['device']}): sharded scan {res['scan_sectors'].shape}, "
              f"stacked step {res['step_stack']['ranges'].shape}, ring slab "
              f"rows {res['slab_rows']} of {res['table_rows']}; launches "
              f"per rank {res['launches']}")
        return

    from pyracecarsimulator_tpu_torch.maps import sample_free_poses
    from pyracecarsimulator_tpu_torch.parallel import (
        make_gap_follower_policy, make_rollout_fn, make_sharded_step,
        multihost, shard_state)
    from pyracecarsimulator_tpu_torch.parallel.mesh import all_gather

    if args.device is None:
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    else:
        device = torch.device(args.device)
    multihost.initialize(args.backend)     # from torchrun's environment
    mesh = multihost.make_pod_mesh(beams_axis=args.beams_axis)
    rank0 = torch.distributed.get_rank() == 0
    if rank0:
        print(f"mesh: {mesh.shape} over {torch.distributed.get_world_size()}"
              f" ranks, backend {torch.distributed.get_backend()}; "
              f"{multihost.global_agent_count(args.agents // mesh.agents, mesh)}"
              " agents")

    bundle = pt.build_sim("levine", scan=pt.ScanParams(num_beams=args.beams),
                          backend="sectors", device=device)
    sharded = make_sharded_step(mesh, bundle, with_noise=False)

    def step(state, action, generator=None):
        # the policy reads whole scans: assemble the wedges of the slab
        out = sharded(state, action, generator)
        return out._replace(ranges=all_gather(
            out.ranges, mesh.beams_group, mesh.beams, dim=1))

    # every rank samples the same global batch and keeps its slab
    poses = torch.as_tensor(sample_free_poses(
        bundle.track, args.agents, np.random.RandomState(0), margin=0.5),
        device=device)
    s0 = shard_state(mesh, pt.state_from_pose(poses[:, 0], poses[:, 1],
                                              poses[:, 2]))
    policy = make_gap_follower_policy(args.beams, float(bundle.scan.fov))
    run = make_rollout_fn(step, policy, args.steps, args.beams)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    run(s0)                                 # warm-up (kernel build, caches)
    sync()
    t0 = time.time()
    final, _ = run(s0)
    sync()
    steady = time.time() - t0
    if rank0:
        aps = args.agents * args.steps / steady
        print(f"{args.agents} agents x {args.steps} steps: {steady:.2f}s "
              f"-> {aps:.3e} agent-steps/s, {aps * args.beams:.3e} rays/s "
              f"(closed loop), {int(final.collision.sum())} of "
              f"{final.collision.numel()} cars of rank 0 latched")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
