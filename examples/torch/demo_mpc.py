"""Demo: sampling-based MPC via cloned-state rollouts, with the PyTorch
port.

Cloning a simulator is expanding a state's tensors, and evaluating N
candidate action sequences is ONE batched rollout on the device:

  every control step: clone current state N times -> rollout horizon H
  under N sampled steering sequences -> score (progress, crash penalty)
  -> execute the best sequence's first action.

On the card both replay as CUDA graphs: the H-step evaluation of the N
clones is captured once (``utils.graph.GraphedFunction``) and the single
car's step is ``make_step_fn(..., graph=True)``; with ``--device cpu``
they run eagerly.

    python examples/torch/demo_mpc.py [--candidates 256] [--horizon 30]
                                      [--device cpu]

Without ``--device`` it runs on the CUDA card (and fails where there is
none).
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path[:0] = [os.path.join(os.path.dirname(__file__), "..", ".."),
                os.path.dirname(os.path.abspath(__file__))]


def clone(state, n):
    """'Clone the sim state for rollouts' == expand every field to n."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).expand(
            (n,) + tuple(getattr(state, f.name).shape)).clone()
        for f in dataclasses.fields(state)})


def main(argv=None):
    from _common import (add_device_arg, launches_since, load_track,
                         most_open_pose, sync_fn)
    ap = argparse.ArgumentParser()
    ap.add_argument("--candidates", type=int, default=256)
    ap.add_argument("--horizon", type=int, default=30)
    ap.add_argument("--control-steps", type=int, default=40)
    ap.add_argument("--beams", type=int, default=128)
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
    sync = sync_fn(device)
    on_card = device.type == "cuda"
    N, H = args.candidates, args.horizon
    bundle = pt.build_sim(load_track(args.map, device),
                          scan=pt.ScanParams(num_beams=args.beams),
                          device=device)
    step = pt.make_step_fn(bundle, with_noise=False)
    drive = pt.make_step_fn(bundle, with_noise=False, graph=True) \
        if on_card else step
    speed = torch.full((N,), 3.0, device=device)
    cruise = torch.tensor(3.0, device=device)

    def evaluate(state1, steer_seqs):
        """Rollout N clones under (N, H) steering plans; return scores."""
        s = clone(state1, N)
        dist = torch.zeros(N, device=device)
        for t in range(H):
            s = step(s, (speed, steer_seqs[:, t])).state
            dist = dist + s.velocity * 0.01
        return dist - 50.0 * s.collision.float()

    if on_card:
        evaluate = GraphedFunction(evaluate, name="candidate evaluation")

    x, y, th = most_open_pose(bundle.track)
    state = pt.state_from_pose(torch.tensor(x, device=device), y, th)

    gen = torch.Generator(device=device).manual_seed(0)
    crashed, done = False, 0
    before = sweeps.launch_counts()
    t0 = time.time()
    with torch.no_grad():
        for k in range(args.control_steps):
            # smooth random steering plans around straight
            seqs = 0.25 * torch.randn(N, H, generator=gen, device=device)
            seqs = (seqs.cumsum(dim=1) * 0.15).clamp(-0.4, 0.4)
            best = int(evaluate(state, seqs).argmax())
            out = drive(state, (cruise, seqs[best, 0]))
            state = out.state
            crashed = bool(out.collision)
            done += 1
            if crashed:
                break
    sync()
    wall = time.time() - t0
    sims = done * N * H
    launches = launches_since(before)
    print(f"MPC: {done} control steps x {N} candidates x "
          f"H={H} = {sims} cloned sim-steps in {wall:.1f}s "
          f"({sims / wall:.3e} sim-steps/s incl the kernels' first build); "
          f"kernel launches {launches}")
    print(f"survived: {not crashed}   final speed "
          f"{float(state.velocity):.2f} m/s   pose "
          f"({float(state.x):.1f}, {float(state.y):.1f})")
    return {"survived": not crashed, "control_steps": done,
            "speed": float(state.velocity), "launches": launches}


if __name__ == "__main__":
    main()
