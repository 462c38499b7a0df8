"""Time the general-segment sweep (``csrc/general_sweep.cu``), and the paths
that run it, of one checkout of the port on the card: for comparing two
commits on the same card.

    python3 scripts/general_ab_torch.py [--tree DIR] [--maps levine,berlin]
                                        [--agents 4096] [--json OUT]
                                        [--kernels-only]

``--tree`` is the root of the checkout whose package is timed (default:
the one holding this script), so one call can time a parent commit
unpacked beside the change, in turns: parent, change, change, parent.
Per map, at ``--agents`` x 1080 beams, 270 degrees, 10 m, on
poses sampled from seed 0 (five sets that differ by 1e-4 rad, one per
call), as the "segments_simplified" scan
hands them over (levine: the (6, K) table as one list; berlin: each
agent's 4 m tile list): ``general_sweep`` min-only and winner; then the
"segments_simplified" step replayed as a CUDA graph (noise on, 50
chained steps) and its BPTT train step (T = 5, Adam, one graph).
``--kernels-only`` leaves out the step and the train step. Milliseconds
from CUDA events after warm-up; beside each kernel the sums of its
outputs on the first set (float64; a clamp to 10 m first, as the scan
clamps, so that misses add 10, not 3e38), which two checkouts of one
function share; and nvcc's resource report of the sweep's source. Prints
one JSON line (also written to ``--json``), with the card's name and
power limit from ``nvidia-smi``. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

BEAMS = 1080
FOV = 4.712388980384690
MAX_RANGE = 10.0
TRAIN_T = 5


def timed(fn, reps, warmup=3):
    """Mean ms of ``fn(i)`` over ``reps`` calls, CUDA events."""
    import torch
    for i in range(warmup):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


def kernels(track, bundle, poses):
    """``general_sweep`` in both modes on one map."""
    import torch
    from pyracecarsimulator_tpu_torch.ops import raycast_general as rg
    from pyracecarsimulator_tpu_torch.ops.common import (rays_from_poses,
                                                         tile_ids)
    g = bundle.segmap
    sets = []
    for k in range(5):
        _, q, xb, yb, ct, st = rays_from_poses(poses + 1e-4 * k, BEAMS, FOV)
        if g.tiles is not None:
            sets.append((g.tiles, tile_ids(g.tiles_shape, g.tile_size,
                                           g.tile_origin, q[:, 0], q[:, 1]),
                         xb, yb, ct, st))
        else:
            sets.append((g.params[None], None, xb, yb, ct, st))
    out = {"table": list(sets[0][0].shape)}
    for winner in (False, True):
        mode = "winner" if winner else "min"
        out[f"general_sweep {mode}"] = timed(
            lambda i: rg.general_sweep(*sets[i % 5], winner), 50)
        got = rg.general_sweep(*sets[0], winner)
        out[f"general_sweep {mode} sums"] = [
            float(torch.clamp(got[0], max=MAX_RANGE).double().sum())] + [
            float(v.double().sum()) for v in got[1:] if v is not None]
    return out


def paths(P, bundle, poses, agents):
    """The graphed simplified step and train step on one map."""
    import torch
    from pyracecarsimulator_tpu_torch.parallel import make_bptt_train_fn
    out = {}
    p = poses
    step = P.make_step_fn(bundle, with_noise=True, graph=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    state = [P.state_from_pose(p[:, 0], p[:, 1], p[:, 2])]
    act = (torch.full((agents,), 2.0, device="cuda"),
           torch.zeros(agents, device="cuda"))

    def one(i):
        state[0] = step(state[0], act, gen).state
    out["segments_simplified step, graphed"] = timed(one, 50, warmup=5)

    def policy(params, s, ranges, t):
        return (torch.full(s.batch_shape, 2.0, device="cuda"),
                torch.tanh(ranges @ params["w"] + params["b"]))

    def loss_fn(o, t):
        return (torch.mean((o.ranges - 10.0) ** 2)
                + torch.mean((o.state.steer_angle - 0.1) ** 2))
    train, init = make_bptt_train_fn(
        P.make_step_fn(bundle, with_noise=False), policy, loss_fn,
        TRAIN_T, BEAMS, optimizer=lambda ps: torch.optim.Adam(
            ps, lr=3e-3, capturable=True))
    params = {"w": torch.zeros(BEAMS, device="cuda"),
              "b": torch.zeros((), device="cuda")}
    opt = [init(params), params]
    s0 = P.state_from_pose(p[:, 0], p[:, 1], p[:, 2])
    losses = []

    def train_once(i):
        opt[1], opt[0], loss, _ = train(opt[1], opt[0], s0)
        losses.append(loss)
    out[f"segments_simplified train step T={TRAIN_T}, graphed"] = timed(
        train_once, 10, warmup=3)
    out["train losses, first and last"] = [float(losses[0]),
                                           float(losses[-1])]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--maps", default="levine,berlin")
    ap.add_argument("--agents", type=int, default=4096)
    ap.add_argument("--json", default=None)
    ap.add_argument("--kernels-only", action="store_true")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("general_ab_torch.py: no CUDA device", file=sys.stderr)
        return 2
    import pyracecarsimulator_tpu_torch as P
    from pyracecarsimulator_tpu_torch.maps import (load_builtin,
                                                   sample_free_poses)
    assert P.__file__.startswith(tree), P.__file__
    result = {"tree": tree, "card": card(),
              "device": torch.cuda.get_device_name(0), "maps": {}}
    for name in args.maps.split(","):
        track = load_builtin(name, device="cuda")
        bundle = P.build_sim(track, backend="segments_simplified",
                             sim=P.SimParams(steer_mode="smooth"),
                             device="cuda")
        poses = torch.as_tensor(sample_free_poses(
            track, args.agents, np.random.RandomState(0)), device="cuda")
        res = kernels(track, bundle, poses)
        if not args.kernels_only:
            res.update(paths(P, bundle, poses, args.agents))
        result["maps"][name] = res
        print(f"{name}: {res}", file=sys.stderr, flush=True)
    from pyracecarsimulator_tpu_torch.ops import _kernels
    result["nvcc_log"] = _kernels.build_info.get(
        "general_sweep", {}).get("log")
    line = json.dumps(result, default=str)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
