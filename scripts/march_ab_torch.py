"""Time the EDF march kernels, and the paths that run them, of one checkout
of the port on the card: for comparing two commits on the same card.

    python3 scripts/march_ab_torch.py [--tree DIR] [--maps levine,berlin]
                                      [--agents 4096] [--json OUT]
                                      [--no-bench] [--kernels-only]

``--tree`` is the root of the checkout whose package is timed (default:
the one holding this script), so one call can time a parent commit
unpacked beside the change, in turns: parent, change, change, parent.
Per map, at ``--agents`` x 1080 beams, 270 degrees, 10 m, 200 trips, on
poses sampled from seed 0 (five sets that differ by 1e-4 rad, one per
call): ``edf_march`` in each variant the checkout has (the implicit one
with "edf_implicit"'s host scalars); ``edf_march_grad`` (the EDF's
gradient, and for "bilinear" the rays'), given the march's ``walk``
record where the checkout's gradient takes one, as ``march_rays``'s
backward does (the record made before the timing: the forward's work);
``march_rays`` bilinear forward and backward in the rays (the train
step's backward); the "edf" and "edf_bilinear" steps replayed as CUDA
graphs (noise on, 50 chained steps) and their BPTT train steps (T = 5,
Adam, one graph); then, once, ``bench_torch.py``'s ``levine_dmap_fwdbwd``
and ``levine_dmap_implicit_fwdbwd`` from the same checkout.
``--no-bench`` leaves out the bench keys, ``--kernels-only`` the steps,
train steps and bench keys. Milliseconds from CUDA events after warm-up;
beside each kernel, the sums of its outputs on the first set (float64:
the ranges, and the EDF's and the rays' gradients), which two checkouts
of one function share (the EDF's gradient to float32 rounding: atomics);
and nvcc's resource report of the march's source where this process
built it. Prints one JSON line (also written to ``--json``), with the card's name
and power limit. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import tempfile

BEAMS = 1080
FOV = 4.712388980384690
MAX_RANGE = 10.0
ITERS = 200
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


def kernels(P, track, poses, agents):
    """The kernels' times on one map."""
    import torch
    from pyracecarsimulator_tpu_torch.ops import raymarch_xla as rx
    from pyracecarsimulator_tpu_torch.ops.common import rays_from_poses
    sets = [rays_from_poses(poses + 1e-4 * k, BEAMS, FOV)[2:]
            for k in range(5)]
    org = torch.tensor([track.origin_x, track.origin_y], device="cuda")
    ox, oy = rx.origin_xy_f32(org, "cuda")
    head = (track.edf, 1.0 / track.resolution, ox, oy)
    tail = (MAX_RANGE, 1e-4, ITERS, (track.height, track.width))
    out = {}
    for v in rx.VARIANTS:
        kw = {}
        if v == "implicit":
            from pyracecarsimulator_tpu_torch.ops import raymarch_diff as rd
            kw = dict(refine=(rd._surface_level(1e-4, track.resolution),
                              0.4 * track.resolution, rd._DENOM_FLOOR))
        out[f"edf_march {v}"] = timed(
            lambda i: rx.edf_march(*head, *sets[i % 5], *tail, v, **kw), 50)
        got = rx.edf_march(*head, *sets[0], *tail, v, **kw)
        out[f"edf_march {v} sum"] = float(
            (got if torch.is_tensor(got) else got[0]).double().sum())
    g = torch.ones(sets[0][0].shape, device="cuda")
    recorded = "walk" in inspect.signature(rx.edf_march_grad).parameters
    for v in ("nearest", "bilinear"):
        walks = [{}] * 5
        if recorded:
            walks = [dict(walk=torch.empty(r[0].shape, dtype=torch.int32,
                                           device="cuda")) for r in sets]
            for r, w in zip(sets, walks):
                rx.edf_march(*head, *r, *tail, v, **w)
        out[f"edf_march_grad {v}"] = timed(
            lambda i: rx.edf_march_grad(*head, *sets[i % 5], *tail, v, g,
                                        True, v == "bilinear",
                                        **walks[i % 5]), 20)
        g_edf, g_rays = rx.edf_march_grad(*head, *sets[0], *tail, v, g,
                                          True, v == "bilinear", **walks[0])
        out[f"edf_march_grad {v} sums"] = [
            float(t.double().sum()) for t in (g_edf, *(g_rays or ()))]

    def fwd_bwd(i):
        rays = [r.detach().requires_grad_(True) for r in sets[i % 5]]
        rx.march_rays(track.edf, track.resolution, org, *rays,
                      max_range=MAX_RANGE, max_iters=ITERS,
                      interp="bilinear",
                      bounds_hw=(track.height, track.width)).sum().backward()
    out["march_rays bilinear fwd+bwd (rays)"] = timed(fwd_bwd, 20)
    return out


def paths(P, track, poses, agents):
    """The graphed EDF steps and train steps on one map."""
    import torch
    from pyracecarsimulator_tpu_torch.parallel import make_bptt_train_fn
    out = {}
    p = torch.as_tensor(poses, device="cuda")
    for backend in ("edf", "edf_bilinear"):
        bundle = P.build_sim(track, backend=backend,
                             sim=P.SimParams(steer_mode="smooth"),
                             device="cuda")
        step = P.make_step_fn(bundle, with_noise=True, graph=True)
        gen = torch.Generator(device="cuda").manual_seed(1)
        state = [P.state_from_pose(p[:, 0], p[:, 1], p[:, 2])]
        act = (torch.full((agents,), 2.0, device="cuda"),
               torch.zeros(agents, device="cuda"))

        def one(i):
            state[0] = step(state[0], act, gen).state
        out[f"{backend} step, graphed"] = timed(one, 50, warmup=5)

        def policy(params, s, ranges, t):
            return (torch.full(s.batch_shape, 2.0, device="cuda"),
                    torch.tanh(ranges @ params["w"] + params["b"]))

        def loss_fn(o, t):     # the steer term: "edf"'s ranges have none
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

        def train_once(i):
            opt[1], opt[0], _, _ = train(opt[1], opt[0], s0)
        out[f"{backend} train step T={TRAIN_T}, graphed"] = timed(
            train_once, 10, warmup=3)
    return out


def bench(tree):
    """``bench_torch.py``'s two map-gradient keys from ``tree``."""
    spec = importlib.util.spec_from_file_location(
        "bench_torch_ab", os.path.join(tree, "bench_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with tempfile.TemporaryDirectory() as tmp:
        res = mod.main(["--only",
                        "levine_dmap_fwdbwd,levine_dmap_implicit_fwdbwd",
                        "--detail", os.path.join(tmp, "detail.json")])
    return {k: res[k] for k in ("rates", "gates", "failed")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--maps", default="levine,berlin")
    ap.add_argument("--agents", type=int, default=4096)
    ap.add_argument("--json", default=None)
    ap.add_argument("--no-bench", action="store_true")
    ap.add_argument("--kernels-only", action="store_true")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("march_ab_torch.py: no CUDA device", file=sys.stderr)
        return 2
    import pyracecarsimulator_tpu_torch as P
    from pyracecarsimulator_tpu_torch.maps import (load_builtin,
                                                   sample_free_poses)
    assert P.__file__.startswith(tree), P.__file__
    result = {"tree": tree, "card": card(),
              "device": torch.cuda.get_device_name(0), "maps": {}}
    for name in args.maps.split(","):
        track = load_builtin(name, device="cuda")
        poses = torch.as_tensor(sample_free_poses(
            track, args.agents, np.random.RandomState(0)), device="cuda")
        result["maps"][name] = kernels(P, track, poses, args.agents)
        if not args.kernels_only:
            result["maps"][name].update(paths(P, track, poses, args.agents))
        print(f"{name}: {result['maps'][name]}", file=sys.stderr, flush=True)
    from pyracecarsimulator_tpu_torch.ops import _kernels
    result["nvcc_log"] = _kernels.build_info.get("edf_march", {}).get("log")
    if not (args.no_bench or args.kernels_only):
        result["bench_torch"] = bench(tree)
    line = json.dumps(result, default=str)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
