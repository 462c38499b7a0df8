"""Where the time of the port's closed-loop step goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_step.py [--map levine,berlin]
                                          [--backend segments,sectors]
                                          [--agents 4096] [--graph]

For each named map and backend (default: both bundled maps, the default
backend "segments" and the sector backend; any backend of ``build_sim``
may be named, for example ``--map levine --backend edf``), at 4096 agents:
builds the step (``build_sim(name, backend=...)``,
``make_step_fn(with_noise=True)``) and warms it up. Then it times 50 steps
with CUDA events, without the profiler, and records 10 more under
``torch.profiler``. It prints the card's name and power limit, the
unprofiled step time, the device's busy time per step from the trace (see
below), the idle share ``1 - busy / unprofiled step time``, the EDF
march's loop trips per step (``ops/raymarch_xla.MARCH_COUNTS``, read
exactly through ``profiling.counters()`` around the timed loop:
on the card the kernel's device counter, the trips of each march's
longest ray; 0 on the segment backends), the list sweep's real slots a
row (``ops/sweeps.SWEEP_COUNTS``, its device counter read the same way:
slots over rows of the timed steps; 0 where no list sweep runs), and the
operations that take the most device time. The profiled
wall time is printed too, only to show what the profiler adds.

Beside the step it times the scan alone (``make_scan_fn``) twice, with its
march trips: on the sampled poses, shifted between repetitions, and on the
scanner poses of the stepped state, which sit 0.275 m ahead of the base
link; then it times the step a second time. A step that takes longer than
its scan by more than the dynamics' ~2 ms shows here whether it marches
further or does other work. Needs a CUDA card.

The traced steps run with the port's spans on (``utils/profiling.py``:
``profiling.enable()`` first, which also labels the graphed step's
capture) after one warm-up step of the profiler, and are read by
``profiling.report``, the attribution the benchmark's traced runs read:
the device's busy time is the union of its operations' intervals over
the traced steps, and beside it come the device time of each span path
(the step's layers, ``.bwd`` for what autograd launches), the share of
the device time they cover, and the device's idle time by the innermost
span open at each gap. The idle share divides the busy time a step by
the unprofiled step time, as ``device_idle_share`` does.

``--graph`` profiles the step replayed as one CUDA graph
(``make_step_fn(..., graph=True)``; every backend, the EDF ones included,
whose trips the device counter counts under replay too): the same
figures, with the capture's seconds and, from the trace, the host's
``cudaGraphLaunch`` calls per step. The kernels per step then count what
the replay runs plus the copies into the graph's static inputs and the
clones of its outputs.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

TIMED_STEPS = 50
TRACED_STEPS = 10


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--map", default="levine,berlin",
                    help="bundled maps, comma-separated")
    ap.add_argument("--backend", default="segments,sectors",
                    help="backends of build_sim, comma-separated")
    ap.add_argument("--agents", type=int, default=4096)
    ap.add_argument("--graph", action="store_true",
                    help="profile the step replayed as a CUDA graph")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from pyracecarsimulator_tpu_torch import (build_sim, make_scan_fn,
                                              make_step_fn, state_from_pose)
    from pyracecarsimulator_tpu_torch.maps import sample_free_poses
    from pyracecarsimulator_tpu_torch.utils import profiling
    from pyracecarsimulator_tpu_torch.utils.profiling import (device_label,
                                                              timed_loop)

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        raise SystemExit(2)
    agents = args.agents
    card = device_label("cuda")
    print(f"card: {card}")

    def counted(fn, reps, warmup):
        """(ms per call, march trips per call, list-sweep slots per row)
        of ``fn(i)``."""
        for i in range(warmup):
            fn(i)
        before = profiling.counters()
        ms = timed_loop(fn, reps=reps, warmup=0, index=True,
                        device="cuda") * 1e3
        after = profiling.counters()
        grown = {k: {c: after[k][c] - before[k][c] for c in after[k]}
                 for k in ("march", "sweep")}
        return (ms, grown["march"]["trips"] / reps,
                grown["sweep"]["slots"] / max(grown["sweep"]["rows"], 1))

    results = {}
    for name, backend in ((n, b) for n in args.map.split(",")
                          for b in args.backend.split(",")):
        bundle = build_sim(name, backend=backend, device="cuda")
        step = make_step_fn(bundle, with_noise=True, graph=args.graph)
        mode = "graphed" if args.graph else "eager"
        scan = make_scan_fn(bundle)
        poses = torch.as_tensor(sample_free_poses(
            bundle.track, agents, np.random.RandomState(0)), device="cuda")
        state = state_from_pose(poses[:, 0], poses[:, 1], poses[:, 2])
        act = (torch.full((agents,), 2.0, device="cuda"),
               torch.zeros(agents, device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(0)

        def advance(i=0):
            nonlocal state
            state = step(state, act, gen).state

        reps = TIMED_STEPS
        t0 = time.perf_counter()
        advance()               # the first call: builds, and captures
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        step_ms, step_trips, step_slots = counted(advance, reps, 5)

        # the scan alone: on the sampled poses, and where the step scans
        sets = []
        for j in range(5):
            q = poses.clone()
            q[:, 2] += j * 1e-3
            sets.append(q)
        scan_ms, scan_trips, _ = counted(lambda i: scan(sets[i % 5]), reps, 1)
        d = bundle.car.scan_distance_to_base_link
        lidar = torch.stack([state.x + d * torch.cos(state.theta),
                             state.y + d * torch.sin(state.theta),
                             state.theta], dim=-1)
        lidar_ms, lidar_trips, _ = counted(lambda i: scan(lidar), reps, 1)
        # the step once more, after the scans: the spread within one process
        step_ms_2, step_trips_2, _ = counted(advance, reps, 1)

        traced = TRACED_STEPS
        profiling.enable()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1)) as prof:
                advance()
                torch.cuda.synchronize()
                prof.step()
                t0 = time.perf_counter()
                for _ in range(traced):
                    advance()
                torch.cuda.synchronize()
                traced_ms = (time.perf_counter() - t0) * 1e3 / traced
            rep = profiling.report(prof.events(), calls=traced,
                                   steps=traced)
        finally:
            profiling.disable()
        busy = rep["busy_s"] * 1e3 / traced
        # device operations by name (kernels, copies and fills: the aten
        # ops that launch them carry the same device time again)
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep")]
        launches = sum(e.count for e in events) / traced
        graph_launches = sum(e.count for e in prof.key_averages()
                             if e.key == "cudaGraphLaunch") / traced
        print(f"[{name} {backend}] {mode} step; its first call "
              f"{first_s:.3f} s; {graph_launches:.1f} cudaGraphLaunch/step")
        print(f"[{name} {backend}] {card}: {agents} agents, step "
              f"{step_ms:.4f} ms (CUDA events, no profiler), device busy "
              f"{busy:.4f} ms/step (trace), idle share {1 - busy / step_ms:.4f}, "
              f"{launches:.0f} kernels/step, {step_trips:.1f} march trips/"
              f"step, {step_slots:.1f} sweep slots/row; wall under the "
              f"profiler {traced_ms:.4f} ms/step")
        print(f"[{name} {backend}] scan alone: sampled poses {scan_ms:.4f} "
              f"ms, {scan_trips:.1f} march trips/scan; the stepped state's "
              f"scanner poses {lidar_ms:.4f} ms, {lidar_trips:.1f} march "
              f"trips/scan; the step again {step_ms_2:.4f} ms, "
              f"{step_trips_2:.1f} march trips/step")
        spans = {p: r["self_s"] * 1e3 / traced
                 for p, r in rep["spans"].items() if r["self_s"]}
        idle = {k: v * 1e3 / traced for k, v in rep["idle_s"].items()}
        print(f"[{name} {backend}] spans: {rep['coverage']:.4f} of the "
              f"device time attributed, {rep['mismatched_replays']} of "
              f"{rep['replays']} replays unmatched; device ms/step by span "
              f"path (self):")
        for p, ms in sorted(spans.items(), key=lambda kv: -kv[1])[:12]:
            print(f"    {ms:9.4f} ms/step  {p}")
        print(f"[{name} {backend}] device idle ms/step by the span open: "
              + ", ".join(f"{k} {v:.4f}" for k, v in
                          sorted(idle.items(), key=lambda kv: -kv[1])))
        events.sort(key=lambda e: -e.self_device_time_total)
        for e in events[:12]:
            print(f"    {e.self_device_time_total / 1e3 / traced:9.4f} "
                  f"ms/step  x{e.count // traced:<3d} {e.key[:90]}")
        results[f"{name} {backend}"] = {
            "mode": mode, "first_call_s": first_s,
            "graph_launches_per_step": graph_launches,
            "idle_share": 1 - busy / step_ms,
            "step_ms": step_ms, "step_trips": step_trips,
            "step_sweep_slots_per_row": step_slots,
            "step_ms_2": step_ms_2, "step_trips_2": step_trips_2,
            "scan_ms": scan_ms, "scan_trips": scan_trips,
            "lidar_scan_ms": lidar_ms, "lidar_scan_trips": lidar_trips,
            "busy_ms": busy, "kernels_per_step": launches,
            "span_ms_per_step": spans, "span_coverage": rep["coverage"],
            "mismatched_replays": rep["mismatched_replays"],
            "idle_ms_per_step": idle}
    return results


if __name__ == "__main__":
    main()
