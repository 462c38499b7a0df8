"""Where the time of the port's closed-loop step goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_step.py

For each bundled map and each of the default backend ("segments") and the
sector backend, at 4096 agents: builds the step (``build_sim(name,
backend=...)``, ``make_step_fn(with_noise=True)``) and warms it up. Then
it times 50 steps with CUDA events, without the profiler, and records 10
more under ``torch.profiler``. It prints the card's name and power
limit, the unprofiled step time, the device's busy time per step from the
trace (the sum of the kernels' device time; one stream, so kernels do not
overlap), the idle share ``1 - busy / unprofiled step time``, and the kernels
that take the most device time. The profiled wall time is printed too, only
to show what the profiler adds. Needs a CUDA card.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

AGENTS = 4096
TIMED_STEPS = 50
TRACED_STEPS = 10
MAPS = ("levine", "berlin")
BACKENDS = ("segments", "sectors")


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pyracecarsimulator_tpu_torch import (build_sim, make_step_fn,
                                              state_from_pose)
    from pyracecarsimulator_tpu_torch.maps import sample_free_poses
    from pyracecarsimulator_tpu_torch.utils.profiling import timed_loop

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    for name, backend in ((n, b) for n in MAPS for b in BACKENDS):
        bundle = build_sim(name, backend=backend, device="cuda")
        step = make_step_fn(bundle, with_noise=True)
        poses = torch.as_tensor(sample_free_poses(
            bundle.track, AGENTS, np.random.RandomState(0)), device="cuda")
        state = state_from_pose(poses[:, 0], poses[:, 1], poses[:, 2])
        act = (torch.full((AGENTS,), 2.0, device="cuda"),
               torch.zeros(AGENTS, device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        def advance():
            nonlocal state
            state = step(state, act, gen).state

        step_ms = timed_loop(advance, reps=TIMED_STEPS, warmup=5,
                             device="cuda") * 1e3

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(TRACED_STEPS):
                state = step(state, act, gen).state
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3 / TRACED_STEPS
        # kernels only: the aten ops that launch them carry the same
        # device time again
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in events) / 1e3 \
            / TRACED_STEPS
        launches = sum(e.count for e in events) / TRACED_STEPS
        print(f"[{name} {backend}] {card}: {AGENTS} agents, step "
              f"{step_ms:.4f} ms (CUDA events, no profiler), device busy "
              f"{busy:.4f} ms/step (trace), idle share {1 - busy / step_ms:.4f}, "
              f"{launches:.0f} kernels/step; wall under the profiler "
              f"{traced_ms:.4f} ms/step")
        events.sort(key=lambda e: -e.self_device_time_total)
        for e in events[:12]:
            print(f"    {e.self_device_time_total / 1e3 / TRACED_STEPS:9.4f} "
                  f"ms/step  x{e.count // TRACED_STEPS:<3d} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
