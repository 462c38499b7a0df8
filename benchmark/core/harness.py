"""One run of one cell: set-up, the measured window, the traced calls, the
check against the reference, and the result's line. Nothing here knows a
mode: the mix names its mode (``modes/<mode>.py``), which makes the calls
and the check (``core/traffic.py``).

Set-up (``setup_s``, from the process's start to the first timed call):
the imports, the map read, the program's map compile (``map_build_s``),
the seeded inputs, and the mode's set-up calls through the window's own
call: the first captures the CUDA graph (``capture_s`` is its time less
the second's). The window then runs calls back to back for ``seconds``;
every call that started in it counts, whole. Before each window call a
reservoir sample drawn from the seed decides whether the check keeps it.
With ``trace``, ``trace_calls`` more calls run under the profiler once
the window has closed (the sample takes none of them). Then the peak
memory is read, the program is freed, and the reference judges what the
mode kept.
"""

from __future__ import annotations

import gc
import os
import random
import statistics
import sys
import time

import torch

from benchmark.reference.maps import load_map
from benchmark.reference.sim import World

from . import checks, spec, trace
from .sides import Program
from .traffic import ClosedLoop


def _p95_ms(durations):
    if len(durations) < 2:
        return durations[0] * 1e3
    return statistics.quantiles(durations, n=100)[94] * 1e3


def run_cell(bench, cell, seed, seconds, traced, device, t_start,
             bench_dir=spec.BENCH_DIR, side_cls=Program):
    """Returns the result's fields and the check's rows (name, value,
    limit)."""
    device = torch.device(device)
    phases = {"imports_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    config = spec.config(cell["config"], bench_dir)
    mix = spec.traffic(cell["traffic"], bench_dir)
    mode = spec.mode(mix["mode"], bench_dir)
    limits = spec.limits(cell["name"], bench_dir)
    grid = load_map(os.path.join(bench_dir, config["map"]))
    phases["map_read_s"] = time.perf_counter() - t
    t = time.perf_counter()
    side = side_cls(grid, config, mix["steer_mode"], device)
    phases["program_s"] = time.perf_counter() - t
    t = time.perf_counter()
    loop = ClosedLoop(mix, config, grid, side, seed, device, mode)
    loop.setup()
    check = mode.Check(mix, config)
    phases["feed_s"] = time.perf_counter() - t

    # -- set-up calls ------------------------------------------------------
    times = []
    for k in range(max(2, int(check.setup_calls))):
        check.before("setup", k, loop.job)
        t = time.perf_counter()
        start, out = loop.call()
        times.append(time.perf_counter() - t)
        check.after("setup", k, loop.job, start, out)
    capture_s = times[0] - times[1]
    setup_s = time.perf_counter() - t_start
    phases["calls_s"] = times
    print(f"setup {setup_s!r} s: " + ", ".join(
        f"{k} {v!r}" for k, v in phases.items()), file=sys.stderr, flush=True)

    # -- the window --------------------------------------------------------
    durations = []
    rng = random.Random(seed)
    keep = int(check.keep)
    summary = None

    def timed(sample=True):
        n = len(durations) + 1
        slot = n - 1 if n <= keep else rng.randrange(n)
        slot = slot if slot < keep and sample else None
        if slot is not None:
            check.before("window", slot, loop.job)
        t = time.perf_counter()
        start, out = loop.call()
        durations.append(time.perf_counter() - t)
        if slot is not None:
            check.after("window", slot, loop.job, start, out)

    w0 = time.perf_counter()
    while len(durations) < keep + 1 or time.perf_counter() - w0 < seconds:
        timed()
    wall = time.perf_counter() - w0
    attempted = len(durations)
    window = list(durations)
    # the traced calls follow the window: they allocate what its steady
    # calls allocate, and no call of the window runs under the profiler or
    # after it
    n_trace = int(mix["trace_calls"]) if traced else 0
    if n_trace:
        summary = trace.traced_calls(lambda: timed(sample=False), n_trace,
                                     device)

    # -- after the window --------------------------------------------------
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    ctx = {"spans": {"map_build_s": side.map_build_s,
                     "capture_s": capture_s}, "trace": None}
    if summary is not None:
        ctx["trace"] = trace.summarize(
            summary[1], summary[0], n_trace, n_trace * loop.horizon,
            spec.kernel_layers(bench_dir),
            untraced_call_s=statistics.fmean(window))
        summary = None
    e2e = {"setup_s": setup_s, "call_p95_ms": _p95_ms(window),
           mix["rate_metric"]: loop.work * attempted / wall}
    metrics = {}
    kind = "per_layer" if traced else "end_to_end"
    for m in spec.metrics_of(bench, kind, cell["name"]):
        if traced:
            value = spec.metric_reader(m["name"], bench_dir)(ctx)
        else:
            value = e2e[m["name"]]
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # -- free the program, then the reference judges -----------------------
    del loop, side
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    world = World(grid, config, device)
    correct, rows = checks.judge(check.numbers(world), limits)
    print(f"reference check {time.perf_counter() - t!r} s", file=sys.stderr,
          flush=True)

    result = {"correct": bool(correct), "attempted": attempted, "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": int(cell["chips"]),
                         "memory_peak_bytes": int(peak)}}
    if ctx["trace"] is not None:
        tr = ctx["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    return result, rows
