"""Tracing and timing utilities.

Counterpart of ``pyracecarsimulator_tpu/utils/profiling.py``: ``trace``
wraps ``torch.profiler``; ``timed_loop`` times repeated calls with CUDA
events where the work runs on the card (PyTorch returns before the device
finishes, so a host clock alone would time the enqueue) and with
``time.perf_counter`` on the CPU. PyTorch runs eagerly: nothing hoists a
repeated call out of the loop, so the JAX harness's per-iteration
perturbation of the inputs has no counterpart; pass ``index=True`` to
change the inputs between repetitions yourself.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """Profile the enclosed block (host, and the card where there is one);
    yields the ``torch.profiler.profile`` object and writes a Chrome trace
    to ``<log_dir>/trace.json`` on exit."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_label(device) -> str:
    """What a report writes beside its numbers: for a CUDA device the
    card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (a card set below its
    maximum runs slower under load), for the CPU the word ``cpu``."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return lines[device.index or 0].strip()


def _first_device(values):
    return next((v.device for v in values if torch.is_tensor(v)), None)


def timed_loop(fn: Callable, *args, reps: int = 20, warmup: int = 2,
               index: bool = False, device=None) -> float:
    """Mean seconds per call of ``fn(*args)`` over ``reps`` calls, after
    ``warmup`` calls. ``index=True`` calls ``fn(i, *args)`` with the
    call's number, so that inputs can change between repetitions.

    ``device``: where the work runs; ``None`` takes the device of the
    first tensor among ``args`` or, failing that, of the warm-up call's
    result. Where neither holds a tensor the work is the CPU's only if
    this process has not touched CUDA; otherwise the call raises and asks
    for ``device``, since a host clock around work on the card would time
    its enqueue. On a CUDA device the loop is bracketed by CUDA events and
    a synchronisation; on the CPU by ``time.perf_counter``."""
    call = (lambda i: fn(i, *args)) if index else (lambda i: fn(*args))
    out = None
    for i in range(warmup):
        out = call(i)
    if device is None:
        device = _first_device(args) or _first_device((out,))
    if device is None:
        if torch.cuda.is_initialized():
            raise ValueError(
                "timed_loop cannot tell where fn runs (no tensor among its "
                "arguments or its result) and this process uses CUDA: pass "
                'device="cuda" or device="cpu"')
        device = "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for i in range(reps):
            call(warmup + i)
        return (time.perf_counter() - t0) / reps
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            call(warmup + i)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e-3 / reps


def rays_per_second(scan_fn: Callable, poses, num_beams: int,
                    reps: int = 20) -> float:
    """Rays per second of ``scan_fn(poses)`` for poses (A, 3)."""
    n_rays = int(poses.shape[0]) * num_beams
    return n_rays / timed_loop(scan_fn, poses, reps=reps)
