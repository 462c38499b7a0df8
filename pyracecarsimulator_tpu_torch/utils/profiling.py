"""Tracing, timing and the port's counters.

Counterpart of ``pyracecarsimulator_tpu/utils/profiling.py``: ``trace``
wraps ``torch.profiler``; ``timed_loop`` times repeated calls with CUDA
events where the work runs on the card (PyTorch returns before the device
finishes, so a host clock alone would time the enqueue) and with
``time.perf_counter`` on the CPU. PyTorch runs eagerly: nothing hoists a
repeated call out of the loop, so the JAX harness's per-iteration
perturbation of the inputs has no counterpart; pass ``index=True`` to
change the inputs between repetitions yourself.

**Spans.** ``span(name)`` (a context manager or a decorator) marks a
layer of the port; ``SPANS`` lists them all:

- ``step.dynamics`` (``simulator.advance``), ``step.scan`` (the scan of
  ``make_step_fn``'s step: the fan, the backend's kernels, their glue and
  epilogue), ``step.noise`` (``add_scan_noise``), ``step.ttc``
  (``check_ttc`` and ``latch``);
- ``scan.route``: the routing of ray rows to cull lists inside a scan
  (the sector scan's tile, block-middle angle, sector and row ids,
  ``raycast_sectors._list_ids``; the tile scan's tile and row ids,
  ``raycast_grad.raycast_tiled_diff``), in a step under ``step.scan``;
- ``scan.fan``: the beam fan of a segment scan whose rays are built
  outside the kernel (``raycast_segments.scan_poses_segments``), and the
  dense route's reciprocals and flat ray tensors
  (``raycast_grad.raycast_all_diff``), in a step under ``step.scan``;
- ``rollout.policy``, ``rollout.carry`` (a rollout step's row writes and
  carry copies), ``rollout.blocks`` (the graphed rollout's carry copy-in,
  block copies into the trajectory and final clone);
- ``train.policy``, ``train.loss``, ``train.backward``,
  ``train.optimizer`` (``zero_grad`` and ``step``);
- ``graph.copy_in``, ``graph.replay``, ``graph.copy_out``
  (``GraphedFunction.__call__``, ``utils/graph.py``).

Tracing is off by default: then ``span`` checks one flag and returns a
shared no-op. ``enable()`` turns it on: a span is then a profiler
``RecordFunction`` range (``_Range``), on the profiler's clock (and an
NVTX range under ``torch.autograd.profiler.emit_nvtx()``).
A device operation is attributed to the innermost span open where it was
launched; one that autograd launches takes the span of the forward
operation it differentiates with ``.bwd`` added (``step.scan.bwd``),
matched through the autograd sequence number the profiler records for
both. A span's path is the names of the spans open around it, outermost
first, joined by ``/``.

**CUDA graphs.** Python does not run at a replay, so a span opened while
a function is captured never shows in the trace of a replay. Each capture
of a ``GraphedFunction`` therefore gets, while tracing is on, a label
table: one entry a device operation that one call of the captured
function queues, in launch order, holding the span path of its launch and
the operation's name (where the profiler kept the device's record of
it), read from one eager labelling call under the profiler (on the
warm-up's terms: the side stream, the static inputs, generator states and
the caller's ``snapshot`` put back). ``enable()`` labels the live
captures; a capture made while tracing is on is labelled at once unless a
profiler is running (a table is never built under one: such a capture
has none, and ``report`` counts its replays unmatched). A replay's device
operations are those of the ``cudaGraphLaunch`` inside its
``graph.replay`` span (the same CUPTI correlation); they take their
table's paths by position, checked by count and by name, under the spans
around the replay. ``report`` reads a trace
that way. With tracing off no table exists, and capture and replay are
unchanged.

**Counters.** ``counters()`` gathers the port's counters: the kernel
wrappers' launches (``ops/sweeps.launch_counts``), each live
``GraphedFunction``'s captures and replays, the EDF march's device
counter (``ops/raymarch_xla.MARCH_COUNTS``), the list sweep's
(``ops/sweeps.SWEEP_COUNTS``) and the dense sweep's
(``ops/sweeps.DENSE_COUNTS``), each an exact read: a synchronisation on
the card.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import gc
import itertools
import os
import re
import subprocess
import time
import weakref
from typing import Callable

import torch

SPANS = frozenset({
    "step.dynamics", "step.scan", "step.noise", "step.ttc", "scan.route",
    "scan.fan",
    "rollout.policy", "rollout.carry", "rollout.blocks",
    "train.policy", "train.loss", "train.backward", "train.optimizer",
    "graph.copy_in", "graph.replay", "graph.copy_out"})
OUTSIDE = "outside the program"     # the label of what no span encloses
_TABLE = "graph.table#"     # the range inside graph.replay naming its table
_LAUNCH = re.compile(r"^cu(da)?[A-Z]")  # CUDA runtime and driver calls
_OP = re.compile(r"^cu(da)?(Launch|Memcpy|Memset)")   # ... that queue an op

_enabled = False
_graphs = weakref.WeakValueDictionary()    # serial -> GraphedFunction
_serial = itertools.count()
_tables: dict = {}      # table id -> [(device op name or None, span path)]


class _Span:
    """A span with tracing off: entering and leaving do nothing. As a
    decorator it asks ``span`` again at each call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


class _Range(_Span):
    """A span with tracing on: profiler ranges, outermost first. They are
    ``RecordFunction``s of the function scope, as ``record_function``'s
    are of the user scope: the same events on the profiler's clock and
    the same NVTX ranges under ``emit_nvtx``, but the profiler does not
    draw them on the device's timeline as well (where a trace reader
    would take them for device operations, as it would the profiler's own
    ``ProfilerStep`` marks), and one costs about 0.4 us against 8 with no
    profiler running (PERF.md)."""

    __slots__ = ("_names", "_open")

    def __init__(self, *names: str):
        super().__init__(names[0])
        self._names = names

    def __enter__(self):
        self._open = [torch._C._profiler._RecordFunctionFast(n)
                      for n in self._names]
        for r in self._open:
            r.__enter__()
        return self

    def __exit__(self, *exc):
        for r in reversed(self._open):
            r.__exit__(*exc)
        return False


_OFF = {name: _Span(name) for name in SPANS}


def span(name: str):
    """The span ``name`` (one of ``SPANS``; module doc)."""
    if not _enabled:
        return _OFF[name]
    if name not in _OFF:
        raise KeyError(f"{name!r} is not a span of the port (SPANS)")
    return _Range(name)


def replay_span(table):
    """``graph.replay`` around one replay and, inside it, the range that
    names the capture's label table ``table`` (an id, or None)."""
    if not _enabled:
        return _OFF["graph.replay"]
    if table not in _tables:
        return _Range("graph.replay")
    return _Range("graph.replay", f"{_TABLE}{table}")


def enabled() -> bool:
    return _enabled


def enable():
    """Turn tracing on and label the live captures (module doc), after a
    collection: a capture that only a dead cycle holds is not run."""
    global _enabled
    _enabled = True
    gc.collect()
    for g in list(_graphs.values()):
        g.label()


def disable():
    """Turn tracing off and drop the label tables (read a trace with
    ``report`` first)."""
    global _enabled
    _enabled = False
    _tables.clear()


def register(graphed):
    """Keep a weak reference to a ``GraphedFunction`` for ``enable`` and
    ``counters``."""
    _graphs[next(_serial)] = graphed


def _profiler_running() -> bool:
    return torch._C._autograd._profiler_enabled()


def wants_table(table) -> bool:
    """Whether a capture whose table is ``table`` should be labelled now:
    tracing on, no table, no profiler running."""
    return _enabled and table not in _tables and not _profiler_running()


def label(run_once: Callable, owner) -> int:
    """Run ``run_once()`` (one eager call of a captured function) under the
    profiler and keep its label table while ``owner`` lives; returns the
    table's id."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        run_once()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    # one entry a launch, in launch order (one stream: the device's order).
    # The host's launch records are complete; the device's records of a few
    # eager kernels were seen missing on the card (PERF.md), so an entry
    # whose kernel left none has no name to check a replay's against
    dev, host = _split(prof.events())
    ctx = _Host(host)
    names = {e.id: e.name for e in dev}
    table = [(names.get(e.id), ctx.eager_path(e)) for e in sorted(
        (e for e in ctx.launches.values() if _OP.match(e.name)), key=_start)]
    key = next(_serial)
    _tables[key] = table
    weakref.finalize(owner, _tables.pop, key, None)
    return key


def counters() -> dict:
    """The port's counters from one place (module doc): ``launches``
    (wrapper name -> kernel launches), ``graphs`` (one dict a live
    ``GraphedFunction``: ``name``, ``captures``, ``replays``), ``march``
    (``{"calls", "trips"}`` of the EDF marches), ``sweep`` (``{"rows",
    "slots", "kept", "fanned"}`` of the list sweeps) and ``dense``
    (``{"rays", "pairs"}`` of the dense sweep), each read exactly."""
    from ..ops import sweeps
    from ..ops.raymarch_xla import MARCH_COUNTS
    return {"launches": sweeps.launch_counts(),
            "graphs": [{"name": g.name, "captures": g.captures,
                        "replays": g.replays}
                       for g in list(_graphs.values())],
            "march": dict(MARCH_COUNTS),
            "sweep": dict(sweeps.SWEEP_COUNTS),
            "dense": dict(sweeps.DENSE_COUNTS)}


# -- reading a trace ---------------------------------------------------------

def _start(e) -> float:
    return float(e.time_range.start)


def _end(e) -> float:
    return float(e.time_range.end)


def _kind(name: str) -> str:
    """An operation's name for matching a replay against its table: a
    graph may run a copy that the eager call queued as a copy as a kernel
    of the driver's (``Memcpy DtoD`` against ``memcpy32_post``, seen on
    the card), so copies and fills match by kind."""
    low = name.lower()
    return next((k for k in ("memcpy", "memset") if k in low), name)


def _split(events):
    """(device operations, host events) of profiler events: the device's
    kernels, copies and fills, without the profiler's step marks and the
    ranges that the profiler also draws on the device's timeline."""
    dev, host = [], []
    for e in events:
        (dev if "cuda" in str(getattr(e, "device_type", "")).lower()
         else host).append(e)
    marks = {e.name for e in host if getattr(e, "is_user_annotation", False)}
    dev = [e for e in dev if not getattr(e, "is_user_annotation", False)
           and e.name not in marks and not e.name.startswith("ProfilerStep")]
    return dev, host


class _Host:
    """What the host events say about each launch: the program spans open
    around it on its thread, the innermost autograd node it runs in, the
    label table of the replay around it; and the forward operation of
    each autograd sequence number."""

    def __init__(self, host):
        self.launches = {e.id: e for e in host if _LAUNCH.match(e.name)}
        self.info = {}          # id(event) -> (path, backward node, table)
        self.forward = {}       # (thread, sequence nr) -> span path
        threads: dict = {}
        for e in host:
            threads.setdefault(e.thread, []).append(e)
        spans = []
        for evs in threads.values():
            evs.sort(key=lambda e: (_start(e), -_end(e)))
            stack = []          # (end, path, node, table)
            for e in evs:
                while stack and stack[-1][0] <= _start(e):
                    stack.pop()
                path, node, table = stack[-1][1:] if stack else ((), None,
                                                                 None)
                seq = getattr(e, "sequence_nr", -1)
                if e.name in SPANS:
                    path = path + (e.name,)
                    spans.append(e)
                elif e.name.startswith(_TABLE):
                    table = int(e.name[len(_TABLE):])
                elif seq >= 0 and getattr(e, "fwd_thread", 0):
                    node = e
                elif seq >= 0:
                    self.forward[(e.thread, seq)] = path
                self.info[id(e)] = (path, node, table)
                stack.append((_end(e), path, node, table))
        spans.sort(key=_start)
        self._spans = spans
        self._starts = [_start(e) for e in spans]
        self._reach = list(itertools.accumulate(
            (_end(e) for e in spans), max))

    def path(self, e) -> tuple:
        return self.info[id(e)][0]

    def table(self, e):
        return self.info[id(e)][2]

    def open_at(self, t: float) -> tuple:
        """The path of the innermost span open at time ``t`` on any
        thread; () where none is."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i < 0 or self._reach[i] < t:
            return ()
        while _end(self._spans[i]) < t:
            i -= 1
        return self.path(self._spans[i])

    def eager_path(self, launch) -> tuple:
        """The span path of what an eager ``launch`` launched (module
        doc): the forward's path with ``.bwd`` under an autograd node,
        else the spans around it on its thread, else those open then on
        another (the caller waiting in ``backward``)."""
        path, node, _ = self.info[id(launch)]
        if node is not None:
            fwd = self.forward.get((node.fwd_thread, node.sequence_nr))
            if fwd:
                return fwd[:-1] + (fwd[-1] + ".bwd",)
        return path or self.open_at(_start(launch))


def report(events, calls: int, steps: int) -> dict:
    """Device time by span from the profiler events of ``calls`` traced
    calls of ``steps`` env steps in all (module doc). Returns:

    - ``spans``: span path -> ``self_s`` (device seconds of the operations
      attributed to that path), ``total_s`` (and to the paths under it)
      and ``ops`` (operation name -> self seconds);
    - ``device_s`` (every device operation's seconds), ``busy_s`` (their
      union), ``attributed_s`` (under some span), ``coverage``
      (attributed / device), ``outside_s`` (launched where no span was
      open), ``unattributed_s`` (no launch found, or a replay without a
      matching table);
    - ``replays`` and ``mismatched_replays`` (a replay whose operations'
      count or names differ from its table's, or that has no table: left
      unattributed, never guessed);
    - ``idle_s``: the device's idle gaps between its operations, by the
      innermost span open at each gap's middle, or ``OUTSIDE``;
    - ``calls`` and ``steps``, to divide by.
    """
    dev, host = _split(events)
    ctx = _Host(host)
    self_s: dict = {}
    lost = outside = 0.0
    replays: dict = {}
    dur = lambda e: (_end(e) - _start(e)) * 1e-6

    def add(path, e):
        nonlocal outside
        if not path:
            outside += dur(e)
            return
        ops = self_s.setdefault(path, {})
        ops[e.name] = ops.get(e.name, 0.0) + dur(e)

    for e in dev:
        launch = ctx.launches.get(e.id)
        if launch is None:
            lost += dur(e)
        elif launch.name == "cudaGraphLaunch":
            replays.setdefault(id(launch), (launch, []))[1].append(e)
        else:
            add(ctx.eager_path(launch), e)
    mismatched = 0
    for launch, ops in replays.values():
        ops.sort(key=_start)
        table = _tables.get(ctx.table(launch))
        if table is None or len(table) != len(ops) or any(
                name is not None and _kind(name) != _kind(e.name)
                for (name, _), e in zip(table, ops)):
            mismatched += 1
            lost += sum(map(dur, ops))
            continue
        around = ctx.path(launch)
        for (_, path), e in zip(table, ops):
            add(around + path, e)
    spans: dict = {}
    for path, ops in self_s.items():
        s = sum(ops.values())
        for k in range(1, len(path) + 1):
            row = spans.setdefault("/".join(path[:k]), {
                "self_s": 0.0, "total_s": 0.0, "ops": {}})
            row["total_s"] += s
        row["self_s"] += s
        row["ops"] = ops
    device_s = sum(map(dur, dev))
    busy, merged = 0.0, []
    for s, t in sorted((_start(e), _end(e)) for e in dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    idle: dict = {}
    for (_, t0), (t1, _) in zip(merged, merged[1:]):
        path = ctx.open_at(0.5 * (t0 + t1))
        key = path[-1] if path else OUTSIDE
        idle[key] = idle.get(key, 0.0) + (t1 - t0) * 1e-6
    attributed = device_s - lost - outside
    return {"calls": calls, "steps": steps, "spans": spans,
            "device_s": device_s,
            "busy_s": sum(t - s for s, t in merged) * 1e-6,
            "attributed_s": attributed,
            "coverage": attributed / device_s if device_s else None,
            "outside_s": outside, "unattributed_s": lost,
            "replays": len(replays), "mismatched_replays": mismatched,
            "idle_s": idle}


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
