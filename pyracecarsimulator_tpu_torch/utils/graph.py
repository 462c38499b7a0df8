"""Capture a function of tensors in a CUDA graph and replay it.

The port's counterpart of ``jax.jit``: the JAX package compiles the step,
the rollout and the train step into one program each, and the device runs
the program; eager PyTorch issues the same work kernel by kernel from
Python (about 200 launches a step), and the card waits for the host most
of the time. ``GraphedFunction`` records the kernels one call of a
function launches into a ``torch.cuda.CUDAGraph`` and replays them with
one launch from the host. Values do not change: a replay runs the same
kernels in the same order on the same inputs as the eager call, which
stays the plain version every graphed path is held against bit for bit.

What a capture owns:

- static input buffers, one per tensor argument; a call copies its
  arguments into them and replays. ``torch.Generator`` arguments are
  registered with the graph, so that every replay draws fresh numbers,
  the same ones the eager call would draw from the generator's state;
- the graph and its private memory pool (``backend.pool`` to share one);
- static outputs, cloned on the way out: a caller may keep a result
  across calls, as it may keep a JAX array.

A function is captured again when the structure, a shape, a dtype or the
device of its arguments changes, when it is handed another generator, and
when an object named by ``watch()`` is replaced (identity, not value): the
graph holds the addresses of the tensors the function closed over, so the
map a step reads through ``step.map_cell`` is watched, and a swapped map
is never read stale. One capture is kept; the earlier one and its pool are
released first.

Before capturing, the function runs ``WARMUP_CALLS`` times on a side stream, as
PyTorch's documentation prescribes: the first call builds and loads the
``nvcc`` libraries and fills the caches of device constants
(``ops/common.py``), neither of which may happen inside a capture. What
the warm-up calls change besides their outputs is put back after the
capture: generator states by this class, anything else (parameters, an
optimizer's state) by the caller's ``snapshot``.

The launch counters of the kernels' wrappers (every wrapper registered in
``ops/_kernels.py``: the sweeps' and the march's) count in Python,
where a replay passes no wrapper. The class takes the difference of
``sweeps.launch_counts()`` across the capture pass, takes it back (no
kernel ran while capturing) and adds it at every replay, so the counters
go on saying what the device ran. (The EDF march's trip counter lives on
the device and counts replays by itself.)

A graph is captured on a CUDA device or the call raises: nothing runs
eagerly in silence where a graph was asked for. A function that reads the
host (``.item()``, ``bool(tensor)``, ``.cpu()``, a tensor built from host
data) cannot be captured; the error says so and names ``graph=False``.
It is caught in the last warm-up call, which runs with PyTorch's
synchronisation check set to raise, before a capture is begun; what that
check misses fails in the capture.

Python's collector is switched off while a stream captures. A dead
cycle (the traceback of a failed capture, say) may own an earlier graph,
and the collector runs at any allocation: were it to run during a
capture, the graph's destructor would free its pool there, which CUDA
forbids and answers by invalidating the capture
(``cudaErrorStreamCaptureInvalidated`` in an unrelated function, seen on
the card). Collecting before every capture instead, as ``torch.cuda.graph``
once did, costs tenths of a second a capture in a large process
(``PERF.md``).

With tracing on (``utils/profiling.py``) each capture also gets a label
table from one more eager call on the warm-up's terms, so that a trace of
its replays can be split by span; with tracing off there is none, and
capture and replay are exactly as described above.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import warnings
from typing import Callable, Optional

import torch

from ..ops import sweeps
from . import profiling
from .profiling import span

_LEAF = "*"
WARMUP_CALLS = 2        # eager calls on a side stream before a capture


def require_capturable(step):
    """Raise unless ``step`` says it can be captured in a CUDA graph
    (``step.capturable``, set by ``simulator.make_step_fn``); the error
    carries the step's own reason (``step.host_read``)."""
    if not getattr(step, "capturable", False):
        why = getattr(step, "host_read", None) or \
            "it is not marked capturable (step.capturable)"
        raise RuntimeError(
            "graph=True: this step cannot be captured in a CUDA graph: "
            f"{why}. Pass graph=False")


def _flatten(obj, leaves: list):
    """Append the tensors and generators of ``obj`` to ``leaves`` and
    return its structure, hashable and comparable: tuples, lists, dicts
    and dataclasses (``CarState``) nest; None, numbers and strings are
    part of the structure."""
    if torch.is_tensor(obj) or isinstance(obj, torch.Generator):
        leaves.append(obj)
        return _LEAF
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return ("const", obj)
    if isinstance(obj, dict):
        return ("dict", tuple(obj),
                tuple(_flatten(v, leaves) for v in obj.values()))
    if isinstance(obj, (tuple, list)):
        return ("seq", type(obj), tuple(_flatten(v, leaves) for v in obj))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        names = tuple(f.name for f in dataclasses.fields(obj))
        return ("dataclass", type(obj), names,
                tuple(_flatten(getattr(obj, n), leaves) for n in names))
    raise TypeError(
        f"a graphed function takes and returns tensors, generators, "
        f"numbers and containers of them, not {type(obj).__name__}")


def _copy_in(statics: list, leaves: list):
    """A call's tensor arguments into the capture's static inputs."""
    for s, v in zip(statics, leaves):
        if torch.is_tensor(v):
            s.copy_(v)


def _unflatten(spec, leaves):
    """The inverse of ``_flatten``; ``leaves`` is an iterator."""
    if spec == _LEAF:
        return next(leaves)
    kind = spec[0]
    if kind == "const":
        return spec[1]
    if kind == "dict":
        return {k: _unflatten(s, leaves) for k, s in zip(spec[1], spec[2])}
    if kind == "seq":
        values = [_unflatten(s, leaves) for s in spec[2]]
        cls = spec[1]
        return cls(*values) if hasattr(cls, "_fields") else cls(values)
    return spec[1](**{n: _unflatten(s, leaves)
                      for n, s in zip(spec[2], spec[3])})


class CudaGraphBackend:
    """Warm-up and capture on the card. ``pool``: a memory pool to share
    with other graphs (``torch.cuda.graph_pool_handle()``); safe only
    where no graph keeps live data in it between replays."""

    def __init__(self, pool=None):
        self.pool = pool

    def check(self, device: torch.device):
        if device.type != "cuda":
            raise RuntimeError(
                f"a CUDA graph is captured on the card, and these tensors "
                f"are on {device}: run on a CUDA device or pass graph=False")

    def warm_up(self, run: Callable, device, n: int):
        """``n`` eager calls of ``run()`` on a side stream. The last of
        several runs with PyTorch's synchronisation check set to raise
        (``torch.cuda.set_sync_debug_mode``): a function that reads the
        host, or copies from it, fails here and not inside the capture."""
        with torch.cuda.device(device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            mode = torch.cuda.get_sync_debug_mode()
            try:
                with torch.cuda.stream(side):
                    for i in range(n):
                        if n > 1 and i == n - 1:
                            with warnings.catch_warnings():
                                # "a prototype feature": what it misses
                                # still fails in the capture
                                warnings.simplefilter("ignore")
                                torch.cuda.set_sync_debug_mode("error")
                        run()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
                torch.cuda.current_stream().wait_stream(side)

    def capture(self, run: Callable, device, generators):
        """Capture one call of ``run()``; returns ``(outputs, replay)``:
        the static output tensors and the function that replays."""
        collecting = gc.isenabled()
        gc.disable()        # no earlier graph dies during this capture
        try:
            with torch.cuda.device(device):
                graph = torch.cuda.CUDAGraph()
                for g in generators:
                    graph.register_generator_state(g)
                with torch.cuda.graph(graph, pool=self.pool):
                    outs = run()
        finally:
            if collecting:
                gc.enable()
        return outs, graph.replay


@dataclasses.dataclass
class _Capture:
    key: tuple              # structure, tensor signatures
    held: list              # generators and watched objects, by identity
    statics: list           # input leaves: static tensors, generators
    outs: list              # static output tensors
    out_spec: object
    replay: Callable
    launches: dict          # wrapper name -> kernel launches of one replay
    run: Callable           # one eager call on the static inputs
    generators: list
    device: torch.device
    table: Optional[int] = None     # its label table (utils/profiling.py)


class GraphedFunction:
    """``fn`` replayed as a CUDA graph (module doc).

    ``fn(*args)``: arguments and results are tensors, ``torch.Generator``s,
    numbers and tuples, lists, dicts or dataclasses of them.
    ``watch()``: the objects ``fn`` reads besides its arguments and that a
    caller may replace (the map of a step); a change of identity captures
    again. ``grad=False`` captures and replays without autograd and
    refuses arguments that require grad; ``grad=True`` is for a function
    that runs its own backward (the train step). ``snapshot()``: called
    before the warm-up (and a labelling call), returns a function that
    puts back what those calls changed, called after them, or None where
    nothing need go back. ``device``: where to capture
    when no argument is a tensor. ``backend``: who warms up and captures
    (``CudaGraphBackend``; a test hands in a stand-in). ``captures`` and
    ``replays`` count.
    """

    def __init__(self, fn: Callable, watch: Optional[Callable] = None,
                 grad: bool = False, snapshot: Optional[Callable] = None,
                 device=None, backend=None, name: Optional[str] = None):
        self.fn = fn
        self.watch = watch or (lambda: ())
        self.grad = grad
        self.snapshot = snapshot
        self.device = None if device is None else torch.device(device)
        self.backend = backend or CudaGraphBackend()
        self.name = name or getattr(fn, "__name__", "function")
        self.captures = 0
        self.replays = 0
        self._cap: Optional[_Capture] = None
        profiling.register(self)

    def release(self):
        """Drop the capture and its memory pool."""
        self._cap = None

    def prepare(self, *args) -> bool:
        """Capture for these arguments if no capture fits them, without
        replaying. Returns whether it captured."""
        before = self.captures
        self._ready(args)
        return self.captures != before

    def label(self):
        """Give the current capture its label table where tracing is on,
        it has none and no profiler is running (``utils/profiling.py``):
        one eager call on the warm-up's terms, after which generator
        states and the caller's ``snapshot`` are put back."""
        cap = self._cap
        if cap is None or not profiling.wants_table(cap.table):
            return
        with self._put_back(cap.generators):
            cap.table = profiling.label(
                lambda: self.backend.warm_up(cap.run, cap.device, 1), cap)

    @contextlib.contextmanager
    def _put_back(self, generators):
        """The capture's grad mode for eager calls of ``fn``; on leaving,
        also after a failure, what they changed goes back: generator
        states by this class, anything else by the caller's
        ``snapshot``."""
        restore = self.snapshot() if self.snapshot else None
        states = [(g, g.get_state()) for g in generators]
        try:
            with torch.enable_grad() if self.grad else torch.no_grad():
                yield
        finally:
            for g, state in states:
                g.set_state(state)
            if restore is not None:
                restore()

    def __call__(self, *args):
        cap, leaves = self._ready(args)
        with torch.no_grad():
            if profiling.enabled():
                with span("graph.copy_in"):
                    _copy_in(cap.statics, leaves)
                with profiling.replay_span(cap.table):
                    cap.replay()
                with span("graph.copy_out"):
                    outs = [o.clone() for o in cap.outs]
            else:
                _copy_in(cap.statics, leaves)
                cap.replay()
                outs = [o.clone() for o in cap.outs]
            sweeps.add_launches(cap.launches)
            self.replays += 1
            return _unflatten(cap.out_spec, iter(outs))

    def _ready(self, args):
        """(the capture that fits ``args``, their leaves)."""
        leaves: list = []
        spec = _flatten(args, leaves)
        tensors = [v for v in leaves if torch.is_tensor(v)]
        if not self.grad and torch.is_grad_enabled() and any(
                t.requires_grad for t in tensors):
            raise RuntimeError(
                f"the graphed {self.name} carries no autograd graph, and an "
                "argument requires grad: pass graph=False to differentiate "
                "through it")
        key = (spec, tuple((tuple(t.shape), t.dtype, t.device)
                           for t in tensors))
        held = [v for v in leaves if not torch.is_tensor(v)]
        held += list(self.watch())
        cap = self._cap
        if (cap is None or cap.key != key or len(cap.held) != len(held)
                or any(a is not b for a, b in zip(cap.held, held))):
            cap = self._capture(key, spec, leaves, held)
        return cap, leaves

    def _capture(self, key, spec, leaves, held) -> _Capture:
        self._cap = None        # the earlier graph's pool goes first
        devices = {v.device for v in leaves if torch.is_tensor(v)}
        if self.device is not None:
            devices.add(self.device)
        if len(devices) != 1:
            raise RuntimeError(
                f"the graphed {self.name} needs its tensors on one device, "
                f"got {sorted(map(str, devices)) or 'no tensor, no device'}")
        device = devices.pop()
        self.backend.check(device)
        generators = [v for v in leaves if isinstance(v, torch.Generator)]
        with torch.no_grad():
            statics = [v.detach().clone() if torch.is_tensor(v) else v
                       for v in leaves]
        out = {}

        def run():
            outs: list = []
            out["spec"] = _flatten(
                self.fn(*_unflatten(spec, iter(statics))), outs)
            if not all(torch.is_tensor(o) for o in outs):
                raise TypeError(f"the graphed {self.name} returned a "
                                "generator")
            return outs

        try:
            with self._put_back(generators):
                self.backend.warm_up(run, device, WARMUP_CALLS)
                before = sweeps.launch_counts()
                outs, replay = self.backend.capture(run, device, generators)
        except Exception as e:
            first = e       # ending a broken capture raises over the cause
            while first.__context__ is not None:
                first = first.__context__
            raise RuntimeError(
                f"capturing {self.name} in a CUDA graph failed: {first}\nA "
                "function that reads the host (.item(), bool(tensor), "
                ".cpu(), a tensor built from host data) or whose optimizer "
                "keeps its step count on the host cannot be captured: pass "
                "graph=False to run it eagerly") from e
        after = sweeps.launch_counts()
        launches = {k: n - before[k] for k, n in after.items()
                    if n != before[k]}
        # the capture pass went through the wrappers, but no kernel ran
        sweeps.add_launches({k: -n for k, n in launches.items()})
        self.captures += 1
        self._cap = _Capture(key=key, held=held, statics=statics, outs=outs,
                             out_spec=out["spec"], replay=replay,
                             launches=launches, run=run,
                             generators=generators, device=device)
        self.label()
        return self._cap
