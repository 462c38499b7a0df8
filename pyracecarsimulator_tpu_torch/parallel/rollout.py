"""Closed-loop rollouts, batched over agents: one program on the card.

Counterpart of ``pyracecarsimulator_tpu/parallel/rollout.py``. The JAX
package compiles the T-step loop into one ``lax.scan`` program. Here the
loop is replayed from CUDA graphs (``utils/graph.py``) where the state
lies on a CUDA device and the step can be captured (``step.capturable``:
every backend of ``simulator.make_step_fn``, the EDF marches included),
and runs eagerly, kernel by kernel from Python, everywhere else: on the
CPU, for the sharded steps of ``parallel/mesh.py``, with ``graph=False``.
Values are the eager loop's bit for bit, trajectories stacked along a
leading time axis, as in JAX.

The graphed loop is one step (policy, step, carry and trajectory writes)
captured once and replayed T times, not T steps unrolled into one graph:

- the capture costs one step whatever T is, so a single ``rollout`` call
  of 500 steps pays for 1 step's capture and not for 500 (an unrolled
  capture costs about as much as running the loop eagerly);
- the graph's memory is one step's working set. The state and the last
  ranges are carried in static buffers that the captured step overwrites
  in place; each step writes its pose, collision flag and (with
  ``keep_scans``) scan into row ``i`` of static block buffers, ``i`` a
  step index that lives on the device and is incremented inside the
  graph. The block buffers hold at most ``_BLOCK_BYTES`` (256 MiB: 15
  steps of 4096 x 1080 scans, every step of a rollout without
  ``keep_scans``); after each block one copy moves them into the
  trajectory, which is allocated per call as the eager loop allocates it.

The host issues T graph launches a rollout, plus a few small launches a
block.

A policy's Python code runs at capture, not at replay. Step 0 has a graph
of its own, captured with the int ``t = 0`` (no scan yet: the ranges are
zeros). Every later step replays one graph, and there the policy's ``t``
is the step index as a one-element int64 tensor on the state's device,
counted up inside the graph, as ``lax.scan`` hands the JAX policy a
traced index: ``steer_seq[t]`` and arithmetic on ``t`` take each step's
own value, with a leading axis of 1 that broadcasts (the tensor is not
0-dim, because PyTorch reads a 0-dim index on the host). A Python branch
on that tensor (``if t < k``) would read the host: like any
policy that reads the host it fails the capture, and the error names
``graph=False``. Branch on ``torch.is_tensor(t)`` first (as
``make_gap_follower_policy`` does for its ``t == 0``), or use
``torch.where``.

A capture is paid back after some tens of steps (``PERF.md`` has the
measured break-even), so ``make_rollout_fn`` keeps its capture for the
next call, and the one-shot ``rollout`` keeps the last function it built
and replays it when it is handed the same step and policy again.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.common import beam_angles
from ..state import FIELDS, CarState
from ..utils.graph import (CudaGraphBackend, GraphedFunction,
                           require_capturable)
from ..utils.profiling import span

# bytes the graphed loop's trajectory block buffers may hold
_BLOCK_BYTES = 1 << 28
# (arguments, run function) of the last one-shot ``rollout`` call
_LAST_ROLLOUT = None


def _eager_rollout(step_fn, policy, num_steps, num_beams, keep_scans,
                   state0, generator):
    state = state0
    ranges = torch.zeros(state0.batch_shape + (num_beams,),
                         dtype=torch.float32, device=state0.device)
    poses, collisions, scans = [], [], []
    for t in range(num_steps):
        with span("rollout.policy"):
            action = policy(state, ranges, t)
        out = step_fn(state, action, generator)
        state, ranges = out.state, out.ranges
        with span("rollout.carry"):
            poses.append(state.pose)
            collisions.append(out.collision)
            if keep_scans:
                scans.append(ranges)
    with span("rollout.carry"):
        traj = {"pose": torch.stack(poses), "collision": torch.stack(
            collisions)}
        if keep_scans:
            traj["ranges"] = torch.stack(scans)
    return state, traj


class _GraphedRollout:
    """The loop of one batch shape on one device as two CUDA graphs (step
    0, and every later step) over static carry and block buffers (module
    doc). ``backend``: as ``GraphedFunction``'s."""

    def __init__(self, step_fn, policy, num_steps, num_beams, keep_scans,
                 state0: CarState, backend=None):
        dev, shape = state0.device, state0.batch_shape
        if backend is None:
            CudaGraphBackend().check(dev)
            backend = CudaGraphBackend(pool=torch.cuda.graph_pool_handle())
        self.num_steps, self.keep_scans = num_steps, keep_scans
        n_agents = max(1, state0.x.numel())
        per_step = n_agents * (13 + 4 * num_beams * bool(keep_scans))
        self.block = max(1, min(num_steps, _BLOCK_BYTES // per_step))
        with torch.no_grad():
            self.state = CarState(**{
                f: getattr(state0, f).detach().clone() for f in FIELDS})
            self.ranges = torch.zeros(shape + (num_beams,),
                                      dtype=torch.float32, device=dev)
            self.index = torch.zeros(1, dtype=torch.int64, device=dev)
            self.t = torch.zeros(1, dtype=torch.int64, device=dev)
            rows = lambda *tail, dtype: torch.zeros(
                (self.block,) + shape + tail, dtype=dtype, device=dev)
            self.blocks = {"pose": rows(3, dtype=torch.float32),
                           "collision": rows(dtype=torch.bool)}
            if keep_scans:
                self.blocks["ranges"] = rows(num_beams, dtype=torch.float32)
        cell = getattr(step_fn, "map_cell", None)
        watch = (lambda: (cell["map"],)) if cell is not None else None
        self.graphs = [
            GraphedFunction(self._one_step(step_fn, policy, first),
                            watch=watch, snapshot=self._rewind, device=dev,
                            backend=backend, name=name)
            for first, name in (
                (True, "rollout step t = 0"),
                (False, "rollout steps t >= 1 (the policy's t is a "
                        "device tensor there)"))]

    def _one_step(self, step_fn, policy, first: bool):
        """Policy, step, carry and trajectory writes of step 0 (``first``)
        or of any later step, all on the static buffers."""
        def one(generator):
            state, ranges = self.state, self.ranges
            t = 0 if first else self.t
            with span("rollout.policy"):
                action = policy(state, ranges, t)
            out = step_fn(state, action, generator)
            with span("rollout.carry"):
                rows = {"pose": out.state.pose, "collision": out.collision,
                        "ranges": out.ranges}
                # the warm-up calls of a capture count on: wrap, never
                # overrun
                row = torch.remainder(self.index, self.block)
                for name, buf in self.blocks.items():
                    buf.index_copy_(0, row, rows[name][None])
                for f in FIELDS:
                    getattr(state, f).copy_(getattr(out.state, f))
                ranges.copy_(out.ranges)
                self.index.add_(1)
                self.t.add_(1)
        return one

    def _rewind(self):
        """Before the eager calls of a step's function (a capture's
        warm-up; a labelling call of ``utils/profiling.py``, made at a
        capture or at ``profiling.enable()``, which may come after a
        whole rollout): the step index and the block row start at 1 and
        0, so that the policy is handed a step it can be handed at a
        replay. None of them comes between ``run``'s setting of the carry
        and its last replay (``run`` captures first), so nothing is put
        back."""
        self.t.fill_(1)
        self.index.zero_()

    def run(self, state0: CarState, generator):
        with torch.no_grad():
            total = self.num_steps
            graphs = self.graphs[:min(total, 2)]
            # capture first: the warm-up steps write the carry
            for g in graphs:
                g.prepare(generator)
            with span("rollout.blocks"):
                for f in FIELDS:
                    getattr(self.state, f).copy_(getattr(state0, f))
                self.ranges.zero_()
                self.t.zero_()
                traj = {k: torch.empty((total,) + tuple(b.shape[1:]),
                                       dtype=b.dtype, device=b.device)
                        for k, b in self.blocks.items()}
            for t0 in range(0, total, self.block):
                n = min(self.block, total - t0)
                with span("rollout.blocks"):
                    self.index.zero_()
                for t in range(t0, t0 + n):
                    graphs[min(t, 1)](generator)
                with span("rollout.blocks"):
                    for k, b in self.blocks.items():
                        traj[k][t0:t0 + n].copy_(b[:n])
            with span("rollout.blocks"):
                final = CarState(**{f: getattr(self.state, f).clone()
                                    for f in FIELDS})
        return final, traj


def make_rollout_fn(step_fn: Callable, policy: Callable, num_steps: int,
                    num_beams: int, keep_scans: bool = False,
                    graph: Optional[bool] = None):
    """Build a reusable rollout: ``run(state0, generator=None) ->
    (final_state, traj)``. ``generator`` (a ``torch.Generator`` on the
    state's device) drives the scan noise; None = noiseless.

    ``graph``: ``None`` replays the loop from CUDA graphs where
    ``state0`` lies on a CUDA device and ``step_fn.capturable`` is true,
    and runs the eager loop otherwise; ``True`` raises where it cannot
    capture; ``False`` is the eager loop. The graphs are forward only:
    with ``None``, a state that requires grad takes the eager loop.
    """
    inner = getattr(step_fn, "eager", step_fn)   # a graphed step's own step
    kept = None         # ((batch shape, device), _GraphedRollout): one

    def run(state0: CarState, generator=None):
        nonlocal kept
        use = graph
        wants_grad = torch.is_grad_enabled() and any(
            getattr(state0, f).requires_grad for f in FIELDS)
        if use is None:
            use = (state0.device.type == "cuda" and not wants_grad
                   and getattr(inner, "capturable", False))
        if not use:
            return _eager_rollout(step_fn, policy, num_steps, num_beams,
                                  keep_scans, state0, generator)
        require_capturable(inner)
        if wants_grad:
            raise RuntimeError(
                "graph=True: the graphed rollout carries no autograd graph, "
                "and the state requires grad: pass graph=False")
        key = (state0.batch_shape, state0.device)
        if kept is None or kept[0] != key:
            kept = None         # one batch shape's buffers at a time
            kept = key, _GraphedRollout(inner, policy, num_steps, num_beams,
                                        keep_scans, state0)
        return kept[1].run(state0, generator)

    return run


def rollout(step_fn: Callable, state0: CarState, policy: Callable,
            num_steps: int, num_beams: int, generator=None,
            keep_scans: bool = False, graph: Optional[bool] = None):
    """Run ``num_steps`` of closed-loop simulation.

    ``policy(state, ranges, t) -> (v_des, steer_des)``; at t=0 ranges are
    all zeros (no scan has happened yet). Returns (final_state, traj),
    traj holding poses (T, ..., 3) and collision (T, ...), plus ranges
    (T, ..., num_beams) if ``keep_scans``. ``graph`` as
    ``make_rollout_fn``'s (module doc).

    The last function built is kept and used again when the next call
    names the same ``step_fn`` and ``policy`` objects and the same sizes:
    only the first of such calls pays for a capture. It keeps that
    capture's buffers (at most ``_BLOCK_BYTES`` and one step's working
    set) until a call with other arguments replaces it.
    """
    global _LAST_ROLLOUT
    key = (step_fn, policy, num_steps, num_beams, keep_scans, graph)
    last = _LAST_ROLLOUT
    if last is None or last[0] != key:  # functions compare by identity
        _LAST_ROLLOUT = last = key, make_rollout_fn(
            step_fn, policy, num_steps, num_beams, keep_scans, graph)
    return last[1](state0, generator)


def make_constant_policy(v_des, steer_des):
    """The same command at every step: each of ``v_des`` and ``steer_des``
    a number, or a tensor or array that broadcasts to the state's batch
    shape (one command per agent), as the JAX policy takes them. A number
    or array is copied to a device once and the copy kept."""
    on_device = {}

    def policy(state, ranges, t):
        dev = state.device
        if dev not in on_device:
            on_device[dev] = tuple(
                torch.as_tensor(c, dtype=torch.float32, device=dev)
                for c in (v_des, steer_des))
        v, s = (c.expand(state.batch_shape) for c in on_device[dev])
        return v, s
    return policy


def make_gap_follower_policy(num_beams: int, fov: float, speed: float = 3.0,
                             steer_gain: float = 0.6):
    """Tiny reactive policy: steer toward the farthest-range beam (the
    first one on ties). Exercises ranges -> control in closed loop."""
    def policy(state, ranges, t):
        dev = ranges.device
        v = torch.full(state.batch_shape, float(speed), device=dev)
        if not torch.is_tensor(t) and t == 0:       # no scan yet
            return v, torch.zeros(state.batch_shape, device=dev)
        best = torch.argmax(ranges, dim=-1)
        return v, steer_gain * beam_angles(num_beams, fov, dev)[best]
    return policy
