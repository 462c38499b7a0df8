"""Training through the simulator: BPTT rollout-loss train steps.

Counterpart of ``pyracecarsimulator_tpu/parallel/train.py``.
``make_bptt_train_fn`` builds one train step that rolls the step function
forward ``num_steps`` steps under a parameterized policy, back-propagates
the mean rollout loss through every step (dynamics, the raycast through
its analytic O(rays) VJP, the TTC latch) and applies an optimizer update.

PyTorch idiom: parameters are a dict of tensors, the optimizer is a
``torch.optim.Optimizer`` built over them, and ``train`` updates the
parameter tensors in place (JAX returns new arrays); it returns the same
dict. The JAX module's ``has_compiler_opts`` guard is left out: it rejects
a JAX-only kind of sharded step.

The JAX train step is one compiled program. Here the whole step
(``zero_grad`` with the gradients kept allocated, the T-step forward,
``backward`` and the optimizer's update) is captured in one CUDA graph
(``utils/graph.py``) over a static copy of ``state0`` where the state lies
on a CUDA device and the step can be captured with its backward, and is a
Python loop under autograd everywhere else. A step can be captured
(``step.capturable``) on every backend of ``simulator.make_step_fn``, and
so can its backward: the EDF marches run their kernels under autograd too
(``ops/raymarch_xla.edf_march`` forward, ``edf_march_grad`` backward; the
implicit march's VJP is elementwise). Losses and parameters after N
graphed steps equal the eager ones bit for bit. The T steps are unrolled
into the graph (one backward spans them all), so the policy's and the
loss's Python branches on ``t`` are resolved exactly. What Python computes
from the optimizer's hyper-parameters is frozen at capture: a learning
rate changed afterwards needs a new train function. An optimizer that
counts its steps on the host (``torch.optim.Adam`` and its kin by default)
would replay its first update for ever: built with ``capturable=True`` it
is captured; without, ``graph=None`` takes the eager step and
``graph=True`` raises. SGD captures as it is, but for momentum with a
dampening: its first update sets the buffer to the whole gradient and the
later ones add the damped gradient, two rules where a graph replays one
(``_why_not_graphed``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..state import CarState, FIELDS
from ..utils.graph import GraphedFunction, require_capturable
from ..utils.profiling import span


def _optimizer_snapshot(params: list, optimizer):
    """Keep the parameters' and the optimizer state's values; returns the
    function that puts them back in place. State tensors that exist only
    afterwards (an optimizer creates its state at its first step, and
    ``torch.optim`` starts every such tensor at zero) are zeroed. Where
    an update from a zeroed state is not the optimizer's first update,
    ``_why_not_graphed`` keeps the optimizer away from the graph."""
    state_tensors = lambda: [v for st in optimizer.state.values()
                             for v in st.values() if torch.is_tensor(v)]
    with torch.no_grad():
        kept = [(t, t.clone()) for t in params + state_tensors()]

    def restore():
        with torch.no_grad():
            known = {id(t) for t, _ in kept}
            for t in state_tensors():
                if id(t) not in known:
                    t.zero_()
            for t, value in kept:
                t.copy_(value)
    return restore


def _why_not_graphed(optimizer) -> Optional[str]:
    """Why one captured update would not equal this optimizer's eager
    updates, or None where it does."""
    kind = type(optimizer).__name__
    for group in optimizer.param_groups:
        if not group.get("capturable", True):
            return (f"{kind} counts its steps on the host, so a CUDA graph "
                    "would replay its first update for ever: build it with "
                    "capturable=True, or pass graph=False to "
                    "make_bptt_train_fn")
        if (isinstance(optimizer, torch.optim.SGD) and group["momentum"]
                and group["dampening"]):
            return (f"{kind} with momentum and dampening sets its buffer to "
                    "the whole gradient at the first update and adds the "
                    "damped gradient afterwards; a CUDA graph replays one "
                    "rule: pass graph=False to make_bptt_train_fn")
    return None


def make_bptt_train_fn(step_fn: Callable, policy: Callable,
                       loss_fn: Callable, num_steps: int, num_beams: int,
                       optimizer: Optional[Callable] = None,
                       graph: Optional[bool] = None):
    """Build a BPTT train step.

    Args:
      step_fn: ``step(state, action, generator=None) -> StepOutput`` (from
        ``simulator.make_step_fn``).
      policy: ``policy(params, state, ranges, t) -> (v_des, steer_des)``.
        At t=0 ranges are zeros (no scan yet).
      loss_fn: ``loss_fn(out: StepOutput, t) -> scalar`` per-step loss; the
        rollout loss is the mean over steps.
      num_steps: BPTT horizon T (memory: the raycast VJP keeps O(rays)
        residuals per step, ~5 * A * B floats * T).
      num_beams: scan width (the shape of the t=0 ranges).
      optimizer: a callable from the parameter list to a
        ``torch.optim.Optimizer``; None = SGD with lr 1e-2 (the JAX
        default ``optax.sgd(1e-2)``).
      graph: ``None`` replays the whole train step from one CUDA graph
        where ``state0`` lies on a CUDA device, ``step_fn.capturable`` is
        true and the optimizer's update can be captured, and runs it
        eagerly otherwise; ``True`` raises where it cannot capture;
        ``False`` is the eager step (module doc).

    Returns ``(train, init_opt_state)``: ``init_opt_state(params)`` makes
    the parameters leaves that require grad and builds the optimizer over
    them in sorted-key order; ``train(params, opt_state, state0,
    generator=None) -> (params, opt_state, loss, final_state)`` takes one
    step (``generator`` drives the scan noise). The loss and final state
    come back detached; each parameter's ``.grad`` keeps the gradient.
    """
    if optimizer is None:
        optimizer = lambda ps: torch.optim.SGD(ps, lr=1e-2)
    inner = getattr(step_fn, "eager", step_fn)   # a graphed step's own step

    def init_opt_state(params):
        return optimizer([params[k].requires_grad_(True)
                          for k in sorted(params)])

    def whole_step(step, params, opt_state, state0, generator,
                   keep_grads: bool):
        with span("train.optimizer"):
            opt_state.zero_grad(set_to_none=not keep_grads)
        state = state0
        ranges = torch.zeros(state0.batch_shape + (num_beams,),
                             dtype=torch.float32, device=state0.device)
        losses = []
        for t in range(num_steps):
            with span("train.policy"):
                action = policy(params, state, ranges, t)
            out = step(state, action, generator)
            with span("train.loss"):
                losses.append(loss_fn(out, t))
            state, ranges = out.state, out.ranges
        with span("train.loss"):
            loss = torch.stack(losses).mean()
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
            opt_state.step()
        final = CarState(**{f: getattr(state, f).detach() for f in FIELDS})
        return loss.detach(), final

    # what the graph closed over: replaced parameters or another optimizer
    # capture again
    cell = {}
    graphed = GraphedFunction(
        lambda state0, generator: whole_step(
            inner, cell["params"], cell["opt"], state0, generator, True),
        watch=lambda: (cell["opt"], getattr(inner, "map_cell", {}).get("map"),
                       *(cell["params"][k] for k in sorted(cell["params"]))),
        grad=True, name="train step",
        snapshot=lambda: _optimizer_snapshot(
            [cell["params"][k] for k in sorted(cell["params"])],
            cell["opt"]))

    def train(params, opt_state, state0: CarState, generator=None):
        use = graph
        why_not = _why_not_graphed(opt_state) if use is not False else None
        if use is None:
            use = (state0.device.type == "cuda" and why_not is None
                   and getattr(inner, "capturable", False))
        if not use:
            loss, final = whole_step(step_fn, params, opt_state, state0,
                                     generator, False)
            return params, opt_state, loss, final
        require_capturable(inner)
        if why_not is not None:
            raise RuntimeError(why_not)
        cell.update(params=params, opt=opt_state)
        loss, final = graphed(state0, generator)
        return params, opt_state, loss, final

    train.graphed = graphed         # .captures, .replays, .release()
    return train, init_opt_state
