"""Training through the simulator: BPTT rollout-loss train steps.

Counterpart of ``pyracecarsimulator_tpu/parallel/train.py``.
``make_bptt_train_fn`` builds one train step that rolls the step function
forward ``num_steps`` steps under a parameterized policy, back-propagates
the mean rollout loss through every step (dynamics, the raycast through
its analytic O(rays) VJP, the TTC latch) and applies an optimizer update.

PyTorch idiom: parameters are a dict of tensors, the optimizer is a
``torch.optim.Optimizer`` built over them, and ``train`` updates the
parameter tensors in place (JAX returns new arrays); it returns the same
dict. The T-step rollout is a Python loop under autograd (the JAX package
compiles it into one ``lax.scan``). The JAX module's ``has_compiler_opts``
guard is left out: it rejects a JAX-only kind of sharded step.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..state import CarState, FIELDS


def make_bptt_train_fn(step_fn: Callable, policy: Callable,
                       loss_fn: Callable, num_steps: int, num_beams: int,
                       optimizer: Optional[Callable] = None):
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

    Returns ``(train, init_opt_state)``: ``init_opt_state(params)`` makes
    the parameters leaves that require grad and builds the optimizer over
    them in sorted-key order; ``train(params, opt_state, state0,
    generator=None) -> (params, opt_state, loss, final_state)`` takes one
    step (``generator`` drives the scan noise). The loss and final state
    come back detached; each parameter's ``.grad`` keeps the gradient.
    """
    if optimizer is None:
        optimizer = lambda ps: torch.optim.SGD(ps, lr=1e-2)

    def init_opt_state(params):
        return optimizer([params[k].requires_grad_(True)
                          for k in sorted(params)])

    def train(params, opt_state, state0: CarState, generator=None):
        opt_state.zero_grad()
        state = state0
        ranges = torch.zeros(state0.batch_shape + (num_beams,),
                             dtype=torch.float32, device=state0.device)
        losses = []
        for t in range(num_steps):
            out = step_fn(state, policy(params, state, ranges, t), generator)
            losses.append(loss_fn(out, t))
            state, ranges = out.state, out.ranges
        loss = torch.stack(losses).mean()
        loss.backward()
        opt_state.step()
        final = CarState(**{f: getattr(state, f).detach() for f in FIELDS})
        return params, opt_state, loss.detach(), final

    return train, init_opt_state
