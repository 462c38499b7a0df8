"""Sanity guards around a step function.

Counterpart of ``pyracecarsimulator_tpu/utils/debug.py``. JAX needs
``checkify`` to carry an error out of a compiled program; PyTorch runs
eagerly, so ``checked`` simply reads the checks' results and raises. That
read is one device-to-host copy per step: a guard for debugging, not for
the timed path.

Usage:
    safe_step = checked(step_fn)
    out = safe_step(state, action, generator)     # raises on a failed check
"""

from __future__ import annotations

from typing import Callable

import torch

_CHECKS = ("non-finite x", "non-finite y", "non-finite theta",
           "non-finite velocity", "non-finite scan ranges",
           "negative scan range", "x out of bounds", "y out of bounds")


def checked(step_fn: Callable, max_abs_pos: float = 1e4) -> Callable:
    """Wrap a step function with assertions on its outputs: finite state
    fields, finite non-negative ranges, positions within ``max_abs_pos``.
    Returns ``fn(state, action, *rest) -> StepOutput`` (the wrapped
    function's own arguments), which raises ``FloatingPointError`` naming
    the failed checks. One host read per step."""

    def run(state, action, *rest):
        out = step_fn(state, action, *rest)
        s = out.state
        bad = torch.stack([
            ~torch.isfinite(s.x).all(), ~torch.isfinite(s.y).all(),
            ~torch.isfinite(s.theta).all(),
            ~torch.isfinite(s.velocity).all(),
            ~torch.isfinite(out.ranges).all(), (out.ranges < 0.0).any(),
            ~(s.x.abs() < max_abs_pos).all(),
            ~(s.y.abs() < max_abs_pos).all()]).tolist()
        if any(bad):
            raise FloatingPointError(
                "step output failed: "
                + ", ".join(c for c, b in zip(_CHECKS, bad) if b))
        return out

    return run
