"""Differentiable distance transform (occupancy -> EDF) on the device.

Counterpart of ``pyracecarsimulator_tpu/ops/soft_edt.py``. The exact EDT
(``maps/edt.py``) runs on the host and has no gradient; this chamfer
wavefront closes the chain occupancy -> EDF -> ranges so that autograd
reaches the occupancy grid. Start from ``d = (1 - occ) * cap`` (or the
log init), then ``iters`` times

    d <- min(d, min over 8 neighbours of (d_neighbour + step))

with steps 1 and sqrt 2 (at most ~8% over the euclidean distance).
``temperature > 0`` replaces the min by a softmin over the 9 candidates.

Plain PyTorch (a stencil of shifts and minima, XLA code in the JAX
package). The hard-min chain splits the gradient evenly between exactly
equal candidates, as JAX's ``minimum`` does, and so does the final clip
(``_clip``); binary maps are full of such ties
(``tests/test_torch_soft_edt.py`` holds the gradient to ``jax.grad``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_SQRT2 = 1.4142135623730951


def _neighbor_candidates(d):
    """The 8 chamfer candidates (d_neighbour + step). Borders replicate
    the edge values, so border distances come from in-map obstacles
    only."""
    p = F.pad(d[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    return [
        p[:-2, 1:-1] + 1.0, p[2:, 1:-1] + 1.0,
        p[1:-1, :-2] + 1.0, p[1:-1, 2:] + 1.0,
        p[:-2, :-2] + _SQRT2, p[:-2, 2:] + _SQRT2,
        p[2:, :-2] + _SQRT2, p[2:, 2:] + _SQRT2,
    ]


def _clip(x, lo: float, hi: float):
    """``jnp.clip``: min(max(x, lo), hi), whose gradient at a bound is
    split evenly between ``x`` and the bound, as JAX's ``minimum`` and
    ``maximum`` split it (``torch.clamp`` would pass all of it). Cells at
    the bounds are common: occupied cells sit at 0, far free cells at the
    cap, binary occupancy at 1."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)),
                         x.new_tensor(hi))


def soft_edt(occupancy, resolution=1.0, iters: int = 64,
             temperature: float = 0.0, init: str = "linear",
             init_lambda: float = 3.0):
    """Differentiable chamfer distance field in meters.

    ``occupancy`` (H, W) float in [0, 1], 1 = occupied; ``iters``
    propagation sweeps, the distance radius in cells (farther distances
    saturate at ``iters + 1`` cells); ``temperature`` 0 = hard min, > 0 =
    softmin in cells; ``init`` "linear" ((1 - occ) * cap, exact for
    binary maps) or "log" (-init_lambda * ln(occ): partial beliefs
    already shorten nearby distances, the occupancy-reconstruction mode).
    Returns (H, W) float32.
    """
    cap = float(iters) + 1.0
    occupancy = torch.as_tensor(occupancy, dtype=torch.float32)
    if init == "log":
        floor = float(np.exp(-cap / init_lambda))
        d = -init_lambda * torch.log(_clip(occupancy, floor, 1.0))
    else:
        # the saturation cap, not 1e38: keeps d(occ) gradients at O(cap)
        d = (1.0 - occupancy) * cap
    for _ in range(iters):
        if temperature > 0.0:
            stack = torch.stack([d] + _neighbor_candidates(d))
            d = -temperature * torch.logsumexp(-stack * (1.0 / temperature),
                                               dim=0)
        else:
            out = d
            for c in _neighbor_candidates(d):
                out = torch.minimum(out, c)
            d = out
    return _clip(d, 0.0, cap) * resolution


def scan_from_occupancy(occupancy, resolution, origin_xy, poses,
                        num_beams=1080, fov=4.712388980384690,
                        max_range=10.0, eps=1e-4, max_iters=128,
                        edt_iters: int = 64, bounds_hw=None):
    """Differentiable occupancy -> lidar ranges: ``soft_edt`` composed
    with the bilinear DT march; autograd of any loss of the output reaches
    the occupancy grid."""
    from .raymarch_xla import scan_poses
    edf = soft_edt(occupancy, resolution, iters=edt_iters)
    return scan_poses(edf, resolution, origin_xy, poses,
                      num_beams=num_beams, fov=fov, max_range=max_range,
                      eps=eps, max_iters=max_iters, interp="bilinear",
                      bounds_hw=bounds_hw)
