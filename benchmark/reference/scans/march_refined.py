"""The upstream distance-transform march (at most ``max_march_iters``
trips, stopping within ``ray_tracing_epsilon``), the hit refined onto the
bilinear level set of the distance field: the ``edf_implicit`` backend's
semantics."""

from __future__ import annotations

import torch

from .. import geometry
from ..maps import padded


def prepare(world):
    occ = torch.as_tensor(padded(world.grid.occupied), device=world.device)
    world.edf = geometry.distance_field(occ, world.grid.resolution,
                                        world.dtype)


def hit(world, x0, y0, c, s, max_range):
    g, p = world.grid, world.scan_p
    return geometry.march_hit(world.edf, g.shape, g.resolution, g.origin,
                              x0, y0, c, s, max_range,
                              float(p["ray_tracing_epsilon"]),
                              int(p["max_march_iters"]))
