"""The exact scan: every range is the first crossing of its beam with the
boundary of the map's occupied cells, within ``max_range``. What every
backend that computes the exact first hit (the segment sweeps, the sector
sweep) has to give."""

from __future__ import annotations

import torch

from .. import geometry


def prepare(world):
    """In float64 a distance field lets the walk skip free space; the
    lower-precision control walks every cell."""
    world.dist = (geometry.distance_field(world.occupied,
                                          world.grid.resolution)
                  if world.dtype == torch.float64 else None)


def hit(world, x0, y0, c, s, max_range):
    g = world.grid
    return geometry.first_hit(world.occupied, g.resolution, g.origin, x0, y0,
                              c, s, max_range, world.dist)
