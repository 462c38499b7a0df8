"""Time-to-collision (TTC) check on tensors.

Counterpart of ``pyracecarsimulator_tpu/models/ttc.py``: per-beam tables
built once per step function, and a branchless any-beam reduction.
"""

from __future__ import annotations

import torch

from ..config import CarParams
from ..ops.common import beam_angles


def ttc_tables(num_beams: int, fov: float, p: CarParams, device=None):
    """Per-beam cos(beam offset) and scanner->footprint-edge distances.

    The scanner sits ``scan_distance_to_base_link`` ahead of the rear
    axle; the car rectangle (length x width) is centered on the wheelbase
    midpoint. ``car_distances[i]`` is the exit distance of beam i from
    inside that rectangle (slab method). The tables land on ``device``
    (``None``: the card, ``config.resolve_device``).
    """
    offs = beam_angles(num_beams, fov, device)
    rear_overhang = (p.length - p.wheelbase) / 2.0
    x_min = -(p.scan_distance_to_base_link + rear_overhang)
    x_max = p.wheelbase + rear_overhang - p.scan_distance_to_base_link
    y_min, y_max = -p.width / 2.0, p.width / 2.0
    c = torch.cos(offs)
    s = torch.sin(offs)
    big = torch.full_like(c, 1e9)
    one = torch.ones_like(c)
    cw = torch.where(c == 0, one, c)
    sw = torch.where(s == 0, one, s)
    # full_like(...) / t is a true division (``scalar / t`` would be a
    # reciprocal then a multiply)
    tx = torch.where(c != 0, torch.maximum(torch.full_like(c, x_min) / cw,
                                           torch.full_like(c, x_max) / cw),
                     big)
    ty = torch.where(s != 0, torch.maximum(torch.full_like(s, y_min) / sw,
                                           torch.full_like(s, y_max) / sw),
                     big)
    return c, torch.minimum(tx, ty)


def check_ttc(ranges, velocity, cosines, car_distances, ttc_threshold):
    """Any-beam TTC collision predicate.

    ranges (..., B) [m], velocity (...,) [m/s], cosines and car_distances
    (B,) tables, ttc_threshold [s]. Returns (...,) bool — True where any
    beam's TTC is in [0, threshold).
    """
    proj = velocity[..., None] * cosines            # closing speed per beam
    safe = torch.where(proj > 0, proj, torch.ones_like(proj))
    ttc = (ranges - car_distances) / safe
    hit = (proj > 0) & (ttc >= 0.0) & (ttc < ttc_threshold)
    return torch.any(hit, dim=-1)
