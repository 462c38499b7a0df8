"""What the benchmark feeds both sides: seeded free start poses, a seeded
pool of reset poses, and the reset between calls.

A pose is free when no occupied cell center lies within ``margin`` of its
cell's center (``demo_train``'s 0.5 m), found on the device. Draws come
from one ``torch.Generator`` on the device, seeded with ``--seed``, in a
fixed order: the start poses, then the reset pool, then whatever the mix
draws.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FIELDS = ("x", "y", "theta", "velocity", "steer_angle", "angular_velocity",
          "slip_angle", "st_dyn", "collision")


def free_cells(grid, margin: float, device) -> torch.Tensor:
    """Flat indices of the map's cells with clearance above ``margin``:
    the occupancy dilated by a disk, row offset by row offset, each row of
    the disk a box filter along x (a difference of prefix sums)."""
    occ = torch.as_tensor(grid.occupied, device=device).to(torch.int32)
    h, w = occ.shape
    rad2 = (margin / grid.resolution) ** 2
    rad = int(math.floor(math.sqrt(rad2)))
    pre = F.pad(torch.cumsum(occ, dim=1), (rad + 1, rad))    # (h, w + 2r+1)
    near = torch.zeros((h + 2 * rad, w), dtype=torch.bool, device=device)
    for dy in range(-rad, rad + 1):
        half = int(math.floor(math.sqrt(rad2 - dy * dy)))
        cols = torch.arange(w, device=device) + rad
        box = pre[:, cols + half + 1] - pre[:, cols - half]
        near[rad + dy:rad + dy + h] |= box > 0
    cells = torch.nonzero(~near[rad:rad + h].reshape(-1)).reshape(-1)
    if cells.numel() == 0:
        raise ValueError(f"no cell of {grid.name} is {margin} m from a wall")
    return cells


def sample_poses(grid, cells, n: int, gen) -> torch.Tensor:
    """(n, 3) float32 poses at the centers of uniformly drawn free cells,
    headings uniform in [-pi, pi)."""
    dev = cells.device
    k = cells[torch.randint(cells.numel(), (n,), generator=gen, device=dev)]
    w = grid.occupied.shape[1]
    res = grid.resolution
    x = grid.origin[0] + ((k % w).double() + 0.5) * res
    y = grid.origin[1] + ((k // w).double() + 0.5) * res
    th = (torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
          * 2.0 - 1.0) * math.pi
    return torch.stack([x, y, th], dim=-1).to(torch.float32)


def state_at(poses: torch.Tensor) -> dict:
    """Standing cars at (n, 3) poses, latch clear."""
    z = torch.zeros_like(poses[:, 0])
    f = torch.zeros(poses.shape[0], dtype=torch.bool, device=poses.device)
    return dict(x=poses[:, 0].clone(), y=poses[:, 1].clone(),
                theta=poses[:, 2].clone(), velocity=z, steer_angle=z.clone(),
                angular_velocity=z.clone(), slip_angle=z.clone(), st_dyn=f,
                collision=f.clone())


class Resetter:
    """Puts every latched car back, standing, at the next pose of the pool
    (the way vectorised RL environments reset a finished episode), on the
    device: no host read."""

    def __init__(self, pool: torch.Tensor):
        self.pool = pool
        self.cursor = torch.zeros((), dtype=torch.int64, device=pool.device)

    def __call__(self, state: dict) -> dict:
        lat = state["collision"]
        k = (self.cursor + torch.cumsum(lat.long(), 0) - 1) \
            % self.pool.shape[0]
        pick = self.pool[k]
        out = {}
        for i, f in enumerate(("x", "y", "theta")):
            out[f] = torch.where(lat, pick[:, i], state[f])
        for f in ("velocity", "steer_angle", "angular_velocity",
                  "slip_angle"):
            out[f] = torch.where(lat, torch.zeros_like(state[f]), state[f])
        out["st_dyn"] = state["st_dyn"] & ~lat
        out["collision"] = torch.zeros_like(lat)
        self.cursor = self.cursor + lat.long().sum()
        return out
