"""Distance-transform ray march: the reference-exact scan ("edf",
"edf_bilinear").

Counterpart of ``pyracecarsimulator_tpu/ops/raymarch_xla.py`` (the module
keeps its JAX name). Every ray sphere-traces the euclidean distance field
in lockstep: it steps by the EDF sample until the sample drops to ``eps``
(hit), the ray leaves the real map (max_range) or the range budget is
spent. The loop has a fixed trip count, as in JAX; a ray that stopped
steps by zero.

Plain PyTorch, no hand-written kernel: the JAX package runs this march in
XLA, not Pallas. Each trip is about 25 elementwise launches over the ray
tensors. Every ``_ALIVE_CHECK`` trips the loop reads ``alive.any()`` on
the host and stops once every ray has stopped. The values are those of
the full trip count: a stopped ray has ``step = 0``, so its position and
``total`` no longer change.

``interp="bilinear"`` samples the EDF bilinearly and is differentiable in
the rays and the EDF through ordinary autograd (the backward scatters
into the EDF's gradient along every visited cell). Autograd then keeps
every trip's taps, weights and indices: about 0.3 GB per trip at
4096 x 1080 rays. ``interp="nearest"`` is the reference's semantics.

Scalars round as in JAX: the origin is a float32 tensor, ``1 /
resolution`` a float32 multiplier. XLA's CPU backend may contract ``x +
step * cos_t`` into a fused multiply-add, which PyTorch does not; a
position that differs by an ulp can put a ray into the neighbouring cell,
so the two marches differ on a few beams by up to about a cell.
"""

from __future__ import annotations

import torch

from .common import _constant, rays_from_poses

_ALIVE_CHECK = 32   # trips between host reads of "is any ray still alive"

# marches run and loop trips taken so far, by every march of the port (this
# module's and ``raymarch_diff``'s); a profiler's or a test's reading
MARCH_COUNTS = {"calls": 0, "trips": 0}


def count_march(trips: int):
    """Record one march that left its loop after ``trips`` trips."""
    MARCH_COUNTS["calls"] += 1
    MARCH_COUNTS["trips"] += trips


def origin_xy_f32(origin_xy, device):
    """(ox, oy) as 0-dim float32 tensors on ``device`` from a (2,) tensor
    or a pair of numbers (copied to the device once per pair,
    ``common._constant``)."""
    if torch.is_tensor(origin_xy):
        o = origin_xy.to(device=device, dtype=torch.float32)
    else:
        xy = (float(origin_xy[0]), float(origin_xy[1]))
        o = _constant(("origin_xy", xy), device,
                      lambda: torch.tensor(xy, dtype=torch.float32))
    return o[0], o[1]


def sample_edf_nearest(edf, gx, gy, bounds_hw=None):
    """Nearest-cell EDF sample in grid units. Out-of-map -> -1 sentinel.

    ``bounds_hw``: real (unpadded) map dims for the in-bounds test; the
    gather itself uses the padded array (padding is free space).
    """
    hp, wp = edf.shape
    h, w = bounds_hw if bounds_hw is not None else (hp, wp)
    ix = torch.floor(gx).to(torch.int64)
    iy = torch.floor(gy).to(torch.int64)
    inb = (ix >= 0) & (iy >= 0) & (ix < w) & (iy < h)
    flat = iy.clamp(0, hp - 1) * wp + ix.clamp(0, wp - 1)
    return torch.where(inb, torch.take(edf, flat), -1.0)


def _bilinear_taps(edf, gx, gy):
    """Bilinear taps at grid coords (gx, gy), cell-center convention:
    (fx, fy, base) with ``base`` the int64 flat index of the lower-left
    tap. The integer base is clamped so that all 4 taps stay in bounds:
    float32 rounds a ``wp - 1.000001`` clip bound up to ``wp - 1``, which
    would put ``base + wp`` past the end within the last half-cell of an
    unpadded map."""
    hp, wp = edf.shape
    xs = torch.clamp(gx - 0.5, 0.0, wp - 1.0)
    ys = torch.clamp(gy - 0.5, 0.0, hp - 1.0)
    x0 = torch.clamp(torch.floor(xs.detach()), max=wp - 2)
    y0 = torch.clamp(torch.floor(ys.detach()), max=hp - 2)
    return xs - x0, ys - y0, y0.to(torch.int64) * wp + x0.to(torch.int64)


def _tap_values(edf, base):
    """The EDF at the 4 taps (f00, f01, f10, f11) of lower-left ``base``."""
    wp = edf.shape[1]
    return (torch.take(edf, base), torch.take(edf, base + 1),
            torch.take(edf, base + wp), torch.take(edf, base + wp + 1))


def sample_edf_bilinear(edf, gx, gy, bounds_hw=None):
    """Bilinear EDF sample, cell-center convention (value of cell (i,j)
    lives at grid point (j+0.5, i+0.5)). Out-of-map -> -1 sentinel."""
    hp, wp = edf.shape
    h, w = bounds_hw if bounds_hw is not None else (hp, wp)
    inb = (gx >= 0) & (gy >= 0) & (gx < w) & (gy < h)
    fx, fy, base = _bilinear_taps(edf, gx, gy)
    f00, f01, f10, f11 = _tap_values(edf, base)
    val = (f00 * (1 - fx) + f01 * fx) * (1 - fy) \
        + (f10 * (1 - fx) + f11 * fx) * fy
    return torch.where(inb, val, -1.0)


def march_rays(edf, resolution, origin_xy, x0, y0, cos_t, sin_t,
               max_range=10.0, eps=0.0001, max_iters: int = 256,
               interp: str = "nearest", bounds_hw=None):
    """March a batch of rays through the EDF; ray args share one shape S
    (broadcastable).

    ``edf`` (H, W) float32 distance field in meters, ``resolution``
    meters per cell, ``origin_xy`` world coords of grid corner (0, 0);
    ``max_iters`` the trip count (``max_range / resolution`` always
    suffices for reference parity); ``interp`` "nearest" (reference) or
    "bilinear" (differentiable). Returns ranges, shape S, clamped to
    ``max_range``.
    """
    if interp not in ("nearest", "bilinear"):
        raise ValueError(f"interp must be 'nearest' or 'bilinear', got "
                         f"{interp!r}")
    sample = sample_edf_nearest if interp == "nearest" else \
        sample_edf_bilinear
    inv_res = 1.0 / resolution
    ox, oy = origin_xy_f32(origin_xy, edf.device)
    x, y, cos_t, sin_t = torch.broadcast_tensors(x0, y0, cos_t, sin_t)
    total = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    alive = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    trips = max_iters
    for it in range(max_iters):
        if it and it % _ALIVE_CHECK == 0 and not bool(alive.any()):
            trips = it
            break
        gx = (x - ox) * inv_res
        gy = (y - oy) * inv_res
        d = sample(edf, gx, gy, bounds_hw)
        oob = d < 0.0                       # left the map
        hit = d <= eps                      # includes oob; refined below
        # reference loop condition: d > eps, in-map, total < max_range
        live = alive & ~hit & ~oob & (total < max_range)
        step = torch.where(live, d, 0.0)
        # out-of-map rays return max_range (clamped at the end)
        total = torch.where(alive & oob, max_range, total)
        alive = live
        x = x + step * cos_t
        y = y + step * sin_t
        total = total + step
    count_march(trips)
    return torch.clamp(total, max=max_range)


def scan_poses(edf, resolution, origin_xy, poses, num_beams: int = 1080,
               fov: float = 4.712388980384690, max_range=10.0, eps=0.0001,
               max_iters: int = 256, interp: str = "nearest",
               theta_discretization: int = 0, bounds_hw=None):
    """Full lidar scans for poses (..., 3) of (x, y, theta) on ``edf``'s
    device; ``theta_discretization > 0`` uses the reference's theta-bucket
    directions. Returns (..., num_beams) float32 ranges."""
    batch, _, xb, yb, ct, st = rays_from_poses(
        poses.to(torch.float32), num_beams, fov, theta_discretization)
    r = march_rays(edf, resolution, origin_xy, xb, yb, ct, st,
                   max_range=max_range, eps=eps, max_iters=max_iters,
                   interp=interp, bounds_hw=bounds_hw)
    return r.reshape(*batch, num_beams)
