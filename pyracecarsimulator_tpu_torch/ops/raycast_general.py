"""Raycast against general (arbitrary-direction) segments: the
"segments_simplified" backend.

Counterpart of ``pyracecarsimulator_tpu/ops/raycast_general.py``, over the
contour-simplified maps of ``maps/contours.py``. Per (ray, segment) pair,
with p0 the segment start, e its unit direction, L its length and
n = (-ey, ex) its normal:

    t = ((p0 - o) . n) / (u . n)        range along the ray
    s = ((o + t u) - p0) . e            position along the segment
    valid = t >= 0 and 0 <= s <= L and (u . n) != 0

The backward is closed form and elementwise, from w = n / (u . n) of the
winning segment: dr/do = -w, dr/du = -t w. ``raycast_general`` and
``raycast_general_tiled`` run under one ``torch.autograd.Function`` that
tracks the winner; outside autograd (no ray requires grad) they take the
cheap min-only sweep, as the JAX package's primal path does.

Plain PyTorch (XLA code in the JAX package, no Pallas kernel): the
(rays x slots) intermediates are swept in slot chunks under the byte
budget of ``ops/sweeps.py``. Within a chunk an exact tie between two
segments takes the larger of their w, across chunks the earlier chunk
wins, as in JAX, whose chunks may be cut elsewhere: the gradient can
differ at exact ties (a ray through a polyline vertex), a set of measure
zero.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import apply_extent_mask, rays_from_poses, tile_ids
from .sweeps import _PLAIN_BYTES_BUDGET

_BIG = 3.0e38


def _pairs(rows, x, y, cos_t, sin_t):
    """Masked pair ranges t (3e38 where invalid) and the pair's (nx, ny,
    d_safe); ``rows`` = (p0x, p0y, ex, ey, L) broadcast against the rays,
    which carry a trailing slot axis of 1."""
    p0x, p0y, ex, ey, length = rows
    nx, ny = -ey, ex
    denom = cos_t * nx + sin_t * ny
    d_safe = torch.where(denom == 0.0, 1e-30, denom)
    t = ((p0x - x) * nx + (p0y - y) * ny) / d_safe
    hx = x + t * cos_t - p0x
    hy = y + t * sin_t - p0y
    s = hx * ex + hy * ey
    valid = (t >= 0.0) & (s >= 0.0) & (s <= length) & (denom != 0.0)
    return torch.where(valid, t, _BIG), nx, ny, d_safe


def _sweep(rows_of, k, x, y, cos_t, sin_t, winner: bool):
    """Sweep rays (shape S) over ``k`` slots in chunks; ``rows_of(c0, c1)``
    gives the chunk's 5 parameter rows shaped to broadcast against
    S + (1,). Returns the unclamped min t and, when ``winner``, the
    winning (wx, wy)."""
    best = torch.full(x.shape, _BIG, dtype=torch.float32, device=x.device)
    wx = torch.zeros_like(best)
    wy = torch.zeros_like(best)
    rays = [v[..., None] for v in (x, y, cos_t, sin_t)]
    chunk = max(1, _PLAIN_BYTES_BUDGET // max(1, x.numel() * 4))
    for c0 in range(0, k, chunk):
        t, nx, ny, d_safe = _pairs(rows_of(c0, min(c0 + chunk, k)), *rays)
        tmin = t.amin(dim=-1)
        if not winner:
            best = torch.minimum(best, tmin)
            continue
        m = t == tmin[..., None]
        wx_c = torch.where(m, nx / d_safe, -_BIG).amax(dim=-1)
        wy_c = torch.where(m, ny / d_safe, -_BIG).amax(dim=-1)
        upd = tmin < best
        best = torch.where(upd, tmin, best)
        wx = torch.where(upd, wx_c, wx)
        wy = torch.where(upd, wy_c, wy)
    return best, wx, wy


class _GeneralRaycast(torch.autograd.Function):
    """Clamped range of rays (x, y, cos_t, sin_t) over general segments
    under the closed-form VJP; ``rows_of``/``k`` describe the slots (no
    gradient reaches them)."""

    @staticmethod
    def forward(ctx, rows_of, k, max_range, x, y, cos_t, sin_t):
        best, wx, wy = _sweep(rows_of, k, x, y, cos_t, sin_t, True)
        hit = best < max_range
        r = torch.clamp(best, max=max_range)
        ctx.save_for_backward(r, torch.where(hit, wx, 0.0),
                              torch.where(hit, wy, 0.0))
        return r

    @staticmethod
    def backward(ctx, g):
        r, wx, wy = ctx.saved_tensors
        return (None, None, None, -g * wx, -g * wy, -g * r * wx,
                -g * r * wy)


def _raycast(rows_of, k, x, y, cos_t, sin_t, max_range):
    rays = (x, y, cos_t, sin_t)
    if torch.is_grad_enabled() and any(v.requires_grad for v in rays):
        return _GeneralRaycast.apply(rows_of, k, max_range, *rays)
    return torch.clamp(_sweep(rows_of, k, *rays, False)[0], max=max_range)


def raycast_general(seg_params, x, y, cos_t, sin_t, max_range=10.0):
    """Differentiable raycast of rays (any common shape) against the
    ``seg_params`` (6, K) [p0x, p0y, ex, ey, L, pad]. Returns ranges
    clamped to ``max_range``. (The JAX signature's ``chunk`` is not taken:
    the slot chunk follows from the byte budget, module doc.)"""
    x, y, cos_t, sin_t = torch.broadcast_tensors(x, y, cos_t, sin_t)
    return _raycast(lambda c0, c1: seg_params[:5, c0:c1],
                    seg_params.shape[1], x, y, cos_t, sin_t, max_range)


def raycast_general_tiled(tiles, tiles_shape, tile_size, tile_origin,
                          x0, y0, x, y, cos_t, sin_t, max_range=10.0):
    """Tile-culled differentiable raycast: agents at ``x0``/``y0`` (A,)
    sweep their map tile's list of ``tiles`` (T, 6, K_tile); rays (A, B).
    ``tiles``, ``x0`` and ``y0`` get no gradient."""
    agent = tiles.index_select(
        0, tile_ids(tiles_shape, tile_size, tile_origin, x0, y0).long())
    return _raycast(lambda c0, c1: agent[:, :5, None, c0:c1].unbind(1),
                    tiles.shape[2], x, y, cos_t, sin_t, max_range)


def raycast_general_numpy(segs: np.ndarray, x, y, cos_t, sin_t,
                          max_range: float) -> np.ndarray:
    """NumPy float64 oracle for the general-segment raycast. segs: (K,
    6)."""
    x = np.atleast_1d(np.asarray(x, np.float64))
    y, cos_t, sin_t = (np.broadcast_to(np.asarray(a, np.float64), x.shape)
                       for a in (y, cos_t, sin_t))
    p0x, p0y, ex, ey, L = (segs[:, i] for i in range(5))
    nx, ny = -ey, ex
    with np.errstate(divide="ignore", invalid="ignore"):
        denom = cos_t[:, None] * nx + sin_t[:, None] * ny
        t = ((p0x - x[:, None]) * nx + (p0y - y[:, None]) * ny) / denom
        hx = x[:, None] + t * cos_t[:, None] - p0x
        hy = y[:, None] + t * sin_t[:, None] - p0y
        s = hx * ex + hy * ey
    valid = (t >= 0) & (s >= 0) & (s <= L) & np.isfinite(t) & (denom != 0)
    t = np.where(valid, t, np.inf)
    return np.minimum(t.min(axis=1), max_range)


def scan_poses_general(gmap, poses, num_beams: int = 1080,
                       fov: float = 4.712388980384690, max_range=10.0,
                       theta_discretization: int = 0,
                       use_tiles: bool = True) -> torch.Tensor:
    """Full lidar scans for poses (..., 3) on the simplified-geometry
    backend, on the map's device; differentiable in the poses. Returns
    (..., num_beams)."""
    batch, poses2, xb, yb, ct, st = rays_from_poses(
        poses.to(torch.float32), num_beams, fov, theta_discretization)
    if use_tiles and gmap.tiles is not None:
        r = raycast_general_tiled(gmap.tiles, gmap.tiles_shape,
                                  gmap.tile_size, gmap.tile_origin,
                                  poses2[:, 0], poses2[:, 1],
                                  xb, yb, ct, st, max_range)
    else:
        r = raycast_general(gmap.params, xb, yb, ct, st, max_range)
    r = apply_extent_mask(r, poses2[:, 0], poses2[:, 1], gmap.extent,
                          max_range)
    return r.reshape(*batch, num_beams)
