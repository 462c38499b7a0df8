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

The sweep (``general_sweep``) launches the hand-written kernel
``csrc/general_sweep.cu`` on CUDA tensors, one launch a scan, in both
modes and both layouts (every ray against the (6, K) table, or each agent
against its map tile's list of a (T, 6, K_tile) table); on CPU tensors its
plain version ``general_sweep_plain`` runs, the kernel's reference bit for
bit. Both take the JAX scan's slot chunks, ``_fit_chunk(K, 512)`` slots:
within a chunk an exact tie between segments takes the larger of their
w, component by component, and across chunks the earlier chunk wins, as
in JAX. The plain version sweeps the rays in blocks whose (rays x slots)
intermediates stay within the byte budget of ``ops/sweeps.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels
from ._kernels import COUNT_LANES
from .common import apply_extent_mask, rays_from_poses, tile_ids
from .raymarch_xla import INDEX_LIMIT, _as_rows
from .sweeps import _PLAIN_BYTES_BUDGET, GENERAL_COUNTS
from ..utils.profiling import span

_BIG = 3.0e38
# the JAX sweeps' slot chunk (``raycast_general``'s default ``chunk``)
_SLOT_CHUNK = 512


def _fit_chunk(k: int) -> int:
    """The slots of one chunk of a ``k``-slot sweep, as the JAX package
    cuts them (``raycast_segments._fit_chunk(k, 512)``): ``k`` itself when
    ``k <= 512``, else the largest multiple of 128 up to 512 that divides
    ``k``. (The maps pad ``k`` to a multiple of 128; JAX sweeps no slot
    for ``k < 128``, and fails on an unaligned ``k > 512``, which this
    copy refuses.)"""
    if k <= _SLOT_CHUNK:
        return k
    for c in range(_SLOT_CHUNK, 0, -128):
        if k % c == 0:
            return c
    raise ValueError(f"general sweep: {k} slots is neither at most "
                     f"{_SLOT_CHUNK} nor a multiple of 128")


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


def _sweep_block(lists, k, chunk, rays, winner):
    """One block of rays (each (R, C, 1)) over the ``lists`` (R or 1, 6,
    K), chunk by chunk: (best, wx, wy), each (R, C)."""
    best = torch.full(rays[0].shape[:-1], _BIG, dtype=torch.float32,
                      device=rays[0].device)
    wx = torch.zeros_like(best)
    wy = torch.zeros_like(best)
    for c0 in range(0, k, chunk):
        t, nx, ny, d_safe = _pairs(lists[:, :5, None, c0:c0 + chunk]
                                   .unbind(1), *rays)
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


def general_sweep_plain(table, ids, x, y, cos_t, sin_t, winner: bool):
    """The plain PyTorch general sweep, on any device: the reference of
    ``csrc/general_sweep.cu``. Same arguments and returns as
    ``general_sweep``. The rays go in blocks of rows and columns whose
    (rays x chunk) intermediates stay within ``_PLAIN_BYTES_BUDGET``; a
    ray's values do not depend on its block. Adds the rays, and the pairs
    they test as the kernel counts them (each ray its row's list up to
    the list's last slot of length >= 0), to ``GENERAL_COUNTS.host`` (a
    synchronisation on the card)."""
    x, y, cos_t, sin_t = torch.broadcast_tensors(x, y, cos_t, sin_t)
    shape = x.shape
    views = [_as_rows(v) for v in (x, y, cos_t, sin_t)]
    rows, cols = views[0].shape
    k = table.shape[2]
    chunk = _fit_chunk(k)
    lists = table[:1] if ids is None else table.index_select(0, ids.long())
    slot = torch.arange(1, k + 1, device=table.device)
    n_real = torch.where(lists[:, 4] >= 0.0, slot, 0).amax(dim=1)
    GENERAL_COUNTS.host["rays"] += rows * cols
    GENERAL_COUNTS.host["pairs"] += cols * int(
        n_real.sum() * (rows if ids is None else 1))
    best = torch.full((rows, cols), _BIG, dtype=torch.float32,
                      device=table.device)
    wx = torch.zeros_like(best)
    wy = torch.zeros_like(best)
    rays_b = max(1, _PLAIN_BYTES_BUDGET // (4 * chunk))
    cols_b = max(1, min(cols, rays_b))
    rows_b = max(1, rays_b // cols_b)
    for r0 in range(0, rows, rows_b):
        r1 = r0 + rows_b
        blk = lists if ids is None else lists[r0:r1]
        for c0 in range(0, cols, cols_b):
            c1 = c0 + cols_b
            out = _sweep_block(blk, k, chunk,
                               [v[r0:r1, c0:c1, None] for v in views],
                               winner)
            for dst, src in zip((best, wx, wy), out):
                dst[r0:r1, c0:c1] = src
    best = best.reshape(shape)
    if not winner:
        return best, None, None
    return best, wx.reshape(shape), wy.reshape(shape)


def general_sweep(table, ids, x, y, cos_t, sin_t, winner: bool):
    """The general-segment sweep: ``general_sweep_plain`` on CPU tensors,
    ``csrc/general_sweep.cu`` on CUDA tensors.

    ``table`` (L, 6, K) float32 slots [p0x, p0y, ex, ey, L, pad]; rays
    ``x``, ``y``, ``cos_t``, ``sin_t`` broadcast to one shape S, whose
    rows are its leading axes and whose columns its last; ``ids`` (rows,)
    int32, the list each row sweeps (in [0, L)), or None: every row sweeps
    list 0. Returns (best, wx, wy), each of shape S: the unclamped first
    hit t (3e38 where nothing is hit) and, with ``winner``, the winning
    segment's (nx, ny) / (u . n) with the JAX scan's ties (module doc);
    without it (best, None, None). ``general_sweep.launches`` counts
    kernel launches; the kernel adds its rays and pairs to
    ``sweeps.GENERAL_COUNTS``' device counter."""
    if not _kernels.on_cuda("general_sweep", table):
        return general_sweep_plain(table, ids, x, y, cos_t, sin_t, winner)
    if (table.dim() != 3 or table.shape[1] != 6 or table.shape[0] < 1
            or table.shape[2] < 1 or table.dtype != torch.float32
            or not table.is_contiguous()):
        raise ValueError(f"general_sweep: table must be a contiguous "
                         f"float32 (L, 6, K) tensor, got {table.dtype} "
                         f"{tuple(table.shape)}")
    rays = torch.broadcast_tensors(x, y, cos_t, sin_t)
    for v in rays:
        if v.device != table.device or v.dtype != torch.float32:
            raise ValueError(f"general_sweep: expected float32 rays on "
                             f"{table.device}, got {v.dtype} on {v.device}")
    shape = rays[0].shape
    views = [_as_rows(v) for v in rays]
    rows, cols = views[0].shape
    if ids is not None and (ids.dtype != torch.int32 or ids.dim() != 1
                            or ids.shape[0] != rows
                            or ids.device != table.device
                            or not ids.is_contiguous()):
        raise ValueError(f"general_sweep: ids must be a contiguous int32 "
                         f"({rows},) tensor on {table.device}")
    l_n, _, k = table.shape
    chunk = _fit_chunk(k)
    extents = {"the table": table.numel(), "the rays": rows * cols}
    extents.update((f"ray tensor {i}'s last offset",
                    (rows - 1) * v.stride(0) + (cols - 1) * v.stride(1))
                   for i, v in enumerate(views))
    for what, size in extents.items():
        if size > INDEX_LIMIT:
            raise ValueError(f"general_sweep: {what} reaches {size}, past "
                             f"the kernel's 32-bit index limit "
                             f"({INDEX_LIMIT})")
    out = [torch.empty(shape, dtype=torch.float32, device=table.device)
           for _ in range(3 if winner else 1)]
    if rows * cols:
        _kernels.launch("general_sweep", "general_sweep", int(winner), table,
                        l_n, k, chunk, ids, *views,
                        *(s for v in views for s in v.stride()), rows, cols,
                        *out, *(None,) * (3 - len(out)),
                        GENERAL_COUNTS.counter(table.device), COUNT_LANES)
    return (out[0], None, None) if not winner else tuple(out)


_kernels.register(general_sweep)


class _GeneralRaycast(torch.autograd.Function):
    """Clamped range of rays (x, y, cos_t, sin_t) over general segments
    under the closed-form VJP; ``table``/``ids`` describe the lists
    (``general_sweep``; no gradient reaches them)."""

    @staticmethod
    def forward(ctx, table, ids, max_range, x, y, cos_t, sin_t):
        best, wx, wy = general_sweep(table, ids, x, y, cos_t, sin_t, True)
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


def _raycast(table, ids, x, y, cos_t, sin_t, max_range):
    rays = torch.broadcast_tensors(x, y, cos_t, sin_t)
    if torch.is_grad_enabled() and any(v.requires_grad for v in rays):
        return _GeneralRaycast.apply(table, ids, max_range, *rays)
    return torch.clamp(general_sweep(table, ids, *rays, False)[0],
                       max=max_range)


def raycast_general(seg_params, x, y, cos_t, sin_t, max_range=10.0):
    """Differentiable raycast of rays (any common shape) against the
    ``seg_params`` (6, K) [p0x, p0y, ex, ey, L, pad]. Returns ranges
    clamped to ``max_range``. (The JAX signature's ``chunk`` is not taken:
    the slots go in its default chunks, module doc.)"""
    return _raycast(seg_params.reshape(1, *seg_params.shape), None, x, y,
                    cos_t, sin_t, max_range)


def raycast_general_tiled(tiles, tiles_shape, tile_size, tile_origin,
                          x0, y0, x, y, cos_t, sin_t, max_range=10.0):
    """Tile-culled differentiable raycast: agents at ``x0``/``y0`` (A,)
    sweep their map tile's list of ``tiles`` (T, 6, K_tile); rays (A, B).
    ``tiles``, ``x0`` and ``y0`` get no gradient. The tile ids are spanned
    as ``scan.route``."""
    with span("scan.route"):
        ids = tile_ids(tiles_shape, tile_size, tile_origin, x0, y0)
    return _raycast(tiles, ids, x, y, cos_t, sin_t, max_range)


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
    (..., num_beams). The fan is spanned as ``scan.fan``."""
    with span("scan.fan"):
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
