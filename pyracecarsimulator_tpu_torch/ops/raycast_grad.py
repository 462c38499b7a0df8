"""Analytic-VJP segment raycasts: the O(rays) backward of every sweep.

Counterpart of ``pyracecarsimulator_tpu/ops/raycast_grad.py``. A ray's range
is ``t = (p - o_perp) / u_perp`` of its winning segment only, and every
segment is axis-aligned, so the VJP is closed form and elementwise over
rays:

    vertical hit:    dr/dx = -1/u_perp   dr/dcos = -t/u_perp   (dy = dsin = 0)
    horizontal hit:  dr/dy = -1/u_perp   dr/dsin = -t/u_perp   (dx = dcos = 0)
    clamped/no hit:  all zero

with ``u_perp`` the ray's own cos (vertical) or sin (horizontal). The only
per-ray residual beyond the range is the winning orientation, and every
sweep of the port already returns it: the kernels keep the vertical and
horizontal minima (bv, bh) apart, so ``isv = bv <= bh`` (exact ties go to
vertical). ``_WinnerRaycast`` is the one ``torch.autograd.Function``: its
forward runs a sweep with autograd off and keeps ``(r, isv, hit, cos_t,
sin_t)``, its backward is ``_winner_vjp``; the dense, tiled and sector
raycasts all go through it. Tables, bounds and the tile or sector lookup
positions are not inputs of the Function and get no gradient, as in the
JAX package.

Left out: the packed-key winner of ``_vh_chunk_body``, a TPU trick that
folds the orientation bit into the mantissa LSB of t so that XLA reduces
one array instead of two. Under autodiff the JAX mixed layout (``kv == 0``)
therefore returns a primal up to 1 ulp below ``raycast_all`` and breaks
exact ties toward horizontal; the port's values equal ``raycast_all`` in
both modes and ties go to vertical (tests/test_torch_grad.py states the
tolerance). There is no chunked scan either: the sweeps stream their
slots themselves, so ``chunk`` and ``kv``/``kv_tile`` are accepted for the
JAX signature and ignored (the layout is read from the sweep bounds).
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from .common import _ray_invs, finish_minima, tile_ids
from .sweeps import dense_sweep, list_sweep

LANES = 128     # beams per row of the tile-routed sweep


def _winner_vjp(r, isv, hit, cos_t, sin_t, g):
    """Closed-form cotangents (gx, gy, gcos, gsin) of the clamped range.

    The winner's ``u_perp`` is the ray's own direction component selected
    by the orientation bit; a vertical hit guarantees cos != 0 (and a
    horizontal one sin != 0), so the reciprocal is safe wherever ``hit``.
    """
    u_win = torch.where(isv, cos_t, sin_t)
    u_safe = torch.where(u_win == 0.0, 1e-30, u_win)
    inv_u = torch.where(hit, 1.0 / u_safe, 0.0)
    gx = torch.where(isv, -g * inv_u, 0.0)
    gy = torch.where(isv, 0.0, -g * inv_u)
    gt = -g * r * inv_u
    return gx, gy, torch.where(isv, gt, 0.0), torch.where(isv, 0.0, gt)


class _WinnerRaycast(torch.autograd.Function):
    """Clamped first-hit range of rays (x, y, cos_t, sin_t) under the
    analytic VJP. ``minima(x, y, cos_t, sin_t) -> (bv, bh)`` is the sweep,
    with everything that gets no gradient (tables, bounds, lookup
    positions) bound inside it."""

    @staticmethod
    def forward(ctx, minima, max_range, x, y, cos_t, sin_t):
        r, isv, hit = finish_minima(*minima(x, y, cos_t, sin_t), max_range)
        ctx.save_for_backward(r, isv, hit, cos_t, sin_t)
        return r

    @staticmethod
    def backward(ctx, g):
        return (None, None) + _winner_vjp(*ctx.saved_tensors, g)


def raycast_with_vjp(minima, x, y, cos_t, sin_t, max_range: float = 10.0):
    """``minima``'s clamped range, differentiable in the rays. Outside
    autograd (no ray requires grad, or grad mode is off) it skips the
    Function and its saved residuals, as the JAX package's primal path
    skips the winner-tracking forward."""
    rays = (x, y, cos_t, sin_t)
    if torch.is_grad_enabled() and any(v.requires_grad for v in rays):
        return _WinnerRaycast.apply(minima, max_range, *rays)
    return finish_minima(*minima(*rays), max_range)[0]


def _all_minima(segment_params, sweep_meta, x, y, cos_t, sin_t):
    """(bv, bh) of the dense sweep for rays of any common shape S."""
    x, y, cos_t, sin_t = torch.broadcast_tensors(x, y, cos_t, sin_t)
    inv_c, inv_s = _ray_invs(cos_t, sin_t)
    flat = [v.reshape(-1).contiguous()
            for v in (x, y, cos_t, sin_t, inv_c, inv_s)]
    bv, bh = dense_sweep(segment_params, sweep_meta, *flat)
    return bv.reshape(cos_t.shape), bh.reshape(cos_t.shape)


def _list_minima(table, meta, ids, x, y, cos_t, sin_t):
    """(bv, bh) of the list-routed sweep, shaped like ``cos_t``: the rows
    of beams of every route (map tiles, sector lists, stacked maps, the
    ring's gathered rows) through ``list_sweep``. ``ids`` (A, NBLK) int32
    rows of the (L, 4, K) ``table`` and its (L, 3) ``meta``; ``cos_t`` and
    ``sin_t`` (A, NBLK * bb), row by row; a row's origin is ``x``/``y`` at
    its first beam (every beam of an agent shares its origin)."""
    a_n, nblk = ids.shape
    g_n = a_n * nblk
    bb = cos_t.shape[1] // nblk
    inv_c, inv_s = _ray_invs(cos_t, sin_t)
    rows = lambda v: v.reshape(g_n, bb).contiguous()
    firsts = lambda v: v[:, ::bb].reshape(g_n).contiguous()
    bv, bh = list_sweep(table, meta, ids.reshape(g_n).contiguous(),
                        firsts(x), firsts(y), rows(cos_t), rows(sin_t),
                        rows(inv_c), rows(inv_s))
    return bv.reshape(cos_t.shape), bh.reshape(cos_t.shape)


def raycast_all_diff(segment_params, sweep_meta, x, y, cos_t, sin_t,
                     max_range=10.0, chunk: int = 1024, kv: int = 0):
    """Differentiable full-set raycast (analytic VJP, O(rays) backward)
    over the (4, K) ``segment_params`` and their (3,) ``sweep_meta``; ray
    args of any common shape. ``chunk`` and ``kv`` are ignored (module
    doc)."""
    return raycast_with_vjp(
        lambda *rays: _all_minima(segment_params, sweep_meta, *rays),
        x, y, cos_t, sin_t, max_range)


def raycast_tiled_diff(tiles, tile_sweep_meta, tiles_shape, tile_size,
                       tile_origin, x0, y0, x, y, cos_t, sin_t,
                       max_range=10.0, chunk: int = 512, kv_tile: int = 0):
    """Differentiable tile-culled raycast (analytic VJP, O(rays) backward):
    agents at ``x0``/``y0`` (A,) sweep their tile's list; rays (A, B).
    ``tiles``, ``x0`` and ``y0`` get no gradient (tile selection is
    piecewise constant in position). ``chunk`` and ``kv_tile`` are ignored
    (module doc)."""
    a_n, b_n = cos_t.shape
    nblk = -(-b_n // LANES)
    pad = nblk * LANES - b_n

    def minima(x, y, cos_t, sin_t):
        if pad:             # repeat the last beam; its outputs are cut off
            cos_t, sin_t = (torch.cat([v, v[:, -1:].expand(a_n, pad)], dim=1)
                            for v in (cos_t, sin_t))
        ids = tile_rows(tiles_shape, tile_size, tile_origin, x0, y0, nblk)
        bv, bh = _list_minima(tiles, tile_sweep_meta, ids, x, y, cos_t,
                              sin_t)
        return bv[:, :b_n], bh[:, :b_n]

    return raycast_with_vjp(minima, x, y, cos_t, sin_t, max_range)


def tile_rows(tiles_shape, tile_size, tile_origin, x0, y0, nblk: int):
    """(A, ``nblk``) int32 list rows of agents at ``x0``/``y0`` (A,) on a
    tiled map: every block of an agent's beams sweeps its tile's list.
    Spanned as ``scan.route``."""
    with span("scan.route"):
        tid = tile_ids(tiles_shape, tile_size, tile_origin, x0, y0)
        return tid.repeat_interleave(nblk).reshape(-1, nblk)
