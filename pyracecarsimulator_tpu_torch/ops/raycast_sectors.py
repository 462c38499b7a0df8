"""Sector-culled segment raycast: list routing, the sweep, the scan.

Counterpart of ``pyracecarsimulator_tpu/ops/raycast_sectors.py`` (the
single-map forward, its VJP and the scan). Beams are grouped into
angle-contiguous blocks of ``bb`` (128 for the 1080-beam / 270 deg scan);
each block (a "ray row": one agent, one origin) sweeps only its (tile,
sector) cull list from ``maps/sectors.py``.

One sweep serves every map and mode: the list-routed sweep of
``ops/sweeps.py`` (plain PyTorch on CPU tensors, the hand-written Hopper
kernel ``csrc/sector_sweep.cu`` on CUDA tensors), which visits a row's
vertical slots [0, n_v) and horizontal slots [h_lo, h_end) from ``meta``.
It replaces the JAX package's XLA dense sweep and its three Pallas sector
kernels; each of those keeps a wrapper with its own launch counter: modes
"auto", "dense" and "sorted_plf*" take ``sector_sweep``, mode "sorted_pl"
``sorted_tiles_sweep`` and ``use_pallas=True`` ``grp_sweep``, all with the
same values. The XLA-only sorted modes ("sorted", "sorted_pt", ...) raise.
Left out as TPU machinery: ``table_ck``, the sort of rows into tiles, the
``grp``/``interpret`` plumbing and SMEM-driven agent chunks.

``raycast_sectors`` is differentiable in the rays: its forward runs under
``raycast_grad._WinnerRaycast``, whose backward is the closed-form
``_winner_vjp``; the table, meta and the lookup positions get no gradient.
``scan_poses_sectors_mapgrad`` adds a d(range)/d(map) cotangent into an
EDF (``raymarch_diff.with_map_gradient``) to the same sector scan.

Multitrack serving: ``scan_poses_sectors_multi`` scans agents that live on
different maps of a ``maps.sectors.StackedSectorMap`` in one sweep;
``stack_block_ids`` routes each agent's blocks to rows of the stacked
table and ``raycast_sectors_ids`` is ``raycast_sectors`` with those rows
handed in. Left out there as TPU machinery: ``resolve_sector_mode``,
``_auto_agent_chunk``'s SMEM caps and ``interpret``.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import (_f32, _padded_offsets, _ray_invs, apply_extent_mask,
                     fan_cos_sin, tile_ids)
from .raycast_grad import raycast_with_vjp
from .sweeps import (grp_sweep, list_sweep_plain as sweep_plain,  # noqa: F401
                     sector_sweep, sorted_tiles_sweep)

_TWO_PI = np.float32(2.0 * np.pi)


def sector_block_width(smap, num_beams: int, fov: float,
                       bb: int | None = None) -> int:
    """Derive (bb=None) or validate a beam-block width for a sector map.

    Every real beam of a ``bb``-block must lie within the map's
    ``block_half`` of the block's lookup beam. ``bb=None`` returns the
    widest supported block, capped at 128. Raises ValueError when ``bb``
    exceeds what the map was built for.
    """
    spacing = fov / max(num_beams - 1, 1)
    if bb is None:
        bb = max(1, min(128, 2 * int(smap.block_half / spacing)))
    need = (bb // 2) * spacing
    if need > smap.block_half:
        raise ValueError(
            f"beam blocks span +-{need:.3f} rad but the sector map was "
            f"built for block_half={smap.block_half:.3f}; rebuild the map "
            "with a larger block_half or use a smaller bb")
    return bb


def _list_ids(tiles_shape, tile_size, tile_origin, ns, x0, y0, ct, st,
              bb: int):
    """(A,) agent positions + (A, B) beam directions -> (A, NBLK) int32
    rows into the (T*NS, ...) sector table. A block's sector is read from
    one in-block beam within half a block of every real beam."""
    a_n, b_n = ct.shape
    nblk = -(-b_n // bb)
    dev = ct.device
    tid = tile_ids(tiles_shape, tile_size, tile_origin, x0, y0)   # (A,)
    mids = torch.as_tensor(
        np.minimum(np.arange(nblk) * bb + bb // 2, b_n - 1), device=dev)
    th = torch.atan2(st[:, mids], ct[:, mids])             # (A, NBLK)
    th = torch.remainder(th, _f32(_TWO_PI, dev))
    sec = torch.clamp((th * _f32(np.float32(ns) / _TWO_PI, dev))
                      .to(torch.int32), 0, ns - 1)
    return (tid[:, None] * ns + sec).to(torch.int32)       # (A, NBLK)


def raycast_sectors(table, meta, tiles_shape, tile_size, tile_origin, ns,
                    x0, y0, x, y, cos_t, sin_t, max_range: float = 10.0,
                    bb: int = 128, sweep=sector_sweep):
    """Differentiable sector-culled raycast for (A,) agent positions
    ``x0``/``y0`` (the list lookup) and (A, B) rays, B a multiple of
    ``bb``. Returns the clamped range (A, B). A row's origin is that of
    its first beam (every beam of an agent shares its origin). ``sweep``
    is one of the list-kernel wrappers (module doc)."""
    b_n = cos_t.shape[1]
    if b_n % bb:
        raise ValueError(f"beam count {b_n} is not a multiple of bb={bb}")

    def minima(x, y, cos_t, sin_t):
        a_n = cos_t.shape[0]
        ids = _list_ids(tiles_shape, tile_size, tile_origin, ns, x0, y0,
                        cos_t, sin_t, bb)
        inv_c, inv_s = _ray_invs(cos_t, sin_t)
        g_n = ids.numel()
        rows = lambda v: v.reshape(g_n, bb).contiguous()
        bv, bh = sweep(table, meta, ids.reshape(g_n).contiguous(),
                       x[:, ::bb].reshape(g_n).contiguous(),
                       y[:, ::bb].reshape(g_n).contiguous(), rows(cos_t),
                       rows(sin_t), rows(inv_c), rows(inv_s))
        return bv.reshape(a_n, b_n), bh.reshape(a_n, b_n)

    return raycast_with_vjp(minima, x, y, cos_t, sin_t, max_range)


def _sweep_for(mode: str, use_pallas):
    """The list-kernel wrapper a mode selects (module doc)."""
    if use_pallas:
        return grp_sweep
    kind = mode.split("@", 1)[0]
    if kind == "sorted_pl":
        return sorted_tiles_sweep
    if kind in ("auto", "dense") or kind.startswith("sorted_plf"):
        return sector_sweep
    raise NotImplementedError(
        f"sector sweep mode {mode!r} is not ported: it selects one of the "
        "JAX package's XLA sorted sweeps, TPU machinery (ROADMAP.md "
        "'Not to port'); the port's list kernel serves 'auto', 'dense', "
        "'sorted_pl' and 'sorted_plf*'")


def _scan_chunk(smap, poses2, ct, st, num_beams, max_range, bb,
                sweep=sector_sweep):
    """Raycast + extent mask for one (A, 3) pose chunk whose padded beam
    fan (ct, st) was built outside the chunk loop. Returns (A,
    num_beams)."""
    r = raycast_sectors(
        smap.table, smap.meta, smap.tiles_shape, smap.tile_size,
        smap.tile_origin, smap.ns, poses2[:, 0], poses2[:, 1],
        poses2[:, 0:1].expand(ct.shape), poses2[:, 1:2].expand(ct.shape),
        ct, st, max_range, bb, sweep)
    return apply_extent_mask(r[:, :num_beams], poses2[:, 0], poses2[:, 1],
                             smap.extent, max_range)


def scan_poses_sectors(smap, poses, num_beams: int = 1080,
                       fov: float = 4.712388980384690, max_range=10.0,
                       theta_discretization: int = 0, bb=None,
                       use_pallas=None, mode: str = "auto",
                       agent_chunk=None) -> torch.Tensor:
    """Full lidar scans for poses (..., 3) on the sector backend; returns
    (..., num_beams) ranges, differentiable in the poses. ``poses`` must be
    on the map's device.

    ``agent_chunk``: agents per sequential chunk; ``None`` or ``0`` never
    chunks (neither sweep's working set grows with the batch beyond its
    inputs and outputs). Values are identical either way.
    """
    sweep = _sweep_for(mode, use_pallas)
    bb = sector_block_width(smap, num_beams, fov, bb)
    batch = tuple(poses.shape[:-1])
    poses2 = poses.reshape(-1, 3).to(torch.float32)
    a_n = poses2.shape[0]
    offs = _padded_offsets(num_beams, fov, bb, poses2.device)
    # the fan is built ONCE for the whole batch, so chunked and unchunked
    # scans see the same directions
    ct, st = fan_cos_sin(poses2[:, 2], offs, theta_discretization)
    if agent_chunk and a_n > agent_chunk:
        r = torch.cat([
            _scan_chunk(smap, poses2[i:i + agent_chunk],
                        ct[i:i + agent_chunk], st[i:i + agent_chunk],
                        num_beams, max_range, bb, sweep)
            for i in range(0, a_n, agent_chunk)])
    else:
        r = _scan_chunk(smap, poses2, ct, st, num_beams, max_range, bb,
                        sweep)
    return r.reshape(*batch, num_beams)


def scan_poses_sectors_mapgrad(smap, edf, resolution, origin_xy, poses,
                               num_beams: int = 1080,
                               fov: float = 4.712388980384690,
                               max_range=10.0,
                               theta_discretization: int = 0,
                               eps: float = 1e-4, bounds_hw=None,
                               bb=None, dedup: bool = False) -> torch.Tensor:
    """Sector-culled scan with a d(range)/d(map) cotangent.

    Values equal ``scan_poses_sectors`` bit for bit (the sector sweep,
    ``sector_sweep``, computes them; ``with_map_gradient`` is
    straight-through). Backward: the ray cotangents through the sector
    scan's closed-form VJP, plus the implicit-function map cotangent into
    ``edf`` at each hit (4 bilinear taps per ray).

    ``edf``: the distance field the map cotangent lands in (for example
    ``track.edf``), on the map's device. It must describe the occupancy
    boundary the sector map was compiled from. ``bounds_hw``: the real
    (h, w) if ``edf`` is padded.
    """
    from .raymarch_diff import with_map_gradient
    bb = sector_block_width(smap, num_beams, fov, bb)
    batch = tuple(poses.shape[:-1])
    poses2 = poses.reshape(-1, 3).to(torch.float32)
    offs = _padded_offsets(num_beams, fov, bb, poses2.device)
    ct, st = fan_cos_sin(poses2[:, 2], offs, theta_discretization)
    xb = poses2[:, 0:1].expand(ct.shape)
    yb = poses2[:, 1:2].expand(ct.shape)
    r = raycast_sectors(
        smap.table, smap.meta, smap.tiles_shape, smap.tile_size,
        smap.tile_origin, smap.ns, poses2[:, 0], poses2[:, 1], xb, yb, ct,
        st, max_range, bb, sector_sweep)[:, :num_beams]
    r = apply_extent_mask(r, poses2[:, 0], poses2[:, 1], smap.extent,
                          max_range)
    r = with_map_gradient(edf, r, xb[:, :num_beams], yb[:, :num_beams],
                          ct[:, :num_beams], st[:, :num_beams], resolution,
                          origin_xy, eps, bounds_hw, dedup)
    return r.reshape(*batch, num_beams)


def raycast_sectors_ids(table, meta, ids, x, y, cos_t, sin_t,
                        max_range: float = 10.0, sweep=sector_sweep):
    """Sector sweep over precomputed list ids (the multitrack path).

    Ray args are (A, NBLK, bb); ``ids`` (A, NBLK) rows into ``table``. The
    values and the VJP are those of ``raycast_sectors``; only the routing
    differs (per-agent map offsets, ``maps.sectors.StackedSectorMap``).
    ``table``, ``meta`` and ``ids`` get no gradient. ``sweep`` is one of
    the list-kernel wrappers (module doc). Returns (A, NBLK*bb) clamped
    ranges."""
    a_n, nblk, bb = cos_t.shape
    g_n = a_n * nblk

    def minima(x, y, cos_t, sin_t):
        inv_c, inv_s = _ray_invs(cos_t, sin_t)
        rows = lambda v: v.reshape(g_n, bb).contiguous()
        bv, bh = sweep(table, meta,
                       ids.reshape(g_n).to(torch.int32).contiguous(),
                       x[:, :, 0].reshape(g_n).contiguous(),
                       y[:, :, 0].reshape(g_n).contiguous(), rows(cos_t),
                       rows(sin_t), rows(inv_c), rows(inv_s))
        return bv.reshape(a_n, nblk, bb), bh.reshape(a_n, nblk, bb)

    return raycast_with_vjp(minima, x, y, cos_t, sin_t,
                            max_range).reshape(a_n, nblk * bb)


def stack_block_ids(stack, mid, x0, y0, ct, st, b_real: int, bb: int):
    """Per-agent routing for the stacked multi-map sweep.

    ``mid``: (A,) int map ids; ``x0``/``y0``: (A,) agent positions;
    ``ct``/``st``: (A, NBLK*bb) padded beam fan; ``b_real``: real beam
    count (block lookup indices are capped there so padded beams never
    route). Returns ``(ids, inside)``: (A, NBLK) int32 rows into
    ``stack.table`` and the (A,) per-agent map-extent mask. The float32
    arithmetic follows the JAX package operation for operation (subtract,
    a correctly rounded divide by a device scalar, truncate)."""
    nblk = ct.shape[1] // bb
    dev = ct.device
    mid = mid.long()
    g = stack.grids.index_select(0, mid)            # [nr, nc, tox, toy]
    base = stack.offsets.index_select(0, mid)       # (A,)
    nr = g[:, 0].to(torch.int32)
    nc = g[:, 1].to(torch.int32)
    ts = _f32(stack.tile_size, dev)
    ci = torch.minimum(torch.clamp(((x0 - g[:, 2]) / ts).to(torch.int32),
                                   min=0), nc - 1)
    ri = torch.minimum(torch.clamp(((y0 - g[:, 3]) / ts).to(torch.int32),
                                   min=0), nr - 1)
    tid = ri * nc + ci
    mids = torch.as_tensor(
        np.minimum(np.arange(nblk) * bb + bb // 2, b_real - 1), device=dev)
    th = torch.remainder(torch.atan2(st[:, mids], ct[:, mids]),
                         _f32(_TWO_PI, dev))
    sec = torch.clamp((th * _f32(np.float32(stack.ns) / _TWO_PI, dev))
                      .to(torch.int32), 0, stack.ns - 1)
    ids = ((base + tid * stack.ns)[:, None] + sec).to(torch.int32)
    e = stack.extents.index_select(0, mid)
    inside = ((x0 >= e[:, 0]) & (x0 < e[:, 1])
              & (y0 >= e[:, 2]) & (y0 < e[:, 3]))
    return ids, inside


def _scan_chunk_multi(stack, poses2, mid, ct, st, num_beams, max_range, bb,
                      sweep=sector_sweep):
    """Stacked raycast + per-agent extent mask for one (A, 3) pose chunk
    whose padded fan (ct, st) was built outside the chunk loop."""
    a_n = poses2.shape[0]
    shp = (a_n, ct.shape[1] // bb, bb)
    ids, inside = stack_block_ids(stack, mid, poses2[:, 0], poses2[:, 1],
                                  ct, st, num_beams, bb)
    r = raycast_sectors_ids(
        stack.table, stack.meta, ids,
        poses2[:, 0:1].expand(ct.shape).reshape(shp),
        poses2[:, 1:2].expand(ct.shape).reshape(shp), ct.reshape(shp),
        st.reshape(shp), max_range, sweep)[:, :num_beams]
    # per-agent extent mask (reference out-of-map => max_range)
    return torch.where(inside[:, None], r, max_range)


def scan_poses_sectors_multi(stack, map_ids, poses, num_beams: int = 1080,
                             fov: float = 4.712388980384690,
                             max_range=10.0, theta_discretization: int = 0,
                             bb=None, mode: str = "auto",
                             agent_chunk=None) -> torch.Tensor:
    """Multitrack batched scan: agent i scans on map ``map_ids[i]`` of
    ``stack`` (a ``maps.sectors.StackedSectorMap``). One sweep serves the
    whole agent batch across all stacked tracks; values equal each map's
    own ``scan_poses_sectors``, and the scan is differentiable in the
    poses. ``poses`` and ``map_ids`` must be on the stack's device.

    ``mode`` and ``agent_chunk`` as ``scan_poses_sectors``."""
    sweep = _sweep_for(mode, None)
    bb = sector_block_width(stack, num_beams, fov, bb)
    batch = tuple(poses.shape[:-1])
    poses2 = poses.reshape(-1, 3).to(torch.float32)
    mid = torch.as_tensor(map_ids, device=poses2.device).reshape(-1)
    a_n = poses2.shape[0]
    offs = _padded_offsets(num_beams, fov, bb, poses2.device)
    # the fan is built once for the whole batch (see scan_poses_sectors)
    ct, st = fan_cos_sin(poses2[:, 2], offs, theta_discretization)
    args = (num_beams, max_range, bb, sweep)
    if agent_chunk and a_n > agent_chunk:
        r = torch.cat([
            _scan_chunk_multi(stack, *(v[i:i + agent_chunk]
                                       for v in (poses2, mid, ct, st)),
                              *args)
            for i in range(0, a_n, agent_chunk)])
    else:
        r = _scan_chunk_multi(stack, poses2, mid, ct, st, *args)
    return r.reshape(*batch, num_beams)
