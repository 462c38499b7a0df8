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
A scan of poses whose rays take no gradient, on the exact fan, takes the
kernel's from-poses entry (``sweeps.list_scan``: the fan, reciprocals,
sweep, clamp and extent mask in one launch, bit for bit the composition);
the route then looks up the directions of the block-middle beams alone.
It replaces the JAX package's XLA dense sweep and its three Pallas sector
kernels, so ``mode`` ("auto", "dense", "sorted_pl", "sorted_plf*", each
with an optional "@N") and ``use_pallas`` are accepted and ignored: every
one runs ``raycast_grad._list_minima``, with the same values. The XLA-only
sorted modes ("sorted", "sorted_pt", ...) raise. Left out as TPU
machinery: ``table_ck``, the sort of rows into tiles, the
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

from ..utils.profiling import span
from .common import (_f32, _padded_offsets, apply_extent_mask, block_mids,
                     fan_cos_sin, fused_scan, mid_offset_factors,
                     offset_factors, rotate_fan, tile_ids)
from .raycast_grad import _list_minima, raycast_with_vjp
from .sweeps import list_scan

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
    b_n = ct.shape[1]
    mids = block_mids(-(-b_n // bb), bb, b_n, ct.device)
    return _sector_ids(tiles_shape, tile_size, tile_origin, ns, x0, y0,
                       ct[:, mids], st[:, mids])


def _sector_ids(tiles_shape, tile_size, tile_origin, ns, x0, y0, cm, sm):
    """``_list_ids`` from the directions (cm, sm) (A, NBLK) of each
    block's lookup beam."""
    dev = cm.device
    tid = tile_ids(tiles_shape, tile_size, tile_origin, x0, y0)   # (A,)
    th = torch.atan2(sm, cm)                               # (A, NBLK)
    th = torch.remainder(th, _f32(_TWO_PI, dev))
    sec = torch.clamp((th * _f32(np.float32(ns) / _TWO_PI, dev))
                      .to(torch.int32), 0, ns - 1)
    return (tid[:, None] * ns + sec).to(torch.int32)       # (A, NBLK)


def raycast_sectors(table, meta, tiles_shape, tile_size, tile_origin, ns,
                    x0, y0, x, y, cos_t, sin_t, max_range: float = 10.0,
                    bb: int = 128):
    """Differentiable sector-culled raycast for (A,) agent positions
    ``x0``/``y0`` (the list lookup) and (A, B) rays, B a multiple of
    ``bb``. Returns the clamped range (A, B). A row's origin is that of
    its first beam (every beam of an agent shares its origin)."""
    b_n = cos_t.shape[1]
    if b_n % bb:
        raise ValueError(f"beam count {b_n} is not a multiple of bb={bb}")

    def minima(x, y, cos_t, sin_t):
        with span("scan.route"):
            ids = _list_ids(tiles_shape, tile_size, tile_origin, ns, x0, y0,
                            cos_t, sin_t, bb)
        return _list_minima(table, meta, ids, x, y, cos_t, sin_t)

    return raycast_with_vjp(minima, x, y, cos_t, sin_t, max_range)


def _check_mode(mode: str, use_pallas):
    """Raise for the modes the port does not run (module doc)."""
    kind = mode.split("@", 1)[0]
    if (use_pallas or kind in ("auto", "dense", "sorted_pl")
            or kind.startswith("sorted_plf")):
        return
    raise NotImplementedError(
        f"sector sweep mode {mode!r} is not ported: it selects one of the "
        "JAX package's XLA sorted sweeps, TPU machinery (ROADMAP.md "
        "'Not to port'); the port's list kernel serves 'auto', 'dense', "
        "'sorted_pl' and 'sorted_plf*'")


def _sector_fan(smap, poses, num_beams, fov, theta_discretization, bb):
    """``(bb, poses2, ct, st)`` of a sector scan of poses (..., 3): the
    block width, the poses as (A, 3) float32 and their fan padded to
    blocks of ``bb``. The fan is built once for the whole batch, so
    chunked and unchunked scans see the same directions."""
    bb = sector_block_width(smap, num_beams, fov, bb)
    poses2 = poses.reshape(-1, 3).to(torch.float32)
    offs = _padded_offsets(num_beams, fov, bb, poses2.device)
    return (bb, poses2,
            *fan_cos_sin(poses2[:, 2], offs, theta_discretization))


def _by_chunks(scan, agent_chunk, *per_agent):
    """``scan(*per_agent)``, or its rows over sequential chunks of
    ``agent_chunk`` agents (``None`` or ``0``: one call)."""
    a_n = per_agent[0].shape[0]
    if agent_chunk and a_n > agent_chunk:
        return torch.cat([scan(*(v[i:i + agent_chunk] for v in per_agent))
                          for i in range(0, a_n, agent_chunk)])
    return scan(*per_agent)


def _scan_chunk(smap, poses2, ct, st, num_beams, max_range, bb):
    """Raycast + extent mask for one (A, 3) pose chunk whose padded beam
    fan (ct, st) was built outside the chunk loop. Returns (A,
    num_beams)."""
    r = raycast_sectors(
        smap.table, smap.meta, smap.tiles_shape, smap.tile_size,
        smap.tile_origin, smap.ns, poses2[:, 0], poses2[:, 1],
        poses2[:, 0:1].expand(ct.shape), poses2[:, 1:2].expand(ct.shape),
        ct, st, max_range, bb)
    return apply_extent_mask(r[:, :num_beams], poses2[:, 0], poses2[:, 1],
                             smap.extent, max_range)


def scan_poses_sectors(smap, poses, num_beams: int = 1080,
                       fov: float = 4.712388980384690, max_range=10.0,
                       theta_discretization: int = 0, bb=None,
                       use_pallas=None, mode: str = "auto",
                       agent_chunk=None) -> torch.Tensor:
    """Full lidar scans for poses (..., 3) on the sector backend; returns
    (..., num_beams) ranges, differentiable in the poses. ``poses`` must be
    on the map's device. ``mode`` and ``use_pallas`` are accepted and
    ignored; the modes the port does not run raise (module doc).

    ``agent_chunk``: agents per sequential chunk; ``None`` or ``0`` never
    chunks (neither sweep's working set grows with the batch beyond its
    inputs and outputs). Values are identical either way.
    """
    _check_mode(mode, use_pallas)
    if fused_scan(poses, theta_discretization):
        bb = sector_block_width(smap, num_beams, fov, bb)
        poses2 = poses.reshape(-1, 3).to(torch.float32)
        # the headings' factors over the whole batch, as ``_sector_fan``
        cth, sth = torch.cos(poses2[:, 2]), torch.sin(poses2[:, 2])
        r = _by_chunks(lambda p, c, s: _scan_chunk_fused(
            smap, p, c, s, num_beams, fov, max_range, bb),
            agent_chunk, poses2, cth, sth)
        return r.reshape(*poses.shape[:-1], num_beams)
    bb, poses2, ct, st = _sector_fan(smap, poses, num_beams, fov,
                                     theta_discretization, bb)
    r = _by_chunks(lambda p, c, s: _scan_chunk(smap, p, c, s, num_beams,
                                               max_range, bb),
                   agent_chunk, poses2, ct, st)
    return r.reshape(*poses.shape[:-1], num_beams)


def _scan_chunk_fused(smap, poses2, cth, sth, num_beams, fov, max_range,
                      bb):
    """``_scan_chunk`` for (A, 3) poses whose rays take no gradient, from
    their headings' (cos, sin) (A,), in one launch of the list kernel's
    from-poses entry; the route looks up the block-middle directions
    alone. The same values bit for bit. Returns (A, num_beams)."""
    dev = poses2.device
    x0, y0 = (poses2[:, i].contiguous() for i in (0, 1))
    with span("scan.route"):
        ids = _sector_ids(smap.tiles_shape, smap.tile_size, smap.tile_origin,
                          smap.ns, x0, y0, *rotate_fan(
                              cth, sth, *mid_offset_factors(num_beams, fov,
                                                            bb, dev)))
    return list_scan(smap.table, smap.meta, ids, x0, y0, cth, sth,
                     *offset_factors(num_beams, fov, bb, dev), max_range,
                     smap.extent, num_beams)


def scan_poses_sectors_mapgrad(smap, edf, resolution, origin_xy, poses,
                               num_beams: int = 1080,
                               fov: float = 4.712388980384690,
                               max_range=10.0,
                               theta_discretization: int = 0,
                               eps: float = 1e-4, bounds_hw=None,
                               bb=None, dedup: bool = False) -> torch.Tensor:
    """Sector-culled scan with a d(range)/d(map) cotangent.

    Values equal ``scan_poses_sectors`` bit for bit (its scan computes
    them; ``with_map_gradient`` is straight-through). Backward: the ray
    cotangents through the sector scan's closed-form VJP, plus the
    implicit-function map cotangent into ``edf`` at each hit (4 bilinear
    taps per ray).

    ``edf``: the distance field the map cotangent lands in (for example
    ``track.edf``), on the map's device. It must describe the occupancy
    boundary the sector map was compiled from. ``bounds_hw``: the real
    (h, w) if ``edf`` is padded.
    """
    from .raymarch_diff import with_map_gradient
    bb, poses2, ct, st = _sector_fan(smap, poses, num_beams, fov,
                                     theta_discretization, bb)
    r = _scan_chunk(smap, poses2, ct, st, num_beams, max_range, bb)
    shape = r.shape
    r = with_map_gradient(edf, r, poses2[:, 0:1].expand(shape),
                          poses2[:, 1:2].expand(shape), ct[:, :num_beams],
                          st[:, :num_beams], resolution, origin_xy, eps,
                          bounds_hw, dedup)
    return r.reshape(*poses.shape[:-1], num_beams)


def raycast_sectors_ids(table, meta, ids, x, y, cos_t, sin_t,
                        max_range: float = 10.0):
    """Sector sweep over precomputed list ids (the multitrack path).

    Ray args are (A, NBLK, bb); ``ids`` (A, NBLK) rows into ``table``. The
    values and the VJP are those of ``raycast_sectors``; only the routing
    differs (per-agent map offsets, ``maps.sectors.StackedSectorMap``).
    ``table``, ``meta`` and ``ids`` get no gradient. Returns (A, NBLK*bb)
    clamped ranges."""
    a_n, nblk, bb = cos_t.shape
    flat = (v.reshape(a_n, nblk * bb) for v in (x, y, cos_t, sin_t))
    return _raycast_rows(table, meta, ids.to(torch.int32), *flat, max_range)


def _raycast_rows(table, meta, ids, x, y, cos_t, sin_t, max_range):
    """``raycast_sectors_ids`` on rays (A, NBLK * bb) and int32 ``ids``."""
    return raycast_with_vjp(
        lambda *rays: _list_minima(table, meta, ids, *rays), x, y, cos_t,
        sin_t, max_range)


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
    mids = block_mids(nblk, bb, b_real, dev)
    th = torch.remainder(torch.atan2(st[:, mids], ct[:, mids]),
                         _f32(_TWO_PI, dev))
    sec = torch.clamp((th * _f32(np.float32(stack.ns) / _TWO_PI, dev))
                      .to(torch.int32), 0, stack.ns - 1)
    ids = ((base + tid * stack.ns)[:, None] + sec).to(torch.int32)
    e = stack.extents.index_select(0, mid)
    inside = ((x0 >= e[:, 0]) & (x0 < e[:, 1])
              & (y0 >= e[:, 2]) & (y0 < e[:, 3]))
    return ids, inside


_LAST_MAP_IDS: dict = {}    # device -> (host contents, their device copy)


def _map_ids_on(map_ids, device):
    """``map_ids`` as a tensor on ``device``. A tensor is moved only if it
    lies elsewhere. A host array is copied when its contents differ from
    the last one served on that device, whose copy is kept (and shared: do
    not write it), so that serving one assignment again copies nothing."""
    if torch.is_tensor(map_ids):
        return map_ids.to(device)
    ids = np.ascontiguousarray(map_ids)
    key = (ids.dtype.str, ids.shape, ids.tobytes())
    last = _LAST_MAP_IDS.get(device)
    if last is None or last[0] != key:
        last = _LAST_MAP_IDS[device] = (
            key, torch.from_numpy(ids.copy()).to(device))
    return last[1]


def _scan_chunk_multi(stack, poses2, mid, ct, st, num_beams, max_range, bb):
    """Stacked raycast + per-agent extent mask for one (A, 3) pose chunk
    whose padded fan (ct, st) was built outside the chunk loop."""
    ids, inside = stack_block_ids(stack, mid, poses2[:, 0], poses2[:, 1],
                                  ct, st, num_beams, bb)
    r = _raycast_rows(
        stack.table, stack.meta, ids, poses2[:, 0:1].expand(ct.shape),
        poses2[:, 1:2].expand(ct.shape), ct, st, max_range)[:, :num_beams]
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
    _check_mode(mode, None)
    bb, poses2, ct, st = _sector_fan(stack, poses, num_beams, fov,
                                     theta_discretization, bb)
    mid = _map_ids_on(map_ids, poses2.device).reshape(-1)
    r = _by_chunks(lambda p, m, c, s: _scan_chunk_multi(
        stack, p, m, c, s, num_beams, max_range, bb),
        agent_chunk, poses2, mid, ct, st)
    return r.reshape(*poses.shape[:-1], num_beams)
