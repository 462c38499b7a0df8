"""Angular-sector culling tables for the sector raycast backend.

Counterpart of ``pyracecarsimulator_tpu/maps/sectors.py``. Per (map tile,
angular sector), the host compiles the list of boundary segments visible
from anywhere in the tile in directions within that sector (padded by the
beam-block half-width and by parallax). At scan time each beam block sweeps
only its own (tile, sector) list. Culling is conservative, so values are
those of a sweep over every segment (proof in the JAX module's doc).

``add_segments`` appends an obstacle's boundary into the lists' headroom
slots (the facade's incremental ``add_obstacle``).

Left out, because they serve the TPU only: ``table_ck`` and
``build_table_ck`` (the chunk-grouped layout of the TPU's fused kernel; the
Hopper kernel reads the plain ``(L, 4, K)`` table), so ``add_segments`` has
no ``table_ck`` branch either, and ``StackedSectorMap`` carries none; and
the native C++ membership call (loading it goes through the JAX package;
the NumPy body below is the same geometry).

``stack_sector_maps`` stacks several maps' tables into one for multitrack
serving (``ops/raycast_sectors.scan_poses_sectors_multi``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from .segments import extract_segments, _FAR

_SUB = 8  # capacity quantum of each orientation block (JAX layout parity)


def _align(n: int, q: int = _SUB) -> int:
    return max(q, ((n + q - 1) // q) * q)


@dataclasses.dataclass(frozen=True)
class SectorSegmentMap:
    """Per-(tile, sector) culled segment lists (exact-boundary geometry).

    ``table``: (L, 4, K) float32, L = tiles * ns — rows [p, lo, hi,
    is_vertical]; each list is a V block of ``kv_sec`` slots then an H block
    of ``K - kv_sec`` slots, each padded with never-hit sentinels
    ``[_FAR, 1, -1]``.
    ``meta``: (L, 3) int32 — [n_v, kv_sec, kv_sec + n_h]: the real V slots
    are [0, n_v), the real H slots [kv_sec, kv_sec + n_h).
    """

    table: Any                       # (L, 4, K) float32
    meta: Any                        # (L, 3) int32
    n_segments: int
    ns: int = 16                     # angular sectors per full circle
    kv_sec: int = 0                  # V/H split inside each list
    block_half: float = 0.285        # max supported beam-block half-width
    tile_size: float = 0.0
    tiles_shape: Tuple[int, int] = (0, 0)
    tile_origin: Tuple[float, float] = (0.0, 0.0)
    extent: Tuple[float, float, float, float] = (-_FAR, _FAR, -_FAR, _FAR)
    rt: float = 0.0                  # tile half-diagonal + slack (meters)
    reach: float = 0.0               # max_range + rt (cull distance)

    @classmethod
    def from_numpy(cls, table, meta, device="cpu", **statics):
        """Build from host arrays (for example the JAX map's ``table`` and
        ``meta`` converted with ``np.asarray``) and the static fields."""
        table = np.array(table, np.float32, order="C")     # own, writable
        meta = np.array(meta, np.int32, order="C")
        if table.ndim != 3 or table.shape[1] != 4:
            raise ValueError(f"table must be (L, 4, K), got {table.shape}")
        if meta.shape != (table.shape[0], 3):
            raise ValueError(f"meta must be (L, 3), got {meta.shape}")
        statics = dict(statics)
        for key in ("tiles_shape", "tile_origin", "extent"):
            if key in statics:
                statics[key] = tuple(statics[key])
        return cls(table=torch.as_tensor(table, device=device),
                   meta=torch.as_tensor(meta, device=device), **statics)

    def to(self, device) -> "SectorSegmentMap":
        return dataclasses.replace(self, table=self.table.to(device),
                                   meta=self.meta.to(device))

    @property
    def device(self):
        return self.table.device


def _seg_endpoints(segs: np.ndarray):
    p, lo, hi, isv = segs[:, 0], segs[:, 1], segs[:, 2], segs[:, 3] > 0.5
    ax = np.where(isv, p, lo)
    ay = np.where(isv, lo, p)
    bx = np.where(isv, p, hi)
    by = np.where(isv, hi, p)
    return ax, ay, bx, by


def _membership(segs: np.ndarray, nr: int, nc: int, ns: int,
                tile_size: float, ox: float, oy: float, rt: float,
                reach: float, block_half: float) -> np.ndarray:
    """(T*NS, K) bool: conservative visibility of each segment from each
    (tile, sector) cull list — the module-doc proof obligation.

    Vectorized over (tiles, segments) in float32 (the 1e-3 rad safety
    epsilon in ``pad`` dwarfs f32 rounding, so the cover stays
    conservative).
    """
    wsec = 2.0 * np.pi / ns
    sec_starts = (np.arange(ns) * wsec).astype(np.float32)
    ax, ay, bx, by = _seg_endpoints(segs)
    f32 = lambda a: np.asarray(a, np.float32)
    ax, ay, bx, by = f32(ax), f32(ay), f32(bx), f32(by)
    cxs = f32(ox + (np.tile(np.arange(nc), nr) + 0.5) * tile_size)   # (T,)
    cys = f32(oy + (np.repeat(np.arange(nr), nc) + 0.5) * tile_size)
    p, slo, shi = f32(segs[:, 0]), f32(segs[:, 1]), f32(segs[:, 2])
    isv = segs[:, 3] > 0.5
    along = np.where(isv[None, :], cys[:, None], cxs[:, None])  # (T, K)
    perp = np.where(isv[None, :], cxs[:, None], cys[:, None])
    d_along = np.maximum(
        np.maximum(slo[None, :] - along, along - shi[None, :]), 0.0)
    d = np.hypot(d_along, np.abs(perp - p[None, :]))
    near = d <= reach
    th1 = np.arctan2(ay[None, :] - cys[:, None], ax[None, :] - cxs[:, None])
    th2 = np.arctan2(by[None, :] - cys[:, None], bx[None, :] - cxs[:, None])
    # short-way arc between endpoint directions (width < pi: the segment
    # lies on one side of any external viewpoint)
    diff = np.mod(th2 - th1, 2.0 * np.pi)
    flip = diff > np.pi
    arc_lo = np.where(flip, th2, th1)
    width = np.where(flip, 2.0 * np.pi - diff, diff)
    par = np.arcsin(np.minimum(1.0, rt / np.maximum(d, 1e-9)))
    pad = par + block_half + 1e-3
    full = (d <= rt) | (width + 2.0 * pad >= 2.0 * np.pi - wsec)
    lo_pad = arc_lo - pad
    span = width + 2.0 * pad
    # sector s = [s*wsec, (s+1)*wsec) intersects the padded arc iff its
    # start lands inside the arc (mod 2pi) or within wsec before it.
    # Looping s keeps peak memory at O(T*K) instead of O(T*K*NS) floats.
    memb = np.empty((ns, nr * nc, len(segs)), bool)
    for s in range(ns):
        rel = np.mod(sec_starts[s] - lo_pad, 2.0 * np.pi)
        memb[s] = ((rel <= span) | (rel >= 2.0 * np.pi - wsec) | full) & near
    return memb.transpose(1, 0, 2).reshape(nr * nc * ns, len(segs))


def add_segments(smap: SectorSegmentMap, new_segs: np.ndarray
                 ) -> SectorSegmentMap:
    """Append boundary segments (e.g. a rasterized obstacle's 4-segment
    box) into the cull lists' headroom slots: O(tiles x new segments) host
    geometry and one small device scatter, instead of a full rebuild. The
    table's shape is unchanged.

    Segments are only ever added, and a segment inside the occupied union
    is occluded by the union's own boundary, so first-hit ranges from
    free-space origins are exactly those of a full rebuild. The table is
    cloned before the write: ``smap`` (which the facade keeps as the
    pristine map for ``clear_obstacles``) is left as it was.

    Raises ValueError when a list's capacity would overflow; the caller
    then rebuilds the map.
    """
    new_segs = np.atleast_2d(np.asarray(new_segs, np.float64))
    nr, nc = smap.tiles_shape
    ox, oy = smap.tile_origin
    memb = _membership(new_segs, nr, nc, smap.ns, smap.tile_size, ox, oy,
                       smap.rt, smap.reach, smap.block_half)     # (L, n)
    meta = smap.meta.cpu().numpy()
    kv = smap.kv_sec
    k_tot = smap.table.shape[2]
    counts_v = meta[:, 0].copy()
    counts_h = (meta[:, 2] - meta[:, 1]).copy()
    lids, slots, rows = [], [], []
    for i, seg in enumerate(new_segs):
        lid = np.where(memb[:, i])[0]
        if len(lid) == 0:
            continue
        if seg[3] > 0.5:
            if (counts_v[lid] >= kv).any():
                raise ValueError(
                    "sector headroom exhausted (V); full rebuild needed")
            slot = counts_v[lid].copy()
            counts_v[lid] += 1
        else:
            if (counts_h[lid] >= k_tot - kv).any():
                raise ValueError(
                    "sector headroom exhausted (H); full rebuild needed")
            slot = kv + counts_h[lid]
            counts_h[lid] += 1
        lids.append(lid)
        slots.append(slot)
        rows.append(np.repeat(seg[None, :].astype(np.float32), len(lid), 0))
    table = smap.table.clone()
    if lids:
        dev = table.device
        table[torch.as_tensor(np.concatenate(lids), device=dev), :,
              torch.as_tensor(np.concatenate(slots), device=dev)] = \
            torch.as_tensor(np.concatenate(rows), device=dev)
    meta2 = np.stack([counts_v, np.full(len(meta), kv, counts_v.dtype),
                      kv + counts_h], axis=1).astype(np.int32)
    return dataclasses.replace(
        smap, table=table, meta=torch.as_tensor(meta2, device=smap.device),
        n_segments=smap.n_segments + len(new_segs))


def build_sector_map(occupancy: np.ndarray, resolution: float,
                     origin_xy=(0.0, 0.0), occupied_thresh: float = 0.5,
                     max_range: float = 10.0, tile_size: float = 2.0,
                     ns: int = 16, block_half: float = 0.285,
                     k_sec: int = 0, kvh=None, headroom: int = 0,
                     real_hw=None, device="cpu") -> SectorSegmentMap:
    """Compile the occupancy boundary into per-(tile, sector) cull lists
    on the host and put the tables on ``device``.

    Args as the JAX package's ``build_sector_map``: ``tile_size`` (meters),
    ``ns`` sectors per circle, ``block_half`` the widest beam-block
    half-width (radians) the map must cover, ``k_sec`` / ``kvh`` capacity
    overrides, ``headroom`` extra capacity per orientation, ``real_hw`` the
    unpadded grid shape.
    """
    segs = extract_segments(occupancy, resolution, origin_xy,
                            occupied_thresh)
    if len(segs) == 0:
        raise ValueError("map has no boundary segments")
    rh, rw = real_hw if real_hw is not None else occupancy.shape
    ox, oy = float(origin_xy[0]), float(origin_xy[1])
    extent = (ox, ox + rw * resolution, oy, oy + rh * resolution)

    h, w = occupancy.shape
    nc = int(np.ceil(w * resolution / tile_size))
    nr = int(np.ceil(h * resolution / tile_size))
    rt = tile_size * np.sqrt(2.0) / 2.0 + 2.0 * resolution
    reach = max_range + rt

    memb_flat = _membership(segs, nr, nc, ns, tile_size, ox, oy, rt,
                            reach, block_half)
    tnl = nr * nc * ns
    isv = segs[:, 3] > 0.5
    counts_v = (memb_flat & isv[None, :]).sum(axis=1)
    counts_h = (memb_flat & ~isv[None, :]).sum(axis=1)

    if kvh is not None:
        kv_sec, kh_sec = int(kvh[0]), int(kvh[1])
        if kv_sec % _SUB or kh_sec % _SUB:
            raise ValueError(f"kvh entries must be multiples of {_SUB}")
    else:
        kv_sec = _align(k_sec // 2 if k_sec > 0
                        else int(counts_v.max()) + headroom)
        kh_sec = _align(k_sec - k_sec // 2 if k_sec > 0
                        else int(counts_h.max()) + headroom)

    table = np.zeros((tnl, kv_sec + kh_sec, 4), np.float32)
    table[:, :, 0] = _FAR     # never-hit sentinel rows [_FAR, 1, -1]
    table[:, :, 1] = 1.0
    table[:, :, 2] = -1.0
    table[:, :kv_sec, 3] = 1.0
    for want_v, base, kp, counts in ((True, 0, kv_sec, counts_v),
                                     (False, kv_sec, kh_sec, counts_h)):
        if counts.max() > kp:
            raise ValueError(
                f"k_sec too small: a (tile, sector) list needs "
                f"{int(counts.max())} {'V' if want_v else 'H'} segments but "
                f"the block holds {kp}; raise k_sec or leave it 0 (auto) - "
                "silent truncation would punch invisible holes in walls")
        mo = memb_flat & (isv if want_v else ~isv)[None, :]
        # nonzero is row-major: entries of one list are consecutive and in
        # segs order, so the in-list slot is a per-group arange
        lid, kk = np.nonzero(mo)
        starts = np.zeros(tnl, np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        table[lid, base + (np.arange(len(lid)) - starts[lid])] = segs[kk]
    meta = np.stack([counts_v, np.full(tnl, kv_sec, counts_v.dtype),
                     kv_sec + counts_h], axis=1).astype(np.int32)

    return SectorSegmentMap.from_numpy(
        table.transpose(0, 2, 1), meta, device=device,
        n_segments=len(segs), ns=ns, kv_sec=kv_sec,
        block_half=float(block_half), tile_size=float(tile_size),
        tiles_shape=(nr, nc), tile_origin=(ox, oy), extent=extent,
        rt=float(rt), reach=float(reach))


@dataclasses.dataclass(frozen=True)
class StackedSectorMap:
    """M sector maps stacked for multitrack batched serving: one scan call
    over agents living on different maps (for example RL across a track
    distribution). Tables are padded to a common capacity and concatenated;
    the per-map tile-grid geometry rides in small per-map tensors gathered
    per agent (O(agents) scalar gathers beside the sweep).
    """

    table: Any        # (sum_m L_m, 4, K) float32, common capacity K
    meta: Any         # (sum_m L_m, 3) int32
    offsets: Any      # (M,) int32: row offset of each map's lists
    grids: Any        # (M, 4) float32: [nr, nc, tox, toy] per map
    extents: Any      # (M, 4) float32: [x0, x1, y0, y1] per map
    ns: int = 16
    kv_sec: int = 0
    block_half: float = 0.285
    tile_size: float = 0.0

    @classmethod
    def from_numpy(cls, table, meta, offsets, grids, extents, device="cpu",
                   **statics):
        """Build from host arrays (for example the JAX stack's leaves
        converted with ``np.asarray``) and the static fields."""
        table = np.array(table, np.float32, order="C")     # own, writable
        meta = np.array(meta, np.int32, order="C")
        if table.ndim != 3 or table.shape[1] != 4:
            raise ValueError(f"table must be (L, 4, K), got {table.shape}")
        if meta.shape != (table.shape[0], 3):
            raise ValueError(f"meta must be (L, 3), got {meta.shape}")
        own = lambda a, dt: torch.as_tensor(np.array(a, dt, order="C"),
                                            device=device)
        return cls(table=torch.as_tensor(table, device=device),
                   meta=torch.as_tensor(meta, device=device),
                   offsets=own(offsets, np.int32),
                   grids=own(grids, np.float32),
                   extents=own(extents, np.float32), **statics)

    def to(self, device) -> "StackedSectorMap":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device)
                     for f in ("table", "meta", "offsets", "grids",
                               "extents")})

    @property
    def device(self):
        return self.table.device


def stack_sector_maps(maps) -> StackedSectorMap:
    """Stack sector maps (same ns/tile_size/block_half; capacities are
    re-padded to the common maximum) for ``scan_poses_sectors_multi``. The
    stack lands on the maps' device. The common capacity K must stay
    <= 4096: the list kernel stages a list's [p, lo, hi] rows in 48 KB of
    shared memory (``ops/sweeps``)."""
    m0 = maps[0]
    for m in maps:
        if (m.ns != m0.ns or m.tile_size != m0.tile_size
                or m.block_half != m0.block_half):
            raise ValueError("stacked maps must share ns/tile_size/"
                             "block_half (rebuild with common settings)")
        if m.device != m0.device:
            raise ValueError("stacked maps must share a device; got "
                             f"{m0.device} and {m.device}")
    kv = max(m.kv_sec for m in maps)
    kh = max(m.table.shape[2] - m.kv_sec for m in maps)
    tables, metas, offsets, grids, extents = [], [], [], [], []
    row = 0
    for m in maps:
        t = m.table.cpu().numpy()                 # (L, 4, K_m)
        l_m, _, _ = t.shape
        kv_m = m.kv_sec
        kh_m = t.shape[2] - kv_m
        out = np.zeros((l_m, 4, kv + kh), np.float32)
        out[:, 0, :] = _FAR                       # never-hit sentinels
        out[:, 1, :] = 1.0
        out[:, 2, :] = -1.0
        out[:, 3, :kv] = 1.0
        out[:, :, :kv_m] = t[:, :, :kv_m]
        out[:, :, kv:kv + kh_m] = t[:, :, kv_m:]
        meta = m.meta.cpu().numpy().copy()        # [n_v, h_lo, h_end]
        n_h = meta[:, 2] - meta[:, 1]
        meta[:, 1] = kv
        meta[:, 2] = kv + n_h
        tables.append(out)
        metas.append(meta)
        offsets.append(row)
        row += l_m
        nr, nc = m.tiles_shape
        grids.append((nr, nc, m.tile_origin[0], m.tile_origin[1]))
        extents.append(m.extent)
    return StackedSectorMap.from_numpy(
        np.concatenate(tables, axis=0), np.concatenate(metas, axis=0),
        offsets, grids, extents, device=m0.device, ns=m0.ns, kv_sec=kv,
        block_half=m0.block_half, tile_size=m0.tile_size)
