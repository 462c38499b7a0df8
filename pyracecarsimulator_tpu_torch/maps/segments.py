"""Occupancy-boundary segments: extraction and the dense backend's map.

Counterpart of ``pyracecarsimulator_tpu/maps/segments.py``. The boundary of
the occupied cell union is a set of merged axis-aligned segments. The
sector tables (``maps/sectors.py``) cull them per (tile, angular sector);
the dense ``segments`` backend sweeps them all (``SegmentMap.params``) or,
on large maps, per map tile (``SegmentMap.tiles``). The host compile is
the JAX module's NumPy body, so the tables equal its build bit for bit.

Segment rows are ``[p, lo, hi, is_vertical]``:
vertical ``x = p, y in [lo, hi]``; horizontal ``y = p, x in [lo, hi]``.

The 128-slot padding of every block is the JAX layout (TPU lanes). The
port keeps it so that the tables, and the ``sweep_meta`` bounds that index
them, are the same; its sweeps visit only the real slots those bounds
name, so the padding costs memory and no work.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from ..config import resolve_device

_LANE = 128

# Sentinel plane for padding slots: far away so they never intersect within
# any max_range (the hit test's product form accepts a reversed interval, so
# the plane, not the interval, is what makes a slot never-hit).
_FAR = 1.0e9


def _merge_runs(mask_2d: np.ndarray):
    """Given a boolean edge mask (rows = fixed index, cols = run axis),
    return (fixed_idx, start, stop) arrays of maximal consecutive runs."""
    h, w = mask_2d.shape
    padded = np.zeros((h, w + 2), dtype=bool)
    padded[:, 1:-1] = mask_2d
    d = np.diff(padded.astype(np.int8), axis=1)
    fi_s, starts = np.where(d == 1)
    fi_e, stops = np.where(d == -1)
    # starts/stops are aligned per row by construction
    return fi_s, starts, stops


def extract_segments(occupancy: np.ndarray, resolution: float,
                     origin_xy=(0.0, 0.0), occupied_thresh: float = 0.5
                     ) -> np.ndarray:
    """Extract merged axis-aligned boundary segments in world coordinates.

    occupancy: (H, W) array; cell (i, j) spans world
    [ox + j*res, ox + (j+1)*res] x [oy + i*res, oy + (i+1)*res].

    Returns (K, 4) float64: [p, lo, hi, is_vertical]; every segment has a
    free cell on one side and an occupied cell (or nothing, at array edges)
    on the other.
    """
    occ = np.asarray(occupancy) >= occupied_thresh
    h, w = occ.shape
    ox, oy = float(origin_xy[0]), float(origin_xy[1])
    segs = []

    # Vertical edges between columns j-1 and j (boundary at x = j),
    # outer array edges included; runs go along y, hence the transpose.
    occ_x = np.diff(
        np.concatenate([np.zeros((h, 1), bool), occ,
                        np.zeros((h, 1), bool)], axis=1), axis=1) != 0
    fi, st, sp = _merge_runs(occ_x.T)   # fi = x boundary index, runs over y
    for x_idx, y0, y1 in zip(fi, st, sp):
        segs.append((ox + x_idx * resolution,
                     oy + y0 * resolution,
                     oy + y1 * resolution, 1.0))

    # Horizontal edges between rows i-1 and i (boundary at y = i).
    occ_y = np.diff(
        np.concatenate([np.zeros((1, w), bool), occ,
                        np.zeros((1, w), bool)], axis=0), axis=0) != 0
    fi, st, sp = _merge_runs(occ_y)     # fi = y boundary index, runs over x
    for y_idx, x0, x1 in zip(fi, st, sp):
        segs.append((oy + y_idx * resolution,
                     ox + x0 * resolution,
                     ox + x1 * resolution, 0.0))

    if not segs:
        return np.zeros((0, 4), np.float64)
    return np.asarray(segs, np.float64)


def pad_segments(segs: np.ndarray, align: int = _LANE) -> np.ndarray:
    """Pad the segment count to a multiple of ``align`` (at least one
    block) with never-hit sentinels ``[_FAR, 1, -1, 1]``."""
    k = len(segs)
    kp = max(align, ((k + align - 1) // align) * align)
    out = np.zeros((kp, 4), np.float64)
    out[:, 0] = _FAR
    out[:, 1] = 1.0    # lo
    out[:, 2] = -1.0   # hi  -> empty interval
    out[:, 3] = 1.0
    out[:k] = segs
    return out


def split_pad_segments(segs: np.ndarray, align: int = _LANE):
    """Verticals first, each group padded to a multiple of ``align``.
    Returns (params (4, KV+KH), KV, KH)."""
    v = segs[segs[:, 3] > 0.5] if len(segs) else segs
    h = segs[segs[:, 3] <= 0.5] if len(segs) else segs
    pv = pad_segments(v, align)
    ph = pad_segments(h, align)
    ph[:, 3] = 0.0
    return np.concatenate([pv, ph], axis=0).T, len(pv), len(ph)


@dataclasses.dataclass(frozen=True)
class SegmentMap:
    """Compiled geometry of the dense raycast backend.

    ``params``: (4, K) float32, rows [p, lo, hi, is_vertical].
    ``sweep_meta``: (3,) int32 [v_hi, h_lo, h_end]: the real vertical
    slots are [0, v_hi), the real horizontal ones [h_lo, h_end). Split
    layout (``kv > 0``): V block [0, kv), H block [kv, K); mixed layout
    (``kv == 0``): the extraction order, V then H then sentinels.
    ``tiles``: None, or (T, 4, K_tile) float32 per-tile cull lists with
    ``tile_sweep_meta`` (T, 3) int32 bounds of the same convention inside
    each list (``kv_tile`` is the V/H split of the split layout, 0 for
    mixed).
    """

    params: Any                      # (4, K) float32
    sweep_meta: Any                  # (3,) int32
    n_segments: int
    tiles: Any = None                # (T, 4, K_tile) float32
    tile_sweep_meta: Any = None      # (T, 3) int32
    tile_size: float = 0.0
    tiles_shape: Tuple[int, int] = (0, 0)
    tile_origin: Tuple[float, float] = (0.0, 0.0)
    extent: Tuple[float, float, float, float] = (-_FAR, _FAR, -_FAR, _FAR)
    kv: int = 0
    kv_tile: int = 0

    @classmethod
    def from_numpy(cls, params, sweep_meta, tiles=None,
                   tile_sweep_meta=None, device=None, **statics):
        """Build from host arrays (for example the JAX map's leaves
        converted with ``np.asarray``) and the static fields, on ``device``
        (``None``: the card, ``config.resolve_device``)."""
        device = resolve_device(device)
        params = np.array(params, np.float32, order="C")   # own, writable
        sweep_meta = np.array(sweep_meta, np.int32)
        if params.ndim != 2 or params.shape[0] != 4:
            raise ValueError(f"params must be (4, K), got {params.shape}")
        if sweep_meta.shape != (3,):
            raise ValueError(f"sweep_meta must be (3,), got "
                             f"{sweep_meta.shape}")
        if (tiles is None) != (tile_sweep_meta is None):
            raise ValueError("tiles and tile_sweep_meta come together")
        as_t = lambda a, dt: (None if a is None else torch.as_tensor(
            np.array(a, dt, order="C"), device=device))
        tiles, tile_sweep_meta = (as_t(tiles, np.float32),
                                  as_t(tile_sweep_meta, np.int32))
        if tiles is not None and (
                tiles.ndim != 3 or tiles.shape[1] != 4
                or tuple(tile_sweep_meta.shape) != (tiles.shape[0], 3)):
            raise ValueError(f"tiles must be (T, 4, K) and tile_sweep_meta "
                             f"(T, 3); got {tuple(tiles.shape)}, "
                             f"{tuple(tile_sweep_meta.shape)}")
        statics = dict(statics)
        for key in ("tiles_shape", "tile_origin", "extent"):
            if key in statics:
                statics[key] = tuple(statics[key])
        return cls(params=torch.as_tensor(params, device=device),
                   sweep_meta=torch.as_tensor(sweep_meta, device=device),
                   tiles=tiles, tile_sweep_meta=tile_sweep_meta, **statics)

    def to(self, device) -> "SegmentMap":
        mv = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self, params=mv(self.params), sweep_meta=mv(self.sweep_meta),
            tiles=mv(self.tiles), tile_sweep_meta=mv(self.tile_sweep_meta))

    @property
    def device(self):
        return self.params.device


def _segment_tile_distance(segs: np.ndarray, cx, cy) -> np.ndarray:
    """Distance from point (cx, cy) to each axis-aligned segment."""
    p, lo, hi, isv = segs[:, 0], segs[:, 1], segs[:, 2], segs[:, 3]
    along = np.where(isv > 0.5, cy, cx)
    perp = np.where(isv > 0.5, cx, cy)
    d_along = np.maximum(np.maximum(lo - along, along - hi), 0.0)
    d_perp = np.abs(perp - p)
    return np.hypot(d_along, d_perp)


def _pad_group(group: np.ndarray, kp: int) -> np.ndarray:
    if len(group) > kp:
        raise ValueError(
            f"k_tile too small: a tile needs {len(group)} segments but the "
            f"block holds {kp}; raise k_tile or leave it 0 (auto-size) - "
            "silent truncation would punch invisible holes in walls")
    block = np.zeros((kp, 4), np.float64)
    block[:, 0] = _FAR          # see pad_segments: product-form safety
    block[:, 1] = 1.0
    block[:, 2] = -1.0
    block[: len(group)] = group
    return block


def _tile_lists(segs, occupancy_shape, resolution, ox, oy, max_range,
                tile_size, k_tile):
    """Per-tile cull lists: (tiles (T, 4, K_tile), tile_sweep_meta (T, 3),
    (nr, nc), kv_tile)."""
    h, w = occupancy_shape
    nc = int(np.ceil(w * resolution / tile_size))
    nr = int(np.ceil(h * resolution / tile_size))
    reach = max_range + tile_size * np.sqrt(2) / 2 + resolution
    groups = []
    for r in range(nr):
        for c in range(nc):
            d = _segment_tile_distance(segs, ox + (c + 0.5) * tile_size,
                                       oy + (r + 0.5) * tile_size)
            sub = segs[np.where(d <= reach)[0]]
            groups.append((sub[sub[:, 3] > 0.5], sub[sub[:, 3] <= 0.5]))
    a = lambda n: max(_LANE, ((n + _LANE - 1) // _LANE) * _LANE)
    kv_t = a(max(len(v) for v, _ in groups))
    kh_t = a(max(len(h_) for _, h_ in groups))
    mixed_kt = a(max(len(v) + len(h_) for v, h_ in groups))
    if k_tile > 0:
        kv_t = kh_t = a(k_tile // 2)
    lists, tmeta = [], []
    if kv_t + kh_t <= 1.25 * mixed_kt:
        for v, h_ in groups:
            bv = _pad_group(v, kv_t)
            bv[:, 3] = 1.0
            bh = _pad_group(h_, kh_t)
            bh[:, 3] = 0.0
            lists.append(np.concatenate([bv, bh], axis=0).T)
            tmeta.append([len(v), kv_t, kv_t + len(h_)])
        kv_tile = kv_t
    else:
        for v, h_ in groups:
            lists.append(_pad_group(np.concatenate([v, h_], axis=0),
                                    mixed_kt).T)
            tmeta.append([len(v), len(v), len(v) + len(h_)])
        kv_tile = 0
    return (np.stack(lists).astype(np.float32), np.asarray(tmeta, np.int32),
            (nr, nc), kv_tile)


def build_segment_map(occupancy: np.ndarray, resolution: float,
                      origin_xy=(0.0, 0.0), occupied_thresh: float = 0.5,
                      max_range: float = 10.0, tile_size: float = 0.0,
                      k_tile: int = 0, real_hw=None,
                      device=None) -> SegmentMap:
    """Extract the boundary segments, lay them out for the dense sweep and
    (``tile_size > 0``) build per-tile cull lists: each square tile keeps
    the segments within ``max_range`` + half its diagonal + one cell of
    its center. Tiles are dropped when the widest list is as wide as the
    full set (culling would buy nothing). Puts the tables on ``device``
    (``None``: the card).
    """
    device = resolve_device(device)
    segs = extract_segments(occupancy, resolution, origin_xy,
                            occupied_thresh)
    n_vertical = int((segs[:, 3] > 0.5).sum()) if len(segs) else 0
    mixed_k = len(pad_segments(segs))
    padded_t, kv_, _ = split_pad_segments(segs)
    if padded_t.shape[1] <= 1.25 * mixed_k:
        params, kv = padded_t, kv_
        sweep_meta = [n_vertical, kv_, kv_ + (len(segs) - n_vertical)]
    else:
        params, kv = pad_segments(segs).T, 0
        # mixed layout keeps extraction order: V block, H block, sentinels
        sweep_meta = [n_vertical, n_vertical, len(segs)]
    rh, rw = real_hw if real_hw is not None else occupancy.shape
    ox, oy = float(origin_xy[0]), float(origin_xy[1])
    extent = (ox, ox + rw * resolution, oy, oy + rh * resolution)

    tiled = {}
    if tile_size > 0.0 and len(segs):
        tiles, tmeta, tiles_shape, kv_tile = _tile_lists(
            segs, occupancy.shape, resolution, ox, oy, max_range, tile_size,
            k_tile)
        # the origin stays when the tiles are dropped, as in the JAX build
        tiled = dict(tile_origin=(ox, oy))
        if tiles.shape[2] < params.shape[1]:
            tiled.update(tiles=tiles, tile_sweep_meta=tmeta,
                         tiles_shape=tiles_shape, kv_tile=kv_tile)
    return SegmentMap.from_numpy(
        params, sweep_meta, device=device, n_segments=len(segs),
        tile_size=float(tile_size), extent=extent, kv=kv, **tiled)


def raycast_segments_numpy(segs: np.ndarray, x, y, cos_t, sin_t,
                           max_range: float) -> np.ndarray:
    """Exact geometric oracle in float64: first-hit distance per ray over
    the (K, 4) segments ``[p, lo, hi, is_vertical]``; ray args broadcastable
    1D."""
    x = np.atleast_1d(np.asarray(x, np.float64))
    y, cos_t, sin_t = (np.broadcast_to(np.asarray(a, np.float64), x.shape)
                       for a in (y, cos_t, sin_t))
    p, lo, hi, isv = (segs[:, i] for i in range(4))
    isv = isv > 0.5
    o_perp = np.where(isv, x[:, None], y[:, None])
    o_along = np.where(isv, y[:, None], x[:, None])
    u_perp = np.where(isv, cos_t[:, None], sin_t[:, None])
    u_along = np.where(isv, sin_t[:, None], cos_t[:, None])
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (p[None, :] - o_perp) / u_perp
    a = o_along + t * u_along
    valid = (t >= 0.0) & (a >= lo[None, :]) & (a <= hi[None, :]) \
        & np.isfinite(t)
    t = np.where(valid, t, np.inf)
    return np.minimum(t.min(axis=1), max_range)
