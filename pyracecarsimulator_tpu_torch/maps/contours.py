"""Boundary contour extraction, polyline simplification and the
simplified-geometry map ("segments_simplified").

Counterpart of ``pyracecarsimulator_tpu/maps/contours.py``. Rasterized
curves explode into thousands of 1-cell staircase segments; tracing the
occupied boundary into closed polylines and simplifying them with
Douglas-Peucker at ``tol_cells`` collapses them into a few hundred general
(any-angle) segments, at a geometric error bounded by the tolerance.

The host code is the JAX module's NumPy, unchanged, so the segment tables
equal its build bit for bit; ``GeneralSegmentMap`` holds them as tensors
on a device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch


def _boundary_edges(occ: np.ndarray):
    """Directed boundary edges (occupied region kept on the LEFT of travel
    direction), as a dict: start vertex -> list of end vertices. Vertices
    are integer grid corners (x, y)."""
    h, w = occ.shape
    edges = {}

    def add(a, b):
        edges.setdefault(a, []).append(b)

    occ_p = np.zeros((h + 2, w + 2), dtype=bool)
    occ_p[1:-1, 1:-1] = occ
    # For each cell boundary where occupancy changes, emit a directed edge.
    # Vertical edge between (i,j-1) and (i,j) at x=j, spans y=i..i+1.
    change_x = occ_p[1:-1, 1:] != occ_p[1:-1, :-1]     # (h, w+1)
    for i, j in zip(*np.nonzero(change_x)):
        right_occ = occ_p[i + 1, j + 1]                # cell (i, j)
        if right_occ:   # occupied on +x side: travel -y keeps it on left?
            add((j, i + 1), (j, i))
        else:
            add((j, i), (j, i + 1))
    change_y = occ_p[1:, 1:-1] != occ_p[:-1, 1:-1]     # (h+1, w)
    for i, j in zip(*np.nonzero(change_y)):
        top_occ = occ_p[i + 1, j + 1]                  # cell (i, j)
        if top_occ:     # occupied on +y side
            add((j, i), (j + 1, i))
        else:
            add((j + 1, i), (j, i))
    return edges


def trace_contours(occ: np.ndarray) -> List[np.ndarray]:
    """Closed boundary loops as (N, 2) float arrays of grid-corner (x, y).

    Orientation: occupied region on the left of the travel direction, so
    outward normals are consistent. Degree-4 (checkerboard) vertices are
    resolved by preferring the sharpest left turn, which keeps loops
    simple.
    """
    edges = _boundary_edges(occ)
    loops = []
    while edges:
        start = next(iter(edges))
        loop = [start]
        cur = start
        prev_dir = None
        while True:
            outs = edges.get(cur)
            if not outs:
                break
            if len(outs) == 1 or prev_dir is None:
                nxt = outs[0]
            else:
                # prefer the sharpest left turn relative to prev_dir
                def turn(o):
                    d = (o[0] - cur[0], o[1] - cur[1])
                    cross = prev_dir[0] * d[1] - prev_dir[1] * d[0]
                    dot = prev_dir[0] * d[0] + prev_dir[1] * d[1]
                    return np.arctan2(cross, dot)
                nxt = max(outs, key=turn)
            outs.remove(nxt)
            if not outs:
                del edges[cur]
            prev_dir = (nxt[0] - cur[0], nxt[1] - cur[1])
            cur = nxt
            if cur == start:
                break
            loop.append(cur)
        if len(loop) >= 4:
            loops.append(np.asarray(loop, np.float64))
    return loops


def _dp_simplify(points: np.ndarray, tol: float) -> np.ndarray:
    """Iterative Douglas-Peucker on an open polyline (N, 2)."""
    n = len(points)
    keep = np.zeros(n, dtype=bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    while stack:
        a, b = stack.pop()
        if b <= a + 1:
            continue
        seg = points[b] - points[a]
        L = np.hypot(*seg)
        pts = points[a + 1:b]
        if L == 0:
            d = np.hypot(*(pts - points[a]).T)
        else:
            rel = pts - points[a]
            d = np.abs(seg[0] / L * rel[:, 1] - seg[1] / L * rel[:, 0])
        i = int(np.argmax(d))
        if d[i] > tol:
            m = a + 1 + i
            keep[m] = True
            stack.append((a, m))
            stack.append((m, b))
    return points[keep]


def simplify_loop(loop: np.ndarray, tol: float) -> np.ndarray:
    """DP-simplify a closed loop; anchors at the two farthest-apart corner
    candidates to avoid degenerate splits."""
    if len(loop) < 8:
        return loop
    # anchor at index 0 and the vertex farthest from it
    d = np.hypot(*(loop - loop[0]).T)
    k = int(np.argmax(d))
    a = _dp_simplify(loop[: k + 1], tol)
    b = _dp_simplify(np.concatenate([loop[k:], loop[:1]]), tol)
    return np.concatenate([a[:-1], b[:-1]])


def contours_to_general_segments(loops: List[np.ndarray], resolution: float,
                                 origin_xy, tol_cells: float = 0.0
                                 ) -> np.ndarray:
    """Loops (grid units) -> general segment params in world coords.

    Returns (K, 6) float64 rows [p0x, p0y, ex, ey, length, pad] with
    (ex, ey) the unit direction; the normal is (-ey, ex).
    """
    ox, oy = float(origin_xy[0]), float(origin_xy[1])
    rows = []
    for loop in loops:
        pts = simplify_loop(loop, tol_cells) if tol_cells > 0 else loop
        closed = np.concatenate([pts, pts[:1]], axis=0)
        for a, b in zip(closed[:-1], closed[1:]):
            d = b - a
            L = float(np.hypot(*d))
            if L == 0.0:
                continue
            rows.append((ox + a[0] * resolution, oy + a[1] * resolution,
                         d[0] / L, d[1] / L, L * resolution, 0.0))
    if not rows:
        return np.zeros((0, 6), np.float64)
    return np.asarray(rows, np.float64)


def extract_general_segments(occ: np.ndarray, resolution: float, origin_xy,
                             tol_cells: float = 1.0) -> np.ndarray:
    """occupancy -> simplified general segments (world coords)."""
    return contours_to_general_segments(
        trace_contours(np.asarray(occ) >= 0.5), resolution, origin_xy,
        tol_cells)


def pad_general_segments(segs: np.ndarray, align: int = 128) -> np.ndarray:
    """Pad with zero-length sentinels (s-interval [0, L]=[0,0] with a far
    p0 and degenerate direction can still hit at s=0; instead use L=-1 so
    the 0<=s<=L test can never pass)."""
    k = len(segs)
    kp = max(align, ((k + align - 1) // align) * align)
    out = np.zeros((kp, 6), np.float64)
    out[:, 2] = 1.0     # unit direction
    out[:, 4] = -1.0    # negative length -> never valid
    out[:k] = segs
    return out


# ---------------------------------------------------------------------------
# Device bundle + tile culling for general segments


@dataclasses.dataclass(frozen=True)
class GeneralSegmentMap:
    """Simplified-geometry bundle: ``params`` (6, K) float32 [p0x, p0y,
    ex, ey, L, pad]; optional per-tile culled ``tiles`` (T, 6, K_tile).
    Metadata as in ``segments.SegmentMap``."""

    params: Any
    n_segments: int
    tol_cells: float
    tiles: Any = None
    tile_size: float = 0.0
    tiles_shape: Tuple[int, int] = (0, 0)
    tile_origin: Tuple[float, float] = (0.0, 0.0)
    extent: Tuple[float, float, float, float] = (-1e30, 1e30, -1e30, 1e30)

    @classmethod
    def from_numpy(cls, params, tiles=None, device="cpu", **statics):
        """Build from host arrays (for example the JAX map's leaves
        converted with ``np.asarray``) and the static fields."""
        params = np.array(params, np.float32, order="C")   # own, writable
        if params.ndim != 2 or params.shape[0] != 6:
            raise ValueError(f"params must be (6, K), got {params.shape}")
        if tiles is not None:
            tiles = np.array(tiles, np.float32, order="C")
            if tiles.ndim != 3 or tiles.shape[1] != 6:
                raise ValueError(f"tiles must be (T, 6, K), got "
                                 f"{tiles.shape}")
            tiles = torch.as_tensor(tiles, device=device)
        statics = dict(statics)
        for key in ("tiles_shape", "tile_origin", "extent"):
            if key in statics:
                statics[key] = tuple(statics[key])
        return cls(params=torch.as_tensor(params, device=device),
                   tiles=tiles, **statics)

    def to(self, device) -> "GeneralSegmentMap":
        return dataclasses.replace(
            self, params=self.params.to(device),
            tiles=None if self.tiles is None else self.tiles.to(device))

    @property
    def device(self):
        return self.params.device


def _gseg_point_distance(segs: np.ndarray, cx: float, cy: float):
    """Distance from a point to each general segment (K, 6)."""
    p0 = segs[:, 0:2]
    e = segs[:, 2:4]
    L = segs[:, 4]
    d = np.stack([cx - p0[:, 0], cy - p0[:, 1]], axis=1)
    s = np.clip(d[:, 0] * e[:, 0] + d[:, 1] * e[:, 1], 0.0, np.maximum(L, 0))
    px = p0[:, 0] + s * e[:, 0]
    py = p0[:, 1] + s * e[:, 1]
    return np.hypot(cx - px, cy - py)


def build_general_segment_map(occupancy: np.ndarray, resolution: float,
                              origin_xy=(0.0, 0.0), tol_cells: float = 1.0,
                              max_range: float = 10.0,
                              tile_size: float = 0.0, k_tile: int = 0,
                              real_hw=None,
                              device="cpu") -> GeneralSegmentMap:
    """Contour-simplified twin of ``segments.build_segment_map``: the host
    compile of the JAX package, then the tables on ``device``. With
    ``tile_size > 0`` each square tile keeps the segments within
    ``max_range`` + half its diagonal + one cell of its center; tiles are
    dropped when a tile list is as wide as the full set."""
    segs = extract_general_segments(occupancy, resolution, origin_xy,
                                    tol_cells)
    params = pad_general_segments(segs).T
    rh, rw = real_hw if real_hw is not None else occupancy.shape
    ox0, oy0 = float(origin_xy[0]), float(origin_xy[1])
    extent = (ox0, ox0 + rw * resolution, oy0, oy0 + rh * resolution)

    tiles = None
    tiles_shape = (0, 0)
    tile_origin = (0.0, 0.0)
    if tile_size > 0.0 and len(segs):
        h, w = occupancy.shape
        nc = int(np.ceil(w * resolution / tile_size))
        nr = int(np.ceil(h * resolution / tile_size))
        reach = max_range + tile_size * np.sqrt(2) / 2 + resolution
        sel = []
        k_needed = 0
        for r in range(nr):
            for c in range(nc):
                cx = ox0 + (c + 0.5) * tile_size
                cy = oy0 + (r + 0.5) * tile_size
                idx = np.where(_gseg_point_distance(segs, cx, cy)
                               <= reach)[0]
                sel.append(idx)
                k_needed = max(k_needed, len(idx))
        if k_tile <= 0:
            k_tile = max(128, ((k_needed + 127) // 128) * 128)
        blocks = []
        for idx in sel:
            if len(idx) > k_tile:
                raise ValueError(
                    f"k_tile too small: a tile needs {len(idx)} segments "
                    f"but the block holds {k_tile}; raise k_tile or leave "
                    "it 0 (auto-size)")
            blk = np.zeros((k_tile, 6), np.float64)
            blk[:, 2] = 1.0
            blk[:, 4] = -1.0      # never-valid sentinel
            blk[: len(idx)] = segs[idx]
            blocks.append(blk.T)
        if k_tile < params.shape[1]:
            tiles = np.stack(blocks)
            tiles_shape = (nr, nc)
            tile_origin = (ox0, oy0)
        # else: no culling benefit, so no per-agent tile gather

    return GeneralSegmentMap.from_numpy(
        params, tiles, device=device, n_segments=len(segs),
        tol_cells=float(tol_cells), tile_size=float(tile_size),
        tiles_shape=tiles_shape, tile_origin=tile_origin, extent=extent)
