"""Occupancy-boundary segment extraction (host NumPy).

Counterpart of the extraction half of
``pyracecarsimulator_tpu/maps/segments.py``: the boundary of the occupied
cell union as merged axis-aligned segments, which the sector tables
(``maps/sectors.py``) cull per (tile, angular sector). The dense
``segments`` backend's map layout is not ported yet.

Segment rows are ``[p, lo, hi, is_vertical]``:
vertical ``x = p, y in [lo, hi]``; horizontal ``y = p, x in [lo, hi]``.
"""

from __future__ import annotations

import numpy as np

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
