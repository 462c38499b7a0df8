"""CPU oracle raycaster (NumPy) — the frozen parity reference.

Copy of ``pyracecarsimulator_tpu/oracle/raycast.py``, so that a machine
without JAX (the GPU machine of ``chip_smoke.py``) holds the port's EDF
march to the reference algorithm. One change: ``scan_batch`` always runs
the per-ray Python loop. The JAX package's version first tries its native
C++ library, and loading that library goes through the JAX package.

This implements, exactly and readably, the reference scan algorithm from
SURVEY.md §3.3 (lineage ``ScanSimulator2D::scan`` / ``trace_ray``):

    for each beam i:
        theta_i = theta - fov/2 + i * fov/(num_beams-1)
        (cos, sin) via the theta-discretization table (or exact trig)
        sphere-trace: while d = edf[cell(x, y)] > eps and in-map and
                      total < max_range:  x += d cos; y += d sin; total += d
        ranges[i] = clamp(total, max_range) (+ Gaussian noise if enabled)

Because the reference mount was empty (SURVEY.md provenance note), this
oracle *is* the authoritative "reference CPU raycaster" for every allclose
gate in BASELINE.md. It is deliberately loop-based and dependency-free so it
can be audited line-by-line against the published upstream algorithm.

A ``bilinear`` interpolation mode is added (no reference equivalent) as the
smooth-sampling twin used to validate pose/map gradients by finite
differences; ``nearest`` is exact reference semantics.
"""

from __future__ import annotations

import numpy as np


def beam_angles(num_beams: int, fov: float) -> np.ndarray:
    """Beam angle offsets relative to heading: [-fov/2, +fov/2] inclusive."""
    return np.linspace(-fov / 2.0, fov / 2.0, num_beams).astype(np.float64)


def theta_table(theta_discretization: int):
    """Reference theta-bucket trig tables over [0, 2pi)."""
    idx = np.arange(theta_discretization)
    ang = idx * (2.0 * np.pi / theta_discretization)
    return np.cos(ang), np.sin(ang)


def _sample_nearest(edf, gx, gy):
    h, w = edf.shape
    ix, iy = int(gx), int(gy)
    if ix < 0 or iy < 0 or ix >= w or iy >= h:
        return None  # out of map
    return edf[iy, ix]


def _sample_bilinear(edf, gx, gy):
    h, w = edf.shape
    # Cell-center convention: value at center of cell (i, j) is edf[i, j];
    # sample point in grid units measured from the map corner.
    xs = gx - 0.5
    ys = gy - 0.5
    if gx < 0 or gy < 0 or gx >= w or gy >= h:
        return None
    xs = min(max(xs, 0.0), w - 1.000001)
    ys = min(max(ys, 0.0), h - 1.000001)
    x0, y0 = int(xs), int(ys)
    fx, fy = xs - x0, ys - y0
    f00 = edf[y0, x0]
    f01 = edf[y0, x0 + 1]
    f10 = edf[y0 + 1, x0]
    f11 = edf[y0 + 1, x0 + 1]
    return (f00 * (1 - fx) + f01 * fx) * (1 - fy) + \
           (f10 * (1 - fx) + f11 * fx) * fy


def trace_ray(edf: np.ndarray, resolution: float, origin_xy,
              x: float, y: float, cos_t: float, sin_t: float,
              max_range: float, eps: float, max_iters: int = 1000,
              interp: str = "nearest", bounds_hw=None) -> float:
    """March one ray; returns range in meters, clamped to max_range.

    Mirrors reference ``trace_ray`` (SURVEY.md §3.3): step by the EDF value
    until it drops below eps (hit), the ray leaves the map, or range budget
    is exhausted.
    """
    sample = _sample_nearest if interp == "nearest" else _sample_bilinear
    h, w = bounds_hw if bounds_hw is not None else edf.shape
    ox, oy = origin_xy
    total = 0.0
    px, py = x, y
    for _ in range(max_iters):
        gx = (px - ox) / resolution
        gy = (py - oy) / resolution
        if gx < 0 or gy < 0 or gx >= w or gy >= h:
            return max_range          # left the (real) map
        d = sample(edf, gx, gy)
        if d is None:
            return max_range          # left the map -> max-range clamp
        if d <= eps:
            break                     # hit
        if total >= max_range:
            break                     # range budget exhausted
        px += d * cos_t
        py += d * sin_t
        total += d
    return min(total, max_range)


def scan(edf: np.ndarray, resolution: float, origin_xy,
         pose, num_beams: int = 1080, fov: float = 4.712388980384690,
         max_range: float = 10.0, eps: float = 0.0001,
         theta_discretization: int | None = None,
         max_iters: int = 1000, interp: str = "nearest",
         std_dev: float = 0.0, rng: np.random.RandomState | None = None,
         bounds_hw=None) -> np.ndarray:
    """Full scan from pose (x, y, theta). Returns (num_beams,) ranges [m]."""
    x, y, theta = float(pose[0]), float(pose[1]), float(pose[2])
    offs = beam_angles(num_beams, fov)
    ranges = np.empty(num_beams, dtype=np.float64)
    if theta_discretization:
        cos_tab, sin_tab = theta_table(theta_discretization)
        two_pi = 2.0 * np.pi
        for i, off in enumerate(offs):
            a = (theta + off) % two_pi
            idx = int(a / two_pi * theta_discretization) % theta_discretization
            ranges[i] = trace_ray(edf, resolution, origin_xy, x, y,
                                  cos_tab[idx], sin_tab[idx],
                                  max_range, eps, max_iters, interp,
                                  bounds_hw)
    else:
        for i, off in enumerate(offs):
            a = theta + off
            ranges[i] = trace_ray(edf, resolution, origin_xy, x, y,
                                  np.cos(a), np.sin(a),
                                  max_range, eps, max_iters, interp,
                                  bounds_hw)
    if std_dev > 0.0:
        rng = rng or np.random.RandomState(0)
        ranges = ranges + rng.normal(0.0, std_dev, size=num_beams)
    return ranges.astype(np.float32)


def scan_batch(edf: np.ndarray, resolution: float, origin_xy, poses,
               num_beams: int = 1080, fov: float = 4.712388980384690,
               max_range: float = 10.0, eps: float = 0.0001,
               max_iters: int = 2000, bounds_hw=None) -> np.ndarray:
    """Batched noiseless oracle scans by per-ray ``trace_ray``. poses:
    (N, 3). Returns (N, num_beams).
    """
    poses = np.atleast_2d(np.asarray(poses, np.float64))
    offs = beam_angles(num_beams, fov)
    ang = poses[:, 2:3] + offs[None, :]
    xs = np.broadcast_to(poses[:, 0:1], ang.shape).ravel()
    ys = np.broadcast_to(poses[:, 1:2], ang.shape).ravel()
    cts, sts = np.cos(ang).ravel(), np.sin(ang).ravel()
    bounds = bounds_hw if bounds_hw is not None else edf.shape
    flat = np.array([trace_ray(edf, resolution, origin_xy, xs[i], ys[i],
                               cts[i], sts[i], max_range, eps, max_iters,
                               bounds_hw=bounds)
                     for i in range(len(xs))])
    return flat.reshape(len(poses), num_beams).astype(np.float32)
