"""Euclidean distance transform (Felzenszwalb–Huttenlocher), on the host.

Counterpart of ``pyracecarsimulator_tpu/maps/edt.py``. The EDT runs once
per map load and once per obstacle edit, on the host. ``edt`` takes the
native library's ``rc_edt`` (``_native/loader.py``, built at first use)
and, on a machine without a C++ compiler, the NumPy body ``edt_numpy``:
the same two-pass algorithm in float64, a Python loop over the columns.
"""

from __future__ import annotations

import numpy as np

from .._native import loader as _native

_INF = 1e20


def _edt_1d_sq(f: np.ndarray) -> np.ndarray:
    """Exact 1D squared distance transform of sampled function f (batched).

    f: (B, n) array; returns (B, n). Lower-envelope-of-parabolas algorithm,
    a Python loop over n vectorized over the batch.
    """
    B, n = f.shape
    d = np.empty_like(f)
    v = np.zeros((B, n), dtype=np.int64)       # parabola locations
    z = np.empty((B, n + 1), dtype=f.dtype)    # envelope boundaries
    k = np.zeros(B, dtype=np.int64)            # rightmost parabola index
    z[:, 0] = -_INF
    z[:, 1] = _INF
    rows = np.arange(B)

    for q in range(1, n):
        fq = f[:, q]
        while True:
            vk = v[rows, k]
            s = ((fq + q * q) - (f[rows, vk] + vk * vk)) / (2.0 * q - 2.0 * vk)
            mask = (s <= z[rows, k]) & (k > 0)
            if not mask.any():
                break
            k[mask] -= 1
        k += 1
        v[rows, k] = q
        z[rows, k] = s
        z[rows, k + 1] = _INF

    kq = np.zeros(B, dtype=np.int64)
    for q in range(n):
        while True:
            mask = z[rows, kq + 1] < q
            if not mask.any():
                break
            kq[mask] += 1
        vk = v[rows, kq]
        d[:, q] = (q - vk) ** 2 + f[rows, vk]
    return d


def edt_numpy(occupied: np.ndarray) -> np.ndarray:
    """Exact euclidean distance (in cells) to the nearest True cell.

    occupied: (H, W) bool. Returns (H, W) float32 distances; cells with no
    occupied cell anywhere get a large finite sentinel (sqrt(_INF)).
    """
    f = np.where(occupied, 0.0, _INF).astype(np.float64)
    d = _edt_1d_sq(f)          # along rows (x)
    d = _edt_1d_sq(d.T).T      # along columns (y)
    return np.sqrt(d).astype(np.float32)


def edt(occupied: np.ndarray, resolution: float = 1.0) -> np.ndarray:
    """Euclidean distance field in meters. Native body first."""
    occupied = np.ascontiguousarray(occupied, dtype=bool)
    out = _native.edt(occupied)
    if out is not None:
        return (out * np.float32(resolution)).astype(np.float32)
    return edt_numpy(occupied) * np.float32(resolution)
