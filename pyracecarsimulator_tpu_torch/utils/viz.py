"""Headless visualization: maps, scans, trajectories -> PNG.

A copy of ``pyracecarsimulator_tpu/utils/viz.py`` (plain NumPy and
matplotlib) that also takes tensors, on any device: the reference lineage
visualized through RViz, a headless run renders matplotlib figures to
files.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _host(a):
    """A tensor (any device) or array-like as a host NumPy array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def render(track, poses=None, scans=None, trajectories=None,
           path: str = "sim.png", dpi: int = 120,
           fov: float = 4.712388980384690):
    """Render the map with optional poses, scan fans, and trajectories.

    Args:
      track: maps.loader.TrackMap.
      poses: (N, 3) array of (x, y, theta) to draw as arrows.
      scans: (N, B) ranges matching ``poses`` — drawn as point fans.
      trajectories: (T, N, 3) or (T, 3) pose history, drawn as lines.
      path: output PNG path.

    Returns the path.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    occ = _host(track.occupancy)[: track.height, : track.width]
    (x0, x1), (y0, y1) = track.world_extent()
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(occ, origin="lower", extent=(x0, x1, y0, y1),
              cmap="gray_r", vmin=0, vmax=1.5, interpolation="nearest")

    if trajectories is not None:
        tr = _host(trajectories)
        if tr.ndim == 2:
            tr = tr[:, None, :]
        for i in range(tr.shape[1]):
            ax.plot(tr[:, i, 0], tr[:, i, 1], lw=0.8, alpha=0.7)

    if poses is not None:
        poses = np.atleast_2d(_host(poses))
        if scans is not None:
            scans = np.atleast_2d(_host(scans))
            b = scans.shape[1]
            offs = np.linspace(-fov / 2, fov / 2, b)
            for p, r in zip(poses, scans):
                ang = p[2] + offs
                ax.plot(p[0] + r * np.cos(ang), p[1] + r * np.sin(ang),
                        ".", ms=1.0, alpha=0.5)
        ax.quiver(poses[:, 0], poses[:, 1],
                  np.cos(poses[:, 2]), np.sin(poses[:, 2]),
                  color="tab:red", scale=30, width=0.004)

    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(track.name)
    fig.tight_layout()
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
    return path
