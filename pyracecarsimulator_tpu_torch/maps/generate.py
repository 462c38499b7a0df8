"""Synthetic track generation (levine- and berlin-class test maps).

A copy of ``pyracecarsimulator_tpu/maps/generate.py`` (plain NumPy and
SciPy): the generators that made the bundled ``levine`` and ``berlin``
assets (PGM + ROS YAML). ``load_builtin`` never calls them (it raises when
an asset is missing); they serve users who want the assets in another
directory, and the tests, which hold them to the committed files.

* ``levine``  — rectangular corridor loop with pillars, 1300x1300 @ 0.05 m
  (Levine-like: axis-aligned hallways).
* ``berlin``  — smooth closed curvy circuit (berlin-like: varying curvature),
  1200x1200 @ 0.05 m.

Generation is deterministic (fixed seeds) so test expectations are stable.
"""

from __future__ import annotations

import os

import numpy as np


def _yaml_text(image: str, resolution: float, origin) -> str:
    return (
        f"image: {image}\n"
        f"resolution: {resolution}\n"
        f"origin: [{origin[0]}, {origin[1]}, 0.0]\n"
        "negate: 0\n"
        "occupied_thresh: 0.65\n"
        "free_thresh: 0.196\n"
    )


def generate_levine(h: int = 1300, w: int = 1300) -> np.ndarray:
    """Axis-aligned corridor loop with interior block + pillars.

    Returns (H, W) uint8 image, 254=free, 0=occupied, 205=unknown, with image
    row 0 at the TOP (ROS convention; the loader flips).
    """
    img = np.full((h, w), 205, dtype=np.uint8)          # outside: unknown
    # Outer free region (the building footprint)
    img[60:h - 60, 60:w - 60] = 0                        # walls
    img[80:h - 80, 80:w - 80] = 254                      # interior free space
    # Interior block leaves a corridor loop ~ 4 m wide (80 cells @ 5 cm)
    img[240:h - 240, 240:w - 240] = 0
    # Carve a few rooms/notches into the interior block edges
    rng = np.random.RandomState(7)
    for _ in range(10):
        side = rng.randint(4)
        d = rng.randint(40, 120)
        span0 = rng.randint(300, h - 400)
        span1 = span0 + rng.randint(60, 200)
        if side == 0:
            img[240:240 + d, span0:span1] = 254
        elif side == 1:
            img[h - 240 - d:h - 240, span0:span1] = 254
        elif side == 2:
            img[span0:span1, 240:240 + d] = 254
        else:
            img[span0:span1, w - 240 - d:w - 240] = 254
    # Pillars in the corridor
    for _ in range(14):
        ci = rng.randint(120, h - 120)
        cj = rng.randint(120, w - 120)
        if img[ci, cj] == 254:
            img[ci - 4:ci + 4, cj - 4:cj + 4] = 0
    return img


def generate_berlin(h: int = 1200, w: int = 1200) -> np.ndarray:
    """Smooth closed circuit: free ribbon of varying width around a wavy
    center-line loop; everything else occupied/unknown."""
    img = np.full((h, w), 205, dtype=np.uint8)
    t = np.linspace(0.0, 2.0 * np.pi, 4000, endpoint=False)
    rng = np.random.RandomState(3)
    # Radius as a low-order Fourier series -> smooth varying curvature
    r = 0.33 + 0.06 * np.cos(2 * t + 0.7) + 0.05 * np.sin(3 * t) \
        + 0.025 * np.cos(5 * t + 1.9)
    cx, cy = w / 2.0, h / 2.0
    px = cx + r * w * np.cos(t)
    py = cy + r * h * 0.9 * np.sin(t)
    half_width = (60 + 25 * np.sin(4 * t + 0.5)).astype(np.int64)  # cells
    yy, xx = np.mgrid[0:h, 0:w]
    free = np.zeros((h, w), dtype=bool)
    # Stamp disks along the centerline (coarse but smooth at this density)
    for k in range(0, len(t), 4):
        hw = int(half_width[k])
        x0, y0 = int(px[k]), int(py[k])
        i0, i1 = max(0, y0 - hw), min(h, y0 + hw + 1)
        j0, j1 = max(0, x0 - hw), min(w, x0 + hw + 1)
        sub = (yy[i0:i1, j0:j1] - y0) ** 2 + (xx[i0:i1, j0:j1] - x0) ** 2
        free[i0:i1, j0:j1] |= sub <= hw * hw
    img[free] = 254
    # Track borders: occupied ring = dilation(free) & ~free
    from scipy.ndimage import binary_dilation  # test-time dep, host only
    border = binary_dilation(free, iterations=3) & ~free
    img[border] = 0
    del rng
    return img


_BUILTIN = {"levine": generate_levine, "berlin": generate_berlin}


def generate_builtin(name: str, assets_dir: str, resolution: float = 0.05):
    """Generate and persist a builtin map asset pair (PGM + YAML)."""
    if name not in _BUILTIN:
        raise KeyError(f"unknown builtin map {name!r}; have {list(_BUILTIN)}")
    from .loader import write_pgm
    os.makedirs(assets_dir, exist_ok=True)
    img = _BUILTIN[name]()
    h, w = img.shape
    # Center the world origin so poses are in [-extent/2, extent/2]
    origin = (-w * resolution / 2.0, -h * resolution / 2.0)
    write_pgm(os.path.join(assets_dir, f"{name}.pgm"), img)
    with open(os.path.join(assets_dir, f"{name}.yaml"), "w") as f:
        f.write(_yaml_text(f"{name}.pgm", resolution, origin))
