"""Map input of both sides: a ROS map (PGM image and flat YAML sidecar).

The benchmark reads the file once and hands the same occupancy,
resolution and origin to the program and to the reference. Semantics of
the ROS ``map_server`` trinary map: a pixel's occupancy probability is
``(255 - value) / 255`` (``1 - value / max`` for 16-bit images, or the
value itself with ``negate``); above ``occupied_thresh`` it is occupied,
below ``free_thresh`` free, and between the two unknown, which counts as
occupied. Image row 0 is the top of the map, grid row 0 its bottom.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass(frozen=True)
class GridMap:
    occupied: np.ndarray      # (H, W) bool, row 0 = world bottom
    resolution: float         # meters per cell
    origin: tuple             # world (x, y) of cell (0, 0)'s lower-left corner
    name: str

    @property
    def shape(self):
        return self.occupied.shape

    def occupancy_f32(self) -> np.ndarray:
        """(H, W) float32 in {0, 1}: what the program is handed."""
        return self.occupied.astype(np.float32)


def read_pgm(path: str) -> np.ndarray:
    """A binary (P5) or ASCII (P2) PGM as an (H, W) integer array."""
    with open(path, "rb") as f:
        data = f.read()
    tokens, i = [], 0
    while len(tokens) < 4:
        while data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while data[i:i + 1] not in (b"\n", b"\r", b""):
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), \
        int(tokens[3])
    i += 1
    if magic == b"P5":
        dt = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
        img = np.frombuffer(data, dtype=dt, count=h * w, offset=i)
        return img.reshape(h, w).astype(np.int64)
    if magic == b"P2":
        return np.array(data[i:].split()[:h * w], np.int64).reshape(h, w)
    raise ValueError(f"{path}: not a P2/P5 PGM ({magic!r})")


def read_yaml(path: str) -> dict:
    """Flat ``key: value`` lines, numbers and ``[a, b]`` lists."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            key, _, value = line.partition(":")
            value = value.strip()
            if value.startswith("["):
                out[key.strip()] = [float(v) for v in
                                    value.strip("[]").split(",") if v.strip()]
                continue
            try:
                out[key.strip()] = float(value)
            except ValueError:
                out[key.strip()] = value.strip("'\"")
    return out


def load_map(yaml_path: str) -> GridMap:
    meta = read_yaml(yaml_path)
    img = read_pgm(os.path.join(os.path.dirname(yaml_path), meta["image"]))
    maxv = 255.0 if img.max() < 256 else float(max(img.max(), 1))
    v = img.astype(np.float64) / maxv
    p = v if int(meta.get("negate", 0)) else 1.0 - v
    # occupied above occupied_thresh, unknown between the thresholds: both
    # are everything that is not free
    occupied = ~(p < float(meta.get("free_thresh", 0.196)))
    origin = meta.get("origin", [0.0, 0.0, 0.0])
    return GridMap(occupied=np.ascontiguousarray(occupied[::-1]),
                   resolution=float(meta["resolution"]),
                   origin=(float(origin[0]), float(origin[1])),
                   name=os.path.splitext(os.path.basename(yaml_path))[0])


def padded(occupied: np.ndarray, align: int = 128) -> np.ndarray:
    """The grid grown on the right and top to multiples of ``align`` cells
    with free cells, as the map is loaded for a scan: the distance field
    is taken over this grid and a bilinear sample at the real map's top or
    right edge reads its free margin."""
    h, w = occupied.shape
    out = np.zeros((-(-h // align) * align, -(-w // align) * align), bool)
    out[:h, :w] = occupied
    return out
