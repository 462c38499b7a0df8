"""ROS-format occupancy-grid map loading and the map bundle.

Counterpart of ``pyracecarsimulator_tpu/maps/loader.py``: a PGM (or PNG)
image plus a YAML sidecar with ``image, resolution, origin,
occupied_thresh, free_thresh, negate`` becomes a ``TrackMap`` whose
occupancy and euclidean distance field are tensors. The grids are padded on
the right/top to multiples of 128 cells, exactly as in the JAX package, so
both packages see the same map; padding cells are FREE (a ray leaving the
real map returns max_range), and consumers test bounds against the real
``(height, width)``.

The YAML sidecar is read by a small parser of the flat ``key: value``
format that ROS map files use, so the port needs no YAML package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Tuple

import numpy as np
import torch

from ..config import resolve_device
from .edt import edt

# The bundled maps (levine, berlin) ship inside this package.
ASSETS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "assets")
_LANE_ALIGN = 128


@dataclasses.dataclass(frozen=True)
class TrackMap:
    """Map bundle: occupancy + EDF tensors, geometry metadata as Python
    scalars."""

    occupancy: Any        # (Hp, Wp) float32 in [0,1]; padded region = 0
    edf: Any              # (Hp, Wp) float32 meters-to-nearest-obstacle
    resolution: float     # meters per cell
    origin_x: float       # world coords of cell (0,0) corner
    origin_y: float
    height: int           # original (unpadded) grid dims
    width: int
    name: str = "map"

    @classmethod
    def from_numpy(cls, occupancy, edf, device=None, **statics):
        """Build from host arrays (for example the JAX map's leaves
        converted with ``np.asarray``) and the static fields, on ``device``
        (``None``: the card, ``config.resolve_device``)."""
        device = resolve_device(device)
        own = lambda a: torch.as_tensor(np.array(a, np.float32, order="C"),
                                        device=device)
        return cls(occupancy=own(occupancy), edf=own(edf), **statics)

    def to(self, device) -> "TrackMap":
        return dataclasses.replace(self, occupancy=self.occupancy.to(device),
                                   edf=self.edf.to(device))

    @property
    def padded_shape(self) -> Tuple[int, int]:
        return tuple(self.edf.shape)

    def world_extent(self):
        """((xmin, xmax), (ymin, ymax)) of the unpadded map in meters."""
        return ((self.origin_x, self.origin_x + self.width * self.resolution),
                (self.origin_y,
                 self.origin_y + self.height * self.resolution))


def _align_up(n: int, m: int = _LANE_ALIGN) -> int:
    return ((n + m - 1) // m) * m


def read_pgm(path: str) -> np.ndarray:
    """Minimal P2/P5 PGM reader (no external deps). Returns (H, W) uint8/16."""
    with open(path, "rb") as f:
        data = f.read()
    # Header tokens: magic, width, height, maxval — comments start with '#'.
    tokens, i = [], 0
    while len(tokens) < 4:
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while i < len(data) and data[i] not in (10, 13):
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    magic, w, h, maxval = (tokens[0], int(tokens[1]), int(tokens[2]),
                           int(tokens[3]))
    i += 1  # single whitespace after maxval
    if magic == b"P5":
        dtype = np.uint8 if maxval < 256 else np.dtype(">u2")
        img = np.frombuffer(data, dtype=dtype, count=h * w, offset=i)
        return img.reshape(h, w).astype(np.uint16 if maxval >= 256
                                        else np.uint8)
    if magic == b"P2":
        vals = np.array(data[i:].split(), dtype=np.int64)[: h * w]
        return vals.reshape(h, w).astype(np.uint16 if maxval >= 256
                                         else np.uint8)
    raise ValueError(f"unsupported PGM magic {magic!r} in {path}")


def write_pgm(path: str, img: np.ndarray) -> None:
    """Write a uint8 (H, W) array as binary P5 PGM."""
    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def _read_image(path: str) -> np.ndarray:
    if os.path.splitext(path)[1].lower() == ".pgm":
        return read_pgm(path)
    from PIL import Image          # PNG and friends, where PIL is installed
    return np.asarray(Image.open(path).convert("L"), dtype=np.uint8)


def _parse_scalar(s: str):
    s = s.strip()
    if s.startswith("[") and s.endswith("]"):
        return [_parse_scalar(v) for v in s[1:-1].split(",") if v.strip()]
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    for conv in (int, float):
        try:
            return conv(s)
        except ValueError:
            pass
    return s


def parse_map_yaml(text: str) -> dict:
    """Parse a ROS map_server YAML sidecar (flat ``key: value`` lines,
    scalars and ``[a, b, c]`` lists, ``#`` comments)."""
    out = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        key, sep, value = line.partition(":")
        if not sep:
            raise ValueError(f"not a 'key: value' line: {line!r}")
        out[key.strip()] = _parse_scalar(value)
    return out


def occupancy_from_image(img: np.ndarray, negate: int = 0,
                         occupied_thresh: float = 0.65,
                         free_thresh: float = 0.196) -> np.ndarray:
    """ROS map_server trinary semantics -> occupancy in {0, 1}.

    p = (255 - value)/255 unless negate; p > occupied_thresh -> occupied,
    p < free_thresh -> free, unknown -> occupied (ray-marching safety).
    """
    maxv = float(img.max()) if img.dtype != np.uint8 else 255.0
    maxv = max(maxv, 1.0)
    v = img.astype(np.float64) / maxv
    p = v if negate else (1.0 - v)
    occ = np.where(p > occupied_thresh, 1.0,
                   np.where(p < free_thresh, 0.0, 1.0))
    return occ.astype(np.float32)


def build_track_map(occupancy: np.ndarray, resolution: float,
                    origin_xy=(0.0, 0.0), name: str = "map",
                    occupied_thresh: float = 0.5,
                    device=None) -> TrackMap:
    """Pad, run the EDT on the host, and put the grids on ``device``
    (``None``: the card, ``config.default_device``).

    ``occupancy`` is (H, W) float32 in [0,1] (row 0 = world bottom; callers
    loading image files flip rows first).
    """
    device = resolve_device(device)
    h, w = occupancy.shape
    hp, wp = _align_up(h), _align_up(w)
    occ_p = np.zeros((hp, wp), dtype=np.float32)  # pad = free (module doc)
    occ_p[:h, :w] = occupancy
    field = edt(occ_p >= occupied_thresh, resolution=resolution)
    return TrackMap.from_numpy(
        occ_p, field, device=device, resolution=float(resolution),
        origin_x=float(origin_xy[0]), origin_y=float(origin_xy[1]),
        height=h, width=w, name=name)


def load_map_yaml(yaml_path: str, device=None) -> TrackMap:
    """Load a ROS map YAML + image pair into a TrackMap on ``device``
    (``None``: the card)."""
    device = resolve_device(device)
    with open(yaml_path) as f:
        meta = parse_map_yaml(f.read())
    img_path = meta["image"]
    if not os.path.isabs(img_path):
        img_path = os.path.join(os.path.dirname(yaml_path), img_path)
    occ = occupancy_from_image(
        _read_image(img_path), negate=int(meta.get("negate", 0)),
        occupied_thresh=float(meta.get("occupied_thresh", 0.65)),
        free_thresh=float(meta.get("free_thresh", 0.196)))
    # Image row 0 is the TOP of the map; grid row 0 must be world bottom.
    occ = occ[::-1].copy()
    origin = meta.get("origin", [0.0, 0.0, 0.0])
    name = os.path.splitext(os.path.basename(yaml_path))[0]
    return build_track_map(occ, float(meta["resolution"]),
                           (float(origin[0]), float(origin[1])), name=name,
                           device=device)


def load_builtin(name: str, device=None) -> TrackMap:
    """Load a bundled map asset by name ('levine', 'berlin') onto
    ``device`` (``None``: the card).

    Raises FileNotFoundError when the asset is missing: the port never
    regenerates assets."""
    device = resolve_device(device)
    path = os.path.join(ASSETS_DIR, f"{name}.yaml")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no bundled map {name!r}: {path} does not exist")
    return load_map_yaml(path, device=device)


def obstacle_cells(track: TrackMap, x: float, y: float, size: float):
    """The cell rows [i0, i1) and columns [j0, j1) that ``add_obstacle``
    fills for a square of edge ``size`` meters centered at (x, y)."""
    r = max(1, int(round(size / track.resolution / 2)))
    ci = int((y - track.origin_y) / track.resolution)
    cj = int((x - track.origin_x) / track.resolution)
    return (max(0, ci - r), min(track.height, ci + r + 1),
            max(0, cj - r), min(track.width, cj + r + 1))


def add_obstacle(track: TrackMap, x: float, y: float,
                 size: float = 0.2) -> TrackMap:
    """Rasterize a square obstacle of edge ``size`` meters centered at
    (x, y) and rebuild the EDF on the host (reference ``addObstacle``;
    obstacles change at episode frequency, not step frequency). Returns a
    new map on the track's device; ``track`` is left as it was."""
    occ = track.occupancy[: track.height, : track.width].cpu().numpy().copy()
    i0, i1, j0, j1 = obstacle_cells(track, x, y, size)
    occ[i0:i1, j0:j1] = 1.0
    return build_track_map(occ, track.resolution,
                           (track.origin_x, track.origin_y), name=track.name,
                           device=track.occupancy.device)


def clear_obstacles(track: TrackMap, original: TrackMap) -> TrackMap:
    """Reference ``clearObstacles``: restore the pristine map."""
    return original


def sample_free_poses(track: TrackMap, n: int, rng=None,
                      margin: float = 0.3, theta_range=(-np.pi, np.pi)):
    """Sample n collision-free poses (x, y, theta) in open space.

    ``margin``: minimum EDF clearance in meters. ``rng``: a
    ``np.random.RandomState`` or an int seed. Returns (n, 3) float32 numpy,
    the same draws as the JAX package's sampler for the same seed.
    """
    if rng is None or isinstance(rng, int):
        rng = np.random.RandomState(rng or 0)
    edf = track.edf.cpu().numpy()[: track.height, : track.width]
    ys, xs = np.where(edf > margin)
    if len(ys) == 0:
        raise ValueError(f"no free cells with clearance > {margin}")
    k = rng.randint(len(ys), size=n)
    x = track.origin_x + (xs[k] + 0.5) * track.resolution
    y = track.origin_y + (ys[k] + 0.5) * track.resolution
    th = rng.uniform(theta_range[0], theta_range[1], n)
    return np.stack([x, y, th], axis=-1).astype(np.float32)
