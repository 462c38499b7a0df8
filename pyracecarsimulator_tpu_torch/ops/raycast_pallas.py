"""The dense backend's kernel entry points ("segments_pallas").

Counterpart of the public half of
``pyracecarsimulator_tpu/ops/raycast_pallas.py``. No Pallas runs here: the
module keeps its JAX name so that a reader finds the counterpart of
``raycast_pallas``, ``raycast_pallas_tiled``, ``scan_poses_pallas`` and
the sweep-bound helpers. The JAX package's Pallas kernels and its XLA
sweeps compute the same values, so in the port both backends run the same
hand-written Hopper kernels (``ops/sweeps.py``): the dense sweep
``csrc/dense_sweep.cu`` on untiled maps, the tile-routed list sweep
``csrc/sector_sweep.cu`` on tiled ones, each under the analytic VJP of
``ops/raycast_grad.py``. ``interpret`` is accepted and ignored (there is no
interpret mode: CPU tensors take the plain PyTorch sweeps).

Left out, because they serve the TPU only: the 4096-ray programs
(``ROWS`` x ``LANES`` padding of the ray count), the ``SEG_BLK`` sublane
groups, the scalar prefetch of the bounds (the kernels read them on the
device), and the per-tail-row register layouts.
"""

from __future__ import annotations

import torch

from ..config import resolve_device

from .raycast_grad import raycast_all_diff, raycast_tiled_diff
from .raycast_segments import scan_poses_segments


def sweep_meta_mixed(n_vertical, n_segments, device=None):
    """Sweep bounds for the mixed layout (extraction order: verticals, then
    horizontals, then padding sentinels), on ``device`` (``None``: the
    card)."""
    device = resolve_device(device)
    return torch.tensor([n_vertical, n_vertical, n_segments],
                        dtype=torch.int32, device=device)


def sweep_meta_split(kv, n_vertical, n_segments, device=None):
    """Sweep bounds for the split layout (vertical block padded to ``kv``):
    V reals in [0, n_vertical), H reals in [kv, kv + n_h); on ``device``
    (``None``: the card)."""
    device = resolve_device(device)
    return torch.tensor([n_vertical, kv, kv + (n_segments - n_vertical)],
                        dtype=torch.int32, device=device)


def raycast_pallas(segment_params, sweep_meta, x, y, cos_t, sin_t,
                   max_range: float = 10.0, interpret: bool = False):
    """Differentiable dense raycast; ray args of any common shape. Values
    match ``raycast_all``; the VJP is the analytic O(rays) form."""
    return raycast_all_diff(segment_params, sweep_meta, x, y, cos_t, sin_t,
                            max_range)


def raycast_pallas_tiled(tiles, tile_sweep_meta, tiles_shape, tile_size,
                         tile_origin, x0, y0, x, y, cos_t, sin_t,
                         max_range: float = 10.0, interpret: bool = False):
    """Differentiable tile-culled raycast; rays (A, B). Values match
    ``raycast_tiled``."""
    return raycast_tiled_diff(tiles, tile_sweep_meta, tiles_shape,
                              tile_size, tile_origin, x0, y0, x, y, cos_t,
                              sin_t, max_range)


def scan_poses_pallas(segmap, poses, num_beams: int = 1080,
                      fov: float = 4.712388980384690, max_range=10.0,
                      theta_discretization: int = 0,
                      interpret=None) -> torch.Tensor:
    """Full lidar scans for poses (..., 3); values match
    ``scan_poses_segments`` (tile tables when the map carries them)."""
    return scan_poses_segments(segmap, poses, num_beams, fov, max_range,
                               theta_discretization, use_tiles=True)
