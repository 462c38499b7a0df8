"""Dense segment raycast: every ray against the full segment set, or against
its agent's map-tile list.

Counterpart of ``pyracecarsimulator_tpu/ops/raycast_segments.py``, the JAX
package's default backend ("segments"). Each ray's range is the minimum
over the boundary segments of the exact ray/segment intersection distance
(``maps/segments.py``). Two variants, each one sweep of ``ops/sweeps.py``:

- ``raycast_all``: flat rays against the real slots of the (4, K)
  ``params`` (``dense_sweep``: ``csrc/dense_sweep.cu`` on CUDA tensors);
- ``raycast_tiled``: each agent's beams, in rows of 128, against its map
  tile's list (``list_sweep``: the list kernel ``csrc/sector_sweep.cu``).

A scan of poses whose rays take no gradient, on the exact fan, runs a
kernel's from-poses entry instead: the list kernel's on a tiled map
(``list_scan``), the dense kernel's on an untiled one (``dense_scan``),
each the fan, the reciprocals, the sweep, the clamp and the extent mask
in one launch, bit for bit the composition. Every other scan of poses
builds its fan here and hands the rays to a sweep: the fan, and on the
dense route its reciprocals and flat ray tensors, are spanned as
``scan.fan``.
On CPU tensors every route runs the plain PyTorch versions. The JAX
package's XLA sweeps here and its Pallas kernels
(``ops/raycast_pallas.py``) have the same values, so the port has one
sweep per shape and both backends, "segments" and "segments_pallas", run
it. Both raycasts are differentiable in the rays through the analytic VJP
of ``ops/raycast_grad.py`` (JAX's ``raycast_all`` gets the same gradient
from plain autodiff).

The kernels read the real-slot bounds (``sweep_meta``,
``tile_sweep_meta``) instead of visiting every padded slot, so
``raycast_all`` and ``raycast_tiled`` take those bounds where the JAX
functions take the static split ``kv``/``kv_tile``; ``chunk`` and the
splits are accepted and ignored (there is no chunked scan: the kernels
stream through shared memory, the plain sweeps chunk by a byte budget).
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from .common import (_padded_offsets, apply_extent_mask, beam_angles,
                     fan_cos_sin, fused_scan, offset_factors)
from .raycast_grad import (LANES, raycast_all_diff, raycast_tiled_diff,
                           tile_rows)
from .sweeps import dense_scan, list_scan


def raycast_all(segment_params, sweep_meta, x, y, cos_t, sin_t,
                max_range=10.0, chunk: int = 1024, kv: int = 0):
    """Raycast against the full segment set: ``segment_params`` (4, K),
    ``sweep_meta`` (3,) int32 [v_hi, h_lo, h_end], ray args of any common
    shape S. Returns ranges, shape S, clamped to ``max_range``."""
    return raycast_all_diff(segment_params, sweep_meta, x, y, cos_t, sin_t,
                            max_range)


def raycast_tiled(tiles, tile_sweep_meta, tiles_shape, tile_size,
                  tile_origin, x0, y0, x, y, cos_t, sin_t, max_range=10.0,
                  chunk: int = 512, kv_tile: int = 0):
    """Raycast with per-agent tile culling: ``tiles`` (T, 4, K_tile) with
    ``tile_sweep_meta`` (T, 3) int32; ``x0``/``y0`` (A,) agent positions
    (the tile lookup); rays (A, B). Returns ranges (A, B)."""
    return raycast_tiled_diff(tiles, tile_sweep_meta, tiles_shape,
                              tile_size, tile_origin, x0, y0, x, y, cos_t,
                              sin_t, max_range)


def _scan_rays(segmap, poses2, ct, st, num_beams, max_range,
               use_tiles: bool = True):
    """Raycast + extent mask for (A, 3) poses whose beam fan (ct, st) was
    built outside (the tile path takes it padded to rows of 128). Returns
    (A, num_beams)."""
    xb = poses2[:, 0:1].expand(ct.shape)
    yb = poses2[:, 1:2].expand(ct.shape)
    if use_tiles and segmap.tiles is not None:
        r = raycast_tiled_diff(segmap.tiles, segmap.tile_sweep_meta,
                               segmap.tiles_shape, segmap.tile_size,
                               segmap.tile_origin, poses2[:, 0],
                               poses2[:, 1], xb, yb, ct, st, max_range)
    else:
        r = raycast_all_diff(segmap.params, segmap.sweep_meta, xb, yb, ct,
                             st, max_range)
    return apply_extent_mask(r[:, :num_beams], poses2[:, 0], poses2[:, 1],
                             segmap.extent, max_range)


def scan_poses_segments(segmap, poses, num_beams: int = 1080,
                        fov: float = 4.712388980384690, max_range=10.0,
                        theta_discretization: int = 0,
                        use_tiles: bool = True) -> torch.Tensor:
    """Full lidar scans for poses (..., 3) via the segment backend; returns
    (..., num_beams) ranges. ``poses`` must be on the map's device."""
    batch = tuple(poses.shape[:-1])
    poses2 = poses.reshape(-1, 3).to(torch.float32)
    tiled = use_tiles and segmap.tiles is not None
    if fused_scan(poses, theta_discretization):
        fused = _scan_tiles_fused if tiled else _scan_dense_fused
        r = fused(segmap, poses2, num_beams, fov, max_range)
        return r.reshape(*batch, num_beams)
    with span("scan.fan"):
        offs = (_padded_offsets(num_beams, fov, LANES, poses2.device)
                if tiled else beam_angles(num_beams, fov, poses2.device))
        ct, st = fan_cos_sin(poses2[:, 2], offs, theta_discretization)
    r = _scan_rays(segmap, poses2, ct, st, num_beams, max_range, use_tiles)
    return r.reshape(*batch, num_beams)


def _scan_tiles_fused(segmap, poses2, num_beams, fov, max_range):
    """The tile-routed scan of (A, 3) poses whose rays take no gradient,
    in one launch of the list kernel's from-poses entry: the values of
    ``_scan_rays`` on the exact padded fan, bit for bit. Returns (A,
    num_beams)."""
    dev = poses2.device
    x0, y0 = (poses2[:, i].contiguous() for i in (0, 1))
    cd, sd = offset_factors(num_beams, fov, LANES, dev)
    ids = tile_rows(segmap.tiles_shape, segmap.tile_size, segmap.tile_origin,
                    x0, y0, cd.shape[0] // LANES)
    return list_scan(segmap.tiles, segmap.tile_sweep_meta, ids, x0, y0,
                     torch.cos(poses2[:, 2]), torch.sin(poses2[:, 2]), cd,
                     sd, max_range, segmap.extent, num_beams)


def _scan_dense_fused(segmap, poses2, num_beams, fov, max_range):
    """The dense scan of (A, 3) poses whose rays take no gradient, in one
    launch of the dense kernel's from-poses entry: the values of
    ``_scan_rays`` on the exact fan over every real segment, bit for bit.
    Returns (A, num_beams)."""
    x0, y0 = (poses2[:, i].contiguous() for i in (0, 1))
    cd, sd = offset_factors(num_beams, fov, 1, poses2.device)
    return dense_scan(segmap.params, segmap.sweep_meta, x0, y0,
                      torch.cos(poses2[:, 2]), torch.sin(poses2[:, 2]), cd,
                      sd, max_range, segmap.extent)
