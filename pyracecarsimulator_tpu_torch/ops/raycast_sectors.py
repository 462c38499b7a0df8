"""Sector-culled segment raycast: list routing, the sweep, the scan.

Counterpart of the main-path subset of
``pyracecarsimulator_tpu/ops/raycast_sectors.py``. Beams are grouped into
angle-contiguous blocks of ``bb`` (128 for the 1080-beam / 270 deg scan);
each block (a "ray row": one agent, one origin) sweeps only its (tile,
sector) cull list from ``maps/sectors.py``.

One sweep serves every map. ``sector_sweep`` routes CPU tensors to
``sweep_plain`` (PyTorch) and CUDA tensors to the hand-written Hopper kernel
``csrc/sector_sweep.cu``, which replaces both of the JAX package's sweeps
(the Pallas fused-gather kernel on large-capacity tables, the XLA dense
sweep on small ones). Both visit the same slots of a row: vertical
[0, n_v) and horizontal [kv, kv + n_h), from ``meta``, and agree bit for
bit. The JAX package's mode zoo (sorted tiles, ``table_ck``, the
``use_pallas``/``grp``/``interpret`` plumbing, SMEM-driven agent chunks) is
TPU machinery and is not ported; modes "auto", "dense" and "sorted_plf*"
all select the one sweep. The backward (``_winner_vjp``) belongs to the
training slice and is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels
from .common import (apply_extent_mask, beam_angles, fan_cos_sin,
                     _ray_invs)

_BIG = 3.0e38
_TWO_PI = np.float32(2.0 * np.pi)
# bytes of gathered (rows, 4, K) cull lists per agent chunk, and of each
# (rows, slots, bb) intermediate, that the plain sweep may hold at once
_PLAIN_BYTES_BUDGET = 1 << 28


def sector_block_width(smap, num_beams: int, fov: float,
                       bb: int | None = None) -> int:
    """Derive (bb=None) or validate a beam-block width for a sector map.

    Every real beam of a ``bb``-block must lie within the map's
    ``block_half`` of the block's lookup beam. ``bb=None`` returns the
    widest supported block, capped at 128. Raises ValueError when ``bb``
    exceeds what the map was built for.
    """
    spacing = fov / max(num_beams - 1, 1)
    if bb is None:
        bb = max(1, min(128, 2 * int(smap.block_half / spacing)))
    need = (bb // 2) * spacing
    if need > smap.block_half:
        raise ValueError(
            f"beam blocks span +-{need:.3f} rad but the sector map was "
            f"built for block_half={smap.block_half:.3f}; rebuild the map "
            "with a larger block_half or use a smaller bb")
    return bb


def _f32(v, device):
    """A 0-dim float32 tensor on ``device``. Scalars that divide ride as
    device tensors: CUDA divides by a host scalar through its reciprocal,
    which is not the correctly rounded quotient the JAX package takes."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def _list_ids(tiles_shape, tile_size, tile_origin, ns, x0, y0, ct, st,
              bb: int):
    """(A,) agent positions + (A, B) beam directions -> (A, NBLK) int32
    rows into the (T*NS, ...) sector table. A block's sector is read from
    one in-block beam within half a block of every real beam."""
    a_n, b_n = ct.shape
    nblk = -(-b_n // bb)
    nr, nc = tiles_shape
    tox, toy = tile_origin
    dev = ct.device
    ts = _f32(tile_size, dev)
    ci = torch.clamp(((x0 - _f32(tox, dev)) / ts).to(torch.int32), 0, nc - 1)
    ri = torch.clamp(((y0 - _f32(toy, dev)) / ts).to(torch.int32), 0, nr - 1)
    tid = ri * nc + ci                                     # (A,)
    mids = torch.as_tensor(
        np.minimum(np.arange(nblk) * bb + bb // 2, b_n - 1), device=dev)
    th = torch.atan2(st[:, mids], ct[:, mids])             # (A, NBLK)
    th = torch.remainder(th, _f32(_TWO_PI, dev))
    sec = torch.clamp((th * _f32(np.float32(ns) / _TWO_PI, dev))
                      .to(torch.int32), 0, ns - 1)
    return (tid[:, None] * ns + sec).to(torch.int32)       # (A, NBLK)


def sweep_plain(table, meta, kv_sec, ids, x0, y0, cos_t, sin_t, inv_c,
                inv_s):
    """Plain PyTorch sweep: the reference of ``csrc/sector_sweep.cu``.

    ``table`` (L, 4, K) f32, ``meta`` (L, 3) i32, ``ids`` (G,) i32 rows,
    ``x0``/``y0`` (G,) row origins, ray tensors (G, bb). Returns the
    unclamped minima (bv, bh), each (G, bb), 3e38 where nothing is hit.

    Like the JAX package's ``_sweep_gathered``, it gathers each row's list
    and sweeps it slot-chunk by slot-chunk as (G, chunk, bb) tensors;
    slots outside the row's real counts are masked, so the contributing
    slots are exactly the kernel's.
    """
    g_n, bb = cos_t.shape
    k = table.shape[2]
    lid = ids.long()
    g_all = table.index_select(0, lid)                      # (G, 4, K)
    m = meta.index_select(0, lid)
    nv = m[:, 0:1]
    nh = m[:, 2:3] - m[:, 1:2]
    slot = torch.arange(k, device=table.device)[None, :]
    real = torch.where(slot < kv_sec, slot < nv, slot - kv_sec < nh)
    chunk = max(1, _PLAIN_BYTES_BUDGET // max(1, g_n * bb * 4))
    big = torch.full((g_n, bb), _BIG, dtype=torch.float32,
                     device=table.device)
    x = x0[:, None, None]
    y = y0[:, None, None]
    best = {}
    for lo_i, hi_i, vertical in ((0, kv_sec, True), (kv_sec, k, False)):
        b = big
        for c0 in range(lo_i, hi_i, chunk):
            c1 = min(c0 + chunk, hi_i)
            p = g_all[:, 0, c0:c1, None]                    # (G, ck, 1)
            lo = g_all[:, 1, c0:c1, None]
            hi = g_all[:, 2, c0:c1, None]
            if vertical:
                t = (p - x) * inv_c[:, None, :]
                a = y + t * sin_t[:, None, :]
            else:
                t = (p - y) * inv_s[:, None, :]
                a = x + t * cos_t[:, None, :]
            valid = ((t >= 0.0) & ((a - lo) * (hi - a) >= 0.0)
                     & real[:, c0:c1, None])
            b = torch.minimum(b, torch.where(valid, t, _BIG).amin(dim=1))
        best[vertical] = b
    return best[True], best[False]


def sector_sweep(table, meta, kv_sec, ids, x0, y0, cos_t, sin_t, inv_c,
                 inv_s):
    """The sweep of ``sweep_plain``, routed by device: CPU tensors take
    ``sweep_plain``; CUDA tensors launch the kernel (or raise). Returns
    (bv, bh), each (G, bb). ``sector_sweep.launches`` counts launches."""
    if table.device.type == "cpu":
        return sweep_plain(table, meta, kv_sec, ids, x0, y0, cos_t, sin_t,
                           inv_c, inv_s)
    if table.device.type != "cuda":
        raise ValueError(f"no sector sweep for device {table.device}")
    g_n, bb = cos_t.shape
    l_n, four, k = table.shape
    if four != 4 or meta.shape != (l_n, 3):
        raise ValueError(f"table must be (L, 4, K) and meta (L, 3); got "
                         f"{tuple(table.shape)}, {tuple(meta.shape)}")
    if not 0 <= kv_sec <= k:
        raise ValueError(f"kv_sec={kv_sec} outside [0, K={k}]")
    if not 0 < bb <= 1024:
        raise ValueError(f"rows of {bb} beams: one thread per beam needs "
                         "1..1024")
    if 3 * k * 4 > 48 * 1024:
        raise ValueError(f"capacity K={k} needs {3 * k * 4} bytes of "
                         "shared memory per row; the kernel takes <= 48 KB")
    checks = ((table, torch.float32, (l_n, 4, k)),
              (meta, torch.int32, (l_n, 3)),
              (ids, torch.int32, (g_n,)), (x0, torch.float32, (g_n,)),
              (y0, torch.float32, (g_n,)),
              *((v, torch.float32, (g_n, bb))
                for v in (cos_t, sin_t, inv_c, inv_s)))
    for v, dtype, shape in checks:
        if (v.device != table.device or v.dtype != dtype
                or tuple(v.shape) != shape or not v.is_contiguous()):
            raise ValueError(
                f"sector_sweep: expected contiguous {dtype} {shape} on "
                f"{table.device}, got {v.dtype} {tuple(v.shape)} on "
                f"{v.device} (contiguous={v.is_contiguous()})")
    bv = torch.empty((g_n, bb), dtype=torch.float32, device=table.device)
    bh = torch.empty_like(bv)
    fn = _kernels.kernel("sector_sweep")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), meta.data_ptr(), ids.data_ptr(),
                 x0.data_ptr(), y0.data_ptr(), cos_t.data_ptr(),
                 sin_t.data_ptr(), inv_c.data_ptr(), inv_s.data_ptr(),
                 bv.data_ptr(), bh.data_ptr(), g_n, bb, k, int(kv_sec),
                 stream)
    if err != 0:
        raise RuntimeError(f"sector_sweep kernel launch failed: CUDA error "
                           f"{err}")
    sector_sweep.launches += 1
    return bv, bh


sector_sweep.launches = 0


def raycast_sectors(table, meta, tiles_shape, tile_size, tile_origin, ns,
                    kv_sec, x0, y0, cos_t, sin_t, max_range: float = 10.0,
                    bb: int = 128):
    """Sector-culled raycast forward for (A,) origins and (A, B) beam
    directions, B a multiple of ``bb``. Returns (r, isv, hit), each (A, B):
    the clamped range, whether the vertical minimum wins (ties go to
    vertical: ``bv <= bh``), and whether anything within max_range was hit.
    """
    a_n, b_n = cos_t.shape
    if b_n % bb:
        raise ValueError(f"beam count {b_n} is not a multiple of bb={bb}")
    ids = _list_ids(tiles_shape, tile_size, tile_origin, ns, x0, y0, cos_t,
                    sin_t, bb)
    inv_c, inv_s = _ray_invs(cos_t, sin_t)
    g_n = ids.numel()
    rows = lambda v: v.reshape(g_n, bb).contiguous()
    bv, bh = sector_sweep(
        table, meta, kv_sec, ids.reshape(g_n).contiguous(),
        x0.repeat_interleave(b_n // bb).contiguous(),
        y0.repeat_interleave(b_n // bb).contiguous(),
        rows(cos_t), rows(sin_t), rows(inv_c), rows(inv_s))
    bv = bv.reshape(a_n, b_n)
    bh = bh.reshape(a_n, b_n)
    m = torch.minimum(bv, bh)
    return torch.clamp(m, max=max_range), bv <= bh, m < max_range


def _padded_offsets(num_beams, fov, bb, device="cpu"):
    """The (NBLK*bb,) beam-offset row: the last offset repeated into the
    padding beams of the last block (their outputs are sliced off)."""
    nblk = -(-num_beams // bb)
    b_pad = nblk * bb - num_beams
    offs = beam_angles(num_beams, fov, device)
    if b_pad:
        offs = torch.cat([offs, offs[-1:].expand(b_pad)])
    return offs


def _check_mode(mode: str, use_pallas):
    if use_pallas:
        raise NotImplementedError(
            "use_pallas=True selects the per-row grp kernel "
            "(raycast_pallas._make_kernel_grp), not ported yet: ROADMAP.md "
            "'Pallas kernels to port', item 3")
    kind = mode.split("@", 1)[0]
    if kind not in ("auto", "dense") and not kind.startswith("sorted_plf"):
        raise NotImplementedError(
            f"sector sweep mode {mode!r} is not ported: the port's one "
            "sweep serves 'auto', 'dense' and 'sorted_plf*' (ROADMAP.md "
            "'Pallas kernels to port', item 2, and 'Not to port')")


def _scan_chunk(smap, poses2, ct, st, num_beams, max_range, bb):
    """Raycast + extent mask for one (A, 3) pose chunk whose padded beam
    fan (ct, st) was built outside the chunk loop. Returns (A,
    num_beams)."""
    r, _, _ = raycast_sectors(
        smap.table, smap.meta, smap.tiles_shape, smap.tile_size,
        smap.tile_origin, smap.ns, smap.kv_sec, poses2[:, 0].contiguous(),
        poses2[:, 1].contiguous(), ct, st, max_range, bb)
    return apply_extent_mask(r[:, :num_beams], poses2[:, 0], poses2[:, 1],
                             smap.extent, max_range)


def scan_poses_sectors(smap, poses, num_beams: int = 1080,
                       fov: float = 4.712388980384690, max_range=10.0,
                       theta_discretization: int = 0, bb=None,
                       use_pallas=None, mode: str = "auto",
                       agent_chunk=None) -> torch.Tensor:
    """Full lidar scans for poses (..., 3) on the sector backend; returns
    (..., num_beams) ranges. ``poses`` must be on the map's device.

    ``agent_chunk``: agents per chunk. ``None`` chunks only CPU scans, so
    that the plain sweep's gathered lists and (rows, slots, bb)
    intermediates stay bounded; the CUDA kernel's working set does not grow
    with the batch. ``0`` never chunks. Values are identical either way.
    """
    _check_mode(mode, use_pallas)
    bb = sector_block_width(smap, num_beams, fov, bb)
    batch = tuple(poses.shape[:-1])
    poses2 = poses.reshape(-1, 3).to(torch.float32)
    a_n = poses2.shape[0]
    nblk = -(-num_beams // bb)
    k = smap.table.shape[2]
    if agent_chunk is None:
        per_agent = nblk * 4 * k * 4
        agent_chunk = (max(1, _PLAIN_BYTES_BUDGET // per_agent)
                       if smap.table.device.type == "cpu" else 0)
    offs = _padded_offsets(num_beams, fov, bb, poses2.device)
    # the fan is built ONCE for the whole batch, so chunked and unchunked
    # scans see the same directions
    ct, st = fan_cos_sin(poses2[:, 2], offs, theta_discretization)
    if agent_chunk and a_n > agent_chunk:
        r = torch.cat([
            _scan_chunk(smap, poses2[i:i + agent_chunk],
                        ct[i:i + agent_chunk], st[i:i + agent_chunk],
                        num_beams, max_range, bb)
            for i in range(0, a_n, agent_chunk)])
    else:
        r = _scan_chunk(smap, poses2, ct, st, num_beams, max_range, bb)
    return r.reshape(*batch, num_beams)
