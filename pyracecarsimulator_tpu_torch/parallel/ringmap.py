"""Ring map-pass scan: the sector table sharded across ranks.

Counterpart of ``pyracecarsimulator_tpu/parallel/ringmap.py``. Beam-axis
sharding (``parallel/mesh.py``) replicates the sector tables; this module
is the extension for maps that do not fit one device (continent-scale
grids, hundreds of stacked tracks): a ring-pass of map shards between
neighbours during the scan, the ring-attention analogue.

Design: the (L, 4, K) cull table is sharded by list rows over the
``beams`` group (S ranks; each keeps L/S rows, memory / S). Rays stay put;
the map moves: at ring step s, rank d holds slab (d + s) mod S, copies the
resident rows its rays own into a per-ray-row buffer, and passes the slab
to its ring neighbour (``mesh.ring_shift``, S - 1 shifts per scan: one
traversal of the table). After S steps every ray row has its cull list,
and one launch of the list kernel sweeps the gathered rows: the (G, 4, K)
buffer is the table, ``ids = arange(G)``, and the bounds are the rows'
own ``meta`` (the (L, 3) int32 meta is small and stays replicated). The
JAX package sweeps all K slots of the gathered rows instead; the
never-hit sentinels make both the same values, those of the replicated
``scan_poses_sectors`` bit for bit.

Cost model (why this is the extension, not the default): the row copy
runs S times per scan, buying a 1/S per-rank table footprint. That trade
is right exactly when the table cannot be replicated: the ring is a
capacity feature, not a throughput one.

Gradients: the usual analytic O(rays) winner VJP; the backward never
touches the ring (only (r, isv, hit) residuals), so training through a
sharded map costs what training through a replicated one does. As in
``parallel/mesh.py`` the pose gradient is summed over the ``beams`` group.
"""

from __future__ import annotations

import torch

from ..maps.segments import _FAR
from ..ops.common import apply_extent_mask, fan_cos_sin
from ..ops.raycast_grad import _list_minima, raycast_with_vjp
from ..ops.raycast_sectors import _list_ids, sector_block_width
from .mesh import Mesh, _wedge, _wedge_offsets, ring_shift, \
    sum_grad_over_beams


def shard_sector_table(mesh: Mesh, smap):
    """Pad the table's list rows to a multiple of the ``beams`` axis size
    with never-hit sentinel rows and return this rank's slab, rows [i * ls,
    (i + 1) * ls) for its ``beams_index`` i, on the map's device, with the
    slab's row count ``ls``."""
    s, i = mesh.beams, mesh.beams_index
    l_n, _, k = smap.table.shape
    ls = -(-l_n // s)
    slab = smap.table[i * ls:(i + 1) * ls]
    if slab.shape[0] < ls:
        pad = torch.zeros((ls - slab.shape[0], 4, k), dtype=torch.float32,
                          device=slab.device)
        pad[:, 0] = _FAR
        pad[:, 1] = 1.0
        pad[:, 2] = -1.0
        slab = torch.cat([slab, pad])
    return slab.clone(), ls


def _ring_gather(mesh: Mesh, slab, ids, ls: int):
    """The (G, 4, K) rows ``ids`` of the ring-sharded table: S steps of
    "copy the rows my rays own, pass the slab on"."""
    k = slab.shape[2]
    sent = torch.tensor([_FAR, 1.0, -1.0, 0.0], device=slab.device)
    buf = sent[None, :, None].expand(ids.shape[0], 4, k)
    for s in range(mesh.beams):
        rel = ids - ((mesh.beams_index + s) % mesh.beams) * ls
        owned = (rel >= 0) & (rel < ls)
        rows = slab.index_select(0, rel.clamp(0, ls - 1).long())
        buf = torch.where(owned[:, None, None], rows, buf)
        if s + 1 < mesh.beams:
            slab = ring_shift(slab, mesh)
    return buf.contiguous()


def _ring_raycast(mesh: Mesh, slab, meta, ids, ls, x, y, cos_t, sin_t,
                  max_range):
    """Ray ranges from a ring-sharded cull table (module doc). ``slab``:
    this rank's (ls, 4, K) rows; ``meta``: the replicated (L, 3) bounds;
    ``ids``: (G,) global list rows of the local ray rows; ray args (G, bb),
    a row's origin being that of its first beam. The slab, meta and ids
    get no gradient."""

    def minima(x, y, cos_t, sin_t):
        buf = _ring_gather(mesh, slab, ids, ls)
        rows = torch.arange(ids.shape[0], dtype=torch.int32,
                            device=buf.device)
        return _list_minima(buf, meta.index_select(0, ids.long()),
                            rows[:, None], x, y, cos_t, sin_t)

    return raycast_with_vjp(minima, x, y, cos_t, sin_t, max_range)


def make_ring_scan(mesh: Mesh, smap, num_beams: int, fov: float,
                   max_range: float = 10.0):
    """Build ``scan(poses_local) -> ranges_local`` with the sector table
    ring-sharded over the mesh's ``beams`` group (module doc): (A_loc, 3)
    poses, the same on every rank of the group, to the rank's (A_loc,
    B_loc) wedge. Bit-parity with the replicated ``scan_poses_sectors``;
    differentiable in the poses through the analytic VJP. Only this
    rank's slab of ``smap.table`` is kept."""
    _, b_loc = _wedge(mesh, num_beams)
    bb = sector_block_width(smap, num_beams, fov)
    slab, ls = shard_sector_table(mesh, smap)
    meta = smap.meta
    offs = _wedge_offsets(mesh, num_beams, fov, bb, slab.device)
    tiles_shape, tile_size, tile_origin = (smap.tiles_shape, smap.tile_size,
                                           smap.tile_origin)
    ns, extent = smap.ns, smap.extent

    def scan(poses):
        x0, y0, theta = sum_grad_over_beams(mesh, *poses.unbind(-1))
        ct, st = fan_cos_sin(theta, offs)
        a_n, bp = ct.shape
        nblk = bp // bb
        ids = _list_ids(tiles_shape, tile_size, tile_origin, ns, x0, y0,
                        ct, st, bb)                      # (A_loc, NBLK)
        rows = lambda v: v.reshape(a_n * nblk, bb)
        r = _ring_raycast(mesh, slab, meta, ids.reshape(-1), ls,
                          rows(x0[:, None].expand(a_n, bp)),
                          rows(y0[:, None].expand(a_n, bp)), rows(ct),
                          rows(st), max_range)
        r = r.reshape(a_n, bp)[:, :b_loc]
        return apply_extent_mask(r, x0, y0, extent, max_range)

    scan.slab_rows = ls
    return scan
