"""The port's two hand-written sweeps, their plain versions and routes.

Every scan backend of the port reduces to one of two functions over
axis-aligned boundary segments (the per-pair formulas are in the CUDA
sources):

- the list-routed sweep: ray rows of ``bb`` beams from one origin, each
  row against its own list of an (L, 4, K) table, vertical slots
  [0, n_v) and horizontal slots [h_lo, h_end) from the list's
  ``meta = [n_v, h_lo, h_end]``. ``csrc/sector_sweep.cu``;
- the dense sweep: flat rays, each against every real segment of a (4, K)
  table, slots [0, v_hi) and [h_lo, h_end) from a (3,) ``sweep_meta``.
  ``csrc/dense_sweep.cu``.

Each kernel has its plain PyTorch version here. A wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises. The list kernel serves four TPU kernels of
``pyracecarsimulator_tpu/ops/raycast_pallas.py``; each keeps a wrapper of
its own with its own launch counter (``<wrapper>.launches``), so that a run
shows which path went through the kernel:

- ``sector_sweep``: the sector backend (``_make_fused_tiles_kernel``);
- ``sorted_tiles_sweep``: sector mode ``"sorted_pl"``
  (``_make_sorted_tiles_kernel``);
- ``grp_sweep``: sector ``use_pallas=True`` (``_make_kernel_grp``);
- ``tile_sweep``: the dense backend's map tiles (``_kernel_tiled``).

``dense_sweep`` replaces ``_kernel``. The plain versions visit exactly the
real slots the kernels visit and compute each pair with the same float32
operations, so kernel and plain version agree bit for bit.

``SWEEP_COUNTS`` counts the list sweep's work, ``{"rows", "slots"}``: the
rows swept and the real slots they visited, n_v + h_end - h_lo a row. The
plain version counts on the host; the kernel adds each row to a device
counter (``_kernels.DeviceCounts``, spread over ``COUNT_LANES`` lanes),
which replayed CUDA graphs advance too. Reading ``SWEEP_COUNTS`` reads
those counters (a synchronisation).
"""

from __future__ import annotations

import torch

from . import _kernels

_BIG = 3.0e38
# bytes of each (rays, slots) intermediate the plain sweeps may hold at once
_PLAIN_BYTES_BUDGET = 1 << 28
# lanes of the list kernel's counter: the blocks of a launch add to lane
# row % COUNT_LANES
COUNT_LANES = 128
SWEEP_COUNTS = _kernels.DeviceCounts(("slots", "rows"), COUNT_LANES)


def _hits(p, lo, hi, o_perp, o_along, u_inv, u_along):
    """Masked ray-segment distances: t where the ray hits, 3e38 elsewhere."""
    t = (p - o_perp) * u_inv
    a = o_along + t * u_along
    return torch.where((t >= 0.0) & ((a - lo) * (hi - a) >= 0.0), t, _BIG)


def list_sweep_plain(table, meta, ids, x0, y0, cos_t, sin_t, inv_c, inv_s):
    """Plain PyTorch list-routed sweep: the reference of
    ``csrc/sector_sweep.cu``.

    ``table`` (L, 4, K) f32, ``meta`` (L, 3) i32, ``ids`` (G,) i32 rows,
    ``x0``/``y0`` (G,) row origins, ray tensors (G, bb). Returns the
    unclamped minima (bv, bh), each (G, bb), 3e38 where nothing is hit.

    Each orientation is swept slot-chunk by slot-chunk as (G, chunk, bb)
    tensors, gathering only the chunk's slots of each row's list; slots
    outside a row's real bounds are masked (bounds clamped as the kernel
    clamps them), so the contributing slots are exactly the kernel's, and
    so are the rows and slots it adds to ``SWEEP_COUNTS.host``.
    """
    g_n, bb = cos_t.shape
    k = table.shape[2]
    dev = table.device
    lid = ids.long()
    m = meta.index_select(0, lid)
    h_lo = m[:, 1:2].clamp(0, k)
    nv = torch.minimum(m[:, 0:1].clamp(min=0), h_lo)
    h_end = torch.maximum(m[:, 2:3], h_lo).clamp(max=k)
    SWEEP_COUNTS.host["rows"] += g_n
    SWEEP_COUNTS.host["slots"] += int((nv + h_end - h_lo).sum())
    big = torch.full((g_n, bb), _BIG, dtype=torch.float32, device=dev)
    if g_n == 0:
        return big, big.clone()
    slot = torch.arange(k, device=dev)[None, :]
    chunk = max(1, _PLAIN_BYTES_BUDGET // max(1, g_n * bb * 4))
    x = x0[:, None, None]
    y = y0[:, None, None]
    best = []
    for lo_i, hi_i, vertical in ((0, int(nv.max()), True),
                                 (int(h_lo.min()), int(h_end.max()), False)):
        b = big
        for c0 in range(lo_i, hi_i, chunk):
            c1 = min(c0 + chunk, hi_i)
            seg = table[:, :3, c0:c1].index_select(0, lid)     # (G, 3, ck)
            p, lo, hi = (seg[:, j, :, None] for j in range(3))  # (G, ck, 1)
            s = slot[:, c0:c1]
            real = (s < nv) if vertical else (s >= h_lo) & (s < h_end)
            if vertical:
                t = _hits(p, lo, hi, x, y, inv_c[:, None, :],
                          sin_t[:, None, :])
            else:
                t = _hits(p, lo, hi, y, x, inv_s[:, None, :],
                          cos_t[:, None, :])
            t = torch.where(real[:, :, None], t, _BIG)
            b = torch.minimum(b, t.amin(dim=1))
        best.append(b)
    return best[0], best[1]


def dense_sweep_plain(params, sweep_meta, x, y, cos_t, sin_t, inv_c, inv_s):
    """Plain PyTorch dense sweep: the reference of ``csrc/dense_sweep.cu``.

    ``params`` (4, K) f32, ``sweep_meta`` (3,) i32 [v_hi, h_lo, h_end], ray
    tensors (N,). Returns the unclamped minima (bv, bh), each (N,), 3e38
    where nothing is hit. Reads the bounds on the host (a synchronisation
    on the card: the plain version is a reference there) and sweeps
    exactly the real slots, in chunks of (N, chunk) tensors.
    """
    n = x.shape[0]
    k = params.shape[1]
    m0, m1, m2 = (int(v) for v in sweep_meta.tolist())
    h_lo = min(max(m1, 0), k)
    bounds = ((0, min(max(m0, 0), k)), (h_lo, min(max(m2, h_lo), k)))
    chunk = max(1, _PLAIN_BYTES_BUDGET // max(1, n * 4))
    best = []
    for (lo_i, hi_i), vertical in zip(bounds, (True, False)):
        b = torch.full((n,), _BIG, dtype=torch.float32, device=params.device)
        for c0 in range(lo_i, hi_i, chunk):
            p, lo, hi = (params[j, c0:min(c0 + chunk, hi_i)][None, :]
                         for j in range(3))
            if vertical:
                t = _hits(p, lo, hi, x[:, None], y[:, None], inv_c[:, None],
                          sin_t[:, None])
            else:
                t = _hits(p, lo, hi, y[:, None], x[:, None], inv_s[:, None],
                          cos_t[:, None])
            b = torch.minimum(b, t.amin(dim=1))
        best.append(b)
    return best[0], best[1]


def _check(name, ref, specs):
    """Raise unless every (tensor, dtype, shape) of ``specs`` is a
    contiguous tensor of that dtype and shape on ``ref``'s device."""
    for v, dtype, shape in specs:
        if (v.device != ref.device or v.dtype != dtype
                or tuple(v.shape) != shape or not v.is_contiguous()):
            raise ValueError(
                f"{name}: expected contiguous {dtype} {shape} on "
                f"{ref.device}, got {v.dtype} {tuple(v.shape)} on "
                f"{v.device} (contiguous={v.is_contiguous()})")


def _list_route(name: str, replaces: str):
    """A wrapper of the list kernel with its own launch counter."""

    def sweep(table, meta, ids, x0, y0, cos_t, sin_t, inv_c, inv_s):
        if not _kernels.on_cuda(name, table):
            return list_sweep_plain(table, meta, ids, x0, y0, cos_t, sin_t,
                                    inv_c, inv_s)
        g_n, bb = cos_t.shape
        l_n, four, k = table.shape
        if four != 4 or tuple(meta.shape) != (l_n, 3):
            raise ValueError(f"{name}: table must be (L, 4, K) and meta "
                             f"(L, 3); got {tuple(table.shape)}, "
                             f"{tuple(meta.shape)}")
        if not 0 < bb <= 1024:
            raise ValueError(f"{name}: rows of {bb} beams: one thread per "
                             "beam needs 1..1024")
        if 3 * k * 4 > 48 * 1024:
            raise ValueError(f"{name}: capacity K={k} needs {3 * k * 4} "
                             "bytes of shared memory per row; the kernel "
                             "takes <= 48 KB")
        _check(name, table, (
            (table, torch.float32, (l_n, 4, k)),
            (meta, torch.int32, (l_n, 3)), (ids, torch.int32, (g_n,)),
            (x0, torch.float32, (g_n,)), (y0, torch.float32, (g_n,)),
            *((v, torch.float32, (g_n, bb))
              for v in (cos_t, sin_t, inv_c, inv_s))))
        bv = torch.empty((g_n, bb), dtype=torch.float32, device=table.device)
        bh = torch.empty_like(bv)
        _kernels.launch(name, "sector_sweep", table, meta, ids, x0, y0,
                        cos_t, sin_t, inv_c, inv_s, bv, bh, g_n, bb, k,
                        SWEEP_COUNTS.counter(table.device), COUNT_LANES)
        sweep.launches += 1
        return bv, bh

    sweep.__name__ = sweep.__qualname__ = name
    sweep.__doc__ = (
        f"The list-routed sweep for {replaces}: ``list_sweep_plain`` on CPU "
        "tensors, ``csrc/sector_sweep.cu`` on CUDA tensors. Returns (bv, "
        f"bh), each (G, bb); ``{name}.launches`` counts kernel launches.")
    sweep.launches = 0
    return sweep


sector_sweep = _list_route("sector_sweep", "the sector backend")
sorted_tiles_sweep = _list_route("sorted_tiles_sweep",
                                 "sector mode 'sorted_pl'")
grp_sweep = _list_route("grp_sweep", "sector use_pallas=True")
tile_sweep = _list_route("tile_sweep", "the dense backend's map tiles")


def dense_sweep(params, sweep_meta, x, y, cos_t, sin_t, inv_c, inv_s):
    """The dense sweep: ``dense_sweep_plain`` on CPU tensors,
    ``csrc/dense_sweep.cu`` on CUDA tensors. Rays are flat (N,). Returns
    (bv, bh), each (N,); ``dense_sweep.launches`` counts kernel launches."""
    if not _kernels.on_cuda("dense_sweep", params):
        return dense_sweep_plain(params, sweep_meta, x, y, cos_t, sin_t,
                                 inv_c, inv_s)
    if params.ndim != 2 or params.shape[0] != 4:
        raise ValueError(f"dense_sweep: params must be (4, K), got "
                         f"{tuple(params.shape)}")
    n = x.shape[0]
    k = params.shape[1]
    _check("dense_sweep", params, (
        (params, torch.float32, (4, k)), (sweep_meta, torch.int32, (3,)),
        *((v, torch.float32, (n,))
          for v in (x, y, cos_t, sin_t, inv_c, inv_s))))
    bv = torch.empty((n,), dtype=torch.float32, device=params.device)
    bh = torch.empty_like(bv)
    _kernels.launch("dense_sweep", "dense_sweep", params, sweep_meta, x, y,
                    cos_t, sin_t, inv_c, inv_s, bv, bh, n, k)
    dense_sweep.launches += 1
    return bv, bh


dense_sweep.launches = 0

LIST_ROUTES = (sector_sweep, sorted_tiles_sweep, grp_sweep, tile_sweep)
for _w in LIST_ROUTES + (dense_sweep,):
    _kernels.register(_w)


def launch_counts() -> dict:
    """``{wrapper name: kernel launches so far}`` of every wrapper of
    ``_kernels.wrappers()``: the sweeps', the marches' and the
    stencil's."""
    return {name: w.launches for name, w in _kernels.wrappers().items()}


def add_launches(delta: dict):
    """Add ``delta[name]`` to each named wrapper's counter. A replayed CUDA
    graph launches the kernels it captured without passing through the
    wrappers: ``utils/graph.py`` adds the launches of one replay here, and
    takes back what the capture pass counted while no kernel ran."""
    by_name = _kernels.wrappers()
    for name, n in delta.items():
        by_name[name].launches += n
