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
kernel or raises. ``list_sweep`` replaces four TPU kernels of
``pyracecarsimulator_tpu/ops/raycast_pallas.py``, and all four run through
it, as do the stacked maps and the ring (their shared row glue is
``raycast_grad._list_minima``):

- ``_make_fused_tiles_kernel``: the sector backend;
- ``_make_sorted_tiles_kernel``: sector mode ``"sorted_pl"``;
- ``_make_kernel_grp``: sector ``use_pallas=True``;
- ``_kernel_tiled``: the dense backend's map tiles.

``dense_sweep`` replaces ``_kernel``. The plain versions visit exactly the
real slots the kernels visit and compute each pair with the same float32
operations, so kernel and plain version agree bit for bit.

``list_scan`` and ``dense_scan`` are the two kernels' second entries, for
scans of poses whose rays take no gradient: from per-agent (cos, sin) of
the headings and per-beam (cos, sin) of the offsets (the list kernel's
fan padded to its rows) each builds each ray and its reciprocals, sweeps
(the row's list; every real segment) and writes the clamped,
extent-masked range of the real beams, in one launch. Their plain
versions are the compositions they replace (``common.rotate_fan``,
``common._ray_invs``, ``list_sweep_plain`` or ``dense_sweep_plain``,
``common.finish_minima``, the slice to the real beams and
``common.apply_extent_mask``).

``SWEEP_COUNTS`` counts the list sweep's work, ``{"slots", "rows",
"kept", "fanned"}``: the rows swept, the real slots of their lists, n_v +
h_end - h_lo a row, the slots the kernel's wedge cull keeps of them (each
row's list less the slots that lie wholly outside the row's own wedge of
rays, ``wedge_edges`` and ``outside_wedge``), which is what the kernel
sweeps, and the rows that ``list_scan`` built from poses. The plain
versions count on the host, culling in the kernel's float32 operations
but sweeping every real slot; the kernel adds each row to a device
counter (``_kernels.DeviceCounts``, spread over ``COUNT_LANES`` lanes),
which replayed CUDA graphs advance too. ``DENSE_COUNTS`` counts the dense
sweep's, ``{"rays", "pairs", "fanned"}``: the rays swept, the ray-segment
pairs they test, v_hi + h_end - h_lo a ray, and the rays that
``dense_scan`` built from poses; ``dense_sweep_plain`` and
``dense_scan_plain`` on the host, the kernel a block at a time on a device
counter of the same kind. ``GENERAL_COUNTS`` counts the general-segment
sweep's (``ops/raycast_general.general_sweep``, the "segments_simplified"
backend), ``{"rays", "pairs"}``: the rays swept and the ray-segment pairs
they test, each ray its list's real slots up to the last; its plain
version on the host, ``csrc/general_sweep.cu`` a block at a time on a
device counter of the same kind. Reading any of them reads those counters
(a synchronisation).
"""

from __future__ import annotations

import torch

from . import _kernels
from ._kernels import COUNT_LANES
from .common import _ray_invs, apply_extent_mask, finish_minima, rotate_fan

_BIG = 3.0e38
# bytes of each (rays, slots) intermediate the plain sweeps may hold at once
_PLAIN_BYTES_BUDGET = 1 << 28
# the list kernel's counter: the blocks of a launch add to lane
# row % COUNT_LANES
SWEEP_COUNTS = _kernels.DeviceCounts(("slots", "rows", "kept", "fanned"),
                                     COUNT_LANES)
# the dense kernel's counter: each block adds to lane block % COUNT_LANES
DENSE_COUNTS = _kernels.DeviceCounts(("rays", "pairs", "fanned"),
                                     COUNT_LANES)
# the general-segment kernel's, the same way
GENERAL_COUNTS = _kernels.DeviceCounts(("rays", "pairs"), COUNT_LANES)
# the list kernel's wedge cull (csrc/sector_sweep.cu, which argues the
# numbers): the least real slots a row culls, the margin's absolute part
# (1 mm) and its part a metre (2^-16), the unit test's tolerance (2^-20)
# and the least cosine to the row's reference ray
CULL_MIN_SLOTS = 32
CULL_ABS = 1.0e-3
CULL_REL = 2.0 ** -16
UNIT_TOL = 2.0 ** -20
MIN_DOT = 0.5
# shared memory the list kernel holds besides its 3 * K staged floats
# (its wedge reduction and kept counters, as ptxas reports them)
_STATIC_SMEM = 656


def _hits(p, lo, hi, o_perp, o_along, u_inv, u_along):
    """Masked ray-segment distances: t where the ray hits, 3e38 elsewhere."""
    t = (p - o_perp) * u_inv
    a = o_along + t * u_along
    return torch.where((t >= 0.0) & ((a - lo) * (hi - a) >= 0.0), t, _BIG)


def _order_key(v):
    """float32 (or, for the gradient tests' float64 rays, float64) ->
    integers of the same width whose signed order is the floats' own, -0
    before +0 (the kernel's ``order_key``, which maps to unsigned
    integers instead)."""
    ity = torch.int32 if v.dtype == torch.float32 else torch.int64
    u = v.contiguous().view(ity)
    return torch.where(u < 0, u ^ torch.iinfo(ity).max, u)


def wedge_edges(cos_t, sin_t, n):
    """The wedge of each row of rays, as ``list_sweep_kernel`` finds it:
    ray tensors (G, bb) and the rows' real slot counts ``n`` (G,) ->
    ``(cull, lx, ly, hx, hy)``, each (G,): whether the row culls at all
    (``n >= CULL_MIN_SLOTS``, every ray finite and unit within
    ``UNIT_TOL`` and within 60 degrees of the middle ray ``bb // 2``), and
    its edge rays: the rays of least and of greatest signed sine against
    the middle ray, the lowest beam among ties for the first and the
    highest for the second."""
    bb = cos_t.shape[1]
    rx = cos_t[:, bb // 2:bb // 2 + 1]
    ry = sin_t[:, bb // 2:bb // 2 + 1]
    unit = ((cos_t * cos_t + sin_t * sin_t) - 1.0).abs() <= UNIT_TOL
    ok = unit & (rx * cos_t + ry * sin_t >= MIN_DOT)
    key = _order_key(rx * sin_t - ry * cos_t)
    beam = torch.arange(bb, device=cos_t.device)
    i_lo = torch.where(key == key.amin(1, keepdim=True), beam, bb).amin(
        1, keepdim=True)
    i_hi = torch.where(key == key.amax(1, keepdim=True), beam, -1).amax(
        1, keepdim=True)
    cull = ok.all(1) & (n >= CULL_MIN_SLOTS)
    return (cull, *(v.gather(1, i)[:, 0] for i in (i_lo, i_hi)
                    for v in (cos_t, sin_t)))


def outside_wedge(ex1, ey1, ex2, ey2, edges, ro):
    """The kernel's cull test, elementwise (in float32 on the kernel's
    inputs): True where the
    segment from (ex1, ey1) to (ex2, ey2), offsets from the row's origin,
    lies wholly on the far side of an edge ray of ``edges = (lx, ly, hx,
    hy)`` by more than the margin ``CULL_ABS + CULL_REL * ((max|ex| +
    max|ey|) + ro)``, ``ro = |x0| + |y0|``. A NaN keeps the slot."""
    lx, ly, hx, hy = edges
    # a Python number in a float32 operation is rounded to float32 first:
    # the kernel's 1.0e-3f and 2^-16
    m = CULL_ABS + CULL_REL * (
        (torch.fmax(ex1.abs(), ex2.abs()) + torch.fmax(ey1.abs(), ey2.abs()))
        + ro)
    low = (lx * ey1 - ly * ex1 < -m) & (lx * ey2 - ly * ex2 < -m)
    high = (hx * ey1 - hy * ex1 > m) & (hx * ey2 - hy * ex2 > m)
    return low | high


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
    so are the rows and slots it adds to ``SWEEP_COUNTS.host``. Every real
    slot is swept; the kernel's wedge cull is only counted (``kept``), so
    that kernel against plain checks that the cull drops nothing hit.
    """
    g_n, bb = cos_t.shape
    k = table.shape[2]
    dev = table.device
    lid = ids.long()
    m = meta.index_select(0, lid)
    h_lo = m[:, 1:2].clamp(0, k)
    nv = torch.minimum(m[:, 0:1].clamp(min=0), h_lo)
    h_end = torch.maximum(m[:, 2:3], h_lo).clamp(max=k)
    n = (nv + h_end - h_lo)[:, 0]
    SWEEP_COUNTS.host["rows"] += g_n
    SWEEP_COUNTS.host["slots"] += int(n.sum())
    big = torch.full((g_n, bb), _BIG, dtype=torch.float32, device=dev)
    if g_n == 0:
        return big, big.clone()
    cull, *edges = wedge_edges(cos_t, sin_t, n)
    edges = [e[:, None] for e in edges]
    ro = (x0.abs() + y0.abs())[:, None]
    kept = torch.zeros(g_n, dtype=torch.int64, device=dev)
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
                ex = p[..., 0] - x0[:, None]
                ends = (ex, lo[..., 0] - y0[:, None], ex,
                        hi[..., 0] - y0[:, None])
            else:
                t = _hits(p, lo, hi, y, x, inv_s[:, None, :],
                          cos_t[:, None, :])
                ey = p[..., 0] - y0[:, None]
                ends = (lo[..., 0] - x0[:, None], ey,
                        hi[..., 0] - x0[:, None], ey)
            t = torch.where(real[:, :, None], t, _BIG)
            b = torch.minimum(b, t.amin(dim=1))
            kept += (real & ~outside_wedge(*ends, edges, ro)).sum(1)
        best.append(b)
    SWEEP_COUNTS.host["kept"] += int(torch.where(cull, kept, n).sum())
    return best[0], best[1]


def dense_sweep_plain(params, sweep_meta, x, y, cos_t, sin_t, inv_c, inv_s):
    """Plain PyTorch dense sweep: the reference of ``csrc/dense_sweep.cu``.

    ``params`` (4, K) f32, ``sweep_meta`` (3,) i32 [v_hi, h_lo, h_end], ray
    tensors (N,). Returns the unclamped minima (bv, bh), each (N,), 3e38
    where nothing is hit. Reads the bounds on the host (a synchronisation
    on the card: the plain version is a reference there) and sweeps
    exactly the real slots, in chunks of (N, chunk) tensors; adds the rays
    and their pairs to ``DENSE_COUNTS.host``.
    """
    n = x.shape[0]
    k = params.shape[1]
    m0, m1, m2 = (int(v) for v in sweep_meta.tolist())
    h_lo = min(max(m1, 0), k)
    bounds = ((0, min(max(m0, 0), k)), (h_lo, min(max(m2, h_lo), k)))
    DENSE_COUNTS.host["rays"] += n
    DENSE_COUNTS.host["pairs"] += n * sum(hi - lo for lo, hi in bounds)
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


def list_sweep(table, meta, ids, x0, y0, cos_t, sin_t, inv_c, inv_s):
    """The list-routed sweep: ``list_sweep_plain`` on CPU tensors,
    ``csrc/sector_sweep.cu`` on CUDA tensors. Returns (bv, bh), each (G,
    bb); ``list_sweep.launches`` counts kernel launches."""
    if not _kernels.on_cuda("list_sweep", table):
        return list_sweep_plain(table, meta, ids, x0, y0, cos_t, sin_t,
                                inv_c, inv_s)
    g_n, bb = cos_t.shape
    l_n, four, k = table.shape
    if four != 4 or tuple(meta.shape) != (l_n, 3):
        raise ValueError(f"list_sweep: table must be (L, 4, K) and meta "
                         f"(L, 3); got {tuple(table.shape)}, "
                         f"{tuple(meta.shape)}")
    if not 0 < bb <= 1024:
        raise ValueError(f"list_sweep: rows of {bb} beams: one thread per "
                         "beam needs 1..1024")
    if 3 * k * 4 + _STATIC_SMEM > 48 * 1024:
        raise ValueError(f"list_sweep: capacity K={k} needs {3 * k * 4} "
                         "bytes of shared memory per row beside the "
                         f"kernel's own {_STATIC_SMEM}; the kernel "
                         "takes <= 48 KB")
    _check("list_sweep", table, (
        (table, torch.float32, (l_n, 4, k)),
        (meta, torch.int32, (l_n, 3)), (ids, torch.int32, (g_n,)),
        (x0, torch.float32, (g_n,)), (y0, torch.float32, (g_n,)),
        *((v, torch.float32, (g_n, bb))
          for v in (cos_t, sin_t, inv_c, inv_s))))
    bv = torch.empty((g_n, bb), dtype=torch.float32, device=table.device)
    bh = torch.empty_like(bv)
    _kernels.launch("list_sweep", "sector_sweep", table, meta, ids, x0, y0,
                    cos_t, sin_t, inv_c, inv_s, bv, bh, g_n, bb, k,
                    SWEEP_COUNTS.counter(table.device), COUNT_LANES)
    return bv, bh


def list_scan_plain(table, meta, ids, x0, y0, cth, sth, cd, sd, max_range,
                    extent, num_beams):
    """Plain PyTorch scan of poses over a list-routed table: the reference
    of ``csrc/sector_sweep.cu``'s from-poses entry, and the composition it
    replaces. ``ids`` (A, NBLK) int32 rows of ``table``; ``x0``, ``y0``,
    ``cth``, ``sth`` (A,) the agents' origins and headings' cos and sin;
    ``cd``, ``sd`` (NBLK * bb,) the padded beam offsets' cos and sin.
    Returns (A, ``num_beams``) ranges clamped to ``max_range``, all
    ``max_range`` for an origin outside ``extent``. Counts its rows in
    ``SWEEP_COUNTS.host["fanned"]``."""
    a_n, nblk = ids.shape
    g_n = a_n * nblk
    bb = cd.shape[0] // max(nblk, 1)
    cos_t, sin_t = rotate_fan(cth, sth, cd, sd)
    inv_c, inv_s = _ray_invs(cos_t, sin_t)
    rows = lambda v: v.reshape(g_n, bb)
    bv, bh = list_sweep_plain(table, meta, ids.reshape(g_n),
                              x0.repeat_interleave(nblk),
                              y0.repeat_interleave(nblk), rows(cos_t),
                              rows(sin_t), rows(inv_c), rows(inv_s))
    SWEEP_COUNTS.host["fanned"] += g_n
    r = finish_minima(bv.reshape(cos_t.shape), bh.reshape(cos_t.shape),
                      max_range)[0]
    return apply_extent_mask(r[:, :num_beams], x0, y0, extent, max_range)


def list_scan(table, meta, ids, x0, y0, cth, sth, cd, sd, max_range,
              extent, num_beams):
    """The list-routed scan of poses (``list_scan_plain``'s arguments and
    result): ``list_scan_plain`` on CPU tensors, the from-poses entry of
    ``csrc/sector_sweep.cu`` on CUDA tensors, one launch;
    ``list_scan.launches`` counts them. ``max_range`` and ``extent`` are
    numbers, compared in float32 as the plain version compares them."""
    if not _kernels.on_cuda("list_scan", table):
        return list_scan_plain(table, meta, ids, x0, y0, cth, sth, cd, sd,
                               max_range, extent, num_beams)
    a_n, nblk = ids.shape
    n_pad = cd.shape[0]
    l_n, four, k = table.shape
    bb = n_pad // nblk if nblk else 0
    if four != 4 or tuple(meta.shape) != (l_n, 3):
        raise ValueError(f"list_scan: table must be (L, 4, K) and meta "
                         f"(L, 3); got {tuple(table.shape)}, "
                         f"{tuple(meta.shape)}")
    if not (0 < bb <= 1024 and bb * nblk == n_pad
            and 0 <= num_beams <= n_pad):
        raise ValueError(f"list_scan: {n_pad} padded beams do not make "
                         f"{nblk} rows of 1..1024 beams holding "
                         f"{num_beams} real ones")
    if 3 * k * 4 + _STATIC_SMEM > 48 * 1024:
        raise ValueError(f"list_scan: capacity K={k} needs {3 * k * 4} "
                         "bytes of shared memory per row beside the "
                         f"kernel's own {_STATIC_SMEM}; the kernel "
                         "takes <= 48 KB")
    _check("list_scan", table, (
        (table, torch.float32, (l_n, 4, k)),
        (meta, torch.int32, (l_n, 3)), (ids, torch.int32, (a_n, nblk)),
        *((v, torch.float32, (a_n,)) for v in (x0, y0, cth, sth)),
        *((v, torch.float32, (n_pad,)) for v in (cd, sd))))
    out = torch.empty((a_n, num_beams), dtype=torch.float32,
                      device=table.device)
    _kernels.launch("list_scan", "list_scan", table, meta, ids, x0, y0, cth,
                    sth, cd, sd, out, a_n, nblk, bb, k, num_beams,
                    float(max_range), *(float(e) for e in extent),
                    SWEEP_COUNTS.counter(table.device), COUNT_LANES)
    return out


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
                    cos_t, sin_t, inv_c, inv_s, bv, bh, n, k,
                    DENSE_COUNTS.counter(params.device), COUNT_LANES)
    return bv, bh


def dense_scan_plain(params, sweep_meta, x0, y0, cth, sth, cd, sd,
                     max_range, extent):
    """Plain PyTorch scan of poses over every real segment: the reference
    of ``csrc/dense_sweep.cu``'s from-poses entry, and the composition it
    replaces. ``params`` (4, K) f32 and ``sweep_meta`` (3,) i32 as in
    ``dense_sweep_plain``; ``x0``, ``y0``, ``cth``, ``sth`` (A,) the
    agents' origins and headings' cos and sin; ``cd``, ``sd`` (B,) the beam
    offsets' cos and sin. Returns (A, B) ranges clamped to ``max_range``,
    all ``max_range`` for an origin outside ``extent``. Counts its rays in
    ``DENSE_COUNTS.host["fanned"]``."""
    cos_t, sin_t = rotate_fan(cth, sth, cd, sd)
    inv_c, inv_s = _ray_invs(cos_t, sin_t)
    flat = lambda v: v.reshape(-1)
    bv, bh = dense_sweep_plain(
        params, sweep_meta, flat(x0[:, None].expand(cos_t.shape)),
        flat(y0[:, None].expand(cos_t.shape)), flat(cos_t), flat(sin_t),
        flat(inv_c), flat(inv_s))
    DENSE_COUNTS.host["fanned"] += cos_t.numel()
    r = finish_minima(bv.reshape(cos_t.shape), bh.reshape(cos_t.shape),
                      max_range)[0]
    return apply_extent_mask(r, x0, y0, extent, max_range)


def dense_scan(params, sweep_meta, x0, y0, cth, sth, cd, sd, max_range,
               extent):
    """The dense scan of poses (``dense_scan_plain``'s arguments and
    result): ``dense_scan_plain`` on CPU tensors, the from-poses entry of
    ``csrc/dense_sweep.cu`` on CUDA tensors, one launch;
    ``dense_scan.launches`` counts them. ``max_range`` and ``extent`` are
    numbers, compared in float32 as the plain version compares them."""
    if not _kernels.on_cuda("dense_scan", params):
        return dense_scan_plain(params, sweep_meta, x0, y0, cth, sth, cd, sd,
                                max_range, extent)
    if params.ndim != 2 or params.shape[0] != 4:
        raise ValueError(f"dense_scan: params must be (4, K), got "
                         f"{tuple(params.shape)}")
    a_n, b_n = x0.shape[0], cd.shape[0]
    k = params.shape[1]
    if a_n * b_n >= 2 ** 31:
        raise ValueError(f"dense_scan: {a_n} agents x {b_n} beams: one "
                         "thread a ray needs fewer than 2^31 rays")
    _check("dense_scan", params, (
        (params, torch.float32, (4, k)), (sweep_meta, torch.int32, (3,)),
        *((v, torch.float32, (a_n,)) for v in (x0, y0, cth, sth)),
        *((v, torch.float32, (b_n,)) for v in (cd, sd))))
    out = torch.empty((a_n, b_n), dtype=torch.float32, device=params.device)
    _kernels.launch("dense_scan", "dense_scan", params, sweep_meta, x0, y0,
                    cth, sth, cd, sd, out, a_n, b_n, k, float(max_range),
                    *(float(e) for e in extent),
                    DENSE_COUNTS.counter(params.device), COUNT_LANES)
    return out


_kernels.register(list_sweep)
_kernels.register(list_scan)
_kernels.register(dense_sweep)
_kernels.register(dense_scan)


def launch_counts() -> dict:
    """``{wrapper name: kernel launches so far}`` of every wrapper of
    ``_kernels.wrappers()``: the sweeps', the marches', the stencil's
    and the car step's."""
    return {name: w.launches for name, w in _kernels.wrappers().items()}


def add_launches(delta: dict):
    """Add ``delta[name]`` to each named wrapper's counter. A replayed CUDA
    graph launches the kernels it captured without passing through the
    wrappers: ``utils/graph.py`` adds the launches of one replay here, and
    takes back what the capture pass counted while no kernel ran."""
    by_name = _kernels.wrappers()
    for name, n in delta.items():
        by_name[name].launches += n
