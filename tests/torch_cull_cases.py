"""Rows and lists for the list kernel's wedge cull (``ops/sweeps``
``wedge_edges`` and ``outside_wedge``, which ``csrc/sector_sweep.cu``
repeats), shared by its tests (``test_torch_sweep_cull.py``,
``test_torch_sweep_counts.py``, ``test_torch_kernels.py``). NumPy, torch
and the port only (no JAX): the card's machine imports it too.

``row_args`` and ``fan_args`` build the sweep's arguments; ``cull_masks``
gives each row's real slots and the slots the cull keeps of them, apart
from the sweep; ``only_slots`` cuts each row's list to a mask of its
slots, so that a sweep over the kept slots alone, or the dropped ones
alone, can be held against the sweep over the whole list; ``built_case``
builds rows at the cull's edges (``BUILT_CASES``), which the card's tests
(``test_torch_kernels.py``) run through the kernel too.
"""

import math

import numpy as np
import torch

from pyracecarsimulator_tpu_torch.ops import sweeps
from pyracecarsimulator_tpu_torch.ops.common import (_padded_offsets,
                                                     _ray_invs, fan_cos_sin)

FOV = 4.712388980384690
# the built rows of ``built_case``
BUILT_CASES = ("endpoint_on_edge_ray", "segment_through_origin",
               "row_of_180_degrees", "row_of_121_degrees",
               "non_finite_direction", "infinite_direction",
               "non_unit_direction", "one_beam", "axis_aligned_beams",
               "padding_beams", "partial_warp", "short_list")


def row_args(table, meta, ids, x0, y0, ct, st):
    """The sweep's arguments: (G,) rows of (G, bb) rays, float32."""
    ic, is_ = _ray_invs(ct, st)
    return (table, meta, ids.to(torch.int32).contiguous(),
            x0.contiguous(), y0.contiguous(),
            *(v.contiguous() for v in (ct, st, ic, is_)))


def fan_args(table, meta, ids, p, bb, beams=1080, fov=FOV):
    """Arguments for poses ``p`` whose padded fan of ``bb``-beam rows
    (``beams`` over ``fov``) routes to ``ids`` (A, NBLK)."""
    ct, st = fan_cos_sin(p[:, 2], _padded_offsets(beams, fov, bb,
                                                  p.device))
    g = ids.numel()
    nblk = g // p.shape[0]
    return row_args(table, meta, ids.reshape(g),
                    p[:, 0].repeat_interleave(nblk),
                    p[:, 1].repeat_interleave(nblk),
                    ct.reshape(g, bb), st.reshape(g, bb))


def cull_masks(args):
    """(real, kept) (G, K) masks of each row's slots: its real slots, and
    those the cull keeps (every real slot of a row that does not cull)."""
    table, meta, ids, x0, y0, ct, st = args[:7]
    k = table.shape[2]
    m = meta[ids.long()]
    h_lo = m[:, 1:2].clamp(0, k)
    nv = torch.minimum(m[:, 0:1].clamp(min=0), h_lo)
    h_end = torch.maximum(m[:, 2:3], h_lo).clamp(max=k)
    slot = torch.arange(k, device=table.device)[None, :]
    vert = slot < nv
    real = vert | ((slot >= h_lo) & (slot < h_end))
    cull, *edges = sweeps.wedge_edges(ct, st, (nv + h_end - h_lo)[:, 0])
    seg = table[ids.long()]
    p, lo, hi = seg[:, 0], seg[:, 1], seg[:, 2]
    x, y = x0[:, None], y0[:, None]
    ends = [torch.where(vert, a, b) for a, b in (
        (p - x, lo - x), (lo - y, p - y), (p - x, hi - x), (hi - y, p - y))]
    out = sweeps.outside_wedge(*ends, [e[:, None] for e in edges],
                               (x0.abs() + y0.abs())[:, None])
    return real, real & ~(out & cull[:, None])


def only_slots(args, keep):
    """The sweep's arguments with each row's list cut to the slots of
    ``keep`` (G, K), compacted: a list a row, vertical slots first."""
    table, meta, ids = args[:3]
    k = table.shape[2]
    seg = table[ids.long()]
    m = meta[ids.long()]
    nv = torch.minimum(m[:, 0:1].clamp(min=0), m[:, 1:2].clamp(0, k))
    vert = torch.arange(k, device=table.device)[None, :] < nv
    rank = torch.where(keep & vert, 0, torch.where(keep, 1, 2))
    order = torch.sort(rank, dim=1, stable=True).indices
    width = max(1, int(keep.sum(1).max()))
    seg = seg.gather(2, order[:, None, :].expand_as(seg))[:, :, :width]
    n_v = (keep & vert).sum(1)
    n = keep.sum(1)
    new_meta = torch.stack([n_v, n_v, n], 1).to(torch.int32)
    return (seg.contiguous(), new_meta,
            torch.arange(ids.numel(), dtype=torch.int32, device=ids.device),
            *args[3:])


def _ring(rng, n_v=40, n_h=40, reach=6.0):
    """A (1, 4, K) list of random segments all around the origin, ``n_v``
    vertical then ``n_h`` horizontal (mixed layout), and its meta."""
    k = n_v + n_h
    t = np.zeros((1, 4, k), np.float32)
    t[0, 0] = rng.uniform(-reach, reach, k)
    a = rng.uniform(-reach, reach, k)
    t[0, 1] = a
    t[0, 2] = a + rng.uniform(0.1, 2.0, k)
    t[0, 3, :n_v] = 1.0
    meta = np.array([[n_v, n_v, k]], np.int32)
    return t, meta


def rows_of(angles, origin=(0.0, 0.0)):
    """One row from ``origin`` with beams at ``angles`` (float32 cos, sin
    of the float64 angles)."""
    a = np.asarray(angles, np.float64)
    ct = torch.tensor(np.cos(a), dtype=torch.float32)[None, :]
    st = torch.tensor(np.sin(a), dtype=torch.float32)[None, :]
    return (torch.tensor([origin[0]], dtype=torch.float32),
            torch.tensor([origin[1]], dtype=torch.float32), ct, st)


def _with(table, meta, extra_v=(), extra_h=()):
    """``table`` with vertical segments (x, y_lo, y_hi) and horizontal ones
    (y, x_lo, x_hi) added to its list."""
    n_v, _, n = (int(v) for v in meta[0])
    cols = ([table[0, :, :n_v]]
            + [np.array([[p], [a], [b], [1.0]], np.float32)
               for p, a, b in extra_v]
            + [table[0, :, n_v:n]]
            + [np.array([[p], [a], [b], [0.0]], np.float32)
               for p, a, b in extra_h])
    t = np.concatenate(cols, 1)[None]
    nv2 = n_v + len(extra_v)
    return t, np.array([[nv2, nv2, t.shape[2]]], np.int32)


def built_case(name):
    """(table, meta, (x0, y0, ct, st), whether the row culls) of the built
    case ``name`` (``BUILT_CASES``): one row over a list of random
    segments all around its origin, 40 vertical then 40 horizontal, with
    the case's slots added."""
    rng = np.random.RandomState(11)
    table, meta = _ring(rng)
    wedge = np.linspace(0.0, 0.4, 128)
    if name == "endpoint_on_edge_ray":
        # the low edge ray is the x axis: (3, 0) lies on it exactly, and
        # the high edge's endpoint lies on its float32 direction
        c, s = np.float32(np.cos(0.4)), np.float32(np.sin(0.4))
        table, meta = _with(table, meta, extra_v=[(3.0, -1.0, 0.0)],
                            extra_h=[(float(np.float32(4 * s)),
                                      float(np.float32(4 * c)), 9.0)])
        return table, meta, rows_of(wedge), True
    if name == "segment_through_origin":
        table, meta = _with(table, meta, extra_v=[(0.0, -1.0, 1.0)],
                            extra_h=[(0.0, -2.0, 0.5)])
        return table, meta, rows_of(wedge), True
    if name == "row_of_180_degrees":
        return table, meta, rows_of(np.linspace(-1.6, 1.6, 128)), False
    if name == "row_of_121_degrees":
        return table, meta, rows_of(np.linspace(0.0, 2.12, 128)), False
    if name == "non_finite_direction":
        rows = rows_of(wedge)
        rows[2][0, 5] = float("nan")
        return table, meta, rows, False
    if name == "infinite_direction":
        rows = rows_of(wedge)
        rows[3][0, 100] = float("inf")
        return table, meta, rows, False
    if name == "non_unit_direction":
        rows = rows_of(wedge)
        rows[2][0] *= 1.001
        rows[3][0] *= 1.001
        return table, meta, rows, False
    if name == "one_beam":
        return table, meta, rows_of([0.7], origin=(0.3, -0.2)), True
    if name == "axis_aligned_beams":
        # 0 and pi/2 exactly in float32 (NaN reciprocals), pi in between
        rows = rows_of(np.linspace(0.0, 0.5 * np.pi, 128))
        rows[2][0, 0], rows[3][0, 0] = 1.0, 0.0
        rows[2][0, -1], rows[3][0, -1] = 0.0, 1.0
        return table, meta, rows, True
    if name == "padding_beams":
        # an agent's ninth row: 56 real beams, the last repeated 72 times
        offs = np.linspace(-0.5, -0.5 + 55 * math.radians(0.25), 56)
        return (table, meta,
                rows_of(np.concatenate([offs, np.full(72, offs[-1])]),
                         origin=(-1.5, 2.0)), True)
    if name == "partial_warp":
        # 45 beams: a warp and a ragged one of 13
        return (table, meta, rows_of(np.linspace(1.0, 1.2, 45),
                                     origin=(0.5, 0.5)), True)
    if name == "short_list":
        n = sweeps.CULL_MIN_SLOTS - 1
        short = np.array([[n // 2, n // 2, n]], np.int32)
        return table, short, rows_of(wedge), False
    raise KeyError(name)
