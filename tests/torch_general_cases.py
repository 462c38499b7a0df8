"""Adversarial inputs of the general-segment sweep (``ops/raycast_general``
``general_sweep``), shared by its CPU tests, its card tests and
``chip_smoke.py`` phase 14. NumPy, torch and the port only (no JAX): the
card's machine imports it too.

``adversarial(seed)`` returns ``(table, ids, rays)``: a (4, 6, 1024)
float32 table (``_fit_chunk(1024) == 512``: two chunks a list), the
(rows,) int32 list of each row and the rays (x, y, cos, sin), each
(rows, cols) float32, cols 100 (a ragged edge on the card). The lists:

0. grid geometry: 700 segments whose endpoints lie on a 0.25 m grid, in
   the eight directions of the compass, and rays from grid points along
   the same eight directions, so that many ranges are exact, hits fall on
   segment endpoints (s = 0 and s = L) and distinct segments tie; exact
   copies tie inside a chunk (slot 5 in 40) and across the chunk cut
   (slots 100-109 in 512-521); a padding slot (300) before the last real
   one;
1. special slots: a tie across the cut (slots 511 and 512, t = 1 for a
   ray from (0, 10) along +x, different normals) and inside the first
   chunk (slots 10 and 20); denominators 0 (slot 70, collinear with +x)
   and subnormal (slots 30-59, hits at t ~ 1-4 through directions
   (1, +-k 1e-40)); a quotient that rounds to -0, a valid t (slot 71,
   for the ray from the origin along (-1e30, 0)); segments crossed at
   t = 1.5e38, 3e38, 3.2e38 and beyond float32 (slots 80-85), early in
   the list;
2. padding only (no real slot);
3. 300 random segments (any direction, 0.1-3 m) in an 8 m box.

Rows: 16, each on list ``ids[r]``; row 0 from (0, 10), rows 1-3 from
the origin (list 1 for rows 0 and 1), rows 4-5 from x = -1.5e38 and
-3e38 (list 1), row 6 with a NaN origin, the rest from random grid
points. Columns 0-15: the eight compass directions twice (exact: 1, 0,
+-sqrt(0.5)); 16-19 NaN or zero directions; 20 (-1e30, 0); the rest
random angles.

``unknown_ids(ids)``: the same rows with rows 2 and 9 on lists 4 and -1
(no such list: the sweep gives NaN there).

``general_pair_counts(args, winner)``: the real pairs of a sweep and those
that lower or tie the running minimum, from the plain version: what
``chip_smoke.py``'s bound of the sweep counts, and what the CPU tests
hold the kernel's emulated loop to.
"""

import numpy as np
import torch

K = 1024
ROWS, COLS = 16, 100
_H = np.float32(np.sqrt(0.5))
_DIRS = np.array([[1, 0], [_H, _H], [0, 1], [-_H, _H], [-1, 0],
                  [-_H, -_H], [0, -1], [_H, -_H]], np.float32)


def _padding(k):
    out = np.zeros((6, k), np.float32)
    out[2] = 1.0
    out[4] = -1.0
    return out


def _grid_list(rng):
    tbl = _padding(K)
    n = 700
    p0 = rng.randint(-16, 17, size=(n, 2)).astype(np.float32) * 0.25
    d = _DIRS[rng.randint(8, size=n)]
    steps = rng.randint(1, 9, size=n).astype(np.float32)
    # an axis-aligned segment's length is a grid multiple; a diagonal's
    # the float32 length of its grid span
    length = np.where((d[:, 0] == 0) | (d[:, 1] == 0), steps * 0.25,
                      np.float32(0.25) * steps / _H).astype(np.float32)
    tbl[0, :n], tbl[1, :n] = p0[:, 0], p0[:, 1]
    tbl[2, :n], tbl[3, :n] = d[:, 0], d[:, 1]
    tbl[4, :n] = length
    tbl[:, 40] = tbl[:, 5]
    tbl[:, 512:522] = tbl[:, 100:110]
    tbl[:, 300] = _padding(1)[:, 0]
    return tbl


def _special_list(rng):
    tbl = _padding(K)
    seg = lambda q, *v: tbl.__setitem__((slice(0, 5), q), v)
    # ties at t = 1 for the ray from (0, 10) along +x
    seg(511, 1.0, 9.0, 0.0, 1.0, 1.0)           # ends at (1, 10): s = L
    seg(512, 1.0, 10.0, _H, -_H, 1.0)           # starts there: s = 0
    seg(10, 1.0, 10.0, 0.0, 1.0, 1.0)           # starts there, upwards
    seg(20, 1.0, 10.0, _H, _H, 2.0)
    # subnormal denominators: nearly parallel to +x, crossing y = 0 at
    # x ~ 1-4 for rays from the origin
    for i, q in enumerate(range(30, 60)):
        ey = np.float32((i % 7 + 1) * 1e-40) * (1 if i % 2 else -1)
        y0 = np.float32(-ey * (1 + i % 4))
        seg(q, np.float32(rng.uniform(-1, 0)), y0, 1.0, ey, 6.0)
    seg(70, 0.5, 0.0, 1.0, 0.0, 1.0)            # collinear: denom 0
    # for a ray from the origin along (-1e30, 0): num = -2^-149, denom
    # 1e30, a quotient that rounds to -0, a valid t = -0
    seg(71, np.float32(2.0 ** -149), -1.0, 0.0, 1.0, 2.0)
    # far crossings: for rays from the origin t = 1.5e38 (80); from x =
    # -1.5e38, t = 3e38 (81), 3.2e38 (82), 1.5e38 (80); from -3e38 the
    # numerator of 83-85 overflows
    seg(80, 1.5e38, -1.0, 0.0, 1.0, 2.0)
    seg(81, 1.5e38, -1.0, 0.0, 1.0, 2.0)
    seg(82, 1.7e38, -1.0, 0.0, 1.0, 2.0)
    seg(83, 3.0e38, -1.0, 0.0, 1.0, 2.0)
    seg(84, 3.4e38, -2.0, 0.0, 1.0, 4.0)
    seg(85, -3.0e38, -1.0, 0.0, 1.0, 2.0)
    return tbl


def _random_list(rng):
    tbl = _padding(K)
    n = 300
    th = rng.uniform(-np.pi, np.pi, n)
    tbl[0, :n] = rng.uniform(-4, 4, n)
    tbl[1, :n] = rng.uniform(-4, 4, n)
    tbl[2, :n] = np.cos(th)
    tbl[3, :n] = np.sin(th)
    tbl[4, :n] = rng.uniform(0.1, 3.0, n)
    return tbl


def adversarial(seed=0, device="cpu"):
    rng = np.random.RandomState(seed)
    table = np.stack([_grid_list(rng), _special_list(rng), _padding(K),
                      _random_list(rng)]).astype(np.float32)
    ids = rng.randint(4, size=ROWS).astype(np.int32)
    ids[[0, 1, 4, 5]] = 1
    x = (rng.randint(-12, 13, size=ROWS) * 0.25).astype(np.float32)
    y = (rng.randint(-12, 13, size=ROWS) * 0.25).astype(np.float32)
    x[:4] = y[:4] = 0.0
    y[0] = 10.0
    x[4], x[5], y[4], y[5] = -1.5e38, -3e38, 0.0, 0.0
    x[6] = np.nan
    th = rng.uniform(-np.pi, np.pi, size=(ROWS, COLS))
    c, s = np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)
    c[:, :16], s[:, :16] = _DIRS[np.arange(16) % 8].T[:, None, :]
    c[:, 16], s[:, 17] = np.nan, np.nan
    c[:, 18:20] = s[:, 18:20] = 0.0
    c[:, 20], s[:, 20] = -1e30, 0.0
    xs = np.repeat(x[:, None], COLS, 1)
    ys = np.repeat(y[:, None], COLS, 1)
    as_t = lambda a: torch.tensor(np.ascontiguousarray(a), device=device)
    return (as_t(table), as_t(ids), [as_t(v) for v in (xs, ys, c, s)])


def unknown_ids(ids):
    out = ids.clone()
    out[2], out[9] = 4, -1
    return out


def general_pair_counts(args, winner, block_rows=256):
    """The real pairs of one general sweep on ``args`` (each ray against
    the slots of its list whose length is >= 0) and, counted from the
    plain version's pair ranges (``raycast_general._pairs``) in the list's
    order, the pairs whose range lowers the running minimum of the
    earlier slots (winner: lowers or ties it): {"pairs", "full_pairs"}.
    Rows go in blocks of ``block_rows``."""
    from pyracecarsimulator_tpu_torch.ops import raycast_general as rg
    from pyracecarsimulator_tpu_torch.ops.raymarch_xla import _as_rows
    table, ids = args[:2]
    rays = [_as_rows(v) for v in torch.broadcast_tensors(*args[2:])]
    rows, cols = rays[0].shape
    real = (table[:, 4, :] >= 0).sum(dim=1)
    lists = (ids.long() if ids is not None else
             torch.zeros(rows, dtype=torch.long, device=table.device))
    full = 0
    big = torch.tensor(rg._BIG, dtype=torch.float32, device=table.device)
    for r0 in range(0, rows, block_rows):
        sel = table[lists[r0:r0 + block_rows]]
        t = rg._pairs(sel[:, :5, None, :].unbind(1),
                      *(v[r0:r0 + block_rows, :, None] for v in rays))[0]
        before = torch.cat([big.expand(*t.shape[:2], 1),
                            torch.cummin(t, dim=-1).values[..., :-1]], -1)
        wins = (t <= before) if winner else (t < before)
        full += int((wins & (t < big)).sum())
    return {"pairs": int(real[lists].sum()) * cols, "full_pairs": full}
