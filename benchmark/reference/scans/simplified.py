"""The simplified-geometry scan: every range is the first hit of its beam,
within ``max_range``, on the Douglas-Peucker-simplified boundary polylines
of the occupied cells. What the ``segments_simplified`` backend states.

The walls are worked out again from the occupancy grid by the rules that
the backend's map compile states (the port's ``maps/contours.py``, module
doc), written here afresh:

1. Edges: every unit cell edge between an occupied and a free cell
   (outside the grid is free), directed with the occupied cell on its
   left, emitted edges of constant x first, then edges of constant y,
   each kind in row-major order of the cell above or right of the edge.
2. Loops: corners ranked by the first emitted edge leaving them; a loop
   starts at the first ranked corner with an untraced outgoing edge,
   leaves by the earliest such edge, then at each corner turns as far
   left as its untraced edges allow, and ends back at its start. Loops of
   fewer than 4 corners are dropped.
3. Simplification at ``TOL_CELLS``: a loop of 8 or more corners is cut at
   corner 0 and the first corner farthest from it; each half is
   simplified by Douglas-Peucker with its ends kept, splitting at the
   first vertex of the largest float64 distance ``|(dx / L) ry - (dy / L)
   rx|`` from the chord where it exceeds the tolerance.
4. Segments: consecutive vertices of each closed loop, zero lengths
   dropped, as (p0x, p0y, ex, ey, length) in world float64.

``hit`` is a brute-force first hit over every segment, in the world's
dtype, in blocks of rays: for a ray from o along u and a segment from p0
along the unit e, of length L and normal n = (-ey, ex),

    t = ((p0 - o) . n) / (u . n),   s = (o + t u - p0) . e,

a hit where u . n != 0, t >= 0 and 0 <= s <= L; the range is the least t,
``max_range`` where none is under it. The hit's normal is n of the
winning segment, from which ``geometry.differentiable`` takes the range's
gradient.
"""

from __future__ import annotations

import numpy as np
import torch

TOL_CELLS = 1.0          # the backend's Douglas-Peucker tolerance, cells
MIN_SIMPLIFIED = 8       # loops shorter than this are kept whole
MIN_LOOP = 4             # loops shorter than this are dropped
_BLOCK_BYTES = 1 << 28   # one (rays x segments) intermediate, at most


def boundary_edges(occupied: np.ndarray):
    """(E, 2) start and (E, 2) end corners (x, y), int64, in emission
    order (module doc, rule 1)."""
    occ = np.asarray(occupied, bool)
    h, w = occ.shape
    pad = np.zeros((h + 2, w + 2), bool)
    pad[1:-1, 1:-1] = occ
    # constant x = j: cells (i, j - 1) and (i, j)
    west, east = pad[1:-1, :-1], pad[1:-1, 1:]
    i, j = np.nonzero(west != east)
    up = west[i, j]                       # occupied on the -x side
    vs = np.stack([j, np.where(up, i, i + 1)], 1)
    ve = np.stack([j, np.where(up, i + 1, i)], 1)
    # constant y = i: cells (i - 1, j) and (i, j)
    south, north = pad[:-1, 1:-1], pad[1:, 1:-1]
    i, j = np.nonzero(south != north)
    fwd = north[i, j]                     # occupied on the +y side
    hs = np.stack([np.where(fwd, j, j + 1), i], 1)
    he = np.stack([np.where(fwd, j + 1, j), i], 1)
    return (np.concatenate([vs, hs]).astype(np.int64),
            np.concatenate([ve, he]).astype(np.int64))


def _leftmost(arrived, leaving):
    """Rank of a turn from direction ``arrived`` onto ``leaving`` (unit
    axis steps): 2 left, 1 straight on, 0 right."""
    cross = arrived[0] * leaving[1] - arrived[1] * leaving[0]
    if cross > 0:
        return 2
    return 1 if cross == 0 else 0


def trace_loops(occupied: np.ndarray) -> list:
    """Closed boundary loops as (N, 2) int64 corner arrays (rule 2)."""
    starts, ends = boundary_edges(occupied)
    outgoing: dict = {}                   # corner -> untraced edge ids
    for e, a in enumerate(map(tuple, starts)):
        outgoing.setdefault(a, []).append(e)
    ranked = list(outgoing)               # dicts keep first insertion
    loops = []
    cursor = 0
    while True:
        while cursor < len(ranked) and not outgoing[ranked[cursor]]:
            cursor += 1
        if cursor == len(ranked):
            return loops
        first = ranked[cursor]
        corners = [first]
        here, arrived = first, None
        while True:
            left = outgoing[here]
            if not left:
                break
            if arrived is None:
                e = left[0]
            else:
                e = max(left, key=lambda f: _leftmost(
                    arrived, tuple(ends[f] - starts[f])))
            left.remove(e)
            arrived = tuple(ends[e] - starts[e])
            here = tuple(ends[e])
            if here == first:
                break
            corners.append(here)
        if len(corners) >= MIN_LOOP:
            loops.append(np.asarray(corners, np.int64))


def _chord_distances(pts: np.ndarray, a: int, b: int) -> np.ndarray:
    """Float64 distance of pts[a + 1 .. b - 1] from the chord pts[a] ->
    pts[b], rounded operation by operation as rule 3 writes it."""
    dx = float(pts[b, 0] - pts[a, 0])
    dy = float(pts[b, 1] - pts[a, 1])
    rx = (pts[a + 1:b, 0] - pts[a, 0]).astype(np.float64)
    ry = (pts[a + 1:b, 1] - pts[a, 1]).astype(np.float64)
    length = np.hypot(dx, dy)
    if length == 0.0:
        return np.hypot(rx, ry)
    ux = np.float64(dx) / length
    uy = np.float64(dy) / length
    return np.abs(ux * ry - uy * rx)


def douglas_peucker(pts: np.ndarray, tol: float) -> np.ndarray:
    """The kept vertices of an open polyline, its ends kept (rule 3)."""
    kept = {0, len(pts) - 1}
    todo = [(0, len(pts) - 1)]
    while todo:
        a, b = todo.pop()
        if b - a < 2:
            continue
        d = _chord_distances(pts, a, b)
        m = int(np.argmax(d))            # the first of the largest
        if d[m] > tol:
            kept.add(a + 1 + m)
            todo += [(a, a + 1 + m), (a + 1 + m, b)]
    return pts[sorted(kept)]


def simplify(loop: np.ndarray, tol: float) -> np.ndarray:
    if len(loop) < MIN_SIMPLIFIED:
        return loop
    rel = (loop - loop[0]).astype(np.float64)
    far = int(np.argmax(np.hypot(rel[:, 0], rel[:, 1])))
    one = douglas_peucker(loop[:far + 1], tol)
    two = douglas_peucker(np.concatenate([loop[far:], loop[:1]]), tol)
    return np.concatenate([one[:-1], two[:-1]])


def segments(occupied: np.ndarray, resolution: float, origin,
             tol: float = TOL_CELLS) -> np.ndarray:
    """(K, 5) float64 world segments [p0x, p0y, ex, ey, length] (rule 4),
    loop after loop."""
    ox, oy = float(origin[0]), float(origin[1])
    out = []
    for loop in trace_loops(occupied):
        pts = simplify(loop, tol).astype(np.float64)
        nxt = np.roll(pts, -1, axis=0)
        dx, dy = nxt[:, 0] - pts[:, 0], nxt[:, 1] - pts[:, 1]
        length = np.hypot(dx, dy)
        real = length != 0.0
        out.append(np.stack([ox + pts[real, 0] * resolution,
                             oy + pts[real, 1] * resolution,
                             dx[real] / length[real],
                             dy[real] / length[real],
                             length[real] * resolution], 1))
    if not out:
        return np.zeros((0, 5), np.float64)
    return np.concatenate(out)


def prepare(world):
    g = world.grid
    world.segments = torch.as_tensor(
        segments(g.occupied, g.resolution, g.origin), device=world.device)


def hit(world, x0, y0, c, s, max_range):
    """(r, hit, nx, ny) of flat rays in their dtype (module doc). The dot
    products with a segment's n and e go through matrix products: (p0 -
    o) . n as p0 . n - o . n, and s as o . e - p0 . e + t (u . e)."""
    dt = x0.dtype
    px, py, ex, ey, length = world.segments.to(dt).unbind(1)
    nx, ny = -ey, ex
    n = x0.numel()
    r = torch.full((n,), max_range, dtype=dt, device=x0.device)
    got = torch.zeros(n, dtype=torch.bool, device=x0.device)
    hx = torch.zeros_like(r)
    hy = torch.zeros_like(r)
    if px.numel() == 0:
        return r, got, hx, hy
    normal = torch.stack([nx, ny])                     # (2, K)
    along_e = torch.stack([ex, ey])
    p_n = px * nx + py * ny
    p_e = px * ex + py * ey
    inf = torch.tensor(float("inf"), dtype=dt, device=x0.device)
    block = max(1, _BLOCK_BYTES // (8 * px.numel()))
    for a in range(0, n, block):
        b = min(n, a + block)
        o = torch.stack([x0[a:b], y0[a:b]], 1)           # (R, 2)
        u = torch.stack([c[a:b], s[a:b]], 1)
        denom = u @ normal
        t = torch.addmm(p_n, o, normal, alpha=-1).div_(denom)
        along = torch.addmm(p_e, o, along_e, beta=-1).addcmul_(
            t, u @ along_e)
        ok = (t >= 0) & (along >= 0) & (along <= length) & (denom != 0)
        best, win = torch.where(ok, t, inf).min(dim=1)
        near = best < max_range
        r[a:b] = torch.where(near, best, r[a:b])
        got[a:b] = near
        hx[a:b] = torch.where(near, nx[win], 0.0)
        hy[a:b] = torch.where(near, ny[win], 0.0)
    return r, got, hx, hy
