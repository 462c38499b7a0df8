"""Plain PyTorch reference of the lidar scan: the distance field, the exact
first boundary hit, and the distance-transform march with its refinement.

Everything takes a ``dtype`` (float64 for the reference, bfloat16 for the
control) and works on flat ray tensors. Nothing here reads the program:
the distance field and the wall geometry are worked out again from the
occupancy grid the benchmark loaded.

Geometry of the grid: cell (i, j) covers world ``[ox + j res, ox + (j+1)
res] x [oy + i res, oy + (i+1) res]``; outside the grid is free space.

``first_hit`` is the exact scan of the segment backends: a ray's range is
the distance to the first cell edge it crosses where the occupancy
changes (the boundary of the occupied cells), found by walking the grid
line by line; no hit within ``max_range`` gives ``max_range``.

``march_hit`` is the upstream simulator's distance-transform stepping
(nearest cell sample, hit at ``eps``, ``max_iters`` trips, out of the map
a miss) followed by the hit's placement on the level set ``E = tau``,
``tau = max(eps, res / 2)``, of the bilinear distance field (cell-center
samples): bisection over the last step plus 0.4 cells, 12 halvings, then
one Newton step from the outside end with the slope floored at
``-slope_floor``.

Both return what the gradient needs: the range, whether it counts as a
hit for the gradient, and the surface normal (nx, ny) whose first-order
change moves the range, ``dr = -(n . d(origin) + r n . d(direction)) /
(n . direction)``: the exact scan's hit edge (n = (1, 0) on an edge of
constant x, (0, 1) on one of constant y), the march's bilinear slope
(the implicit function theorem on ``E(p(r)) = tau``). ``differentiable``
turns that into a range that carries this gradient.
"""

from __future__ import annotations

import math

import torch

_COMPACT_EVERY = 4      # trips between compactions of the live rays


def distance_field(occupied: torch.Tensor, resolution: float,
                   dtype=torch.float64) -> torch.Tensor:
    """Exact euclidean distance, in meters, from each cell center to the
    nearest occupied cell center: per row the distance to the nearest
    occupied cell of the row, then per column the least of ``dy^2 +
    row^2`` over every row."""
    h, w = occupied.shape
    dev = occupied.device
    big = float(4 * (h + w))
    idx = torch.arange(w, device=dev, dtype=torch.float64)[None, :]
    last = torch.cummax(torch.where(occupied, idx, -big), dim=1).values
    nxt = -torch.flip(torch.cummax(torch.flip(
        torch.where(occupied, -idx, -big), [1]), dim=1).values, [1])
    row2 = torch.minimum(idx - last, nxt - idx) ** 2           # (h, w)
    ys = torch.arange(h, device=dev, dtype=torch.float64)
    dy2 = (ys[:, None] - ys[None, :]) ** 2                     # (h, h)
    chunk = max(1, (1 << 27) // (h * h))
    out = torch.empty((h, w), dtype=torch.float64, device=dev)
    for c0 in range(0, w, chunk):
        cols = row2[:, c0:c0 + chunk]
        out[:, c0:c0 + chunk] = (dy2[:, :, None] + cols[None, :, :]).amin(1)
    return (torch.sqrt(out) * resolution).to(dtype)


def fan(theta: torch.Tensor, num_beams: int, fov: float):
    """(A,) headings -> the beams' (cos, sin), each (A, B), and the (B,)
    offsets: ``num_beams`` evenly spaced over ``[-fov/2, fov/2]``."""
    offs = torch.linspace(-fov / 2.0, fov / 2.0, num_beams,
                          dtype=torch.float64, device=theta.device)
    ang = theta[:, None] + offs.to(theta.dtype)[None, :]
    return torch.cos(ang), torch.sin(ang), offs


def _occupied_at(occ_flat, ix, iy, h, w):
    inb = (ix >= 0) & (iy >= 0) & (ix < w) & (iy < h)
    flat = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    return occ_flat[flat] & inb, inb


def _skip_free(dist, resolution, origin, x0, y0, c, s, max_range):
    """How far each ray can go before it could first touch an occupied
    cell: from a point in a free cell whose center lies ``e`` from the
    nearest occupied cell's center, every occupied point lies at least
    ``e - sqrt(2) res`` away. Steps by that (less 0.6% of a cell, so that
    a step never ends on a boundary) while it is a cell or more. Rays
    that start in an occupied cell or outside the grid do not move."""
    h, w = dist.shape
    flat = dist.reshape(-1)
    ox, oy = origin
    margin = 1.42 * resolution
    t = torch.zeros_like(x0)
    live = torch.arange(x0.numel(), device=x0.device)
    for it in range(4 * int(math.ceil(max_range / resolution)) + 4):
        if it % _COMPACT_EVERY == 0:
            live = live[go] if it else live
            if live.numel() == 0:
                break
        tl = t[live]
        ix = torch.floor((x0[live] + tl * c[live] - ox) / resolution).long()
        iy = torch.floor((y0[live] + tl * s[live] - oy) / resolution).long()
        inb = (ix >= 0) & (iy >= 0) & (ix < w) & (iy < h)
        e = flat[iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)] - margin
        go = inb & (e >= resolution) & (tl < max_range)
        t[live] = torch.where(go, tl + e, tl)
    return t


def first_hit(occupied: torch.Tensor, resolution: float, origin, x0, y0,
              c, s, max_range: float, dist=None):
    """Exact first boundary hit of flat rays (module doc). ``occupied``:
    the real (H, W) grid, bool; ``dist``: its ``distance_field`` (float64),
    with which each ray first skips the free space it cannot leave
    (``_skip_free``). Returns (r, hit, nx, ny) in the rays' dtype. Rays
    that start outside the grid are misses."""
    dt = x0.dtype
    h, w = occupied.shape
    occ_flat = occupied.reshape(-1)
    ox, oy = origin
    n = x0.numel()
    start = torch.zeros_like(x0)
    if dist is not None:
        start = _skip_free(dist, resolution, origin, x0.double(),
                           y0.double(), c.double(), s.double(),
                           max_range).to(dt)
    gx = (x0 + start * c - ox) / resolution
    gy = (y0 + start * s - oy) / resolution
    ix = torch.floor(gx).long()
    iy = torch.floor(gy).long()
    inside0, inb = _occupied_at(occ_flat, ix, iy, h, w)
    sx = torch.where(c > 0, 1, -1)
    sy = torch.where(s > 0, 1, -1)
    kx = ix + (c > 0).long()          # next line of constant x
    ky = iy + (s > 0).long()
    cz = torch.where(c == 0, torch.ones_like(c), c)
    szs = torch.where(s == 0, torch.ones_like(s), s)
    max_g = max_range / resolution
    t0 = start / resolution
    r = torch.full((n,), max_range, dtype=dt, device=x0.device)
    hit = torch.zeros(n, dtype=torch.bool, device=x0.device)
    vert = torch.zeros(n, dtype=torch.bool, device=x0.device)
    live = torch.nonzero(inb & (t0 < max_g)).reshape(-1)
    state = [v[live] for v in (gx, gy, cz, szs, c, s, ix, iy, kx, ky, sx,
                               sy, inside0, t0)]
    res_l = [r[live], hit[live], vert[live]]
    fin = torch.zeros(live.shape, dtype=torch.bool, device=x0.device)
    trips = 2 * int(math.ceil(max_g)) + 4
    for it in range(trips):
        if live.numel() == 0:
            break
        (gxl, gyl, czl, szl, cl, sl, ixl, iyl, kxl, kyl, sxl, syl, in0,
         t0l) = state
        tx = torch.where(cl == 0, math.inf, (kxl.to(dt) - gxl) / czl)
        ty = torch.where(sl == 0, math.inf, (kyl.to(dt) - gyl) / szl)
        alongx = tx <= ty
        t = torch.minimum(tx, ty) + t0l
        stepx = torch.where(alongx, sxl, 0)
        stepy = torch.where(alongx, 0, syl)
        ixl, kxl = ixl + stepx, kxl + stepx
        iyl, kyl = iyl + stepy, kyl + stepy
        now, still_in = _occupied_at(occ_flat, ixl, iyl, h, w)
        reached = t < max_g
        got = reached & (now != in0) & ~fin
        # a finished ray walks on until it is compacted away; only its
        # first result is kept
        rl, hl, vl = res_l
        res_l = [torch.where(got, t * resolution, rl), hl | got,
                 torch.where(got, alongx, vl)]
        fin = fin | got | ~reached | ~still_in
        state = [gxl, gyl, czl, szl, cl, sl, ixl, iyl, kxl, kyl, sxl, syl,
                 in0, t0l]
        last = it == trips - 1
        if it % _COMPACT_EVERY == _COMPACT_EVERY - 1 or last:
            r[live], hit[live], vert[live] = res_l
            keep = torch.nonzero(~fin).reshape(-1)
            live, fin = live[keep], fin[keep]
            state = [v[keep] for v in state]
            res_l = [v[keep] for v in res_l]
    if live.numel():
        r[live], hit[live], vert[live] = res_l
    zero = torch.zeros_like(r)
    one = torch.ones_like(r)
    nx = torch.where(hit & vert, one, zero)
    ny = torch.where(hit & ~vert, one, zero)
    return r, hit, nx, ny


def _bilinear(edf_flat, hp, wp, gx, gy, slope: bool = True):
    """Bilinear distance field at grid coordinates (cell-center samples,
    taps clamped into the grid): value and (with ``slope``) its
    grid-space slope."""
    xs = torch.clamp(gx - 0.5, 0.0, wp - 1.0)
    ys = torch.clamp(gy - 0.5, 0.0, hp - 1.0)
    x0 = torch.clamp(torch.floor(xs), max=wp - 2)
    y0 = torch.clamp(torch.floor(ys), max=hp - 2)
    fx, fy = xs - x0, ys - y0
    base = y0.long() * wp + x0.long()
    f00, f01 = edf_flat[base], edf_flat[base + 1]
    f10, f11 = edf_flat[base + wp], edf_flat[base + wp + 1]
    val = (f00 * (1 - fx) + f01 * fx) * (1 - fy) \
        + (f10 * (1 - fx) + f11 * fx) * fy
    if not slope:
        return val
    dgx = (f01 - f00) * (1 - fy) + (f11 - f10) * fy
    dgy = (f10 - f00) * (1 - fx) + (f11 - f01) * fx
    return val, dgx, dgy


def march_hit(edf: torch.Tensor, real_hw, resolution: float, origin, x0,
              y0, c, s, max_range: float, eps: float, max_iters: int,
              slope_floor: float = 1e-2, halvings: int = 12):
    """The march and its refinement (module doc) for flat rays. ``edf``:
    the padded grid's distance field in meters, in the rays' dtype;
    ``real_hw``: the map's own (H, W), outside of which a sample is out of
    the map. Returns (r, ok, nx, ny): ``ok`` marks refined hits on the
    level set that are not grazing, the rays whose range has a gradient,
    and (nx, ny) is the distance field's world slope there."""
    dt = x0.dtype
    hp, wp = edf.shape
    h, w = real_hw
    flat = edf.reshape(-1)
    ox, oy = origin
    n = x0.numel()
    total = torch.zeros(n, dtype=dt, device=x0.device)
    last = torch.zeros_like(total)
    hit = torch.zeros(n, dtype=torch.bool, device=x0.device)
    live = torch.arange(n, device=x0.device)
    # the live rays' walk, kept compact and written back at compactions
    walk = [x0, y0, c, s, total, last, hit]
    for it in range(max_iters):
        if it:
            # a stopped ray is left as it is by later trips (its step is
            # 0 and its sample unchanged): write the stopped ones back
            out = ~go
            total[live[out]], last[live[out]], hit[live[out]] = (
                v[out] for v in walk[4:])
            live, walk = live[go], [v[go] for v in walk]
        if live.numel() == 0:
            break
        xl, yl, cl, sl, tl, ll, hl = walk
        ix = torch.floor((xl - ox) / resolution).long()
        iy = torch.floor((yl - oy) / resolution).long()
        inb = (ix >= 0) & (iy >= 0) & (ix < w) & (iy < h)
        d = torch.where(inb, flat[iy.clamp(0, hp - 1) * wp
                                  + ix.clamp(0, wp - 1)], -1.0)
        hit_now = inb & (d <= eps)
        go = inb & ~hit_now & (tl < max_range)
        step = torch.where(go, d, 0.0)
        walk = [xl + step * cl, yl + step * sl, cl, sl,
                torch.where(inb, tl + step, torch.full_like(tl, max_range)),
                torch.where(go, step, ll), hl | hit_now]
    if live.numel():
        total[live], last[live], hit[live] = walk[4:]
    tau = max(eps, 0.5 * resolution)
    # the refinement, on the hits only
    idx = torch.nonzero(hit).reshape(-1)
    xh, yh, ch, sh = (v[idx] for v in (x0, y0, c, s))

    def grid(r):
        return (xh + r * ch - ox) / resolution, (yh + r * sh - oy) / resolution

    def level(r):
        gx, gy = grid(r)
        val, dgx, dgy = _bilinear(flat, hp, wp, gx, gy)
        inb = (gx >= 0) & (gy >= 0) & (gx < w) & (gy < h)
        ex, ey = dgx / resolution, dgy / resolution
        return val - tau, ex * ch + ey * sh, ex, ey, inb

    lo = torch.clamp(total[idx] - last[idx], min=0.0)
    hi = total[idx] + 0.4 * resolution
    for _ in range(halvings):
        mid = 0.5 * (lo + hi)
        out = _bilinear(flat, hp, wp, *grid(mid), slope=False) - tau > 0
        lo, hi = torch.where(out, mid, lo), torch.where(out, hi, mid)
    f, df = level(lo)[:2]
    df = torch.where(df > -slope_floor, -slope_floor, df)
    r_hit = torch.minimum(torch.maximum(lo - f / df, lo), hi)
    r_hit = torch.clamp(r_hit, max=max_range)
    f, denom, ex, ey, inb = level(r_hit)
    ok_h = (r_hit < max_range) & inb & (torch.abs(f) <= 0.6 * tau) \
        & (torch.abs(denom) >= slope_floor)
    r = torch.clamp(total, max=max_range)
    r[idx] = r_hit
    zero = torch.zeros_like(r)
    ok = torch.zeros_like(hit)
    ok[idx] = ok_h
    nx, ny = zero.clone(), zero.clone()
    nx[idx] = torch.where(ok_h, ex, 0.0)
    ny[idx] = torch.where(ok_h, ey, 0.0)
    return r, ok, nx, ny


def differentiable(r, ok, nx, ny, x0, y0, c, s):
    """``r`` (no gradient) as a range whose gradient in the ray origins
    (x0, y0) and directions (c, s) is the first-order change of the hit
    (module doc) where ``ok``, and zero elsewhere."""
    r = r.detach()
    nx, ny = nx.detach(), ny.detach()
    denom = nx * c.detach() + ny * s.detach()
    denom = torch.where(ok, denom, torch.ones_like(denom))
    move = (nx * (x0 - x0.detach()) + ny * (y0 - y0.detach())
            + r * (nx * (c - c.detach()) + ny * (s - s.detach())))
    return r - torch.where(ok, move / denom, torch.zeros_like(move))
