"""Distance-transform ray march: the reference-exact scan ("edf",
"edf_bilinear").

Counterpart of ``pyracecarsimulator_tpu/ops/raymarch_xla.py`` (the module
keeps its JAX name). Every ray sphere-traces the euclidean distance field:
it steps by the EDF sample until the sample drops to ``eps`` (hit), the
ray leaves the real map (max_range) or the range budget is spent. The JAX
march is a fixed-trip ``lax.scan`` in which a stopped ray steps by zero.

``march_rays`` runs the hand-written kernels of ``csrc/edf_march.cu`` on
CUDA tensors: ``edf_march``, in which persistent warps loop each ray's
trips in registers until the ray stops, write its range once and take the
next rays, one launch a march, no host read; and, where autograd needs the
march's gradient, its backward ``edf_march_grad`` (the
``torch.autograd.Function`` ``_March``), which walks each ray from the
forward's record of its steps (``walk``), keeping its positions, and back
(the source says how). On CPU tensors the plain loop ``march_rays_plain``
runs under ordinary autograd. The plain loop is the kernels' reference:
the march performs the same float32 operations in the same order, so the
two agree bit for bit, and ``march_grad_plain`` (autograd through the plain loop) is
the gradient kernel's, which agrees to float32 rounding (it sums in
another order and adds the EDF's taps with atomics). The plain loop runs
the trips in lockstep, about 25 elementwise operations a trip, and every
``_ALIVE_CHECK`` trips reads ``alive.any()`` on the host and stops once
every ray has stopped (a stopped ray has ``step = 0``, so the values are
those of the full trip count).

``interp="bilinear"`` samples the EDF bilinearly and is differentiable in
the rays and the EDF (the backward scatters into the EDF's gradient along
every visited cell). ``interp="nearest"`` is the reference's semantics: its
range is differentiable in the EDF only (its cell indices are integers,
as in JAX). The map origin takes no gradient on the card.

``MARCH_COUNTS`` counts marches and their trips. The plain loop counts on
the host: the trips it ran, a multiple of ``_ALIVE_CHECK`` or
``max_iters``. The kernel counts on the device, in a counter per device
that every launch adds to, replayed CUDA graphs included: the trips of
the launch's longest ray, which is what the JAX ``while_loop`` would run.
Reading ``MARCH_COUNTS`` reads those counters (a synchronisation).

Scalars round as in JAX: the origin is a float32 tensor, ``1 /
resolution`` a float32 multiplier. XLA's CPU backend may contract ``x +
step * cos_t`` into a fused multiply-add, which neither the plain loop
nor the kernel (``-fmad=false``) does; a position that differs by an ulp
can put a ray into the neighbouring cell, so the port's march and JAX's
differ on a few beams by up to about a cell.
"""

from __future__ import annotations

import torch

from . import _kernels
from .common import _constant, rays_from_poses

_ALIVE_CHECK = 32   # trips between host reads of "is any ray still alive"
# the kernel's variants (a template argument of csrc/edf_march.cu)
VARIANTS = {"nearest": 0, "bilinear": 1, "implicit": 2}
# the positions of a ray the bilinear gradient keeps (the kernel's kSlots;
# 64 was faster than 32 on both bundled maps, PERF.md); a longer ray is
# marched again from GRAD_SLOTS / 2 checkpoints
GRAD_SLOTS = 64
# the bilinear gradient's longest march (past (GRAD_SLOTS / 2) ** 2 steps
# the re-marches grow with the length squared)
MAX_GRAD_TRIPS = 64 * 32
# the kernels index cells and rays in 32 bits
INDEX_LIMIT = 2 ** 31 - 1


class _MarchCounts(_kernels.DeviceCounts):
    """``{"calls", "trips"}`` of every march of the port (this module's
    and ``raymarch_diff``'s): the plain loops' host counts plus the
    kernel's device counters, [trips, calls] (module doc)."""

    def __init__(self):
        super().__init__(("trips", "calls"))


MARCH_COUNTS = _MarchCounts()


def count_march(trips: int):
    """Record one plain march that left its loop after ``trips`` trips."""
    MARCH_COUNTS.host["calls"] += 1
    MARCH_COUNTS.host["trips"] += trips


def origin_xy_f32(origin_xy, device):
    """(ox, oy) as 0-dim float32 tensors on ``device`` from a (2,) tensor
    or a pair of numbers (copied to the device once per pair,
    ``common._constant``)."""
    if torch.is_tensor(origin_xy):
        o = origin_xy.to(device=device, dtype=torch.float32)
    else:
        xy = (float(origin_xy[0]), float(origin_xy[1]))
        o = _constant(("origin_xy", xy), device,
                      lambda: torch.tensor(xy, dtype=torch.float32))
    return o[0], o[1]


def sample_edf_nearest(edf, gx, gy, bounds_hw=None):
    """Nearest-cell EDF sample in grid units. Out-of-map -> -1 sentinel.

    ``bounds_hw``: real (unpadded) map dims for the in-bounds test; the
    gather itself uses the padded array (padding is free space).
    """
    hp, wp = edf.shape
    h, w = bounds_hw if bounds_hw is not None else (hp, wp)
    ix = torch.floor(gx).to(torch.int64)
    iy = torch.floor(gy).to(torch.int64)
    inb = (ix >= 0) & (iy >= 0) & (ix < w) & (iy < h)
    flat = iy.clamp(0, hp - 1) * wp + ix.clamp(0, wp - 1)
    return torch.where(inb, torch.take(edf, flat), -1.0)


def _bilinear_taps(edf, gx, gy):
    """Bilinear taps at grid coords (gx, gy), cell-center convention:
    (fx, fy, base) with ``base`` the int64 flat index of the lower-left
    tap. The integer base is clamped so that all 4 taps stay in bounds:
    float32 rounds a ``wp - 1.000001`` clip bound up to ``wp - 1``, which
    would put ``base + wp`` past the end within the last half-cell of an
    unpadded map."""
    hp, wp = edf.shape
    xs = torch.clamp(gx - 0.5, 0.0, wp - 1.0)
    ys = torch.clamp(gy - 0.5, 0.0, hp - 1.0)
    x0 = torch.clamp(torch.floor(xs.detach()), max=wp - 2)
    y0 = torch.clamp(torch.floor(ys.detach()), max=hp - 2)
    return xs - x0, ys - y0, y0.to(torch.int64) * wp + x0.to(torch.int64)


def _tap_values(edf, base):
    """The EDF at the 4 taps (f00, f01, f10, f11) of lower-left ``base``."""
    wp = edf.shape[1]
    return (torch.take(edf, base), torch.take(edf, base + 1),
            torch.take(edf, base + wp), torch.take(edf, base + wp + 1))


def sample_edf_bilinear(edf, gx, gy, bounds_hw=None):
    """Bilinear EDF sample, cell-center convention (value of cell (i,j)
    lives at grid point (j+0.5, i+0.5)). Out-of-map -> -1 sentinel."""
    hp, wp = edf.shape
    h, w = bounds_hw if bounds_hw is not None else (hp, wp)
    inb = (gx >= 0) & (gy >= 0) & (gx < w) & (gy < h)
    fx, fy, base = _bilinear_taps(edf, gx, gy)
    f00, f01, f10, f11 = _tap_values(edf, base)
    val = (f00 * (1 - fx) + f01 * fx) * (1 - fy) \
        + (f10 * (1 - fx) + f11 * fx) * fy
    return torch.where(inb, val, -1.0)


def _as_rows(v):
    """A (rows, cols) view of a ray tensor: the last axis is the columns.
    Two-dimensional tensors (the scans' expanded origin views among them)
    pass as they are; other shapes are reshaped, copying only where no
    view exists."""
    if v.dim() == 2:
        return v
    return v.reshape(1, -1) if v.dim() <= 1 else v.reshape(-1, v.shape[-1])


def _march_launch_args(name, edf, ox, oy, rays, max_iters, bounds_hw):
    """Check the march's CUDA arguments; returns (shape S of the rays,
    the entry points' arguments from ``edf`` to ``cols``, without the
    scalars after ``oy``) as (shape, head, tail)."""
    if not _kernels.on_cuda(name, edf):
        raise ValueError(f"{name}: a CUDA kernel; CPU tensors take the "
                         "plain loop")
    if edf.dtype != torch.float32 or edf.dim() != 2 \
            or not edf.is_contiguous():
        raise ValueError(f"{name}: edf must be a contiguous float32 "
                         f"(H, W) tensor, got {edf.dtype} "
                         f"{tuple(edf.shape)}")
    if max_iters < 0:
        raise ValueError(f"{name}: max_iters must be >= 0, got {max_iters}")
    rays = torch.broadcast_tensors(*rays)
    for v in rays + (ox, oy):
        if v.device != edf.device or v.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 tensors on "
                             f"{edf.device}, got {v.dtype} on {v.device}")
    if ox.dim() or oy.dim():
        raise ValueError(f"{name}: the origin is two 0-dim tensors")
    hp, wp = edf.shape
    h, w = bounds_hw if bounds_hw is not None else (hp, wp)
    views = [_as_rows(v) for v in rays]
    rows, cols = views[0].shape
    strides = [s for v in views for s in v.stride()]
    extents = {"the map": hp * wp, "its bounds": max(h, w),
               "the rays": rows * cols}
    extents.update((f"ray tensor {k}'s last offset",
                    (rows - 1) * v.stride(0) + (cols - 1) * v.stride(1))
                   for k, v in enumerate(views))
    for what, size in extents.items():
        if size > INDEX_LIMIT:
            raise ValueError(f"{name}: {what} reaches {size}, past the "
                             f"kernel's 32-bit index limit ({INDEX_LIMIT})")
    return (rays[0].shape, (edf, hp, wp, h, w, ox, oy),
            (*views, *strides, rows, cols))


def _record(name, v, shape, device, what):
    """Check an int32 per-ray tensor (``ray_trips``, ``walk``)."""
    if v is not None and (v.dtype != torch.int32 or v.shape != shape
                          or v.device != device or not v.is_contiguous()):
        raise ValueError(f"{name}: {what} must be a contiguous int32 "
                         f"tensor of shape {tuple(shape)} on {device}")


def persistent_grid(device, kernel: str, variant: str) -> int:
    """The blocks a launch of ``kernel`` ("edf_march" or
    "edf_march_grad") in ``variant`` starts on ``device`` when it has
    enough rays: one wave, the SMs times the blocks an SM holds."""
    with torch.cuda.device(device):
        blocks = _kernels.kernel("edf_march_wave")(
            int(kernel == "edf_march_grad"), VARIANTS[variant])
    if blocks <= 0:
        raise RuntimeError(f"{kernel}: no persistent grid for {variant}")
    return blocks


def edf_march(edf, inv_res, ox, oy, x0, y0, cos_t, sin_t, max_range, eps,
              max_iters: int, bounds_hw, variant: str, ray_trips=None,
              walk=None, refine=None):
    """The march of ``csrc/edf_march.cu`` on CUDA tensors of one broadcast
    shape S (``march_rays_plain``'s arguments; ``ox``/``oy`` 0-dim float32
    device tensors). ``variant``: "nearest" and "bilinear" return the
    clamped ranges (S); "implicit" returns the ranges and the hit flags
    (S) of ``raymarch_diff._fwd_impl`` (its plain version
    ``raymarch_diff._fwd_plain``) and takes ``refine`` = (tau, top,
    slope_floor), the level set, the bracket's top past the march stop and
    the slope floor, which the kernel receives rounded once to float32, as
    the plain version's operations take them. ``ray_trips``: an int32
    tensor of shape S to receive each ray's trip count, or None; ``walk``:
    one to receive what ``edf_march_grad`` needs of each ray (its steps
    where its range has a gradient, else -1), or None.
    ``edf_march.launches`` counts kernel launches. No gradient
    (``march_rays`` and ``raymarch_diff.march_rays_implicit`` have
    one)."""
    if variant not in VARIANTS:
        raise ValueError(f"edf_march: variant must be one of "
                         f"{', '.join(VARIANTS)}, got {variant!r}")
    implicit = variant == "implicit"
    if implicit != (refine is not None):
        raise ValueError("edf_march: the implicit variant, and only it, "
                         "takes refine = (tau, top, slope_floor)")
    shape, head, tail = _march_launch_args(
        "edf_march", edf, ox, oy, (x0, y0, cos_t, sin_t), max_iters,
        bounds_hw)
    total = torch.empty(shape, dtype=torch.float32, device=edf.device)
    hit = torch.empty(shape, dtype=torch.bool, device=edf.device) \
        if implicit else None
    _record("edf_march", ray_trips, shape, edf.device, "ray_trips")
    _record("edf_march", walk, shape, edf.device, "walk")
    if total.numel():
        # the launch's own scratch: its longest trip count, the warps that
        # are done, the rays' cursor (the source's doc)
        scratch = torch.zeros(3, dtype=torch.int64, device=edf.device)
        _kernels.launch("edf_march", "edf_march", VARIANTS[variant], *head,
                        float(inv_res), float(max_range), float(eps),
                        int(max_iters), *tail,
                        *(float(v) for v in refine or (0.0, 0.0, 0.0)),
                        total, hit, ray_trips, walk,
                        MARCH_COUNTS.counter(edf.device), scratch)
    return (total, hit) if implicit else total


_kernels.register(edf_march)


def edf_march_grad(edf, inv_res, ox, oy, x0, y0, cos_t, sin_t, max_range,
                   eps, max_iters: int, bounds_hw, interp: str, g,
                   edf_grad: bool, ray_grad: bool, walk):
    """The gradient of ``edf_march``'s clamped ranges (variants "nearest"
    and "bilinear") by the kernel of ``csrc/edf_march.cu``, on CUDA
    tensors: ``g`` (shape S) is the ranges' cotangent. Returns (the EDF's
    gradient or None, (g_x0, g_y0, g_cos, g_sin) or None), each ray
    gradient of shape S; ``edf_grad`` and ``ray_grad`` say which to
    compute (the rays only for "bilinear", and with ``max_iters <=
    MAX_GRAD_TRIPS``). ``walk``: ``edf_march``'s record of the same march,
    from which the kernel walks each ray once. ``march_grad_plain`` is its
    plain version (same arguments but ``walk``).
    ``edf_march_grad.launches`` counts kernel launches."""
    if interp not in ("nearest", "bilinear"):
        raise ValueError(f"edf_march_grad: interp must be 'nearest' or "
                         f"'bilinear', got {interp!r}")
    if ray_grad and interp == "nearest":
        raise ValueError("edf_march_grad: the nearest march's range has no "
                         "gradient in the rays")
    if interp == "bilinear" and max_iters > MAX_GRAD_TRIPS:
        raise ValueError(f"edf_march_grad: the bilinear gradient marches at "
                         f"most {MAX_GRAD_TRIPS} trips, got max_iters="
                         f"{max_iters}")
    shape, head, tail = _march_launch_args(
        "edf_march_grad", edf, ox, oy, (x0, y0, cos_t, sin_t), max_iters,
        bounds_hw)
    if walk is None:
        raise ValueError("edf_march_grad: walk, edf_march's record of the "
                         "same march, is required")
    _record("edf_march_grad", walk, shape, edf.device, "walk")
    g = g.to(torch.float32).expand(shape).contiguous()
    g_edf = torch.zeros_like(edf) if edf_grad else None
    g_rays = tuple(torch.empty(shape, dtype=torch.float32,
                               device=edf.device) for _ in range(4)) \
        if ray_grad else (None,) * 4
    if g.numel() and (edf_grad or ray_grad):
        cursor = torch.zeros(1, dtype=torch.int64, device=edf.device)
        _kernels.launch("edf_march_grad", "edf_march_grad",
                        VARIANTS[interp], *head, float(inv_res),
                        float(max_range), float(eps), int(max_iters), *tail,
                        g, g_edf, *g_rays, walk, cursor)
    elif ray_grad:
        g_rays = tuple(v.zero_() for v in g_rays)
    return g_edf, (g_rays if ray_grad else None)


_kernels.register(edf_march_grad)


def march_grad_plain(edf, inv_res, ox, oy, x0, y0, cos_t, sin_t, max_range,
                     eps, max_iters: int, bounds_hw, interp: str, g,
                     edf_grad: bool, ray_grad: bool):
    """The plain version of ``edf_march_grad``, on any device: autograd
    through ``march_rays_plain``. Same arguments and returns."""
    with torch.enable_grad():
        e = edf.detach().requires_grad_(edf_grad)
        rays = [v.detach().requires_grad_(ray_grad) for v in
                torch.broadcast_tensors(x0, y0, cos_t, sin_t)]
        out = march_rays_plain(e, inv_res, ox, oy, *rays, max_range, eps,
                               max_iters, interp, bounds_hw)
        wrt = ([e] if edf_grad else []) + (rays if ray_grad else [])
        grads = (torch.autograd.grad(out, wrt, g.expand(out.shape),
                                     allow_unused=True)
                 if out.requires_grad else (None,) * len(wrt))
        grads = [torch.zeros_like(v) if d is None else d
                 for v, d in zip(wrt, grads)]
    return (grads.pop(0) if edf_grad else None,
            tuple(grads) if ray_grad else None)


class _March(torch.autograd.Function):
    """``edf_march`` with ``edf_march_grad`` as its backward, in (edf, x0,
    y0, cos_t, sin_t). With ``record`` (set whenever a backward can run)
    the forward keeps the march's ``walk`` record of each ray for the
    backward."""

    @staticmethod
    def forward(ctx, edf, x0, y0, cos_t, sin_t, inv_res, ox, oy, max_range,
                eps, max_iters, interp, bounds_hw, record):
        walk = torch.empty(torch.broadcast_shapes(x0.shape, y0.shape,
                                                  cos_t.shape, sin_t.shape),
                           dtype=torch.int32, device=edf.device) \
            if record else None
        ctx.save_for_backward(edf, x0, y0, cos_t, sin_t, ox, oy, walk)
        ctx.consts = (inv_res, max_range, eps, max_iters, bounds_hw, interp)
        return edf_march(edf, inv_res, ox, oy, x0, y0, cos_t, sin_t,
                         max_range, eps, max_iters, bounds_hw, interp,
                         walk=walk)

    @staticmethod
    def backward(ctx, g):
        edf, x0, y0, cos_t, sin_t, ox, oy, walk = ctx.saved_tensors
        inv_res, max_range, eps, max_iters, bounds_hw, interp = ctx.consts
        g_edf, g_rays = edf_march_grad(
            edf, inv_res, ox, oy, x0, y0, cos_t, sin_t, max_range, eps,
            max_iters, bounds_hw, interp, g, ctx.needs_input_grad[0],
            any(ctx.needs_input_grad[1:5]), walk=walk)
        return (g_edf, *(g_rays or (None,) * 4)) + (None,) * 9


def march_rays_plain(edf, inv_res, ox, oy, x0, y0, cos_t, sin_t, max_range,
                     eps, max_iters: int, interp: str, bounds_hw):
    """The plain PyTorch march, on any device: the trips in lockstep over
    the ray tensors, the reference of ``edf_march``'s "nearest" and
    "bilinear" variants (module doc). Differentiable through autograd.
    Returns the ranges clamped to ``max_range``."""
    sample = sample_edf_nearest if interp == "nearest" else \
        sample_edf_bilinear
    x, y, cos_t, sin_t = torch.broadcast_tensors(x0, y0, cos_t, sin_t)
    total = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    alive = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    trips = max_iters
    for it in range(max_iters):
        if it and it % _ALIVE_CHECK == 0 and not bool(alive.any()):
            trips = it
            break
        gx = (x - ox) * inv_res
        gy = (y - oy) * inv_res
        d = sample(edf, gx, gy, bounds_hw)
        oob = d < 0.0                       # left the map
        hit = d <= eps                      # includes oob; refined below
        # reference loop condition: d > eps, in-map, total < max_range
        live = alive & ~hit & ~oob & (total < max_range)
        step = torch.where(live, d, 0.0)
        # out-of-map rays return max_range (clamped at the end)
        total = torch.where(alive & oob, max_range, total)
        alive = live
        x = x + step * cos_t
        y = y + step * sin_t
        total = total + step
    count_march(trips)
    return torch.clamp(total, max=max_range)


def march_rays(edf, resolution, origin_xy, x0, y0, cos_t, sin_t,
               max_range=10.0, eps=0.0001, max_iters: int = 256,
               interp: str = "nearest", bounds_hw=None):
    """March a batch of rays through the EDF; ray args share one shape S
    (broadcastable).

    ``edf`` (H, W) float32 distance field in meters, ``resolution``
    meters per cell, ``origin_xy`` world coords of grid corner (0, 0);
    ``max_iters`` the trip count (``max_range / resolution`` always
    suffices for reference parity); ``interp`` "nearest" (reference) or
    "bilinear" (differentiable in the rays). Returns ranges, shape S,
    clamped to ``max_range``. CUDA tensors launch ``edf_march`` (and
    ``edf_march_grad`` in the backward), CPU tensors run the plain loop
    (module doc).
    """
    if interp not in ("nearest", "bilinear"):
        raise ValueError(f"interp must be 'nearest' or 'bilinear', got "
                         f"{interp!r}")
    inv_res = 1.0 / resolution
    ox, oy = origin_xy_f32(origin_xy, edf.device)
    rays = torch.broadcast_tensors(x0, y0, cos_t, sin_t)
    if not _kernels.on_cuda("edf_march", edf):
        return march_rays_plain(edf, inv_res, ox, oy, *rays, max_range, eps,
                                max_iters, interp, bounds_hw)
    if torch.is_grad_enabled() and (ox.requires_grad or oy.requires_grad):
        raise ValueError("march_rays: the map origin takes no gradient on "
                         "the card")
    if interp == "nearest":     # its range has no gradient in the rays
        rays = tuple(v.detach() for v in rays)
    record = torch.is_grad_enabled() and any(
        v.requires_grad for v in (edf, *rays))
    return _March.apply(edf, *rays, inv_res, ox, oy, max_range, eps,
                        max_iters, interp, bounds_hw, record)


def scan_poses(edf, resolution, origin_xy, poses, num_beams: int = 1080,
               fov: float = 4.712388980384690, max_range=10.0, eps=0.0001,
               max_iters: int = 256, interp: str = "nearest",
               theta_discretization: int = 0, bounds_hw=None):
    """Full lidar scans for poses (..., 3) of (x, y, theta) on ``edf``'s
    device; ``theta_discretization > 0`` uses the reference's theta-bucket
    directions. Returns (..., num_beams) float32 ranges."""
    batch, _, xb, yb, ct, st = rays_from_poses(
        poses.to(torch.float32), num_beams, fov, theta_discretization)
    r = march_rays(edf, resolution, origin_xy, xb, yb, ct, st,
                   max_range=max_range, eps=eps, max_iters=max_iters,
                   interp=interp, bounds_hw=bounds_hw)
    return r.reshape(*batch, num_beams)
