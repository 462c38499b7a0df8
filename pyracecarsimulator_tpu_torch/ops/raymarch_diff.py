"""Fast differentiable DT march: implicit-function gradients at the hit.

Counterpart of ``pyracecarsimulator_tpu/ops/raymarch_diff.py`` ("edf_implicit"
and the map cotangent of ``make_scan_fn(map_grad=True)``).

- FORWARD: the nearest-sample sphere trace decides hit or miss, then 12
  bisection halvings and one Newton polish place the hit on the bilinear
  level set E(p(r)) = tau, tau = max(eps, res/2). On walls that level set
  is the occupied-cell boundary, the surface of the exact segment
  backends.
- BACKWARD (``torch.autograd.Function``): r* solves F(r) = E(p(r)) - tau =
  0, so by the implicit function theorem
      dr/dtheta_cell = -w_cell / (dE/dr)   (w_cell: the bilinear weight)
      dr/d(origin)   = -grad E / (dE/dr)
  i.e. elementwise math over the rays and one 4-tap scatter-add per ray
  into the map cotangent. Misses and grazing hits (|dE/dr| below a floor)
  get zero gradient.

``with_map_gradient`` attaches the same map cotangent to ranges from any
exact forward (straight-through values); ``dedup=True`` sums it by a
stable argsort of the rays by cell and sums over the sorted segments.

The forward (``_fwd_impl``: the nearest march, the JAX ``while_loop``,
then ``_refine``'s bisection, the JAX ``fori_loop``, and the Newton
polish) runs on CUDA tensors in one launch of the hand-written kernel
``csrc/edf_march.cu``, variant "implicit" (``raymarch_xla.edf_march``):
each ray marches until it stops, and the same lane refines a hit in
registers and writes the range and the hit flag once; no host read. The
forward carries no gradient: the implicit VJP differentiates the refined
hit, and ``_MarchImplicit.forward`` runs without autograd. On CPU tensors
its plain version ``_fwd_plain`` runs (``_march_nearest_plain``, then
``_refine``), the kernel's reference bit for bit: the march's trips in a
Python loop that reads ``alive.any()`` every ``raymarch_xla._ALIVE_CHECK``
trips (the extra trips change nothing: a dead ray has ``step = 0``, and
its ``total``, ``last``, ``hit``, ``x`` and ``y`` keep their values), then
the refinement over every ray, kept where the march hit. The VJP is plain
PyTorch (XLA code in the JAX package) and reads nothing from the host, so
the whole forward and backward can be captured in a CUDA graph. The map
cotangent is summed with ``index_add_``, which on CUDA adds with atomics:
the order of the sum, and so its last bits, differ from JAX's and from run
to run.

A scan taken from poses with the exact fan (``scan_poses_implicit``, the
"edf_implicit" backend) runs as one ``torch.autograd.Function``,
``_ScanImplicit``, whose pose cotangent is one kernel,
``implicit_pose_vjp`` (``csrc/edf_march.cu``). It replaces the XLA code
of the JAX package's custom_vjp backward ``_mri_bwd`` composed with the
transpose of the fan (``rays_from_poses``: the broadcasts' sums over the
beams, the rotation's products, cos and sin of the heading), which the
port had run as ~120 PyTorch passes over the (agents, beams) rays. Per
ray the terms of ``_pose_terms`` (``_hit_scale``'s float32 operations,
the direction recomputed from the agent's cos and sin of the heading and
the beam offsets'), summed over each agent's beams in a fixed order: no
atomics. Its bound is the bytes of the cotangent, the range and the hit
flag (9 B a ray); the forward keeps the fan's (N,) and (B,) factors, not
its (N, B) cosines. On CPU tensors ``implicit_pose_vjp_plain`` runs: the
same terms, then ``sum``. The map cotangent, where the EDF requires grad,
is ``_hit_scale`` and ``_scatter_taps``. The bucketed fan
(``theta_discretization > 0``), whose heading has no gradient (a
``floor``), and the ray-level ``march_rays_implicit`` keep
``_MarchImplicit``'s per-ray VJP.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import beam_angles, fan_factors, rays_from_poses, rotate_fan
from . import _kernels
from .raymarch_xla import (_ALIVE_CHECK, INDEX_LIMIT, _bilinear_taps,
                           _tap_values, count_march, edf_march,
                           origin_xy_f32, sample_edf_nearest)

_DENOM_FLOOR = 1e-2    # |dE/dr| below this => grazing; zero gradient


def _bilinear_patch(edf, gx, gy, bounds_hw):
    """Bilinear value + grid-space gradient + the 4 taps' flat indices and
    weights at grid coords (gx, gy), in ``sample_edf_bilinear``'s
    cell-center convention."""
    hp, wp = edf.shape
    h, w = bounds_hw if bounds_hw is not None else (hp, wp)
    inb = (gx >= 0) & (gy >= 0) & (gx < w) & (gy < h)
    fx, fy, base = _bilinear_taps(edf, gx, gy)
    f00, f01, f10, f11 = _tap_values(edf, base)
    val = (f00 * (1 - fx) + f01 * fx) * (1 - fy) \
        + (f10 * (1 - fx) + f11 * fx) * fy
    dgx = (f01 - f00) * (1 - fy) + (f11 - f10) * fy
    dgy = (f10 - f00) * (1 - fx) + (f11 - f01) * fx
    weights = ((1 - fx) * (1 - fy), fx * (1 - fy),
               (1 - fx) * fy, fx * fy)
    idx = (base, base + 1, base + wp, base + wp + 1)
    return val, dgx, dgy, weights, idx, inb


def _march_nearest_plain(edf, inv_res, ox, oy, x0, y0, cos_t, sin_t,
                         max_range, eps, max_iters, bounds_hw):
    """Reference-rule sphere trace with nearest sampling, in plain PyTorch
    on any device (the march of ``_fwd_plain``). Returns (total,
    last_step, hit): ``total`` ends one sample inside the first occupied
    cell; ``[total - last_step, total]`` brackets the boundary
    crossing."""
    x, y = x0, y0
    total = torch.zeros(x0.shape, dtype=torch.float32, device=x0.device)
    last = torch.zeros_like(total)
    alive = torch.ones(x0.shape, dtype=torch.bool, device=x0.device)
    hit = torch.zeros_like(alive)
    trips = max_iters
    for it in range(max_iters):
        if it and it % _ALIVE_CHECK == 0 and not bool(alive.any()):
            trips = it
            break
        gx = (x - ox) * inv_res
        gy = (y - oy) * inv_res
        d = sample_edf_nearest(edf, gx, gy, bounds_hw)
        oob = d < 0.0
        hit_now = alive & (d <= eps) & ~oob
        hit = hit | hit_now
        live = alive & ~hit_now & ~oob & (total < max_range)
        step = torch.where(live, d, 0.0)
        total = torch.where(alive & oob, max_range, total)
        last = torch.where(live, step, last)
        x = x + step * cos_t
        y = y + step * sin_t
        total = total + step
        alive = live
    count_march(trips)
    return total, last, hit


def _refine(edf, inv_res, ox, oy, x0, y0, cos_t, sin_t, eps, bounds_hw,
            lo, hi, slope_floor, iters=12):
    """Bisection + one Newton polish for the first bilinear eps-crossing
    in [lo, hi]. The bracket can be the whole ray (a head-on march reaches
    the wall in one step), hence 12 halvings (10 m -> 2.4 mm). The polish
    is anchored at the outside end ``lo``, whose patch straddles free and
    occupied cells, so its slope is informative; a slope above
    ``-slope_floor`` is taken as ``-slope_floor``."""

    def eval_f(r):
        gx = (x0 + r * cos_t - ox) * inv_res
        gy = (y0 + r * sin_t - oy) * inv_res
        val, dgx, dgy, _, _, _ = _bilinear_patch(edf, gx, gy, bounds_hw)
        return val - eps, (dgx * cos_t + dgy * sin_t) * inv_res

    for _ in range(iters):
        r = 0.5 * (lo + hi)
        out = eval_f(r)[0] > 0        # still outside: crossing beyond r
        lo, hi = torch.where(out, r, lo), torch.where(out, hi, r)
    f, df = eval_f(lo)
    # E decreases along the ray into the surface: the degenerate-slope
    # fallback is negative
    safe = torch.where(df > -slope_floor, -slope_floor, df)
    return torch.minimum(torch.maximum(lo - f / safe, lo), hi)


def _surface_level(eps, resolution) -> float:
    """The float32 level tau = max(eps, res/2) the hit is refined onto: at
    tau = res/2 the bilinear field crosses exactly at the occupied-cell
    boundary on flat walls, and |dE/dr| ~ cos(incidence) there."""
    return float(np.float32(max(eps, 0.5 * resolution)))


def _gate_width(tau) -> float:
    """0.6 tau, rounded in float32 as JAX rounds it."""
    return float(np.float32(0.6) * np.float32(tau))


def _surface_gate(val, tau):
    """|val - tau| <= 0.6 tau (``_gate_width``): the implicit formula holds
    only on the level set."""
    return torch.abs(val - tau) <= _gate_width(tau)


def _hit_scale(edf, resolution, ox, oy, x0, y0, cos_t, sin_t, r, g, gate,
               eps, bounds_hw):
    """The shared backward of the implicit forms: ``scale = -g / (dE/dr)``
    where the hit is on the level set and not grazing, 0 elsewhere, with
    the world-space EDF slope (ex, ey) and the 4 taps' weights and
    indices at p(r). ``gate`` (bool) further restricts the rays."""
    inv_res = 1.0 / resolution
    gx = (x0 + r * cos_t - ox) * inv_res
    gy = (y0 + r * sin_t - oy) * inv_res
    val, dgx, dgy, weights, idx, inb = _bilinear_patch(edf, gx, gy,
                                                       bounds_hw)
    ex = dgx * inv_res
    ey = dgy * inv_res
    denom = ex * cos_t + ey * sin_t
    ok = gate & inb & _surface_gate(val, _surface_level(eps, resolution)) \
        & (torch.abs(denom) >= _DENOM_FLOOR)
    scale = torch.where(ok, -g / torch.where(ok, denom, 1.0), 0.0)
    return scale, ex, ey, weights, idx, ok


def _scatter_taps(edf, scale, weights, idx):
    """Map cotangent: the 4 taps' ``scale * w`` scatter-added, tap by
    tap."""
    flat = torch.zeros(edf.numel(), dtype=edf.dtype, device=edf.device)
    for wgt, ix in zip(weights, idx):
        flat.index_add_(0, ix.reshape(-1), (scale * wgt).reshape(-1))
    return flat.reshape(edf.shape)


def _sorted_taps(edf, scale, weights, idx, ok):
    """Map cotangent by sort-by-cell: one stable argsort of the rays by
    their lower-left tap, then per tap a sum over the sorted segments of
    equal cells; a tap's image is a zero-padded shift of the per-cell sums
    (all 4 taps sit at the base plus a constant offset). Dead rays get the
    sentinel cell one past the image and fall off the end."""
    n = edf.numel()
    stride = edf.shape[-1]
    base = torch.where(ok, idx[0], n).reshape(-1)
    order = torch.argsort(base, stable=True)
    lengths = torch.bincount(base, minlength=n + 1)
    flat = torch.zeros(n, dtype=edf.dtype, device=edf.device)
    for off, wgt in zip((0, 1, stride, stride + 1), weights):
        ws = (scale * wgt).reshape(-1)[order]
        seg = torch.segment_reduce(ws, "sum", lengths=lengths,
                                   unsafe=True)[:n]
        if off:
            seg = torch.cat([seg.new_zeros(off), seg[:n - off]])
        flat = flat + seg
    return flat.reshape(edf.shape)


def _fwd_impl(edf, resolution, ox, oy, x0, y0, cos_t, sin_t, max_range,
              eps, max_iters, bounds_hw):
    """The implicit march's forward: (ranges, hit flags). CUDA tensors
    launch ``edf_march`` ("implicit"), CPU tensors run ``_fwd_plain``
    (module doc)."""
    args = (edf, 1.0 / resolution, ox, oy,
            *torch.broadcast_tensors(x0, y0, cos_t, sin_t), max_range, eps,
            max_iters, bounds_hw)
    # the level set; the bracket's top 0.4 cells past the march stop (a
    # landing just inside the occupied cell's entry corner can still have
    # E_bilinear > tau); the Newton step's slope floor
    refine = (_surface_level(eps, resolution), 0.4 * resolution,
              _DENOM_FLOOR)
    if _kernels.on_cuda("edf_march", edf):
        return edf_march(*args, "implicit", refine=refine)
    return _fwd_plain(*args, refine)


def _fwd_plain(edf, inv_res, ox, oy, x0, y0, cos_t, sin_t, max_range, eps,
               max_iters, bounds_hw, refine):
    """The plain PyTorch forward on any device, ``edf_march``'s arguments
    for its "implicit" variant: its reference (module doc)."""
    tau, top, slope_floor = refine
    total, last, hit = _march_nearest_plain(edf, inv_res, ox, oy, x0, y0,
                                            cos_t, sin_t, max_range, eps,
                                            max_iters, bounds_hw)
    lo = torch.clamp(total - last, min=0.0)
    hi = total + top
    r_hit = _refine(edf, inv_res, ox, oy, x0, y0, cos_t, sin_t, tau,
                    bounds_hw, lo, hi, slope_floor)
    r = torch.where(hit, r_hit, torch.clamp(total, max=max_range))
    r = torch.clamp(r, max=max_range)
    return r, hit & (r < max_range)


class _MarchImplicit(torch.autograd.Function):
    """``march_rays_implicit``'s forward with the implicit-function VJP in
    (edf, x0, y0, cos_t, sin_t)."""

    @staticmethod
    def forward(ctx, edf, x0, y0, cos_t, sin_t, resolution, origin_xy,
                max_range, eps, max_iters, bounds_hw):
        ox, oy = origin_xy_f32(origin_xy, edf.device)
        r, hit = _fwd_impl(edf, resolution, ox, oy, x0, y0, cos_t, sin_t,
                           max_range, eps, max_iters, bounds_hw)
        ctx.save_for_backward(edf, x0, y0, cos_t, sin_t, r, hit, ox, oy)
        ctx.consts = (resolution, eps, bounds_hw)
        return r

    @staticmethod
    def backward(ctx, g):
        edf, x0, y0, cos_t, sin_t, r, hit, ox, oy = ctx.saved_tensors
        resolution, eps, bounds_hw = ctx.consts
        scale, ex, ey, weights, idx, _ = _hit_scale(
            edf, resolution, ox, oy, x0, y0, cos_t, sin_t, r, g, hit, eps,
            bounds_hw)
        edf_ct = (_scatter_taps(edf, scale, weights, idx)
                  if ctx.needs_input_grad[0] else None)
        # dr/dx0 = -ex/denom ; dr/dcos = -ex*r/denom
        return (edf_ct, scale * ex, scale * ey, scale * ex * r,
                scale * ey * r) + (None,) * 6


def march_rays_implicit(edf, resolution, origin_xy, x0, y0, cos_t, sin_t,
                        max_range=10.0, eps=0.0001, max_iters: int = 256,
                        bounds_hw=None):
    """Differentiable DT march with the implicit-function VJP (module doc).

    Same signature family as ``march_rays``; ray args broadcast to one
    shape. Differentiable in ``edf`` (4-cell scatter at the hit) and in
    the ray origins and direction cosines (closed-form hit-surface
    gradients); ``resolution`` and ``origin_xy`` get none.
    """
    rays = torch.broadcast_tensors(x0, y0, cos_t, sin_t)
    return _MarchImplicit.apply(edf, *rays, resolution, origin_xy,
                                max_range, eps, max_iters, bounds_hw)


def _pose_terms(edf, resolution, ox, oy, poses, cth, sth, cd, sd, r, hit,
                g, eps, bounds_hw):
    """The per-ray terms of the pose cotangent of a scan taken from
    ``poses`` (N, 3) with the exact fan of ``fan_factors`` (cth, sth (N,),
    cd, sd (B,)): (d/dx0, d/dy0, d/dtheta), each (N, B), for ranges ``r``,
    hit flags ``hit`` and their cotangent ``g``. ``scale * r * (ey * ct -
    ex * st)`` is what autograd reaches through the fan (d ct/d theta =
    -st, d st/d theta = ct): the same derivative."""
    ct, st = rotate_fan(cth, sth, cd, sd)
    scale, ex, ey, _, _, _ = _hit_scale(
        edf, resolution, ox, oy, poses[:, 0:1], poses[:, 1:2], ct, st, r, g,
        hit, eps, bounds_hw)
    return scale * ex, scale * ey, scale * r * (ey * ct - ex * st)


def implicit_pose_vjp_plain(edf, resolution, ox, oy, poses, cth, sth, cd,
                            sd, r, hit, g, eps, bounds_hw):
    """The plain PyTorch version of ``implicit_pose_vjp``, on any device:
    ``_pose_terms`` summed over the beams. Returns (N, 3)."""
    return torch.stack([t.sum(dim=-1) for t in _pose_terms(
        edf, resolution, ox, oy, poses, cth, sth, cd, sd, r, hit, g, eps,
        bounds_hw)], dim=-1)


def implicit_pose_vjp(edf, resolution, ox, oy, poses, cth, sth, cd, sd, r,
                      hit, g, eps, bounds_hw, terms=None):
    """The pose cotangent (N, 3) of an "edf_implicit" scan taken from
    ``poses`` (N, 3): ``_pose_terms`` summed over each agent's B beams.
    CUDA tensors launch the kernel of ``csrc/edf_march.cu``
    (``implicit_pose_vjp_kernel``: one block an agent, the sum in a fixed
    order, no atomics), CPU tensors run ``implicit_pose_vjp_plain``. The
    kernel's terms equal ``_pose_terms``' bit for bit; its sums differ
    from ``torch.sum``'s by their order. ``terms``: a contiguous float32
    (3, N, B) CUDA tensor that receives each ray's terms, or None.
    ``implicit_pose_vjp.launches`` counts kernel launches."""
    args = (edf, resolution, ox, oy, poses, cth, sth, cd, sd, r, hit, g,
            eps, bounds_hw)
    if not _kernels.on_cuda("implicit_pose_vjp", edf):
        if terms is not None:
            raise ValueError("implicit_pose_vjp: terms are the kernel's; "
                             "CPU tensors take the plain version")
        return implicit_pose_vjp_plain(*args)
    name = "implicit_pose_vjp"
    if edf.dtype != torch.float32 or edf.dim() != 2 \
            or not edf.is_contiguous() or min(edf.shape) < 2:
        raise ValueError(f"{name}: edf must be a contiguous float32 (H, W) "
                         f"tensor, at least 2 x 2, got {edf.dtype} "
                         f"{tuple(edf.shape)}")
    n, b = r.shape
    g = g.contiguous()
    want = {"poses": (poses, (n, 3), torch.float32),
            "cth": (cth, (n,), torch.float32),
            "sth": (sth, (n,), torch.float32),
            "cd": (cd, (b,), torch.float32),
            "sd": (sd, (b,), torch.float32),
            "r": (r, (n, b), torch.float32),
            "hit": (hit, (n, b), torch.bool),
            "g": (g, (n, b), torch.float32),
            "ox": (ox, (), torch.float32), "oy": (oy, (), torch.float32)}
    if terms is not None:
        want["terms"] = (terms, (3, n, b), torch.float32)
    for what, (v, shape, dtype) in want.items():
        strided = what == "poses"     # read through its strides
        if tuple(v.shape) != shape or v.dtype != dtype \
                or v.device != edf.device \
                or not (strided or v.is_contiguous()):
            raise ValueError(f"{name}: {what} must be a "
                             f"{'' if strided else 'contiguous '}{dtype} "
                             f"tensor of shape {shape} on {edf.device}, got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")
    hp, wp = edf.shape
    h, w = bounds_hw if bounds_hw is not None else (hp, wp)
    last = (n - 1) * poses.stride(0) + poses.stride(1) if n else 0
    for what, size in {"the map": hp * wp, "the rays": 3 * n * b,
                       "the poses' last offset": last}.items():
        if size > INDEX_LIMIT:
            raise ValueError(f"{name}: {what} reaches {size}, past the "
                             f"kernel's 32-bit index limit ({INDEX_LIMIT})")
    out = torch.empty((n, 3), dtype=torch.float32, device=edf.device)
    if n:
        tau = _surface_level(eps, resolution)
        _kernels.launch(name, name, edf, hp, wp, h, w, ox, oy,
                        float(1.0 / resolution), tau, _gate_width(tau),
                        _DENOM_FLOOR, poses, poses.stride(0),
                        poses.stride(1), cth, sth, cd, sd, r, hit, g, n, b,
                        out, terms)
        implicit_pose_vjp.launches += 1
    return out


implicit_pose_vjp.launches = 0
_kernels.register(implicit_pose_vjp)


class _ScanImplicit(torch.autograd.Function):
    """``scan_poses_implicit``'s exact-fan forward with its VJP in (edf,
    poses): the pose cotangent by ``implicit_pose_vjp``, the map cotangent
    as ``_MarchImplicit``'s. The forward launches what ``rays_from_poses``
    and ``march_rays_implicit`` launch and keeps the fan's (N,) and (B,)
    factors, not its (N, B) cosines."""

    @staticmethod
    def forward(ctx, edf, poses, resolution, origin_xy, num_beams, fov,
                max_range, eps, max_iters, bounds_hw):
        fan = fan_factors(poses[:, 2], beam_angles(num_beams, fov,
                                                   poses.device))
        ct, st = rotate_fan(*fan)
        ox, oy = origin_xy_f32(origin_xy, edf.device)
        r, hit = _fwd_impl(edf, resolution, ox, oy, poses[:, 0:1],
                           poses[:, 1:2], ct, st, max_range, eps, max_iters,
                           bounds_hw)
        ctx.save_for_backward(edf, poses, *fan, r, hit, ox, oy)
        ctx.consts = (resolution, eps, bounds_hw)
        return r

    @staticmethod
    def backward(ctx, g):
        edf, poses, cth, sth, cd, sd, r, hit, ox, oy = ctx.saved_tensors
        resolution, eps, bounds_hw = ctx.consts
        edf_ct = pose_ct = None
        if ctx.needs_input_grad[1]:
            pose_ct = implicit_pose_vjp(edf, resolution, ox, oy, poses, cth,
                                        sth, cd, sd, r, hit, g, eps,
                                        bounds_hw)
        if ctx.needs_input_grad[0]:
            ct, st = rotate_fan(cth, sth, cd, sd)
            scale, _, _, weights, idx, _ = _hit_scale(
                edf, resolution, ox, oy, poses[:, 0:1], poses[:, 1:2], ct,
                st, r, g, hit, eps, bounds_hw)
            edf_ct = _scatter_taps(edf, scale, weights, idx)
        return (edf_ct, pose_ct) + (None,) * 8


def scan_poses_implicit(edf, resolution, origin_xy, poses,
                        num_beams: int = 1080,
                        fov: float = 4.712388980384690,
                        max_range=10.0, eps=0.0001, max_iters: int = 256,
                        theta_discretization: int = 0, bounds_hw=None):
    """Full lidar scans with the implicit-gradient march; poses (..., 3)
    on ``edf``'s device. Returns (..., num_beams). The exact fan takes
    ``_ScanImplicit`` (its pose cotangent: ``implicit_pose_vjp``); the
    bucketed fan (``theta_discretization > 0``), whose heading has no
    gradient, the rays' VJP of ``march_rays_implicit``."""
    poses = poses.to(torch.float32)
    if theta_discretization:
        batch, _, xb, yb, ct, st = rays_from_poses(
            poses, num_beams, fov, theta_discretization)
        r = march_rays_implicit(edf, resolution, origin_xy, xb, yb, ct, st,
                                max_range, eps, max_iters, bounds_hw)
        return r.reshape(*batch, num_beams)
    batch = tuple(poses.shape[:-1])
    r = _ScanImplicit.apply(edf, poses.reshape(-1, 3), resolution,
                            origin_xy, num_beams, fov, max_range, eps,
                            max_iters, bounds_hw)
    return r.reshape(*batch, num_beams)


class _WithMapGradient(torch.autograd.Function):
    """Straight-through ``r`` with the implicit-function map cotangent."""

    @staticmethod
    def forward(ctx, edf, r, x0, y0, cos_t, sin_t, resolution, origin_xy,
                eps, bounds_hw, dedup):
        ox, oy = origin_xy_f32(origin_xy, edf.device)
        ctx.save_for_backward(edf, r, x0, y0, cos_t, sin_t, ox, oy)
        ctx.consts = (resolution, eps, bounds_hw, dedup)
        return r.clone()

    @staticmethod
    def backward(ctx, g):
        edf, r, x0, y0, cos_t, sin_t, ox, oy = ctx.saved_tensors
        resolution, eps, bounds_hw, dedup = ctx.consts
        edf_ct = None
        if ctx.needs_input_grad[0]:
            scale, _, _, weights, idx, ok = _hit_scale(
                edf, resolution, ox, oy, x0, y0, cos_t, sin_t, r, g, True,
                eps, bounds_hw)
            edf_ct = (_sorted_taps(edf, scale, weights, idx, ok) if dedup
                      else _scatter_taps(edf, scale, weights, idx))
        # the pose terms belong to the geometric forward's own VJP, which
        # the r cotangent reaches; adding IFT pose terms would count twice
        return (edf_ct, g) + (None,) * 9


def with_map_gradient(edf, r, x0, y0, cos_t, sin_t, resolution, origin_xy,
                      eps: float = 0.0001, bounds_hw=None,
                      dedup: bool = False):
    """Attach a d(range)/d(map) cotangent to ranges ``r`` from any exact
    forward (sectors, segments).

    value:      ``r``, bit for bit;
    d r/d edf:  -w_cell / (dE/dr) at p(r), a 4-cell scatter (implicit
                function theorem on the tau level set, which coincides
                with the occupied-cell boundary on walls);
    d r/d rays: none here; the ``r`` cotangent passes through unchanged to
                the geometric forward's own VJP.

    Rays whose patch is not on the tau level set, or that graze it, get
    zero map gradient. ``dedup=True`` sums the cotangent by sort-by-cell
    (module doc): the same values up to the float32 order of the sum.
    """
    rays = torch.broadcast_tensors(x0, y0, cos_t, sin_t)
    return _WithMapGradient.apply(edf, r, *rays, resolution, origin_xy, eps,
                                  bounds_hw, dedup)
