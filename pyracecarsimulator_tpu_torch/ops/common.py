"""Shared scan prologue/epilogue: beam fan, theta buckets, extent mask.

Counterpart of ``pyracecarsimulator_tpu/ops/common.py`` plus the per-ray
reciprocals of ``raycast_segments._ray_invs``.

Beam offsets follow ``jnp.linspace``'s algorithm (``start * (1 - i/div) +
stop * i/div`` with the last entry set to ``stop``) in IEEE float32, one
rounding per operation. XLA's CPU code generator rounds that expression
differently (it contracts and reassociates, and differs even between its
own jitted and eager runs), so about half of the 1080 offsets differ from
the JAX package's by an ulp, and ``torch.cos``/``torch.sin`` differ from
XLA's on some inputs. Sweeps given the same fan agree bit for bit; a
free-running scan agrees within a stated tolerance.

Scan constants live on the device and are made once: the beam fan, the
padded fan, its offsets' cos and sin (``offset_factors``, whole and at the
block lookup beams), the block lookup beams and every 0-dim scalar that
divides (``_f32``) are cached per (arguments, device) in ``_CONSTANTS``. After the
first scan on a device a scan copies nothing from the host, which is what
lets the step be captured in a CUDA graph (``utils/graph.py``; a copy from
pageable host memory is not allowed while a stream captures). The cached
tensors are shared by every caller: they are never written in place. And
they are never evicted: a captured graph holds their addresses, so a
freed constant would be read stale. The cache grows by a fan per (beams,
fov) and a few 0-dim scalars per map geometry (tile size, origin).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import resolve_device


_CONSTANTS: dict = {}   # (kind, arguments, device) -> tensor on the device


def _constant(key, device, make) -> torch.Tensor:
    """The tensor of ``make()`` (host data) on ``device``, made and copied
    once per (``key``, device); a CUDA device without an index is the
    current one. Callers share the tensor: it must not be written."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    t = _CONSTANTS.get((key, device))
    if t is None:
        t = _CONSTANTS[(key, device)] = make().to(device)
    return t


def beam_angles(num_beams: int, fov: float, device=None) -> torch.Tensor:
    """(num_beams,) float32 beam offsets in [-fov/2, fov/2], inclusive
    endpoints, on ``device`` (``None``: the card,
    ``config.resolve_device``). Cached (module doc): do not write it."""
    return _constant(("beam_angles", int(num_beams), float(fov)), device,
                     lambda: _beam_angles_host(num_beams, fov))


def _beam_angles_host(num_beams: int, fov: float) -> torch.Tensor:
    start = np.float32(-fov / 2.0)
    stop = np.float32(fov / 2.0)
    if num_beams == 1:
        offs = np.asarray([start], np.float32)
    else:
        div = num_beams - 1
        step = np.arange(div, dtype=np.float32) / np.float32(div)
        offs = np.concatenate(
            [start * (np.float32(1.0) - step) + stop * step,
             np.asarray([stop], np.float32)])
    return torch.from_numpy(offs)


def _padded_offsets(num_beams, fov, bb, device=None):
    """The (NBLK*bb,) beam-offset row for beam blocks of ``bb``: the last
    offset repeated into the padding beams of the last block (their
    outputs are sliced off). Cached (module doc): do not write it."""
    def make():
        offs = _beam_angles_host(num_beams, fov)
        b_pad = -num_beams % bb
        return torch.cat([offs, offs[-1:].expand(b_pad)]) if b_pad else offs
    return _constant(("padded_offsets", int(num_beams), float(fov), int(bb)),
                     device, make)


def offset_factors(num_beams, fov, bb, device):
    """``(cd, sd)``, each (NBLK*bb,): the cos and sin of
    ``_padded_offsets``, computed on ``device`` once (the values
    ``fan_factors`` gives on it; ``bb = 1``: the fan unpadded, as the
    dense route takes it). Cached (module doc): do not write them."""
    def make():
        offs = _padded_offsets(num_beams, fov, bb, device)
        return torch.stack([torch.cos(offs), torch.sin(offs)])
    cs = _constant(("offset_factors", int(num_beams), float(fov), int(bb)),
                   device, make)
    return cs[0], cs[1]


def mid_offset_factors(num_beams, fov, bb, device):
    """``(cd, sd)``, each (NBLK,): ``offset_factors`` at each block's
    lookup beam (``block_mids`` over the padded fan, as the sector route
    looks up a padded fan). Cached (module doc): do not write them."""
    def make():
        cd, sd = offset_factors(num_beams, fov, bb, device)
        n_pad = cd.shape[0]
        mids = block_mids(n_pad // bb, bb, n_pad, device)
        return torch.stack([cd[mids], sd[mids]])
    cs = _constant(("mid_offset_factors", int(num_beams), float(fov),
                    int(bb)), device, make)
    return cs[0], cs[1]


def fused_scan(poses, theta_discretization: int) -> bool:
    """Whether a scan of ``poses`` may take a sweep kernel's from-poses
    entry (``sweeps.list_scan``, ``sweeps.dense_scan``): the exact fan,
    and no ray that takes a gradient."""
    return not theta_discretization and not (torch.is_grad_enabled()
                                             and poses.requires_grad)


def block_mids(nblk: int, bb: int, b_real: int, device) -> torch.Tensor:
    """(nblk,) int64 lookup beam of each ``bb``-beam block, its middle beam
    capped at the last real beam ``b_real - 1``. Cached (module doc)."""
    return _constant(
        ("block_mids", int(nblk), int(bb), int(b_real)), device,
        lambda: torch.from_numpy(
            np.minimum(np.arange(nblk) * bb + bb // 2, b_real - 1)))


def quantize_angles(ang, theta_discretization: int):
    """Reference theta-bucket quantization: angle -> bucket-start angle,
    bucket floor((a mod 2pi)/2pi * D) clipped to [0, D-1]. The divisor
    rides as a device scalar (``_f32``), so that the card takes the same
    correctly rounded quotient as the CPU and the JAX package."""
    if not theta_discretization:
        return ang
    two_pi = 2.0 * math.pi
    idx = torch.floor(torch.remainder(ang, two_pi) / _f32(two_pi, ang.device)
                      * theta_discretization)
    idx = torch.clamp(idx.to(torch.int32), 0, theta_discretization - 1)
    return idx * (two_pi / theta_discretization)


def fan_cos_sin(theta, offs, theta_discretization: int = 0):
    """Beam-fan direction cosines: (A,) headings x (B,) beam offsets ->
    (ct, st), each (A, B).

    Exact mode (``theta_discretization == 0``) rotates the per-beam
    (cos d, sin d) by each heading's (cos, sin): 4 mul + 2 add per ray, the
    definition every sector-backend path shares. ``theta_discretization >
    0`` keeps the reference theta-bucket table semantics.
    """
    if theta_discretization:
        ang = quantize_angles(theta[:, None] + offs[None, :],
                              theta_discretization)
        return torch.cos(ang), torch.sin(ang)
    return rotate_fan(*fan_factors(theta, offs))


def fan_factors(theta, offs):
    """The exact fan's factors: (cos theta, sin theta) (A,) of the
    headings and (cos d, sin d) (B,) of the beam offsets."""
    return torch.cos(theta), torch.sin(theta), torch.cos(offs), \
        torch.sin(offs)


def rotate_fan(cth, sth, cd, sd):
    """(ct, st) (A, B) of ``fan_factors``' (A,) and (B,) factors: the
    heading rotated by each beam offset, ``ct = cth*cd - sth*sd``, ``st =
    sth*cd + cth*sd``."""
    cth, sth = cth[:, None], sth[:, None]
    return cth * cd - sth * sd, sth * cd + cth * sd


def rays_from_poses(poses, num_beams: int, fov: float,
                    theta_discretization: int = 0):
    """poses (..., 3) -> (batch_shape, poses2 (N,3), xb, yb, ct, st) with
    ray tensors shaped (N, num_beams)."""
    batch = tuple(poses.shape[:-1])
    poses2 = poses.reshape(-1, 3)
    ct, st = fan_cos_sin(poses2[:, 2],
                         beam_angles(num_beams, fov, poses.device),
                         theta_discretization)
    xb = poses2[:, 0:1].expand(ct.shape)
    yb = poses2[:, 1:2].expand(ct.shape)
    return batch, poses2, xb, yb, ct, st


def _f32(v, device):
    """A 0-dim float32 tensor on ``device``. Scalars that divide ride as
    device tensors: CUDA divides by a host scalar through its reciprocal,
    which is not the correctly rounded quotient the JAX package takes.
    Cached per (value, device) (module doc): do not write it."""
    return _constant(("f32", float(v)), device,
                     lambda: torch.tensor(v, dtype=torch.float32))


def tile_ids(tiles_shape, tile_size, tile_origin, x0, y0):
    """(A,) agent positions -> (A,) int32 row-major ids of their map tiles,
    clamped to the grid (the JAX package's f32 arithmetic: subtract, then
    a correctly rounded divide, then truncate)."""
    nr, nc = tiles_shape
    tox, toy = tile_origin
    dev = x0.device
    ts = _f32(tile_size, dev)
    ci = torch.clamp(((x0 - _f32(tox, dev)) / ts).to(torch.int32), 0, nc - 1)
    ri = torch.clamp(((y0 - _f32(toy, dev)) / ts).to(torch.int32), 0, nr - 1)
    return ri * nc + ci


def apply_extent_mask(r, x, y, extent, max_range):
    """A scan from outside the real map is all max_range (the reference's
    immediate out-of-map exit). x/y: (...,) origins; r: (..., B)."""
    ex0, ex1, ey0, ey1 = extent
    inside = (x >= ex0) & (x < ex1) & (y >= ey0) & (y < ey1)
    return torch.where(inside[..., None], r,
                       torch.full_like(r, max_range))


def finish_minima(bv, bh, max_range):
    """Per-orientation minima -> (r, isv, hit): the range clamped to
    ``max_range``, whether the vertical minimum wins (exact ties go to
    vertical), and whether anything within ``max_range`` was hit."""
    m = torch.minimum(bv, bh)
    return torch.clamp(m, max=max_range), bv <= bh, m < max_range


def _ray_invs(cos_t, sin_t):
    """Per-ray reciprocals, hoisted out of the segment sweep. A zero
    direction component maps to a NaN reciprocal: t and the hit coordinate
    become NaN and every comparison rejects them (this also covers a ray
    collinear with a segment's line, where a huge finite reciprocal would
    still give t = 0 * huge = 0)."""
    nan = torch.full_like(cos_t, float("nan"))
    one = torch.ones_like(cos_t)
    inv_c = torch.where(cos_t == 0.0, nan,
                        one / torch.where(cos_t == 0.0, one, cos_t))
    inv_s = torch.where(sin_t == 0.0, nan,
                        one / torch.where(sin_t == 0.0, one, sin_t))
    return inv_c, inv_s
