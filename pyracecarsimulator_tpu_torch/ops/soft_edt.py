"""Differentiable distance transform (occupancy -> EDF) on the device.

Counterpart of ``pyracecarsimulator_tpu/ops/soft_edt.py``. The exact EDT
(``maps/edt.py``) runs on the host and has no gradient; this chamfer
wavefront closes the chain occupancy -> EDF -> ranges so that autograd
reaches the occupancy grid. Start from ``d = (1 - occ) * cap`` (or the
log init), then ``iters`` times

    d <- min(d, min over 8 neighbours of (d_neighbour + step))

with steps 1 and sqrt 2 (at most ~8% over the euclidean distance).
``temperature > 0`` replaces the min by a softmin over the 9 candidates.

The stencil loop (the JAX package's ``lax.scan``) runs on CUDA tensors in
the hand-written kernels of ``csrc/soft_edt.cu``: ``chamfer_stencil``
(kernel ``soft_edt``, one launch a call, the iterations in one C loop on
the current stream) and, as its backward through the
``torch.autograd.Function`` ``_ChamferStencil``, ``chamfer_stencil_grad``
(kernel ``soft_edt_grad``), which walks the iterations in reverse from
the forward's history of each iteration's input field. On CPU tensors
``soft_edt`` calls ``chamfer_stencil`` outside the Function, and the
wrapper runs the plain loop ``chamfer_stencil_plain`` under ordinary
autograd, so that its values and gradients stay those of the JAX
package. The init and the final clip are plain elementwise passes on
either device.

The hard-min chain splits the gradient evenly between exactly equal
candidates, as JAX's ``minimum`` does, and so does the final clip
(``_clip``); binary maps are full of such ties
(``tests/test_torch_soft_edt.py`` holds the gradient to ``jax.grad``).
``chamfer_stencil_grad_plain`` is the backward written out as the kernel
computes it: each output cell's cotangent split over its 9 candidates
(the slots), then gathered by each source cell in the order in which
autograd sums them through the plain loop.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _kernels

_SQRT2 = 1.4142135623730951
# the padded field's slice that candidate slot k (1..8, in
# ``_neighbor_candidates``' order) reads: rows, then columns
_PAD_SLICES = (None,
               (slice(None, -2), slice(1, -1)), (slice(2, None), slice(1, -1)),
               (slice(1, -1), slice(None, -2)), (slice(1, -1), slice(2, None)),
               (slice(None, -2), slice(None, -2)),
               (slice(None, -2), slice(2, None)),
               (slice(2, None), slice(None, -2)),
               (slice(2, None), slice(2, None)))
# the kernels index cells in 32 bits and tile rows 8 to a block
INDEX_LIMIT = 2 ** 31 - 1
MAX_ROWS = 65535 * 8


def _neighbor_candidates(d):
    """The 8 chamfer candidates (d_neighbour + step). Borders replicate
    the edge values, so border distances come from in-map obstacles
    only."""
    p = F.pad(d[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    return [
        p[:-2, 1:-1] + 1.0, p[2:, 1:-1] + 1.0,
        p[1:-1, :-2] + 1.0, p[1:-1, 2:] + 1.0,
        p[:-2, :-2] + _SQRT2, p[:-2, 2:] + _SQRT2,
        p[2:, :-2] + _SQRT2, p[2:, 2:] + _SQRT2,
    ]


def _clip(x, lo: float, hi: float):
    """``jnp.clip``: min(max(x, lo), hi), whose gradient at a bound is
    split evenly between ``x`` and the bound, as JAX's ``minimum`` and
    ``maximum`` split it (``torch.clamp`` would pass all of it). Cells at
    the bounds are common: occupied cells sit at 0, far free cells at the
    cap, binary occupancy at 1."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)),
                         x.new_tensor(hi))


def init_field(occupancy, iters: int, init: str = "linear",
               init_lambda: float = 3.0):
    """The stencil's starting field (H, W) from a float32 occupancy:
    ``(1 - occ) * cap`` ("linear") or ``-init_lambda * ln(occ)`` with occ
    clipped to ``[exp(-cap / init_lambda), 1]`` ("log"), cap = iters + 1."""
    cap = float(iters) + 1.0
    if init == "log":
        floor = float(np.exp(-cap / init_lambda))
        return -init_lambda * torch.log(_clip(occupancy, floor, 1.0))
    # the saturation cap, not 1e38: keeps d(occ) gradients at O(cap)
    return (1.0 - occupancy) * cap


def chamfer_stencil_plain(d, iters: int, temperature: float = 0.0,
                          history=None):
    """The plain stencil loop on any device, differentiable through
    autograd: ``iters`` chamfer iterations from ``d`` (H, W), hard min
    (``temperature`` 0) or softmin. ``history``: a (iters, H, W) tensor
    to receive each iteration's input field, or None. The reference of
    the kernel ``soft_edt``."""
    for k in range(iters):
        if history is not None:
            history[k].copy_(d.detach())
        if temperature > 0.0:
            stack = torch.stack([d] + _neighbor_candidates(d))
            d = -temperature * torch.logsumexp(-stack * (1.0 / temperature),
                                               dim=0)
        else:
            out = d
            for c in _neighbor_candidates(d):
                out = torch.minimum(out, c)
            d = out
    return d


def _slot_cotangents(d, g, temperature):
    """One iteration's backward up to its candidates: the cotangent
    ``g`` (H, W) of the iteration's output split over the 9 candidates
    of each output cell (self, then ``_neighbor_candidates``' order), as
    autograd splits it through the plain loop. Hard: the chain of
    ``torch.minimum`` walked back from its last link (a tie halves, the
    larger side gets 0, a NaN passes all of it to both). Soft:
    ``-(((g * -T) * w_i) * (1 / T))``, ``w_i = exp(y_i - L)``, the
    softmin's weights."""
    c = [d] + _neighbor_candidates(d)
    if temperature > 0.0:
        y = -torch.stack(c) * (1.0 / temperature)
        w = (y - torch.logsumexp(y, dim=0)).exp()
        return list(-((g * -temperature) * w * (1.0 / temperature)))
    run = [d]
    for ck in c[1:]:
        run.append(torch.minimum(run[-1], ck))
    slots = [None] * 9
    for k in range(8, 0, -1):
        a, b = run[k - 1], c[k]
        split = torch.where(a == b, g / 2, g)
        slots[k] = split.masked_fill(a < b, 0)
        g = split.masked_fill(a > b, 0)
    slots[0] = g
    return slots


def _edge_rows(n, device):
    """For each row (or column) s of n, the first padded row whose
    replicate source is s, and how many there are: the padded rows of a
    source are consecutive (s + 1; also 0 at the first edge and n + 1 at
    the last)."""
    s = torch.arange(n, device=device)
    first = s + 1 - (s == 0).long()
    return first, (s + 1 + (s == n - 1).long()) - first + 1


def _gather(slots):
    """A source cell's cotangent from the slot cotangents of the outputs
    that read it, summed in autograd's order through the plain loop: each
    padded cell adds the 8 candidate slots that read it, slot 8 first
    (autograd runs the later candidates' slices first); the replicate
    pad's backward adds the padded cells of a source in row-major order;
    then the source's own slot 0 is added."""
    h, w = slots[0].shape
    pg = slots[0].new_zeros(h + 2, w + 2)
    for k in range(8, 0, -1):
        pg[_PAD_SLICES[k]] += slots[k]
    r0, nr = _edge_rows(h, pg.device)
    c0, nc = _edge_rows(w, pg.device)
    acc = torch.zeros_like(slots[0])
    for a in range(3):
        rows = pg.index_select(0, torch.minimum(r0 + a, r0 + nr - 1))
        for b in range(3):
            v = rows.index_select(1, torch.minimum(c0 + b, c0 + nc - 1))
            valid = (a < nr)[:, None] & (b < nc)[None, :]
            acc = acc + torch.where(valid, v, 0.0)
    return slots[0] + acc


def chamfer_stencil_grad_plain(history, g, temperature: float = 0.0):
    """The plain version of ``chamfer_stencil_grad``, on any device: the
    cotangent of the stencil's input ``d`` from ``history`` (iters, H, W)
    (each iteration's input field) and the output's cotangent ``g``
    (H, W), the iterations in reverse, each split over its candidates
    (``_slot_cotangents``) and gathered (``_gather``)."""
    g = g.clone()
    for k in range(history.shape[0] - 1, -1, -1):
        g = _gather(_slot_cotangents(history[k], g, temperature))
    return g


def _check(name, field, iters, history=None):
    """What the kernels take: a contiguous float32 (H, W) field, iters >=
    0, a history of (iters, H, W) on the field's device; a device with a
    kernel (the CPU takes the plain version)."""
    if not torch.is_tensor(field) or field.dim() != 2 \
            or field.dtype != torch.float32 or not field.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous float32 (H, W) "
                         f"tensor, got {getattr(field, 'dtype', field)} "
                         f"{tuple(getattr(field, 'shape', ()))}")
    if iters < 0:
        raise ValueError(f"{name}: iters must be >= 0, got {iters}")
    if history is not None and (
            history.dtype != torch.float32 or not history.is_contiguous()
            or history.shape != (iters, *field.shape)
            or history.device != field.device):
        raise ValueError(f"{name}: history must be a contiguous float32 "
                         f"{(iters, *field.shape)} tensor on {field.device}, "
                         f"got {history.dtype} {tuple(history.shape)} on "
                         f"{history.device}")
    if field.numel() > INDEX_LIMIT or field.shape[0] > MAX_ROWS:
        raise ValueError(f"{name}: a field of {tuple(field.shape)} is past "
                         f"the kernel's limits ({INDEX_LIMIT} cells, "
                         f"{MAX_ROWS} rows)")
    return _kernels.on_cuda(name, field)


def _scalars(temperature):
    """(soft, 1 / T, -T) as the kernels take them: the softmin's
    multipliers rounded once to float32 from the host's double, as torch
    rounds a Python scalar."""
    soft = temperature > 0.0
    return (int(soft), float(1.0 / temperature) if soft else 0.0,
            float(-temperature))


def chamfer_stencil(d0, iters: int, temperature: float = 0.0,
                    history=None):
    """``iters`` chamfer iterations from ``d0`` (H, W) by the kernel
    ``soft_edt`` of ``csrc/soft_edt.cu`` on CUDA tensors (one launch),
    ``chamfer_stencil_plain`` on CPU tensors. ``history``: a (iters, H, W)
    tensor to receive each iteration's input field (what
    ``chamfer_stencil_grad`` reads), or None. Hard min at ``temperature``
    0: equal to the plain loop bit for bit; softmin: to float32 rounding
    (the 9 exponentials are summed in the candidates' order, torch's
    reduction order is its own). ``chamfer_stencil.launches`` counts
    kernel launches."""
    if not _check("soft_edt", d0, iters, history):
        return chamfer_stencil_plain(d0, iters, temperature, history)
    out = torch.empty_like(d0)
    if iters == 0 or d0.numel() == 0:
        return out.copy_(d0)
    tmp = torch.empty_like(d0) if history is None and iters > 1 else None
    _kernels.launch("soft_edt", "soft_edt", d0, out, tmp, history,
                    d0.shape[0], d0.shape[1], int(iters),
                    *_scalars(temperature))
    return out


_kernels.register(chamfer_stencil, "soft_edt")


def chamfer_stencil_grad(history, g, temperature: float = 0.0):
    """The cotangent of ``chamfer_stencil``'s input from its ``history``
    (iters, H, W) and its output's cotangent ``g`` (H, W), by the kernel
    ``soft_edt_grad`` of ``csrc/soft_edt.cu`` on CUDA tensors (one
    launch), ``chamfer_stencil_grad_plain`` on CPU tensors.
    ``chamfer_stencil_grad.launches`` counts kernel launches."""
    if not torch.is_tensor(history) or history.dim() != 3:
        raise ValueError(f"soft_edt_grad: history must be a (iters, H, W) "
                         f"tensor, got {getattr(history, 'shape', history)}")
    iters = history.shape[0]
    if not _check("soft_edt_grad", g, iters, history):
        return chamfer_stencil_grad_plain(history, g, temperature)
    out = torch.empty_like(g)
    if iters == 0 or g.numel() == 0:
        return out.copy_(g)
    tmp = torch.empty_like(g) if iters > 1 else None
    _kernels.launch("soft_edt_grad", "soft_edt_grad", history, g, out, tmp,
                    g.shape[0], g.shape[1], int(iters),
                    *_scalars(temperature))
    return out


_kernels.register(chamfer_stencil_grad, "soft_edt_grad")


class _ChamferStencil(torch.autograd.Function):
    """``chamfer_stencil`` with ``chamfer_stencil_grad`` as its backward.
    With ``keep`` (set when the input requires grad) the forward keeps
    the history of each iteration's input field for the backward:
    ``iters`` x H x W float32."""

    @staticmethod
    def forward(ctx, d0, iters, temperature, keep):
        history = d0.new_empty((iters, *d0.shape)) if keep else None
        ctx.save_for_backward(history)
        ctx.temperature = temperature
        return chamfer_stencil(d0, iters, temperature, history)

    @staticmethod
    def backward(ctx, g):
        (history,) = ctx.saved_tensors
        return (chamfer_stencil_grad(history, g.contiguous(),
                                     ctx.temperature), None, None, None)


def soft_edt(occupancy, resolution=1.0, iters: int = 64,
             temperature: float = 0.0, init: str = "linear",
             init_lambda: float = 3.0):
    """Differentiable chamfer distance field in meters.

    ``occupancy`` (H, W) float in [0, 1], 1 = occupied (a tensor keeps
    its device; anything else goes to the card, ``config.resolve_device``);
    ``iters`` propagation sweeps, the distance radius in cells (farther
    distances saturate at ``iters + 1`` cells); ``temperature`` 0 = hard
    min, > 0 = softmin in cells; ``init`` "linear" ((1 - occ) * cap, exact
    for binary maps) or "log" (-init_lambda * ln(occ): partial beliefs
    already shorten nearby distances, the occupancy-reconstruction mode).
    CUDA tensors launch ``soft_edt`` (and ``soft_edt_grad`` in the
    backward), CPU tensors run the plain loop (module doc). Returns (H, W)
    float32.
    """
    if not torch.is_tensor(occupancy):
        from ..config import resolve_device
        occupancy = torch.as_tensor(occupancy, device=resolve_device(None))
    occupancy = occupancy.to(torch.float32)
    cap = float(iters) + 1.0
    d = init_field(occupancy, iters, init, init_lambda).contiguous()
    if _kernels.on_cuda("soft_edt", d):
        d = _ChamferStencil.apply(d, iters, float(temperature),
                                  torch.is_grad_enabled() and d.requires_grad)
    else:
        # the wrapper's plain version, under ordinary autograd
        d = chamfer_stencil(d, iters, temperature)
    return _clip(d, 0.0, cap) * resolution


def scan_from_occupancy(occupancy, resolution, origin_xy, poses,
                        num_beams=1080, fov=4.712388980384690,
                        max_range=10.0, eps=1e-4, max_iters=128,
                        edt_iters: int = 64, bounds_hw=None):
    """Differentiable occupancy -> lidar ranges: ``soft_edt`` composed
    with the bilinear DT march; autograd of any loss of the output reaches
    the occupancy grid."""
    from .raymarch_xla import scan_poses
    edf = soft_edt(occupancy, resolution, iters=edt_iters)
    return scan_poses(edf, resolution, origin_xy, poses,
                      num_beams=num_beams, fov=fov, max_range=max_range,
                      eps=eps, max_iters=max_iters, interp="bilinear",
                      bounds_hw=bounds_hw)
