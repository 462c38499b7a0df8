"""PyTorch port of the differentiable chamfer EDT (``ops/soft_edt.py``)
against the JAX package, mirroring tests/test_soft_edt.py.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:
- temperature 0 (hard min), linear init, binary map: the field equal bit
  for bit, and the occupancy gradient of ``jax.grad`` equal bit for bit.
  Binary maps are full of exact ties of the min chain and of the final
  clip; both packages split the gradient evenly at a tie;
- log init, or temperature > 0 (softmin through ``logsumexp``): field
  within 1e-5 + 1e-5 relative, gradient within 1e-4 + 1e-4 relative
  (``exp``/``log`` round differently in the two libraries);
- ``scan_from_occupancy``: range within 1e-4, occupancy gradient within
  1e-3 + 1e-3 relative (the bilinear march's taps round differently);
- the stencil's explicit backward ``chamfer_stencil_grad_plain`` (the
  kernel ``soft_edt_grad``'s reference) against autograd through
  ``chamfer_stencil_plain`` on the CPU: bit for bit in both modes (it
  recomputes each iteration's candidates and softmin with the same torch
  operations, splits the cotangent as autograd's ``minimum`` and
  ``logsumexp`` backwards do, and sums in autograd's order), on binary,
  fractional and log-init fields, 5 shapes, 0, 1 and 24 iterations;
  composed with the plain init and ``_clip``, against ``jax.grad`` with
  the tolerances above (hard, linear init: bit for bit).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pyracecarsimulator_tpu.maps.edt import edt_numpy

# the JAX ops package exports a function of the module's name
jsoft = importlib.import_module("pyracecarsimulator_tpu.ops.soft_edt")

from pyracecarsimulator_tpu_torch import config
from pyracecarsimulator_tpu_torch.ops import _kernels
from pyracecarsimulator_tpu_torch.ops import soft_edt as psoft


def _binary(seed, shape=(48, 40), p=0.03):
    rng = np.random.RandomState(seed)
    occ = (rng.rand(*shape) < p).astype(np.float32)
    occ[0, 0] = 1.0
    return occ


def _compare(occ, kw, exact):
    w = np.random.RandomState(7).randn(*occ.shape).astype(np.float32)
    g_ref = jax.grad(lambda o: jnp.sum(jsoft.soft_edt(o, 0.05, **kw) * w))(
        jnp.asarray(occ))
    d_ref = np.asarray(jsoft.soft_edt(jnp.asarray(occ), 0.05, **kw))
    o = torch.tensor(occ, requires_grad=True)
    d = psoft.soft_edt(o, 0.05, **kw)
    (d * torch.tensor(w)).sum().backward()
    if exact:
        np.testing.assert_array_equal(d.detach().numpy(), d_ref)
        np.testing.assert_array_equal(o.grad.numpy(), np.asarray(g_ref))
    else:
        np.testing.assert_allclose(d.detach().numpy(), d_ref, atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(o.grad.numpy(), np.asarray(g_ref),
                                   atol=1e-4, rtol=1e-4)
    assert np.abs(o.grad.numpy()).sum() > 0


def test_hard_min_binary_map_ties_match_jax():
    _compare(_binary(0), dict(iters=24), exact=True)


@pytest.mark.parametrize("kw", [
    dict(iters=24, temperature=0.25),
    dict(iters=16, init="log"),
    dict(iters=16, temperature=0.25, init="log", init_lambda=2.0),
], ids=["soft-linear", "hard-log", "soft-log"])
def test_soft_and_log_modes_match_jax(kw):
    occ = _binary(1) if kw.get("init") != "log" else \
        np.random.RandomState(2).rand(48, 40).astype(np.float32) * 0.9
    _compare(occ, kw, exact=False)


def test_chamfer_close_to_euclidean(rng):
    occ = (rng.rand(96, 96) < 0.02).astype(np.float32)
    occ[0, 0] = 1.0
    exact = edt_numpy(occ > 0.5)
    cham = psoft.soft_edt(torch.tensor(occ), 1.0, iters=96).numpy()
    mask = exact < 60
    rel = (cham[mask] - exact[mask]) / np.maximum(exact[mask], 1e-9)
    assert rel.min() > -1e-5 and rel.max() < 0.09


def test_zero_inside_and_fractional():
    occ = np.zeros((32, 32), np.float32)
    occ[10:14, 10:14] = 1.0
    d = psoft.soft_edt(torch.tensor(occ), 1.0, iters=16).numpy()
    assert d[11, 11] == 0.0 and d[11, 16] > 0.0
    occ = np.zeros((32, 32), np.float32)
    occ[16, 20] = 1.0
    full = float(psoft.soft_edt(torch.tensor(occ), 1.0, 24)[16, 10])
    occ[16, 20] = 0.5
    half = float(psoft.soft_edt(torch.tensor(occ), 1.0, 24)[16, 10])
    assert half > full


def test_scan_from_occupancy_matches_jax():
    """tests/test_soft_edt.py's ray at a block: the range, and its
    occupancy gradient against jax.grad."""
    occ = np.zeros((64, 64), np.float32)
    occ[:2, :] = 1; occ[-2:, :] = 1; occ[:, :2] = 1; occ[:, -2:] = 1
    occ[30:34, 40:44] = 1.0
    pose = np.asarray([10.0, 32.0, 0.0], np.float32)
    kw = dict(num_beams=1, fov=0.01, max_range=50.0, max_iters=64,
              edt_iters=48)
    loss_j = lambda o: jsoft.scan_from_occupancy(
        o, 1.0, (0.0, 0.0), jnp.asarray(pose), **kw)[0]
    r_ref = float(loss_j(jnp.asarray(occ)))
    g_ref = np.asarray(jax.grad(loss_j)(jnp.asarray(occ)))
    o = torch.tensor(occ, requires_grad=True)
    r = psoft.scan_from_occupancy(o, 1.0, (0.0, 0.0), torch.tensor(pose),
                                  **kw)[0]
    r.backward()
    assert 28.0 < r.item() < 32.0
    assert abs(r.item() - r_ref) < 1e-4
    np.testing.assert_allclose(o.grad.numpy(), g_ref, atol=1e-3, rtol=1e-3)
    assert o.grad.numpy()[30:34, 40:44].min() < 0.0


# -- the stencil's explicit backward and the kernels' routing ----------------

SHAPES = [(1, 17), (17, 1), (2, 2), (33, 47), (48, 40)]
MAPS = ["binary", "fractional", "log"]
MODES = {"hard": 0.0, "soft": 0.25}


def _field(kind, shape, iters, seed=3):
    """(occupancy, init) of a map kind: binary (ties everywhere),
    fractional occupancy with the linear init, or with the log init."""
    rng = np.random.RandomState(seed)
    if kind == "binary":
        occ = (rng.rand(*shape) < 0.1).astype(np.float32)
        occ.flat[0] = 1.0
    else:
        occ = rng.rand(*shape).astype(np.float32)
    return occ, ("log" if kind == "log" else "linear")


def _cotangent(shape, seed=5):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("iters", [0, 1, 24])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", MAPS)
def test_plain_gradient_equals_autograd(kind, mode, shape, iters):
    """``chamfer_stencil_grad_plain`` from the plain loop's history equals
    autograd through ``chamfer_stencil_plain`` bit for bit; the history
    holds each iteration's input field and leaves the values unchanged."""
    temperature = MODES[mode]
    occ, init = _field(kind, shape, iters)
    d0 = psoft.init_field(torch.tensor(occ), iters, init)
    g = torch.tensor(_cotangent(shape))
    x = d0.clone().requires_grad_(True)
    out = psoft.chamfer_stencil_plain(x, iters, temperature)
    if iters:
        out.backward(g)
    ref = x.grad if iters else g
    history = torch.full((iters, *shape), float("nan"))
    again = psoft.chamfer_stencil_plain(d0, iters, temperature, history)
    assert torch.equal(again, out.detach())
    if iters:
        assert torch.equal(history[0], d0)
        assert torch.equal(history[-1], psoft.chamfer_stencil_plain(
            d0, iters - 1, temperature))
    got = psoft.chamfer_stencil_grad_plain(history, g, temperature)
    assert torch.equal(got, ref)
    assert float(got.abs().sum()) > 0


@pytest.mark.parametrize("shape", [(17, 1), (2, 2), (33, 47)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", MAPS)
def test_explicit_gradient_matches_jax(kind, mode, shape):
    """The occupancy gradient of the port's plain init, the plain loop
    (history kept), the explicit backward and ``_clip``, composed by hand,
    against ``jax.grad`` of the JAX package's ``soft_edt``: bit for bit in
    hard mode with the linear init, else within the file's tolerance for
    ``exp``/``log``."""
    iters, temperature = 24, MODES[mode]
    occ, init = _field(kind, shape, iters)
    kw = dict(iters=iters, temperature=temperature, init=init)
    w = np.random.RandomState(7).randn(*shape).astype(np.float32)
    g_ref = np.asarray(jax.grad(
        lambda o: jnp.sum(jsoft.soft_edt(o, 0.05, **kw) * w))(
            jnp.asarray(occ)))
    o = torch.tensor(occ, requires_grad=True)
    d0 = psoft.init_field(o, iters, init)
    history = torch.empty((iters, *shape))
    d = psoft.chamfer_stencil_plain(d0.detach(), iters, temperature,
                                    history).requires_grad_(True)
    (psoft._clip(d, 0.0, iters + 1.0) * 0.05 * torch.tensor(w)).sum() \
        .backward()
    g_d0 = psoft.chamfer_stencil_grad_plain(history, d.grad, temperature)
    d0.backward(g_d0)
    if mode == "hard" and init == "linear":
        np.testing.assert_array_equal(o.grad.numpy(), g_ref)
    else:
        np.testing.assert_allclose(o.grad.numpy(), g_ref, atol=1e-4,
                                   rtol=1e-4)
    assert np.abs(g_ref).sum() > 0


def _stand_in(monkeypatch, calls):
    """The device check says "the card"; each launch is recorded, counted
    on the wrapper it names (as ``_kernels.launch`` counts it) and fills
    its outputs from the plain versions."""

    def launch(name, entry, *args):
        _kernels.wrappers()[name].launches += 1
        if entry == "soft_edt":
            d0, out, tmp, history, h, w, iters, soft, inv_t, neg_t = args
            out.copy_(psoft.chamfer_stencil_plain(
                d0, iters, -neg_t if soft else 0.0, history))
        else:
            history, g, out, tmp, h, w, iters, soft, inv_t, neg_t = args
            out.copy_(psoft.chamfer_stencil_grad_plain(
                history, g, -neg_t if soft else 0.0))
        calls.append(dict(entry=entry, shape=(h, w), iters=iters, soft=soft,
                          inv_t=inv_t, neg_t=neg_t, history=history,
                          tmp=tmp))

    monkeypatch.setattr(_kernels, "on_cuda", lambda name, ref: True)
    monkeypatch.setattr(_kernels, "launch", launch)


@pytest.mark.parametrize("kw", [
    dict(iters=24), dict(iters=24, temperature=0.25),
    dict(iters=16, temperature=0.25, init="log", init_lambda=2.0),
], ids=["hard", "soft", "soft-log"])
def test_card_route_launches_each_kernel_once(monkeypatch, kw):
    """With the device check saying "the card": ``soft_edt`` forward and
    backward make exactly one ``soft_edt`` and one ``soft_edt_grad``
    launch, with the iterations, the softmin's float32 multipliers, the
    field's shape and the forward's history (iters, H, W), and, the plain
    versions standing in for the kernels, the CPU's values and gradient
    bit for bit. Without a gradient no history is kept."""
    occ = _binary(4, shape=(33, 47)) * 0.9
    w = torch.tensor(np.random.RandomState(7).randn(33, 47).astype(
        np.float32))

    def run():
        o = torch.tensor(occ, requires_grad=True)
        d = psoft.soft_edt(o, 0.05, **kw)
        (d * w).sum().backward()
        return d.detach(), o.grad

    ref = run()
    calls = []
    before = (psoft.chamfer_stencil.launches,
              psoft.chamfer_stencil_grad.launches)
    _stand_in(monkeypatch, calls)
    got = run()
    assert (psoft.chamfer_stencil.launches,
            psoft.chamfer_stencil_grad.launches) == (before[0] + 1,
                                                     before[1] + 1)
    assert [c["entry"] for c in calls] == ["soft_edt", "soft_edt_grad"]
    t = kw.get("temperature", 0.0)
    for c in calls:
        assert c["shape"] == (33, 47) and c["iters"] == kw["iters"]
        assert c["soft"] == int(t > 0)
        assert c["neg_t"] == -t and c["inv_t"] == (1.0 / t if t else 0.0)
        assert tuple(c["history"].shape) == (kw["iters"], 33, 47)
    assert calls[0]["history"] is calls[1]["history"]
    assert calls[0]["tmp"] is None and calls[1]["tmp"] is not None
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    calls.clear()
    with torch.no_grad():
        d = psoft.soft_edt(torch.tensor(occ), 0.05, **kw)
    assert torch.equal(d, ref[0])
    assert len(calls) == 1 and calls[0]["history"] is None
    assert calls[0]["tmp"] is not None
    calls.clear()
    psoft.soft_edt(torch.tensor(occ, requires_grad=True), 0.05, iters=0)
    assert calls == []


def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    """A device with no kernel raises; with the device check patched, a
    field that is not a contiguous float32 (H, W) tensor, iters < 0, or a
    history that is not (iters, H, W) float32 on the field's device,
    raises before any launch."""
    d = torch.zeros(5, 6)
    with pytest.raises(ValueError, match="no kernel for device"):
        psoft.chamfer_stencil(d.to("meta"), 2)
    with pytest.raises(ValueError, match="no kernel for device"):
        psoft.chamfer_stencil_grad(torch.zeros(2, 5, 6, device="meta"),
                                   d.to("meta"))
    calls = []
    _stand_in(monkeypatch, calls)
    hist = torch.zeros(2, 5, 6)
    for bad, match in (
            (dict(d0=d[None]), "\\(H, W\\)"),
            (dict(d0=d.double()), "float32"),
            (dict(d0=torch.zeros(6, 5).t()), "contiguous"),
            (dict(d0=[[0.0]]), "tensor"),
            (dict(iters=-1), "iters must be >= 0"),
            (dict(history=hist[:1]), "history"),
            (dict(history=hist.double()), "history"),
            (dict(history=hist.to("meta")), "history"),
            (dict(history=torch.zeros(2, 6, 5).transpose(1, 2)),
             "history")):
        args = dict(d0=d, iters=2, temperature=0.0, history=None)
        with pytest.raises(ValueError, match=match):
            psoft.chamfer_stencil(**{**args, **bad})
    for bad, match in (
            (dict(history=hist[0]), "\\(iters, H, W\\)"),
            (dict(history=hist[:, :4]), "history"),
            (dict(g=d.double()), "float32"),
            (dict(g=d[:, ::2]), "contiguous")):
        args = dict(history=hist, g=d, temperature=0.25)
        with pytest.raises(ValueError, match=match):
            psoft.chamfer_stencil_grad(**{**args, **bad})
    assert calls == []
    out = psoft.chamfer_stencil(d, 2, 0.25, hist)
    assert out.shape == (5, 6) and len(calls) == 1
    assert psoft.chamfer_stencil(d, 0) is not d and len(calls) == 1
    g0 = psoft.chamfer_stencil_grad(hist, d + 1.0, 0.25)
    assert g0.shape == (5, 6) and len(calls) == 2


def test_plain_route_on_cpu_tensors():
    """CPU tensors take the plain versions through the wrappers, counting
    no launch, with the plain loop's values and history."""
    occ, init = _field("fractional", (33, 47), 8)
    d0 = psoft.init_field(torch.tensor(occ), 8, init)
    before = (psoft.chamfer_stencil.launches,
              psoft.chamfer_stencil_grad.launches)
    hist = torch.empty(8, 33, 47)
    out = psoft.chamfer_stencil(d0, 8, 0.25, hist)
    ref_hist = torch.empty(8, 33, 47)
    assert torch.equal(out, psoft.chamfer_stencil_plain(d0, 8, 0.25,
                                                        ref_hist))
    assert torch.equal(hist, ref_hist)
    g = torch.tensor(_cotangent((33, 47)))
    assert torch.equal(psoft.chamfer_stencil_grad(hist, g, 0.25),
                       psoft.chamfer_stencil_grad_plain(hist, g, 0.25))
    assert (psoft.chamfer_stencil.launches,
            psoft.chamfer_stencil_grad.launches) == before


def test_soft_edt_cpu_route_through_the_wrapper(monkeypatch):
    """On CPU tensors ``soft_edt`` takes the wrapper ``chamfer_stencil``
    (its plain version, no launch) with autograd through the plain loop:
    one call with the init field, and a gradient equal to autograd's
    through ``chamfer_stencil_plain``."""
    occ = torch.tensor(_binary(11, shape=(24, 20)), requires_grad=True)
    calls = []
    wrapper = psoft.chamfer_stencil

    def recording(d, iters, temperature=0.0, history=None):
        calls.append((tuple(d.shape), iters, temperature, history))
        return wrapper(d, iters, temperature, history)

    monkeypatch.setattr(psoft, "chamfer_stencil", recording)
    before = wrapper.launches
    psoft.soft_edt(occ, 0.5, iters=8, temperature=0.25).sum().backward()
    assert calls == [((24, 20), 8, 0.25, None)]
    assert wrapper.launches == before
    ref = occ.detach().clone().requires_grad_(True)
    d = psoft.chamfer_stencil_plain(psoft.init_field(ref, 8), 8, 0.25)
    (psoft._clip(d, 0.0, 9.0) * 0.5).sum().backward()
    assert torch.equal(occ.grad, ref.grad)


def test_non_tensor_occupancy_goes_to_the_default_device(monkeypatch):
    """A tensor keeps its device; anything else goes to
    ``config.resolve_device(None)``: without a card that raises the error
    that names ``device="cpu"``, and where the default device is the CPU
    the field lies there."""
    occ = _binary(5, shape=(20, 24))
    d = psoft.soft_edt(torch.tensor(occ), 1.0, iters=8)
    assert d.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        psoft.soft_edt(occ, 1.0, iters=8)
    monkeypatch.setattr(config, "default_device",
                        lambda: torch.device("cpu"))
    got = psoft.soft_edt(occ, 1.0, iters=8)
    assert got.device.type == "cpu" and torch.equal(got, d)
