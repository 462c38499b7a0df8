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
  1e-3 + 1e-3 relative (the bilinear march's taps round differently).
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
