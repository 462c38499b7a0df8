"""BPTT through the port's closed-loop rollout, its train step and its
checkpoints, against finite differences and the JAX package.

The port's versions of tests/test_rollout_grad.py and tests/test_train.py:
gradients of a trajectory loss with respect to per-step controls and the
initial pose, back-propagated through T steps of dynamics, lidar scan (the
analytic VJP) and TTC latch, on the dense "segments" backend and on
"sectors". Tolerances:

- finite differences: central, eps 1e-3 in float32, rtol 2e-2 and atol
  2e-3 as in the JAX tests (ranges are piecewise linear in the pose: exact
  away from winner switches; the floor guards an FD step that crosses
  one);
- the two backends return the same ranges, so their rollout gradients
  agree to rtol 1e-5;
- the first train step against the JAX package's from the same parameters
  and initial state: the port's beam fan differs from XLA's by an ulp on
  some beams (ROADMAP.md fault 3.1), which moves a few ranges by up to
  1e-4 m, and the mixed-layout JAX VJP moves ranges by 1 ulp
  (tests/test_torch_grad.py); the loss agrees to rtol 1e-5 and the
  gradient to rtol 1e-3 of its largest component.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

from pyracecarsimulator_tpu import simulator as jsim
from pyracecarsimulator_tpu.config import (ScanParams as JScanP,
                                           SimParams as JSimP)
from pyracecarsimulator_tpu.maps.loader import (build_track_map as
                                                jax_build_track_map)
from pyracecarsimulator_tpu.parallel import (make_bptt_train_fn as
                                             jax_make_bptt_train_fn)
from pyracecarsimulator_tpu.state import state_from_pose as jax_from_pose
from pyracecarsimulator_tpu.utils import checkpoint as jckpt

import pyracecarsimulator_tpu_torch as P
from pyracecarsimulator_tpu_torch import simulator as psim
from pyracecarsimulator_tpu_torch.maps.loader import build_track_map
from pyracecarsimulator_tpu_torch.parallel import make_bptt_train_fn
from pyracecarsimulator_tpu_torch.utils import checkpoint as pckpt


def _corridor():
    occ = np.zeros((192, 192), np.float32)
    occ[:4, :] = 1; occ[-4:, :] = 1; occ[:, :4] = 1; occ[:, -4:] = 1
    occ[60:132, 60:132] = 1
    return occ


def _bundle(backend, num_beams=64, **sim):
    track = build_track_map(_corridor(), 0.05, (-4.8, -4.8), name="small",
                            device="cpu")
    return psim.build_sim(track, scan=P.ScanParams(num_beams=num_beams),
                          sim=P.SimParams(**sim), backend=backend, device="cpu")


@pytest.fixture(scope="module")
def ack_bundles():
    return {b: _bundle(b, dynamics="ackermann")
            for b in ("segments", "sectors")}


def _open_pose(bundle):
    t = bundle.track
    edf = t.edf.numpy()[: t.height, : t.width]
    iy, ix = np.unravel_index(np.argmax(edf), edf.shape)
    return (t.origin_x + (ix + 0.5) * t.resolution,
            t.origin_y + (iy + 0.5) * t.resolution)


def _make_loss(bundle, v_des=1.5):
    """loss(steers, pose0) through T steps of the full step function: a
    terminal-pose term (the dynamics chain) plus a clearance term (the
    raycast VJP), so a wrong gradient in either path fails the checks."""
    step = psim.make_step_fn(bundle, with_noise=False)

    def loss(steers, pose0, n=1):
        s = P.state_from_pose(pose0[0].expand(n), pose0[1], pose0[2])
        clear = []
        for s_des in steers:
            out = step(s, (torch.full((n,), v_des), s_des.expand(n)))
            s = out.state
            clear.append(out.ranges.mean())
        return s.x.sum() + s.y.sum() + 0.1 * torch.stack(clear).sum()

    return loss


def _fd(loss, steers, pose0, eps=1e-3):
    out = np.zeros(len(steers))
    with torch.no_grad():
        for t in range(len(steers)):
            e = torch.zeros(len(steers))
            e[t] = eps
            out[t] = (float(loss(steers + e, pose0))
                      - float(loss(steers - e, pose0))) / (2 * eps)
    return out


STEERS = [0.05, -0.08, 0.12, 0.02]


def test_bptt_matches_finite_differences(ack_bundles):
    """grad through T=4 steps of dynamics + scan + TTC == central FD."""
    b = ack_bundles["segments"]
    x, y = _open_pose(b)
    pose0 = torch.tensor([x, y, 0.3])
    loss = _make_loss(b)
    steers = torch.tensor(STEERS, requires_grad=True)
    loss(steers, pose0).backward()
    g = steers.grad.numpy()
    assert np.all(np.isfinite(g)) and np.any(g != 0.0)
    np.testing.assert_allclose(g, _fd(loss, steers.detach(), pose0),
                               rtol=2e-2, atol=2e-3)


def test_bptt_sectors_matches_finite_differences(ack_bundles):
    """BPTT through the sector backend: control gradients against FD, and
    control and initial-pose gradients against the segments backend (same
    ranges, so the same rollout gradients)."""
    x, y = _open_pose(ack_bundles["sectors"])
    grads = {}
    for name, b in ack_bundles.items():
        steers = torch.tensor(STEERS, requires_grad=True)
        pose0 = torch.tensor([x, y, 0.3], requires_grad=True)
        loss = _make_loss(b)
        loss(steers, pose0).backward()
        grads[name] = (steers.grad.numpy(), pose0.grad.numpy())
        if name == "sectors":
            gs, gp = grads[name]
            assert np.all(np.isfinite(gp)) and np.any(gp != 0.0)
            np.testing.assert_allclose(
                gs, _fd(loss, steers.detach(), pose0.detach()), rtol=2e-2,
                atol=2e-3)
    for a, b in zip(grads["sectors"], grads["segments"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_bptt_long_horizon_finite(ack_bundles):
    """T=40 BPTT stays finite and the early-step gradient is nonzero."""
    b = ack_bundles["segments"]
    x, y = _open_pose(b)
    loss = _make_loss(b, v_des=1.0)
    steers = torch.tensor(0.05 * np.sin(np.arange(40) * 0.3),
                          dtype=torch.float32, requires_grad=True)
    loss(steers, torch.tensor([x, y, np.pi / 4]), n=2).backward()
    g = steers.grad.numpy()
    assert g.shape == (40,) and np.all(np.isfinite(g))
    assert np.abs(g[:20]).max() > 0.0, "gradient vanished through BPTT"


def test_bptt_gradient_descends(ack_bundles):
    """A few SGD steps on the controls improve the worst-beam clearance."""
    b = ack_bundles["segments"]
    x, y = _open_pose(b)
    step = psim.make_step_fn(b, with_noise=False)
    s0 = P.state_from_pose(torch.tensor([x]), y, 0.0)

    def neg_clearance(steers):
        s, clear = s0, []
        for s_des in steers:
            out = step(s, (torch.full((1,), 1.5), s_des.expand(1)))
            s = out.state
            clear.append(out.ranges.min())
        return -torch.stack(clear).mean()

    steers = torch.full((12,), 0.3, requires_grad=True)  # toward the block
    opt = torch.optim.SGD([steers], lr=0.05)
    with torch.no_grad():
        l0 = float(neg_clearance(steers))
    for _ in range(25):
        opt.zero_grad()
        neg_clearance(steers).backward()
        opt.step()
    with torch.no_grad():
        l1 = float(neg_clearance(steers))
    assert l1 < l0 - 1e-3, f"no improvement: {l0} -> {l1}"


# -- the train step ---------------------------------------------------------

B = 180


def _policy_t(params, state, ranges, t):
    steer = torch.tanh(ranges @ params["w"] + params["b"])
    return torch.full(state.batch_shape, 2.0), steer


def _loss_t(out, t):
    return (torch.mean((out.ranges - 10.0) ** 2)
            + 10.0 * torch.mean(out.collision.float()))


def _policy_j(params, state, ranges, t):
    steer = jnp.tanh(ranges @ params["w"] + params["b"])
    return jnp.full(state.batch_shape, 2.0), steer


def _loss_j(out, t):
    return (jnp.mean((out.ranges - 10.0) ** 2)
            + 10.0 * jnp.mean(out.collision.astype(jnp.float32)))


def _start(bundle, a_n=8):
    x0, y0 = _open_pose(bundle)
    rng = np.random.RandomState(0)
    return (np.full(a_n, x0, np.float32) + 0.05 * rng.randn(a_n)
            .astype(np.float32),
            np.full(a_n, y0, np.float32) + 0.05 * rng.randn(a_n)
            .astype(np.float32),
            np.linspace(0, 2, a_n).astype(np.float32))


def test_bptt_train_step_learns():
    """The port's test_train: 8 Adam steps on levine's sector backend with
    smooth steering, 180 beams, T=5; the loss falls and the weights move."""
    bundle = psim.build_sim("levine", scan=P.ScanParams(num_beams=B),
                            sim=P.SimParams(dt=0.05, steer_mode="smooth"),
                            backend="sectors", device="cpu")
    step = psim.make_step_fn(bundle, with_noise=False)
    s0 = P.state_from_pose(*map(torch.from_numpy, _start(bundle)))
    train, init = make_bptt_train_fn(
        step, _policy_t, _loss_t, num_steps=5, num_beams=B,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=3e-3))
    params = {"w": torch.zeros(B), "b": torch.zeros(())}
    opt = init(params)
    losses = []
    for _ in range(8):
        params, opt, loss, final = train(params, opt, s0)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert float(params["w"].detach().abs().sum()) > 0
    assert losses[-1] < losses[0]
    assert not final.x.requires_grad and final.x.shape == (8,)


def _jax_bundle(backend):
    track = jax_build_track_map(_corridor(), 0.05, (-4.8, -4.8),
                                name="small")
    return jsim.build_sim(track, scan=JScanP(num_beams=B),
                          sim=JSimP(dt=0.05, steer_mode="smooth"),
                          backend=backend)


@pytest.mark.parametrize("backend", ["segments", "sectors"])
def test_first_train_step_matches_jax(backend, tmp_path):
    """Loss and gradient of the first train step against the JAX package's
    from zero parameters (SGD with lr 1 from zero leaves -grad in the
    parameters); then the JAX parameters after one step cross over by
    save_pytree -> load_pytree and give the JAX loss of the next step."""
    pb = _bundle(backend, B, dt=0.05, steer_mode="smooth")
    jb = _jax_bundle(backend)
    x, y, th = _start(pb)
    jtrain, jinit = jax_make_bptt_train_fn(
        jsim.make_step_fn(jb, with_noise=False), _policy_j, _loss_j, 5, B,
        optimizer=optax.sgd(1.0))
    jparams = {"w": jnp.zeros(B), "b": jnp.zeros(())}
    js0 = jax_from_pose(jnp.asarray(x), jnp.asarray(y), jnp.asarray(th))
    jp1, jopt, jloss, _ = jtrain(jparams, jinit(jparams), js0)
    jgrad = -np.asarray(jp1["w"])

    train, init = make_bptt_train_fn(
        psim.make_step_fn(pb, with_noise=False), _policy_t, _loss_t, 5, B,
        optimizer=lambda ps: torch.optim.SGD(ps, lr=1.0))
    params = {"w": torch.zeros(B), "b": torch.zeros(())}
    s0 = P.state_from_pose(*map(torch.from_numpy, (x, y, th)))
    _, _, loss, _ = train(params, init(params), s0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    grad = params["w"].grad.numpy()
    assert np.abs(jgrad).max() > 0
    np.testing.assert_allclose(grad, jgrad, rtol=0,
                               atol=1e-3 * np.abs(jgrad).max())

    # JAX parameters after its first step -> the port's trainer
    jckpt.save_pytree(str(tmp_path / "p.npz"), jp1)
    _, _, jloss2, _ = jtrain(jp1, jopt, js0)
    loaded = pckpt.load_pytree(str(tmp_path / "p.npz"),
                               {"w": torch.zeros(B), "b": torch.zeros(())})
    assert loaded["w"].dtype == torch.float32
    np.testing.assert_array_equal(loaded["w"].numpy(), np.asarray(jp1["w"]))
    _, _, loss2, _ = train(loaded, init(loaded), s0)
    np.testing.assert_allclose(float(loss2), float(jloss2), rtol=1e-5)


def test_default_optimizer_is_sgd():
    _, init = make_bptt_train_fn(None, None, None, 1, 4)
    params = {"w": torch.zeros(4)}
    opt = init(params)
    assert isinstance(opt, torch.optim.SGD)
    assert opt.param_groups[0]["lr"] == 1e-2
    assert params["w"].requires_grad


def test_state_checkpoints_cross_over(tmp_path):
    """save_npz/load_npz: the JAX package's file loads in the port and the
    port's in the JAX package, field for field."""
    rng = np.random.RandomState(1)
    x, y, th = (rng.randn(5).astype(np.float32) for _ in range(3))
    js = jax_from_pose(jnp.asarray(x), jnp.asarray(y), jnp.asarray(th))
    jckpt.save_npz(str(tmp_path / "j.npz"), js, jax.random.PRNGKey(3), 7)
    ps, key, step = pckpt.load_npz(str(tmp_path / "j.npz"), device="cpu")
    assert step == 7
    np.testing.assert_array_equal(key.numpy(),
                                  np.asarray(jax.random.PRNGKey(3)))
    for f, v in ps.numpy().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(js, f)))
    gen = torch.Generator().manual_seed(5)
    pckpt.save_npz(str(tmp_path / "p.npz"), ps, gen.get_state(), 9)
    js2, jkey, jstep = jckpt.load_npz(str(tmp_path / "p.npz"))
    assert jstep == 9
    for f, v in ps.numpy().items():
        np.testing.assert_array_equal(np.asarray(getattr(js2, f)), v)
    _, key2, _ = pckpt.load_npz(str(tmp_path / "p.npz"), device="cpu")
    assert torch.equal(key2, gen.get_state())


def test_pytree_roundtrip_and_leaf_order(tmp_path):
    """Nested dicts, lists and tuples: leaves in jax.tree.leaves order, so
    the two packages read each other's files; the leaf count is checked."""
    tree = {"b": [np.arange(3.0), (np.ones(2), None)], "a": np.float32(2.5)}
    pckpt.save_pytree(str(tmp_path / "t"), tree)
    back = jckpt.load_pytree(str(tmp_path / "t"), tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    tmpl = {"b": [torch.zeros(3), (torch.zeros(2), None)],
            "a": torch.zeros(())}
    got = pckpt.load_pytree(str(tmp_path / "t.npz"), tmpl)
    assert torch.is_tensor(got["a"]) and float(got["a"]) == 2.5
    np.testing.assert_array_equal(got["b"][1][0].numpy(), np.ones(2))
    assert got["b"][1][1] is None
    with pytest.raises(ValueError, match="leaves"):
        pckpt.load_pytree(str(tmp_path / "t"), {"a": torch.zeros(())})
