"""PyTorch port of the EDF ray march ("edf", "edf_bilinear") and the NumPy
oracle, against the JAX package, on the shared ``small_track`` map.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:
- the port's oracle is a copy: equal to the JAX oracle bit for bit;
- the nearest march given the JAX package's rays: at least 99.5% of the
  beams within 1e-4 m, all within 3 cells (XLA's CPU backend may contract
  ``x + step * cos`` into an FMA; an ulp of position can move a ray into
  the next cell);
- against the oracle: the bound of tests/test_raymarch.py (> 99% within
  1e-3 m, all below 3 cells);
- the bilinear march and its ``jax.grad`` gradients in the EDF and the
  rays: within 1e-4 absolute + 1e-4 relative (float32 rounding of the
  bilinear taps, summed over up to 200 trips);
- the "edf" closed-loop step: poses within 1e-5, ranges as the nearest
  march.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pyracecarsimulator_tpu import simulator as jsim
from pyracecarsimulator_tpu import state as jstate
from pyracecarsimulator_tpu.oracle import raycast as jorc
from pyracecarsimulator_tpu.ops.common import rays_from_poses as jax_rays
from pyracecarsimulator_tpu.ops.raymarch_xla import march_rays as jmarch
from pyracecarsimulator_tpu.ops.raymarch_xla import scan_poses as jscan

import pyracecarsimulator_tpu_torch as P
from pyracecarsimulator_tpu_torch import simulator as psim
from pyracecarsimulator_tpu_torch.maps.loader import TrackMap
from pyracecarsimulator_tpu_torch.oracle import raycast as porc
from pyracecarsimulator_tpu_torch.ops.raymarch_xla import march_rays as pmarch
from pyracecarsimulator_tpu_torch.ops.raymarch_xla import scan_poses as pscan

T = lambda a: torch.tensor(np.asarray(a))      # an own, writable copy


def _port_track(track):
    return TrackMap.from_numpy(
        np.asarray(track.occupancy), np.asarray(track.edf),
        resolution=track.resolution, origin_x=track.origin_x,
        origin_y=track.origin_y, height=track.height, width=track.width,
        name=track.name)


def _free_poses(track, n, seed, margin=0.5):
    rng = np.random.RandomState(seed)
    edf = np.asarray(track.edf)[: track.height, : track.width]
    ys, xs = np.where(edf > margin)
    k = rng.randint(len(ys), size=n)
    return np.stack([track.origin_x + (xs[k] + 0.5) * track.resolution,
                     track.origin_y + (ys[k] + 0.5) * track.resolution,
                     rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)


def _org(track):
    return np.asarray((track.origin_x, track.origin_y), np.float32)


def _jax_fan(poses, num_beams, theta_discretization=0):
    """The JAX package's rays for ``poses``, as float32 numpy arrays."""
    _, _, xb, yb, ct, st = jax_rays(jnp.asarray(poses), num_beams,
                                    4.712388980384690, theta_discretization)
    return tuple(np.array(v, np.float32) for v in (xb, yb, ct, st))


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_oracle_copy_equals_jax_oracle(small_track, interp):
    edf = np.asarray(small_track.edf)
    org = (small_track.origin_x, small_track.origin_y)
    for x, y, th in _free_poses(small_track, 2, 3):
        kw = dict(num_beams=90, max_range=8.0, interp=interp,
                  bounds_hw=(small_track.height, small_track.width))
        np.testing.assert_array_equal(
            porc.scan(edf, small_track.resolution, org, (x, y, th), **kw),
            jorc.scan(edf, small_track.resolution, org, (x, y, th), **kw))
    kw = dict(num_beams=45, theta_discretization=2000)
    np.testing.assert_array_equal(
        porc.scan(edf, small_track.resolution, org, (x, y, 0.4), **kw),
        jorc.scan(edf, small_track.resolution, org, (x, y, 0.4), **kw))


def test_oracle_scan_batch_equals_jax_scans(small_track):
    """The port's scan_batch (always the Python loop) against the JAX
    oracle's per-pose ``scan``."""
    edf = np.asarray(small_track.edf)
    org = (small_track.origin_x, small_track.origin_y)
    poses = _free_poses(small_track, 3, 4)
    got = porc.scan_batch(edf, small_track.resolution, org, poses,
                          num_beams=60, max_iters=1000)
    ref = np.stack([jorc.scan(edf, small_track.resolution, org, p,
                              num_beams=60, max_iters=1000) for p in poses])
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("theta_discretization", [0, 2000])
def test_nearest_march_matches_jax_on_shared_rays(small_track,
                                                  theta_discretization):
    poses = _free_poses(small_track, 24, 5, margin=0.2)
    x, y, c, s = _jax_fan(poses, 180, theta_discretization)
    kw = dict(max_range=10.0, max_iters=200,
              bounds_hw=(small_track.height, small_track.width))
    ref = np.asarray(jmarch(small_track.edf, small_track.resolution,
                            jnp.asarray(_org(small_track)), *map(
                                jnp.asarray, (x, y, c, s)), **kw))
    got = pmarch(T(np.asarray(small_track.edf)), small_track.resolution,
                 T(_org(small_track)), T(x), T(y), T(c), T(s), **kw).numpy()
    d = np.abs(got - ref)
    assert np.mean(d <= 1e-4) >= 0.995, np.mean(d <= 1e-4)
    assert d.max() < 3 * small_track.resolution


def test_scan_matches_oracle_nearest(small_track):
    """tests/test_raymarch.py's bound, on the port's free-running scan
    against the port's oracle."""
    edf = np.asarray(small_track.edf)
    org = (small_track.origin_x, small_track.origin_y)
    for x, y, th in _free_poses(small_track, 3, 42):
        ref = porc.scan(edf, small_track.resolution, org, (x, y, th),
                        num_beams=180, max_range=8.0)
        got = pscan(T(edf), small_track.resolution, T(_org(small_track)),
                    torch.tensor([x, y, th]), num_beams=180, max_range=8.0,
                    max_iters=256).numpy()
        d = np.abs(got - ref)
        assert (d < 1e-3).mean() > 0.99, (d.max(), (d > 1e-3).sum())
        assert d.max() < 3 * small_track.resolution


def test_scan_theta_table_mode_matches_oracle(small_track):
    edf = np.asarray(small_track.edf)
    org = (small_track.origin_x, small_track.origin_y)
    x, y, _ = _free_poses(small_track, 1, 8)[0]
    ref = porc.scan(edf, small_track.resolution, org, (x, y, 0.4),
                    num_beams=90, theta_discretization=2000)
    got = pscan(T(edf), small_track.resolution, T(_org(small_track)),
                torch.tensor([x, y, 0.4]), num_beams=90,
                theta_discretization=2000, max_iters=256).numpy()
    d = np.abs(got - ref)
    assert (d < 1e-3).mean() > 0.97, (d.max(), (d > 1e-3).sum())


def test_free_running_scan_matches_jax(small_track):
    """Each package with its own beam fan (ROADMAP.md fault 3.1)."""
    poses = _free_poses(small_track, 6, 9, margin=0.2)
    kw = dict(num_beams=270, max_range=10.0, max_iters=200,
              bounds_hw=(small_track.height, small_track.width))
    ref = np.asarray(jscan(small_track.edf, small_track.resolution,
                           jnp.asarray(_org(small_track)),
                           jnp.asarray(poses), **kw))
    got = pscan(T(np.asarray(small_track.edf)), small_track.resolution,
                T(_org(small_track)), T(poses), **kw).numpy()
    assert got.shape == ref.shape == (6, 270)
    d = np.abs(got - ref)
    assert np.mean(d <= 1e-4) >= 0.995 and d.max() < 3 * 0.05


def test_bilinear_values_and_grads_match_jax(small_track):
    """jax.grad of a weighted sum of bilinear-march ranges in the EDF and
    the four ray arguments against the port's autograd."""
    poses = _free_poses(small_track, 4, 10, margin=0.3)
    x, y, c, s = (v.reshape(-1) for v in _jax_fan(poses, 60))
    edf = np.asarray(small_track.edf)
    w = np.random.RandomState(0).randn(x.size).astype(np.float32)
    kw = dict(max_range=10.0, max_iters=200, interp="bilinear",
              bounds_hw=(small_track.height, small_track.width))
    org = _org(small_track)

    def f(*a):
        return jnp.sum(jmarch(a[0], small_track.resolution,
                              jnp.asarray(org), *a[1:], **kw) * w)

    jargs = [jnp.asarray(v) for v in (edf, x, y, c, s)]
    r_ref = np.asarray(jmarch(jargs[0], small_track.resolution,
                              jnp.asarray(org), *jargs[1:], **kw))
    g_ref = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*jargs)
    pargs = [torch.tensor(v, requires_grad=True) for v in (edf, x, y, c, s)]
    r = pmarch(pargs[0], small_track.resolution, T(org), *pargs[1:], **kw)
    (r * T(w)).sum().backward()
    np.testing.assert_allclose(r.detach().numpy(), r_ref, atol=1e-4,
                               rtol=1e-4)
    for got, ref in zip(pargs, g_ref):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=1e-4)
    assert np.abs(pargs[0].grad.numpy()).sum() > 0


def test_bilinear_close_to_nearest(small_track):
    org = T(_org(small_track))
    edf = T(np.asarray(small_track.edf))
    x, y, _ = _free_poses(small_track, 1, 11, margin=0.8)[0]
    pose = torch.tensor([x, y, 1.0])
    a = pscan(edf, small_track.resolution, org, pose, num_beams=120,
              max_iters=256, interp="nearest")
    b = pscan(edf, small_track.resolution, org, pose, num_beams=120,
              max_iters=400, interp="bilinear")
    assert float((a - b).abs().max()) < 4 * small_track.resolution


def test_out_of_map_clamp_and_shapes(small_track):
    org = T(_org(small_track))
    edf = T(np.asarray(small_track.edf))
    one = lambda v: torch.tensor([v])
    r = pmarch(edf, small_track.resolution, org, one(1000.0), one(1000.0),
               one(1.0), one(0.0), max_range=10.0, max_iters=16)
    assert float(r[0]) == 10.0
    iy, ix = np.unravel_index(np.argmax(edf.numpy()), edf.shape)
    x = small_track.origin_x + (ix + 0.5) * small_track.resolution
    y = small_track.origin_y + (iy + 0.5) * small_track.resolution
    r = pmarch(edf, small_track.resolution, org, one(x), one(y), one(1.0),
               one(0.0), max_range=0.5, max_iters=64)
    assert float(r[0]) <= 0.5 + 1e-6
    out = pscan(edf, small_track.resolution, org, torch.zeros(4, 7, 3),
                num_beams=32, max_iters=8)
    assert out.shape == (4, 7, 32)
    with pytest.raises(ValueError, match="interp"):
        pscan(edf, small_track.resolution, org, torch.zeros(3),
              interp="cubic")


def test_edf_step_matches_jax(small_track):
    """The closed-loop step on the "edf" backend, noise off, 3 steps."""
    n = 8
    scan = dict(num_beams=180)
    jb = jsim.build_sim(small_track, scan=jsim.ScanParams(**scan),
                        backend="edf")
    pb = psim.build_sim(_port_track(small_track),
                        scan=P.ScanParams(**scan), backend="edf", device="cpu")
    assert pb.segmap is None and jb.segmap is None
    poses = _free_poses(small_track, n, 12, margin=0.3)
    js = jstate.state_from_pose(*map(jnp.asarray, poses.T))
    ps = P.state_from_pose(*map(T, poses.T.copy()))
    jstep = jsim.make_step_fn(jb, with_noise=False)
    pstep = psim.make_step_fn(pb, with_noise=False)
    v = np.full(n, 2.0, np.float32)
    st = np.linspace(-0.2, 0.2, n).astype(np.float32)
    for _ in range(3):
        jo = jstep(js, (jnp.asarray(v), jnp.asarray(st)))
        po = pstep(ps, (T(v), T(st)))
        np.testing.assert_allclose(po.state.pose.numpy(),
                                   np.asarray(jo.state.pose), atol=1e-5)
        d = np.abs(po.ranges.numpy() - np.asarray(jo.ranges))
        assert np.mean(d <= 1e-4) >= 0.995 and d.max() < 3 * 0.05
        js, ps = jo.state, po.state
