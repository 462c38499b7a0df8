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
from pyracecarsimulator_tpu_torch.ops.raymarch_diff import (
    scan_poses_implicit as pdiff_scan)

T = lambda a: torch.tensor(np.asarray(a))      # an own, writable copy


def _port_track(track):
    return TrackMap.from_numpy(
        np.asarray(track.occupancy), np.asarray(track.edf),
        resolution=track.resolution, origin_x=track.origin_x,
        origin_y=track.origin_y, height=track.height, width=track.width,
        name=track.name, device="cpu")


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
    """The port's scan_batch against the JAX oracle's per-pose ``scan``:
    its Python loop bit for bit, its native body (which sums the range in
    float64 where the loop sums NumPy float32 scalars) within 1e-5 m, the
    bound of ``tests/test_native.py``."""
    from pyracecarsimulator_tpu_torch._native import loader as pnat
    edf = np.asarray(small_track.edf)
    org = (small_track.origin_x, small_track.origin_y)
    poses = _free_poses(small_track, 3, 4)
    ref = np.stack([jorc.scan(edf, small_track.resolution, org, p,
                              num_beams=60, max_iters=1000) for p in poses])
    with pnat.numpy_only():
        got = porc.scan_batch(edf, small_track.resolution, org, poses,
                              num_beams=60, max_iters=1000)
    np.testing.assert_array_equal(got, ref)
    before = pnat.trace_rays.calls
    got_native = porc.scan_batch(edf, small_track.resolution, org, poses,
                                 num_beams=60, max_iters=1000)
    assert pnat.trace_rays.calls == before + pnat.available()
    np.testing.assert_allclose(got_native, ref, atol=1e-5)


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


@pytest.mark.parametrize("backend", ["edf", "edf_implicit"])
def test_edf_step_marches_once_and_as_far_as_its_scan(small_track, backend):
    """A closed-loop step on a march backend runs one march and nothing
    more: the trips it takes (``raymarch_xla.MARCH_COUNTS``) are those of
    one scan from the stepped cars' scanner poses, and its ranges are that
    scan's. The loop leaves only at every 32nd trip, so a step can march a
    block further than a scan from other poses."""
    from pyracecarsimulator_tpu_torch.ops.raymarch_xla import (_ALIVE_CHECK,
                                                               MARCH_COUNTS)
    bundle = psim.build_sim(_port_track(small_track), backend=backend,
                            scan=P.ScanParams(num_beams=90), device="cpu")
    poses = T(_free_poses(small_track, 6, 9))
    s0 = P.state_from_pose(poses[:, 0], poses[:, 1], poses[:, 2])
    act = (torch.full((6,), 2.0), torch.zeros(6))
    step = psim.make_step_fn(bundle, with_noise=False)
    before = dict(MARCH_COUNTS)
    out = step(s0, act)
    stepped = {k: MARCH_COUNTS[k] - before[k] for k in before}
    assert stepped["calls"] == 1
    assert 0 < stepped["trips"] <= bundle.scan.max_march_iters
    assert (stepped["trips"] % _ALIVE_CHECK == 0
            or stepped["trips"] == bundle.scan.max_march_iters)
    d = bundle.car.scan_distance_to_base_link
    s = out.state
    lidar = torch.stack([s.x + d * torch.cos(s.theta),
                         s.y + d * torch.sin(s.theta), s.theta], -1)
    before = dict(MARCH_COUNTS)
    r = psim.make_scan_fn(bundle)(lidar)
    assert MARCH_COUNTS["calls"] - before["calls"] == 1
    assert MARCH_COUNTS["trips"] - before["trips"] == stepped["trips"]
    assert torch.equal(r, out.ranges)


# -- the kernel's wrapper: its route, its arguments, its counters ------------
# (the kernel itself runs on the card: tests/test_torch_kernels.py)

def _stand_ins(monkeypatch, calls):
    """The device check says "the card"; ``edf_march`` and
    ``edf_march_grad`` are replaced by their plain versions (autograd
    through the plain loop for the gradient), each call recorded in
    ``calls``: (variant, x0's strides) and ("grad", edf_grad, ray_grad)."""
    from pyracecarsimulator_tpu_torch.ops import _kernels
    from pyracecarsimulator_tpu_torch.ops import raymarch_diff as rd
    from pyracecarsimulator_tpu_torch.ops import raymarch_xla as rx

    def kernel(edf, inv_res, ox, oy, x, y, c, s, max_range, eps, max_iters,
               bounds_hw, variant, ray_trips=None, walk=None, refine=None):
        calls.append((variant, x.stride(), y.stride()))
        with torch.no_grad():
            if variant == "implicit":
                return rd._fwd_plain(edf, inv_res, ox, oy, x, y, c, s,
                                     max_range, eps, max_iters, bounds_hw,
                                     refine)
            return rx.march_rays_plain(edf, inv_res, ox, oy, x, y, c, s,
                                       max_range, eps, max_iters, variant,
                                       bounds_hw)

    def grad(*args, walk=None):
        calls.append(("grad",) + args[-2:])
        return rx.march_grad_plain(*args)

    monkeypatch.setattr(_kernels, "on_cuda", lambda name, ref: True)
    monkeypatch.setattr(rx, "edf_march", kernel)
    monkeypatch.setattr(rd, "edf_march", kernel)
    monkeypatch.setattr(rx, "edf_march_grad", grad)


@pytest.mark.parametrize("interp, edf_grad, ray_grad, grad_mode, grads", [
    ("nearest", False, False, True, None),
    ("nearest", False, True, True, None),
    ("nearest", True, False, True, (True, False)),
    ("nearest", True, True, False, None),
    ("bilinear", False, False, True, None),
    ("bilinear", False, True, True, (False, True)),
    ("bilinear", True, False, True, (True, False)),
    ("bilinear", True, True, False, None),
])
def test_march_route(small_track, monkeypatch, interp, edf_grad, ray_grad,
                     grad_mode, grads):
    """CPU tensors run the plain loop under autograd; CUDA tensors launch
    ``edf_march``, and where autograd needs the march's gradient its
    backward launches ``edf_march_grad`` once, for what needs one: the
    EDF, and the rays of a bilinear march (a nearest march's range has no
    gradient in the rays). With the plain versions standing in for the
    kernels, values and gradients equal the CPU's bit for bit."""
    edf0 = T(np.asarray(small_track.edf))
    poses = T(_free_poses(small_track, 3, 4))
    kw = dict(num_beams=24, max_iters=200, interp=interp,
              bounds_hw=(small_track.height, small_track.width))
    g = torch.linspace(0.5, 1.5, 3 * 24).reshape(3, 24)

    def run():
        edf = edf0.clone().requires_grad_(edf_grad)
        q = poses.clone().requires_grad_(ray_grad)
        with torch.set_grad_enabled(grad_mode):
            r = pscan(edf, small_track.resolution, T(_org(small_track)), q,
                      **kw)
        if r.requires_grad:
            r.backward(g)
        return r.detach(), r.requires_grad, edf.grad, q.grad

    ref = run()
    calls = []
    _stand_ins(monkeypatch, calls)
    got = run()
    assert [c[0] for c in calls] == [interp] + (["grad"] if grads else [])
    if grads:
        assert calls[1][1:] == grads
    assert torch.equal(got[0], ref[0]) and got[1] == ref[1] == bool(grads)
    for a, b in zip(got[2:], ref[2:]):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


def test_march_entry_points_take_the_route(small_track, monkeypatch):
    """With the device check saying "the card": ``march_rays`` (both
    interpolations, through ``scan_poses``) and the implicit march's
    ``_fwd_impl`` hand ``edf_march`` the scan's expanded origin views
    (stride 0 along the beams, never a copy) and its variant, and return
    what it returns; the bilinear march's backward goes to
    ``edf_march_grad``, with the rays' gradient asked for."""
    from pyracecarsimulator_tpu_torch.ops import raymarch_xla as rx
    calls = []
    edf = T(np.asarray(small_track.edf))
    org = T(_org(small_track))
    poses = T(_free_poses(small_track, 5, 3))
    kw = dict(num_beams=40, max_iters=200,
              bounds_hw=(small_track.height, small_track.width))
    ref = {i: pscan(edf, small_track.resolution, org, poses, interp=i, **kw)
           for i in ("nearest", "bilinear")}
    ref_imp = pdiff_scan(edf, small_track.resolution, org, poses, **kw)
    q = poses.clone().requires_grad_(True)
    pscan(edf, small_track.resolution, org, q, interp="bilinear",
          **kw).sum().backward()
    ref_grad = q.grad
    _stand_ins(monkeypatch, calls)
    for interp in ("nearest", "bilinear"):
        got = pscan(edf, small_track.resolution, org, poses, interp=interp,
                    **kw)
        assert torch.equal(got, ref[interp])
    got = pdiff_scan(edf, small_track.resolution, org, poses, **kw)
    assert torch.equal(got, ref_imp)
    assert [v for v, _, _ in calls] == ["nearest", "bilinear", "implicit"]
    assert all(sx == (3, 0) and sy == (3, 0) for _, sx, sy in calls)
    q = poses.clone().requires_grad_(True)
    pscan(edf, small_track.resolution, org, q, interp="bilinear",
          **kw).sum().backward()
    assert calls[3:] == [("bilinear", (3, 0), (3, 0)),
                         ("grad", False, True)]
    assert torch.equal(q.grad, ref_grad) and q.grad.abs().sum() > 0


def test_march_wrapper_views_and_checks(monkeypatch):
    """``_as_rows``: a (rows, cols) view, no copy of a 2-D or expanded
    tensor; ``edf_march`` refuses CPU tensors, and (the device check
    patched) what the kernel does not take, before any launch: a
    gradient without the march's record among it."""
    from pyracecarsimulator_tpu_torch.ops import _kernels
    from pyracecarsimulator_tpu_torch.ops import raymarch_xla as rx
    x = torch.arange(6.0).reshape(3, 2)[:, :1].expand(3, 5)
    assert rx._as_rows(x) is x and x.stride() == (2, 0)
    assert rx._as_rows(torch.zeros(7)).shape == (1, 7)
    assert rx._as_rows(torch.zeros(())).shape == (1, 1)
    assert rx._as_rows(torch.zeros(2, 3, 4)).shape == (6, 4)
    edf = torch.ones(8, 8)
    o = torch.zeros(2)
    rays = [torch.zeros(3, 4) for _ in range(4)]
    args = lambda **kw: {**dict(edf=edf, inv_res=20.0, ox=o[0], oy=o[1],
                                x0=rays[0], y0=rays[1], cos_t=rays[2],
                                sin_t=rays[3], max_range=10.0, eps=1e-4,
                                max_iters=8, bounds_hw=None,
                                variant="nearest"), **kw}
    grad_args = lambda **kw: {
        **{k: v for k, v in args().items() if k != "variant"},
        **dict(interp="bilinear", g=torch.ones(3, 4), edf_grad=True,
               ray_grad=True, walk=torch.zeros(3, 4, dtype=torch.int32)),
        **kw}
    with pytest.raises(ValueError, match="CUDA kernel"):
        rx.edf_march(**args())
    with pytest.raises(ValueError, match="CUDA kernel"):
        rx.edf_march_grad(**grad_args())
    monkeypatch.setattr(_kernels, "on_cuda", lambda name, ref: True)
    for bad, match in ((dict(variant="cubic"), "variant"),
                       (dict(edf=edf.double()), "float32"),
                       (dict(edf=edf.t()), "contiguous"),
                       (dict(max_iters=-1), "max_iters"),
                       (dict(x0=rays[0].double()), "float32"),
                       (dict(ox=o), "0-dim"),
                       (dict(ray_trips=torch.zeros(3, 4)), "int32"),
                       (dict(variant="implicit"), "refine"),
                       (dict(refine=(0.025, 0.02, 0.01)), "refine")):
        with pytest.raises(ValueError, match=match):
            rx.edf_march(**args(**bad))
    for bad, match in ((dict(interp="cubic"), "interp"),
                       (dict(interp="nearest"), "no gradient in the rays"),
                       (dict(max_iters=rx.MAX_GRAD_TRIPS + 1), "at most"),
                       (dict(edf=edf.t()), "contiguous"),
                       (dict(ox=o), "0-dim"),
                       (dict(walk=None), "walk, edf_march's record")):
        with pytest.raises(ValueError, match=match):
            rx.edf_march_grad(**grad_args(**bad))


def test_march_counts_add_the_device_counters():
    """``MARCH_COUNTS`` is the plain loops' host counts plus every
    device's kernel counter ([trips, calls]), read at each lookup; a CPU
    tensor stands in for a device's counter here."""
    from pyracecarsimulator_tpu_torch.ops import raymarch_xla as rx
    counts = rx._MarchCounts()
    counts.host.update(calls=2, trips=64)
    c = counts.counter(torch.device("cpu"))
    assert c.dtype == torch.int64 and c.tolist() == [0, 0]
    c[0], c[1] = 150, 3
    assert dict(counts) == {"calls": 5, "trips": 214}
    assert counts.counter(torch.device("cpu")) is c
    assert set(rx.MARCH_COUNTS) == {"calls", "trips"}


def _edge_rays():
    """(edf (64, 2200) at 5 mm, origin, bounds, rays (4 x (n,)), their
    resolution): a field of 5 mm (one cell a step) with a wall from column
    2100, one ray from every column along the middle row, nearly along
    +x, whose steps before the wall or the 10 m range run through every
    count from 1 to about 2000, and rays from |gx| > 2 ** 31 cells (the
    card's tests add NaN origins and 300,001 rays:
    tests/test_torch_kernels.py::_edge_case)."""
    rng = np.random.RandomState(5)
    edf = np.full((64, 2200), 0.005, np.float32)
    edf[:, 2100:] = 0.0
    k = 2100
    x = np.concatenate([(np.arange(k) + 0.5) * 0.005, [3e7, -3e7, 0.5]])
    y = np.concatenate([np.full(k, 0.1625), [0.15, 0.15, 3e7]])
    th = np.concatenate([rng.uniform(-0.002, 0.002, k), [0.0, 0.0, 0.0]])
    rays = [v.astype(np.float32) for v in (x, y, np.cos(th), np.sin(th))]
    return edf, np.zeros(2, np.float32), (64, 2200), rays, 0.005


def test_plain_march_matches_jax_on_edge_rays():
    """The edge rays of the card's tests, 2048 trips (``MAX_GRAD_TRIPS``):
    the port's plain march against the JAX march to the tolerance of
    ``test_nearest_march_matches_jax_on_shared_rays``; the far origins
    read max_range in both."""
    from pyracecarsimulator_tpu_torch.ops import raymarch_xla as rx
    edf, org, hw, rays, res = _edge_rays()
    kw = dict(max_range=10.0, max_iters=rx.MAX_GRAD_TRIPS, bounds_hw=hw)
    ref = np.asarray(jmarch(jnp.asarray(edf), res, jnp.asarray(org),
                            *map(jnp.asarray, rays), **kw))
    got = pmarch(T(edf), res, T(org), *map(T, rays), **kw).numpy()
    d = np.abs(got - ref)
    assert np.mean(d <= 1e-4) >= 0.995, np.mean(d <= 1e-4)
    assert d.max() < 3 * res
    assert (got[-3:] == 10.0).all() and (ref[-3:] == 10.0).all()
    assert got[:-3].min() < 1.0 and (got[:-3] == 10.0).any()


def _recording_launch(monkeypatch, calls):
    """``_kernels.launch`` replaced by a recorder of (entry, args) that
    writes the march's outputs (zero ranges, a record counting up) and
    leaves the gradient's zeroed ones."""
    from pyracecarsimulator_tpu_torch.ops import _kernels

    def launch(name, entry, *args):
        calls.append((entry, args))
        if entry == "edf_march":
            args[-6].zero_()
            if args[-3] is not None:
                args[-3].copy_(torch.arange(args[-3].numel(),
                                            dtype=torch.int32)
                               .reshape(args[-3].shape))
        elif args[-5] is not None:
            for v in args[-6:-2]:
                v.zero_()

    monkeypatch.setattr(_kernels, "on_cuda", lambda name, ref: True)
    monkeypatch.setattr(_kernels, "launch", launch)


def test_march_wrapper_launch_arguments(monkeypatch):
    """What the wrappers hand the kernels (the launch recorded): the
    variant, the implicit variant's three scalars (0 for the others), its
    hit flags, a zeroed 3-word scratch a march (its longest trips, its
    warps done, the rays' cursor) and a zeroed cursor a gradient, and the
    record ``walk``; the kernel keeps ``GRAD_SLOTS`` positions a ray; a
    wrong record raises."""
    from pyracecarsimulator_tpu_torch.ops import _kernels
    from pyracecarsimulator_tpu_torch.ops import raymarch_xla as rx
    calls = []
    _recording_launch(monkeypatch, calls)
    edf = torch.ones(8, 8)
    o = torch.zeros(2)
    rays = [torch.zeros(3, 4) for _ in range(4)]
    head = (edf, 20.0, o[0], o[1], *rays, 10.0, 1e-4, 8, None)
    walk = torch.zeros(3, 4, dtype=torch.int32)
    rx.edf_march(*head, "bilinear", walk=walk)
    r, hit = rx.edf_march(*head, "implicit", refine=(0.025, 0.02, 0.01))
    (entry, a), (_, b) = calls
    assert entry == "edf_march" and a[0] == 1 and b[0] == 2
    assert a[-9:-6] == (0.0, 0.0, 0.0) and b[-9:-6] == (0.025, 0.02, 0.01)
    assert a[-5] is None and b[-6] is r and b[-5] is hit
    assert hit.dtype == torch.bool and hit.shape == r.shape == (3, 4)
    for args in (a, b):
        scratch = args[-1]
        assert scratch.dtype == torch.int64 and scratch.tolist() == [0] * 3
    assert a[-3] is walk and b[-3] is None
    assert rx.MARCH_COUNTS.counter(edf.device) is a[-2]
    g = torch.ones(3, 4)
    rx.edf_march_grad(*head, "bilinear", g, True, True, walk=walk)
    src = (_kernels.CSRC_DIR / "edf_march.cu").read_text()
    assert f"constexpr int kSlots = {rx.GRAD_SLOTS};" in src
    entry, c = calls[2]
    assert entry == "edf_march_grad" and c[0] == 1
    assert c[-2] is walk
    assert c[-1].dtype == torch.int64 and c[-1].tolist() == [0]
    for bad in (walk.to(torch.int64), walk[:2], walk.t()):
        with pytest.raises(ValueError, match="walk"):
            rx.edf_march(*head, "nearest", walk=bad)
        with pytest.raises(ValueError, match="walk"):
            rx.edf_march_grad(*head, "nearest", g, True, False, walk=bad)


def test_march_wrapper_32_bit_limit(monkeypatch):
    """A map, bounds, a ray count or a ray tensor's last offset past
    2 ** 31 - 1 raises, naming the 32-bit limit, before any launch (meta
    tensors: no memory)."""
    from pyracecarsimulator_tpu_torch.ops import _kernels
    from pyracecarsimulator_tpu_torch.ops import raymarch_xla as rx
    monkeypatch.setattr(_kernels, "on_cuda", lambda name, ref: True)
    meta = dict(device="meta", dtype=torch.float32)
    o = torch.zeros(2, **meta)
    small = torch.empty(16, 16, **meta)
    rays = [torch.empty(3, 4, **meta) for _ in range(4)]
    wide = torch.empty(1, **meta).expand(2 ** 16, 2 ** 16)
    far = torch.empty(1, **meta).as_strided((3, 4), (2 ** 30, 1))

    def run(edf=small, rays=rays, bounds=None):
        args = (edf, 20.0, o[0], o[1], *rays, 10.0, 1e-4, 8, bounds)
        walk = torch.empty(rays[0].shape, device="meta", dtype=torch.int32)
        with pytest.raises(ValueError, match="32-bit index limit"):
            rx.edf_march(*args, "nearest")
        with pytest.raises(ValueError, match="32-bit index limit"):
            rx.edf_march_grad(*args, "bilinear", rays[0], True, True, walk)

    run(edf=torch.empty(2 ** 16, 2 ** 15, **meta))
    run(bounds=(2 ** 31, 16))
    run(rays=[wide] * 4)
    run(rays=[far] + rays[1:])
    assert rx.INDEX_LIMIT == 2 ** 31 - 1


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_march_forward_saves_the_record_for_the_backward(monkeypatch,
                                                         interp):
    """Under autograd ``march_rays``'s forward has the march write its
    record (``walk``: int32, one per ray) and saves it; the backward hands
    the gradient kernel that very tensor. Without autograd no record."""
    from pyracecarsimulator_tpu_torch.ops import raymarch_xla as rx
    calls = []
    _recording_launch(monkeypatch, calls)
    edf = torch.ones(8, 8, requires_grad=True)
    rays = [torch.zeros(3, 4, requires_grad=interp == "bilinear")
            for _ in range(4)]
    r = rx.march_rays(edf, 0.05, (0.0, 0.0), *rays, max_iters=8,
                      interp=interp)
    (entry, fwd), = calls
    walk = fwd[-3]
    assert entry == "edf_march" and walk.dtype == torch.int32
    assert walk.shape == (3, 4) and walk.tolist() == \
        torch.arange(12).reshape(3, 4).tolist()
    r.sum().backward()
    entry, bwd = calls[1]
    assert entry == "edf_march_grad" and bwd[-2] is walk
    with torch.no_grad():
        rx.march_rays(edf, 0.05, (0.0, 0.0), *rays, max_iters=8,
                      interp=interp)
    assert calls[2][1][-3] is None


def test_march_variants_apply_to_the_source(tmp_path):
    """``scripts/march_variants_torch.py``'s variants are the shipped
    ``csrc/edf_march.cu`` with lines replaced: each replacement still
    finds its text the stated number of times, and the copy holds the
    variant's source and the rest of the package."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "march_variants_torch", root / "scripts" / "march_variants_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    shipped = (root / tool.SOURCE).read_text()
    assert set(tool.VARIANTS) == {"global cursor", "shared slots"}
    for name, edits in tool.VARIANTS.items():
        tree = Path(tool.variant_tree(str(tmp_path), name))
        text = (tree / tool.SOURCE).read_text()
        assert text != shipped
        for old, new, count in edits:
            assert shipped.count(old) == count and new in text
        assert (tree / tool.PKG / "ops" / "raymarch_xla.py").exists()
        assert not (tree / tool.PKG / "_build").exists()
