"""PyTorch port of the implicit-gradient march and the map cotangent
(``ops/raymarch_diff.py``, ``scan_poses_sectors_mapgrad``) against the JAX
package, mirroring tests/test_raymarch_diff.py.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:
- the bracket march ``_march_nearest_plain`` against the JAX
  ``while_loop``: ``hit`` equal, ``total`` and ``last`` within 1e-5 m
  (ROADMAP.md's tolerated fault 6 allows up to a cell where XLA contracts
  the position update; on this CPU they agree), also with a trip count
  that cuts rays off;
- the forward ``_fwd_impl`` (on the card one launch of the kernel
  ``csrc/edf_march.cu``, variant "implicit"; here its plain version, the
  march then ``_refine``) against JAX's ``_fwd_impl``: hit flags equal,
  ranges within 1e-5 m (the bracket's tolerance; on this CPU they agree
  bit for bit), with 256 trips and with 5;
- ``march_rays_implicit`` values and its VJP in (edf, x0, y0, cos, sin)
  against ``jax.vjp``: 1e-5 absolute + 1e-5 relative on the values,
  1e-4 + 1e-4 on the cotangents (on this CPU both are equal bit for bit;
  the bound leaves room for XLA's fused-multiply-add choices);
- ``with_map_gradient``, scatter and dedup, against ``jax.grad``: 1e-4 +
  1e-5 relative (the same four float32 products per ray, summed in
  another order by the dedup form);
- the map-grad sector scan: forward equal to ``scan_poses_sectors`` bit for
  bit; the EDF cotangent against the JAX facade's within 1e-2 absolute +
  1e-3 relative (each package builds its own beam fan, ROADMAP.md fault
  3.1, which moves a hit point by float32 ulps);
- ``scan_poses_implicit``'s VJP in the poses (``_ScanImplicit``, the plain
  ``implicit_pose_vjp_plain`` on this CPU): against ``jax.vjp`` of the JAX
  package's ``scan_poses_implicit`` within 1e-4 + 1e-4 relative plus
  ``SUM_TOL`` x the sum of the agent's |terms| (each package builds its own
  fan, fault 3.1, and each sums the beams in its own order); against the
  composition it replaces (``rays_from_poses`` + ``_MarchImplicit`` under
  autograd) within ``SUM_TOL`` x the sum of |terms|, with the x and y
  terms of each ray equal to that composition's ray cotangents bit for
  bit and the forward's ranges equal bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pyracecarsimulator_tpu import simulator as jsim
from pyracecarsimulator_tpu.maps.edt import edt
from pyracecarsimulator_tpu.ops import raymarch_diff as jdiff

import pyracecarsimulator_tpu_torch as P
from pyracecarsimulator_tpu_torch import simulator as psim
from pyracecarsimulator_tpu_torch.maps.loader import TrackMap
from pyracecarsimulator_tpu_torch.maps.segments import (
    extract_segments, raycast_segments_numpy)
from pyracecarsimulator_tpu_torch.ops import raycast_sectors as psec
from pyracecarsimulator_tpu_torch.ops import raymarch_diff as pdiff
from pyracecarsimulator_tpu_torch.ops.raymarch_xla import march_rays

RES = 0.05
MAXR = 6.0
FOV = 4.712388980384690
# the pose cotangent's beam sums, relative to the sum of the agent's
# |terms|: float32 sums of ~1000 terms in two orders differ by a few ulps
# of that sum in each (a sequential sum's bound is 1080 x 2^-24 = 6.4e-5)
SUM_TOL = 1e-5
T = lambda a: torch.tensor(np.asarray(a))      # an own, writable copy


@pytest.fixture(scope="module")
def field():
    """tests/test_raymarch_diff.py's field: a walled square with 25 random
    blocks; (occ, edf, org, (H, W)) as numpy."""
    rng = np.random.RandomState(11)
    h = w = 160
    occ = np.zeros((h, w), np.float32)
    occ[:3, :] = 1; occ[-3:, :] = 1; occ[:, :3] = 1; occ[:, -3:] = 1
    for _ in range(25):
        r, c = rng.randint(8, h - 14), rng.randint(8, w - 14)
        bh, bw = rng.randint(2, 10, 2)
        occ[r:r + bh, c:c + bw] = 1
    edf = np.asarray(edt(occ >= 0.5, RES), np.float32)
    org = np.asarray((-h * RES / 2, -w * RES / 2), np.float32)
    return occ, edf, org, (h, w)


def _rays(field, n, seed):
    _, edf, org, _ = field
    rng = np.random.RandomState(seed)
    ys, xs = np.where(edf > 0.25)
    k = rng.randint(len(ys), size=n)
    th = rng.uniform(-np.pi, np.pi, n)
    return tuple(np.asarray(v, np.float32) for v in (
        org[0] + (xs[k] + .5) * RES, org[1] + (ys[k] + .5) * RES,
        np.cos(th), np.sin(th)))


def _port_implicit(field, edf, rays, **kw):
    _, _, org, hw = field
    return pdiff.march_rays_implicit(edf, RES, T(org), *rays, MAXR, 1e-4,
                                     kw.get("max_iters", 256), hw)


@pytest.mark.parametrize("max_iters", [256, 5])
def test_march_nearest_bracket_matches_jax(field, max_iters):
    _, edf, org, hw = field
    rays = _rays(field, 300, 4)
    args = (RES ** -1, np.float32(org[0]), np.float32(org[1]))
    ref = jdiff._march_nearest(jnp.asarray(edf), *args,
                               *map(jnp.asarray, rays), MAXR, 1e-4,
                               max_iters, hw)
    ox, oy = T(org)
    got = pdiff._march_nearest_plain(T(edf), 1.0 / RES, ox, oy,
                                     *map(T, rays), MAXR, 1e-4, max_iters,
                                     hw)
    total, last, hit = (np.asarray(v) for v in ref)
    np.testing.assert_array_equal(got[2].numpy(), hit)
    np.testing.assert_allclose(got[0].numpy(), total, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), last, atol=1e-5)
    assert hit.mean() > (0.5 if max_iters > 5 else 0.0)


@pytest.mark.parametrize("max_iters", [256, 5])
def test_fwd_impl_matches_jax(field, max_iters):
    _, edf, org, hw = field
    rays = _rays(field, 300, 6)
    r_ref, hit_ref = jdiff._fwd_impl(jnp.asarray(edf), RES, jnp.asarray(org),
                                     *map(jnp.asarray, rays), MAXR, 1e-4,
                                     max_iters, hw)
    ox, oy = T(org)
    r, hit = pdiff._fwd_impl(T(edf), RES, ox, oy, *map(T, rays), MAXR, 1e-4,
                             max_iters, hw)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_ref))
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), atol=1e-5,
                               rtol=0)
    assert hit.numpy().mean() > (0.5 if max_iters > 5 else 0.0)
    assert (r.numpy() < MAXR).any() and (r.numpy() <= MAXR).all()


def test_implicit_values_and_vjp_match_jax(field):
    _, edf, org, hw = field
    rays = _rays(field, 384, 0)
    g = np.random.RandomState(1).randn(384).astype(np.float32)
    r_ref, vjp = jax.vjp(
        lambda *a: jdiff.march_rays_implicit(a[0], RES, jnp.asarray(org),
                                             *a[1:], MAXR, 1e-4, 256, hw),
        *map(jnp.asarray, (edf,) + rays))
    ct_ref = vjp(jnp.asarray(g))
    args = [torch.tensor(v, requires_grad=True) for v in (edf,) + rays]
    r = _port_implicit(field, args[0], args[1:])
    r.backward(T(g))
    np.testing.assert_allclose(r.detach().numpy(), np.asarray(r_ref),
                               atol=1e-5, rtol=1e-5)
    for a, ref in zip(args, ct_ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=1e-4)
    assert np.abs(args[0].grad.numpy()).sum() > 0


def test_forward_tracks_boundary_oracle(field):
    """tests/test_raymarch_diff.py's value contract on the port: the hit
    sits on the occupied-cell boundary of the float64 segment oracle
    wherever the nearest march agrees with that oracle."""
    occ, edf, org, hw = field
    rays = _rays(field, 512, 0)
    with torch.no_grad():
        r_imp = _port_implicit(field, T(edf), tuple(map(T, rays))).numpy()
    r_near = march_rays(T(edf), RES, T(org), *map(T, rays), max_range=MAXR,
                        eps=1e-4, max_iters=512, bounds_hw=hw).numpy()
    r_or = raycast_segments_numpy(extract_segments(occ, RES, org), *rays,
                                  MAXR)
    agree = np.abs(r_near - r_or) < 2 * RES
    assert agree.mean() > 0.9
    d = np.abs(r_imp - r_or)[agree]
    assert np.quantile(d, 0.95) < 1.5 * RES
    assert (r_imp - r_near).max() < RES


def test_vjp_matches_fd_of_own_forward(field):
    """Central finite differences of the port's forward against its VJP
    in the four ray arguments, kink-filtered as in the JAX test."""
    _, edf, _, _ = field
    rays = [T(v) for v in _rays(field, 96, 3)]
    args = [torch.tensor(v.numpy(), requires_grad=True) for v in rays]
    _port_implicit(field, T(edf), args).sum().backward()

    def f(rs):
        with torch.no_grad():
            return float(_port_implicit(field, T(edf), rs).sum())

    h = 1e-3
    rng = np.random.RandomState(0)
    checked = passed = 0
    f0 = f(rays)
    for ai in range(4):
        ga = args[ai].grad.numpy()
        for j in rng.choice(96, 8, replace=False):
            plus, minus = list(rays), list(rays)
            plus[ai] = rays[ai].clone()
            plus[ai][j] += h
            minus[ai] = rays[ai].clone()
            minus[ai][j] -= h
            fd_f, fd_b = (f(plus) - f0) / h, (f0 - f(minus)) / h
            fd = 0.5 * (fd_f + fd_b)
            if abs(fd_f - fd_b) >= 0.05 * (1 + abs(fd)) or abs(fd) >= 50:
                continue
            checked += 1
            passed += abs(fd - ga[j]) < 5e-2 + 0.05 * abs(fd)
    assert checked >= 12 and passed / checked >= 0.9, (checked, passed)


def test_scan_wrapper_and_misses(field):
    _, edf, org, hw = field
    poses = torch.tensor([[0.0, 0.0, 0.3], [50.0, 50.0, 0.0]])
    e = torch.tensor(edf, requires_grad=True)
    r = pdiff.scan_poses_implicit(e, RES, T(org), poses, num_beams=64,
                                  max_range=MAXR, bounds_hw=hw)
    assert r.shape == (2, 64)
    assert bool((r[1] == MAXR).all())              # out of map
    r[1].sum().backward()                          # misses: no map grad
    assert float(e.grad.abs().sum()) == 0.0


@pytest.mark.parametrize("dedup", [False, True])
def test_with_map_gradient_matches_jax(field, dedup):
    _, edf, org, hw = field
    rays = _rays(field, 256, 9)
    with torch.no_grad():
        r = _port_implicit(field, T(edf), tuple(map(T, rays))).numpy()

    def loss(e):
        return jnp.sum(jdiff.with_map_gradient(
            e, jnp.asarray(r), *map(jnp.asarray, rays), RES,
            jnp.asarray(org), 1e-4, hw, dedup) ** 2)

    g_ref = np.asarray(jax.grad(loss)(jnp.asarray(edf)))
    e = torch.tensor(edf, requires_grad=True)
    rin = torch.tensor(r, requires_grad=True)
    out = pdiff.with_map_gradient(e, rin, *map(T, rays), RES, T(org), 1e-4,
                                  hw, dedup)
    assert torch.equal(out, T(r))                  # straight through
    (out ** 2).sum().backward()
    assert np.abs(g_ref).sum() > 0
    np.testing.assert_allclose(e.grad.numpy(), g_ref, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(rin.grad.numpy(), 2 * r, rtol=1e-6)


def test_dedup_matches_scatter(field):
    _, edf, org, _ = field
    rays = tuple(map(T, _rays(field, 512, 5)))
    with torch.no_grad():
        r = _port_implicit(field, T(edf), rays, max_iters=128)

    def grad_of(dedup):
        e = torch.tensor(edf, requires_grad=True)
        (pdiff.with_map_gradient(e, r, *rays, RES, T(org), 1e-4, None,
                                 dedup) ** 2).sum().backward()
        return e.grad.numpy()

    g0, g1 = grad_of(False), grad_of(True)
    assert np.abs(g0).sum() > 0
    np.testing.assert_allclose(g0, g1, rtol=1e-5, atol=1e-6)


def test_map_grad_sector_scan(small_track):
    """make_scan_fn(map_grad=True): the sector scan's values bit for bit,
    the EDF cotangent against the JAX facade's."""
    t = small_track
    pt = TrackMap.from_numpy(np.asarray(t.occupancy), np.asarray(t.edf),
                             resolution=t.resolution, origin_x=t.origin_x,
                             origin_y=t.origin_y, height=t.height,
                             width=t.width, device="cpu")
    jb = jsim.build_sim(t, scan=jsim.ScanParams(num_beams=128,
                                                max_range=6.0),
                        backend="sectors")
    pb = psim.build_sim(pt, scan=P.ScanParams(num_beams=128, max_range=6.0),
                        backend="sectors", device="cpu")
    rng = np.random.RandomState(11)
    e_real = np.asarray(t.edf)[: t.height, : t.width]
    ys, xs = np.where(e_real > 0.5)
    k = rng.randint(len(ys), size=8)
    poses = np.stack([t.origin_x + (xs[k] + .5) * t.resolution,
                      t.origin_y + (ys[k] + .5) * t.resolution,
                      rng.uniform(-np.pi, np.pi, 8)], -1).astype(np.float32)
    scan_j = jsim.make_scan_fn(jb, map_grad=True)
    g_ref = np.asarray(jax.grad(lambda e: jnp.sum(
        scan_j(jnp.asarray(poses), e) ** 2))(jnp.asarray(t.edf)))
    scan_g = psim.make_scan_fn(pb, map_grad=True)
    e = torch.tensor(np.asarray(t.edf), requires_grad=True)
    r = scan_g(T(poses), e)
    assert torch.equal(r.detach(), psim.make_scan_fn(pb)(T(poses)))
    assert torch.equal(r.detach(), psec.scan_poses_sectors(
        pb.segmap, T(poses), num_beams=128, max_range=6.0))
    (r ** 2).sum().backward()
    assert np.abs(e.grad.numpy()).sum() > 0
    np.testing.assert_allclose(e.grad.numpy(), g_ref, atol=1e-2, rtol=1e-3)
    # the pose cotangent flows through the sector scan's own VJP
    p = T(poses).requires_grad_(True)
    scan_g(p, T(np.asarray(t.edf))).sum().backward()
    assert torch.isfinite(p.grad).all() and float(p.grad.abs().sum()) > 0


def _pose_cases(field):
    """Pose sets of the pose-VJP tests: (poses (N, 3) float32, num_beams,
    theta_discretization). "exact": free poses; "bucketed": the same on
    the theta-bucket fan; "misses": one pose outside the map (every beam
    misses), one at the map's centre, and free poses with a short range
    budget; "grazing": a pose 3 cm from the bottom wall heading along it,
    whose fan of 1081 beams has a hit below the slope floor and hits off
    the level set, beside free poses."""
    _, edf, org, _ = field
    rng = np.random.RandomState(21)
    ys, xs = np.where(edf > 0.25)
    k = rng.randint(len(ys), size=6)
    free = np.stack([org[0] + (xs[k] + .5) * RES, org[1] + (ys[k] + .5) * RES,
                     rng.uniform(-np.pi, np.pi, 6)], -1).astype(np.float32)
    wall = org[1] + 3 * RES
    return {
        "exact": (free, 64, 0),
        "bucketed": (free, 64, 2000),
        "misses": (np.concatenate([[[50.0, 50.0, 0.2], [0.0, 0.0, 0.3]],
                                   free[:3]]).astype(np.float32), 64, 0),
        "grazing": (np.concatenate([[[0.0, wall + 0.03, 0.0]],
                                    free[:2]]).astype(np.float32), 1081, 0),
    }


def _port_scan(field, edf, poses, beams, disc):
    _, _, org, hw = field
    return pdiff.scan_poses_implicit(edf, RES, T(org), poses,
                                     num_beams=beams, fov=FOV,
                                     max_range=MAXR,
                                     theta_discretization=disc, bounds_hw=hw)


def _term_sums(field, edf, poses, beams, g):
    """The sum over each agent's beams of |terms| (N, 3) of the exact fan's
    pose cotangent (``_pose_terms``), the scale of its sums' rounding."""
    _, _, org, hw = field
    p = T(poses)
    fan = P.ops.common.fan_factors(
        p[:, 2], P.ops.common.beam_angles(beams, FOV, "cpu"))
    ox, oy = T(org)
    with torch.no_grad():
        r, hit = pdiff._fwd_impl(T(edf), RES, ox, oy, p[:, 0:1], p[:, 1:2],
                                 *P.ops.common.rotate_fan(*fan), MAXR, 1e-4,
                                 256, hw)
        terms = pdiff._pose_terms(T(edf), RES, ox, oy, p, *fan, r, hit,
                                  T(g), 1e-4, hw)
    return torch.stack([t.abs().sum(-1) for t in terms], -1).numpy()


@pytest.mark.parametrize("case", ["exact", "bucketed", "misses", "grazing"])
def test_scan_pose_vjp_matches_jax(field, case):
    """The scan's values and its VJP in the poses against ``jax.vjp`` of
    the JAX package's ``scan_poses_implicit``."""
    _, edf, org, hw = field
    poses, beams, disc = _pose_cases(field)[case]
    g = np.random.RandomState(3).randn(len(poses), beams).astype(np.float32)
    r_ref, vjp = jax.vjp(
        lambda p: jdiff.scan_poses_implicit(
            jnp.asarray(edf), RES, jnp.asarray(org), p, num_beams=beams,
            fov=FOV, max_range=MAXR, theta_discretization=disc,
            bounds_hw=hw), jnp.asarray(poses))
    (ct_ref,) = vjp(jnp.asarray(g))
    p = T(poses).requires_grad_(True)
    r = _port_scan(field, T(edf), p, beams, disc)
    r.backward(T(g))
    np.testing.assert_allclose(r.detach().numpy(), np.asarray(r_ref),
                               atol=1e-5, rtol=1e-5)
    got, ref = p.grad.numpy(), np.asarray(ct_ref)
    scale = _term_sums(field, edf, poses, beams, g)
    assert (np.abs(got - ref) <= 1e-4 + 1e-4 * np.abs(ref)
            + SUM_TOL * scale).all(), np.abs(got - ref).max()
    hits = r.detach().numpy() < MAXR
    if case == "bucketed":     # the bucket's floor: no heading gradient
        assert (got[:, 2] == 0).all() and np.abs(got[:, :2]).sum() > 0
    else:
        assert (np.abs(got).sum(-1) > 0).all() or case == "misses"
    if case == "misses":
        assert not hits[0].any() and (got[0] == 0).all()
        assert np.abs(got[1:]).sum() > 0
    if case == "grazing":
        p0 = T(poses[:1])
        fan = P.ops.common.fan_factors(
            p0[:, 2], P.ops.common.beam_angles(beams, FOV, "cpu"))
        ct, st = P.ops.common.rotate_fan(*fan)
        ox, oy = T(org)
        x0, y0 = p0[:, 0:1], p0[:, 1:2]
        rr = r.detach()[:1]
        gx, gy = (x0 + rr * ct - ox) / RES, (y0 + rr * st - oy) / RES
        val, dgx, dgy, _, _, _ = pdiff._bilinear_patch(T(edf), gx, gy, hw)
        denom = (dgx * ct + dgy * st) / RES
        on = pdiff._surface_gate(val, pdiff._surface_level(1e-4, RES))
        hit0 = T(hits[:1])
        assert bool((hit0 & on & (denom.abs() < pdiff._DENOM_FLOOR)).any())
        assert bool((hit0 & ~on).any())


@pytest.mark.parametrize("case", ["exact", "misses", "grazing"])
def test_scan_pose_vjp_matches_composition(field, case):
    """``_ScanImplicit`` against the composition it replaces,
    ``rays_from_poses`` + ``_MarchImplicit`` under autograd: the ranges bit
    for bit, each ray's x and y terms equal to the composition's ray
    cotangents bit for bit, the agents' sums within ``SUM_TOL`` x the sum
    of their |terms|."""
    _, edf, org, hw = field
    poses, beams, _ = _pose_cases(field)[case]
    g = T(np.random.RandomState(4).randn(len(poses), beams)
          .astype(np.float32))
    p = T(poses).requires_grad_(True)
    r = _port_scan(field, T(edf), p, beams, 0)
    r.backward(g)
    q = T(poses).requires_grad_(True)
    _, _, xb, yb, ct, st = P.ops.common.rays_from_poses(q, beams, FOV)
    rays = [v.detach().requires_grad_(True) for v in (xb, yb, ct, st)]
    r_old = pdiff.march_rays_implicit(T(edf), RES, T(org), *rays, MAXR,
                                      1e-4, 256, hw)
    r_old.backward(g)
    torch.autograd.backward((xb, yb, ct, st), [v.grad for v in rays])
    assert torch.equal(r.detach(), r_old.detach())
    fan = P.ops.common.fan_factors(
        T(poses)[:, 2], P.ops.common.beam_angles(beams, FOV, "cpu"))
    ox, oy = T(org)
    hit = pdiff._fwd_impl(T(edf), RES, ox, oy, xb.detach(), yb.detach(),
                          ct.detach(), st.detach(), MAXR, 1e-4, 256, hw)[1]
    terms = pdiff._pose_terms(T(edf), RES, ox, oy, T(poses), *fan,
                              r.detach(), hit, g, 1e-4, hw)
    assert torch.equal(terms[0], rays[0].grad)
    assert torch.equal(terms[1], rays[1].grad)
    scale = torch.stack([t.abs().sum(-1) for t in terms], -1)
    assert bool(((p.grad - q.grad).abs() <= SUM_TOL * scale).all()), \
        float((p.grad - q.grad).abs().max())
    assert float(p.grad.abs().sum()) > 0


def test_scan_map_and_pose_cotangents_match_jax(field):
    """With the EDF requiring grad the scan's VJP gives both cotangents:
    the map's (``_hit_scale`` + ``_scatter_taps``) and the poses', each
    against ``jax.vjp``; the map's within the map-grad sector scan's 1e-2
    + 1e-3 relative, as each package's own fan moves the hit points (fault
    3.1), and bit for bit the composition's (``rays_from_poses`` +
    ``_MarchImplicit``)."""
    _, edf, org, hw = field
    poses, beams, _ = _pose_cases(field)["exact"]
    g = np.random.RandomState(5).randn(len(poses), beams).astype(np.float32)
    _, vjp = jax.vjp(
        lambda e, p: jdiff.scan_poses_implicit(
            e, RES, jnp.asarray(org), p, num_beams=beams, fov=FOV,
            max_range=MAXR, bounds_hw=hw),
        jnp.asarray(edf), jnp.asarray(poses))
    e_ref, p_ref = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    e = T(edf).requires_grad_(True)
    p = T(poses).requires_grad_(True)
    _port_scan(field, e, p, beams, 0).backward(T(g))
    assert np.abs(e_ref).sum() > 0
    np.testing.assert_allclose(e.grad.numpy(), e_ref, atol=1e-2, rtol=1e-3)
    e_old = T(edf).requires_grad_(True)
    _, _, *rays = P.ops.common.rays_from_poses(T(poses), beams, FOV)
    pdiff.march_rays_implicit(e_old, RES, T(org), *rays, MAXR, 1e-4, 256,
                              hw).backward(T(g))
    assert torch.equal(e.grad, e_old.grad)
    scale = _term_sums(field, edf, poses, beams, g)
    assert (np.abs(p.grad.numpy() - p_ref) <= 1e-4 + 1e-4 * np.abs(p_ref)
            + SUM_TOL * scale).all()


def test_scan_saves_fan_factors_only(field):
    """Under ``torch.no_grad`` the scan saves nothing for a backward; with
    a gradient it keeps the ranges and hit flags and the fan's (N,) and
    (B,) factors, not the (N, B) cosines."""
    _, edf, _, _ = field
    poses, beams, _ = _pose_cases(field)["exact"]
    packed = []

    def pack(t):
        packed.append((tuple(t.shape), t.dtype))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with torch.no_grad():
            r0 = _port_scan(field, T(edf), T(poses).requires_grad_(True),
                            beams, 0)
        assert packed == [] and r0.grad_fn is None
        r = _port_scan(field, T(edf), T(poses).requires_grad_(True), beams,
                       0)
    assert torch.equal(r.detach(), r0)
    rays = (len(poses), beams)
    assert sorted(str(d) for s, d in packed if s == rays) == [
        "torch.bool", "torch.float32"]
    assert ((len(poses),), torch.float32) in packed
    assert ((beams,), torch.float32) in packed


def test_pose_vjp_wrapper_refuses_terms_on_cpu(field):
    _, edf, org, hw = field
    poses, beams, _ = _pose_cases(field)["exact"]
    p = T(poses)
    fan = P.ops.common.fan_factors(
        p[:, 2], P.ops.common.beam_angles(beams, FOV, "cpu"))
    r = torch.zeros(len(poses), beams)
    hit = torch.zeros(len(poses), beams, dtype=torch.bool)
    ox, oy = T(org)
    args = (T(edf), RES, ox, oy, p, *fan, r, hit, r, 1e-4, hw)
    assert torch.equal(pdiff.implicit_pose_vjp(*args),
                       torch.zeros(len(poses), 3))
    with pytest.raises(ValueError, match="terms"):
        pdiff.implicit_pose_vjp(*args, terms=torch.zeros(3, *r.shape))
    assert pdiff.implicit_pose_vjp.launches == 0
