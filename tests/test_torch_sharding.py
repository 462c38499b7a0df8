"""The port's agents x beams sharding against the unsharded port and the
JAX package.

One ``parallel.dryrun.dryrun`` spawn per mesh shape (4 gloo ranks on the
CPU, the port's analogue of the JAX tests' fake 8-device mesh) runs every
sharded path on the tiny two-track case; the tests hold its gathered
results against the unsharded port in this process and against the JAX
package's ``make_sharded_scan`` / ``make_sharded_step`` on a 4-device mesh
of the same shape. Tolerances, as tests/test_sharding.py: ranges atol 1e-5
(bit-exact against the unsharded port where the beam axis is not split:
the 128-beam blocks then coincide), gradients rtol/atol 1e-4, state 1e-6,
collisions equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pyracecarsimulator_tpu.config import ScanParams as JScanParams
from pyracecarsimulator_tpu.maps.loader import (build_track_map as
                                                jax_build_track_map)
from pyracecarsimulator_tpu.maps.sectors import (stack_sector_maps as
                                                 jax_stack_sector_maps)
from pyracecarsimulator_tpu.parallel import mesh as jmesh
from pyracecarsimulator_tpu import simulator as jsim
from pyracecarsimulator_tpu.state import state_from_pose as jax_state

import pyracecarsimulator_tpu_torch as P
from pyracecarsimulator_tpu_torch.maps.sectors import stack_sector_maps
from pyracecarsimulator_tpu_torch.ops.common import rays_from_poses
from pyracecarsimulator_tpu_torch.ops.raycast_grad import raycast_all_diff
from pyracecarsimulator_tpu_torch.ops.raycast_sectors import (
    scan_poses_sectors, scan_poses_sectors_multi)
from pyracecarsimulator_tpu_torch.parallel import dryrun as dr
from pyracecarsimulator_tpu_torch.parallel import mesh as pmesh

NB = 128
SHAPES = [(4, 1), (2, 2), (1, 4)]


@pytest.fixture(scope="module")
def case():
    return dr.tiny_case(agents=16, num_beams=NB, seed=0)


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def sharded(request, case):
    """(mesh shape, rank 0's gathered results of a 4-rank gloo dry run)."""
    a, b = request.param
    return (a, b), dr.dryrun(a * b, beams_axis=b, device="cpu", case=case)


@pytest.fixture(scope="module")
def port_ref(case):
    """The unsharded port on the case, in this process."""
    sectors, dense = dr.case_bundles(case, "cpu")
    t = lambda a: torch.tensor(np.asarray(a))
    kw = dict(num_beams=NB, fov=case["fov"], max_range=case["max_range"])
    out = {}
    p = t(case["poses"]).requires_grad_(True)
    r = scan_poses_sectors(sectors[0].segmap, p, **kw)
    (r ** 2).sum().backward()
    out["scan_sectors"], out["grad_sectors"] = r.detach().numpy(), \
        p.grad.numpy()
    p = t(case["poses"]).requires_grad_(True)
    _, _, xb, yb, ct, st = rays_from_poses(p, NB, case["fov"])
    m = dense.segmap
    r = raycast_all_diff(m.params, m.sweep_meta, xb, yb, ct, st,
                         case["max_range"])
    (r ** 2).sum().backward()
    out["scan_dense"], out["grad_dense"] = r.detach().numpy(), p.grad.numpy()

    def step(bundle, poses):
        q = t(poses)
        n = q.shape[0]
        v, steer = case["action"]
        return P.make_step_fn(bundle, with_noise=False)(
            P.state_from_pose(q[:, 0], q[:, 1], q[:, 2]),
            (torch.full((n,), float(v)), torch.full((n,), float(steer))))

    out["step_sectors"] = step(sectors[0], case["poses"])
    # the JAX sharded body sweeps the dense map untiled; so does the port's
    out["step_dense"] = step(dense._replace(segmap=dataclasses.replace(
        dense.segmap, tiles=None, tile_sweep_meta=None)), case["poses"])
    half = len(case["map_ids"]) // 2
    out["step_stack"] = [step(b, case["stack_poses"][sl]) for b, sl in (
        (sectors[0], slice(0, half)), (sectors[1], slice(half, None)))]
    out["stack"] = stack_sector_maps([b.segmap for b in sectors])
    return out


@pytest.fixture(scope="module")
def jax_ref(case):
    """The JAX package's sharded scan, gradient and steps on the case, on
    a (2, 2) mesh of its fake CPU devices (its results do not depend on
    the mesh's shape beyond the tolerances below; one compile each)."""
    scan_p = JScanParams(num_beams=NB)
    tracks = [jax_build_track_map(m["occupancy"], m["resolution"],
                                  m["origin"]) for m in case["maps"]]
    sectors = [jsim.build_sim(t, scan=scan_p, backend="sectors")
               for t in tracks]
    dense = jsim.build_sim(tracks[0], scan=scan_p, backend="segments")
    mesh = jmesh.make_mesh(jax.devices()[:4], agents_axis=2, beams_axis=2)
    fov = float(case["fov"])
    poses = jnp.asarray(case["poses"])
    out = {}
    for kind, m in (("sectors", sectors[0].segmap),
                    ("dense", dense.segmap.params)):
        scan = jmesh.make_sharded_scan(mesh, m, NB, fov)
        out[f"scan_{kind}"] = np.asarray(scan(poses))
        if kind == "sectors":
            out["grad_sectors"] = np.asarray(
                jax.grad(lambda p: jnp.sum(scan(p) ** 2))(poses))
    v, steer = case["action"]
    action = (jnp.full((16,), v), jnp.full((16,), steer))

    def state_of(p):
        p = jnp.asarray(p)
        return jmesh.shard_state(mesh, jax_state(p[:, 0], p[:, 1], p[:, 2]))

    for kind, b in (("sectors", sectors[0]), ("dense", dense)):
        step = jmesh.make_sharded_step(mesh, b, with_noise=False)
        out[f"step_{kind}"] = step(state_of(case["poses"]), action, None)
    stack = jax_stack_sector_maps([b.segmap for b in sectors])
    step = jmesh.make_sharded_step(mesh, sectors[0], with_noise=False,
                                   stack=stack)
    out["step_stack"] = step(state_of(case["stack_poses"]), action,
                             jnp.asarray(case["map_ids"]), None)
    return out


def test_dryrun_reports_its_world(sharded):
    shape, res = sharded
    assert res["mesh"] == shape and res["backend"] == "gloo"
    assert res["device"] == "cpu"
    # CPU tensors take the plain sweeps: no rank launched a kernel
    assert res["launches"] == [{}] * 4


@pytest.mark.parametrize("kind", ["sectors", "dense"])
def test_sharded_scan_matches_unsharded_port(sharded, port_ref, kind):
    """atol 1e-5; bit-exact where the beam axis is not split."""
    shape, res = sharded
    got, ref = res[f"scan_{kind}"], port_ref[f"scan_{kind}"]
    assert got.shape == ref.shape == (16, NB)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    if shape[1] == 1 or kind == "dense":
        np.testing.assert_array_equal(got, ref)
    assert np.mean(ref < 10.0) > 0.5


@pytest.mark.parametrize("kind", ["sectors", "dense"])
def test_sharded_scan_matches_jax_sharded_scan(sharded, jax_ref, kind):
    """Against JAX's make_sharded_scan: each package builds its own fan,
    so (ROADMAP.md fault 3.1) at least 99.5% of the beams agree within
    1e-5 m and at least 99.9% within 1e-4 m (the rest flip their winner
    at an edge)."""
    _, res = sharded
    d = np.abs(res[f"scan_{kind}"] - jax_ref[f"scan_{kind}"])
    assert np.mean(d <= 1e-5) >= 0.995
    assert np.mean(d <= 1e-4) >= 0.999


@pytest.mark.parametrize("kind", ["sectors", "dense"])
def test_sharded_gradient_collective(sharded, port_ref, kind):
    """The pose gradient of sum(ranges^2) over all wedges equals the
    unsharded gradient (rtol/atol 1e-4): the explicit all-reduce over the
    beams group. Without it a rank would hold its wedge's share only."""
    _, res = sharded
    got, ref = res[f"grad_{kind}"], port_ref[f"grad_{kind}"]
    assert got.shape == (16, 3) and np.abs(ref).sum() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_sharded_gradient_matches_jax_grad(sharded, jax_ref):
    """Against jax.grad through JAX's sharded sector scan (the psum that
    shard_map's transpose inserts): rtol/atol 1e-4 on at least 95% of the
    pose components (free-running fans, fault 3.1)."""
    _, res = sharded
    close = np.isclose(res["grad_sectors"], jax_ref["grad_sectors"],
                       rtol=1e-4, atol=1e-4)
    assert close.mean() >= 0.95


@pytest.mark.parametrize("kind", ["sectors", "dense"])
def test_sharded_step_matches_unsharded_port(sharded, port_ref, kind):
    """State 1e-6, ranges 1e-5, collisions equal."""
    _, res = sharded
    got, ref = res[f"step_{kind}"], port_ref[f"step_{kind}"]
    np.testing.assert_allclose(got["ranges"], ref.ranges.numpy(), atol=1e-5)
    np.testing.assert_array_equal(got["collision"], ref.collision.numpy())
    for f, v in ref.state.numpy().items():
        if v.dtype == bool:
            np.testing.assert_array_equal(got["state"][f], v)
        else:
            np.testing.assert_allclose(got["state"][f], v, atol=1e-6)


@pytest.mark.parametrize("kind", ["sectors", "dense"])
def test_sharded_step_matches_jax_sharded_step(sharded, jax_ref, kind):
    """Against JAX's make_sharded_step: state 1e-6 (1e-5 on theta, fault
    3.1's trig), collisions equal, at least 99.5% of the beams within
    1e-4 m."""
    _, res = sharded
    got, ref = res[f"step_{kind}"], jax_ref[f"step_{kind}"]
    d = np.abs(got["ranges"] - np.asarray(ref.ranges))
    assert np.mean(d <= 1e-4) >= 0.995
    np.testing.assert_array_equal(got["collision"],
                                  np.asarray(ref.collision))
    for f in ("x", "y", "velocity", "steer_angle"):
        np.testing.assert_allclose(got["state"][f],
                                   np.asarray(getattr(ref.state, f)),
                                   atol=1e-6)
    np.testing.assert_allclose(got["state"]["theta"],
                               np.asarray(ref.state.theta), atol=1e-5)


def test_stacked_step_matches_per_map_steps(sharded, port_ref):
    """The multitrack sharded step against each map's own unsharded
    sector step: ranges 1e-5, state 1e-6, collisions equal."""
    _, res = sharded
    got = res["step_stack"]
    lo = 0
    for ref in port_ref["step_stack"]:
        sl = slice(lo, lo + ref.ranges.shape[0])
        lo = sl.stop
        np.testing.assert_allclose(got["ranges"][sl], ref.ranges.numpy(),
                                   atol=1e-5)
        np.testing.assert_array_equal(got["collision"][sl],
                                      ref.collision.numpy())
        np.testing.assert_allclose(got["state"]["x"][sl],
                                   ref.state.x.numpy(), atol=1e-6)
    assert lo == 16


def test_stacked_step_equals_multi_scan(sharded, port_ref, case):
    """The stacked step's ranges are scan_poses_sectors_multi's at the
    stepped lidar poses (atol 1e-5; bit-exact with an unsplit beam axis)."""
    shape, res = sharded
    s = res["step_stack"]["state"]
    d = P.CarParams().scan_distance_to_base_link
    t = lambda a: torch.tensor(np.asarray(a))
    x, y, th = t(s["x"]), t(s["y"]), t(s["theta"])
    poses = torch.stack([x + d * torch.cos(th), y + d * torch.sin(th), th],
                        -1)
    ref = scan_poses_sectors_multi(port_ref["stack"], t(case["map_ids"]),
                                   poses, num_beams=NB, fov=case["fov"],
                                   max_range=case["max_range"]).numpy()
    np.testing.assert_allclose(res["step_stack"]["ranges"], ref, atol=1e-5)
    if shape[1] == 1:
        np.testing.assert_array_equal(res["step_stack"]["ranges"], ref)


def test_stacked_step_matches_jax_stacked_step(sharded, jax_ref):
    """Against JAX's multitrack sharded step: collisions equal, x within
    1e-6, at least 99.5% of the beams within 1e-4 m (fault 3.1)."""
    _, res = sharded
    got, ref = res["step_stack"], jax_ref["step_stack"]
    d = np.abs(got["ranges"] - np.asarray(ref.ranges))
    assert np.mean(d <= 1e-4) >= 0.995
    np.testing.assert_array_equal(got["collision"],
                                  np.asarray(ref.collision))
    np.testing.assert_allclose(got["state"]["x"], np.asarray(ref.state.x),
                               atol=1e-6)


@pytest.mark.parametrize("n, agents_axis, beams_axis, want", [
    (8, None, 1, (8, 1)), (8, None, 2, (4, 2)), (8, 2, 4, (2, 4)),
    (4, None, 4, (1, 4))])
def test_mesh_shape(n, agents_axis, beams_axis, want):
    assert pmesh.mesh_shape(n, agents_axis, beams_axis) == want


def test_mesh_shape_rejects_bad_factors():
    with pytest.raises(ValueError, match="divisible"):
        pmesh.mesh_shape(8, None, 3)
    with pytest.raises(ValueError, match="!= 8"):
        pmesh.mesh_shape(8, 3, 2)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialised process group"):
        pmesh.make_mesh()


def test_slabs_and_wedges_of_a_mesh():
    """shard_agents / shard_state cut the agents axis by the rank's
    agents index; the wedge offsets are a slice of the full fan, padded by
    repeating the last offset; no process group needed."""
    m = pmesh.Mesh(agents=2, beams=2, agents_index=1, beams_index=1,
                   beams_ranks=(2, 3))
    assert m.shape == {"agents": 2, "beams": 2} and m.index == 3
    t = torch.arange(8.0)
    assert pmesh.shard_agents(m, t).tolist() == [4.0, 5.0, 6.0, 7.0]
    s = pmesh.shard_state(m, P.state_from_pose(t, t + 1, t + 2))
    assert s.batch_shape == (4,) and s.y.tolist() == [5.0, 6.0, 7.0, 8.0]
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.shard_agents(m, torch.arange(7.0))
    full = P.ops.beam_angles(128, 4.0)
    offs = pmesh._wedge_offsets(m, 128, 4.0, 14, "cpu")
    assert offs.shape == (70,)
    assert torch.equal(offs[:64], full[64:])
    assert torch.equal(offs[64:], full[-1:].expand(6))
    with pytest.raises(ValueError, match="not divisible"):
        pmesh._wedge(pmesh.Mesh(1, 3, 0, 0, (0, 1, 2)), 128)
    g0 = pmesh.rank_generator(m, 7, "cpu").initial_seed()
    g1 = pmesh.rank_generator(
        pmesh.Mesh(2, 2, 0, 1, (0, 1)), 7, "cpu").initial_seed()
    assert g0 != g1


def test_collectives_are_identities_on_one_rank():
    """A group of one needs no process group: the helpers return their
    input, and the gradient passes unchanged."""
    m = pmesh.Mesh(1, 1, 0, 0, (0,))
    t = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
    assert pmesh.gather_ranges(m, t) is t
    assert pmesh.ring_shift(t, m) is t
    assert pmesh.sum_grad_over_beams(m, t)[0] is t
    assert pmesh.all_reduce(t, None, None, 1) is t


def test_sharded_step_on_one_rank_with_noise(case):
    """A 1 x 1 mesh needs no process group. The noiseless sharded step
    equals make_step_fn's bit for bit; with noise the rank's generator
    (rank_generator) drives it: reproducible from the seed, and equal to
    make_step_fn's with a generator of the same seed."""
    m = pmesh.Mesh(1, 1, 0, 0, (0,))
    bundle = dr.case_bundles(case, "cpu")[0][0]
    q = torch.tensor(case["poses"])
    s0 = P.state_from_pose(q[:, 0], q[:, 1], q[:, 2])
    act = (torch.full((16,), 3.0), torch.full((16,), 0.05))
    ref = P.make_step_fn(bundle, with_noise=False)(s0, act)
    clean = pmesh.make_sharded_step(m, bundle, with_noise=False)(s0, act)
    assert torch.equal(clean.ranges, ref.ranges)
    assert torch.equal(clean.state.x, ref.state.x)
    noisy_step = pmesh.make_sharded_step(m, bundle, with_noise=True)
    a = noisy_step(s0, act, pmesh.rank_generator(m, 5, "cpu"))
    b = noisy_step(s0, act, pmesh.rank_generator(m, 5, "cpu"))
    c = P.make_step_fn(bundle, with_noise=True)(
        s0, act, torch.Generator().manual_seed(5))
    assert torch.equal(a.ranges, b.ranges) and torch.equal(a.ranges, c.ranges)
    d = (a.ranges - clean.ranges).std()
    assert 0.005 < float(d) < 0.02          # scan_std_dev = 0.01
    # without a generator the noise is off, as in make_step_fn
    assert torch.equal(noisy_step(s0, act).ranges, clean.ranges)


def test_make_sharded_scan_rejects_other_maps(case):
    m = pmesh.Mesh(1, 1, 0, 0, (0,))
    with pytest.raises(TypeError, match="SegmentMap or a SectorSegmentMap"):
        pmesh.make_sharded_scan(m, torch.zeros(4, 8), NB, 4.7)
    bundle = dr.case_bundles(case, "cpu")[1]
    with pytest.raises(ValueError, match="needs a segment backend"):
        pmesh.make_sharded_step(m, bundle._replace(segmap=None))


def test_dryrun_reports_a_failed_rank(case):
    """A rank that raises fails the call with its traceback (and the
    others are not waited for until their collective times out)."""
    bad = dict(case, num_beams=NB + 1)       # 129 beams over 2 wedges
    with pytest.raises(RuntimeError, match="not divisible by beams"):
        dr.dryrun(2, beams_axis=2, device="cpu", case=bad, timeout_s=60)
