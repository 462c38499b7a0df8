"""PyTorch port of the closed-loop step, rollout and facade against the JAX
package, on the shared ``small_track`` map.

Tolerances: with noise off, poses within atol=1e-5 (the dynamics agree to
float32 rounding and feed back through five steps); ranges as in the
free-running scan of tests/test_torch_sectors.py (>= 99.5% of beams within
1e-4 m; the port's beam fan differs from XLA's by an ulp on some beams,
ROADMAP.md fault 3.1); collision flags equal. Noise cannot match
``jax.random`` bit for bit, so it is checked by its statistics.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from pyracecarsimulator_tpu import simulator as jsim
from pyracecarsimulator_tpu import state as jstate
from pyracecarsimulator_tpu.config import SimParams as JSimP
from pyracecarsimulator_tpu.maps.loader import sample_free_poses
from pyracecarsimulator_tpu.parallel import rollout as jax_rollout
from pyracecarsimulator_tpu.parallel import (make_gap_follower_policy as
                                            jax_gap_follower)

import pyracecarsimulator_tpu_torch as P
from pyracecarsimulator_tpu_torch import simulator as psim
from pyracecarsimulator_tpu_torch.maps.loader import TrackMap
from pyracecarsimulator_tpu_torch.ops.noise import add_scan_noise
from pyracecarsimulator_tpu_torch.parallel import (
    make_constant_policy, make_gap_follower_policy, make_rollout_fn, rollout)

N_AGENTS = 12
STEPS = 5
SIM_KW = dict(ttc_threshold=0.3)       # generous: some cars latch


def _port_track(track):
    return TrackMap.from_numpy(
        np.asarray(track.occupancy), np.asarray(track.edf),
        resolution=track.resolution, origin_x=track.origin_x,
        origin_y=track.origin_y, height=track.height, width=track.width,
        name=track.name)


@pytest.fixture(scope="module")
def bundles(small_track):
    jb = jsim.build_sim(small_track, sim=JSimP(**SIM_KW), backend="sectors")
    pb = psim.build_sim(_port_track(small_track), sim=P.SimParams(**SIM_KW),
                        backend="auto", device="cpu")
    return jb, pb


def _initial(small_track):
    poses = sample_free_poses(small_track, N_AGENTS, 5, margin=0.2)
    d = {k: np.zeros(N_AGENTS, np.float32)
         for k in jstate.CarState.__annotations__}
    d.update(x=poses[:, 0], y=poses[:, 1], theta=poses[:, 2],
             velocity=np.linspace(0.5, 6.0, N_AGENTS).astype(np.float32),
             st_dyn=np.zeros(N_AGENTS, bool),
             collision=np.zeros(N_AGENTS, bool))
    return (jstate.CarState(**{k: jnp.asarray(v) for k, v in d.items()}),
            P.state_from_numpy(d, device="cpu"))


def _close_ranges(got, ref):
    assert got.shape == ref.shape
    assert np.mean(np.abs(got - ref) <= 1e-4) >= 0.995


def test_bundle_matches_jax(bundles):
    jb, pb = bundles
    assert pb.backend == jb.backend == "sectors"
    np.testing.assert_array_equal(pb.segmap.table.numpy(),
                                  np.asarray(jb.segmap.table))
    np.testing.assert_array_equal(pb.segmap.meta.numpy(),
                                  np.asarray(jb.segmap.meta))


def test_noiseless_steps_match_jax(bundles, small_track):
    jb, pb = bundles
    jstep = jsim.make_step_fn(jb, with_noise=False)
    pstep = psim.make_step_fn(pb, with_noise=False)
    js, ps = _initial(small_track)
    v = np.full(N_AGENTS, 3.0, np.float32)
    s = np.linspace(-0.3, 0.3, N_AGENTS).astype(np.float32)
    latched = 0
    for _ in range(STEPS):
        jo = jstep(js, (jnp.asarray(v), jnp.asarray(s)))
        po = pstep(ps, (torch.from_numpy(v), torch.from_numpy(s)))
        np.testing.assert_allclose(po.state.pose.numpy(),
                                   np.asarray(jo.state.pose), atol=1e-5)
        _close_ranges(po.ranges.numpy(), np.asarray(jo.ranges))
        np.testing.assert_array_equal(po.collision.numpy(),
                                      np.asarray(jo.collision))
        latched = int(po.collision.sum())
        js, ps = jo.state, po.state
    assert 0 < latched < N_AGENTS


def test_rollout_matches_jax(bundles, small_track):
    """Gap-follower rollout: ranges -> control -> dynamics in closed loop."""
    jb, pb = bundles
    nb, fov = jb.scan.num_beams, jb.scan.fov
    js, ps = _initial(small_track)
    jfin, jtraj = jax_rollout(jsim.make_step_fn(jb, with_noise=False), js,
                              jax_gap_follower(nb, fov), STEPS, nb)
    run = make_rollout_fn(psim.make_step_fn(pb, with_noise=False),
                          make_gap_follower_policy(nb, fov), STEPS, nb,
                          keep_scans=True)
    pfin, ptraj = run(ps)
    assert ptraj["pose"].shape == (STEPS, N_AGENTS, 3)
    assert ptraj["ranges"].shape == (STEPS, N_AGENTS, nb)
    np.testing.assert_allclose(ptraj["pose"].numpy(),
                               np.asarray(jtraj["pose"]), atol=1e-5)
    np.testing.assert_array_equal(ptraj["collision"].numpy(),
                                  np.asarray(jtraj["collision"]))
    np.testing.assert_allclose(pfin.pose.numpy(), np.asarray(jfin.pose),
                               atol=1e-5)


def test_constant_policy_rollout(bundles, small_track):
    _, pb = bundles
    _, ps = _initial(small_track)
    fin, traj = rollout(psim.make_step_fn(pb, with_noise=False), ps,
                        make_constant_policy(1.0, 0.0), 3, pb.scan.num_beams)
    assert traj["pose"].shape == (3, N_AGENTS, 3)
    assert "ranges" not in traj and torch.isfinite(fin.pose).all()


def test_noise_statistics():
    """Mean ~ 0 and std ~ scan_std_dev, as tests/test_scan_modes.py checks
    the JAX noise; std 0 or no generator is the identity; max_range
    re-clamps."""
    g = torch.Generator().manual_seed(0)
    base = torch.full((200, 1080), 5.0)
    resid = (add_scan_noise(base, g, 0.01) - base).numpy()
    assert abs(resid.mean()) < 1e-4
    assert abs(resid.std() - 0.01) < 5e-4
    assert add_scan_noise(base, g, 0.0) is base
    assert add_scan_noise(base, None, 0.01) is base
    top = add_scan_noise(torch.full((1000,), 10.0), g, 0.5, max_range=10.0)
    assert float(top.max()) <= 10.0 and float(top.min()) < 10.0


def test_step_with_noise(bundles, small_track):
    _, pb = bundles
    _, ps = _initial(small_track)
    step = psim.make_step_fn(pb, with_noise=True)
    act = (torch.full((N_AGENTS,), 2.0), torch.zeros(N_AGENTS))
    clean = psim.make_step_fn(pb, with_noise=False)(ps, act).ranges
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    r1 = step(ps, act, g1).ranges
    assert torch.equal(r1, step(ps, act, g2).ranges)   # seeded
    d = (r1 - clean).numpy()
    assert abs(d.std() - pb.scan.scan_std_dev) < 1e-3
    assert torch.equal(step(ps, act, None).ranges, clean)


def test_map_swap_through_map_cell(bundles, small_track):
    """step.map_cell["map"] is read at every call: swapping in a map with
    an extra wall changes the ranges without rebuilding the step."""
    _, pb = bundles
    _, ps = _initial(small_track)
    step = psim.make_step_fn(pb, with_noise=False)
    act = (torch.zeros(N_AGENTS), torch.zeros(N_AGENTS))
    before = step(ps, act).ranges
    occ = np.asarray(small_track.occupancy).copy()
    occ[150:160, 150:160] = 1
    other = psim.build_sim(TrackMap.from_numpy(
        occ, np.asarray(small_track.edf), resolution=small_track.resolution,
        origin_x=small_track.origin_x, origin_y=small_track.origin_y,
        height=small_track.height, width=small_track.width),
        backend="sectors", device="cpu")
    step.map_cell["map"] = other.segmap
    after = step(ps, act).ranges
    assert not torch.equal(before, after)
    step.map_cell["map"] = pb.segmap
    assert torch.equal(step(ps, act).ranges, before)


def test_unported_paths_raise(bundles, small_track):
    """Every backend of the JAX package is ported; what still raises are
    the JAX facade's ValueError guards."""
    _, pb = bundles
    with pytest.raises(ValueError, match="unknown backend"):
        psim.build_sim(_port_track(small_track), backend="segment", device="cpu")
    # the backend must match the bundle's map type, as in the JAX facade
    for backend in ("segments", "segments_pallas", "segments_simplified"):
        with pytest.raises(ValueError, match="map type"):
            psim.make_scan_fn(pb, backend=backend)
    # map_grad is the sector backend's path only
    dense = psim.build_sim(_port_track(small_track), backend="segments",
                           device="cpu")
    edf = psim.build_sim(_port_track(small_track), backend="edf", device="cpu")
    for bundle, backend in ((dense, None), (edf, None), (pb, "auto"),
                            (pb, "edf_implicit")):
        with pytest.raises(ValueError, match="map_grad"):
            psim.make_scan_fn(bundle, backend=backend, map_grad=True)
    with pytest.raises(ValueError, match="sector backend"):
        psim.make_scan_fn(dense, backend="sectors", map_grad=True)
    # the EDF bundle carries no compiled geometry
    with pytest.raises(ValueError, match="segment backend"):
        psim.make_scan_fn(edf, backend="segments")
    simple = psim.build_sim(_port_track(small_track),
                            backend="segments_simplified", device="cpu")
    with pytest.raises(ValueError, match="segments_pallas"):
        psim.make_scan_fn(simple, backend="segments_pallas")
    with pytest.raises(ValueError, match="dynamics"):
        psim.make_step_fn(pb._replace(sim=P.SimParams(dynamics="mb")))


def test_facade_drives_scalar_car(small_track):
    """RacecarSimulator with batch shape (): the reference call sequence."""
    sim = P.RacecarSimulator(_port_track(small_track), seed=1,
                             scan_params=P.ScanParams(num_beams=270),
                             device="cpu")
    assert sim.backend == "segments"            # the JAX facade's default
    sim.set_pose(-4.0, -4.0, 0.0)
    sim.drive(2.0, 0.1)
    for _ in range(3):
        out = sim.update_pose()
    assert out.ranges.shape == (270,) and torch.isfinite(out.ranges).all()
    assert out.state.x.shape == () and float(sim.get_state().x) > -4.0
    assert sim.check_collision().shape == ()
    assert sim.run_scan().shape == (270,)
    st = sim.getState()
    sim.stop()
    assert float(sim.state.velocity) == 0.0
    sim.setState(st)
    assert float(sim.state.velocity) > 0.0
    sim.setPose(-4.0, -4.0)
    assert sim.checkCollision().item() is False
    # the obstacle cycle: a box 1 m ahead of the scanner shortens the beam
    # straight ahead, and clearing it restores the scan bit for bit (the
    # noise generator is reseeded before each scan)
    sim.set_pose(-4.0, -4.0, 0.0)
    scan = lambda: (sim.generator.manual_seed(5), sim.run_scan())[1]
    before = scan()
    sim.addObstacle(-4.0 + 0.275 + 1.0, -4.0, 0.4)
    ahead = scan()[135]
    assert 0.7 < float(ahead) < 0.85                # 1 m - half the box
    sim.clearObstacles()
    assert torch.equal(scan(), before)
