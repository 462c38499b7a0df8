"""The port's closed-loop step on the dense backends ("segments", the
default, and "segments_pallas") against the JAX package.

Tolerances as in tests/test_torch_simulator.py: with noise off, poses
within atol=1e-5 m (float32 dynamics fed back through the steps); ranges
within 1e-4 m on at least 99.5% of the beams (the port's beam fan differs
from XLA's by an ulp on some beams, ROADMAP.md fault 3.1); collision flags
equal. The port's two dense backends run the same sweeps and must agree
bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from pyracecarsimulator_tpu import simulator as jsim
from pyracecarsimulator_tpu import state as jstate
from pyracecarsimulator_tpu.config import SimParams as JSimP
from pyracecarsimulator_tpu.maps import loader as jloader

import pyracecarsimulator_tpu_torch as P
from pyracecarsimulator_tpu_torch import simulator as psim
from pyracecarsimulator_tpu_torch.maps import loader as ploader
from pyracecarsimulator_tpu_torch.maps.loader import TrackMap
from pyracecarsimulator_tpu_torch.maps.segments import SegmentMap

SIM_KW = dict(ttc_threshold=0.3)       # generous: some cars latch


def _port_track(track):
    return TrackMap.from_numpy(
        np.asarray(track.occupancy), np.asarray(track.edf),
        resolution=track.resolution, origin_x=track.origin_x,
        origin_y=track.origin_y, height=track.height, width=track.width,
        name=track.name)


def _initial(track, n, seed):
    poses = jloader.sample_free_poses(track, n, seed, margin=0.2)
    d = {k: np.zeros(n, np.float32) for k in jstate.CarState.__annotations__}
    d.update(x=poses[:, 0], y=poses[:, 1], theta=poses[:, 2],
             velocity=np.linspace(0.5, 6.0, n).astype(np.float32),
             st_dyn=np.zeros(n, bool), collision=np.zeros(n, bool))
    return (jstate.CarState(**{k: jnp.asarray(v) for k, v in d.items()}),
            P.state_from_numpy(d, device="cpu"))


def _steps_match(jb, pb, js, ps, n_steps):
    jstep = jsim.make_step_fn(jb, with_noise=False)
    pstep = psim.make_step_fn(pb, with_noise=False)
    n = ps.batch_shape[0]
    v = np.full(n, 3.0, np.float32)
    s = np.linspace(-0.3, 0.3, n).astype(np.float32)
    for _ in range(n_steps):
        jo = jstep(js, (jnp.asarray(v), jnp.asarray(s)))
        po = pstep(ps, (torch.from_numpy(v), torch.from_numpy(s)))
        np.testing.assert_allclose(po.state.pose.numpy(),
                                   np.asarray(jo.state.pose), atol=1e-5)
        r, r_ref = po.ranges.numpy(), np.asarray(jo.ranges)
        assert r.shape == r_ref.shape
        assert np.mean(np.abs(r - r_ref) <= 1e-4) >= 0.995
        np.testing.assert_array_equal(po.collision.numpy(),
                                      np.asarray(jo.collision))
        js, ps = jo.state, po.state
    return ps


@pytest.mark.parametrize("backend", ["segments", "segments_pallas"])
def test_noiseless_steps_match_jax(small_track, backend):
    jb = jsim.build_sim(small_track, sim=JSimP(**SIM_KW), backend=backend)
    pb = psim.build_sim(_port_track(small_track),
                        sim=P.SimParams(**SIM_KW), backend=backend, device="cpu")
    assert pb.backend == jb.backend == backend
    assert isinstance(pb.segmap, SegmentMap)
    np.testing.assert_array_equal(pb.segmap.params.numpy(),
                                  np.asarray(jb.segmap.params))
    js, ps = _initial(small_track, 12, 5)
    final = _steps_match(jb, pb, js, ps, 5)
    assert 0 < int(final.collision.sum()) < 12


@pytest.mark.parametrize("name", ["levine", "berlin"])
def test_bundled_maps_match_jax(name):
    """The default backend on the bundled maps, 8 agents, 1080 beams:
    levine runs the dense sweep, berlin the tile-routed one."""
    jt = jloader.load_builtin(name)
    jb = jsim.build_sim(jt)
    pb = psim.build_sim(ploader.load_builtin(name, device="cpu"),
                        device="cpu")
    assert jb.backend == pb.backend == "segments"
    assert (pb.segmap.tiles is not None) == (name == "berlin")
    js, ps = _initial(jt, 8, 3)
    _steps_match(jb, pb, js, ps, 3)


def test_segments_and_segments_pallas_are_identical(small_track):
    track = _port_track(small_track)
    _, ps = _initial(small_track, 12, 6)
    act = (torch.full((12,), 2.0), torch.linspace(-0.2, 0.2, 12))
    outs = []
    for backend in ("segments", "segments_pallas"):
        b = psim.build_sim(track, backend=backend, device="cpu")
        o = psim.make_step_fn(b, with_noise=False)(ps, act)
        outs.append((o.ranges, o.state.pose, o.collision))
        assert torch.equal(psim.make_scan_fn(b)(ps.pose), psim.make_scan_fn(
            psim.build_sim(track, backend="segments", device="cpu"))(ps.pose))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_default_backend_and_tile_sizes(small_track):
    """build_sim and the facade default to "segments" with 4.0 m tiles;
    the sector backend keeps 2.0 m tiles."""
    track = _port_track(small_track)
    b = psim.build_sim(track, device="cpu")
    assert b.backend == "segments" and b.segmap.tile_size == 4.0
    assert psim.build_sim(track, backend="auto",
                          device="cpu").segmap.tile_size == 2.0
    assert P.RacecarSimulator(track, device="cpu").backend == "segments"
    with pytest.raises(ValueError, match="map type"):
        psim.make_scan_fn(b, backend="sectors")
