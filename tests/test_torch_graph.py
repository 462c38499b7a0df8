"""The port's compiled step: device-resident scan constants and the CUDA
graphs of the step, the rollout and the BPTT train step.

A CUDA graph cannot be captured without a card, so the graphs themselves
are held against the eager paths in ``chip_smoke.py`` and in
``tests/test_torch_kernels.py`` (marked ``cuda``; it skips without a
card). Here, on the CPU:

- the cached constants of ``ops/common.py`` equal freshly computed values
  bit for bit, are the same objects at the second call and are not
  written by scans, steps or rollouts; functions that read them equal the
  JAX package's bit for bit where they did before (``quantize_angles``,
  the sector list ids given the JAX fan); the fan itself keeps its
  tolerance of two float32 ulps of fov / 2 (4.8e-7 rad) against
  ``jnp.linspace`` (ROADMAP.md, tolerated fault 1);
- a second scan on each exact backend builds no tensor from host data
  (``torch.tensor``, ``torch.as_tensor`` and ``torch.from_numpy`` are
  counted under a monkeypatch);
- ``graph=None`` on the CPU is the eager loop; ``graph=True`` on the CPU
  raises and names the card; every backend's step and train step can be
  captured, the EDF ones included (their marches and the marches'
  gradient run in ``csrc/edf_march.cu`` on the card);
- the bookkeeping of ``utils.graph.GraphedFunction`` (copy-in, cloned
  outputs, a new capture after a swapped map, a new shape or another
  generator, restored generator states, the launch counters' replay) and
  the graphed rollout's and train step's own (the carried state, the
  block buffers, the optimizer's snapshot) run with ``_ReRun``, a
  stand-in backend that re-runs the function where the card would replay
  the graph. With it the graphed step and rollout equal the eager ones
  bit for bit on every backend, the EDF ones included; the graphed rollout
  equals the JAX package's within 1e-5 m in the poses (on "edf" its kept
  scans within ROADMAP.md's tolerated fault 6: >= 99.5% of the beams
  within 1e-4 m, all within 3 cells); the graphed train step equals the
  eager one bit for bit, on the three EDF backends too; a graphed "edf"
  facade reads each edited map.
"""

import contextlib
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from pyracecarsimulator_tpu import simulator as jsim
from pyracecarsimulator_tpu import state as jstate
from pyracecarsimulator_tpu.maps.loader import sample_free_poses
from pyracecarsimulator_tpu.maps.sectors import (build_sector_map as
                                                 jax_build_sector_map)
from pyracecarsimulator_tpu.ops import raycast_sectors as jrs
from pyracecarsimulator_tpu.ops.common import (beam_angles as jax_beam_angles,
                                               fan_cos_sin as jax_fan,
                                               quantize_angles as jax_quantize)
from pyracecarsimulator_tpu.parallel import (make_gap_follower_policy as
                                             jax_gap_follower,
                                             rollout as jax_rollout)

import pyracecarsimulator_tpu_torch as P
from pyracecarsimulator_tpu_torch import simulator as psim
from pyracecarsimulator_tpu_torch.maps.loader import TrackMap
from pyracecarsimulator_tpu_torch.ops import common, sweeps
from pyracecarsimulator_tpu_torch.ops import raycast_sectors as prs
from pyracecarsimulator_tpu_torch.parallel import (
    make_bptt_train_fn, make_constant_policy, make_gap_follower_policy,
    make_rollout_fn, make_mesh)
from pyracecarsimulator_tpu_torch.state import FIELDS
from pyracecarsimulator_tpu_torch.utils import profiling
from pyracecarsimulator_tpu_torch.utils.graph import (CudaGraphBackend,
                                                      GraphedFunction)

prollout = importlib.import_module(
    "pyracecarsimulator_tpu_torch.parallel.rollout")

FOV = 4.712388980384690
N_AGENTS = 12
STEPS = 7
BEAMS = 64
EXACT = ("segments", "segments_pallas", "sectors")
EDF = ("edf", "edf_implicit", "edf_bilinear")


class _ReRun:
    """Stand-in for ``CudaGraphBackend`` on the CPU: the capture pass runs
    the function once for its static outputs; a replay re-runs it, under
    the grad mode of the capture, and writes the new results into those
    outputs. A replayed graph passes no kernel wrapper, so the launch
    counters are put back after the re-run."""

    def __init__(self):
        self.warmups = self.captured = self.replayed = 0
        self.calls = []         # what was asked of it, in order

    def check(self, device):
        pass

    def warm_up(self, run, device, n):
        self.calls.append(("warm_up", n))
        for _ in range(n):
            run()
            self.warmups += 1

    def capture(self, run, device, generators):
        self.calls.append(("capture",))
        self.captured += 1
        grad = torch.is_grad_enabled()
        outs = run()

        def replay():
            self.calls.append(("replay",))
            self.replayed += 1
            before = sweeps.launch_counts()
            with torch.set_grad_enabled(grad):
                new = run()
            with torch.no_grad():
                for s, n in zip(outs, new):
                    s.copy_(n)
            sweeps.add_launches({k: before[k] - n
                                 for k, n in sweeps.launch_counts().items()})
        return outs, replay


def _port_track(track):
    return TrackMap.from_numpy(
        np.asarray(track.occupancy), np.asarray(track.edf),
        resolution=track.resolution, origin_x=track.origin_x,
        origin_y=track.origin_y, height=track.height, width=track.width,
        name=track.name, device="cpu")


@pytest.fixture(scope="module")
def bundles(small_track):
    track = _port_track(small_track)
    scan = P.ScanParams(num_beams=BEAMS)
    return {b: psim.build_sim(track, scan=scan, backend=b, device="cpu",
                              sim=P.SimParams(ttc_threshold=0.3))
            for b in EXACT + ("edf", "edf_bilinear", "edf_implicit",
                              "segments_simplified")}


def _initial(small_track, n=N_AGENTS):
    poses = sample_free_poses(small_track, n, 5, margin=0.2)
    d = {k: np.zeros(n, np.float32) for k in FIELDS}
    d.update(x=poses[:, 0], y=poses[:, 1], theta=poses[:, 2],
             velocity=np.linspace(0.5, 6.0, n).astype(np.float32),
             st_dyn=np.zeros(n, bool), collision=np.zeros(n, bool))
    return d


def _same_state(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


# -- the cached constants ---------------------------------------------------

def _fresh_fan(num_beams, fov):
    """The beam offsets by the formula of ``jnp.linspace``, one float32
    rounding per operation, computed here."""
    start, stop = np.float32(-fov / 2.0), np.float32(fov / 2.0)
    if num_beams == 1:
        return np.asarray([start], np.float32)
    step = np.arange(num_beams - 1, dtype=np.float32) \
        / np.float32(num_beams - 1)
    return np.concatenate([start * (np.float32(1.0) - step) + stop * step,
                           np.asarray([stop], np.float32)])


def _fresh_padded(num_beams, fov, bb):
    offs = _fresh_fan(num_beams, fov)
    return np.concatenate([offs, np.repeat(offs[-1:], -num_beams % bb)])


CONSTANTS = {
    "beam_angles": (lambda: common.beam_angles(1080, FOV, "cpu"),
                    lambda: _fresh_fan(1080, FOV)),
    "beam_angles_1": (lambda: common.beam_angles(1, FOV, "cpu"),
                      lambda: _fresh_fan(1, FOV)),
    "padded_offsets": (lambda: common._padded_offsets(1080, FOV, 128, "cpu"),
                       lambda: _fresh_padded(1080, FOV, 128)),
    "padded_offsets_exact": (lambda: common._padded_offsets(256, 1.2, 128,
                                                            "cpu"),
                             lambda: _fresh_padded(256, 1.2, 128)),
    "block_mids": (lambda: common.block_mids(9, 128, 1080, "cpu"),
                   lambda: np.minimum(np.arange(9) * 128 + 64, 1079)),
    "f32": (lambda: common._f32(2.0 * np.pi, "cpu"),
            lambda: np.float32(2.0 * np.pi)),
    "f32_from_float32": (lambda: common._f32(np.float32(16) / np.float32(
        2.0 * np.pi), "cpu"),
        lambda: np.float32(16) / np.float32(2.0 * np.pi)),
}


@pytest.mark.parametrize("name", sorted(CONSTANTS))
def test_cached_constant_equals_fresh_value(name):
    """Bit for bit the value computed afresh, of its dtype, and the same
    tensor at every later call."""
    cached, fresh = CONSTANTS[name]
    got, ref = cached(), np.asarray(fresh())
    assert got.device.type == "cpu" and got.dtype == torch.from_numpy(
        ref.reshape(-1)).dtype
    np.testing.assert_array_equal(got.numpy(), ref)
    assert cached() is got


def test_cached_constants_are_per_arguments_and_device_checked():
    a = common.beam_angles(90, FOV, "cpu")
    assert common.beam_angles(90, FOV, torch.device("cpu")) is a
    assert common.beam_angles(91, FOV, "cpu") is not a
    assert common.beam_angles(90, 3.0, "cpu") is not a
    assert common._f32(2.0, "cpu") is not common._f32(3.0, "cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        common.beam_angles(90, FOV)         # no device: the card, or raise


def test_fan_keeps_its_tolerance_against_jax():
    """ROADMAP.md tolerated fault 1: XLA rounds ``jnp.linspace`` otherwise;
    the offsets agree within two float32 ulps of fov / 2 (4.8e-7 rad),
    endpoints exactly."""
    got = common.beam_angles(1080, FOV, "cpu").numpy()
    ref = np.asarray(jax_beam_angles(1080, FOV))
    assert np.abs(got - ref).max() <= 4.8e-7
    assert got[0] == ref[0] and got[-1] == ref[-1]


def test_quantize_angles_with_cached_divisor_equals_jax():
    """The divisor is a cached 0-dim device tensor; both calls equal the
    JAX package's buckets bit for bit on the same summed angles."""
    rng = np.random.RandomState(3)
    ang = (rng.uniform(-np.pi, np.pi, (32, 1))
           + _fresh_fan(1080, FOV)[None, :]).astype(np.float32)
    ref = np.asarray(jax_quantize(jnp.asarray(ang), 2000))
    for _ in range(2):
        got = common.quantize_angles(torch.from_numpy(ang), 2000)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_list_ids_with_cached_lookup_beams_equal_jax(small_track):
    """Tile and sector routing through the cached block midpoints and
    scalars: identical rows given the JAX fan, at both calls."""
    occ = np.asarray(small_track.occupancy)
    jmap = jax_build_sector_map(
        occ, small_track.resolution,
        (small_track.origin_x, small_track.origin_y), max_range=10.0,
        tile_size=2.0, ns=16)
    poses = sample_free_poses(small_track, 16, 2, margin=0.2)
    bb = 128
    ct, st = jax_fan(jnp.asarray(poses[:, 2]),
                     jrs._padded_offsets(1080, FOV, bb))
    ref = np.asarray(jrs._list_ids(
        jmap.tiles_shape, jmap.tile_size, jmap.tile_origin, jmap.ns,
        jnp.asarray(poses[:, 0]), jnp.asarray(poses[:, 1]), ct, st, bb))
    t = lambda a: torch.from_numpy(np.array(a))
    for _ in range(2):
        got = prs._list_ids(jmap.tiles_shape, jmap.tile_size,
                            jmap.tile_origin, jmap.ns, t(poses[:, 0]),
                            t(poses[:, 1]), t(ct), t(st), bb)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_tile_ids_equal_float32_arithmetic():
    """Subtract, a correctly rounded divide, truncate, clamp: NumPy's
    float32 operations, at both calls."""
    rng = np.random.RandomState(1)
    x = rng.uniform(-30, 30, 500).astype(np.float32)
    y = rng.uniform(-30, 30, 500).astype(np.float32)
    shape, ts, org = (7, 9), 4.0, (-17.3, -11.1)
    ci = np.clip(((x - np.float32(org[0])) / np.float32(ts)).astype(np.int32),
                 0, shape[1] - 1)
    ri = np.clip(((y - np.float32(org[1])) / np.float32(ts)).astype(np.int32),
                 0, shape[0] - 1)
    for _ in range(2):
        got = common.tile_ids(shape, ts, org, torch.from_numpy(x),
                              torch.from_numpy(y))
        np.testing.assert_array_equal(got.numpy(), ri * shape[1] + ci)


class _HostBuilds:
    """Counts the calls that build a tensor from host data."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("tensor", "as_tensor", "from_numpy"):
            monkeypatch.setattr(torch, name, self._counted(name))

    def _counted(self, name):
        real = getattr(torch, name)

        def counted(*a, **kw):
            self.calls.append(name)
            return real(*a, **kw)
        return counted


@pytest.mark.parametrize("backend", EXACT)
def test_second_scan_builds_no_tensor_from_host(bundles, small_track,
                                                backend, monkeypatch):
    """After the first scan and step on a device, a scan and a step on the
    exact backends make no call that builds a tensor from host data."""
    bundle = bundles[backend]
    state = P.state_from_numpy(_initial(small_track), device="cpu")
    scan = psim.make_scan_fn(bundle)
    step = psim.make_step_fn(bundle, with_noise=True)
    act = (torch.full((N_AGENTS,), 2.0), torch.zeros(N_AGENTS))
    gen = torch.Generator().manual_seed(0)
    first = scan(state.pose)
    step(state, act, gen)
    host = _HostBuilds(monkeypatch)
    second = scan(state.pose)
    out = step(state, act, gen)
    assert host.calls == []
    assert torch.equal(first, second) and out.ranges.shape == first.shape


def test_cached_tensors_are_not_written_by_the_paths_that_read_them(
        bundles, small_track):
    state = P.state_from_numpy(_initial(small_track), device="cpu")
    act = (torch.full((N_AGENTS,), 2.0), torch.zeros(N_AGENTS))
    for backend in EXACT:       # fill the caches
        psim.make_step_fn(bundles[backend], with_noise=False)(state, act)
    kept = {k: v.clone() for k, v in common._CONSTANTS.items()}
    assert len(kept) >= 4
    policy = make_gap_follower_policy(BEAMS, FOV)
    for backend in EXACT:
        step = psim.make_step_fn(bundles[backend], with_noise=False)
        psim.make_scan_fn(bundles[backend])(state.pose)
        make_rollout_fn(step, policy, 3, BEAMS)(state)
    for k, v in kept.items():
        assert torch.equal(common._CONSTANTS[k], v), k


def test_map_ids_host_array_is_copied_once():
    ids = np.arange(6, dtype=np.int32) % 2
    a = prs._map_ids_on(ids, torch.device("cpu"))
    assert prs._map_ids_on(ids.copy(), torch.device("cpu")) is a
    ids[0] = 1                  # other contents: another tensor
    b = prs._map_ids_on(ids, torch.device("cpu"))
    assert b is not a and b[0] == 1 and a[0] == 0
    assert len(prs._LAST_MAP_IDS) == 1          # one assignment is kept
    t = torch.arange(4)
    assert prs._map_ids_on(t, torch.device("cpu")) is t


def test_constant_policy_keeps_its_commands_on_the_device(monkeypatch):
    policy = make_constant_policy(2.5, np.linspace(-0.2, 0.2, 4))
    state = P.state_from_pose(torch.zeros(4), torch.zeros(4),
                              torch.zeros(4))
    v, s = policy(state, None, 0)
    host = _HostBuilds(monkeypatch)
    v2, s2 = policy(state, None, 1)
    assert host.calls == []
    assert torch.equal(v, v2) and torch.equal(s, s2)
    assert v.shape == s.shape == (4,) and float(v[0]) == 2.5
    np.testing.assert_allclose(s.numpy(), np.linspace(-0.2, 0.2, 4),
                               rtol=1e-6)


# -- graph= on the CPU and on backends that read the host ---------------------

def test_graph_none_on_cpu_runs_the_eager_loop(bundles, small_track):
    state = P.state_from_numpy(_initial(small_track), device="cpu")
    step = psim.make_step_fn(bundles["sectors"], with_noise=False)
    assert step.capturable and step.host_read is None
    policy = make_gap_follower_policy(BEAMS, FOV)
    default = make_rollout_fn(step, policy, STEPS, BEAMS, keep_scans=True)
    eager = make_rollout_fn(step, policy, STEPS, BEAMS, keep_scans=True,
                            graph=False)
    (fa, ta), (fb, tb) = default(state), eager(state)
    assert _same_state(fa, fb)
    assert all(torch.equal(ta[k], tb[k]) for k in ("pose", "collision",
                                                   "ranges"))
    train, init = make_bptt_train_fn(
        step, lambda p, s, r, t: (torch.full(s.batch_shape, 2.0),
                                  torch.tanh(r @ p["w"])),
        lambda out, t: out.ranges.mean(), 2, BEAMS)
    params = {"w": torch.zeros(BEAMS)}
    train(params, init(params), state)
    assert train.graphed.captures == 0          # graph=None: eager here


@pytest.mark.parametrize("what", ["step", "facade", "rollout", "train"])
def test_graph_true_on_cpu_raises_and_names_the_card(bundles, small_track,
                                                     what):
    bundle = bundles["sectors"]
    state = P.state_from_numpy(_initial(small_track), device="cpu")
    step = psim.make_step_fn(bundle, with_noise=False)
    with pytest.raises(RuntimeError, match="(?s)card.*graph=False"):
        if what == "step":
            psim.make_step_fn(bundle, graph=True)
        elif what == "facade":
            psim.RacecarSimulator(bundle.track, device="cpu", graph=True)
        elif what == "rollout":
            make_rollout_fn(step, make_gap_follower_policy(BEAMS, FOV), 2,
                            BEAMS, graph=True)(state)
        else:
            train, init = make_bptt_train_fn(
                step, lambda p, s, r, t: (torch.full(s.batch_shape, 2.0),
                                          torch.tanh(r @ p["w"])),
                lambda out, t: out.ranges.mean(), 2, BEAMS, graph=True)
            params = {"w": torch.zeros(BEAMS)}
            train(params, init(params), state)


@pytest.fixture()
def standin(monkeypatch):
    """``make_step_fn(graph=True)`` and the facade's ``graph=True`` on the
    CPU: the stand-in backend where the card's would capture."""
    graph_mod = importlib.import_module(
        "pyracecarsimulator_tpu_torch.utils.graph")
    monkeypatch.setattr(graph_mod, "CudaGraphBackend", _ReRun)
    monkeypatch.setattr(psim, "CudaGraphBackend", _ReRun)


def _edf_train_loss(out, t):
    # the nearest march's ranges carry no gradient: a steering target does
    return _train_loss(out, t) + torch.mean(
        (out.state.steer_angle - 0.1) ** 2)


@pytest.mark.parametrize("backend, module, plain", [
    ("edf", "raymarch_xla", "march_rays_plain"),
    ("edf_bilinear", "raymarch_xla", "march_rays_plain"),
    ("edf_implicit", "raymarch_diff", "_march_nearest_plain")])
def test_graph_true_on_an_edf_step_names_the_host_read(bundles, small_track,
                                                       backend, module,
                                                       plain, monkeypatch):
    """No host read is left to name: the EDF step is capturable, its march
    goes through ``module``'s march (``plain`` on the CPU, the kernel on
    the card), and ``graph=True`` on the CPU raises for the card, for the
    step and for the train step alike (the marches' gradient runs in the
    kernel too, "edf_bilinear"'s included)."""
    bundle = bundles[backend]
    mod = importlib.import_module(
        f"pyracecarsimulator_tpu_torch.ops.{module}")
    marched, march = [], getattr(mod, plain)
    monkeypatch.setattr(mod, plain,
                        lambda *a: marched.append(a[-2]) or march(*a))
    step = psim.make_step_fn(bundle, with_noise=False)
    assert step.capturable and step.host_read is None
    assert not hasattr(step, "grad_host_read")
    state = P.state_from_numpy(_initial(small_track), device="cpu")
    act = (torch.full((N_AGENTS,), 2.0), torch.zeros(N_AGENTS))
    assert step(state, act).ranges.shape == (N_AGENTS, BEAMS)
    assert len(marched) == 1
    if module == "raymarch_xla":
        assert marched == ["bilinear" if backend == "edf_bilinear"
                           else "nearest"]
    with pytest.raises(RuntimeError, match="(?s)card.*graph=False") as e:
        psim.make_step_fn(bundle, with_noise=False, graph=True)
    assert "alive.any()" not in str(e.value)
    train, init = make_bptt_train_fn(step, _train_policy, _edf_train_loss, 2,
                                     BEAMS, graph=True)
    params = {"w": torch.zeros(BEAMS), "b": torch.zeros(())}
    with pytest.raises(RuntimeError, match="(?s)card.*graph=False") as e:
        train(params, init(params), state)
    assert "autograd loop" not in str(e.value)
    assert train.graphed.captures == 0


def test_which_steps_can_be_captured(bundles):
    for backend in EXACT + ("segments_simplified",) + EDF:
        step = psim.make_step_fn(bundles[backend])
        assert step.capturable and step.host_read is None
    # "edf" with bilinear sampling too
    bilinear = bundles["edf"]._replace(
        scan=P.ScanParams(num_beams=BEAMS, interp="bilinear"))
    step = psim.make_step_fn(bilinear)
    assert step.capturable and step.host_read is None
    import socket
    import torch.distributed as dist
    from pyracecarsimulator_tpu_torch.parallel import (make_sharded_step,
                                                       multihost)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    multihost.initialize("gloo", f"tcp://localhost:{port}", world_size=1,
                         rank=0, timeout_s=60)
    try:
        sharded = make_sharded_step(make_mesh(), bundles["sectors"])
    finally:
        dist.destroy_process_group()
    assert not sharded.capturable and "torch.distributed" in sharded.host_read


@pytest.mark.parametrize("backend", EDF)
def test_graphed_edf_step_equals_eager(bundles, small_track, backend,
                                       standin):
    """``make_step_fn(graph=True)`` on an EDF backend, with the stand-in:
    3 replays with changing inputs, noise on from one seed, equal to the
    eager step bit for bit, one capture."""
    state = P.state_from_numpy(_initial(small_track), device="cpu")
    eager = psim.make_step_fn(bundles[backend], with_noise=True)
    graphed = psim.make_step_fn(bundles[backend], with_noise=True,
                                graph=True)
    assert graphed.eager.capturable and graphed.host_read is None
    act = (torch.full((N_AGENTS,), 2.0), torch.zeros(N_AGENTS))
    ge, gg = torch.Generator().manual_seed(3), torch.Generator()
    # the stand-in's capture pass draws; a real capture does not
    graphed.graphed.prepare(state, act, gg)
    gg.manual_seed(3)
    se = sg = state
    for i in range(3):
        a = (act[0] + 0.25 * i, act[1] + 0.02 * i)
        oe, og = eager(se, a, ge), graphed(sg, a, gg)
        assert torch.equal(oe.ranges, og.ranges)
        assert torch.equal(oe.collision, og.collision)
        assert _same_state(oe.state, og.state)
        se, sg = oe.state, og.state
    assert graphed.graphed.captures == 1 and graphed.graphed.replays == 3


def test_graphed_edf_facade_reads_each_edited_map(small_track, standin):
    """``RacecarSimulator(backend="edf", graph=True)`` across
    ``add_obstacle`` and ``clear_obstacles``: every step equals the eager
    facade's bit for bit, the box shortens the beam ahead and clearing
    restores it (a stale EDF would show), one capture per map."""
    track = _port_track(small_track)
    sims = [psim.RacecarSimulator(track, backend="edf", device="cpu",
                                  with_noise=False, graph=g)
            for g in (True, False)]
    x, y = -2.3, -1.0          # west of the block, east of the bar, facing +y
    for sim in sims:
        sim.set_pose(x, y, np.pi / 2)
        sim.drive(0.5, 0.0)
    ahead = []
    for edit in (None, "add", "clear"):
        for sim in sims:
            if edit == "add":
                sim.add_obstacle(x, y + 0.275 + 1.0, size=0.4)
            elif edit == "clear":
                sim.clear_obstacles()
        a, b = (sim.update_pose() for sim in sims)
        assert torch.equal(a.ranges, b.ranges)
        assert _same_state(a.state, b.state)
        ahead.append(float(a.ranges[sims[0].bundle.scan.num_beams // 2]))
    assert ahead[1] < 1.0 < ahead[0] and ahead[2] > 1.0
    assert sims[0]._step.graphed.captures == 3


def test_train_refuses_an_optimizer_that_counts_on_the_host(bundles,
                                                           small_track):
    state = P.state_from_numpy(_initial(small_track), device="cpu")
    step = psim.make_step_fn(bundles["sectors"], with_noise=False)
    train, init = make_bptt_train_fn(
        step, lambda p, s, r, t: (torch.full(s.batch_shape, 2.0),
                                  torch.tanh(r @ p["w"])),
        lambda out, t: out.ranges.mean(), 2, BEAMS,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-3), graph=True)
    params = {"w": torch.zeros(BEAMS)}
    with pytest.raises(RuntimeError, match="(?s)Adam.*capturable=True.*"
                                           "graph=False"):
        train(params, init(params), state)


@pytest.mark.parametrize("name, make, reason", [
    ("sgd", lambda ps: torch.optim.SGD(ps, lr=1e-2), None),
    ("momentum", lambda ps: torch.optim.SGD(ps, lr=1e-2, momentum=0.9), None),
    ("nesterov", lambda ps: torch.optim.SGD(ps, lr=1e-2, momentum=0.9,
                                            nesterov=True), None),
    ("dampening", lambda ps: torch.optim.SGD(ps, lr=1e-2, momentum=0.9,
                                             dampening=0.5),
     "(?s)SGD.*dampening.*graph=False"),
    ("adam", lambda ps: torch.optim.Adam(ps, lr=1e-3),
     "(?s)Adam.*capturable=True.*graph=False"),
    ("adam_capturable", lambda ps: torch.optim.Adam(ps, lr=1e-3,
                                                    capturable=True), None),
])
def test_which_optimizers_one_captured_update_serves(bundles, small_track,
                                                     name, make, reason):
    """``graph=None`` trains eagerly where one captured update would not
    equal the optimizer's eager updates (a step count on the host, a
    momentum buffer with dampening: its first update differs from the
    later ones); ``graph=True`` raises there and says why."""
    ptrain = importlib.import_module(
        "pyracecarsimulator_tpu_torch.parallel.train")
    why = ptrain._why_not_graphed(make([torch.zeros(2, requires_grad=True)]))
    assert (why is None) == (reason is None)
    if name == "adam_capturable":
        return              # torch runs a capturable Adam on a card only
    state = P.state_from_numpy(_initial(small_track), device="cpu")
    step = psim.make_step_fn(bundles["sectors"], with_noise=False)
    for graph in (None, True):
        train, init = make_bptt_train_fn(
            step, lambda p, s, r, t: (torch.full(s.batch_shape, 2.0),
                                      torch.tanh(r @ p["w"])),
            lambda out, t: out.ranges.mean(), 2, BEAMS, optimizer=make,
            graph=graph)
        train.graphed.backend = _ReRun()
        params = {"w": torch.zeros(BEAMS)}
        if graph and reason:
            with pytest.raises(RuntimeError, match=reason):
                train(params, init(params), state)
            continue
        train(params, init(params), state)
        assert train.graphed.captures == (1 if graph else 0)


# -- GraphedFunction's bookkeeping, with the stand-in backend -----------------

def test_graphed_function_copies_in_and_clones_out():
    seen = []

    def fn(x, pair, scale):
        seen.append(x)
        return {"y": x * scale + pair[0], "z": (pair[1] + 1, None)}

    backend = _ReRun()
    g = GraphedFunction(fn, backend=backend)
    x, a, b = torch.arange(4.0), torch.ones(4), torch.zeros(4)
    out1 = g(x, (a, b), 3.0)
    assert (backend.warmups, backend.captured, backend.replayed) == (2, 1, 1)
    assert torch.equal(out1["y"], x * 3 + 1) and out1["z"][1] is None
    # the function saw the static buffers, never the caller's tensors
    assert all(s is not x for s in seen) and len({id(s) for s in seen}) == 1
    out2 = g(x + 10, (a, b), 3.0)
    assert g.captures == 1 and g.replays == 2
    assert torch.equal(out2["y"], (x + 10) * 3 + 1)
    # a result is the caller's to keep: the next replay does not touch it
    assert torch.equal(out1["y"], x * 3 + 1)
    assert out1["y"].data_ptr() != out2["y"].data_ptr()
    assert torch.equal(x, torch.arange(4.0))


def test_graphed_function_captures_again_when_it_has_to():
    cell = {"map": torch.tensor([1.0])}
    g = GraphedFunction(lambda x, gen=None: x + cell["map"],
                        watch=lambda: (cell["map"],), backend=_ReRun())
    x = torch.zeros(3)
    assert torch.equal(g(x), x + 1) and g.captures == 1
    g(x + 5)
    assert g.captures == 1                      # new values: a replay
    cell["map"] = torch.tensor([2.0])           # a swapped map: never stale
    assert torch.equal(g(x), x + 2) and g.captures == 2
    cell["map"] = cell["map"].clone()           # identity, not value
    g(x)
    assert g.captures == 3
    g(torch.zeros(5))                           # a new shape
    assert g.captures == 4
    g(torch.zeros(5, dtype=torch.float64))      # a new dtype
    assert g.captures == 5
    gen = torch.Generator().manual_seed(0)
    g(torch.zeros(5), gen)                      # another structure
    g(torch.zeros(5), gen)
    assert g.captures == 6
    g(torch.zeros(5), torch.Generator().manual_seed(0))   # another generator
    assert g.captures == 7 and g.replays == 9
    g.release()
    g(torch.zeros(5), gen)
    assert g.captures == 8


def test_graphed_function_draws_what_the_eager_calls_draw():
    """The warm-up calls' draws are put back: from one seed the graphed
    calls give the eager calls' numbers, and no replay repeats a draw."""
    def noisy(x, gen):
        return x + torch.randn(x.shape, generator=gen)

    x = torch.zeros(6)
    g = GraphedFunction(noisy, backend=_ReRun())
    ge, gg = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    # the stand-in's capture pass draws too; a captured graph does not
    got = []
    for i in range(3):
        if i == 0:
            g.prepare(x, gg)
            gg.manual_seed(7)
        got.append(g(x, gg))
    ref = [noisy(x, ge) for _ in range(3)]
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert not torch.equal(got[0], got[1])


def test_graphed_function_restores_generator_state_after_warm_up():
    class NoCapturePass(_ReRun):
        """Closer to the card: the capture pass has no effect."""

        def capture(self, run, device, generators):
            states = [g.get_state() for g in generators]
            outs, replay = super().capture(run, device, generators)
            for g, s in zip(generators, states):
                g.set_state(s)
            return outs, replay

    def noisy(x, gen):
        return x + torch.randn(x.shape, generator=gen)

    x = torch.zeros(6)
    g = GraphedFunction(noisy, backend=NoCapturePass())
    ge, gg = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    assert torch.equal(g(x, gg), noisy(x, ge))
    assert torch.equal(g(x, gg), noisy(x, ge))


def test_graphed_function_replays_the_launch_counters():
    """What the capture pass counted is taken back and added at every
    replay; the warm-up calls' launches are real and stay."""
    def fn(x):
        sweeps.dense_sweep.launches += 2        # as two kernel launches
        sweeps.list_sweep.launches += 1
        return x + 1

    before = sweeps.launch_counts()
    grown = lambda: {k: n - before[k] for k, n in
                     sweeps.launch_counts().items() if n != before[k]}
    g = GraphedFunction(fn, backend=_ReRun())
    try:
        g.prepare(torch.zeros(2))
        assert grown() == {"dense_sweep": 4, "list_sweep": 2}  # warm-ups
        g(torch.zeros(2))
        assert grown() == {"dense_sweep": 6, "list_sweep": 3}
        for _ in range(5):
            g(torch.zeros(2))
        assert grown() == {"dense_sweep": 16, "list_sweep": 8}
    finally:
        sweeps.add_launches({k: -n for k, n in grown().items()})


def test_graphed_function_refuses_what_it_cannot_do():
    g = GraphedFunction(lambda x: x * 2)
    with pytest.raises(RuntimeError, match="(?s)card.*cpu.*graph=False"):
        g(torch.zeros(3))                       # the real backend, no card
    with pytest.raises(RuntimeError, match="requires grad.*graph=False"):
        GraphedFunction(lambda x: x * 2, backend=_ReRun())(
            torch.zeros(3, requires_grad=True))
    with pytest.raises(TypeError, match="not set"):
        GraphedFunction(lambda x: x, backend=_ReRun())({1, 2})

    def reads_host(x):
        raise ValueError("operation not permitted when stream is capturing")

    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    with pytest.raises(RuntimeError, match="(?s)capturing.*not permitted.*"
                                           "reads the host.*graph=False"):
        GraphedFunction(lambda x, g: reads_host(x), backend=_ReRun())(
            torch.zeros(3), gen)
    assert torch.equal(gen.get_state(), state)
    assert isinstance(GraphedFunction(lambda: None).backend,
                      CudaGraphBackend)


# -- the graphed rollout and train step, with the stand-in backend ------------

def _graphed_rollout(step, policy, steps, keep_scans, state, block=None):
    backend = _ReRun()
    run = prollout._GraphedRollout(step, policy, steps, BEAMS, keep_scans,
                                   state, backend=backend)
    if block is not None:
        run.block = block
    return run, backend


@pytest.mark.parametrize("backend", EXACT + EDF)
@pytest.mark.parametrize("noise", [False, True])
def test_graphed_rollout_equals_eager_loop(bundles, small_track, backend,
                                           noise):
    """The carried state, the block buffers (3 steps a block, 7 steps) and
    the step index: poses, collisions, scans and the final state equal the
    eager loop's bit for bit, also at a second call."""
    state = P.state_from_numpy(_initial(small_track), device="cpu")
    step = psim.make_step_fn(bundles[backend], with_noise=True)
    policy = make_gap_follower_policy(BEAMS, FOV)
    run, standin = _graphed_rollout(step, policy, STEPS, True, state, block=3)
    eager = make_rollout_fn(step, policy, STEPS, BEAMS, keep_scans=True,
                            graph=False)
    ge = torch.Generator().manual_seed(11) if noise else None
    gg = torch.Generator().manual_seed(11) if noise else None
    for call in range(2):
        fe, te = eager(state, ge)
        if noise and call == 0:
            # the stand-in's two capture passes draw; a real capture does not
            for g in run.graphs:
                g.prepare(gg)
            gg.manual_seed(11)
        fg, tg = run.run(state, gg)
        assert set(tg) == {"pose", "collision", "ranges"}
        for k in te:
            assert torch.equal(te[k], tg[k]), (k, call)
        assert _same_state(fe, fg)
    assert standin.captured == 2                # step 0, every later step
    assert [g.replays for g in run.graphs] == [2, 2 * (STEPS - 1)]
    assert 0 < int(te["collision"][-1].sum()) < N_AGENTS


def test_graphed_rollout_matches_jax(small_track):
    """The slice as a whole against the JAX package's ``lax.scan`` rollout
    on the sector backend: poses within 1e-5 m, collisions equal."""
    sim_kw = dict(ttc_threshold=0.3)
    from pyracecarsimulator_tpu.config import SimParams as JSimP
    jb = jsim.build_sim(small_track, sim=JSimP(**sim_kw), backend="sectors")
    pb = psim.build_sim(_port_track(small_track), sim=P.SimParams(**sim_kw),
                        backend="sectors", device="cpu")
    nb, fov = jb.scan.num_beams, jb.scan.fov
    d = _initial(small_track)
    js = jstate.CarState(**{k: jnp.asarray(v) for k, v in d.items()})
    ps = P.state_from_numpy(d, device="cpu")
    jfin, jtraj = jax_rollout(jsim.make_step_fn(jb, with_noise=False), js,
                              jax_gap_follower(nb, fov), 5, nb)
    run = prollout._GraphedRollout(
        psim.make_step_fn(pb, with_noise=False),
        make_gap_follower_policy(nb, fov), 5, nb, False, ps,
        backend=_ReRun())
    pfin, ptraj = run.run(ps, None)
    np.testing.assert_allclose(ptraj["pose"].numpy(),
                               np.asarray(jtraj["pose"]), atol=1e-5)
    np.testing.assert_array_equal(ptraj["collision"].numpy(),
                                  np.asarray(jtraj["collision"]))
    np.testing.assert_allclose(pfin.pose.numpy(), np.asarray(jfin.pose),
                               atol=1e-5)


def test_graphed_edf_rollout_matches_jax(small_track):
    """The graphed "edf" rollout against the JAX package's ``lax.scan``
    rollout of its "edf" step, the same numpy inputs: poses within 1e-5 m,
    collisions equal, the kept scans within tolerated fault 6 (>= 99.5% of
    the beams within 1e-4 m, all within 3 cells)."""
    sim_kw = dict(ttc_threshold=0.3)
    from pyracecarsimulator_tpu.config import SimParams as JSimP
    jb = jsim.build_sim(small_track, sim=JSimP(**sim_kw), backend="edf")
    pb = psim.build_sim(_port_track(small_track), sim=P.SimParams(**sim_kw),
                        backend="edf", device="cpu")
    nb, fov = jb.scan.num_beams, jb.scan.fov
    d = _initial(small_track)
    js = jstate.CarState(**{k: jnp.asarray(v) for k, v in d.items()})
    ps = P.state_from_numpy(d, device="cpu")
    jfin, jtraj = jax_rollout(jsim.make_step_fn(jb, with_noise=False), js,
                              jax_gap_follower(nb, fov), 5, nb,
                              keep_scans=True)
    run = prollout._GraphedRollout(
        psim.make_step_fn(pb, with_noise=False),
        make_gap_follower_policy(nb, fov), 5, nb, True, ps,
        backend=_ReRun())
    pfin, ptraj = run.run(ps, None)
    np.testing.assert_allclose(ptraj["pose"].numpy(),
                               np.asarray(jtraj["pose"]), atol=1e-5)
    np.testing.assert_array_equal(ptraj["collision"].numpy(),
                                  np.asarray(jtraj["collision"]))
    np.testing.assert_allclose(pfin.pose.numpy(), np.asarray(jfin.pose),
                               atol=1e-5)
    diff = np.abs(ptraj["ranges"].numpy() - np.asarray(jtraj["ranges"]))
    assert np.mean(diff <= 1e-4) >= 0.995 and diff.max() < 3 * 0.05


def test_graphed_rollout_hands_the_policy_its_step_index(small_track):
    """After step 0 the graphed loop's policy gets ``t`` as the step
    index carried beside the state (a one-element int64 tensor), the int 0 at
    step 0: an open-loop ``steer_seq[t]`` equals the eager loop bit for
    bit across blocks (3 steps a block) and at a second call, and the JAX
    package's ``lax.scan`` rollout within 1e-5 m in the poses."""
    sim_kw = dict(ttc_threshold=0.3)
    from pyracecarsimulator_tpu.config import SimParams as JSimP
    jb = jsim.build_sim(small_track, sim=JSimP(**sim_kw), backend="sectors")
    pb = psim.build_sim(_port_track(small_track), sim=P.SimParams(**sim_kw),
                        backend="sectors", device="cpu")
    nb = jb.scan.num_beams
    d = _initial(small_track)
    seq = np.linspace(-0.4, 0.4, STEPS).astype(np.float32)
    jseq, pseq = jnp.asarray(seq), torch.from_numpy(seq)
    seen = []

    def policy(state, ranges, t):
        seen.append(t)
        return (torch.full(state.batch_shape, 2.0),
                pseq[t].expand(state.batch_shape))

    ps = P.state_from_numpy(d, device="cpu")
    step = psim.make_step_fn(pb, with_noise=False)
    fe, te = make_rollout_fn(step, policy, STEPS, nb, graph=False)(ps)
    assert seen == list(range(STEPS))
    del seen[:]
    run = prollout._GraphedRollout(step, policy, STEPS, nb, False, ps,
                                   backend=_ReRun())
    run.block = 3
    for _ in range(2):
        fg, tg = run.run(ps, None)
        assert torch.equal(te["pose"], tg["pose"]) and _same_state(fe, fg)
    assert int(run.t) == STEPS
    assert {type(t) for t in seen} == {int, torch.Tensor}
    assert all(t == 0 for t in seen if isinstance(t, int))
    assert all(t.dtype == torch.int64 and t.shape == (1,)
               for t in seen if torch.is_tensor(t))
    # a loop that replayed step 1's command for ever would show here
    _, stale = make_rollout_fn(
        step, lambda s, r, t: policy(s, r, min(t, 1)), STEPS, nb,
        graph=False)(ps)
    assert not torch.equal(stale["pose"], te["pose"])
    js = jstate.CarState(**{k: jnp.asarray(v) for k, v in d.items()})
    _, jtraj = jax_rollout(
        jsim.make_step_fn(jb, with_noise=False), js,
        lambda s, r, t: (jnp.full(s.batch_shape, 2.0),
                         jnp.broadcast_to(jseq[t], s.batch_shape)),
        STEPS, nb)
    np.testing.assert_allclose(tg["pose"].numpy(), np.asarray(jtraj["pose"]),
                               atol=1e-5)


def test_one_shot_rollout_keeps_the_last_function(bundles, small_track):
    """``rollout`` builds its function once per (step, policy, sizes):
    the same objects again reuse it (on the card: its capture), other
    arguments replace it."""
    from pyracecarsimulator_tpu_torch.parallel import rollout
    state = P.state_from_numpy(_initial(small_track), device="cpu")
    step = psim.make_step_fn(bundles["sectors"], with_noise=False)
    policy = make_gap_follower_policy(BEAMS, FOV)
    _, a = rollout(step, state, policy, 3, BEAMS)
    kept = prollout._LAST_ROLLOUT[1]
    _, b = rollout(step, state, policy, 3, BEAMS)
    assert prollout._LAST_ROLLOUT[1] is kept
    assert torch.equal(a["pose"], b["pose"])
    _, c = rollout(step, state, policy, 4, BEAMS)
    assert prollout._LAST_ROLLOUT[1] is not kept and c["pose"].shape[0] == 4
    kept = prollout._LAST_ROLLOUT[1]
    rollout(step, state, make_gap_follower_policy(BEAMS, FOV), 4, BEAMS)
    assert prollout._LAST_ROLLOUT[1] is not kept
    _, e = rollout(step, state, policy, 3, BEAMS, keep_scans=True, graph=False)
    assert set(e) == {"pose", "collision", "ranges"}
    assert torch.equal(e["pose"], a["pose"])


def test_graphed_rollout_sizes_its_blocks(bundles, small_track):
    state = P.state_from_numpy(_initial(small_track), device="cpu")
    step = psim.make_step_fn(bundles["sectors"], with_noise=False)
    policy = make_gap_follower_policy(BEAMS, FOV)
    run, _ = _graphed_rollout(step, policy, 40, False, state)
    assert run.block == 40 and set(run.blocks) == {"pose", "collision"}
    per_step = N_AGENTS * (13 + 4 * BEAMS)
    old = prollout._BLOCK_BYTES
    prollout._BLOCK_BYTES = 5 * per_step + 1
    try:
        run, _ = _graphed_rollout(step, policy, 40, True, state)
    finally:
        prollout._BLOCK_BYTES = old
    assert run.block == 5 and run.blocks["ranges"].shape == (5, N_AGENTS,
                                                             BEAMS)
    assert sum(b.numel() * b.element_size()
               for b in run.blocks.values()) == 5 * per_step
    fin, traj = run.run(state, None)
    ref_fin, ref = make_rollout_fn(step, policy, 40, BEAMS, keep_scans=True,
                                   graph=False)(state)
    assert torch.equal(traj["ranges"], ref["ranges"])
    assert _same_state(fin, ref_fin)


def test_graphed_rollout_sees_a_swapped_map(bundles, small_track):
    """The step's map cell is watched: after a swap both graphs are
    captured again and the new map is read."""
    state = P.state_from_numpy(_initial(small_track), device="cpu")
    bundle = bundles["sectors"]
    step = psim.make_step_fn(bundle, with_noise=False)
    policy = make_constant_policy(1.0, 0.0)
    run, standin = _graphed_rollout(step, policy, 3, True, state)
    _, before = run.run(state, None)
    empty = np.zeros(tuple(bundle.track.occupancy.shape), np.float32)
    empty[:2, :] = 1
    other = psim.build_sim(
        TrackMap.from_numpy(empty, np.ones_like(empty), resolution=0.05,
                            origin_x=bundle.track.origin_x,
                            origin_y=bundle.track.origin_y,
                            height=bundle.track.height,
                            width=bundle.track.width, name="empty",
                            device="cpu"),
        scan=bundle.scan, backend="sectors", device="cpu")
    step.map_cell["map"] = other.segmap
    _, after = run.run(state, None)
    assert standin.captured == 4
    ref = make_rollout_fn(step, policy, 3, BEAMS, keep_scans=True,
                          graph=False)(state)[1]
    assert torch.equal(after["ranges"], ref["ranges"])
    assert not torch.equal(after["ranges"], before["ranges"])
    step.map_cell["map"] = bundle.segmap


def _train_policy(params, state, ranges, t):
    steer = torch.tanh(ranges @ params["w"] + params["b"])
    return torch.full(state.batch_shape, 2.0), steer


def _train_loss(out, t):
    return (torch.mean((out.ranges - 10.0) ** 2)
            + 10.0 * torch.mean(out.collision.float()))


@pytest.mark.parametrize("optimizer", ["sgd", "momentum"])
def test_graphed_train_step_equals_eager(small_track, optimizer):
    """Whole-step capture with the stand-in: the warm-up steps' updates
    are put back (parameters, momentum buffers), the gradients stay
    allocated, and losses, parameters and the final state after 4 steps
    equal the eager trainer's bit for bit."""
    bundle = psim.build_sim(
        _port_track(small_track), scan=P.ScanParams(num_beams=BEAMS),
        sim=P.SimParams(steer_mode="smooth"), backend="sectors",
        device="cpu")
    step = psim.make_step_fn(bundle, with_noise=True)
    state = P.state_from_numpy(_initial(small_track, 8), device="cpu")
    make_opt = {"sgd": None, "momentum": lambda ps: torch.optim.SGD(
        ps, lr=1e-2, momentum=0.9)}[optimizer]
    got = {}
    for graph in (False, True):
        train, init = make_bptt_train_fn(step, _train_policy, _train_loss, 3,
                                         BEAMS, optimizer=make_opt,
                                         graph=graph)
        train.graphed.backend = _ReRun()
        params = {"w": torch.full((BEAMS,), 0.01), "b": torch.zeros(())}
        opt = init(params)
        gen = torch.Generator().manual_seed(1)
        losses = []
        for i in range(4):
            if graph and i == 0:
                # the stand-in's capture pass trains for real: keep it out
                state_w = {k: v.detach().clone() for k, v in params.items()}
            params, opt, loss, final = train(params, opt, state, gen)
            losses.append(float(loss))
        got[graph] = (losses, params["w"].detach().clone(),
                      params["b"].detach().clone(), final,
                      params["w"].grad.clone())
        if graph:
            assert train.graphed.captures == 1
            assert train.graphed.replays == 4
    assert got[True][0] == got[False][0]
    for i in (1, 2, 4):
        assert torch.equal(got[True][i], got[False][i])
    assert _same_state(got[True][3], got[False][3])
    assert got[True][0][0] != got[True][0][-1]      # it trains


@pytest.mark.parametrize("backend", EDF)
def test_graphed_edf_train_step_equals_eager(small_track, backend):
    """The "edf", "edf_implicit" and "edf_bilinear" train steps captured
    with the stand-in: losses, parameters, gradients and the final state
    after 3 steps equal the eager trainer's bit for bit."""
    bundle = psim.build_sim(
        _port_track(small_track), scan=P.ScanParams(num_beams=BEAMS),
        sim=P.SimParams(steer_mode="smooth"), backend=backend, device="cpu")
    step = psim.make_step_fn(bundle, with_noise=True)
    state = P.state_from_numpy(_initial(small_track, 8), device="cpu")
    got = {}
    for graph in (False, True):
        train, init = make_bptt_train_fn(step, _train_policy,
                                         _edf_train_loss, 3, BEAMS,
                                         graph=graph)
        train.graphed.backend = _ReRun()
        params = {"w": torch.full((BEAMS,), 0.01), "b": torch.zeros(())}
        opt = init(params)
        gen = torch.Generator().manual_seed(1)
        losses = []
        for _ in range(3):
            params, opt, loss, final = train(params, opt, state, gen)
            losses.append(float(loss))
        got[graph] = (losses, params["w"].detach().clone(),
                      params["b"].detach().clone(), final,
                      params["w"].grad.clone())
        assert train.graphed.captures == (1 if graph else 0)
    assert got[True][0] == got[False][0]
    for i in (1, 2, 4):
        assert torch.equal(got[True][i], got[False][i])
    assert _same_state(got[True][3], got[False][3])
    assert got[True][0][0] != got[True][0][-1]      # it trains


# -- spans and label tables, with the stand-in backend ------------------------

@pytest.fixture
def tracing():
    """Tracing on for one test, off and without tables afterwards."""
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()


@pytest.mark.parametrize("on", [False, True])
def test_graphed_function_labels_only_with_tracing_on(on):
    """Tracing off: the backend is asked for the same calls in the same
    order as ever (two warm-up calls, the capture, a replay a call) and no
    table exists. On: one more eager call on the warm-up's terms after the
    capture gives the capture its table, and ``enable`` labels a capture
    made while tracing was off."""
    backend = _ReRun()
    g = GraphedFunction(lambda x: x * 2, backend=backend)
    x = torch.arange(3.0)
    try:
        if on:
            profiling.enable()
        assert torch.equal(g(x), x * 2) and torch.equal(g(x + 1), x * 2 + 2)
        label = [("warm_up", 1)] if on else []
        assert backend.calls == [("warm_up", 2), ("capture",)] + label + [
            ("replay",), ("replay",)]
        assert (g._cap.table in profiling._tables) == on
        profiling.enable()
        assert g._cap.table in profiling._tables
        assert backend.calls.count(("warm_up", 1)) == 1
    finally:
        profiling.disable()
    assert not profiling._tables
    g(x)
    assert backend.calls[-1] == ("replay",) and backend.warmups == 3


def test_labelling_changes_no_result(small_track, tracing):
    """The labelling calls put back what they change: with tracing on the
    graphed train step (the momentum buffers, the parameters)
    and the graphed noisy rollout (the generator, the carry) equal the
    eager ones bit for bit."""
    bundle = psim.build_sim(
        _port_track(small_track), scan=P.ScanParams(num_beams=BEAMS),
        sim=P.SimParams(steer_mode="smooth"), backend="edf_implicit",
        device="cpu")
    step = psim.make_step_fn(bundle, with_noise=True)
    state = P.state_from_numpy(_initial(small_track, 8), device="cpu")
    got = {}
    for graph in (False, True):
        train, init = make_bptt_train_fn(
            step, _train_policy, _edf_train_loss, 3, BEAMS,
            optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-2, momentum=0.9),
            graph=graph)
        train.graphed.backend = _ReRun()
        params = {"w": torch.full((BEAMS,), 0.01), "b": torch.zeros(())}
        opt = init(params)
        losses = [float(train(params, opt, state)[2]) for _ in range(3)]
        got[graph] = (losses, params["w"].detach().clone())
    assert got[True][0] == got[False][0]
    assert torch.equal(got[True][1], got[False][1])
    policy = make_gap_follower_policy(BEAMS, FOV)
    run, standin = _graphed_rollout(step, policy, 4, True, state)
    eager = make_rollout_fn(step, policy, 4, BEAMS, keep_scans=True,
                            graph=False)
    for g in run.graphs:        # the stand-in's capture passes draw
        g.prepare(torch.Generator().manual_seed(3))
    fe, te = eager(state, torch.Generator().manual_seed(3))
    fg, tg = run.run(state, torch.Generator().manual_seed(3))
    assert all(torch.equal(te[k], tg[k]) for k in te)
    assert _same_state(fe, fg)
    # one labelling call a capture (a new generator captures again)
    assert standin.calls.count(("warm_up", 1)) == standin.captured == 4


def test_capture_under_a_profiler_is_never_labelled_inside_a_rollout(
        small_track, tracing):
    """A capture made while a profiler runs gets no table, and none is
    made at its later calls: a labelling step there would run after
    ``run`` has set the carry and move the rollout a step on. With
    tracing on, a rollout captured inside ``profile()`` and called again
    outside it equals the eager rollout bit for bit, both times."""
    from torch.profiler import ProfilerActivity, profile
    bundle = psim.build_sim(_port_track(small_track),
                            scan=P.ScanParams(num_beams=BEAMS),
                            backend="edf", device="cpu")
    step = psim.make_step_fn(bundle)
    policy = make_gap_follower_policy(BEAMS, FOV)
    state = P.state_from_numpy(_initial(small_track, 8), device="cpu")
    run, standin = _graphed_rollout(step, policy, 5, True, state, block=3)
    eager = make_rollout_fn(step, policy, 5, BEAMS, keep_scans=True,
                            graph=False)
    for traced in (True, False):
        with profile(activities=[ProfilerActivity.CPU]) if traced \
                else contextlib.nullcontext():
            fg, tg = run.run(state, None)
        fe, te = eager(state, None)
        assert all(torch.equal(te[k], tg[k]) for k in te)
        assert _same_state(fe, fg)
        state = fg
    assert standin.captured == 2 and ("warm_up", 1) not in standin.calls
    assert all(g._cap.table is None for g in run.graphs)


def test_labelling_after_a_rollout_hands_the_policy_a_step_it_can_take(
        small_track):
    """After a whole rollout the step index stands at T; ``enable`` labels
    the graphs from step 1 and row 0 (``_GraphedRollout._rewind``, which
    the capture's warm-up calls start from too), so an open-loop policy
    that indexes its commands by ``t`` is handed a step it has."""
    bundle = psim.build_sim(_port_track(small_track),
                            scan=P.ScanParams(num_beams=BEAMS),
                            backend="edf", device="cpu")
    seq = torch.linspace(-0.3, 0.3, 4)
    seen = []

    def policy(state, ranges, t):
        seen.append(int(t))
        return (torch.full(state.batch_shape, 2.0),
                seq[t].expand(state.batch_shape))

    state = P.state_from_numpy(_initial(small_track, 4), device="cpu")
    run, standin = _graphed_rollout(psim.make_step_fn(bundle), policy, 4,
                                    False, state)
    run.run(state, None)
    assert int(run.t) == 4
    del seen[:]
    try:
        profiling.enable()
        assert standin.calls.count(("warm_up", 1)) == 2
    finally:
        profiling.disable()
    assert seen == [0, 1]


def _ranges(prof):
    """(name, start, end) of the port's spans in a CPU profile."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name in profiling.SPANS]


def _inside(ranges, outer):
    """The names of the spans that lie inside some ``outer`` span."""
    boxes = [(a, b) for n, a, b in ranges if n == outer]
    return {n for n, a, b in ranges if n != outer
            and any(a0 <= a and b <= b0 for a0, b0 in boxes)}


def test_spans_nest_as_the_layers_do(small_track, tracing):
    """With tracing on, a graphed rollout and a graphed train step
    (stand-in) record the spans of ``utils/profiling.py`` and they nest:
    a replay holds the step's and the loop's spans, a rollout's block
    copies and a call's copies lie outside it; the sector scan's routing
    lies inside ``step.scan``."""
    from torch.profiler import ProfilerActivity, profile
    bundle = psim.build_sim(
        _port_track(small_track), scan=P.ScanParams(num_beams=BEAMS),
        sim=P.SimParams(steer_mode="smooth"), backend="sectors",
        device="cpu")
    step = psim.make_step_fn(bundle, with_noise=True)
    state = P.state_from_numpy(_initial(small_track, 8), device="cpu")
    run, _ = _graphed_rollout(step, make_gap_follower_policy(BEAMS, FOV), 3,
                              True, state)
    gen = torch.Generator().manual_seed(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run.run(state, gen)
    r = _ranges(prof)
    assert {n for n, _, _ in r} == {
        "rollout.blocks", "graph.copy_in",
        "graph.replay", "graph.copy_out", "rollout.policy", "step.dynamics",
        "step.scan", "scan.route", "step.noise", "step.ttc",
        "rollout.carry"}
    assert _inside(r, "graph.replay") == {
        "rollout.policy", "step.dynamics", "step.scan", "scan.route",
        "step.noise", "step.ttc", "rollout.carry"}
    assert _inside(r, "step.scan") == {"scan.route"}
    assert not _inside(r, "rollout.blocks")
    train, init = make_bptt_train_fn(
        step, _train_policy, _train_loss, 2, BEAMS, graph=True)
    train.graphed.backend = _ReRun()
    params = {"w": torch.full((BEAMS,), 0.01), "b": torch.zeros(())}
    opt = init(params)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train(params, opt, state, gen)
    r = _ranges(prof)
    assert {"graph.copy_in", "graph.replay", "graph.copy_out",
            "train.backward"} <= {n for n, _, _ in r}
    assert _inside(r, "graph.replay") == {
        "train.optimizer", "train.policy", "train.loss", "train.backward",
        "step.dynamics", "step.scan", "scan.route", "step.noise", "step.ttc"}
    assert _inside(r, "step.scan") == {"scan.route"}


def test_optimizer_snapshot_puts_back_values_in_place():
    ptrain = importlib.import_module(
        "pyracecarsimulator_tpu_torch.parallel.train")
    w = torch.ones(3, requires_grad=True)
    opt = torch.optim.SGD([w], lr=0.5, momentum=0.9)
    restore = ptrain._optimizer_snapshot([w], opt)
    w.sum().backward()
    opt.step()                                  # creates the momentum buffer
    buf = opt.state[w]["momentum_buffer"]
    assert not torch.equal(w.detach(), torch.ones(3)) and buf.abs().sum() > 0
    ptr = w.data_ptr()
    restore()
    assert torch.equal(w.detach(), torch.ones(3)) and w.data_ptr() == ptr
    assert opt.state[w]["momentum_buffer"] is buf and buf.abs().sum() == 0
    restore2 = ptrain._optimizer_snapshot([w], opt)
    opt.step()
    restore2()                                  # a state that existed: kept
    assert buf.abs().sum() == 0 and torch.equal(w.detach(), torch.ones(3))
