"""The port's tooling: the default device, debug guards, timers, the pod
mesh layout, the map generators, the copied oracles and viz.

Tolerances: the generators equal the committed assets byte for byte; the
copied NumPy oracles equal the JAX package's copies exactly; the port's
dynamics against ``oracle/dynamics.py`` carry the bounds of
tests/test_dynamics.py and tests/test_ttc.py (2e-5, 5e-5 on the
single-track step, 1e-5 on inputs and tables; TTC flags equal).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyracecarsimulator_tpu.oracle import dynamics as jax_odyn

import pyracecarsimulator_tpu_torch as P
from pyracecarsimulator_tpu_torch import config as pcfg
from pyracecarsimulator_tpu_torch.maps import generate as pgen
from pyracecarsimulator_tpu_torch.maps import loader as ploader
from pyracecarsimulator_tpu_torch.models import dynamics as pdyn
from pyracecarsimulator_tpu_torch.models import ttc as pttc
from pyracecarsimulator_tpu_torch.oracle import dynamics as odyn
from pyracecarsimulator_tpu_torch.parallel import multihost
from pyracecarsimulator_tpu_torch.utils import debug, profiling, viz
from pyracecarsimulator_tpu_torch.utils.checkpoint import load_npz, save_npz

CAR = P.CarParams()
FOV = 4.712388980384690
DT = 0.01

def _need_no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default resolves")


# -- the default device ----------------------------------------------------

def test_build_sim_without_a_card_raises_and_names_the_argument():
    _need_no_card()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        P.build_sim("levine")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        P.RacecarSimulator("levine")


@pytest.mark.parametrize("call", [
    lambda: ploader.load_builtin("levine"),
    lambda: ploader.load_map_yaml(os.path.join(ploader.ASSETS_DIR,
                                               "levine.yaml")),
    lambda: ploader.build_track_map(np.zeros((8, 8), np.float32), 0.05),
    lambda: P.zero_state((2,)),
    lambda: P.state_from_numpy({}),
    lambda: load_npz("no_such_file.npz"),
    lambda: __import__(
        "pyracecarsimulator_tpu_torch.parallel.dryrun",
        fromlist=["dryrun"]).dryrun(2, beams_axis=2),
], ids=["load_builtin", "load_map_yaml", "build_track_map", "zero_state",
        "state_from_numpy", "load_npz", "dryrun"])
def test_entry_points_never_pick_the_cpu_themselves(call):
    """device=None means the card: without one every entry point raises
    before it does any work (no file is read, no map built)."""
    _need_no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_resolve_device_keeps_an_explicit_choice():
    assert pcfg.resolve_device("cpu") == torch.device("cpu")
    assert pcfg.resolve_device(torch.device("cpu")).type == "cpu"
    assert P.zero_state((3,), device="cpu").x.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="never|no CUDA"):
            pcfg.default_device()
    else:
        assert pcfg.default_device().type == "cuda"


def test_checkpoint_round_trip_names_its_device(tmp_path):
    s = P.state_from_pose(torch.arange(3.0), torch.zeros(3), torch.ones(3))
    save_npz(str(tmp_path / "s.npz"), s, step=4)
    back, key, step = load_npz(str(tmp_path / "s.npz"), device="cpu")
    assert step == 4 and key is None and torch.equal(back.x, s.x)


# -- utils.debug -----------------------------------------------------------

def _tiny_step():
    from pyracecarsimulator_tpu_torch.parallel.dryrun import tiny_occupancy
    track = ploader.build_track_map(tiny_occupancy(), 0.05, (-4.8, -4.8),
                                    device="cpu")
    bundle = P.build_sim(track, scan=P.ScanParams(num_beams=32),
                         backend="sectors", device="cpu")
    state = P.state_from_pose(torch.tensor([-3.5, 3.5]),
                              torch.tensor([-3.5, 3.0]), torch.zeros(2))
    action = (torch.full((2,), 2.0), torch.zeros(2))
    return P.make_step_fn(bundle, with_noise=False), state, action


def test_checked_passes_a_clean_step():
    step, state, action = _tiny_step()
    out = debug.checked(step)(state, action, None)
    ref = step(state, action, None)
    assert torch.equal(out.ranges, ref.ranges)
    assert torch.equal(out.state.x, ref.state.x)


@pytest.mark.parametrize("field, value, message", [
    ("x", float("nan"), "non-finite x"),
    ("theta", float("nan"), "non-finite theta"),
    ("y", 2e4, "y out of bounds")])
def test_checked_raises_on_a_bad_state(field, value, message):
    step, state, action = _tiny_step()
    bad = P.state.set_field(state, **{field: torch.tensor([0.0, value])})
    with pytest.raises(FloatingPointError, match=message):
        debug.checked(step)(bad, action, None)


def test_checked_raises_on_bad_ranges_and_honours_the_bound():
    step, state, action = _tiny_step()

    def poisoned(s, a, g=None):
        out = step(s, a, g)
        return out._replace(ranges=out.ranges - 100.0)

    with pytest.raises(FloatingPointError, match="negative scan range"):
        debug.checked(poisoned)(state, action)
    with pytest.raises(FloatingPointError, match="x out of bounds"):
        debug.checked(step, max_abs_pos=1.0)(state, action, None)


# -- utils.profiling -------------------------------------------------------

def test_timed_loop_counts_calls_and_passes_the_index():
    seen = []
    sec = profiling.timed_loop(lambda i, t: seen.append(i) or t.sum(),
                               torch.ones(4), reps=5, warmup=2, index=True)
    assert seen == [0, 1, 2, 3, 4, 5, 6] and sec > 0
    calls = []
    profiling.timed_loop(lambda t: calls.append(1), torch.ones(4), reps=3,
                         warmup=1)
    assert len(calls) == 4


def test_timed_loop_measures_host_time_on_the_cpu():
    import time
    sec = profiling.timed_loop(lambda: time.sleep(0.01), reps=3, warmup=0)
    assert 0.009 < sec < 0.1


def test_timed_loop_never_guesses_the_cpu_once_cuda_is_in_use(monkeypatch):
    """A closure that takes and returns no tensor hides where it runs:
    with CUDA initialised in the process the call asks for ``device``."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(ValueError, match='device="cuda"'):
        profiling.timed_loop(lambda: None, reps=1, warmup=1)
    calls = []
    sec = profiling.timed_loop(lambda: calls.append(1), reps=2, warmup=1,
                               device="cpu")
    assert len(calls) == 3 and sec >= 0
    # a tensor among the arguments or in the result names the device
    assert profiling.timed_loop(lambda t: None, torch.ones(2), reps=1) >= 0
    assert profiling.timed_loop(lambda: torch.ones(2), reps=1) >= 0


def test_rays_per_second_counts_rays():
    import time
    poses = torch.zeros(4, 3)

    def scan(p):
        time.sleep(0.005)
        return p

    rate = profiling.rays_per_second(scan, poses, num_beams=100, reps=3)
    assert 400 / 0.1 < rate < 400 / 0.005


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(16).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0


# -- utils.profiling: spans and the report ---------------------------------

@pytest.fixture
def tracing():
    """Tracing on for one test, off and without tables afterwards."""
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()


def _ev(name, start, end, thread=1, id=0, dev=False, seq=-1, fwd=0,
        mark=None):
    """A profiler event as ``torch.profiler``'s ``events()`` gives it:
    times in microseconds, a host span marked as a user annotation."""
    from types import SimpleNamespace
    return SimpleNamespace(
        name=name, id=id, thread=thread, fwd_thread=fwd, sequence_nr=seq,
        device_type="DeviceType.CUDA" if dev else "DeviceType.CPU",
        time_range=SimpleNamespace(start=start, end=end),
        is_user_annotation=(name in profiling.SPANS or name.startswith(
            "graph.table#")) if mark is None else mark)


def test_span_is_a_shared_noop_when_tracing_is_off():
    """Off: the same object at every call, nothing recorded (a CPU profile
    of a step and a rollout shows no span); a name outside ``SPANS`` is
    refused either way."""
    from torch.profiler import ProfilerActivity, profile
    assert not profiling.enabled()
    assert profiling.span("step.scan") is profiling.span("step.scan")
    assert profiling.replay_span(None) is profiling.span("graph.replay")
    bundle = P.build_sim(ploader.load_builtin("levine", device="cpu"),
                         scan=P.ScanParams(num_beams=16), backend="edf",
                         device="cpu")
    step = P.make_step_fn(bundle, with_noise=True)
    state = P.state_from_pose(torch.tensor([7.0]), torch.tensor([4.0]),
                              torch.tensor([0.0]))
    act = (torch.full((1,), 2.0), torch.zeros(1))
    from pyracecarsimulator_tpu_torch.parallel import (
        make_constant_policy, rollout)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, act, torch.Generator().manual_seed(0))
        rollout(step, state, make_constant_policy(2.0, 0.0), 2, 16)
    assert not {e.name for e in prof.events()} & profiling.SPANS
    for on in (False, True):
        profiling.enable() if on else None
        try:
            with pytest.raises(KeyError):
                profiling.span("step.other")
        finally:
            profiling.disable()


def test_span_decorates_and_checks_at_each_call(tracing):
    """A function decorated while tracing was off records its range once
    tracing is on, and nothing once it is off again."""
    from torch.profiler import ProfilerActivity, profile
    profiling.disable()
    built = profiling.span("step.noise")(lambda x: x + 1)
    for on in (True, False):
        profiling.enable() if on else profiling.disable()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert built(torch.ones(1)).item() == 2.0
        names = [e.name for e in prof.events()]
        assert names.count("step.noise") == (1 if on else 0)


def test_report_attributes_replays_by_position_and_counts_a_mismatch(
        tracing, monkeypatch):
    """A replay's operations (the CUPTI correlation of the
    ``cudaGraphLaunch`` inside its ``graph.replay``) take their table's
    paths by position under the spans around the replay, checked by name
    where the table has one (a copy by kind: the graph may run it as a
    kernel); a replay whose count or names differ is counted and left
    unattributed; the ranges the profiler draws on the device's timeline
    are not operations."""
    monkeypatch.setitem(profiling._tables, 7, [
        ("k1", ("step.dynamics",)), (None, ("step.scan",)),
        ("Memcpy DtoD (Device -> Device)", ("step.scan",))])

    def replay(t, launch, names):
        return [_ev("graph.replay", t, t + 30), _ev("graph.table#7", t + 1,
                                                    t + 29),
                _ev("cudaGraphLaunch", t + 2, t + 4, id=launch)] + [
            _ev(n, t + 10 + 2 * i, t + 11 + 2 * i, id=launch, dev=True)
            for i, n in enumerate(names)]

    ev = ([_ev("rollout.blocks", 0, 200)]
          + replay(10, 100, ["k1", "k2", "memcpy32_post"])
          + [_ev("graph.replay", 20, 25, dev=True, mark=True)]
          + replay(60, 101, ["k1", "k2"])
          + replay(110, 102, ["kY", "k2",
                              "Memcpy DtoD (Device -> Device)"]))
    rep = profiling.report(ev, calls=1, steps=2)
    spans = rep["spans"]
    assert set(spans) == {"rollout.blocks", "rollout.blocks/graph.replay",
                          "rollout.blocks/graph.replay/step.dynamics",
                          "rollout.blocks/graph.replay/step.scan"}
    scan = spans["rollout.blocks/graph.replay/step.scan"]
    assert scan["self_s"] == pytest.approx(2e-6)
    assert scan["ops"] == pytest.approx({"k2": 1e-6, "memcpy32_post": 1e-6})
    assert spans["rollout.blocks"]["total_s"] == pytest.approx(3e-6)
    assert spans["rollout.blocks"]["self_s"] == 0.0
    assert (rep["replays"], rep["mismatched_replays"]) == (3, 2)
    assert rep["device_s"] == pytest.approx(8e-6)
    assert rep["unattributed_s"] == pytest.approx(5e-6)
    assert rep["coverage"] == pytest.approx(3 / 8)
    assert rep["busy_s"] == pytest.approx(8e-6)
    assert (rep["calls"], rep["steps"]) == (1, 2)


def test_report_gives_autograd_ops_their_forward_span(tracing):
    """An operation launched under an autograd node takes the span of the
    forward operation of the same sequence number, with ``.bwd``; one
    under no node and no span on its thread takes the span open on
    another (the caller in ``backward``); one under no span is outside
    the program."""
    ev = [_ev("step.scan", 0, 10), _ev("aten::mul", 1, 5, seq=5),
          _ev("cudaLaunchKernel", 2, 3, id=200),
          _ev("mul_kernel", 4, 6, id=200, dev=True),
          _ev("train.backward", 15, 35),
          _ev("autograd::engine::evaluate_function: MulBackward0", 20, 30,
              thread=2, seq=5, fwd=1),
          _ev("MulBackward0", 20.5, 29, thread=2, seq=5, fwd=1),
          _ev("cudaLaunchKernel", 21, 22, thread=2, id=201),
          _ev("mul_bwd_kernel", 23, 26, id=201, dev=True),
          _ev("torch::autograd::AccumulateGrad", 30.5, 33, thread=2),
          _ev("cudaLaunchKernel", 31, 32, thread=2, id=202),
          _ev("add_kernel", 32, 33.5, id=202, dev=True),
          _ev("cudaMemcpyAsync", 40, 41, id=203),
          _ev("Memcpy DtoD", 41, 42, id=203, dev=True),
          _ev("lost_kernel", 50, 51, id=999, dev=True)]
    rep = profiling.report(ev, calls=1, steps=1)
    self_s = {k: v["self_s"] for k, v in rep["spans"].items()}
    assert self_s == pytest.approx({"step.scan": 2e-6,
                                    "step.scan.bwd": 3e-6,
                                    "train.backward": 1.5e-6})
    assert rep["outside_s"] == pytest.approx(1e-6)
    assert rep["unattributed_s"] == pytest.approx(1e-6)
    assert rep["coverage"] == pytest.approx(6.5 / 8.5)
    # idle gaps by the innermost span open at their middle
    assert rep["idle_s"] == pytest.approx({
        profiling.OUTSIDE: (17 + 7.5 + 8) * 1e-6, "train.backward": 6e-6})


def test_counters_gather_the_ports_counters():
    """``counters()``: the wrappers' launches, each live graphed function's
    captures and replays, the march's, the list sweep's and the dense
    sweep's counts (the exact reads)."""
    from pyracecarsimulator_tpu_torch.ops import sweeps
    from pyracecarsimulator_tpu_torch.ops.raymarch_xla import MARCH_COUNTS
    from pyracecarsimulator_tpu_torch.utils.graph import GraphedFunction
    g = GraphedFunction(lambda x: x, name="counted function")
    got = profiling.counters()
    assert got["launches"] == sweeps.launch_counts()
    mine = [r for r in got["graphs"] if r["name"] == "counted function"]
    assert mine == [{"name": "counted function", "captures": 0,
                     "replays": 0}]
    assert got["march"] == dict(MARCH_COUNTS)
    assert got["sweep"] == dict(sweeps.SWEEP_COUNTS)
    assert set(got["sweep"]) == {"rows", "slots", "kept", "fanned"}
    assert got["dense"] == dict(sweeps.DENSE_COUNTS)
    assert set(got["dense"]) == {"rays", "pairs"}
    del g


# -- parallel.multihost ----------------------------------------------------

@pytest.mark.parametrize("world, local, beams, want", [
    ("8", "4", 2, (4, 2)), ("8", "4", 4, (2, 4)), ("8", "8", 1, (8, 1)),
    ("16", "4", 1, (16, 1))])
def test_pod_mesh_layout_from_env_vars(monkeypatch, world, local, beams,
                                       want):
    """beams is carved from a host's ranks; torchrun numbers them
    contiguously and the mesh is row-major, so each beams group is one
    host's."""
    monkeypatch.setenv("WORLD_SIZE", world)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert multihost.pod_mesh_shape(beams) == want
    na, nb = want
    for a in range(na):
        hosts = {(a * nb + b) // int(local) for b in range(nb)}
        assert len(hosts) == 1


def test_pod_mesh_keeps_beams_inside_a_host(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    for beams in (3, 8):
        with pytest.raises(ValueError, match="must divide the host"):
            multihost.pod_mesh_shape(beams)
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert multihost.pod_mesh_shape(8) == (1, 8)      # one host


def test_initialize_needs_a_rendezvous(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        multihost.initialize("gloo")


def test_global_agent_count():
    from pyracecarsimulator_tpu_torch.parallel.mesh import Mesh
    m = Mesh(agents=8, beams=2, agents_index=0, beams_index=0,
             beams_ranks=(0, 1))
    assert multihost.global_agent_count(8192, m) == 65536


# -- maps.generate ---------------------------------------------------------

@pytest.mark.parametrize("name", ["levine", "berlin"])
def test_generators_reproduce_the_committed_assets(name, tmp_path):
    """generate_<name>() is the committed .pgm, and generate_builtin writes
    the committed pair byte for byte."""
    img = {"levine": pgen.generate_levine,
           "berlin": pgen.generate_berlin}[name]()
    ref = ploader.read_pgm(os.path.join(ploader.ASSETS_DIR, f"{name}.pgm"))
    assert img.dtype == np.uint8
    np.testing.assert_array_equal(img, ref)
    pgen.generate_builtin(name, str(tmp_path))
    for ext in ("pgm", "yaml"):
        with open(os.path.join(ploader.ASSETS_DIR, f"{name}.{ext}"),
                  "rb") as f, open(tmp_path / f"{name}.{ext}", "rb") as g:
            assert f.read() == g.read()


def test_generate_builtin_rejects_unknown_names(tmp_path):
    with pytest.raises(KeyError, match="unknown builtin"):
        pgen.generate_builtin("monza", str(tmp_path))
    with pytest.raises(FileNotFoundError):          # never regenerated
        ploader.load_builtin("monza", device="cpu")


# -- oracle.dynamics -------------------------------------------------------

def _state(d):
    f = lambda k: torch.tensor(d[k], dtype=torch.float32)
    return P.CarState(x=f("x"), y=f("y"), theta=f("theta"),
                      velocity=f("velocity"), steer_angle=f("steer_angle"),
                      angular_velocity=f("angular_velocity"),
                      slip_angle=f("slip_angle"),
                      st_dyn=torch.tensor(d["st_dyn"]),
                      collision=torch.tensor(False))


def _close(s, od, atol):
    for k in ("x", "y", "theta", "velocity", "steer_angle",
              "angular_velocity", "slip_angle"):
        assert abs(float(getattr(s, k)) - od[k]) < atol, k


def test_oracle_copy_equals_the_jax_packages(rng):
    """The copied module computes what the original computes."""
    d = {"x": 1.0, "y": -2.0, "theta": 0.7, "velocity": 3.0,
         "steer_angle": 0.2, "angular_velocity": 0.5, "slip_angle": 0.05,
         "st_dyn": False}
    for fn in ("ks_step", "st_step"):
        assert getattr(odyn, fn)(d, 1.5, -0.8, CAR, DT) == \
            getattr(jax_odyn, fn)(d, 1.5, -0.8, CAR, DT)
    assert odyn.ackermann_step(d, 2.0, 0.1, CAR, DT) == \
        jax_odyn.ackermann_step(d, 2.0, 0.1, CAR, DT)
    for a, b in zip(odyn.ttc_tables(90, FOV, CAR),
                    jax_odyn.ttc_tables(90, FOV, CAR)):
        np.testing.assert_array_equal(a, b)
    assert odyn.compute_accel(3.0, 1.0, CAR) == \
        jax_odyn.compute_accel(3.0, 1.0, CAR)


def test_input_processing_matches_oracle(rng):
    """1e-5, over both accel clamps and the bang-bang dead band."""
    for _ in range(50):
        v, v_des = rng.uniform(-7, 7), rng.uniform(-8, 8)
        st, st_des = rng.uniform(-0.4, 0.4), rng.uniform(-0.5, 0.5)
        s = P.state.set_field(
            P.zero_state((), device="cpu"),
            velocity=torch.tensor(v, dtype=torch.float32),
            steer_angle=torch.tensor(st, dtype=torch.float32))
        a, sv = pdyn.process_input(torch.tensor(v_des, dtype=torch.float32),
                                   torch.tensor(st_des, dtype=torch.float32),
                                   s, CAR)
        ao = odyn.compute_accel(
            float(np.clip(v_des, -CAR.max_speed, CAR.max_speed)), v, CAR)
        svo = odyn.compute_steer_vel(
            float(np.clip(st_des, -CAR.max_steer_angle,
                          CAR.max_steer_angle)), st, CAR)
        assert abs(float(a) - ao) < 1e-5 and abs(float(sv) - svo) < 1e-5


def test_ks_and_ackermann_match_oracle(rng):
    """2e-5 on every continuous field."""
    for _ in range(30):
        d = {"x": rng.uniform(-5, 5), "y": rng.uniform(-5, 5),
             "theta": rng.uniform(-3, 3), "velocity": rng.uniform(-5, 7),
             "steer_angle": rng.uniform(-0.4, 0.4),
             "angular_velocity": 0.0, "slip_angle": 0.0, "st_dyn": False}
        a, sv = rng.uniform(-5, 5), rng.uniform(-3, 3)
        t = lambda v: torch.tensor(v, dtype=torch.float32)
        _close(pdyn.ks_step(_state(d), t(a), t(sv), CAR, DT),
               odyn.ks_step(d, a, sv, CAR, DT), 2e-5)
        speed, steer = rng.uniform(0, 5), rng.uniform(-0.4, 0.4)
        _close(pdyn.ackermann_step(_state(d), t(speed), t(steer), CAR, DT),
               odyn.ackermann_step(d, speed, steer, CAR, DT), 2e-5)


@pytest.mark.parametrize("v0", [0.1, 0.5, 1.5, 4.0, 6.5, -2.0])
def test_st_matches_oracle_both_branches(v0):
    """5e-5; the kinematic branch below v_switch, the dynamic one above."""
    d = {"x": 1.0, "y": -2.0, "theta": 0.7, "velocity": v0,
         "steer_angle": 0.2, "angular_velocity": 0.5, "slip_angle": 0.05,
         "st_dyn": False}
    t = lambda v: torch.tensor(v, dtype=torch.float32)
    s = pdyn.st_step(_state(d), t(1.5), t(-0.8), CAR, DT)
    _close(s, odyn.st_step(d, 1.5, -0.8, CAR, DT), 5e-5)
    assert bool(s.st_dyn) == (abs(v0) >= CAR.v_switch)


def test_ttc_tables_match_oracle():
    """cosines 1e-6, footprint distances 1e-5."""
    c, dist = pttc.ttc_tables(180, FOV, CAR, "cpu")
    c_o, dist_o = odyn.ttc_tables(180, FOV, CAR)
    np.testing.assert_allclose(c.numpy(), c_o, atol=1e-6)
    np.testing.assert_allclose(dist.numpy(), dist_o, atol=1e-5)


def test_check_ttc_matches_oracle(rng):
    """Flags equal on 50 random (ranges, speed, threshold) draws."""
    c, dist = pttc.ttc_tables(90, FOV, CAR, "cpu")
    c_o, dist_o = odyn.ttc_tables(90, FOV, CAR)
    hits = 0
    for _ in range(50):
        ranges = rng.uniform(0.1, 10.0, 90)
        v, thr = float(rng.uniform(-7, 7)), float(rng.uniform(0.005, 0.5))
        got = bool(pttc.check_ttc(
            torch.tensor(ranges, dtype=torch.float32)[None],
            torch.tensor([v], dtype=torch.float32), c, dist, thr)[0])
        assert got == odyn.check_ttc(ranges, v, c_o, dist_o, thr), (v, thr)
        hits += got
    assert 0 < hits < 50


# -- utils.viz -------------------------------------------------------------

def test_viz_renders_tensors(tmp_path):
    pytest.importorskip("matplotlib")
    from pyracecarsimulator_tpu_torch.parallel.dryrun import tiny_occupancy
    track = ploader.build_track_map(tiny_occupancy(), 0.05, (-4.8, -4.8),
                                    device="cpu")
    poses = torch.tensor([[-3.5, -3.5, 0.0], [3.5, 3.0, 1.0]])
    scans = torch.full((2, 16), 2.0)
    traj = torch.zeros(5, 2, 3)
    out = viz.render(track, poses, scans, traj, path=str(tmp_path / "v.png"))
    assert os.path.getsize(out) > 1000
