"""The dense kernel's entry from poses (``ops/sweeps.dense_scan``), on the CPU.

A scan of poses on an untiled map whose rays take no gradient, on the
exact fan, hands the dense kernel the agents' origins and headings' (cos,
sin) and the fan's per-beam (cos, sin): the kernel builds each ray, its
reciprocals, sweeps every real segment and writes the clamped,
extent-masked range (``csrc/dense_sweep.cu``). Its plain version, which CPU
tensors run, is the composition it replaces, so these tests hold the new
path to the old one bit for bit: on levine (82 segments) and on berlin
compiled untiled (4442 segments in a K = 4608 table, more than one chunk of
the kernel's shared memory), with an origin outside the map's extent, a
ragged agent count, 1080 beams and a small odd count, and headings at
which a beam's sine is exactly 0 (a NaN reciprocal). A scan whose poses
take a gradient, or on the theta table, keeps the rays-given path, values
and gradients; ``DENSE_COUNTS["fanned"]`` counts the rays built from poses
and no other; the graphed step on the new path captures without building a
tensor from host data. The card's side: ``tests/test_torch_kernels.py -k
dense``.
"""

import importlib
import importlib.util
import pathlib
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pyracecarsimulator_tpu_torch as P
from pyracecarsimulator_tpu_torch import simulator as psim
from pyracecarsimulator_tpu_torch.maps import load_builtin, sample_free_poses
from pyracecarsimulator_tpu_torch.maps.segments import build_segment_map
from pyracecarsimulator_tpu_torch.ops import common, sweeps
from pyracecarsimulator_tpu_torch.ops import raycast_segments as rseg
from pyracecarsimulator_tpu_torch.utils import profiling
from test_torch_list_scan import _WatchedCapture

FOV = 4.712388980384690
MAX_RANGE = 10.0
AGENTS = 37                 # not a multiple of a 256-ray block's agents


def _maps():
    """levine as ``build_sim`` compiles it by default (untiled) and berlin
    compiled untiled, each with its track."""
    out = {"levine": P.build_sim("levine", device="cpu")}
    berlin = load_builtin("berlin", device="cpu")
    occ = np.ascontiguousarray(
        berlin.occupancy.numpy()[: berlin.height, : berlin.width])
    flat = build_segment_map(occ, berlin.resolution,
                             (berlin.origin_x, berlin.origin_y),
                             max_range=MAX_RANGE, tile_size=0.0,
                             real_hw=occ.shape, device="cpu")
    out["berlin"] = types.SimpleNamespace(track=berlin, segmap=flat)
    return out


@pytest.fixture(scope="module")
def maps():
    out = _maps()
    assert out["levine"].segmap.tiles is None
    assert out["levine"].segmap.n_segments == 82
    assert out["berlin"].segmap.tiles is None
    assert out["berlin"].segmap.params.shape[1] > 1024
    return out


def _poses(bundle, n, beams, seed=3):
    """``n`` free poses: the first moved outside the map's extent, the
    second at heading exactly 0, the third turned so that beam
    ``beams // 3``'s rotated sine is exactly 0."""
    p = torch.as_tensor(sample_free_poses(bundle.track, n,
                                          np.random.RandomState(seed)))
    p[0, 0] = bundle.segmap.extent[1] + 0.5
    p[1, 2] = 0.0
    p[2, 2] = -common.beam_angles(beams, FOV, "cpu")[beams // 3]
    return p


def _todays_scan(m, p, beams):
    """The composition the entry replaces, as the scans ran it before: the
    exact fan, the reciprocals and flat rays through the rays-given sweep
    (``raycast_grad.raycast_all_diff``), the clamp and the extent mask."""
    with torch.no_grad():
        ct, st = common.fan_cos_sin(p[:, 2], common.beam_angles(beams, FOV,
                                                                "cpu"))
        return rseg._scan_rays(m, p, ct, st, beams, MAX_RANGE), st


@pytest.mark.parametrize("name, beams, agents", [
    ("levine", 1080, AGENTS), ("levine", 37, AGENTS), ("levine", 1080, 3),
    ("berlin", 1080, 5), ("berlin", 37, AGENTS)])
def test_dense_scan_is_todays_composition(maps, name, beams, agents):
    """The scan on the entry from poses equals today's composition bit
    for bit (the plain version is that composition); the origin outside
    the extent reads max_range on every beam; the rays whose sine is
    exactly 0 (an odd fan's middle beam at heading 0, a beam turned onto
    the axis) have a NaN reciprocal."""
    bundle = maps[name]
    m = bundle.segmap
    p = _poses(bundle, agents, beams)
    got = rseg.scan_poses_segments(m, p, beams, FOV, MAX_RANGE)
    ref, st = _todays_scan(m, p, beams)
    assert got.shape == (agents, beams)
    assert torch.equal(got, ref)
    assert bool((got[0] == MAX_RANGE).all())
    assert bool((got[1:] < MAX_RANGE).any())
    assert float(st[2, beams // 3]) == 0.0
    if beams % 2:
        assert float(st[1, beams // 2]) == 0.0
    assert bool(common._ray_invs(st, st)[1][2, beams // 3].isnan())


@pytest.mark.parametrize("name", ["levine", "berlin"])
def test_dense_scan_plain_is_the_wrapper_on_cpu(maps, name):
    """``dense_scan`` on CPU tensors is ``dense_scan_plain``, which is
    ``rotate_fan``, ``_ray_invs``, ``dense_sweep_plain`` on the flat rays,
    ``finish_minima`` and ``apply_extent_mask``; no kernel launches, and
    every ray is counted, with its pairs, as fanned."""
    bundle = maps[name]
    m = bundle.segmap
    p = _poses(bundle, 6, 1080)
    cd, sd = common.offset_factors(1080, FOV, 1, "cpu")
    assert cd.shape == (1080,)
    offs = common.beam_angles(1080, FOV, "cpu")
    assert torch.equal(cd, torch.cos(offs)) and torch.equal(sd,
                                                            torch.sin(offs))
    x0, y0 = p[:, 0].contiguous(), p[:, 1].contiguous()
    cth, sth = torch.cos(p[:, 2]), torch.sin(p[:, 2])
    args = (m.params, m.sweep_meta, x0, y0, cth, sth, cd, sd, MAX_RANGE,
            m.extent)
    launches = sweeps.launch_counts()
    before = dict(sweeps.DENSE_COUNTS.host)
    got = sweeps.dense_scan(*args)
    grown = {k: sweeps.DENSE_COUNTS.host[k] - before[k] for k in before}
    assert sweeps.launch_counts() == launches
    ct, st = common.rotate_fan(cth, sth, cd, sd)
    flat = lambda v: v.reshape(-1)
    bv, bh = sweeps.dense_sweep_plain(
        m.params, m.sweep_meta, flat(x0[:, None].expand(ct.shape)),
        flat(y0[:, None].expand(ct.shape)),
        *map(flat, (ct, st, *common._ray_invs(ct, st))))
    r = common.finish_minima(bv.reshape(ct.shape), bh.reshape(ct.shape),
                             MAX_RANGE)[0]
    assert torch.equal(got, common.apply_extent_mask(r, x0, y0, m.extent,
                                                     MAX_RANGE))
    assert grown == {"rays": 6 * 1080, "fanned": 6 * 1080,
                     "pairs": 6 * 1080 * m.n_segments}
    assert torch.equal(sweeps.dense_scan_plain(*args), got)


@pytest.mark.parametrize("name", ["levine", "berlin"])
def test_poses_that_take_a_gradient_keep_the_rays_given_path(
        maps, name, monkeypatch):
    """Poses that take a gradient, and the theta table, never reach
    ``dense_scan``: the values are the fused scan's, and the pose gradient
    is the analytic VJP's (``_WinnerRaycast``) through today's
    composition, bit for bit."""
    bundle = maps[name]
    m = bundle.segmap
    p = _poses(bundle, 5, 1080)
    fused = rseg.scan_poses_segments(m, p, 1080, FOV, MAX_RANGE)

    def refused(*a, **kw):
        raise AssertionError("dense_scan reached")
    monkeypatch.setattr(rseg, "dense_scan", refused)
    q = p.clone().requires_grad_(True)
    r = rseg.scan_poses_segments(m, q, 1080, FOV, MAX_RANGE)
    (r * r).sum().backward()
    assert torch.equal(r.detach(), fused)
    q2 = p.clone().requires_grad_(True)
    ct, st = common.fan_cos_sin(q2[:, 2], common.beam_angles(1080, FOV,
                                                             "cpu"))
    r2 = rseg._scan_rays(m, q2, ct, st, 1080, MAX_RANGE)
    (r2 * r2).sum().backward()
    assert torch.equal(q.grad, q2.grad) and bool(q.grad.abs().sum() > 0)
    table = rseg.scan_poses_segments(m, p, 1080, FOV, MAX_RANGE,
                                     theta_discretization=2000)
    assert table.shape == fused.shape


def test_fanned_counts_the_rays_built_from_poses_only(maps):
    """On levine a scan of poses without a gradient counts every ray as
    fanned; one whose poses take a gradient, one on the theta table and
    the rays-given sweep count none; every scan tests 82 pairs a ray."""
    bundle = maps["levine"]
    m = bundle.segmap
    p = _poses(bundle, 4, 1080)
    counts = sweeps.DENSE_COUNTS

    def grown(fn):
        before = dict(counts)
        fn()
        return {k: counts[k] - before[k] for k in before}

    scan = lambda q, **kw: rseg.scan_poses_segments(m, q, 1080, FOV,
                                                    MAX_RANGE, **kw)
    fused = grown(lambda: scan(p))
    assert fused == {"rays": 4 * 1080, "pairs": 82 * 4 * 1080,
                     "fanned": 4 * 1080}
    q = p.clone().requires_grad_(True)
    with_grad = grown(lambda: scan(q).sum().backward())
    assert with_grad == {**fused, "fanned": 0}
    table = grown(lambda: scan(p, theta_discretization=2000))
    assert table == {**fused, "fanned": 0}
    with torch.no_grad():
        no_grad = grown(lambda: scan(p.clone().requires_grad_(True)))
    assert no_grad == fused
    assert profiling.counters()["dense"] == dict(counts)


def test_dense_scan_refuses_other_devices():
    meta_dev = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="device"):
        sweeps.dense_scan(meta_dev(4, 128), meta_dev(3),
                          *(meta_dev(8) for _ in range(4)),
                          *(meta_dev(16) for _ in range(2)), MAX_RANGE,
                          (0.0, 1.0, 0.0, 1.0))


def test_graphed_levine_step_on_the_entry_from_poses_captures(maps,
                                                              monkeypatch):
    """``make_step_fn(..., graph=True)`` on levine's default bundle, on the
    entry from poses: the capture builds no tensor from host data and
    makes no scan constant, the replayed steps equal the eager ones, and
    every ray they sweep is fanned."""
    graph_mod = importlib.import_module(
        "pyracecarsimulator_tpu_torch.utils.graph")
    monkeypatch.setattr(graph_mod, "CudaGraphBackend", _WatchedCapture)
    monkeypatch.setattr(psim, "CudaGraphBackend", _WatchedCapture)
    bundle = maps["levine"]
    assert bundle.backend == "segments"
    q = _poses(bundle, 12, 1080)[1:]
    state = P.state_from_pose(q[:, 0], q[:, 1], q[:, 2])
    act = (torch.full((11,), 2.0), torch.zeros(11))
    eager = P.make_step_fn(bundle, with_noise=False)
    graphed = P.make_step_fn(bundle, with_noise=False, graph=True)
    _WatchedCapture.seen.clear()
    before = dict(sweeps.DENSE_COUNTS)
    se = sg = state
    for _ in range(3):
        oe, og = eager(se, act), graphed(sg, act)
        assert torch.equal(oe.ranges, og.ranges)
        se, sg = oe.state, og.state
    assert _WatchedCapture.seen == [([], 0)]
    grown = {k: sweeps.DENSE_COUNTS[k] - before[k] for k in before}
    assert grown["rays"] > 0 and grown["fanned"] == grown["rays"]
    assert grown["pairs"] == 82 * grown["rays"]


def _reader():
    """``read`` of the benchmark's ``dense_fanned_share`` metric."""
    path = (pathlib.Path(__file__).resolve().parents[1] / "benchmark"
            / "metrics" / "dense_fanned_share.py")
    spec = importlib.util.spec_from_file_location("dense_fanned_reader",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("counters, want", [
    (None, None),                                   # no counters() at all
    ({"sweep": {"rows": 9, "slots": 900}}, None),
    ({"dense": {"rays": 8, "pairs": 656}}, None),   # no fanned column
    ({"dense": {"rays": 0, "pairs": 0, "fanned": 0}}, None),
    ({"dense": {"rays": 4423680, "pairs": 4423680 * 82,
                "fanned": 4423680}}, 1.0),
    ({"dense": {"rays": 8, "pairs": 656, "fanned": 6}}, 0.75)])
def test_dense_fanned_reader_reads_fanned_over_rays(monkeypatch, counters,
                                                    want):
    """The benchmark's ``dense_fanned_share`` reads the port's fanned rays
    over its dense rays, and None where the port has no ``fanned`` column
    (a program before the dense entry from poses), no port is loaded, or
    no ray was swept."""
    read = _reader()
    mod = types.ModuleType(profiling.__name__)
    if counters is not None:
        mod.counters = lambda: counters
    monkeypatch.setitem(sys.modules, profiling.__name__, mod)
    assert read({"trace": None, "spans": {}}) == want
    monkeypatch.delitem(sys.modules, profiling.__name__)
    assert read({"trace": None, "spans": {}}) is None


def test_dense_fanned_reader_on_the_port(maps):
    """On the port itself, after a scan of poses on levine on the CPU: the
    counter's fanned rays over its rays."""
    bundle = maps["levine"]
    rseg.scan_poses_segments(bundle.segmap, _poses(bundle, 3, 1080), 1080,
                             FOV, MAX_RANGE)
    counts = dict(sweeps.DENSE_COUNTS)
    assert 0 < counts["fanned"] <= counts["rays"]
    assert _reader()({"trace": None, "spans": {}}) == \
        counts["fanned"] / counts["rays"]
