"""The port's native host tier (``_native/loader.py`` over
``csrc/racecar_native.cpp``) against its NumPy bodies and against the JAX
package's loader, on the same seeded inputs.

Tolerances, as ``tests/test_native.py`` states them: the EDT within 1e-4
cells of scipy and bit for bit equal to the JAX package's native EDT and
to the port's NumPy body; sector membership entry for entry; extracted
segments as a set after rounding to 9 digits; the segment raycast within
1e-9 m; the EDF march within 1e-6 m. Maps built with the native bodies
equal those built with the NumPy bodies forced, tensor for tensor.
"""

import os
import stat

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyracecarsimulator_tpu._native import loader as jnat

from pyracecarsimulator_tpu_torch._native import loader as nat
from pyracecarsimulator_tpu_torch.maps import edt as edt_fn, edt_numpy
from pyracecarsimulator_tpu_torch.maps import loader as ploader
from pyracecarsimulator_tpu_torch.maps import sectors as psec
from pyracecarsimulator_tpu_torch.maps import segments as pseg
from pyracecarsimulator_tpu_torch.oracle import raycast as porc

pytestmark = pytest.mark.skipif(
    nat.compiler() is None, reason="no C++ compiler on PATH")


def _jax_native():
    if not jnat.available():
        pytest.skip("the JAX package's native library is unavailable")
    return jnat


def _track_args(t):
    occ = np.asarray(t.occupancy)[: t.height, : t.width]
    return occ, t.resolution, (t.origin_x, t.origin_y)


def _membership_args(t, tile_size=2.0, ns=16):
    occ, res, org = _track_args(t)
    segs = pseg.extract_segments(occ, res, org)
    nr = int(np.ceil(occ.shape[0] * res / tile_size))
    nc = int(np.ceil(occ.shape[1] * res / tile_size))
    rt = tile_size * np.sqrt(2.0) / 2.0 + 2.0 * res
    return (segs, nr, nc, ns, tile_size, org[0], org[1], rt, 10.0 + rt,
            0.285)


def _rays(rng, n=64):
    th = rng.uniform(-np.pi, np.pi, n)
    return (rng.uniform(-3, 3, n), rng.uniform(-3, 3, n), np.cos(th),
            np.sin(th))


def _segment_set(segs):
    return set(map(tuple, np.round(segs, 9)))


def test_loader_has_its_counterparts_functions():
    for name in ("build", "available", "edt", "trace_rays",
                 "raycast_segments", "sector_membership",
                 "extract_segments"):
        assert callable(getattr(nat, name)) and callable(getattr(jnat, name))
    assert nat.available()


def test_library_is_built_from_the_ports_source_into_build_dir():
    path = nat.library_path()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(nat.__file__)))
    assert str(nat.SOURCE) == os.path.join(pkg, "csrc", "racecar_native.cpp")
    assert str(path.parent) == os.path.join(pkg, "_build")
    assert nat.available() and path.exists()
    assert not any(f.startswith("-march") for f in nat.CXX_FLAGS)
    assert {"-O3", "-fPIC", "-shared", "-std=c++17"} <= set(nat.CXX_FLAGS)


@pytest.mark.parametrize("against", ["scipy", "numpy_body", "jax_native"])
def test_edt(rng, against):
    occ = rng.rand(257, 129) < 0.01
    occ[0, 0] = True
    got = nat.edt(occ)
    assert got.dtype == np.float32
    if against == "scipy":
        ndimage = pytest.importorskip("scipy.ndimage")
        np.testing.assert_allclose(
            got, ndimage.distance_transform_edt(~occ), atol=1e-4)
    elif against == "numpy_body":
        np.testing.assert_array_equal(got, edt_numpy(occ))
    else:
        np.testing.assert_array_equal(got, _jax_native().edt(occ))


@pytest.mark.parametrize("against", ["numpy_body", "jax_native"])
@pytest.mark.parametrize("tile_size, ns", [(2.0, 16), (4.0, 8)])
def test_sector_membership(small_track, against, tile_size, ns):
    args = _membership_args(small_track, tile_size, ns)
    got = nat.sector_membership(*args)
    assert got.dtype == bool and got.shape == (args[1] * args[2] * ns,
                                               len(args[0]))
    if against == "numpy_body":
        with nat.numpy_only():
            ref = psec._membership(*args)
    else:
        ref = _jax_native().sector_membership(*args)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(psec._membership(*args), got)


@pytest.mark.parametrize("against", ["python_body", "jax_native"])
def test_extract_segments(rng, against):
    occ = rng.rand(64, 96) < 0.1
    got = nat.extract_segments(occ)
    if against == "python_body":
        ref = pseg.extract_segments(occ.astype(np.float32), 1.0, (0.0, 0.0))
    else:
        ref = _jax_native().extract_segments(occ)
    assert len(got) == len(ref) and _segment_set(got) == _segment_set(ref)


@pytest.mark.parametrize("against", ["numpy_body", "jax_native"])
def test_raycast_segments(small_track, rng, against):
    segs = pseg.extract_segments(*_track_args(small_track))
    xs, ys, cts, sts = _rays(rng)
    got = nat.raycast_segments(segs, xs, ys, cts, sts)
    if against == "numpy_body":
        ref = pseg.raycast_segments_numpy(segs, xs, ys, cts, sts, 10.0)
        np.testing.assert_allclose(got, ref, atol=1e-9)
    else:
        np.testing.assert_array_equal(
            got, _jax_native().raycast_segments(segs, xs, ys, cts, sts))
    assert (got < 10.0).mean() > 0.5


@pytest.mark.parametrize("against", ["python_body", "jax_native"])
def test_trace_rays(small_track, rng, against):
    t = small_track
    edf = np.asarray(t.edf)
    org = (t.origin_x, t.origin_y)
    bounds = (t.height, t.width)
    xs, ys, cts, sts = _rays(rng)
    got = nat.trace_rays(edf, bounds, t.resolution, org, xs, ys, cts, sts)
    if against == "python_body":
        ref = np.array([porc.trace_ray(edf, t.resolution, org, xs[i], ys[i],
                                       cts[i], sts[i], 10.0, 1e-4,
                                       bounds_hw=bounds)
                        for i in range(len(xs))])
        np.testing.assert_allclose(got, ref, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, _jax_native().trace_rays(
            edf, bounds, t.resolution, org, xs, ys, cts, sts))


def test_scan_batch_takes_the_native_body(small_track, rng):
    t = small_track
    edf = np.asarray(t.edf)
    org = (t.origin_x, t.origin_y)
    kw = dict(num_beams=32, bounds_hw=(t.height, t.width))
    poses = np.stack([rng.uniform(-3, 3, 4), rng.uniform(-3, 3, 4),
                      rng.uniform(-np.pi, np.pi, 4)], -1)
    before = nat.trace_rays.calls
    batch = porc.scan_batch(edf, t.resolution, org, poses, **kw)
    assert nat.trace_rays.calls == before + 1
    with nat.numpy_only():
        loop = porc.scan_batch(edf, t.resolution, org, poses, **kw)
    assert nat.trace_rays.calls == before + 1
    np.testing.assert_allclose(batch, loop, atol=1e-5)


def _build_track(t):
    occ, res, org = _track_args(t)
    m = ploader.build_track_map(occ, res, org, device="cpu")
    return [m.occupancy, m.edf]


def _build_sectors(t):
    occ, res, org = _track_args(t)
    m = psec.build_sector_map(occ, res, org, headroom=8, device="cpu")
    return [m.table, m.meta]


def _add_obstacle(t):
    occ, res, org = _track_args(t)
    with nat.numpy_only():      # the same starting map for both bodies
        m = ploader.build_track_map(occ, res, org, device="cpu")
    m2 = ploader.add_obstacle(m, 2.4, 0.3, size=0.4)
    assert not torch.equal(m2.edf, m.edf)
    return [m2.occupancy, m2.edf]


@pytest.mark.parametrize("build, counted", [
    (_build_track, "edt"), (_build_sectors, "sector_membership"),
    (_add_obstacle, "edt")], ids=["build_track_map", "build_sector_map",
                                  "add_obstacle"])
def test_native_and_numpy_bodies_build_the_same_tensors(small_track, build,
                                                        counted):
    fn = getattr(nat, counted)
    before = fn.calls
    native = build(small_track)
    assert fn.calls == before + 1
    with nat.numpy_only():
        plain = build(small_track)
    assert fn.calls == before + 1
    for a, b in zip(native, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("entry", ["edt", "trace_rays", "raycast_segments",
                                   "sector_membership", "extract_segments"])
def test_counters_move_only_for_the_native_body(small_track, rng, entry):
    segs = pseg.extract_segments(*_track_args(small_track))
    occ = np.asarray(small_track.occupancy) > 0.5
    calls = {
        "edt": lambda: nat.edt(occ),
        "trace_rays": lambda: nat.trace_rays(
            np.asarray(small_track.edf), occ.shape, 0.05, (-4.8, -4.8),
            *_rays(rng, 4)),
        "raycast_segments": lambda: nat.raycast_segments(segs,
                                                         *_rays(rng, 4)),
        "sector_membership": lambda: nat.sector_membership(
            *_membership_args(small_track)),
        "extract_segments": lambda: nat.extract_segments(occ),
    }
    fn = getattr(nat, entry)
    others = {k: v for k, v in nat.call_counts().items() if k != entry}
    before = fn.calls
    assert calls[entry]() is not None
    assert fn.calls == before + 1 == nat.call_counts()[entry]
    with nat.numpy_only():
        assert calls[entry]() is None and not nat.available()
    assert fn.calls == before + 1
    assert {k: v for k, v in nat.call_counts().items()
            if k != entry} == others


@pytest.fixture()
def fresh_loader(monkeypatch, tmp_path):
    """The loader as a new process finds it: nothing loaded, an empty build
    directory."""
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "BUILD_DIR", tmp_path / "_build")
    return nat


@pytest.mark.parametrize("call, match", [
    (lambda: nat.edt(np.ones((2, 3, 4), bool)), "occupied must be"),
    (lambda: nat.extract_segments(np.ones(5, bool)), "occ must be"),
    (lambda: nat.raycast_segments(np.zeros((3, 5)), [0.], [0.], [1.], [0.]),
     "segments must be"),
    (lambda: nat.sector_membership(np.zeros(4), 1, 1, 1, 1.0, 0, 0, 0.1,
                                   1.0, 0.1), "segments must be"),
    (lambda: nat.trace_rays(np.ones((8, 8), np.float32), (9, 8), 1.0,
                            (0, 0), [1.], [1.], [1.], [0.]), "bounds_hw"),
    (lambda: nat.trace_rays(np.ones((8, 8), np.float32), (8, 8), 1.0,
                            (0, 0), [[1.]], [1.], [1.], [0.]), "rays must")],
    ids=["edt", "extract_segments", "raycast_segments", "sector_membership",
         "trace_rays_bounds", "trace_rays_shape"])
def test_shapes_are_checked_before_the_pointers_cross(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_failing_compiler_raises_with_its_output(fresh_loader, monkeypatch,
                                                 tmp_path):
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'broken-cxx: cannot compile' >&2\n"
                   "exit 1\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CXX", str(cxx))
    for call in (fresh_loader.available,
                 lambda: fresh_loader.edt(np.ones((4, 4), bool)),
                 lambda: edt_fn(np.ones((4, 4), bool))):
        with pytest.raises(RuntimeError, match="broken-cxx: cannot compile"):
            call()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_without_a_compiler_the_numpy_bodies_run(fresh_loader, monkeypatch,
                                                 small_track):
    monkeypatch.setenv("CXX", "no-such-c++-compiler")
    assert fresh_loader.compiler() is None
    assert fresh_loader.build() is False and not fresh_loader.available()
    occ = np.asarray(small_track.occupancy) > 0.5
    before = fresh_loader.call_counts()
    assert fresh_loader.edt(occ) is None
    np.testing.assert_array_equal(edt_fn(occ, 0.05),
                                  edt_numpy(occ) * np.float32(0.05))
    args = _membership_args(small_track)
    assert psec._membership(*args).shape == (args[1] * args[2] * 16,
                                             len(args[0]))
    assert fresh_loader.call_counts() == before


def test_fresh_build_with_the_compiler_on_path(fresh_loader, rng):
    occ = rng.rand(33, 47) < 0.05
    occ[3, 3] = True
    assert fresh_loader.available()
    assert fresh_loader.library_path().exists()
    assert fresh_loader.build_info["path"] == str(
        fresh_loader.library_path())
    np.testing.assert_array_equal(fresh_loader.edt(occ), edt_numpy(occ))
