"""The port's tools beside the package, on the CPU at small sizes:
``scripts/parity_report_torch.py``, ``bench_torch.py`` and
``scripts/sweep_geometry_torch.py`` through their ``main([...])``, each
against the JAX package's counterpart.

Tolerances. The parity report's rows are statistics (mean, p99, max) of
|backend - oracle| over 4 poses x 90 beams on levine; the same statistics
are computed here through the JAX functions as ``scripts/parity_report.py``
computes them (its Pallas rows in interpret mode). Rows of exact geometry,
the simplified geometry included, agree within 1e-4 m. The march rows
("edf march", "edf implicit") may differ on a few beams by up to 3 cells
(XLA's CPU code fuses the march's position update, ROADMAP.md fault 6): the
mean within 1e-3 m, p99 and max within 3 cells. Gradient rows are max|d|
against the dense analytic VJP and lie under 1e-5 on both sides.
"""

import ast
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
FOV = 4.712388980384690
NEW_FILES = ("bench_torch.py", "scripts/parity_report_torch.py",
             "scripts/sweep_geometry_torch.py",
             "scripts/profile_torch_step.py", "chip_smoke.py")

# every key bench_torch.py reports, as bench.py's stages name them
BENCH_RATES = (
    [f"{m}{mid}_{end}" for m in ("levine", "berlin")
     for mid in ("", "_pallas", "_sector", "_sector_pallas")
     for end in ("fwd", "fwdbwd")]
    + [f"berlin_sector_{mid}_{end}" for mid in ("sorted", "fused")
       for end in ("fwd", "fwdbwd")]
    + ["levine_1024_fwd", "berlin_simplified_fwd", "berlin_simplified_fwdbwd",
       "levine_dmap_fwdbwd", "levine_dmap_implicit_fwdbwd",
       "levine_dmap_hybrid_fwdbwd", "levine_dmap_hybrid_dedup_fwdbwd",
       "env_steps_s_4096", "env_steps_s_4096_sectors",
       "env_steps_s_4096_sectors_berlin", "train_steps_s_levine",
       "train_rays_s_levine", "train_steps_s_berlin", "train_rays_s_berlin",
       "multitrack_fwdbwd", "ring_1dev_rays_s", "sharded_step_1dev_rays_s"]
    # the eager twins of the paths that replay as CUDA graphs on the card
    + ["env_steps_s_4096_eager", "env_steps_s_4096_sectors_eager",
       "env_steps_s_4096_sectors_berlin_eager", "train_steps_s_levine_eager",
       "train_steps_s_berlin_eager"])
BENCH_GATES = ("levine_sector_parity_maxabs", "berlin_sector_parity_maxabs",
               "multitrack_parity_maxabs", "ring_parity_maxabs",
               "rollout_graph_parity_maxabs")


def _load(rel):
    name = os.path.splitext(os.path.basename(rel))[0]
    spec = importlib.util.spec_from_file_location(f"tool_{name}",
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- (a) the parity report --------------------------------------------------

def _jax_report(n_poses, beams):
    """``scripts/parity_report.py``'s rows on levine, computed here:
    {backend: |r - oracle|}, and the two gradient maxima."""
    import importlib
    from pyracecarsimulator_tpu.maps import load_builtin, sample_free_poses
    from pyracecarsimulator_tpu.maps.contours import (
        build_general_segment_map)
    from pyracecarsimulator_tpu.maps.sectors import build_sector_map
    from pyracecarsimulator_tpu.maps.segments import (
        build_segment_map, extract_segments, pad_segments,
        raycast_segments_numpy)
    from pyracecarsimulator_tpu.ops.common import rays_from_poses
    from pyracecarsimulator_tpu.ops.raycast_general import scan_poses_general
    from pyracecarsimulator_tpu.ops.raycast_grad import raycast_all_diff
    from pyracecarsimulator_tpu.ops.raycast_sectors import (
        raycast_sectors, scan_poses_sectors)
    from pyracecarsimulator_tpu.ops.raycast_segments import (
        scan_poses_segments)
    from pyracecarsimulator_tpu.ops.raymarch_diff import scan_poses_implicit
    from pyracecarsimulator_tpu.ops.raymarch_xla import scan_poses
    from pyracecarsimulator_tpu.oracle.raycast import scan_batch
    rp = importlib.import_module("pyracecarsimulator_tpu.ops.raycast_pallas")

    t = load_builtin("levine")
    org = (t.origin_x, t.origin_y)
    bounds = (t.height, t.width)
    occ = np.asarray(t.occupancy)
    poses = sample_free_poses(t, n_poses, np.random.RandomState(0))
    jp = jnp.asarray(poses)
    segs = pad_segments(extract_segments(occ, t.resolution, org))

    def geometry(num_beams):
        _, p2, xb, yb, ct, st = rays_from_poses(jp, num_beams, FOV)
        o = raycast_segments_numpy(
            segs, *(np.asarray(v).ravel() for v in (xb, yb, ct, st)),
            10.0).reshape(n_poses, num_beams)
        return o, (p2, xb, yb, ct, st)

    o_march = scan_batch(np.asarray(t.edf), t.resolution, org, poses,
                         num_beams=beams, bounds_hw=bounds)
    o_geom, (p2, xb, yb, ct, st) = geometry(beams)
    o_1080, _ = geometry(1080)
    kw = dict(max_range=10.0, real_hw=bounds)
    sm = build_segment_map(occ, t.resolution, org, tile_size=4.0, **kw)
    gm = build_general_segment_map(occ, t.resolution, org, tol_cells=1.0,
                                   tile_size=4.0, **kw)
    smap = build_sector_map(occ, t.resolution, org, tile_size=2.0, ns=16,
                            **kw)
    rows = {
        "edf march": (scan_poses(
            t.edf, t.resolution, jnp.asarray(org), jp, num_beams=beams,
            max_iters=200, bounds_hw=bounds), o_march),
        "segments exact": (scan_poses_segments(sm, jp, num_beams=beams),
                           o_geom),
        "segments exact (dense kernel)": (rp.raycast_pallas(
            sm.params, sm.sweep_meta, xb, yb, ct, st, 10.0, True), o_geom),
        "sectors exact": (scan_poses_sectors(smap, jp, num_beams=beams),
                          o_geom),
        "simplified tol=1": (scan_poses_general(gm, jp, num_beams=beams),
                             o_geom),
        "edf implicit": (scan_poses_implicit(
            t.edf, t.resolution, jnp.asarray(org), jp, num_beams=beams,
            max_iters=256, bounds_hw=bounds), o_geom),
        "sectors exact (grouped route, 1080b)": (scan_poses_sectors(
            smap, jp, num_beams=1080, use_pallas=True, interpret=True),
            o_1080),
        "segments exact (dense/tiled kernel, 1080b)": (rp.scan_poses_pallas(
            sm, jp, num_beams=1080, interpret=True), o_1080),
        "sectors exact (sorted-tile route, 1080b)": (scan_poses_sectors(
            smap, jp, num_beams=1080, mode="sorted_pl@128", interpret=True),
            o_1080),
        # levine's capacity is under 112, so the JAX map carries no
        # ``table_ck`` and its report has no fused row: the port's fused
        # route is the same list kernel, held to the JAX default scan
        "sectors exact (fused route, 1080b)": (scan_poses_sectors(
            smap, jp, num_beams=1080), o_1080),
        "DT-march oracle": (o_march, o_geom),
    }
    diffs = {k: np.abs(np.asarray(r) - o) for k, (r, o) in rows.items()}

    def g_of(fn):
        return np.stack([np.asarray(a) for a in jax.grad(
            lambda *rays: jnp.sum(fn(*rays)), argnums=(0, 1, 2, 3))(
                xb, yb, ct, st)])

    g_ref = g_of(lambda *r: raycast_all_diff(sm.params, *r, 10.0, 1024,
                                             sm.kv))
    bb = max(1, min(128, 2 * int(smap.block_half / (FOV / (beams - 1)))))
    g_sec = g_of(lambda *r: raycast_sectors(
        smap.table, smap.meta, smap.tiles_shape, smap.tile_size,
        smap.tile_origin, smap.ns, smap.kv_sec, p2[:, 0], p2[:, 1], *r,
        10.0, bb, 64, False, False))
    g_pal = g_of(lambda *r: rp.raycast_pallas(sm.params, sm.sweep_meta, *r,
                                              10.0, True))
    return diffs, (float(np.abs(g_sec - g_ref).max()),
                   float(np.abs(g_pal - g_ref).max()))


def test_parity_report_matches_jax_report(capsys, tmp_path):
    tool = _load("scripts/parity_report_torch.py")
    md = tmp_path / "PARITY_TORCH.md"
    out = tool.main(["--maps", "levine", "--poses", "4", "--beams", "90",
                     "--device", "cpu", "--write", str(md)])
    printed = capsys.readouterr().out
    assert out["device"] == "cpu" and "device: cpu" in printed
    diffs, grads = _jax_report(4, 90)
    rows = {r["backend"]: r for r in out["rows"]}
    # the JAX report's rows in its order, its XLA-only sorted row left out
    assert list(rows) == list(diffs)
    cell = 0.05
    for name, d in diffs.items():
        r = rows[name]
        assert r["map"] == "levine" and name in printed
        ref = (float(d.mean()), float(np.quantile(d, 0.99)), float(d.max()))
        got = (r["mean"], r["p99"], r["max"])
        if name in ("edf march", "edf implicit"):
            tol = (1e-3, 3 * cell, 3 * cell)
        else:
            tol = (1e-4,) * 3
        for g, f, t in zip(got, ref, tol):
            assert abs(g - f) <= t, (name, got, ref)
        assert r["launches"] == {}              # the CPU launches no kernel
    # the exact rows meet the JAX report's own gate against the oracle
    for name in ("segments exact", "segments exact (dense kernel)",
                 "sectors exact", "sectors exact (grouped route, 1080b)",
                 "segments exact (dense/tiled kernel, 1080b)",
                 "sectors exact (sorted-tile route, 1080b)",
                 "sectors exact (fused route, 1080b)"):
        assert rows[name]["share_within_1e-4"] >= 0.999 and rows[name]["kernel"]
    assert rows["edf march"]["share_within_1e-3"] >= 0.99
    for g, ref in zip(out["grads"], grads):
        assert g["max_abs_diff"] <= 1e-5 and ref <= 1e-5
    text = md.read_text()
    assert "device: cpu" in text and "parity_report_torch.py --maps levine" \
        in text and "| levine | sectors exact |" in text


def test_tools_need_a_card_or_the_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    for rel, argv in (("scripts/parity_report_torch.py", ["--poses", "2"]),
                      ("bench_torch.py", ["--agents", "8"])):
        with pytest.raises(SystemExit) as e:
            _load(rel).main(argv)
        assert e.value.code not in (0, None)
        assert 'device="cpu"' in str(e.value.code)


# -- (b) bench_torch.py -----------------------------------------------------

@pytest.fixture(scope="module")
def bench():
    return _load("bench_torch.py")


def test_bench_every_key_and_gate(bench, capsys, tmp_path):
    detail = tmp_path / "detail.json"
    out = bench.main(["--device", "cpu", "--agents", "8", "--train-T", "2",
                      "--reps", "1", "--loops", "2", "--detail", str(detail)])
    assert out["failed"] == []
    assert sorted(out["rates"]) == sorted(BENCH_RATES)
    assert all(np.isfinite(v) and v > 0 for v in out["rates"].values())
    assert out["gates"] == {k: 0.0 for k in BENCH_GATES}
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and len(lines[0]) < 1500     # the one stdout line
    line = json.loads(lines[0])
    assert set(line) == {"device", "agents", "beams", "rates", "gates",
                         "detail"}
    assert line["device"] == "cpu" and line["agents"] == 8
    assert set(line["rates"]) == set(bench.LINE_KEYS)
    assert line["gates"] == out["gates"]
    record = json.loads(detail.read_text())
    assert record["device"] == "cpu" and record["rates"] == out["rates"]
    t = record["timing"]["berlin_sector_fwdbwd"]
    assert len(t["loops_ms"]) == 2 and t["kernel"] == "list_sweep"
    assert t["launches"] == {}                  # the CPU launches no kernel
    assert record["timing"]["train_steps_s_berlin"]["work"] == 8 * 2


def test_bench_only_runs_a_subset(bench, capsys, tmp_path):
    out = bench.main(["--device", "cpu", "--agents", "8", "--reps", "1",
                      "--loops", "1", "--train-T", "2", "--only",
                      "train_rays_s_levine,levine_sector_parity_maxabs",
                      "--detail", str(tmp_path / "d.json")])
    assert out["failed"] == []
    assert set(out["rates"]) == {"train_steps_s_levine",
                                 "train_rays_s_levine"}
    assert out["gates"] == {"levine_sector_parity_maxabs": 0.0}
    assert out["rates"]["train_rays_s_levine"] == pytest.approx(
        1080 * out["rates"]["train_steps_s_levine"], rel=1e-3)
    capsys.readouterr()


def test_bench_bundles_are_build_sims(bench):
    """The bench shares one map build per track among its stages; what it
    steps is what ``build_sim`` would hand a user."""
    import pyracecarsimulator_tpu_torch as P
    b = bench.Bench(torch.device("cpu"), 8, 1, 1, 2, set())
    for backend, fields in (("sectors", ("table", "meta")),
                            ("segments", ("params", "sweep_meta"))):
        got = b.bundle("levine", backend, smooth=True)
        ref = P.build_sim("levine", backend=backend, device="cpu",
                          scan=P.ScanParams(num_beams=1080),
                          sim=P.SimParams(steer_mode="smooth"))
        assert got._replace(track=None, segmap=None) == \
            ref._replace(track=None, segmap=None)
        for f in fields:
            assert torch.equal(getattr(got.segmap, f), getattr(ref.segmap, f))
        assert torch.equal(got.track.edf, ref.track.edf)


def test_bench_names_a_failed_stage(bench, capsys, tmp_path, monkeypatch):
    def boom(b):
        raise RuntimeError("made to fail")
    monkeypatch.setattr(bench, "stage_levine_1024", boom)
    argv = ["--device", "cpu", "--agents", "8", "--reps", "1", "--loops",
            "1", "--only", "levine_1024_fwd,levine_fwd", "--detail",
            str(tmp_path / "d.json")]
    assert bench.cli(argv) == 1
    cap = capsys.readouterr()
    assert "FAILED: levine_1024" in cap.err and "made to fail" in cap.err
    line = json.loads(cap.out.strip().splitlines()[-1])
    assert set(line["rates"]) == {"levine_fwd"}     # the other stage still ran
    # a gate that is not 0.0 is a failure too
    monkeypatch.undo()
    b = bench.Bench(torch.device("cpu"), 8, 1, 1, 2, set())
    b.gate("ring_parity_maxabs", 1e-6)
    assert b.failed == ["ring_parity_maxabs"]


# -- (c) the geometry sweep -------------------------------------------------

@pytest.mark.parametrize("combo", ["16:2.0:0.285", "32:1.0:0.025"])
def test_sweep_geometry_matches_jax_arithmetic(small_track, combo):
    """``table_stats`` on the port's sector map of ``small_track`` against
    ``scripts/sweep_geometry.py``'s arithmetic on the JAX map."""
    from pyracecarsimulator_tpu.maps.sectors import (build_sector_map as
                                                     jax_build)
    from pyracecarsimulator_tpu_torch.maps import build_sector_map
    tool = _load("scripts/sweep_geometry_torch.py")
    t = small_track
    ns, ts, bh = combo.split(":")
    ns, ts, bh = int(ns), float(ts), float(bh)
    args = (np.asarray(t.occupancy), t.resolution, (t.origin_x, t.origin_y))
    kw = dict(max_range=10.0, tile_size=ts, ns=ns, block_half=bh,
              real_hw=(t.height, t.width))
    rng = np.random.RandomState(0)
    a_n, b_n = 64, 1080
    X = rng.uniform(-4.0, 4.0, a_n).astype(np.float32)
    Y = rng.uniform(-4.0, 4.0, a_n).astype(np.float32)
    TH = rng.uniform(-np.pi, np.pi, a_n).astype(np.float32)
    got = tool.table_stats(build_sector_map(*args, **kw, device="cpu"),
                           X, Y, TH)

    smap = jax_build(*args, **kw)       # scripts/sweep_geometry.py:64-85
    meta = np.asarray(smap.meta)
    real = meta[:, 0] + (meta[:, 2] - meta[:, 1])
    spacing = (4.712388980384690 / (b_n - 1))
    bb = max(1, min(128, 2 * int(bh / spacing)))
    nblk = -(-b_n // bb)
    nr, nc = smap.tiles_shape
    tox, toy = smap.tile_origin
    ci = np.clip(((X - tox) / ts).astype(int), 0, nc - 1)
    ri = np.clip(((Y - toy) / ts).astype(int), 0, nr - 1)
    tid = ri * nc + ci
    offs = (np.arange(b_n) - (b_n - 1) / 2.0) * spacing
    mids = np.minimum(np.arange(nblk) * bb + bb // 2, b_n - 1)
    th = np.mod(TH[:, None] + offs[None, mids], 2 * np.pi)
    sec = np.clip((th * (ns / (2 * np.pi))).astype(int), 0, ns - 1)
    n_of = real[(tid[:, None] * ns + sec).reshape(-1)]
    assert got["K"] == smap.table.shape[2] and got["kv"] == smap.kv_sec
    assert got["bb"] == bb
    assert got["real_mean"] == float(real.mean())
    assert got["real_max"] == int(real.max())
    assert got["visited_mean"] == float(n_of.mean())
    assert got["visited_max"] == int(n_of.max())
    assert got["table_mb"] == np.asarray(smap.table).nbytes / 1e6


def test_sweep_geometry_main_on_a_bundled_map(capsys):
    tool = _load("scripts/sweep_geometry_torch.py")
    rows = tool.main(["levine", "16:2.0:0.285"])
    assert [r["combo"] for r in rows] == ["16:2.0:0.285"]
    assert rows[0]["K"] == 32 and rows[0]["bb"] == 128
    printed = capsys.readouterr().out
    assert "nothing runs on a card" in printed and "K=  32" in printed


# -- (d) what the port imports ----------------------------------------------

def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_tools_import_no_jax():
    """Neither a module of the port, nor a tool or demo beside it, imports
    JAX or the JAX package."""
    files = [os.path.join(ROOT, f) for f in NEW_FILES]
    for top in ("pyracecarsimulator_tpu_torch", "examples/torch"):
        for d, _, names in os.walk(os.path.join(ROOT, top)):
            files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 50
    banned = ("jax", "jaxlib", "flax", "optax", "orbax",
              "pyracecarsimulator_tpu")
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in banned, (path, mod)
