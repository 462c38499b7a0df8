"""The benchmark's ``levine-segments.rollout`` cell on the CPU at a small
size: levine's real map, compiled as ``build_sim`` compiles it for the
default "segments" backend (untiled: the dense route), driven through the
benchmark's harness and held by the cell's own limits to the ``exact``
reference of ``benchmark/reference/`` (plain PyTorch, float64)."""

import json
import os
import shutil
import sys
import time

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.core import harness, spec  # noqa: E402

CELL = "levine-segments.rollout"


def _small_copy(tmp_path, agents=32, horizon=3):
    """The benchmark with levine's real map, the configuration cut to
    ``agents`` cars and the mix to ``horizon`` steps and one checked call
    a run."""
    root = tmp_path / "root"
    bench = root / "benchmark"
    for sub in ("configs", "traffic", "limits", "kernels", "metrics",
                "modes", "maps"):
        shutil.copytree(os.path.join(spec.BENCH_DIR, sub), bench / sub,
                        ignore=shutil.ignore_patterns("__pycache__",
                                                      "berlin.*"))
    cfg = spec.config("levine-segments")
    cfg["agents"] = agents
    (bench / "configs" / "levine-segments.json").write_text(json.dumps(cfg))
    mix = spec.traffic("rollout")
    mix.update(horizon=horizon, check_calls=1)
    (bench / "traffic" / "rollout.json").write_text(json.dumps(mix))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root)
    return str(root), str(bench)


def test_the_dense_scan_agrees_with_the_exact_reference(tmp_path):
    """A whole run of the cell on the CPU at 32 cars x 1080 beams and 3
    steps a call on the real map, under the cell's own limits: correct,
    every range, pose and latch as the reference's, and the port's dense
    counter at exactly the map's 82 pairs a ray over the run."""
    from pyracecarsimulator_tpu_torch.utils import profiling
    torch.set_num_threads(2)
    root, bench_dir = _small_copy(tmp_path)
    bench = spec.benchmark(root)
    before = profiling.counters()["dense"]
    result, rows = harness.run_cell(bench, spec.cell(bench, CELL),
                                    2 ** 33 + 5, 0.2, False, "cpu",
                                    time.perf_counter(), bench_dir=bench_dir)
    assert result["correct"], rows
    got = {name: value for name, value, _ in rows}
    assert got["range_off_share"] <= spec.limits(CELL)["range_off_share"]
    assert got["pose_off_share"] == 0 and got["latch_off_share"] == 0
    after = profiling.counters()["dense"]
    rays = after["rays"] - before["rays"]
    assert rays > 0 and after["pairs"] - before["pairs"] == 82 * rays
