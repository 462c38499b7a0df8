"""The benchmark's ``berlin-segments_simplified.bptt`` cell on the CPU at a
small size: berlin's real map, compiled as ``build_sim`` compiles it for
the "segments_simplified" backend (533 simplified segments in 4 m tiles),
trained through the benchmark's harness and held by the cell's own limits
to the ``simplified`` reference scan of ``benchmark/reference/`` (plain
PyTorch, float64)."""

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

CELL = "berlin-segments_simplified.bptt"
CONFIG = "berlin-segments_simplified"


def _small_copy(tmp_path, agents=32, horizon=3):
    """The benchmark with berlin's real map, the configuration cut to
    ``agents`` cars and the mix to ``horizon`` steps and one checked call
    a run."""
    root = tmp_path / "root"
    bench = root / "benchmark"
    for sub in ("configs", "traffic", "limits", "kernels", "metrics",
                "modes", "maps"):
        shutil.copytree(os.path.join(spec.BENCH_DIR, sub), bench / sub,
                        ignore=shutil.ignore_patterns("__pycache__",
                                                      "levine.*"))
    cfg = spec.config(CONFIG)
    cfg["agents"] = agents
    (bench / "configs" / f"{CONFIG}.json").write_text(json.dumps(cfg))
    mix = spec.traffic("bptt")
    mix.update(horizon=horizon, check_calls=1)
    (bench / "traffic" / "bptt.json").write_text(json.dumps(mix))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root)
    return str(root), str(bench)


def test_the_general_sweep_trains_as_the_simplified_reference(tmp_path):
    """A whole run of the cell on the CPU at 32 cars x 1080 beams and 3
    steps a call on the real map, under the cell's own limits: correct,
    and the port's general counter at exactly each ray's tile list up to
    its last real slot, summed over the run."""
    from pyracecarsimulator_tpu_torch.ops import raycast_general as rg
    from pyracecarsimulator_tpu_torch.utils import profiling
    torch.set_num_threads(2)
    root, bench_dir = _small_copy(tmp_path)
    bench = spec.benchmark(root)
    seen = []
    sweep = rg.general_sweep_plain

    def counted(table, ids, x, y, cos_t, sin_t, winner):
        real = torch.where(table[:, 4] >= 0.0,
                           torch.arange(1, table.shape[2] + 1), 0).amax(1)
        rows = ids.long() if ids is not None else torch.zeros(
            x.shape[0], dtype=torch.long)
        cols = torch.broadcast_tensors(x, y, cos_t, sin_t)[0].shape[-1]
        seen.append((rows.numel() * cols, int(real[rows].sum()) * cols))
        return sweep(table, ids, x, y, cos_t, sin_t, winner)

    before = profiling.counters()["general"]
    rg.general_sweep_plain = counted
    try:
        result, rows = harness.run_cell(bench, spec.cell(bench, CELL),
                                        2 ** 33 + 11, 0.2, False, "cpu",
                                        time.perf_counter(),
                                        bench_dir=bench_dir)
    finally:
        rg.general_sweep_plain = sweep
    assert result["correct"], rows
    after = profiling.counters()["general"]
    rays = after["rays"] - before["rays"]
    pairs = after["pairs"] - before["pairs"]
    assert seen and rays == sum(r for r, _ in seen)
    assert pairs == sum(p for _, p in seen)
    assert 0 < pairs <= 146 * rays
