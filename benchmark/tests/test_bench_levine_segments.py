"""The ``levine-segments`` configuration: the file loads through the
registry as a deployment with nothing cut, and its backend compiles
levine's map untiled (the dense route). The cell's run against the
``exact`` reference on the CPU is in ``tests/test_torch_levine_segments.py``
and the reader of ``dense_pairs_per_ray`` in
``tests/test_torch_sweep_counts.py``."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.core import spec  # noqa: E402

CELL = "levine-segments.rollout"


def test_the_configuration_is_the_default_backend_untiled():
    bench = spec.benchmark()
    entry = next(c for c in bench["configs"]
                 if c["name"] == "levine-segments")
    assert entry["reduced"] == []
    cfg = spec.config("levine-segments")
    assert (cfg["backend"], cfg["reference_scan"]) == ("segments", "exact")
    assert cfg["agents"] == 4096 and cfg["scan"]["num_beams"] == 1080
    assert spec.cell(bench, CELL)["config"] == "levine-segments"
    from benchmark.core.sides import Program
    from benchmark.reference.maps import load_map
    grid = load_map(os.path.join(spec.BENCH_DIR, cfg["map"]))
    side = Program(grid, cfg, "bang", "cpu")
    segmap = side.bundle.segmap
    assert side.bundle.backend == "segments"
    assert segmap.tiles is None and segmap.n_segments == 82
    assert segmap.sweep_meta.tolist() == [41, 41, 82]
