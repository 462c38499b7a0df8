"""The ``dense_fanned_share.rollout`` metric: registered for the
``levine-segments.rollout`` cell only, found by name, and reading the
port's dense counter: 1 after scans of poses without a gradient on an
untiled map, None where the port's dense counter has no ``fanned`` column
(a program before the dense kernel's entry from poses). The reader's
cases against stand-in counters are in ``tests/test_torch_dense_scan.py``."""

import os
import sys
import types

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.core import spec  # noqa: E402

NAME = "dense_fanned_share.rollout"
CELL = "levine-segments.rollout"
PORT = "pyracecarsimulator_tpu_torch.utils.profiling"


def test_the_metric_is_the_levine_segments_cells():
    bench = spec.benchmark()
    entry = next(m for m in bench["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == [CELL]
    assert (entry["layer"], entry["moves"], entry["source"]) == (
        "Scan kernels", "env_steps_s", "program_counter")
    assert NAME in [m["name"] for m in spec.metrics_of(bench, "per_layer",
                                                       CELL)]
    for w in bench["workloads"]:
        if w["name"] != CELL:
            assert NAME not in [m["name"] for m in spec.metrics_of(
                bench, "per_layer", w["name"])]


def test_the_reader_reads_one_on_the_port_and_none_before_it(monkeypatch):
    torch = pytest.importorskip("torch")
    import pyracecarsimulator_tpu_torch as P
    from pyracecarsimulator_tpu_torch.ops import raycast_segments as rseg
    from pyracecarsimulator_tpu_torch.utils import profiling
    read = spec.metric_reader(NAME)
    bundle = P.build_sim("levine", scan=P.ScanParams(num_beams=64),
                         device="cpu")
    poses = torch.tensor([[0.0, 0.0, 0.3], [1.0, -1.0, 2.0]])
    before = profiling.counters()["dense"]
    rseg.scan_poses_segments(bundle.segmap, poses, 64)
    after = profiling.counters()["dense"]
    assert after["fanned"] - before["fanned"] == 128
    assert read({"trace": None, "spans": {}}) == \
        after["fanned"] / after["rays"]
    old = types.ModuleType(PORT)
    old.counters = lambda: {"dense": {"rays": 128, "pairs": 128 * 82}}
    monkeypatch.setitem(sys.modules, PORT, old)
    assert read({"trace": None, "spans": {}}) is None
