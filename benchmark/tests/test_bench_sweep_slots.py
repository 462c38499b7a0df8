"""The reader of ``sweep_slots_per_ray``: the port's list-sweep counter
(``counters()["sweep"]``) read from the module already loaded in the
process, slots over rows; None where the port has no such counter (a
program before it) or no row was swept, so that a traced run of such a
program leaves the metric out."""

import os
import sys
import types

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.core import spec  # noqa: E402

READ = spec.metric_reader("sweep_slots_per_ray.rollout")
PORT = "pyracecarsimulator_tpu_torch.utils.profiling"


def _port(monkeypatch, counters):
    mod = types.ModuleType(PORT)
    if counters is not None:
        mod.counters = lambda: counters
    monkeypatch.setitem(sys.modules, PORT, mod)


@pytest.mark.parametrize("counters", [
    None,                                           # no counters() at all
    {"launches": {}, "graphs": [], "march": {"calls": 0, "trips": 0}},
    {"sweep": {"rows": 0, "slots": 0}}])
def test_no_counter_or_no_row_reads_none(monkeypatch, counters):
    _port(monkeypatch, counters)
    assert READ({"trace": None, "spans": {}}) is None


def test_no_port_loaded_reads_none(monkeypatch):
    monkeypatch.delitem(sys.modules, PORT, raising=False)
    assert READ({"trace": None, "spans": {}}) is None


def test_slots_over_rows(monkeypatch):
    _port(monkeypatch, {"sweep": {"rows": 36864, "slots": 36864 * 198 + 5}})
    assert READ({"trace": None, "spans": {}}) == pytest.approx(
        198 + 5 / 36864, rel=1e-15)


def test_the_port_counts_what_its_scans_swept():
    """On the port itself, after a sector scan on the CPU: the plain
    sweep's host count, slots over rows."""
    torch = pytest.importorskip("torch")
    import pyracecarsimulator_tpu_torch as P
    from pyracecarsimulator_tpu_torch.ops import sweeps
    from pyracecarsimulator_tpu_torch.utils import profiling  # noqa: F401
    bundle = P.build_sim("levine", backend="sectors",
                         scan=P.ScanParams(num_beams=256), device="cpu")
    scan = P.make_scan_fn(bundle)
    scan(torch.tensor([[7.0, 4.0, 0.3], [6.0, 4.0, -1.0]]))
    counts = dict(sweeps.SWEEP_COUNTS)
    assert counts["rows"] > 0
    assert READ({"trace": None, "spans": {}}) == counts["slots"] / \
        counts["rows"]
