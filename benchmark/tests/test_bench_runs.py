"""Whole runs of each cell on the CPU, eagerly, at 64 agents x 180 beams on
a tiny track (``tiny.py``), under the cells' own limits: the program
agrees with the reference; the control (the reference in bfloat16 in the
program's place) and every fault the cells can have, planted in the
program underneath a run, come out not correct. The look for a card is
skipped (``harness.run_cell`` is called with ``device="cpu"``)."""

import os
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(os.path.dirname(HERE)), HERE]

import tiny  # noqa: E402
from benchmark.core import harness, spec  # noqa: E402
from benchmark.core.sides import Control  # noqa: E402

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
torch.set_num_threads(2)        # the tests run in several workers
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}
SEED = 2 ** 31 + 977


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    root, bench_dir = tiny.make(tmp_path_factory.mktemp("bench"))
    return spec.benchmark(root), bench_dir


def _run(tiny_bench, cell, **kw):
    bench, bench_dir = tiny_bench
    return harness.run_cell(bench, spec.cell(bench, cell), SEED, 0.5, False,
                            "cpu", time.perf_counter(), bench_dir=bench_dir,
                            **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_agrees_with_the_reference(tiny_bench, cell):
    result, rows = _run(tiny_bench, cell)
    assert set(result) == RESULT_KEYS
    assert result["correct"], rows
    assert result["attempted"] >= 1 and result["failed"] == 0
    e2e = [m["name"] for m in spec.metrics_of(tiny_bench[0], "end_to_end",
                                              cell)]
    assert sorted(result["metrics"]) == sorted(e2e)
    assert all(m["value"] > 0 for m in result["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny_bench, cell):
    result, rows = _run(tiny_bench, cell, side_cls=Control)
    assert not result["correct"], rows


def _mode(cell):
    return spec.mode(spec.traffic(spec.cell(BENCH, cell)["traffic"])["mode"])


CASES = [(c, f) for c in CELLS for f in _mode(c).FAULTS]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_underneath_is_not_correct(tiny_bench, cell, fault,
                                           monkeypatch):
    _mode(cell).FAULTS[fault](monkeypatch.setattr)
    result, rows = _run(tiny_bench, cell)
    assert not result["correct"], rows
