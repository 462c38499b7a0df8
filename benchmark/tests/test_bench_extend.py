"""A configuration with a backend the benchmark has not run, a traffic mix
of a mode it has not had, a per-layer metric and a cell are added by new
files and new entries in BENCHMARK.json alone: no file of the harness
changes, and the new cell runs, correct, on the CPU (the tiny copy); the
new mode's check catches a fault planted underneath it."""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(os.path.dirname(HERE)), HERE]

import tiny  # noqa: E402
from benchmark.core import harness, spec  # noqa: E402

# a mode of its own: the cars drive straight at a fixed speed for the
# mix's horizon, one step of the program at a time; the check follows the
# sampled call and compares the last scan and the final state
STRAIGHT = '''
import torch

from benchmark.core import faults
from benchmark.core.checks import TOL_RANGE_M, clone, off_state

FAULTS = {"altered_answer": faults.longer_first_scan}


def program(side, mix, config, gen):
    speed = float(mix["policy"]["speed"])

    def job(start):
        state = side.car_state(start)
        act = (torch.full(state.batch_shape, speed, device=side.device),
               torch.zeros(state.batch_shape, device=side.device))
        for _ in range(int(mix["horizon"])):
            out = side.step(state, act)
            state = out.state
        return side.fields(state), out.ranges
    job.final = lambda out: out[0]
    return job


def _drive(w, start, speed, horizon, steer_mode):
    state = w.cast(start)
    v = torch.full_like(state["x"], speed)
    for _ in range(horizon):
        new = w.advance(state, v, torch.zeros_like(v), steer_mode)
        sx, sy = w.scanner(new["x"], new["y"], new["theta"])
        ranges = w.scan(sx, sy, new["theta"])
        state = w.latch(new, ranges)
    return state, ranges


def control(side, mix, config, gen):
    def job(start):
        state, ranges = _drive(side.world, start,
                               float(mix["policy"]["speed"]),
                               int(mix["horizon"]), side.steer_mode)
        return side.out(state), ranges.float()
    job.final = lambda out: out[0]
    return job


class Check:
    setup_calls = 2
    keep = 1

    def __init__(self, mix, config):
        self.mix, self.kept = mix, None

    def before(self, where, slot, job):
        pass

    def after(self, where, slot, job, start, out):
        if where == "window":
            self.kept = (clone(start), clone(out[0]), out[1].clone())

    def numbers(self, world):
        start, final, ranges = self.kept
        state, ref = _drive(world, start, float(self.mix["policy"]["speed"]),
                            int(self.mix["horizon"]), self.mix["steer_mode"])
        return {"range_off_share": float(((ranges.double() - ref).abs()
                                          > TOL_RANGE_M).double().mean()),
                "state_off_share": float(off_state(final, state)
                                         .double().mean())}
'''


def _write(path, obj):
    with open(path, "w") as f:
        f.write(obj if isinstance(obj, str) else json.dumps(obj))


def _new_cell(tmp_path):
    root, bench_dir = tiny.make(tmp_path)
    cfg = spec.config("berlin-segments", bench_dir)
    cfg.update(name="tiny-sectors", backend="sectors", agents=32)
    _write(os.path.join(bench_dir, "configs", "tiny-sectors.json"), cfg)
    _write(os.path.join(bench_dir, "modes", "straight.py"), STRAIGHT)
    _write(os.path.join(bench_dir, "traffic", "straight.json"),
           {"mode": "straight", "rate_metric": "env_steps_s", "horizon": 4,
            "steer_mode": "bang", "policy": {"speed": 2.0},
            "start_margin_m": 0.5, "reset_pool_factor": 4,
            "trace_calls": 1})
    _write(os.path.join(bench_dir, "limits", "tiny-sectors.straight.json"),
           {"range_off_share": 1e-4, "state_off_share": 1e-2})
    _write(os.path.join(bench_dir, "metrics", "map_cells.py"),
           "def read(ctx):\n    return ctx['spans']['map_build_s'] * 0 + 1\n")
    bench = spec.benchmark(root)
    bench["configs"].append({"name": "tiny-sectors", "source": "tiny.py",
                             "file": "benchmark/configs/tiny-sectors.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-sectors.straight",
                               "config": "tiny-sectors",
                               "traffic": "straight", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "map_cells", "unit": "1",
                               "better": "lower", "source": "host_clock",
                               "layer": "Host map compile",
                               "moves": "setup_s",
                               "workloads": ["tiny-sectors.straight"]})
    for m in bench["end_to_end"]:
        if m["name"] == "env_steps_s":
            m["workloads"].append("tiny-sectors.straight")
    _write(os.path.join(root, "BENCHMARK.json"), bench)
    return root, bench_dir


def _run(root, bench_dir):
    bench = spec.benchmark(root)
    cell = spec.cell(bench, "tiny-sectors.straight")
    return harness.run_cell(bench, cell, 2 ** 32 + 7, 0.2, False, "cpu",
                            time.perf_counter(), bench_dir=bench_dir)


def test_new_files_and_entries_make_a_new_cell(tmp_path):
    root, bench_dir = _new_cell(tmp_path)
    result, rows = _run(root, bench_dir)
    assert result["correct"], rows
    assert [r[0] for r in rows] == ["range_off_share", "state_off_share"]
    assert set(result["metrics"]) == {"env_steps_s", "call_p95_ms",
                                      "setup_s"}
    assert spec.metric_reader("map_cells", bench_dir)(
        {"spans": {"map_build_s": 0.5}}) == 1
    bench = spec.benchmark(root)
    assert [m["name"] for m in spec.metrics_of(bench, "per_layer",
                                               "tiny-sectors.straight")][-1] \
        == "map_cells"


def test_the_new_modes_check_catches_its_fault(tmp_path, monkeypatch):
    root, bench_dir = _new_cell(tmp_path)
    spec.mode("straight", bench_dir).FAULTS["altered_answer"](
        monkeypatch.setattr)
    result, rows = _run(root, bench_dir)
    assert not result["correct"], rows
