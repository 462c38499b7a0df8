"""The command as the benchmark's check runs it: without a card it exits
non-zero and prints no result, traced or not; so does a checkout that
holds only BENCHMARK.json and the benchmark's own files."""

import os
import shutil
import subprocess
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _run(cwd, trace):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "berlin-segments.rollout", "--seed", str(2 ** 33 + 5), "--seconds",
         "1", "--trace", str(trace)],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


@pytest.mark.parametrize("trace", [0, 1])
def test_no_card_no_result(trace):
    out = _run(ROOT, trace)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "metrics" not in out.stdout and "busy_s" not in out.stdout
    assert "no CUDA device" in out.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, 1)
    assert out.returncode != 0
    assert "{" not in out.stdout
