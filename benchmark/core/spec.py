"""The benchmark's registries, all found by name: ``BENCHMARK.json`` at the
root of the checkout, and beside this package one file per configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``),
traffic mode (``modes/<mode>.py``, named by the mix), per-layer metric
reader (``metrics/<name>.py``, or ``metrics/<stem>.py`` for a name
``<stem>.<traffic>``), cell's limits (``limits/<cell>.json``) and group
of kernel-name patterns (``kernels/*.json``); each configuration names
the reference's scan (``reference/scans/<name>.py``). A new
configuration, mix, mode, metric or cell is new files and new entries:
nothing here names one.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json(os.path.join(bench_dir, "configs", f"{name}.json"))


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json(os.path.join(bench_dir, "traffic", f"{name}.json"))


def limits(cell_name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json(os.path.join(bench_dir, "limits", f"{cell_name}.json"))


def kernel_layers(bench_dir: str = BENCH_DIR) -> dict:
    """Layer name -> kernel-name substrings, merged over every file of
    ``kernels/``."""
    out: dict = {}
    for path in sorted(glob.glob(os.path.join(bench_dir, "kernels",
                                              "*.json"))):
        spec = _json(path)
        out.setdefault(spec["layer"], []).extend(spec["patterns"])
    return out


def _module(path: str, prefix: str):
    spec = importlib.util.spec_from_file_location(
        prefix + re.sub(r"[^A-Za-z0-9_]", "_", os.path.basename(path)[:-3]),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mode(name: str, bench_dir: str = BENCH_DIR):
    """The module of traffic mode ``name`` (``core/traffic.py`` says what
    it holds)."""
    path = os.path.join(bench_dir, "modes", f"{name}.py")
    if not NAME.match(name) or not os.path.exists(path):
        raise FileNotFoundError(f"no traffic mode {name!r}")
    return _module(path, "bench_mode_")


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The ``read(ctx)`` function of a per-layer metric's reader."""
    stem = name
    while True:
        path = os.path.join(bench_dir, "metrics", f"{stem}.py")
        if os.path.exists(path):
            break
        if "." not in stem:
            raise FileNotFoundError(f"no reader for metric {name!r}")
        stem = stem.rsplit(".", 1)[0]
    return _module(path, "bench_metric_").read


def metrics_of(bench: dict, kind: str, cell_name: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics a cell reports:
    those without a ``workloads`` list and those whose list names it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]
