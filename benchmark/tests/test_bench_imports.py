"""Nothing the benchmark runs loads JAX or the JAX package, by top-level
module name compared whole (the port's name begins with the JAX
package's), and the reference loads nothing of the port."""

import ast
import glob
import os
import subprocess
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402

JAX_NAMES = {"jax", "jaxlib", "flax", "pyracecarsimulator_tpu"}
PORT = "pyracecarsimulator_tpu_torch"


def _tops_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')"
         "[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_port_load_no_jax():
    tops = _tops_after(
        "import glob, importlib.util, pyracecarsimulator_tpu_torch\n"
        "import pyracecarsimulator_tpu_torch.parallel\n"
        "from benchmark.core import harness, sides, trace, checks\n"
        "from benchmark.core import spec\n"
        "for p in glob.glob('benchmark/metrics/*.py'):\n"
        "    spec.metric_reader(p.rsplit('/', 1)[1][:-3])\n"
        "for p in glob.glob('benchmark/modes/*.py'):\n"
        "    spec.mode(p.rsplit('/', 1)[1][:-3])\n")
    assert PORT in tops
    assert not tops & JAX_NAMES, tops & JAX_NAMES


def test_the_reference_loads_nothing_of_the_program():
    tops = _tops_after("import glob, importlib\n"
                       "import benchmark.reference.sim, "
                       "benchmark.reference.maps, benchmark.core.checks\n"
                       "for p in glob.glob('benchmark/reference/scans/*.py'):\n"
                       "    importlib.import_module('benchmark.reference.scans.'"
                       " + p.rsplit('/', 1)[1][:-3])")
    assert not tops & (JAX_NAMES | {PORT}), tops & (JAX_NAMES | {PORT})


def test_no_source_of_the_benchmark_imports_jax():
    for path in glob.glob(os.path.join(BENCH_DIR, "**", "*.py"),
                          recursive=True):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in JAX_NAMES, (path, n)
                if "reference" in path.split(os.sep):
                    assert n.split(".")[0] != PORT, (path, n)


def test_the_run_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyracecarsimulator_tpu_torch.x", sys)
    assert "pyracecarsimulator_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "pyracecarsimulator_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"jax", "pyracecarsimulator_tpu"} <= set(run.loaded_forbidden())
