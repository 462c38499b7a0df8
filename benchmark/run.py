"""Run one cell of the benchmark of ``pyracecarsimulator_tpu_torch`` once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port. It runs on the CUDA card
of the machine it is started on and refuses to run without one (nothing
falls back to the CPU). The last line of standard output is the result's
JSON object; the last lines of standard error are the check's numbers,
each beside its limit. The port builds its kernels with nvcc into its
own ``_build/`` inside the checkout and loads them itself; the driver's
JIT cache of PTX stays inside the checkout too (``.bench_cache/nv``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "pyracecarsimulator_tpu")


def _fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def loaded_forbidden():
    """Top-level names of loaded modules that a run may not hold,
    compared whole (the port's name begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["CUDA_CACHE_PATH"] = os.path.join(ROOT, ".bench_cache", "nv")
    sys.path.insert(0, ROOT)
    from benchmark.core import harness, spec
    bench = spec.benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        _fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < int(cell["chips"]):
        _fail(f"{cell['name']} needs {cell['chips']} cards, this machine "
              f"has {torch.cuda.device_count()}")
    try:
        import pyracecarsimulator_tpu_torch  # noqa: F401
    except ImportError as e:
        _fail(f"the program is not in this checkout: {e}")
    torch.set_num_threads(4)
    result, rows = harness.run_cell(bench, cell, args.seed, args.seconds,
                                    bool(args.trace), "cuda", T_START)
    bad = loaded_forbidden()
    if bad:
        _fail(f"modules loaded that the run may not hold: {', '.join(bad)}")
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in rows}
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
