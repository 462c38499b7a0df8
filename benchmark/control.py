"""The readings that a cell's limits are set from, on the card, in one
process: the program's check numbers on many seeds (each a whole run of
the cell with a short window) and the control's (the reference in
bfloat16 put in the program's place) on a few.

    python benchmark/control.py --workload <cell> [--seeds 12]
        [--control-seeds 3] [--faults a,b] [--fault-seeds 3]
        [--seconds 2] [--json out.json]

``--faults`` also reads the program with each named fault planted
underneath, as the cell's mode lists them (``FAULTS`` of
``modes/<mode>.py``). The benchmark's own runs never run
the control or a fault. Each seed's line goes to
standard error as it comes; the JSON holds every reading.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3 * 2 ** 31 + 17)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        sys.exit("benchmark: no CUDA device")
    from benchmark.core import harness, spec
    from benchmark.core.sides import Control, Program
    bench = spec.benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    mode = spec.mode(spec.traffic(cell["traffic"])["mode"])
    fault_names = [f for f in args.faults.split(",") if f]
    out = {"cell": cell["name"], "program": [], "control": []}
    plan = ([("program", Program, None)] * args.seeds
            + [("control", Control, None)] * args.control_seeds
            + [(f"fault:{f}", Program, f) for f in fault_names
               for _ in range(args.fault_seeds)])
    for i, (side, cls, fault) in enumerate(plan):
        seed = args.first_seed + 7919 * i
        undo = []
        if fault:
            mode.FAULTS[fault](lambda o, n, v: (
                undo.append((o, n, getattr(o, n))), setattr(o, n, v)))
        t = time.perf_counter()
        try:
            result, rows = harness.run_cell(bench, cell, seed, args.seconds,
                                            False, "cuda", t, side_cls=cls)
            numbers = {name: value for name, value, _ in rows}
            numbers["correct"] = result["correct"]
        except Exception as e:          # a control that crashes has failed
            numbers = {"error": repr(e)}
        for o, n, v in reversed(undo):
            setattr(o, n, v)
        out.setdefault(side, []).append(
            {"seed": seed, "numbers": numbers,
             "seconds": time.perf_counter() - t})
        print(side, seed, json.dumps(numbers), file=sys.stderr, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
