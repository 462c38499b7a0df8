"""Time the list-routed sweep (``csrc/sector_sweep.cu``, kernel
``list_sweep_kernel``) of one checkout of the port on the card: for
comparing two commits on the same card.

    python3 scripts/sweep_ab_torch.py [--tree DIR] [--map berlin]
                                      [--agents 4096] [--turns 3]
                                      [--json OUT]

``--tree`` is the root of the checkout whose package is timed (default:
the one holding this script), so one call can time a parent commit
unpacked beside the change, in turns: parent, change, change, parent.
On the map, at ``--agents`` x 1080 beams, 270 degrees, 10 m, on poses
sampled from seed 0 (five sets that differ by 1e-3 rad, one a call), the
sweep alone (``ops/sweeps.list_sweep``) on the two tables the exact
backends route rows to: the sector backend's (tile, sector) lists
(``sectors``) and the segment backend's 4 m map tiles (``tiles``; none on
an untiled map such as levine). Device milliseconds a call from CUDA
graphs of 20 calls replayed between CUDA events, ``--turns`` times (their
median and each turn);
beside them the rows, the real slots a row from ``meta`` of the rows
(what the sweep's counter counts, where the tree's port has it:
``ops/sweeps.SWEEP_COUNTS``, read around one eager call), the slots a row
the kernel's wedge cull keeps (``kept_per_row``, where the tree's counter
has a ``kept`` column), and the sums of the outputs on the first set
(float64, clamped to 10 m), which two checkouts of one function share.
Prints one JSON line (also written to ``--json``) with the card's name
and power limit from ``nvidia-smi``. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

BEAMS = 1080
FOV = 4.712388980384690
MAX_RANGE = 10.0
CALLS = 20


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


def graphed_ms(fn, sets, reps=5):
    """Device ms a call of ``fn(*sets[i])``: ``CALLS`` calls in one CUDA
    graph, replayed ``reps`` times between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(*sets[i % len(sets)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(CALLS):
            fn(*sets[i % len(sets)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (CALLS * reps)


def list_args(table, meta, ids, p, ct, st, bb):
    """The sweep's arguments for poses ``p`` whose padded fan (ct, st)
    routes row by row to ``ids`` (A, NBLK)."""
    import torch
    from pyracecarsimulator_tpu_torch.ops.common import _ray_invs
    g = ids.numel()
    nblk = g // p.shape[0]
    ic, is_ = _ray_invs(ct, st)
    return (table, meta, ids.reshape(g).to(torch.int32).contiguous(),
            p[:, 0].repeat_interleave(nblk).contiguous(),
            p[:, 1].repeat_interleave(nblk).contiguous(),
            *(v.reshape(g, bb).contiguous() for v in (ct, st, ic, is_)))


def cases(bundles, poses):
    """{table: [argument sets of ``list_sweep``]} on the two tables."""
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
    from pyracecarsimulator_tpu_torch.ops.common import (_padded_offsets,
                                                         fan_cos_sin,
                                                         tile_ids)
    smap, segmap = bundles["sectors"].segmap, bundles["segments"].segmap
    out = {"sectors": []}
    if segmap.tiles is not None:
        out["tiles"] = []
    bb = rs.sector_block_width(smap, BEAMS, FOV)
    for p in poses:
        ct, st = fan_cos_sin(p[:, 2], _padded_offsets(BEAMS, FOV, bb,
                                                      p.device))
        ids = rs._list_ids(smap.tiles_shape, smap.tile_size,
                           smap.tile_origin, smap.ns, p[:, 0], p[:, 1], ct,
                           st, bb)
        out["sectors"].append(list_args(smap.table, smap.meta, ids, p, ct,
                                        st, bb))
        if "tiles" not in out:
            continue
        ct, st = fan_cos_sin(p[:, 2], _padded_offsets(BEAMS, FOV, 128,
                                                      p.device))
        nblk = ct.shape[1] // 128
        tid = tile_ids(segmap.tiles_shape, segmap.tile_size,
                       segmap.tile_origin, p[:, 0], p[:, 1])
        out["tiles"].append(list_args(
            segmap.tiles, segmap.tile_sweep_meta,
            tid[:, None].expand(-1, nblk), p, ct, st, 128))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--map", default="berlin")
    ap.add_argument("--agents", type=int, default=4096)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sweep_ab_torch.py: no CUDA device", file=sys.stderr)
        return 2
    import pyracecarsimulator_tpu_torch as P
    from pyracecarsimulator_tpu_torch.maps import sample_free_poses
    from pyracecarsimulator_tpu_torch.ops import sweeps
    if not P.__file__.startswith(tree):
        raise SystemExit(f"imported {P.__file__}, not the tree {tree}")
    bundles = {b: P.build_sim(args.map, backend=b, device="cuda")
               for b in ("sectors", "segments")}
    base = torch.as_tensor(sample_free_poses(
        bundles["sectors"].track, args.agents, np.random.RandomState(0)),
        device="cuda")
    poses = []
    for j in range(5):
        q = base.clone()
        q[:, 2] += j * 1e-3
        poses.append(q)
    counted = getattr(sweeps, "SWEEP_COUNTS", None)
    out = {"tree": tree, "card": card(), "map": args.map,
           "agents": args.agents, "counter": counted is not None}
    fn = sweeps.list_sweep
    for route, sets in cases(bundles, poses).items():
        table, meta, ids = sets[0][:3]
        m = meta[ids.long()].long()
        row = {"table": list(table.shape), "rows": ids.numel(),
               "slots_per_row": float((m[:, 0] + m[:, 2] - m[:, 1])
                                      .double().mean())}
        before = dict(counted) if counted is not None else None
        bv, bh = fn(*sets[0])
        if counted is not None:
            after = dict(counted)
            row["counted"] = {k: after[k] - before[k] for k in after}
            if "kept" in row["counted"]:
                row["kept_per_row"] = row["counted"]["kept"] / ids.numel()
        r = torch.clamp(torch.minimum(bv, bh), max=MAX_RANGE)
        row["sum_range"] = float(r.double().sum())
        turns = [graphed_ms(fn, sets) for _ in range(args.turns)]
        row["ms"] = statistics.median(turns)
        row["ms_turns"] = turns
        out[route] = row
        print(f"[{route}] {row}", file=sys.stderr, flush=True)
    line = json.dumps(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
