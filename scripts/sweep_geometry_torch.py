"""Host sweep of sector-table geometry: list-length statistics against
(ns, tile_size, block_half), from the PyTorch port's map compile.

    python scripts/sweep_geometry_torch.py [map] [combos...]
      combo = ns:tile_size:block_half, for example 32:2.0:0.025

Counterpart of ``scripts/sweep_geometry.py``, the same table from
``pyracecarsimulator_tpu_torch.maps.sectors.build_sector_map(...,
device="cpu")``. A host tool: it builds tables and counts list lengths,
and nothing runs on a card (every tensor is made on the CPU).

The list kernel sweeps the real slots of the lists a batch visits, so the
batch-visited mean is what a sector scan costs; the capacity K (the longest
list per orientation) sets the table's size. Both follow the angular wedge
a list must cover: the sector arc (2 pi / ns), plus 2 * block_half for the
beam block's fan, plus the tile's parallax (which shrinks with tile_size).
Per combo the script prints the capacity K (kv + kh), the table's MB, the
real lists' mean, p99 and max, and the visited mean, p90 and max of the
standard batch (4096 agents x 1080 beams from seed 0): the figures for
choosing a finer-routed layout.

``main(argv)`` returns the rows as a list of dicts.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

BEAMS = 1080
FOV = 4.712388980384690
DEFAULT = ("16:2.0:0.285", "32:2.0:0.285", "32:2.0:0.15", "32:2.0:0.025",
           "64:2.0:0.025", "128:2.0:0.025", "64:1.0:0.025",
           "128:1.0:0.025", "32:1.0:0.025")


def table_stats(smap, x, y, theta):
    """The statistics of one sector map for a batch of poses: ``smap`` a
    ``SectorSegmentMap`` (its tensors on the CPU, or anything with the same
    fields as arrays), ``x``/``y``/``theta`` (A,) float32 arrays."""
    meta = np.asarray(smap.meta)
    real = meta[:, 0] + (meta[:, 2] - meta[:, 1])
    ns, ts, bh = smap.ns, smap.tile_size, smap.block_half
    # every (agent, block) lookup a bb-block would do; bb follows from
    # block_half
    spacing = FOV / (BEAMS - 1)
    bb = max(1, min(128, 2 * int(bh / spacing)))
    nblk = -(-BEAMS // bb)
    nr, nc = smap.tiles_shape
    tox, toy = smap.tile_origin
    ci = np.clip(((x - tox) / ts).astype(int), 0, nc - 1)
    ri = np.clip(((y - toy) / ts).astype(int), 0, nr - 1)
    tid = ri * nc + ci
    offs = (np.arange(BEAMS) - (BEAMS - 1) / 2.0) * spacing
    mids = np.minimum(np.arange(nblk) * bb + bb // 2, BEAMS - 1)
    th = np.mod(theta[:, None] + offs[None, mids], 2 * np.pi)
    sec = np.clip((th * (ns / (2 * np.pi))).astype(int), 0, ns - 1)
    n_of = real[(tid[:, None] * ns + sec).reshape(-1)]
    table = np.asarray(smap.table)
    return {"bb": bb, "K": int(table.shape[2]), "kv": int(smap.kv_sec),
            "table_mb": table.nbytes / 1e6,
            "real_mean": float(real.mean()),
            "real_p99": float(np.percentile(real, 99)),
            "real_max": int(real.max()),
            "visited_mean": float(n_of.mean()),
            "visited_p90": float(np.percentile(n_of, 90)),
            "visited_max": int(n_of.max())}


def standard_batch(track, agents: int = 4096):
    """(x, y, theta) of the standard batch: free cells with 0.3 m of
    clearance and headings from seed 0, as ``bench_torch.py`` draws them."""
    edf = track.edf.cpu().numpy()[: track.height, : track.width]
    rng = np.random.RandomState(0)
    ys, xs = np.where(edf > 0.3)
    k = rng.randint(len(ys), size=agents)
    x = (track.origin_x + (xs[k] + .5) * track.resolution).astype(np.float32)
    y = (track.origin_y + (ys[k] + .5) * track.resolution).astype(np.float32)
    return x, y, rng.uniform(-np.pi, np.pi, agents).astype(np.float32)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    name = argv[0] if argv else "berlin"
    combos = argv[1:] or list(DEFAULT)
    from pyracecarsimulator_tpu_torch.maps import (build_sector_map,
                                                   load_builtin)
    print("host tool: tables are built and counted on the CPU, nothing runs "
          "on a card")
    m = load_builtin(name, device="cpu")
    batch = standard_batch(m)
    rows = []
    for combo in combos:
        ns, ts, bh = combo.split(":")
        t0 = time.time()
        try:
            smap = build_sector_map(
                m.occupancy.numpy(), m.resolution, (m.origin_x, m.origin_y),
                max_range=10.0, tile_size=float(ts), ns=int(ns),
                block_half=float(bh), real_hw=(m.height, m.width),
                device="cpu")
        except ValueError as e:      # a combination the compile refuses
            print(f"{combo}: build failed: {e!r}", flush=True)
            continue
        s = {"combo": combo, "build_s": time.time() - t0,
             **table_stats(smap, *batch)}
        rows.append(s)
        print(f"{combo}: build {s['build_s']:5.1f}s  bb={s['bb']:3d} "
              f"K={s['K']:4d} (kv={s['kv']}) table={s['table_mb']:6.1f}MB  "
              f"real mean={s['real_mean']:5.1f} p99={s['real_p99']:5.0f} "
              f"max={s['real_max']:4d}  visited mean={s['visited_mean']:5.1f} "
              f"p90={s['visited_p90']:4.0f} max={s['visited_max']:4d}",
              flush=True)
    return rows


if __name__ == "__main__":
    main()
