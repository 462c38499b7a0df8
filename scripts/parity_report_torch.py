"""Parity report of the PyTorch port: every scan backend against the frozen
CPU oracles, on both bundled maps.

    python scripts/parity_report_torch.py [--poses 16] [--beams 180]
        [--maps levine,berlin] [--device cpu] [--write docs/PARITY_TORCH.md]

Counterpart of ``scripts/parity_report.py``, row for row and in its order.
Per map, on poses sampled in free space from seed 0:

- against the DT-march oracle (``oracle/raycast.scan_batch``): the "edf"
  march (``ops/raymarch_xla.scan_poses``, 200 trips);
- against the exact-geometry oracle
  (``maps/segments.raycast_segments_numpy``, float64, on the port's own
  rays): ``scan_poses_segments``, the dense entry point
  ``ops/raycast_pallas.raycast_pallas``, ``scan_poses_sectors``,
  ``scan_poses_general`` on the contour-simplified map (tolerance 1 cell)
  and the implicit march (256 trips);
- the rows that need the 1080-beam geometry (128-beam blocks):
  ``scan_poses_sectors(use_pallas=True)``, ``scan_poses_pallas``, and the
  sector modes "sorted_pl@128" and "sorted_plf@128";
- the march oracle against the geometry oracle (corner tunnelling);
- gradients: the pose cotangents of ``raycast_sectors`` and of
  ``raycast_pallas`` against the dense analytic VJP ``raycast_all_diff``.

Left out: the JAX report's "sectors exact (sorted sweep)" row. Its
``mode="sorted"`` selects an XLA-only sweep that the port does not carry
(``ops/raycast_sectors._check_mode`` raises for it).

Beside each row stand the launches of the hand-written kernels' wrappers
while the row ran (``ops/sweeps.launch_counts``, the EDF march's
``edf_march`` among them: the "edf march" and "edf implicit" rows run it). On the card a row that
names a kernel and launched none is a fault; on the CPU every wrapper runs
its plain PyTorch version and every count is 0.

Runs on the CUDA card unless given ``--device cpu`` (without a card and
without that flag it exits with ``config.default_device``'s message).
``main(argv)`` returns what it printed as a dict.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

FOV = 4.712388980384690
MAX_RANGE = 10.0


def _stats(d):
    """The report's statistics of |backend - oracle| (meters)."""
    return {"mean": float(d.mean()), "p99": float(np.quantile(d, 0.99)),
            "max": float(d.max()),
            "share_within_1e-4": float(np.mean(d <= 1e-4)),
            "share_within_1e-3": float(np.mean(d <= 1e-3))}


def _geometry_oracle(segs, xb, yb, ct, st):
    """float64 first-hit ranges of the rays (A, B), pose by pose."""
    from pyracecarsimulator_tpu_torch.maps.segments import (
        raycast_segments_numpy)
    rows = [v.detach().cpu().numpy().astype(np.float64)
            for v in (xb, yb, ct, st)]
    return np.stack([raycast_segments_numpy(segs, *(r[i] for r in rows),
                                            MAX_RANGE)
                     for i in range(rows[0].shape[0])])


def report(maps, n_poses, beams, device):
    """The rows of the report. Returns ``(rows, grad_rows)``: dicts with
    the map, the backend, the oracle, the statistics, the kernel wrapper
    the row is meant to launch (None: plain PyTorch) and the launches
    counted while it ran."""
    import torch
    from pyracecarsimulator_tpu_torch.maps import (
        build_general_segment_map, build_sector_map, build_segment_map,
        load_builtin, sample_free_poses)
    from pyracecarsimulator_tpu_torch.maps.segments import extract_segments
    from pyracecarsimulator_tpu_torch.ops import raymarch_xla, sweeps
    from pyracecarsimulator_tpu_torch.ops.common import rays_from_poses
    from pyracecarsimulator_tpu_torch.ops.raycast_general import (
        scan_poses_general)
    from pyracecarsimulator_tpu_torch.ops.raycast_grad import raycast_all_diff
    from pyracecarsimulator_tpu_torch.ops.raycast_pallas import (
        raycast_pallas, scan_poses_pallas)
    from pyracecarsimulator_tpu_torch.ops.raycast_sectors import (
        raycast_sectors, scan_poses_sectors)
    from pyracecarsimulator_tpu_torch.ops.raycast_segments import (
        scan_poses_segments)
    from pyracecarsimulator_tpu_torch.ops.raymarch_diff import (
        scan_poses_implicit)
    from pyracecarsimulator_tpu_torch.oracle.raycast import scan_batch

    def counted(fn):
        """``fn()`` as a host array, with the launches it caused."""
        before = sweeps.launch_counts()
        out = fn()
        out = (out.detach().cpu().numpy() if torch.is_tensor(out)
               else np.stack([g.cpu().numpy() for g in out]))
        used = {k: n - before[k] for k, n in sweeps.launch_counts().items()
                if n != before[k]}
        return out, used

    rows, grad_rows = [], []
    for name in maps:
        t = load_builtin(name, device=device)
        occ = t.occupancy.cpu().numpy()
        org = (t.origin_x, t.origin_y)
        bounds = (t.height, t.width)
        poses = sample_free_poses(t, n_poses, np.random.RandomState(0))
        p = torch.as_tensor(poses, device=device)
        org_t = torch.tensor(org, dtype=torch.float32, device=device)

        # oracle A: the DT march (reference semantics)
        o_march = scan_batch(t.edf.cpu().numpy(), t.resolution, org, poses,
                             num_beams=beams, bounds_hw=bounds)
        # oracle B: exact geometry, on the port's own rays
        segs = extract_segments(occ, t.resolution, org)
        _, p2, xb, yb, ct, st = rays_from_poses(p, beams, FOV)
        o_geom = _geometry_oracle(segs, xb, yb, ct, st)

        kw = dict(max_range=MAX_RANGE, real_hw=bounds, device=device)
        sm = build_segment_map(occ, t.resolution, org, tile_size=4.0, **kw)
        gm = build_general_segment_map(occ, t.resolution, org, tol_cells=1.0,
                                       tile_size=4.0, **kw)
        smap = build_sector_map(occ, t.resolution, org, tile_size=2.0, ns=16,
                                **kw)
        # scans of poses without a gradient take a kernel's entry from
        # poses: the list kernel's on map tiles, the dense kernel's else
        seg_kernel = "list_scan" if sm.tiles is not None else "dense_scan"

        march = ("DT-march oracle", o_march)
        geom = ("geometry oracle", o_geom)
        with torch.no_grad():
            for bname, kernel, oracle, fn in (
                    ("edf march", "edf_march", march,
                     lambda: raymarch_xla.scan_poses(
                        t.edf, t.resolution, org_t, p, num_beams=beams,
                        max_iters=200, bounds_hw=bounds)),
                    ("segments exact", seg_kernel, geom,
                     lambda: scan_poses_segments(sm, p, num_beams=beams)),
                    ("segments exact (dense kernel)", "dense_sweep", geom,
                     lambda: raycast_pallas(sm.params, sm.sweep_meta, xb, yb,
                                            ct, st, MAX_RANGE)),
                    ("sectors exact", "list_scan", geom,
                     lambda: scan_poses_sectors(smap, p, num_beams=beams)),
                    ("simplified tol=1", None, geom,
                     lambda: scan_poses_general(gm, p, num_beams=beams)),
                    ("edf implicit", "edf_march", geom,
                     lambda: scan_poses_implicit(
                        t.edf, t.resolution, org_t, p, num_beams=beams,
                        max_iters=256, bounds_hw=bounds))):
                r, used = counted(fn)
                rows.append({"map": name, "backend": bname,
                             "oracle": oracle[0], "kernel": kernel,
                             "launches": used,
                             **_stats(np.abs(r - oracle[1]))})

            # kernel rows that need the 1080-beam geometry: the sector
            # routes take 128-beam blocks within block_half, and the tile
            # route exists only where the map carries tiles
            _, _, xb18, yb18, ct18, st18 = rays_from_poses(p, 1080, FOV)
            o_geom_1080 = _geometry_oracle(segs, xb18, yb18, ct18, st18)
            for bname, kernel, fn in (
                    ("sectors exact (grouped route, 1080b)", "list_scan",
                     lambda: scan_poses_sectors(smap, p, num_beams=1080,
                                                use_pallas=True)),
                    ("segments exact (dense/tiled kernel, 1080b)",
                     seg_kernel,
                     lambda: scan_poses_pallas(sm, p, num_beams=1080)),
                    ("sectors exact (sorted-tile route, 1080b)",
                     "list_scan",
                     lambda: scan_poses_sectors(smap, p, num_beams=1080,
                                                mode="sorted_pl@128")),
                    ("sectors exact (fused route, 1080b)", "list_scan",
                     lambda: scan_poses_sectors(smap, p, num_beams=1080,
                                                mode="sorted_plf@128"))):
                r, used = counted(fn)
                rows.append({"map": name, "backend": bname,
                             "oracle": "geometry oracle", "kernel": kernel,
                             "launches": used,
                             **_stats(np.abs(r - o_geom_1080))})

        # cross-semantics: march vs geometry (documents corner tunnelling)
        rows.append({"map": name, "backend": "DT-march oracle",
                     "oracle": "geometry oracle", "kernel": None,
                     "launches": {}, **_stats(np.abs(o_march - o_geom))})

        # gradient parity: pose cotangents of every exact fast path against
        # the dense analytic VJP
        def g_of(fn):
            rays = [v.clone().requires_grad_(True) for v in (xb, yb, ct, st)]
            return torch.autograd.grad(fn(*rays).sum(), rays)

        g_ref, _ = counted(lambda: g_of(lambda *rays: raycast_all_diff(
            sm.params, sm.sweep_meta, *rays, MAX_RANGE)))
        bb = max(1, min(128, 2 * int(smap.block_half / (FOV / (beams - 1)))))
        while beams % bb:           # any narrower block is within block_half
            bb -= 1
        for gname, kernel, fn in (
                ("sectors vs dense VJP", "list_sweep",
                 lambda *rays: raycast_sectors(
                     smap.table, smap.meta, smap.tiles_shape, smap.tile_size,
                     smap.tile_origin, smap.ns, p2[:, 0], p2[:, 1], *rays,
                     MAX_RANGE, bb)),
                ("dense kernel entry vs dense VJP", "dense_sweep",
                 lambda *rays: raycast_pallas(sm.params, sm.sweep_meta, *rays,
                                              MAX_RANGE))):
            g, used = counted(lambda: g_of(fn))
            grad_rows.append({"map": name, "check": gname, "kernel": kernel,
                              "launches": used,
                              "max_abs_diff": float(np.abs(g - g_ref).max())})
    return rows, grad_rows


def _launch_text(row, on_card):
    if row["kernel"] is None:
        return "-"
    if not on_card:
        return f"{row['kernel']}: plain version (cpu)"
    return ", ".join(f"{k} {n}" for k, n in row["launches"].items()) or \
        f"{row['kernel']} 0 (NOT LAUNCHED)"


def format_report(out, markdown=False):
    """The report as text: aligned columns, or a Markdown table."""
    on_card = out["device"] != "cpu"
    sep, edge = (" | ", "| ") if markdown else ("  ", "")
    lines = []

    def table(head, body):
        if markdown:
            lines.append(edge + sep.join(head) + " |")
            lines.append(edge + sep.join("---" for _ in head) + " |")
            lines.extend(edge + sep.join(r) + " |" for r in body)
        else:
            widths = [max(len(r[i]) for r in [head] + body)
                      for i in range(len(head))]
            for r in [head] + body:
                lines.append(sep.join(c.ljust(w) for c, w in zip(r, widths)))

    table(["map", "backend", "oracle", "mean", "p99", "max",
           "within 1e-4 m", "kernel launches"],
          [[r["map"], r["backend"], r["oracle"], f"{r['mean']:.4f}",
            f"{r['p99']:.4f}", f"{r['max']:.4f}",
            f"{r['share_within_1e-4']:.4f}", _launch_text(r, on_card)]
           for r in out["rows"]])
    lines.append("")
    table(["map", "gradient check (pose cotangents)", "max|d|",
           "kernel launches"],
          [[g["map"], g["check"], f"{g['max_abs_diff']:.2e}",
            _launch_text(g, on_card)] for g in out["grads"]])
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=16)
    ap.add_argument("--beams", type=int, default=180)
    ap.add_argument("--maps", default="levine,berlin",
                    help="bundled maps, comma-separated")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a card (default: the card)")
    ap.add_argument("--write", default="",
                    help="also write the report to this Markdown file")
    args = ap.parse_args(argv)

    from pyracecarsimulator_tpu_torch.config import resolve_device
    from pyracecarsimulator_tpu_torch.utils.profiling import device_label
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"parity_report_torch.py: {e}")
    rows, grads = report(args.maps.split(","), args.poses, args.beams,
                         device)
    out = {"device": device_label(device), "poses": args.poses,
           "beams": args.beams, "rows": rows, "grads": grads}
    head = (f"device: {out['device']}; {args.poses} poses per map, "
            f"{args.beams} beams (1080 where a row says so), 270 deg, "
            f"{MAX_RANGE:g} m; differences in meters")
    print(head)
    print(format_report(out))
    if args.write:
        command = "python scripts/parity_report_torch.py " + " ".join(
            argv if argv is not None else sys.argv[1:])
        with open(args.write, "w") as f:
            f.write("# Parity of the PyTorch port against the CPU oracles\n\n"
                    f"{head}.\n\nCommand: `{command.strip()}`\n\n"
                    "Rows and columns as `scripts/parity_report_torch.py` "
                    "documents them; the JAX report's XLA-only "
                    "`mode=\"sorted\"` row is left out (the port refuses "
                    "that mode).\n\n"
                    + format_report(out, markdown=True) + "\n")
        print(f"written to {args.write}")
    return out


if __name__ == "__main__":
    main()
