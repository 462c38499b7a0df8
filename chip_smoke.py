"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — ``build_sim`` -> ``make_step_fn`` ->
``make_rollout_fn`` with the gap-follower policy — at full width (4096
agents, 1080 beams, 270 deg, max_range 10) on both bundled maps, levine and
berlin, and checks it:

1. the card's name and power limit, the PyTorch and CUDA versions;
2. builds the sector-sweep kernel (``csrc/sector_sweep.cu``) with nvcc;
3. per map: the kernel against its plain PyTorch version on the card on the
   full 4096 x 1080 fan (mismatches must be 0), the CUDA scan against the
   CPU scan on a small batch given the same fan (bit-identical), and the
   scan against a brute-force float64 ray/segment oracle on a few poses;
4. the main path on the card: one step plus a 20-step noisy rollout per
   map, with the kernel's launch counter reset just before and read just
   after (it must have grown), outputs finite, of the right shape, on the
   card;
5. times (CUDA events, warm-up, inputs that change between repetitions):
   the kernel and the plain sweep, the full scan, and the closed-loop step;
6. the reference-style facade ``RacecarSimulator`` with batch shape ().

Prints a JSON line describing the kernel, then as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, without that line, on any failure or without a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

AGENTS = 4096
BEAMS = 1080
FOV = 4.712388980384690
MAX_RANGE = 10.0
STEPS = 20
MAPS = ("levine", "berlin")
KERNEL_SOURCE = "pyracecarsimulator_tpu_torch/csrc/sector_sweep.cu"
REPLACES = "pyracecarsimulator_tpu/ops/raycast_pallas.py:704"


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def timed_ms(fn, reps, warmup=2):
    """Mean milliseconds per call of ``fn(i)`` over ``reps`` calls, after
    ``warmup`` calls; CUDA events on the card."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(warmup + i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def oracle_ranges(segs, x, y, ct, st, max_range):
    """Brute force in float64: first hit of each ray over every boundary
    segment. x, y (A,); ct, st (A, B). Returns (A, B)."""
    import numpy as np
    out = np.empty(ct.shape, np.float64)
    p, lo, hi, isv = (segs[:, i] for i in range(4))
    v = isv > 0.5
    for i in range(ct.shape[0]):
        c = ct[i].astype(np.float64)[:, None]
        s = st[i].astype(np.float64)[:, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            tv = (p[v][None] - x[i]) / c
            av = y[i] + tv * s
            okv = (tv >= 0) & (av >= lo[v][None]) & (av <= hi[v][None])
            th = (p[~v][None] - y[i]) / s
            ah = x[i] + th * c
            okh = (th >= 0) & (ah >= lo[~v][None]) & (ah <= hi[~v][None])
        best = np.minimum(np.where(okv, tv, np.inf).min(axis=1),
                          np.where(okh, th, np.inf).min(axis=1))
        out[i] = np.minimum(best, max_range)
    return out


def sweep_args(smap, p):
    """The main path's inputs to ``sector_sweep`` for poses ``p`` (A, 3)
    on the map's device: (ct, st, ids, args), args as the sweep takes
    them."""
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
    from pyracecarsimulator_tpu_torch.ops.common import (_ray_invs,
                                                         fan_cos_sin)
    bb = rs.sector_block_width(smap, BEAMS, FOV)
    ct, st = fan_cos_sin(p[:, 2], rs._padded_offsets(BEAMS, FOV, bb,
                                                     p.device))
    ids = rs._list_ids(smap.tiles_shape, smap.tile_size, smap.tile_origin,
                       smap.ns, p[:, 0], p[:, 1], ct, st, bb)
    ic, is_ = _ray_invs(ct, st)
    g = ids.numel()
    nblk = g // p.shape[0]
    args = (smap.table, smap.meta, smap.kv_sec, ids.reshape(g).contiguous(),
            p[:, 0].repeat_interleave(nblk).contiguous(),
            p[:, 1].repeat_interleave(nblk).contiguous(),
            *(v.reshape(g, bb).contiguous() for v in (ct, st, ic, is_)))
    return ct, st, ids, args


def check_kernel(name, track, smap, poses, counts):
    """Kernel vs plain sweep on the card on the full fan; CUDA scan vs CPU
    scan with the same fan; scan vs the brute-force oracle. Returns the
    kernel's max abs error against the plain version."""
    import numpy as np
    import torch
    from pyracecarsimulator_tpu_torch.maps.segments import extract_segments
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs

    p = torch.as_tensor(poses, device="cuda")
    ct, st, ids, args = sweep_args(smap, p)
    g, bb = args[-1].shape
    bv, bh = rs.sector_sweep(*args)
    bv_p, bh_p = rs.sweep_plain(*args)
    torch.cuda.synchronize()
    mism = int(((bv != bv_p) | (bh != bh_p)).sum())
    err = max(float((bv.double() - bv_p.double()).abs().max()),
              float((bh.double() - bh_p.double()).abs().max()))
    log(f"[{name}] kernel vs plain on {g} rows x {bb} beams "
        f"({p.shape[0]} x {BEAMS} rays): (bv, bh) mismatches = {mism}, "
        f"max abs err = {err}")
    check(mism == 0, f"{name}: kernel disagrees with the plain sweep")
    m = smap.meta[ids.reshape(-1).long()]
    counts[name] = {"rows": g, "mean_real_slots": float(
        (m[:, 0] + m[:, 2] - m[:, 1]).float().mean())}

    # the same fan through the CUDA scan and the CPU (plain) scan
    few = p[:64]
    cpu_map = smap.to("cpu")
    r_dev = rs._scan_chunk(smap, few, ct[:64], st[:64], BEAMS, MAX_RANGE,
                           bb).cpu()
    r_cpu = rs._scan_chunk(cpu_map, few.cpu(), ct[:64].cpu(),
                           st[:64].cpu(), BEAMS, MAX_RANGE, bb)
    same = bool(torch.equal(r_dev, r_cpu))
    log(f"[{name}] scan on cuda vs CPU plain scan, same fan, 64 poses: "
        f"bit-identical = {same}")
    check(same, f"{name}: device scan differs from the CPU scan")

    # brute-force oracle on a few poses
    segs = extract_segments(track.occupancy.cpu().numpy(), track.resolution,
                            (track.origin_x, track.origin_y))
    k = 8
    ora = oracle_ranges(segs, poses[:k, 0].astype(np.float64),
                        poses[:k, 1].astype(np.float64),
                        ct[:k, :BEAMS].cpu().numpy(),
                        st[:k, :BEAMS].cpu().numpy(), MAX_RANGE)
    d = np.abs(r_dev[:k].numpy() - ora)
    share = float(np.mean(d <= 1e-4))
    log(f"[{name}] scan vs float64 brute-force oracle ({len(segs)} "
        f"segments, {k} poses): share within 1e-4 m = {share}, "
        f"max abs diff = {float(d.max())}")
    check(share >= 0.999, f"{name}: scan disagrees with the oracle")
    return err


def time_sweeps(name, smap, poses, card):
    """Kernel and plain sweep at 4096 x 1080, and the full scan; inputs
    change between repetitions (five pose sets in turn)."""
    import torch
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs

    sets = []
    for j in range(5):
        p = torch.as_tensor(poses, device="cuda").clone()
        p[:, 2] += j * 1e-3
        sets.append((p, sweep_args(smap, p)[3]))
    rays = AGENTS * BEAMS
    k_ms = timed_ms(lambda i: rs.sector_sweep(*sets[i % 5][1]), 50)
    p_ms = timed_ms(lambda i: rs.sweep_plain(*sets[i % 5][1]), 5, warmup=1)
    k2_ms = timed_ms(lambda i: rs.sector_sweep(*sets[i % 5][1]), 50)
    s_ms = timed_ms(lambda i: rs.scan_poses_sectors(
        smap, sets[i % 5][0], num_beams=BEAMS, fov=FOV,
        max_range=MAX_RANGE), 20)
    log(f"[{name}] {card}: sector_sweep kernel {k_ms:.4f} ms then "
        f"{k2_ms:.4f} ms ({rays / (k_ms * 1e-3):.4e} rays/s), plain sweep "
        f"{p_ms:.4f} ms ({rays / (p_ms * 1e-3):.4e} rays/s), full scan "
        f"(fan + ids + kernel + mask) {s_ms:.4f} ms "
        f"({rays / (s_ms * 1e-3):.4e} rays/s), {AGENTS} x {BEAMS}")
    return {"kernel_ms": k_ms, "kernel_ms_2": k2_ms, "plain_ms": p_ms,
            "scan_ms": s_ms}


def run():
    import numpy as np
    import torch
    from pyracecarsimulator_tpu_torch import (RacecarSimulator, build_sim,
                                              make_step_fn, state_from_pose)
    from pyracecarsimulator_tpu_torch.maps import (build_sector_map,
                                                   load_builtin,
                                                   sample_free_poses)
    from pyracecarsimulator_tpu_torch.ops import _kernels
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
    from pyracecarsimulator_tpu_torch.parallel import (
        make_gap_follower_policy, make_rollout_fn)

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    path = _kernels.build("sector_sweep")
    info = _kernels.build_info["sector_sweep"]
    log(f"built {path.name} in {info['seconds']:.2f} s "
        f"(wall {time.perf_counter() - t0:.2f} s); nvcc: "
        f"{' '.join(_kernels.NVCC_FLAGS)}")
    log(info["log"])

    # 3. kernel vs plain, per map
    smaps, poses_by_map, counts, errs = {}, {}, {}, []
    for name in MAPS:
        t0 = time.perf_counter()
        track = load_builtin(name, device="cuda")
        t1 = time.perf_counter()
        smap = build_sector_map(
            track.occupancy.cpu().numpy(), track.resolution,
            (track.origin_x, track.origin_y), max_range=MAX_RANGE,
            real_hw=(track.height, track.width), device="cuda")
        t2 = time.perf_counter()
        log(f"[{name}] map load {t1 - t0:.2f} s, host sector build "
            f"{t2 - t1:.2f} s: table {tuple(smap.table.shape)} "
            f"({smap.table.numel() * 4 / 1e6:.1f} MB), kv_sec {smap.kv_sec}, "
            f"{smap.n_segments} segments")
        poses = sample_free_poses(track, AGENTS, np.random.RandomState(0))
        smaps[name], poses_by_map[name] = smap, poses
        errs.append(check_kernel(name, track, smap, poses, counts))
        log(f"[{name}] rows {counts[name]['rows']}, mean real slots per "
            f"visited list {counts[name]['mean_real_slots']:.1f}")

    # 4. the main path, counted
    bundles = {name: build_sim(name, backend="auto", device="cuda")
               for name in MAPS}
    fov = bundles[MAPS[0]].scan.fov
    rs.sector_sweep.launches = 0
    outs = {}
    for name in MAPS:
        step = make_step_fn(bundles[name], with_noise=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        p = torch.as_tensor(poses_by_map[name], device="cuda")
        state0 = state_from_pose(p[:, 0], p[:, 1], p[:, 2])
        act = (torch.full((AGENTS,), 2.0, device="cuda"),
               torch.zeros(AGENTS, device="cuda"))
        first = step(state0, act, gen)
        run_fn = make_rollout_fn(step, make_gap_follower_policy(BEAMS, fov),
                                 STEPS, BEAMS)
        final, traj = run_fn(state0, gen)
        outs[name] = (first, final, traj)
    torch.cuda.synchronize()
    launches = rs.sector_sweep.launches
    log(f"main path: {len(MAPS)} maps x (1 step + {STEPS}-step rollout) -> "
        f"sector_sweep launches = {launches}")
    check(launches == len(MAPS) * (STEPS + 1),
          f"the main path launched the kernel {launches} times")
    for name, (first, final, traj) in outs.items():
        check(tuple(first.ranges.shape) == (AGENTS, BEAMS)
              and tuple(traj["pose"].shape) == (STEPS, AGENTS, 3)
              and tuple(traj["collision"].shape) == (STEPS, AGENTS),
              f"{name}: output shapes")
        for t in (first.ranges, final.x, final.y, final.theta, traj["pose"]):
            check(t.device.type == "cuda" and bool(torch.isfinite(t).all()),
                  f"{name}: outputs not finite or not on the card")
        r = first.ranges
        log(f"[{name}] step ranges mean {float(r.mean()):.4f} m, min "
            f"{float(r.min()):.4f}, max {float(r.max()):.4f}; after "
            f"{STEPS} steps {int(traj['collision'][-1].sum())} of {AGENTS} "
            f"cars latched, mean speed {float(final.velocity.mean()):.3f} "
            "m/s")

    # 5. times
    times = {}
    for name in MAPS:
        times[name] = time_sweeps(name, smaps[name], poses_by_map[name], card)
        step = make_step_fn(bundles[name], with_noise=True)
        gen = torch.Generator(device="cuda").manual_seed(1)
        p = torch.as_tensor(poses_by_map[name], device="cuda")
        state = [state_from_pose(p[:, 0], p[:, 1], p[:, 2])]
        act = (torch.full((AGENTS,), 2.0, device="cuda"),
               torch.zeros(AGENTS, device="cuda"))

        def one(i):
            state[0] = step(state[0], act, gen).state
        ms = timed_ms(one, 50, warmup=5)
        times[name]["step_ms"] = ms
        log(f"[{name}] {card}: closed-loop step {ms:.4f} ms for {AGENTS} "
            f"agents = {AGENTS / (ms * 1e-3):.4e} env-steps/s")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # 6. the facade
    sim = RacecarSimulator(MAPS[0], device="cuda", seed=0)
    sim.set_pose(float(poses_by_map[MAPS[0]][0, 0]),
                 float(poses_by_map[MAPS[0]][0, 1]),
                 float(poses_by_map[MAPS[0]][0, 2]))
    sim.drive(1.0, 0.05)
    for _ in range(3):
        out = sim.update_pose()
    check(tuple(out.ranges.shape) == (BEAMS,)
          and tuple(out.state.x.shape) == ()
          and bool(torch.isfinite(out.ranges).all())
          and tuple(sim.run_scan().shape) == (BEAMS,), "facade outputs")
    log(f"facade: 3 update_pose calls on {MAPS[0]}, x "
        f"{float(sim.get_state().x):.4f}, collision "
        f"{bool(sim.check_collision())}")

    big = MAPS[-1]
    log(json.dumps({"kernels": [{
        "name": "sector_sweep", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(errs), "ms": times[big]["kernel_ms"],
        "plain_ms": times[big]["plain_ms"], "shape_of_ms": f"{big} "
        f"{AGENTS}x{BEAMS}", "ms_by_map": {n: times[n] for n in MAPS}}]}))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def main() -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "pyracecarsimulator_tpu_torch")):
        print("chip_smoke.py: the pyracecarsimulator_tpu_torch package is "
              "not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    device = run()
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
