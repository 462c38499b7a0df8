"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at full width (4096 agents, 1080 beams, 270 deg,
max_range 10) on both bundled maps, levine and berlin, and checks them:

1. the card's name and power limit, the PyTorch and CUDA versions;
2. builds the two kernels, ``csrc/sector_sweep.cu`` (the list-routed
   sweep) and ``csrc/dense_sweep.cu``, with one nvcc per source, started
   together;
3. per map, the sector backend: the list kernel against its plain PyTorch
   version on the card on the full 4096 x 1080 fan (mismatches must be 0),
   the CUDA scan against the CPU scan on 64 poses given the same fan
   (bit-identical), and the scan against the float64 brute-force oracle
   ``maps.segments.raycast_segments_numpy`` on a few poses;
4. per map, the dense "segments" backend (the default): the kernel its
   default path runs (levine: the dense kernel; berlin: the list kernel
   over map tiles) against its plain version on the full fan, the CUDA
   scan against the CPU scan, the scan against the oracle; and the dense
   kernel over berlin's 4442 untiled segments against its plain version
   on 256 agents;
5. the sector routes of the JAX package's other two list kernels (mode
   "sorted_pl", ``use_pallas=True``) against the plain version, and their
   scans, counted, against the default sector scan;
6. the main path: ``build_sim(name)`` (default backend) -> one step plus
   a 20-step noisy rollout per map, with every launch counter set to 0
   just before and read just after (levine must have run the dense kernel,
   berlin the tile route, 21 times each); "segments_pallas" equal to
   "segments"; then the same drive on the sector backend;
7. 3 BPTT train steps (T = 5, 4096 x 1080) on berlin with "segments" and
   with "sectors": loss finite, parameters moved, counters grown;
8. times (CUDA events, warm-up, inputs that change between repetitions):
   each kernel and its plain version, the full scans, the closed-loop
   steps, one train step; peak device memory;
9. the reference-style facade ``RacecarSimulator`` with batch shape ().

Prints a JSON line describing the five TPU kernels' counterparts, then as
the last line ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}``. Exits non-zero, without that line, on any failure or
without a CUDA card.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

AGENTS = 4096
BEAMS = 1080
FOV = 4.712388980384690
MAX_RANGE = 10.0
STEPS = 20
TRAIN_T = 5
MAPS = ("levine", "berlin")
SRC = "pyracecarsimulator_tpu_torch/csrc/"
TPU = "pyracecarsimulator_tpu/ops/raycast_pallas.py:"
# wrapper name -> (CUDA source, the TPU kernel it replaces, where it runs)
KERNELS = {
    "sector_sweep": (SRC + "sector_sweep.cu", TPU + "704",
                     "sector backend"),
    "sorted_tiles_sweep": (SRC + "sector_sweep.cu", TPU + "505",
                           "sector backend, mode 'sorted_pl'"),
    "grp_sweep": (SRC + "sector_sweep.cu", TPU + "239",
                  "sector backend, use_pallas=True"),
    "dense_sweep": (SRC + "dense_sweep.cu", TPU + "116",
                    "segments backend, untiled maps (levine)"),
    "tile_sweep": (SRC + "sector_sweep.cu", TPU + "186",
                   "segments backend, tiled maps (berlin)"),
}


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


def wrappers():
    from pyracecarsimulator_tpu_torch.ops import sweeps
    return {name: getattr(sweeps, name) for name in KERNELS}


def reset_counts():
    for w in wrappers().values():
        w.launches = 0


def counts():
    return {name: w.launches for name, w in wrappers().items()}


def list_args(table, meta, ids, p, ct, st):
    """The list sweep's arguments for poses ``p`` (A, 3) whose padded fan
    (ct, st) (A, NBLK*bb) routes row by row to ``ids`` (A, NBLK)."""
    from pyracecarsimulator_tpu_torch.ops.common import _ray_invs
    g = ids.numel()
    nblk = g // p.shape[0]
    bb = ct.shape[1] // nblk
    ic, is_ = _ray_invs(ct, st)
    return (table, meta, ids.reshape(g).contiguous(),
            p[:, 0].repeat_interleave(nblk).contiguous(),
            p[:, 1].repeat_interleave(nblk).contiguous(),
            *(v.reshape(g, bb).contiguous() for v in (ct, st, ic, is_)))


def sector_case(smap, p):
    """(fan, args of the list sweep) of the sector scan of poses ``p``."""
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
    bb = rs.sector_block_width(smap, BEAMS, FOV)
    ct, st = rs.fan_cos_sin(p[:, 2], rs._padded_offsets(BEAMS, FOV, bb,
                                                        p.device))
    ids = rs._list_ids(smap.tiles_shape, smap.tile_size, smap.tile_origin,
                       smap.ns, p[:, 0], p[:, 1], ct, st, bb)
    return (ct, st), list_args(smap.table, smap.meta, ids, p, ct, st)


def segment_case(segmap, p):
    """(fan, args of the sweep the default segments path runs) for poses
    ``p``: the tile route on tiled maps, the dense sweep otherwise."""
    from pyracecarsimulator_tpu_torch.ops.common import (
        _padded_offsets, _ray_invs, beam_angles, fan_cos_sin, tile_ids)
    if segmap.tiles is not None:
        ct, st = fan_cos_sin(p[:, 2], _padded_offsets(BEAMS, FOV, 128,
                                                      p.device))
        nblk = ct.shape[1] // 128
        tid = tile_ids(segmap.tiles_shape, segmap.tile_size,
                       segmap.tile_origin, p[:, 0], p[:, 1])
        ids = tid[:, None].expand(-1, nblk).to(segmap.tile_sweep_meta.dtype)
        return (ct, st), list_args(segmap.tiles, segmap.tile_sweep_meta,
                                   ids, p, ct, st)
    ct, st = fan_cos_sin(p[:, 2], beam_angles(BEAMS, FOV, p.device))
    ic, is_ = _ray_invs(ct, st)
    flat = lambda v: v.reshape(-1).contiguous()
    return (ct, st), (segmap.params, segmap.sweep_meta,
                      flat(p[:, 0:1].expand(ct.shape)),
                      flat(p[:, 1:2].expand(ct.shape)),
                      *map(flat, (ct, st, ic, is_)))


def plain_of(name):
    from pyracecarsimulator_tpu_torch.ops import sweeps
    return (sweeps.dense_sweep_plain if name == "dense_sweep"
            else sweeps.list_sweep_plain)


def kernel_vs_plain(label, name, args):
    """One launch of wrapper ``name`` against its plain version on the same
    tensors; 0 mismatches required. Returns the max abs error."""
    import torch
    bv, bh = wrappers()[name](*args)
    bv_p, bh_p = plain_of(name)(*args)
    torch.cuda.synchronize()
    mism = int(((bv != bv_p) | (bh != bh_p)).sum())
    err = max(float((bv.double() - bv_p.double()).abs().max()),
              float((bh.double() - bh_p.double()).abs().max()))
    log(f"[{label}] {name} vs plain on {tuple(bv.shape)} rays: (bv, bh) "
        f"mismatches = {mism}, max abs err = {err}")
    check(mism == 0, f"{label}: {name} disagrees with its plain version")
    return err


def scan_checks(label, track, scan_rays, dev_map, cpu_map, poses, fan):
    """``scan_rays(map, poses, ct, st)`` on the card against the same on
    the CPU (same fan, 64 poses), and against the float64 oracle (8
    poses)."""
    import numpy as np
    import torch
    from pyracecarsimulator_tpu_torch.maps.segments import (
        extract_segments, raycast_segments_numpy)
    ct, st = fan
    p = torch.as_tensor(poses[:64], device="cuda")
    r_dev = scan_rays(dev_map, p, ct[:64], st[:64]).cpu()
    r_cpu = scan_rays(cpu_map, p.cpu(), ct[:64].cpu(), st[:64].cpu())
    same = bool(torch.equal(r_dev, r_cpu))
    log(f"[{label}] scan on cuda vs CPU plain scan, same fan, 64 poses: "
        f"bit-identical = {same}")
    check(same, f"{label}: device scan differs from the CPU scan")
    segs = extract_segments(track.occupancy.cpu().numpy(), track.resolution,
                            (track.origin_x, track.origin_y))
    k = 8
    c64, s64 = (v[:k, :BEAMS].cpu().numpy().astype(np.float64)
                for v in (ct, st))
    ora = np.stack([raycast_segments_numpy(
        segs, np.full(BEAMS, poses[i, 0], np.float64),
        np.full(BEAMS, poses[i, 1], np.float64), c64[i], s64[i], MAX_RANGE)
        for i in range(k)])
    d = np.abs(r_dev[:k].numpy() - ora)
    share = float(np.mean(d <= 1e-4))
    log(f"[{label}] scan vs float64 brute-force oracle ({len(segs)} "
        f"segments, {k} poses): share within 1e-4 m = {share}, max abs "
        f"diff = {float(d.max())}")
    check(share >= 0.999, f"{label}: scan disagrees with the oracle")


def time_kernel(name, sets, plain_reps=5):
    """Kernel, plain, kernel over the argument sets in turn."""
    w, plain = wrappers()[name], plain_of(name)
    n = len(sets)
    k_ms = timed_ms(lambda i: w(*sets[i % n]), 50)
    p_ms = timed_ms(lambda i: plain(*sets[i % n]), plain_reps, warmup=1)
    k2_ms = timed_ms(lambda i: w(*sets[i % n]), 50)
    return {"ms": k_ms, "ms_2": k2_ms, "plain_ms": p_ms}


def pose_sets(poses, n=5):
    import torch
    out = []
    for j in range(n):
        p = torch.as_tensor(poses, device="cuda").clone()
        p[:, 2] += j * 1e-3
        out.append(p)
    return out


def drive(bundles, backend_label, poses_by_map):
    """One step and a STEPS-step noisy rollout per map, counted. Returns
    {map: launch counts} and checks the outputs."""
    import torch
    from pyracecarsimulator_tpu_torch import make_step_fn, state_from_pose
    from pyracecarsimulator_tpu_torch.parallel import (
        make_gap_follower_policy, make_rollout_fn)
    used = {}
    for name, bundle in bundles.items():
        step = make_step_fn(bundle, with_noise=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        p = torch.as_tensor(poses_by_map[name], device="cuda")
        state0 = state_from_pose(p[:, 0], p[:, 1], p[:, 2])
        act = (torch.full((AGENTS,), 2.0, device="cuda"),
               torch.zeros(AGENTS, device="cuda"))
        run_fn = make_rollout_fn(step, make_gap_follower_policy(
            BEAMS, bundle.scan.fov), STEPS, BEAMS)
        reset_counts()
        first = step(state0, act, gen)
        final, traj = run_fn(state0, gen)
        torch.cuda.synchronize()
        used[name] = {k: v for k, v in counts().items() if v}
        log(f"[{name}] {backend_label} main path (1 step + {STEPS}-step "
            f"rollout): launches {used[name]}")
        check(tuple(first.ranges.shape) == (AGENTS, BEAMS)
              and tuple(traj["pose"].shape) == (STEPS, AGENTS, 3)
              and tuple(traj["collision"].shape) == (STEPS, AGENTS),
              f"{name}: output shapes")
        for t in (first.ranges, final.x, final.y, final.theta, traj["pose"]):
            check(t.device.type == "cuda" and bool(torch.isfinite(t).all()),
                  f"{name}: outputs not finite or not on the card")
        r = first.ranges
        log(f"[{name}] {backend_label} step ranges mean "
            f"{float(r.mean()):.4f} m, min {float(r.min()):.4f}, max "
            f"{float(r.max()):.4f}; after {STEPS} steps "
            f"{int(traj['collision'][-1].sum())} of {AGENTS} cars latched, "
            f"mean speed {float(final.velocity.mean()):.3f} m/s")
    return used


def step_ms(bundle, poses):
    import torch
    from pyracecarsimulator_tpu_torch import make_step_fn, state_from_pose
    step = make_step_fn(bundle, with_noise=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    p = torch.as_tensor(poses, device="cuda")
    state = [state_from_pose(p[:, 0], p[:, 1], p[:, 2])]
    act = (torch.full((AGENTS,), 2.0, device="cuda"),
           torch.zeros(AGENTS, device="cuda"))

    def one(i):
        state[0] = step(state[0], act, gen).state
    return timed_ms(one, 50, warmup=5)


def train_phase(bundle, poses, label):
    """3 BPTT train steps at full width; returns (losses, train-step ms,
    launch counts of the 3 steps)."""
    import torch
    from pyracecarsimulator_tpu_torch import (SimParams, make_step_fn,
                                              state_from_pose)
    from pyracecarsimulator_tpu_torch.parallel import make_bptt_train_fn
    bundle = bundle._replace(sim=SimParams(steer_mode="smooth"))
    step = make_step_fn(bundle, with_noise=False)

    def policy(params, state, ranges, t):
        steer = torch.tanh(ranges @ params["w"] + params["b"])
        return torch.full(state.batch_shape, 2.0, device="cuda"), steer

    def loss_fn(out, t):
        return (torch.mean((out.ranges - 10.0) ** 2)
                + 10.0 * torch.mean(out.collision.float()))

    train, init = make_bptt_train_fn(
        step, policy, loss_fn, TRAIN_T, BEAMS,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=3e-3))
    params = {"w": torch.zeros(BEAMS, device="cuda"),
              "b": torch.zeros((), device="cuda")}
    opt = init(params)
    p = torch.as_tensor(poses, device="cuda")
    s0 = state_from_pose(p[:, 0], p[:, 1], p[:, 2])
    reset_counts()
    losses = []
    for _ in range(3):
        params, opt, loss, final = train(params, opt, s0)
        losses.append(float(loss))
    used = {k: v for k, v in counts().items() if v}
    moved = float(params["w"].detach().abs().sum())
    log(f"[berlin] {label} BPTT, {TRAIN_T} steps x {AGENTS} x {BEAMS}: "
        f"losses {losses}, |w|_1 after 3 Adam steps {moved}, launches "
        f"{used}")
    check(all(math.isfinite(v) for v in losses),
          f"{label}: training loss not finite")
    check(moved > 0, f"{label}: parameters did not move")
    ms = timed_ms(lambda i: train(params, opt, s0), 3, warmup=1)
    return losses, ms, used


def run():
    import numpy as np
    import torch
    from pyracecarsimulator_tpu_torch import RacecarSimulator, build_sim
    from pyracecarsimulator_tpu_torch.maps import (build_sector_map,
                                                   load_builtin,
                                                   sample_free_poses)
    from pyracecarsimulator_tpu_torch.maps.segments import build_segment_map
    from pyracecarsimulator_tpu_torch.ops import _kernels
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
    from pyracecarsimulator_tpu_torch.ops import raycast_segments as rseg

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    # 2. build, one nvcc per source, together
    t0 = time.perf_counter()
    _kernels.build("sector_sweep", "dense_sweep")
    log(f"built both kernels in {time.perf_counter() - t0:.2f} s wall; "
        f"nvcc: {' '.join(_kernels.NVCC_FLAGS)}")
    for name, info in _kernels.build_info.items():
        log(f"{name}: {info['seconds']:.2f} s\n{info['log']}")

    errs = {name: [] for name in KERNELS}
    times = {name: {} for name in KERNELS}
    tracks, smaps, segmaps, poses_by_map = {}, {}, {}, {}
    sector_scan = lambda m, p, ct, st: rs._scan_chunk(
        m, p, ct, st, BEAMS, MAX_RANGE, rs.sector_block_width(m, BEAMS, FOV))
    segment_scan = lambda m, p, ct, st: rseg._scan_rays(
        m, p, ct, st, BEAMS, MAX_RANGE)
    for name in MAPS:
        t0 = time.perf_counter()
        track = load_builtin(name, device="cuda")
        t1 = time.perf_counter()
        occ = track.occupancy.cpu().numpy()
        args = (occ, track.resolution, (track.origin_x, track.origin_y))
        kw = dict(max_range=MAX_RANGE, real_hw=(track.height, track.width),
                  device="cuda")
        smap = build_sector_map(*args, **kw)
        t2 = time.perf_counter()
        segmap = build_segment_map(*args, tile_size=4.0, **kw)
        t3 = time.perf_counter()
        log(f"[{name}] map load {t1 - t0:.2f} s; host sector build "
            f"{t2 - t1:.2f} s: table {tuple(smap.table.shape)}, kv_sec "
            f"{smap.kv_sec}; host segment build {t3 - t2:.2f} s: params "
            f"{tuple(segmap.params.shape)}, kv {segmap.kv}, sweep_meta "
            f"{segmap.sweep_meta.tolist()}, tiles "
            f"{None if segmap.tiles is None else tuple(segmap.tiles.shape)}"
            f", kv_tile {segmap.kv_tile}; {segmap.n_segments} segments")
        poses = sample_free_poses(track, AGENTS, np.random.RandomState(0))
        tracks[name], smaps[name], segmaps[name] = track, smap, segmap
        poses_by_map[name] = poses
        p = torch.as_tensor(poses, device="cuda")

        # 3. the sector backend
        fan, args = sector_case(smap, p)
        errs["sector_sweep"].append(
            kernel_vs_plain(f"{name} sectors", "sector_sweep", args))
        m = smap.meta[args[2].long()]
        log(f"[{name}] sector rows {args[2].numel()}, mean real slots per "
            f"visited list {float((m[:, 0] + m[:, 2] - m[:, 1]).float().mean()):.1f}")
        scan_checks(f"{name} sectors", track, sector_scan, smap,
                    smap.to("cpu"), poses, fan)

        # 4. the segments backend
        kname = "tile_sweep" if segmap.tiles is not None else "dense_sweep"
        check(kname == {"levine": "dense_sweep",
                        "berlin": "tile_sweep"}[name],
              f"{name}: the default map layout changed")
        fan, args = segment_case(segmap, p)
        errs[kname].append(kernel_vs_plain(f"{name} segments", kname, args))
        if kname == "tile_sweep":
            m = segmap.tile_sweep_meta[args[2].long()]
            log(f"[{name}] tile rows {args[2].numel()}, mean real slots "
                f"per visited tile list "
                f"{float((m[:, 0] + m[:, 2] - m[:, 1]).float().mean()):.1f}")
        scan_checks(f"{name} segments", track, segment_scan, segmap,
                    segmap.to("cpu"), poses, fan)
        times[kname][name] = time_kernel(
            kname, [segment_case(segmap, q)[1] for q in pose_sets(poses)])
        times["sector_sweep"][name] = time_kernel(
            "sector_sweep",
            [sector_case(smap, q)[1] for q in pose_sets(poses)])

    # 4b. the dense kernel over berlin's untiled set: several smem chunks
    flat = build_segment_map(
        tracks["berlin"].occupancy.cpu().numpy(), tracks["berlin"].resolution,
        (tracks["berlin"].origin_x, tracks["berlin"].origin_y),
        max_range=MAX_RANGE, tile_size=0.0, device="cuda",
        real_hw=(tracks["berlin"].height, tracks["berlin"].width))
    check(flat.tiles is None, "berlin untiled build kept tiles")
    few = [q[:256] for q in pose_sets(poses_by_map["berlin"])]
    errs["dense_sweep"].append(kernel_vs_plain(
        "berlin untiled, 256 agents", "dense_sweep",
        segment_case(flat, few[0])[1]))
    times["dense_sweep"]["berlin_untiled_256"] = time_kernel(
        "dense_sweep", [segment_case(flat, q)[1] for q in few])
    full = [segment_case(flat, q)[1]
            for q in pose_sets(poses_by_map["berlin"], 2)]
    times["dense_sweep"]["berlin_untiled_4096_kernel_only_ms"] = timed_ms(
        lambda i: wrappers()["dense_sweep"](*full[i % 2]), 5, warmup=1)

    # 5. the sector routes of kernels 2.2 and 2.3, counted
    big = MAPS[-1]
    sets = [sector_case(smaps[big], q)[1]
            for q in pose_sets(poses_by_map[big])]
    p = torch.as_tensor(poses_by_map[big], device="cuda")
    ref = rs.scan_poses_sectors(smaps[big], p, num_beams=BEAMS, fov=FOV,
                                max_range=MAX_RANGE)
    route_counts = {}
    for name, kw in (("sorted_tiles_sweep", dict(mode="sorted_pl")),
                     ("grp_sweep", dict(use_pallas=True))):
        errs[name].append(kernel_vs_plain(f"{big} sectors", name, sets[0]))
        reset_counts()
        got = rs.scan_poses_sectors(smaps[big], p, num_beams=BEAMS, fov=FOV,
                                    max_range=MAX_RANGE, **kw)
        torch.cuda.synchronize()
        route_counts[name] = counts()[name]
        same = bool(torch.equal(got, ref))
        log(f"[{big}] sector scan with {kw}: launches {counts()}, equal to "
            f"the default sector scan = {same}")
        check(same and route_counts[name] == 1 and sum(counts().values()) == 1,
              f"{name}: the route did not run alone or changed the scan")
        times[name][big] = time_kernel(name, sets)

    # 6. the main path: the default backend, then the sector backend
    seg_bundles = {name: build_sim(name, device="cuda") for name in MAPS}
    check(all(b.backend == "segments" for b in seg_bundles.values()),
          "build_sim's default backend is not 'segments'")
    main_counts = drive(seg_bundles, "segments", poses_by_map)
    check(main_counts["levine"] == {"dense_sweep": STEPS + 1}
          and main_counts["berlin"] == {"tile_sweep": STEPS + 1},
          f"the default path launched {main_counts}")
    from pyracecarsimulator_tpu_torch import make_step_fn, state_from_pose
    for name in MAPS:
        p = torch.as_tensor(poses_by_map[name], device="cuda")
        s0 = state_from_pose(p[:, 0], p[:, 1], p[:, 2])
        act = (torch.full((AGENTS,), 2.0, device="cuda"),
               torch.zeros(AGENTS, device="cuda"))
        pal = build_sim(name, backend="segments_pallas", device="cuda")
        a = make_step_fn(seg_bundles[name], with_noise=False)(s0, act)
        b = make_step_fn(pal, with_noise=False)(s0, act)
        same = all(bool(torch.equal(u, v)) for u, v in (
            (a.ranges, b.ranges), (a.state.pose, b.state.pose),
            (a.collision, b.collision)))
        log(f"[{name}] segments_pallas step equals segments step: {same}")
        check(same, f"{name}: segments_pallas differs from segments")
    sec_bundles = {name: build_sim(name, backend="sectors", device="cuda")
                   for name in MAPS}
    sec_counts = drive(sec_bundles, "sectors", poses_by_map)
    check(all(c == {"sector_sweep": STEPS + 1} for c in sec_counts.values()),
          f"the sector path launched {sec_counts}")

    # 7. BPTT on berlin, both backends
    train = {}
    for label, bundle, kname in (
            ("segments", seg_bundles[big], "tile_sweep"),
            ("sectors", sec_bundles[big], "sector_sweep")):
        torch.cuda.reset_peak_memory_stats()
        losses, ms, used = train_phase(bundle, poses_by_map[big], label)
        check(used == {kname: 3 * TRAIN_T},
              f"{label} training launched {used}")
        train[label] = {"losses": losses, "train_step_ms": ms,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "launches": used}
        log(f"[{big}] {card}: {label} train step (T={TRAIN_T}, fwd + bwd, "
            f"Adam) {ms:.4f} ms, peak device memory "
            f"{train[label]['peak_gb']:.2f} GB")

    # 8. scan and step times
    rays = AGENTS * BEAMS
    for name in MAPS:
        sets = pose_sets(poses_by_map[name])
        for label, scan, m in (
                ("segments", rseg.scan_poses_segments, segmaps[name]),
                ("sectors", rs.scan_poses_sectors, smaps[name])):
            ms = timed_ms(lambda i: scan(m, sets[i % 5], num_beams=BEAMS,
                                         fov=FOV, max_range=MAX_RANGE), 20)
            times.setdefault("scans", {})[f"{name} {label}"] = ms
            log(f"[{name}] {card}: full {label} scan {ms:.4f} ms "
                f"({rays / (ms * 1e-3):.4e} rays/s)")
        for label, bundles in (("segments", seg_bundles),
                               ("sectors", sec_bundles)):
            ms = step_ms(bundles[name], poses_by_map[name])
            times.setdefault("steps", {})[f"{name} {label}"] = ms
            log(f"[{name}] {card}: closed-loop {label} step {ms:.4f} ms = "
                f"{AGENTS / (ms * 1e-3):.4e} env-steps/s")
    for name, t in times.items():
        if name in KERNELS:
            for shape, v in t.items():
                log(f"{card}: {name} {shape}: {v}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        "GB")

    # 9. the facade, default backend
    sim = RacecarSimulator(MAPS[0], device="cuda", seed=0)
    sim.set_pose(*map(float, poses_by_map[MAPS[0]][0]))
    sim.drive(1.0, 0.05)
    for _ in range(3):
        out = sim.update_pose()
    check(sim.backend == "segments" and tuple(out.ranges.shape) == (BEAMS,)
          and tuple(out.state.x.shape) == ()
          and bool(torch.isfinite(out.ranges).all())
          and tuple(sim.run_scan().shape) == (BEAMS,), "facade outputs")
    log(f"facade ({sim.backend}): 3 update_pose calls on {MAPS[0]}, x "
        f"{float(sim.get_state().x):.4f}, collision "
        f"{bool(sim.check_collision())}")

    launches = {"sector_sweep": sum(c.get("sector_sweep", 0)
                                    for c in sec_counts.values()),
                "dense_sweep": main_counts["levine"]["dense_sweep"],
                "tile_sweep": main_counts["berlin"]["tile_sweep"],
                **route_counts}
    shape_of = {"dense_sweep": "levine", "tile_sweep": "berlin",
                "sector_sweep": "berlin", "sorted_tiles_sweep": "berlin",
                "grp_sweep": "berlin"}
    log(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "path": path, "launches": launches[name],
        "max_abs_err": max(errs[name]),
        "ms": times[name][shape_of[name]]["ms"],
        "plain_ms": times[name][shape_of[name]]["plain_ms"],
        "shape_of_ms": f"{shape_of[name]} {AGENTS}x{BEAMS}",
        "ms_by_shape": times[name]}
        for name, (src, rep, path) in KERNELS.items()],
        "scans_ms": times["scans"], "steps_ms": times["steps"],
        "train": train, "card": card}))
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
