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
9. the reference-style facade ``RacecarSimulator`` with batch shape ();
10. per map, the "edf" march (plain PyTorch, no kernel): the CUDA march
    against the CPU march on 64 poses given the same fan (bit-identical),
    the scan against the NumPy oracle ``oracle/raycast.py`` on 2 poses
    (tests/test_raymarch.py's bound), the full scan's time and its device
    operations per scan (profiler); the "edf" step and a 20-step rollout,
    counted (no kernel of the five may run), and the step's time;
11. per map, "edf_implicit" forward and backward at full width (EDF and
    pose gradients finite and non-zero); "edf_bilinear" forward at full
    width, forward and backward at 256 agents (autograd keeps every trip);
12. ``make_scan_fn(map_grad=True)`` on berlin's sector backend: forward
    equal to ``scan_poses_sectors`` bit for bit, EDF cotangent finite and
    non-zero, ``sector_sweep`` launched exactly once per scan; the dedup
    cotangent against the scatter one;
13. per map, ``soft_edt`` of the occupancy on the card against the CPU
    (hard min: bit-identical; softmin: 1e-4), and its time;
14. per map, "segments_simplified": the CUDA scan against the CPU scan
    given the same fan (bit-identical), the scan, step and rollout,
    counted (no kernel), and times;
15. per map, the obstacle cycle through ``RacecarSimulator(device="cuda")``
    on "segments", "sectors", "edf" and "segments_simplified": a box 1 m
    ahead of the scanner shortens the beam straight ahead; the sector
    incremental edit gives exactly the full rebuild's ranges; the launch
    counters show the dense or tile kernel, or the sector kernel, on the
    edited map; ``clear_obstacles`` restores the earlier scan bit for bit;
    the host time of ``add_obstacle``;
16. multitrack at full width: levine + berlin stacked, 2048 agents per
    map: the list kernel against its plain version over the stacked
    table, ``scan_poses_sectors_multi`` equal bit for bit to the two
    per-map scans, exactly one ``sector_sweep`` launch per multi scan (one
    ``sorted_tiles_sweep`` launch with ``mode="sorted_pl"``), forward +
    backward, times;
17. a 1 x 1 mesh on the card, backend NCCL, in this process: the sharded
    sector step equal to ``make_step_fn``'s, the stacked step equal to the
    multitrack scan, the ring scan (one slab) equal to
    ``scan_poses_sectors``, all bit for bit, counted and timed; the
    ring's one launch (the gathered buffer as the table) against its plain
    version;
18. four gloo ranks on the one card through ``parallel.dryrun`` (mesh
    2 x 2, berlin, 1024 agents): the dense, sector and ring sweeps at the
    wedges' shapes against their plain versions; gathered ranges,
    collisions and pose gradients against the unsharded run and the
    oracle, each rank's launches;
19. ``utils.debug.checked`` on a clean and on a poisoned step;
    ``utils.profiling.rays_per_second`` of the berlin sector scan.

Every kernel's time stands beside its bound: the larger of its
instruction slots (``OPS_PER_TEST`` per ray-segment test, counted from the
real slots of the lists this run visits) over the card's FP32 instruction
rate at ``clocks.max.sm``, and its bytes (each input and output once) over
the HBM rate.

Prints a JSON line describing the five TPU kernels' counterparts (their
launches path by path, each path counted from 0), then as
the last line ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}``. Exits non-zero, without that line, on any failure or
without a CUDA card.
"""

from __future__ import annotations

import json
import math
import os
import re
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


# the bound's model: instruction slots per ray-segment test (7 separately
# rounded float32 operations, 2 compares, 1 select; -fmad=false forbids
# fusing), FP32 lanes per SM, and the HBM rate of an H100 SXM (NVIDIA's
# data sheet)
OPS_PER_TEST = 10
LANES_PER_SM = 128
HBM_BYTES_PER_S = 3.35e12


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


def card_rates():
    """The card's FP32 instruction rate (SMs x lanes x the maximum SM clock
    that nvidia-smi reports) and HBM rate: what the bounds divide by."""
    import torch
    props = torch.cuda.get_device_properties(0)
    try:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60).stdout.strip().splitlines()[0])
    except (ValueError, IndexError):    # "[N/A]": take PyTorch's figure
        mhz = props.clock_rate / 1e3
    sms = props.multi_processor_count
    return {"sm_clock_max_mhz": mhz, "sms": sms,
            "slots_per_s": sms * LANES_PER_SM * mhz * 1e6,
            "hbm_bytes_per_s": HBM_BYTES_PER_S}


def timed_ms(fn, reps, warmup=2):
    """Mean milliseconds per call of ``fn(i)`` over ``reps`` calls, after
    ``warmup`` calls; CUDA events on the card."""
    from pyracecarsimulator_tpu_torch.utils.profiling import timed_loop
    return timed_loop(fn, reps=reps, warmup=warmup, index=True,
                      device="cuda") * 1e3


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


def bound_of(name, args, rates):
    """The least time the card could take for one call of wrapper ``name``
    on ``args``: the larger of instruction slots over the instruction rate
    and bytes over the HBM rate. Tests are counted from the real slots of
    the lists the rows visit; bytes count each visited list, each ray
    tensor and each output once."""
    import torch
    if name == "dense_sweep":
        params, sweep_meta, x = args[0], args[1], args[2]
        k = params.shape[1]
        v_hi, h_lo, h_end = (int(v) for v in sweep_meta.tolist())
        h_lo = min(max(h_lo, 0), k)
        slots = min(max(v_hi, 0), k) + min(max(h_end, h_lo), k) - h_lo
        rays = x.numel()
        tests = rays * slots
        nbytes = 12 * slots + 12 + 4 * rays * (6 + 2)
    else:
        table, meta, ids, _, _, ct = args[:6]
        k = table.shape[2]

        def real_slots(rows):
            m = meta[rows.long()].long()
            h_lo = m[:, 1].clamp(0, k)
            nv = torch.minimum(m[:, 0].clamp(min=0), h_lo)
            return nv + torch.maximum(m[:, 2], h_lo).clamp(max=k) - h_lo

        g, bb = ct.shape
        tests = int(real_slots(ids).sum()) * bb
        uniq = torch.unique(ids)
        nbytes = (12 * int(real_slots(uniq).sum()) + 12 * uniq.numel()
                  + 12 * g + 4 * g * bb * (4 + 2))
    ops_ms = tests * OPS_PER_TEST / rates["slots_per_s"] * 1e3
    bytes_ms = nbytes / rates["hbm_bytes_per_s"] * 1e3
    out = {"tests": tests, "bytes": nbytes, "bound_ops_ms": ops_ms,
           "bound_bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    # what the compiled loop spends per test (sass_report), where known:
    # the time its instruction stream needs at the full instruction rate
    per_test = rates.get("sass_per_test", {}).get(
        "dense_sweep" if name == "dense_sweep" else "sector_sweep")
    if per_test:
        out["compiled_slots_ms"] = (tests * per_test / rates["slots_per_s"]
                                    * 1e3)
    return out


def sass_report():
    """Where the toolkit has cuobjdump: the instructions each built
    kernel spends per ray-segment test, read from its SASS. A sweep loop
    is a backward branch whose body holds FSEL instructions, one per test
    (the select of the new minimum); the loop's instruction count over its
    FSEL count is what the compiled code spends per test, against the
    ``OPS_PER_TEST`` the function needs at least. With ``CHIP_SMOKE_OUT``
    set, the SASS is also written into that directory."""
    import shutil
    from pyracecarsimulator_tpu_torch.ops import _kernels
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_kernels.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        log("cuobjdump not found: the instruction slots per test are reasoned "
            "from the sources")
        return {}
    out_dir = os.environ.get("CHIP_SMOKE_OUT")
    report = {}
    for name, info in _kernels.build_info.items():
        sass = subprocess.run([tool, "-sass", info["path"]],
                              capture_output=True, text=True,
                              timeout=120).stdout
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"sass_{name}.txt"), "w") as f:
                f.write(sass)
        ins = [(int(a, 16), op, tgt) for a, op, tgt in re.findall(
            r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
            r"(?:[^;]*?\s(0x[0-9a-f]+)\s*;)?", sass, flags=re.M)]
        back = [(int(tgt, 16), addr) for addr, op, tgt in ins
                if op == "BRA" and tgt and int(tgt, 16) < addr]
        loops = []
        for lo, hi in back:
            if any((a, b) != (lo, hi) and lo <= a and b <= hi
                   for a, b in back):
                continue                 # not innermost
            body = [o for a, o, _ in ins if lo <= a <= hi]
            if "FSEL" in body:
                mix = {o: body.count(o) for o in sorted(set(body))}
                loops.append({"instructions": len(body),
                              "tests": mix["FSEL"],
                              "per_test": len(body) / mix["FSEL"],
                              "mix": mix})
        report[name] = loops
        for lp in loops:
            log(f"{name}: SASS sweep loop of {lp['tests']} test(s): "
                f"{lp['instructions']} instructions = {lp['per_test']:.2f} "
                f"per test {lp['mix']}")
        check(loops, f"{name}: no sweep loop found in the SASS")
    return report


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


def time_kernel(name, sets, rates, plain_reps=5):
    """Kernel, plain, kernel over the argument sets in turn, beside the
    bound of the first set."""
    w, plain = wrappers()[name], plain_of(name)
    n = len(sets)
    k_ms = timed_ms(lambda i: w(*sets[i % n]), 50)
    p_ms = timed_ms(lambda i: plain(*sets[i % n]), plain_reps, warmup=1)
    k2_ms = timed_ms(lambda i: w(*sets[i % n]), 50)
    out = {"ms": k_ms, "ms_2": k2_ms, "plain_ms": p_ms,
           **bound_of(name, sets[0], rates)}
    out["share_of_bound"] = out["bound_ms"] / min(k_ms, k2_ms)
    return out


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


def step_ms(bundle, poses, reps=50):
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
    return timed_ms(one, reps, warmup=min(5, reps))


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


def device_ops(fn):
    """CUDA kernels and copies one call of ``fn()`` puts on the card,
    counted by the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return int(sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA))


def same_fan_check(label, fn, dev_args, exact=True, tol=0.0):
    """``fn(*args)`` on the card against ``fn`` on CPU copies of the same
    tensors and maps: bit-identical (``exact``) or within ``tol``."""
    import torch
    cpu = [a.to("cpu") for a in dev_args]
    got = fn(*dev_args).cpu()
    ref = fn(*cpu)
    err = float((got.double() - ref.double()).abs().max())
    same = bool(torch.equal(got, ref))
    log(f"[{label}] cuda vs CPU on {tuple(got.shape)}: bit-identical = "
        f"{same}, max abs err = {err}")
    check(same if exact else err <= tol, f"{label}: cuda differs from CPU")
    return err


def march_phases(card, name, track, poses):
    """10-11: the EDF march backends on one map. Returns the times."""
    import numpy as np
    import torch
    from pyracecarsimulator_tpu_torch import build_sim, make_scan_fn
    from pyracecarsimulator_tpu_torch.oracle import raycast as orc
    from pyracecarsimulator_tpu_torch.ops import raymarch_xla as rx
    from pyracecarsimulator_tpu_torch.ops.common import rays_from_poses
    from pyracecarsimulator_tpu_torch.ops.raymarch_diff import (
        scan_poses_implicit)
    out = {}
    bundle = build_sim(track, backend="edf", device="cuda")
    sc = bundle.scan
    org = torch.tensor([track.origin_x, track.origin_y], device="cuda")
    hw = (track.height, track.width)
    kw = dict(max_range=MAX_RANGE, eps=sc.ray_tracing_epsilon,
              max_iters=sc.max_march_iters, bounds_hw=hw)
    p = torch.as_tensor(poses, device="cuda")
    _, _, xb, yb, ct, st = rays_from_poses(p[:64], BEAMS, FOV)
    same_fan_check(f"{name} edf march, 64 poses", lambda e, o, *r:
                   rx.march_rays(e, track.resolution, o, *r, **kw),
                   (track.edf, org, xb, yb, ct, st))
    scan = make_scan_fn(bundle)
    edf_np = track.edf.cpu().numpy()
    for i in range(2):
        ref = orc.scan(edf_np, track.resolution,
                       (track.origin_x, track.origin_y), poses[i],
                       num_beams=BEAMS, fov=FOV, max_range=MAX_RANGE,
                       eps=sc.ray_tracing_epsilon, bounds_hw=hw)
        d = np.abs(scan(p[i]).cpu().numpy() - ref)
        log(f"[{name}] edf scan vs NumPy oracle, pose {i}: share within "
            f"1e-3 m = {float((d < 1e-3).mean())}, max abs diff = "
            f"{float(d.max())}")
        check((d < 1e-3).mean() > 0.99 and d.max() < 3 * track.resolution,
              f"{name}: edf scan disagrees with the oracle")
    sets = pose_sets(poses)
    out["edf_scan_ms"] = timed_ms(lambda i: scan(sets[i % 5]), 5, warmup=1)
    out["edf_scan_device_ops"] = device_ops(lambda: scan(sets[0]))
    out["edf_step_ms"] = step_ms(bundle, poses, reps=10)
    log(f"[{name}] {card}: edf scan {out['edf_scan_ms']:.4f} ms "
        f"({out['edf_scan_device_ops']} device ops per scan), closed-loop "
        f"edf step {out['edf_step_ms']:.4f} ms")

    # 11. the differentiable marches
    def implicit(edf, q):
        return scan_poses_implicit(edf, track.resolution, org, q,
                                   num_beams=BEAMS, fov=FOV, **kw)

    def fwd_bwd(scan_fn, q):
        edf = track.edf.clone().requires_grad_(True)
        q = q.clone().requires_grad_(True)
        scan_fn(edf, q).sum().backward()
        return edf.grad, q.grad

    def bilinear(edf, q):
        return rx.scan_poses(edf, track.resolution, org, q, num_beams=BEAMS,
                             fov=FOV, interp="bilinear", **kw)

    for label, fn, q in (("edf_implicit", implicit, p),
                         ("edf_bilinear", bilinear, p[:256])):
        g_edf, g_pose = fwd_bwd(fn, q)
        torch.cuda.synchronize()
        ok = all(bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
                 for g in (g_edf, g_pose))
        log(f"[{name}] {label} fwd+bwd on {q.shape[0]} x {BEAMS}: EDF grad "
            f"|.|_1 {float(g_edf.abs().sum()):.4f}, pose grad |.|_1 "
            f"{float(g_pose.abs().sum()):.4f}, finite and non-zero = {ok}")
        check(ok, f"{name}: {label} gradients")
        torch.cuda.reset_peak_memory_stats()
        out[f"{label}_fwd_bwd_ms"] = timed_ms(
            lambda i: fwd_bwd(fn, sets[i % 5][: q.shape[0]]), 2, warmup=1)
        out[f"{label}_fwd_bwd_agents"] = q.shape[0]
        out[f"{label}_fwd_bwd_peak_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
        with torch.no_grad():
            out[f"{label}_fwd_ms"] = timed_ms(
                lambda i: fn(track.edf, sets[i % 5]), 3, warmup=1)
        log(f"[{name}] {card}: {label} forward {AGENTS} x {BEAMS} "
            f"{out[f'{label}_fwd_ms']:.4f} ms; forward + backward "
            f"{q.shape[0]} x {BEAMS} {out[f'{label}_fwd_bwd_ms']:.4f} ms, "
            f"peak {out[f'{label}_fwd_bwd_peak_gb']:.2f} GB")
    out["edf_launches"] = drive({name: bundle}, "edf", {name: poses})[name]
    check(out["edf_launches"] == {},
          f"{name}: the edf path launched {out['edf_launches']}")
    return out


def mapgrad_phase(card, smap_bundle, poses):
    """12: make_scan_fn(map_grad=True) on a sector bundle."""
    import torch
    from pyracecarsimulator_tpu_torch import make_scan_fn
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
    from pyracecarsimulator_tpu_torch.ops import raymarch_diff as rd
    track = smap_bundle.track
    scan_g = make_scan_fn(smap_bundle, map_grad=True)
    p = torch.as_tensor(poses, device="cuda")
    edf = track.edf.clone().requires_grad_(True)
    reset_counts()
    r = scan_g(p, edf)
    torch.cuda.synchronize()
    used = {k: v for k, v in counts().items() if v}
    ref = rs.scan_poses_sectors(smap_bundle.segmap, p, num_beams=BEAMS,
                                fov=FOV, max_range=MAX_RANGE)
    same = bool(torch.equal(r.detach(), ref))
    (r ** 2).sum().backward()
    g = edf.grad
    ok = bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
    log(f"[berlin] map_grad sector scan: launches {used}, forward equal to "
        f"scan_poses_sectors = {same}, EDF cotangent |.|_1 "
        f"{float(g.abs().sum()):.4f}, finite and non-zero = {ok}")
    check(used == {"sector_sweep": 1} and same and ok, "map_grad scan")
    sets = pose_sets(poses)
    n_scans = 3
    reset_counts()

    def fwd_bwd(i):
        e = track.edf.clone().requires_grad_(True)
        (scan_g(sets[i % 5], e) ** 2).sum().backward()
    ms = timed_ms(fwd_bwd, n_scans, warmup=0)
    grown = counts()
    log(f"[berlin] {card}: map_grad sector scan forward + backward "
        f"{ms:.4f} ms at {AGENTS} x {BEAMS}; launches over {n_scans} "
        f"scans {grown}")
    check(grown == {**{k: 0 for k in KERNELS}, "sector_sweep": n_scans},
          f"map_grad: {n_scans} scans launched {grown}")
    # dedup against scatter, on the forward's own rays
    from pyracecarsimulator_tpu_torch.ops.common import rays_from_poses
    _, _, xb, yb, cts, sts = rays_from_poses(p[:512], BEAMS, FOV)
    with torch.no_grad():
        r512 = rs.scan_poses_sectors(smap_bundle.segmap, p[:512],
                                     num_beams=BEAMS, fov=FOV,
                                     max_range=MAX_RANGE)
    grads = []
    for dedup in (False, True):
        e = track.edf.clone().requires_grad_(True)
        org = torch.tensor([track.origin_x, track.origin_y], device="cuda")
        (rd.with_map_gradient(e, r512, xb, yb, cts, sts, track.resolution,
                              org, 1e-4, (track.height, track.width),
                              dedup) ** 2).sum().backward()
        grads.append(e.grad)
    err = float((grads[0] - grads[1]).abs().max())
    scale = float(grads[0].abs().max())
    log(f"[berlin] with_map_gradient dedup vs scatter, 512 x {BEAMS}: max "
        f"abs diff {err} (max |cotangent| {scale})")
    check(err <= 1e-5 * scale + 1e-6, "dedup cotangent differs")
    return {"fwd_bwd_ms": ms, "launches": used, "dedup_err": err}


def soft_edt_phase(card, name, track):
    """13: soft_edt of the map's occupancy, card against CPU."""
    import torch
    from pyracecarsimulator_tpu_torch.ops.soft_edt import soft_edt
    out = {}
    for label, kw, exact, tol in (("hard", {}, True, 0.0),
                                  ("soft", dict(temperature=0.25), False,
                                   1e-4)):
        out[f"{label}_err"] = same_fan_check(
            f"{name} soft_edt {label} {tuple(track.occupancy.shape)}",
            lambda occ: soft_edt(occ, track.resolution, **kw),
            (track.occupancy,), exact=exact, tol=tol)
        out[f"{label}_ms"] = timed_ms(
            lambda i: soft_edt(track.occupancy, track.resolution, **kw), 3,
            warmup=1)
        log(f"[{name}] {card}: soft_edt {label} (64 iters) "
            f"{out[f'{label}_ms']:.4f} ms")
    return out


def simplified_phase(card, name, track, poses):
    """14: the "segments_simplified" backend on one map."""
    import torch
    from pyracecarsimulator_tpu_torch import build_sim, make_scan_fn
    from pyracecarsimulator_tpu_torch.ops import raycast_general as rg
    from pyracecarsimulator_tpu_torch.ops.common import (apply_extent_mask,
                                                         rays_from_poses)
    out = {}
    t0 = time.perf_counter()
    bundle = build_sim(track, backend="segments_simplified", device="cuda")
    gmap = bundle.segmap
    out["build_s"] = time.perf_counter() - t0
    log(f"[{name}] segments_simplified: {gmap.n_segments} general segments "
        f"(params {tuple(gmap.params.shape)}, tiles "
        f"{None if gmap.tiles is None else tuple(gmap.tiles.shape)}), host "
        f"build {out['build_s']:.2f} s")

    def scan_rays(m, q, xb, yb, ct, st):
        if m.tiles is not None:
            r = rg.raycast_general_tiled(m.tiles, m.tiles_shape, m.tile_size,
                                         m.tile_origin, q[:, 0], q[:, 1],
                                         xb, yb, ct, st, MAX_RANGE)
        else:
            r = rg.raycast_general(m.params, xb, yb, ct, st, MAX_RANGE)
        return apply_extent_mask(r, q[:, 0], q[:, 1], m.extent, MAX_RANGE)

    p = torch.as_tensor(poses, device="cuda")
    _, q, xb, yb, ct, st = rays_from_poses(p[:64], BEAMS, FOV)
    same_fan_check(f"{name} segments_simplified scan, 64 poses",
                   lambda m, *a: scan_rays(m, *a),
                   (gmap, q, xb, yb, ct, st))
    scan = make_scan_fn(bundle)
    sets = pose_sets(poses)
    out["scan_ms"] = timed_ms(lambda i: scan(sets[i % 5]), 5, warmup=1)
    out["step_ms"] = step_ms(bundle, poses, reps=10)
    out["launches"] = drive({name: bundle}, "segments_simplified",
                            {name: poses})[name]
    check(out["launches"] == {},
          f"{name}: segments_simplified launched {out['launches']}")
    log(f"[{name}] {card}: segments_simplified scan {out['scan_ms']:.4f} "
        f"ms, step {out['step_ms']:.4f} ms")
    return out


def obstacle_phase(card, name, track, poses):
    """15: the facade's obstacle cycle on four backends of one map."""
    import numpy as np
    import torch
    from pyracecarsimulator_tpu_torch import RacecarSimulator
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
    edf = track.edf.cpu().numpy()[: track.height, : track.width]
    iy, ix = np.unravel_index(np.argmax(edf), edf.shape)
    x = track.origin_x + (ix + 0.5) * track.resolution
    y = track.origin_y + (iy + 0.5) * track.resolution
    ahead = BEAMS // 2                 # the beam straight ahead
    box_x = x + 0.275 + 1.0            # 1 m ahead of the scanner
    expect = {"segments": {"levine": "dense_sweep",
                           "berlin": "tile_sweep"}[name],
              "sectors": "sector_sweep", "edf": None,
              "segments_simplified": None}
    out = {}
    for backend, kname in expect.items():
        sim = RacecarSimulator(track, backend=backend, device="cuda",
                               with_noise=False)
        sim.set_pose(x, y, 0.0)
        before = sim.run_scan()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.add_obstacle(box_x, y, size=0.4)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        reset_counts()
        with_box = sim.run_scan()
        stepped = sim.update_pose()
        torch.cuda.synchronize()
        used = {k: v for k, v in counts().items() if v}
        r0, r1 = float(before[ahead]), float(with_box[ahead])
        res = {"add_obstacle_host_ms": host_ms, "launches": used,
               "ahead_before": r0, "ahead_with_box": r1}
        check(0.7 < r1 < 0.9 and r1 < r0 - 0.1
              and float(stepped.ranges[ahead]) < 0.9,
              f"{name} {backend}: the box does not shorten the beam ahead "
              f"({r0} -> {r1})")
        check(used == ({kname: 2} if kname else {}),
              f"{name} {backend}: the edited map launched {used}")
        if backend == "sectors":
            inc = sim.bundle.segmap
            res["incremental"] = (
                inc.n_segments == sim._pristine_segmap.n_segments + 4
                and inc.table.shape == sim._pristine_segmap.table.shape)
            full = sim._build_segmap(sim.bundle.track)
            q = torch.as_tensor(poses[:256], device="cuda")
            kw = dict(num_beams=BEAMS, fov=FOV, max_range=MAX_RANGE)
            same = bool(torch.equal(rs.scan_poses_sectors(inc, q, **kw),
                                    rs.scan_poses_sectors(full, q, **kw)))
            log(f"[{name}] sectors: incremental add_segments = "
                f"{res['incremental']}, ranges equal to the full rebuild's "
                f"on 256 x {BEAMS} = {same}")
            check(res["incremental"] and same, f"{name}: add_segments")
        sim.set_pose(x, y, 0.0)
        sim.clear_obstacles()
        restored = bool(torch.equal(sim.run_scan(), before))
        log(f"[{name}] {card}: {backend} add_obstacle {host_ms:.1f} ms "
            f"host; beam ahead {r0:.4f} -> {r1:.4f} m; launches on the "
            f"edited map (scan + step) {used}; clear_obstacles restores "
            f"the scan bit for bit = {restored}")
        check(restored, f"{name} {backend}: clear_obstacles")
        out[backend] = res
    return out


def lidar_poses(state, car):
    """(A, 3) scanner poses of a state."""
    import torch
    d = car.scan_distance_to_base_link
    return torch.stack([state.x + d * torch.cos(state.theta),
                        state.y + d * torch.sin(state.theta), state.theta],
                       dim=-1)


def multitrack_phase(card, sec_bundles, poses_by_map, rates, errs):
    """16: multitrack serving over the two bundled maps, stacked."""
    import torch
    from pyracecarsimulator_tpu_torch.maps import stack_sector_maps
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
    half = AGENTS // 2
    t0 = time.perf_counter()
    stack = stack_sector_maps([sec_bundles[m].segmap for m in MAPS])
    torch.cuda.synchronize()
    out = {"stack_s": time.perf_counter() - t0,
           "table": list(stack.table.shape),
           "table_bytes": stack.table.numel() * 4}
    log(f"[stack] {' + '.join(MAPS)} stacked in {out['stack_s']:.2f} s: "
        f"table {tuple(stack.table.shape)}, {out['table_bytes'] / 1e6:.1f} "
        f"MB, kv_sec {stack.kv_sec}, offsets {stack.offsets.tolist()}")
    check(stack.table.is_cuda and stack.table.shape[0] == sum(
        sec_bundles[m].segmap.table.shape[0] for m in MAPS), "stack shape")
    poses = torch.cat([torch.as_tensor(poses_by_map[m][:half], device="cuda")
                       for m in MAPS])
    mid = torch.arange(len(MAPS), device="cuda",
                       dtype=torch.int32).repeat_interleave(half)
    kw = dict(num_beams=BEAMS, fov=FOV, max_range=MAX_RANGE)

    def case(p):
        bb = rs.sector_block_width(stack, BEAMS, FOV)
        ct, st = rs.fan_cos_sin(p[:, 2], rs._padded_offsets(BEAMS, FOV, bb,
                                                            p.device))
        ids, _ = rs.stack_block_ids(stack, mid, p[:, 0], p[:, 1], ct, st,
                                    BEAMS, bb)
        return list_args(stack.table, stack.meta, ids, p, ct, st)

    sets = []
    for j in range(5):
        q = poses.clone()
        q[:, 2] += j * 1e-3
        sets.append(q)
    args = [case(q) for q in sets]
    for name in ("sector_sweep", "sorted_tiles_sweep"):
        errs[name].append(kernel_vs_plain("stack", name, args[0]))
    out["kernel"] = time_kernel("sector_sweep", args, rates)
    log(f"[stack] {card}: sector_sweep over the stacked table "
        f"{out['kernel']}")

    # the multi scan against the two per-map scans, counted
    per_map = lambda p: torch.cat([
        rs.scan_poses_sectors(sec_bundles[m].segmap,
                              p[i * half:(i + 1) * half], **kw)
        for i, m in enumerate(MAPS)])
    ref = per_map(poses)
    out["launches"] = {}
    for mode, wname in (("auto", "sector_sweep"),
                        ("sorted_pl", "sorted_tiles_sweep")):
        reset_counts()
        got = rs.scan_poses_sectors_multi(stack, mid, poses, mode=mode, **kw)
        torch.cuda.synchronize()
        used = {k: v for k, v in counts().items() if v}
        same = bool(torch.equal(got, ref))
        log(f"[stack] scan_poses_sectors_multi(mode={mode!r}) on "
            f"{tuple(got.shape)}: launches {used}, equal to the two "
            f"per-map scans bit for bit = {same}")
        check(same and used == {wname: 1},
              f"multitrack scan, mode {mode}: {used}, equal={same}")
        out["launches"][wname] = used[wname]

    # forward + backward once
    reset_counts()
    p = poses.clone().requires_grad_(True)
    (rs.scan_poses_sectors_multi(stack, mid, p, **kw) ** 2).sum().backward()
    g = p.grad
    ok = (bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
          and counts()["sector_sweep"] == 1)
    out["launches"]["sector_sweep"] += counts()["sector_sweep"]
    log(f"[stack] multi scan forward + backward: pose grad |.|_1 "
        f"{float(g.abs().sum()):.4f}, finite and non-zero, one launch = {ok}")
    check(ok, "multitrack gradients")

    def fwd_bwd(i):
        q = sets[i % 5].clone().requires_grad_(True)
        (rs.scan_poses_sectors_multi(stack, mid, q, **kw) ** 2
         ).sum().backward()

    out["multi_scan_ms"] = timed_ms(lambda i: rs.scan_poses_sectors_multi(
        stack, mid, sets[i % 5], **kw), 20)
    out["per_map_scans_ms"] = timed_ms(lambda i: per_map(sets[i % 5]), 20)
    out["multi_scan_ms_2"] = timed_ms(lambda i: rs.scan_poses_sectors_multi(
        stack, mid, sets[i % 5], **kw), 20)
    out["multi_fwd_bwd_ms"] = timed_ms(fwd_bwd, 10)
    log(f"[stack] {card}: multi scan {out['multi_scan_ms']:.4f} / "
        f"{out['multi_scan_ms_2']:.4f} ms, the two per-map scans "
        f"{out['per_map_scans_ms']:.4f} ms, multi forward + backward "
        f"{out['multi_fwd_bwd_ms']:.4f} ms at {AGENTS} x {BEAMS}")
    return out, stack, poses, mid


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def mesh_phase(card, bundle, stack, stack_poses, mid, poses, errs):
    """17: a 1 x 1 mesh on the card, backend NCCL, in this process."""
    import torch
    import torch.distributed as dist
    from pyracecarsimulator_tpu_torch import make_step_fn, state_from_pose
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
    from pyracecarsimulator_tpu_torch.parallel import (
        make_mesh, make_ring_scan, make_sharded_step, multihost, ringmap)
    multihost.initialize("nccl", f"tcp://localhost:{free_port()}",
                         world_size=1, rank=0, timeout_s=120)
    try:
        mesh = make_mesh()
        one = torch.ones(4, device="cuda")
        dist.all_reduce(one)
        check(dist.get_backend() == "nccl" and mesh.shape == {
            "agents": 1, "beams": 1} and float(one.sum()) == 4.0,
              "the 1 x 1 NCCL mesh")
        kw = dict(num_beams=BEAMS, fov=FOV, max_range=MAX_RANGE)
        act = (torch.full((AGENTS,), 2.0, device="cuda"),
               torch.zeros(AGENTS, device="cuda"))
        p = torch.as_tensor(poses, device="cuda")
        s0 = state_from_pose(p[:, 0], p[:, 1], p[:, 2])
        out = {"launches": {}}

        # the sharded sector step against make_step_fn
        sharded = make_sharded_step(mesh, bundle, with_noise=False)
        plain = make_step_fn(bundle, with_noise=False)
        reset_counts()
        a = sharded(s0, act)
        out["launches"]["sharded sector step"] = dict(
            (k, v) for k, v in counts().items() if v)
        b = plain(s0, act)
        same = all(bool(torch.equal(u, v)) for u, v in (
            (a.ranges, b.ranges), (a.state.pose, b.state.pose),
            (a.collision, b.collision), (a.state.velocity,
                                         b.state.velocity)))
        log(f"[mesh 1x1 nccl] sharded sector step on {tuple(a.ranges.shape)}"
            f": launches {out['launches']['sharded sector step']}, equal to "
            f"make_step_fn's bit for bit = {same}")
        check(same and out["launches"]["sharded sector step"] == {
            "sector_sweep": 1}, "sharded sector step")

        # the stacked step against the multitrack scan
        q = stack_poses
        stacked = make_sharded_step(mesh, bundle, with_noise=False,
                                    stack=stack)
        reset_counts()
        c = stacked(state_from_pose(q[:, 0], q[:, 1], q[:, 2]), act, mid)
        out["launches"]["stacked step"] = dict(
            (k, v) for k, v in counts().items() if v)
        ref = rs.scan_poses_sectors_multi(
            stack, mid, lidar_poses(c.state, bundle.car), **kw)
        same = bool(torch.equal(c.ranges, ref))
        log(f"[mesh 1x1 nccl] stacked step: launches "
            f"{out['launches']['stacked step']}, ranges equal to "
            f"scan_poses_sectors_multi at the stepped poses = {same}; "
            f"{int(c.collision.sum())} of {AGENTS} cars latched")
        check(same and out["launches"]["stacked step"] == {
            "sector_sweep": 1}, "stacked sharded step")

        # the ring scan, one slab: its one launch sweeps the gathered
        # (G, 4, K) buffer as the table, row by row
        smap = bundle.segmap
        _, (_, meta, ids, *rays) = sector_case(smap, p)
        slab, ls = ringmap.shard_sector_table(mesh, smap)
        buf = ringmap._ring_gather(mesh, slab, ids, ls)
        errs["sector_sweep"].append(kernel_vs_plain(
            f"ring buffer {tuple(buf.shape)}", "sector_sweep",
            (buf, meta.index_select(0, ids.long()).contiguous(),
             torch.arange(ids.numel(), dtype=torch.int32, device="cuda"),
             *rays)))
        del slab, buf
        ring = make_ring_scan(mesh, smap, BEAMS, FOV, MAX_RANGE)
        reset_counts()
        r = ring(p)
        out["launches"]["ring scan"] = dict(
            (k, v) for k, v in counts().items() if v)
        ref = rs.scan_poses_sectors(bundle.segmap, p, **kw)
        same = bool(torch.equal(r, ref))
        log(f"[mesh 1x1 nccl] ring scan, S = 1, slab rows {ring.slab_rows}: "
            f"launches {out['launches']['ring scan']}, equal to "
            f"scan_poses_sectors bit for bit = {same}")
        check(same and out["launches"]["ring scan"] == {"sector_sweep": 1}
              and ring.slab_rows == bundle.segmap.table.shape[0],
              "ring scan")

        sets = pose_sets(poses)
        state = [s0]

        def run(step, *extra):
            def one(i):
                state[0] = step(state[0], act, *extra).state
            state[0] = s0
            return timed_ms(one, 30, warmup=5)

        out["sharded_step_ms"] = run(sharded)
        out["plain_step_ms"] = run(plain)
        out["stacked_step_ms"] = run(stacked, mid)
        out["ring_scan_ms"] = timed_ms(lambda i: ring(sets[i % 5]), 20)
        out["replicated_scan_ms"] = timed_ms(
            lambda i: rs.scan_poses_sectors(bundle.segmap, sets[i % 5],
                                            **kw), 20)
        log(f"[mesh 1x1 nccl] {card}: noiseless sector step, sharded "
            f"{out['sharded_step_ms']:.4f} ms, make_step_fn "
            f"{out['plain_step_ms']:.4f} ms, stacked "
            f"{out['stacked_step_ms']:.4f} ms; ring scan "
            f"{out['ring_scan_ms']:.4f} ms, replicated scan "
            f"{out['replicated_scan_ms']:.4f} ms, at {AGENTS} x {BEAMS}")
        return out
    finally:
        dist.destroy_process_group()


def ranks_phase(card, bundle, flat, track, poses, errs):
    """18: four gloo ranks on the one card, mesh 2 x 2, berlin."""
    import numpy as np
    import torch
    from pyracecarsimulator_tpu_torch import make_step_fn, state_from_pose
    from pyracecarsimulator_tpu_torch.maps.segments import (
        extract_segments, raycast_segments_numpy)
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
    from pyracecarsimulator_tpu_torch.ops.common import (
        _ray_invs, fan_cos_sin, rays_from_poses)
    from pyracecarsimulator_tpu_torch.ops.raycast_grad import (
        raycast_all_diff)
    from pyracecarsimulator_tpu_torch.parallel import mesh as pmesh
    from pyracecarsimulator_tpu_torch.parallel.dryrun import dryrun
    n = 1024
    case = {"maps": ["berlin"], "poses": poses[:n], "action": (2.0, 0.0),
            "num_beams": BEAMS, "fov": FOV, "max_range": MAX_RANGE}
    t0 = time.perf_counter()
    res = dryrun(4, beams_axis=2, device="cuda", case=case, backend="gloo",
                 timeout_s=300)
    out = {"wall_s": time.perf_counter() - t0, "launches": res["launches"],
           "mesh": res["mesh"], "backend": res["backend"]}
    log(f"[4 ranks] dryrun(4, beams_axis=2, device='cuda') on berlin, {n} x "
        f"{BEAMS}: mesh {res['mesh']}, backend {res['backend']}, "
        f"{out['wall_s']:.1f} s wall; launches per rank {res['launches']}")
    check(res["mesh"] == (2, 2) and res["backend"] == "gloo"
          and res["launches"] == [{"sector_sweep": 3, "dense_sweep": 2}] * 4,
          "the four ranks' mesh, backend or launches")

    kw = dict(num_beams=BEAMS, fov=FOV, max_range=MAX_RANGE)
    p = torch.as_tensor(poses[:n], device="cuda")

    # the sweeps the ranks launched, rebuilt here at the wedges' shapes (all
    # 1024 agents x each half of the fan), against their plain versions
    smap = bundle.segmap
    bb = rs.sector_block_width(smap, BEAMS, FOV)
    flat_rays = lambda *v: [t.reshape(-1).contiguous() for t in v]
    for b in range(2):
        wedge = pmesh.Mesh(agents=2, beams=2, agents_index=0, beams_index=b,
                           beams_ranks=(0, 1))
        ct, st = fan_cos_sin(p[:, 2], pmesh._wedge_offsets(
            wedge, BEAMS, FOV, 0, "cuda"))
        errs["dense_sweep"].append(kernel_vs_plain(
            f"berlin untiled, wedge {b} of 2", "dense_sweep",
            (flat.params, flat.sweep_meta, *flat_rays(
                p[:, 0:1].expand(ct.shape), p[:, 1:2].expand(ct.shape), ct,
                st, *_ray_invs(ct, st)))))
        ct, st = fan_cos_sin(p[:, 2], pmesh._wedge_offsets(
            wedge, BEAMS, FOV, bb, "cuda"))
        ids = rs._list_ids(smap.tiles_shape, smap.tile_size,
                           smap.tile_origin, smap.ns, p[:, 0], p[:, 1], ct,
                           st, bb)
        args = list_args(smap.table, smap.meta, ids, p, ct, st)
        errs["sector_sweep"].append(kernel_vs_plain(
            f"berlin sectors, wedge {b} of 2", "sector_sweep", args))
        rows = args[2].long()
        errs["sector_sweep"].append(kernel_vs_plain(
            f"berlin ring buffer, wedge {b} of 2", "sector_sweep",
            (smap.table.index_select(0, rows),
             smap.meta.index_select(0, rows).contiguous(),
             torch.arange(rows.numel(), dtype=torch.int32, device="cuda"),
             *args[3:])))

    def with_grad(fn):
        q = p.clone().requires_grad_(True)
        r = fn(q)
        (r ** 2).sum().backward()
        return r.detach().cpu().numpy(), q.grad.cpu().numpy()

    def dense(q):
        _, _, xb, yb, ct, st = rays_from_poses(q, BEAMS, FOV)
        return raycast_all_diff(flat.params, flat.sweep_meta, xb, yb, ct,
                                st, MAX_RANGE)

    refs = {"sectors": with_grad(lambda q: rs.scan_poses_sectors(
        bundle.segmap, q, **kw)), "dense": with_grad(dense)}
    for kind, keys in (("sectors", ("scan_sectors", "grad_sectors")),
                       ("dense", ("scan_dense", "grad_dense")),
                       ("sectors", ("ring", "ring_grad"))):
        r_ref, g_ref = refs[kind]
        d = np.abs(res[keys[0]] - r_ref)
        share = float(np.mean(d <= 1e-5))
        g_err = float(np.abs(res[keys[1]] - g_ref).max()
                      / np.abs(g_ref).max())
        out[keys[0]] = {"share_within_1e-5": share,
                        "max_abs_diff": float(d.max()),
                        "equal": bool(np.array_equal(res[keys[0]], r_ref)),
                        "grad_rel_err": g_err}
        log(f"[4 ranks] {keys[0]} vs the unsharded run: {out[keys[0]]}")
        check(share >= 0.999 and g_err <= 1e-4,
              f"four ranks: {keys[0]} differs from the unsharded run")

    # the gathered ranges against the float64 oracle
    segs = extract_segments(track.occupancy.cpu().numpy(), track.resolution,
                            (track.origin_x, track.origin_y))
    _, _, _, _, ct, st = rays_from_poses(p[:4], BEAMS, FOV)
    ora = np.stack([raycast_segments_numpy(
        segs, np.full(BEAMS, poses[i, 0], np.float64),
        np.full(BEAMS, poses[i, 1], np.float64),
        ct[i].cpu().numpy().astype(np.float64),
        st[i].cpu().numpy().astype(np.float64), MAX_RANGE)
        for i in range(4)])
    for key in ("scan_sectors", "scan_dense", "ring"):
        share = float(np.mean(np.abs(res[key][:4] - ora) <= 1e-4))
        log(f"[4 ranks] gathered {key} ranges vs the float64 oracle, 4 "
            f"poses: share within 1e-4 m = {share}")
        check(share >= 0.999,
              f"four ranks: {key} ranges disagree with the oracle")

    # the sharded steps against make_step_fn
    s0 = state_from_pose(p[:, 0], p[:, 1], p[:, 2])
    act = (torch.full((n,), 2.0, device="cuda"),
           torch.zeros(n, device="cuda"))
    for kind, b in (("sectors", bundle),
                    ("dense", bundle._replace(segmap=flat,
                                              backend="segments"))):
        ref = make_step_fn(b, with_noise=False)(s0, act)
        got = res[f"step_{kind}"]
        share = float(np.mean(np.abs(
            got["ranges"] - ref.ranges.cpu().numpy()) <= 1e-5))
        same = bool(np.array_equal(got["collision"],
                                   ref.collision.cpu().numpy()))
        dx = float(np.abs(got["state"]["x"]
                          - ref.state.x.cpu().numpy()).max())
        out[f"step_{kind}"] = {"share_within_1e-5": share,
                               "collisions_equal": same, "max_dx": dx}
        log(f"[4 ranks] step_{kind} vs make_step_fn: "
            f"{out[f'step_{kind}']}")
        check(share >= 0.999 and same and dx <= 1e-6,
              f"four ranks: step_{kind} differs from the unsharded step")
    check(res["slab_rows"] * 2 == res["table_rows"], "ring slab rows")
    return out


def tooling_phase(card, bundle, poses):
    """19: utils.debug.checked and utils.profiling.rays_per_second."""
    import torch
    from pyracecarsimulator_tpu_torch import (make_scan_fn, make_step_fn,
                                              state_from_pose)
    from pyracecarsimulator_tpu_torch.state import set_field
    from pyracecarsimulator_tpu_torch.utils.debug import checked
    from pyracecarsimulator_tpu_torch.utils.profiling import rays_per_second
    p = torch.as_tensor(poses, device="cuda")
    s0 = state_from_pose(p[:, 0], p[:, 1], p[:, 2])
    act = (torch.full((AGENTS,), 2.0, device="cuda"),
           torch.zeros(AGENTS, device="cuda"))
    safe = checked(make_step_fn(bundle, with_noise=False))
    out = safe(s0, act)
    check(bool(torch.isfinite(out.ranges).all()), "checked: clean step")
    x = s0.x.clone()
    x[7] = float("nan")
    raised = ""
    try:
        safe(set_field(s0, x=x), act)
    except FloatingPointError as e:
        raised = str(e)
    log(f"checked(step): a clean step passes; an injected NaN raises "
        f"{raised!r}")
    check("non-finite x" in raised, "checked did not raise on a NaN")
    rate = rays_per_second(make_scan_fn(bundle), p, BEAMS, reps=20)
    log(f"[berlin] {card}: rays_per_second of the sector scan at {AGENTS} "
        f"x {BEAMS}: {rate:.4e} rays/s")
    check(rate > 0 and math.isfinite(rate), "rays_per_second")
    return {"rays_per_second": rate}


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
    sass = sass_report()
    rates = card_rates()
    # the unrolled main loop is the cheapest per test
    rates["sass_per_test"] = {k: min(lp["per_test"] for lp in v)
                              for k, v in sass.items()}
    log(f"bounds: {OPS_PER_TEST} instruction slots per test over "
        f"{rates['sms']} SMs x {LANES_PER_SM} lanes x "
        f"{rates['sm_clock_max_mhz']:.0f} MHz (clocks.max.sm) = {rates['slots_per_s']:.4e} slots/s; HBM "
        f"{HBM_BYTES_PER_S:.3e} B/s")

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
            kname, [segment_case(segmap, q)[1] for q in pose_sets(poses)],
            rates)
        times["sector_sweep"][name] = time_kernel(
            "sector_sweep",
            [sector_case(smap, q)[1] for q in pose_sets(poses)], rates)

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
        "dense_sweep", [segment_case(flat, q)[1] for q in few], rates)
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
        times[name][big] = time_kernel(name, sets, rates)

    # 6. the main path: the default backend, then the sector backend
    # no device named: the entry points put everything on the card
    seg_bundles = {name: build_sim(name) for name in MAPS}
    check(all(b.backend == "segments" and b.track.edf.is_cuda
              and b.segmap.params.is_cuda for b in seg_bundles.values()),
          "build_sim's default is not the 'segments' backend on the card")
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
    sim = RacecarSimulator(MAPS[0], seed=0)
    check(sim.device.type == "cuda" and sim.state.x.is_cuda,
          "the facade's default device is not the card")
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

    # 10-15. the EDF marches, map gradients, soft_edt, simplified
    # geometry and the obstacle cycle
    slice_out = {"edf": {}, "soft_edt": {}, "segments_simplified": {},
                 "obstacles": {}}
    for name in MAPS:
        slice_out["edf"][name] = march_phases(card, name, tracks[name],
                                              poses_by_map[name])
    slice_out["map_grad"] = mapgrad_phase(card, sec_bundles[big],
                                          poses_by_map[big])
    for name in MAPS:
        slice_out["soft_edt"][name] = soft_edt_phase(card, name,
                                                     tracks[name])
        slice_out["segments_simplified"][name] = simplified_phase(
            card, name, tracks[name], poses_by_map[name])
        slice_out["obstacles"][name] = obstacle_phase(
            card, name, tracks[name], poses_by_map[name])
    log(f"after phases 10-15: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # 16-19. multitrack, the 1 x 1 mesh, four ranks on the card, tooling
    slice_out["multitrack"], stack, stack_poses, mid = multitrack_phase(
        card, sec_bundles, poses_by_map, rates, errs)
    slice_out["mesh_1x1"] = mesh_phase(card, sec_bundles[big], stack,
                                       stack_poses, mid, poses_by_map[big],
                                       errs)
    del stack
    torch.cuda.empty_cache()
    slice_out["four_ranks"] = ranks_phase(card, sec_bundles[big], flat,
                                          tracks[big], poses_by_map[big],
                                          errs)
    slice_out["tooling"] = tooling_phase(card, sec_bundles[big],
                                         poses_by_map[big])
    log(f"the four ranks of phase 18 launched "
        f"{slice_out['four_ranks']['launches']}")

    # launches of this process, path by path: each path was driven with the
    # counts set to 0 just before it and read just after
    by_path = {
        **{f"default step + rollout, {m}": c for m, c in main_counts.items()},
        **{f"sector step + rollout, {m}": c for m, c in sec_counts.items()},
        "sector scan, mode sorted_pl": {
            "sorted_tiles_sweep": route_counts["sorted_tiles_sweep"]},
        "sector scan, use_pallas": {"grp_sweep": route_counts["grp_sweep"]},
        **{f"BPTT train steps, {k}": v["launches"] for k, v in train.items()},
        "map_grad scans": slice_out["map_grad"]["launches"],
        **{f"obstacle cycle, {m} {backend}": res["launches"]
           for m, per_map in slice_out["obstacles"].items()
           for backend, res in per_map.items()},
        "multitrack scans": slice_out["multitrack"]["launches"],
        **{f"1 x 1 mesh, {k}": v
           for k, v in slice_out["mesh_1x1"]["launches"].items()}}
    launches_by_path = {name: {path: c[name] for path, c in by_path.items()
                               if c.get(name)} for name in KERNELS}
    log(f"launches by path: {launches_by_path}")
    check(all(launches_by_path.values()),
          f"a kernel was never launched: {launches_by_path}")
    shape_of = {"dense_sweep": "levine", "tile_sweep": "berlin",
                "sector_sweep": "berlin", "sorted_tiles_sweep": "berlin",
                "grp_sweep": "berlin"}
    log(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "path": path, "launches": sum(launches_by_path[name].values()),
        "launches_by_path": launches_by_path[name],
        "max_abs_err": max(errs[name]),
        "ms": times[name][shape_of[name]]["ms"],
        "plain_ms": times[name][shape_of[name]]["plain_ms"],
        "bound_ms": times[name][shape_of[name]]["bound_ms"],
        "bound_by": times[name][shape_of[name]]["bound_by"],
        # no PyTorch call computes the first-hit sweep
        "library_ms": None,
        "shape_of_ms": f"{shape_of[name]} {AGENTS}x{BEAMS}",
        "ms_by_shape": times[name]}
        for name, (src, rep, path) in KERNELS.items()],
        "scans_ms": times["scans"], "steps_ms": times["steps"],
        "train": train,
        "slice": slice_out, "card": card, "rates": rates,
        "ops_per_test": OPS_PER_TEST, "sass_loops": sass}))
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
