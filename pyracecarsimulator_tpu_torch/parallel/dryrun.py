"""A local multi-rank dry run of the sharded paths.

The port's analogue of the JAX package's ``dryrun_multichip`` and of its
tests' fake 8-device CPU mesh: ``dryrun`` spawns ``n_ranks`` local
processes, joins them in one ``torch.distributed`` world, runs every
sharded path of ``parallel/mesh.py`` and ``parallel/ringmap.py`` on NumPy
inputs and returns rank 0's gathered NumPy results, for a caller to hold
against the unsharded functions:

  * the sharded scan on the sector map and on the dense map, and the pose
    gradient of ``sum(ranges ** 2)`` through each (the explicit gradient
    all-reduce over ``beams``);
  * the sharded step on both maps and, where the case stacks two maps or
    more, the multitrack step;
  * the ring scan and its pose gradient, and the slab's row count.

The processes are started with the ``spawn`` method (a forked child of a
process that holds other libraries' threads is not safe) and rendezvous on
a ``file://`` store in a temporary directory. The worker functions live
here, not beside the caller: a spawned child imports them by module name.
Every wait has a timeout, after which the children are killed and the call
raises; a hung collective fails, it does not hang the caller.

On ``device="cuda"`` with the gloo backend all ranks share the current
card; NCCL refuses two ranks on one GPU, so such a world runs gloo and
``parallel/mesh``'s collective helpers stage through host memory, while
every sweep still launches its kernel on the card. With
``backend="nccl"`` rank i takes card ``i % torch.cuda.device_count()``: one
card per rank on a host that has as many. Build the kernels in the parent
first (``ops._kernels.build``): the children then load the finished
libraries.

    python -m pyracecarsimulator_tpu_torch.parallel.dryrun 4 2 cpu

(ranks, beams axis, device; without the third argument the ranks share the
card).
"""

from __future__ import annotations

import os
import pathlib
import pickle
import sys
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..config import ScanParams, resolve_device
from ..maps.loader import build_track_map, load_builtin
from ..maps.sectors import stack_sector_maps
from ..ops import sweeps
from ..state import FIELDS, state_from_pose
from . import multihost
from .mesh import (gather_agents, gather_ranges, make_mesh,
                   make_sharded_scan, make_sharded_step, shard_agents)
from .ringmap import make_ring_scan

FOV = 4.712388980384690
PATHS = ("scan", "step", "ring")     # what run_case runs by default


def tiny_occupancy(second: bool = False, hw: int = 192) -> np.ndarray:
    """A walled square room with one block (or, ``second``, two other
    blocks): the small tracks of the sharding tests."""
    occ = np.zeros((hw, hw), np.float32)
    occ[:4, :] = 1
    occ[-4:, :] = 1
    occ[:, :4] = 1
    occ[:, -4:] = 1
    if second:
        occ[40:60, 90:170] = 1
        occ[120:168, 30:80] = 1
    else:
        occ[60:132, 60:132] = 1
    return occ


def _free_poses(occ, resolution, origin, n, rng, margin_cells=8):
    """``n`` poses on cells at least ``margin_cells`` from any occupied
    cell of the (H, W) grid ``occ``."""
    from scipy.ndimage import binary_dilation
    free = ~binary_dilation(occ > 0.5, iterations=margin_cells)
    ys, xs = np.where(free)
    k = rng.randint(len(ys), size=n)
    return np.stack([origin[0] + (xs[k] + 0.5) * resolution,
                     origin[1] + (ys[k] + 0.5) * resolution,
                     rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)


def tiny_case(agents: int = 16, num_beams: int = 128, seed: int = 0) -> dict:
    """The default case: two 192 x 192 tracks at 5 cm, ``agents`` poses on
    the first for the single-map paths, and half of the agents on each for
    the multitrack step. Optional entry: ``"paths"``, a subset of
    ``PATHS``, cuts what ``run_case`` runs."""
    rng = np.random.RandomState(seed)
    res, org = 0.05, (-4.8, -4.8)
    occs = [tiny_occupancy(False), tiny_occupancy(True)]
    half = agents // 2
    return {
        "maps": [{"occupancy": o, "resolution": res, "origin": org}
                 for o in occs],
        "poses": _free_poses(occs[0], res, org, agents, rng),
        "stack_poses": np.concatenate(
            [_free_poses(occs[0], res, org, half, rng),
             _free_poses(occs[1], res, org, agents - half, rng)]),
        "map_ids": np.asarray([0] * half + [1] * (agents - half), np.int32),
        "action": (3.0, 0.05), "num_beams": num_beams, "fov": FOV,
        "max_range": 10.0, "tile_size": 2.0, "sector_ns": 16}


def case_bundles(case: dict, device):
    """(sector bundles of every map, dense bundle of the first map) on
    ``device``; a map is a bundled one's name or a grid."""
    from ..simulator import build_sim
    scan = ScanParams(num_beams=int(case["num_beams"]),
                      fov=float(case["fov"]),
                      max_range=float(case["max_range"]))
    tracks = [load_builtin(m, device=device) if isinstance(m, str)
              else build_track_map(m["occupancy"], m["resolution"],
                                   m["origin"], device=device)
              for m in case["maps"]]
    sectors = [build_sim(t, scan=scan, backend="sectors", device=device,
                         tile_size=case.get("tile_size"),
                         sector_ns=case.get("sector_ns", 16))
               for t in tracks]
    dense = build_sim(tracks[0], scan=scan, backend="segments",
                      device=device)
    return sectors, dense


def _np(t):
    return t.detach().cpu().numpy()


def run_case(mesh, case: dict, device) -> dict:
    """Run every sharded path of the case on this rank of ``mesh`` and
    return the gathered global results as NumPy arrays (the same on every
    rank)."""
    device = torch.device(device)
    sectors, dense = case_bundles(case, device)
    nb, fov, max_range = (int(case["num_beams"]), float(case["fov"]),
                          float(case["max_range"]))
    on_dev = lambda a: torch.as_tensor(np.asarray(a), device=device)
    out = {"mesh": (mesh.agents, mesh.beams), "device": str(device),
           "backend": dist.get_backend()}
    paths = case.get("paths", PATHS)
    for w in sweeps.LIST_ROUTES + (sweeps.dense_sweep,):
        w.launches = 0

    # the sharded scan and its pose gradient, sector and dense maps
    poses = shard_agents(mesh, on_dev(case["poses"]))
    for name, m in ((("sectors", sectors[0].segmap), ("dense", dense.segmap))
                    if "scan" in paths else ()):
        scan = make_sharded_scan(mesh, m, nb, fov, max_range)
        p = poses.clone().requires_grad_(True)
        r = scan(p)
        (r ** 2).sum().backward()
        out[f"scan_{name}"] = _np(gather_ranges(mesh, r.detach()))
        out[f"grad_{name}"] = _np(gather_agents(mesh, p.grad))

    # the sharded step, single map and stack
    def step_out(step, pose_np, *extra):
        q = shard_agents(mesh, on_dev(pose_np))
        a_loc = q.shape[0]
        v, steer = case["action"]
        action = (torch.full((a_loc,), float(v), device=device),
                  torch.full((a_loc,), float(steer), device=device))
        o = step(state_from_pose(q[:, 0], q[:, 1], q[:, 2]), action, *extra)
        return {"ranges": _np(gather_ranges(mesh, o.ranges)),
                "collision": _np(gather_agents(mesh, o.collision)),
                "state": {f: _np(gather_agents(mesh, getattr(o.state, f)))
                          for f in FIELDS}}

    for name, b in ((("sectors", sectors[0]), ("dense", dense))
                    if "step" in paths else ()):
        out[f"step_{name}"] = step_out(
            make_sharded_step(mesh, b, with_noise=False), case["poses"])
    if "step" in paths and len(sectors) > 1:
        stack = stack_sector_maps([b.segmap for b in sectors])
        out["step_stack"] = step_out(
            make_sharded_step(mesh, sectors[0], with_noise=False,
                              stack=stack), case["stack_poses"],
            shard_agents(mesh, on_dev(case["map_ids"])))

    if "ring" in paths:
        smap = sectors[0].segmap
        ring = make_ring_scan(mesh, smap, nb, fov, max_range)
        p = poses.clone().requires_grad_(True)
        r = ring(p)
        (r ** 2).sum().backward()
        out["ring"] = _np(gather_ranges(mesh, r.detach()))
        out["ring_grad"] = _np(gather_agents(mesh, p.grad))
        out["slab_rows"] = ring.slab_rows
        out["table_rows"] = int(smap.table.shape[0])

    mine = {w.__name__: w.launches
            for w in sweeps.LIST_ROUTES + (sweeps.dense_sweep,)
            if w.launches}
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, mine)
    out["launches"] = per_rank
    return out


def _worker(rank, n_ranks, beams_axis, device, backend, out_dir,
            timeout_s):
    try:
        torch.set_num_threads(1)
        with open(os.path.join(out_dir, "case.pkl"), "rb") as f:
            case = pickle.load(f)
        device = torch.device(device)
        if device.type == "cuda":
            if device.index is None:
                device = torch.device(
                    "cuda", rank % torch.cuda.device_count()
                    if backend == "nccl" else torch.cuda.current_device())
            torch.cuda.set_device(device)
        multihost.initialize(
            backend, f"file://{os.path.join(out_dir, 'store')}", n_ranks,
            rank, timeout_s)
        result = run_case(make_mesh(beams_axis=beams_axis), case, device)
        if rank == 0:
            with open(os.path.join(out_dir, "result.pkl"), "wb") as f:
                pickle.dump(result, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def dryrun(n_ranks: int, beams_axis: int = 1, device=None,
           case: Optional[dict] = None, backend: str = "gloo",
           timeout_s: float = 120.0) -> dict:
    """Run ``run_case`` on ``n_ranks`` local processes laid out as an
    ``(n_ranks / beams_axis, beams_axis)`` mesh and return rank 0's
    results. ``device``: where the ranks compute; ``None`` means the card
    (``config.resolve_device``: it raises where there is none), the CPU
    only on ``device="cpu"``. ``case``: NumPy inputs as ``tiny_case``
    makes them (the default). Raises ``RuntimeError`` with the children's tracebacks when
    a rank fails, and ``TimeoutError`` after ``timeout_s`` seconds, having
    killed the children."""
    device = resolve_device(device)
    case = tiny_case() if case is None else case
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        # the case travels in a file: a child that dies before it has read
        # a large argument from its start-up pipe would block start()
        with open(os.path.join(tmp, "case.pkl"), "wb") as f:
            pickle.dump(case, f)
        procs = [ctx.Process(
            target=_worker, daemon=True,
            args=(rank, n_ranks, beams_axis, str(device), backend, tmp,
                  timeout_s))
            for rank in range(n_ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed = lambda: any(n.startswith("error_") for n in os.listdir(tmp))
        try:
            # a rank that failed leaves the others waiting in a collective:
            # stop at the first error file, or at the deadline
            while (any(p.is_alive() for p in procs) and not failed()
                   and time.monotonic() < deadline):
                time.sleep(0.1)
            hung = [i for i, p in enumerate(procs) if p.is_alive()]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
        errors = [pathlib.Path(tmp, n).read_text()
                  for n in sorted(os.listdir(tmp)) if n.startswith("error_")]
        if errors:
            raise RuntimeError("dryrun: a rank failed:\n" + "\n".join(errors))
        if hung:
            raise TimeoutError(f"dryrun: ranks {hung} still ran after "
                               f"{timeout_s} s and were killed")
        bad = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"dryrun: ranks exited with {bad}")
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)


if __name__ == "__main__":
    n, nb = int(sys.argv[1]), int(sys.argv[2])
    res = dryrun(n, nb, sys.argv[3] if len(sys.argv) > 3 else None)
    print({k: (v.shape if hasattr(v, "shape") else v)
           for k, v in res.items() if not isinstance(v, dict)})
