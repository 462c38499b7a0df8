"""Demo: occupancy-grid reconstruction from lidar scans by gradient
descent, with the PyTorch port.

The full differentiable chain (``ops/soft_edt.py``):

    occupancy --(chamfer soft-EDT, log init)--> EDF --(bilinear EDF
    samples)--> TSDF loss vs observed scans --> grad --> occupancy

    python examples/torch/demo_mapping.py                # 96x96 toy room
    python examples/torch/demo_mapping.py --map levine   # 1300x1300 track
    python examples/torch/demo_mapping.py --fast         # the hybrid path

``--fast`` runs the hybrid d(range)/d(map) path instead:
``make_scan_fn(bundle, map_grad=True)``, the sector-culled exact forward
on the sector sweep kernel plus the implicit-function map cotangent.
Task: map CORRECTION at levine's scale. Start from a miscalibrated prior
(true walls dilated 2 cells = every surface 0.10 m too close), observe
exact scans, and recover the true surface by relinearized Gauss-Newton
steps, each step's per-cell update assembled from two backward passes of
the facade scan function (weighted range residual / weighted hit
density). The compiled geometry is rebuilt on the host from the corrected
EDF between steps, which is where the native EDT and sector membership
(``_native/loader.py``) pay.

Without ``--device`` it runs on the CUDA card (and fails where there is
none).
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path[:0] = [os.path.join(os.path.dirname(__file__), "..", ".."),
                os.path.dirname(os.path.abspath(__file__))]

FREE_FRACS = (0.2, 0.4, 0.6, 0.8)


def toy_world():
    H = W = 96
    occ = np.zeros((H, W), np.float32)
    occ[:3, :] = 1; occ[-3:, :] = 1
    occ[:, :3] = 1; occ[:, -3:] = 1
    occ[40:52, 60:70] = 1.0
    occ[20:28, 25:32] = 1.0
    return occ


def real_occupancy(track):
    """The unpadded (H, W) occupancy of a track as a host array."""
    return track.occupancy.cpu().numpy()[: track.height, : track.width]


def fast_main(args, device):
    """Map correction through the facade map_grad route (module doc)."""
    import torch
    from scipy.ndimage import binary_dilation
    from _common import launches_since, load_track
    from pyracecarsimulator_tpu_torch import (ScanParams, build_sim,
                                              make_scan_fn)
    from pyracecarsimulator_tpu_torch._native import loader as native
    from pyracecarsimulator_tpu_torch.maps import (build_track_map, edt,
                                                   sample_free_poses)
    from pyracecarsimulator_tpu_torch.ops import sweeps

    name = args.map if args.map != "toy" else "levine"
    m_true = load_track(name, device)
    occ_true = real_occupancy(m_true) > 0.5
    res = m_true.resolution
    H, W = occ_true.shape
    n_poses = args.poses or 96
    beams = args.beams or 540
    sp = ScanParams(num_beams=beams, max_range=10.0)
    print(f"[fast] {m_true.name} {H}x{W} @ {res} m, {n_poses} poses x "
          f"{beams} beams (device={device})")

    # observed scans: the exact sector pipeline on the TRUE map
    bundle_true = build_sim(m_true, scan=sp, backend="sectors",
                            device=device)
    poses = torch.as_tensor(sample_free_poses(
        m_true, n_poses, np.random.RandomState(0), margin=0.5),
        device=device)
    with torch.no_grad():
        observed = make_scan_fn(bundle_true)(poses)

    def compile_estimate(occ_est, label):
        track = build_track_map(occ_est.astype(np.float32), res, org,
                                name=label, device=device)
        return build_sim(track, scan=sp, backend="sectors", device=device)

    def score(pred):
        err = (pred - observed).abs()
        return (float(err.pow(2).mean().sqrt()),
                float((err < res).float().mean()))

    # miscalibrated prior: every wall 2 cells (0.10 m) too close
    occ_est = binary_dilation(occ_true, iterations=2)
    org = (m_true.origin_x, m_true.origin_y)
    before, native_before = sweeps.launch_counts(), native.call_counts()
    t0 = time.time()
    outer = args.iters if args.iters < 30 else 10
    trace = []
    for it in range(outer):
        # re-derive the EDF from the carved occupancy each relinearization:
        # the IFT gate needs |grad E| = 1 near the tau surface, which raw
        # residual-sized e updates violate one iteration later
        e = torch.as_tensor(edt(occ_est, 1.0) * np.float32(res),
                            device=device).requires_grad_(True)
        scan_g = make_scan_fn(compile_estimate(occ_est, f"est{it}"),
                              map_grad=True)
        pred = scan_g(poses, e)
        rmse, within = score(pred.detach())
        trace.append(rmse)
        print(f"[fast] iter {it}  range RMSE {rmse * 100:6.2f} cm   "
              f"beams within 1 cell: {within * 100:5.1f}%")
        if within > 0.999:
            break
        # Gauss-Newton-ish per-cell update from two backward pulls:
        #   pull(g) = sum_rays -g * w_cell / denom_ray   (IFT cotangent)
        # g = 1:           G1 = sum  w/|denom|          (hit density)
        # g = pred - obs:  G2 = sum (pred-obs) w/|denom| (weighted resid.)
        # => -G2/G1 = hit-weighted mean of (obs - pred) = the EDF shift
        # that moves each cell's surface onto the observed range (|grad E|
        # = 1 for a distance field, so range error == surface offset).
        g1, = torch.autograd.grad(pred, e, torch.ones_like(pred),
                                  retain_graph=True)
        g2, = torch.autograd.grad(pred, e, pred.detach() - observed)
        dense = g1 > 1e-3
        upd = torch.where(dense, -g2 / torch.where(dense, g1, 1.0), 0.0)
        occ_est = ((e.detach() + upd) < 0.5 * res).cpu().numpy()
    with torch.no_grad():
        pred = make_scan_fn(compile_estimate(occ_est, "est_final"))(poses)
    rmse, within = score(pred)
    # surface agreement vs the true map (same scoring idea as the slow path)
    true_surface = occ_true & binary_dilation(~occ_true)
    pred_near = binary_dilation(occ_est, iterations=1)
    recall = (pred_near & true_surface).sum() / max(true_surface.sum(), 1)
    launches = launches_since(before)
    native_calls = {k: n - native_before[k]
                    for k, n in native.call_counts().items()}
    print(f"[fast] done in {time.time() - t0:.1f}s  final range RMSE "
          f"{rmse * 100:.2f} cm, {within * 100:.1f}% of beams within one "
          f"cell (prior: every wall {2 * res * 100:.0f} cm off); "
          f"true-surface recall {recall:.2f}; kernel launches {launches}, "
          f"native host calls {native_calls}")
    return {"rmse_trace": trace, "final_rmse": rmse, "within": within,
            "recall": float(recall), "launches": launches,
            "native_calls": native_calls}


def main(argv=None):
    from _common import add_device_arg, load_track
    ap = argparse.ArgumentParser()
    ap.add_argument("--map", default="toy",
                    help="'toy' (96x96 room), a bundled map's name "
                         "('levine': full 1300x1300 grid) or a map YAML's "
                         "path")
    ap.add_argument("--poses", type=int, default=0,
                    help="scan poses (0 = per-map default)")
    ap.add_argument("--beams", type=int, default=0,
                    help="beams per scan (0 = per-mode default)")
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--fast", action="store_true",
                    help="the hybrid d(range)/d(map) path (module doc)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch
    from pyracecarsimulator_tpu_torch.config import resolve_device
    device = resolve_device(args.device)
    if args.fast:
        return fast_main(args, device)

    from pyracecarsimulator_tpu_torch.maps import edt
    from pyracecarsimulator_tpu_torch.ops.common import beam_angles
    from pyracecarsimulator_tpu_torch.ops.raymarch_xla import (
        sample_edf_bilinear, scan_poses)
    from pyracecarsimulator_tpu_torch.ops.soft_edt import soft_edt

    # ground truth in GRID UNITS (res = 1 cell); levine's 0.05 m cells
    # make max_range 10 m = 200 cells
    if args.map == "toy":
        occ_true = toy_world()
        n_poses = args.poses or 24
        beams, max_range, max_iters = args.beams or 180, 80.0, 128
        edt_iters, free_margin = 64, 0.8
    else:
        occ_true = real_occupancy(load_track(args.map, "cpu"))
        n_poses = args.poses or 256
        beams, max_range, max_iters = args.beams or 360, 200.0, 256
        # big maps: the chamfer EDF only needs to be exact out to the
        # free-sample margin test, not across the whole hall
        edt_iters, free_margin = 96, 0.8
    H, W = occ_true.shape
    print(f"world {H}x{W}, {n_poses} poses x {beams} beams "
          f"(device={device})")

    # observe scans from free-space poses with the EXACT pipeline
    edf_true_np = edt(occ_true > 0.5, 1.0)
    edf_true = torch.as_tensor(edf_true_np, device=device)
    rng = np.random.RandomState(0)
    free_y, free_x = np.where(edf_true_np > 4.0)
    k = rng.randint(len(free_y), size=n_poses)
    poses = torch.as_tensor(np.stack([
        free_x[k] + 0.5, free_y[k] + 0.5,
        rng.uniform(-np.pi, np.pi, n_poses)], -1).astype(np.float32),
        device=device)
    fov = 2 * np.pi * 0.999
    observed = scan_poses(edf_true, 1.0, torch.zeros(2, device=device),
                          poses, num_beams=beams, fov=fov,
                          max_range=max_range, max_iters=max_iters)

    # reconstruct with a TSDF-style loss on the differentiable EDF:
    # observed hit points must lie ON surfaces (edf -> 0) and sampled
    # points along each beam before the hit must stay FREE (edf large).
    # (A naive MSE on re-simulated ranges saturates: through a transparent
    # initial map every ray clamps at max_range with zero gradient.)
    ang = poses[:, 2:3] + beam_angles(beams, fov, device)[None, :]
    ux, uy = torch.cos(ang), torch.sin(ang)
    hit_mask = observed < max_range * 0.99
    hx = poses[:, 0:1] + observed * ux
    hy = poses[:, 1:2] + observed * uy
    # free samples stop at 0.8*r: samples closer to the hit would demand
    # clearance where the surface itself must sit (margin conflict drove
    # reconstruction to empty maps)
    fracs = torch.tensor(FREE_FRACS, device=device)
    fx = poses[:, 0:1, None] + observed[..., None] * fracs * ux[..., None]
    fy = poses[:, 1:2, None] + observed[..., None] * fracs * uy[..., None]

    # sigmoid -> occ ~ 0.18
    logits = torch.full((H, W), -1.5, device=device, requires_grad=True)

    def loss(logits):
        occ = torch.sigmoid(logits)
        edf = soft_edt(occ, 1.0, iters=edt_iters, temperature=0.25,
                       init="log", init_lambda=3.0)
        d_hit = sample_edf_bilinear(edf, hx, hy)
        d_free = sample_edf_bilinear(edf, fx, fy)
        hit_term = (torch.where(hit_mask, d_hit, 0.0) ** 2).mean()
        free_term = (torch.relu(free_margin - d_free) ** 2).mean()
        return hit_term + free_term

    opt = torch.optim.Adam([logits], lr=0.3)
    losses = []
    t0 = time.time()
    for i in range(args.iters):
        opt.zero_grad()
        value = loss(logits)
        value.backward()
        opt.step()
        losses.append(float(value.detach()))
        if i % max(1, args.iters // 5) == 0:
            print(f"iter {i:3d}  tsdf loss {losses[-1]:8.4f}")
    occ_rec = torch.sigmoid(logits.detach()).cpu().numpy()
    # score on the OBSERVABLE surface: lidar can only see obstacle
    # boundary cells within range of some pose (not block interiors,
    # not beyond max_range on big maps)
    from scipy.ndimage import binary_dilation
    true = occ_true > 0.5
    surface = true & binary_dilation(~true)
    if args.map != "toy":
        seen = np.zeros_like(true)
        mask = hit_mask.cpu().numpy()
        hxn = np.clip(hx.cpu().numpy().astype(int), 0, W - 1)
        hyn = np.clip(hy.cpu().numpy().astype(int), 0, H - 1)
        seen[hyn[mask], hxn[mask]] = True
        surface &= binary_dilation(seen, iterations=2)
    pred_near = binary_dilation(occ_rec > 0.5, iterations=1)
    recall = (pred_near & surface).sum() / max(surface.sum(), 1)
    print(f"done in {time.time()-t0:.1f}s  surface recall = {recall:.2f} "
          f"({(pred_near & surface).sum()}/{surface.sum()} observed "
          f"boundary cells within 1 cell of a reconstructed obstacle)")
    return {"losses": losses, "recall": float(recall)}


if __name__ == "__main__":
    main()
