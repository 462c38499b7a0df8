"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU, a CUDA build of PyTorch and nvcc; without
a card they skip (the check happens in a fixture, so every worker collects
the same tests). On a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

Tolerance: none. The kernels are compiled without FMA contraction or fast
math and must equal their plain versions (``list_sweep_plain``,
``dense_sweep_plain``) bit for bit on the same inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyracecarsimulator_tpu_torch.maps.loader import build_track_map
from pyracecarsimulator_tpu_torch.maps.sectors import build_sector_map
from pyracecarsimulator_tpu_torch.maps.segments import build_segment_map
from pyracecarsimulator_tpu_torch.ops import raycast_grad as rg
from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
from pyracecarsimulator_tpu_torch.ops import raycast_segments as rseg
from pyracecarsimulator_tpu_torch.ops import sweeps
from pyracecarsimulator_tpu_torch.ops.common import _ray_invs, fan_cos_sin

pytestmark = pytest.mark.cuda

FOV = 4.712388980384690


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _corridor(ns, tile_size):
    """A corridor loop with a pillar (tests/conftest.py's small_track)."""
    occ = np.zeros((192, 192), np.float32)
    occ[:4, :] = 1; occ[-4:, :] = 1; occ[:, :4] = 1; occ[:, -4:] = 1
    occ[60:132, 60:132] = 1
    occ[100:104, 20:40] = 1
    track = build_track_map(occ, 0.05, (-4.8, -4.8), device="cpu")
    return track, build_sector_map(
        track.occupancy.numpy(), 0.05, (-4.8, -4.8), tile_size=tile_size,
        ns=ns, real_hw=(192, 192))


@pytest.mark.parametrize("ns, tile_size, num_beams",
                         [(16, 2.0, 1080), (4, 4.0, 540), (16, 2.0, 37)])
def test_kernel_matches_plain(cuda, ns, tile_size, num_beams):
    track, smap = _corridor(ns, tile_size)
    rng = np.random.RandomState(0)
    edf = track.edf.numpy()[:192, :192]
    ys, xs = np.where(edf > 0.2)
    k = rng.randint(len(ys), size=300)
    poses = torch.tensor(np.stack([-4.8 + (xs[k] + .5) * .05,
                                   -4.8 + (ys[k] + .5) * .05,
                                   rng.uniform(-np.pi, np.pi, 300)], -1),
                         dtype=torch.float32, device=cuda)
    smap = smap.to(cuda)
    bb = rs.sector_block_width(smap, num_beams, FOV)
    ct, st = fan_cos_sin(poses[:, 2], rs._padded_offsets(num_beams, FOV, bb,
                                                         cuda))
    ids = rs._list_ids(smap.tiles_shape, smap.tile_size, smap.tile_origin,
                       smap.ns, poses[:, 0], poses[:, 1], ct, st, bb)
    ic, is_ = _ray_invs(ct, st)
    g = ids.numel()
    nblk = g // poses.shape[0]
    args = (smap.table, smap.meta, ids.reshape(g).contiguous(),
            poses[:, 0].repeat_interleave(nblk).contiguous(),
            poses[:, 1].repeat_interleave(nblk).contiguous(),
            *(v.reshape(g, bb).contiguous() for v in (ct, st, ic, is_)))
    before = rs.sector_sweep.launches
    bv, bh = rs.sector_sweep(*args)
    torch.cuda.synchronize()
    assert rs.sector_sweep.launches == before + 1
    bv_p, bh_p = rs.sweep_plain(*args)
    assert torch.equal(bv, bv_p) and torch.equal(bh, bh_p)
    assert bool((torch.minimum(bv, bh) < 10.0).float().mean() > 0.5)


def test_scan_on_card_matches_cpu_scan(cuda):
    """The whole scan: kernel on the card vs plain on the CPU, same fan."""
    _, smap = _corridor(16, 2.0)
    rng = np.random.RandomState(1)
    poses = torch.tensor(np.stack([rng.uniform(-4, 4, 64),
                                   rng.uniform(-4, 4, 64),
                                   rng.uniform(-np.pi, np.pi, 64)], -1),
                         dtype=torch.float32)
    bb = rs.sector_block_width(smap, 1080, FOV)
    ct, st = fan_cos_sin(poses[:, 2], rs._padded_offsets(1080, FOV, bb))
    r_cpu = rs._scan_chunk(smap, poses, ct, st, 1080, 10.0, bb)
    r_dev = rs._scan_chunk(smap.to(cuda), poses.to(cuda), ct.to(cuda),
                           st.to(cuda), 1080, 10.0, bb)
    assert torch.equal(r_dev.cpu(), r_cpu)


def test_wrapper_rejects_bad_inputs(cuda):
    _, smap = _corridor(16, 2.0)
    smap = smap.to(cuda)
    g, bb = 4, 128
    ok = dict(ids=torch.zeros(g, dtype=torch.int32, device=cuda),
              x0=torch.zeros(g, device=cuda), y0=torch.zeros(g, device=cuda))
    rays = [torch.ones(g, bb, device=cuda) for _ in range(4)]
    for wrapper in sweeps.LIST_ROUTES:
        with pytest.raises(ValueError, match="int32"):
            wrapper(smap.table, smap.meta, ok["ids"].long(), ok["x0"],
                    ok["y0"], *rays)
        with pytest.raises(ValueError, match="contiguous"):
            wrapper(smap.table, smap.meta, ok["ids"], ok["x0"], ok["y0"],
                    torch.ones(bb, g, device=cuda).t(), *rays[1:])
        with pytest.raises(ValueError, match="shared memory"):
            wrapper(torch.zeros(2, 4, 8192, device=cuda),
                    torch.zeros(2, 3, dtype=torch.int32, device=cuda),
                    ok["ids"], ok["x0"], ok["y0"], *rays)
    params = torch.zeros(4, 256, device=cuda)
    meta = torch.tensor([0, 128, 128], dtype=torch.int32, device=cuda)
    flat = [torch.ones(300, device=cuda) for _ in range(6)]
    with pytest.raises(ValueError, match="int32"):
        sweeps.dense_sweep(params, meta.long(), *flat)
    with pytest.raises(ValueError, match="float32"):
        sweeps.dense_sweep(params.double(), meta, *flat)
    with pytest.raises(ValueError, match=r"\(4, K\)"):
        sweeps.dense_sweep(params[:3], meta, *flat)
    with pytest.raises(ValueError, match="contiguous"):
        sweeps.dense_sweep(params, meta, torch.ones(600, device=cuda)[::2],
                           *flat[1:])
    with pytest.raises(ValueError, match="on cpu"):
        sweeps.dense_sweep(params, meta, flat[0].cpu(), *flat[1:])


def _random_segments(rng, n_v, kv, n_h, kh):
    """A split (4, kv + kh) table of random axis-aligned segments in a
    20 m square, sentinel-padded, and its sweep_meta."""
    params = np.zeros((4, kv + kh), np.float32)
    params[0], params[1], params[2] = 1e9, 1.0, -1.0
    for lo_i, n in ((0, n_v), (kv, n_h)):
        p = rng.uniform(-10, 10, n)
        a = rng.uniform(-10, 10, n)
        params[0, lo_i:lo_i + n] = p
        params[1, lo_i:lo_i + n] = a
        params[2, lo_i:lo_i + n] = a + rng.uniform(0.05, 2.0, n)
    params[3, :kv] = 1.0
    return params, np.array([n_v, kv, kv + n_h], np.int32)


@pytest.mark.parametrize("n_v, kv, n_h, kh, n", [
    (41, 41, 41, 87, 4096 * 3),       # mixed layout, levine's counts
    (84, 128, 128, 128, 1000),        # split, ragged ray count
    (2221, 2304, 2221, 2304, 2 * 256 + 37),   # berlin-untiled: 3 chunks
    (0, 0, 5, 128, 77)])              # no verticals
def test_dense_matches_plain(cuda, n_v, kv, n_h, kh, n):
    rng = np.random.RandomState(n)
    params, meta = _random_segments(rng, n_v, kv, n_h, kh)
    if kv == n_v:                      # mixed: [n_v, n_v, n]
        meta = np.array([n_v, n_v, n_v + n_h], np.int32)
    th = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    ct, st = np.cos(th), np.sin(th)
    ct[:3], st[3:6] = 0.0, 0.0
    rays = [torch.tensor(v, device=cuda) for v in (
        rng.uniform(-8, 8, n).astype(np.float32),
        rng.uniform(-8, 8, n).astype(np.float32), ct, st)]
    args = (torch.tensor(params, device=cuda),
            torch.tensor(meta, device=cuda), *rays, *_ray_invs(*rays[2:]))
    before = sweeps.dense_sweep.launches
    bv, bh = sweeps.dense_sweep(*args)
    torch.cuda.synchronize()
    assert sweeps.dense_sweep.launches == before + 1
    bv_p, bh_p = sweeps.dense_sweep_plain(*args)
    assert torch.equal(bv, bv_p) and torch.equal(bh, bh_p)
    assert bool((torch.minimum(bv, bh) < 1e9).any())


def _blobby(seed, n_blocks):
    rng = np.random.RandomState(seed)
    occ = np.zeros((220, 220), np.float32)
    occ[:3, :] = 1; occ[-3:, :] = 1; occ[:, :3] = 1; occ[:, -3:] = 1
    for _ in range(n_blocks):
        r, c = rng.randint(10, 208), rng.randint(10, 208)
        h, w = rng.randint(2, 9, 2)
        occ[r:r + h, c:c + w] = 1
    return occ


@pytest.mark.parametrize("seed, n_blocks, kw", [
    (7, 40, dict(tile_size=1.0, max_range=2.0)),     # mixed tiles
    (3, 400, dict(tile_size=2.0, max_range=4.0))])   # split tiles
def test_tile_sweep_and_scans_match_plain(cuda, seed, n_blocks, kw):
    """The tile route against the plain sweep on the scan's rows, and the
    dense and tiled scans on the card against the CPU scans (same fan),
    values and pose gradients."""
    segmap = build_segment_map(_blobby(seed, n_blocks), 0.05, (-5.5, -5.5),
                               **kw)
    assert segmap.tiles is not None
    rng = np.random.RandomState(seed)
    poses = torch.tensor(np.stack([rng.uniform(-5, 5, 40),
                                   rng.uniform(-5, 5, 40),
                                   rng.uniform(-np.pi, np.pi, 40)], -1),
                         dtype=torch.float32)
    offs = rs._padded_offsets(1080, FOV, 128)
    ct, st = fan_cos_sin(poses[:, 2], offs)
    dev = segmap.to(cuda)
    p_d, ct_d, st_d = poses.to(cuda), ct.to(cuda), st.to(cuda)
    mins = rg._tiled_minima(dev.tiles, dev.tile_sweep_meta, dev.tiles_shape,
                            dev.tile_size, dev.tile_origin, p_d[:, 0],
                            p_d[:, 1], p_d[:, 0:1].expand(ct_d.shape),
                            p_d[:, 1:2].expand(ct_d.shape), ct_d, st_d)
    ref = rg._tiled_minima(segmap.tiles, segmap.tile_sweep_meta,
                           segmap.tiles_shape, segmap.tile_size,
                           segmap.tile_origin, poses[:, 0], poses[:, 1],
                           poses[:, 0:1].expand(ct.shape),
                           poses[:, 1:2].expand(ct.shape), ct, st)
    for a, b in zip(mins, ref):
        assert torch.equal(a.cpu(), b)
    for use_tiles in (True, False):
        before = (sweeps.tile_sweep.launches, sweeps.dense_sweep.launches)
        pg = p_d.clone().requires_grad_(True)
        r_dev = rseg._scan_rays(dev, pg, ct_d, st_d, 1080, kw["max_range"],
                                use_tiles)
        r_dev.sum().backward()
        pc = poses.clone().requires_grad_(True)
        r_cpu = rseg._scan_rays(segmap, pc, ct, st, 1080, kw["max_range"],
                                use_tiles)
        r_cpu.sum().backward()
        assert torch.equal(r_dev.detach().cpu(), r_cpu.detach())
        assert torch.allclose(pg.grad.cpu(), pc.grad, rtol=1e-5, atol=1e-5)
        after = (sweeps.tile_sweep.launches, sweeps.dense_sweep.launches)
        assert after == (before[0] + use_tiles, before[1] + (not use_tiles))


@pytest.mark.parametrize("mode, use_pallas, route", [
    ("sorted_pl", None, "sorted_tiles_sweep"),
    ("auto", True, "grp_sweep"), ("auto", None, "sector_sweep")])
def test_sector_routes_launch_their_wrapper(cuda, mode, use_pallas, route):
    """Kernels 2.2 and 2.3 run as routes onto the list kernel: each mode
    counts on its own wrapper, with the sector scan's values."""
    _, smap = _corridor(16, 2.0)
    rng = np.random.RandomState(2)
    poses = torch.tensor(np.stack([rng.uniform(-4, 4, 32),
                                   rng.uniform(-4, 4, 32),
                                   rng.uniform(-np.pi, np.pi, 32)], -1),
                         dtype=torch.float32)
    smap, poses = smap.to(cuda), poses.to(cuda)
    ref = rs.scan_poses_sectors(smap, poses)
    wrapper = getattr(sweeps, route)
    before = wrapper.launches
    got = rs.scan_poses_sectors(smap, poses, mode=mode,
                                use_pallas=use_pallas)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(got, ref)
