"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU, a CUDA build of PyTorch and nvcc; without
a card they skip (the check happens in a fixture, so every worker collects
the same tests). On a machine with a card:

    python -m pytest tests/test_torch_kernels.py -m cuda -q

Tolerance: none. The kernel is compiled without FMA contraction or fast
math and must equal ``sweep_plain`` bit for bit on the same inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyracecarsimulator_tpu_torch.maps.loader import build_track_map
from pyracecarsimulator_tpu_torch.maps.sectors import build_sector_map
from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
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
    track = build_track_map(occ, 0.05, (-4.8, -4.8))
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
    args = (smap.table, smap.meta, smap.kv_sec, ids.reshape(g).contiguous(),
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
    with pytest.raises(ValueError, match="int32"):
        rs.sector_sweep(smap.table, smap.meta, smap.kv_sec,
                        ok["ids"].long(), ok["x0"], ok["y0"], *rays)
    with pytest.raises(ValueError, match="contiguous"):
        rs.sector_sweep(smap.table, smap.meta, smap.kv_sec, ok["ids"],
                        ok["x0"], ok["y0"],
                        torch.ones(bb, g, device=cuda).t(), *rays[1:])
