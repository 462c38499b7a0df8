"""The port's ring map-pass scan against the replicated sector scan and
the JAX package's ring scan.

One ``parallel.dryrun.dryrun`` spawn per mesh shape (4 gloo ranks on the
CPU) runs ``make_ring_scan`` on a 220 x 220 blobby map, 16 agents x 512
beams; the ring is as long as the mesh's beams axis (4, 2 and 1 slabs).
Tolerances: the ring assembles the very rows the replicated scan reads and
sweeps them with the same arithmetic, so ranges equal the port's
``scan_poses_sectors`` bit for bit and gradients within 1e-5; against the
JAX ring scan, which builds its own fan (ROADMAP.md fault 3.1), at least
99.5% of the beams within 1e-4 m.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pyracecarsimulator_tpu.maps.sectors import (build_sector_map as
                                                 jax_build_sector_map)
from pyracecarsimulator_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pyracecarsimulator_tpu.parallel.ringmap import (make_ring_scan as
                                                     jax_make_ring_scan)

from pyracecarsimulator_tpu_torch.maps.segments import _FAR
from pyracecarsimulator_tpu_torch.ops.raycast_sectors import (
    scan_poses_sectors)
from pyracecarsimulator_tpu_torch.parallel import dryrun as dr
from pyracecarsimulator_tpu_torch.parallel import ringmap as prm
from pyracecarsimulator_tpu_torch.parallel.mesh import Mesh

FOV = 4.712388980384690
MAXR = 4.0
NB = 512
SHAPES = [(1, 4), (2, 2), (4, 1)]


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(7)
    hw = 220
    occ = np.zeros((hw, hw), np.float32)
    occ[:3, :] = 1; occ[-3:, :] = 1; occ[:, :3] = 1; occ[:, -3:] = 1
    for _ in range(40):
        r, c = rng.randint(10, hw - 12), rng.randint(10, hw - 12)
        h, w = rng.randint(2, 9, 2)
        occ[r:r + h, c:c + w] = 1
    res = 0.05
    org = (-hw * res / 2, -hw * res / 2)
    ys, xs = np.where(occ < 0.5)
    k = rng.randint(len(ys), size=16)
    poses = np.stack([org[0] + (xs[k] + .5) * res,
                      org[1] + (ys[k] + .5) * res,
                      rng.uniform(-np.pi, np.pi, 16)], -1).astype(np.float32)
    return {"maps": [{"occupancy": occ, "resolution": res, "origin": org}],
            "poses": poses, "num_beams": NB, "fov": FOV, "max_range": MAXR,
            "tile_size": 1.0, "sector_ns": 8, "paths": ("ring",)}


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def ring(request, case):
    a, b = request.param
    return (a, b), dr.dryrun(a * b, beams_axis=b, device="cpu", case=case)


@pytest.fixture(scope="module")
def replicated(case):
    """(sector map, ranges, pose gradient) of the replicated port scan."""
    smap = dr.case_bundles(case, "cpu")[0][0].segmap
    p = torch.tensor(case["poses"]).requires_grad_(True)
    r = scan_poses_sectors(smap, p, num_beams=NB, fov=FOV, max_range=MAXR)
    (r ** 2).sum().backward()
    return smap, r.detach().numpy(), p.grad.numpy()


def test_ring_scan_matches_replicated(ring, replicated):
    """Bit-parity: the ring-assembled sweep is the same arithmetic over
    the same rows as the replicated path."""
    _, res = ring
    assert res["ring"].shape == (16, NB)
    np.testing.assert_array_equal(res["ring"], replicated[1])
    assert np.mean(replicated[1] < MAXR) > 0.5


def test_ring_scan_gradient(ring, replicated):
    """Pose gradients through the ring scan equal the replicated
    backend's (rtol/atol 1e-5): the backward never touches the ring, and
    the wedges' shares are summed over the beams group."""
    _, res = ring
    assert np.abs(replicated[2]).sum() > 0
    np.testing.assert_allclose(res["ring_grad"], replicated[2], rtol=1e-5,
                               atol=1e-5)


def test_ring_table_sharded_memory(ring, replicated):
    """Each rank keeps L/S table rows (the capacity point of the ring)."""
    (_, s), res = ring
    l_n = replicated[0].table.shape[0]
    assert res["table_rows"] == l_n
    assert res["slab_rows"] == -(-l_n // s)
    assert res["launches"] == [{}] * 4        # CPU tensors: plain sweep
    assert "scan_sectors" not in res          # the case ran the ring only


def test_ring_scan_matches_jax_ring_scan(ring, case):
    """Against the JAX package's make_ring_scan on a mesh of the same
    shape, each with its own fan: >= 99.5% of the beams within 1e-4 m."""
    shape, res = ring
    m = case["maps"][0]
    jmap = jax_build_sector_map(m["occupancy"], m["resolution"], m["origin"],
                                max_range=MAXR, tile_size=1.0, ns=8)
    mesh = jax_make_mesh(jax.devices()[:4], agents_axis=shape[0],
                         beams_axis=shape[1])
    ref = np.asarray(jax_make_ring_scan(mesh, jmap, NB, FOV, MAXR)(
        jnp.asarray(case["poses"])))
    assert np.mean(np.abs(res["ring"] - ref) <= 1e-4) >= 0.995


def _mesh(beams, index):
    return Mesh(agents=1, beams=beams, agents_index=0, beams_index=index,
                beams_ranks=tuple(range(beams)))


@pytest.mark.parametrize("s", [1, 3, 4])
def test_shard_sector_table_slabs(replicated, s):
    """The slabs of every ring position, concatenated, are the table
    followed by never-hit sentinel rows up to a multiple of S."""
    smap = replicated[0]
    slabs, rows = zip(*(prm.shard_sector_table(_mesh(s, i), smap)
                        for i in range(s)))
    l_n, _, k = smap.table.shape
    ls = -(-l_n // s)
    assert set(rows) == {ls} and all(t.shape == (ls, 4, k) for t in slabs)
    whole = torch.cat(slabs)
    assert torch.equal(whole[:l_n], smap.table)
    pad = whole[l_n:]
    assert pad.shape[0] == s * ls - l_n
    assert bool((pad[:, 0] == _FAR).all() and (pad[:, 1] == 1.0).all()
                and (pad[:, 2] == -1.0).all())
    # a slab is a copy: the rank may drop the full table
    assert slabs[0].data_ptr() != smap.table.data_ptr()


def test_ring_of_one_runs_without_a_process_group(replicated, case):
    """S = 1: no neighbour to pass to, so the scan needs no process group;
    it gathers the rows itself and equals the replicated scan bit for
    bit."""
    smap, ref, g_ref = replicated
    scan = prm.make_ring_scan(_mesh(1, 0), smap, NB, FOV, MAXR)
    assert scan.slab_rows == smap.table.shape[0]
    p = torch.tensor(case["poses"]).requires_grad_(True)
    r = scan(p)
    (r ** 2).sum().backward()
    np.testing.assert_array_equal(r.detach().numpy(), ref)
    np.testing.assert_allclose(p.grad.numpy(), g_ref, rtol=1e-5, atol=1e-5)


def test_ring_gather_returns_the_rows(replicated):
    smap = replicated[0]
    ids = torch.tensor([5, 0, smap.table.shape[0] - 1, 5], dtype=torch.int32)
    slab, ls = prm.shard_sector_table(_mesh(1, 0), smap)
    buf = prm._ring_gather(_mesh(1, 0), slab, ids, ls)
    assert torch.equal(buf, smap.table[ids.long()])


def test_ring_rejects_indivisible_beams(replicated):
    with pytest.raises(ValueError, match="not divisible by beams"):
        prm.make_ring_scan(_mesh(3, 0), replicated[0], NB, FOV, MAXR)
