"""PyTorch port of multitrack serving against the JAX package.

Two small maps (a 220 x 220 blobby grid and the 192 x 192 ``small_track``)
are compiled by both packages, stacked by both, and scanned by both.
Inputs are made with numpy from a seed. Tolerances: the stacked tables,
the routing and every sweep given the JAX package's beam fan agree bit for
bit; a free-running scan builds its own fan, whose offsets and trig differ
from XLA's by an ulp on some beams (ROADMAP.md fault 3.1), so it is held to
1e-4 m on at least 99.5% of the beams.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pyracecarsimulator_tpu.maps import sectors as jsec
from pyracecarsimulator_tpu.ops import raycast_sectors as jrs
from pyracecarsimulator_tpu.ops.common import fan_cos_sin as jax_fan

from pyracecarsimulator_tpu_torch.maps import sectors as psec
from pyracecarsimulator_tpu_torch.ops import raycast_sectors as prs
from pyracecarsimulator_tpu_torch.ops import sweeps

FOV = 4.712388980384690
MAXR = 4.0
BB = 128
NB = 540
BUILD = dict(max_range=MAXR, tile_size=1.0, ns=8, block_half=0.62)


def _blobby():
    rng = np.random.RandomState(7)
    hw = 220
    occ = np.zeros((hw, hw), np.float32)
    occ[:3, :] = 1; occ[-3:, :] = 1; occ[:, :3] = 1; occ[:, -3:] = 1
    for _ in range(40):
        r, c = rng.randint(10, hw - 12), rng.randint(10, hw - 12)
        h, w = rng.randint(2, 9, 2)
        occ[r:r + h, c:c + w] = 1
    return occ, 0.05, (-hw * 0.05 / 2, -hw * 0.05 / 2)


def _free_poses(occ, res, org, n, rng):
    ys, xs = np.where(occ < 0.5)
    k = rng.randint(len(ys), size=n)
    return np.stack([org[0] + (xs[k] + .5) * res, org[1] + (ys[k] + .5) * res,
                     rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)


@pytest.fixture(scope="module")
def world(small_track):
    """(JAX maps, port maps, JAX stack, port stack, poses, map ids): 12
    agents on each map; one agent of each map stands outside it."""
    t = small_track
    grids = [_blobby(),
             (np.asarray(t.occupancy)[: t.height, : t.width], t.resolution,
              (t.origin_x, t.origin_y))]
    jmaps = [jsec.build_sector_map(occ, res, org, **BUILD)
             for occ, res, org in grids]
    pmaps = [psec.build_sector_map(occ, res, org, **BUILD)
             for occ, res, org in grids]
    rng = np.random.RandomState(2)
    poses = np.concatenate([_free_poses(*g, 12, rng) for g in grids])
    poses[3, 0] = 50.0           # outside map 0's extent
    poses[20, 1] = -50.0         # outside map 1's extent
    mid = np.asarray([0] * 12 + [1] * 12, np.int32)
    return (jmaps, pmaps, jsec.stack_sector_maps(jmaps),
            psec.stack_sector_maps(pmaps), poses, mid)


def _t(a):
    return torch.from_numpy(np.array(a))      # a writable host copy


def _jax_fan(poses, num_beams=NB, bb=BB):
    offs = jrs._padded_offsets(num_beams, FOV, bb)
    return jax_fan(jnp.asarray(poses[:, 2]), offs)


@pytest.mark.parametrize("leaf", ["table", "meta", "offsets", "grids",
                                  "extents"])
def test_stack_equals_jax_build(world, leaf):
    """Every tensor of the stack equals the JAX stack's bit for bit."""
    _, _, jstack, pstack, _, _ = world
    got = getattr(pstack, leaf).numpy()
    ref = np.asarray(getattr(jstack, leaf))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_stack_statics_and_layout(world):
    """Common capacities, rewritten meta, sentinel fill, no table_ck."""
    jmaps, pmaps, jstack, pstack, _, _ = world
    for f in ("ns", "kv_sec", "block_half", "tile_size"):
        assert getattr(pstack, f) == getattr(jstack, f)
    assert not hasattr(pstack, "table_ck")
    kv = max(m.kv_sec for m in pmaps)
    kh = max(m.table.shape[2] - m.kv_sec for m in pmaps)
    assert pstack.kv_sec == kv and pstack.table.shape[2] == kv + kh
    assert pstack.table.shape[0] == sum(m.table.shape[0] for m in pmaps)
    meta = pstack.meta.numpy()
    assert (meta[:, 1] == kv).all()
    l0 = pmaps[0].table.shape[0]
    m0 = pmaps[0].meta.numpy()
    np.testing.assert_array_equal(meta[:l0, 0], m0[:, 0])
    np.testing.assert_array_equal(meta[:l0, 2] - kv, m0[:, 2] - m0[:, 1])
    # a slot past a list's real ones is the never-hit sentinel
    tab = pstack.table.numpy()
    row = int(np.argmin(meta[:, 0]))
    np.testing.assert_array_equal(tab[row, :3, kv - 1],
                                  np.float32([psec._FAR, 1.0, -1.0]))
    assert pstack.device == pmaps[0].device


def test_stack_rejects_mixed_settings(world):
    _, pmaps, _, _, _, _ = world
    occ, res, org = _blobby()
    other = psec.build_sector_map(occ, res, org, max_range=MAXR,
                                  tile_size=2.0, ns=8, block_half=0.62)
    with pytest.raises(ValueError, match="share"):
        psec.stack_sector_maps([pmaps[0], other])


def test_stack_from_numpy_and_to(world):
    _, _, jstack, pstack, _, _ = world
    again = psec.StackedSectorMap.from_numpy(
        *(np.asarray(getattr(jstack, f)) for f in (
            "table", "meta", "offsets", "grids", "extents")),
        ns=jstack.ns, kv_sec=jstack.kv_sec, block_half=jstack.block_half,
        tile_size=jstack.tile_size)
    assert torch.equal(again.table, pstack.table)
    assert torch.equal(again.meta, pstack.meta)
    assert again.to("cpu").grids.dtype == torch.float32
    with pytest.raises(ValueError, match="table must be"):
        psec.StackedSectorMap.from_numpy(np.zeros((3, 5)), np.zeros((3, 3)),
                                         [0], [[1, 1, 0, 0]], [[0, 1, 0, 1]])


@pytest.mark.parametrize("bb", [64, 128])
def test_stack_block_ids_match_jax(world, bb):
    """Rows into the stacked table and the extent mask: identical given
    the same fan (int32 truncation and float32 division in JAX's order)."""
    _, _, jstack, pstack, poses, mid = world
    ct, st = _jax_fan(poses, bb=bb)
    ids_ref, in_ref = jrs.stack_block_ids(
        jstack, jnp.asarray(mid), jnp.asarray(poses[:, 0]),
        jnp.asarray(poses[:, 1]), ct, st, NB, bb)
    ids, inside = prs.stack_block_ids(
        pstack, _t(mid), _t(poses[:, 0]), _t(poses[:, 1]),
        _t(np.asarray(ct)), _t(np.asarray(st)), NB, bb)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_ref))
    np.testing.assert_array_equal(inside.numpy(), np.asarray(in_ref))
    assert not inside[3] and not inside[20] and inside.sum() == 22


def test_raycast_sectors_ids_matches_jax(world):
    """raycast_sectors_ids given the JAX ids and fan: values bit-exact."""
    _, _, jstack, pstack, poses, mid = world
    ct, st = _jax_fan(poses)
    a_n = poses.shape[0]
    shp = (a_n, ct.shape[1] // BB, BB)
    ids, _ = jrs.stack_block_ids(
        jstack, jnp.asarray(mid), jnp.asarray(poses[:, 0]),
        jnp.asarray(poses[:, 1]), ct, st, NB, BB)
    xb = np.repeat(poses[:, 0:1], ct.shape[1], 1).reshape(shp)
    yb = np.repeat(poses[:, 1:2], ct.shape[1], 1).reshape(shp)
    ref = jrs.raycast_sectors_ids(
        jstack.table, jstack.meta, ids, jstack.kv_sec, jnp.asarray(xb),
        jnp.asarray(yb), ct.reshape(shp), st.reshape(shp), MAXR)
    got = prs.raycast_sectors_ids(
        pstack.table, pstack.meta, _t(np.asarray(ids)), _t(xb), _t(yb),
        _t(np.asarray(ct)).reshape(shp), _t(np.asarray(st)).reshape(shp),
        MAXR)
    assert got.shape == (a_n, ct.shape[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert np.mean(got.numpy() < MAXR) > 0.3


def _port_multi_on_fan(pstack, poses, mid, ct, st, num_beams=NB, bb=BB,
                       sweep=sweeps.sector_sweep):
    return prs._scan_chunk_multi(pstack, _t(poses), _t(mid),
                                 _t(np.asarray(ct)), _t(np.asarray(st)),
                                 num_beams, MAXR, bb, sweep)


def test_multi_scan_with_jax_fan_is_bit_identical(world):
    """The multitrack scan given the JAX fan equals the JAX package's
    scan_poses_sectors_multi bit for bit, the extent mask included."""
    _, _, jstack, pstack, poses, mid = world
    ref = np.asarray(jrs.scan_poses_sectors_multi(
        jstack, jnp.asarray(mid), jnp.asarray(poses), num_beams=NB, fov=FOV,
        max_range=MAXR, bb=BB, mode="dense"))
    got = _port_multi_on_fan(pstack, poses, mid, *_jax_fan(poses))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.all(ref[3] == MAXR) and np.all(ref[20] == MAXR)


def test_free_running_multi_scan_within_tolerance(world):
    """With its own fan the port differs from the JAX multitrack scan only
    through ulp-level direction differences (ROADMAP.md fault 3.1):
    >= 99.5% of beams within 1e-4 m."""
    _, _, jstack, pstack, poses, mid = world
    ref = np.asarray(jrs.scan_poses_sectors_multi(
        jstack, jnp.asarray(mid), jnp.asarray(poses), num_beams=1080,
        fov=FOV, max_range=MAXR))
    got = prs.scan_poses_sectors_multi(pstack, _t(mid), _t(poses),
                                       num_beams=1080, fov=FOV,
                                       max_range=MAXR).numpy()
    assert got.shape == ref.shape == (24, 1080)
    assert np.mean(np.abs(got - ref) <= 1e-4) >= 0.995


@pytest.mark.parametrize("bb", [64, 128])
def test_multi_equals_per_map(world, bb):
    """One multitrack scan equals each map's own sector scan, bit for
    bit, and so do the pose gradients."""
    _, pmaps, _, pstack, poses, mid = world
    kw = dict(num_beams=NB, fov=FOV, max_range=MAXR, bb=bb)
    p = _t(poses).requires_grad_(True)
    multi = prs.scan_poses_sectors_multi(pstack, _t(mid), p, **kw)
    (multi ** 2).sum().backward()
    for m, sl in ((pmaps[0], slice(0, 12)), (pmaps[1], slice(12, 24))):
        q = _t(poses[sl]).requires_grad_(True)
        own = prs.scan_poses_sectors(m, q, **kw)
        (own ** 2).sum().backward()
        assert torch.equal(multi[sl].detach(), own.detach())
        assert torch.equal(p.grad[sl], q.grad)
    assert float(p.grad.abs().sum()) > 0


def test_multi_batch_shape_and_map_ids_forms(world):
    """Poses (2, 12, 3) with map ids as a tensor, an array or a list."""
    _, _, _, pstack, poses, mid = world
    kw = dict(num_beams=NB, fov=FOV, max_range=MAXR)
    flat = prs.scan_poses_sectors_multi(pstack, _t(mid), _t(poses), **kw)
    for ids in (_t(mid).reshape(2, 12), mid.reshape(2, 12), mid.tolist()):
        r = prs.scan_poses_sectors_multi(pstack, ids,
                                         _t(poses).reshape(2, 12, 3), **kw)
        assert r.shape == (2, 12, NB)
        assert torch.equal(r.reshape(24, NB), flat)


def test_multi_pose_gradient_matches_jax_on_a_shared_fan(world):
    """The ray cotangents of the multitrack sweep against jax.vjp of the
    JAX raycast_sectors_ids on the same ids and fan: exact. The table,
    meta and ids get no gradient."""
    _, _, jstack, pstack, poses, mid = world
    ct, st = (np.asarray(v) for v in _jax_fan(poses))
    a_n = poses.shape[0]
    shp = (a_n, ct.shape[1] // BB, BB)
    ids, _ = jrs.stack_block_ids(
        jstack, jnp.asarray(mid), jnp.asarray(poses[:, 0]),
        jnp.asarray(poses[:, 1]), jnp.asarray(ct), jnp.asarray(st), NB, BB)
    xb = np.repeat(poses[:, 0:1], ct.shape[1], 1).reshape(shp)
    yb = np.repeat(poses[:, 1:2], ct.shape[1], 1).reshape(shp)
    g = np.random.RandomState(5).standard_normal(ct.shape).astype(np.float32)
    r_ref, vjp = jax.vjp(
        lambda *rays: jrs.raycast_sectors_ids(
            jstack.table, jstack.meta, ids, jstack.kv_sec, *rays, MAXR),
        jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(ct.reshape(shp)),
        jnp.asarray(st.reshape(shp)))
    g_ref = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    table = pstack.table.clone().requires_grad_(True)
    rays = [torch.tensor(v.reshape(shp), requires_grad=True)
            for v in (xb, yb, ct, st)]
    r = prs.raycast_sectors_ids(table, pstack.meta, _t(np.asarray(ids)),
                                *rays, MAXR)
    r.backward(_t(g))
    np.testing.assert_array_equal(r.detach().numpy(), np.asarray(r_ref))
    for got, ref in zip(rays, g_ref):
        np.testing.assert_array_equal(got.grad.numpy(), ref)
    assert table.grad is None


def test_multi_pose_gradient_against_jax_grad_free_running(world):
    """d sum(r^2) / d poses of the free-running multitrack scan against
    jax.grad of the JAX one: rtol 1e-3 / atol 1e-2 on at least 95% of the
    pose components (a beam whose winner flips under an ulp of direction
    moves a component by a whole beam's share)."""
    _, _, jstack, pstack, poses, mid = world
    kw = dict(num_beams=NB, fov=FOV, max_range=MAXR, bb=BB)
    g_ref = np.asarray(jax.grad(lambda p: jnp.sum(
        jrs.scan_poses_sectors_multi(jstack, jnp.asarray(mid), p,
                                     mode="dense", **kw) ** 2))(
        jnp.asarray(poses)))
    p = _t(poses).requires_grad_(True)
    (prs.scan_poses_sectors_multi(pstack, _t(mid), p, **kw) ** 2
     ).sum().backward()
    close = np.isclose(p.grad.numpy(), g_ref, rtol=1e-3, atol=1e-2)
    assert close.mean() >= 0.95
    assert np.all(p.grad.numpy()[3] == 0) and np.all(g_ref[3] == 0)


@pytest.mark.parametrize("mode", ["sorted_pl@32", "sorted_pl@64"])
def test_multi_sorted_pl_matches_pallas_kernel(world, mode):
    """mode="sorted_pl" through the multitrack path against the JAX
    package's sorted-tile Pallas kernel in interpret mode (as
    tests/test_sectors.py runs it), on the JAX fan: bit-exact. On the CPU
    the port's route runs the plain list sweep."""
    _, _, jstack, pstack, poses, mid = world
    ref = np.asarray(jrs.scan_poses_sectors_multi(
        jstack, jnp.asarray(mid), jnp.asarray(poses), num_beams=NB, fov=FOV,
        max_range=MAXR, bb=BB, mode=mode, interpret=True))
    got = _port_multi_on_fan(pstack, poses, mid, *_jax_fan(poses),
                             sweep=sweeps.sorted_tiles_sweep)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("mode, ok", [("auto", True), ("dense", True),
                                      ("sorted_pl@64", True),
                                      ("sorted_plf@128", True),
                                      ("sorted_pt", False)])
def test_multi_modes(world, mode, ok):
    """The modes of the single-map scan: the list kernel's routes give
    the same values; the XLA-only sorted modes are not ported."""
    _, _, _, pstack, poses, mid = world
    kw = dict(num_beams=NB, fov=FOV, max_range=MAXR)
    if not ok:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            prs.scan_poses_sectors_multi(pstack, _t(mid), _t(poses),
                                         mode=mode, **kw)
        return
    ref = prs.scan_poses_sectors_multi(pstack, _t(mid), _t(poses), **kw)
    r = prs.scan_poses_sectors_multi(pstack, _t(mid), _t(poses), mode=mode,
                                     **kw)
    assert torch.equal(r, ref)
    assert all(w.launches == 0 for w in sweeps.LIST_ROUTES)


@pytest.mark.parametrize("chunk", [7, 12, 100])
def test_multi_agent_chunks_are_bit_identical(world, chunk):
    """agent_chunk=7 (a ragged last chunk) equals agent_chunk=0, values
    and gradients."""
    _, _, _, pstack, poses, mid = world
    kw = dict(num_beams=NB, fov=FOV, max_range=MAXR, bb=64)
    outs = []
    for c in (0, chunk):
        p = _t(poses).requires_grad_(True)
        r = prs.scan_poses_sectors_multi(pstack, _t(mid), p, agent_chunk=c,
                                         **kw)
        (r ** 2).sum().backward()
        outs.append((r.detach(), p.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_stacked_capacity_fits_the_kernel(world):
    """The list kernel stages 3 rows of K float32 in <= 48 KB of shared
    memory: K <= 4096, far above a stack of the bundled maps (496)."""
    _, _, _, pstack, _, _ = world
    assert 3 * pstack.table.shape[2] * 4 <= 48 * 1024
    assert 3 * 4096 * 4 <= 48 * 1024 < 3 * 4097 * 4
