"""PyTorch port of the sector backend against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: sweeps given the same fan, list ids and reciprocals agree bit
for bit (the sweep's arithmetic is IEEE float32, one rounding per operation,
on both sides). A free-running scan builds its own fan, whose offsets and
trig differ from XLA's by an ulp on some beams (ROADMAP.md fault 3.1), so
it is held to 1e-4 m on at least 99.5% of the beams.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from pyracecarsimulator_tpu.maps.sectors import (build_sector_map as
                                                 jax_build_sector_map,
                                                 build_table_ck)
from pyracecarsimulator_tpu.ops import raycast_sectors as jrs
from pyracecarsimulator_tpu.ops.common import fan_cos_sin as jax_fan
from pyracecarsimulator_tpu.ops.raycast_pallas import (
    _raycast_pallas_ids_grp_raw, sweep_sorted_tiles_fused,
    sweep_sorted_tiles_pallas)
from pyracecarsimulator_tpu.ops.raycast_segments import (
    _ray_invs as jax_ray_invs)

from pyracecarsimulator_tpu_torch.maps.sectors import SectorSegmentMap
from pyracecarsimulator_tpu_torch.ops import _kernels
from pyracecarsimulator_tpu_torch.ops import raycast_sectors as prs
from pyracecarsimulator_tpu_torch.ops import sweeps

FOV = 4.712388980384690
MAXR = 4.0
BB = 128
STATICS = ("n_segments", "ns", "kv_sec", "block_half", "tile_size",
           "tiles_shape", "tile_origin", "extent", "rt", "reach")


@pytest.fixture(scope="module")
def blobby_bigk():
    """tests/test_sectors.py's blobby geometry at coarse tiles/sectors:
    capacity K >= 112, so the JAX map carries the fused kernel's table_ck
    layout."""
    rng = np.random.RandomState(7)
    H = W = 220
    occ = np.zeros((H, W), np.float32)
    occ[:3, :] = 1; occ[-3:, :] = 1; occ[:, :3] = 1; occ[:, -3:] = 1
    for _ in range(40):
        r, c = rng.randint(10, H - 12), rng.randint(10, W - 12)
        h, w = rng.randint(2, 9, 2)
        occ[r:r + h, c:c + w] = 1
    res = 0.05
    org = (-H * res / 2, -W * res / 2)
    jmap = jax_build_sector_map(occ, res, org, max_range=MAXR, tile_size=4.0,
                                ns=4, block_half=0.62)
    assert jmap.table.shape[2] >= 112 and jmap.table_ck is not None
    ys, xs = np.where(occ < 0.5)
    k = rng.randint(len(ys), size=12)
    poses = np.stack([org[0] + (xs[k] + .5) * res,
                      org[1] + (ys[k] + .5) * res,
                      rng.uniform(-np.pi, np.pi, 12)], -1).astype(np.float32)
    return jmap, _port_map(jmap), poses


def _port_map(jmap):
    return SectorSegmentMap.from_numpy(
        np.asarray(jmap.table), np.asarray(jmap.meta),
        **{f: getattr(jmap, f) for f in STATICS}, device="cpu")


def _jax_rows(jmap, poses, num_beams):
    """The JAX package's own fan, list ids and reciprocals, flattened to
    (G, BB) ray rows."""
    offs = jrs._padded_offsets(num_beams, FOV, BB)
    ct, st = jax_fan(jnp.asarray(poses[:, 2]), offs)
    x0 = jnp.asarray(poses[:, 0])
    y0 = jnp.asarray(poses[:, 1])
    ids = jrs._list_ids(jmap.tiles_shape, jmap.tile_size, jmap.tile_origin,
                        jmap.ns, x0, y0, ct, st, BB)
    ic, is_ = jax_ray_invs(ct, st)
    nblk = ct.shape[1] // BB
    g = poses.shape[0] * nblk
    rows = [np.asarray(v).reshape(g, BB) for v in (ct, st, ic, is_)]
    return (np.asarray(ids).reshape(g), np.repeat(poses[:, 0], nblk),
            np.repeat(poses[:, 1], nblk), rows, (ct, st))


def _t(a):
    return torch.from_numpy(np.array(a))      # a writable host copy


def _assert_same_result(bv_ref, bh_ref, bv, bh):
    """Clamped ranges and hit bit-exact, isv equal where hit. Unclamped
    minima may differ where nothing real is hit: the reference kernels
    also visit sentinel slots, whose 'hits' land near 1e9 m."""
    bv_ref, bh_ref = np.asarray(bv_ref), np.asarray(bh_ref)
    bv, bh = bv.numpy(), bh.numpy()
    m_ref = np.minimum(bv_ref, bh_ref)
    m = np.minimum(bv, bh)
    np.testing.assert_array_equal(np.minimum(m, MAXR),
                                  np.minimum(m_ref, MAXR))
    hit = m < MAXR
    np.testing.assert_array_equal(hit, m_ref < MAXR)
    np.testing.assert_array_equal((bv <= bh)[hit], (bv_ref <= bh_ref)[hit])
    assert hit.mean() > 0.5


@pytest.mark.parametrize("chunk", [8, 16])
def test_sweep_plain_matches_fused_pallas_kernel(blobby_bigk, chunk):
    """sweep_plain == sweep_sorted_tiles_fused (interpret mode), the TPU
    kernel the CUDA kernel replaces, on the same rows."""
    jmap, pmap, poses = blobby_bigk
    ids, x0, y0, (ct, st, ic, is_), _ = _jax_rows(jmap, poses, 540)
    k = jmap.table.shape[2]
    bv_ref, bh_ref = sweep_sorted_tiles_fused(
        build_table_ck(jmap.table), jmap.meta, jmap.kv_sec, k,
        jnp.asarray(ids), jnp.asarray(x0), jnp.asarray(y0),
        *map(jnp.asarray, (ct, st, ic, is_)), chunk=chunk, tile_rows=16,
        interpret=True)
    bv, bh = prs.sweep_plain(pmap.table, pmap.meta, _t(ids), _t(x0),
                             _t(y0), _t(ct), _t(st), _t(ic), _t(is_))
    _assert_same_result(bv_ref, bh_ref, bv, bh)


def test_sweep_plain_matches_xla_dense_sweep(blobby_bigk):
    """sweep_plain == _sweep_xla (the JAX sweep of small-capacity maps)."""
    jmap, pmap, poses = blobby_bigk
    ids, x0, y0, (ct, st, ic, is_), _ = _jax_rows(jmap, poses, 1080)
    a_n = poses.shape[0]
    nblk = ids.shape[0] // a_n
    shp = lambda v: jnp.asarray(v).reshape(a_n, nblk, BB)
    xb = np.repeat(x0[:, None], BB, 1)
    yb = np.repeat(y0[:, None], BB, 1)
    bv_ref, bh_ref = jrs._sweep_xla(
        jmap.table, jmap.kv_sec, jnp.asarray(ids).reshape(a_n, nblk),
        *map(shp, (xb, yb, ct, st, ic, is_)), 64)
    bv, bh = prs.sweep_plain(pmap.table, pmap.meta, _t(ids), _t(x0),
                             _t(y0), _t(ct), _t(st), _t(ic), _t(is_))
    _assert_same_result(np.asarray(bv_ref).reshape(-1, BB),
                        np.asarray(bh_ref).reshape(-1, BB), bv, bh)


def test_list_ids_match_jax(blobby_bigk):
    """Tile/sector routing: identical rows given the same fan."""
    jmap, pmap, poses = blobby_bigk
    ids, _, _, _, (ct, st) = _jax_rows(jmap, poses, 1080)
    got = prs._list_ids(pmap.tiles_shape, pmap.tile_size, pmap.tile_origin,
                        pmap.ns, _t(poses[:, 0]), _t(poses[:, 1]),
                        _t(np.asarray(ct)), _t(np.asarray(st)), BB)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().reshape(-1), ids)


@pytest.mark.parametrize("num_beams", [540, 1080])
def test_scan_with_jax_fan_is_bit_identical(blobby_bigk, num_beams):
    """The port's scan given the JAX package's beam fan equals the JAX
    package's scan_poses_sectors bit for bit (extent mask included: one
    pose is moved outside the map)."""
    jmap, pmap, poses = blobby_bigk
    poses = poses.copy()
    poses[0, 0] = 50.0
    ref = np.asarray(jrs.scan_poses_sectors(
        jmap, jnp.asarray(poses), num_beams=num_beams, fov=FOV,
        max_range=MAXR, bb=BB))
    _, _, _, _, (ct, st) = _jax_rows(jmap, poses, num_beams)
    got = prs._scan_chunk(pmap, _t(poses), _t(np.asarray(ct)),
                          _t(np.asarray(st)), num_beams, MAXR, BB)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.all(ref[0] == MAXR)


def test_free_running_scan_within_tolerance(blobby_bigk):
    """With its own fan the port differs from the JAX scan only through
    ulp-level direction differences (ROADMAP.md fault 3.1): >= 99.5% of
    beams within 1e-4 m."""
    jmap, pmap, poses = blobby_bigk
    ref = np.asarray(jrs.scan_poses_sectors(
        jmap, jnp.asarray(poses), num_beams=1080, fov=FOV, max_range=MAXR))
    got = prs.scan_poses_sectors(pmap, _t(poses), num_beams=1080, fov=FOV,
                                 max_range=MAXR).numpy()
    assert got.shape == ref.shape == (poses.shape[0], 1080)
    assert np.mean(np.abs(got - ref) <= 1e-4) >= 0.995


def test_agent_chunks_are_bit_identical(blobby_bigk):
    _, pmap, poses = blobby_bigk
    p = _t(poses).reshape(3, 4, 3)
    kw = dict(num_beams=540, fov=FOV, max_range=MAXR)
    r0 = prs.scan_poses_sectors(pmap, p, agent_chunk=0, **kw)
    r1 = prs.scan_poses_sectors(pmap, p, agent_chunk=5, **kw)
    assert r0.shape == (3, 4, 540)
    assert torch.equal(r0, r1)


def test_cpu_tensors_take_the_plain_sweep(blobby_bigk):
    """sector_sweep routes CPU tensors to sweep_plain: same values, and the
    kernel's launch counter does not move."""
    jmap, pmap, poses = blobby_bigk
    ids, x0, y0, rays, _ = _jax_rows(jmap, poses, 540)
    args = (pmap.table, pmap.meta, _t(ids), _t(x0), _t(y0), *map(_t, rays))
    before = prs.sector_sweep.launches
    bv, bh = prs.sector_sweep(*args)
    bv2, bh2 = prs.sweep_plain(*args)
    assert torch.equal(bv, bv2) and torch.equal(bh, bh2)
    prs.scan_poses_sectors(pmap, _t(poses), num_beams=540, fov=FOV,
                           max_range=MAXR)
    assert prs.sector_sweep.launches == before == 0


def test_sweep_rejects_other_devices(blobby_bigk):
    _, pmap, _ = blobby_bigk
    meta_dev = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="device"):
        prs.sector_sweep(meta_dev(4, 4, 16), meta_dev(4, 3),
                         meta_dev(2), meta_dev(2), meta_dev(2),
                         *(meta_dev(2, BB) for _ in range(4)))


@pytest.mark.parametrize("mode, ok", [
    ("auto", True), ("dense", True), ("sorted_plf@128", True),
    ("sorted_plfm@16", True), ("sorted_pl@128", True), ("sorted", False),
    ("sorted_pt", False)])
def test_modes(blobby_bigk, mode, ok):
    """'auto', 'dense', 'sorted_pl' and 'sorted_plf*' all run the list
    kernel's routes with the same values, as does use_pallas=True; the
    XLA-only sorted modes are not ported."""
    _, pmap, poses = blobby_bigk
    kw = dict(num_beams=540, fov=FOV, max_range=MAXR)
    ref = prs.scan_poses_sectors(pmap, _t(poses), **kw)
    if ok:
        r = prs.scan_poses_sectors(pmap, _t(poses), mode=mode, **kw)
        assert torch.equal(r, ref)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            prs.scan_poses_sectors(pmap, _t(poses), mode=mode, **kw)
    r = prs.scan_poses_sectors(pmap, _t(poses), use_pallas=True, mode=mode,
                               **kw)
    assert torch.equal(r, ref)
    assert all(w.launches == 0 for w in sweeps.LIST_ROUTES)


def test_sorted_pl_route_matches_pallas_kernel(blobby_bigk):
    """The sorted_pl route (list_sweep_plain on CPU) ==
    sweep_sorted_tiles_pallas (interpret mode), TPU kernel 2.2."""
    jmap, pmap, poses = blobby_bigk
    ids, x0, y0, (ct, st, ic, is_), _ = _jax_rows(jmap, poses, 540)
    bv_ref, bh_ref = sweep_sorted_tiles_pallas(
        jmap.table, jmap.meta, jmap.kv_sec, jnp.asarray(ids),
        jnp.asarray(x0), jnp.asarray(y0),
        *map(jnp.asarray, (ct, st, ic, is_)), chunk=8, tile_rows=16,
        interpret=True)
    bv, bh = sweeps.sorted_tiles_sweep(pmap.table, pmap.meta, _t(ids),
                                       _t(x0), _t(y0), _t(ct), _t(st),
                                       _t(ic), _t(is_))
    _assert_same_result(bv_ref, bh_ref, bv, bh)


def test_grp_route_matches_pallas_kernel(blobby_bigk):
    """The use_pallas route == _raycast_pallas_ids_grp_raw (interpret
    mode), TPU kernel 2.3; it takes per-beam origins, the port per-row
    ones (equal here, as on every sector path)."""
    jmap, pmap, poses = blobby_bigk
    ids, x0, y0, (ct, st, ic, is_), _ = _jax_rows(jmap, poses, 540)
    xb = np.repeat(x0[:, None], BB, 1)
    yb = np.repeat(y0[:, None], BB, 1)
    bv_ref, bh_ref = _raycast_pallas_ids_grp_raw(
        jnp.asarray(ids), jmap.meta, jmap.table,
        *map(jnp.asarray, (xb, yb, ct, st, ic, is_)), grp=4,
        interpret=True)
    bv, bh = sweeps.grp_sweep(pmap.table, pmap.meta, _t(ids), _t(x0),
                              _t(y0), _t(ct), _t(st), _t(ic), _t(is_))
    _assert_same_result(bv_ref, bh_ref, bv, bh)


def test_block_width_matches_jax(blobby_bigk):
    jmap, pmap, _ = blobby_bigk
    for nb in (540, 1080):
        assert prs.sector_block_width(pmap, nb, FOV) == \
            jrs.sector_block_width(jmap, nb, FOV)
    with pytest.raises(ValueError, match="block_half"):
        prs.sector_block_width(pmap, 64, FOV, bb=64)


def test_build_command_flags():
    """Hopper target, no FMA contraction, no fast math, for every kernel's
    source (the sweeps', the general sweep's, the EDF march's, which
    holds the march, its gradient, their persistent grid's query and the
    implicit march's pose VJP, and the chamfer stencil's, which holds the
    stencil and its gradient), each entry point a C function of its
    source."""
    assert set(_kernels._SIGNATURES) == {"sector_sweep", "dense_sweep",
                                         "edf_march", "edf_march_grad",
                                         "edf_march_wave",
                                         "implicit_pose_vjp",
                                         "general_sweep", "soft_edt",
                                         "soft_edt_grad"}
    for name, (source, symbol, _) in _kernels._SIGNATURES.items():
        cmd = _kernels.build_command(source, Path("out.so"))
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-fmad=false" in cmd
        assert not any("fast" in c for c in cmd)
        assert cmd[-1].endswith(f"csrc/{source}.cu")
        assert Path(cmd[-1]).exists()
        assert _kernels.library_path(source).parent == _kernels.BUILD_DIR
        assert f'extern "C" int {symbol}(' in Path(cmd[-1]).read_text()
    assert {s for s, _, _ in _kernels._SIGNATURES.values()} == {
        "sector_sweep", "dense_sweep", "edf_march", "general_sweep",
        "soft_edt"}


def test_port_imports_no_jax():
    code = ("import sys, pyracecarsimulator_tpu_torch; "
            "assert 'jax' not in sys.modules, 'jax'; "
            "assert 'pyracecarsimulator_tpu' not in sys.modules, 'pkg'")
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# -- ScanParams.use_theta_table on the "sectors" backend ------------------
# (tests/test_torch_scan_modes.py states the tolerances)

def test_theta_table_quantizes_directions(small_track):
    import test_torch_scan_modes as checks
    checks.check_one_bucket(small_track, "sectors")


def test_theta_table_matches_oracle_buckets(small_track):
    import test_torch_scan_modes as checks
    checks.check_oracle_buckets(small_track, "sectors")


def test_theta_table_scan_matches_jax(small_track):
    import test_torch_scan_modes as checks
    checks.check_against_jax(small_track, "sectors")
