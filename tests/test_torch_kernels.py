"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU, a CUDA build of PyTorch and nvcc; without
a card they skip (the check happens in a fixture, so every worker collects
the same tests). On a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

Tolerance: none. The kernels are compiled without FMA contraction or fast
math and must equal their plain versions (``list_sweep_plain``,
``dense_sweep_plain``, ``raycast_general.general_sweep_plain``, and for
``csrc/edf_march.cu`` the plain loop ``raymarch_xla.march_rays_plain`` and
the implicit forward ``raymarch_diff._fwd_plain``; for its pose VJP the
per-ray terms of ``raymarch_diff._pose_terms``, whose sums over the beams
are held within 1e-5 x the sum of the agent's |terms|: the kernel sums
in another order than ``torch.sum``) bit for bit on the same inputs. ``csrc/soft_edt.cu`` (the chamfer stencil of ``ops/soft_edt.py``
and its gradient): hard min bit for bit against ``chamfer_stencil_plain``
and ``chamfer_stencil_grad_plain``; softmin within 1e-5 x max(1, the
largest |plain|) (the kernel sums the 9 exponentials in the candidates'
order, torch's reduction in its own); the gradient against autograd
through the plain loop within the same in hard mode (autograd's
replicate-pad backward adds an edge cell's terms with atomics, in no fixed
order), within 1e-4 x max(1, the largest |plain|) in softmin mode
(autograd runs its own forward, whose fields differ by ulps, and each
weight exp(y_i - L) turns the rounding of |L|, up to (iters + 1) / T
cells, into a relative error of the weight).
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
from pyracecarsimulator_tpu_torch.ops.common import (_ray_invs, fan_cos_sin,
                                                     tile_ids)
from torch_cull_cases import BUILT_CASES, built_case, row_args

pytestmark = pytest.mark.cuda

FOV = 4.712388980384690
# dense_sweep_kernel's registers in nvcc's report (sm_90a), as before it
# counted its work
DENSE_REGISTERS = 40


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
        ns=ns, real_hw=(192, 192), device="cpu")


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
    before = sweeps.list_sweep.launches
    bv, bh = sweeps.list_sweep(*args)
    torch.cuda.synchronize()
    assert sweeps.list_sweep.launches == before + 1
    bv_p, bh_p = sweeps.list_sweep_plain(*args)
    assert torch.equal(bv, bv_p) and torch.equal(bh, bh_p)
    assert bool((torch.minimum(bv, bh) < 10.0).float().mean() > 0.5)


def _sector_args(cuda, poses_n=300, num_beams=1080):
    """The list sweep's arguments for the corridor's sector scan of
    ``poses_n`` free poses."""
    track, smap = _corridor(16, 2.0)
    rng = np.random.RandomState(2)
    edf = track.edf.numpy()[:192, :192]
    ys, xs = np.where(edf > 0.2)
    k = rng.randint(len(ys), size=poses_n)
    p = torch.tensor(np.stack([-4.8 + (xs[k] + .5) * .05,
                               -4.8 + (ys[k] + .5) * .05,
                               rng.uniform(-np.pi, np.pi, poses_n)], -1),
                     dtype=torch.float32, device=cuda)
    smap = smap.to(cuda)
    bb = rs.sector_block_width(smap, num_beams, FOV)
    ct, st = fan_cos_sin(p[:, 2], rs._padded_offsets(num_beams, FOV, bb,
                                                     cuda))
    ids = rs._list_ids(smap.tiles_shape, smap.tile_size, smap.tile_origin,
                       smap.ns, p[:, 0], p[:, 1], ct, st, bb)
    ic, is_ = _ray_invs(ct, st)
    g = ids.numel()
    nblk = g // poses_n
    return (smap.table, smap.meta, ids.reshape(g).contiguous(),
            p[:, 0].repeat_interleave(nblk).contiguous(),
            p[:, 1].repeat_interleave(nblk).contiguous(),
            *(v.reshape(g, bb).contiguous() for v in (ct, st, ic, is_)))


_MAP_TABLES = {}


def _map_table_args(cuda, table):
    """The list sweep's arguments on a bundled map's table: berlin's 4 m
    tiles or sector lists, levine's sector lists; 512 free poses (seed 0)
    and the padded fan of each route's rows. Made once a process."""
    if table not in _MAP_TABLES:
        import pyracecarsimulator_tpu_torch as P
        from pyracecarsimulator_tpu_torch.maps import sample_free_poses
        from pyracecarsimulator_tpu_torch.ops.common import (_padded_offsets,
                                                             tile_ids)
        name, kind = table.split("_")
        bundle = P.build_sim(name, backend="sectors" if kind == "sectors"
                             else "segments", device=cuda)
        p = torch.as_tensor(sample_free_poses(
            bundle.track, 512, np.random.RandomState(0)), device=cuda)
        m = bundle.segmap
        bb = (rs.sector_block_width(m, 1080, FOV) if kind == "sectors"
              else 128)
        ct, st = fan_cos_sin(p[:, 2], _padded_offsets(1080, FOV, bb, cuda))
        g_rows = ct.shape[1] // bb
        if kind == "sectors":
            table_, meta = m.table, m.meta
            ids = rs._list_ids(m.tiles_shape, m.tile_size, m.tile_origin,
                               m.ns, p[:, 0], p[:, 1], ct, st, bb)
        else:
            table_, meta = m.tiles, m.tile_sweep_meta
            ids = tile_ids(m.tiles_shape, m.tile_size, m.tile_origin,
                           p[:, 0], p[:, 1])[:, None].expand(-1, g_rows)
        ic, is_ = _ray_invs(ct, st)
        g = ids.numel()
        _MAP_TABLES[table] = (
            table_, meta, ids.reshape(g).to(torch.int32).contiguous(),
            p[:, 0].repeat_interleave(g_rows).contiguous(),
            p[:, 1].repeat_interleave(g_rows).contiguous(),
            *(v.reshape(g, bb).contiguous() for v in (ct, st, ic, is_)))
    return _MAP_TABLES[table]


@pytest.mark.parametrize("table", ["corridor", "berlin_tiles",
                                   "berlin_sectors", "levine_sectors"])
def test_list_sweep_counts_rows_and_slots_on_the_device(cuda, table):
    """The list kernel adds its rows, their real slots and the slots its
    wedge cull keeps to the device's counter: on the same
    inputs exactly what the plain version adds on the host; one replay of
    a CUDA graph of the sweep advances it by exactly one call's count; the
    outputs, eager and replayed, are the plain version's (which sweeps
    every real slot) bit for bit. On berlin's tables the cull keeps under
    two fifths of the slots."""
    wrapper = sweeps.list_sweep
    counts = sweeps.SWEEP_COUNTS
    args = (_sector_args(cuda) if table == "corridor"
            else _map_table_args(cuda, table))
    wrapper(*args)              # the counter exists before any capture
    torch.cuda.synchronize()
    start, host = dict(counts), dict(counts.host)
    bv, bh = wrapper(*args)
    dev = {k: counts[k] - start[k] for k in start}
    bv_p, bh_p = sweeps.list_sweep_plain(*args)
    plain = {k: counts.host[k] - host[k] for k in host}
    assert plain["rows"] == args[2].numel() and plain["slots"] > 0
    assert 0 < plain["kept"] <= plain["slots"]
    if table.startswith("berlin"):
        assert plain["kept"] < 0.4 * plain["slots"]
    assert dev == plain
    assert torch.equal(bv, bv_p) and torch.equal(bh, bh_p)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = wrapper(*args)
    before = dict(counts)
    graph.replay()
    torch.cuda.synchronize()
    assert {k: counts[k] - before[k] for k in before} == plain
    assert torch.equal(out[0], bv_p) and torch.equal(out[1], bh_p)


@pytest.mark.parametrize("name", BUILT_CASES)
def test_list_sweep_cull_at_its_edges(cuda, name):
    """The built rows of ``tests/torch_cull_cases.py`` (an endpoint on an
    edge ray, a segment through the origin, rows the cull cannot bound,
    one beam, axis-aligned beams, padding beams, a ragged warp, a short
    list) through the kernel: the plain version's minima bit for bit and
    its kept slots."""
    table, meta, (x0, y0, ct, st), _ = built_case(name)
    args = row_args(torch.tensor(table, device=cuda),
                    torch.tensor(meta, device=cuda),
                    torch.zeros(1, dtype=torch.int32, device=cuda),
                    *(v.to(cuda) for v in (x0, y0, ct, st)))
    counts = sweeps.SWEEP_COUNTS
    sweeps.list_sweep(*args)
    torch.cuda.synchronize()
    start, host = dict(counts), dict(counts.host)
    bv, bh = sweeps.list_sweep(*args)
    dev = {k: counts[k] - start[k] for k in start}
    bv_p, bh_p = sweeps.list_sweep_plain(*args)
    assert dev == {k: counts.host[k] - host[k] for k in host}
    assert torch.equal(bv, bv_p) and torch.equal(bh, bh_p)


_BERLIN = {}


def _berlin_case(cuda, kind):
    """Berlin's sector map or its 4 m tiles on the card, and 4096 seeded
    free poses, the first moved outside the map's extent. Made once a
    process."""
    if kind not in _BERLIN:
        import pyracecarsimulator_tpu_torch as P
        from pyracecarsimulator_tpu_torch.maps import sample_free_poses
        bundle = P.build_sim("berlin", backend=kind, device=cuda)
        p = torch.as_tensor(sample_free_poses(
            bundle.track, 4096, np.random.RandomState(5)), device=cuda)
        p[0, 0] = bundle.segmap.extent[1] + 1.0
        _BERLIN[kind] = (bundle.segmap, p)
    return _BERLIN[kind]


@pytest.mark.parametrize("kind", ["sectors", "segments"])
def test_list_scan_equals_the_rays_given_path_on_berlin(cuda, kind):
    """The scan of 4096 poses x 1080 beams on berlin's sector lists and
    tiles on the list kernel's entry from poses (one ``list_scan``
    launch) against the same scan with the poses taking a gradient (the
    rays-given kernel and the glue around it, one ``list_sweep`` launch):
    0 mismatches, the same rows, real and kept slots on the device
    counter, every row of the first and none of the second counted as
    fanned; replayed from a CUDA graph, the same ranges and counts."""
    m, p = _berlin_case(cuda, kind)
    scan = (rs.scan_poses_sectors if kind == "sectors"
            else rseg.scan_poses_segments)
    counts = sweeps.SWEEP_COUNTS

    def counted(fn):
        torch.cuda.synchronize()
        c0, n0 = dict(counts), sweeps.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: counts[k] - c0[k] for k in c0}, {
            k: n - n0[k] for k, n in sweeps.launch_counts().items()
            if n != n0[k]}

    scan(m, p)                  # the counter and constants, before capture
    fused, c_f, n_f = counted(lambda: scan(m, p))
    q = p.clone().requires_grad_(True)
    given, c_g, n_g = counted(lambda: scan(m, q).detach())
    assert n_f == {"list_scan": 1} and n_g == {"list_sweep": 1}
    assert int((fused != given).sum()) == 0 and torch.equal(fused, given)
    assert bool((fused[0] == 10.0).all())
    assert c_f["fanned"] == c_f["rows"] > 0 and c_g["fanned"] == 0
    assert {k: c_f[k] for k in ("rows", "slots", "kept")} == {
        k: c_g[k] for k in ("rows", "slots", "kept")}
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = scan(m, p)
    replayed, c_r, _ = counted(graph.replay)
    assert torch.equal(out, fused) and c_r == c_f


def test_list_scan_on_an_odd_fan_at_heading_zero(cuda):
    """An odd beam count's middle offset is exactly 0: at heading 0 its
    sine is 0 and its reciprocal NaN. The entry from poses on the card
    equals the scan with the poses taking a gradient (the rays-given
    kernel) bit for bit, and, given the same factors (the card's cos and
    sin differ from the CPU's by an ulp on some inputs), the plain
    composition on the CPU; with padding beams too (541 beams in rows of
    64)."""
    from pyracecarsimulator_tpu_torch.ops.common import offset_factors
    _, smap = _corridor(16, 2.0)
    rng = np.random.RandomState(6)
    poses = torch.tensor(np.stack([rng.uniform(-4, 4, 48),
                                   rng.uniform(-4, 4, 48),
                                   rng.uniform(-np.pi, np.pi, 48)], -1),
                         dtype=torch.float32, device=cuda)
    poses[:8, 2] = 0.0
    poses[8, 0] = 50.0                          # outside the extent
    smap = smap.to(cuda)
    for num_beams in (541, 1080):
        fused = rs.scan_poses_sectors(smap, poses, num_beams)
        q = poses.clone().requires_grad_(True)
        assert torch.equal(fused, rs.scan_poses_sectors(smap, q, num_beams))
        bb = rs.sector_block_width(smap, num_beams, FOV)
        cd, sd = offset_factors(num_beams, FOV, bb, cuda)
        x0, y0 = poses[:, 0].contiguous(), poses[:, 1].contiguous()
        cth, sth = torch.cos(poses[:, 2]), torch.sin(poses[:, 2])
        ids = rs._list_ids(smap.tiles_shape, smap.tile_size, smap.tile_origin,
                           smap.ns, x0, y0, *rs.rotate_fan(cth, sth, cd, sd),
                           bb)
        args = (smap.table, smap.meta, ids, x0, y0, cth, sth, cd, sd, 10.0,
                smap.extent, num_beams)
        assert torch.equal(sweeps.list_scan(*args), fused)
        plain = sweeps.list_scan_plain(*(a.cpu() if torch.is_tensor(a)
                                         else a for a in args))
        assert torch.equal(fused.cpu(), plain)


def _nvcc_resources(source, tmp_path):
    """``{mangled kernel name: (registers, spill store bytes, stack frame
    bytes)}`` from nvcc's resource report of a fresh build of
    ``csrc/<source>.cu``."""
    import re
    import subprocess
    from pyracecarsimulator_tpu_torch.ops import _kernels
    done = subprocess.run(_kernels.build_command(
        source, tmp_path / f"{source}.so", _kernels.nvcc_path()),
        capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr
    res = {}
    for chunk in re.split(r"Function (?:properties for )?",
                          done.stdout + done.stderr)[1:]:
        reg = (re.search(r"REG:(\d+)", chunk)
               or re.search(r"Used (\d+) registers", chunk))
        if reg:
            spill = re.search(r"(\d+) bytes spill stores", chunk)
            stack = (re.search(r"STACK:(\d+)", chunk)
                     or re.search(r"(\d+) bytes stack frame", chunk))
            res[chunk.split()[0].rstrip(":")] = (
                int(reg.group(1)), int(spill.group(1)) if spill else 0,
                int(stack.group(1)) if stack else 0)
    return res


def test_list_kernel_entries_keep_their_registers(cuda, tmp_path):
    """nvcc's resource report of ``csrc/sector_sweep.cu``: both entries
    of ``list_sweep_kernel`` (rays given, from poses), neither spilling
    nor with a stack frame, the rays-given one at 32 registers."""
    import re
    res = {m.group(1): r for name, r in
           _nvcc_resources("sector_sweep", tmp_path).items()
           for m in [re.search(r"list_sweep_kernelILb([01])E", name)] if m}
    assert set(res) == {"0", "1"}, res
    assert res["0"][0] == 32, res
    assert all(r[1] == 0 and r[2] == 0 for r in res.values()), res


def test_a_work_counter_is_never_made_inside_a_capture(cuda):
    """A kernel's device counter made inside a CUDA graph's capture would
    be the graph's memory, zeroed at each replay: ``counter`` refuses to
    make one there; one made before is handed out as it is."""
    from pyracecarsimulator_tpu_torch.ops import _kernels
    fresh, made = _kernels.DeviceCounts(("a",)), _kernels.DeviceCounts(("a",))
    c = made.counter(cuda)
    with pytest.raises(RuntimeError, match="before capturing"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            assert made.counter(cuda) is c
            fresh.counter(cuda)
    assert not fresh.device


def test_scan_on_card_matches_cpu_scan(cuda):
    """The whole scan: kernel on the card vs plain on the CPU, same fan."""
    _, smap = _corridor(16, 2.0)
    rng = np.random.RandomState(1)
    poses = torch.tensor(np.stack([rng.uniform(-4, 4, 64),
                                   rng.uniform(-4, 4, 64),
                                   rng.uniform(-np.pi, np.pi, 64)], -1),
                         dtype=torch.float32)
    bb = rs.sector_block_width(smap, 1080, FOV)
    ct, st = fan_cos_sin(poses[:, 2], rs._padded_offsets(1080, FOV, bb,
                                                         "cpu"))
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
        sweeps.list_sweep(smap.table, smap.meta, ok["ids"].long(), ok["x0"],
                          ok["y0"], *rays)
    with pytest.raises(ValueError, match="contiguous"):
        sweeps.list_sweep(smap.table, smap.meta, ok["ids"], ok["x0"],
                          ok["y0"], torch.ones(bb, g, device=cuda).t(),
                          *rays[1:])
    with pytest.raises(ValueError, match="shared memory"):
        sweeps.list_sweep(torch.zeros(2, 4, 8192, device=cuda),
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


def _levine_dense_args(cuda, agents):
    """The dense route's flat rays on levine's untiled map: ``agents``
    free poses x 1080 beams over the full set."""
    import pyracecarsimulator_tpu_torch as P
    from pyracecarsimulator_tpu_torch.maps import sample_free_poses
    from pyracecarsimulator_tpu_torch.ops.common import beam_angles
    bundle = P.build_sim("levine", device=cuda)
    segmap = bundle.segmap
    assert segmap.tiles is None
    p = torch.as_tensor(sample_free_poses(bundle.track, agents,
                                          np.random.RandomState(4)),
                        device=cuda)
    ct, st = fan_cos_sin(p[:, 2], beam_angles(1080, FOV, cuda))
    flat = lambda v: v.reshape(-1).contiguous()
    return (segmap.params, segmap.sweep_meta,
            flat(p[:, 0:1].expand(ct.shape)),
            flat(p[:, 1:2].expand(ct.shape)),
            *map(flat, (ct, st, *_ray_invs(ct, st))))


@pytest.mark.parametrize("case", ["mixed", "split", "levine"])
def test_dense_sweep_counts_rays_and_pairs_on_the_device(cuda, case):
    """The dense kernel adds each block's rays and the pairs they test
    (v_hi + h_end - h_lo a ray) to the device's counter: on the same
    inputs exactly what the plain version adds on the host, a ragged last
    block counting its live rays only; one replay of a CUDA graph of the
    sweep advances it by exactly one call's count; the outputs, eager and
    replayed, are the plain version's bit for bit."""
    counts = sweeps.DENSE_COUNTS
    if case == "levine":
        args = _levine_dense_args(cuda, 512)
    else:
        rng = np.random.RandomState(5)
        n_v, kv, n_h, kh, n = ((41, 41, 41, 87, 3 * 256 + 17)
                               if case == "mixed"
                               else (84, 128, 128, 128, 1000))
        params, meta = _random_segments(rng, n_v, kv, n_h, kh)
        if case == "mixed":
            meta = np.array([n_v, n_v, n_v + n_h], np.int32)
        th = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
        rays = [torch.tensor(v, device=cuda) for v in (
            rng.uniform(-8, 8, n).astype(np.float32),
            rng.uniform(-8, 8, n).astype(np.float32), np.cos(th),
            np.sin(th))]
        args = (torch.tensor(params, device=cuda),
                torch.tensor(meta, device=cuda), *rays,
                *_ray_invs(*rays[2:]))
    sweeps.dense_sweep(*args)   # the counter exists before any capture
    torch.cuda.synchronize()
    start, host = dict(counts), dict(counts.host)
    bv, bh = sweeps.dense_sweep(*args)
    dev = {k: counts[k] - start[k] for k in start}
    bv_p, bh_p = sweeps.dense_sweep_plain(*args)
    plain = {k: counts.host[k] - host[k] for k in host}
    v_hi, h_lo, h_end = args[1].tolist()
    assert plain == {"rays": args[2].numel(),
                     "pairs": args[2].numel() * (v_hi + h_end - h_lo)}
    if case == "levine":
        assert plain["pairs"] == 82 * plain["rays"]
    assert dev == plain
    assert torch.equal(bv, bv_p) and torch.equal(bh, bh_p)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sweeps.dense_sweep(*args)
    before = dict(counts)
    graph.replay()
    torch.cuda.synchronize()
    assert {k: counts[k] - before[k] for k in before} == plain
    assert torch.equal(out[0], bv_p) and torch.equal(out[1], bh_p)


def test_graphed_levine_step_counts_82_pairs_a_ray(cuda):
    """``build_sim("levine")`` with no backend named sweeps every ray
    against levine's 82 segments: each replay of the graphed step adds its
    agents x beams rays and 82 pairs each to ``counters()["dense"]``."""
    import pyracecarsimulator_tpu_torch as P
    from pyracecarsimulator_tpu_torch.maps import sample_free_poses
    from pyracecarsimulator_tpu_torch.utils import profiling
    beams, agents = 256, 64
    bundle = P.build_sim("levine", scan=P.ScanParams(num_beams=beams),
                         device=cuda)
    assert bundle.backend == "segments" and bundle.segmap.tiles is None
    p = torch.as_tensor(sample_free_poses(bundle.track, agents,
                                          np.random.RandomState(3)),
                        device=cuda)
    state = P.state_from_pose(p[:, 0], p[:, 1], p[:, 2])
    act = (torch.full((agents,), 2.0, device=cuda),
           torch.zeros(agents, device=cuda))
    step = P.make_step_fn(bundle, with_noise=False, graph=True)
    step(state, act)
    torch.cuda.synchronize()
    before = profiling.counters()["dense"]
    for _ in range(3):
        step(state, act)
    after = profiling.counters()["dense"]
    assert step.graphed.replays >= 3
    assert {k: after[k] - before[k] for k in after} == {
        "rays": 3 * agents * beams, "pairs": 3 * agents * beams * 82}


def test_dense_kernel_keeps_its_registers(cuda, tmp_path):
    """nvcc's resource report of ``csrc/dense_sweep.cu``: the kernel keeps
    the registers it had before it counted its work, with no spill and no
    stack frame."""
    res = [r for name, r in _nvcc_resources("dense_sweep", tmp_path).items()
           if "dense_sweep_kernel" in name]
    assert res == [(DENSE_REGISTERS, 0, 0)], res


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
    """The tile route's rows through the list sweep's row glue on the card
    against the same on the CPU (the plain sweep), and the dense and tiled
    scans on the card against the CPU scans (same fan), values and pose
    gradients."""
    segmap = build_segment_map(_blobby(seed, n_blocks), 0.05, (-5.5, -5.5),
                               **kw, device="cpu")
    assert segmap.tiles is not None
    rng = np.random.RandomState(seed)
    poses = torch.tensor(np.stack([rng.uniform(-5, 5, 40),
                                   rng.uniform(-5, 5, 40),
                                   rng.uniform(-np.pi, np.pi, 40)], -1),
                         dtype=torch.float32)
    offs = rs._padded_offsets(1080, FOV, 128, "cpu")
    ct, st = fan_cos_sin(poses[:, 2], offs)
    dev = segmap.to(cuda)
    p_d, ct_d, st_d = poses.to(cuda), ct.to(cuda), st.to(cuda)

    def tile_minima(m, p, ct, st):
        ids = tile_ids(m.tiles_shape, m.tile_size, m.tile_origin, p[:, 0],
                       p[:, 1])[:, None].expand(-1, ct.shape[1] // 128)
        return rg._list_minima(m.tiles, m.tile_sweep_meta, ids,
                               p[:, 0:1].expand(ct.shape),
                               p[:, 1:2].expand(ct.shape), ct, st)

    mins = tile_minima(dev, p_d, ct_d, st_d)
    ref = tile_minima(segmap, poses, ct, st)
    for a, b in zip(mins, ref):
        assert torch.equal(a.cpu(), b)
    for use_tiles in (True, False):
        before = (sweeps.list_sweep.launches, sweeps.dense_sweep.launches)
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
        after = (sweeps.list_sweep.launches, sweeps.dense_sweep.launches)
        assert after == (before[0] + use_tiles, before[1] + (not use_tiles))


@pytest.mark.parametrize("mode, use_pallas", [
    ("sorted_pl", None), ("auto", True), ("auto", None), ("dense", None),
    ("sorted_plf@128", None)])
def test_sector_routes_launch_their_wrapper(cuda, mode, use_pallas):
    """Every mode and ``use_pallas`` (kernels 2.2 and 2.3 among them) run
    the one list kernel: a scan of poses without a gradient one
    ``list_scan`` launch (its entry from poses), with the sector scan's
    values."""
    _, smap = _corridor(16, 2.0)
    rng = np.random.RandomState(2)
    poses = torch.tensor(np.stack([rng.uniform(-4, 4, 32),
                                   rng.uniform(-4, 4, 32),
                                   rng.uniform(-np.pi, np.pi, 32)], -1),
                         dtype=torch.float32)
    smap, poses = smap.to(cuda), poses.to(cuda)
    ref = rs.scan_poses_sectors(smap, poses)
    before = sweeps.launch_counts()
    got = rs.scan_poses_sectors(smap, poses, mode=mode,
                                use_pallas=use_pallas)
    torch.cuda.synchronize()
    assert {k: n - before[k] for k, n in sweeps.launch_counts().items()
            if n != before[k]} == {"list_scan": 1}
    assert torch.equal(got, ref)


# -- the step and the rollout replayed as CUDA graphs ------------------------

@pytest.mark.parametrize("backend", ["segments", "sectors", "edf",
                                     "edf_implicit", "edf_bilinear",
                                     "segments_simplified"])
def test_graphed_step_and_rollout_equal_eager(cuda, backend):
    """``make_step_fn(graph=True)`` and the default rollout on the card
    against the eager step and loop, noise on from one seed: bit for bit;
    a replayed rollout of T steps adds T to its wrapper's counter."""
    import pyracecarsimulator_tpu_torch as P
    from pyracecarsimulator_tpu_torch.maps import sample_free_poses
    from pyracecarsimulator_tpu_torch.parallel import (
        make_gap_follower_policy, make_rollout_fn)
    from pyracecarsimulator_tpu_torch.state import FIELDS
    beams, steps = 256, 10
    bundle = P.build_sim("levine", backend=backend,
                         scan=P.ScanParams(num_beams=beams), device=cuda)
    p = torch.as_tensor(sample_free_poses(bundle.track, 64,
                                          np.random.RandomState(0)),
                        device=cuda)
    state = P.state_from_pose(p[:, 0], p[:, 1], p[:, 2])
    act = (torch.full((64,), 2.0, device=cuda), torch.zeros(64, device=cuda))
    same = lambda a, b: all(torch.equal(getattr(a, f), getattr(b, f))
                            for f in FIELDS)
    seeded = lambda: torch.Generator(device=cuda).manual_seed(2)
    eager = P.make_step_fn(bundle, with_noise=True)
    graphed = P.make_step_fn(bundle, with_noise=True, graph=True)
    ge, gg = seeded(), seeded()
    se = sg = state
    for _ in range(3):
        oe, og = eager(se, act, ge), graphed(sg, act, gg)
        assert torch.equal(oe.ranges, og.ranges)
        assert torch.equal(oe.collision, og.collision)
        assert same(oe.state, og.state)
        se, sg = oe.state, og.state
    assert graphed.graphed.captures == 1
    policy = make_gap_follower_policy(beams, FOV)
    run = make_rollout_fn(eager, policy, steps, beams, keep_scans=True)
    run_eager = make_rollout_fn(eager, policy, steps, beams, keep_scans=True,
                                graph=False)
    ge, gg = seeded(), seeded()
    for call in range(2):
        before = sweeps.launch_counts()
        fg, tg = run(state, gg)
        grown = [n - before[k] for k, n in sweeps.launch_counts().items()
                 if n != before[k]]
        # the first call warms up its two graphs with 2 steps each
        assert grown == [steps + (4 if call == 0 else 0)]
        fe, te = run_eager(state, ge)
        assert all(torch.equal(te[k], tg[k]) for k in te) and same(fe, fg)


def test_graphed_rollout_policy_that_depends_on_t(cuda):
    """After step 0 the policy's ``t`` is the device-side step index: an
    open-loop ``steer_seq[t]`` equals the eager loop bit for bit, also at
    a second call; a Python branch on ``t`` fails the capture and the
    error names ``graph=False``; the one-shot ``rollout`` keeps its
    capture for the next call; a host-counting Adam under ``graph=None``
    trains eagerly."""
    import pyracecarsimulator_tpu_torch as P
    from pyracecarsimulator_tpu_torch.maps import sample_free_poses
    from pyracecarsimulator_tpu_torch.parallel import (make_bptt_train_fn,
                                                       make_rollout_fn,
                                                       rollout)
    beams, steps, n = 128, 9, 32
    bundle = P.build_sim("levine", backend="sectors",
                         scan=P.ScanParams(num_beams=beams), device=cuda)
    p = torch.as_tensor(sample_free_poses(bundle.track, n,
                                          np.random.RandomState(0)),
                        device=cuda)
    state = P.state_from_pose(p[:, 0], p[:, 1], p[:, 2])
    step = P.make_step_fn(bundle, with_noise=False)
    seq = torch.linspace(-0.4, 0.4, steps, device=cuda)
    v = torch.full((n,), 2.0, device=cuda)
    open_loop = lambda s, r, t: (v, seq[t].expand(n))
    fe, te = make_rollout_fn(step, open_loop, steps, beams, graph=False)(state)
    run = make_rollout_fn(step, open_loop, steps, beams, graph=True)
    for _ in range(2):
        fg, tg = run(state)
        assert torch.equal(te["pose"], tg["pose"])
        assert torch.equal(fe.steer_angle, fg.steer_angle)
    # a loop that replayed step 1's command for ever would show here
    _, stale = make_rollout_fn(
        step, lambda s, r, t: open_loop(s, r, min(t, 1)), steps, beams,
        graph=False)(state)
    assert not torch.equal(stale["pose"], te["pose"])

    branching = lambda s, r, t: (v, seq[0 if t < 3 else 1].expand(n))
    # caught in the warm-up, by PyTorch's synchronisation check, before a
    # capture is begun; the check is put back to what it was
    with pytest.raises(RuntimeError,
                       match="(?s)t >= 1.*synchroniz.*graph=False"):
        make_rollout_fn(step, branching, steps, beams)(state)
    assert torch.cuda.get_sync_debug_mode() == 0

    # the failed call's traceback is a dead cycle that owns its step-0
    # graph. Were it collected in the middle of a later capture, the
    # graph's pool would be freed there and that capture invalidated:
    # the collector is off while a stream captures, and on again after.
    import gc
    seen = []

    def collecting(ps, s, r, t):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return v, torch.tanh(r @ ps["w"])

    smooth = bundle._replace(sim=P.SimParams(steer_mode="smooth"))
    train, init = make_bptt_train_fn(
        P.make_step_fn(smooth, with_noise=False), collecting,
        lambda out, t: out.ranges.mean(), 2, beams,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-3, capturable=True))
    params = {"w": torch.zeros(beams, device=cuda)}
    opt = init(params)
    for _ in range(2):
        params, opt, loss, _ = train(params, opt, state)
    assert train.graphed.captures == 1 and bool(torch.isfinite(loss))
    assert seen == [False, False] and gc.isenabled()

    first = rollout(step, state, open_loop, steps, beams)
    before = sweeps.launch_counts()
    again = rollout(step, state, open_loop, steps, beams)
    grown = [k - before[name] for name, k in sweeps.launch_counts().items()
             if k != before[name]]
    assert grown == [steps]                     # no warm-up step: a replay
    assert torch.equal(first[1]["pose"], again[1]["pose"])

    train, init = make_bptt_train_fn(
        P.make_step_fn(smooth, with_noise=False),
        lambda ps, s, r, t: (v, torch.tanh(r @ ps["w"])),
        lambda out, t: out.ranges.mean(), 2, beams,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-3))
    params = {"w": torch.zeros(beams, device=cuda)}
    opt = init(params)
    for _ in range(2):
        params, opt, loss, _ = train(params, opt, state)
    assert train.graphed.captures == 0 and bool(torch.isfinite(loss))


# -- the EDF march ------------------------------------------------------------

def _edge_case(rng, nan):
    """(edf (64, 2200) at 5 mm, origin, bounds, rays (4 x (n,))): a field
    of 5 mm (one cell a step) with a wall from column 2100, and 300,001
    rays (not a multiple of 32, and more than one persistent wave takes,
    so that warps refill from the cursor): first one ray from every
    column along the middle row, nearly along +x, so that the steps
    before the wall or the 10 m range run through every count from 1 to
    about 2000 (a ray of exactly ``GRAD_SLOTS`` and ``GRAD_SLOTS + 1``
    steps among them, and rays of more than (GRAD_SLOTS / 2) ** 2 steps,
    whose segments are marched again in parts); then origins at
    |gx| > 2 ** 31 cells, and
    with ``nan`` NaN ones (the plain bilinear march gathers at a NaN
    position's taps: it has no value there); then random rays anywhere in
    and around the map."""
    edf = np.full((64, 2200), 0.005, np.float32)
    edf[:, 2100:] = 0.0
    n, k = 300_001, 2100
    x = rng.uniform(-0.1, 11.1, n).astype(np.float32)
    y = rng.uniform(-0.05, 0.37, n).astype(np.float32)
    th = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    x[:k] = (np.arange(k) + 0.5) * 0.005
    y[:k] = 0.1625
    th[:k] = rng.uniform(-0.002, 0.002, k)
    x[k:k + 6] = [3e7, -3e7, np.nan if nan else 4e9, 0.5,
                  np.nan if nan else -4e9, np.inf]
    y[k:k + 6] = [0.15, 0.15, 0.15, np.nan if nan else 3e7,
                  np.nan if nan else -3e7, 0.15]
    th[k:k + 6] = 0.0
    return edf, (0.0, 0.0), (64, 2200), (x, y, np.cos(th), np.sin(th))


def _march_case(cuda, case, nan=True):
    """(edf, inv_res, ox, oy, rays (4 x (A, B)), bounds) on the card:
    "random", the corridor map with origins anywhere in and around it
    (some start outside the map, some in a wall) and random directions;
    "levine", the bundled map's fan of 1080 beams from 48 free poses, 8
    poses outside the map and 8 in walls; "edges", ``_edge_case`` (NaN
    origins with ``nan``)."""
    from pyracecarsimulator_tpu_torch.maps import (load_builtin,
                                                   sample_free_poses)
    from pyracecarsimulator_tpu_torch.ops.common import rays_from_poses
    rng = np.random.RandomState(5)
    if case == "edges":
        edf, org, hw, rays = _edge_case(rng, nan)
        org = torch.tensor(org, device=cuda)
        return (torch.tensor(edf, device=cuda), 200.0, org[0], org[1],
                [torch.tensor(v, device=cuda) for v in rays], hw)
    if case == "random":
        track, _ = _corridor(16, 2.0)
        n = 3000
        x = rng.uniform(-6.0, 6.0, (n, 1)).astype(np.float32)
        y = rng.uniform(-6.0, 6.0, (n, 1)).astype(np.float32)
        th = rng.uniform(-np.pi, np.pi, (n, 1)).astype(np.float32)
        rays = [torch.tensor(v, device=cuda) for v in
                (x, y, np.cos(th), np.sin(th))]
    else:
        track = load_builtin("levine", device="cpu")
        poses = sample_free_poses(track, 64, np.random.RandomState(0))
        poses[48:56, 0] += 1000.0                       # outside the map
        occ = track.occupancy.numpy()[: track.height, : track.width]
        iy, ix = np.nonzero(occ > 0.5)
        k = rng.randint(len(iy), size=8)
        poses[56:, 0] = track.origin_x + (ix[k] + 0.5) * track.resolution
        poses[56:, 1] = track.origin_y + (iy[k] + 0.5) * track.resolution
        _, _, *rays = rays_from_poses(torch.tensor(poses, device=cuda), 1080,
                                      FOV)
    org = torch.tensor([track.origin_x, track.origin_y], device=cuda)
    return (track.edf.to(cuda), 1.0 / track.resolution, org[0], org[1],
            rays, (track.height, track.width))


@pytest.mark.parametrize("case", ["random", "levine", "edges"])
@pytest.mark.parametrize("variant", ["nearest", "bilinear", "implicit"])
def test_edf_march_matches_plain(cuda, variant, case):
    """Each variant against its plain version on the same tensors, bit for
    bit: ranges, and for the implicit variant the hit flags (against the
    march and ``_refine``, with the host scalars of a 5 cm map, and with
    "edges"'s 5 mm); with 200 trips (2048, ``MAX_GRAD_TRIPS``, on
    "edges") and with 3, which cuts rays off; each ray's trips within the
    count; one launch a march. (NaN origins only for "nearest": the plain
    bilinear versions gather at a NaN position's taps, which has no
    value.)"""
    from pyracecarsimulator_tpu_torch.ops import raymarch_diff as rd
    from pyracecarsimulator_tpu_torch.ops import raymarch_xla as rx
    edf, inv, ox, oy, rays, hw = _march_case(cuda, case,
                                             nan=variant == "nearest")
    res = 0.005 if case == "edges" else 0.05
    refine = (rd._surface_level(1e-4, res), 0.4 * res, rd._DENOM_FLOOR)
    for max_iters in ((rx.MAX_GRAD_TRIPS, 3) if case == "edges"
                      else (200, 3)):
        tail = (10.0, 1e-4, max_iters)
        trips = torch.zeros(rays[0].shape, dtype=torch.int32, device=cuda)
        before = rx.edf_march.launches
        kw = dict(refine=refine) if variant == "implicit" else {}
        got = rx.edf_march(edf, inv, ox, oy, *rays, *tail, hw, variant,
                           ray_trips=trips, **kw)
        torch.cuda.synchronize()
        assert rx.edf_march.launches == before + 1
        if variant == "implicit":
            ref = rd._fwd_plain(edf, inv, ox, oy, *rays, *tail, hw, refine)
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
            assert got[1].dtype == torch.bool and bool(got[1].any())
            ranges = got[0]
        else:
            ref = rx.march_rays_plain(edf, inv, ox, oy, *rays, *tail,
                                      variant, hw)
            assert torch.equal(got, ref)
            ranges = got
        assert 1 <= int(trips.min()) and int(trips.max()) <= max_iters
        assert bool((ranges < 10.0).any()) and bool((ranges >= 10.0).any())
        if case == "edges" and max_iters > 3:
            # rays of exactly GRAD_SLOTS and GRAD_SLOTS + 1 steps (a hit
            # takes one trip more than its steps), and far longer ones
            hits = set(trips[:2100].tolist())
            assert {rx.GRAD_SLOTS + 1, rx.GRAD_SLOTS + 2} <= hits
            assert max(hits) > (rx.GRAD_SLOTS // 2) ** 2 + 1


@pytest.mark.parametrize("beams", [1080, 37])
def test_implicit_pose_vjp_matches_plain(cuda, beams):
    """``implicit_pose_vjp`` (the implicit march's VJP in the poses) against
    ``_pose_terms`` and ``implicit_pose_vjp_plain`` on levine: 48 free
    poses, 8 outside the map and 8 in walls, read through a strided view
    (a column slice of a wider tensor), a cotangent that is an expanded
    view: each ray's terms bit for bit, the sums within 1e-5 x the sum of
    the agent's |terms| (another order of the sum), the same bits again
    and from a CUDA graph's replay; one launch a call; no agents, no
    launch."""
    from pyracecarsimulator_tpu_torch.maps import (load_builtin,
                                                   sample_free_poses)
    from pyracecarsimulator_tpu_torch.ops import raymarch_diff as rd
    from pyracecarsimulator_tpu_torch.ops.common import (
        beam_angles, fan_factors, rotate_fan)
    track = load_builtin("levine", device=cuda)
    rng = np.random.RandomState(5)
    poses = sample_free_poses(track, 64, np.random.RandomState(0))
    poses[48:56, 0] += 1000.0                       # outside the map
    occ = track.occupancy.cpu().numpy()[: track.height, : track.width]
    iy, ix = np.nonzero(occ > 0.5)
    k = rng.randint(len(iy), size=8)
    poses[56:, 0] = track.origin_x + (ix[k] + 0.5) * track.resolution
    poses[56:, 1] = track.origin_y + (iy[k] + 0.5) * track.resolution
    wide = torch.zeros((64, 5), device=cuda)
    wide[:, 1:4] = torch.tensor(poses, device=cuda)
    p = wide[:, 1:4]
    org = torch.tensor([track.origin_x, track.origin_y], device=cuda)
    ox, oy = org[0], org[1]
    hw = (track.height, track.width)
    fan = fan_factors(p[:, 2], beam_angles(beams, FOV, cuda))
    r, hit = rd._fwd_impl(track.edf, track.resolution, ox, oy, p[:, 0:1],
                          p[:, 1:2], *rotate_fan(*fan), 10.0, 1e-4, 200, hw)
    gen = torch.Generator(device=cuda).manual_seed(3)
    g = torch.randn((1, beams), generator=gen, device=cuda).expand(64, -1)
    args = (track.edf, track.resolution, ox, oy, p, *fan, r, hit, g, 1e-4,
            hw)
    terms = torch.empty((3, 64, beams), device=cuda)
    before = rd.implicit_pose_vjp.launches
    got = rd.implicit_pose_vjp(*args, terms=terms)
    assert rd.implicit_pose_vjp.launches == before + 1
    ref_terms = rd._pose_terms(*args)
    assert all(torch.equal(a, b) for a, b in zip(terms, ref_terms))
    scale = torch.stack([t.abs().sum(-1) for t in ref_terms], -1)
    ref = rd.implicit_pose_vjp_plain(*args)
    assert bool(((got - ref).abs() <= 1e-5 * scale).all())
    assert bool((got[48:56] == 0).all()) and float(got.abs().sum()) > 0
    assert torch.equal(rd.implicit_pose_vjp(*args), got)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        rd.implicit_pose_vjp(*args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rd.implicit_pose_vjp(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)
    none = rd.implicit_pose_vjp(track.edf, track.resolution, ox, oy,
                                p[:0], *(v[:0] for v in fan[:2]), *fan[2:],
                                r[:0], hit[:0], g[:0], 1e-4, hw)
    assert none.shape == (0, 3)


@pytest.mark.parametrize("case", ["random", "levine", "edges"])
@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_edf_march_grad_matches_plain(cuda, interp, case):
    """The march's gradient against autograd through the plain loop on the
    same tensors, with 200 trips and with 3 (on "edges" also 2048,
    ``MAX_GRAD_TRIPS``, on its first 4096 rays: autograd keeps every
    trip's tensors), from the march's record: the rays' gradients
    (bilinear) bit for bit, the EDF's within 1e-4 x max(1, the
    largest |plain|) (the kernel adds with atomics, autograd's scatter in
    another order); one launch a gradient; ``march_rays`` under autograd
    takes it."""
    from pyracecarsimulator_tpu_torch.ops import raymarch_xla as rx
    edf, inv, ox, oy, rays, hw = _march_case(cuda, case,
                                             nan=interp != "bilinear")
    gen = torch.Generator(device=cuda).manual_seed(3)
    g = torch.rand(rays[0].shape, generator=gen, device=cuda) + 0.5
    ray_grad = interp == "bilinear"
    runs = [(200, None), (3, None)]
    if case == "edges":
        runs.insert(0, (rx.MAX_GRAD_TRIPS, 4096))
    for max_iters, first in runs:
        rs = [v[:first] for v in rays]
        args = (edf, inv, ox, oy, *rs, 10.0, 1e-4, max_iters, hw, interp,
                g[:first], True, ray_grad)
        walk = torch.empty(rs[0].shape, dtype=torch.int32, device=cuda)
        rx.edf_march(*args[:12], interp, walk=walk)
        ref = rx.march_grad_plain(*args)
        scale = max(1.0, float(ref[0].abs().max()))
        assert float(ref[0].abs().sum()) > 0
        before = rx.edf_march_grad.launches
        got = rx.edf_march_grad(*args, walk)
        assert rx.edf_march_grad.launches == before + 1
        assert float((got[0] - ref[0]).abs().max()) <= 1e-4 * scale
        assert (got[1] is None) == (not ray_grad)
        for a, b in zip(got[1] or (), ref[1] or ()):
            assert torch.equal(a, b)
    leaves = [edf.clone().requires_grad_(True)] + [
        v.clone().requires_grad_(ray_grad) for v in rays]
    org = torch.stack([ox, oy])
    before = rx.edf_march_grad.launches
    r = rx.march_rays(leaves[0], 1.0 / inv, org, *leaves[1:],
                      max_iters=200, interp=interp, bounds_hw=hw)
    r.backward(g)
    assert rx.edf_march_grad.launches == before + 1
    ref = rx.march_grad_plain(edf, 1.0 / (1.0 / inv), ox, oy, *rays, 10.0,
                              1e-4, 200, hw, interp, g, True, ray_grad)
    assert torch.allclose(leaves[0].grad, ref[0], rtol=0,
                          atol=1e-4 * max(1.0, float(ref[0].abs().max())))
    for leaf, b in zip(leaves[1:], ref[1] or ()):
        assert torch.equal(leaf.grad, b)


def test_edf_march_counts_its_trips_on_the_device(cuda):
    """Every launch adds its longest ray's trips and 1 call to the
    device's counter; a replayed graph of the "edf" step counts too."""
    import pyracecarsimulator_tpu_torch as P
    from pyracecarsimulator_tpu_torch.maps import sample_free_poses
    from pyracecarsimulator_tpu_torch.ops import raymarch_xla as rx
    edf, inv, ox, oy, rays, hw = _march_case(cuda, "levine")
    trips = torch.zeros(rays[0].shape, dtype=torch.int32, device=cuda)
    rx.edf_march(edf, inv, ox, oy, *rays, 10.0, 1e-4, 200, hw, "nearest")
    counter = rx.MARCH_COUNTS.counter(edf.device)
    before = counter.clone()
    rx.edf_march(edf, inv, ox, oy, *rays, 10.0, 1e-4, 200, hw, "nearest",
                 ray_trips=trips)
    grown = (counter - before).tolist()
    assert grown == [int(trips.max()), 1]
    bundle = P.build_sim("levine", backend="edf",
                         scan=P.ScanParams(num_beams=256), device=cuda)
    p = torch.as_tensor(sample_free_poses(bundle.track, 32,
                                          np.random.RandomState(1)),
                        device=cuda)
    state = P.state_from_pose(p[:, 0], p[:, 1], p[:, 2])
    act = (torch.full((32,), 2.0, device=cuda), torch.zeros(32, device=cuda))
    step = P.make_step_fn(bundle, with_noise=False, graph=True)
    step.graphed.prepare(state, act, None)
    before = dict(rx.MARCH_COUNTS)
    for _ in range(3):
        step(state, act)
    assert rx.MARCH_COUNTS["calls"] - before["calls"] == 3
    assert rx.MARCH_COUNTS["trips"] - before["trips"] > 3


def test_edf_march_counts_concurrent_launches(cuda):
    """Marches of unequal grids on two streams at once: each launch keeps
    its own scratch, so the counter grows by the sum of their longest
    rays' trips and by 2 calls, and the next launch counts right too."""
    from pyracecarsimulator_tpu_torch.ops import raymarch_xla as rx
    edf, inv, ox, oy, rays, hw = _march_case(cuda, "levine")
    small = [v[:3] for v in rays]
    tr = [torch.zeros(v[0].shape, dtype=torch.int32, device=cuda)
          for v in (rays, small)]
    counter = rx.MARCH_COUNTS.counter(edf.device)
    torch.cuda.synchronize()
    before = counter.clone()
    streams = [torch.cuda.Stream() for _ in range(2)]
    for _ in range(20):
        for st, rs, t in zip(streams, (rays, small), tr):
            with torch.cuda.stream(st):
                rx.edf_march(edf, inv, ox, oy, *rs, 10.0, 1e-4, 200, hw,
                             "nearest", ray_trips=t)
    torch.cuda.synchronize()
    most = int(tr[0].max()) + int(tr[1].max())
    assert (counter - before).tolist() == [20 * most, 40]
    before = counter.clone()
    rx.edf_march(edf, inv, ox, oy, *small, 10.0, 1e-4, 200, hw, "nearest")
    assert (counter - before).tolist() == [int(tr[1].max()), 1]


@pytest.mark.parametrize("backend", ["edf", "edf_implicit", "edf_bilinear"])
def test_graphed_edf_train_step_equals_eager(cuda, backend):
    """The EDF train steps (T = 3, Adam with ``capturable=True``) in one
    CUDA graph against the eager ones after 3 steps, bit for bit; the
    bilinear march's backward runs ``edf_march_grad`` in both, the
    implicit march's ``implicit_pose_vjp``."""
    import pyracecarsimulator_tpu_torch as P
    from pyracecarsimulator_tpu_torch.maps import sample_free_poses
    from pyracecarsimulator_tpu_torch.ops import raymarch_diff as rd
    from pyracecarsimulator_tpu_torch.ops import raymarch_xla as rx
    from pyracecarsimulator_tpu_torch.parallel import make_bptt_train_fn
    beams, n = 128, 32

    def bundle_of(b):
        return P.build_sim("levine", backend=b,
                           scan=P.ScanParams(num_beams=beams),
                           sim=P.SimParams(steer_mode="smooth"), device=cuda)

    bundle = bundle_of(backend)
    p = torch.as_tensor(sample_free_poses(bundle.track, n,
                                          np.random.RandomState(2)),
                        device=cuda)
    state = P.state_from_pose(p[:, 0], p[:, 1], p[:, 2])
    policy = lambda ps, s, r, t: (torch.full((n,), 2.0, device=cuda),
                                  torch.tanh(r @ ps["w"] + ps["b"]))
    loss = lambda out, t: (torch.mean((out.ranges - 10.0) ** 2)
                           + torch.mean((out.state.steer_angle - 0.1) ** 2))
    adam = lambda ps: torch.optim.Adam(ps, lr=3e-3, capturable=True)
    got = {}
    grads = rx.edf_march_grad.launches
    vjps = rd.implicit_pose_vjp.launches
    for graph in (False, True):
        train, init = make_bptt_train_fn(P.make_step_fn(bundle,
                                                        with_noise=False),
                                         policy, loss, 3, beams,
                                         optimizer=adam, graph=graph)
        params = {"w": torch.zeros(beams, device=cuda),
                  "b": torch.zeros((), device=cuda)}
        opt = init(params)
        losses = []
        for _ in range(3):
            params, opt, l, final = train(params, opt, state)
            losses.append(l.clone())
        got[graph] = (torch.stack(losses), params["w"].detach().clone(),
                      final.pose)
        assert train.graphed.captures == (1 if graph else 0)
    assert all(torch.equal(a, b) for a, b in zip(got[False], got[True]))
    assert float(got[True][1].abs().sum()) > 0          # it trains
    assert (rx.edf_march_grad.launches > grads) == (backend == "edf_bilinear")
    assert (rd.implicit_pose_vjp.launches > vjps) == (backend == "edf_implicit")


# -- the general-segment sweep ------------------------------------------------

def _general_case(cuda):
    """(table (3, 6, 640), ids (64,), rays (4 x (64, 1080))) on the card:
    list 0 levine's simplified segments, with a copy of them from slot 512
    (every hit ties across chunks of 128); list 1 two segments met by a
    ray at t = 1 in slots 127 and 128 with different normals (a tie at a
    chunk boundary); list 2 only padding. Rows sweep random lists; the
    fan of 1080 beams from free poses (origins as expanded views, stride 0
    along the beams), row 0 from the origin: its beam 0 along +x, beam 1
    with a NaN direction, beam 2 parallel to segment 0 (a zero denom)."""
    from pyracecarsimulator_tpu_torch.maps import (contours as pc,
                                                   load_builtin,
                                                   sample_free_poses)
    from pyracecarsimulator_tpu_torch.ops.common import rays_from_poses
    track = load_builtin("levine", device="cpu")
    occ = track.occupancy.numpy()
    segs = pc.extract_general_segments(occ, track.resolution,
                                       (track.origin_x, track.origin_y), 1.0)
    pad = lambda k: np.ascontiguousarray(
        pc.pad_general_segments(np.zeros((0, 6)), k).T, np.float32)
    table = np.stack([pad(640)] * 3)
    table[0, :, :len(segs)] = segs.T
    table[0, :, 512:512 + len(segs)] = segs.T
    h = np.float32(np.sqrt(0.5))
    table[1, :5, 127] = [1.0, -1.0, 0.0, 1.0, 1.0]
    table[1, :5, 128] = [1.0, 0.0, h, -h, 1.0]
    rng = np.random.RandomState(4)
    ids = rng.randint(3, size=64).astype(np.int32)
    ids[0] = 1
    poses = sample_free_poses(track, 64, rng)
    poses[0] = 0.0
    _, _, x, y, c, s = rays_from_poses(torch.tensor(poses), 1080, FOV)
    c, s = c.clone(), s.clone()
    c[0, 0], s[0, 0] = 1.0, 0.0
    c[0, 1] = s[0, 1] = float("nan")
    c[0, 2], s[0, 2] = float(segs[0, 2]), float(segs[0, 3])
    return (torch.tensor(table, device=cuda),
            torch.tensor(ids, device=cuda),
            [v.to(cuda) for v in (x[:, :1], y[:, :1], c, s)])


@pytest.mark.parametrize("winner", [False, True])
@pytest.mark.parametrize("tiled", [False, True])
def test_general_sweep_matches_plain(cuda, tiled, winner):
    """``general_sweep`` against ``general_sweep_plain`` on the same
    tensors, bit for bit (best, and with ``winner`` wx and wy): each row
    its own list, or every row list 0 (then also a flat 1-D layout); one
    launch a sweep; the chunk-boundary tie keeps the first chunk's w."""
    from pyracecarsimulator_tpu_torch.ops import raycast_general as pg
    table, ids, (x, y, c, s) = _general_case(cuda)
    x, y = x.expand(c.shape), y.expand(c.shape)
    cases = ([(table, ids, (x, y, c, s))] if tiled else
             [(table[:1], None, (x, y, c, s)),
              (table[:1], None, tuple(v.reshape(-1) for v in (x, y, c, s)))])
    for tbl, ix, rays in cases:
        before = pg.general_sweep.launches
        got = pg.general_sweep(tbl, ix, *rays, winner)
        torch.cuda.synchronize()
        assert pg.general_sweep.launches == before + 1
        ref = pg.general_sweep_plain(tbl, ix, *rays, winner)
        assert (got[1] is None) == (ref[1] is None) == (not winner)
        assert all(a is None or torch.equal(a, b) for a, b in zip(got, ref))
        best = got[0].reshape(c.shape)
        lists = ids if tiled else torch.zeros_like(ids)
        big = float(np.float32(3e38))
        assert float(best[0, 1]) == big                 # a NaN direction
        assert float((best[lists == 0] < 10.0).float().mean()) > 0.3
        assert bool((best[lists == 2] == big).all())    # only padding
    if tiled and winner:
        assert float(got[0][0, 0]) == 1.0
        assert (float(got[1][0, 0]), float(got[2][0, 0])) == (1.0, 0.0)


@pytest.mark.parametrize("winner", [False, True])
def test_general_sweep_adversarial(cuda, winner):
    """``general_sweep`` against ``general_sweep_plain`` on the adversarial
    set of ``tests/torch_general_cases.py`` (1024 slots in chunks of 512,
    exact ties inside a chunk and across the cut, rays through segment
    endpoints, zero and subnormal denominators, NaN rays, a padding-only
    list, ranges near 3e38): each row on its list, each list alone as the
    flat table, and rows on lists that do not exist (NaN there, the other
    rows as the plain version gives them); as torch.equal compares (a
    zero equals a zero of either sign: torch's amin leaves the sign at a
    tie of +0 and -0 open), a NaN equal to a NaN; one launch a sweep."""
    from pyracecarsimulator_tpu_torch.ops import raycast_general as pg
    from torch_general_cases import adversarial, unknown_ids
    table, ids, rays = adversarial(0, device=cuda)
    same = lambda a, b: bool(((a == b) | (a.isnan() & b.isnan())).all())
    runs = [(table, ids)] + [(table[i:i + 1], None)
                             for i in range(table.shape[0])]
    for tbl, ix in runs:
        before = pg.general_sweep.launches
        got = pg.general_sweep(tbl, ix, *rays, winner)
        torch.cuda.synchronize()
        assert pg.general_sweep.launches == before + 1
        ref = pg.general_sweep_plain(tbl, ix, *rays, winner)
        assert (got[1] is None) == (ref[1] is None) == (not winner)
        assert all(a is None or same(a, b) for a, b in zip(got, ref))
    bad = unknown_ids(ids)
    unknown = (bad < 0) | (bad >= table.shape[0])
    got = pg.general_sweep(table, bad, *rays, winner)
    ref = pg.general_sweep_plain(table, torch.where(unknown, 2, bad), *rays,
                                 winner)
    for a, b in zip(got, ref):
        if a is not None:
            assert bool(a[unknown].isnan().all())
            assert same(a[~unknown], b[~unknown])


def test_general_sweep_graphed_equals_eager(cuda):
    """The "segments_simplified" scan of levine, min-only and winner (under
    autograd, with its backward), captured in a CUDA graph and replayed on
    new poses, against the eager scan: bit for bit, one ``general_sweep``
    launch a scan."""
    import pyracecarsimulator_tpu_torch as P
    from pyracecarsimulator_tpu_torch.maps import sample_free_poses
    from pyracecarsimulator_tpu_torch.ops import raycast_general as pg
    bundle = P.build_sim("levine", backend="segments_simplified",
                         device=cuda)
    poses = [torch.as_tensor(sample_free_poses(bundle.track, 128,
                                               np.random.RandomState(k)),
                             device=cuda) for k in range(3)]
    kw = dict(num_beams=1080, max_range=10.0)
    static = poses[0].clone()
    w = torch.linspace(0.5, 1.5, 1080, device=cuda)

    def scan_and_grad():
        q = static.detach().requires_grad_(True)
        r = pg.scan_poses_general(bundle.segmap, q, **kw)
        (r * w).sum().backward()
        with torch.no_grad():
            r0 = pg.scan_poses_general(bundle.segmap, static, **kw)
        return r.detach(), q.grad, r0

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            scan_and_grad()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = scan_and_grad()
    for p in poses:
        static.copy_(p)
        before = pg.general_sweep.launches
        graph.replay()
        ref = scan_and_grad()
        torch.cuda.synchronize()
        assert pg.general_sweep.launches == before + 2
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
        assert float(ref[1].abs().sum()) > 0


# -- the chamfer stencil of soft_edt ------------------------------------------

STENCIL_TOL = 1e-5
STENCIL_GRAD_TOL = 1e-4


def _stencil_case(cuda, shape, mode):
    """(d0, iters, temperature) on the card: a seeded binary map of
    ``shape`` (linear init) for "hard" and "soft", fractional occupancy
    with the log init for "soft-log"; or levine's occupancy ("levine") at
    the full map's iterations (64; the demo's 96 for "soft-log")."""
    from pyracecarsimulator_tpu_torch.maps import load_builtin
    from pyracecarsimulator_tpu_torch.ops import soft_edt as ps
    rng = np.random.RandomState(11)
    log = mode == "soft-log"
    if shape == "levine":
        occ = load_builtin("levine", device="cpu").occupancy.numpy()
        if log:
            occ = np.clip(occ, 0.05, 0.95)
        iters = 96 if log else 64
    else:
        occ = rng.rand(*shape).astype(np.float32)
        if not log:
            occ = (occ < 0.1).astype(np.float32)
        iters = 24
    d0 = ps.init_field(torch.tensor(occ, device=cuda), iters,
                       "log" if log else "linear").contiguous()
    return d0, iters, 0.0 if mode == "hard" else 0.25


def _close(a, b, exact, tol=STENCIL_TOL):
    if exact:
        return torch.equal(a, b)
    return float((a - b).abs().max()) <= tol * max(
        1.0, float(b.abs().max()))


@pytest.mark.parametrize("shape", [(1, 17), (17, 1), (2, 2), (33, 47),
                                   (48, 40), "levine"], ids=str)
@pytest.mark.parametrize("mode", ["hard", "soft", "soft-log"])
def test_soft_edt_kernels_match_plain(cuda, mode, shape):
    """``chamfer_stencil`` against ``chamfer_stencil_plain`` (values and
    history), ``chamfer_stencil_grad`` against
    ``chamfer_stencil_grad_plain`` from the kernel's history and against
    autograd through the plain loop, on the card; one launch each."""
    from pyracecarsimulator_tpu_torch.ops import soft_edt as ps
    d0, iters, t = _stencil_case(cuda, shape, mode)
    exact = mode == "hard"
    hist = torch.empty((iters, *d0.shape), device=cuda)
    ref_hist = torch.empty_like(hist)
    before = (ps.chamfer_stencil.launches, ps.chamfer_stencil_grad.launches)
    out = ps.chamfer_stencil(d0, iters, t)
    out_h = ps.chamfer_stencil(d0, iters, t, hist)
    ref = ps.chamfer_stencil_plain(d0, iters, t, ref_hist)
    torch.cuda.synchronize()
    assert torch.equal(out, out_h)
    assert _close(out, ref, exact) and _close(hist, ref_hist, exact)
    gen = torch.Generator(device=cuda).manual_seed(3)
    g = torch.randn(d0.shape, generator=gen, device=cuda)
    got = ps.chamfer_stencil_grad(hist, g, t)
    plain = ps.chamfer_stencil_grad_plain(hist, g, t)
    x = d0.clone().requires_grad_(True)
    ps.chamfer_stencil_plain(x, iters, t).backward(g)
    torch.cuda.synchronize()
    assert (ps.chamfer_stencil.launches,
            ps.chamfer_stencil_grad.launches) == (before[0] + 2,
                                                  before[1] + 1)
    assert _close(got, plain, exact)
    assert _close(got, x.grad, False,
                  STENCIL_TOL if exact else STENCIL_GRAD_TOL)
    assert float(got.abs().sum()) > 0


def test_soft_edt_on_the_card_launches_both_kernels(cuda):
    """``soft_edt`` of a CUDA occupancy, forward and backward: one launch
    of each kernel, the values and the occupancy gradient against the CPU
    bit for bit (hard min, binary map; the gradient kernel sums in the
    order of the CPU's autograd, which equals JAX)."""
    from pyracecarsimulator_tpu_torch.ops import soft_edt as ps
    rng = np.random.RandomState(2)
    occ = (rng.rand(300, 220) < 0.02).astype(np.float32)
    w = rng.randn(300, 220).astype(np.float32)
    grads = []
    for device in ("cpu", cuda):
        o = torch.tensor(occ, device=device, requires_grad=True)
        before = (ps.chamfer_stencil.launches,
                  ps.chamfer_stencil_grad.launches)
        d = ps.soft_edt(o, 0.05, iters=64)
        (d * torch.tensor(w, device=device)).sum().backward()
        grads.append((d.detach().cpu(), o.grad.cpu()))
        n = int(device != "cpu")
        assert (ps.chamfer_stencil.launches,
                ps.chamfer_stencil_grad.launches) == (before[0] + n,
                                                      before[1] + n)
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


@pytest.mark.parametrize("mode", ["hard", "soft"])
def test_soft_edt_kernels_replay_from_a_cuda_graph(cuda, mode):
    """Neither entry synchronises with the host: the forward (with its
    history) and the gradient captured in one CUDA graph replay, on
    inputs changed in place, what the eager calls give."""
    from pyracecarsimulator_tpu_torch.ops import soft_edt as ps
    d0, iters, t = _stencil_case(cuda, (48, 40), mode)
    gen = torch.Generator(device=cuda).manual_seed(4)
    g = torch.randn(d0.shape, generator=gen, device=cuda)
    hist = torch.empty((iters, *d0.shape), device=cuda)

    def both():
        return (ps.chamfer_stencil(d0, iters, t, hist),
                ps.chamfer_stencil_grad(hist, g, t))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = both()
    for k in range(3):
        d0.mul_(0.5 + 0.25 * k)
        g.mul_(-1.0)
        graph.replay()
        ref = both()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
