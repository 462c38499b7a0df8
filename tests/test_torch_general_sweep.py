"""The port's general-segment sweep (``ops/raycast_general.py``:
``general_sweep``, its plain version ``general_sweep_plain`` and the
chunk rule ``_fit_chunk``) against the JAX package's scans
(``_fwd_general``, ``_fwd_general_plain``, ``_fwd_general_tiled`` and
``_fwd_general_tiled_plain``), and the wrapper's route and checks. The
kernel itself, ``csrc/general_sweep.cu``, runs on the card:
tests/test_torch_kernels.py holds it against the plain version there.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:
- an exact tie at a chunk boundary: bit for bit (every product there is
  exact, so XLA's contraction of products into multiply-adds changes
  nothing);
- a map of real segments: ranges within 2e-5 m, the winner's (wx, wy)
  within 1e-5 relative (XLA's CPU backend contracts ``cos * nx + sin *
  ny`` and the range's numerator into multiply-adds, PyTorch rounds each
  product: the denominator moves by an ulp; measured here 9.5e-7 m and
  1.9e-7 relative), hit flags equal;
- the plain version against itself in smaller blocks of rays: bit for
  bit.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

# the JAX ops package exports a function of the module's name
jg = importlib.import_module("pyracecarsimulator_tpu.ops.raycast_general")

from pyracecarsimulator_tpu_torch.maps import contours as pc
from pyracecarsimulator_tpu_torch.ops import _kernels
from pyracecarsimulator_tpu_torch.ops import raycast_general as pg

from test_torch_contours import RES, disks, _free_poses

T = lambda a: torch.tensor(np.asarray(a))      # an own, writable copy
MAXR = 10.0


def _sentinels(k):
    """(6, k) padding slots, as ``pad_general_segments`` makes them."""
    return np.ascontiguousarray(
        pc.pad_general_segments(np.zeros((0, 6)), k).T, np.float32)


def _boundary_table():
    """(6, 640) slots, cut by ``_fit_chunk(640, 512)`` into chunks of 128,
    with two segments that the ray from the origin along +x meets at t = 1:
    in slot 127 (the first chunk's last) a vertical one ending at (1, 0),
    in slot 128 (the second's first) a slanted one starting there, whose
    normals give w = (1, -0) and (1, 1)."""
    table = _sentinels(640)
    h = np.float32(np.sqrt(0.5))
    table[:5, 127] = [1.0, -1.0, 0.0, 1.0, 1.0]
    table[:5, 128] = [1.0, 0.0, h, -h, 1.0]
    return table


def test_fit_chunk_matches_jax():
    from pyracecarsimulator_tpu.ops.raycast_segments import _fit_chunk
    for k in (128, 256, 384, 512, 640, 768, 1280, 1536, 4608):
        assert pg._fit_chunk(k) == _fit_chunk(k, 512), k
    assert pg._fit_chunk(82) == 82          # JAX sweeps no slot here
    with pytest.raises(ValueError, match="multiple of 128"):
        pg._fit_chunk(700)


@pytest.mark.parametrize("tiled", [False, True])
def test_chunk_boundary_tie_matches_jax(tiled):
    """The tie across the chunk boundary keeps the first chunk's winner, as
    JAX's scan does: w = (1, -0), not the larger (1, 1) of one chunk;
    ranges, wx and wy bit for bit."""
    table = _boundary_table()
    x = np.zeros((2, 3), np.float32)
    y = np.array([[0.0] * 3, [0.5] * 3], np.float32)
    th = np.array([[0.0, 0.3, -0.3], [0.0, -0.7, 3.0]])
    c, s = np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)
    c[0, 0], s[0, 0] = 1.0, 0.0
    rays = (x, y, c, s)
    if tiled:
        tiles = np.stack([_sentinels(640), table])    # both agents: tile 1
        geo = ((1, 2), 100.0, (-150.0, -50.0))
        x0 = y0 = np.zeros(2, np.float32)
        r, wx, wy, _ = jg._fwd_general_tiled(
            jnp.asarray(tiles), *geo, jnp.asarray(x0), jnp.asarray(y0),
            *map(jnp.asarray, rays), MAXR, 512)
        ids = pg.tile_ids(*geo, T(x0), T(y0))
        assert ids.tolist() == [1, 1]
        got = pg.general_sweep(T(tiles), ids, *map(T, rays), True)
    else:
        r, wx, wy, _ = jg._fwd_general(jnp.asarray(table),
                                       *map(jnp.asarray, rays), MAXR, 512)
        got = pg.general_sweep(T(table)[None], None, *map(T, rays), True)
    assert torch.equal(torch.clamp(got[0], max=MAXR), T(r))
    assert torch.equal(got[1], T(wx)) and torch.equal(got[2], T(wy))
    assert float(got[0][0, 0]) == 1.0
    assert (float(got[1][0, 0]), float(got[2][0, 0])) == (1.0, 0.0)
    whole = pg._sweep_block(T(table)[None], 640, 640,
                            [T(v)[:1, :1, None] for v in rays], True)
    assert float(whole[2][0, 0]) == 1.0     # one chunk takes the larger w


def _map_case(tiled):
    """(table, tile geometry or None, x0, y0, rays (4 x (12, 40))) on the
    disks map: 134 segments padded to 640 slots (5 chunks; a copy of the
    segments in slots 512-645 ties every hit across chunks), or its 1 m
    tiles padded to 640; 40 beams from 12 free poses, beam 0 of pose 0
    with a NaN direction and beam 1 parallel to segment 0 (its denom 0)."""
    occ, org = disks()
    segs = pc.extract_general_segments(occ, RES, org, 1.0)
    table = _sentinels(640)
    table[:, :len(segs)] = segs.T
    table[:, 512:512 + 128] = segs[:128].T
    geo = None
    if tiled:
        m = pc.build_general_segment_map(occ, RES, org, tol_cells=1.0,
                                         max_range=1.5, tile_size=1.0,
                                         real_hw=occ.shape, device="cpu")
        kt = m.tiles.shape[2]
        table = np.concatenate([m.tiles.numpy(), np.broadcast_to(
            _sentinels(640 - kt), (m.tiles.shape[0], 6, 640 - kt))], 2)
        geo = (m.tiles_shape, m.tile_size, m.tile_origin)
    poses = _free_poses(occ, org, 12, 1)
    th = poses[:, 2:3] + np.linspace(-2.3, 2.3, 40, dtype=np.float32)
    c, s = np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)
    c[0, 0] = s[0, 0] = np.nan
    c[0, 1], s[0, 1] = segs[0, 2], segs[0, 3]
    x = np.repeat(poses[:, :1], 40, 1)
    y = np.repeat(poses[:, 1:2], 40, 1)
    return (np.ascontiguousarray(table), geo, poses[:, 0], poses[:, 1],
            (x, y, c, s))


@pytest.mark.parametrize("winner", [False, True])
@pytest.mark.parametrize("tiled", [False, True])
def test_plain_sweep_matches_jax(tiled, winner):
    """``general_sweep`` on CPU tensors (its plain version) against the
    JAX scan of the same layout and mode, on 480 rays of a real map."""
    table, geo, x0, y0, rays = _map_case(tiled)
    jr = tuple(map(jnp.asarray, rays))
    if tiled:
        args = (jnp.asarray(table), *geo, jnp.asarray(x0), jnp.asarray(y0),
                *jr, MAXR, 512)
        ref = (jg._fwd_general_tiled(*args) if winner
               else jg._fwd_general_tiled_plain(*args))
        ids = pg.tile_ids(*geo, T(x0), T(y0))
        got = pg.general_sweep(T(table), ids, *map(T, rays), winner)
    else:
        args = (jnp.asarray(table), *jr, MAXR, 512)
        ref = (jg._fwd_general(*args) if winner
               else jg._fwd_general_plain(*args))
        got = pg.general_sweep(T(table)[None], None, *map(T, rays), winner)
    r_ref = np.asarray(ref[0] if winner else ref)
    r = torch.clamp(got[0], max=MAXR).numpy()
    np.testing.assert_allclose(r, r_ref, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(r < MAXR, r_ref < MAXR)
    assert 0.3 < np.mean(r_ref < MAXR) < 1.0 and r[0, 0] == MAXR
    assert (got[1] is None) == (got[2] is None) == (not winner)
    if winner:
        for a, b in zip(got[1:], ref[1:3]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("budget", [4 * 640 * 7, 4 * 128 * 9 * 2])
def test_plain_blocks_do_not_change_values(monkeypatch, budget):
    """The plain version in blocks of rays (7 rays, i.e. parts of a row;
    18 rays, i.e. whole rows of a 9-beam scan) equals one block."""
    table, geo, x0, y0, rays = _map_case(True)
    ids = pg.tile_ids(*geo, T(x0), T(y0))
    for tbl, ix, rs in ((T(table), ids, [T(v) for v in rays]),
                        (T(table[:1]), None, [T(v[:, :9]) for v in rays])):
        whole = pg.general_sweep_plain(tbl, ix, *rs, True)
        monkeypatch.setattr(pg, "_PLAIN_BYTES_BUDGET", budget)
        part = pg.general_sweep_plain(tbl, ix, *rs, True)
        monkeypatch.undo()
        assert all(torch.equal(a, b) for a, b in zip(whole, part))


def _stand_in(monkeypatch, calls):
    """The device check says "the card"; the launch is recorded, counted
    on the wrapper it names (as ``_kernels.launch`` counts it) and fills
    the outputs from the plain version, reading the rays through the
    views and strides it was handed."""

    def launch(name, entry, winner, table, n_lists, k, chunk, ids, x, y, c,
               s, *rest):
        _kernels.wrappers()[name].launches += 1
        strides, (rows, cols), out = rest[:8], rest[8:10], rest[10:]
        calls.append(dict(entry=entry, winner=winner, k=k, chunk=chunk,
                          ids=ids, strides=strides, shape=(rows, cols)))
        got = pg.general_sweep_plain(table, ids, x, y, c, s, bool(winner))
        for dst, src in zip(out, got):
            if dst is not None:
                dst.copy_(src.reshape(dst.shape))

    monkeypatch.setattr(_kernels, "on_cuda", lambda name, ref: True)
    monkeypatch.setattr(_kernels, "launch", launch)


@pytest.mark.parametrize("tiled", [False, True])
def test_scan_launches_the_sweep_once(monkeypatch, tiled):
    """With the device check saying "the card": a scan hands
    ``general_sweep`` its layout (the tile ids, or none) and the scan's
    expanded origin views (stride 0 along the beams, never a copy), one
    launch a scan, min-only outside autograd and winner under it; with
    the plain version standing in for the kernel, values and pose
    gradients equal the CPU's bit for bit."""
    occ, org = disks()
    m = pc.build_general_segment_map(occ, RES, org, tol_cells=1.0,
                                     max_range=1.5,
                                     tile_size=1.0 if tiled else 0.0,
                                     real_hw=occ.shape, device="cpu")
    poses = T(_free_poses(occ, org, 6, 2))
    kw = dict(num_beams=32, max_range=1.5)

    def run():
        with torch.no_grad():
            r = pg.scan_poses_general(m, poses, **kw)
        q = poses.clone().requires_grad_(True)
        pg.scan_poses_general(m, q, **kw).sum().backward()
        return r, q.grad

    ref = run()
    calls = []
    before = pg.general_sweep.launches
    _stand_in(monkeypatch, calls)
    got = run()
    assert pg.general_sweep.launches == before + 2
    assert [c["winner"] for c in calls] == [0, 1]
    for c in calls:
        assert c["shape"] == (6, 32) and c["strides"][:4] == (3, 0, 3, 0)
        assert (c["ids"] is None) == (not tiled)
        k = (m.tiles if tiled else m.params).shape[-1]
        assert c["k"] == k and c["chunk"] == pg._fit_chunk(k)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_wrapper_rejects_bad_inputs(monkeypatch):
    """``general_sweep`` on a tensor of another device than the CPU or the
    card raises, and (the device check patched) what the kernel does not
    take raises before any launch."""
    table = T(_boundary_table())[None]
    rays = [torch.zeros(3, 4) for _ in range(4)]
    with pytest.raises(ValueError, match="no kernel for device"):
        pg.general_sweep(table.to("meta"), None, *rays, True)
    calls = []
    _stand_in(monkeypatch, calls)
    ids = torch.zeros(3, dtype=torch.int32)
    for bad, match in (
            (dict(table=table.double()), "float32 \\(L, 6, K\\)"),
            (dict(table=table[:, :5]), "\\(L, 6, K\\)"),
            (dict(table=table.transpose(0, 1)), "\\(L, 6, K\\)"),
            (dict(table=table[..., ::2]), "contiguous"),
            (dict(table=table[..., :0]), "\\(L, 6, K\\)"),
            (dict(x=rays[0].double()), "float32 rays"),
            (dict(ids=ids.long()), "int32"),
            (dict(ids=ids[:2]), "int32 \\(3,\\)"),
            (dict(table=torch.cat([table, table[..., :60]], 2)),
             "multiple of 128")):
        args = dict(table=table, ids=None, x=rays[0], y=rays[1],
                    cos_t=rays[2], sin_t=rays[3], winner=True)
        with pytest.raises(ValueError, match=match):
            pg.general_sweep(**{**args, **bad})
    assert calls == []
    best, wx, wy = pg.general_sweep(table, ids, *rays, False)
    assert len(calls) == 1 and calls[0]["ids"] is ids
    assert best.shape == (3, 4) and best.dtype == torch.float32
    assert wx is None and wy is None


# -- the kernel's loop, emulated ------------------------------------------------
#
# ``csrc/general_sweep.cu`` sweeps only a list's real slots and divides only
# where a pair can still win. ``_emulate`` runs its loop in float32 torch,
# vectorised over the rays, in the kernel's order of operations, so that
# the skips can be held against the plain version here, bit for bit as
# torch.equal compares (``_equal``: a NaN equals a NaN), and counted.

def _above(v):
    """The float after |v|: the kernel's skip threshold."""
    return ((v.contiguous().view(torch.int32) & 0x7fffffff) + 1).view(
        torch.float32)


def _equal(a, b):
    """torch.equal, where a NaN equals a NaN. (As torch.equal, a zero
    equals a zero of either sign: which of +0 and -0 torch's ``amin``
    returns at a tie is left open, and differs with the reduction's
    order.)"""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _emulate(table, ids, x, y, c, s, winner):
    """The kernel's loop on (rows, cols) rays: (best, wx, wy) and the
    pairs it leaves: ``padding`` (past the list's last real slot),
    ``skipped`` (the division test), ``divided`` (the rest) and ``wins``
    (valid pairs whose t lowers, winner: or ties, the running minimum)."""
    x, y, c, s = torch.broadcast_tensors(x, y, c, s)
    rows, cols = x.shape
    n_lists, _, k = table.shape
    chunk = pg._fit_chunk(k)
    rid = (torch.zeros(rows, dtype=torch.long) if ids is None
           else ids.long())
    known = (rid >= 0) & (rid < n_lists)
    lst = table[rid.clamp(0, n_lists - 1)]
    real = lst[:, 4, :] >= 0
    idx = torch.arange(1, k + 1).expand(rows, k)
    limit = torch.where(real, idx, 0).amax(dim=1)
    limit = torch.where(known, limit, 0)[:, None]
    big = torch.tensor(3.0e38)
    neg_tiny = torch.tensor(-2.0 ** -149)
    best = torch.full((rows, cols), 3.0e38)
    hi = _above(best)
    wx = torch.zeros_like(best)
    wy = torch.zeros_like(best)
    n = dict(padding=0, skipped=0, divided=0, wins=0)
    for base in range(0, k, chunk):
        cmin = torch.full_like(best, float("inf"))
        cwx = torch.zeros_like(best)
        cwy = torch.zeros_like(best)
        tied = torch.zeros(rows, cols, dtype=torch.int64)
        for q in range(base, base + chunk):
            active = (q < limit).expand(rows, cols)
            p0x, p0y, ex, ey, ln = (lst[:, i, q, None] for i in range(5))
            nx, ny = -ey, ex
            denom = c * nx + s * ny
            num = (p0x - x) * nx + (p0y - y) * ny
            b = denom.abs()
            sq = (num.view(torch.int32)
                  ^ (denom.view(torch.int32) & -2 ** 31)).view(torch.float32)
            skip = (sq > hi * b) | (sq < neg_tiny * b)
            go = active & ~skip
            d_safe = torch.where(denom == 0.0, 1e-30, denom)
            t = num / d_safe
            hx = x + t * c - p0x
            hy = y + t * s - p0y
            sp = hx * ex + hy * ey
            valid = go & (t >= 0) & (sp >= 0) & (sp <= ln) & (denom != 0)
            thr = best if not winner else torch.minimum(best, cmin)
            n["padding"] += int((~active).sum())
            n["skipped"] += int((active & skip).sum())
            n["divided"] += int(go.sum())
            n["wins"] += int((valid & (t < big)
                              & ((t <= thr) if winner else (t < thr))).sum())
            if not winner:
                low = valid & (t < best)
                best = torch.where(low, t, best)
                hi = torch.where(low, _above(t), hi)
                continue
            le = valid & (t <= cmin)
            lt = le & (t < cmin)
            eq = le & ~lt
            qx, qy = nx / d_safe, ny / d_safe
            cwx = torch.where(lt, qx, torch.where(eq, torch.maximum(cwx, qx),
                                                  cwx))
            cwy = torch.where(lt, qy, torch.where(eq, torch.maximum(cwy, qy),
                                                  cwy))
            tied = torch.where(lt, 1, torch.where(eq, tied + 1, tied))
            hi = torch.where(lt, _above(torch.minimum(best, t)), hi)
            cmin = torch.where(lt, t, cmin)
        if winner:
            fill = tied < chunk
            cwx = torch.where(fill, torch.maximum(cwx, -big), cwx)
            cwy = torch.where(fill, torch.maximum(cwy, -big), cwy)
            upd = cmin < best
            best = torch.where(upd, cmin, best)
            wx = torch.where(upd, cwx, wx)
            wy = torch.where(upd, cwy, wy)
            hi = _above(best)
    nan = torch.tensor(float("nan"))
    out = [torch.where(known[:, None], v, nan) for v in (best, wx, wy)]
    return (out[0], *(out[1:] if winner else (None, None))), n


def _same(got, ref):
    return all(a is None and b is None or _equal(a, b)
               for a, b in zip(got, ref))


@pytest.mark.parametrize("winner", [False, True])
def test_emulated_kernel_matches_plain_adversarial(winner):
    """The kernel's loop (its real-slot limit, its division skip, the
    winner's ties) against ``general_sweep_plain`` on the adversarial set
    (``tests/torch_general_cases.py``: 1024 slots in chunks of 512, exact
    ties inside a chunk and across the cut, rays through endpoints, zero
    and subnormal denominators, NaN rays, a padding-only list, ranges near
    3e38), bit for bit (``_equal``): each row on its list, each list as
    the flat table, and rows on lists that do not exist (NaN there, the
    other rows as the plain version gives them)."""
    from torch_general_cases import adversarial, unknown_ids
    table, ids, rays = adversarial(0)
    runs = [(table, ids)] + [(table[i:i + 1], None) for i in range(4)]
    skipped = 0
    for tbl, ix in runs:
        got, n = _emulate(tbl, ix, *rays, winner)
        ref = pg.general_sweep_plain(tbl, ix, *rays, winner)
        assert _same(got, ref)
        skipped += n["skipped"]
        assert n["padding"] > 0 and n["divided"] >= n["wins"] > 0 or (
            tbl.shape[0] == 1 and tbl[0, 4].max() < 0)
    assert skipped > 0
    bad = unknown_ids(ids)
    unknown = (bad < 0) | (bad >= table.shape[0])
    got, _ = _emulate(table, bad, *rays, winner)
    ref = pg.general_sweep_plain(table, torch.where(unknown, 2, bad),
                                 *rays, winner)
    for a, b in zip(got, ref):
        if a is not None:
            assert bool(a[unknown].isnan().all())
            assert _equal(a[~unknown], b[~unknown])
    # the cases the set is made for are there
    best = ref[0]
    assert float(best[0, 0]) == 1.0                      # the tie at t = 1
    assert bool((best[1, :16] < 1e-38).any())            # subnormal ranges
    assert bool((best == 0.0).any())
    assert float(best[4, 0]) == float(np.float32(1.5e38))
    assert bool((best[6] == 3.0e38).all())               # a NaN origin
    assert str(float(best[1, 20])) == "-0.0"             # a quotient -0


def _map_rays(name, agents):
    """(table, ids, rays (agents, 1080)) of the "segments_simplified"
    scan of bundled map ``name``, as ``raycast_general`` hands them to the
    sweep (levine's flat table, berlin's 4 m tiles)."""
    import pyracecarsimulator_tpu_torch as P
    from pyracecarsimulator_tpu_torch.maps import sample_free_poses
    from pyracecarsimulator_tpu_torch.ops.common import rays_from_poses
    g = P.build_sim(name, backend="segments_simplified",
                    device="cpu").segmap
    poses = torch.as_tensor(sample_free_poses(
        load_track(name), agents, np.random.RandomState(3)))
    _, q, xb, yb, ct, st = rays_from_poses(poses, 1080, 4.712388980384690)
    if g.tiles is not None:
        return (g.tiles, pg.tile_ids(g.tiles_shape, g.tile_size,
                                     g.tile_origin, q[:, 0], q[:, 1]),
                (xb, yb, ct, st))
    return g.params[None], None, (xb, yb, ct, st)


def load_track(name):
    from pyracecarsimulator_tpu_torch.maps import load_builtin
    return load_builtin(name, device="cpu")


@pytest.mark.parametrize("winner", [False, True])
@pytest.mark.parametrize("name", ["levine", "berlin"])
def test_emulated_kernel_matches_plain_on_maps(name, winner):
    """The kernel's loop against ``general_sweep_plain`` on the scans of
    both bundled maps, 6 agents x 1080 beams, bit for bit; the pairs that
    each skip removes, printed (``pytest -s``): the padding past a list's
    last real slot and the divisions the threshold test proves useless.
    ``general_pair_counts`` (``tests/torch_general_cases.py``: the
    bound's count in ``chip_smoke.py``, from the plain version) gives the
    emulation's real pairs and winning pairs."""
    from torch_general_cases import general_pair_counts
    table, ids, rays = _map_rays(name, 6)
    got, n = _emulate(table, ids, *rays, winner)
    ref = pg.general_sweep_plain(table, ids, *rays, winner)
    assert _same(got, ref)
    assert float((ref[0] < MAXR).float().mean()) > 0.5
    counts = general_pair_counts((table, ids, *rays), winner, block_rows=4)
    real = n["skipped"] + n["divided"]
    assert counts == {"pairs": real, "full_pairs": n["wins"]}
    slots = n["padding"] + real
    print(f"\n{name} {'winner' if winner else 'min'}: {slots} slot pairs, "
          f"padding {n['padding']} ({n['padding'] / slots:.3f}), division "
          f"skipped {n['skipped']} ({n['skipped'] / real:.3f} of the real), "
          f"divided {n['divided']} ({n['divided'] / real:.3f}), winning "
          f"{n['wins']} ({n['wins'] / real:.4f})")
    assert n["padding"] > 0 and n["skipped"] > n["divided"] > n["wins"] > 0
