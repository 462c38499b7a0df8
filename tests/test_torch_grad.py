"""The port's analytic VJPs against the JAX package's, and against finite
differences.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:

- ``_winner_vjp`` on the same residuals, and every VJP whose JAX side keeps
  the vertical and horizontal minima apart (split layouts, the Pallas
  kernels, the sector sweep): exact.
- Mixed layouts (``kv == 0`` / ``kv_tile == 0``) under JAX autodiff: JAX
  packs the orientation bit into the mantissa LSB of t (``_vh_chunk_body``),
  so its primal sits up to 1 ulp below ``raycast_all`` and exact V/H ties
  go to horizontal; the port keeps the minima apart (ties to vertical).
  Held to: the port's primal equals ``raycast_all`` exactly, JAX's primal
  within 1 ulp of it; d/dx and d/dy equal except on exact ties; d/dcos and
  d/dsin (-g * r * (1/u)) within 3 ulp relative: the ulp of r and the two
  roundings of the product.
- Finite differences, in float64 on the plain sweeps: central differences
  of the summed range (rays are independent) on rays whose winning
  segment is the same at both ends, rtol 1e-6.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pyracecarsimulator_tpu.maps import segments as jseg
from pyracecarsimulator_tpu.ops import raycast_grad as jrg
from pyracecarsimulator_tpu.ops import raycast_segments as jrs
from pyracecarsimulator_tpu.ops import raycast_sectors as jsec
from pyracecarsimulator_tpu.ops.common import fan_cos_sin as jax_fan
from pyracecarsimulator_tpu.maps.sectors import (build_sector_map as
                                                 jax_build_sector_map)

from pyracecarsimulator_tpu_torch.maps import segments as pseg
from pyracecarsimulator_tpu_torch.maps.sectors import SectorSegmentMap
from pyracecarsimulator_tpu_torch.ops import raycast_grad as prg
from pyracecarsimulator_tpu_torch.ops import raycast_pallas as prp
from pyracecarsimulator_tpu_torch.ops import raycast_sectors as psec
from pyracecarsimulator_tpu_torch.ops.common import tile_ids

jrp = importlib.import_module("pyracecarsimulator_tpu.ops.raycast_pallas")

MAXR = 4.0
FOV = 4.712388980384690


def _tile_minima(tiles, meta, tiles_shape, tile_size, tile_origin, x0, y0,
                 *rays):
    """(bv, bh) of the tile route for rays (A, NBLK * 128): each agent's
    rows through the list sweep's row glue, on its map tile's list."""
    nblk = rays[2].shape[1] // prg.LANES
    ids = tile_ids(tiles_shape, tile_size, tile_origin, x0, y0)
    return prg._list_minima(tiles, meta, ids[:, None].expand(-1, nblk),
                            *rays)


def _blobby(seed, n_blocks):
    rng = np.random.RandomState(seed)
    h = w = 220
    occ = np.zeros((h, w), np.float32)
    occ[:3, :] = 1; occ[-3:, :] = 1; occ[:, :3] = 1; occ[:, -3:] = 1
    for _ in range(n_blocks):
        r, c = rng.randint(10, h - 12), rng.randint(10, w - 12)
        bh, bw = rng.randint(2, 9, 2)
        occ[r:r + bh, c:c + bw] = 1
    return occ, (-h * 0.025, -w * 0.025)


@pytest.fixture(scope="module")
def maps(small_track):
    """name -> (JAX map, port map): mixed (small_track), split (blobby),
    mixed tiles (blobby) and split tiles (a denser blobby)."""
    t = small_track
    occ_s, org_s = np.asarray(t.occupancy), (t.origin_x, t.origin_y)
    cases = {"mixed": (occ_s, org_s, {}),
             "split": (*_blobby(7, 40), {}),
             "tiles_mixed": (*_blobby(7, 40),
                             dict(tile_size=1.0, max_range=2.0)),
             "tiles_split": (*_blobby(3, 400),
                             dict(tile_size=2.0, max_range=4.0))}
    out = {}
    for name, (occ, org, kw) in cases.items():
        out[name] = (jseg.build_segment_map(occ, 0.05, org, **kw),
                     pseg.build_segment_map(occ, 0.05, org, **kw,
                                            device="cpu"))
    assert out["mixed"][1].kv == 0 and out["split"][1].kv > 0
    assert out["tiles_mixed"][1].kv_tile == 0
    assert out["tiles_split"][1].kv_tile > 0
    return out


def _rays(seed, a_n, b_n):
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(-4.5, 4.5, a_n).astype(np.float32)
    y0 = rng.uniform(-4.5, 4.5, a_n).astype(np.float32)
    th = rng.uniform(-np.pi, np.pi, (a_n, b_n)).astype(np.float32)
    ct, st = np.cos(th), np.sin(th)
    g = rng.standard_normal((a_n, b_n)).astype(np.float32)
    return x0, y0, ct, st, g


def _t(a, grad=False):
    return torch.tensor(np.array(a), requires_grad=grad)


def _port_grads(fn, x0, y0, ct, st, g):
    """Forward + backward of ``fn(xb, yb, ct, st)`` with per-ray origins
    broadcast from x0/y0; returns (r, [dx, dy, dcos, dsin] per ray)."""
    xb, yb = (_t(np.repeat(v[:, None], ct.shape[1], 1), True)
              for v in (x0, y0))
    c, s = _t(ct, True), _t(st, True)
    r = fn(xb, yb, c, s)
    r.backward(_t(g))
    return r.detach().numpy(), [v.grad.numpy() for v in (xb, yb, c, s)]


def _jax_grads(fn, x0, y0, ct, st, g):
    xb, yb = (jnp.asarray(np.repeat(v[:, None], ct.shape[1], 1))
              for v in (x0, y0))
    r, vjp = jax.vjp(fn, xb, yb, jnp.asarray(ct), jnp.asarray(st))
    return np.asarray(r), [np.asarray(v) for v in vjp(jnp.asarray(g))]


def test_winner_vjp_matches_jax():
    rng = np.random.RandomState(0)
    n = 4000
    r = rng.uniform(0, 10, n).astype(np.float32)
    isv = rng.rand(n) > 0.5
    hit = rng.rand(n) > 0.2
    ct = rng.uniform(-1, 1, n).astype(np.float32)
    st = rng.uniform(-1, 1, n).astype(np.float32)
    ct[:50] = 0.0
    st[50:100] = 0.0
    g = rng.standard_normal(n).astype(np.float32)
    ref = jrg._winner_vjp(*map(jnp.asarray, (r, isv, hit, ct, st, g)))
    got = prg._winner_vjp(*map(_t, (r, isv, hit, ct, st, g)))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["split", "tiles_split"])
def test_split_layout_vjp_exact(maps, name):
    """raycast_all_diff / raycast_tiled_diff: values and all four ray
    cotangents equal jax.vjp bit for bit on split layouts."""
    jmap, pmap = maps[name]
    x0, y0, ct, st, g = _rays(1, 6, 256)
    if name == "split":
        jfn = lambda *r: jrg.raycast_all_diff(jmap.params, *r, MAXR, 1024,
                                              jmap.kv)
        pfn = lambda *r: prg.raycast_all_diff(pmap.params, pmap.sweep_meta,
                                              *r, MAXR)
    else:
        jfn = lambda *r: jrg.raycast_tiled_diff(
            jmap.tiles, jmap.tiles_shape, jmap.tile_size, jmap.tile_origin,
            jnp.asarray(x0), jnp.asarray(y0), *r, MAXR, 512, jmap.kv_tile)
        pfn = lambda *r: prg.raycast_tiled_diff(
            pmap.tiles, pmap.tile_sweep_meta, pmap.tiles_shape,
            pmap.tile_size, pmap.tile_origin, _t(x0), _t(y0), *r, MAXR)
    r_ref, g_ref = _jax_grads(jfn, x0, y0, ct, st, g)
    r, grads = _port_grads(pfn, x0, y0, ct, st, g)
    np.testing.assert_array_equal(r, r_ref)
    for a, b in zip(grads, g_ref):
        np.testing.assert_array_equal(a, b)
    assert np.mean(r < MAXR) > 0.3 and np.any(grads[0] != 0)


@pytest.mark.parametrize("name", ["mixed", "tiles_mixed"])
def test_mixed_layout_vjp_under_the_ulp_contract(maps, name):
    """Mixed layouts: the port's primal equals raycast_all exactly, JAX's
    autodiff primal is within 1 ulp; cotangents per the module doc."""
    jmap, pmap = maps[name]
    x0, y0, ct, st, g = _rays(2, 6, 256)
    xb, yb = (np.repeat(v[:, None], 256, 1) for v in (x0, y0))
    if name == "mixed":
        plain = jrs.raycast_all(jmap.params, xb, yb, ct, st, MAXR)
        jfn = lambda *r: jrg.raycast_all_diff(jmap.params, *r, MAXR)
        pfn = lambda *r: prg.raycast_all_diff(pmap.params, pmap.sweep_meta,
                                              *r, MAXR)
        minima = lambda: prg._all_minima(pmap.params, pmap.sweep_meta,
                                         *map(_t, (xb, yb, ct, st)))
    else:
        tile_args = (jmap.tiles, jmap.tiles_shape, jmap.tile_size,
                     jmap.tile_origin, jnp.asarray(x0), jnp.asarray(y0))
        plain = jrs.raycast_tiled(*tile_args, xb, yb, ct, st, MAXR)
        jfn = lambda *r: jrg.raycast_tiled_diff(*tile_args, *r, MAXR)
        ptile = (pmap.tiles, pmap.tile_sweep_meta, pmap.tiles_shape,
                 pmap.tile_size, pmap.tile_origin, _t(x0), _t(y0))
        pfn = lambda *r: prg.raycast_tiled_diff(*ptile, *r, MAXR)
        minima = lambda: _tile_minima(*ptile, *map(_t, (xb, yb, ct, st)))
    r_ref, g_ref = _jax_grads(jfn, x0, y0, ct, st, g)
    r, grads = _port_grads(pfn, x0, y0, ct, st, g)
    np.testing.assert_array_equal(r, np.asarray(plain))
    assert np.all(np.abs(r - r_ref) <= np.spacing(r))
    bv, bh = (v.numpy() for v in minima())
    tie = (bv == bh) & (np.minimum(bv, bh) < MAXR)
    same = ~tie & ((r < MAXR) == (r_ref < MAXR))
    assert same.mean() > 0.99 and np.mean(r < MAXR) > 0.3
    for a, b in zip(grads[:2], g_ref[:2]):
        np.testing.assert_array_equal(a[same], b[same])
    for a, b in zip(grads[2:], g_ref[2:]):
        np.testing.assert_allclose(a[same], b[same], rtol=3.6e-7, atol=0)


@pytest.mark.parametrize("name", ["mixed", "split", "tiles_mixed",
                                  "tiles_split"])
def test_pallas_entry_points_vjp_exact(maps, name):
    """raycast_pallas / raycast_pallas_tiled against jax.vjp of the JAX
    Pallas kernels (interpret mode), which keep the minima apart: exact on
    every layout."""
    jmap, pmap = maps[name]
    x0, y0, ct, st, g = _rays(3, 4, 128)
    if jmap.tiles is None:
        jfn = lambda *r: jrp.raycast_pallas(jmap.params, jmap.sweep_meta,
                                            *r, MAXR, True)
        pfn = lambda *r: prp.raycast_pallas(pmap.params, pmap.sweep_meta,
                                            *r, MAXR)
    else:
        jfn = lambda *r: jrp.raycast_pallas_tiled(
            jmap.tiles, jmap.tile_sweep_meta, jmap.tiles_shape,
            jmap.tile_size, jmap.tile_origin, jnp.asarray(x0),
            jnp.asarray(y0), *r, MAXR, True)
        pfn = lambda *r: prp.raycast_pallas_tiled(
            pmap.tiles, pmap.tile_sweep_meta, pmap.tiles_shape,
            pmap.tile_size, pmap.tile_origin, _t(x0), _t(y0), *r, MAXR)
    r_ref, g_ref = _jax_grads(jfn, x0, y0, ct, st, g)
    r, grads = _port_grads(pfn, x0, y0, ct, st, g)
    np.testing.assert_array_equal(r, r_ref)
    for a, b in zip(grads, g_ref):
        np.testing.assert_array_equal(a, b)


def test_sector_vjp_matches_jax():
    """The sector forward's autograd Function against jax.vjp of JAX
    raycast_sectors (dense XLA sweep) on the same fan: exact. The table,
    meta and lookup positions get no gradient."""
    occ, org = _blobby(7, 40)
    jmap = jax_build_sector_map(occ, 0.05, org, max_range=MAXR,
                                tile_size=2.0, ns=8, block_half=0.4)
    pmap = SectorSegmentMap.from_numpy(
        np.asarray(jmap.table), np.asarray(jmap.meta),
        **{f: getattr(jmap, f) for f in (
            "n_segments", "ns", "kv_sec", "block_half", "tile_size",
            "tiles_shape", "tile_origin", "extent", "rt", "reach")},
        device="cpu")
    rng = np.random.RandomState(4)
    a_n, bb = 6, 64
    x0 = rng.uniform(-4.5, 4.5, a_n).astype(np.float32)
    y0 = rng.uniform(-4.5, 4.5, a_n).astype(np.float32)
    offs = jsec._padded_offsets(256, 1.2, bb)
    ct, st = (np.asarray(v) for v in jax_fan(
        jnp.asarray(rng.uniform(-np.pi, np.pi, a_n).astype(np.float32)),
        offs))
    g = rng.standard_normal(ct.shape).astype(np.float32)
    jfn = lambda *r: jsec.raycast_sectors(
        jmap.table, jmap.meta, jmap.tiles_shape, jmap.tile_size,
        jmap.tile_origin, jmap.ns, jmap.kv_sec, jnp.asarray(x0),
        jnp.asarray(y0), *r, MAXR, bb)
    table = pmap.table.clone().requires_grad_(True)
    x0_t = _t(x0, True)
    pfn = lambda *r: psec.raycast_sectors(
        table, pmap.meta, pmap.tiles_shape, pmap.tile_size,
        pmap.tile_origin, pmap.ns, x0_t, _t(y0), *r, MAXR, bb)
    r_ref, g_ref = _jax_grads(jfn, x0, y0, ct, st, g)
    r, grads = _port_grads(pfn, x0, y0, ct, st, g)
    np.testing.assert_array_equal(r, r_ref)
    for a, b in zip(grads, g_ref):
        np.testing.assert_array_equal(a, b)
    assert np.mean(r < MAXR) > 0.3
    assert table.grad is None and x0_t.grad is None


@pytest.mark.parametrize("name", ["mixed", "split", "tiles_split"])
def test_vjp_matches_finite_differences(maps, name):
    """d(sum r)/d(x, y, cos, sin) of the analytic VJP against central
    differences in float64 (the plain sweeps promote to the rays' dtype),
    on rays whose winner (orientation and hit) holds at both ends."""
    _, pmap = maps[name]
    x0, y0, ct, st, _ = _rays(5, 4, 128)
    xb, yb = (np.repeat(v[:, None], 128, 1).astype(np.float64)
              for v in (x0, y0))
    rays = [xb, yb, ct.astype(np.float64), st.astype(np.float64)]
    if pmap.tiles is None:
        fn = lambda *r: prg.raycast_all_diff(pmap.params, pmap.sweep_meta,
                                             *r, MAXR)
        win = lambda *r: prg._all_minima(pmap.params, pmap.sweep_meta, *r)
    else:
        tl = (pmap.tiles, pmap.tile_sweep_meta, pmap.tiles_shape,
              pmap.tile_size, pmap.tile_origin, _t(x0), _t(y0))
        fn = lambda *r: prg.raycast_tiled_diff(*tl, *r, MAXR)
        win = lambda *r: _tile_minima(*tl, *r)
    ts = [torch.tensor(v, requires_grad=True) for v in rays]
    fn(*ts).sum().backward()
    eps = 1e-6
    base = win(*map(torch.tensor, rays))
    for i in range(4):
        up, dn = ([torch.tensor(v + (sgn * eps if j == i else 0.0))
                   for j, v in enumerate(rays)] for sgn in (1, -1))
        fd = ((fn(*up) - fn(*dn)) / (2 * eps)).numpy()
        keep = np.ones(fd.shape, bool)
        for r_ in (up, dn):
            bv, bh = win(*r_)
            keep &= ((bv <= bh) == (base[0] <= base[1])).numpy()
            keep &= (torch.minimum(bv, bh) < MAXR).numpy() == (
                torch.minimum(*base) < MAXR).numpy()
        assert keep.mean() > 0.9
        np.testing.assert_allclose(ts[i].grad.numpy()[keep], fd[keep],
                                   rtol=1e-6, atol=1e-6)
    assert np.any(ts[0].grad.numpy() != 0)
