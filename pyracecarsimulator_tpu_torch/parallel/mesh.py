"""Agents x beams sharding over ``torch.distributed``.

Counterpart of ``pyracecarsimulator_tpu/parallel/mesh.py``. The scaling
model is the JAX package's:

  * ``agents`` mesh axis: data parallel, each rank owns a slab of cars;
  * ``beams`` mesh axis: each rank computes a contiguous beam wedge of
    every owned agent's scan. Segment tables are replicated; rays never
    communicate during the sweep, so the only collectives are the
    reductions that consume scans (the TTC any-beam OR) and the sum of the
    pose gradients over the wedges.

JAX's ``shard_map`` is one program over a global array. The port is SPMD:
every rank runs the same function on its own slab, and the functions here
take and return the rank's local tensors. A rank's place is ``rank =
agents_index * beams + beams_index``, the row-major layout of the JAX
mesh. ``shard_state``/``shard_agents`` cut a global batch to the rank's
slab; ``gather_ranges``/``gather_agents`` assemble the global arrays that
``shard_map`` returned for free.

The gradient all-reduce is explicit: JAX's transpose of ``shard_map``
sums the pose cotangents over ``beams``; here the poses enter a scan
through ``_SumGradOverBeams``, whose backward is that sum. With it every
rank of a ``beams`` group holds the gradient of the summed loss over all
the group's wedges, provided each rank's loss covers its own wedge only.

Collectives go through three helpers, ``all_reduce``, ``all_gather`` and
``ring_shift``. A gloo group takes CUDA tensors only for some
collectives, so when the group's backend is gloo and the tensor lies on
the card the helpers stage it through pinned host memory; the compute and
the kernels stay on the card. With NCCL (one card per rank) the tensors
go as they are. The backend is the one the caller initialised
(``parallel/multihost.initialize``); nothing here switches it.

Left out as XLA machinery: ``compiler_opts``, ``step.jitted`` and
``has_compiler_opts`` (compiler options and retrace introspection of the
jitted step), ``parallel/flags.py``, ``resolve_sector_mode`` and
``table_ck``. The maps ride in ``map_cell["map"]`` as in
``simulator.make_step_fn``; PyTorch runs eagerly, so a swap needs nothing
else.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from ..maps.contours import GeneralSegmentMap
from ..maps.sectors import SectorSegmentMap, StackedSectorMap
from ..maps.segments import SegmentMap
from ..models.ttc import check_ttc, ttc_tables
from ..ops.common import apply_extent_mask, beam_angles, fan_cos_sin
from ..ops.noise import add_scan_noise
from ..ops.raycast_general import raycast_general
from ..ops.raycast_grad import raycast_all_diff
from ..ops.raycast_sectors import (_scan_chunk_multi, raycast_sectors,
                                   sector_block_width, sector_sweep)
from ..state import FIELDS, CarState


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an (agents, beams) grid of ranks."""

    agents: int                  # size of the agents axis
    beams: int                   # size of the beams axis
    agents_index: int            # this rank's coordinates
    beams_index: int
    beams_ranks: Tuple[int, ...]    # global ranks that share agents_index
    agents_group: Any = None     # process group of the ranks that share
    #                              beams_index (collectives over agents)
    beams_group: Any = None      # process group of ``beams_ranks``

    @property
    def shape(self) -> dict:
        return {"agents": self.agents, "beams": self.beams}

    @property
    def index(self) -> int:
        """``beams_index + beams * agents_index``: the rank."""
        return self.beams_index + self.beams * self.agents_index


def mesh_shape(n: int, agents_axis: Optional[int] = None,
               beams_axis: int = 1) -> Tuple[int, int]:
    """(agents, beams) for ``n`` ranks. With ``agents_axis=None`` every
    rank not used by ``beams_axis`` goes to the agents axis: beam sharding
    only pays off once per-rank agent slabs get small."""
    if n % beams_axis:
        raise ValueError(f"{n} ranks not divisible by beams_axis="
                         f"{beams_axis}")
    if agents_axis is None:
        agents_axis = n // beams_axis
    if agents_axis * beams_axis != n:
        raise ValueError(f"mesh {agents_axis}x{beams_axis} != {n} ranks")
    return agents_axis, beams_axis


def make_mesh(agents_axis: Optional[int] = None,
              beams_axis: int = 1) -> Mesh:
    """The mesh over every rank of the initialised process group.

    ``dist.new_group`` is a collective over the whole world, so every rank
    creates every group, in the same order, and keeps the two it belongs
    to."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group "
            "(parallel.multihost.initialize, or parallel.dryrun)")
    na, nb = mesh_shape(dist.get_world_size(), agents_axis, beams_axis)
    ai, bi = divmod(dist.get_rank(), nb)
    rows = [tuple(a * nb + b for b in range(nb)) for a in range(na)]
    cols = [tuple(a * nb + b for a in range(na)) for b in range(nb)]
    row_groups = [dist.new_group(list(r)) for r in rows]
    col_groups = [dist.new_group(list(c)) for c in cols]
    return Mesh(agents=na, beams=nb, agents_index=ai, beams_index=bi,
                beams_ranks=rows[ai],
                agents_group=col_groups[bi], beams_group=row_groups[ai])


# -- the three collective helpers ------------------------------------------

def _staged(t, group) -> bool:
    """True when ``t`` must cross through host memory: a CUDA tensor on a
    gloo group (module doc)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t):
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def all_reduce(t, op, group, size: int):
    """``t`` reduced with ``op`` over the ``size`` ranks of ``group``; a
    new tensor on ``t``'s device."""
    if size == 1:
        return t
    if _staged(t, group):
        h = _to_host(t)
        dist.all_reduce(h, op=op, group=group)
        return h.to(t.device)
    t = t.clone()
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t, group, size: int, dim: int = 0):
    """The ranks' tensors of ``group`` concatenated along ``dim`` in group
    order, on ``t``'s device. Bool tensors travel as uint8."""
    if size == 1:
        return t
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    src = _to_host(src) if _staged(src, group) else src.contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(device=t.device, dtype=t.dtype)


def ring_shift(t, mesh: Mesh):
    """One step of the ring over the ``beams`` group: send ``t`` to the
    neighbour below (``beams_index - 1``) and return what the neighbour
    above sent. The send and the receive are posted together before either
    is waited for; a ring of blocking sends would deadlock."""
    s = mesh.beams
    if s == 1:
        return t
    staged = _staged(t, mesh.beams_group)
    src = _to_host(t) if staged else t.contiguous()
    dst = torch.empty_like(src)
    below = mesh.beams_ranks[(mesh.beams_index - 1) % s]
    above = mesh.beams_ranks[(mesh.beams_index + 1) % s]
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, below, group=mesh.beams_group),
            dist.P2POp(dist.irecv, dst, above, group=mesh.beams_group)]):
        work.wait()
    return dst.to(t.device) if staged else dst


class _SumGradOverBeams(torch.autograd.Function):
    """Identity whose backward sums the cotangent over the ``beams``
    group: the explicit form of the psum that JAX's transpose of
    ``shard_map`` inserts for an input replicated over ``beams``."""

    @staticmethod
    def forward(ctx, mesh, t):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return None, all_reduce(g, dist.ReduceOp.SUM, m.beams_group, m.beams)


def sum_grad_over_beams(mesh: Mesh, *parts):
    """``parts`` (tensors of one shape), with their gradients summed over
    the ``beams`` group by one all-reduce; unchanged where there is no
    group to sum over or no gradient to take."""
    if mesh.beams == 1 or not (torch.is_grad_enabled()
                               and any(p.requires_grad for p in parts)):
        return parts
    return _SumGradOverBeams.apply(
        mesh, torch.stack(parts, dim=-1)).unbind(-1)


# -- slabs in, global arrays out -------------------------------------------

def shard_agents(mesh: Mesh, t):
    """The rank's slab of a global per-agent tensor (agents on axis 0)."""
    a_n = t.shape[0]
    if a_n % mesh.agents:
        raise ValueError(f"{a_n} agents not divisible by the agents mesh "
                         f"axis {mesh.agents}")
    a_loc = a_n // mesh.agents
    return t[mesh.agents_index * a_loc:(mesh.agents_index + 1) * a_loc]


def shard_state(mesh: Mesh, state: CarState) -> CarState:
    """The rank's agent slab of a global ``CarState``."""
    return CarState(**{f: shard_agents(mesh, getattr(state, f))
                       for f in FIELDS})


def gather_agents(mesh: Mesh, local):
    """Per-agent local tensors -> the global tensor (one all-gather over
    the ``agents`` group), on every rank."""
    return all_gather(local, mesh.agents_group, mesh.agents, dim=0)


def gather_ranges(mesh: Mesh, local):
    """(A_loc, B_loc) wedges -> the global (A, B) ranges (one all-gather
    per axis), on every rank."""
    row = all_gather(local, mesh.beams_group, mesh.beams, dim=1)
    return gather_agents(mesh, row)


def rank_generator(mesh: Mesh, seed: int, device) -> torch.Generator:
    """The rank's noise generator: seeded from the caller's ``seed`` and
    the rank's ``beams_index + beams * agents_index``, so every wedge
    draws its own noise (the JAX package folds the same index into its
    key)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * mesh.agents * mesh.beams + mesh.index)
    return gen


# -- the wedge scan --------------------------------------------------------

def _wedge(mesh: Mesh, num_beams: int):
    """(first beam, beam count) of this rank's wedge."""
    if num_beams % mesh.beams:
        raise ValueError(f"num_beams={num_beams} not divisible by beams "
                         f"mesh axis {mesh.beams}")
    b_loc = num_beams // mesh.beams
    return mesh.beams_index * b_loc, b_loc


def _wedge_offsets(mesh: Mesh, num_beams: int, fov: float, bb: int, device):
    """This rank's slice of the full beam offsets, padded to a multiple of
    ``bb`` (0: no padding) by repeating the last offset."""
    b0, b_loc = _wedge(mesh, num_beams)
    offs = beam_angles(num_beams, fov, device)[b0:b0 + b_loc]
    pad = (-b_loc) % bb if bb else 0
    return torch.cat([offs, offs[-1:].expand(pad)]) if pad else offs


def _make_wedge_scan(mesh: Mesh, proto, num_beams: int, fov: float,
                     max_range: float, theta_disc: int = 0,
                     mask_dense: bool = True):
    """``scan(m, x, y, theta, mid=None) -> (A_loc, B_loc)`` ranges of this
    rank's beam wedge on map ``m``, of ``proto``'s type: a
    ``StackedSectorMap`` (``mid`` routes each agent), a
    ``SectorSegmentMap``, a ``GeneralSegmentMap`` or a ``SegmentMap``
    (swept densely over ``params``, never its tiles, as in the JAX
    package). The gradient with respect to ``x``, ``y`` and ``theta`` is
    summed over the ``beams`` group."""
    is_stack = isinstance(proto, StackedSectorMap)
    is_sector = isinstance(proto, SectorSegmentMap)
    is_general = isinstance(proto, GeneralSegmentMap)
    if not (is_stack or is_sector or is_general
            or isinstance(proto, SegmentMap)):
        raise TypeError(f"no sharded scan for a {type(proto).__name__}")
    _, b_loc = _wedge(mesh, num_beams)
    # beam wedges are angle-contiguous, so the per-block (tile, sector)
    # routing stays local to the rank
    bb = (sector_block_width(proto, num_beams, fov)
          if is_stack or is_sector else 0)
    offs = _wedge_offsets(mesh, num_beams, fov, bb, proto.device)

    def scan(m, x, y, theta, mid=None):
        x, y, theta = sum_grad_over_beams(mesh, x, y, theta)
        ct, st = fan_cos_sin(theta, offs, theta_disc)
        if is_stack:
            return _scan_chunk_multi(m, torch.stack([x, y, theta], -1), mid,
                                     ct, st, b_loc, max_range, bb)
        xb = x[:, None].expand(ct.shape)
        yb = y[:, None].expand(ct.shape)
        if is_sector:
            r = raycast_sectors(
                m.table, m.meta, m.tiles_shape, m.tile_size, m.tile_origin,
                m.ns, x, y, xb, yb, ct, st, max_range, bb,
                sector_sweep)[:, :b_loc]
        elif is_general:
            r = raycast_general(m.params, xb, yb, ct, st, max_range)
        else:
            r = raycast_all_diff(m.params, m.sweep_meta, xb, yb, ct, st,
                                 max_range)
            if not mask_dense:
                return r
        return apply_extent_mask(r, x, y, m.extent, max_range)

    return scan


def make_sharded_scan(mesh: Mesh, segments_or_map, num_beams: int,
                      fov: float, max_range: float = 10.0,
                      map_cell: Optional[dict] = None):
    """Build ``scan(poses_local) -> ranges_local`` sharded (agents, beams)
    on the mesh.

    ``segments_or_map``: a ``maps.segments.SegmentMap`` (where the JAX
    function takes the bare (4, K) params and their ``kv`` split the port
    takes the map, which carries both: the dense kernel reads the
    real-slot bounds from its ``sweep_meta``; no extent mask, as in the
    JAX package) or a ``maps.sectors.SectorSegmentMap`` (the sector
    sweep runs unchanged inside each shard).

    ``poses_local``: the rank's (A_loc, 3) agent slab, the same on every
    rank of a ``beams`` group; returns the rank's (A_loc, B_loc) wedge.
    Differentiable: the analytic VJP inside each shard gives the partial
    pose cotangent of the wedge, and the sum over the ``beams`` group makes
    it the gradient of the whole scan (module doc).

    The map is read from ``map_cell["map"]`` at call time, as in
    ``simulator.make_scan_fn``.
    """
    if not isinstance(segments_or_map, (SegmentMap, SectorSegmentMap)):
        raise TypeError("make_sharded_scan takes a SegmentMap or a "
                        f"SectorSegmentMap, got "
                        f"{type(segments_or_map).__name__}")
    if map_cell is None:
        map_cell = {"map": segments_or_map}
    wedge = _make_wedge_scan(mesh, segments_or_map, num_beams, fov,
                             max_range, mask_dense=False)

    def scan(poses):
        return wedge(map_cell["map"], poses[:, 0], poses[:, 1], poses[:, 2])

    return scan


def make_sharded_step(mesh: Mesh, bundle, with_noise: bool = False,
                      stack=None, map_cell: Optional[dict] = None):
    """Sharded full simulation step over (agents, beams).

    Dynamics run on the rank's agent slab (every rank of a ``beams`` group
    repeats them); the scan is beam-sharded; the TTC any-beam reduction
    crosses the ``beams`` group with one all-reduce (max). Returns
    ``step(state, action, generator=None) -> StepOutput`` on local
    tensors: the state and the collision flags of the slab, the ranges of
    the slab's wedge. ``generator``: the rank's own
    (``rank_generator``), used when ``with_noise``.

    ``stack``: a ``maps.sectors.StackedSectorMap`` switches the scan to
    multitrack serving: the signature becomes ``step(state, action,
    map_ids, generator=None)`` with ``map_ids`` the slab's (A_loc,) map
    ids, and agent i scans on map ``map_ids[i]`` through the stacked sweep
    (the sweep of ``scan_poses_sectors_multi``, so the values are its).
    ``bundle`` still supplies the car, scan and sim parameters; its segmap
    is ignored.

    ``map_cell``: the map is read from ``map_cell["map"]`` at call time.
    """
    from ..simulator import advance, latch
    car, sc, sim = bundle.car, bundle.scan, bundle.sim
    num_beams = int(sc.num_beams)
    is_stack = stack is not None
    proto = stack if is_stack else bundle.segmap
    if proto is None:
        raise ValueError("sharded step needs a segment backend")
    if map_cell is None:
        map_cell = {"map": proto}
    theta_disc = int(sc.theta_discretization) if sc.use_theta_table else 0
    max_range = float(sc.max_range)
    wedge = _make_wedge_scan(mesh, proto, num_beams, float(sc.fov),
                             max_range, theta_disc)
    b0, b_loc = _wedge(mesh, num_beams)
    cosines, car_dists = (t[b0:b0 + b_loc] for t in ttc_tables(
        num_beams, float(sc.fov), car, proto.device))

    def body(state, action, mid, generator):
        new, sx, sy = advance(state, action, car, sim)
        ranges = wedge(map_cell["map"], sx, sy, new.theta, mid)
        if with_noise and generator is not None:
            ranges = add_scan_noise(ranges, generator, sc.scan_std_dev)
        # local any-beam TTC, then OR across the beam shards
        hit = check_ttc(ranges, new.velocity, cosines, car_dists,
                        sim.ttc_threshold)
        hit = all_reduce(hit.to(torch.int32), dist.ReduceOp.MAX,
                         mesh.beams_group, mesh.beams) > 0
        return latch(new, ranges, hit)

    if is_stack:
        def step(state, action, map_ids, generator=None):
            return body(state, action, map_ids, generator)
    else:
        def step(state, action, generator=None):
            return body(state, action, None, generator)
    step.map_cell = map_cell
    return step
