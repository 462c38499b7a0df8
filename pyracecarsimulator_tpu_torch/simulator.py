"""Simulator facade: functional core + reference-style OO wrapper.

Counterpart of ``pyracecarsimulator_tpu/simulator.py``. ``make_step_fn``
returns one function that runs the closed-loop step for any agent batch:
input processing -> dynamics -> scan from the lidar origin -> optional
range noise -> TTC latch. ``RacecarSimulator`` is a thin stateful wrapper
over it with the reference's method names, obstacle edits included.

Backends, as in the JAX package, with its default ``"segments"``:
``"segments"`` (dense exact geometry, tile-culled on large maps),
``"segments_pallas"`` (the same geometry through the JAX package's Pallas
kernels; in the port both run the same Hopper kernels and give the same
values), ``"sectors"`` (per-(tile, angular-sector) culled exact geometry)
and its alias ``"auto"``, ``"segments_simplified"`` (contour-simplified
general segments, ~1-cell tolerance), ``"edf"`` (the reference-exact
distance-transform march), ``"edf_bilinear"`` (the bilinear march,
differentiable in the map by autograd) and ``"edf_implicit"`` (the
nearest march with the implicit-function VJP). ``make_scan_fn(...,
map_grad=True)`` gives the sector scan a d(range)/d(map) cotangent.

The JAX step is one compiled program (``jax.jit``, the map a traced
argument). The port's step runs eagerly by default, kernel by kernel from
Python; ``make_step_fn(..., graph=True)`` returns it replayed as one CUDA
graph (``utils/graph.py``), bit for bit the eager step's values. A step
carries ``step.capturable``: True on every backend, whose scans read
nothing from the host after their first call on a device (the EDF
marches run in the kernel ``csrc/edf_march.cu`` on the card, each ray
looping until it stops); a step that cannot be captured (the sharded
steps of ``parallel/mesh.py``) names its host read in ``step.host_read``.
A train step differentiates through the step, and its backward reads
nothing from the host either: the marches' gradient runs in the kernel
too (``ops/raymarch_xla.edf_march_grad``). Swapping a map through
``step.map_cell`` replaces the tensors the next eager call reads; a graph
holds the addresses of the table it was captured with, so the graphed
step watches the identity of ``map_cell["map"]`` and captures again after
a swap (the JAX facade's retrace checks, ``_swap_or_rebuild``'s shape
signature and ``jitted._cache_size``, have no other counterpart). The
rollout and the
train step capture the eager step inside their own graphs
(``parallel/rollout.py``, ``parallel/train.py``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from .config import CarParams, ScanParams, SimParams, resolve_device
from .state import CarState, zero_state, state_from_pose, set_field
from .models import dynamics as dyn
from .models.ttc import ttc_tables, check_ttc
from .maps.contours import GeneralSegmentMap, build_general_segment_map
from .maps.loader import (TrackMap, add_obstacle as _add_obs, load_builtin,
                          obstacle_cells)
from .maps.sectors import SectorSegmentMap, add_segments, build_sector_map
from .maps.segments import SegmentMap, build_segment_map
from .ops.raycast_general import scan_poses_general as _scan_general
from .ops.raycast_pallas import scan_poses_pallas as _scan_pallas
from .ops.raycast_sectors import (scan_poses_sectors as _scan_sectors,
                                  scan_poses_sectors_mapgrad)
from .ops.raycast_segments import scan_poses_segments as _scan_segments
from .ops.raymarch_diff import scan_poses_implicit as _scan_implicit
from .ops.raymarch_xla import scan_poses as _scan_edf
from .ops.noise import add_scan_noise
from .utils.graph import (CudaGraphBackend, GraphedFunction,
                          require_capturable)
from .utils.profiling import span

# backends whose map object is a compiled segment table (vs the EDF track)
_SEGMENT_BACKENDS = ("segments", "segments_simplified", "segments_pallas",
                     "sectors", "auto")
_EDF_BACKENDS = ("edf", "edf_bilinear", "edf_implicit")


class StepOutput(NamedTuple):
    """Observation bundle from one simulation step."""

    ranges: Any        # (..., num_beams) lidar ranges [m]
    collision: Any     # (...,) bool — latched collision flag
    state: Any         # CarState after the step


class SimBundle(NamedTuple):
    """Everything a step function reads."""

    track: TrackMap
    # None for the EDF backends, whose map object is the track
    segmap: Union[SegmentMap, SectorSegmentMap, GeneralSegmentMap, None]
    car: CarParams
    scan: ScanParams
    sim: SimParams
    backend: str = "segments"   # resolved backend ("auto" never stored)


def _check_backend(backend: str):
    if backend not in _SEGMENT_BACKENDS + _EDF_BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; choose one of "
            f"{', '.join(_SEGMENT_BACKENDS + _EDF_BACKENDS)}")


def _map_args(track: TrackMap):
    """The host occupancy and geometry every map compile takes."""
    return (track.occupancy.cpu().numpy(), track.resolution,
            (track.origin_x, track.origin_y))


def build_sim(track_or_name, car: CarParams = None, scan: ScanParams = None,
              sim: SimParams = None, backend: str = "segments",
              tile_size: Optional[float] = None,
              sector_ns: int = 16, sector_headroom: int = 0,
              device=None) -> SimBundle:
    """Load or accept a map and compile everything the step needs on the
    host, then place the tensors on ``device``. ``device=None`` is the
    CUDA card (``config.default_device``, which raises where there is
    none); pass ``device="cpu"`` to run on the CPU.

    ``backend``: one of the module doc's; "auto" resolves to "sectors",
    the faster exact backend on the H100 on both bundled maps (the
    measurement stands beside the code).
    The EDF backends need no compiled geometry (``segmap`` is None).
    ``tile_size``: culling tile edge in meters; None = per-backend default
    (4.0 for the dense backends, 2.0 for the sector backend, whose parallax
    pad shrinks with the tile).
    """
    _check_backend(backend)
    if backend == "auto":
        # Decided on the H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
        # phase 24, 4096 agents x 1080 beams), with the host out of the
        # step: a graphed rollout step takes 0.49 ms on "sectors" against
        # 0.93 ms on "segments" on levine, whose map "segments" leaves
        # untiled, so that every ray is swept against all 82 segments (the
        # dense sweep's work counter, ops/sweeps.DENSE_COUNTS; the
        # benchmark's levine-segments rollout cell: 0.88 ms of device time
        # a step), and 0.69 against 0.76 ms on berlin, whose sector lists
        # hold 192 real slots a ray where its map tiles hold 881 (the list
        # sweep's counter, ops/sweeps.SWEEP_COUNTS). Eagerly both are bound
        # by the host's launch rate (2.2-3.9 ms a step either way). Values
        # are equal on every exact backend. (The JAX package picks
        # "sectors" for a TPU v5e reason of its own.)
        backend = "sectors"
    device = resolve_device(device)
    track = (load_builtin(track_or_name, device=device)
             if isinstance(track_or_name, str)
             else track_or_name.to(device))
    car = car or CarParams()
    scan = scan or ScanParams()
    sim = sim or SimParams()
    kw = dict(max_range=float(scan.max_range),
              real_hw=(track.height, track.width), device=device)
    segmap = None
    if backend == "sectors":
        segmap = build_sector_map(
            *_map_args(track),
            tile_size=tile_size if tile_size is not None else 2.0,
            ns=sector_ns, headroom=sector_headroom, **kw)
    elif backend == "segments_simplified":
        segmap = build_general_segment_map(
            *_map_args(track),
            tile_size=tile_size if tile_size is not None else 4.0, **kw)
    elif backend in ("segments", "segments_pallas"):
        segmap = build_segment_map(
            *_map_args(track),
            tile_size=tile_size if tile_size is not None else 4.0, **kw)
    return SimBundle(track=track, segmap=segmap, car=car, scan=scan,
                     sim=sim, backend=backend)


def _origin(track: TrackMap):
    """The map origin as a (2,) float32 tensor on the track's device."""
    return torch.tensor([track.origin_x, track.origin_y],
                        dtype=torch.float32, device=track.edf.device)


def make_scan_fn(bundle: SimBundle, backend: Optional[str] = None,
                 map_cell: Optional[dict] = None,
                 map_grad: bool = False,
                 agent_chunk: Optional[int] = None) -> Callable[[Any], Any]:
    """Returns ``scan(poses) -> ranges`` for poses (..., 3), noiseless.
    The segment backends are differentiable in the poses (analytic VJP),
    "edf_bilinear" and "edf_implicit" in the poses and the map.

    ``backend=None`` uses the backend the bundle was built with. The map
    (segment table, or the track for the EDF backends) is read from
    ``map_cell["map"]`` at every call, so a caller may swap in another
    map. ``agent_chunk`` is forwarded to ``scan_poses_sectors``.

    ``map_grad=True`` (sector backend only) returns ``scan(poses, edf) ->
    ranges`` instead: values equal the sector scan's bit for bit, and
    autograd reaches ``edf`` through the implicit-function map cotangent
    at each hit (``ops/raycast_sectors.scan_poses_sectors_mapgrad``). Pass
    ``bundle.track.edf`` or any EDF of the same boundary.
    """
    backend = backend or bundle.backend
    _check_backend(backend)
    sc = bundle.scan
    kw = dict(num_beams=sc.num_beams, fov=sc.fov, max_range=sc.max_range,
              theta_discretization=(sc.theta_discretization
                                    if sc.use_theta_table else 0))
    track = bundle.track
    bounds = (track.height, track.width)
    if map_grad:
        if backend != "sectors":
            raise ValueError(
                "map_grad=True is the sector backend's hybrid path; "
                f"backend={backend!r} either cannot attach the implicit "
                "map cotangent or (edf_bilinear/edf_implicit) is already "
                "differentiable in the map")
        if not isinstance(bundle.segmap, SectorSegmentMap):
            raise ValueError("bundle was not built with the sector backend")
        if map_cell is None:
            map_cell = {"map": bundle.segmap}
        org = _origin(track)
        return lambda poses, edf: scan_poses_sectors_mapgrad(
            map_cell["map"], edf, track.resolution, org, poses,
            eps=sc.ray_tracing_epsilon, bounds_hw=bounds, **kw)
    if backend in _SEGMENT_BACKENDS:
        if bundle.segmap is None:
            raise ValueError("bundle built without a segment backend")
        if map_cell is None:
            map_cell = {"map": bundle.segmap}
        sectors = backend in ("sectors", "auto")
        if sectors != isinstance(bundle.segmap, SectorSegmentMap):
            raise ValueError(
                f"backend={backend!r} does not match the bundle's map type "
                f"{type(bundle.segmap).__name__}; build the bundle with "
                f"build_sim(backend={backend!r})")
        if sectors:
            return lambda poses: _scan_sectors(map_cell["map"], poses,
                                               agent_chunk=agent_chunk, **kw)
        if backend == "segments_pallas":
            if not isinstance(bundle.segmap, SegmentMap):
                raise ValueError(
                    "backend='segments_pallas' needs an exact SegmentMap "
                    "(build_sim(backend='segments_pallas')), but this "
                    f"bundle carries {type(bundle.segmap).__name__} "
                    "geometry")
            return lambda poses: _scan_pallas(map_cell["map"], poses, **kw)
        # "segments" and "segments_simplified": the map type decides
        if isinstance(bundle.segmap, GeneralSegmentMap):
            return lambda poses: _scan_general(map_cell["map"], poses, **kw)
        return lambda poses: _scan_segments(map_cell["map"], poses, **kw)

    if map_cell is None:
        map_cell = {"map": track}
    org = _origin(track)
    march = dict(eps=sc.ray_tracing_epsilon, max_iters=sc.max_march_iters,
                 bounds_hw=bounds, **kw)
    if backend == "edf_implicit":
        return lambda poses: _scan_implicit(
            map_cell["map"].edf, track.resolution, org, poses, **march)
    interp = "bilinear" if backend == "edf_bilinear" else sc.interp
    return lambda poses: _scan_edf(map_cell["map"].edf, track.resolution,
                                   org, poses, interp=interp, **march)


def advance(state: CarState, action, car: CarParams, sim: SimParams):
    """Input processing and one dynamics update (reference ``drive()`` +
    ``compute_accel``, then ``update_pose()``). Returns ``(new_state, sx,
    sy)``: the state before the scan and the lidar origin, which sits
    ``scan_distance_to_base_link`` ahead of the base link."""
    v_des, steer_des = action
    with span("step.dynamics"):
        accel, steer_vel = dyn.process_input(
            v_des, steer_des, state, car, kp=sim.speed_kp,
            steer_mode=sim.steer_mode, steer_kp=sim.steer_kp)
        if sim.dynamics == "st":
            new = dyn.st_step(state, accel, steer_vel, car, sim.dt)
        elif sim.dynamics == "ks":
            new = dyn.ks_step(state, accel, steer_vel, car, sim.dt)
        elif sim.dynamics == "ackermann":
            new = dyn.ackermann_step(state, v_des, steer_des, car, sim.dt)
        else:
            raise ValueError(f"unknown dynamics {sim.dynamics!r}")
        new = dyn.apply_standstill(state, new)
        sx = new.x + car.scan_distance_to_base_link * torch.cos(new.theta)
        sy = new.y + car.scan_distance_to_base_link * torch.sin(new.theta)
    return new, sx, sy


def latch(new: CarState, ranges, hit) -> StepOutput:
    """TTC collision -> latch (reference ``checkCollision`` + ``stop()``):
    a car that hit, now or earlier, stands still."""
    latched = new.collision | hit
    zero = torch.zeros_like(new.velocity)
    out_state = set_field(
        new,
        velocity=torch.where(latched, zero, new.velocity),
        steer_angle=torch.where(latched, zero, new.steer_angle),
        angular_velocity=torch.where(latched, zero, new.angular_velocity),
        slip_angle=torch.where(latched, zero, new.slip_angle),
        collision=latched)
    return StepOutput(ranges=ranges, collision=latched, state=out_state)


def make_step_fn(bundle: SimBundle, backend: Optional[str] = None,
                 with_noise: bool = True,
                 agent_chunk: Optional[int] = None,
                 graph: bool = False) -> Callable:
    """Build the closed-loop simulation step.

    Returns ``step(state, action, generator=None) -> StepOutput``; action
    is ``(v_des, steer_des)`` with shapes broadcastable to the state batch,
    and ``generator`` (a ``torch.Generator`` on the map's device) drives
    the range noise when ``with_noise``. ``step.map_cell["map"]`` holds the
    map the scan reads (the segment table, or the track for the EDF
    backends). ``step.capturable`` says whether the step can be captured
    in a CUDA graph (module doc); where it cannot, ``step.host_read`` says
    why.

    ``graph=True`` returns the step replayed as one CUDA graph: the same
    values, forward only (no autograd graph), ``step.map_cell`` kept and
    watched, ``step.eager`` the step it captured. It raises for a bundle
    that is not on a CUDA device.
    """
    backend = backend or bundle.backend
    map_cell = {"map": (bundle.segmap if backend in _SEGMENT_BACKENDS
                        else bundle.track)}
    scan_fn = make_scan_fn(bundle, backend, map_cell,
                           agent_chunk=agent_chunk)
    car, sc, sim = bundle.car, bundle.scan, bundle.sim
    cosines, car_dists = ttc_tables(sc.num_beams, sc.fov, car,
                                    bundle.track.edf.device)
    if sim.dynamics not in ("st", "ks", "ackermann"):
        raise ValueError(f"unknown dynamics {sim.dynamics!r}")

    def step(state: CarState, action, generator=None) -> StepOutput:
        # 1-2. input processing and the dynamics update
        new, sx, sy = advance(state, action, car, sim)
        # 3. scan from the lidar origin
        with span("step.scan"):
            ranges = scan_fn(torch.stack([sx, sy, new.theta], dim=-1))
        if with_noise and generator is not None:
            # unclamped, matching the reference/oracle noise model
            ranges = add_scan_noise(ranges, generator, sc.scan_std_dev)
        # 4. TTC collision -> latch
        with span("step.ttc"):
            hit = check_ttc(ranges, new.velocity, cosines, car_dists,
                            sim.ttc_threshold)
            return latch(new, ranges, hit)

    step.map_cell = map_cell        # swap maps here
    step.capturable = True
    step.host_read = None
    return _graphed_step(step, bundle.track.edf.device) if graph else step


def _graphed_step(step, device):
    """``step`` replayed as a CUDA graph that watches the step's map."""
    require_capturable(step)
    CudaGraphBackend().check(device)
    map_cell = step.map_cell
    graphed = GraphedFunction(step, watch=lambda: (map_cell["map"],),
                              name="step")

    def graphed_step(state: CarState, action, generator=None) -> StepOutput:
        return graphed(state, action, generator)

    graphed_step.map_cell = map_cell
    graphed_step.capturable = True
    graphed_step.host_read = None
    graphed_step.eager = step
    graphed_step.graphed = graphed      # .captures, .replays, .release()
    return graphed_step


class RacecarSimulator:
    """Reference-style OO facade over the functional core; the state lives
    in ``self.state`` with an arbitrary agent batch shape, on ``device``
    (``None``: the CUDA card, as ``build_sim``)."""

    def __init__(self, track_or_name="levine", car_params: CarParams = None,
                 scan_params: ScanParams = None, sim_params: SimParams = None,
                 backend: str = "segments", batch_shape=(), seed: int = 0,
                 with_noise: bool = True, device=None, graph: bool = False):
        """``graph=True`` replays the step as a CUDA graph
        (``make_step_fn``); each ``add_obstacle`` and ``clear_obstacles``
        swaps the map and costs one capture, so the default stays eager."""
        device = resolve_device(device)
        # sector_headroom as in the JAX facade: slack in the cull-list
        # capacity for the obstacle edits
        self.bundle = build_sim(track_or_name, car_params, scan_params,
                                sim_params, backend=backend,
                                sector_headroom=8, device=device)
        # clear_obstacles swaps these back in, no rebuild
        self._pristine_track = self.bundle.track
        self._pristine_segmap = self.bundle.segmap
        self.device = device
        self.backend = self.bundle.backend
        self.with_noise = with_noise
        self.batch_shape = tuple(batch_shape)
        self._step = make_step_fn(self.bundle, self.backend, with_noise,
                                  graph=graph)
        # the scan shares the step's cell: one swap serves both
        self._scan = make_scan_fn(self.bundle, self.backend,
                                  self._step.map_cell)
        self.state = zero_state(self.batch_shape, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        z = torch.zeros(self.batch_shape, device=self.device)
        self._action = (z, z)
        self._last: Optional[StepOutput] = None

    def _full(self, v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=self.device).expand(
                                   self.batch_shape).clone()

    # -- reference API ----------------------------------------------------
    def drive(self, desired_speed, desired_steer):
        """Set the drive command (reference ``drive``/``setInput``)."""
        self._action = (self._full(desired_speed), self._full(desired_steer))

    def update_pose(self):
        """Advance one dt: dynamics + scan + TTC (reference updatePose)."""
        out = self._step(self.state, self._action,
                         self.generator if self.with_noise else None)
        self.state = out.state
        self._last = out
        return out

    step = update_pose

    def run_scan(self):
        """Scan at the current pose without stepping (reference runScan)."""
        d = self.bundle.car.scan_distance_to_base_link
        s = self.state
        poses = torch.stack([s.x + d * torch.cos(s.theta),
                             s.y + d * torch.sin(s.theta), s.theta], dim=-1)
        r = self._scan(poses)
        if self.with_noise:
            r = add_scan_noise(r, self.generator,
                               self.bundle.scan.scan_std_dev)
        return r

    get_scan = run_scan

    def check_collision(self):
        """Latched collision flag(s) (reference checkCollision)."""
        if self._last is None:
            return self.state.collision
        return self._last.collision

    def stop(self):
        """Zero motion state, keep pose (reference stop())."""
        z = torch.zeros(self.batch_shape, device=self.device)
        self.state = set_field(self.state, velocity=z, steer_angle=z,
                               angular_velocity=z, slip_angle=z)
        self._action = (z, z)
        self._last = None

    def set_pose(self, x, y, theta=0.0):
        """Teleport + clear motion and the collision latch (reference
        set-pose)."""
        self.state = state_from_pose(self._full(x), self._full(y),
                                     self._full(theta))
        self._last = None

    reset = set_pose

    def get_state(self) -> CarState:
        return self.state

    def set_state(self, state: CarState):
        self.state = state.to(self.device)
        self._last = None

    def _swap_map(self):
        """Point the step and the scan at the bundle's current map."""
        self._step.map_cell["map"] = (
            self.bundle.segmap if self.backend in _SEGMENT_BACKENDS
            else self.bundle.track)

    def _build_segmap(self, track: TrackMap):
        """Recompile the current backend's geometry from ``track`` (None
        for the EDF backends)."""
        if self.backend not in _SEGMENT_BACKENDS:
            return None
        old = self.bundle.segmap
        kw = dict(max_range=float(self.bundle.scan.max_range),
                  real_hw=(track.height, track.width), device=self.device)
        if self.backend == "sectors":
            sec = dict(tile_size=old.tile_size, ns=old.ns,
                       block_half=old.block_half, **kw)
            try:
                # keep the previous capacity split while it fits
                return build_sector_map(
                    *_map_args(track),
                    kvh=(old.kv_sec, old.table.shape[2] - old.kv_sec), **sec)
            except ValueError:      # capacity overflow: auto-size instead
                return build_sector_map(*_map_args(track), **sec)
        build = (build_general_segment_map
                 if self.backend == "segments_simplified"
                 else build_segment_map)
        return build(*_map_args(track), tile_size=old.tile_size, **kw)

    def _obstacle_box_segments(self, track: TrackMap, x, y, size):
        """The 4 boundary segments of the rasterized obstacle box, in the
        cell snapping of ``maps.loader.add_obstacle``."""
        res = track.resolution
        i0, i1, j0, j1 = obstacle_cells(track, x, y, size)
        ox, oy = track.origin_x, track.origin_y
        return np.asarray([
            (ox + j0 * res, oy + i0 * res, oy + i1 * res, 1.0),
            (ox + j1 * res, oy + i0 * res, oy + i1 * res, 1.0),
            (oy + i0 * res, ox + j0 * res, ox + j1 * res, 0.0),
            (oy + i1 * res, ox + j0 * res, ox + j1 * res, 0.0)],
            np.float64)

    def add_obstacle(self, x, y, size=0.2):
        """Rasterize an obstacle and update the EDF and the geometry
        (reference addObstacle; a host path at episode frequency). On the
        sector backend the cull lists are appended to in their headroom
        (``maps.sectors.add_segments``, ray-exact), with a full rebuild
        when the headroom runs out; the other segment backends rebuild."""
        track = _add_obs(self.bundle.track, x, y, size)
        if self.backend == "sectors":
            try:
                segmap = add_segments(
                    self.bundle.segmap,
                    self._obstacle_box_segments(self.bundle.track, x, y,
                                                size))
            except ValueError:
                segmap = self._build_segmap(track)
        else:
            segmap = self._build_segmap(track)
        self.bundle = self.bundle._replace(track=track, segmap=segmap)
        self._swap_map()

    def clear_obstacles(self):
        """Restore the pristine map (reference clearObstacles): a swap of
        the cached pristine geometry, no rebuild."""
        self.bundle = self.bundle._replace(track=self._pristine_track,
                                           segmap=self._pristine_segmap)
        self._swap_map()

    # camelCase aliases matching the reference lineage's method names
    updatePose = update_pose
    runScan = run_scan
    getScan = run_scan
    checkCollision = check_collision
    getState = get_state
    setState = set_state
    setPose = set_pose
    addObstacle = add_obstacle
    clearObstacles = clear_obstacles
    setInput = drive
