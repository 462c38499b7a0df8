"""Simulator facade: functional core + reference-style OO wrapper.

Counterpart of ``pyracecarsimulator_tpu/simulator.py``. ``make_step_fn``
returns one function that runs the closed-loop step for any agent batch:
input processing -> dynamics -> scan from the lidar origin -> optional
range noise -> TTC latch. ``RacecarSimulator`` is a thin stateful wrapper
over it with the reference's method names.

Ported backends, with the JAX package's default, ``"segments"``:
``"segments"`` (dense exact geometry, tile-culled on large maps),
``"segments_pallas"`` (the same geometry through the JAX package's Pallas
kernels; in the port both run the same Hopper kernels and give the same
values), ``"sectors"`` (per-(tile, angular-sector) culled exact geometry)
and its alias ``"auto"``. The scan of every ported backend is
differentiable in the poses (analytic VJP). The simplified-geometry and
EDF backends, the obstacle edits and ``map_grad`` raise
NotImplementedError, each naming its ROADMAP item. PyTorch runs eagerly,
so swapping a map through ``step.map_cell`` simply replaces the tensors
the next call reads; there is no compiled program to keep.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from .config import CarParams, ScanParams, SimParams
from .state import CarState, zero_state, state_from_pose, set_field
from .models import dynamics as dyn
from .models.ttc import ttc_tables, check_ttc
from .maps.loader import TrackMap, load_builtin
from .maps.sectors import SectorSegmentMap, build_sector_map
from .maps.segments import SegmentMap, build_segment_map
from .ops.raycast_pallas import scan_poses_pallas as _scan_pallas
from .ops.raycast_sectors import scan_poses_sectors as _scan_sectors
from .ops.raycast_segments import scan_poses_segments as _scan_segments
from .ops.noise import add_scan_noise

# backends of the JAX package that the port does not run yet, with the
# ROADMAP.md queue-1 item that ports each
_UNPORTED_BACKENDS = {"segments_simplified": 12, "edf": 15,
                      "edf_bilinear": 15, "edf_implicit": 15}
_BACKENDS = ("segments", "segments_pallas", "sectors", "auto")


class StepOutput(NamedTuple):
    """Observation bundle from one simulation step."""

    ranges: Any        # (..., num_beams) lidar ranges [m]
    collision: Any     # (...,) bool — latched collision flag
    state: Any         # CarState after the step


class SimBundle(NamedTuple):
    """Everything a step function reads."""

    track: TrackMap
    segmap: Union[SegmentMap, SectorSegmentMap]
    car: CarParams
    scan: ScanParams
    sim: SimParams
    backend: str = "segments"   # resolved backend ("auto" never stored)


def _check_backend(backend: str):
    if backend in _UNPORTED_BACKENDS:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet: ROADMAP.md queue 1, "
            f"item {_UNPORTED_BACKENDS[backend]}")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; the port runs "
                         f"{', '.join(_BACKENDS)}")


def build_sim(track_or_name, car: CarParams = None, scan: ScanParams = None,
              sim: SimParams = None, backend: str = "segments",
              tile_size: Optional[float] = None,
              sector_ns: int = 16, sector_headroom: int = 0,
              device="cpu") -> SimBundle:
    """Load or accept a map and compile everything the step needs on the
    host, then place the tensors on ``device``.

    ``backend``: "segments" (dense exact geometry, no angular culling),
    "segments_pallas" (the same geometry and values through the kernel
    entry points of ``ops/raycast_pallas.py``), "sectors" (per-(tile,
    angular-sector) culled exact geometry) or "auto" (alias for
    "sectors").
    ``tile_size``: culling tile edge in meters; None = per-backend default
    (4.0 for the dense backends, 2.0 for the sector backend, whose parallax
    pad shrinks with the tile).
    """
    _check_backend(backend)
    if backend == "auto":
        backend = "sectors"
    track = (load_builtin(track_or_name, device=device)
             if isinstance(track_or_name, str)
             else track_or_name.to(device))
    car = car or CarParams()
    scan = scan or ScanParams()
    sim = sim or SimParams()
    args = (track.occupancy.cpu().numpy(), track.resolution,
            (track.origin_x, track.origin_y))
    kw = dict(max_range=float(scan.max_range),
              real_hw=(track.height, track.width), device=device)
    if backend == "sectors":
        segmap = build_sector_map(
            *args, tile_size=tile_size if tile_size is not None else 2.0,
            ns=sector_ns, headroom=sector_headroom, **kw)
    else:
        segmap = build_segment_map(
            *args, tile_size=tile_size if tile_size is not None else 4.0,
            **kw)
    return SimBundle(track=track, segmap=segmap, car=car, scan=scan,
                     sim=sim, backend=backend)


def make_scan_fn(bundle: SimBundle, backend: Optional[str] = None,
                 map_cell: Optional[dict] = None,
                 map_grad: bool = False,
                 agent_chunk: Optional[int] = None) -> Callable[[Any], Any]:
    """Returns ``scan(poses) -> ranges`` for poses (..., 3), noiseless and
    differentiable in the poses.

    ``backend=None`` uses the backend the bundle was built with. The map
    is read from ``map_cell["map"]`` at every call, so a caller may swap in
    another map. ``agent_chunk`` is forwarded to ``scan_poses_sectors``.
    """
    backend = backend or bundle.backend
    _check_backend(backend)
    if map_grad:
        raise NotImplementedError(
            "map_grad (the dRange/dMap path) is not ported yet: ROADMAP.md "
            "queue 1, item 14")
    if map_cell is None:
        map_cell = {"map": bundle.segmap}
    sectors = backend in ("sectors", "auto")
    if sectors != isinstance(bundle.segmap, SectorSegmentMap):
        raise ValueError(
            f"backend={backend!r} does not match the bundle's map type "
            f"{type(bundle.segmap).__name__}; build the bundle with "
            f"build_sim(backend={backend!r})")
    if backend == "segments_pallas" and not isinstance(bundle.segmap,
                                                       SegmentMap):
        raise ValueError(
            "backend='segments_pallas' needs an exact SegmentMap "
            "(build_sim(backend='segments_pallas'))")
    sc = bundle.scan
    kw = dict(num_beams=sc.num_beams, fov=sc.fov, max_range=sc.max_range,
              theta_discretization=(sc.theta_discretization
                                    if sc.use_theta_table else 0))
    if sectors:
        return lambda poses: _scan_sectors(map_cell["map"], poses,
                                           agent_chunk=agent_chunk, **kw)
    scan = _scan_pallas if backend == "segments_pallas" else _scan_segments
    return lambda poses: scan(map_cell["map"], poses, **kw)


def make_step_fn(bundle: SimBundle, backend: Optional[str] = None,
                 with_noise: bool = True,
                 agent_chunk: Optional[int] = None) -> Callable:
    """Build the closed-loop simulation step.

    Returns ``step(state, action, generator=None) -> StepOutput``; action
    is ``(v_des, steer_des)`` with shapes broadcastable to the state batch,
    and ``generator`` (a ``torch.Generator`` on the map's device) drives
    the range noise when ``with_noise``.
    """
    map_cell = {"map": bundle.segmap}
    scan_fn = make_scan_fn(bundle, backend, map_cell,
                           agent_chunk=agent_chunk)
    car, sc, sim = bundle.car, bundle.scan, bundle.sim
    cosines, car_dists = ttc_tables(sc.num_beams, sc.fov, car,
                                    bundle.segmap.device)
    dynamics = sim.dynamics
    if dynamics not in ("st", "ks", "ackermann"):
        raise ValueError(f"unknown dynamics {dynamics!r}")

    def step(state: CarState, action, generator=None) -> StepOutput:
        v_des, steer_des = action
        # 1. input processing (reference drive() + compute_accel)
        accel, steer_vel = dyn.process_input(
            v_des, steer_des, state, car, kp=sim.speed_kp,
            steer_mode=sim.steer_mode, steer_kp=sim.steer_kp)
        # 2. dynamics update (reference update_pose())
        if dynamics == "st":
            new = dyn.st_step(state, accel, steer_vel, car, sim.dt)
        elif dynamics == "ks":
            new = dyn.ks_step(state, accel, steer_vel, car, sim.dt)
        else:
            new = dyn.ackermann_step(state, v_des, steer_des, car, sim.dt)
        new = dyn.apply_standstill(state, new)
        # 3. scan from the lidar origin (scan_distance_to_base_link ahead)
        sx = new.x + car.scan_distance_to_base_link * torch.cos(new.theta)
        sy = new.y + car.scan_distance_to_base_link * torch.sin(new.theta)
        ranges = scan_fn(torch.stack([sx, sy, new.theta], dim=-1))
        if with_noise and generator is not None:
            # unclamped, matching the reference/oracle noise model
            ranges = add_scan_noise(ranges, generator, sc.scan_std_dev)
        # 4. TTC collision -> latch (reference checkCollision + stop())
        hit = check_ttc(ranges, new.velocity, cosines, car_dists,
                        sim.ttc_threshold)
        latched = new.collision | hit
        zero = torch.zeros_like(new.velocity)
        out_state = set_field(
            new,
            velocity=torch.where(latched, zero, new.velocity),
            steer_angle=torch.where(latched, zero, new.steer_angle),
            angular_velocity=torch.where(latched, zero,
                                         new.angular_velocity),
            slip_angle=torch.where(latched, zero, new.slip_angle),
            collision=latched)
        return StepOutput(ranges=ranges, collision=latched, state=out_state)

    step.map_cell = map_cell        # swap maps here
    return step


class RacecarSimulator:
    """Reference-style OO facade over the functional core; the state lives
    in ``self.state`` with an arbitrary agent batch shape, on ``device``."""

    def __init__(self, track_or_name="levine", car_params: CarParams = None,
                 scan_params: ScanParams = None, sim_params: SimParams = None,
                 backend: str = "segments", batch_shape=(), seed: int = 0,
                 with_noise: bool = True, device="cpu"):
        # sector_headroom as in the JAX facade: slack in the cull-list
        # capacity for the obstacle edits
        self.bundle = build_sim(track_or_name, car_params, scan_params,
                                sim_params, backend=backend,
                                sector_headroom=8, device=device)
        self.device = torch.device(device)
        self.backend = self.bundle.backend
        self.with_noise = with_noise
        self.batch_shape = tuple(batch_shape)
        self._step = make_step_fn(self.bundle, self.backend, with_noise)
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

    def add_obstacle(self, x, y, size=0.2):
        raise NotImplementedError(
            "add_obstacle (maps.sectors.add_segments and the dense map "
            "rebuild) is not ported yet: ROADMAP.md queue 1, item 5b")

    def clear_obstacles(self):
        raise NotImplementedError(
            "clear_obstacles pairs with add_obstacle, not ported yet: "
            "ROADMAP.md queue 1, item 5b")

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
