"""The two things a traffic mode can drive: the program (the PyTorch and
CUDA port, ``pyracecarsimulator_tpu_torch``) and the control (the plain
reference put in the program's place, computed a precision lower). A
mode's module has one function for each, named by ``kind``, that makes
its calls on that side. Both take and give states as dicts of tensors
keyed by the port's field names.
"""

from __future__ import annotations

import time

import torch

from .feed import FIELDS


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The port: its map compiled and its step built for the
    configuration. ``map_build_s``: host clock around the map's compile
    (distance field, wall geometry, tables) and its copy to the device."""

    kind = "program"

    def __init__(self, grid, config, steer_mode, device):
        import pyracecarsimulator_tpu_torch as pt
        from pyracecarsimulator_tpu_torch.maps.loader import build_track_map
        self.pt = pt
        self.device = torch.device(device)
        t0 = time.perf_counter()
        track = build_track_map(grid.occupancy_f32(), grid.resolution,
                                grid.origin, name=grid.name,
                                device=self.device)
        sim = dict(config["sim"], steer_mode=steer_mode)
        self.bundle = pt.build_sim(
            track, pt.CarParams(**config["car"]),
            pt.ScanParams(**config["scan"]), pt.SimParams(**sim),
            backend=config["backend"], device=self.device)
        sync(self.device)
        self.map_build_s = time.perf_counter() - t0
        self.step = pt.make_step_fn(self.bundle, with_noise=False)
        self.num_beams = int(config["scan"]["num_beams"])
        self.fov = float(config["scan"]["fov"])

    def car_state(self, d: dict):
        return self.pt.CarState(**{f: d[f] for f in FIELDS})

    @staticmethod
    def fields(state) -> dict:
        return {f: getattr(state, f) for f in FIELDS}


class Control:
    """The reference in the program's place at ``dtype`` (bfloat16 for a
    float32 configuration): the same closed loop, scans and steps in the
    lower precision, results handed back in float32."""

    kind = "control"

    def __init__(self, grid, config, steer_mode, device,
                 dtype=torch.bfloat16):
        from benchmark.reference import sim
        self.sim = sim
        self.device = torch.device(device)
        t0 = time.perf_counter()
        self.world = sim.World(grid, config, self.device, dtype)
        self.map_build_s = time.perf_counter() - t0
        self.steer_mode = steer_mode
        self.num_beams = int(config["scan"]["num_beams"])

    @staticmethod
    def out(state: dict) -> dict:
        return {f: (v.float() if v.is_floating_point() else v)
                for f, v in state.items()}
