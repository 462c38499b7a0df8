"""The one traffic generator: a closed loop with one client, driven by a
mix's data file (``traffic/<name>.json``) and the mode that file names
(``modes/<mode>.py``, found by name).

The client waits for each call before it sends the next. The cars start
standing at seeded free poses; the state is chained from call to call,
and before each call every car whose latch is set is put back at the
next pose of a seeded pool (``feed.Resetter``). What one call is, and
what of it the reference checks, is the mode's.

A mode's module holds:

- ``program(side, mix, config, gen)`` and ``control(side, mix, config,
  gen)``: the call on each side (``sides.Program``, ``sides.Control``),
  a callable ``job(start) -> out`` with ``job.final(out)``, the state
  the next call starts from; ``gen`` is the seeded generator, for what
  the mode draws;
- ``Check(mix, config)``: ``setup_calls`` (at least 2: the first
  captures, the second times a replay), ``keep`` (window calls sampled,
  from the seed), ``before(where, slot, job)`` and ``after(where, slot,
  job, start, out)`` around each set-up call (``where`` "setup", ``slot``
  its index) and each sampled window call ("window", its slot), and
  ``numbers(world)``: the compared numbers, by name, once the window has
  closed and the program is freed;
- ``FAULTS``: the faults its cells can have, each a planter of
  ``core/faults.py``;
- optionally ``work(config, mix)``: agent-steps a call (by default agents
  x the mix's ``horizon``).

A call ends when the caller has its result (a synchronize).
"""

from __future__ import annotations

import torch

from . import feed
from .sides import sync


def default_work(config: dict, mix: dict) -> int:
    return int(config["agents"]) * int(mix["horizon"])


class ClosedLoop:
    def __init__(self, mix: dict, config: dict, grid, side, seed: int,
                 device, mode):
        self.mix, self.config, self.grid, self.side = mix, config, grid, side
        self.mode = mode
        self.seed, self.device = int(seed), torch.device(device)
        self.agents = int(config["agents"])
        self.horizon = int(mix["horizon"])
        self.work = getattr(mode, "work", default_work)(config, mix)

    def setup(self):
        mix = self.mix
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        cells = feed.free_cells(self.grid, float(mix["start_margin_m"]),
                                self.device)
        start = feed.sample_poses(self.grid, cells, self.agents, gen)
        pool = feed.sample_poses(self.grid, cells,
                                 self.agents * int(mix["reset_pool_factor"]),
                                 gen)
        self.state = feed.state_at(start)
        self.reset = feed.Resetter(pool)
        self.job = getattr(self.mode, self.side.kind)(self.side, mix,
                                                      self.config, gen)

    def call(self):
        """One call; returns (start state, the job's outputs)."""
        start = self.reset(self.state)
        out = self.job(start)
        sync(self.device)
        self.state = self.job.final(out)
        return start, out
