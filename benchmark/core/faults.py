"""Faults planted in the program underneath a run, to show that the check
catches them: each a function that patches the port through pytest's or
a plain ``monkeypatch`` (``setattr``). A mode (``modes/<mode>.py``) lists
under ``FAULTS`` which of them stand for the faults its cells can have:

- ``frozen_step``: the step returns its car's state unchanged;
- ``half_batch``: half of the batch left out, its scans the other half's
  (and so a train step's mean taken over the rest);
- ``longer_first_scan``: the first agent's scan reads 5 cm long at every
  step, an answer altered where it is produced;
- ``doubled_weight_grad``: the gradient of the weights (the policy's one
  vector) doubled as the optimizer gets it;
- ``no_update``: the optimizer's step leaves the parameters unchanged.
"""

from __future__ import annotations

import torch


def _simulator():
    import pyracecarsimulator_tpu_torch.simulator as simulator
    return simulator


def _frozen(state, action, car, sim):
    from pyracecarsimulator_tpu_torch.state import set_field
    d = car.scan_distance_to_base_link
    return (set_field(state, velocity=state.velocity + 0.0),
            state.x + d * torch.cos(state.theta),
            state.y + d * torch.sin(state.theta))


def frozen_step(setattr_):
    setattr_(_simulator(), "advance", _frozen)


def half_batch(setattr_):
    simulator = _simulator()
    latch = simulator.latch

    def broken(new, ranges, hit):
        h = ranges.shape[0] // 2
        return latch(new, torch.cat([ranges[:h], ranges[:h],
                                     ranges[2 * h:]]), hit)
    setattr_(simulator, "latch", broken)


def longer_first_scan(setattr_):
    simulator = _simulator()
    latch = simulator.latch

    def broken(new, ranges, hit):
        bump = torch.zeros_like(ranges)
        bump[0] = 0.05
        return latch(new, ranges + bump, hit)
    setattr_(simulator, "latch", broken)


def doubled_weight_grad(setattr_):
    step = torch.optim.Adam.step

    def broken(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.dim() == 1 and p.grad is not None:
                    p.grad.mul_(2.0)
        return step(self, closure)
    setattr_(torch.optim.Adam, "step", broken)


def no_update(setattr_):
    setattr_(torch.optim.Adam, "step", lambda self, closure=None: None)
