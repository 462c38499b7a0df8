"""Mode ``bptt``: differentiable-simulation training. A call is one BPTT
train step over the mix's ``horizon`` steps of ``demo_train``'s policy
and loss (``core/policies.py``), Adam (``optimizer.lr``) updating the
policy, whose weights are drawn from the seed.

The check follows two train steps with the reference: the first, from
the seeded weights and a fresh optimizer (set-up's first call, through
the window's own call); and one window call drawn from the seed, from
the side's own parameters and optimizer state (moments and step count)
as they stood before it, since nothing but the program's state can
start a step that hundreds of updates came before. Both from the same
start states as the side (its chained states after the benchmark's
reset). Compared for each, the worst of the two kept: the loss
(relative gap); the gradient as the optimizer got it, worked out from
its moments before and after the step; the parameters' change; each as
the gap of the norms, leaf by leaf, against the reference's norm of that
leaf or of the median leaf, whichever is larger (leaves whose reference
gradient is under ``STILL_LEAF`` of the median leaf's left out of the
change); and the share of agents whose final state differs.
"""

from __future__ import annotations

import math
import statistics
import sys

import torch

from benchmark.core import faults, policies
from benchmark.core.checks import (STILL_LEAF, clone, leaf_gap, norms,
                                   off_state)

FAULTS = {"half_batch": faults.half_batch,
          "altered_answer": faults.doubled_weight_grad,
          "no_update": faults.no_update}


def _knobs(mix):
    return (float(mix["policy"]["speed"]), float(mix["loss"]["crash_weight"]),
            int(mix["horizon"]), float(mix["optimizer"]["lr"]))


def _weights(mix, config, gen, device):
    nb = int(config["scan"]["num_beams"])
    return {"w": float(mix["policy"]["weight_std"]) * torch.randn(
                nb, generator=gen, device=device),
            "b": torch.zeros((), device=device)}


def program(side, mix, config, gen):
    from pyracecarsimulator_tpu_torch.parallel import make_bptt_train_fn
    speed, crash_weight, horizon, lr = _knobs(mix)
    params = _weights(mix, config, gen, side.device)
    capturable = side.device.type == "cuda"
    train, init = make_bptt_train_fn(
        side.step, policies.linear_steer(speed),
        policies.clearance_crash(crash_weight), horizon, side.num_beams,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=lr,
                                              capturable=capturable))
    opt = init(params)

    def job(start):
        _, _, loss, final = train(params, opt, side.car_state(start))
        return loss, side.fields(final)

    def snapshot():
        # an optimizer that never stepped holds no state: zero moments
        out = {"params": clone(params), "m": {}, "v": {},
               "t": torch.zeros(())}
        for k, p in params.items():
            st = opt.state.get(p, {})
            for key, name in (("m", "exp_avg"), ("v", "exp_avg_sq")):
                out[key][k] = (st[name].detach().clone() if name in st
                               else torch.zeros_like(p.detach()))
            if "step" in st:
                out["t"] = st["step"].detach().clone()
        return out
    job.final = lambda out: out[1]
    job.snapshot = snapshot
    return job


def control(side, mix, config, gen):
    w, sim = side.world, side.sim
    speed, crash_weight, horizon, lr = _knobs(mix)
    held = {k: v.to(w.dtype)
            for k, v in _weights(mix, config, gen, side.device).items()}
    opt = sim.Adam(held, lr)

    def job(start):
        loss, _, after, final = sim.train_step(
            w, held, opt, start, horizon, speed, crash_weight,
            side.steer_mode)
        held.update(after)
        return loss.float(), side.out(final)

    def snapshot():
        st = opt.state()
        return {"params": clone(held), "m": st["m"], "v": st["v"],
                "t": st["t"]}
    job.final = lambda out: out[1]
    job.snapshot = snapshot
    return job


class Check:
    setup_calls = 2

    def __init__(self, mix, config):
        self.mix = mix
        self.keep = int(mix["check_calls"])
        self.recs = {}
        self._before = None

    @staticmethod
    def _followed(where, slot):
        return where == "window" or slot == 0

    def before(self, where, slot, job):
        if self._followed(where, slot):
            self._before = job.snapshot()

    def after(self, where, slot, job, start, out):
        if self._followed(where, slot):
            self.recs[(where, slot)] = {
                "before": self._before, "after": job.snapshot(),
                "start": clone(start), "loss": out[0].detach().clone(),
                "final": clone(out[1])}
            self._before = None

    def numbers(self, world) -> dict:
        from benchmark.reference import sim
        speed, crash_weight, horizon, lr = _knobs(self.mix)
        b1 = sim.Adam.B1
        seen: dict = {}
        for key in sorted(self.recs):
            rec = self.recs[key]
            bef, aft = rec["before"], rec["after"]
            p0 = {k: v.to(world.dtype) for k, v in bef["params"].items()}
            opt = sim.Adam(p0, lr, m=bef["m"], v=bef["v"],
                           t=int(float(bef["t"])))
            loss, g_ref, p_ref, final = sim.train_step(
                world, p0, opt, rec["start"], horizon, speed, crash_weight,
                self.mix["steer_mode"])
            g_side = {k: (aft["m"][k].double() - b1 * bef["m"][k].double())
                      / (1.0 - b1) for k in g_ref}
            gn = norms(g_ref)
            med = statistics.median(gn.values())
            moving = [k for k in g_ref if gn[k] >= STILL_LEAF * med]
            d_ref = {k: p_ref[k] - p0[k] for k in g_ref}
            d_side = {k: aft["params"][k].double()
                      - bef["params"][k].double() for k in g_ref}
            ref_loss = float(loss)
            found = {
                "loss_gap": abs(float(rec["loss"]) - ref_loss)
                / max(abs(ref_loss), 1e-30),
                "grad_gap": leaf_gap(g_side, g_ref),
                "update_gap": leaf_gap(d_side, d_ref, moving),
                "state_off_share": float(off_state(rec["final"], final)
                                         .double().mean())}
            print(f"followed {key[0]} call {key[1]}: " + ", ".join(
                f"{k} {v!r}" for k, v in found.items()), file=sys.stderr,
                flush=True)
            for k, v in found.items():
                seen.setdefault(k, []).append(v)
        # the worst of the followed steps; a NaN anywhere stays a NaN
        return {k: (math.nan if any(v != v for v in vs) else max(vs))
                for k, vs in seen.items()}
