"""What decides ``correct``, the parts every mode shares: the tolerances
inside a share, the comparison of two states, the gap of two trees of
tensors, and the judgement of each number against its limit from
``limits/<cell>.json``. What a mode compares, and how the reference
follows its calls, is the mode's (``modes/<mode>.py``)."""

from __future__ import annotations

import statistics

import torch

TOL_RANGE_M = 1e-3
TOL_POSE_M = 1e-3
TOL_ANGLE = 1e-3
TOL_STATE = 1e-3
# leaves whose reference gradient is below this share of the median
# leaf's move by round-off alone under Adam: left out of the change
STILL_LEAF = 1e-3


def clone(d: dict) -> dict:
    return {k: v.detach().clone() for k, v in d.items()}


def off_state(side_final: dict, ref_final: dict) -> torch.Tensor:
    """(A,) bool: agents whose final state differs."""
    off = torch.zeros_like(ref_final["collision"])
    for f in ("x", "y"):
        off |= (side_final[f].double() - ref_final[f].double()).abs() \
            > TOL_POSE_M
    for f in ("theta", "velocity", "steer_angle", "angular_velocity",
              "slip_angle"):
        off |= (side_final[f].double() - ref_final[f].double()).abs() \
            > TOL_STATE
    for f in ("st_dyn", "collision"):
        off |= side_final[f] != ref_final[f]
    return off


def norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tree.items()}


def leaf_gap(side: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap of norms, against the reference's norm of the
    leaf or of the median leaf, whichever is larger."""
    ref_n = norms(ref)
    med = statistics.median(ref_n.values())
    side_n = norms(side)
    worst = 0.0
    for k in (keep if keep is not None else ref):
        worst = max(worst, abs(side_n[k] - ref_n[k])
                    / max(ref_n[k], med, 1e-30))
    return worst


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number at or under its
    limit, and finite."""
    rows = [(k, float(v), float(limits[k])) for k, v in numbers.items()]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows
