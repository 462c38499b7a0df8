"""Ray-segment pairs a ray tests in the general-segment sweep (the
"segments_simplified" backend), on average over the run: the sweep's pairs
over its rays (``counters()["general"]`` of the port's profiling module, a
device counter that the kernel adds each block's rays and the pairs they
test to, each ray its list's real slots up to the last, replayed CUDA
graphs included). It moves with the work the map compile hands the kernel
(the simplified segments, the tile lists), not with the kernel's speed.
Read from the port already loaded in the process; None where the port has
no such counter or no ray was swept. Per traffic mix."""

import sys

PORT = "pyracecarsimulator_tpu_torch.utils.profiling"


def read(ctx):
    profiling = sys.modules.get(PORT)
    if profiling is None or not hasattr(profiling, "counters"):
        return None
    general = profiling.counters().get("general")
    if not general or not general.get("rays"):
        return None
    return general["pairs"] / general["rays"]
