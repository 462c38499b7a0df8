"""Ray-segment pairs a ray tests in the dense sweep, on average over the
run: the dense sweep's pairs over its rays (``counters()["dense"]`` of the
port's profiling module, a device counter that the kernel adds each
block's rays and the pairs they test to, replayed CUDA graphs included).
It moves with the work the route hands the kernel (the segments of the
map compile, a cull of the dense route), not with the kernel's speed.
Read from the port already loaded in the process; None where the port has
no such counter or no ray was swept. Per traffic mix."""

import sys

PORT = "pyracecarsimulator_tpu_torch.utils.profiling"


def read(ctx):
    profiling = sys.modules.get(PORT)
    if profiling is None or not hasattr(profiling, "counters"):
        return None
    dense = profiling.counters().get("dense")
    if not dense or not dense.get("rays"):
        return None
    return dense["pairs"] / dense["rays"]
