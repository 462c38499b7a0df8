"""Real slots a ray sweeps, on average over the run: the list sweep's
slots over its rows (``counters()["sweep"]`` of the port's profiling
module, a device counter that the kernel adds each row's real slots and
the row to, replayed CUDA graphs included). It moves with the cull lists
(the map compile, the routing), not with the kernel's speed. Read from the
port already loaded in the process; None where the port has no such
counter or no row was swept. Per traffic mix."""

import sys

PORT = "pyracecarsimulator_tpu_torch.utils.profiling"


def read(ctx):
    profiling = sys.modules.get(PORT)
    if profiling is None or not hasattr(profiling, "counters"):
        return None
    sweep = profiling.counters().get("sweep")
    if not sweep or not sweep.get("rows"):
        return None
    return sweep["slots"] / sweep["rows"]
