"""Slots a ray sweeps after the list kernel's wedge cull, on average over
the run: the kept slots over the rows (``counters()["sweep"]`` of the
port's profiling module, a device counter that the kernel adds each row's
kept slots and the row to, replayed CUDA graphs included). Beside
``sweep_slots_per_ray`` (the lists' real slots, the cull's input) it
says how much of each list the rows still test. Read from the port
already loaded in the process; None where the port counts no kept slots
or no row was swept. Per traffic mix."""

import sys

PORT = "pyracecarsimulator_tpu_torch.utils.profiling"


def read(ctx):
    profiling = sys.modules.get(PORT)
    if profiling is None or not hasattr(profiling, "counters"):
        return None
    sweep = profiling.counters().get("sweep")
    if not sweep or not sweep.get("rows") or "kept" not in sweep:
        return None
    return sweep["kept"] / sweep["rows"]
