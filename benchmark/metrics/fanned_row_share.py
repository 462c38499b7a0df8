"""Share of the list sweep's rows that the list kernel built from poses,
over the run: the fanned rows over the rows (``counters()["sweep"]`` of
the port's profiling module, a device counter that the kernel adds each
row to, and each row its entry from poses sweeps to ``fanned``, replayed
CUDA graphs included). 1 where every scan takes the one launch that builds
the fan, sweeps and writes the finished range; below 1 where scans ran the
rays-given sweep and the passes around it. Read from the port already
loaded in the process; None where the port counts no fanned rows or no
row was swept. Per traffic mix."""

import sys

PORT = "pyracecarsimulator_tpu_torch.utils.profiling"


def read(ctx):
    profiling = sys.modules.get(PORT)
    if profiling is None or not hasattr(profiling, "counters"):
        return None
    sweep = profiling.counters().get("sweep")
    if not sweep or not sweep.get("rows") or "fanned" not in sweep:
        return None
    return sweep["fanned"] / sweep["rows"]
