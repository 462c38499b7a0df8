"""Share of the dense sweep's rays that the dense kernel built from poses,
over the run: the fanned rays over the rays (``counters()["dense"]`` of
the port's profiling module, a device counter that the kernel adds each
block's rays to, and each block its entry from poses sweeps to
``fanned``, replayed CUDA graphs included). 1 where every dense scan takes
the one launch that builds the fan, sweeps and writes the finished range;
below 1 where scans ran the rays-given sweep and the passes around it.
Read from the port already loaded in the process; None where the port's
dense counter has no ``fanned`` column or no ray was swept. Per traffic
mix."""

import sys

PORT = "pyracecarsimulator_tpu_torch.utils.profiling"


def read(ctx):
    profiling = sys.modules.get(PORT)
    if profiling is None or not hasattr(profiling, "counters"):
        return None
    dense = profiling.counters().get("dense")
    if not dense or not dense.get("rays") or "fanned" not in dense:
        return None
    return dense["fanned"] / dense["rays"]
