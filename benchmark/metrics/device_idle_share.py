"""The device's idle share of a call as the window runs it: 1 - (the
device's busy time a call, the union of its activity intervals over the
traced calls, divided by their number) / (the mean host time of the
window's untraced calls). The traced calls' own host time is not the
divisor: the profiler stretches the host's part of a call (CUPTI at each
graph launch) and not the device's work. Per traffic mix
(``device_idle_share.<mix>``)."""


def read(ctx):
    tr = ctx["trace"]
    if (tr is None or tr["busy_s"] <= 0 or not tr["calls"]
            or not tr.get("untraced_call_s")):
        return None
    return 1.0 - tr["busy_s"] / tr["calls"] / tr["untraced_call_s"]
