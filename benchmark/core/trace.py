"""The profiler arithmetic of a traced run, frozen here: device activity
of a fixed number of calls inside the window, read from
``torch.profiler``'s events.

- busy: the union of the device's activity intervals (kernels, copies
  and fills) inside the traced calls; the window is the host clock
  around the same calls, each of which ends in a synchronize, so the
  device's activity lies inside it. The profiler lengthens the host's
  part of a call (CUPTI at each graph launch), never the device's work,
  so the device's busy time a call is set beside the mean host time of
  the window's untraced calls too (``untraced_call_s``);
- kernels: device kernels (not copies or fills), counted and summed by
  the layer their name falls in (``kernels/*.json``), per env step;
- the breakdown: the device operations that took most time, and the
  longest idle gaps between device intervals, labelled by the innermost
  host operation running at the gap's middle.
"""

from __future__ import annotations

import time

_COPIES = ("memcpy", "memset")


def _is_device(evt) -> bool:
    """A device operation; the profiler's step annotation, which it also
    draws on the device's timeline across the whole step, is none."""
    return ("cuda" in str(getattr(evt, "device_type", "")).lower()
            and not evt.name.startswith("ProfilerStep"))


def _span(evt):
    tr = evt.time_range
    return float(tr.start) * 1e-6, float(tr.end) * 1e-6


def union(intervals):
    """Total length of the union of (start, end) intervals, and the merged
    intervals in order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def layer_of(name: str, layers: dict):
    for layer, patterns in layers.items():
        if any(p in name for p in patterns):
            return layer
    return None


def traced_calls(call, n: int, device):
    """Run ``call`` once under the profiler's warm-up (its events are
    dropped: CUPTI's first sight of a CUDA graph costs that call extra),
    then ``n`` times traced; returns (window_s of the ``n`` calls, their
    events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n,
                                   repeat=1)) as prof:
        call()
        prof.step()
        t0 = time.perf_counter()
        for i in range(n):
            call()
            if i == n - 1:
                window = time.perf_counter() - t0
            prof.step()
    return window, prof.events()


def summarize(events, window_s: float, calls: int, steps: int,
              layers: dict, untraced_call_s=None, top: int = 10) -> dict:
    """What the per-layer readers read from a traced window of ``calls``
    calls and ``steps`` env steps (module doc)."""
    dev = [e for e in events if _is_device(e)]
    host = [e for e in events if not _is_device(e)
            and not e.name.startswith("ProfilerStep")]
    spans = [_span(e) for e in dev]
    busy, merged = union(spans)
    by_name: dict = {}
    by_layer: dict = {}
    kernels = 0
    for e, (s, t) in zip(dev, spans):
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
        if any(c in e.name.lower() for c in _COPIES):
            continue
        kernels += 1
        layer = layer_of(e.name, layers)
        by_layer[layer] = by_layer.get(layer, 0.0) + (t - s)
    gaps: dict = {}
    host_spans = [(_span(e), e.name) for e in host]
    for (s0, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        inner = [(b - a, name) for (a, b), name in host_spans
                 if a <= mid <= b]
        label = min(inner)[1] if inner else "host idle"
        gaps[label] = gaps.get(label, 0.0) + (s1 - e0)
    rank = lambda d: [[k, v] for k, v in
                      sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"window_s": window_s, "busy_s": busy, "calls": calls,
            "untraced_call_s": untraced_call_s, "steps": steps,
            "kernels": kernels, "layer_s": by_layer,
            "device_ops": rank(by_name), "idle_gaps": rank(gaps)}
