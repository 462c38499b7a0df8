"""Device time per env step of every kernel outside the layer "Scan
kernels": the elementwise passes and VJPs around the scan, the
optimizer. Per traffic mix."""

LAYER = "Scan kernels"


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    rest = sum(v for k, v in tr["layer_s"].items() if k != LAYER)
    return rest * 1e3 / tr["steps"] if rest > 0 else None
