"""Device time per env step of the kernels of the layer "Scan kernels"
(``kernels/*.json``). Per traffic mix."""

LAYER = "Scan kernels"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["layer_s"].get(LAYER):
        return None
    return tr["layer_s"][LAYER] * 1e3 / tr["steps"]
