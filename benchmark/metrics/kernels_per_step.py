"""Device kernels (copies and fills left out) per env step of the traced
calls. Per traffic mix (``kernels_per_step.<mix>``)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["kernels"]:
        return None
    return tr["kernels"] / tr["steps"]
