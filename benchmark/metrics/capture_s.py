"""Host clock of the first call (warm-up on a side stream and the CUDA
graph's capture) less that of the second (one replay)."""


def read(ctx):
    return ctx["spans"].get("capture_s")
