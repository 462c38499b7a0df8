"""Host clock around the program's map compile (``build_track_map`` and
``build_sim``: the distance field, the wall geometry, the tables, their
copy to the device)."""


def read(ctx):
    return ctx["spans"].get("map_build_s")
