"""texel_map_s: host seconds of the bake's texel map (bake/lightmap_uv.py,
bake/surface_map.py), as the Baker records it in setup_s."""


def read(ctx):
    return ctx["setup"].get("texel_map_s")
