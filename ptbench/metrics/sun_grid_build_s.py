"""sun_grid_build_s: host seconds of the session's last sun-grid build
(accel/sunspace.py, during set-up), as the session records it."""


def read(ctx):
    return ctx["setup"].get("sun_grid_build_s")
