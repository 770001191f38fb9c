"""setup_s: seconds from the start of the harness to the first timed step:
importing torch and the port, loading its kernel libraries, the scene, its
tables, screens and sky, the warm-up steps (the first builds the sun grid)."""


def read(ctx):
    return ctx["setup_s"]
