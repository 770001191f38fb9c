"""Per-layer readers shared by a metric's files for each kind of step: a
`ptbench/metrics/<name>.<step>.py` file binds one of these to a step kind
(`read = readers.idle_pct("bake")`), which is the STEP of a mode's file
(ptbench/modes/), not its name: a mode added later whose step is one
displayed frame reads as `frame` does. Each reader returns None where the
run's step is of another kind or the run was not traced, so the metric is
left out of the line there."""

from .trace import HAND_KERNELS, TRAVERSAL_KERNELS, device_s


def _traced(ctx, step):
    return ctx["step"] == step and ctx.get("profile") is not None


def idle_pct(step: str):
    """The share of the traced stretch's wall time in which no operation
    ran on the card: 1 - (union of the device operations' intervals) /
    (the stretch's host interval), in percent."""
    def read(ctx):
        if not _traced(ctx, step):
            return None
        prof = ctx["profile"]
        if prof["window_s"] <= 0 or prof["busy_s"] <= 0:
            return None
        return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
    return read


def _kernel_ms(step: str, pick):
    """Device milliseconds per traced step of the kernels `pick` takes."""
    def read(ctx):
        if not _traced(ctx, step):
            return None
        s = device_s(ctx, pick)
        return s * 1e3 / ctx["traced_steps"] if s > 0 else None
    return read


def traversal_ms(step: str):
    """The port's traversal kernels (csrc/traverse.cu, packet.cu,
    sungrid.cu, screen.cu), by the names the port gave them."""
    return _kernel_ms(step, lambda name: name in TRAVERSAL_KERNELS)


def shading_ms(step: str):
    """Every kernel that is not a hand kernel of the port's csrc/ (torch's
    ops: texture and cubemap taps, NEE, the vertex update, raygen,
    accumulation)."""
    return _kernel_ms(step, lambda name: name not in HAND_KERNELS)


def gather_roofline_pct(step: str):
    """The row gather's (csrc/gather.cu) share of its memory roofline over
    the traced steps: the bytes its calls need (each call's distinct rows
    read, its ids read, its rows written, each byte once) over the H100's
    3.35 TB/s, over the gather kernel's device time, in percent."""
    def read(ctx):
        if not _traced(ctx, step):
            return None
        s = device_s(ctx, lambda name: name == "gather_rows")
        if s <= 0 or not ctx.get("gather_bytes"):
            return None
        return 100.0 * ctx["gather_bytes"] / ctx["hbm_bytes_per_s"] / s
    return read
