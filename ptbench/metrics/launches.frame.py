"""launches.frame: device kernels per traced frame (torch's ops of the
integrator and the port's hand kernels; copies and fills not counted)."""

from ptbench.trace import is_kernel


def read(ctx):
    prof = ctx.get("profile")
    if ctx["step"] != "frame" or prof is None:
        return None
    n = sum(1 for name, _, _ in prof["device_ops"] if is_kernel(name))
    return n / ctx["traced_steps"] if n else None
