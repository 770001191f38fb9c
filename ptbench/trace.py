"""Counters and the device trace of a `--trace 1` run.

The spans are the program's own (dxrpathtracer_tpu_torch/app/profiler.py,
read by ptbench/spans.py from one program-traced step); this file reads
the card-only stretch before it. A wrapper around the gather kernel's
launch records each call's ids and table width, whose bytes are counted
after the traced stretch. Counters are the port's own KERNEL_LAUNCHES
dicts and ints, read before and after the window.

`device_summary` turns a profile of the card alone into what the
per-layer readers read: every device operation with its interval, and the
union of those intervals (the device's busy time; a union rather than a
sum, so overlapping streams are not counted twice).
"""

import contextlib
import re

import torch

# The port's hand kernels (dxrpathtracer_tpu_torch/csrc/*.cu) by the names
# it gave their __global__ functions.
TRAVERSAL_KERNELS = ("warp_kernel", "thread_kernel", "packet_kernel",
                     "sungrid_kernel", "proxy_kernel", "proxy_closest_kernel",
                     "cut_kernel")
HAND_KERNELS = TRAVERSAL_KERNELS + ("gather_rows", "revalidate_kernel",
                                    "raster_kernel")


def sync(device):
    """Wait for the device's work (nothing to wait for on the CPU)."""
    if str(device).startswith("cuda"):
        torch.cuda.synchronize(device)


def kernel_base_name(name: str) -> str:
    """The function's name in a device event's name: `void (anonymous
    namespace)::packet_kernel<false, true, 0>(float const*, ...)` ->
    packet_kernel."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    m = re.match(r"\s*([\w:]+)", s)
    return m.group(1).split("::")[-1] if m else name


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def device_s(ctx, pick) -> float:
    """Seconds of the traced kernels whose base name `pick` accepts."""
    return sum(e - s for n, s, e in ctx["profile"]["device_ops"]
               if is_kernel(n) and pick(kernel_base_name(n)))


# (module, counter) of the port's launch counters
COUNTERS = (
    ("dxrpathtracer_tpu_torch.accel.traverse", "KERNEL_LAUNCHES"),
    ("dxrpathtracer_tpu_torch.accel.packet", "KERNEL_LAUNCHES"),
    ("dxrpathtracer_tpu_torch.accel.sunspace", "KERNEL_LAUNCHES"),
    ("dxrpathtracer_tpu_torch.accel.sunspace", "ALPHA_KERNEL_LAUNCHES"),
    ("dxrpathtracer_tpu_torch.accel.proxy", "KERNEL_LAUNCHES"),
    ("dxrpathtracer_tpu_torch.accel.history", "KERNEL_LAUNCHES"),
    ("dxrpathtracer_tpu_torch.render.swraster", "KERNEL_LAUNCHES"),
    ("dxrpathtracer_tpu_torch.accel.gather", "KERNEL_LAUNCHES"),
)


class GatherRecorder:
    """Wraps the gather kernel's launch; while `on`, keeps each call's ids
    and the table's row width and rows."""

    def __init__(self):
        from dxrpathtracer_tpu_torch.accel import gather
        self.calls = []
        self.on = False
        inner = gather._launch_kernel

        def launch(table, idx):
            if self.on:
                self.calls.append((idx, table.shape[0], table.shape[1],
                                   table.element_size()))
            return inner(table, idx)
        gather._launch_kernel = launch

    def bytes_needed(self) -> int:
        """Each call's distinct rows read, its ids read and its rows
        written, each byte once."""
        total = 0
        for idx, _rows, width, esize in self.calls:
            distinct = int(torch.unique(idx).numel())
            total += (distinct * width * esize + idx.numel() * 4
                      + idx.numel() * width * esize)
        return total


def read_counters() -> dict:
    import importlib
    out = {}
    for mod_name, name in COUNTERS:
        val = getattr(importlib.import_module(mod_name), name)
        short = mod_name.rsplit(".", 1)[-1]
        if isinstance(val, dict):
            for k, v in val.items():
                out[f"{short}.{k}"] = int(v)
        else:
            out[f"{short}.{name.lower()}"] = int(val)
    return out


def counter_deltas(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


@contextlib.contextmanager
def profiled(spans: bool):
    """A torch profiler of the card's activity; with `spans`, of the host's
    too (the program's spans among it), which slows the host."""
    acts = []
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    if spans or not acts:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def _union(intervals):
    """Total length and merged list of [start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


NAME_CHARS = 120  # of a device operation's name in the breakdown


def _by_kernel(ops) -> list:
    """[(base name, launches, seconds)] of the traced operations, the most
    time first."""
    acc = {}
    for n, s, e in ops:
        k = kernel_base_name(n) if is_kernel(n) else n
        c, t = acc.get(k, (0, 0.0))
        acc[k] = (c + 1, t + (e - s))
    return sorted(((k, c, t) for k, (c, t) in acc.items()),
                  key=lambda r: -r[2])


def _device_ops(prof):
    """[(name, start s, end s)] of a profile's device operations; the
    card's copies of host annotations are not operations."""
    dev_type = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
            for e in prof.events()
            if e.device_type == dev_type
            and not getattr(e, "is_user_annotation", False)]


def device_summary(prof, window_s: float, top: int = 10) -> dict:
    """What the per-layer readers read from a profile of the card alone
    over a stretch of `window_s` seconds on the host clock (the traced
    steps and the synchronise that ends them; the card is idle before it,
    since each step ends in one): {window_s, busy_s (the union of the
    operations' intervals), device_ops [(name, start, end)], top_ops
    [(name, seconds)], ops_by_kernel}."""
    ops = _device_ops(prof)
    busy, _ = _union([(s, e) for _, s, e in ops])
    by_op = {}
    for n, s, e in ops:
        by_op[n] = by_op.get(n, 0.0) + (e - s)
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])
    return {"window_s": window_s, "busy_s": busy, "device_ops": ops,
            "top_ops": [(n[:NAME_CHARS], t) for n, t in top_ops[:top]],
            "ops_by_kernel": _by_kernel(ops)}
