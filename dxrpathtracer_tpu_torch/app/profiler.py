"""Profiler — per-pass timing with moving statistics.

The port of dxrpathtracer_tpu/app/profiler.py (the reference's GPU
timestamp-query profiler, Graphics/Profiler.{h,cpp}: StartProfile/EndProfile
around every pass, 64-frame moving stats, by-name lookup
`GPUProfileTiming`). On a CUDA device `gpu_scope` records a pair of CUDA
events on the current stream around the pass, the timestamp-query pair of
the reference: nothing waits at the scope's exit, and a pass's time is read
when the statistics are (the query-heap resolve, Profiler.cpp:240,329). On
the CPU, where torch runs each op to completion, it is a wall clock, as
`cpu_scope` is. RAII ProfileBlock/CPUProfileBlock become context managers.
"""

import contextlib
import os
import time
from collections import defaultdict, deque

import torch


class Profiler:
    WINDOW = 64  # moving-average window (Profiler.cpp keeps 64 frames)

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        # seconds, or a (start, stop) CUDA event pair not read yet
        self._samples = defaultdict(lambda: deque(maxlen=self.WINDOW))

    @contextlib.contextmanager
    def cpu_scope(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[name].append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def gpu_scope(self, name: str):
        """Times the device work enqueued inside the scope: CUDA events on
        a CUDA device, the wall clock otherwise."""
        if self.device.type != "cuda":
            with self.cpu_scope(name):
                yield
            return
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            stop.record()
            self._samples[name].append((start, stop))

    def _seconds(self, name: str) -> list[float]:
        """The window's samples of `name` in seconds; event pairs are read
        (waiting for their stop event) and replaced by their time."""
        window = self._samples[name]
        for i, v in enumerate(window):
            if isinstance(v, tuple):
                v[1].synchronize()
                window[i] = v[0].elapsed_time(v[1]) * 1e-3
        return list(window)

    def timing(self, name: str) -> float:
        """GPUProfileTiming equivalent: moving-average seconds for a pass."""
        s = self._seconds(name) if name in self._samples else []
        return sum(s) / len(s) if s else 0.0

    def stats(self):
        out = {}
        for name in list(self._samples):
            s = self._seconds(name)
            out[name] = {"avg": sum(s) / len(s), "max": max(s), "min": min(s),
                         "count": len(s)}
        return out

    def report(self) -> str:
        lines = [f"{name:32s} avg {v['avg']*1e3:8.2f} ms  max {v['max']*1e3:8.2f} ms"
                 for name, v in sorted(self.stats().items())]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of everything inside the scope (the
    CPU ops and, on a CUDA device, its kernels) and write it to
    `log_dir`/trace.json in the Chrome trace format (chrome://tracing,
    Perfetto): the PIX-capture equivalent (Profiler.cpp + PIXMarker,
    GraphicsTypes.h:516). Used by `render --profile-trace DIR`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
