"""Profiler — per-pass timing with moving statistics, and the program's
tracer.

The port of dxrpathtracer_tpu/app/profiler.py (the reference's GPU
timestamp-query profiler, Graphics/Profiler.{h,cpp}: StartProfile/EndProfile
around every pass, 64-frame moving stats, by-name lookup
`GPUProfileTiming`). On a CUDA device `gpu_scope` records a pair of CUDA
events on the current stream around the pass, the timestamp-query pair of
the reference: nothing waits at the scope's exit, and a pass's time is read
when the statistics are (the query-heap resolve, Profiler.cpp:240,329). On
the CPU, where torch runs each op to completion, it is a wall clock, as
`cpu_scope` is. RAII ProfileBlock/CPUProfileBlock become context managers.

The tracer: `span(name)` marks a stage of the frame or the bake,
`count(name, n)` counts an event under the innermost open span, and
`tracing()` switches both on for its scope. Untraced, `span` returns one
shared no-op context manager after one check of a module flag, and `count`
returns at once. Traced, each span opens
`torch.profiler.record_function("dxrpt." + name)`, so the spans lie on the
card's kernels' timeline in any torch.profiler profile taken around them,
and the records count each span path's calls and counts; span times are
read from the profile, not kept here. On a CUDA device `tracing()` also
puts torch in its sync debug mode ("warn") and counts each "synchronizing
CUDA operation" torch reports (a blocking copy between host and card,
`.item()`, `nonzero()`, ...) as `host_sync` under the innermost span. An
explicit `torch.cuda.synchronize()` is not among them, the launchers of
csrc/*.cu synchronise nothing, and torch calls the mode a prototype that
may miss some synchronizing operations: the count is a floor. The state
is the process's: trace from one thread. Each pass scope of `Profiler` is
a span of its own name too.
"""

import contextlib
import functools
import os
import sys
import time
import warnings
from collections import defaultdict, deque

import torch

SPAN_PREFIX = "dxrpt."  # of the spans' record_function names
HOST_SYNC = "host_sync"  # the counter of synchronizing CUDA operations
SYNC_WARNING = "called a synchronizing CUDA operation"  # torch's message


class _NoSpan:
    """The one span of an untraced run: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Trace:
    """What one `tracing()` scope records: {span path: {"calls": n,
    "counts": {name: n}}}, a path being the open spans' names joined by
    "/" ("" outside every span), and the stack of open paths."""

    def __init__(self):
        self.records = {}
        self.paths = [""]

    def entry(self, path: str) -> dict:
        rec = self.records.get(path)
        if rec is None:
            rec = self.records[path] = {"calls": 0, "counts": {}}
        return rec


_trace = None  # the open tracing() scope's _Trace; None when untraced


class _Span:
    __slots__ = ("_trace", "_name", "_range")

    def __init__(self, trace: _Trace, name: str):
        self._trace, self._name = trace, name

    def __enter__(self):
        t = self._trace
        parent = t.paths[-1]
        path = f"{parent}/{self._name}" if parent else self._name
        t.paths.append(path)
        t.entry(path)["calls"] += 1
        self._range = torch.profiler.record_function(SPAN_PREFIX + self._name)
        self._range.__enter__()

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self._trace.paths.pop()
        return False


def span(name: str):
    """A context manager around one stage of the work: NO_SPAN untraced,
    a record_function range and an entry in the records under tracing()."""
    if _trace is None:
        return NO_SPAN
    return _Span(_trace, name)


def spanned(name: str):
    """Decorator: each call of the function runs in span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1):
    """Adds n to counter `name` of the innermost open span; nothing
    untraced."""
    t = _trace
    if t is None:
        return
    counts = t.entry(t.paths[-1])["counts"]
    counts[name] = counts.get(name, 0) + n


def _sync_counter(show):
    """A warnings.showwarning that counts torch's synchronizing-operation
    warnings as HOST_SYNC and hands every other warning to `show`."""
    def showwarning(message, category, filename, lineno, file=None,
                    line=None):
        if str(message).startswith(SYNC_WARNING):
            count(HOST_SYNC)
        else:
            show(message, category, filename, lineno, file, line)
    return showwarning


@contextlib.contextmanager
def tracing():
    """Spans and counts on inside the scope; yields the records ({span
    path: {"calls", "counts"}}), complete when the scope ends. On a CUDA
    device torch's sync debug mode is "warn" inside; the previous mode,
    warning filters and tracing state come back at the end."""
    global _trace
    prev, mode = _trace, None
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.showwarning = _sync_counter(warnings.showwarning)
        if torch.cuda.is_available():
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        _trace = _Trace()
        try:
            yield _trace.records
        finally:
            _trace = prev
            if mode is not None:
                torch.cuda.set_sync_debug_mode(mode)


def sync_lines(records: dict) -> list[str]:
    """One line per span path with host syncs, the most first."""
    rows = sorted(((rec["counts"].get(HOST_SYNC, 0), path, rec["calls"])
                   for path, rec in records.items()), reverse=True)
    return [f"{n:6d} host syncs in {calls:5d} calls of {path or '(no span)'}"
            for n, path, calls in rows if n]


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
            with span(name):
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
            with span(name):
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
    CPU ops, the program's spans and, on a CUDA device, its kernels) with
    tracing() on, and write it to `log_dir`/trace.json in the Chrome trace
    format (chrome://tracing, Perfetto), then the host syncs by span path
    to stderr: the PIX-capture equivalent (Profiler.cpp + PIXMarker,
    GraphicsTypes.h:516). Used by `render --profile-trace DIR`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with tracing() as records:
            yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    total = sum(r["counts"].get(HOST_SYNC, 0) for r in records.values())
    print(f"# host syncs by span, {total} in all:", file=sys.stderr)
    for line in sync_lines(records):
        print(f"#   {line}", file=sys.stderr)
