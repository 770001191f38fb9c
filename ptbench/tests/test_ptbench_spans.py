"""The program-traced step (ptbench/spans.py) and the readers of
host_syncs.* and taps_ms.*: None untraced or where the step is of the
other kind, whatever the mode's name, the right sums on a synthetic table;
the table and idle gaps of a tiny cell's step on the CPU, and a tiny
traced run that reads them; on the card, one `nonzero()` inside a span is
one host sync there."""

import pytest
import torch

from ptbench import run as R
from ptbench import spans

from ._tiny import cell_parts, run_tiny


def _row(calls=1, device_ms=0.0, syncs=0):
    return {"calls": calls, "host_ms": 1.0, "host_self_ms": 0.5,
            "device_ms": device_ms, "device_self_ms": device_ms,
            "kernels": 1, "syncs": syncs}


FRAME_ROWS = {
    "frame": _row(syncs=1),
    "frame/RenderRayTracing/frame.constants": _row(syncs=6),
    "frame/RenderRayTracing/paths/shade": _row(2, 30.0),
    "frame/RenderRayTracing/paths/shade/shade.taps": _row(10, 40.0, 0),
    "frame/RenderRayTracing/paths/shade/shade.sample": _row(2, 5.0, 2),
    "frame/RenderRayTracing/paths/trace/traverse.any/shade.taps":
        _row(1, 2.5),
    "": _row(0, syncs=100),  # outside the frame: not the frame's
}
BAKE_ROWS = {
    "bake": _row(2, syncs=0),
    "bake/bake.slab/bake.rays": _row(16, 1.0, 32),
    "bake/bake.slab/paths/shade/shade.taps": _row(80, 800.0, 0),
}


@pytest.mark.parametrize("name,step,rows,want", [
    ("host_syncs.frame", "frame", FRAME_ROWS, 9.0),
    ("taps_ms.frame", "frame", FRAME_ROWS, 42.5),
    ("host_syncs.bake", "bake", BAKE_ROWS, 16.0),
    ("taps_ms.bake", "bake", BAKE_ROWS, 400.0)])
def test_reader_sums_its_stage(name, step, rows, want):
    read = R.load_metric(name).read
    assert read({"mode": step, "step": step,
                 "program_spans": rows}) == pytest.approx(want)
    # a mode of another name whose step is of this kind reads the same
    assert read({"mode": "turntable", "step": step,
                 "program_spans": rows}) == pytest.approx(want)
    other = "bake" if step == "frame" else "frame"
    assert read({"mode": step, "step": other, "program_spans": rows}) is None
    assert read({"mode": step, "step": step}) is None  # untraced
    assert read({"mode": step, "step": step, "program_spans": {}}) is None


def test_taps_reader_needs_a_taps_span():
    read = R.load_metric("taps_ms.frame").read
    rows = {"frame": _row(), "frame/paths": _row(device_ms=3.0)}
    assert read({"step": "frame", "program_spans": rows}) is None
    assert R.load_metric("host_syncs.frame").read(
        {"step": "frame", "program_spans": rows}) == 0.0


@pytest.mark.parametrize("cell,stage", [("pt1080-sponza", "frame"),
                                        ("bake4096-sponza", "bake")])
def test_program_step_on_a_tiny_cell(cell, stage):
    """The table of a tiny cell's program-traced step on the CPU: the
    stage's spans with their calls and host times (no device times here),
    and every idle gap named by a program span or OUTSIDE."""
    _, _, config, traffic, _ = cell_parts(cell)
    runner = R.load_mode(config["mode"]).Runner(
        config, traffic, R.load_scene(traffic), 5, "cpu")
    runner.setup()
    steps = runner.steps
    prof, records, host_s = spans.program_step(runner)
    rows, gaps = spans.tabulate(prof, records)
    assert runner.steps == steps + 1  # one step of the runner's own
    assert host_s > 0 and rows[stage]["calls"] == 1
    taps = [r for p, r in rows.items() if p.endswith("/shade.taps")]
    assert sum(r["calls"] for r in taps) == 10  # 5 maps, 2 vertices, 1 slab
    for path, r in rows.items():
        assert path == stage or path.startswith(stage + "/")
        assert 0.0 <= r["host_self_ms"] <= r["host_ms"] + 1e-9
        assert r["device_ms"] == 0.0 and r["syncs"] == 0
    assert rows[stage]["host_ms"] <= host_s * 1e3
    assert gaps == []  # no device operations on the CPU: no timeline
    text = spans.lines(rows, gaps)
    assert len(text) == len(rows) + 2


@pytest.mark.parametrize("cell,step,seconds", [
    ("pt1080-sponza", "frame", 4.0), ("bake4096-sponza", "bake", 8.0)])
def test_a_traced_run_reads_the_program_step(cell, step, seconds,
                                              monkeypatch):
    """A tiny `--trace 1` run takes one program-traced step, puts its table
    in ctx["program_spans"], reads its cell's two new metrics from it, and
    leaves the program's tracing off; an untraced run has no table."""
    from dxrpathtracer_tpu_torch.app import profiler

    seen = []
    read_metrics = R.read_metrics

    def spy(entries, ctx):
        seen.append(([m["name"] for m in entries], ctx))
        return read_metrics(entries, ctx)

    monkeypatch.setattr(R, "read_metrics", spy)
    called = []
    load_metric = R.load_metric

    def load(name):
        mod = load_metric(name)
        called.append(name)
        return mod

    monkeypatch.setattr(R, "load_metric", load)
    result, _ = run_tiny(cell, trace=1, seconds=seconds)
    assert result["correct"] is True
    (names, ctx), = seen
    assert ctx["step"] == step and ctx["mode"] == step
    rows = ctx["program_spans"]
    assert rows[step]["calls"] == 1
    assert any(p.endswith("/shade.taps") for p in rows)
    new = {f"host_syncs.{step}", f"taps_ms.{step}"}
    assert new <= set(names) and new <= set(called)
    # the CPU counts no host syncs and runs nothing on a card
    assert result["metrics"][f"host_syncs.{step}"]["value"] == 0.0
    assert f"taps_ms.{step}" not in result["metrics"]
    assert result["breakdown"]["idle_gaps"] == []
    assert profiler.span("frame") is profiler.NO_SPAN  # tracing off again

    seen.clear()
    run_tiny(cell, trace=0)
    (_, ctx), = seen
    assert "program_spans" not in ctx and ctx["step"] == step


def test_program_step_refuses_tracing_left_on(monkeypatch):
    """Where the program's tracing were still on after the traced step,
    the steps after it would run traced: the harness stops."""
    import contextlib

    from dxrpathtracer_tpu_torch.app import profiler

    @contextlib.contextmanager
    def leaky():
        profiler._trace = profiler._Trace()
        yield profiler._trace.records

    class Runner:
        device = "cpu"

        def step(self):
            pass

    monkeypatch.setattr(profiler, "tracing", leaky)
    try:
        with pytest.raises(RuntimeError, match="tracing is still on"):
            spans.program_step(Runner())
    finally:
        profiler._trace = None


@pytest.mark.card
def test_nonzero_in_a_span_is_one_host_sync(card):
    from dxrpathtracer_tpu_torch.app import profiler as P
    x = torch.arange(1024, device=card) % 3 == 0
    torch.cuda.synchronize()
    with P.tracing() as records:
        with P.span("frame"):
            with P.span("shade"):
                idx = x.nonzero()
            y = x.float() * 2.0  # no sync
    torch.cuda.synchronize()
    assert idx.shape[0] == 342 and y.shape == x.shape
    assert records["frame/shade"]["counts"] == {P.HOST_SYNC: 1}
    assert records["frame"]["counts"] == {}
    assert torch.cuda.get_sync_debug_mode() == 0


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


class _Event:
    """The fields of a profiler event that spans.Timeline reads; times in
    microseconds, as the profiler's."""

    def __init__(self, name, start, end, cuda=False, cid=0, parent=None):
        import torch
        self.name, self.id, self.cpu_parent = name, cid, parent
        self.time_range = _Range(start, end)
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.cpu_children, self.is_user_annotation = [], False
        if parent is not None:
            parent.cpu_children.append(self)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_table_puts_each_kernel_under_its_launch_span():
    """A kernel counts under the span its launch call was made in, even
    where it runs after the span ended (the hand kernels' ctypes launches
    have no torch op around them); idle gaps go to the span the host was
    in when they began."""
    frame = _Event("dxrpt.frame", 0, 1000)
    taps = _Event("dxrpt.shade.taps", 100, 200, parent=frame)
    op = _Event("aten::index", 110, 150, parent=taps)
    walk = _Event("dxrpt.traverse.any", 300, 400, parent=frame)
    events = [frame, taps, op, walk,
              _Event("cudaLaunchKernel", 120, 125, cid=7, parent=op),
              _Event("cudaLaunchKernel", 310, 315, cid=8, parent=walk),
              _Event("cudaLaunchKernel", 1100, 1105, cid=9),
              _Event("vectorized_gather_kernel", 130, 330, cuda=True, cid=7),
              _Event("warp_kernel", 400, 700, cuda=True, cid=8),
              _Event("Memcpy HtoD", 1200, 1210, cuda=True, cid=9),
              _Event("dxrpt.traverse.any", 330, 390, cuda=True)]
    events[-1].is_user_annotation = True  # the card's copy of a span
    timeline = spans.Timeline(_Prof(events))
    records = {"frame": {"calls": 1, "counts": {spans.HOST_SYNC: 2}},
               "": {"calls": 0, "counts": {spans.HOST_SYNC: 1}}}
    rows = spans.table(timeline, records)
    assert set(rows) == {"frame", "frame/shade.taps", "frame/traverse.any",
                         spans.OUTSIDE}
    assert rows["frame/shade.taps"]["device_self_ms"] == pytest.approx(0.2)
    assert rows["frame/traverse.any"]["kernels"] == 1
    assert rows["frame"]["device_ms"] == pytest.approx(0.5)
    assert rows["frame"]["device_self_ms"] == 0.0
    assert rows["frame"]["host_self_ms"] == pytest.approx(0.8)
    assert rows["frame"]["syncs"] == 2
    assert rows[spans.OUTSIDE]["syncs"] == 1
    assert rows[spans.OUTSIDE]["kernels"] == 0  # a copy is no kernel
    gaps = dict(spans.idle_gaps(timeline))
    # idle: [0, 130) and [700, 1200) begin in frame, [330, 400) in the
    # walk's span
    assert gaps == pytest.approx({"frame": 630e-6,
                                  "frame/traverse.any": 70e-6})
