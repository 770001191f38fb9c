"""The program's own spans in one profiled step.

dxrpathtracer_tpu_torch/app/profiler.py marks each stage of the frame and
the bake with a span (`record_function("dxrpt." + name)` while its
`tracing()` is on) and counts the host syncs that torch reports under the
innermost open span. `program_step` takes one step of a mode's runner with
that tracing on, profiled on host and card; every `--trace 1` run of
ptbench/run.py takes it after the card-only stretch, and `tabulate` reduces
it once the window has closed. `table` joins the profile's
span events with the tracer's records: per span path, its calls, host ms,
host ms outside its child spans, the device ms and kernels of the work
launched inside it (each device operation by the host time of the launch
call the profiler correlates it with, so it counts under the span whose
host code launched it, whenever it ran; torch's ops and the hand kernels'
ctypes launches alike) and the host syncs. `idle_gaps` names each idle
stretch of the card's timeline by the innermost program span the host was
in when it began: the breakdown's `idle_gaps`. The readers of
`host_syncs.*` and `taps_ms.*` (`syncs_per_step`, `device_ms_per_step`)
read the table from ctx["program_spans"], in a run whose mode's STEP is
theirs (ctx["step"]).

    python3 -m ptbench.spans --workload <cell> --seed <n> [--steps 10]
        [--out FILE]

runs a cell's set-up on the card, times `--steps` untraced steps, one step
profiled on host and card, and one program-traced step (profiled so too),
and prints the table, the idle gaps, what the four readers read from it and
the three steps' host ms: what tracing costs.
"""

import argparse
import bisect
import json
import statistics
import sys
import time
from pathlib import Path

from .trace import _union, is_kernel, profiled

PREFIX = "dxrpt."  # the program's spans (app/profiler.py's SPAN_PREFIX)
HOST_SYNC = "host_sync"  # the program's counter of synchronizing operations
OUTSIDE = "(outside)"  # an idle gap that began outside every program span
METRICS = ("host_syncs.frame", "taps_ms.frame", "host_syncs.bake",
           "taps_ms.bake")


def _path(event) -> str:
    """The names of the program spans around `event`, itself included,
    outermost first, joined by "/"."""
    names = []
    while event is not None:
        if event.name.startswith(PREFIX):
            names.append(event.name[len(PREFIX):])
        event = event.cpu_parent
    return "/".join(reversed(names))


def _child_spans(event) -> list:
    """The program spans nearest below `event` in the host's call tree."""
    out = []
    for child in event.cpu_children:
        out += ([child] if child.name.startswith(PREFIX)
                else _child_spans(child))
    return out


class Timeline:
    """A profile's program spans on the host (`span_events`; `spans`:
    [(start s, end s, path)] by start), its device operations [(name,
    start s, end s, correlation id)] and the host time of each launch call
    (the CUDA runtime and driver calls, by the correlation id they share
    with the operation they launched)."""

    def __init__(self, prof):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        self.span_events, self.ops, self.launches = [], [], {}
        for e in prof.events():
            t = e.time_range
            if e.device_type == cuda:
                if not (e.name.startswith(PREFIX)
                        or getattr(e, "is_user_annotation", False)):
                    self.ops.append((e.name, t.start / 1e6, t.end / 1e6,
                                     e.id))
            elif e.name.startswith(PREFIX):
                self.span_events.append(e)
            elif e.name.startswith("cu"):  # cudaLaunchKernel, cuLaunch...
                self.launches[e.id] = t.start / 1e6
        self.spans = sorted((e.time_range.start / 1e6,
                             e.time_range.end / 1e6, _path(e))
                            for e in self.span_events)
        self._starts = [s for s, _, _ in self.spans]

    def span_at(self, t: float) -> str:
        """The path of the innermost (latest-starting) program span open
        on the host at t, or OUTSIDE."""
        for j in range(bisect.bisect_right(self._starts, t) - 1, -1, -1):
            s, e, path = self.spans[j]
            if s <= t < e:
                return path
        return OUTSIDE


def _row(rows: dict, path: str) -> dict:
    return rows.setdefault(path, {
        "calls": 0, "host_ms": 0.0, "host_self_ms": 0.0, "device_ms": 0.0,
        "device_self_ms": 0.0, "kernels": 0, "syncs": 0})


def table(timeline: Timeline, records: dict) -> dict:
    """{span path: {calls, host_ms, host_self_ms, device_ms,
    device_self_ms, kernels, syncs}} of a profile taken with the program's
    tracing on (its Timeline) and that tracing's records. A device
    operation counts under the innermost span open on the host when its
    launch call began (OUTSIDE where none was or no launch call is
    profiled), whenever it ran. `host_self_ms`, `device_self_ms`, `kernels`
    and `syncs` leave out what the span's child spans hold; `host_ms` and
    `device_ms` hold them."""
    rows = {}
    for e in timeline.span_events:
        row = _row(rows, _path(e))
        host = e.time_range.elapsed_us()
        row["calls"] += 1
        row["host_ms"] += host / 1e3
        row["host_self_ms"] += (host - sum(c.time_range.elapsed_us()
                                           for c in _child_spans(e))) / 1e3
    for name, start, end, cid in timeline.ops:
        t = timeline.launches.get(cid)
        row = _row(rows, OUTSIDE if t is None else timeline.span_at(t))
        row["device_self_ms"] += (end - start) * 1e3
        row["kernels"] += is_kernel(name)
    for path, rec in records.items():
        syncs = rec["counts"].get(HOST_SYNC, 0)
        if syncs:
            _row(rows, path or OUTSIDE)["syncs"] = syncs
    for path, row in rows.items():
        row["device_ms"] = sum(r["device_self_ms"] for p, r in rows.items()
                               if p == path or p.startswith(path + "/"))
    return rows


def idle_gaps(timeline: Timeline, top: int = 12) -> list:
    """[(span path, seconds)] of the card's idle time from the first
    program span's start to the end of the last span or device operation,
    each gap named by the innermost program span open on the host when it
    began (OUTSIDE where none was), the most first; [] where no operation
    ran on a card (a CPU run has no device timeline)."""
    spans, ops = timeline.spans, timeline.ops
    if not spans or not ops:
        return []
    w0 = spans[0][0]
    w1 = max([e for _, e, _ in spans] + [e for _, _, e, _ in ops])
    _, merged = _union([(max(s, w0), e) for _, s, e, _ in ops if e > w0])
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    by_span = {}
    for i in range(0, len(edges) - 1, 2):
        s, e = edges[i], edges[i + 1]
        if e > s:
            name = timeline.span_at(s)
            by_span[name] = by_span.get(name, 0.0) + (e - s)
    return sorted(by_span.items(), key=lambda kv: -kv[1])[:top]


def program_step(runner):
    """One step of `runner` with the program's tracing on, profiled on host
    and card: (the profile, the tracing's records, the step's host
    seconds). Raises where the tracing is still on after it, so the steps
    that follow run untraced."""
    from dxrpathtracer_tpu_torch.app.profiler import NO_SPAN, span, tracing
    with profiled(spans=True) as prof:
        with tracing() as records:
            t0 = time.perf_counter()
            runner.step()
            host_s = time.perf_counter() - t0
    if span("frame") is not NO_SPAN:
        raise RuntimeError("ptbench: the program's tracing is still on "
                           "after its traced step")
    return prof, records, host_s


def tabulate(prof, records):
    """(table, idle gaps) of a program step's profile and records."""
    timeline = Timeline(prof)
    return table(timeline, records), idle_gaps(timeline)


def _under(rows: dict, stage: str):
    """The rows at or below the top-level span `stage`, and its calls."""
    calls = rows.get(stage, {}).get("calls", 0)
    return [r for p, r in rows.items()
            if p == stage or p.startswith(stage + "/")], calls


def syncs_per_step(step: str, stage: str):
    """Reader: the host syncs counted under the span `stage` per call of
    it in the program-traced step; None where the mode's step is of
    another kind, or untraced."""
    def read(ctx):
        rows = ctx.get("program_spans")
        if ctx["step"] != step or not rows:
            return None
        under, calls = _under(rows, stage)
        return sum(r["syncs"] for r in under) / calls if calls else None
    return read


def device_ms_per_step(step: str, stage: str, leaf: str):
    """Reader: the device ms of the kernels launched inside the spans
    named `leaf` below `stage`, per call of `stage`; None where the mode's
    step is of another kind, untraced, or where no such span ran on the
    card."""
    def read(ctx):
        rows = ctx.get("program_spans")
        if ctx["step"] != step or not rows:
            return None
        _, calls = _under(rows, stage)
        ms = sum(r["device_ms"] for p, r in rows.items()
                 if p.startswith(stage + "/")
                 and p.rsplit("/", 1)[1] == leaf)
        return ms / calls if calls and ms > 0 else None
    return read


def lines(rows: dict, gaps: list) -> list:
    """The table, deepest paths under their parents, and the gaps."""
    out = [f"{'span path':70s} {'calls':>6s} {'host ms':>9s} {'self':>9s} "
           f"{'dev ms':>9s} {'self':>9s} {'kern':>6s} {'syncs':>6s}"]
    for path in sorted(rows):
        r = rows[path]
        out.append(f"{path or '(no span)':70.70s} {r['calls']:6d} "
                   f"{r['host_ms']:9.3f} {r['host_self_ms']:9.3f} "
                   f"{r['device_ms']:9.3f} {r['device_self_ms']:9.3f} "
                   f"{r['kernels']:6d} {r['syncs']:6d}")
    out.append("idle gaps (ms) by innermost program span: " + json.dumps(
        [[p, round(s * 1e3, 3)] for p, s in gaps]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m ptbench.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from . import run as R
    bench = R._load_json(Path.cwd() / "BENCHMARK.json")
    cell = R.find_cell(bench, args.workload)
    config = R.load_config(cell["config"])
    traffic = R.load_traffic(cell["traffic"])
    import torch
    if not torch.cuda.is_available():
        R.log("ptbench.spans: needs a CUDA device")
        return 3
    mode = R.load_mode(config["mode"])
    runner = mode.Runner(config, traffic, R.load_scene(traffic),
                         args.seed % R.FIRST_SAMPLES, "cuda:0")
    runner.setup()
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        runner.step()
        times.append(time.perf_counter() - t0)
    with profiled(spans=True):
        t0 = time.perf_counter()
        runner.step()
        profiled_s = time.perf_counter() - t0
    prof, records, traced_s = program_step(runner)
    rows, gaps = tabulate(prof, records)
    ctx = {"mode": config["mode"], "step": mode.STEP, "program_spans": rows}
    readings = {m: R.load_metric(m).read(ctx) for m in METRICS}
    result = {"workload": cell["name"], "card": R.card_line(),
              "seed": args.seed,
              "untraced_step_ms": [t * 1e3 for t in times],
              "untraced_median_ms": statistics.median(times) * 1e3,
              "host_profiled_step_ms": profiled_s * 1e3,
              "program_traced_step_ms": traced_s * 1e3,
              "metrics": {k: v for k, v in readings.items()
                          if v is not None},
              "spans": rows, "idle_gaps": gaps}
    for line in lines(rows, gaps):
        R.log(f"ptbench.spans: {line}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("spans", "idle_gaps",
                                   "untraced_step_ms")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
