"""The benchmark of dxrpathtracer_tpu_torch on the card.

    python3 -m ptbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. A cell of BENCHMARK.json names a configuration
(ptbench/configs/<config>.json: the mode, its sizes and settings) and a
traffic mix (ptbench/workloads/<traffic>.json: the scene generator of
ptbench/scenes/, the camera and the sun). The mode's runner
(ptbench/modes/<mode>.py) builds the port's session, warms the cell's own
shapes and steps it; the mode's STEP says what one step is ("frame": one
displayed frame; "bake": one bake sample), and the readers key on it, not
on the mode's name. This file times the window, reads each metric with
its reader (ptbench/metrics/<name>.py; the per-layer ones in a traced
run), checks the output against the plain reference (ptbench/ref/) at
pixels or texels drawn from the seed, within the cell's limits
(ptbench/limits/<cell>.json), and prints one JSON line last on standard
output.

--seed sets the first progressive sample index (seed mod FIRST_SAMPLES),
which drives the CMJ pattern, and draws the pixels or texels compared.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent
FIRST_SAMPLES = 4096
FORBIDDEN = ("jax", "jaxlib", "flax", "dxrpathtracer_tpu")
HBM_BYTES_PER_S = 3.35e12  # chip_smoke.py:492, the H100 SXM's HBM3 peak
PHASES = {}  # set-up seconds that main() times before run()


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"ptbench: no workload {name!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    return _load_json(ROOT / "configs" / f"{name}.json")


def load_traffic(name: str) -> dict:
    return _load_json(ROOT / "workloads" / f"{name}.json")


def load_limits(cell: str) -> dict:
    return _load_json(ROOT / "limits" / f"{cell}.json")


def _load_module(kind: str, name: str):
    """ptbench/<kind>/<name>.py as the module ptbench.<kind>.<name> (its
    relative imports resolve in the package; a name may hold dots)."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"ptbench: no {kind} file {path.name}")
    spec = importlib.util.spec_from_file_location(
        f"ptbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_scene(traffic: dict):
    """The SceneDesc of the traffic's scene generator, built with the
    traffic's parameters."""
    return _load_module("scenes", traffic["scene"]).build(traffic)


def load_mode(name: str):
    """The mode's module; refused by name where it declares no STEP."""
    mod = _load_module("modes", name)
    if not isinstance(getattr(mod, "STEP", None), str):
        raise SystemExit(f"ptbench: mode {name} (modes/{name}.py) declares "
                         f"no STEP, the kind of its step (\"frame\", "
                         f"\"bake\", ...) that the readers key on")
    return mod


def load_metric(name: str):
    return _load_module("metrics", name)


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The entries of BENCHMARK.json's `kind` list that the cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def read_metrics(entries: list, ctx: dict) -> dict:
    """{name: {value, unit}} of each entry whose reader finds something."""
    out = {}
    for m in entries:
        value = load_metric(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or ''."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m ptbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def timed_window(runner, seconds: float, traced_steps: int, recorder):
    """Steps the runner until `seconds` have passed on the host clock.
    Returns (window seconds, each untraced step's seconds, the trace or
    None). With a gather `recorder` (a traced run), once a third of the
    window has passed, `traced_steps` steps are profiled on the card alone
    and one more step on host and card with the program's tracing on
    (`spans.program_step`); their time is in the window but not among the
    step times. The trace is (the card's profile, its stretch's host
    seconds, the program step's (profile, records, host seconds))."""
    from . import spans
    from . import trace as tr
    times, traced = [], None
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        if recorder is not None and traced is None and t - start >= seconds / 3:
            recorder.on = True
            with tr.profiled(spans=False) as prof:
                t0 = time.perf_counter()
                for _ in range(traced_steps):
                    runner.step()
                tr.sync(runner.device)
                stretch_s = time.perf_counter() - t0
            recorder.on = False
            traced = (prof, stretch_s, spans.program_step(runner))
            continue
        runner.step()
        now = time.perf_counter()
        times.append(now - t)
        if now - start >= seconds:
            return now - start, times, traced


def main(argv=None) -> int:
    args = parse(argv)
    bench = _load_json(Path.cwd() / "BENCHMARK.json")
    cell = find_cell(bench, args.workload)
    config = load_config(cell["config"])
    traffic = load_traffic(cell["traffic"])
    limits = load_limits(cell["name"])
    chips = int(cell["chips"])

    t = time.perf_counter()
    import torch
    PHASES["torch_import"] = time.perf_counter() - t
    t = time.perf_counter()
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    PHASES["cuda_query"] = time.perf_counter() - t
    if count < chips:
        log(f"ptbench: the cell needs {chips} CUDA device(s), found {count}")
        return 3
    result, check_lines = run(args, bench, cell, config, traffic, limits,
                              "cuda:0")
    found = forbidden_modules()
    if found:
        log(f"ptbench: modules that must not load were loaded: {found}")
        return 4
    for line in check_lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


def run(args, bench, cell, config, traffic, limits, device):
    """One run of the cell on `device`; returns (the result's dict, the
    check's lines)."""
    import torch

    from . import spans
    from . import trace as tr
    on_card = device.startswith("cuda")
    mode = load_mode(config["mode"])
    recorder = tr.GatherRecorder() if args.trace else None
    t_scene = time.perf_counter()
    desc = load_scene(traffic)
    first = args.seed % FIRST_SAMPLES
    runner = mode.Runner(config, traffic, desc, first, device)
    t_setup = time.perf_counter()
    runner.setup()
    setup_s = time.perf_counter() - _T0
    card = card_line() if on_card else "cpu"
    phases = dict(PHASES, harness=t_scene - _T0 - sum(PHASES.values()),
                  scene=t_setup - t_scene, **runner.phases)
    log(f"ptbench: {cell['name']} on {card}: set-up {setup_s:.3f} s, "
        f"first sample {first}; phases (s) {json.dumps(phases)}")

    counters0 = tr.read_counters()
    traced_steps = int(config["traced_steps"])
    window_s, times, traced = timed_window(runner, args.seconds,
                                           traced_steps, recorder)
    counters = tr.counter_deltas(counters0, tr.read_counters())
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"ptbench: {runner.steps} {runner.unit_name} in {window_s:.3f} s "
        f"({len(times)} timed), {runner.rays_per_step()} rays each; "
        f"hand-kernel launches {json.dumps(counters)}")

    ctx = {"mode": config["mode"], "step": mode.STEP, "setup_s": setup_s,
           "window_s": window_s, "step_s": times, "steps": runner.steps,
           "setup": runner.setup_readings(), "traced_steps": traced_steps,
           "hbm_bytes_per_s": HBM_BYTES_PER_S}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced is not None:
        ctx["profile"] = tr.device_summary(traced[0], traced[1])
        ctx["program_spans"], gaps = spans.tabulate(*traced[2][:2])
        del traced
        ctx["gather_bytes"] = recorder.bytes_needed()
        recorder.calls.clear()
        for name, count, secs in ctx["profile"]["ops_by_kernel"][:30]:
            log(f"ptbench: traced {name[:90]}: {count} launches, "
                f"{secs * 1e3:.3f} ms")
        for line in spans.lines(ctx["program_spans"], gaps):
            log(f"ptbench: program step: {line}")
        device_info["busy_s"] = ctx["profile"]["busy_s"]
        device_info["window_s"] = ctx["profile"]["window_s"]
        breakdown = {"device_ops": [[n, s] for n, s in
                                    ctx["profile"]["top_ops"]],
                     "idle_gaps": [[n, s] for n, s in gaps[:10]]}
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = read_metrics(cell_metrics(bench, cell["name"], kind), ctx)

    # the outputs compared; the program's state is freed before the
    # reference runs on the same device
    rng = np.random.default_rng(args.seed % 2**64)
    idx = runner.draw(rng, int(config["check"]["count"]))
    got = runner.outputs(idx)
    runner.release()
    ctx.pop("profile", None)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = runner.reference(idx, device).cpu()
    numbers = runner.numbers(got, ref)
    from .check import verdict
    correct = verdict(numbers, limits)
    lines = [f"ptbench: reference {time.perf_counter() - t_ref:.3f} s over "
             f"{len(idx)} {config['check']['what']} and {runner.steps} "
             f"{runner.unit_name}"]
    lines += [f"check {k} {v!r} limit {limits.get(k)!r}"
              for k, v in numbers.items()]
    result = {"correct": bool(correct), "attempted": runner.steps,
              "failed": 0, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": v, "limit": limits.get(k)}
                       for k, v in numbers.items()}
    return result, lines


if __name__ == "__main__":
    sys.exit(main())
