"""The turntable cell (ptbench/modes/turntable.py, ptbench/ref/turntable.py):
its tiny version's last line, traced and untraced; the reference equal to
the port's plain route; the check failing on the control, on perturbed
outputs and on a step that skips the rebuild or the rotation; on the card,
at the cell's size, the control failing on three seeds and the program
passing."""

import numpy as np
import pytest
import torch

from ptbench import calibrate, spans
from ptbench import run as R
from ptbench.check import verdict

from ._tiny import bench, cell_parts, run_tiny

CELL = "turntable1080-sponza"


def _runner(first_sample, **sizes):
    _, _, config, traffic, limits = cell_parts(CELL, **sizes)
    mode = R.load_mode(config["mode"])
    runner = mode.Runner(config, traffic, R.load_scene(traffic),
                         first_sample, "cpu")
    runner.setup()
    return runner, config, limits


def test_files_name_each_other():
    b, cell, config, traffic, limits = cell_parts(CELL)
    assert config["mode"] == "turntable" and traffic["scene"]
    assert R.load_mode("turntable").STEP == "frame"
    assert config["turntable"] == {"frames_per_turn": 24,
                                   "samples_per_frame": 4}
    assert cell["chips"] == 1 and set(limits) == {"bad_px_pct"}
    got = {m["name"] for m in R.cell_metrics(b, CELL, "end_to_end")}
    assert got == {"frame_ms", "setup_s"}
    got = {m["name"] for m in R.cell_metrics(b, CELL, "per_layer")}
    assert got == {"idle_pct.frame", "launches.frame", "traversal_ms.frame",
                   "shading_ms.frame", "gather_roofline_pct.frame",
                   "build_ms.frame", "turntable_syncs.frame"}


def test_the_reference_loads_nothing_of_the_program():
    from .test_ptbench_imports import FORBIDDEN, _top_level
    code = (
        "import sys, json, numpy as np, torch\n"
        "torch.set_num_threads(2)\n"
        "from ptbench.ref import turntable\n"
        "from ptbench.scenes import sponza_standin\n"
        "t = json.load(open('ptbench/workloads/sponza.json'))\n"
        "c = json.load(open('ptbench/configs/turntable1080.json'))\n"
        "c.update(width=16, height=8)\n"
        "t['texture_size'] = 8\n"
        "d = sponza_standin.build(t)\n"
        "turntable.accumulate(d, c, t, np.arange(8), 5, 'cpu')\n"
        "print(' '.join(sorted({m.split('.')[0] for m in list(sys.modules)})))\n")
    mods = _top_level(code)
    assert not (mods & (FORBIDDEN | {"dxrpathtracer_tpu_torch"}))


def test_last_line():
    result, lines = run_tiny(CELL)
    assert result["correct"] is True and result["attempted"] >= 1
    assert set(result["metrics"]) == {"frame_ms", "setup_s"}
    assert result["metrics"]["frame_ms"]["value"] > 0
    assert result["check"]["bad_px_pct"]["value"] == 0.0
    assert any(line.startswith("check bad_px_pct ") for line in lines)


def test_traced_run_reads_the_turntable_metrics():
    """On the CPU the turntable's syncs read 0 (torch counts none there)
    and build_ms.frame has no device time to read; the line has every
    other metric the program's CPU route gives."""
    result, _ = run_tiny(CELL, trace=1, seconds=9.0)
    assert result["correct"] is True
    got = result["metrics"]
    assert got["turntable_syncs.frame"] == {"value": 0.0,
                                            "unit": "syncs/frame"}
    assert "build_ms.frame" not in got and "setup_s" not in got


def test_program_step_has_the_turntable_spans():
    runner, _, _ = _runner(17, width=16, height=8)
    prof, records, _ = spans.program_step(runner)
    rows, _ = spans.tabulate(prof, records)
    assert rows["turntable"]["calls"] == 1
    for stage in ("rotate", "build", "geometry", "samples", "display"):
        assert rows[f"turntable/turntable.{stage}"]["calls"] == 1
    assert records["turntable/turntable.build"]["counts"] == {
        "lbvh_build": 1}
    assert any(p.startswith("turntable/turntable.samples/") for p in rows)
    assert not any(p == "frame" or p.startswith("frame/") for p in rows)


def _row(calls=1, device_ms=0.0, syncs=0):
    return {"calls": calls, "host_ms": 1.0, "host_self_ms": 0.5,
            "device_ms": device_ms, "device_self_ms": device_ms,
            "kernels": 1, "syncs": syncs}


ROWS = {
    "turntable": _row(2, 700.0, 0),
    "turntable/turntable.rotate": _row(2, 1.0, 1),
    "turntable/turntable.build": _row(2, 8.0, 3),
    "turntable/turntable.samples": _row(2, 600.0, 0),
    "turntable/turntable.samples/frame.constants": _row(8, 0.1, 56),
    "frame/turntable.build": _row(1, 50.0, 9),  # not below `turntable`
    "": _row(0, syncs=100),
}


def test_readers_sum_the_turntable():
    ctx = {"mode": "turntable", "step": "frame", "program_spans": ROWS}
    build = R.load_metric("build_ms.frame").read
    syncs = R.load_metric("turntable_syncs.frame").read
    assert build(ctx) == pytest.approx(4.0)
    assert syncs(ctx) == pytest.approx(30.0)
    # a frame cell's table has no `turntable` span: nothing is read
    frame_rows = {"frame": _row(syncs=21), "frame/paths": _row(1, 40.0)}
    for read in (build, syncs):
        assert read(dict(ctx, program_spans=frame_rows)) is None
        assert read(dict(ctx, step="bake")) is None
        assert read({"mode": "turntable", "step": "frame"}) is None


def test_reference_equals_the_port_bit_for_bit():
    """Every pixel of a tiny frame of the turn, after two steps, in every
    bit: the reference's tree and the program's W8 table find the same
    hits here."""
    runner, config, _ = _runner(8, width=24, height=16)
    for _ in range(2):
        runner.step()
    assert runner.last_frame() == 9  # a view from inside the building
    idx = np.arange(config["width"] * config["height"])
    got = runner.outputs(idx)
    ref = runner.reference(idx, "cpu")
    assert torch.equal(got, ref)
    assert runner.numbers(got, ref) == {"bad_px_pct": 0.0}


def test_check_fails_on_perturbed_outputs():
    """A few more compared pixels than the limit allows, each off by 1e-2
    of itself, fail the check; one fewer than that passes."""
    runner, config, limits = _runner(5)
    runner.step()
    idx = runner.draw(np.random.default_rng(3), config["check"]["count"])
    got = runner.outputs(idx)
    ref = runner.reference(idx, "cpu")
    lit = torch.nonzero(ref[:, 0] > 0)[:, 0]
    allowed = int(limits["bad_px_pct"] / 100.0 * len(idx))
    got[lit[:allowed], 0] *= 1.01
    assert verdict(runner.numbers(got, ref), limits)
    got[lit[allowed], 0] *= 1.01
    assert not verdict(runner.numbers(got, ref), limits)


def test_control_fails():
    """The reference in bfloat16 in the program's place is not correct."""
    _, _, config, traffic, limits = cell_parts(CELL)
    (line,) = calibrate.readings(config, traffic, [], [2**31 + 3], 2, "cpu")
    assert not verdict(line["numbers"], limits)


def _fault_stale_table(monkeypatch):
    """Each frame walks the table built for the frame before it."""
    from dxrpathtracer_tpu_torch.scene import animate
    build, last = animate.build_bvh_device, []

    def stale(*a, **k):
        last.append(build(*a, **k))
        return last[-2] if len(last) > 1 else last[-1]
    monkeypatch.setattr(animate, "build_bvh_device", stale)


def _fault_unturned(monkeypatch):
    """The rotation skipped: each frame renders the unturned scene."""
    from dxrpathtracer_tpu_torch.scene import animate
    monkeypatch.setattr(animate, "rotate_scene_y",
                        lambda scene, theta, center: scene)


def _fault_answer_altered(monkeypatch):
    """Every path's radiance off by 1 % where it is produced."""
    from dxrpathtracer_tpu_torch.render import integrator
    trace = integrator.trace_paths
    monkeypatch.setattr(integrator, "trace_paths",
                        lambda *a, **k: trace(*a, **k) * 1.01)


FAULTS = {"stale_table": _fault_stale_table, "unturned": _fault_unturned,
          "answer_altered": _fault_answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_check_fails_on_a_broken_step(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, _ = run_tiny(CELL)
    assert result["correct"] is False


@pytest.mark.card
def test_control_fails_and_program_passes_at_cell_size(card):
    """About a window's frames (90) at the cell's size: the program within
    the limit on one seed, the control over it on three."""
    c = R.find_cell(bench(), CELL)
    config, traffic = R.load_config(c["config"]), R.load_traffic(c["traffic"])
    limits = R.load_limits(CELL)
    for line in calibrate.readings(config, traffic, [2**31 + 11],
                                   [2**31 + 12, 2**31 + 13, 2**31 + 14],
                                   90, card):
        ok = verdict(line["numbers"], limits)
        assert ok == (line["kind"] == "program"), line
