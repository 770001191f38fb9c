"""The comparison that decides `correct`: the reference equals the port's
plain route, the check passes on it, and fails on the control and on a
timed path broken underneath."""

import numpy as np
import pytest
import torch

from ptbench import calibrate
from ptbench import run as R

from ._tiny import cell_parts, run_tiny

FRAMES = ("pt1080-sponza", "pt1080-sponza-alpha")
CELLS = FRAMES + ("bake4096-sponza",)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_the_port_bit_for_bit(cell):
    """The port's plain route on the CPU and the reference agree in every
    bit at every pixel or texel of a tiny cell."""
    _, _, config, traffic, _ = cell_parts(cell, width=24, height=16,
                                          resolution=48)
    mode = R.load_mode(config["mode"])
    runner = mode.Runner(config, traffic, R.load_scene(traffic),
                         777, "cpu")
    runner.setup()
    for _ in range(2):
        runner.step()
    total = (config["width"] * config["height"] if config["mode"] == "frame"
             else config["resolution"] ** 2)
    idx = np.arange(total)
    got = runner.outputs(idx)
    ref = runner.reference(idx, "cpu")
    assert torch.equal(got, ref)
    assert runner.numbers(got, ref) == {k: 0.0 for k in
                                        runner.numbers(got, ref)}


@pytest.mark.parametrize("cell", CELLS)
def test_check_passes_on_the_plain_route(cell):
    result, _ = run_tiny(cell)
    assert result["correct"] is True
    assert all(c["value"] == 0.0 for c in result["check"].values())


def _fault_state_unchanged(monkeypatch):
    """Each step does its work and returns its state unchanged."""
    from dxrpathtracer_tpu_torch.bake import baker
    from dxrpathtracer_tpu_torch.render import integrator
    render, bake = integrator.render_sample, baker.bake_sample

    def render_same(*a, **k):
        render(*a, **k)
        return a[8]

    def bake_same(*a, **k):
        bake(*a, **k)
        return a[7]
    monkeypatch.setattr(integrator, "render_sample", render_same)
    monkeypatch.setattr(baker, "bake_sample", bake_same)


def _fault_half_batch(monkeypatch):
    """Half of the pixels or texels left out of the step; the mean over the
    rest."""
    from dxrpathtracer_tpu_torch.bake import baker
    from dxrpathtracer_tpu_torch.render import integrator
    render, bake = integrator.render_sample, baker.bake_sample

    def render_half(*a, **k):
        accum = a[8]
        out = render(*a, **k)
        h = out.shape[0] // 2
        return torch.cat([out[:h], accum[h:]])

    def bake_half(*a, **k):
        accum = a[7]
        out = bake(*a, **k)
        h = out.shape[0] // 2
        return torch.cat([out[:h], accum[h:]])
    monkeypatch.setattr(integrator, "render_sample", render_half)
    monkeypatch.setattr(baker, "bake_sample", bake_half)


def _fault_answer_altered(monkeypatch):
    """Every path's radiance off by 1 % where it is produced."""
    from dxrpathtracer_tpu_torch.bake import baker
    from dxrpathtracer_tpu_torch.render import integrator
    trace = integrator.trace_paths

    def altered(*a, **k):
        return trace(*a, **k) * 1.01
    monkeypatch.setattr(integrator, "trace_paths", altered)
    monkeypatch.setattr(baker, "trace_paths", altered)


FAULTS = {"state_unchanged": _fault_state_unchanged,
          "half_batch": _fault_half_batch,
          "answer_altered": _fault_answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_check_fails_on_a_broken_timed_path(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, _ = run_tiny(cell)
    assert result["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_check_fails_on_perturbed_outputs(cell):
    """A few more compared values than the cell's limit allows, each off
    by 1e-2 of itself, fail the check; one fewer than that passes."""
    _, _, config, traffic, limits = cell_parts(cell)
    mode = R.load_mode(config["mode"])
    runner = mode.Runner(config, traffic, R.load_scene(traffic),
                         5, "cpu")
    runner.setup()
    runner.step()
    idx = runner.draw(np.random.default_rng(3), config["check"]["count"])
    got = runner.outputs(idx)
    ref = runner.reference(idx, "cpu")
    lit = torch.nonzero(ref[:, 0] > 0)[:, 0]
    (limit,) = limits.values()
    allowed = int(limit / 100.0 * len(idx))
    from ptbench.check import verdict
    got[lit[:allowed], 0] *= 1.01
    assert verdict(runner.numbers(got, ref), limits)
    got[lit[allowed], 0] *= 1.01
    assert not verdict(runner.numbers(got, ref), limits)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    """The reference in bfloat16 in the program's place is not correct."""
    _, _, config, traffic, limits = cell_parts(cell)
    (line,) = calibrate.readings(config, traffic, [], [2**31 + 3], 2, "cpu")
    from ptbench.check import verdict
    assert not verdict(line["numbers"], limits)
