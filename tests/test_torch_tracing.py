"""The port's tracer (dxrpathtracer_tpu_torch/app/profiler.py): spans,
counts and the host-sync counter, on the CPU.

Untraced, `span` is one shared no-op that makes no profiler object; traced,
spans nest into paths, counts and torch's synchronizing-operation warnings
go to the innermost span, and the warning filters come back at the end. A
16x16 frame on each route and a 64^2 pair-atlas bake, under a CPU
torch.profiler, emit every span their route reaches, and give the same
outputs bit for bit with tracing on and off.
"""

import warnings

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

from dxrpathtracer_tpu_torch.app import profiler as P  # noqa: E402
from dxrpathtracer_tpu_torch.app.session import RenderSession  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import (AppSettings,  # noqa: E402
                                                  Scenes)
from dxrpathtracer_tpu_torch.bake.baker import Baker  # noqa: E402
from dxrpathtracer_tpu_torch.scene.registry import (  # noqa: E402
    tiny_alpha_scene)

FRAME_SPANS = {
    "frame", "frame.update", "RenderRayTracing", "frame.constants", "raygen",
    "paths", "trace", "shade", "shade.miss", "shade.fetch", "shade.taps",
    "shade.sun", "shade.spot", "shade.sample", "visibility",
    "vertex_update", "accumulate"}
BAKE_SPANS = {"bake", "frame.constants", "bake.slab", "bake.rays", "paths",
              "trace", "shade", "shade.taps", "visibility", "vertex_update",
              "bake.clamp", "traverse.closest", "traverse.sun_grid",
              "traverse.screened", "traverse.any"}


def _no_record_function(*_args, **_kwargs):
    raise AssertionError("record_function made while untraced")


def test_span_off_is_the_shared_noop(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function",
                        _no_record_function)
    first = P.span("frame")
    assert first is P.span("shade") is P.NO_SPAN
    with P.span("frame") as got:
        assert got is None
        P.count("host_sync")  # no tracing() scope: nothing to count in

    @P.spanned("traverse.closest")
    def walk(x):
        """doc"""
        return x + 1

    assert walk(1) == 2 and walk.__name__ == "walk" and walk.__doc__ == "doc"


def test_span_paths_nest_and_count_calls():
    with P.tracing() as records:
        with P.span("frame"):
            for _ in range(3):
                with P.span("paths"):
                    with P.span("trace"):
                        pass
            with P.span("accumulate"):
                pass
    assert records == {
        "frame": {"calls": 1, "counts": {}},
        "frame/paths": {"calls": 3, "counts": {}},
        "frame/paths/trace": {"calls": 3, "counts": {}},
        "frame/accumulate": {"calls": 1, "counts": {}}}
    assert P.span("frame") is P.NO_SPAN  # off again after the scope


def test_count_goes_to_the_innermost_span():
    with P.tracing() as records:
        P.count("outside")
        with P.span("bake"):
            P.count("rays", 2)
            with P.span("bake.slab"):
                P.count("rays", 5)
                P.count("rays")
            P.count("rays")
    assert records[""]["counts"] == {"outside": 1}
    assert records["bake"]["counts"] == {"rays": 3}
    assert records["bake/bake.slab"]["counts"] == {"rays": 6}


def test_sync_warning_counts_in_its_span():
    """torch's sync debug warning, raised here by hand, counts as a host
    sync of the span it is raised in; other warnings still show."""
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with P.tracing() as records:
            with P.span("frame"):
                with P.span("frame.constants"):
                    for _ in range(2):
                        warnings.warn(P.SYNC_WARNING + " (Triggered "
                                      "internally at Copy.cu:1)",
                                      UserWarning)
                warnings.warn(P.SYNC_WARNING, UserWarning)
                warnings.warn("something else", UserWarning)
    assert records["frame/frame.constants"]["counts"] == {P.HOST_SYNC: 2}
    assert records["frame"]["counts"] == {P.HOST_SYNC: 1}
    assert [str(w.message) for w in shown] == ["something else"]
    assert P.sync_lines(records) == [
        "     2 host syncs in     1 calls of frame/frame.constants",
        "     1 host syncs in     1 calls of frame"]


def test_tracing_restores_warning_filters():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        filters, show = list(warnings.filters), warnings.showwarning
        with pytest.raises(RuntimeError):
            with P.tracing():
                assert warnings.filters != filters
                assert warnings.showwarning is not show
                raise RuntimeError("the scope ends in an error")
        assert warnings.filters == filters
        assert warnings.showwarning is show
    assert P.span("frame") is P.NO_SPAN


def _profiled_spans(fn):
    """(the records, the set of span names in a CPU profile) of fn() under
    tracing()."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with P.tracing() as records:
            fn()
    names = {e.name[len(P.SPAN_PREFIX):] for e in prof.events()
             if e.name.startswith(P.SPAN_PREFIX)}
    return records, names


def _traced_and_untraced(sess):
    """The accumulation after one more frame untraced and, from the same
    state, traced; the records and profiled span names."""
    state = sess.checkpoint_state()
    sess.render_frame()
    untraced = sess.accum.clone()
    sess.restore_state(state)
    records, names = _profiled_spans(sess.render_frame)
    return untraced, sess.accum, records, names


# each route's frame and the traversal spans it reaches (BoxTest: the
# packets, the cut in front of the per-ray walks, the grid and the
# screened shadow walks; the env switches' alternates)
ROUTES = {
    "default": ({}, "BoxTest", {
        "traverse.packet_closest", "traverse.packet_any", "traverse.cut",
        "traverse.closest", "traverse.sun_grid", "traverse.screened",
        "traverse.any"}),
    "history": ({"DXRPT_HISTORY": "1"}, "BoxTest", {
        "traverse.history", "traverse.packet_closest",
        "traverse.packet_any"}),
    "proxy_seed": ({"DXRPT_PROXY_SEED": "1"}, "BoxTest", {
        "traverse.proxy_seed", "traverse.closest"}),
    "raster": ({"DXRPT_RASTER_MIN_PIXELS": "1"}, "BoxTest", {
        "traverse.raster"}),
    "split_alpha": ({"DXRPT_SPLIT_ALPHA": "1"}, "tiny_alpha", {
        "traverse.split_alpha", "traverse.packet_closest",
        "traverse.packet_any"}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_frame_spans_and_bits(route, monkeypatch):
    env, scene_name, traversal = ROUTES[route]
    for k in ("DXRPT_HISTORY", "DXRPT_PROXY_SEED", "DXRPT_RASTER_MIN_PIXELS",
              "DXRPT_SPLIT_ALPHA", "DXRPT_KCAND", "DXRPT_ALPHA_SPLIT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    settings = AppSettings(current_scene=Scenes.BoxTest)
    scene = preset = None
    if scene_name == "tiny_alpha":
        scene, preset = tiny_alpha_scene()
    sess = RenderSession(settings, 16, 16, device="cpu", scene=scene,
                         preset=preset)
    assert sess.render_frame()
    untraced, traced, records, names = _traced_and_untraced(sess)
    assert torch.equal(untraced, traced)
    assert FRAME_SPANS | traversal <= names, sorted(
        (FRAME_SPANS | traversal) - names)
    assert {p.rsplit("/", 1)[-1] for p in records} == names
    assert records["frame"]["calls"] == 1
    taps = [r["calls"] for p, r in records.items()
            if p.endswith("/shade.taps")]
    assert sum(taps) == 10  # five maps at each of two vertices
    assert not any(r["counts"] for r in records.values())  # no card here


def test_bake_spans_and_bits():
    sess = RenderSession(AppSettings(current_scene=Scenes.BoxTest), 8, 8,
                         device="cpu")
    baker = Baker(sess, resolution=64, atlas_mode="pair")
    baker.bake_step()
    # a copy: on the CPU the checkpoint's array is a view of `accum`, which
    # bake_step writes in place
    state = {k: np.copy(v) for k, v in baker.checkpoint_state().items()}
    baker.bake_step()
    untraced = baker.accum.clone()
    baker.restore_state(state)
    records, names = _profiled_spans(baker.bake_step)
    assert torch.equal(untraced, baker.accum)
    assert BAKE_SPANS <= names, sorted(BAKE_SPANS - names)
    assert records["bake"]["calls"] == 1
    assert records["bake/bake.slab"]["calls"] == len(baker._row0)


def test_device_trace_writes_spans_and_sync_lines(tmp_path, capsys):
    sess = RenderSession(AppSettings(current_scene=Scenes.BoxTest), 16, 16,
                         device="cpu")
    with P.device_trace(str(tmp_path)):
        sess.render_frame()
        P.count(P.HOST_SYNC, 3)
    text = (tmp_path / "trace.json").read_text()
    for name in ("dxrpt.frame", "dxrpt.shade.taps", "dxrpt.traverse.any"):
        assert f'"{name}"' in text
    err = capsys.readouterr().err
    assert "# host syncs by span, 3 in all:" in err
    assert "3 host syncs in     0 calls of (no span)" in err
