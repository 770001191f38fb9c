"""Crash-dump capture of dxrpathtracer_tpu_torch (app/crashdump.py), held
as tests/test_crashdump.py holds the JAX package's.

  - The guard writes the dump and re-raises; the session registry backs the
    CLI's guard; KeyboardInterrupt is not dumped.
  - The report has the JAX package's keys, at the top level and inside
    `settings`, `frame` and `scene_tables`, everywhere but `platform`,
    which holds torch's inventory (versions, cards, current device).
  - A part of the inventory or of the session capture that raises (as every
    CUDA call may after a sticky fault) is recorded as its error; the other
    parts, the dump and the original exception survive.
"""

import json

import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

from dxrpathtracer_tpu.app import crashdump as jcrashdump  # noqa: E402
from dxrpathtracer_tpu.app.session import RenderSession as JaxSession  # noqa: E402
from dxrpathtracer_tpu.app import settings as jsettings  # noqa: E402
from dxrpathtracer_tpu_torch.app.crashdump import (build_crash_report,  # noqa: E402
                                                   crash_guard,
                                                   current_session)
from dxrpathtracer_tpu_torch.app.session import RenderSession  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes  # noqa: E402


def _session():
    s = AppSettings(current_scene=Scenes.BoxTest, sqrt_num_samples=1)
    return RenderSession(settings=s, width=16, height=16, device="cpu")


def test_crash_guard_writes_dump_and_reraises(tmp_path):
    sess = _session()
    path = tmp_path / "crash.json"
    with pytest.raises(RuntimeError, match="simulated device fault"):
        with crash_guard(sess, path=str(path)):
            raise RuntimeError("simulated device fault (illegal address)")

    report = json.loads(path.read_text())
    assert "simulated device fault" in report["exception"]
    assert report["frame"] == {"width": 16, "height": 16, "sample_idx": 0,
                               "scene": "BoxTest", "slab_rows": 16}
    assert report["scene_tables"]["num_triangles"] > 0
    assert report["scene_tables"]["bvh_width"] == 8
    assert report["settings"]["max_path_length"] == "3"
    assert any("RuntimeError" in ln for ln in report["traceback"])
    plat = report["platform"]
    assert plat["torch_version"] == torch.__version__
    assert plat["cuda_version"] == torch.version.cuda
    assert plat["cuda_available"] == torch.cuda.is_available()
    assert len(plat["devices"]) == torch.cuda.device_count()
    assert "errors" not in plat


def test_session_registry_backs_the_cli_guard(tmp_path, monkeypatch):
    sess = _session()  # __init__ registers itself
    assert current_session() is sess
    report = build_crash_report(ValueError("boom"))  # no explicit session
    report2 = build_crash_report(ValueError("boom"), current_session())
    assert "frame" not in report
    assert report2["frame"]["height"] == 16
    # the CLI's guard finds the session the command made
    path = tmp_path / "cli.json"
    monkeypatch.setenv("DXRPT_CRASH_DUMP", str(path))
    monkeypatch.setenv("DXRPT_PROBE", "1")
    from dxrpathtracer_tpu_torch.app import cli
    with pytest.raises(ValueError, match="does not fit"):
        cli.main(["bake", "--current-scene", "BoxTest", "--resolution", "8",
                  "--atlas", "pair", "--samples", "1", "--device", "cpu",
                  "--output", str(tmp_path / "lm.png"), "--checkpoint",
                  str(_bad_checkpoint(tmp_path))])
    report = json.loads(path.read_text())
    assert report["frame"]["scene"] == "BoxTest"
    assert report["frame"]["width"] == 8 and report["env"]["DXRPT_PROBE"] == "1"
    assert "ValueError" in report["traceback"][-1]


def _bad_checkpoint(tmp_path):
    import numpy as np
    path = tmp_path / "bad.npz"
    np.savez(path, accum=np.zeros((4, 4, 4), np.float32), sample_index=1)
    return path


def test_keyboard_interrupt_not_dumped(tmp_path):
    path = tmp_path / "crash.json"
    with pytest.raises(KeyboardInterrupt):
        with crash_guard(None, path=str(path)):
            raise KeyboardInterrupt()
    assert not path.exists()


def test_report_keys_match_jax():
    exc = RuntimeError("boom")
    port = build_crash_report(exc, _session())
    ref = jcrashdump.build_crash_report(exc, JaxSession(
        settings=jsettings.AppSettings(current_scene=jsettings.Scenes.BoxTest,
                                       sqrt_num_samples=1),
        width=16, height=16))
    assert set(port) == set(ref)
    for key in ("settings", "frame", "scene_tables"):
        assert set(port[key]) == set(ref[key]), key
    assert port["settings"] == ref["settings"]
    assert port["scene_tables"]["num_triangles"] == \
        ref["scene_tables"]["num_triangles"]
    assert set(port["platform"]) == {"torch_version", "cuda_version",
                                     "cuda_available", "devices",
                                     "current_device"}


class _Broken:
    """A session whose tables raise, as after a sticky CUDA fault."""

    def __init__(self, sess):
        self.__dict__.update(sess.__dict__)

    @property
    def bvh(self):
        raise RuntimeError("CUDA error: an illegal memory access")


def test_each_part_is_guarded(tmp_path, monkeypatch):
    def sticky(*a):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(torch.cuda, "device_count", sticky)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", sticky)
    path = tmp_path / "crash.json"
    with pytest.raises(ValueError, match="the original"):
        with crash_guard(_Broken(_session()), path=str(path)):
            raise ValueError("the original")
    report = json.loads(path.read_text())
    plat = report["platform"]
    assert plat["torch_version"] == torch.__version__
    assert set(plat["errors"]) == {"devices", "current_device"}
    assert "illegal memory access" in plat["errors"]["devices"]
    assert report["frame"]["width"] == 16 and "settings" in report
    assert "scene_tables" not in report
    assert set(report["session_capture_error"]) == {"scene_tables"}
