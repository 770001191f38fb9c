"""Shader hot reload of dxrpathtracer_tpu_torch (app/hotreload.py), held as
tests/test_hotreload.py holds the JAX package's, plus the CUDA sources.

  - The watcher on a temporary fake package: an edit of a leaf module
    reloads it and its dependents, dependency first; an edit of a CUDA
    source reloads the module that names it in KERNEL_SOURCE; unwatched
    modules are never reported.
  - `reload_order` over the port: dependencies before dependents, and a
    kernel module (accel/gather.py) before the integrator and the bake.
  - In a subprocess, on a temporary copy of the package (a reload replaces
    the package's classes, so it never runs in the shared test process): an
    edit of the copy's csrc/traverse.cu maps to accel.traverse, whose reload
    drops its loaded library (`_kernel`) and its launch counts, with no
    build on this host; then `rebuild_step` and a frame equal the frames
    before the reload.
  - In a subprocess: a reload of the real integrator (source unchanged) and
    `rebuild_step` restart the render, which then takes the reloaded
    `render_sample` and gives the same image.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest
from torch_threads import one_torch_thread  # noqa: F401

pytest.importorskip("torch")

from dxrpathtracer_tpu_torch.app.hotreload import (ShaderWatcher,  # noqa: E402
                                                   reload_order)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "dxrpathtracer_tpu_torch"


def _bump(path):
    # mtime granularity on some filesystems is 1 s: force a visible change
    st = path.stat()
    os.utime(path, (st.st_atime, st.st_mtime + 2.0))


def _write(path, src):
    path.write_text(textwrap.dedent(src))
    _bump(path)


def _make_fake_pkg(tmp_path, monkeypatch):
    """A miniature package shaped like the port: core (leaf), accel (a
    kernel module naming its CUDA source), render (imports both via `from
    ... import`), app (not watched)."""
    pkg = tmp_path / "fakeshaders_t"
    for sub in ("core", "accel", "render", "app", "csrc"):
        (pkg / sub).mkdir(parents=True)
        (pkg / sub / "__init__.py").write_text("")
    (pkg / "__init__.py").write_text("")
    (pkg / "csrc" / "k.cu").write_text("// kernel\n")
    (pkg / "core" / "brdf.py").write_text("def f():\n    return 1\n")
    (pkg / "accel" / "k.py").write_text(
        "from pathlib import Path\n"
        "KERNEL_SOURCE = Path(__file__).parent.parent / 'csrc' / 'k.cu'\n"
        "_kernel = None\n"
        "def h():\n    return 100\n")
    (pkg / "render" / "integrator.py").write_text(
        "from fakeshaders_t.core.brdf import f\n"
        "from fakeshaders_t.accel.k import h\n"
        "def g():\n    return f() + h() + 10\n")
    (pkg / "app" / "host.py").write_text("HOST = True\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    import importlib
    for m in ("fakeshaders_t", "fakeshaders_t.core.brdf",
              "fakeshaders_t.accel.k", "fakeshaders_t.render.integrator",
              "fakeshaders_t.app.host"):
        importlib.import_module(m)
    return pkg


def test_watcher_reloads_edited_modules_and_kernel_sources(tmp_path,
                                                           monkeypatch):
    pkg = _make_fake_pkg(tmp_path, monkeypatch)
    try:
        w = ShaderWatcher(root="fakeshaders_t",
                          subpackages=("core", "accel", "render"))
        assert w.poll() == []   # nothing changed yet

        _write(pkg / "core" / "brdf.py", """
            def f():
                return 2
            """)
        changed = w.poll()
        assert changed == ["fakeshaders_t.core.brdf"]
        order = w.reload(changed)
        # the dependent that did `from core.brdf import f` reloads AFTER
        # its dependency, so its binding re-resolves to the new code
        assert order.index("fakeshaders_t.core.brdf") < order.index(
            "fakeshaders_t.render.integrator")
        from fakeshaders_t.render.integrator import g
        assert g() == 112

        # an edit of the CUDA source reloads the module that builds it
        k = sys.modules["fakeshaders_t.accel.k"]
        k._kernel = "a loaded library"
        with open(pkg / "csrc" / "k.cu", "a") as f:
            f.write("// edited\n")
        _bump(pkg / "csrc" / "k.cu")
        changed = w.poll()
        assert changed == ["fakeshaders_t.accel.k"]
        order = w.reload(changed)
        assert order.index("fakeshaders_t.accel.k") < order.index(
            "fakeshaders_t.render.integrator")
        assert "fakeshaders_t.core.brdf" not in order
        assert sys.modules["fakeshaders_t.accel.k"]._kernel is None
        assert w.poll() == []

        # the unwatched "C++ side" is never reported
        _write(pkg / "app" / "host.py", "HOST = False\n")
        assert w.poll() == []
    finally:
        for name in [n for n in sys.modules if n.startswith("fakeshaders_t")]:
            del sys.modules[name]


def test_reload_order_is_dependency_first_for_the_port():
    import dxrpathtracer_tpu_torch.app.session  # noqa: F401
    import dxrpathtracer_tpu_torch.bake.baker  # noqa: F401
    order = reload_order([f"{PKG}.core.brdf"])
    assert order.index(f"{PKG}.core.brdf") < order.index(
        f"{PKG}.render.integrator")
    order = reload_order([f"{PKG}.accel.gather"])
    first = order.index(f"{PKG}.accel.gather")
    for dep in ("render.integrator", "bake.surface_map", "bake.baker",
                "app.session"):
        assert first < order.index(f"{PKG}.{dep}"), dep
    # only loaded package modules take part
    assert reload_order(["not.a.module"]) == []


def _run(script, *args, cwd=REPO, pythonpath=REPO):
    proc = subprocess.run([sys.executable, "-c", script, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=pythonpath))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok"), proc.stdout[-2000:]
    return proc.stdout


_CU_EDIT = r"""
import os
import sys
import torch
import dxrpathtracer_tpu_torch as pkg
from dxrpathtracer_tpu_torch.accel import traverse
from dxrpathtracer_tpu_torch.app.hotreload import ShaderWatcher
from dxrpathtracer_tpu_torch.app.session import RenderSession
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes

root = sys.argv[1]
assert pkg.__file__.startswith(root), pkg.__file__   # the copy
sess = RenderSession(AppSettings(current_scene=Scenes.BoxTest,
                                 sqrt_num_samples=1), 16, 16, device="cpu")
before = sess.render_to_completion(2).clone()
traverse._kernel = "a loaded library"
traverse.KERNEL_LAUNCHES[(8, False, False)] = 3
w = ShaderWatcher()
src = str(traverse.KERNEL_SOURCE)
assert src.startswith(root) and src.endswith("traverse.cu")
with open(src, "a") as f:
    f.write("// edited\n")
st = os.stat(src)
os.utime(src, (st.st_atime, st.st_mtime + 2.0))
changed = w.poll()
assert changed == ["dxrpathtracer_tpu_torch.accel.traverse"], changed
order = w.reload(changed)
for name in ("accel.traverse", "render.integrator", "app.session"):
    assert "dxrpathtracer_tpu_torch." + name in order, name
t = sys.modules["dxrpathtracer_tpu_torch.accel.traverse"]
assert t is traverse and t._kernel is None and t.KERNEL_LAUNCHES == {}
old = sess._render_sample
sess.rebuild_step()
assert sess.sample_idx == 0 and sess._render_sample is not old
after = sess.render_to_completion(2)
assert torch.equal(after, before)
assert w.poll() == []
print("ok")
"""


def test_cuda_source_edit_reloads_its_module_in_a_copy(tmp_path):
    """An edit of csrc/traverse.cu in a copy of the package (the repo's
    files are never touched) reloads accel.traverse and drops its library;
    nothing is built here (the next CPU frame runs the plain walk)."""
    copy = tmp_path / PKG
    shutil.copytree(os.path.join(REPO, PKG), copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    # what the package reads outside itself: the C++ source of its SAH
    # library (keyed by its hash, built at first use); its data files are
    # its own
    shutil.copytree(os.path.join(REPO, "native"), tmp_path / "native",
                    ignore=shutil.ignore_patterns("*.so"))
    _run(_CU_EDIT, str(tmp_path), cwd=tmp_path, pythonpath=str(tmp_path))
    built = [p.name for p in (copy / "build").glob("lib*.so")]
    assert not [n for n in built if n.startswith(("libtraverse",
                                                  "libgather"))], built


_REAL_RELOAD = r"""
import sys
import torch
from dxrpathtracer_tpu_torch.app.hotreload import ShaderWatcher
from dxrpathtracer_tpu_torch.app.session import RenderSession
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes

sess = RenderSession(AppSettings(current_scene=Scenes.BoxTest,
                                 sqrt_num_samples=2), 16, 16, device="cpu")
ref = sess.render_to_completion().clone()
w = ShaderWatcher()
name = "dxrpathtracer_tpu_torch.render.integrator"
reloaded = w.reload([name])
assert name in reloaded, reloaded
sess.rebuild_step()
assert sess.sample_idx == 0   # a reload restarts the progressive render
assert sess._render_sample is sys.modules[name].render_sample
out = sess.render_to_completion()
assert torch.equal(out, ref)
print("ok")
"""


def test_session_rebuild_step_after_real_reload():
    _run(_REAL_RELOAD)
