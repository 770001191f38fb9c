"""Port parity: what the viewer needs of dxrpathtracer_tpu_torch's
RenderSession, against dxrpathtracer_tpu's.

  - `display_thumbnail`: both sessions hold the same seeded HDR
    accumulation (through the `accum` setters); at several thumbnail sizes
    and exposures the port's uint8 thumbnail is within 1 of the JAX one
    (the JAX thumbnail is jitted, so XLA may fuse the tone curve's
    products, which the port rounds one by one).
  - Checkpoints cross both ways on BoxTest 32x32 (sqrt_num_samples=2): the
    JAX session's `checkpoint_state` after 2 samples restored into the
    port, and the port's into the JAX session; 2 further samples on each
    side agree with the other package's 4 uninterrupted samples within
    rel-RMSE 1e-4 (scaled by max|ref|). The JAX side runs in a subprocess
    whose XLA:CPU emits no FMA (ISA capped at AVX).
  - Within the port: N + M samples resumed from a checkpoint in a new
    session equal N + M uninterrupted samples bit for bit; a restored
    session's next `update()` keeps the accumulation; the `accum` setter and
    `restore_state` refuse a wrong shape, dtype or device; `rebuild_step`
    restarts the accumulation.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from dxrpathtracer_tpu.app.session import RenderSession as JaxSession  # noqa: E402
from dxrpathtracer_tpu.app import settings as jsettings  # noqa: E402
from dxrpathtracer_tpu_torch.app.session import RenderSession  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, N, M = 32, 2, 2
LIMIT = 1e-4

_JAX = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from dxrpathtracer_tpu.app.session import RenderSession
from dxrpathtracer_tpu.app.settings import AppSettings, Scenes

port_ckpt, out, res, n, m = sys.argv[1:]
res, n, m = int(res), int(n), int(m)
s = AppSettings(current_scene=Scenes.BoxTest, sqrt_num_samples=2,
                enable_sunspace_shadows=False, enable_dense_proxy=False,
                enable_clear_cut=False, enable_sw_raster=False)
sess = RenderSession(settings=s, width=res, height=res)
sess.render_to_completion(max_samples=n)
ckpt = sess.checkpoint_state()
whole = np.asarray(sess.render_to_completion(max_samples=n + m))
with np.load(port_ckpt) as z:
    sess.restore_state({"accum": z["accum"], "sample_idx": int(z["sample_idx"])})
sess.update()
assert sess.sample_idx == n
resumed = np.asarray(sess.render_to_completion(max_samples=n + m))
np.savez(out, ckpt_accum=ckpt["accum"], ckpt_sample_idx=ckpt["sample_idx"],
         whole=whole, resumed=resumed)
"""


def _rel_rmse(img, ref):
    return float(np.sqrt(np.mean((img - ref) ** 2))
                 / (np.abs(ref).max() + 1e-9))


def _settings():
    return AppSettings(current_scene=Scenes.BoxTest, sqrt_num_samples=2)


@pytest.fixture(scope="module")
def port_run():
    """The port's 2-sample checkpoint and its 4-sample accumulation."""
    sess = RenderSession(_settings(), RES, RES, device="cpu")
    sess.render_to_completion(max_samples=N)
    ckpt = sess.checkpoint_state()
    whole = sess.render_to_completion(max_samples=N + M).numpy().copy()
    return ckpt, whole


@pytest.fixture(scope="module")
def jax_run(port_run, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    ckpt, _ = port_run
    np.savez(tmp / "port.npz", accum=ckpt["accum"],
             sample_idx=ckpt["sample_idx"])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX, str(tmp / "port.npz"),
         str(tmp / "jax.npz"), str(RES), str(N), str(M)], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(tmp / "jax.npz"))


def test_jax_checkpoint_resumes_in_the_port(jax_run):
    sess = RenderSession(_settings(), RES, RES, device="cpu")
    sess.restore_state({"accum": jax_run["ckpt_accum"],
                        "sample_idx": jax_run["ckpt_sample_idx"]})
    sess.update()
    assert sess.sample_idx == N
    out = sess.render_to_completion(max_samples=N + M).numpy()
    err = _rel_rmse(out, jax_run["whole"])
    assert err <= LIMIT, err


def test_port_checkpoint_resumes_in_jax(port_run, jax_run):
    _, whole = port_run
    err = _rel_rmse(jax_run["resumed"], whole)
    assert err <= LIMIT, err
    assert _rel_rmse(whole, jax_run["whole"]) <= LIMIT


def test_checkpoint_resume_is_bit_equal(port_run):
    ckpt, whole = port_run
    assert ckpt["accum"].dtype == np.float32
    assert ckpt["accum"].shape == (RES, RES, 3) and ckpt["sample_idx"] == N
    sess = RenderSession(_settings(), RES, RES, device="cpu")
    sess.restore_state(ckpt)
    sess.render_frame()   # update() keeps the restored accumulation
    assert sess.sample_idx == N + 1
    out = sess.render_to_completion(max_samples=N + M).numpy()
    np.testing.assert_array_equal(out, whole)


@pytest.mark.parametrize("bad", ["shape", "dtype", "device", "numpy"])
def test_accum_setter_is_strict(bad):
    sess = RenderSession(_settings(), 8, 6, device="cpu")
    img = {"shape": torch.zeros((6, 8, 4)),
           "dtype": torch.zeros((6, 8, 3), dtype=torch.float64),
           "device": torch.zeros((6, 8, 3), device="meta"),
           "numpy": np.zeros((6, 8, 3), np.float32)}[bad]
    with pytest.raises(ValueError, match="accum"):
        sess.accum = img
    with pytest.raises(ValueError, match="accum"):
        sess.restore_state({"accum": np.zeros((8, 6, 3)), "sample_idx": 1})
    good = torch.ones((6, 8, 3))
    sess.accum = good
    assert sess.accum is good


def test_rebuild_step_restarts():
    sess = RenderSession(_settings(), 8, 8, device="cpu")
    sess.render_frame()
    sess.rebuild_step()
    assert sess.sample_idx == 0 and float(sess.accum.abs().sum()) == 0.0
    assert sess.render_frame() and sess.sample_idx == 1


@pytest.mark.parametrize("size", [(16, 16), (20, 9), (5, 31)])
def test_display_thumbnail_matches_jax(size):
    w, h = 24, 18
    rng = np.random.default_rng(w * h + size[0])
    img = rng.gamma(0.7, 0.6, (h, w, 3)).astype(np.float32) * 1024.0
    img[rng.random((h, w)) < 0.03] *= 300.0
    port = RenderSession(_settings(), w, h, device="cpu")
    ref = JaxSession(settings=jsettings.AppSettings(
        current_scene=jsettings.Scenes.BoxTest, sqrt_num_samples=2),
        width=w, height=h)
    port.accum = torch.from_numpy(img)
    ref.accum = jnp.asarray(img)
    cols, rows = size
    for exposure in (-14.0, -1.5, 0.0, 0.5):
        port.settings = port.settings.replace(exposure=exposure)
        ref.settings = ref.settings.replace(exposure=exposure)
        got = port.display_thumbnail(cols, rows)
        want = np.asarray(ref.display_thumbnail(cols, rows))
        assert got.dtype == torch.uint8 and got.device == port.device
        assert tuple(got.shape) == want.shape == (rows, cols, 3)
        diff = np.abs(got.numpy().astype(int) - want.astype(int))
        assert diff.max() <= 1, (exposure, diff.max(), int((diff > 0).sum()))
