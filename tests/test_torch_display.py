"""Port parity: the display path of dxrpathtracer_tpu_torch (post-processing,
EXR output, the `render` command) against dxrpathtracer_tpu.

  - `bloom_pass`, `post_process`, `resolve_weighted` and the filmic curve on
    seeded HDR images, odd sizes included (33x17: the half-size bloom
    crops a row and a column, and the bilinear upscale is not exactly 2x),
    against the JAX package's functions: rtol 1e-5, atol 1e-6 (torch's
    bilinear upscale and mean take other summation orders than
    jax.image.resize's weight products and XLA's reduction).
  - EXR: files written by the port and by the JAX package are byte-equal
    (zip, zips and none; half and float); each reads the other's.
  - `python -m dxrpathtracer_tpu_torch render --device cpu` on BoxTest 32x32:
    its PNG against the JAX package's `display_image` of the same render,
    every 8-bit value within 1 (the JAX frame is jitted, so XLA may fuse
    products that the port rounds one by one), and its EXR read back equal
    to the session's accumulation; a missing card raises, in raster
    mode too.
  - The bake writes `.exr`.
"""

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from dxrpathtracer_tpu.render import exr as jexr  # noqa: E402
from dxrpathtracer_tpu.render import postfx as jpostfx  # noqa: E402
from dxrpathtracer_tpu_torch.app import cli  # noqa: E402
from dxrpathtracer_tpu_torch.core.constants import FP16Scale  # noqa: E402
from dxrpathtracer_tpu_torch.render import exr, postfx  # noqa: E402
from dxrpathtracer_tpu_torch.render.film import read_exr, write_image  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
SIZES = [(32, 48), (33, 17), (17, 33), (2, 2), (5, 1)]


def _hdr(h, w, seed):
    """Seeded HDR radiance: mostly 0-2, a few fireflies up to 2000."""
    rng = np.random.default_rng(seed)
    img = rng.gamma(0.7, 0.6, (h, w, 3)).astype(np.float32)
    spikes = rng.random((h, w)) < 0.02
    img[spikes] *= 1000.0
    return img


@pytest.mark.parametrize("h,w", SIZES)
def test_bloom_and_post_process_match_jax(h, w):
    img = _hdr(h, w, seed=h * 100 + w)
    t = torch.from_numpy(img)
    if h >= 2 and w >= 2:
        got = postfx.bloom_pass(t, 1.5).numpy()
        want = np.asarray(jpostfx.bloom_pass(jnp.asarray(img), 1.5))
        assert got.shape == want.shape == (h // 2, w // 2, 3)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        up = postfx._upscale_bilinear_2x(torch.tensor(want), h, w)
        np.testing.assert_allclose(
            up.numpy(), np.asarray(jpostfx._upscale_bilinear_2x(
                jnp.asarray(want), h, w)), rtol=RTOL, atol=ATOL)
    for kw in (dict(exposure=0.0, bloom_exposure=-4.0, bloom_magnitude=1.0,
                    bloom_blur_sigma=2.5),
               dict(exposure=-14.0, bloom_exposure=2.0, bloom_magnitude=0.5,
                    bloom_blur_sigma=1.0)):
        got = postfx.post_process(t * 16384.0, **kw).numpy()
        want = np.asarray(jpostfx.post_process(jnp.asarray(img * 16384.0),
                                               **kw))
        assert got.shape == (h, w, 3)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the chain without bloom: the exposure scale, then the tone curve
    got = postfx.tone_map_filmic_alu(t * 16384.0 * (2.0 ** -14.0 / FP16Scale))
    want = jpostfx.post_process(jnp.asarray(img * 16384.0), exposure=-14.0,
                                bloom_exposure=2.0, bloom_magnitude=0.5,
                                bloom_blur_sigma=1.0, enable_bloom=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_tone_curve_and_weighted_resolve_match_jax():
    img = _hdr(33, 17, seed=7)
    np.testing.assert_array_equal(
        postfx.tone_map_filmic_alu(torch.from_numpy(img)).numpy(),
        np.asarray(jpostfx.tone_map_filmic_alu(jnp.asarray(img))))
    samples = np.stack([_hdr(33, 17, seed=s) * 4000.0 for s in range(4)])
    samples[1, 3, 5] = -2.0  # clamped to 0
    for exposure in (-14.0, 0.0):
        got = postfx.resolve_weighted(torch.from_numpy(samples), exposure)
        want = jpostfx.resolve_weighted(jnp.asarray(samples), exposure)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("compression", ["zip", "zips", "none"])
@pytest.mark.parametrize("pixel_type", ["half", "float"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_exr_bytes_equal_jax(tmp_path, compression, pixel_type, channels):
    img = _hdr(19, 23, seed=channels)[..., :1].repeat(channels, -1) \
        if channels == 1 else np.concatenate(
            [_hdr(19, 23, seed=channels)] * 2, -1)[..., :channels]
    mine, theirs = tmp_path / "port.exr", tmp_path / "jax.exr"
    exr.write_exr(mine, img, compression=compression, pixel_type=pixel_type)
    jexr.write_exr(theirs, img, compression=compression, pixel_type=pixel_type)
    assert mine.read_bytes() == theirs.read_bytes()
    a, names_a = exr.read_exr(theirs)
    b, names_b = jexr.read_exr(mine)
    assert names_a == names_b
    np.testing.assert_array_equal(a, b)
    want = img.astype(np.float16).astype(np.float32) \
        if pixel_type == "half" else img
    np.testing.assert_array_equal(a, want)


def _read_png(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def test_render_command_matches_jax_display_image(tmp_path):
    from dxrpathtracer_tpu.app.session import RenderSession as JSession
    from dxrpathtracer_tpu.app.settings import AppSettings as JSettings
    from dxrpathtracer_tpu.app.settings import Scenes as JScenes
    from dxrpathtracer_tpu.render.film import to_uint8
    png, hdr = tmp_path / "render.png", tmp_path / "render.exr"
    cli.main(["render", "--current-scene", "BoxTest", "--width", "32",
              "--height", "32", "--sqrt-num-samples", "2", "--output",
              str(png), "--save-hdr", str(hdr), "--device", "cpu"])
    got = _read_png(png)
    sess = JSession(settings=JSettings(current_scene=JScenes.BoxTest,
                                       sqrt_num_samples=2),
                    width=32, height=32)
    sess.render_to_completion()
    want = to_uint8(np.asarray(sess.display_image()))
    assert got.shape == want.shape == (32, 32, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    print(f"render --device cpu vs JAX display_image: max |diff| "
          f"{diff.max()}, {np.mean(diff == 0):.4f} of values equal")
    assert diff.max() <= 1
    accum, names = read_exr(hdr)
    assert names == ["R", "G", "B"] and accum.shape == (32, 32, 3)
    np.testing.assert_allclose(accum, np.asarray(sess.accum), rtol=1e-4,
                               atol=1e-6)


def test_render_command_raises_for_raster_and_without_card(tmp_path,
                                                           monkeypatch):
    """Without a card the command raises rather than carry on on the CPU,
    in path-tracing and in raster mode (an unknown shadow mode is refused
    by the parser)."""
    out = str(tmp_path / "x.png")
    monkeypatch.setenv("DXRPT_CRASH_DUMP", str(tmp_path / "crash.json"))
    with pytest.raises(SystemExit):
        cli.main(["render", "--current-scene", "BoxTest", "--width", "8",
                  "--height", "8", "--output", out, "--device", "cpu",
                  "--raster", "--shadow-mode", "vsm"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--raster"], ["--shadow-mode", "pcf", "--raster"],
                  ["--enable-ray-tracing", "false"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["render", "--current-scene", "BoxTest", "--width", "8",
                      "--height", "8", "--output", out, *extra])
    assert (tmp_path / "crash.json").exists()


def test_bake_writes_exr(tmp_path):
    path = tmp_path / "lm.exr"
    cli.main(["bake", "--current-scene", "BoxTest", "--resolution", "16",
              "--atlas", "pair", "--samples", "1", "--output", str(path),
              "--device", "cpu"])
    lm, names = read_exr(path)
    assert names == ["R", "G", "B"] and lm.shape == (16, 16, 3)
    assert np.isfinite(lm).all() and lm.max() > 0.0
    write_image(tmp_path / "again.exr", lm)
    np.testing.assert_array_equal(read_exr(tmp_path / "again.exr")[0], lm)
