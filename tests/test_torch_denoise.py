"""Port parity: render/denoise.py and render/learned_denoise.py of
dxrpathtracer_tpu_torch against dxrpathtracer_tpu, on images made from a
numpy seed.

  - median_filter_3x3 equals the JAX median exactly, on random images with
    luminance ties (repeated pixels): both sort stably;
  - atrous_denoise and guided_bilateral_denoise within rtol 1e-5, atol 1e-6
    (exp and log1p are library calls that may differ by an ulp);
  - learned_denoise with the repository's weights, on one tile and on a
    multi-tile case (small tile and overlap), within rtol 1e-4, atol 1e-5:
    convolutions sum in another order than XLA's.
"""

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from dxrpathtracer_tpu.render import denoise as jden  # noqa: E402
from dxrpathtracer_tpu.render import learned_denoise as jlearn  # noqa: E402
from dxrpathtracer_tpu_torch.convert import (denoiser_params_from_numpy,  # noqa: E402
                                             load_denoiser_weights)
from dxrpathtracer_tpu_torch.render import denoise as tden  # noqa: E402
from dxrpathtracer_tpu_torch.render import learned_denoise as tlearn  # noqa: E402

FILTER_RTOL, FILTER_ATOL = 1e-5, 1e-6
LEARNED_RTOL, LEARNED_ATOL = 1e-4, 1e-5


def _lightmap(seed, h, w):
    """A noisy HDR map with fireflies, a coverage hole, unit normals and
    piecewise albedo, as a bake leaves them."""
    rng = np.random.default_rng(seed)
    img = rng.gamma(2.0, 0.5, (h, w, 3)).astype(np.float32)
    img[rng.random((h, w)) < 0.02] *= 50.0  # fireflies
    valid = np.ones((h, w), bool)
    valid[h // 3:h // 2, w // 4:w // 2] = False
    img[~valid] = 0.0
    nrm = rng.standard_normal((h, w, 3)).astype(np.float32)
    nrm[:, : w // 2] = (0.0, 1.0, 0.0)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    albedo = np.where(np.arange(w)[None, :, None] < w // 3, 0.8, 0.3)
    albedo = np.broadcast_to(albedo, (h, w, 3)).astype(np.float32).copy()
    return img, albedo, nrm, valid


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_median_equals_jax_exactly(seed):
    rng = np.random.default_rng(seed)
    img = rng.random((23, 31, 3)).astype(np.float32)
    # ties: a palette of a few pixel values repeated across the image, and
    # constant rows
    palette = rng.random((4, 3)).astype(np.float32)
    pick = rng.random((23, 31)) < 0.5
    img[pick] = palette[rng.integers(0, 4, pick.sum())]
    img[5] = palette[0]
    want = np.asarray(jden.median_filter_3x3(jnp.asarray(img)))
    got = tden.median_filter_3x3(torch.from_numpy(img)).numpy()
    assert got.tobytes() == want.tobytes()


def test_median_removes_impulse():
    img = np.full((16, 16, 3), 0.5, np.float32)
    img[8, 8] = 100.0  # firefly
    out = tden.median_filter_3x3(torch.from_numpy(img)).numpy()
    assert np.allclose(out, 0.5, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_atrous_matches_jax(masked):
    img, _, _, valid = _lightmap(3, 40, 36)
    v = valid if masked else None
    want = np.asarray(jden.atrous_denoise(
        jnp.asarray(img), valid=None if v is None else jnp.asarray(v)))
    timg, tv = _t(img, valid)
    got = tden.atrous_denoise(timg, valid=tv if masked else None).numpy()
    np.testing.assert_allclose(got, want, rtol=FILTER_RTOL, atol=FILTER_ATOL)


def test_guided_matches_jax():
    img, albedo, nrm, valid = _lightmap(4, 40, 36)
    want = np.asarray(jden.guided_bilateral_denoise(
        jnp.asarray(img), jnp.asarray(albedo), jnp.asarray(nrm),
        valid=jnp.asarray(valid)))
    got = tden.guided_bilateral_denoise(*_t(img, albedo, nrm),
                                        valid=_t(valid)[0]).numpy()
    np.testing.assert_allclose(got, want, rtol=FILTER_RTOL, atol=FILTER_ATOL)


def test_denoiser_weights_convert():
    params = load_denoiser_weights()
    net = tlearn.DenoiserNet()
    net.load_state_dict(denoiser_params_from_numpy(params))
    assert len(params) == len(tlearn.ARCH) + 1
    w0 = net.layers[0].weight.detach().numpy()
    np.testing.assert_array_equal(w0, params[0][0].transpose(3, 2, 0, 1))


@pytest.mark.parametrize("shape,tile,overlap", [
    ((40, 36), 512, 64),   # one tile
    ((70, 52), 32, 6),     # several overlapping tiles
])
def test_learned_matches_jax(shape, tile, overlap):
    img, albedo, nrm, valid = _lightmap(5, *shape)
    want = np.asarray(jlearn.learned_denoise(
        jnp.asarray(img), jnp.asarray(albedo), jnp.asarray(nrm),
        valid=jnp.asarray(valid), tile=tile, overlap=overlap))
    got = tlearn.learned_denoise(*_t(img, albedo, nrm), valid=_t(valid)[0],
                                 tile=tile, overlap=overlap).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LEARNED_RTOL,
                               atol=LEARNED_ATOL)
