"""Port parity: render/denoise.py and render/learned_denoise.py of
dxrpathtracer_tpu_torch against dxrpathtracer_tpu, on images made from a
numpy seed.

  - median_filter_3x3 equals the JAX median exactly, on random images with
    luminance ties (repeated pixels): both sort stably;
  - atrous_denoise and guided_bilateral_denoise within rtol 1e-5, atol 1e-6
    (exp and log1p are library calls that may differ by an ulp);
  - learned_denoise with the repository's weights, on one tile and on a
    multi-tile case (small tile and overlap), within rtol 1e-4, atol 1e-5:
    convolutions sum in another order than XLA's;
  - the training API: init_net keeps JAX init_params' scheme (shapes,
    He-normal std, zero biases and head, deterministic per seed); save_net
    -> JAX load_params -> apply_net equals the port's forward within the
    learned tolerance, and load_net reads it back exactly.
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


def test_init_net_scheme():
    """init_net keeps JAX init_params' scheme (its draws come from a
    torch.Generator, not threefry): the layers' HWIO shapes, He-normal
    weights of std sqrt(2 / (9 cin)), zero biases and a zero head; the same
    seed gives the same net."""
    import jax
    want = [(tuple(w.shape), tuple(b.shape))
            for w, b in jlearn.init_params(jax.random.PRNGKey(0))]
    net = tlearn.init_net(torch.Generator().manual_seed(5))
    got = [(tuple(c.weight.permute(2, 3, 1, 0).shape), tuple(c.bias.shape))
           for c in net.layers]
    assert got == want
    cin = tlearn.IN_CHANNELS
    for conv, (cout, _) in zip(net.layers[:-1], tlearn.ARCH):
        std = float(conv.weight.detach().std())
        assert abs(std / np.sqrt(2.0 / (9 * cin)) - 1.0) < 0.1, std
        assert not bool(conv.bias.any())
        cin = cout
    assert not bool(net.layers[-1].weight.any())
    assert not bool(net.layers[-1].bias.any())
    again = tlearn.init_net(torch.Generator().manual_seed(5))
    other = tlearn.init_net(torch.Generator().manual_seed(6))
    for a, b, c in zip(net.parameters(), again.parameters(),
                       other.parameters()):
        assert torch.equal(a, b)
    assert not torch.equal(net.layers[0].weight, other.layers[0].weight)
    # the zero head makes the net the identity on the guided output
    img, albedo, nrm, valid = _t(*_lightmap(7, 24, 20))
    feat, log_g = tlearn.make_features(img, albedo, nrm, valid)
    with torch.no_grad():
        res = net(feat.permute(2, 0, 1)[None])
    assert not bool(res.any())


def test_save_net_round_trips(tmp_path):
    """save_net writes the layout JAX load_params reads: its apply_net on
    the saved weights equals the port's forward within the learned
    tolerance, and the port's load_net reads the file back exactly."""
    gen = torch.Generator().manual_seed(9)
    net = tlearn.init_net(gen)
    with torch.no_grad():  # a head that is not zero, so the output counts
        net.layers[-1].weight.copy_(
            0.05 * torch.randn(net.layers[-1].weight.shape, generator=gen))
        net.layers[-1].bias.copy_(
            0.01 * torch.randn(net.layers[-1].bias.shape, generator=gen))
    path = tmp_path / "weights.npz"
    tlearn.save_net(net, path)
    params = jlearn.load_params(str(path))
    assert len(params) == len(tlearn.ARCH) + 1
    img, albedo, nrm, valid = _lightmap(8, 24, 20)
    feat, _ = tlearn.make_features(*_t(img, albedo, nrm, valid))
    want = np.asarray(jlearn.apply_net(params, jnp.asarray(feat.numpy())[None]))
    with torch.no_grad():
        got = net(feat.permute(2, 0, 1)[None]).permute(0, 2, 3, 1).numpy()
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=LEARNED_RTOL,
                               atol=LEARNED_ATOL)
    back = tlearn.load_net("cpu", path)
    for (k, a), (k2, b) in zip(net.state_dict().items(),
                               back.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
