"""Port parity: core/ of dxrpathtracer_tpu_torch against dxrpathtracer_tpu.

Inputs are made with numpy from a seed and handed to both packages. CMJ must
match bit for bit; the float sampling and BRDF functions within rtol 1e-6,
atol 1e-7 (both sides are float32; the sampling tests share XLA's sin/cos, see
`jax_primitives`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from dxrpathtracer_tpu.core import brdf as jbrdf  # noqa: E402
from dxrpathtracer_tpu.core import cmj as jcmj  # noqa: E402
from dxrpathtracer_tpu.core import sampling as jsampling  # noqa: E402
from dxrpathtracer_tpu_torch.core import brdf as tbrdf  # noqa: E402
from dxrpathtracer_tpu_torch.core import cmj as tcmj  # noqa: E402
from dxrpathtracer_tpu_torch.core import math3 as tmath3  # noqa: E402
from dxrpathtracer_tpu_torch.core import sampling as tsampling  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7


def _patterns(kind: str, rng):
    """Per-pixel CMJ patterns as uint32: plain pixel indices, or the
    set * total_pixels + pixel values the integrator forms, which wrap past
    2^32 for late sample sets."""
    pixel = np.arange(4096, dtype=np.uint64)
    if kind == "pixels":
        return pixel.astype(np.uint32)
    total = 1920 * 1080
    sets = rng.integers(1, 4000, size=pixel.shape).astype(np.uint64)
    wide = sets * np.uint64(total) + pixel
    assert (wide >= 2 ** 32).any()  # the wrap is exercised
    return (wide & np.uint64(0xFFFFFFFF)).astype(np.uint32)


@pytest.mark.parametrize("sqrt_n", [1, 2, 4])
@pytest.mark.parametrize("kind", ["pixels", "wrapped"])
def test_sample_cmj_2d_bit_exact(sqrt_n, kind):
    # The reference runs op by op (not under jax.jit, where XLA may contract
    # a multiply-add into an FMA): that is the function as written.
    pattern = _patterns(kind, np.random.default_rng(7))
    samples = np.arange(64, dtype=np.uint32)[:, None]    # (64, 1) x (4096,)
    ref = np.asarray(jcmj.sample_cmj_2d(jnp.asarray(samples), sqrt_n, sqrt_n,
                                        jnp.asarray(pattern)))
    pat_t = torch.from_numpy(pattern.astype(np.int64))
    for sample_idx in range(64):
        got = tcmj.sample_cmj_2d(sample_idx, sqrt_n, sqrt_n, pat_t).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      ref[sample_idx].view(np.uint32))


def test_cmj_permute_and_rand_float_bit_exact():
    rng = np.random.default_rng(3)
    i = rng.integers(0, 2 ** 32, size=5000, dtype=np.uint64).astype(np.uint32)
    p = rng.integers(0, 2 ** 32, size=5000, dtype=np.uint64).astype(np.uint32)
    it, pt = (torch.from_numpy(a.astype(np.int64)) for a in (i, p))
    for l in (1, 3, 16, 1000):
        ref = np.asarray(jcmj.cmj_permute(jnp.asarray(i % l), l,
                                          jnp.asarray(p)))
        got = tcmj.cmj_permute(it % l, l, pt).numpy()
        np.testing.assert_array_equal(got, ref.astype(np.int64))
    ref = np.asarray(jcmj.cmj_rand_float(jnp.asarray(i), jnp.asarray(p)))
    got = tcmj.cmj_rand_float(it, pt).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def _unit(rng, n):
    v = rng.standard_normal((n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _both(fn_j, fn_t, *args):
    ref = fn_j(*[jnp.asarray(a) for a in args])
    got = fn_t(*[torch.from_numpy(np.ascontiguousarray(a)) for a in args])
    if isinstance(ref, tuple):
        return [np.asarray(r) for r in ref], [g.numpy() for g in got]
    return [np.asarray(ref)], [got.numpy()]


def _assert_close(refs, gots):
    for r, g in zip(refs, gots):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)


@pytest.fixture()
def jax_primitives(monkeypatch):
    """The port's sampling module takes sin, cos, the vector norm and the
    cross product from XLA.

    Those primitives round differently in the last ulp in about 1 % of lanes
    (torch's and XLA's sin/cos are different approximations; jnp.linalg.norm
    and jnp.cross run jitted, and XLA contracts their multiply-adds into
    FMAs), and
    sqrt(1 - x) near x = 1 (the hemisphere rim) magnifies one ulp past
    rtol 1e-6. With the primitives shared, what remains is the port's own
    arithmetic, which must meet the stated tolerance in every lane."""
    def via_jax(fn):
        return lambda x: torch.from_numpy(np.array(fn(jnp.asarray(x.numpy()))))
    monkeypatch.setattr(tsampling, "cos", via_jax(jnp.cos))
    monkeypatch.setattr(tsampling, "sin", via_jax(jnp.sin))
    monkeypatch.setattr(tsampling, "_norm", via_jax(
        lambda v: jnp.linalg.norm(v, axis=-1, keepdims=True)))
    monkeypatch.setattr(tsampling, "cross", lambda a, b: torch.from_numpy(
        np.array(jnp.cross(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))))


def test_trig_correctly_rounded():
    x = np.random.default_rng(10).uniform(-7, 7, 100000).astype(np.float32)
    for fn, ref in ((tmath3.sin, np.sin), (tmath3.cos, np.cos),
                    (tmath3.sqrt, np.sqrt)):
        arg = np.abs(x) if ref is np.sqrt else x
        want = ref(arg.astype(np.float64)).astype(np.float32)
        np.testing.assert_array_equal(fn(torch.from_numpy(arg)).numpy(), want)


def test_sample_cosine_hemisphere(jax_primitives):
    rng = np.random.default_rng(11)
    u1, u2 = rng.random((2, 8192), dtype=np.float32)
    u1[:4] = [0.0, 0.5, 1.0, 0.5]  # region boundaries and the disk center
    u2[:4] = [0.5, 0.5, 0.5, 0.0]
    _assert_close(*_both(jsampling.sample_cosine_hemisphere,
                         tsampling.sample_cosine_hemisphere, u1, u2))


def test_sample_ggx_visible_normal(jax_primitives):
    rng = np.random.default_rng(12)
    n = 8192
    wo = _unit(rng, n)
    wo[:, 2] = np.abs(wo[:, 2])
    wo[0] = (0.0, 0.0, 1.0)  # the v.z >= 0.999 basis branch
    rough = rng.uniform(0.02, 1.0, n).astype(np.float32)
    u1, u2 = rng.random((2, n), dtype=np.float32)
    _assert_close(*_both(jsampling.sample_ggx_visible_normal,
                         tsampling.sample_ggx_visible_normal,
                         wo, rough, rough, u1, u2))


@pytest.mark.parametrize("name", [
    "fresnel", "ggx_specular", "smith_ggx_masking",
    "smith_ggx_masking_shadowing", "ggx_environment_brdf_scale_bias",
    "calc_lighting"])
def test_brdf_functions(name):
    rng = np.random.default_rng(13)
    n = 4096
    nrm, l, v = _unit(rng, n), _unit(rng, n), _unit(rng, n)
    h = (l + v) / np.linalg.norm(l + v, axis=1, keepdims=True)
    spec = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    spec[:8] = 0.0005  # below the 0.1 % albedo fade
    rough = rng.uniform(0.02, 1.0, n).astype(np.float32)
    ndv = rng.uniform(0.0, 1.0, n).astype(np.float32)
    args = {
        "fresnel": (spec, h.astype(np.float32), l),
        "ggx_specular": (rough, nrm, h.astype(np.float32), v, l),
        "smith_ggx_masking": (nrm, l, v, rough * rough),
        "smith_ggx_masking_shadowing": (nrm, l, v, rough * rough),
        "ggx_environment_brdf_scale_bias": (ndv, np.sqrt(rough)),
        "calc_lighting": (nrm, l, rng.uniform(0, 90, (n, 3)).astype(np.float32),
                          rng.random((n, 3), dtype=np.float32), spec, rough,
                          rng.standard_normal((n, 3)).astype(np.float32),
                          rng.standard_normal((n, 3)).astype(np.float32),
                          1.0 + rng.random((n, 3), dtype=np.float32)),
    }[name]
    _assert_close(*_both(getattr(jbrdf, name), getattr(tbrdf, name), *args))
