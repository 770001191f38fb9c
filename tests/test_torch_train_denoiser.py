"""Port parity: dxrpathtracer_tpu_torch/tools/train_denoiser.py against the
JAX repository's tools/train_denoiser.py, on the CPU at a small size (maps of
48x40, patches of 16, batch 4, 6 steps) made from a numpy seed.

  - make_patches: the same seed and pairs give the same crops (the same
    draws, the coverage test included), masks and log-references exactly,
    and features within test_torch_denoise.py's learned tolerance (rtol
    1e-4, atol 1e-5: the guided filter's exp and log1p, the convolutions'
    order);
  - denoise_loss and its gradients against jax.value_and_grad of the JAX
    loss expression, with covered texels whose guided value is 0 in the
    batch: at init (zero head) each is a tie of max(x, 0), whose gradient
    JAX splits in half, and where the reference is 0 too, of |0|, whose
    gradient JAX takes as +1 (the test shows that clamp_min's or
    torch.abs's would differ); loss rtol 1e-5, gradients within GRAD_RTOL
    (1e-5) of each layer's largest gradient (they differ by ~1e-6: the
    convolutions sum in another order than XLA's);
  - train from JAX's init_params against JAX's train with the same seed:
    per-step losses within 6e-6 of the 5-decimal losses JAX prints, the
    weights after 6 steps within WEIGHT_ATOL, a tenth of lr: Adam moves a
    weight by up to ~lr a step whatever its gradient's size, so it
    amplifies the gradients' rounding (~1e-6 of each layer's largest) where
    a gradient is small, and a gradient that rounding pushed across 0
    would move its weight the other way, by ~2 lr; below lr/10 no update
    went another way (1.2e-5 at most, read on an x86 host);
  - the learning rate at every step against optax.cosine_decay_schedule,
    as cosine_lr and as CosineAdam applies it, and CosineAdam against
    optax.adam under that schedule on the same gradients, within one
    float32 ulp;
  - evaluate's rows against the numbers the JAX evaluate prints (4
    decimals), a pair with an empty mask skipped by both;
  - the --dataset-cache npz written by either package's main and read by
    the other's;
  - bake_dataset on BoxTest at 32 (spps 1 and 2, 4 reference samples)
    against the port's own Baker snapshots, bit for bit;
  - both tools' --device default to the card and raise without one.
"""

import re
import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
optax = pytest.importorskip("optax")

import tools.train_denoiser as jtd  # noqa: E402
from dxrpathtracer_tpu.render import learned_denoise as jlearn  # noqa: E402
from dxrpathtracer_tpu_torch.app.session import RenderSession  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes  # noqa: E402
from dxrpathtracer_tpu_torch.bake import baker as tbaker  # noqa: E402
from dxrpathtracer_tpu_torch.convert import denoiser_params_from_numpy  # noqa: E402
from dxrpathtracer_tpu_torch.render import learned_denoise as tlearn  # noqa: E402
from dxrpathtracer_tpu_torch.tools import make_denoise_eval as tmake  # noqa: E402
from dxrpathtracer_tpu_torch.tools import train_denoiser as ttd  # noqa: E402

FEAT_RTOL, FEAT_ATOL = 1e-4, 1e-5
GRAD_RTOL = 1e-5
PATCH, BATCH, STEPS, LR, SEED = 16, 4, 6, 1e-3, 0
WEIGHT_ATOL = LR / 10
# one float32 ulp of a parameter below 4 in magnitude: optax's operations,
# one rounding apart
ADAM_ATOL = 2.4e-7
_STEP_LINE = re.compile(r"step (\d+)/\d+ loss ([0-9.]+)")
_EVAL_LINE = re.compile(r"eval: noisy ([0-9.]+)  guided ([0-9.]+)  "
                        r"learned ([0-9.]+)")


def _pair(seed, h=48, w=40):
    """(noisy, ref, albedo, normal, valid) as a bake leaves them: fireflies
    in the noisy map, a hole and an uncovered band (so that some crops
    fail the coverage test), a black patch, unit normals, piecewise
    albedo."""
    rng = np.random.default_rng(seed)
    ref = rng.gamma(3.0, 0.4, (h, w, 3)).astype(np.float32)
    noisy = (ref * rng.gamma(2.0, 0.5, (h, w, 3))).astype(np.float32)
    noisy[rng.random((h, w)) < 0.02] *= 40.0
    valid = np.ones((h, w), bool)
    valid[:, : w // 3] = False
    valid[h // 2:h // 2 + 6, w // 2:w // 2 + 8] = False
    black = (slice(4, 14), slice(w - 12, w - 2))
    noisy[black] = 0.0
    ref[black] = 0.0
    noisy[~valid] = 0.0
    ref[~valid] = 0.0
    nrm = rng.standard_normal((h, w, 3)).astype(np.float32)
    nrm[h // 2:] = (0.0, 1.0, 0.0)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    albedo = np.where(np.arange(w)[None, :, None] < w // 2, 0.7, 0.25)
    albedo = np.broadcast_to(albedo, (h, w, 3)).astype(np.float32).copy()
    return noisy, ref, albedo, nrm, valid


def _pairs():
    return [_pair(0), _pair(1)]


def _jax_params(seed, head_scale=0.0):
    """JAX init_params, the head replaced by a seeded normal draw when
    head_scale > 0 (so that every layer gets a gradient)."""
    params = [(np.asarray(w), np.asarray(b))
              for w, b in jlearn.init_params(jax.random.PRNGKey(seed))]
    if head_scale:
        rng = np.random.default_rng(seed + 100)
        w, b = params[-1]
        params[-1] = ((head_scale * rng.standard_normal(w.shape))
                      .astype(np.float32),
                      (0.1 * head_scale * rng.standard_normal(b.shape))
                      .astype(np.float32))
    return params


def _net(params):
    net = tlearn.DenoiserNet()
    net.load_state_dict(denoiser_params_from_numpy(params))
    return net


def _hwio(net):
    return [(c.weight.detach().numpy().transpose(2, 3, 1, 0),
             c.bias.detach().numpy()) for c in net.layers]


def _nchw(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
            for a in arrays]


@pytest.fixture(scope="module")
def patches():
    """JAX make_patches and the port's on the same pairs and seed, with
    both generators' states after."""
    pairs = _pairs()
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    want = jtd.make_patches(pairs, PATCH, 16, rj)
    got = ttd.make_patches(pairs, PATCH, 16, rt, device="cpu")
    return want, got, rj.bit_generator.state, rt.bit_generator.state


def test_make_patches_matches_jax(patches):
    (jf, jr, jm), (tf, tr, tm), jstate, tstate = patches
    assert tstate == jstate  # the same draws, rejected crops included
    assert tf.shape == jf.shape == (16, PATCH, PATCH, tlearn.IN_CHANNELS)
    assert tf.dtype == tr.dtype == tm.dtype == np.float32
    assert tr.tobytes() == jr.tobytes() and tm.tobytes() == jm.tobytes()
    assert 0.0 < tm.mean() < 1.0
    np.testing.assert_allclose(tf, jf, rtol=FEAT_RTOL, atol=FEAT_ATOL)


def _jax_loss(params, f, r, m):
    """The JAX trainer's loss_fn (tools/train_denoiser.py:111-115)."""
    res = jlearn.apply_net(params, f)
    out = jnp.maximum(f[..., 3:6] + res, 0.0)
    return jnp.sum(jnp.abs(out - r) * m) / (jnp.sum(m) * 3.0 + 1e-6)


def _grads(net):
    return [(c.weight.grad.numpy().transpose(2, 3, 1, 0), c.bias.grad.numpy())
            for c in net.layers]


def _close(got, want):
    for i, ((gw, gb), (ww, wb)) in enumerate(zip(got, want)):
        for g, w in ((gw, ww), (gb, wb)):
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * scale,
                                       err_msg=f"layer {i}")


def _max0(x, zero):
    return torch.maximum(x, x.new_full((), zero))


def _abs_jax(d):
    return torch.where(d >= 0, d, -d)


@pytest.mark.parametrize("head", ["zero", "random"])
def test_loss_and_gradients_match_jax(patches, head):
    """One batch of the JAX patches, texels with a guided value of 0 on
    covered texels among them; the loss and every layer's gradient."""
    (f, r, m), _, _, _ = patches
    f, r, m = f[:BATCH].copy(), r[:BATCH], m[:BATCH].copy()
    # a covered black corner: the guided output is 0 there (a bake's
    # unlit texels; the guided filter's reach spreads light over the
    # synthetic maps' black patch)
    f[:, :5, :5, 3:6] = 0.0
    f[:, :5, :5, 12] = 1.0
    m[:, :5, :5] = 1.0
    ties = int(((f[..., 3:6] == 0.0) & (m > 0)).sum())
    assert ties >= BATCH * 75
    params = _jax_params(SEED, 0.0 if head == "zero" else 0.05)
    loss, grads = jax.value_and_grad(_jax_loss)(
        [(jnp.asarray(w), jnp.asarray(b)) for w, b in params],
        jnp.asarray(f), jnp.asarray(r), jnp.asarray(m))
    grads = [(np.asarray(w), np.asarray(b)) for w, b in grads]
    net = _net(params)
    got = ttd.denoise_loss(net, *_nchw(f, r, m))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    _close(_grads(net), grads)
    if head == "zero":
        # the hidden layers' gradients are exactly 0 behind a zero head
        assert all(not np.any(w) for w, _ in _grads(net)[:-1])
        # clamp_min passes a tie's whole gradient, torch.abs none at 0:
        # either would give the head another gradient
        assert int(((f[..., 3:6] == 0) & (r == 0) & (m > 0)).sum()) > 0
        tf_, tr_, tm_ = _nchw(f, r, m)
        for floor, absf in ((torch.clamp_min, _abs_jax), (_max0, torch.abs)):
            net.zero_grad()
            d = floor(tf_[:, 3:6] + net(tf_), 0.0) - tr_
            (torch.sum(absf(d) * tm_) / (torch.sum(tm_) * 3.0 + 1e-6)
             ).backward()
            with pytest.raises(AssertionError):
                _close(_grads(net)[-1:], grads[-1:])


def test_train_matches_jax(patches, capsys):
    (f, r, m), _, _, _ = patches
    want = jtd.train(f, r, m, STEPS, BATCH, LR, SEED, log_every=1)
    printed = {int(s): float(v) for s, v in
               _STEP_LINE.findall(capsys.readouterr().err)}
    assert sorted(printed) == list(range(1, STEPS + 1))
    net, losses = ttd.train(f, r, m, STEPS, BATCH, LR, SEED,
                            net=_net(_jax_params(SEED)), log_every=1,
                            device="cpu")
    assert losses.shape == (STEPS,) and np.isfinite(losses).all()
    # JAX prints 5 decimals: half a unit of the last, and 1e-6 of rounding
    np.testing.assert_allclose(losses, [printed[i + 1] for i in range(STEPS)],
                               rtol=0, atol=6e-6)
    for (gw, gb), (ww, wb) in zip(_hwio(net), want):
        np.testing.assert_allclose(gw, np.asarray(ww), rtol=0,
                                   atol=WEIGHT_ATOL)
        np.testing.assert_allclose(gb, np.asarray(wb), rtol=0,
                                   atol=WEIGHT_ATOL)
    # the first step moved only the head; every layer has moved by now
    init = _jax_params(SEED)
    assert all(np.any(g != w0) for (g, _), (w0, _) in zip(_hwio(net), init))


def test_learning_rate_matches_optax_schedule():
    """cosine_lr against optax's schedule at every update, past the last
    too; CosineAdam applies it: under a constant gradient of 1 (mu_hat =
    nu_hat = 1) update i moves a float64 parameter by lr_i / (1 + eps)."""
    sched = optax.cosine_decay_schedule(LR, STEPS, alpha=0.05)
    param = torch.zeros(1, dtype=torch.float64)
    opt = ttd.CosineAdam([param], LR, STEPS)
    for i in range(STEPS + 3):
        want = float(sched(jnp.int32(i)))
        assert ttd.cosine_lr(i, LR, STEPS) == pytest.approx(want, rel=1e-6)
        before = float(param)
        param.grad = torch.ones_like(param)
        opt.step()
        assert (before - float(param)) * (1 + ttd.EPS) == pytest.approx(
            want, rel=1e-6)
    with pytest.raises(ValueError):
        ttd.CosineAdam([param], LR, 0)


def test_adam_updates_match_optax():
    """CosineAdam against optax.adam under the cosine schedule, fed the same
    gradients (gradients near 0 included), past the schedule's end: the
    parameters after every step within ADAM_ATOL."""
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal(257).astype(np.float32)
    grads = rng.standard_normal((STEPS + 2, 257)).astype(np.float32)
    grads[:, :32] *= 1e-7
    opt = optax.adam(optax.cosine_decay_schedule(LR, STEPS, alpha=0.05))
    p = jnp.asarray(p0)
    state = opt.init(p)
    param = torch.from_numpy(p0.copy())
    topt = ttd.CosineAdam([param], LR, STEPS)
    worst = 0.0
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, upd)
        param.grad = torch.from_numpy(g.copy())
        topt.step()
        worst = max(worst, float(np.abs(param.numpy() - np.asarray(p)).max()))
    print(f"\nCosineAdam vs optax.adam: max |diff| {worst:.3e}")
    assert worst <= ADAM_ATOL


def test_evaluate_matches_jax(tmp_path, capsys):
    """A net with a head that is not zero, saved and read by both packages;
    the second pair's mask is empty."""
    params = _jax_params(SEED, 0.05)
    path = tmp_path / "w.npz"
    tlearn.save_net(_net(params), path)
    pairs = _pairs()
    empty = list(pairs[1])
    empty[4] = np.zeros_like(empty[4])
    pairs = [pairs[0], tuple(empty)]
    jtd.evaluate(jlearn.load_params(str(path)), pairs)
    err = capsys.readouterr().err
    want = [tuple(map(float, row)) for row in _EVAL_LINE.findall(err)]
    assert len(want) == 1 and "SKIPPED" in err
    rows = ttd.evaluate(tlearn.load_net("cpu", path), pairs)
    assert rows[1] is None and "SKIPPED" in capsys.readouterr().err
    np.testing.assert_allclose(rows[0], want[0], rtol=0, atol=6e-5)
    assert rows[0][2] != rows[0][1]  # the net changed the guided output


def _main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train_denoiser", *argv])
    module.main()


def test_dataset_cache_moves_both_ways(tmp_path, monkeypatch):
    """Each package's main bakes (its bake_dataset replaced by the
    synthetic pairs) into --dataset-cache; the other package's loader and
    main read it back; the pairs and their dtypes survive exactly."""
    pairs = _pairs()
    small = ["--patch", str(PATCH), "--patches", "4", "--steps", "1",
             "--batch", "2", "--scenes", "BoxTest"]
    monkeypatch.setattr(jtd, "bake_dataset", lambda *a: [pairs[0]])
    monkeypatch.setattr(ttd, "bake_dataset", lambda *a: [pairs[1]])
    jcache, tcache = tmp_path / "jax.npz", tmp_path / "port.npz"
    _main(jtd, [*small, "--dataset-cache", str(jcache),
                "--out", str(tmp_path / "jw.npz")], monkeypatch)
    ttd.main([*small, "--dataset-cache", str(tcache), "--device", "cpu",
              "--out", str(tmp_path / "tw.npz")])
    for cache, pair in ((jcache, pairs[0]), (tcache, pairs[1])):
        (got,) = ttd.load_dataset(cache)
        for a, b in zip(got, pair):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # each main reads the other's cache (and bakes nothing)
    monkeypatch.setattr(jtd, "bake_dataset", None)
    monkeypatch.setattr(ttd, "bake_dataset", None)
    _main(jtd, [*small, "--dataset-cache", str(tcache),
                "--out", str(tmp_path / "jw2.npz")], monkeypatch)
    ttd.main([*small, "--dataset-cache", str(jcache), "--device", "cpu",
              "--out", str(tmp_path / "tw2.npz")])
    for name in ("jw2.npz", "tw2.npz"):
        assert len(jlearn.load_params(str(tmp_path / name))) == \
            len(tlearn.ARCH) + 1


def test_bake_dataset_matches_baker(monkeypatch):
    """bake_dataset's pairs equal the snapshots of a Baker driven by hand
    (one charted atlas shared by both: it is the slow host part)."""
    atlases = {}

    def charted(pos, tri, **kw):
        key = (pos.tobytes(), tri.tobytes(), tuple(sorted(kw.items())))
        if key not in atlases:
            atlases[key] = build(pos, tri, **kw)
        return atlases[key]

    build = tbaker.build_charted_atlas
    monkeypatch.setattr(tbaker, "build_charted_atlas", charted)
    pairs = ttd.bake_dataset("BoxTest", 32, (1, 2), 4, device="cpu")
    sess = RenderSession(AppSettings(current_scene=Scenes.BoxTest,
                                     sqrt_num_samples=16), 8, 8,
                         device="cpu")
    baker = tbaker.Baker(sess, resolution=32)
    snaps = []
    for _ in range(4):
        baker.bake_step()
        snaps.append(baker.lightmap().numpy())
    valid = (baker.accum[..., 3] > 0).numpy()
    assert len(atlases) == 1 and len(pairs) == 2 and valid.mean() > 0.5
    for pair, spp in zip(pairs, (1, 2)):
        want = (snaps[spp - 1], snaps[3], baker.surface_maps["albedo"].numpy(),
                baker.surface_maps["normal"].numpy(), valid)
        for a, b in zip(pair, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_tools_default_to_the_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttd.main(["--out", str(tmp_path / "w.npz")])
    with pytest.raises(RuntimeError, match="CUDA"):
        ttd.train(np.zeros((1, PATCH, PATCH, 13), np.float32),
                  np.zeros((1, PATCH, PATCH, 3), np.float32),
                  np.ones((1, PATCH, PATCH, 1), np.float32), 1, 1, LR, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmake.main(["--out", str(tmp_path / "e.npz"), "--scene", "BoxTest"])
    assert not list(tmp_path.iterdir())
