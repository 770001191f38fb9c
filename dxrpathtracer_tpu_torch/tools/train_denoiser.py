"""Train the learned lightmap denoiser (render/learned_denoise.py) on the card:
`python -m dxrpathtracer_tpu_torch.tools.train_denoiser`.

The port of the JAX repository's denoiser trainer, with its function names,
flags and defaults, plus `--device` (default cuda; without a card it
raises). It bakes (noisy low-spp, converged) lightmap pairs with their
albedo and normal surface maps for a set of scenes through the port's Baker
(on the card: the traversal, gather, grid and proxy kernels), cuts flipped
and rotated patches with enough bake coverage, and fits the residual CNN
on a masked log-space L1 loss with optax's Adam under its cosine-decayed
learning rate, written out (CosineAdam). The JAX package trains with no
Pallas kernel (XLA differentiates its convolutions), so autograd runs
cuDNN's convolutions here, forward and backward, in full float32: TF32
stays off (dxrpathtracer_tpu_torch/__init__.py). cuDNN's backward may sum
in another order from one run to the next.

    python -m dxrpathtracer_tpu_torch.tools.train_denoiser \\
        --scenes BoxTest,Stronghold --resolution 192 \\
        --noisy-spp 1,2,4 --ref-spp 96 --steps 3000 \\
        --dataset-cache pairs.npz

The default scenes include Stronghold, whose stand-in has 246,084
triangles: its charted atlas is built on the host before its bake starts
and takes about a quarter of an hour (each scene's atlas seconds are
printed). `--dataset-cache` keeps the baked pairs in the npz layout of the
JAX trainer's cache (count, noisy{i}, ref{i}, albedo{i}, normal{i},
valid{i}), so either package reuses a cache the other baked. The weights go
to `--out` in the layout both packages' loaders read (save_net).
"""

import argparse
import math
import os
import sys
import time

import numpy as np
import torch

from ..app.session import RenderSession
from ..app.settings import AppSettings, Scenes
from ..bake.baker import Baker
from ..convert import DENOISER_WEIGHTS
from ..render.denoise import despike, guided_bilateral_denoise
from ..render.learned_denoise import (init_net, learned_denoise,
                                      make_features, save_net)

PAIR_KEYS = ("noisy", "ref", "albedo", "normal", "valid")
# optax.adam's defaults, and the floor of the cosine decay (alpha)
BETAS = (0.9, 0.999)
EPS = 1e-8
LR_FLOOR = 0.05


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_denoiser: no CUDA device (pass "
                           "device='cpu' to run on the host)")
    return dev


def bake_dataset(scene_name, resolution, noisy_spps, ref_spp, device="cuda"):
    """Returns (list[(noisy, ref, albedo, normal, valid)]) for one scene:
    host arrays, a pair per noisy spp (ascending), each against the
    `ref_spp` bake; valid is where the bake accumulated a sample."""
    settings = AppSettings(current_scene=Scenes[scene_name],
                           sqrt_num_samples=16)
    sess = RenderSession(settings=settings, width=8, height=8, device=device)
    baker = Baker(sess, resolution=resolution)
    setup = baker.setup_s
    print(f"  {scene_name}: charted atlas {setup['atlas']:.2f}s, texel map "
          f"{setup['texel_map']:.2f}s, surface maps "
          f"{setup['surface_maps']:.2f}s", file=sys.stderr)
    snaps = {}
    t0 = time.time()
    for i in range(ref_spp):
        baker.bake_step()
        if (i + 1) in noisy_spps:
            snaps[i + 1] = baker.lightmap().cpu().numpy()
        if (i + 1) % 16 == 0:
            print(f"  {scene_name}: sample {i + 1}/{ref_spp} "
                  f"({time.time() - t0:.0f}s)", file=sys.stderr)
    ref = baker.lightmap().cpu().numpy()
    valid = (baker.accum[..., 3] > 0.0).cpu().numpy()
    if not valid.any():
        print(f"  WARNING: {scene_name} bake produced ZERO valid texels — "
              f"pairs will be unusable (investigate before training)",
              file=sys.stderr)
    albedo = baker.surface_maps["albedo"].cpu().numpy()
    normal = baker.surface_maps["normal"].cpu().numpy()
    return [(snaps[s], ref, albedo, normal, valid) for s in sorted(snaps)]


@torch.no_grad()
def make_patches(pairs, patch, count, rng, device="cuda"):
    """Random flipped/rotated crops with enough bake coverage, drawn from
    the numpy `rng` in the JAX trainer's order (the same seed gives the
    same crops). Returns float32 (feat (N,P,P,13), log_ref (N,P,P,3),
    mask (N,P,P,1)) host arrays."""
    dev = _device(device)
    # despike once per source image (inference applies the same prefilter)
    prepped = []
    for noisy, ref, albedo, normal, valid in pairs:
        img, alb, nrm, v = (torch.as_tensor(np.ascontiguousarray(a),
                                            device=dev)
                            for a in (noisy, albedo, normal, valid))
        feat, _ = make_features(despike(img), alb, nrm, v)
        prepped.append((feat.cpu().numpy(), ref, valid))

    feats, refs, masks = [], [], []
    tries = 0
    while len(feats) < count and tries < count * 20:
        tries += 1
        feat, ref, valid = prepped[rng.integers(len(prepped))]
        h, w = valid.shape
        y = rng.integers(0, h - patch + 1)
        x = rng.integers(0, w - patch + 1)
        v = valid[y:y + patch, x:x + patch]
        if v.mean() < 0.3:
            continue
        f = feat[y:y + patch, x:x + patch]
        r = np.log1p(np.maximum(ref[y:y + patch, x:x + patch], 0.0))
        k = rng.integers(4)
        f, r, v = (np.rot90(a, k) for a in (f, r, v))
        if rng.integers(2):
            f, r, v = (a[:, ::-1] for a in (f, r, v))
        feats.append(np.ascontiguousarray(f))
        refs.append(np.ascontiguousarray(r))
        masks.append(np.ascontiguousarray(v[..., None].astype(np.float32)))
    if not feats:
        raise ValueError(f"make_patches: no {patch}^2 crop in {tries} tries "
                         f"has 30 % bake coverage")
    return tuple(np.stack(a).astype(np.float32, copy=False)
                 for a in (feats, refs, masks))


def denoise_loss(net, f, r, m):
    """The JAX trainer's loss on NCHW batches: f (N,13,P,P) features, r
    (N,3,P,P) log1p references, m (N,1,P,P) coverage: the mean over covered
    texels of |max(log1p(guided) + residual, 0) - r|, log1p(guided) being
    feature channels 3:6. Its gradient follows JAX's at both ties: at init
    the head is zero, so a covered texel whose guided output is 0 has
    max(0, 0), whose gradient torch.maximum splits in half as jnp.maximum
    does (clamp_min would pass all of it), and where its reference is 0 as
    well, |0|, whose gradient is +1 in JAX and 0 in torch.abs."""
    res = net(f)
    d = torch.maximum(f[:, 3:6] + res, res.new_zeros(())) - r
    return (torch.sum(torch.where(d >= 0, d, -d) * m)
            / (torch.sum(m) * 3.0 + 1e-6))


def cosine_lr(step, lr, steps):
    """optax.cosine_decay_schedule(lr, steps, alpha=LR_FLOOR) at update
    `step` (from 0)."""
    t = min(step, steps) / steps
    return lr * ((1.0 - LR_FLOOR) * 0.5 * (1.0 + math.cos(math.pi * t))
                 + LR_FLOOR)


class CosineAdam:
    """optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=LR_FLOOR)),
    in optax's arithmetic: mu = b1 mu + (1 - b1) g, nu = b2 nu +
    (1 - b2) g^2, both divided by their bias correction 1 - b^t, the update
    -lr_i (mu_hat / (sqrt(nu_hat) + eps)) with eps_root 0, lr_i =
    cosine_lr(i) at update i (from 0). Written out on the parameters'
    device: torch.optim's constructor imports torch._dynamo, which took
    7.3 s on the host of an H100 machine (torch 2.11), most of the
    recipe's training time."""

    def __init__(self, params, lr, steps):
        if steps <= 0:
            raise ValueError(f"the cosine decay needs steps > 0, got {steps}")
        self.params = list(params)
        self.lr, self.steps, self.count = lr, steps, 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self):
        """One update from the parameters' .grad."""
        b1, b2 = BETAS
        grads = [p.grad for p in self.params]
        lr = cosine_lr(self.count, self.lr, self.steps)
        self.count += 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        upd = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        den = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(self.params, upd, alpha=-lr)


def train_step(net, opt, f, r, m):
    """One Adam update on one batch; returns the batch's loss (a 0-d
    tensor on the net's device, before the update)."""
    net.zero_grad(set_to_none=True)
    loss = denoise_loss(net, f, r, m)
    loss.backward()
    opt.step()
    return loss.detach()


def train(feats, refs, masks, steps, batch, lr, seed, net=None,
          log_every=200, device="cuda"):
    """Fit the net (by default init_net seeded with `seed`; a given `net`
    is trained in place) on the patches, kept on `device`, with batches of
    `rng.integers(0, n, batch)` from np.random.default_rng(seed) as the JAX
    trainer draws them. Returns (net, per-step losses (steps,) float32)."""
    dev = _device(device)
    if net is None:
        net = init_net(torch.Generator().manual_seed(seed))
    net = net.to(dev).train()
    f_all, r_all, m_all = (
        torch.as_tensor(a, device=dev).permute(0, 3, 1, 2).contiguous()
        for a in (feats, refs, masks))
    opt = CosineAdam(net.parameters(), lr, steps)
    n = f_all.shape[0]
    rng = np.random.default_rng(seed)
    # every step's draw, in order, uploaded once: a copy from the host in
    # the loop would wait for the card at every step
    idx = torch.as_tensor(np.stack([rng.integers(0, n, batch)
                                    for _ in range(steps)]), device=dev)
    losses = torch.zeros(steps, dtype=torch.float32, device=dev)
    t0 = time.time()
    for i in range(steps):
        losses[i] = train_step(net, opt, f_all[idx[i]], r_all[idx[i]],
                               m_all[idx[i]])
        if (i + 1) % log_every == 0 or i == 0:
            print(f"  step {i + 1}/{steps} loss {float(losses[i]):.5f} "
                  f"({time.time() - t0:.0f}s)", file=sys.stderr)
    return net.eval(), losses.cpu().numpy()


def _log_rmse(a, b, m):
    """RMSE of log1p(max(., 0)) over the mask's texels."""
    d = (np.log1p(np.maximum(a, 0)) - np.log1p(np.maximum(b, 0)))[m]
    return float(np.sqrt(np.mean(d * d)))


def evaluate(net, pairs):
    """Held-in eval: log-RMSE vs converged for noisy / guided / learned
    (learned_denoise with `net`, on its device). Returns a row
    (noisy, guided, learned) per pair, None for a pair with an empty mask."""
    dev = next(net.parameters()).device
    rows = []
    for noisy, ref, albedo, normal, valid in pairs:
        if not valid.any():
            print("  eval: SKIPPED pair with empty valid mask",
                  file=sys.stderr)
            rows.append(None)
            continue
        img, alb, nrm, v = (torch.as_tensor(np.ascontiguousarray(a),
                                            device=dev)
                            for a in (noisy, albedo, normal, valid))
        base = _log_rmse(noisy, ref, valid)
        gui = _log_rmse(guided_bilateral_denoise(img, alb, nrm, valid=v)
                       .cpu().numpy(), ref, valid)
        lrn = _log_rmse(learned_denoise(img, alb, nrm, valid=v, net=net)
                       .cpu().numpy(), ref, valid)
        print(f"  eval: noisy {base:.4f}  guided {gui:.4f}  "
              f"learned {lrn:.4f}", file=sys.stderr)
        rows.append((base, gui, lrn))
    return rows


def save_dataset(path, pairs):
    """The pairs as the JAX trainer's --dataset-cache npz."""
    arrs = {"count": np.int32(len(pairs))}
    for i, tup in enumerate(pairs):
        for k, a in zip(PAIR_KEYS, tup):
            arrs[f"{k}{i}"] = a
    np.savez_compressed(path, **arrs)


def load_dataset(path):
    """The pairs of a --dataset-cache npz (either package's)."""
    with np.load(path) as z:
        return [tuple(z[f"{k}{i}"] for k in PAIR_KEYS)
                for i in range(int(z["count"]))]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="train_denoiser")
    ap.add_argument("--scenes", default="BoxTest,Stronghold")
    ap.add_argument("--resolution", type=int, default=192)
    ap.add_argument("--noisy-spp", default="1,2,4")
    ap.add_argument("--ref-spp", type=int, default=96)
    ap.add_argument("--patch", type=int, default=64)
    ap.add_argument("--patches", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset-cache", default=None,
                    help="npz path: reuse baked pairs if present")
    ap.add_argument("--out", default=str(DENOISER_WEIGHTS))
    ap.add_argument("--device", default="cuda",
                    help="torch device of the bakes and the training")
    args = ap.parse_args(argv)
    _device(args.device)

    noisy_spps = [int(s) for s in args.noisy_spp.split(",")]
    if args.dataset_cache and os.path.exists(args.dataset_cache):
        pairs = load_dataset(args.dataset_cache)
        print(f"# reusing {len(pairs)} baked pairs from "
              f"{args.dataset_cache}", file=sys.stderr)
    else:
        pairs = []
        for scene in args.scenes.split(","):
            print(f"# baking {scene} @{args.resolution} "
                  f"(ref {args.ref_spp} spp)", file=sys.stderr)
            pairs += bake_dataset(scene, args.resolution, noisy_spps,
                                  args.ref_spp, args.device)
        if args.dataset_cache:
            save_dataset(args.dataset_cache, pairs)

    rng = np.random.default_rng(args.seed)
    feats, refs, masks = make_patches(pairs, args.patch, args.patches, rng,
                                      args.device)
    print(f"# {feats.shape[0]} patches of {args.patch}^2", file=sys.stderr)

    net, _ = train(feats, refs, masks, args.steps, args.batch, args.lr,
                   args.seed, device=args.device)
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    save_net(net, args.out)
    print(f"# wrote {args.out}", file=sys.stderr)
    evaluate(net, pairs)


if __name__ == "__main__":
    main()
