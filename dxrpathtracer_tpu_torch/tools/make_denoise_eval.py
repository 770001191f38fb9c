"""Bake a held-out denoiser eval set for one scene on the card:
`python -m dxrpathtracer_tpu_torch.tools.make_denoise_eval`.

The port of the JAX repository's eval-set tool, with its flags and defaults
plus `--device` (default cuda; without a card it raises). It bakes noisy
snapshots at the requested spp values and a converged reference
(train_denoiser.bake_dataset) and saves them in the JAX tool's npz layout:
count, spps, scene, float16 noisy{i}, ref{i}, albedo{i}, normal{i} and the
boolean valid{i} masks, which tests/test_denoise_eval.py and
tests/test_torch_denoise.py read.

    python -m dxrpathtracer_tpu_torch.tools.make_denoise_eval \\
        --scene SunTemple --resolution 192 --noisy-spp 1,2,4 --ref-spp 96 \\
        --out tests/data/denoise_eval_suntemple_192.npz
"""

import argparse
import os

import numpy as np

from .train_denoiser import PAIR_KEYS, bake_dataset


def main(argv=None):
    ap = argparse.ArgumentParser(prog="make_denoise_eval")
    ap.add_argument("--scene", default="SunTemple")
    ap.add_argument("--resolution", type=int, default=192)
    ap.add_argument("--noisy-spp", default="1,2,4")
    ap.add_argument("--ref-spp", type=int, default=96)
    ap.add_argument("--out",
                    default="tests/data/denoise_eval_suntemple_192.npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the bakes")
    args = ap.parse_args(argv)

    noisy_spps = [int(s) for s in args.noisy_spp.split(",")]
    pairs = bake_dataset(args.scene, args.resolution, noisy_spps,
                         args.ref_spp, args.device)
    arrs = {"count": np.int32(len(pairs)),
            "spps": np.asarray(noisy_spps, np.int32),
            "scene": np.bytes_(args.scene)}
    for i, tup in enumerate(pairs):
        for k, a in zip(PAIR_KEYS, tup):
            arrs[f"{k}{i}"] = a if k == "valid" else a.astype(np.float16)
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(args.out, **arrs)
    size = os.path.getsize(args.out) / 1e6
    print(f"{args.out}: {len(pairs)} pairs @{args.resolution} "
          f"({size:.1f} MB)")


if __name__ == "__main__":
    main()
