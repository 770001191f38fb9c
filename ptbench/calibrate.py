"""The readings the cells' limits are set from, on the card.

    python3 -m ptbench.calibrate --workload <cell> --steps <n> \
        [--program-seeds a,b,...] [--control-seeds c,d,...]

For each program seed: the cell's program, built once, restarts at the
seed's first sample, runs `n` steps through the timed entry and is compared
with the reference at the seed's pixels or texels (the lower reading). For
each control seed: the reference computed with its tables and accumulation
held in bfloat16 (ref/scene.py: the nearest precision below the float32
that the configuration states), put in the program's place and compared
with the float32 reference over the same `n` steps (the upper reading).
Prints one JSON line per reading.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from . import run as R


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m ptbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--program-seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    args = p.parse_args(argv)
    bench = R._load_json(Path.cwd() / "BENCHMARK.json")
    cell = R.find_cell(bench, args.workload)
    config = R.load_config(cell["config"])
    traffic = R.load_traffic(cell["traffic"])
    for line in readings(config, traffic, args.program_seeds,
                         args.control_seeds, args.steps, "cuda:0"):
        print(json.dumps(dict(line, cell=cell["name"])), flush=True)
    return 0


def readings(config, traffic, program_seeds, control_seeds, steps, device):
    """Yields {kind, seed, steps, numbers} for each seed."""
    mode = R.load_mode(config["mode"])
    desc = R.load_scene(traffic)
    count = int(config["check"]["count"])
    runner = None
    for seed in program_seeds:
        if runner is None:
            runner = mode.Runner(config, traffic, desc,
                                 seed % R.FIRST_SAMPLES, device)
            runner.setup()
        runner.restart(seed % R.FIRST_SAMPLES)
        for _ in range(steps):
            runner.step()
        idx = runner.draw(np.random.default_rng(seed % 2**64), count)
        got = runner.outputs(idx)
        ref = runner.reference(idx, device).cpu()
        yield {"kind": "program", "seed": seed, "steps": steps,
               "numbers": runner.numbers(got, ref)}
    if runner is not None:
        runner.release()
    for seed in control_seeds:
        ctl = mode.Runner(config, traffic, desc, seed % R.FIRST_SAMPLES,
                          device)
        ctl.steps = steps
        idx = ctl.draw(np.random.default_rng(seed % 2**64), count)
        ref = ctl.reference(idx, device).cpu()
        low = ctl.reference(idx, device, torch.bfloat16).cpu()
        yield {"kind": "control", "seed": seed, "steps": steps,
               "numbers": ctl.numbers(low, ref)}


if __name__ == "__main__":
    sys.exit(main())
