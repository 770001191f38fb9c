"""Tiny versions of the cells for CPU tests: the cells' own configuration,
traffic and limits at a small frame or lightmap and small texture maps."""

import argparse
import json

from ptbench import run as R

ROOT = R.ROOT.parent


def bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_parts(name: str, width=32, height=16, resolution=64, count=128,
               texture_size=16):
    b = bench()
    cell = R.find_cell(b, name)
    config = R.load_config(cell["config"])
    if R.load_mode(config["mode"]).STEP == "frame":
        config.update(width=width, height=height, traced_steps=1)
    else:
        config.update(resolution=resolution, traced_steps=1)
    config["check"] = dict(config["check"], count=count)
    traffic = dict(R.load_traffic(cell["traffic"]),
                   texture_size=texture_size)
    return b, cell, config, traffic, R.load_limits(name)


def run_tiny(name: str, seed: int = 2**31 + 17, seconds: float = 0.5,
             trace: int = 0, **sizes):
    """(result, check lines) of one run of the cell's tiny version on the
    CPU."""
    b, cell, config, traffic, limits = cell_parts(name, **sizes)
    args = argparse.Namespace(workload=name, seed=seed, seconds=seconds,
                              trace=trace)
    return R.run(args, b, cell, config, traffic, limits, "cpu")
