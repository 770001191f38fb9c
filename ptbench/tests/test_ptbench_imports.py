"""Nothing the harness loads is JAX or the JAX package, and the reference
loads nothing of the program either; top-level names compared whole."""

import subprocess
import sys

from ._tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "dxrpathtracer_tpu"}


def _top_level(code: str) -> set:
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(proc.stdout.split())


def test_a_run_loads_no_jax():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from ptbench.tests._tiny import run_tiny\n"
        "from ptbench import calibrate, trace\n"
        "run_tiny('pt1080-sponza-alpha', trace=1, seconds=0.5)\n"
        "run_tiny('bake4096-sponza')\n"
        "print(' '.join(sorted({m.split('.')[0] for m in list(sys.modules)})))\n")
    mods = _top_level(code)
    assert "dxrpathtracer_tpu_torch" in mods  # the program ran
    assert not (mods & FORBIDDEN), mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys, json, numpy as np, torch\n"
        "torch.set_num_threads(2)\n"
        "from ptbench.ref import frame, bake\n"
        "from ptbench.scenes import sponza_alpha_checker\n"
        "t = json.load(open('ptbench/workloads/sponza-alpha.json'))\n"
        "c = json.load(open('ptbench/configs/pt1080.json'))\n"
        "c.update(width=16, height=8)\n"
        "t['texture_size'] = 8\n"
        "d = sponza_alpha_checker.build(t)\n"
        "frame.accumulate(d, c, t, np.arange(8), 3, 1, 'cpu')\n"
        "b = json.load(open('ptbench/configs/bake4096.json'))\n"
        "b.update(resolution=32)\n"
        "bake.lightmap(d, b, t, np.arange(8), 3, 1, 'cpu')\n"
        "print(' '.join(sorted({m.split('.')[0] for m in list(sys.modules)})))\n")
    mods = _top_level(code)
    assert not (mods & (FORBIDDEN | {"dxrpathtracer_tpu_torch"}))
