"""The port's data files and its independence from the JAX package's tree.

  - dxrpathtracer_tpu_torch/sky/data/hosek_data.npz and
    dxrpathtracer_tpu_torch/data/denoiser_weights.npz are byte-equal to the
    JAX package's files, and the port's loaders read its own copies
    (convert.load_denoiser_weights still takes another path);
  - no module of dxrpathtracer_tpu_torch, and not chip_smoke.py, names a
    path inside dxrpathtracer_tpu/ in its code: no string constant other
    than a docstring or a "file:line" citation of a replaced function
    (chip_smoke.py's `replaces`) holds one.
"""

import ast
import os
import re
from pathlib import Path

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

from dxrpathtracer_tpu_torch import convert  # noqa: E402
from dxrpathtracer_tpu_torch.sky import hosek  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "dxrpathtracer_tpu_torch"
FILES = {"hosek": ("sky/data/hosek_data.npz", "sky/data/hosek_data.npz"),
         "denoiser": ("data/denoiser_weights.npz",
                      "data/denoiser_weights.npz")}
_INSIDE = re.compile(r"(^|[^\w])dxrpathtracer_tpu([/\\]|$)")
_CITATION = re.compile(r"^dxrpathtracer_tpu/[\w/]+\.py:\d+$")


@pytest.mark.parametrize("name", list(FILES))
def test_data_files_are_byte_equal_copies(name):
    mine, theirs = FILES[name]
    got = (PORT / mine).read_bytes()
    assert got == (REPO / "dxrpathtracer_tpu" / theirs).read_bytes()
    assert len(got) > 100_000


def test_loaders_read_the_port_copies(tmp_path):
    assert hosek._DATA_PATH == PORT / "sky" / "data" / "hosek_data.npz"
    assert convert.DENOISER_WEIGHTS == PORT / "data" / "denoiser_weights.npz"
    params = convert.load_denoiser_weights()
    jax_file = REPO / "dxrpathtracer_tpu" / "data" / "denoiser_weights.npz"
    other = convert.load_denoiser_weights(jax_file)
    assert len(params) == len(other) > 1
    for (w, b), (w2, b2) in zip(params, other):
        np.testing.assert_array_equal(w, w2)
        np.testing.assert_array_equal(b, b2)


def _docstrings(tree):
    """The ids of the module's, classes' and functions' docstring nodes."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr)
                    and isinstance(first.value, ast.Constant)
                    and isinstance(first.value.value, str)):
                out.add(id(first.value))
    return out


def _paths_named(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = _docstrings(tree)
    found = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs and _INSIDE.search(node.value)
                and not _CITATION.match(node.value)):
            found.append(f"{path.relative_to(REPO)}:{node.lineno}: "
                         f"{node.value[:60]!r}")
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            found += [f"{path.relative_to(REPO)}:{node.lineno}: import {n}"
                      for n in names
                      if n == "dxrpathtracer_tpu"
                      or n.startswith("dxrpathtracer_tpu.")]
    return found


def test_port_names_no_path_inside_the_jax_package():
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 50
    # the repository tools the port carries, whose JAX originals write into
    # the JAX package's tree
    for tool in ("train_denoiser.py", "make_denoise_eval.py"):
        assert PORT / "tools" / tool in sources
    found = [f for p in sources for f in _paths_named(p)]
    assert not found, "\n".join(found)
    # the CUDA and C++ sources name none either, outside comments
    for src in sorted(PORT.rglob("*.cu")):
        code = re.sub(r"//[^\n]*|/\*.*?\*/", "", src.read_text(), flags=re.S)
        assert not _INSIDE.search(code), src
