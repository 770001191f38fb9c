"""Port parity: accel/traverse.py of dxrpathtracer_tpu_torch (the module that
holds the CUDA traversal kernel) against dxrpathtracer_tpu.

Here, on the CPU, the port runs its kernel's plain torch version. It is held
  - step by step against the JAX package's only TPU kernel,
    accel/pallas_body.py::pallas_step, run in Pallas interpret mode as
    tests/test_pallas_body.py runs it: all nine outputs exactly equal;
  - end to end against the JAX closest_hit / any_hit (DXRPT_PALLAS_BODY
    unset) on the same W8 and W32 tables: tri ids and visibility equal,
    t/u/v within rtol 1e-6, atol 1e-7 (and, expected, bit-equal);
  - on the adversarial cases of dxrpathtracer_tpu_torch/tools/
    traverse_cases.py (equal-t ties, coplanar boxes under axis-aligned rays,
    hits at t = +-0, inactive rays), against the same JAX functions: tri ids
    and visibility equal, t/u/v bit-equal.
The kernel itself is held against the plain version on the card by
chip_smoke.py. Inputs are numpy arrays made from a seed.

XLA:CPU contracts a multiply followed by an add into one FMA wherever the
CPU has FMA instructions, so a jitted reference rounds some slab and
Moller-Trumbore products differently from code that rounds each product (the
port's plain version, and its kernel, built with --fmad=false). The JAX
reference therefore runs in a subprocess with the XLA:CPU ISA capped at AVX,
which has no FMA: the same JAX code, every product rounded.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dxrpathtracer_tpu.accel.lbvh import build_bvh  # noqa: E402
from dxrpathtracer_tpu_torch.accel import traverse as ttrav  # noqa: E402
from dxrpathtracer_tpu_torch.convert import bvh_from_numpy  # noqa: E402
from dxrpathtracer_tpu_torch.tools import traverse_cases  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_reference(script: str, inputs: dict, tmp) -> dict:
    """Run `script` (reads argv[1] .npz, writes argv[2] .npz) in a fresh
    Python whose XLA:CPU emits no FMA; returns its outputs."""
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    env.pop("DXRPT_PALLAS_BODY", None)
    proc = subprocess.run([sys.executable, "-c", script, str(src), str(dst)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(dst))


def _rays(seed, n):
    """The rays of tests/test_pallas_body.py, as numpy."""
    rng = np.random.default_rng(seed)
    o = (rng.standard_normal((n, 3)) * 5).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _port_bvh(jbvh):
    return bvh_from_numpy(np.asarray(jbvh.table), jbvh.num_rows,
                          jbvh.max_depth, jbvh.root_code, jbvh.width,
                          jbvh.has_alpha_flags)


@pytest.fixture(scope="module")
def soup_tables():
    """W8 and W32 tables of one soup, built by the JAX package."""
    tris = traverse_cases.soup(0)
    return {w: build_bvh(*tris, width=w) for w in (8, 32)}


_STATE = ("cur", "pmask", "sp", "snode", "smask", "bt", "btri", "bu", "bv")
_LANES = ("ox", "oy", "oz", "dx", "dy", "dz", "ivx", "ivy", "ivz", "tmin",
          "cur", "pmask", "sp", "snode", "smask", "bt", "btri", "bu", "bv")
_STEPS = (0, 1, 2, 5, 10, 20, 39)  # mid-walk states held against the kernel

_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from dxrpathtracer_tpu.accel import pallas_body, traverse
from dxrpathtracer_tpu.accel.lbvh import FlatBVH

inp = dict(np.load(sys.argv[1]))
out = {}
lanes = %r
state = %r
for key in sorted(k[:-5] for k in inp if k.endswith("__rec")):
    step = pallas_body.pallas_step(
        jnp.asarray(inp[key + "__rec"]),
        *[jnp.asarray(inp[key + "__" + f]) for f in lanes],
        first_hit=bool(inp[key + "__first_hit"]),
        done_code=int(inp[key + "__done"]),
        stack_depth=int(inp[key + "__stack"]),
        tile=int(inp[key + "__tile"]), interpret=True)
    for f, r in zip(state, step):
        out[key + "__" + f] = np.asarray(r)
for w in (8, 32):
    c = inp["w%%d__const" %% w]
    bvh = FlatBVH(table=jnp.asarray(inp["w%%d__table" %% w]), num_rows=int(c[0]),
                  max_depth=int(c[1]), root_code=int(c[2]), width=w)
    for kind in ("closest", "any"):
        args = [jnp.asarray(inp[kind + "__" + f])
                for f in ("o", "d", "tmin", "tmax", "active")]
        fn = traverse.closest_hit if kind == "closest" else traverse.any_hit
        res = jax.jit(fn)(bvh, *args)
        if kind == "closest":
            for f in ("t", "tri_id", "u", "v"):
                out["w%%d__%%s__%%s" %% (w, kind, f)] = np.asarray(getattr(res, f))
        else:
            out["w%%d__any__vis" %% w] = np.asarray(res)
np.savez(sys.argv[2], **out)
""" % (_LANES, _STATE)


def _cases(kind, n):
    o, d = _rays(5 if kind == "closest" else 6, n)
    rng = np.random.default_rng(105 if kind == "closest" else 106)
    tmin = rng.choice([0.0, 1e-4, 0.5], size=n).astype(np.float32)
    tmax = np.where(rng.random(n) < 0.3, 3.5, 1e30).astype(np.float32)
    active = rng.random(n) > 0.2
    return dict(o=o, d=d, tmin=tmin, tmax=tmax, active=active)


def _walk_states(bvh, first_hit):
    """The port's lane state before each step of _STEPS, and after it."""
    n = 512
    o, d = (torch.from_numpy(a) for a in _rays(1, n))
    s = ttrav.init_lanes(bvh, o, d, ttrav.safe_inv(d),
                         torch.full((n,), 1e-4), torch.full((n,), 1e30),
                         torch.from_numpy(np.arange(n) % 5 != 0))
    states = []
    for step in range(max(_STEPS) + 1):
        nxt = ttrav.traverse_step_plain(bvh, s, first_hit)
        if step in _STEPS:
            states.append((step, s, nxt))
        s = nxt
    assert (s.cur != bvh.num_rows).any()  # still mid-walk at the last one
    return states


@pytest.fixture(scope="module")
def reference(soup_tables, tmp_path_factory):
    """Port results and the JAX reference's, for every test of this file."""
    port = {w: _port_bvh(soup_tables[w]) for w in (8, 32)}
    inputs, walks = {}, {}
    for first_hit in (False, True):
        walks[first_hit] = _walk_states(port[8], first_hit)
        for step, s, _ in walks[first_hit]:
            key = f"fh{int(first_hit)}s{step}"
            cur = s.cur.numpy()
            row = np.where(cur < 0, ~cur, np.where(cur == port[8].num_rows, 0,
                                                   cur))
            inputs[key + "__rec"] = port[8].table.numpy()[row]
            for f in _LANES:
                inputs[key + "__" + f] = getattr(s, f).numpy()
            inputs[key + "__first_hit"] = np.asarray(first_hit)
            inputs[key + "__done"] = np.asarray(port[8].num_rows)
            inputs[key + "__stack"] = np.asarray(port[8].stack_depth)
            inputs[key + "__tile"] = np.asarray(512)
    for w in (8, 32):
        inputs[f"w{w}__table"] = port[w].table.numpy()
        inputs[f"w{w}__const"] = np.asarray(
            [port[w].num_rows, port[w].max_depth, port[w].root_code])
    for kind in ("closest", "any"):
        for f, a in _cases(kind, 2048).items():
            inputs[kind + "__" + f] = a
    ref = run_reference(_SCRIPT, inputs, tmp_path_factory.mktemp("traverse"))
    return port, walks, ref


@pytest.mark.parametrize("first_hit", [False, True])
def test_step_matches_pallas_kernel(reference, first_hit):
    _, walks, ref = reference
    for step, _, nxt in walks[first_hit]:
        key = f"fh{int(first_hit)}s{step}"
        for f in _STATE:
            got = getattr(nxt, f).numpy()
            np.testing.assert_array_equal(
                got.view(np.int32), ref[key + "__" + f].view(np.int32),
                err_msg=f"{f} after step {step}")


def _port_walk(bvh, kind):
    c = {f: torch.from_numpy(a) for f, a in _cases(kind, 2048).items()}
    fn = ttrav.closest_hit if kind == "closest" else ttrav.any_hit
    return fn(bvh, c["o"], c["d"], c["tmin"], c["tmax"], c["active"])


@pytest.mark.parametrize("width", [8, 32])
def test_closest_hit_matches_jax(reference, width):
    port, _, ref = reference
    got = _port_walk(port[width], "closest")
    tri = got.tri_id.numpy()
    np.testing.assert_array_equal(tri, ref[f"w{width}__closest__tri_id"])
    active = _cases("closest", 2048)["active"]
    assert (tri >= 0).sum() > 500 and (~active & (tri >= 0)).sum() == 0
    for f in ("t", "u", "v"):
        g, r = getattr(got, f).numpy(), ref[f"w{width}__closest__{f}"]
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL, err_msg=f)
        same = np.array_equal(g.view(np.int32), r.view(np.int32))
        print(f"W{width} closest {f}: "
              + ("bit-equal" if same else
                 f"within tolerance, {np.sum(g != r)} lanes not bit-equal"))


@pytest.mark.parametrize("width", [8, 32])
def test_any_hit_matches_jax(reference, width):
    port, _, ref = reference
    vis = _port_walk(port[width], "any").numpy()
    np.testing.assert_array_equal(vis, ref[f"w{width}__any__vis"])
    assert 0 < (vis == 0).sum() < _cases("any", 2048)["active"].sum()


_CASE_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from dxrpathtracer_tpu.accel import traverse
from dxrpathtracer_tpu.accel.lbvh import FlatBVH

inp = dict(np.load(sys.argv[1]))
out = {}
for key in sorted(k[:-7] for k in inp if k.endswith("__table")):
    c = inp[key + "__const"]
    bvh = FlatBVH(table=jnp.asarray(inp[key + "__table"]), num_rows=int(c[0]),
                  max_depth=int(c[1]), root_code=int(c[2]), width=int(c[3]))
    case = key.split("__")[0]
    args = [jnp.asarray(inp[case + "__" + f])
            for f in ("o", "d", "tmin", "tmax", "active")]
    res = jax.jit(traverse.closest_hit)(bvh, *args)
    for f in ("t", "tri_id", "u", "v"):
        out[key + "__closest__" + f] = np.asarray(getattr(res, f))
    out[key + "__any__vis"] = np.asarray(jax.jit(traverse.any_hit)(bvh, *args))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def adversarial(tmp_path_factory):
    """The adversarial cases: port tables and the JAX results on them."""
    cases = traverse_cases.cases()
    inputs, port = {}, {}
    for name, (tris, rays) in cases.items():
        for f, a in rays.items():
            inputs[f"{name}__{f}"] = a
        for w in (8, 32):
            bvh = _port_bvh(build_bvh(*tris, width=w))
            port[name, w] = bvh
            inputs[f"{name}__w{w}__table"] = bvh.table.numpy()
            inputs[f"{name}__w{w}__const"] = np.asarray(
                [bvh.num_rows, bvh.max_depth, bvh.root_code, w])
    ref = run_reference(_CASE_SCRIPT, inputs,
                        tmp_path_factory.mktemp("traverse_cases"))
    return cases, port, ref


@pytest.mark.parametrize("case", ["ties", "soup"])
@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("width", [8, 32])
def test_adversarial_cases_match_jax(adversarial, case, kind, width):
    """Every tie rule of the walk: tri ids / visibility equal, t/u/v bit
    for bit."""
    cases, port, ref = adversarial
    rays = {f: torch.from_numpy(a) for f, a in cases[case][1].items()}
    args = (port[case, width], rays["o"], rays["d"], rays["tmin"],
            rays["tmax"], rays["active"])
    key = f"{case}__w{width}__{kind}"
    if kind == "any":
        vis = ttrav.any_hit(*args).numpy()
        np.testing.assert_array_equal(vis, ref[key + "__vis"])
        assert 0 < (vis == 0).sum() < rays["active"].sum()
        return
    got = ttrav.closest_hit(*args)
    np.testing.assert_array_equal(got.tri_id.numpy(), ref[key + "__tri_id"])
    for f in ("t", "u", "v"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy().view(np.int32),
            ref[key + "__" + f].view(np.int32), err_msg=f)
    hit = got.tri_id.numpy() >= 0
    assert hit.sum() > len(hit) // 4
    if case == "ties":  # hits at t = -0 and at t = +0 both occur
        t = got.t.numpy()[hit]
        assert ((t == 0) & np.signbit(t)).any() and ((t == 0)
                                                     & ~np.signbit(t)).any()


def test_routing_is_by_device(soup_tables, monkeypatch):
    """CPU tensors take the plain route and never reach the kernel wrapper;
    a device that is neither CPU nor CUDA raises (CUDA tensors reach the
    kernel: chip_smoke.py counts its launches on the card)."""
    calls = []
    monkeypatch.setattr(ttrav, "_launch_kernel",
                        lambda *a, **k: calls.append("kernel"))
    bvh = _port_bvh(soup_tables[8])
    o, d = _rays(7, 64)
    rec = ttrav.closest_hit(bvh, torch.from_numpy(o), torch.from_numpy(d),
                            0.0, 1e30)
    assert calls == [] and ttrav.KERNEL_LAUNCHES == {}
    assert rec.tri_id.device.type == "cpu" and bool(rec.hit.any())
    with pytest.raises(ValueError, match="no traversal for device meta"):
        ttrav.closest_hit(bvh, torch.empty((4, 3), device="meta"),
                          torch.empty((4, 3), device="meta"), 0.0, 1.0)
