"""Port parity: the material tap of dxrpathtracer_tpu_torch (scene/taps.py,
the wrapper of the CUDA kernel csrc/taps.cu, and its plain twin
scene/textures.py::bilinear_from_meta_plain) against dxrpathtracer_tpu.

The twin is held bit for bit against the JAX package's
`bilinear_from_meta` on one texel pool of 1x1, non-square and 1024^2
textures: seeded uv in [-2, 3), uv on texel centres and edges, and uv
outside [0, 1) that wraps; once on contiguous lanes and once on the strided
views the integrator passes (base/w/h columns of the packed shading row,
uv inside a 14-float vertex block), through `_sample_packed`. The JAX side
runs in a subprocess whose XLA:CPU emits no FMA, so its products round as
the twin's do. The kernel cannot run here: the wrapper's routing and its
rejects are checked, and its launcher is run against a stand-in for the
library that reads the lanes through the very pointers and strides the
kernel is handed. chip_smoke.py holds the kernel against the twin on the
card. Inputs are made from a numpy seed.
"""

import contextlib
import ctypes
import os
import subprocess
import sys
import types

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

from dxrpathtracer_tpu_torch.app import profiler  # noqa: E402
from dxrpathtracer_tpu_torch.render.integrator import _sample_packed  # noqa: E402
from dxrpathtracer_tpu_torch.scene import taps, textures  # noqa: E402
from dxrpathtracer_tpu_torch.scene.types import (PACKED_SLOTS,  # noqa: E402
                                                 TRI_SHADE_META,
                                                 TRI_SHADE_VTX,
                                                 TRI_SHADE_WIDTH)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ((1, 1), (5, 3), (2, 7), (1024, 1024), (1, 9))  # (w, h)
N_RANDOM = 6000
CASES = ("random", "centres_edges", "wrap")

_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from dxrpathtracer_tpu.scene.textures import bilinear_from_meta
ref = dict(np.load(sys.argv[1]))
texels = jnp.asarray(ref.pop("texels"))
meta = ref.pop("meta")
out = {}
for name in sorted({k.split("__")[0] for k in ref}):
    tex, uv = ref[name + "__tex"], ref[name + "__uv"]
    m = meta[tex]
    out[name] = np.asarray(jax.jit(bilinear_from_meta)(
        texels, jnp.asarray(m[:, 0]), jnp.asarray(m[:, 1]),
        jnp.asarray(m[:, 2]), jnp.asarray(uv)))
np.savez(sys.argv[2], **out)
"""


def _pool(rng):
    """One pool of every SIZES texture, row-major, as AtlasBuilder packs it:
    (texels (total, 4) f32, meta (textures, 3) int32 of (base, w, h))."""
    meta, rows, base = [], [], 0
    for w, h in SIZES:
        meta.append((base, w, h))
        rows.append(rng.standard_normal((w * h, 4)).astype(np.float32))
        base += w * h
    texels = np.concatenate(rows)
    texels[0, 1] = np.float32(-0.0)
    return texels, np.asarray(meta, np.int32)


def _lanes(rng, case):
    """(texture index, uv) lanes of one case."""
    n_tex = len(SIZES)
    if case == "random":
        tex = rng.integers(0, n_tex, N_RANDOM)
        return tex, rng.uniform(-2.0, 3.0, (N_RANDOM, 2)).astype(np.float32)
    tex, uv = [], []
    for t, (w, h) in enumerate(SIZES):
        if case == "centres_edges":
            # every texel centre and edge of small textures, a stretch of
            # the 1024^2 one, in f32 as uv * size - 0.5 meets them
            k = np.arange(-min(w, 6), min(w, 6) * 2 + 1, dtype=np.float32)
            j = np.arange(-min(h, 6), min(h, 6) * 2 + 1, dtype=np.float32)
            xs = np.concatenate([(k + np.float32(0.5)) / np.float32(w),
                                 k / np.float32(w)])
            ys = np.concatenate([(j + np.float32(0.5)) / np.float32(h),
                                 j / np.float32(h)])
        else:  # wrap: uv far outside [0, 1) and at its ends
            xs = ys = np.float32([-2.75, -1.0, -0.5, -1e-7, 0.0, 1e-7, 0.999,
                                  1.0, 1.25, 2.0, 2.9999])
        gx, gy = np.meshgrid(xs, ys)
        uv.append(np.stack([gx.ravel(), gy.ravel()], 1))
        tex.append(np.full(gx.size, t))
    return np.concatenate(tex), np.concatenate(uv).astype(np.float32)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """{"texels", "meta", case: (tex, uv, the JAX package's taps)}."""
    rng = np.random.default_rng(18)
    texels, meta = _pool(rng)
    inputs = {"texels": texels, "meta": meta}
    lanes = {case: _lanes(rng, case) for case in CASES}
    for case, (tex, uv) in lanes.items():
        inputs[case + "__tex"], inputs[case + "__uv"] = tex, uv
    tmp = tmp_path_factory.mktemp("taps")
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT,
                           str(tmp / "in.npz"), str(tmp / "out.npz")],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = dict(np.load(tmp / "out.npz"))
    return {"texels": texels, "meta": meta,
            **{c: (*lanes[c], want[c]) for c in CASES}}


def _shading_views(meta, tex, uv, slot):
    """(packed_mm, uv) as _fetch_shade_inputs passes them: the int32 view of
    the packed meta inside each lane's 64-word shading row, and uv inside a
    14-float vertex block; slot `slot`'s columns hold (base, w, h)."""
    n = len(tex)
    rec = torch.zeros((n, TRI_SHADE_WIDTH), dtype=torch.float32)
    rec_i = rec.view(torch.int32)
    k = 3 * PACKED_SLOTS.index(slot)
    rec_i[:, TRI_SHADE_META + k:TRI_SHADE_META + k + 3] = torch.from_numpy(
        meta[tex])
    packed_mm = rec_i[:, TRI_SHADE_META:TRI_SHADE_META + 20]
    blk = torch.zeros((n, TRI_SHADE_VTX), dtype=torch.float32)
    blk[:, 6:8] = torch.from_numpy(uv)
    return packed_mm, blk[:, 6:8]


@pytest.mark.parametrize("case", CASES)
def test_plain_twin_equals_jax(cases, case):
    tex, uv, want = cases[case]
    m = torch.from_numpy(cases["meta"][tex])
    got = textures.bilinear_from_meta(torch.from_numpy(cases["texels"]),
                                      m[:, 0], m[:, 1], m[:, 2],
                                      torch.from_numpy(uv))
    assert got.shape == (len(tex), 4)
    # bit for bit, -0.0 included
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("slot", PACKED_SLOTS)
@pytest.mark.parametrize("case", CASES)
def test_sample_packed_strided_views_equal_jax(cases, case, slot):
    tex, uv, want = cases[case]
    packed_mm, uv_view = _shading_views(cases["meta"], tex, uv, slot)
    assert not uv_view.is_contiguous() and packed_mm.stride(0) == 64
    scene = types.SimpleNamespace(texels=torch.from_numpy(cases["texels"]))
    got = _sample_packed(scene, packed_mm, uv_view, slot)
    assert got.numpy().tobytes() == want.tobytes()


def test_routing_is_by_device(cases, monkeypatch):
    """CPU tensors take the plain twin and never reach the kernel's
    launcher; a device that is neither CPU nor CUDA raises."""
    calls = []
    monkeypatch.setattr(taps, "_launch_kernel",
                        lambda *a, **k: calls.append("kernel"))
    monkeypatch.setattr(taps, "KERNEL_LAUNCHES", 0)
    tex, uv, want = cases["random"]
    m = torch.from_numpy(cases["meta"][tex])
    got = textures.bilinear_from_meta(torch.from_numpy(cases["texels"]),
                                      m[:, 0], m[:, 1], m[:, 2],
                                      torch.from_numpy(uv))
    assert calls == [] and taps.KERNEL_LAUNCHES == 0
    assert got.device.type == "cpu"
    assert got.numpy().tobytes() == want.tobytes()
    meta_i = torch.empty(5, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no bilinear tap for device meta"):
        textures.bilinear_from_meta(torch.empty((8, 4), device="meta"),
                                    meta_i, meta_i, meta_i,
                                    torch.empty((5, 2), device="meta"))


@pytest.mark.parametrize("what", ["float64 pool", "pool not (total, 4)",
                                  "int64 meta", "strided pool",
                                  "float64 uv", "uv of other lanes"])
def test_rejects_what_the_kernel_does_not_take(what, monkeypatch):
    def no_build():
        raise AssertionError("the launcher built the kernel")
    monkeypatch.setattr(taps, "kernel_library", no_build)
    texels = torch.zeros((16, 4))
    meta = torch.zeros(3, dtype=torch.int32)
    uv = torch.zeros((3, 2))
    if what == "float64 pool":
        texels = texels.double()
    elif what == "pool not (total, 4)":
        texels = torch.zeros((16, 3))
    elif what == "int64 meta":
        meta = meta.long()
    elif what == "strided pool":
        texels = torch.zeros((16, 8))[:, ::2]
    elif what == "float64 uv":
        uv = uv.double()
    else:
        uv = torch.zeros((4, 2))
    with pytest.raises(ValueError):
        taps._launch_kernel(texels, meta, meta, meta, uv)


def _alias(ptr, nbytes, dtype):
    """A flat CPU tensor over `nbytes` bytes at address `ptr`."""
    return torch.frombuffer((ctypes.c_byte * nbytes).from_address(ptr),
                            dtype=dtype)


class _HostKernel:
    """Stands in for the built library: `dxrpt_bilinear_tap` reads the lanes
    and the pool through the pointers and element strides it is handed, as
    the kernel does, taps them with the plain twin and writes the output
    rows at the output pointer. Records each call's arguments."""

    def __init__(self):
        self.calls = []

    def dxrpt_bilinear_tap(self, texels, uv, uv_row, uv_col, base,
                           base_stride, w, w_stride, h, h_stride, out, n,
                           stream):
        self.calls.append(dict(texels=texels, uv=uv, uv_row=uv_row,
                               uv_col=uv_col, base=base, base_stride=base_stride,
                               w=w, w_stride=w_stride, h=h, h_stride=h_stride,
                               out=out, n=n))

        def lane(ptr, stride, dtype):
            flat = _alias(ptr, 4 * ((n - 1) * stride + 1), dtype)
            return flat.as_strided((n,), (stride,))

        total = self.total
        pool = _alias(texels, 16 * total, torch.float32).view(total, 4)
        u = lane(uv, uv_row, torch.float32)
        v = lane(uv + 4 * uv_col, uv_row, torch.float32)
        got = textures.bilinear_from_meta_plain(
            pool, lane(base, base_stride, torch.int32),
            lane(w, w_stride, torch.int32), lane(h, h_stride, torch.int32),
            torch.stack([u, v], 1))
        _alias(out, 16 * n, torch.float32).copy_(got.reshape(-1))
        return 0


@pytest.fixture
def host_kernel(monkeypatch):
    """taps' launcher with _HostKernel as its library, and torch.cuda's
    device scope and stream replaced by CPU stand-ins."""
    lib = _HostKernel()
    monkeypatch.setattr(taps, "kernel_library", lambda: lib)
    monkeypatch.setattr(taps, "KERNEL_LAUNCHES", 0)
    monkeypatch.setattr(taps.torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(taps.torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    return lib


def test_launcher_reads_the_integrator_views_in_place(cases, host_kernel):
    """One launch a tap, on the views' own memory (no copy), counted in
    KERNEL_LAUNCHES and as the tracer's `tap_kernel` under the open span;
    the output equals the twin's bit for bit."""
    tex, uv, want = cases["random"]
    packed_mm, uv_view = _shading_views(cases["meta"], tex, uv, "normal")
    k = 3 * PACKED_SLOTS.index("normal")
    base, w, h = (packed_mm[..., k + j] for j in range(3))
    texels = torch.from_numpy(cases["texels"])
    host_kernel.total = texels.shape[0]
    with profiler.tracing() as records:
        with profiler.span("shade.taps"):
            got = taps._launch_kernel(texels, base, w, h, uv_view)
    assert taps.KERNEL_LAUNCHES == 1
    assert records["shade.taps"]["counts"] == {"tap_kernel": 1}
    (call,) = host_kernel.calls
    assert (call["uv"], call["uv_row"], call["uv_col"]) == (
        uv_view.data_ptr(), TRI_SHADE_VTX, 1)
    for name, t in (("base", base), ("w", w), ("h", h)):
        assert call[name] == t.data_ptr()
        assert call[f"{name}_stride"] == TRI_SHADE_WIDTH
    assert call["texels"] == texels.data_ptr() and call["n"] == len(tex)
    assert got.numpy().tobytes() == want.tobytes()


def test_launcher_takes_lanes_of_any_shape(cases, host_kernel):
    """(n, K) lanes, as the split-alpha route's AlphaTest passes them, come
    back in their shape; 0 lanes launch nothing."""
    tex, uv, want = cases["random"]
    m = torch.from_numpy(cases["meta"][tex]).reshape(-1, 4, 3)
    texels = torch.from_numpy(cases["texels"])
    host_kernel.total = texels.shape[0]
    got = taps._launch_kernel(texels, m[..., 0], m[..., 1], m[..., 2],
                              torch.from_numpy(uv).reshape(-1, 4, 2))
    assert got.shape == (len(tex) // 4, 4, 4)
    assert got.numpy().tobytes() == want.tobytes()
    empty = torch.zeros(0, dtype=torch.int32)
    assert taps._launch_kernel(texels, empty, empty, empty,
                               torch.zeros((0, 2))).shape == (0, 4)
    assert taps.KERNEL_LAUNCHES == 1 and len(host_kernel.calls) == 1
