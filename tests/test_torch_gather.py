"""Port parity: accel/gather.py of dxrpathtracer_tpu_torch (the module that
holds the CUDA row-gather kernel) against dxrpathtracer_tpu.

The JAX package's TPU kernel, tools/microbench_dma_gather.py::dma_gather,
needs TPU memory spaces (SMEM, DMA semaphores) and does not run on the CPU;
its own correctness check compares it with jnp.take(table, idx, axis=0).
Here `row_gather` on CPU tensors (the plain version) is held against that
same jnp.take bit for bit, for f32 and i32 tables of several widths and a
ragged row count. The kernel itself is held against the plain version, bit
for bit, on the card by chip_smoke.py. Inputs are made from a numpy seed.
"""

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from dxrpathtracer_tpu_torch.accel import gather  # noqa: E402

ROWS = 777
N = 2 * 2048 + 37  # ragged: not a multiple of the TPU kernel's chunk


def _inputs(seed, dtype, width):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        table = rng.standard_normal((ROWS, width)).astype(np.float32)
        table[0, 0] = np.float32(-0.0)
        table[1, 0] = np.float32(np.nan)
    else:
        table = rng.integers(-2**31, 2**31 - 1, (ROWS, width), dtype=np.int64)
        table = table.astype(np.int32)
    idx = rng.integers(0, ROWS, N).astype(np.int32)
    idx[:4] = (0, 1, ROWS - 1, 0)  # repeats and both ends
    return table, idx


@pytest.mark.parametrize("width", [1, 3, 32, 64, 128])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_row_gather_equals_jnp_take(dtype, width):
    table, idx = _inputs(width, dtype, width)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    got = gather.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.from_numpy(table).dtype
    assert tuple(got.shape) == (N, width)
    # bit for bit, NaN and -0.0 included
    assert got.numpy().tobytes() == want.tobytes()


def test_row_gather_empty_index():
    table, _ = _inputs(0, np.float32, 64)
    got = gather.row_gather(torch.from_numpy(table),
                            torch.zeros(0, dtype=torch.int32))
    assert tuple(got.shape) == (0, 64)


def test_routing_is_by_device(monkeypatch):
    """CPU tensors take the plain route and never reach the kernel wrapper;
    a device that is neither CPU nor CUDA raises (CUDA tensors reach the
    kernel: chip_smoke.py counts its launches on the card)."""
    calls = []
    monkeypatch.setattr(gather, "_launch_kernel",
                        lambda *a, **k: calls.append("kernel"))
    table, idx = _inputs(1, np.float32, 64)
    got = gather.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert calls == [] and gather.KERNEL_LAUNCHES == 0
    assert got.device.type == "cpu"
    with pytest.raises(ValueError, match="no row gather for device meta"):
        gather.row_gather(torch.empty((4, 3), device="meta"),
                          torch.empty(5, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("table_shape,table_dtype,idx_dtype", [
    ((8,), torch.float32, torch.int32),        # a 1-D table
    ((8, 4), torch.float64, torch.int32),      # not a 4-byte dtype
    ((8, 4), torch.float32, torch.int64),      # indices not int32
])
def test_rejects_what_the_kernel_does_not_take(table_shape, table_dtype,
                                               idx_dtype):
    with pytest.raises(ValueError):
        gather.row_gather(torch.zeros(table_shape, dtype=table_dtype),
                          torch.zeros(3, dtype=idx_dtype))
