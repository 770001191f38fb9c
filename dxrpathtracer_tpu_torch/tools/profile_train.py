"""Where the denoiser trainer's time goes on the card: `python -m
dxrpathtracer_tpu_torch.tools.profile_train`.

At the shapes of the JAX repository's recipe (tools/train_denoiser.py's
defaults: 2048 patches of 64^2 with 13 feature channels, batch 16), on
patches drawn from a numpy seed, each stage of train() timed alone on the
host clock around a synchronise: the patches' upload and NCHW copy,
init_net, the optimizer's construction (CosineAdam, and torch.optim.Adam
beside it for comparison: its constructor imports torch._dynamo), the
first step (cuDNN's first calls), then STEPS steps pipelined (one
synchronise at the end) and STEPS steps each synchronised (their median);
then `profile_step` traces 10 steps with torch.profiler: device time, idle
share and the kernels with the most device time. Needs a CUDA device.
"""

import statistics
import time

import numpy as np
import torch

from ..render.learned_denoise import IN_CHANNELS, init_net
from .train_denoiser import CosineAdam, train_step

PATCHES, PATCH, BATCH, LR, STEPS = 2048, 64, 16, 1e-3, 200
TOP = 25  # kernels listed by profile_step


def _timed(label, fn):
    """fn()'s result; prints its synchronised host ms."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    print(f"{label}: {(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
    return out


def profile_step(label: str, step):
    """One warm-up call of step(), one timed, one traced; prints the wall
    ms (profiled and not), the device time, the idle share and the kernels
    with the most device time. Kernels of one stream run one at a time, so
    their sum is the busy time."""
    step()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0

    # only the device's own rows: an op row (aten::index) repeats the time
    # of the kernels it launched
    rows = [(_self_device_us(e), e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"{label}: {plain_s * 1e3:.1f} ms unprofiled, "
          f"{profiled_s * 1e3:.1f} ms profiled; device time "
          f"{device_ms:.1f} ms in {sum(r[1] for r in rows)} launches; idle "
          f"share {(1.0 - device_ms / (profiled_s * 1e3)) * 100:.1f} %")
    for us, count, name in rows[:TOP]:
        print(f"  {us / 1e3:9.2f} ms  {count:6d} x  {name[:110]}")


def _self_device_us(event):
    """Self device microseconds (the attribute's name varies by version)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(event, attr, None)
        if value is not None:
            return value
    return 0.0


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    rng = np.random.default_rng(0)
    host = [rng.random((PATCHES, PATCH, PATCH, c), dtype=np.float32)
            for c in (IN_CHANNELS, 3, 1)]
    _timed("CUDA context", lambda: torch.zeros(1, device="cuda"))
    f, r, m = _timed("upload and NCHW copy of the patches", lambda: [
        torch.as_tensor(a, device="cuda").permute(0, 3, 1, 2).contiguous()
        for a in host])
    net = _timed("init_net", lambda: init_net(
        torch.Generator().manual_seed(0)).to("cuda").train())
    opt = _timed("CosineAdam", lambda: CosineAdam(net.parameters(), LR,
                                                  3000))
    _timed("torch.optim.Adam (not used)",
           lambda: torch.optim.Adam(net.parameters(), lr=LR))
    # the first step, both timed runs and profile_step's three calls
    idx = torch.as_tensor(rng.integers(0, PATCHES, (2 * STEPS + 31, BATCH)),
                          device="cuda")
    batches = iter(idx)

    def step():
        i = next(batches)
        return train_step(net, opt, f[i], r[i], m[i])

    _timed("first step", step)
    _timed(f"{STEPS} steps pipelined", lambda: [step() for _ in range(STEPS)])
    times = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"synchronised step: median {statistics.median(times):.3f} ms of "
          f"{STEPS}", flush=True)
    profile_step("10 training steps", lambda: [step() for _ in range(10)])
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")


if __name__ == "__main__":
    main()
