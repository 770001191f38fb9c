"""Where a bake step's time goes on the card: `python -m
dxrpathtracer_tpu_torch.tools.profile_bake`.

Builds the Baker of chip_smoke.py's bake phase (the Sponza-class stand-in, a
4096^2 lightmap on the pair atlas, default settings: path length 3,
sqrt_num_samples 4), runs one warm-up step, then traces one step with
torch.profiler and prints: the step's wall seconds (synchronised, profiled
and not), the device time summed over all kernels and the idle share
(1 - device time / profiled wall time), and the kernels with the most device
time. Kernels of one stream run one at a time, so their sum is the busy
time. Needs a CUDA device.
"""

import time

import torch


RESOLUTION = 4096
TOP = 25  # kernels listed


def main():
    from ..app.session import RenderSession
    from ..app.settings import AppSettings, Scenes
    from ..bake.baker import Baker

    if not torch.cuda.is_available():
        raise SystemExit("profile_bake: no CUDA device")
    sess = RenderSession(AppSettings(current_scene=Scenes.Sponza), 8, 8)
    baker = Baker(sess, resolution=RESOLUTION, atlas_mode="pair")
    baker.bake_step()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    baker.bake_step()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        baker.bake_step()
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0

    # only the device's own rows: an op row (aten::index) repeats the time
    # of the kernels it launched
    rows = [(_self_device_us(e), e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"bake step {RESOLUTION}^2 (pair atlas): "
          f"{plain_s * 1e3:.1f} ms unprofiled, {profiled_s * 1e3:.1f} ms "
          f"profiled; device time {device_ms:.1f} ms in "
          f"{sum(r[1] for r in rows)} launches; idle share "
          f"{(1.0 - device_ms / (profiled_s * 1e3)) * 100:.1f} %")
    for us, count, name in rows[:TOP]:
        print(f"  {us / 1e3:9.2f} ms  {count:6d} x  {name[:110]}")


def _self_device_us(event):
    """Self device microseconds (the attribute's name varies by version)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(event, attr, None)
        if value is not None:
            return value
    return 0.0


if __name__ == "__main__":
    main()
