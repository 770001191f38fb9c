#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one GPU: `python3 chip_smoke.py`.

Drives dxrpathtracer_tpu_torch's main path — the Sponza-class stand-in
(246,084 triangles) at 1920x1080, path length 3, one CMJ sample per pixel
per frame — and checks every kernel on it. Phases, each fatal on failure:

  1. device: a CUDA device must be present; prints the card's name and power
     limit as nvidia-smi reports them;
  2. build: compiles the traversal kernel (csrc/traverse.cu, nvcc, sm_90a)
     and the native SAH builder from the checkout, with the seconds each took;
  3. kernel against plain: the traversal kernel and its plain torch version,
     both on the card, on the five ray classes of one plain-route 1080p
     sample (depth-1 closest on W8, depth-1 sun on W8, depth-2 closest, sun
     and terminal on W32): 0 visibility mismatches, 0 tri-id mismatches
     outside equal-t ties, t/u/v within rtol 1e-6; times of both;
  4. main path: RenderSession on the card; init and first-frame seconds,
     median ms/frame over 10 frames, Mrays/s by bench.py's formula
     W*H*(1+(L-1)*2)/dt; the accumulation must be finite and the kernel
     must have launched 5 times per frame;
  5. same frame, kernel against plain: one 240x135 sample on the card and
     on the CPU; relative RMSE <= 1e-4.

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Full results also go to
chiprun_out/chip_smoke.json. Exits non-zero, with no result line, when there
is no CUDA device or any phase fails. Imports no JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "dxrpathtracer_tpu_torch/csrc/traverse.cu"
TPU_KERNEL = "dxrpathtracer_tpu/accel/pallas_body.py:52"
RTOL = 1e-6


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, repeat=1):
    """Mean device milliseconds of fn() over `repeat` calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeat):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeat, out


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    return smi


def phase_build():
    from dxrpathtracer_tpu_torch.accel import bvh, traverse
    t0 = time.time()
    traverse.kernel_library()
    t_kernel = time.time() - t0
    t0 = time.time()
    bvh.sah_library()
    t_sah = time.time() - t0
    log(f"build: traverse.cu (nvcc sm_90a) {t_kernel:.2f} s, "
        f"sah_builder.cpp (g++) {t_sah:.2f} s")
    for line in traverse.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            log(f"  ptxas: {line.strip()}")
    return {"traverse_s": t_kernel, "sah_builder_s": t_sah}


def ray_classes(sess):
    """The five traversal calls of one 1080p sample, its rays made on the
    plain route: {name: (bvh, first_hit, o, d, t_min, t_max, active)}."""
    from dxrpathtracer_tpu_torch.accel.traverse import (safe_inv,
                                                        traverse_plain)
    from dxrpathtracer_tpu_torch.render import integrator as it

    s, dev = sess.settings, sess.device
    w, h = sess.width, sess.height
    frame = sess.frame_constants(0)
    o, d, length, pix = it.raygen(s, frame, w, h, dev)

    def plain(bvh, first_hit, o, d, tmin, tmax, act):
        tmin = torch.as_tensor(tmin, dtype=torch.float32,
                               device=dev).expand(o.shape[0]).contiguous()
        return traverse_plain(bvh, o, d, safe_inv(d), tmin, tmax, act,
                              first_hit)

    out = {}
    state = it._path_state0(o, d, length)
    for depth, flags in it._depth_schedule(s):
        table = sess.bvh if depth == 1 else sess.bvh_ray
        args = (state["ray_o"], state["ray_d"], state["t_min"],
                state["t_max"], state["active"])
        out[f"d{depth}_closest_W{table.width}"] = (table, False, *args)
        rec = plain(table, False, *args)
        state, reqs, mid = it._shade_vertex(
            sess.scene, sess.sky_cube, s, frame, depth, flags, state, rec,
            pix, w * h, 1, frame.curr_sample_idx)
        vis = []
        for kind, r in zip(it._shadow_plan(s, flags), reqs):
            tab = sess.bvh if (depth == 1 and kind == "sun") else sess.bvh_ray
            out[f"d{depth}_{kind}_any_W{tab.width}"] = (tab, True, *r)
            vis.append(torch.where(plain(tab, True, *r).hit, 0.0, 1.0))
        state = it._apply_vertex(s, sess.sky_cube, depth, flags, state, mid,
                                 vis)
    return out


def phase_kernel_vs_plain(sess):
    from dxrpathtracer_tpu_torch.accel import traverse
    results, max_err = {}, 0.0
    total_ms = total_plain_ms = 0.0
    for name, (bvh, first_hit, o, d, tmin, tmax, act) in \
            ray_classes(sess).items():
        o, d = o.contiguous(), d.contiguous()
        tmin = torch.as_tensor(tmin, dtype=torch.float32, device=o.device)
        tmin = tmin.expand(o.shape[0]).contiguous()
        tmax, act = tmax.contiguous(), act.contiguous()
        inv_d = traverse.safe_inv(d).contiguous()
        kernel = lambda: traverse._launch_kernel(bvh, o, d, inv_d, tmin, tmax,
                                                 act, first_hit)
        kernel()  # warm-up
        ms, got = cuda_ms(kernel, repeat=3)
        plain_ms, ref = cuda_ms(lambda: traverse.traverse_plain(
            bvh, o, d, inv_d, tmin, tmax, act, first_hit))
        row = {"rays": int(o.shape[0]), "active": int(act.sum()),
               "ms": ms, "plain_ms": plain_ms}
        if first_hit:
            mism = int((got.hit != ref.hit).sum())
            row.update(vis_mismatches=mism, occluded=int(ref.hit.sum()))
            ok = mism == 0
        else:
            differ = got.tri_id != ref.tri_id
            tie = differ & (got.t.view(torch.int32) == ref.t.view(torch.int32))
            bad = int((differ & ~tie).sum())
            same = ~differ
            errs = [(getattr(got, f)[same] - getattr(ref, f)[same]).abs()
                    for f in ("t", "u", "v")]
            hit = same & ref.hit
            err = max(float((got.t - ref.t)[hit].abs().max()) if hit.any()
                      else 0.0, float(errs[1].max()), float(errs[2].max()))
            rel_ok = all(torch.allclose(getattr(got, f)[same],
                                        getattr(ref, f)[same], rtol=RTOL,
                                        atol=0.0) for f in ("t", "u", "v"))
            max_err = max(max_err, err)
            row.update(tri_mismatches=bad, equal_t_ties=int(tie.sum()),
                       hits=int(ref.hit.sum()), max_abs_err=err)
            ok = bad == 0 and rel_ok
        total_ms += ms
        total_plain_ms += plain_ms
        results[name] = row
        log(f"{name}: " + ", ".join(
            f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()))
        if not ok:
            raise SystemExit(f"chip_smoke: kernel and plain traversal "
                             f"disagree on {name}: {row}")
    return results, max_err, total_ms, total_plain_ms


def phase_main_path(smi):
    from dxrpathtracer_tpu_torch.accel import traverse
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    w, h, frames = 1920, 1080, 10
    settings = AppSettings(current_scene=Scenes.Sponza, benchmark_mode=True,
                           max_path_length=3)
    t0 = time.time()
    sess = RenderSession(settings, w, h, device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    log(f"main path: init {init_s:.2f} s ({sess.scene.num_triangles} "
        f"triangles, W8 {sess.bvh.num_rows} rows, W32 "
        f"{sess.bvh_ray.num_rows} rows)")

    checks = phase_kernel_vs_plain(sess)

    traverse.KERNEL_LAUNCHES = 0
    t0 = time.time()
    sess.render_frame()
    torch.cuda.synchronize()
    first_s = time.time() - t0
    dts = []
    for _ in range(frames):
        t0 = time.time()
        sess.render_frame()
        torch.cuda.synchronize()
        dts.append(time.time() - t0)
    launches = traverse.KERNEL_LAUNCHES
    accum = sess.accum
    if tuple(accum.shape) != (h, w, 3) or not bool(accum.isfinite().all()):
        raise SystemExit("chip_smoke: the accumulation is not a finite "
                         f"{h}x{w}x3 image")
    if launches < 5 * (frames + 1):
        raise SystemExit(f"chip_smoke: {launches} kernel launches in "
                         f"{frames + 1} frames, want >= 5 per frame")
    med = statistics.median(dts)
    spread = (max(dts) - min(dts)) / med * 100.0
    mrays = w * h * (1 + (settings.max_path_length - 1) * 2) / med / 1e6
    main = {"width": w, "height": h, "path_length": settings.max_path_length,
            "init_s": init_s, "first_frame_s": first_s,
            "ms_per_frame_median": med * 1e3, "spread_pct": spread,
            "frames": frames, "mrays_per_s": mrays,
            "kernel_launches": launches, "accum_mean": float(accum.mean()),
            "card": smi}
    log(f"main path: first frame {first_s:.3f} s; {med * 1e3:.2f} ms/frame "
        f"(median of {frames}, spread {spread:.1f}%), {mrays:.1f} Mrays/s; "
        f"{launches} kernel launches; accum mean {main['accum_mean']:.4f} "
        f"[{smi}]")
    return main, checks, launches


def phase_same_frame():
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    settings = AppSettings(current_scene=Scenes.Sponza, benchmark_mode=True,
                           max_path_length=3)
    imgs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.time()
        sess = RenderSession(settings, 240, 135, device=dev)
        sess.render_frame()
        imgs[dev] = sess.accum.cpu()
        log(f"same frame 240x135 on {dev}: {time.time() - t0:.2f} s")
    ref, got = imgs["cpu"], imgs["cuda"]
    rel = float(((got - ref) ** 2).mean().sqrt() / (ref.abs().max() + 1e-9))
    exact = float((got == ref).float().mean())
    log(f"same frame: rel RMSE cuda (kernel) vs cpu (plain) {rel:.3e}, "
        f"{exact:.4f} of values bit-equal")
    if not (rel <= 1e-4 and bool(got.isfinite().all())):
        raise SystemExit(f"chip_smoke: kernel frame differs from plain frame "
                         f"(rel RMSE {rel:.3e})")
    return {"rel_rmse": rel, "bit_equal_fraction": exact}


def main():
    smi = phase_device()
    sys.path.insert(0, ROOT)
    build = phase_build()
    main_path, (classes, max_err, ms, plain_ms), launches = \
        phase_main_path(smi)
    same = phase_same_frame()
    kernels = {"kernels": [{
        "name": "traverse", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches,
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}]}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "build": build, "ray_classes": classes,
                   "main_path": main_path, "same_frame": same, **kernels},
                  f, indent=1)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
