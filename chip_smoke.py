#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one GPU: `python3 chip_smoke.py`.

Drives dxrpathtracer_tpu_torch's two main paths and checks every kernel on
them: the path-traced frame (the Sponza-class stand-in, 246,084 triangles, at
1920x1080, path length 3, one CMJ sample per pixel per frame) and the GI
lightmap bake (the same scene, a 4096x4096 lightmap on the pair atlas,
default settings: path length 3, sqrt_num_samples 4). Phases, each fatal on
failure:

  1. device: a CUDA device must be present; prints the card's name and power
     limit as nvidia-smi reports them;
  2. build: compiles the traversal kernel (csrc/traverse.cu), the row-gather
     kernel (csrc/gather.cu) and the native SAH builder from the checkout, all
     at once, with the seconds each took; for each (width, first_hit)
     instantiation of the traversal kernel, ptxas' registers, stack frame
     and spills and the warps one SM holds at once (the persistent grid);
     the W32 instantiations must have no stack frame and no spills;
  3. traversal kernel against plain: the kernel and its plain torch version,
     both on the card, (a) on the five ray classes of one plain-route 1080p
     sample (depth-1 closest on W8, depth-1 sun on W8, depth-2 closest, sun
     and terminal on W32): 0 lanes whose tri id, t, u or v differ in any
     bit; times of both, M visits/s; the plain walk counts its internal and
     leaf visits, the filled child slots and triangles of the records it
     visits and the distinct table rows it touches, which give each class
     its bound (BOUND below); (b) on the adversarial cases of
     dxrpathtracer_tpu_torch/tools/traverse_cases.py (equal-t ties, coplanar
     boxes under axis-aligned rays, hits at t = +-0, inactive rays), W8 and
     W32, closest and any hit: again 0 lanes that differ in any bit;
  4. frame main path: RenderSession on the card; init and first-frame
     seconds, median ms/frame over 10 frames, Mrays/s by bench.py's formula
     W*H*(1+(L-1)*2)/dt; the accumulation must be finite, the traversal
     kernel must have launched 5 times and the gather kernel at least once
     per frame;
  5. same frame, kernel against plain: one 240x135 sample on the card and
     on the CPU; relative RMSE <= 1e-4;
  6. bake main path: Baker on the card at full size; atlas, texel-map and
     surface-map seconds, covered texels (>= 50 %), first-step seconds,
     median seconds per bake step over 3 more steps with the spread,
     Mrays/s as covered*(1+(L-1)*2)/dt, traversal and gather launches per
     step (both > 0), peak device memory, and the ms of the median, guided
     and learned denoisers on the 4096^2 lightmap; the accumulation and
     every denoised map must be finite;
  7. row gather against plain: kernel, plain (`table[idx.long()]`) and
     torch.index_select, bit-equal, timed with CUDA events on (a) the TPU
     microbenchmark's shapes (32768 rows, 2^20 indices, width 32 and 128),
     (b) the shading row (the stand-in's (246084, 64) tri_shade by the
     2,073,600 depth-1 hit ids of one 1080p sample) and (c) the surface
     map's gathers at 4096^2; each with M rows/s and its bound;
  8. same bake, kernels against plain: BoxTest at 64x64, 2 steps, on the
     card and on the CPU; relative RMSE <= 1e-4 and validCount equal.

BOUND: the least time the card could take, the larger of the bytes moved
(each input read once, each output written once) over 3.35 TB/s (NVIDIA H100
SXM data sheet) and the f32 operations over 33.5 T operations/s. The data
sheet's 67 TFLOP/s counts a fused multiply-add as two operations; the
traversal kernel is built --fmad=false (every product rounded on its own, as
the reference rounds it), so it cannot fuse, and its slab and
Moller-Trumbore work is subtractions, products, min/max and comparisons:
one f32 operation per lane per clock, 132 SMs x 128 lanes x 1.98 GHz. A
traversal class moves its rays (45 B in, 16 B out each) and the distinct
512 B table rows its walk touches, and does SLAB_OPS per child slot of each
internal visit and MT_OPS per triangle of each leaf visit, every slot of
the record, as the kernel tests them (the script prints the share of those
operations that falls on empty slots: padding). A gather of n
rows of `width` words moves its distinct rows, its indices and its output:
(distinct*width + n + n*width)*4 B; beside it the script prints the time of
n*width*4*2 + n*4 B, every gathered row counted as a read from memory.

The line before the last is {"kernels": [...]}, whose `launches` count both
main paths' runs; the last is {"ok": true, "device": {...}}. Full results
also go to chiprun_out/chip_smoke.json. Exits non-zero, with no result line,
when there is no CUDA device or any phase fails. Imports no JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TRAVERSE_SOURCE = "dxrpathtracer_tpu_torch/csrc/traverse.cu"
TRAVERSE_REPLACES = "dxrpathtracer_tpu/accel/pallas_body.py:52"
GATHER_SOURCE = "dxrpathtracer_tpu_torch/csrc/gather.cu"
GATHER_REPLACES = "tools/microbench_dma_gather.py:28"
# Where and at what size the phases run: the card at full size. (A rehearsal
# on the CPU may shrink them; the card's run never does.)
DEVICE = "cuda"
FRAME_SIZE = (1920, 1080)
SAME_FRAME_SIZE = (240, 135)
BAKE_RES = 4096
MICROBENCH_ROWS, MICROBENCH_N = 32768, 1 << 20
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 132 * 128 * 1.98e9  # no FMA: one f32 operation/lane/clock
# f32 operations of csrc/traverse.cu per child slot of an internal visit:
# 6 subtractions and 6 products (slabs), 6 min/max for t_near and 6 for
# t_far, and 3 comparisons (bounds valid, t_near <= t_far, nearest key).
SLAB_OPS = 27
# ... and per triangle of a leaf visit (Moller-Trumbore): p = d x e2 (9),
# det (5), |det| test (2), 1/det (2), s = o - v0 (3), u (6), q = s x e1 (9),
# v (6), t (6), the five range tests with u + v (6) and the nearest key (1).
MT_OPS = 55
RAY_IN_BYTES = 45  # origin, direction, 1/direction, t_min, t_max, active
HIT_BYTES = 16     # t, tri_id, u, v
ROW_BYTES = 512    # one table record


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


def bound_ms(nbytes, ops=0):
    """(bound ms, "bytes" or "operations") by the BOUND rule above."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sync():
    torch.cuda.synchronize()


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
    """Builds the three native libraries at once (one compiler each)."""
    from concurrent.futures import ThreadPoolExecutor

    from dxrpathtracer_tpu_torch.accel import bvh, gather, traverse

    def timed(fn):
        t0 = time.time()
        fn()
        return time.time() - t0

    jobs = {"traverse_s": traverse.kernel_library,
            "gather_s": gather.kernel_library,
            "sah_builder_s": bvh.sah_library}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(timed, fn) for k, fn in jobs.items()}
        secs = {k: f.result() for k, f in futures.items()}
    log(f"build (in parallel): traverse.cu (nvcc sm_90a) "
        f"{secs['traverse_s']:.2f} s, gather.cu (nvcc sm_90a) "
        f"{secs['gather_s']:.2f} s, sah_builder.cpp (g++) "
        f"{secs['sah_builder_s']:.2f} s")
    for line in gather.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            log(f"  ptxas gather: {line.strip()}")
    kernels = ptxas_report(traverse.BUILD_LOG)
    for (width, first_hit), row in sorted(kernels.items()):
        row["resident_warps_per_sm"] = traverse.resident_warps(width,
                                                               first_hit)
        log(f"  traverse W{width} {'any' if first_hit else 'closest'}: "
            + ", ".join(f"{k} {v}" for k, v in row.items()))
        if width == 32 and (row["stack_frame_bytes"] or row["spill_stores"]
                            or row["spill_loads"]):
            raise SystemExit(f"chip_smoke: the W32 traversal kernel uses "
                             f"local memory: {row}")
    if sorted(kernels) != [(8, False), (8, True), (32, False), (32, True)]:
        raise SystemExit(f"chip_smoke: ptxas reported traversal kernels "
                         f"{sorted(kernels)}")
    secs["traverse_kernels"] = {f"W{w}_{'any' if fh else 'closest'}": row
                                for (w, fh), row in kernels.items()}
    return secs


def ptxas_report(log_text):
    """{(width, first_hit): registers, stack frame and spills} of each
    traversal kernel instantiation in nvcc's -Xptxas -v output (warp_kernel
    walks W32 tables, thread_kernel W8)."""
    import re
    out, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '\S*(warp|thread)_kernelILb"
                      r"([01])E", line)
        if m:
            cur = (32 if m.group(1) == "warp" else 8, m.group(2) == "1")
            out[cur] = {}
            continue
        if "Compiling entry function" in line:
            cur = None
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack_frame_bytes=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


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


def walk_counts(bvh, first_hit, o, d, inv_d, tmin, tmax, act):
    """{internal and leaf visits, filled child slots and triangles of the
    visited records, distinct rows touched} of the plain walk on these rays:
    traverse_plain's loop, counting as it steps. A slot is filled where its
    box is not inverted, a triangle where its tri id is >= 0; the rest are
    padding that the kernel tests all the same."""
    from dxrpathtracer_tpu_torch.accel import traverse
    from dxrpathtracer_tpu_torch.accel.bvh import LEAF_SIZE
    s = traverse.init_lanes(bvh, o, d, inv_d, tmin, tmax, act)
    done = bvh.num_rows
    # per row, read both ways: filled child slots, filled leaf triangles
    slots = sum((lo[0] <= hi[0]).sum(1) for lo, hi, *_ in
                traverse._child_banks(bvh, bvh.table))
    tris = (bvh.table[:, 9 * LEAF_SIZE:10 * LEAF_SIZE].view(torch.int32)
            >= 0).sum(1)
    zero = torch.zeros((), dtype=torch.int64, device=o.device)
    n = {k: zero.clone() for k in ("internal", "leaf", "slots", "tris")}
    touched = torch.zeros(bvh.num_rows, dtype=torch.bool, device=o.device)
    max_iters = bvh.num_rows * 2 + bvh.stack_depth + 4
    it = 0
    while it < max_iters and bool((s.cur != done).any()):
        alive = s.cur != done
        is_leaf = alive & (s.cur < 0)
        is_int = alive & ~is_leaf
        row = torch.where(is_leaf, ~s.cur, s.cur)
        n["internal"] += is_int.sum()
        n["leaf"] += is_leaf.sum()
        n["slots"] += slots[row[is_int].long()].sum()
        n["tris"] += tris[row[is_leaf].long()].sum()
        touched[row[alive].long()] = True
        s = traverse.traverse_step_plain(bvh, s, first_hit)
        it += 1
    return {**{k: int(v) for k, v in n.items()}, "rows": int(touched.sum())}


def hit_mismatches(got, ref):
    """Lanes whose tri id, t, u or v differ in any bit."""
    bad = got.tri_id != ref.tri_id
    for f in ("t", "u", "v"):
        bad |= (getattr(got, f).view(torch.int32)
                != getattr(ref, f).view(torch.int32))
    return int(bad.sum())


def phase_kernel_vs_plain(sess):
    from dxrpathtracer_tpu_torch.accel import traverse
    from dxrpathtracer_tpu_torch.accel.bvh import LEAF_SIZE
    results, max_err = {}, 0.0
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
             "ops_ms": 0.0, "filled_ops_ms": 0.0}
    d1_hits = None
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
        c = walk_counts(bvh, first_hit, o, d, inv_d, tmin, tmax, act)
        n = int(o.shape[0])
        nbytes = n * (RAY_IN_BYTES + HIT_BYTES) + c["rows"] * ROW_BYTES
        ops = (c["internal"] * bvh.width * SLAB_OPS
               + c["leaf"] * LEAF_SIZE * MT_OPS)
        filled_ops = c["slots"] * SLAB_OPS + c["tris"] * MT_OPS
        b_ms, b_by = bound_ms(nbytes, ops)
        visits = c["internal"] + c["leaf"]
        row = {"rays": n, "active": int(act.sum()),
               "ms": ms, "plain_ms": plain_ms,
               "internal_visits": c["internal"], "leaf_visits": c["leaf"],
               "mvisits_per_s": visits / ms / 1e3,
               "slots_filled_per_internal": c["slots"] / max(c["internal"], 1),
               "tris_filled_per_leaf": c["tris"] / max(c["leaf"], 1),
               "rows_touched": c["rows"], "bytes": nbytes, "ops": ops,
               "padding_ops_share": 1.0 - filled_ops / max(ops, 1),
               "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
               "mismatches": hit_mismatches(got, ref),
               "hits": int(ref.hit.sum())}
        if first_hit:
            row["vis_mismatches"] = int((got.hit != ref.hit).sum())
        elif d1_hits is None:
            d1_hits = got.tri_id
        both = got.hit & ref.hit
        if bool(both.any()):
            max_err = max([max_err] + [
                float((getattr(got, f) - getattr(ref, f))[both].abs().max())
                for f in ("t", "u", "v")])
        ok = row["mismatches"] == 0
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bound_ms"] += b_ms
        total["bytes_ms"] += bound_ms(nbytes)[0]
        total["ops_ms"] += bound_ms(0, ops)[0]
        total["filled_ops_ms"] += bound_ms(0, filled_ops)[0]
        results[name] = row
        log(f"{name}: " + ", ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()))
        if not ok:
            raise SystemExit(f"chip_smoke: kernel and plain traversal "
                             f"disagree on {name}: {row}")
    total["bound_by"] = ("bytes" if total["bytes_ms"] >= total["ops_ms"]
                         else "operations")
    log(f"traversal, five classes: kernel {total['ms']:.3f} ms, plain "
        f"{total['plain_ms']:.1f} ms, bound {total['bound_ms']:.4f} ms "
        f"({total['bound_ms'] / total['ms'] * 100:.1f} % of the kernel's "
        f"time; bytes terms {total['bytes_ms']:.4f} ms, operations terms "
        f"{total['ops_ms']:.4f} ms, of which filled slots "
        f"{total['filled_ops_ms']:.4f} ms)")
    return results, max_err, total, d1_hits


def phase_adversarial():
    """The kernel against the plain walk, bit for bit, on the adversarial
    cases (tools/traverse_cases.py) at W8 and W32, closest and any hit."""
    from dxrpathtracer_tpu_torch.accel import traverse
    from dxrpathtracer_tpu_torch.accel.bvh import build_bvh
    from dxrpathtracer_tpu_torch.tools.traverse_cases import cases
    results = {}
    for case, (tris, rays) in cases().items():
        r = {f: torch.from_numpy(a).to(DEVICE) for f, a in rays.items()}
        inv_d = traverse.safe_inv(r["d"]).contiguous()
        args = (r["o"], r["d"], inv_d, r["tmin"], r["tmax"], r["active"])
        for width in (8, 32):
            bvh = build_bvh(*tris, width=width).to(DEVICE)
            for first_hit in (False, True):
                got = traverse._launch_kernel(bvh, *args, first_hit)
                ref = traverse.traverse_plain(bvh, *args, first_hit)
                name = f"{case}_W{width}_{'any' if first_hit else 'closest'}"
                row = {"rays": int(r["o"].shape[0]),
                       "active": int(r["active"].sum()),
                       "hits": int(ref.hit.sum()),
                       "zero_t_hits": int((ref.hit & (ref.t == 0)).sum()),
                       "mismatches": hit_mismatches(got, ref)}
                results[name] = row
                log(f"adversarial {name}: " + ", ".join(
                    f"{k}={v}" for k, v in row.items()))
                if row["mismatches"]:
                    raise SystemExit(f"chip_smoke: kernel and plain traversal "
                                     f"disagree on the adversarial case "
                                     f"{name}: {row}")
    return results


def phase_main_path(smi):
    from dxrpathtracer_tpu_torch.accel import gather, traverse
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    (w, h), frames = FRAME_SIZE, 10
    settings = AppSettings(current_scene=Scenes.Sponza, benchmark_mode=True,
                           max_path_length=3)
    t0 = time.time()
    sess = RenderSession(settings, w, h, device=DEVICE)
    sync()
    init_s = time.time() - t0
    log(f"main path: init {init_s:.2f} s ({sess.scene.num_triangles} "
        f"triangles, W8 {sess.bvh.num_rows} rows, W32 "
        f"{sess.bvh_ray.num_rows} rows)")

    checks = phase_kernel_vs_plain(sess)

    traverse.KERNEL_LAUNCHES = gather.KERNEL_LAUNCHES = 0
    t0 = time.time()
    sess.render_frame()
    sync()
    first_s = time.time() - t0
    dts = []
    for _ in range(frames):
        t0 = time.time()
        sess.render_frame()
        sync()
        dts.append(time.time() - t0)
    launches = {"traverse": traverse.KERNEL_LAUNCHES,
                "row_gather": gather.KERNEL_LAUNCHES}
    accum = sess.accum
    if tuple(accum.shape) != (h, w, 3) or not bool(accum.isfinite().all()):
        raise SystemExit("chip_smoke: the accumulation is not a finite "
                         f"{h}x{w}x3 image")
    if (launches["traverse"] < 5 * (frames + 1)
            or launches["row_gather"] < frames + 1):
        raise SystemExit(f"chip_smoke: {launches} kernel launches in "
                         f"{frames + 1} frames, want >= 5 traversals and "
                         f">= 1 gather per frame")
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
        f"kernel launches {launches}; accum mean {main['accum_mean']:.4f} "
        f"[{smi}]")
    return sess, main, checks, launches


def phase_same_frame():
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    settings = AppSettings(current_scene=Scenes.Sponza, benchmark_mode=True,
                           max_path_length=3)
    imgs = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.time()
        sess = RenderSession(settings, *SAME_FRAME_SIZE, device=dev)
        sess.render_frame()
        imgs[dev] = sess.accum.cpu()
        log(f"same frame {SAME_FRAME_SIZE} on {dev}: "
            f"{time.time() - t0:.2f} s")
    ref, got = imgs["cpu"], imgs[DEVICE]
    rel = rel_rmse(got, ref)
    exact = float((got == ref).float().mean())
    log(f"same frame: rel RMSE cuda (kernel) vs cpu (plain) {rel:.3e}, "
        f"{exact:.4f} of values bit-equal")
    if not (rel <= 1e-4 and bool(got.isfinite().all())):
        raise SystemExit(f"chip_smoke: kernel frame differs from plain frame "
                         f"(rel RMSE {rel:.3e})")
    return {"rel_rmse": rel, "bit_equal_fraction": exact}


def rel_rmse(got, ref):
    return float(((got - ref) ** 2).mean().sqrt() / (ref.abs().max() + 1e-9))


def phase_bake(smi):
    """The bake main path, as `python -m dxrpathtracer_tpu_torch bake
    --current-scene Sponza --resolution 4096 --atlas pair` drives it."""
    from dxrpathtracer_tpu_torch.accel import gather, traverse
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    from dxrpathtracer_tpu_torch.bake.baker import Baker
    res, steps = BAKE_RES, 3
    settings = AppSettings(current_scene=Scenes.Sponza)
    t0 = time.time()
    sess = RenderSession(settings, 8, 8)  # no device: the card
    if sess.device.type != DEVICE:
        raise SystemExit(f"chip_smoke: RenderSession defaulted to "
                         f"{sess.device}")
    init_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    baker = Baker(sess, resolution=res, atlas_mode="pair")
    covered = int((baker.surface_maps["position"][..., 3] > 0).sum())
    coverage = covered / (res * res)
    log(f"bake: session init {init_s:.2f} s; atlas "
        f"{baker.setup_s['atlas']:.3f} s, texel map "
        f"{baker.setup_s['texel_map']:.2f} s (host), surface maps "
        f"{baker.setup_s['surface_maps']:.3f} s; {covered} covered texels "
        f"({coverage * 100:.1f} %), {len(baker._row0)} slabs of "
        f"{baker._slab_rows} rows")
    if coverage < 0.5:
        raise SystemExit(f"chip_smoke: bake coverage {coverage:.3f} < 0.5")

    traverse.KERNEL_LAUNCHES = gather.KERNEL_LAUNCHES = 0
    t0 = time.time()
    baker.bake_step()
    sync()
    first_s = time.time() - t0
    dts = []
    for _ in range(steps):
        t0 = time.time()
        baker.bake_step()
        sync()
        dts.append(time.time() - t0)
    launches = {"traverse": traverse.KERNEL_LAUNCHES,
                "row_gather": gather.KERNEL_LAUNCHES}
    per_step = {k: v / (steps + 1) for k, v in launches.items()}
    if not bool(baker.accum.isfinite().all()):
        raise SystemExit("chip_smoke: the bake accumulation is not finite")
    if min(launches.values()) == 0:
        raise SystemExit(f"chip_smoke: bake launches {launches}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(dts)
    spread = (max(dts) - min(dts)) / med * 100.0
    mrays = covered * (1 + (settings.max_path_length - 1) * 2) / med / 1e6
    log(f"bake: first step {first_s:.3f} s; {med:.3f} s/step (median of "
        f"{steps}, spread {spread:.1f}%), {mrays:.1f} Mrays/s; launches per "
        f"step {per_step}; peak device memory {peak_gib:.2f} GiB [{smi}]")

    # denoisers on the 4096^2 lightmap (the learned net warms up on a crop:
    # weight load and cuDNN set-up)
    from dxrpathtracer_tpu_torch.render.learned_denoise import learned_denoise
    maps = baker.surface_maps
    learned_denoise(baker.lightmap()[:64, :64], maps["albedo"][:64, :64],
                    maps["normal"][:64, :64])
    denoise_ms = {}
    for mode in ("median", "guided", "learned"):
        sync()
        t0 = time.time()
        out = baker.denoised_lightmap(mode)
        sync()
        denoise_ms[mode] = (time.time() - t0) * 1e3
        if tuple(out.shape) != (res, res, 3) or not bool(out.isfinite().all()):
            raise SystemExit(f"chip_smoke: {mode} denoise is not a finite "
                             f"{res}x{res}x3 map")
    log(f"bake: denoise ms on {res}^2: " + ", ".join(
        f"{k} {v:.1f}" for k, v in denoise_ms.items()))
    out = {"resolution": res, "atlas": "pair",
           "path_length": settings.max_path_length,
           "sqrt_num_samples": settings.sqrt_num_samples,
           "session_init_s": init_s, "setup_s": baker.setup_s,
           "covered_texels": covered, "coverage": coverage,
           "slabs": len(baker._row0), "first_step_s": first_s,
           "step_s": dts, "step_s_median": med, "spread_pct": spread,
           "mrays_per_s": mrays, "kernel_launches": launches,
           "launches_per_step": per_step, "peak_memory_gib": peak_gib,
           "denoise_ms": denoise_ms,
           "lightmap_mean": float(baker.lightmap().mean()), "card": smi}
    return baker, out, launches


def gather_case(name, table, idx, repeat):
    from dxrpathtracer_tpu_torch.accel import gather
    got = gather._launch_kernel(table, idx)
    ref = gather.row_gather_plain(table, idx)
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        raise SystemExit(f"chip_smoke: gather kernel differs from plain on "
                         f"{name}")
    err = float((got - ref).abs().max()) if len(idx) else 0.0
    ms, _ = cuda_ms(lambda: gather._launch_kernel(table, idx), repeat)
    plain_ms, _ = cuda_ms(lambda: gather.row_gather_plain(table, idx), repeat)
    library_ms, _ = cuda_ms(lambda: torch.index_select(table, 0, idx), repeat)
    n, width = int(idx.shape[0]), int(table.shape[1])
    distinct = int(torch.unique(idx).numel())
    # the table's rows that these indices touch are read once, the indices
    # once and the output written once
    b_ms, b_by = bound_ms(distinct * width * 4 + n * 4 + n * width * 4)
    row = {"rows": int(table.shape[0]), "n": n, "width": width,
           "dtype": str(table.dtype).replace("torch.", ""),
           "distinct_rows": distinct, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "mrows_per_s": n / ms / 1e3,
           "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
           # every gathered row counted as read from memory
           "n_rows_bound_ms": bound_ms(n * width * 4 * 2 + n * 4)[0],
           "max_abs_err": err}
    log(f"gather {name}: " + ", ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in row.items()))
    return row


def phase_gather(frame_sess, d1_hits, baker):
    """Row-gather kernel against its plain version and index_select."""
    from dxrpathtracer_tpu_torch.accel.gather import row_gather
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    cases = {}
    rows, n = MICROBENCH_ROWS, MICROBENCH_N
    for width in (32, 128):
        table = torch.randn((rows, width), generator=gen, device=DEVICE)
        idx = torch.randint(0, rows, (n,), generator=gen, device=DEVICE,
                            dtype=torch.int32)
        cases[f"a_microbench_w{width}"] = gather_case(
            f"(a) microbench width {width}", table, idx, repeat=20)
    shade_idx = torch.clamp_min(d1_hits, 0).to(torch.int32).contiguous()
    cases["b_shading_row"] = gather_case(
        "(b) shading row", frame_sess.scene.tri_shade, shade_idx, repeat=10)
    scene = baker.session.scene
    tri_map = torch.from_numpy(baker.texel_map[0].reshape(-1)).to(DEVICE)
    safe_tri = torch.clamp_min(tri_map, 0)
    corner = row_gather(scene.tri_idx, safe_tri)[:, 0].contiguous()
    mat = row_gather(scene.tri_material[:, None], safe_tri)[:, 0].contiguous()
    for name, table, idx in (("tri_idx", scene.tri_idx, safe_tri),
                             ("positions", scene.positions, corner),
                             ("uvs", scene.uvs, corner),
                             ("tri_material", scene.tri_material[:, None],
                              safe_tri),
                             ("packed_meta", scene.packed_meta, mat)):
        cases[f"c_surface_{name}"] = gather_case(
            f"(c) surface map {name}", table, idx, repeat=5)
    return cases


def phase_same_bake():
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    from dxrpathtracer_tpu_torch.bake.baker import Baker
    settings = AppSettings(current_scene=Scenes.BoxTest)
    accums = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.time()
        baker = Baker(RenderSession(settings, 8, 8, device=dev),
                      resolution=64, atlas_mode="charts",
                      atlas_opts={"grid_cols": 512})
        for _ in range(2):
            baker.bake_step()
        accums[dev] = baker.accum.cpu()
        log(f"same bake BoxTest 64^2 x 2 on {dev}: {time.time() - t0:.2f} s")
    got, ref = accums[DEVICE], accums["cpu"]
    count_equal = bool(torch.equal(got[..., 3], ref[..., 3]))
    lm = lambda a: torch.where(a[..., 3:] > 0, a[..., :3]
                               / torch.clamp_min(a[..., 3:], 1.0), 0.0)
    rel = rel_rmse(lm(got), lm(ref))
    log(f"same bake: rel RMSE cuda (kernels) vs cpu (plain) {rel:.3e}, "
        f"validCount equal {count_equal}")
    if not (rel <= 1e-4 and count_equal and bool(got.isfinite().all())):
        raise SystemExit(f"chip_smoke: kernel bake differs from plain bake "
                         f"(rel RMSE {rel:.3e}, validCount equal "
                         f"{count_equal})")
    return {"rel_rmse": rel, "valid_count_equal": count_equal}


def main():
    smi = phase_device()
    sys.path.insert(0, ROOT)
    build = phase_build()
    adversarial = phase_adversarial()
    frame_sess, main_path, (classes, max_err, trav, d1_hits), frame_launches = \
        phase_main_path(smi)
    same = phase_same_frame()
    baker, bake, bake_launches = phase_bake(smi)
    gathers = phase_gather(frame_sess, d1_hits, baker)
    same_bake = phase_same_bake()
    shade = gathers["b_shading_row"]
    kernels = {"kernels": [
        {"name": "traverse", "route": "cuda", "source": TRAVERSE_SOURCE,
         "replaces": TRAVERSE_REPLACES,
         "launches": frame_launches["traverse"] + bake_launches["traverse"],
         "max_abs_err": max_err, "ms": trav["ms"],
         "plain_ms": trav["plain_ms"], "bound_ms": trav["bound_ms"],
         "bound_by": trav["bound_by"], "library_ms": None},
        {"name": "row_gather", "route": "cuda", "source": GATHER_SOURCE,
         "replaces": GATHER_REPLACES,
         "launches": (frame_launches["row_gather"]
                      + bake_launches["row_gather"]),
         "max_abs_err": max(c["max_abs_err"] for c in gathers.values()),
         "ms": shade["ms"], "plain_ms": shade["plain_ms"],
         "bound_ms": shade["bound_ms"], "bound_by": shade["bound_by"],
         "library_ms": shade["library_ms"]}]}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "build": build, "ray_classes": classes,
                   "traversal_total": trav, "adversarial": adversarial,
                   "main_path": main_path, "same_frame": same, "bake": bake,
                   "gather": gathers, "same_bake": same_bake, **kernels}, f,
                  indent=1)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
