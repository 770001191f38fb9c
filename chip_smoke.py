#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one GPU: `python3 chip_smoke.py`.

Drives dxrpathtracer_tpu_torch's main paths and checks every kernel on
them: the path-traced frame (the Sponza-class stand-in, 246,084 triangles, at
1920x1080, path length 3, one CMJ sample per pixel per frame), the
alpha-tested, spot-lit frame (SponzaAlpha-checker: the stand-in plus 384
alpha-tested foliage cards with a checker opacity mask and four spot lights,
dxrpathtracer_tpu_torch/tools/alpha_cases.py; same size and path length),
the `render` command, and the GI lightmap bake (the stand-in, a 4096x4096
lightmap on the pair atlas, default settings: path length 3,
sqrt_num_samples 4). Phases, each fatal on failure:

  1. device: a CUDA device must be present; prints the card's name and power
     limit as nvidia-smi reports them;
  2. build: compiles the traversal kernel (csrc/traverse.cu), the row-gather
     kernel (csrc/gather.cu) and the native SAH builder from the checkout, all
     at once, with the seconds each took; for each (width, first_hit, alpha)
     instantiation of the traversal kernel (eight), ptxas' registers, stack
     frame and spills and the warps one SM holds at once (the persistent
     grid); the opaque W32 instantiations must have no stack frame and no
     spills;
  3. traversal kernel against plain: the kernel and its plain torch version,
     both on the card, (a) on the five ray classes of one plain-route 1080p
     sample (depth-1 closest on W8, depth-1 sun on W8, depth-2 closest, sun
     and terminal on W32): 0 lanes whose tri id, t, u or v differ in any
     bit; times of both, M visits/s; the plain walk counts its internal and
     leaf visits, the filled child slots and triangles of the records it
     visits and the distinct table rows it touches, which give each class
     its bound (BOUND below); (b) on the adversarial cases of
     dxrpathtracer_tpu_torch/tools/traverse_cases.py (equal-t ties, coplanar
     boxes under axis-aligned rays, hits at t = +-0, inactive rays, and the
     alpha cases: an opacity of exactly 0.35, chains of up to 16
     rejections, an opaque and an alpha triangle at equal t, a card seen
     edge-on), W8 and W32, closest and any hit: again 0 lanes that differ in
     any bit;
  4. frame main path: RenderSession on the card; init and first-frame
     seconds, median ms/frame over 10 frames, Mrays/s by bench.py's formula
     W*H*(1+(L-1)*2)/dt; the accumulation must be finite, the traversal
     kernel must have launched 5 times and the gather kernel at least once
     per frame;
  5. same frame, kernel against plain: one 240x135 sample on the card and
     on the CPU; relative RMSE <= 1e-4;
  A. alpha ray classes, kernel against plain: on the SponzaAlpha-checker
     session with max_any_hit_path_length 3, the seven traversal calls of
     one 1080p sample with the alpha test (depth-1 closest, sun and spot on
     W8; depth-2 closest, sun, spot and terminal on W32; the spot rays of
     the four lights in one call): 0 lanes that differ in any bit; ms, M
     visits/s, candidates, texture taps and rejections per ray, bound;
  B. the alpha frame main path: that session at the reference's
     max_any_hit_path_length 1 and at 3 (every ray alpha-tested), 10 frames
     each after a first: median ms/frame with the spread, Mrays/s by
     bench.py's formula (which counts no spot rays), traversal launches per
     frame by instantiation; the accumulation must be finite;
  C. same alpha frame, kernels against plain: one 240x135 sample on the
     card and on the CPU, every traversal call's rays and results recorded.
     At the reference's max_any_hit_path_length 1: relative RMSE <= 1e-4.
     At 2 (depth-2 rays alpha-tested too): per call, the lanes whose rays
     differ between the routes (torch's CUDA and CPU shading ops may round
     a last bit differently) and by how much, the lanes whose results
     differ, none of which may have bit-equal rays, and the lanes whose hit
     differs; each pixel off by more than 1e-3 of the image's maximum, with
     the calls in which its hit differs; then the CPU route once more,
     given the card's rays for its depth-2 (alpha-tested W32) calls:
     relative RMSE <= 1e-4 against the card; and the plain card vs CPU
     reading, <= SAME_ALPHA_2_LIMIT;
  D. the `render` command: `python -m dxrpathtracer_tpu_torch render
     --current-scene Sponza --width 1920 --height 1080 --sqrt-num-samples 2`
     as a subprocess, writing chiprun_out/render.png and render.exr; the EXR
     read back must equal the accumulation of the same 4 samples rendered
     here; the PNG's size; `display_image` timed at 1080p;
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

An alpha class adds to its bound the texture taps its walk takes: TAP_OPS
f32 operations and TAP_BYTES (four channel-0 texels) each.

The line before the last is {"kernels": [...]}: one entry per traversal
instantiation and one for the gather kernel, whose `launches` count the
main paths' runs (the opaque frame, the alpha frames and the bake) and
every one of which must be > 0; the last is {"ok": true, "device": {...}}.
Full results also go to chiprun_out/chip_smoke.json. Exits non-zero, with
no result line, when there is no CUDA device or any phase fails. Imports no
JAX.
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
# f32 operations of one alpha-test texture tap (csrc/traverse.cu
# alpha_accept): 1-u-v (2), the UV lerp (10), uv*size-0.5 (4), size to
# float (2), floor (2), fractions (2), to int (2), the three texel lerps (9)
# and the cutoff (1); its integer index arithmetic is not counted. It reads
# four channel-0 texels.
TAP_OPS = 34
TAP_BYTES = 16
PLAIN_CHUNK = 1 << 21  # rays per plain walk: its lockstep state stays small
# Card vs CPU at max_any_hit_path_length 2, rel-RMSE limit: the H100's
# reading is 8.803e-4, one pixel whose depth-2 path differs (PERF.md)
SAME_ALPHA_2_LIMIT = 2e-3


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
    for key, row in sorted(kernels.items()):
        row["resident_warps_per_sm"] = traverse.resident_warps(*key)
        log(f"  traverse {instance_name(key)}: "
            + ", ".join(f"{k} {v}" for k, v in row.items()))
        if key[0] == 32 and not key[2] and (row["stack_frame_bytes"]
                                            or row["spill_stores"]
                                            or row["spill_loads"]):
            raise SystemExit(f"chip_smoke: the W32 traversal kernel uses "
                             f"local memory: {row}")
    if sorted(kernels) != INSTANCES:
        raise SystemExit(f"chip_smoke: ptxas reported traversal kernels "
                         f"{sorted(kernels)}")
    secs["traverse_kernels"] = {instance_name(k): row
                                for k, row in kernels.items()}
    return secs


# (width, first_hit, alpha) of the traversal kernel's instantiations
INSTANCES = [(w, fh, a) for w in (8, 32) for fh in (False, True)
             for a in (False, True)]


def instance_name(key):
    width, first_hit, alpha = key
    return (f"W{width}_{'any' if first_hit else 'closest'}"
            + ("_alpha" if alpha else ""))


def ptxas_report(log_text):
    """{(width, first_hit, alpha): registers, stack frame and spills} of each
    traversal kernel instantiation in nvcc's -Xptxas -v output (warp_kernel
    walks W32 tables, thread_kernel W8)."""
    import re
    out, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '\S*(warp|thread)_kernelILb"
                      r"([01])ELb([01])E", line)
        if m:
            cur = (32 if m.group(1) == "warp" else 8, m.group(2) == "1",
                   m.group(3) == "1")
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


def plain_walk(bvh, first_hit, o, d, inv_d, tmin, tmax, act, alpha=None,
               counts=None):
    """traverse_plain over chunks of PLAIN_CHUNK rays (each ray's walk is
    its own, so the chunks give the whole call's hits); with `counts`, adds
    every chunk's walk_counts to it instead and returns None."""
    from dxrpathtracer_tpu_torch.accel.traverse import (HitRecord,
                                                        traverse_plain)
    parts = []
    for i in range(0, o.shape[0], PLAIN_CHUNK):
        sl = slice(i, i + PLAIN_CHUNK)
        rays = (o[sl], d[sl], inv_d[sl], tmin[sl], tmax[sl], act[sl])
        if counts is None:
            parts.append(traverse_plain(bvh, *rays, first_hit, alpha))
            continue
        for k, v in walk_counts(bvh, first_hit, *rays, alpha).items():
            counts[k] = (counts[k] | v if k == "touched" else
                         counts[k] + v) if k in counts else v
    if counts is not None:
        return None
    return HitRecord(*(torch.cat([getattr(p, f) for p in parts])
                       for f in ("t", "tri_id", "u", "v")))


def ray_classes(sess):
    """The traversal calls of one 1080p sample, its rays made on the plain
    route: {name: (bvh, first_hit, o, d, t_min, t_max, active, alpha)},
    where alpha is the alpha test or None (a name ends in _alpha then)."""
    from dxrpathtracer_tpu_torch.accel.traverse import safe_inv
    from dxrpathtracer_tpu_torch.render import integrator as it

    s, dev = sess.settings, sess.device
    w, h = sess.width, sess.height
    frame = sess.frame_constants(0)
    o, d, length, pix = it.raygen(s, frame, w, h, dev)
    alpha = it._make_alpha_test(sess.scene, s)

    def plain(bvh, first_hit, o, d, tmin, tmax, act, a):
        tmin = torch.as_tensor(tmin, dtype=torch.float32,
                               device=dev).expand(o.shape[0]).contiguous()
        return plain_walk(bvh, first_hit, o, d, safe_inv(d), tmin, tmax,
                          act, a)

    def name(depth, kind, table, a):
        return (f"d{depth}_{kind}_W{table.width}"
                + ("_alpha" if a is not None else ""))

    out = {}
    n = w * h
    state = it._path_state0(o, d, length)
    for depth, flags in it._depth_schedule(s):
        table = sess.bvh if depth == 1 else sess.bvh_ray
        a = alpha if flags["use_any_hit"] else None
        args = (state["ray_o"], state["ray_d"], state["t_min"],
                state["t_max"], state["active"])
        out[name(depth, "closest", table, a)] = (table, False, *args, a)
        rec = plain(table, False, *args, a)
        state, reqs, mid = it._shade_vertex(
            sess.scene, sess.sky_cube, s, frame, depth, flags, state, rec,
            pix, n, 1, frame.curr_sample_idx)
        plan = it._shadow_plan(sess.scene, s, alpha is not None, flags)
        vis = [None] * len(reqs)
        for kind, tab, r, a, pos in it._shadow_calls(
                sess.bvh, sess.bvh_ray, alpha, depth, plan, reqs):
            out[name(depth, kind + "_any", tab, a)] = (tab, True, *r, a)
            v = torch.where(plain(tab, True, *r, a).hit, 0.0, 1.0)
            for j, i in enumerate(pos):
                vis[i] = v[j * n:(j + 1) * n]
        state = it._apply_vertex(s, sess.sky_cube, depth, flags, state, mid,
                                 vis)
    return out


def walk_counts(bvh, first_hit, o, d, inv_d, tmin, tmax, act, alpha=None):
    """{internal and leaf visits, filled child slots and triangles of the
    visited records, the table rows touched (a mask), and with `alpha` the
    alpha test's candidates, texture taps and rejections} of the plain walk
    on these rays: traverse_plain's loop, counting as it steps. A slot is
    filled where its box is not inverted, a triangle where its tri id is
    >= 0; the rest are padding that the kernel tests all the same."""
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
    tally = {}
    accept = None if alpha is None else counting_accept(alpha, tally)
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
        s = traverse.traverse_step_plain(bvh, s, first_hit, accept)
        it += 1
    return {**{k: int(v) for k, v in n.items()}, **tally,
            "touched": touched}


def counting_accept(alpha, tally):
    """accept_fn for the plain walk: `alpha`'s verdicts, adding to `tally`
    the candidates it is asked about (triangles that pass the geometric
    test), the texture taps among them (opacity-mapped ones) and the
    rejections."""
    from dxrpathtracer_tpu_torch.accel import traverse
    from dxrpathtracer_tpu_torch.scene.types import TRI_SHADE_META

    def accept(tid, u, v):
        ok = alpha(tid, u, v)
        rows = alpha.tri_shade.index_select(0, torch.clamp_min(tid, 0).long())
        taps = rows.view(torch.int32)[:, TRI_SHADE_META
                                      + traverse._HAS_OPACITY] != 0
        for k, c in (("candidates", ok.numel()), ("taps", taps.sum()),
                     ("rejected", (~ok).sum())):
            tally[k] = tally.get(k, 0) + int(c)
        return ok
    return accept


def hit_mismatches(got, ref):
    """Lanes whose tri id, t, u or v differ in any bit."""
    bad = got.tri_id != ref.tri_id
    for f in ("t", "u", "v"):
        bad |= (getattr(got, f).view(torch.int32)
                != getattr(ref, f).view(torch.int32))
    return int(bad.sum())


def phase_kernel_vs_plain(sess, label="traversal, five classes"):
    """Every traversal class of one 1080p sample of `sess`: the kernel
    against the plain walk, bit for bit, with times, counts and bounds.
    Returns (rows by class, max |err|, totals, the depth-1 closest hit ids,
    sums by kernel instantiation)."""
    from dxrpathtracer_tpu_torch.accel import traverse
    from dxrpathtracer_tpu_torch.accel.bvh import LEAF_SIZE
    results, max_err = {}, 0.0
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
             "ops_ms": 0.0, "filled_ops_ms": 0.0}
    by_instance = {}
    d1_hits = None
    for name, (bvh, first_hit, o, d, tmin, tmax, act, alpha) in \
            ray_classes(sess).items():
        o, d = o.contiguous(), d.contiguous()
        tmin = torch.as_tensor(tmin, dtype=torch.float32, device=o.device)
        tmin = tmin.expand(o.shape[0]).contiguous()
        tmax, act = tmax.contiguous(), act.contiguous()
        inv_d = traverse.safe_inv(d).contiguous()
        kernel = lambda: traverse._launch_kernel(bvh, o, d, inv_d, tmin, tmax,
                                                 act, first_hit, alpha)
        kernel()  # warm-up
        ms, got = cuda_ms(kernel, repeat=3)
        plain_ms, ref = cuda_ms(lambda: plain_walk(
            bvh, first_hit, o, d, inv_d, tmin, tmax, act, alpha))
        c = {}
        plain_walk(bvh, first_hit, o, d, inv_d, tmin, tmax, act, alpha, c)
        c["rows"] = int(c.pop("touched").sum())
        taps = c.get("taps", 0)
        n = int(o.shape[0])
        nbytes = (n * (RAY_IN_BYTES + HIT_BYTES) + c["rows"] * ROW_BYTES
                  + taps * TAP_BYTES)
        ops = (c["internal"] * bvh.width * SLAB_OPS
               + c["leaf"] * LEAF_SIZE * MT_OPS + taps * TAP_OPS)
        filled_ops = (c["slots"] * SLAB_OPS + c["tris"] * MT_OPS
                      + taps * TAP_OPS)
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
        if alpha is not None:
            row.update(candidates_per_ray=c.get("candidates", 0) / n,
                       taps_per_ray=taps / n,
                       rejected_per_ray=c.get("rejected", 0) / n,
                       taps=taps, rejected=c.get("rejected", 0))
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
        err = 0.0
        if bool(both.any()):
            err = max(float((getattr(got, f) - getattr(ref, f))[both].abs()
                            .max()) for f in ("t", "u", "v"))
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bound_ms"] += b_ms
        total["bytes_ms"] += bound_ms(nbytes)[0]
        total["ops_ms"] += bound_ms(0, ops)[0]
        total["filled_ops_ms"] += bound_ms(0, filled_ops)[0]
        inst = by_instance.setdefault(
            (bvh.width, first_hit, alpha is not None),
            {"classes": [], "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
             "bytes_ms": 0.0, "ops_ms": 0.0, "max_abs_err": 0.0})
        inst["classes"].append(name)
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                     ("bytes_ms", bound_ms(nbytes)[0]),
                     ("ops_ms", bound_ms(0, ops)[0])):
            inst[k] += v
        inst["max_abs_err"] = max(inst["max_abs_err"], err)
        results[name] = row
        log(f"{name}: " + ", ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()))
        if not ok:
            raise SystemExit(f"chip_smoke: kernel and plain traversal "
                             f"disagree on {name}: {row}")
    total["bound_by"] = ("bytes" if total["bytes_ms"] >= total["ops_ms"]
                         else "operations")
    for inst in by_instance.values():
        inst["bound_by"] = ("bytes" if inst["bytes_ms"] >= inst["ops_ms"]
                            else "operations")
    log(f"{label}: kernel {total['ms']:.3f} ms, plain "
        f"{total['plain_ms']:.1f} ms, bound {total['bound_ms']:.4f} ms "
        f"({total['bound_ms'] / total['ms'] * 100:.1f} % of the kernel's "
        f"time; bytes terms {total['bytes_ms']:.4f} ms, operations terms "
        f"{total['ops_ms']:.4f} ms, of which filled slots "
        f"{total['filled_ops_ms']:.4f} ms)")
    return results, max_err, total, d1_hits, by_instance


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
    results.update(phase_adversarial_alpha())
    return results


def phase_adversarial_alpha():
    """The alpha instantiations against the plain walk with the alpha test,
    bit for bit, on the alpha cases of tools/traverse_cases.py: W8 (with
    alpha flags) and W32, closest and any hit."""
    from dxrpathtracer_tpu_torch.accel import traverse
    from dxrpathtracer_tpu_torch.accel.bvh import build_bvh_for_scene
    from dxrpathtracer_tpu_torch.app.settings import AppSettings
    from dxrpathtracer_tpu_torch.render.integrator import _make_alpha_test
    from dxrpathtracer_tpu_torch.tools.traverse_cases import (
        alpha_case_scene, alpha_cases)
    results = {}
    for case, (meshes, mask, rays) in alpha_cases().items():
        scene = alpha_case_scene(meshes, mask)
        alpha = _make_alpha_test(scene.to(DEVICE), AppSettings())
        r = {f: torch.from_numpy(a).to(DEVICE) for f, a in rays.items()}
        inv_d = traverse.safe_inv(r["d"]).contiguous()
        args = (r["o"], r["d"], inv_d, r["tmin"], r["tmax"], r["active"])
        for width in (8, 32):
            bvh = build_bvh_for_scene(scene, width=width,
                                      flag_alpha=width == 8).to(DEVICE)
            for first_hit in (False, True):
                got = traverse._launch_kernel(bvh, *args, first_hit, alpha)
                ref = traverse.traverse_plain(bvh, *args, first_hit, alpha)
                c = plain_counts(bvh, first_hit, args, alpha)
                name = f"{case}_W{width}_{'any' if first_hit else 'closest'}"
                row = {"rays": int(r["o"].shape[0]),
                       "active": int(r["active"].sum()),
                       "hits": int(ref.hit.sum()),
                       "candidates": c.get("candidates", 0),
                       "taps": c.get("taps", 0),
                       "rejected": c.get("rejected", 0),
                       "mismatches": hit_mismatches(got, ref)}
                results[name] = row
                log(f"adversarial {name}: " + ", ".join(
                    f"{k}={v}" for k, v in row.items()))
                if row["mismatches"] or not row["candidates"]:
                    raise SystemExit(f"chip_smoke: alpha kernel and plain "
                                     f"traversal disagree on the adversarial "
                                     f"case {name}: {row}")
    return results


def plain_counts(bvh, first_hit, rays, alpha):
    counts = {}
    plain_walk(bvh, first_hit, *rays, alpha, counts)
    counts.pop("touched", None)
    return counts


def phase_main_path(smi):
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

    first_s, dts, launches = timed_frames(sess, frames)
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


def reset_launches():
    from dxrpathtracer_tpu_torch.accel import gather, traverse
    gather.KERNEL_LAUNCHES = 0
    traverse.KERNEL_LAUNCHES.clear()


def read_launches():
    """The kernel launches since reset_launches: in all and by traversal
    instantiation."""
    from dxrpathtracer_tpu_torch.accel import gather, traverse
    return {"traverse": sum(traverse.KERNEL_LAUNCHES.values()),
            "row_gather": gather.KERNEL_LAUNCHES,
            "traverse_by_instance": {
                instance_name(k): v
                for k, v in sorted(traverse.KERNEL_LAUNCHES.items())}}


def timed_frames(sess, frames):
    """The launch counts set to 0, a first frame, then `frames` frames, each
    synchronised: (first frame s, frame s, launches of all of them)."""
    reset_launches()
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
    return first_s, dts, read_launches()


def phase_alpha(smi):
    """The slice's frame: SponzaAlpha-checker (tools/alpha_cases.py) at
    1080p, path length 3, benchmark mode. (A) its traversal classes with
    the alpha test at every depth, kernel against plain; (B) the frame at
    max_any_hit_path_length 1 and 3, 10 frames each."""
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    from dxrpathtracer_tpu_torch.scene.registry import checker_mask
    from dxrpathtracer_tpu_torch.tools import alpha_cases
    (w, h), frames = FRAME_SIZE, 10
    t0 = time.time()
    scene, preset = alpha_cases.sponza_alpha_checker()
    settings = AppSettings(current_scene=Scenes.Sponza, benchmark_mode=True,
                           max_path_length=3, max_any_hit_path_length=3)
    sess = RenderSession(settings, w, h, device=DEVICE, scene=scene,
                         preset=preset)
    sync()
    init_s = time.time() - t0
    log(f"alpha frame: init {init_s:.2f} s ({sess.scene.num_triangles} "
        f"triangles, {scene.num_lights} spot lights, W8 {sess.bvh.num_rows} "
        f"rows with alpha flags {sess.bvh.has_alpha_flags}, W32 "
        f"{sess.bvh_ray.num_rows} rows); the reference's foliage DDS is not "
        f"in the repository, the checker is bound "
        f"({float((checker_mask() < 0.35).mean()):.2f} of its texels "
        f"reject)")
    checks = phase_kernel_vs_plain(sess, "alpha traversal classes")

    runs = {}
    for any_hit_len in (1, 3):
        sess.settings = sess.settings.replace(
            max_any_hit_path_length=any_hit_len)
        first_s, dts, launches = timed_frames(sess, frames)
        accum = sess.accum
        if (tuple(accum.shape) != (h, w, 3)
                or not bool(accum.isfinite().all())):
            raise SystemExit("chip_smoke: the alpha accumulation is not a "
                             f"finite {h}x{w}x3 image")
        med = statistics.median(dts)
        spread = (max(dts) - min(dts)) / med * 100.0
        mrays = w * h * (1 + (settings.max_path_length - 1) * 2) / med / 1e6
        per_frame = {k: v / (frames + 1) for k, v in
                     launches["traverse_by_instance"].items()}
        runs[f"max_any_hit_{any_hit_len}"] = {
            "first_frame_s": first_s, "ms_per_frame_median": med * 1e3,
            "ms_per_frame": [t * 1e3 for t in dts], "spread_pct": spread,
            "frames": frames, "mrays_per_s": mrays,
            "kernel_launches": launches,
            "traverse_launches_per_frame": per_frame,
            "accum_mean": float(accum.mean()), "card": smi}
        log(f"alpha frame, max_any_hit_path_length {any_hit_len}: first "
            f"frame {first_s:.3f} s; {med * 1e3:.2f} ms/frame (median of "
            f"{frames}, spread {spread:.1f}%), {mrays:.1f} Mrays/s (bench.py's "
            f"formula: no spot rays counted); traversal launches per frame "
            f"{per_frame}, gather launches {launches['row_gather']}; accum "
            f"mean {float(accum.mean()):.4f} [{smi}]")
        if launches["traverse"] != 7 * (frames + 1):
            raise SystemExit(f"chip_smoke: {launches} traversal launches in "
                             f"{frames + 1} alpha frames, want 7 per frame")
    out = {"width": w, "height": h, "path_length": settings.max_path_length,
           "triangles": sess.scene.num_triangles,
           "spot_lights": scene.num_lights,
           "init_s": init_s, "runs": runs}
    launches = [r["kernel_launches"] for r in runs.values()]
    return out, checks, launches


def recorded_frame(scene, preset, settings, dev, inject=None):
    """One SAME_FRAME_SIZE sample of `scene` on `dev`, every traversal call
    of it recorded: (accumulation on the CPU, [{"key": (first_hit, table
    width, alpha-tested, rays), "rays": (o, d, t_min, t_max, active),
    "out": results}], both on the CPU). With `inject` (the calls of another
    run), the alpha-tested calls on the W32 table take that run's rays
    instead of their own."""
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.render import integrator as it
    calls = []
    originals = it.closest_hit, it.any_hit

    def recording(fn, first_hit):
        def call(bvh, o, d, tmin, tmax, active=None, alpha=None):
            n, d_ = o.shape[0], o.device
            rays = [o, d] + [torch.as_tensor(x, dtype=torch.float32,
                                             device=d_).expand(n)
                             for x in (tmin, tmax)]
            rays.append(torch.ones(n, dtype=torch.bool, device=d_)
                        if active is None else active)
            key = (first_hit, bvh.width, alpha is not None, n)
            if inject is not None and alpha is not None and bvh.width == 32:
                other = inject[len(calls)]
                assert other["key"] == key, (other["key"], key)
                rays = [x.to(d_) for x in other["rays"]]
            out = fn(bvh, *rays, alpha=alpha)
            res = out if first_hit else torch.stack(
                [out.t, out.tri_id.view(torch.float32), out.u, out.v])
            calls.append({"key": key, "rays": [x.cpu() for x in rays],
                          "out": res.cpu()})
            return out
        return call

    it.closest_hit = recording(originals[0], False)
    it.any_hit = recording(originals[1], True)
    try:
        sess = RenderSession(settings, *SAME_FRAME_SIZE, device=dev,
                             scene=scene, preset=preset)
        sess.render_frame()
        return sess.accum.cpu(), calls
    finally:
        it.closest_hit, it.any_hit = originals


def call_differences(a, b, pixels):
    """Per traversal call of two recorded runs of `pixels` pixels: the lanes
    whose rays differ in any bit and the largest difference of an origin or
    direction component; the lanes whose results differ in any bit, and of
    those the lanes whose rays are bit-equal; the lanes whose hit differs
    (another triangle, or the other visibility). Returns (rows, per call
    the (pixels,) mask of pixels with a lane whose hit differs)."""
    rows, masks = [], []
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 \
        else x.to(torch.int32)
    for ca, cb in zip(a, b, strict=True):
        if ca["key"] != cb["key"]:
            raise SystemExit(f"chip_smoke: traversal calls differ: "
                             f"{ca['key']} and {cb['key']}")
        first_hit, width, alpha, n = ca["key"]
        ray_diff = torch.zeros(n, dtype=torch.bool)
        for x, y in zip(ca["rays"], cb["rays"]):
            diff = bits(x) != bits(y)
            ray_diff |= diff.reshape(n, -1).any(1)
        ray_abs = max(float((x - y).abs().max()) for x, y in
                      zip(ca["rays"][:2], cb["rays"][:2]))
        out_diff = bits(ca["out"]) != bits(cb["out"])
        if first_hit:
            hit_diff = out_diff
        else:
            hit_diff = out_diff[1]  # the triangle id
            out_diff = out_diff.any(0)
        masks.append(hit_diff.reshape(-1, pixels).any(0))
        rows.append({"call": f"{'any' if first_hit else 'closest'}_W{width}"
                     + ("_alpha" if alpha else ""), "rays": n,
                     "rays_differ": int(ray_diff.sum()),
                     "max_abs_ray_diff": ray_abs,
                     "results_differ": int(out_diff.sum()),
                     "results_differ_rays_equal":
                         int((out_diff & ~ray_diff).sum()),
                     "hits_differ": int(hit_diff.sum())})
    return rows, masks


def phase_same_alpha_frame():
    """The alpha, spot-lit frame at SAME_FRAME_SIZE on the card and on the
    CPU: at max_any_hit_path_length 1 held at rel-RMSE <= 1e-4; at 2, the
    witness that the gap between the routes enters through the depth-2
    rays and not through the kernel."""
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    from dxrpathtracer_tpu_torch.tools.alpha_cases import sponza_alpha_checker
    scene, preset = sponza_alpha_checker()
    out = {}
    runs = {}
    for any_hit_len in (1, 2):
        settings = AppSettings(current_scene=Scenes.Sponza,
                               benchmark_mode=True, max_path_length=3,
                               max_any_hit_path_length=any_hit_len)
        for dev in (DEVICE, "cpu"):
            t0 = time.time()
            runs[any_hit_len, dev] = recorded_frame(scene, preset, settings,
                                                    dev)
            log(f"same alpha frame {SAME_FRAME_SIZE}, max_any_hit_path_"
                f"length {any_hit_len}, on {dev}: {time.time() - t0:.2f} s")
    got, ref = runs[1, DEVICE][0], runs[1, "cpu"][0]
    rel = rel_rmse(got, ref)
    exact = float((got == ref).float().mean())
    log(f"same alpha frame, max_any_hit_path_length 1: rel RMSE cuda "
        f"(kernel) vs cpu (plain) {rel:.3e}, {exact:.4f} of values "
        f"bit-equal")
    if not (rel <= 1e-4 and bool(got.isfinite().all())
            and float(ref.abs().max()) > 0):
        raise SystemExit(f"chip_smoke: kernel alpha frame differs from the "
                         f"plain frame (rel RMSE {rel:.3e})")
    out["max_any_hit_1"] = {"rel_rmse": rel, "bit_equal_fraction": exact}

    # max_any_hit_path_length 2: the routes compared call by call, then the
    # CPU route given the card's rays for its alpha-tested W32 calls (the
    # depth-2 closest, sun and spot rays)
    (card, card_calls), (cpu, cpu_calls) = runs[2, DEVICE], runs[2, "cpu"]
    settings = AppSettings(current_scene=Scenes.Sponza, benchmark_mode=True,
                           max_path_length=3, max_any_hit_path_length=2)
    t0 = time.time()
    given, _ = recorded_frame(scene, preset, settings, "cpu",
                              inject=card_calls)
    log(f"same alpha frame, max_any_hit_path_length 2, on cpu with the "
        f"card's depth-2 rays: {time.time() - t0:.2f} s")
    w, h = SAME_FRAME_SIZE
    calls, hit_masks = call_differences(card_calls, cpu_calls, w * h)
    for row in calls:
        log("  card vs cpu " + ", ".join(
            f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()))
    scale = float(card.abs().max())
    reading = {}
    for name, img in (("cpu", cpu), ("cpu_given_card_depth2_rays", given)):
        off = ((img - card).abs().amax(-1) > 1e-3 * scale).reshape(-1)
        # each pixel that is off, with the calls in which one of its lanes
        # hit another triangle or got the other visibility
        pixels = [{"x": int(p) % w, "y": int(p) // w,
                   "calls_whose_hit_differs": [
                       f"{i}:{calls[i]['call']}"
                       for i, m in enumerate(hit_masks) if bool(m[p])]}
                  for p in off.nonzero()[:, 0][:8]]
        reading[name] = {
            "rel_rmse": rel_rmse(img, card),
            "bit_equal_fraction": float((img == card).float().mean()),
            "pixels_off_by_1e-3_of_max": int(off.sum()),
            "pixels_off": pixels}
        log(f"same alpha frame, max_any_hit_path_length 2: cuda (kernel) vs "
            f"{name}: " + ", ".join(f"{k} {v:.4g}" if isinstance(v, float)
                                    else f"{k} {v}"
                                    for k, v in reading[name].items()))
    unexplained = sum(r["results_differ_rays_equal"] for r in calls)
    if (unexplained or reading["cpu_given_card_depth2_rays"]["rel_rmse"]
            > 1e-4 or reading["cpu"]["rel_rmse"] > SAME_ALPHA_2_LIMIT):
        raise SystemExit(f"chip_smoke: at max_any_hit_path_length 2, "
                         f"{unexplained} traversal lanes differ on bit-equal "
                         f"rays, or the frames differ: {reading}")
    out["max_any_hit_2"] = {**reading, "calls": calls}
    return out


def phase_render_command(smi):
    """`python -m dxrpathtracer_tpu_torch render` on the card, as a user
    runs it; its EXR against the same samples rendered here."""
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    from dxrpathtracer_tpu_torch.render.film import read_exr
    w, h = FRAME_SIZE
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    png, exr = (os.path.join(out_dir, f) for f in ("render.png",
                                                   "render.exr"))
    cmd = [sys.executable, "-m", "dxrpathtracer_tpu_torch", "render",
           "--current-scene", "Sponza", "--width", str(w), "--height", str(h),
           "--sqrt-num-samples", "2", "--output", png, "--save-hdr", exr]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    cmd_s = time.time() - t0
    if proc.returncode != 0:
        raise SystemExit(f"chip_smoke: the render command failed:\n"
                         f"{proc.stderr[-3000:]}")
    for line in proc.stderr.splitlines():
        if line.startswith("#"):
            log(f"render command: {line}")
    hdr, names = read_exr(exr)
    sess = RenderSession(AppSettings(current_scene=Scenes.Sponza,
                                     sqrt_num_samples=2), w, h)
    sess.render_to_completion()
    accum = sess.accum.cpu()
    got = torch.from_numpy(hdr)
    if names != ["R", "G", "B"] or tuple(got.shape) != (h, w, 3):
        raise SystemExit(f"chip_smoke: render.exr holds {names} "
                         f"{tuple(got.shape)}")
    rel = rel_rmse(got, accum)
    exact = float((got == accum).float().mean())
    # display_image at 1080p (bloom and the tone curve), CUDA events
    sess.display_image()
    disp_ms, disp = cuda_ms(sess.display_image, repeat=5)
    png_bytes = os.path.getsize(png)
    log(f"render command: {cmd_s:.1f} s; render.png {png_bytes} B, "
        f"render.exr vs the accumulation of the same 4 samples here: rel "
        f"RMSE {rel:.3e}, {exact:.4f} of values bit-equal; display_image "
        f"{disp_ms:.3f} ms at {w}x{h} [{smi}]")
    if rel > 1e-6 or not bool(disp.isfinite().all()) or png_bytes < 1000:
        raise SystemExit(f"chip_smoke: render command output wrong (EXR "
                         f"rel RMSE {rel:.3e}, PNG {png_bytes} B)")
    return {"command_s": cmd_s, "png_bytes": png_bytes, "exr_rel_rmse": rel,
            "exr_bit_equal_fraction": exact, "display_image_ms": disp_ms,
            "card": smi}


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

    reset_launches()
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
    launches = read_launches()
    per_step = {k: launches[k] / (steps + 1)
                for k in ("traverse", "row_gather")}
    if not bool(baker.accum.isfinite().all()):
        raise SystemExit("chip_smoke: the bake accumulation is not finite")
    if min(launches["traverse"], launches["row_gather"]) == 0:
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
    frame_sess, main_path, (classes, _, trav, d1_hits, opaque_inst), \
        frame_launches = phase_main_path(smi)
    same = phase_same_frame()
    alpha, (alpha_classes, _, alpha_trav, _, alpha_inst), alpha_launches = \
        phase_alpha(smi)
    torch.cuda.empty_cache()
    same_alpha = phase_same_alpha_frame()
    render = phase_render_command(smi)
    torch.cuda.empty_cache()
    baker, bake, bake_launches = phase_bake(smi)
    gathers = phase_gather(frame_sess, d1_hits, baker)
    same_bake = phase_same_bake()
    shade = gathers["b_shading_row"]

    # each traversal instantiation: its launches on the main paths (the
    # opaque frame, the alpha frames, the bake) and its ray classes' sums
    runs = [frame_launches, *alpha_launches, bake_launches]
    entries = []
    for key in INSTANCES:
        name = instance_name(key)
        launches = sum(r["traverse_by_instance"].get(name, 0) for r in runs)
        inst = (alpha_inst if key[2] else opaque_inst).get(key)
        if launches == 0 or inst is None:
            raise SystemExit(f"chip_smoke: traversal {name}: {launches} "
                             f"launches on the main paths, classes {inst}")
        entries.append({
            "name": f"traverse_{name}", "route": "cuda",
            "source": TRAVERSE_SOURCE, "replaces": TRAVERSE_REPLACES,
            "launches": launches, "max_abs_err": inst["max_abs_err"],
            "ms": inst["ms"], "plain_ms": inst["plain_ms"],
            "bound_ms": inst["bound_ms"], "bound_by": inst["bound_by"],
            "library_ms": None})
    entries.append(
        {"name": "row_gather", "route": "cuda", "source": GATHER_SOURCE,
         "replaces": GATHER_REPLACES,
         "launches": sum(r["row_gather"] for r in runs),
         "max_abs_err": max(c["max_abs_err"] for c in gathers.values()),
         "ms": shade["ms"], "plain_ms": shade["plain_ms"],
         "bound_ms": shade["bound_ms"], "bound_by": shade["bound_by"],
         "library_ms": shade["library_ms"]})
    kernels = {"kernels": entries}
    instances = {instance_name(k): v
                 for k, v in {**opaque_inst, **alpha_inst}.items()}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "build": build, "ray_classes": classes,
                   "traversal_total": trav, "adversarial": adversarial,
                   "main_path": main_path, "same_frame": same,
                   "alpha_ray_classes": alpha_classes,
                   "alpha_traversal_total": alpha_trav, "alpha_frame": alpha,
                   "same_alpha_frame": same_alpha, "render_command": render,
                   "traversal_instances": instances, "bake": bake,
                   "gather": gathers, "same_bake": same_bake, **kernels}, f,
                  indent=1)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
