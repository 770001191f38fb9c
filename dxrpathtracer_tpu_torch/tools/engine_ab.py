"""The packet, dense-proxy and sun-grid kernels of two trees on the same
rays, on the card: `python -m dxrpathtracer_tpu_torch.tools.engine_ab
--parent DIR [--packet-variant NAME=FILE ...]`.

DIR is a checkout of another commit (`git archive <commit> | tar -C DIR -xf
-`). The script builds DIR's csrc/packet.cu, csrc/screen.cu and
csrc/sungrid.cu, this tree's, one alternative of this tree's ("alt": the
packet kernel with kWarps = 8 packets per block, the proxy with kPhase1 =
32 triangles in its first phase, the grid walk with kGroup = 4 lanes per
ray; each a copy of the source with that one constant changed) and any
other packet.cu given as a variant (run with this tree's screens and
grid). It records the engine classes of one sample of the 1080p stand-in
with the default settings (chip_smoke.py's E1 classes) and the grid's two
classes of one slab of a 4096^2 bake step (E1's bake classes), holds every
build against the plain versions on them, bit for bit, runs chip_smoke.py's
E1 edge cases on this tree's kernels, and then times the builds in turns:
parent, change, alt, the variants, then the same in reverse, each turn
every class (CUDA events, the mean of 20 launches after one), beside the
per-ray walk on the same rays (W8 for the depth-1 classes, W32 for the
proxy's, both for the grid's) and each class's bound by chip_smoke.py's
rule. It prints one line per class and build with the card's name and
power limit, each build's ptxas report, and writes
chiprun_out/engine_ab.json. Needs a CUDA device.
"""

import argparse
import ctypes
import json
import os
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..accel import packet, proxy, sunspace, traverse
from ..buildlib import BUILD_DIR, REPO_ROOT, build_shared_library, nvcc

ALT = {"packet": ("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),
       "screen": ("constexpr int kPhase1 = 16;",
                  "constexpr int kPhase1 = 32;"),
       "sungrid": ("constexpr int kGroup = 1;", "constexpr int kGroup = 4;")}
# each source's wrapper module and the C functions every build of it has
KERNELS = {"packet": (packet, ("dxrpt_packet_traverse",)),
           "screen": (proxy, ("dxrpt_proxy_blocked", "dxrpt_cut_clear")),
           "sungrid": (sunspace, ("dxrpt_sun_any_hit",))}
REPEAT = 20


def _sources(parent: Path, variants: dict) -> dict:
    """{(build, kernel): source path} of the parent, alt and `variants`
    ({name: packet.cu path}) builds; the alt sources are written under the
    build directory."""
    out = {(name, "packet"): Path(path) for name, path in variants.items()}
    for kernel in KERNELS:
        out[("parent", kernel)] = (parent / "dxrpathtracer_tpu_torch" / "csrc"
                                   / f"{kernel}.cu")
        text = (Path(packet.KERNEL_SOURCE).parent / f"{kernel}.cu").read_text()
        old, new = ALT[kernel]
        if text.count(old) != 1:
            raise SystemExit(f"engine_ab: {kernel}.cu does not hold {old!r}")
        alt = BUILD_DIR / "variants" / f"{kernel}_alt.cu"
        alt.parent.mkdir(parents=True, exist_ok=True)
        alt.write_text(text.replace(old, new))
        out[("alt", kernel)] = alt
    return out


def _build(sources: dict) -> dict:
    """{(build, kernel): (ctypes library, ptxas log)}: this tree's ("change",
    the wrappers' own libraries) and `sources`', built at once."""
    def one(item):
        (build, kernel), src = item
        # the alt copies include this tree's headers (csrc/alpha.cuh)
        path, log = build_shared_library(
            Path(src), f"{kernel}_{build}",
            [nvcc(), *traverse.NVCC_FLAGS, "-I",
             str(Path(packet.KERNEL_SOURCE).parent)])
        return (build, kernel), (ctypes.CDLL(str(path)), log)

    with ThreadPoolExecutor(len(sources) + len(KERNELS)) as pool:
        own = [pool.submit(m.kernel_library) for m, _ in KERNELS.values()]
        libs = dict(pool.map(one, sources.items()))
        for f in own:
            f.result()
    for kernel, (mod, _) in KERNELS.items():
        libs[("change", kernel)] = (mod.kernel_library(), mod.BUILD_LOG)
    # the C interfaces are the same in every build: the wrappers' argtypes
    for (build, kernel), (lib, _) in libs.items():
        ref = libs[("change", kernel)][0]
        for name in KERNELS[kernel][1]:
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = getattr(ref, name).argtypes
    return libs


def _use(libs, build):
    """Points the wrappers at `build`'s libraries (a packet variant's with
    this tree's screens and grid)."""
    for kernel, (mod, _) in KERNELS.items():
        mod._kernel = libs.get((build, kernel), libs[("change", kernel)])[0]


def _hits_differ(a, b):
    return sum(int((getattr(a, f).view(torch.int32)
                    != getattr(b, f).view(torch.int32)).sum())
               for f in ("t", "u", "v")) + int((a.tri_id != b.tri_id).sum())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the commit to compare with")
    ap.add_argument("--packet-variant", action="append", default=[],
                    metavar="NAME=FILE",
                    help="another packet.cu to time with the rest")
    args = ap.parse_args(argv)
    variants = dict(v.split("=", 1) for v in args.packet_variant)
    names = ["parent", "change", "alt", *variants]
    turns = names + names[::-1]
    sys.path.insert(0, str(REPO_ROOT))
    import chip_smoke as cs

    from ..app.session import RenderSession
    from ..app.settings import AppSettings, Scenes
    from ..bake.baker import Baker

    smi = cs.phase_device()
    libs = _build(_sources(args.parent.resolve(), variants))
    builds = {}
    for (build, kernel), (_, log) in sorted(libs.items()):
        for name, row in cs.ptxas_entries(log).items():
            builds[f"{build} {name}"] = row
            print(f"ptxas {build} {name}: " + ", ".join(
                f"{k} {v}" for k, v in row.items()), flush=True)
    _use(libs, "change")
    warps = cs.engine_resident_warps(packet, sunspace, proxy)
    print(f"resident warps per SM (change): {warps}", flush=True)

    sess = cs.engine_session("Sponza")
    box_sess = cs.engine_session("BoxTest")
    classes = cs.engine_classes(sess)
    n = sess.width * sess.height
    baker = Baker(RenderSession(AppSettings(current_scene=Scenes.Sponza), 8,
                                8, device=cs.DEVICE),
                  resolution=cs.BAKE_RES, atlas_mode="pair")
    bake_classes, slab_row = cs.bake_sun_classes(baker)

    # the work, the bound and the plain results of each class
    jobs = {}
    for name, first_hit in (("d1_closest", False), ("d1_sun", True)):
        o, d, tmin, tmax, act = classes[name]
        inv = traverse.safe_inv(d).contiguous()
        stats = {}
        ref = packet.packet_traverse_plain(sess.bvh, o, d, inv, tmin, tmax,
                                           act, first_hit, stats)
        nbytes = (n * (cs.RAY_IN_BYTES + cs.HIT_BYTES)
                  + int(stats["touched"].sum()) * cs.ROW_BYTES)
        ops = (stats["slot_tests"] * cs.SLAB_OPS
               + stats["tri_tests"] * cs.MT_OPS)
        jobs[name] = dict(
            run=lambda o=o, d=d, inv=inv, tmin=tmin, tmax=tmax, act=act,
            fh=first_hit: packet._launch_kernel(sess.bvh, o, d, inv, tmin,
                                                tmax, act, fh),
            walk=lambda o=o, d=d, inv=inv, tmin=tmin, tmax=tmax, act=act,
            fh=first_hit: traverse._launch_kernel(sess.bvh, o, d, inv, tmin,
                                                  tmax, act, fh),
            ref=ref, differ=_hits_differ, bound=cs.bound_ms(nbytes, ops),
            work={"active": int(act.sum()), "slot_tests": stats["slot_tests"],
                  "triangle_tests": stats["tri_tests"],
                  "internal_visits": stats["internal"],
                  "leaf_visits": stats["leaf"]})
    for name, cls in (("proxy_terminal", "d2_terminal"),
                      ("proxy_d2_sun", "d2_sun")):
        rays = proxy._rays(*classes[cls])
        o, d, tmin, tmax, act = rays
        inv = traverse.safe_inv(d).contiguous()
        stats = {}
        ref = proxy.proxy_blocked_plain(sess.proxy, *rays, stats=stats)
        nbytes = n * cs.SCREEN_RAY_BYTES + sess.proxy.tris.numel() * 4
        jobs[name] = dict(
            run=lambda rays=rays: proxy._launch("proxy_blocked",
                                                sess.proxy.tris, rays),
            walk=lambda o=o, d=d, inv=inv, tmin=tmin, tmax=tmax, act=act:
            traverse._launch_kernel(sess.bvh_ray, o, d, inv, tmin, tmax, act,
                                    True),
            ref=ref, differ=lambda a, b: int((a != b).sum()),
            bound=cs.bound_ms(nbytes, stats["tests"] * cs.PROXY_OPS),
            work={"active": int(act.sum()), "blocked": int(ref.sum()),
                  "triangle_tests": stats["tests"]})

    # the grid on the frame's depth-2 sun class and the bake slab's two
    for name, (owner, rays) in {
            "grid_d2_sun": (sess, classes["d2_sun"]),
            "grid_bake_d1_sun": (baker.session, bake_classes["bake_d1_sun"]),
            "grid_bake_d2_sun": (baker.session,
                                 bake_classes["bake_d2_sun"])}.items():
        grid = owner.update_sun_grid()
        o, d, tmin, tmax, act = rays
        inv = traverse.safe_inv(d).contiguous()
        stats = {}
        ref = sunspace.sun_any_hit_plain(grid, *rays, stats=stats)
        walks = {f"W{w}": lambda bvh=bvh, o=o, d=d, inv=inv, tmin=tmin,
                 tmax=tmax, act=act: traverse._launch_kernel(
                     bvh, o, d, inv, tmin, tmax, act, True)
                 for w, bvh in ((32, owner.bvh_ray), (8, owner.bvh))}
        jobs[name] = dict(
            run=lambda grid=grid, rays=rays: sunspace._launch_kernel(grid,
                                                                    *rays),
            walk=walks["W32"], walk_w8=walks["W8"], ref=ref,
            differ=lambda a, b: int((a != b).sum()),
            bound=cs.bound_ms(*cs.grid_work(stats, act)),
            work={"active": int(act.sum()), "blocked": int((ref == 0).sum()),
                  "record_visits": stats["visits"],
                  "triangle_tests": stats["tri_tests"],
                  **({"slab_row": slab_row} if "bake" in name else {}),
                  **cs.walk_shape(stats, act, cs.grid_warps())})

    # every build against the plain versions, bit for bit
    mism = {}
    for build in names:
        _use(libs, build)
        for name, job in jobs.items():
            mism[f"{build} {name}"] = job["differ"](job["run"](), job["ref"])
    print(f"lanes that differ from the plain versions: {mism} [{smi}]",
          flush=True)
    _use(libs, "change")
    edges = cs.engine_edge_cases(sess, box_sess)

    times = {f"{b} {c}": [] for b in names for c in jobs}
    walk = {c: [] for c in jobs}
    walk_w8 = {c: [] for c in jobs if "walk_w8" in jobs[c]}
    for build in turns:
        _use(libs, build)
        for name, job in jobs.items():
            job["run"]()
            ms, _ = cs.cuda_ms(job["run"], repeat=REPEAT)
            times[f"{build} {name}"].append(ms)
            for key, spent in (("walk", walk), ("walk_w8", walk_w8)):
                if key in job:
                    job[key]()
                    ms, _ = cs.cuda_ms(job[key], repeat=REPEAT)
                    spent[name].append(ms)
    _use(libs, "change")

    rows = {}
    for name, job in jobs.items():
        b_ms, b_by = job["bound"]
        for build in names:
            ts = times[f"{build} {name}"]
            ms = statistics.mean(ts)
            w8 = (statistics.mean(walk_w8[name]) if name in walk_w8
                  else None)
            rows[f"{build} {name}"] = {
                "ms": ms, "ms_turns": ts, "bound_ms": b_ms, "bound_by": b_by,
                "bound_share": b_ms / ms,
                "per_ray_walk_ms": statistics.mean(walk[name]),
                **({"per_ray_w8_walk_ms": w8} if w8 is not None else {}),
                "mismatches_vs_plain": mism[f"{build} {name}"],
                **job["work"]}
            print(f"{name} {build}: {ms:.4f} ms (turns "
                  + ", ".join(f"{t:.4f}" for t in ts)
                  + f"), bound {b_ms:.4f} ms ({b_by}; {b_ms / ms:.1%}), "
                  f"per-ray walk {statistics.mean(walk[name]):.4f} ms"
                  + (f" (W32), {w8:.4f} ms (W8)" if w8 is not None else "")
                  + f", differ {mism[f'{build} {name}']}; {job['work']} "
                  f"[{smi}]", flush=True)
    out_dir = REPO_ROOT / "chiprun_out"
    os.makedirs(out_dir, exist_ok=True)
    with open(out_dir / "engine_ab.json", "w") as f:
        json.dump({"card": smi, "turns": turns, "repeat": REPEAT,
                   "alt": ALT, "packet_variants": variants, "ptxas": builds,
                   "resident_warps": warps,
                   "rows": rows, "per_ray_walk_ms_turns": walk,
                   "per_ray_w8_walk_ms_turns": walk_w8,
                   "edge_cases": edges}, f, indent=1)
    if any(mism.values()):
        raise SystemExit(f"engine_ab: builds differ from the plain "
                         f"versions: {mism}")


if __name__ == "__main__":
    main()
