"""Crash-dump capture — the Nsight Aftermath analog (SURVEY.md §5.3).

The port of dxrpathtracer_tpu/app/crashdump.py. The reference registers
Aftermath callbacks that write `DXRPathTracer_Crash.nv-gpudmp` plus shader
debug logs when the GPU device is lost (DXRPathTracer.cpp:60-80). Here the
failure modes are a CUDA fault (an illegal address in a kernel, reported at
the next synchronising call), a failed kernel build, device or host memory
running out, or a plain exception; the need is the same: when a dispatch
dies, persist what is needed to reproduce it before the process exits.

`crash_guard(session)` wraps a render/bake loop; on an unhandled exception it
writes `dxrpathtracer_crash.json` (the path in $DXRPT_CRASH_DUMP, if set):
exception and traceback, the torch and CUDA versions and the cards, the numpy
version, the full settings, frame shapes, sample index, BVH/scene table
shapes, the DXRPT_/CUDA_/TORCH_/PYTORCH_ environment, argv. Then it
re-raises. A CUDA fault is sticky: after one, every CUDA call of the process
may raise again. So each part of the device inventory and of the session
capture is taken on its own, a part that raises is recorded as its error,
and the dump is always written and the original exception re-raised.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
import traceback

DEFAULT_PATH = "dxrpathtracer_crash.json"
ENV_PREFIXES = ("DXRPT_", "CUDA_", "TORCH_", "PYTORCH_")

# Weak reference to the most recently constructed RenderSession (registered
# by RenderSession.__init__) so a guard installed at the CLI dispatch level
# can still capture frame/scene state without threading the object through.
_last_session = None


def register_session(session) -> None:
    import weakref
    global _last_session
    _last_session = weakref.ref(session)


def current_session():
    return _last_session() if _last_session is not None else None


def _part(out: dict, key: str, fn, errors: dict) -> None:
    """out[key] = fn(), or errors[key] = the exception's repr."""
    try:
        out[key] = fn()
    except Exception as e:  # a sticky CUDA fault, a half-built session
        errors[key] = repr(e)


def _cards():
    import torch
    cards = []
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        cards.append({"index": i, "name": p.name,
                      "capability": f"{p.major}.{p.minor}",
                      "total_memory": p.total_memory})
    return cards


def _device_inventory() -> dict:
    """torch, CUDA, the cards and the current device; each part on its own
    (device enumeration can itself be what died)."""
    import torch
    inv, errors = {}, {}
    _part(inv, "torch_version", lambda: torch.__version__, errors)
    _part(inv, "cuda_version", lambda: torch.version.cuda, errors)
    _part(inv, "cuda_available", torch.cuda.is_available, errors)
    _part(inv, "devices", _cards, errors)
    _part(inv, "current_device",
          lambda: (torch.cuda.current_device()
                   if torch.cuda.is_available() else "cpu"), errors)
    if errors:
        inv["errors"] = errors
    return inv


def _settings(session) -> dict:
    s = session.settings
    return {f: repr(getattr(s, f)) for f in s.__dataclass_fields__}


def _frame(session) -> dict:
    return {"width": session.width, "height": session.height,
            "sample_idx": session.sample_idx,
            "scene": getattr(session.preset, "name", "?"),
            # one pass over the whole frame: no row slabs
            "slab_rows": session.height}


def _scene_tables(session) -> dict:
    return {"num_triangles": int(session.scene_host.num_triangles),
            "bvh_rows": int(session.bvh.num_rows),
            "bvh_width": int(session.bvh.width)}


def build_crash_report(exc: BaseException, session=None) -> dict:
    import numpy as np

    report = {
        "kind": "dxrpathtracer_tpu_torch crash dump (Aftermath analog)",
        "time_unix": time.time(),
        "exception": repr(exc),
        "traceback": traceback.format_exception(type(exc), exc,
                                                exc.__traceback__),
        "platform": _device_inventory(),
        "numpy_version": np.__version__,
        "env": {k: v for k, v in os.environ.items()
                if k.startswith(ENV_PREFIXES)},
        "argv": sys.argv,
    }
    if session is not None:
        errors = {}
        for key, fn in (("settings", _settings), ("frame", _frame),
                        ("scene_tables", _scene_tables)):
            _part(report, key, lambda fn=fn: fn(session), errors)
        if errors:
            report["session_capture_error"] = errors
    return report


def write_crash_dump(exc: BaseException, session=None, path=None) -> str:
    path = path or os.environ.get("DXRPT_CRASH_DUMP", DEFAULT_PATH)
    report = build_crash_report(exc, session)
    with open(path, "w") as f:
        json.dump(report, f, indent=1, default=repr)
    print(f"# crash dump written to {path}", file=sys.stderr)
    return path


@contextlib.contextmanager
def crash_guard(session=None, path=None):
    """Wrap a render/bake loop; on an unhandled exception persist the dump
    and re-raise (the reference shows a message box and exits — App.cpp:78-82).
    KeyboardInterrupt passes through undumped (user intent, not a crash)."""
    try:
        yield
    except KeyboardInterrupt:
        raise
    except BaseException as exc:
        with contextlib.suppress(Exception):  # never mask the real error
            write_crash_dump(exc, session or current_session(), path)
        raise
