"""Scene binary cache — the Model::CreateFromMeshData / Serialization.h analog.

The port of dxrpathtracer_tpu/scene/cache.py. The reference can serialize an
imported model to a binary cache and reload it without re-running Assimp
(SampleFramework12 Serialization.h; Model::CreateFromMeshData,
Model.cpp:724). Here the imported model is the port's `Scene`, a tree of
dataclasses whose leaves are torch tensors and plain values, so the cache is
one compressed .npz: every tensor as its numpy bytes under a dotted field
path, plus a JSON header that names each dataclass node.

Entries are keyed by a content hash of the source FBX bytes, the preset
fields, the alpha subdivision's switches (DXRPT_ALPHA_SPLIT and
DXRPT_ALPHA_SPLIT_LEVEL), this package's tag and its LOADER_VERSION: a change to the importer
or to the asset invalidates the entry, and the JAX package's entries, which
may share the DXRPT_SCENE_CACHE directory, never match. A header may name
only the classes of `_CLASSES` (the port's own scene types); an entry that
names any other class is unreadable and the scene is parsed again, so a
cache entry never imports a module. Loading is best-effort: any mismatch or
corruption falls back to the parser with a warning.
"""

import dataclasses
import hashlib
import io
import json
import logging
import os
import tempfile

import numpy as np
import torch

from .types import Scene, SpotLights

log = logging.getLogger(__name__)

# Bump when the importer's output changes (fields, packing, parity fixes):
# stale entries must not survive a loader change.
LOADER_VERSION = 2
PACKAGE_TAG = "dxrpathtracer_tpu_torch"

# The classes an entry may rebuild, by the name its header gives them.
_CLASSES = {f"{cls.__module__}:{cls.__qualname__}": cls
            for cls in (Scene, SpotLights)}


def flatten_pytree(obj, prefix=""):
    """(arrays {path: np.ndarray}, spec) of a tree of dataclasses whose
    leaves are tensors (stored as numpy arrays of their bytes) and plain
    values."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        arrays, fields = {}, {}
        for f in dataclasses.fields(obj):
            path = f"{prefix}.{f.name}" if prefix else f.name
            a, fields[f.name] = flatten_pytree(getattr(obj, f.name), path)
            arrays.update(a)
        cls = type(obj)
        return arrays, {"kind": "dataclass",
                        "class": f"{cls.__module__}:{cls.__qualname__}",
                        "fields": fields}
    if isinstance(obj, torch.Tensor):
        path = prefix or "_root"
        return {path: obj.detach().cpu().numpy()}, {"kind": "tensor",
                                                    "path": path}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {}, {"kind": "value", "value": obj}
    raise TypeError(f"unsupported leaf type {type(obj)!r} at {prefix!r}")


def unflatten_pytree(arrays, spec):
    """The tree `flatten_pytree` described: tensors come back as CPU
    tensors. Raises ValueError for a class outside _CLASSES."""
    kind = spec["kind"]
    if kind == "dataclass":
        cls = _CLASSES.get(spec["class"])
        if cls is None:
            raise ValueError(f"cache entry names class {spec['class']!r}, "
                             "which is not one of the port's scene types")
        return cls(**{name: unflatten_pytree(arrays, s)
                      for name, s in spec["fields"].items()})
    if kind == "tensor":
        return torch.from_numpy(np.array(arrays[spec["path"]]))
    if kind == "value":
        return spec["value"]
    raise ValueError(f"bad spec kind {kind!r}")


def save_pytree(path: str, obj) -> None:
    """Atomic write of a tree of dataclasses to one compressed .npz."""
    arrays, spec = flatten_pytree(obj)
    payload = dict(arrays)
    payload["__spec__"] = np.frombuffer(json.dumps(spec).encode(),
                                        dtype=np.uint8)
    buf = io.BytesIO()
    np.savez_compressed(buf, **payload)
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(buf.getvalue())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_pytree(path: str):
    with np.load(path, allow_pickle=False) as z:
        spec = json.loads(bytes(z["__spec__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__spec__"}
    return unflatten_pytree(arrays, spec)


def default_cache_dir() -> str:
    """DXRPT_SCENE_CACHE, else ~/.cache/dxrpt_scene_cache; '' disables."""
    d = os.environ.get("DXRPT_SCENE_CACHE")
    if d is not None:
        return d
    return os.path.expanduser("~/.cache/dxrpt_scene_cache")


def scene_cache_key(fbx_path: str, preset) -> str:
    h = hashlib.sha256()
    h.update(f"{PACKAGE_TAG}:loader-v{LOADER_VERSION}".encode())
    # the load-time alpha subdivision (scene/alphasplit.py) changes the
    # built geometry, so its switches are part of the key
    h.update(("alphasplit:" + os.environ.get("DXRPT_ALPHA_SPLIT", "") + ":"
              + os.environ.get("DXRPT_ALPHA_SPLIT_LEVEL", "4")).encode())
    h.update(repr(dataclasses.astuple(preset)).encode())
    with open(fbx_path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()[:32]


def cache_path(fbx_path: str, preset) -> str | None:
    """The entry's file, or None when the cache is disabled."""
    d = default_cache_dir()
    return os.path.join(d, scene_cache_key(fbx_path, preset) + ".npz") \
        if d else None


def load_cached_scene(fbx_path: str, preset):
    """The cached Scene, or None (miss, disabled or unreadable)."""
    path = cache_path(fbx_path, preset)
    if path is None or not os.path.exists(path):
        return None
    try:
        scene = load_pytree(path)
        if not isinstance(scene, Scene):
            raise ValueError(f"the entry holds a {type(scene).__name__}")
    except Exception as e:  # any corrupt or foreign entry: parse again
        log.warning("scene cache entry unreadable (%s) — reparsing: %s",
                    path, e)
        return None
    log.info("scene cache hit: %s", path)
    return scene


def store_cached_scene(fbx_path: str, preset, scene) -> None:
    path = cache_path(fbx_path, preset)
    if path is None:
        return
    try:
        save_pytree(path, scene)
    except OSError as e:  # best-effort, like the reference's shader cache
        log.warning("scene cache write failed: %s", e)
        return
    log.info("scene cache write: %s", path)
