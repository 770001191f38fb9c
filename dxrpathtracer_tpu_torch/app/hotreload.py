"""Shader hot reload — the port of dxrpathtracer_tpu/app/hotreload.py, the
analog of the reference's file-watch shader pipeline
(ShaderCompilation.cpp:416 UpdateShaders polls source mtimes; App.cpp:231-237
re-creates PSOs when a compiled shader changed).

Here the "shaders" are the modules of the render path under core/, render/,
accel/, sky/ and bake/, and the CUDA sources in csrc/ that they build: a
module that loads a kernel names its source in `KERNEL_SOURCE`
(accel/traverse.py, accel/gather.py), and an edit of that source counts as an
edit of the module. Those reload in place; the orchestration layers (scene/,
app/, tools/) are the reference's C++ side — editing them needs a restart,
exactly like the reference (its hot reload covers HLSL only, not the engine).

Mechanics: ``ShaderWatcher.poll()`` stats the watched files (the reference's
mtime poll); on a change the changed modules plus every package module that
(transitively) imports them reload dependency-first, so ``from x import f``
bindings in dependents re-resolve to the new code. Reloading a kernel's
module drops its loaded library (`_kernel`) and its launch count
(`KERNEL_LAUNCHES`), so a counter must be read through the module after a
reload; the next launch builds the edited source into a new library, named by
the hash of its source (buildlib.build_shared_library). The old library stays
loaded, unused. The session then takes the reloaded per-sample render
(``RenderSession.rebuild_step`` — the PSO re-create) and resets the
progressive accumulation.

A reload re-creates the reloaded modules' classes (FrameConstants,
HitRecord, ...): objects made before it keep their old classes.
"""

from __future__ import annotations

import importlib
import os
import sys
import types

ROOT = "dxrpathtracer_tpu_torch"
# The render path — our HLSL. Everything else is "C++": restart.
WATCHED_SUBPACKAGES = ("core", "render", "accel", "sky", "bake")


def _watched_modules(root: str, subpackages) -> dict[str, tuple[str, ...]]:
    """Loaded module name -> its watched files (its source, and the CUDA
    source it builds) for the watched subtree of `root`."""
    prefixes = tuple(f"{root}.{sp}" for sp in subpackages)
    out = {}
    for name, mod in list(sys.modules.items()):
        if not isinstance(mod, types.ModuleType):
            continue
        if not (name in prefixes
                or name.startswith(tuple(p + "." for p in prefixes))):
            continue
        files = [getattr(mod, "__file__", None),
                 getattr(mod, "KERNEL_SOURCE", None)]
        files = tuple(str(f) for f in files if f and os.path.exists(f))
        if files:
            out[name] = files
    return out


def _package_modules(root: str) -> dict[str, types.ModuleType]:
    return {name: mod for name, mod in list(sys.modules.items())
            if isinstance(mod, types.ModuleType)
            and (name == root or name.startswith(root + "."))}


def _import_graph(root: str) -> dict[str, set]:
    """name -> set of package modules it uses. Edges come from each module's
    globals: a referenced package module, or any function/class whose
    __module__ lives in the package (covers `from x import f`)."""
    mods = _package_modules(root)
    deps: dict[str, set] = {}
    for name, mod in mods.items():
        d = set()
        for val in vars(mod).values():
            if isinstance(val, types.ModuleType):
                vn = getattr(val, "__name__", "")
            else:
                vn = getattr(val, "__module__", None)
            if isinstance(vn, str) and vn in mods and vn != name:
                d.add(vn)
        deps[name] = d
    return deps


def reload_order(changed, root: str = ROOT) -> list:
    """Changed modules + transitive dependents, dependencies first."""
    deps = _import_graph(root)
    changed = [c for c in changed if c in deps]
    # transitive dependents of the changed set
    affected = set(changed)
    grew = True
    while grew:
        grew = False
        for name, d in deps.items():
            if name not in affected and d & affected:
                affected.add(name)
                grew = True
    # topological order over the affected subgraph (deps before dependents);
    # cycles (rare: package __init__ re-exports) break by insertion order
    order, seen = [], set()

    def visit(n, stack):
        if n in seen or n in stack:
            return
        stack.add(n)
        for d in sorted(deps.get(n, ())):
            if d in affected:
                visit(d, stack)
        stack.discard(n)
        seen.add(n)
        order.append(n)

    for n in sorted(affected):
        visit(n, set())
    return order


class ShaderWatcher:
    """Polls watched sources for changes and reloads them in place.

    The reference analog: ShaderCompilation.cpp keeps per-shader file
    timestamps and UpdateShaders() re-compiles the ones whose source (or
    include) changed; the app then re-creates the PSOs that used them.
    """

    def __init__(self, root: str = ROOT, subpackages=WATCHED_SUBPACKAGES):
        self.root = root
        self.subpackages = tuple(subpackages)
        self._mtimes: dict[tuple[str, str], float] = {}
        self._snapshot()

    def _snapshot(self):
        for name, files in _watched_modules(self.root,
                                            self.subpackages).items():
            for f in files:
                try:
                    self._mtimes[(name, f)] = os.stat(f).st_mtime
                except OSError:
                    pass

    def poll(self) -> list:
        """Names of watched modules whose source, or kernel source, changed
        since the last poll. Newly imported modules are adopted (not
        reported) — matching the reference, which only reloads shaders it
        has already compiled."""
        changed = []
        for name, files in _watched_modules(self.root,
                                            self.subpackages).items():
            for f in files:
                try:
                    m = os.stat(f).st_mtime
                except OSError:
                    continue
                prev = self._mtimes.get((name, f))
                self._mtimes[(name, f)] = m
                if prev is not None and m != prev and name not in changed:
                    changed.append(name)
        return changed

    def reload(self, changed) -> list:
        """Reload `changed` + transitive dependents, dependencies first.
        Returns the list actually reloaded."""
        order = reload_order(changed, self.root)
        for name in order:
            importlib.reload(sys.modules[name])
        self._snapshot()
        return order

    def poll_and_reload(self) -> list:
        changed = self.poll()
        return self.reload(changed) if changed else []
