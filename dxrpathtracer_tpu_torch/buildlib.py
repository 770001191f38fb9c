"""Build native sources of the repository into shared libraries, at first use.

Each library lands in `dxrpathtracer_tpu_torch/build/` (listed in .gitignore)
under a name keyed by a hash of its source, of every header it includes with
`#include "..."` (found beside the including file or in a `-I` directory of
the command, recursively) and of its compile command, so an edit to any of
them builds anew and a fresh checkout builds from the sources alone; the
compiler's report (stderr) is kept beside it as `<library>.log`. A failed
build raises with the compiler's output; nothing falls back.
"""

import hashlib
import os
import re
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "build"
REPO_ROOT = Path(__file__).resolve().parent.parent


def nvcc() -> str:
    """The CUDA compiler: on PATH, else under $CUDA_HOME (/usr/local/cuda)."""
    import shutil
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or shutil.which("nvcc", path=f"{cuda_home}/bin")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build with the "
                           "CUDA toolkit")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_key(src: Path, command: list[str]) -> str:
    """The hex digest a build of `src` with `command` is keyed by: the
    source's bytes, each quoted include's path and bytes (once each, in
    the order met) and the command."""
    dirs = [Path(c[2:]) if len(c) > 2 else Path(n)
            for c, n in zip(command, [*command[1:], ""])
            if c.startswith("-I")]
    key = hashlib.sha256()
    seen, todo = set(), [Path(src)]
    while todo:
        path = todo.pop(0)
        text = path.read_bytes()
        key.update(str(len(text)).encode() + b"\0" + text)
        for name in _INCLUDE.findall(text):
            name = name.decode()
            found = next((d / name for d in (path.parent, *dirs)
                          if (d / name).is_file()), None)
            if found is None:
                raise FileNotFoundError(f"{path}: #include \"{name}\" not "
                                        f"found beside it or in {dirs}")
            found = found.resolve()
            if found not in seen:
                seen.add(found)
                key.update(name.encode() + b"\0")
                todo.append(found)
    key.update("\0".join(command).encode())
    return key.hexdigest()


def build_shared_library(src: Path, stem: str, command: list[str],
                         timeout: float = 600.0) -> tuple[Path, str]:
    """Compile `src` with `command + ["-o", out, src]` unless the keyed
    library exists. Returns (library path, the compiler's stderr from the
    build that made it)."""
    out = BUILD_DIR / f"lib{stem}_{source_key(src, command)[:16]}.so"
    log = out.with_name(f"{out.name}.log")
    if out.exists():
        return out, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([*command, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {src} failed ({' '.join(command)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    # the report first, then the library (atomically): a concurrent build
    # finds a whole library with its report beside it
    tmp_log = log.with_name(f"{log.name}.{os.getpid()}.tmp")
    tmp_log.write_text(proc.stderr)
    os.replace(tmp_log, log)
    os.replace(tmp, out)
    return out, proc.stderr
