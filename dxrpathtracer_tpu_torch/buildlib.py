"""Build native sources of the repository into shared libraries, at first use.

Each library lands in `dxrpathtracer_tpu_torch/build/` (listed in .gitignore)
under a name keyed by a hash of its source and its compile command, so an edit
to either builds anew and a fresh checkout builds from the sources alone. A
failed build raises with the compiler's output; nothing falls back.
"""

import hashlib
import os
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "build"
REPO_ROOT = Path(__file__).resolve().parent.parent


def build_shared_library(src: Path, stem: str, command: list[str],
                         timeout: float = 600.0) -> tuple[Path, str]:
    """Compile `src` with `command + ["-o", out, src]` unless the keyed
    library exists. Returns (library path, compiler stderr; "" when cached)."""
    key = hashlib.sha256(src.read_bytes() + "\0".join(command).encode())
    out = BUILD_DIR / f"lib{stem}_{key.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([*command, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {src} failed ({' '.join(command)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build finds a whole library
    return out, proc.stderr
