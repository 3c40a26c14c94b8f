"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Libraries go
to ``vq_vae_gan_diffusion_torch/_build/`` (ignored by git), named by a hash of
the source and the flags, so an edited source rebuilds. Nothing here runs at
import time: a library is built at its first use, or by :func:`build_all`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA "
                       "kernels cannot be built on this machine")


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path] | None:
    """Start nvcc for one source unless its library exists; the output goes
    to a temporary name and is moved into place by :func:`_finish`."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), tmp


def _finish(name: str, started: Tuple[subprocess.Popen, Path] | None) -> str:
    """Wait for one build, move the library into place and return the
    compiler's log (empty when the library was already built)."""
    if started is None:
        return ""
    proc, tmp = started
    log, _ = proc.communicate()
    out = library_path(name)
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Build every ``csrc/*.cu`` at once, one nvcc process per source, and
    return each compiler log (ptxas register and shared-memory usage)."""
    started = {name: _start(name) for name in sources()}
    return {name: _finish(name, s) for name, s in started.items()}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    _finish(name, _start(name))
    return ctypes.CDLL(str(library_path(name)))
