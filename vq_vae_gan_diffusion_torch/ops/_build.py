"""Build and load the port's native libraries.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``; each host
source ``csrc/<name>.cpp`` (the sample store of ``data/native_loader.py``)
compiles with the host compiler (``$CXX``, else ``c++``) by
:func:`host_library`. Libraries go to ``vq_vae_gan_diffusion_torch/_build/``
(ignored by git), named by a hash of the source and the flags, so an edited
source rebuilds; each is written under a temporary name and moved into place,
so processes that build at once do not read a half-written file. Nothing here
runs at import time: a library is built at its first use, or by
:func:`build_all` (the ``.cu`` sources).
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
# the JAX package's native/Makefile flags
HOST_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread", "-shared"]


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


def library_path(name: str, suffix: str = ".cu", flags: List[str] = NVCC_FLAGS) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}{suffix}").read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(compiler: List[str], src: Path, out: Path
           ) -> Tuple[subprocess.Popen, Path, Path, Path] | None:
    """Start ``compiler`` on ``src`` unless ``out`` exists; the library goes
    to a temporary name and is moved into place by :func:`_finish`."""
    if out.exists():
        return None
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.Popen([*compiler, "-o", str(tmp), str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"{compiler[0]} failed for csrc/{src.name}: {e}") from e
    return proc, tmp, out, src


def _finish(started: Tuple[subprocess.Popen, Path, Path, Path] | None) -> str:
    """Wait for one build, move the library into place and return the
    compiler's log (empty when the library was already built); a failed
    build raises with the log."""
    if started is None:
        return ""
    proc, tmp, out, src = started
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{os.path.basename(proc.args[0])} failed for csrc/{src.name}:\n{log}")
    os.replace(tmp, out)
    return log


def _start_cuda(name: str) -> Tuple[subprocess.Popen, Path, Path, Path] | None:
    out = library_path(name)
    if out.exists():                    # no nvcc needed for a library already built
        return None
    return _start([nvcc_path(), *NVCC_FLAGS], CSRC_DIR / f"{name}.cu", out)


def build_all() -> Dict[str, str]:
    """Build every ``csrc/*.cu`` at once, one nvcc process per source, and
    return each compiler log (ptxas register and shared-memory usage)."""
    started = {name: _start_cuda(name) for name in sources()}
    return {name: _finish(s) for name, s in started.items()}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    _finish(_start_cuda(name))
    return ctypes.CDLL(str(library_path(name)))


def host_compiler() -> str:
    return os.environ.get("CXX") or "c++"


@functools.lru_cache(maxsize=None)
def host_library(name: str) -> ctypes.CDLL:
    """The loaded library for the host source ``csrc/<name>.cpp``, built
    first with :func:`host_compiler` and ``HOST_FLAGS`` if needed; a failed
    build raises with the compiler's log."""
    flags = [host_compiler(), *HOST_FLAGS]
    # -march=native code runs only on the machine that built it: its name
    # keys the library too, so a tree copied to another machine rebuilds
    out = library_path(name, ".cpp", flags + [os.uname().nodename, os.uname().machine])
    _finish(_start(flags, CSRC_DIR / f"{name}.cpp", out))
    return ctypes.CDLL(str(out))
