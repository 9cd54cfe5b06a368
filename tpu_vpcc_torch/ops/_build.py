"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under the checkout's ``build/kernels/`` (listed in ``.gitignore``) and
loaded with ctypes; the library is rebuilt when its source is newer.
Nothing here falls back: a missing ``nvcc``, a failed compile or a
failed load raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}
#: ``nvcc`` output (the ``-Xptxas -v`` register and shared-memory lines)
#: of each kernel library built by this process, by name
build_logs: dict = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing, or it refused a kernel source."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        Path(home) / "bin" / "nvcc" if home else None,
        Path("/usr/local/cuda/bin/nvcc"),
    ):
        if cand is not None and cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME)")
    return found


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library path."""
    src = CSRC_DIR / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}.so"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed on {src.name} (rc {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    build_logs[name] = proc.stdout + proc.stderr
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built at first use and cached."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
