"""Build the hand-written CUDA kernels at first use and load them.

Each ``kernels/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, under
``build/`` at the root of the checkout, and loaded with ``ctypes``. The
library's file name carries a hash of its source and flags, so an edited
source rebuilds and an unchanged one is reused; ptxas's register and
shared-memory report is kept beside it (:func:`build_log`). Nothing is
built or loaded at import time: the CPU tests import every module, and
the CPU has no ``nvcc``.

``--use_fast_math`` is deliberately absent: it makes f32 division
approximate, and the kernels' FiLM interpolation relies on an IEEE
division to stay bit-exact with ``ops.upsample.linear_upsample``.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_log(name: str) -> str:
    """nvcc's output (the ptxas report) from building ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, compiled first if it is
    not built yet; raises with the compiler's output if nvcc fails."""
    if name not in _LIBS:
        target = library_path(name)
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
            target.with_suffix(".log").write_text(proc.stdout)
            os.replace(tmp, target)
        _LIBS[name] = ctypes.CDLL(str(target))
    return _LIBS[name]
