"""Build the hand-written CUDA kernels at first use and load them.

Each ``kernels/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, under
``build/`` at the root of the checkout, and loaded with ``ctypes``. The
library's file name carries a hash of its source, the shared headers and
the flags, so an edited source rebuilds and an unchanged one is reused;
ptxas's register and shared-memory report is kept beside it
(:func:`build_log`). Nothing is
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
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
# every kernel source of the port: csrc/<name>.cu
KERNELS = (
    "newt_fused_cr",
    "newt_fused_cr_bwd",
    "newt_fused_stream",
    "newt_fused_fl",
    "newt_fused_fl_bwd",
    "fast_newt_lookup",
    "newt_fused_x",
    "newt_fused_x_bwd",
)
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
    """The library's path, named by a hash of its source, every header in
    ``csrc/`` (``newt_shaper.cuh``, ``newt_shaper_bwd.cuh``,
    ``newt_lanes_bwd.cuh`` and ``newt_bank.cuh`` are shared) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_log(name: str) -> str:
    """nvcc's output (the ptxas report) from building ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".log").read_text()


def build(names: Sequence[str] = KERNELS) -> None:
    """Compile every ``csrc/<name>.cu`` that is not built yet (all of
    :data:`KERNELS` by default), one nvcc process per source, all started
    together; raises with the compiler's output if any fails."""
    jobs = []
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, target, tmp, proc))
    failed = []
    for name, target, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        target.with_suffix(".log").write_text(out)
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, compiled first if it is
    not built yet; raises with the compiler's output if nvcc fails."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]
