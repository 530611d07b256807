"""Build of the port's CUDA kernels, at first use, into ``build/kernels/``.

Each ``csrc/*.cu`` file is one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` (H100) and loaded with ``ctypes``. A
library's file name carries a hash of its source and of the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. There is
no fallback: a missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# never --use_fast_math: the kernels' rounding must be IEEE's
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    """``nvcc`` on the PATH, else under ``$CUDA_HOME`` (``/usr/local/cuda``
    by default); raises when neither has one."""
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError(
            f"nvcc not found on PATH or at {nvcc}: the CUDA kernels cannot "
            "be built (set CUDA_HOME to the CUDA toolkit)")
    return nvcc


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built for its current
    source and flags."""
    digest = hashlib.sha256()
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # publish whole: a concurrent loader never sees half
    return out


def build_all() -> Dict[str, Path]:
    """Build every ``csrc/*.cu``."""
    return {n: build(n) for n in sorted(p.stem for p in CSRC.glob("*.cu"))}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if need be."""
    return ctypes.CDLL(str(build(name)))
