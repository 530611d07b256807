"""Build of the port's CUDA kernels, at first use, into ``build/kernels/``.

Each ``csrc/*.cu`` file is one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` (H100) and loaded with ``ctypes``. A
library's file name carries a hash of its source and of the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. There is
no fallback: a missing ``nvcc`` or a failed compile raises. Beside the
build, what the wrappers of the chunked scans share: their inputs on 16
bytes (:func:`on_16_bytes`) and their scratch in one allocation a call
(:func:`scratch`).
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

import torch

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


def _compile(names) -> Dict[str, Path]:
    """Build the libraries of ``csrc/<name>.cu`` for ``names`` that are not
    built yet: one ``nvcc`` per source, all started at once. Raises naming
    every source that failed."""
    outs = {n: library_path(n) for n in names}
    todo = [n for n in names if not outs[n].exists()]
    if not todo:
        return outs
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for n in todo:
        tmp = outs[n].with_name(f"{outs[n].name}.{os.getpid()}.tmp")
        jobs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for n, (tmp, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {n}.cu (exit {proc.returncode}):\n{err}")
        else:
            os.replace(tmp, outs[n])  # publish whole: a concurrent loader never sees half
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    return _compile([name])[name]


def build_all() -> Dict[str, Path]:
    """Build every ``csrc/*.cu``, the compiles running side by side."""
    return _compile(sorted(p.stem for p in CSRC.glob("*.cu")))


def on_16_bytes(*tensors: torch.Tensor) -> List[torch.Tensor]:
    """The tensors made contiguous, each starting on 16 bytes (a copy where
    it does not): the kernels read rows 16 or 8 bytes at a time."""
    ins = [t.contiguous() for t in tensors]
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in ins]


def scratch(device, *sizes: int) -> Tuple[torch.Tensor, List[int]]:
    """One f32 buffer of ``sizes`` elements, part after part, and each
    part's address: one allocation a call. A part starts on 16 bytes where
    the parts before it have a multiple of 4 elements."""
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    ptrs = [buf.data_ptr() + 4 * sum(sizes[:i]) for i in range(len(sizes))]
    return buf, ptrs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if need be."""
    return ctypes.CDLL(str(build(name)))
