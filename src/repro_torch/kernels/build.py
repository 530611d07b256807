"""Build of the port's CUDA kernels, at first use, into ``build/kernels/``.

Each ``csrc/*.cu`` file is one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` (H100) and loaded with ``ctypes``. A
library's file name carries a hash of its source, of the ``csrc/*.cuh``
headers and of the flags, so an edited source or header is rebuilt and an
unchanged one is loaded as it is. There is no fallback: a missing ``nvcc``
or a failed compile raises. Beside the build, what every wrapper shares:
its library's loading, launches and launch counts (:class:`Library`) and
its choice between the kernel and the plain version (:func:`route`); and
what the wrappers of the chunked scans share: their inputs on 16 bytes
(:func:`on_16_bytes`) and their scratch in one allocation a call
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
from typing import Dict, List, Sequence, Tuple

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
    source, the headers beside it and the flags."""
    digest = hashlib.sha256()
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
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


def route(what: str, *tensors: torch.Tensor) -> bool:
    """True for the CUDA kernels, False for the plain versions on the CPU;
    raises on tensors on several devices and on any other device (``what``
    names the kernel in the message)."""
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"tensors on several devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if device.type == "cpu":
        return False
    if device.type == "cuda":
        return True
    raise ValueError(f"no {what} kernel for device {device}")


class Library:
    """The kernels of ``csrc/<name>.cu``, each entry point ``prefix +
    kernel`` taking its ``signatures[kernel]`` and then the stream. Nothing
    is built or loaded before the first launch or query. :attr:`launches`
    counts each kernel's launches since the last :meth:`reset`."""

    def __init__(self, name: str, signatures: Dict[str, Sequence], *,
                 prefix: str = ""):
        self.name, self.prefix, self.signatures = name, prefix, signatures
        self.launches: Dict[str, int] = dict.fromkeys(signatures, 0)
        self._fns = self._config = None

    def reset(self) -> None:
        for kernel in self.launches:
            self.launches[kernel] = 0

    def _load(self) -> Dict:
        """Load the library and set each entry point's types, once."""
        lib = load(self.name)
        fns = {}
        for kernel, argtypes in self.signatures.items():
            fn = getattr(lib, self.prefix + kernel)
            fn.argtypes = [*argtypes, ctypes.c_void_p]   # then the stream
            fn.restype = ctypes.c_int
            fns[kernel] = fn
        self._config = getattr(lib, f"{self.name}_launch_config")
        self._config.restype = ctypes.c_int
        self._fns = fns
        return fns

    def launch(self, kernel: str, device: torch.device, *args) -> None:
        """Launch ``kernel`` on ``device``'s current stream; raise on error."""
        fn = (self._fns or self._load())[kernel]
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                               f"cudaError {err}")
        self.launches[kernel] += 1

    def launch_config(self, *args: int) -> List[int]:
        """The seven ints of ``<name>_launch_config(*args, out)`` (int
        arguments); raises on a cudaError."""
        if self._config is None:
            self._load()
        out = (ctypes.c_int * 7)()
        err = self._config(
            *map(ctypes.c_int, args), ctypes.c_void_p(ctypes.addressof(out)))
        if err != 0:
            raise RuntimeError(f"{self.name}_launch_config{args} failed: "
                               f"cudaError {err}")
        return list(out)
