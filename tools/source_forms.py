"""Forms of a kernel source, each made by exact substitutions, built and loaded side by side.

The form tools (``tools/cast_forms.py``, ``tools/flash_attention_forms.py``)
import it: ``build_forms(source, out, forms, signatures)`` writes each form of
``source`` into ``out``, runs one ``nvcc`` a form, all at once, with the
port's flags, and loads each library with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

from repro_torch.kernels import build


def build_forms(source: Path, out: Path, forms: dict, signatures: dict) -> dict:
    """``{form: library}``. ``forms`` maps a form's name to its
    substitutions ``[(text in the source, its replacement), ...]``, each of
    which must match exactly once; ``signatures`` maps each C entry point
    to its argument types, the stream's pointer left out."""
    text = source.read_text()
    out.mkdir(parents=True, exist_ok=True)
    for header in source.parent.glob("*.cuh"):   # what the source includes
        shutil.copy(header, out)
    procs = {}
    for name, subs in forms.items():
        form = text
        for old, new in subs:
            if form.count(old) != 1:
                raise AssertionError(f"{name}: {old!r} is not in the source once")
            form = form.replace(old, new)
        src = out / f"{name}.cu"
        src.write_text(form)
        procs[name] = subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(src.with_suffix(".so")), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on form {name}:\n{log}")
        lib = ctypes.CDLL(str((out / name).with_suffix(".so")))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes + [ctypes.c_void_p]
        libs[name] = lib
    return libs
