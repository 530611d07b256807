"""The kernel library the port's five CUDA wrappers share
(``repro_torch.kernels.build``), on the CPU: importing the wrappers and
constructing their libraries builds and loads nothing; each wrapper's
``LAUNCHES`` is its library's counter, with the kernels' names as keys,
and ``reset_launches`` zeroes it; ``build.route`` sends CPU tensors to the
plain versions and raises on mixed devices and on a device with no route;
and ``Library.launch``/``launch_config`` against a stand-in for the loaded
library (the entry points' types set once, the stream passed last, the
error raised, the launch counted). The kernels themselves run on the card
(``chip_smoke.py``)."""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import (adamw, build, flash_attention, quant_ring,
                                 rwkv6_wkv, ssd_scan)

ROOT = Path(__file__).resolve().parents[1]

_RING = ["quantize_pack", "dequant_add_quantize", "dequant_accumulate", "dequant"]
KEYS = {
    "quant_ring": _RING + [f"{k}_fp8" for k in _RING]
    + ["cast_pack_bf16", "bf16_add_cast", "bf16_accumulate", "bf16_upcast"],
    "flash_attention": ["flash_attention_fwd", "flash_attention_bwd_preprocess",
                        "flash_attention_bwd_dkdv", "flash_attention_bwd_dq"],
    "rwkv6_wkv": ["wkv6_fwd", "wkv6_bwd"],
    "ssd_scan": ["ssd_fwd", "ssd_bwd"],
    "adamw": ["adamw_leaf"],
}
MODULES = {"quant_ring": quant_ring, "flash_attention": flash_attention,
           "rwkv6_wkv": rwkv6_wkv, "ssd_scan": ssd_scan, "adamw": adamw}
# the source each wrapper's library loads
SOURCES = {"quant_ring": "quant_ring", "flash_attention": "flash_attention",
           "rwkv6_wkv": "wkv6", "ssd_scan": "ssd_scan", "adamw": "adamw"}


def test_wrappers_import_without_building_or_loading():
    """In a fresh process, with ``build.build`` and ``build.load`` made to
    raise: the five wrappers import, a library is constructed, and none
    has loaded anything."""
    code = (
        "from repro_torch.kernels import build\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'built or loaded {a}')\n"
        "build.build = build.load = refuse\n"
        "from repro_torch.kernels import adamw, flash_attention, quant_ring, "
        "rwkv6_wkv, ssd_scan\n"
        "lib = build.Library('quant_ring', quant_ring._SIGNATURES, "
        "prefix='quant_ring_')\n"
        "mods = (adamw, flash_attention, quant_ring, rwkv6_wkv, ssd_scan)\n"
        "assert all(m.LIB._fns is None for m in mods) and lib._fns is None\n"
        "print('NOTHING LOADED')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOTHING LOADED" in proc.stdout


@pytest.mark.parametrize("wrapper", sorted(KEYS))
def test_launches_are_the_library_counter(wrapper):
    mod = MODULES[wrapper]
    assert mod.LAUNCHES is mod.LIB.launches
    assert list(mod.LAUNCHES) == KEYS[wrapper]
    assert mod.LIB.name == SOURCES[wrapper]
    assert list(mod.LIB.signatures) == KEYS[wrapper]


@pytest.mark.parametrize("wrapper", sorted(KEYS))
def test_reset_launches_zeroes_the_counter(wrapper):
    mod = MODULES[wrapper]
    counter = mod.LAUNCHES
    for i, kernel in enumerate(counter):
        counter[kernel] = i + 3
    mod.reset_launches()
    assert mod.LAUNCHES is counter
    assert counter == dict.fromkeys(KEYS[wrapper], 0)


def test_route_takes_the_plain_version_on_the_cpu():
    x = torch.zeros(2)
    assert build.route("SSD", x) is False
    assert build.route("SSD", x, torch.ones(3), torch.zeros(())) is False


@pytest.mark.parametrize("what", ["flash attention", "WKV6", "SSD", "AdamW",
                                  "quant-ring"])
def test_route_raises_on_mixed_devices_and_on_meta(what):
    cpu, meta = torch.zeros(2), torch.zeros(2, device="meta")
    with pytest.raises(ValueError,
                       match=r"tensors on several devices: \['cpu', 'meta'\]"):
        build.route(what, cpu, meta)
    with pytest.raises(ValueError, match=f"no {what} kernel for device meta"):
        build.route(what, meta, meta)


class _Entry:
    """A stand-in for a ctypes function: records its calls, returns
    ``ret``; a launch-config query writes 7 ints at its last argument."""

    def __init__(self, ret=0, config=None):
        self.calls, self.ret, self.config = [], ret, config

    def __call__(self, *args):
        self.calls.append(args)
        if self.config is not None:
            (ctypes.c_int * 7).from_address(args[-1].value)[:] = self.config
        return self.ret


class _FakeCDLL:
    def __init__(self, **entries):
        self.__dict__.update(entries)


@pytest.fixture
def fake_cuda(monkeypatch):
    """``torch.cuda.device`` and ``current_stream`` that a CPU process can
    enter: the stream's pointer is 1234."""

    class Stream:
        cuda_stream = 1234

    class Device:
        def __init__(self, device):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream)


def test_library_loads_once_and_launches_on_the_stream(monkeypatch, fake_cuda):
    fns = {"k_a": _Entry(), "k_b": _Entry(), "src_launch_config": _Entry()}
    loads = []

    def load(name):
        loads.append(name)
        return _FakeCDLL(**fns)

    monkeypatch.setattr(build, "load", load)
    lib = build.Library("src", {"a": [ctypes.c_int], "b": [ctypes.c_void_p] * 2},
                        prefix="k_")
    assert loads == [] and lib.launches == {"a": 0, "b": 0}
    lib.launch("a", torch.device("cpu"), 7)
    lib.launch("a", torch.device("cpu"), 8)
    lib.launch("b", torch.device("cpu"), 1, 2)
    assert loads == ["src"]
    assert lib.launches == {"a": 2, "b": 1}
    assert fns["k_a"].calls == [(7, 1234), (8, 1234)]
    assert fns["k_b"].calls == [(1, 2, 1234)]
    assert fns["k_a"].argtypes == [ctypes.c_int, ctypes.c_void_p]
    assert fns["k_b"].argtypes == [ctypes.c_void_p] * 3
    assert fns["k_a"].restype is ctypes.c_int
    lib.reset()
    assert lib.launches == {"a": 0, "b": 0}


def test_library_raises_on_a_failed_launch_and_does_not_count(monkeypatch, fake_cuda):
    monkeypatch.setattr(build, "load", lambda name: _FakeCDLL(
        bad=_Entry(ret=9), src_launch_config=_Entry()))
    lib = build.Library("src", {"bad": []})
    with pytest.raises(RuntimeError,
                       match="CUDA kernel bad failed to launch: cudaError 9"):
        lib.launch("bad", torch.device("cpu"))
    assert lib.launches == {"bad": 0}


@pytest.mark.parametrize("args", [(0,), (2, 224, 1), (1, 64, 32, 0)])
def test_library_launch_config_reads_seven_ints(monkeypatch, args):
    query = _Entry(config=[40, 0, 8, 256, 128, 4096, 3])
    monkeypatch.setattr(build, "load", lambda name: _FakeCDLL(
        k=_Entry(), src_launch_config=query))
    lib = build.Library("src", {"k": []})
    assert lib.launch_config(*args) == [40, 0, 8, 256, 128, 4096, 3]
    (call,) = query.calls
    assert [a.value for a in call[:-1]] == list(args)
    assert all(type(a) is ctypes.c_int for a in call[:-1])
    assert query.restype is ctypes.c_int
    assert lib.launches == {"k": 0}


def test_library_launch_config_raises_on_a_cuda_error(monkeypatch):
    monkeypatch.setattr(build, "load", lambda name: _FakeCDLL(
        k=_Entry(), src_launch_config=_Entry(ret=98)))
    lib = build.Library("src", {"k": []})
    with pytest.raises(RuntimeError,
                       match=r"src_launch_config\(0, 64\) failed: cudaError 98"):
        lib.launch_config(0, 64)
