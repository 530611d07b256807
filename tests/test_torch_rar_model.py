"""The port's Eq. (1) pricing (``repro_torch.core.rar_model``) held against
the JAX package's ``repro.core.rar_model``, bit for bit.

A scalar worker count must give the same Python number as the reference,
and an array of worker counts the same float32 array: the reference
computes arrays in ``jnp`` (float32, one eager op at a time), the port in
numpy float32 with the same operations in the same order. No tolerance.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import rar_model as ref
from repro_torch.core import rar_model as port

LAYOUTS = ref.WIRE_COMPRESSIONS
WS = list(range(1, 17))
DS = [1, 7, 513, 4096, 4097, 1000003, 751632384]
PROFILE = dict(d=751632384.0, bandwidth=12.5e9, reduce_speed=2.8e11,
               t_fwd_per_sample=1.7e-5, t_bwd=0.19, batch_size=8192.0,
               overhead=5e-3)


def same(got, want):
    """Bit-identical: the same Python type and value for a scalar, the same
    dtype, shape and bits for an array."""
    if isinstance(want, (int, float)):
        assert type(got) is type(want) and got == want, (got, want)
        return
    want = np.asarray(want)
    assert isinstance(got, np.ndarray), type(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def both(name, *args, **kw):
    return getattr(port, name)(*args, **kw), getattr(ref, name)(*args, **kw)


def test_module_constants_match():
    assert port.WIRE_COMPRESSIONS == ref.WIRE_COMPRESSIONS
    assert port._FUSED_WIRE_LAYOUTS == ref._FUSED_WIRE_LAYOUTS
    assert [f.name for f in dataclasses.fields(port.RarJobProfile)] == \
        [f.name for f in dataclasses.fields(ref.RarJobProfile)]
    assert [f.name for f in dataclasses.fields(port.WireFormula)] == \
        [f.name for f in dataclasses.fields(ref.WireFormula)]


@pytest.mark.parametrize("compression", LAYOUTS)
def test_wire_formula_matches(compression):
    for block in (128, 4096):
        fp = port.wire_formula(compression, block=block)
        fr = ref.wire_formula(compression, block=block)
        assert dataclasses.asdict(fp) == dataclasses.asdict(fr)
        for w in WS:
            same(fp.messages(w), fr.messages(w))
            for d in DS:
                for executed in (True, False):
                    same(fp.bytes_per_worker(d, w, executed=executed),
                         fr.bytes_per_worker(d, w, executed=executed))


def test_wire_formula_rejects_unknown_layout():
    for bad in ("int4", "fp8", "bf16", ""):
        with pytest.raises(ValueError):
            port.wire_formula(bad)
        with pytest.raises(ValueError):
            ref.wire_formula(bad)


@pytest.mark.parametrize("as_array", [False, True], ids=["scalar", "array"])
def test_ring_bytes_and_times_match(as_array):
    ws = [np.asarray(WS)] if as_array else WS + [0, 2.0, 3.5]
    for w in ws:
        for d in DS:
            for eb in (1, 2, 4):
                same(*both("rar_ring_bytes_per_worker", float(d), w, eb))
            same(*both("rar_allreduce_time", w, float(d), 1e9, 3e10))
        for fused in (False, True):
            same(*both("compressed_ring_messages", w, fused=fused))
        for compression in LAYOUTS:
            same(*both("rar_ring_messages", w, compression=compression))


@pytest.mark.parametrize("as_array", [False, True], ids=["scalar", "array"])
@pytest.mark.parametrize("fused", [False, True])
def test_compressed_bytes_and_time_match(fused, as_array):
    ws = [np.asarray(WS)] if as_array else WS
    for w in ws:
        for d in DS:
            for block in (1, 33, 128, 4096):
                for peb, trailer in ((1, True), (2, False)):
                    kw = dict(fused=fused, block=block,
                              payload_elem_bytes=peb, trailer=trailer)
                    same(*both("rar_compressed_bytes_per_worker", float(d), w,
                               **kw))
                    same(*both("compressed_rar_allreduce_time", w, float(d),
                               1e9, 3e10, message_overhead=2e-6, **kw))


@pytest.mark.parametrize("as_array", [False, True], ids=["scalar", "array"])
@pytest.mark.parametrize("compression", LAYOUTS)
def test_iteration_time_matches(compression, as_array):
    ws = [np.asarray(WS)] if as_array else WS
    for w in ws:
        for mo in (0.0, 3e-6):
            for h in (0.0, 0.25, 1.0):
                same(*both("rar_iteration_time", w, compression=compression,
                           message_overhead=mo, overlap_hidden_fraction=h,
                           **PROFILE))
        pp = port.RarJobProfile(compression=compression, **PROFILE)
        pr = ref.RarJobProfile(compression=compression, **PROFILE)
        same(pp.iteration_time(w), pr.iteration_time(w))
        same(pp.iterations_per_slot(w, 60.0), pr.iterations_per_slot(w, 60.0))
        for bw in (1e9, 12.5e9):
            for h in (None, 0.0, 0.5):
                same(port.effective_iteration_time(pp, bw, w,
                                                   overlap_hidden_fraction=h),
                     ref.effective_iteration_time(pr, bw, w,
                                                  overlap_hidden_fraction=h))


@pytest.mark.parametrize("compression", LAYOUTS)
def test_scalar_helpers_match(compression):
    pp = port.RarJobProfile(compression=compression, message_overhead=1e-6,
                            **PROFILE)
    pr = ref.RarJobProfile(compression=compression, message_overhead=1e-6,
                           **PROFILE)
    for w in WS:
        for bw in (0.0, 1e9, 12.5e9, 20e9):
            same(port.contention_progress_factor(pp, w, bw),
                 ref.contention_progress_factor(pr, w, bw))
        same(port.effective_zeta(pp, w, 60.0), ref.effective_zeta(pr, w, 60.0))
        same(*both("ps_worker_bytes", 1e6, w))
    same(port.effective_iteration_time(pp, 0.0, 4),
         ref.effective_iteration_time(pr, 0.0, 4))
    for w_max in (1, 4, 16):
        same(port.optimal_worker_count(pp, w_max),
             ref.optimal_worker_count(pr, w_max))
    kw = {k: v for k, v in PROFILE.items() if k not in ("batch_size",)}
    kw.pop("d")
    same(*both("rar_iteration_time_asymptote", d=PROFILE["d"],
               batch_size=PROFILE["batch_size"], **kw))
    for n_params, tokens in ((6e8, 8192.0), (2.5e9, 1.0)):
        got, want = both("profile_from_arch", n_params=n_params,
                         tokens_per_batch=tokens, compression=compression,
                         message_overhead=2e-6, overlap_hidden_fraction=0.5)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_bad_arguments_raise_as_in_reference():
    for mod in (port, ref):
        with pytest.raises(ValueError):
            mod.rar_iteration_time(4, compression="int4", **PROFILE)
        with pytest.raises(ValueError):
            mod.rar_iteration_time(4, overlap_hidden_fraction=1.5, **PROFILE)
