"""The port's ring-timing measurement (``repro_torch.cluster.calibrate``'s
``measure_ring_timings`` and ``main``) against the reference's.

The reference times its ring over one process's host devices and skips the
worlds larger than their count; the port times the f32 ``ring_all_reduce``
over a ``LocalRing`` whose ranks all sit on one device, so every world of
the grid runs. Its default grid is the reference's, whose own recording on
8 host devices is ``tests/data/ring_timings.json``. The fit of what the
port records is the reference's fit of the same samples, bit for bit.
"""

import dataclasses
import inspect
import json
import os

import pytest
import torch

from repro.cluster import calibrate as jax_calibrate
from repro_torch.cluster import calibrate

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "data", "ring_timings.json")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: when test workers share the cores, torch's thread
    pool makes the w=8 rings tens of times slower and the fit noisy."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grid(samples):
    return [(s.world, s.n_elements) for s in samples]


def test_default_grid_is_the_references():
    port = inspect.signature(calibrate.measure_ring_timings).parameters
    ref = inspect.signature(jax_calibrate.measure_ring_timings).parameters
    for name in ("worlds", "n_elements", "repeats"):
        assert port[name].default == ref[name].default, name
    assert port["device"].default == "cuda"
    recorded = _grid(jax_calibrate.load_timings(FIXTURE))
    want = [(w, d) for w in port["worlds"].default
            for d in port["n_elements"].default]
    assert recorded == want and len(want) == 9


def test_small_sizes_give_the_references_grid():
    sizes = (16, 64, 256)
    samples = calibrate.measure_ring_timings(worlds=(1, 2, 4, 8, 16),
                                             n_elements=sizes, repeats=2,
                                             device="cpu")
    # world 1 is skipped as in the reference; 16 runs, since one device
    # holds any number of ranks (the reference skips worlds beyond its
    # device count)
    assert _grid(samples) == [(w, d) for w in (2, 4, 8, 16) for d in sizes]
    assert all(isinstance(s, calibrate.RingTimingSample) and s.seconds > 0
               for s in samples)


def test_no_fallback_off_the_card():
    if torch.cuda.is_available():
        pytest.skip("this process has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        calibrate.measure_ring_timings(worlds=(2,), n_elements=(16,),
                                       repeats=1)


def test_main_writes_json_that_load_timings_reads(tmp_path, capsys):
    out = tmp_path / "ring_timings.json"
    calibrate.main(["--device", "cpu", "--out", str(out)])
    line = capsys.readouterr().out.strip()
    assert line.startswith(f"recorded 9 samples -> {out}; fitted b=")
    assert "not a wire between devices" in line
    samples = calibrate.load_timings(str(out))
    assert _grid(samples) == _grid(jax_calibrate.load_timings(FIXTURE))
    assert samples == [calibrate.RingTimingSample(**r)
                       for r in json.loads(out.read_text())]
    # the reference reads the port's file and fits it to the same bits
    ref_samples = jax_calibrate.load_timings(str(out))
    fit = calibrate.fit_comm_model(samples)
    assert dataclasses.asdict(fit) == dataclasses.asdict(
        jax_calibrate.fit_comm_model(ref_samples))
    assert fit.n_samples == 9 and fit.bandwidth > 0
