"""The port's scheduler half held against the JAX package's: the numpy
modules carried across into ``repro_torch`` (utility, problem, topology,
trace, G-VNE, GADGET, the baselines, the event streams, the driver and its
analytic backend, the sanitizer and the calibration fit) and ``pdhg_solve``
rewritten in torch.

Everything the reference computes deterministically must come out
bit-identical: the full ``SimResult`` of ``gadget``, ``fifo``, ``drf`` and
``las`` (every slot record, the event log, the final worker-time z, the
committed rings and the cached utilities) over three seeds and a fault
config, plain and under ``REPRO_SANITIZE=1``; ``solve_slot``'s embeddings
and values; the generated graphs and jobs; the calibration fits.
``pdhg_solve`` is f32 on both sides with other summation orders: it is held
to the reference's own limits against HiGHS (``tests/test_lp.py``: within 2%
of the optimum, never above it by more than 5%, in the box) and to the
reference's ``pdhg_solve`` within 1e-4 of the value (measured below 1e-6).
"""

import dataclasses
import functools

import numpy as np
import pytest

from repro.cluster import make_fat_tree as jax_make_fat_tree
from repro.cluster.calibrate import RingTimingSample as JaxSample
from repro.cluster.calibrate import calibrate_profile as jax_calibrate_profile
from repro.cluster.calibrate import fit_comm_model as jax_fit_comm_model
from repro.cluster.topology import ResourceState as JaxResourceState
from repro.cluster.trace import JobTraceConfig as JaxTraceConfig
from repro.cluster.trace import generate_jobs as jax_generate_jobs
from repro.core.gvne import GvneConfig as JaxGvneConfig
from repro.core.gvne import solve_slot as jax_solve_slot
from repro.core.lp import pdhg_solve as jax_pdhg_solve
from repro.core.problem import DDLJSInstance as JaxInstance
from repro.core.problem import ScheduleState as JaxState
from repro.core.rar_model import profile_from_arch as jax_profile_from_arch
from repro.core.utility import sqrt_utility as jax_sqrt_utility
from repro.core.problem import Job as JaxJob
from repro.sched import ContentionConfig as JaxContention
from repro.sched import FaultConfig as JaxFaultConfig
from repro.sched import OnlineDriver as JaxDriver
from repro.sched import ScriptedEventStream as JaxScripted
from repro.sched import WorkerLeave as JaxWorkerLeave
from repro.sched import registry as jax_registry
from repro_torch.cluster import make_fat_tree
from repro_torch.cluster.calibrate import (
    RingTimingSample,
    calibrate_profile,
    fit_comm_model,
)
from repro_torch.cluster.topology import ResourceState
from repro_torch.cluster.trace import JobTraceConfig, generate_jobs
from repro_torch.configs import get_arch
from repro_torch.core import gvne
from repro_torch.core.gvne import GvneConfig, solve_slot
from repro_torch.core.lp import pdhg_solve, solve_lp
from repro_torch.core.problem import DDLJSInstance, Job, ScheduleState
from repro_torch.core.rar_model import profile_from_arch
from repro_torch.core.utility import sqrt_utility
from repro_torch.sched import (
    ContentionConfig,
    FaultConfig,
    OnlineDriver,
    ScriptedEventStream,
    WorkerLeave,
    registry,
)

SCHEDULERS = ("gadget", "fifo", "drf", "las")
SEEDS = (0, 1, 2)


def plain(x):
    """A structure of builtins that compares equal only where the two
    packages' objects agree bit for bit (floats by ``repr``, which round
    trips; dataclasses by class name and fields)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {repr(k): plain(v) for k, v in x.items()}
    if isinstance(x, (set, frozenset)):
        return ("set", sorted(repr(plain(v)) for v in x))
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (float, np.floating)):
        return ("float", repr(float(x)))
    if isinstance(x, np.integer):
        return int(x)
    if hasattr(x, "__dict__") and not callable(x):
        return (type(x).__name__, plain(vars(x)))
    return x


def sim_summary(res):
    st = res.state
    return plain({
        "scheduler": res.scheduler,
        "records": res.records,
        "completion_slot": res.completion_slot,
        "events": res.events,
        "z": st.z,
        "history": st.history,
        "utilities": st._util,
        "total_utility": res.total_utility,
        "avg_jct": res.avg_jct(),
        "embedded_ratio": res.embedded_ratio(),
    })


def trace_instance(side, seed, n_servers=8, n_jobs=8, horizon=16):
    make, gen, cfg, inst = ((make_fat_tree, generate_jobs, JobTraceConfig,
                             DDLJSInstance) if side == "port" else
                            (jax_make_fat_tree, jax_generate_jobs,
                             JaxTraceConfig, JaxInstance))
    graph = make(n_servers=n_servers, seed=seed + 1)
    jobs = gen(cfg(n_jobs=n_jobs, horizon=horizon, seed=seed + 2))
    return inst(graph=graph, jobs=jobs, horizon=horizon)


def example_instance(side):
    """``examples/schedule_and_train.py``'s instance: three jobs (job 1
    priced on the fused int8 ring) on the 1-2 GPU fat tree."""
    if side == "port":
        make, prof_of, job, util, inst = (make_fat_tree, profile_from_arch,
                                          Job, sqrt_utility, DDLJSInstance)
    else:
        make, prof_of, job, util, inst = (jax_make_fat_tree,
                                          jax_profile_from_arch, JaxJob,
                                          jax_sqrt_utility, JaxInstance)
    graph = make(n_servers=4, n_racks=2, n_core=1, gpus_choices=(1, 2), seed=0)
    jobs = []
    for i, arch in enumerate(["qwen3-0.6b", "granite-3-2b", "rwkv6-7b"]):
        prof = prof_of(n_params=float(get_arch(arch).n_params()),
                       tokens_per_batch=4096.0 * 8,
                       compression="int8-fused" if i == 1 else None,
                       message_overhead=5e-6)
        jobs.append(job(id=i, arrival=i % 2, max_workers=4,
                        demands={"gpus": 1.0, "mem": 1.0},
                        budgets={"gpus": 40.0}, bandwidth=30e9,
                        zeta=float(prof.iterations_per_slot(4, 60.0)) / 4.0,
                        utility=util(10.0), profile=prof, arch=arch))
    return inst(graph=graph, jobs=jobs, horizon=6)


def run(side, inst, name, **driver_kw):
    reg, driver = (registry, OnlineDriver) if side == "port" else \
        (jax_registry, JaxDriver)
    return driver(inst, **driver_kw).run(reg.create(name, seed=0))


def fault_kw(side, seed):
    fc = FaultConfig if side == "port" else JaxFaultConfig
    return {"faults": fc(server_fail_prob=0.08, straggler_prob=0.15,
                         seed=seed)}


def contention_kw(side):
    cc = ContentionConfig if side == "port" else JaxContention
    return {"contention": cc(oversubscription=1.5)}


@pytest.mark.parametrize("name", SCHEDULERS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sanitize", [False, True])
def test_sim_result_bit_identical(name, seed, sanitize, monkeypatch):
    if sanitize:
        monkeypatch.setenv("REPRO_SANITIZE", "1")
    else:
        monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    got = sim_summary(run("port", trace_instance("port", seed), name))
    want = sim_summary(run("jax", trace_instance("jax", seed), name))
    assert got == want


@pytest.mark.parametrize("name", SCHEDULERS)
@pytest.mark.parametrize("sanitize", [False, True])
def test_sim_result_bit_identical_under_faults_and_contention(name, sanitize,
                                                              monkeypatch):
    if sanitize:
        monkeypatch.setenv("REPRO_SANITIZE", "1")
    else:
        monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    for seed in SEEDS:
        got = sim_summary(run("port", trace_instance("port", seed), name,
                              **fault_kw("port", seed),
                              **contention_kw("port")))
        want = sim_summary(run("jax", trace_instance("jax", seed), name,
                               **fault_kw("jax", seed),
                               **contention_kw("jax")))
        assert got == want, seed


@pytest.mark.parametrize("sanitize", [False, True])
def test_example_instance_bit_identical(sanitize, monkeypatch):
    """The example's three jobs, with its contention and scripted leave;
    sanitized, the int8-fused job's wire check runs on both sides."""
    if sanitize:
        monkeypatch.setenv("REPRO_SANITIZE", "1")
    else:
        monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    got = sim_summary(run(
        "port", example_instance("port"), "gadget", **contention_kw("port"),
        events=ScriptedEventStream(mid=[WorkerLeave(3, job_id=0, n=1)])))
    want = sim_summary(run(
        "jax", example_instance("jax"), "gadget", **contention_kw("jax"),
        events=JaxScripted(mid=[JaxWorkerLeave(3, job_id=0, n=1)])))
    assert got == want


@pytest.mark.parametrize("seed", SEEDS)
def test_graphs_and_generated_jobs_identical(seed):
    port, ref = trace_instance("port", seed), trace_instance("jax", seed)
    assert plain(port.graph) == plain(ref.graph)
    assert len(port.jobs) == len(ref.jobs)
    for a, b in zip(port.jobs, ref.jobs):
        fields = [f.name for f in dataclasses.fields(b) if f.name != "utility"]
        assert plain({f: getattr(a, f) for f in fields}) == \
            plain({f: getattr(b, f) for f in fields})
        for z in (0.0, 0.5, 3.0, 17.25):
            assert repr(a.utility(z)) == repr(b.utility(z))


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_slot_identical(seed):
    out = {}
    for side in ("port", "jax"):
        inst = trace_instance(side, seed, n_servers=6, n_jobs=6, horizon=5)
        for j in inst.jobs:
            j.arrival = 0
        res_cls, state_cls, cfg_cls, solve = (
            (ResourceState, ScheduleState, GvneConfig, solve_slot)
            if side == "port" else
            (JaxResourceState, JaxState, JaxGvneConfig, jax_solve_slot))
        r = solve(res_cls(inst.graph), inst.jobs, state_cls(inst),
                  cfg_cls(seed=seed))
        out[side] = plain({f: getattr(r, f) for f in (
            "embeddings", "lp_value", "rounded_value", "value", "n_rounds",
            "accepted", "diagnostics")})
    assert out["port"] == out["jax"]


def test_calibration_fits_identical():
    rng = np.random.default_rng(0)
    samples = [(w, int(n), float(1e-4 + n * (w - 1) / w * 3e-9
                                  * (1 + 0.05 * rng.standard_normal())))
               for w in (2, 4, 8) for n in (1 << 14, 1 << 16, 1 << 18)]
    got = fit_comm_model([RingTimingSample(*s) for s in samples])
    want = jax_fit_comm_model([JaxSample(*s) for s in samples])
    assert plain(got) == plain(want)
    prof = profile_from_arch(n_params=1e8, tokens_per_batch=4096.0)
    jprof = jax_profile_from_arch(n_params=1e8, tokens_per_batch=4096.0)
    assert plain(calibrate_profile(prof, [RingTimingSample(*s) for s in samples])) \
        == plain(jax_calibrate_profile(jprof, [JaxSample(*s) for s in samples]))


def lp_case(seed, n, m, lo, hi):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.1, 1.0, n)
    A = rng.uniform(0.0, 1.0, (m, n))
    b = rng.uniform(lo, hi, m)
    return c, A, b


def test_pdhg_matches_highs_small():
    c, A, b = lp_case(0, 12, 6, 1.0, 3.0)
    exact = solve_lp(c, A_ub=A, b_ub=b, upper=np.ones(12))
    approx = pdhg_solve(c, A, b, upper=np.ones(12), iters=8000, device="cpu")
    assert approx.value == pytest.approx(exact.value, rel=0.02)
    ref = jax_pdhg_solve(c, A, b, upper=np.ones(12), iters=8000)
    assert approx.status == ref.status == 0
    assert abs(approx.value - ref.value) <= 1e-4 * abs(ref.value)


@pytest.mark.parametrize("seed", [0, 7, 42, 123, 499])
def test_pdhg_primal_feasible_and_bounded(seed):
    c, A, b = lp_case(seed, 10, 5, 0.5, 2.0)
    exact = solve_lp(c, A_ub=A, b_ub=b, upper=np.ones(10))
    approx = pdhg_solve(c, A, b, upper=np.ones(10), iters=6000, device="cpu")
    assert approx.value <= exact.value * 1.05 + 1e-6
    assert np.all(approx.x >= -1e-6) and np.all(approx.x <= 1.0 + 1e-6)
    ref = jax_pdhg_solve(c, A, b, upper=np.ones(10), iters=6000)
    assert approx.status == ref.status
    assert abs(approx.value - ref.value) <= 1e-4 * max(abs(ref.value), 1.0)
    np.testing.assert_allclose(approx.x, ref.x, atol=1e-4)


def test_gvne_with_pdhg_engine_on_cpu(monkeypatch):
    """``solve_slot`` with ``lp_engine="pdhg"`` lands within 25% of the
    HiGHS-driven value, as ``tests/test_theory.py`` holds the reference's;
    the engine's ``pdhg_solve`` is pointed at the CPU here (it runs on the
    card by default)."""
    monkeypatch.setattr(gvne, "pdhg_solve",
                        functools.partial(pdhg_solve, device="cpu"))
    graph = make_fat_tree(n_servers=6, n_racks=2, n_core=1, seed=3)
    jobs = generate_jobs(JobTraceConfig(n_jobs=6, horizon=5, seed=4))
    for j in jobs:
        j.arrival = 0
    state = ScheduleState(DDLJSInstance(graph=graph, jobs=jobs, horizon=5))
    exact = solve_slot(ResourceState(graph), jobs, state,
                       GvneConfig(seed=0, lp_engine="highs"))
    approx = solve_slot(ResourceState(graph), jobs, state,
                        GvneConfig(seed=0, lp_engine="pdhg"))
    assert approx.value >= 0.75 * exact.value
    for e in approx.embeddings:
        e.validate_ring()
