"""The port's trace replay, comparison metrics and simulator shim
(``repro_torch.cluster.traces``, ``.metrics``, ``.simulator``) held bit for
bit against the JAX package's on the seeds of ``tests/test_traces.py``,
``tests/test_trace_arrivals.py`` and ``tests/test_scheduler.py``.

All three are numpy on both sides, so everything must agree exactly: the
records the synthesizer draws, the files ``save_trace`` writes (byte for
byte, loaded across packages both ways), the jobs ``jobs_from_trace`` maps
them onto (every field, and the utility's values by ``repr``), the rows of
``summarize`` and their CSV lines, and the full ``SimResult`` of
``ClusterSimulator(...).run`` with and without faults.
"""

import dataclasses
import warnings

import pytest

from repro.cluster import metrics as jax_metrics
from repro.cluster import simulator as jax_simulator
from repro.cluster import traces as jax_traces
from repro.cluster.topology import make_fat_tree as jax_make_fat_tree
from repro.cluster.trace import JobTraceConfig as JaxTraceConfig
from repro.cluster.trace import generate_jobs as jax_generate_jobs
from repro.core.problem import DDLJSInstance as JaxInstance
from repro.sched import registry as jax_registry
from repro_torch.cluster import metrics, simulator, traces
from repro_torch.cluster.topology import make_fat_tree
from repro_torch.cluster.trace import JobTraceConfig, generate_jobs
from repro_torch.core.problem import DDLJSInstance
from repro_torch.sched import registry

from test_torch_sched import plain, sim_summary

SIDES = {"port": traces, "ref": jax_traces}
# the reference tests' synthesizer calls: (n_jobs, horizon, seed, queued)
SYNTH = [(50, 40, 3, None), (30, 20, 1, None), (5000, 100, 0, None),
         (2000, 100, 0, 1.0), (2000, 100, 0, 0.5), (200, 200, 9, None),
         (200, 200, 10, None)]
UTILITY_GRID = (0.0, 1.0, 37.5, 300.0, 1234.5, 3000.0, 1e5)


def _rec(mod, **kw):
    base = dict(job_id=0, submit_slot=3, gpu_count=4, duration_slots=12.5,
                bandwidth_class="medium", priority=42.0)
    base.update(kw)
    return mod.TraceJobRecord(**base)


def rows(records):
    return [dataclasses.asdict(r) for r in records]


def job_view(job):
    """Every field of a ``Job`` but its utility, floats by ``repr``, and the
    utility by its name and its values on a grid."""
    fields = {f.name: getattr(job, f.name) for f in dataclasses.fields(job)
              if f.name != "utility"}
    return plain({**fields, "utility": (job.utility.name,
                                        [job.utility(k) for k in UTILITY_GRID])})


@pytest.mark.parametrize("n_jobs,horizon,seed,queued", SYNTH)
def test_synthesize_pai_like_identical(n_jobs, horizon, seed, queued):
    got = traces.synthesize_pai_like(n_jobs=n_jobs, horizon=horizon,
                                     seed=seed, queued_fraction=queued)
    want = jax_traces.synthesize_pai_like(n_jobs=n_jobs, horizon=horizon,
                                          seed=seed, queued_fraction=queued)
    assert plain(rows(got)) == plain(rows(want))


@pytest.mark.parametrize("bad", [dict(bandwidth_class="turbo"),
                                 dict(gpu_count=0), dict(submit_slot=-1),
                                 dict(duration_slots=0.0)])
def test_record_validation_identical(bad):
    messages = []
    for mod in (traces, jax_traces):
        with pytest.raises(ValueError) as err:
            _rec(mod, **bad)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert _rec(traces).bandwidth == _rec(jax_traces).bandwidth \
        == traces.BANDWIDTH_CLASSES["medium"]
    assert traces.TRACE_COLUMNS == jax_traces.TRACE_COLUMNS
    assert traces.BANDWIDTH_CLASSES == jax_traces.BANDWIDTH_CLASSES


@pytest.mark.parametrize("ext", ["csv", "jsonl", "json"])
def test_save_and_load_across_packages(tmp_path, ext):
    """The two packages write the same bytes, and each loads what the other
    wrote into the same records."""
    records = {side: mod.synthesize_pai_like(n_jobs=50, horizon=40, seed=3)
               for side, mod in SIDES.items()}
    paths = {side: tmp_path / f"{side}.{ext}" for side in SIDES}
    for side, mod in SIDES.items():
        mod.save_trace(records[side], paths[side])
    assert paths["port"].read_bytes() == paths["ref"].read_bytes()
    want = plain(rows(records["ref"]))
    for reader in SIDES.values():
        for path in paths.values():
            assert plain(rows(reader.load_trace(path))) == want


def test_loaders_reject_the_same_inputs(tmp_path):
    bad_csv = tmp_path / "bad.csv"
    bad_csv.write_text("job_id,submit_slot\n0,1\n")
    bad_json = tmp_path / "bad.jsonl"
    bad_json.write_text('{"job_id": 0}\nnot json\n')
    for mod in SIDES.values():
        with pytest.raises(ValueError, match="unsupported trace extension"):
            mod.load_trace(tmp_path / "trace.parquet")
        with pytest.raises(ValueError, match="unsupported trace extension"):
            mod.save_trace([], tmp_path / "trace.parquet")
        with pytest.raises(ValueError, match="missing trace columns"):
            mod.load_trace(bad_csv)
    # a record missing columns fails on both sides before the bad line
    for mod in SIDES.values():
        with pytest.raises(KeyError):
            mod.load_trace(bad_json)
    bad_json.write_text("not json\n")
    for mod in SIDES.values():
        with pytest.raises(ValueError, match=":1: invalid JSON"):
            mod.load_trace(bad_json)


@pytest.mark.parametrize("utility", ["sigmoid", "sqrt"])
@pytest.mark.parametrize("seed", [0, 5, 6])
def test_jobs_from_trace_identical(utility, seed):
    got = traces.jobs_from_trace(
        traces.synthesize_pai_like(n_jobs=30, horizon=20, seed=1),
        seed=seed, utility=utility)
    want = jax_traces.jobs_from_trace(
        jax_traces.synthesize_pai_like(n_jobs=30, horizon=20, seed=1),
        seed=seed, utility=utility)
    assert [job_view(j) for j in got] == [job_view(j) for j in want]
    (one,) = traces.jobs_from_trace([_rec(traces)], seed=0)
    assert (one.id, one.arrival, one.max_workers, one.budgets) == \
        (0, 3, 4, {"gpus": 50.0})


# ``tests/test_trace_arrivals.py``'s generator configs (the second overruns
# its horizon and rescales, with a warning)
ARRIVAL_CFGS = [dict(n_jobs=100, horizon=200, mean_interarrival=2.0, seed=0),
                dict(n_jobs=200, horizon=50, mean_interarrival=2.0,
                     burst_prob=0.0, seed=1),
                dict(n_jobs=40, horizon=500, mean_interarrival=2.0, seed=3),
                dict(n_jobs=60, horizon=2000, mean_interarrival=2.0,
                     burst_prob=0.0, seed=2)]


@pytest.mark.parametrize("cfg", ARRIVAL_CFGS)
def test_generated_jobs_replay_identically(cfg, tmp_path):
    """Generated jobs, written as trace records by each package and replayed
    by each: the same jobs on both sides."""
    out = {}
    for side, (gen, conf) in (("port", (generate_jobs, JobTraceConfig)),
                              ("ref", (jax_generate_jobs, JaxTraceConfig))):
        mod = SIDES[side]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            jobs = gen(conf(**cfg))
        records = [mod.TraceJobRecord(
            job_id=j.id, submit_slot=j.arrival, gpu_count=j.max_workers,
            duration_slots=round(j.budgets["gpus"] / j.max_workers, 3),
            bandwidth_class="high" if j.bandwidth > 1e9 else "low",
            priority=10.0) for j in jobs]
        mod.save_trace(records, tmp_path / f"{side}.csv")
        out[side] = [job_view(j) for j in mod.jobs_from_trace(
            mod.load_trace(tmp_path / f"{side}.csv"), seed=cfg["seed"])]
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "ref.csv").read_bytes()
    assert out["port"] == out["ref"]


def small_instance(side, seed):
    """``tests/test_scheduler.py``'s instance, its seeds shifted by ``seed``."""
    make, gen, cfg, inst = ((make_fat_tree, generate_jobs, JobTraceConfig,
                             DDLJSInstance) if side == "port" else
                            (jax_make_fat_tree, jax_generate_jobs,
                             JaxTraceConfig, JaxInstance))
    graph = make(n_servers=10, seed=1 + seed)
    jobs = gen(cfg(n_jobs=12, horizon=20, seed=2 + seed))
    return inst(graph=graph, jobs=jobs, horizon=20)


def trace_instance(side):
    """Jobs replayed from a synthesized trace on the contention test's tree
    (``tests/test_scheduler.py``, seed 3)."""
    mod = SIDES[side]
    make, inst = ((make_fat_tree, DDLJSInstance) if side == "port"
                  else (jax_make_fat_tree, JaxInstance))
    records = mod.synthesize_pai_like(n_jobs=16, horizon=12, seed=4)
    return inst(graph=make(n_servers=8, seed=3),
                jobs=mod.jobs_from_trace(records, seed=4), horizon=12)


def simulate(side, inst, name, faults):
    sim_mod, reg = ((simulator, registry) if side == "port"
                    else (jax_simulator, jax_registry))
    fc = (sim_mod.FaultConfig(server_fail_prob=0.1, straggler_prob=0.2,
                              seed=5) if faults else None)
    sim = sim_mod.ClusterSimulator(inst, fc)
    with pytest.warns(DeprecationWarning, match="ClusterSimulator is deprecated"):
        return sim.run(reg.create(name, seed=0))


@pytest.mark.parametrize("name", ["gadget", "fifo"])
@pytest.mark.parametrize("faults", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_cluster_simulator_and_summaries_identical(name, faults, seed):
    results = {side: simulate(side, small_instance(side, seed), name, faults)
               for side in SIDES}
    assert sim_summary(results["port"]) == sim_summary(results["ref"])
    got = metrics.summarize([results["port"]])
    want = jax_metrics.summarize([results["ref"]])
    assert plain(got) == plain(want)
    assert metrics.csv_lines(got) == jax_metrics.csv_lines(want)


def test_replayed_trace_summaries_identical():
    """A synthesized trace replayed through every scheduler: the summary
    table and its CSV lines agree row for row."""
    out = {}
    for side, mod in (("port", metrics), ("ref", jax_metrics)):
        inst = trace_instance(side)
        results = []
        for name in ("gadget", "fifo", "drf", "las"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                sim_mod = simulator if side == "port" else jax_simulator
                reg = registry if side == "port" else jax_registry
                results.append(sim_mod.ClusterSimulator(inst).run(
                    reg.create(name, seed=0)))
        out[side] = (plain(mod.summarize(results)), mod.csv_lines(
            mod.summarize(results)))
    assert out["port"] == out["ref"]
    assert len(out["port"][1]) == 5
    assert metrics.csv_lines([]) == jax_metrics.csv_lines([]) == []


def test_simulator_reexports_the_moved_types():
    from repro_torch import cluster
    from repro_torch.sched import api, events

    assert simulator.FaultConfig is events.FaultConfig
    assert simulator.ContentionConfig is api.ContentionConfig
    assert simulator.SimResult is api.SimResult
    assert simulator.SlotRecord is api.SlotRecord
    assert simulator.contention_factor is api.contention_factor
    assert cluster.ClusterSimulator is simulator.ClusterSimulator
    assert cluster.synthesize_pai_like is traces.synthesize_pai_like
