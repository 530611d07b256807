"""The port's execution backends and online loop held against the JAX
package's.

* ``LiveBackend`` against framework-free stub trainers: one case for each
  behaviour that ``tests/test_exec_backend.py`` pins for the reference
  (full credit, leave -> re-ring, failure wave -> restore, straggler
  throttling, a one-step slot's leave, a whole ring's departure,
  ``restore_profiles``, analytic pricing without a trainer, calibration:
  the refit, the compute subtraction, an inconsistent compute model, a
  single comm load, a compressed ring's actual wire bytes), each run on
  the port and on the reference with the same stubs and expected to give
  the same numbers; and the driver-backend contract.
* The port and the reference driven by the same stub trainers over the
  example's instance (GADGET, contention, the scripted leave, and a fault
  config), with ``calibrate=False`` and with deterministic stub timings and
  calibration on: the ``SimResult``s and the backends' reports are
  identical, bit for bit.
* ``audit_compiled_step_cache`` over the port's ``RingWorkerGroup``.
* The ported loop, ``repro_torch.launch.schedule_and_train``, on the CPU at
  the example's sizes, checked for what the example asserts.
"""

import types

import numpy as np
import pytest
import torch

import repro.cluster.topology as jax_topology
import repro.core.problem as jax_problem
import repro.core.rar_model as jax_rar_model
import repro.core.utility as jax_utility
import repro.sched as jax_sched
import repro_torch.cluster.topology as topology
import repro_torch.core.problem as problem
import repro_torch.core.rar_model as rar_model
import repro_torch.core.utility as utility
import repro_torch.sched as sched
from repro_torch.configs import get_arch
from repro_torch.launch import schedule_and_train as loop
from repro_torch.models.model import build_model
from repro_torch.sched.backend import audit_compiled_step_cache
from repro_torch.training.elastic import RingWorkerGroup
from repro_torch.training.optimizer import make_optimizer
from test_torch_sched import example_instance, plain, sim_summary

SIDES = {
    "port": types.SimpleNamespace(topology=topology, problem=problem,
                                  rar_model=rar_model, utility=utility,
                                  sched=sched),
    "jax": types.SimpleNamespace(topology=jax_topology, problem=jax_problem,
                                 rar_model=jax_rar_model, utility=jax_utility,
                                 sched=jax_sched),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this file's torch ops on one thread: its ops are small, and when
    test workers share the cores, torch's own thread pool makes them many
    times slower than one thread does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=list(SIDES))
def ns(request):
    return SIDES[request.param]


def one_job_instance(ns, horizon=3, budget=8.0, profile=None):
    t = ns.topology
    servers = [t.Server(0, 0, {"gpus": 4.0}), t.Server(1, 0, {"gpus": 4.0})]
    links = []
    for s in servers:
        links.append(t.Link(s.node, "r0", 100.0))
        links.append(t.Link("r0", s.node, 100.0))
    graph = t.SubstrateGraph(servers, links, n_racks=1, n_core=0)
    job = ns.problem.Job(id=0, arrival=0, max_workers=2, demands={"gpus": 1.0},
                         budgets={"gpus": budget}, bandwidth=1.0, zeta=1.0,
                         utility=ns.utility.sqrt_utility(1.0), profile=profile)
    return ns.problem.DDLJSInstance(graph=graph, jobs=[job], horizon=horizon)


def coloc_two(ns):
    """A scheduler that places a colocated 2-worker ring for every active
    job."""
    s = ns.sched

    class ColocTwo(s.SchedulerBase):
        name = "coloc2"

        def decide(self, ctx):
            embeddings = []
            for job in ctx.active_jobs():
                emb = ns.topology.Embedding(job.id, [(0, 2)], [], job.bandwidth)
                if ctx.res.feasible(emb, job.demands):
                    ctx.res.commit(emb, job.demands)
                    embeddings.append(emb)
            return s.SlotDecision(ctx.t, embeddings, 0.0, 0.0,
                                  len(ctx.active_jobs()), len(embeddings))
    return ColocTwo()


class StubTrainer:
    """Duck-typed ElasticTrainer that replays the ``run_slot`` contract. Its
    parameters are 100 elements, as a port replica tree (device -> tree) or
    as the reference's tree."""

    def __init__(self, ns, timings_by_call=()):
        self.params = ({torch.device("cpu"): {"w": torch.zeros(100)}}
                       if ns is SIDES["port"] else {"w": np.zeros(100, np.float32)})
        self.plans = []
        self.restores = 0
        self.step = 0
        self._timings = list(timings_by_call)

    def run_slot(self, plan):
        self.plans.append(plan)
        w = plan.workers
        if plan.leave is not None:
            after, n = plan.leave
            worker_steps = after * w + (plan.steps - after) * max(1, w - n)
            re_rings = 1
        else:
            worker_steps = plan.steps * w
            re_rings = 0
        self.step += plan.steps
        idx = len(self.plans) - 1
        timings = self._timings[idx] if idx < len(self._timings) else {}
        return {"steps": plan.steps, "loss": 1.0, "workers": w,
                "worker_steps": worker_steps, "timings": timings,
                "re_rings": re_rings}

    def restore(self):
        self.restores += 1
        return True


def drive(ns, inst, backend, **kw):
    return ns.sched.OnlineDriver(inst, backend=backend, **kw).run(coloc_two(ns))


def profile(ns, **kw):
    base = dict(d=100.0, bandwidth=4e6, reduce_speed=float("inf"),
                t_fwd_per_sample=0.0, t_bwd=0.0, batch_size=8.0)
    return ns.rar_model.RarJobProfile(**{**base, **kw})


def comm_secs(w, d=100, b_true=1e6):
    """Eq. (1)'s comm time at ``b_true`` elements/s, zero overhead."""
    return d * (w - 1.0) / w * 2.0 / b_true


# ---------------------------------------------------------------------------
# the driver-backend contract
# ---------------------------------------------------------------------------

def test_default_backend_is_analytic(ns):
    s = ns.sched
    inst = one_job_instance(ns)
    assert isinstance(s.OnlineDriver(inst).backend, s.AnalyticBackend)
    assert isinstance(s.AnalyticBackend(), s.ExecutionBackend)
    assert isinstance(s.LiveBackend({}), s.ExecutionBackend)


def test_backend_sees_every_slot_and_midslot_view(ns):
    s = ns.sched
    seen = []

    class Recording(s.AnalyticBackend):
        name = "recording"

        def execute_slot(self, decision, execution):
            seen.append((execution.t, set(execution.wave),
                         dict(execution.left), len(decision.embeddings)))
            return super().execute_slot(decision, execution)

    drive(ns, one_job_instance(ns, horizon=3), Recording(),
          events=s.ScriptedEventStream(mid=[s.WorkerLeave(1, job_id=0, n=1),
                                            s.ServerFailure(2, server_id=0)]))
    assert seen == [(0, set(), {}, 1), (1, set(), {0: 1}, 1),
                    (2, {0}, {}, 1)]


def test_backend_factors_drive_commit_slot_and_arity_is_checked(ns):
    s = ns.sched

    class HalfCredit:
        name = "half"

        def execute_slot(self, decision, execution):
            return s.SlotOutcome(factors=[0.5] * len(decision.embeddings))

    class Broken:
        name = "broken"

        def execute_slot(self, decision, execution):
            return s.SlotOutcome(factors=[])

    out = drive(ns, one_job_instance(ns, horizon=2), HalfCredit())
    assert out.state.z[0] == pytest.approx(2.0)
    assert all(r.effective_worker_time == pytest.approx(1.0)
               for r in out.records)
    with pytest.raises(ValueError, match="broken.*factors"):
        drive(ns, one_job_instance(ns, horizon=1), Broken())


# ---------------------------------------------------------------------------
# LiveBackend against stub trainers, on both sides
# ---------------------------------------------------------------------------

def test_full_slot_gets_full_credit(ns):
    tr = StubTrainer(ns)
    backend = ns.sched.LiveBackend({0: tr}, steps_per_slot=4, calibrate=False)
    out = drive(ns, one_job_instance(ns, horizon=2), backend)
    assert out.state.z[0] == pytest.approx(4.0)
    assert tr.step == 8 and tr.restores == 0
    assert all(r["factor"] == pytest.approx(1.0) for r in backend.reports)


def test_worker_leave_re_rings_without_restore(ns):
    s = ns.sched
    tr = StubTrainer(ns)
    backend = s.LiveBackend({0: tr}, steps_per_slot=4, calibrate=False)
    out = drive(ns, one_job_instance(ns, horizon=1), backend,
                events=s.ScriptedEventStream(mid=[s.WorkerLeave(0, job_id=0, n=1)]))
    assert tr.restores == 0
    assert tr.plans[0].leave == (2, 1)
    assert out.state.z[0] == pytest.approx(6.0 / 8.0 * 2.0)
    assert backend.reports[0]["re_rings"] == 1


def test_failure_wave_restores_checkpoint(ns):
    s = ns.sched
    tr = StubTrainer(ns)
    backend = s.LiveBackend({0: tr}, steps_per_slot=4, calibrate=False)
    out = drive(ns, one_job_instance(ns, horizon=2), backend,
                events=s.ScriptedEventStream(mid=[s.ServerFailure(0, server_id=0)]))
    assert tr.restores == 1
    assert out.records[0].lost_embeddings == 1
    assert out.records[0].effective_worker_time == 0.0
    assert out.records[1].n_embedded == 0
    assert out.state.z[0] == 0.0


def test_straggler_throttles_submitted_steps(ns):
    s = ns.sched
    tr = StubTrainer(ns)
    backend = s.LiveBackend({0: tr}, steps_per_slot=4, calibrate=False)
    out = drive(ns, one_job_instance(ns, horizon=1), backend,
                events=s.ScriptedEventStream(
                    pre=[s.StragglerOnset(0, server_id=0, factor=0.5)]))
    assert tr.plans[0].steps == 2
    assert out.state.z[0] == pytest.approx(1.0)


def test_one_step_slot_leave_runs_on_survivors(ns):
    s = ns.sched
    tr = StubTrainer(ns)
    backend = s.LiveBackend({0: tr}, steps_per_slot=4, calibrate=False)
    out = drive(ns, one_job_instance(ns, horizon=1), backend,
                events=s.ScriptedEventStream(
                    pre=[s.StragglerOnset(0, server_id=0, factor=0.25)],
                    mid=[s.WorkerLeave(0, job_id=0, n=1)]))
    assert tr.plans[0].steps == 1
    assert tr.plans[0].leave == (0, 1)
    assert out.state.z[0] == pytest.approx(0.25)


def test_whole_ring_departure_restores_with_zero_credit(ns):
    s = ns.sched
    inst = one_job_instance(ns, horizon=1)
    tr = StubTrainer(ns)
    backend = s.LiveBackend({0: tr}, steps_per_slot=4, calibrate=False)
    events = s.ScriptedEventStream(mid=[s.WorkerLeave(0, job_id=0, n=2)])
    out = drive(ns, inst, backend, events=events)
    assert tr.restores == 1 and tr.plans == []
    assert out.state.z[0] == 0.0
    ref = s.OnlineDriver(
        inst, events=s.ScriptedEventStream(mid=[s.WorkerLeave(0, job_id=0, n=2)])
    ).run(coloc_two(ns))
    assert ref.state.z[0] == out.state.z[0]


def test_restore_profiles_undoes_calibration(ns):
    prof = profile(ns)
    inst = one_job_instance(ns, horizon=2, profile=prof)
    tr = StubTrainer(ns, [{2: comm_secs(2)}, {4: comm_secs(4)}] * 2)
    backend = ns.sched.LiveBackend({0: tr}, steps_per_slot=4)
    drive(ns, inst, backend)
    assert inst.jobs[0].profile is not prof
    backend.restore_profiles()
    assert inst.jobs[0].profile is prof
    assert backend.calibrated == {} and backend.samples == {} \
        and backend.reports == []
    drive(ns, inst, backend)
    assert inst.jobs[0].profile.bandwidth == pytest.approx(1e6, rel=1e-6)


def test_jobs_without_trainer_price_analytically(ns):
    backend = ns.sched.LiveBackend({}, steps_per_slot=4)
    out = drive(ns, one_job_instance(ns, horizon=1), backend)
    assert out.state.z[0] == pytest.approx(2.0)
    assert backend.reports == []


def test_recalibrates_profile_bandwidth(ns):
    prof = profile(ns)
    inst = one_job_instance(ns, horizon=2, profile=prof)
    tr = StubTrainer(ns, [{2: comm_secs(2)}, {4: comm_secs(4)}])
    backend = ns.sched.LiveBackend({0: tr}, steps_per_slot=4)
    drive(ns, inst, backend)
    assert 0 in backend.calibrated
    assert inst.jobs[0].profile.bandwidth == pytest.approx(1e6, rel=1e-6)
    assert {s.world for s in backend.samples[0]} == {2, 4}


def test_calibration_subtracts_modeled_compute(ns):
    c_fwd, t_bwd, gb = 1e-3, 1e-3, 8
    inst = one_job_instance(ns, horizon=2, profile=profile(
        ns, t_fwd_per_sample=c_fwd, t_bwd=t_bwd))

    def secs(w):
        return comm_secs(w) + c_fwd * gb / w + t_bwd

    tr = StubTrainer(ns, [{2: secs(2)}, {4: secs(4)}])
    tr.global_batch = gb
    drive(ns, inst, ns.sched.LiveBackend({0: tr}, steps_per_slot=4))
    assert inst.jobs[0].profile.bandwidth == pytest.approx(1e6, rel=1e-6)


def test_calibration_ignores_inconsistent_compute_model(ns):
    inst = one_job_instance(ns, horizon=2, profile=profile(ns, t_bwd=10.0))
    tr = StubTrainer(ns, [{2: comm_secs(2)}, {4: comm_secs(4)}])
    tr.global_batch = 8
    backend = ns.sched.LiveBackend({0: tr}, steps_per_slot=4)
    drive(ns, inst, backend)
    assert 0 in backend.calibrated
    assert inst.jobs[0].profile.bandwidth == pytest.approx(1e6, rel=1e-6)


def test_skips_refit_on_single_comm_load(ns):
    prof = profile(ns)
    inst = one_job_instance(ns, horizon=2, profile=prof)
    tr = StubTrainer(ns, [{2: 1e-4}, {2: 1e-4}])
    backend = ns.sched.LiveBackend({0: tr}, steps_per_slot=4)
    drive(ns, inst, backend)
    assert backend.calibrated == {}
    assert inst.jobs[0].profile is prof


def test_calibrates_compressed_profiles_at_actual_bytes(ns):
    rm = ns.rar_model
    d, b_true = 100, 1e6
    inst = one_job_instance(ns, horizon=2,
                            profile=profile(ns, compression="int8"))

    def secs(w):
        return rm.rar_compressed_bytes_per_worker(d, w) / (4.0 * b_true)

    tr = StubTrainer(ns, [{2: secs(2)}, {4: secs(4)}] * 2)
    backend = ns.sched.LiveBackend({0: tr}, steps_per_slot=4)
    drive(ns, inst, backend)
    for s in backend.samples[0]:
        ratio = (rm.rar_compressed_bytes_per_worker(d, s.world)
                 / rm.rar_ring_bytes_per_worker(d, s.world, elem_bytes=4))
        assert s.n_elements == pytest.approx(d * ratio)
    assert inst.jobs[0].profile.bandwidth == pytest.approx(b_true, rel=1e-6)
    assert inst.jobs[0].profile.compression == "int8"


# ---------------------------------------------------------------------------
# port and reference, the same stubs, identical results
# ---------------------------------------------------------------------------

def stub_timings():
    """Per call, best step seconds by ring size: Eq. (1)-shaped, so the
    calibration refit fires once two ring sizes are seen."""
    return [{w: 1e-3 + comm_secs(w, d=3e6, b_true=5e8) * (1 + 0.01 * i)}
            for i in range(12) for w in (4, 2, 1)]


def stub_run(side, *, calibrate, faults):
    ns = SIDES[side]
    s = ns.sched
    inst = example_instance(side)
    trainers = {j.id: StubTrainer(ns, stub_timings()) for j in inst.jobs}
    backend = s.LiveBackend(trainers, steps_per_slot=4, calibrate=calibrate)
    kw = {"faults": s.FaultConfig(server_fail_prob=0.1, straggler_prob=0.2,
                                  seed=5)} if faults else {
        "events": s.ScriptedEventStream(mid=[s.WorkerLeave(3, job_id=0, n=1)])}
    res = s.OnlineDriver(inst, contention=s.ContentionConfig(oversubscription=1.5),
                         backend=backend, **kw).run(
        s.registry.create("gadget", seed=0))
    return {"sim": sim_summary(res), "reports": plain(backend.reports),
            "calibrated": plain(backend.calibrated),
            "samples": plain(backend.samples),
            "plans": plain({j: t.plans for j, t in trainers.items()}),
            "restores": {j: t.restores for j, t in trainers.items()}}


@pytest.mark.parametrize("calibrate", [False, True])
@pytest.mark.parametrize("faults", [False, True])
def test_stub_driven_runs_identical(calibrate, faults):
    got = stub_run("port", calibrate=calibrate, faults=faults)
    want = stub_run("jax", calibrate=calibrate, faults=faults)
    assert got == want
    assert got["reports"], "the stubs must have run"
    if calibrate:
        assert got["calibrated"] != {}


def test_sanitized_stub_run_identical(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert stub_run("port", calibrate=True, faults=False) == \
        stub_run("jax", calibrate=True, faults=False)


# ---------------------------------------------------------------------------
# the compiled-step cache audit over the port's RingWorkerGroup
# ---------------------------------------------------------------------------

def make_group():
    model = build_model(get_arch("qwen3-0.6b").reduced())
    return RingWorkerGroup(model, make_optimizer("adamw"), global_batch=8,
                           lr=1e-2, mode="ring", devices=["cpu"] * 8)


def test_audit_compiled_step_cache_clean_and_catches_hazards():
    group = make_group()
    for w in (4, 2, 4):
        group.form(w)
    assert group.compile_count == 2
    assert audit_compiled_step_cache(group) == []

    group.lr = 5e-3    # a closed-over attribute mutated after construction
    problems = audit_compiled_step_cache(group)
    assert len(problems) == 1 and "fingerprint" in problems[0]

    group = make_group()
    group.form(4)
    group.compile_count += 1
    assert "compile_count=2" in audit_compiled_step_cache(group)[0]

    group = make_group()
    group.form(4)
    prog = group._programs.pop(group.cache_key(4))
    group._programs[group.cache_key(2)] = prog
    assert any("spans 4 rank slot(s)" in p
               for p in audit_compiled_step_cache(group))


def test_live_backend_audits_the_cache_when_sanitizing(monkeypatch):
    from repro_torch.analysis import SanitizerError

    class Trainer(StubTrainer):
        def __init__(self):
            super().__init__(SIDES["port"])
            self.group = make_group()
            self.group.form(2)
            self.group.lr = 5e-3

    inst = one_job_instance(SIDES["port"], horizon=1)
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    out = drive(SIDES["port"], inst, sched.LiveBackend({0: Trainer()},
                                                      calibrate=False))
    assert out.records
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    with pytest.raises(SanitizerError, match="cache audit failed"):
        drive(SIDES["port"], inst, sched.LiveBackend({0: Trainer()},
                                                    calibrate=False))


# ---------------------------------------------------------------------------
# the ported loop on the CPU, at the example's sizes
# ---------------------------------------------------------------------------

def test_schedule_and_train_loop_on_cpu(capsys):
    jobs, trainers, backend, result = loop.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count(" slot ") == loop.SLOTS and "== outcome ==" in out
    assert [j.arch for j in jobs] == loop.ARCHS
    assert trainers[1].mode == "compressed-fused"
    assert trainers[0].mode == trainers[2].mode == "ring"
    # the scripted leave re-rang job 0's slot-3 ring once, with no restore
    slot3 = [r for r in backend.reports if r["t"] == 3 and r["job_id"] == 0]
    assert len(slot3) == 1 and slot3[0]["re_rings"] == 1
    assert trainers[0].re_ring_events == 1
    assert all(tr.restores == 0 for tr in trainers.values())
    for job_id, tr in trainers.items():
        rows = [r for r in backend.reports if r["job_id"] == job_id]
        assert tr.step == sum(r["steps"] for r in rows) > 0
        assert len(tr.losses) == tr.step
        assert np.all(np.isfinite(tr.losses))
        assert result.state.z[job_id] > 0
    # measured credit: a 4-worker slot that lost one worker halfway goes on
    # over 2 (3 survivors clamp to a divisor of the global batch 8)
    assert slot3[0]["worker_steps"] == 2 * 4 + 2 * 2
