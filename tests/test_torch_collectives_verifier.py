"""The port's collective verifier (``repro_torch.analysis.collectives``),
its mutation suite (``repro_torch.analysis.fixtures``) and
``LocalRing.permute``, held against the reference's verifier.

Every test of ``tests/test_collectives_verifier.py`` has its counterpart
here, on the port's recording ring (a jaxpr there, a ``RecordingRing``'s
records here). Beyond those, the reference's own check functions judge the
port's records: each recorded ``CollectiveSite`` is turned into the
reference's ``CollectiveSite`` (no guards: a recording has none) and handed
to the reference's ``check_topology``, ``check_deadlock``,
``check_pricing`` and ``check_step_pricing`` with the reference's
``RING_VARIANTS`` / ``STEP_MODES`` entry of the same name. The reference
cannot trace its own rings on this image (``AbstractMesh`` under jax 0.9.0,
ROADMAP C1), but these functions are pure. The port's step takes the loss
mean as the reference's ``pmean`` does, a 4-byte psum over the ring, so its
records are judged as they are. On the fixtures, the reference's
checks fire the axis the port's fire, except ``broken-branch-nested``: the
reference's ``check_deadlock`` reads the ``lax.cond`` guards of a jaxpr, a
recording has none, and that axis is held by the port's differential check
alone. Everything runs on the CPU, where the quant-ring wrappers take their
plain versions.
"""

import dataclasses
import itertools
import json
import os
import textwrap

import numpy as np
import pytest
import torch

from repro.analysis import collectives as jcoll
from repro.analysis import fixtures as jfix
from repro.dist.registry import STEP_MODES as REF_STEP_MODES
from repro.dist.registry import variant_by_name as ref_variant_by_name
from repro.kernels.quant_ring import hop_message_layout as ref_hop_message_layout
from repro_torch.analysis import collectives as coll
from repro_torch.analysis import fixtures as fix
from repro_torch.analysis.baseline import Baseline
from repro_torch.core.rar_model import wire_formula
from repro_torch.dist.collectives import LocalRing, _ring_perm
from repro_torch.dist.registry import RING_VARIANTS, STEP_MODES, variant_by_name
from repro_torch.kernels.quant_ring import hop_message_layout
from repro_torch.training.train_step import RING_STEP_MODES

# the verifier's entry points run on the card unless asked otherwise
DEVICE = "cpu"
WORLDS = (2, 3, 4)   # at least three world sizes, as the reference's tests
DS = (96, 777)       # divisible and padded gradient sizes
FIXTURES = {v.name: (v, axis) for v, axis in fix.broken_ring_variants()}


def _ref_sites(sites):
    """The port's records as the reference's sites (no guards)."""
    return [jcoll.CollectiveSite(primitive=s.primitive, nbytes=s.nbytes,
                                 dtype=s.dtype, perm=s.perm, guards=(),
                                 repeat=s.repeat) for s in sites]


# ---------------------------------------------------------------------------
# the repo is clean (the gate, as tests)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", RING_VARIANTS,
                         ids=[v.name for v in RING_VARIANTS])
def test_registered_variant_passes_all_axes(variant):
    findings = coll.verify_ring_variant(variant, WORLDS, DS, device=DEVICE)
    assert findings == [], "\n".join(str(f) for f in findings)


@pytest.mark.parametrize("mode", RING_STEP_MODES)
def test_step_mode_passes_all_axes(mode):
    findings = coll.verify_step_mode(mode, WORLDS, device=DEVICE)
    assert findings == [], "\n".join(str(f) for f in findings)


@pytest.mark.parametrize("mode", RING_STEP_MODES)
def test_step_mode_has_no_recompile_hazards(mode):
    findings = coll.audit_step_recompilation(mode, 2, device=DEVICE)
    assert findings == [], "\n".join(str(f) for f in findings)


def test_repo_wide_recompile_audits_clean():
    findings = (coll.audit_optimizer_templates(device=DEVICE)
                + coll.audit_static_closure()
                + coll.audit_live_group(device=DEVICE))
    assert findings == [], "\n".join(str(f) for f in findings)


def test_registry_covers_every_step_mode():
    assert set(STEP_MODES) == set(RING_STEP_MODES)
    for mode, spec in STEP_MODES.items():
        if spec.collective == "ppermute":
            assert spec.leaf_variant() in RING_VARIANTS


# ---------------------------------------------------------------------------
# the reference's check functions judge the port's records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [v.name for v in RING_VARIANTS])
def test_reference_checks_accept_recorded_variant(name):
    """Every registered variant at worlds 2/3/4/8 and d 96/777: the
    reference's checks, with the reference's variant of the same name,
    find nothing on the port's records, and neither do the port's."""
    variant, ref = variant_by_name(name), ref_variant_by_name(name)
    assert coll.verify_ring_variant(variant, coll.DEFAULT_WORLDS,
                                    coll.DEFAULT_DS, device=DEVICE) == []
    for w in coll.DEFAULT_WORLDS:
        for d in coll.DEFAULT_DS:
            sites = _ref_sites(coll.record_ring_variant(variant, w, d,
                                                        device=DEVICE))
            assert sites
            msgs = (jcoll.check_topology(ref, sites, w)
                    + jcoll.check_deadlock(sites)
                    + jcoll.check_pricing(ref, sites, w, d))
            assert msgs == [], (w, d, msgs)


@pytest.mark.parametrize("mode", RING_STEP_MODES)
def test_reference_checks_accept_recorded_step(mode):
    """Every step mode at worlds 2/3/4, its own records (the loss mean
    among them, a 4-byte psum): the reference's checks find nothing, and
    neither do the port's."""
    ref = REF_STEP_MODES[mode]
    for w in WORLDS:
        rec = coll.record_train_step(mode, w, device=DEVICE)
        sites = _ref_sites(rec.sites)
        msgs = (jcoll.check_topology(ref, sites, w)
                + jcoll.check_deadlock(sites)
                + jcoll.check_step_pricing(ref, sites, w, rec.leaf_sizes))
        assert msgs == [], (w, msgs)
        assert coll.check_step_pricing(STEP_MODES[mode], rec.sites, w,
                                       rec.leaf_sizes) == [], w


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reference_checks_fire_on_port_fixture(name):
    """On each fixture's records the reference's checks (with the
    reference's fixture of the same name) fire the axis the port's fire —
    except the branch: the reference's check_deadlock reads lax.cond
    guards, a recording has none, so the port's differential check alone
    holds that axis."""
    variant, axis = FIXTURES[name]
    ref = {v.name: v for v, _ in jfix.broken_ring_variants()}[name]
    w, d = 4, 777
    port_fired = {f.check for f in coll.verify_ring_variant(
        variant, [w], [d], device=DEVICE)}
    assert axis in port_fired
    sites = _ref_sites(coll.record_ring_variant(variant, w, d, device=DEVICE))
    ref_fired = {check for check, msgs in (
        ("ring-topology", jcoll.check_topology(ref, sites, w)),
        ("deadlock-order", jcoll.check_deadlock(sites)),
        ("pricing", jcoll.check_pricing(ref, sites, w, d))) if msgs}
    if name == "broken-branch-nested":
        assert ref_fired == set() and port_fired == {"deadlock-order"}
    else:
        assert ref_fired == port_fired == {axis}


def _perms(w):
    return [tuple(zip(range(w), dsts))
            for dsts in itertools.permutations(range(w))]


def test_cycle_error_matches_reference():
    """Message for message, on every permutation of 1-5 ranks, on every
    map of 1-3 ranks (non-bijections), on perms missing a pair, and on
    perms checked at another world size."""
    cases = [(p, w) for w in range(1, 6) for p in _perms(w)]
    cases += [(tuple(zip(range(w), m)), w) for w in range(1, 4)
              for m in itertools.product(range(w), repeat=w)]
    cases += [(p[:-1], w) for w in range(2, 6) for p in _perms(w)[:6]]
    cases += [(p, w + 1) for w in range(1, 5) for p in _perms(w)[:6]]
    assert len(cases) > 200
    for perm, w in cases:
        assert coll._cycle_error(perm, w) == jcoll._cycle_error(perm, w), \
            (perm, w)


def test_cli_json_keys_match_reference_schema(tmp_path):
    """The --json document has the reference's top-level keys, and each
    finding the reference's record keys."""
    empty = Baseline(entries={}, malformed=[])
    port = coll.findings_json([], empty, coll.SweepStats(), [])
    ref = jcoll.findings_json([], jcoll.Baseline(entries={}, malformed=[]),
                              jcoll.SweepStats(), [])
    assert set(port) == set(ref)
    finding = dict(check="pricing", path="src/x.py", symbol="s", message="m",
                   line=3)
    assert coll.Finding(**finding).to_json() == \
        jcoll.Finding(**finding).to_json()


@pytest.mark.parametrize("check,silenced", [
    ("check_topology", ("broken-wrong-permutation", "broken-mixed-direction")),
    ("check_pricing", ("broken-f32-payload-int8", "broken-trailer-mismatch",
                       "broken-fp8-trailer-mismatch",
                       "broken-bucket-missing-segment",
                       "broken-bucket-shared-chain")),
    ("scalar_leaf_findings", ("python_scalar_template",)),
])
def test_self_test_reports_each_toothless_check(monkeypatch, check, silenced):
    monkeypatch.setattr(coll, check, lambda *a, **k: [])
    failures = coll.run_self_test(device=DEVICE)
    for name in silenced:
        assert any(f.startswith(name) for f in failures), failures
    assert len(failures) == len(silenced)


# ---------------------------------------------------------------------------
# the mutation suite: each axis fails on its deliberately broken ring
# ---------------------------------------------------------------------------

def _fired(variant, w=4, d=777):
    return {f.check for f in coll.verify_ring_variant(variant, [w], [d],
                                                      device=DEVICE)}


def test_wrong_permutation_fails_ring_topology():
    broken = FIXTURES["broken-wrong-permutation"][0]
    # w=4: i -> i+2 splits into two 2-cycles
    assert "ring-topology" in _fired(broken)


def test_mixed_direction_fails_ring_topology():
    broken = FIXTURES["broken-mixed-direction"][0]
    assert "ring-topology" in _fired(broken)
    # each individual perm is a fine cycle — only direction consistency fires
    findings = coll.verify_ring_variant(broken, [4], [777], device=DEVICE)
    assert any("distinct permutations" in f.message for f in findings)


def test_branch_nested_collective_fails_deadlock_order():
    broken = FIXTURES["broken-branch-nested"][0]
    findings = coll.verify_ring_variant(broken, [4], [777], device=DEVICE)
    deadlock = [f for f in findings if f.check == "deadlock-order"]
    assert deadlock and "depends on the data" in deadlock[0].message
    # the all-negative and all-zero families skip the branch the N(0, 1)
    # family takes
    assert {"'negative'", "'zero'"} <= {f.message.split()[3]
                                        for f in deadlock}


def test_byte_drift_fails_pricing():
    broken = FIXTURES["broken-f32-payload-int8"][0]
    findings = coll.verify_ring_variant(broken, [4], [777], device=DEVICE)
    pricing = [f for f in findings if f.check == "pricing"]
    assert pricing, findings
    # message count is deliberately correct; only the bytes drift (4x)
    assert not any("gamma accounting" in f.message for f in pricing)
    assert any("prices" in f.message and "B" in f.message for f in pricing)


def test_trailer_mismatch_fails_pricing():
    broken = FIXTURES["broken-trailer-mismatch"][0]
    findings = coll.verify_ring_variant(broken, [4], [777], device=DEVICE)
    assert any(f.check == "pricing" and "trailer" in f.message
               for f in findings), findings


def test_fp8_trailer_mismatch_fails_pricing():
    """The short-trailer defect must also fire under fp8 pricing — fp8
    shares the int8 message layout (1 B payload + bitcast f32 trailer)."""
    broken = FIXTURES["broken-fp8-trailer-mismatch"][0]
    findings = coll.verify_ring_variant(broken, [4], [777], device=DEVICE)
    assert any(f.check == "pricing" and "fp8-fused" in f.message
               for f in findings), findings


def test_bucket_missing_segment_fails_pricing():
    """A bucket pipeline that rings only 2 of its 3 declared segments must
    fail pricing on message count (a silently-unreduced bucket)."""
    broken = FIXTURES["broken-bucket-missing-segment"][0]
    findings = coll.verify_ring_variant(broken, [4], [777], device=DEVICE)
    pricing = [f for f in findings if f.check == "pricing"]
    assert any("gamma accounting" in f.message for f in pricing), findings


def test_bucket_shared_chain_fails_pricing_on_messages_only():
    """Three declared buckets through ONE ring carry the same total bytes
    as the per-segment plan — only the per-message accounting catches the
    shared chain."""
    broken = FIXTURES["broken-bucket-shared-chain"][0]
    findings = coll.verify_ring_variant(broken, [4], [777], device=DEVICE)
    pricing = [f for f in findings if f.check == "pricing"]
    assert any("gamma accounting" in f.message for f in pricing), findings
    # the byte totals coincide by construction: no byte-drift finding
    assert not any("payloads total" in f.message for f in pricing), findings


def test_python_scalar_fails_recompile_hazard():
    findings = coll.scalar_leaf_findings(fix.python_scalar_template(),
                                         "fixture")
    assert len(findings) == 1
    assert findings[0].check == "recompile-hazard"
    assert "lr_scale" in findings[0].message


def test_self_test_reports_all_axes_firing():
    assert coll.run_self_test(device=DEVICE) == []


def test_self_test_detects_a_toothless_checker(monkeypatch):
    """If an analysis silently stops firing, the self-test must say so."""
    monkeypatch.setattr(coll, "check_deadlock", lambda families: [])
    failures = coll.run_self_test(device=DEVICE)
    assert any("broken-branch-nested" in f for f in failures)


def test_trailer_mismatch_shared_with_kernel_checker():
    """The same seeded trailer defect is rejected at the kernel-config
    layer too — one fixture constant, two analyses."""
    from repro_torch.analysis import kernels as akern

    spec = fix.trailer_mismatch_kernel_spec()
    assert spec.scale_bytes == fix.TRAILER_MISMATCH_SCALE_BYTES
    result = akern.check_spec(spec)
    assert not result.ok
    assert any("scale_bytes" in e for e in result.errors)
    # and the default CLI suite pins it as a must-reject
    assert any(getattr(s, "scale_bytes", None) ==
               fix.TRAILER_MISMATCH_SCALE_BYTES and not expect_ok
               for s, expect_ok in akern.default_suite())


# ---------------------------------------------------------------------------
# topology primitives
# ---------------------------------------------------------------------------

def test_cycle_error_accepts_hamiltonian_cycles():
    for w in (2, 3, 4, 8):
        fwd = tuple((i, (i + 1) % w) for i in range(w))
        rev = tuple((i, (i - 1) % w) for i in range(w))
        assert coll._cycle_error(fwd, w) is None
        assert coll._cycle_error(rev, w) is None


def test_cycle_error_rejects_non_bijections_and_split_cycles():
    # rank 0 sends twice, rank 1 never sends
    assert "bijection" in coll._cycle_error(((0, 1), (0, 2), (2, 0)), 3)
    # two disjoint 2-cycles over 4 ranks
    err = coll._cycle_error(((0, 2), (2, 0), (1, 3), (3, 1)), 4)
    assert "disjoint cycles" in err


def test_bidir_w2_forward_reverse_coincide():
    """At w=2 both directions are the same perm — the bidirectional variant
    must still pass (the sweep includes w=2)."""
    bidir = variant_by_name("bidir")
    findings = coll.verify_ring_variant(bidir, [2], [96], device=DEVICE)
    assert findings == [], findings


# ---------------------------------------------------------------------------
# pricing agreement with rar_model / quant_ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compression", [None, "int8", "int8-fused",
                                         "bf16-fused", "fp8-fused"])
def test_variant_expectations_match_wire_formula(compression):
    name = {None: "f32", "int8": "int8", "int8-fused": "int8-fused",
            "bf16-fused": "bf16-fused", "fp8-fused": "fp8-fused"}
    variant = variant_by_name(name[compression])
    formula = wire_formula(compression)
    for w in WORLDS:
        assert variant.expected_messages(w) == formula.messages(w)
        for d in DS:
            assert variant.expected_bytes(d, w) == pytest.approx(
                formula.bytes_per_worker(d, w, executed=True))


def test_fused_recorded_message_is_hop_message_layout():
    """Every fused hop ships one int8 buffer of exactly payload+trailer,
    the reference's layout."""
    variant = variant_by_name("int8-fused")
    w, d = 4, 777
    sites = coll.record_ring_variant(variant, w, d, device=DEVICE)
    layout = hop_message_layout(-(-d // w), block=4096)
    assert layout.message_bytes == \
        ref_hop_message_layout(-(-d // w), block=4096).message_bytes
    hops = [s for s in sites if s.primitive == "ppermute"]
    assert hops and all(
        s.uniform and s.dtype == "int8" and s.nbytes == layout.message_bytes
        for s in hops)
    assert layout.message_bytes == layout.payload_bytes + layout.trailer_bytes


def test_recording_ring_records_every_collective():
    """One record a permute (and a hop), one a psum: the perm, each rank's
    dtype and bytes, repeat 1; the ring's counts as a LocalRing's. Ranks
    sending different sizes in one collective are a pricing finding."""
    ring = coll.RecordingRing(["cpu"] * 3)
    xs = [torch.zeros(4), torch.zeros(4), torch.zeros(4)]
    ring.permute(xs, [(0, 2), (2, 1), (1, 0)])
    ring.hop(xs, reverse=True)
    ring.psum([torch.zeros(2, dtype=torch.bfloat16)] * 3)
    ring.permute([torch.zeros(4), torch.zeros(5), torch.zeros(4, dtype=torch.int8)],
                 _ring_perm(3))
    assert [(s.primitive, s.perm, s.repeat) for s in ring.sites] == [
        ("ppermute", ((0, 2), (2, 1), (1, 0)), 1),
        ("ppermute", ((0, 2), (1, 0), (2, 1)), 1),
        ("psum", None, 1),
        ("ppermute", ((0, 1), (1, 2), (2, 0)), 1)]
    assert ring.sites[2].rank_dtypes == ("bfloat16",) * 3
    assert ring.sites[2].rank_bytes == (4, 4, 4)
    assert ring.sites[3].rank_dtypes == ("float32", "float32", "int8")
    assert ring.sites[3].rank_bytes == (16, 20, 4)
    assert not ring.sites[3].uniform
    assert ring.messages == [3, 3, 3] and ring.psums == [1, 1, 1]
    assert ring.bytes == [48, 52, 36]
    msgs = coll.check_pricing(variant_by_name("f32"), ring.sites, 3, 12)
    assert any("different dtypes or sizes" in m for m in msgs)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("w", [2, 3, 4, 8])
def test_hop_is_permute_along_the_ring(w, reverse):
    """``hop(reverse=...)`` is ``permute`` with ``_ring_perm(w, reverse)``:
    the same bits delivered, the same counts."""
    rng = np.random.default_rng(w)
    xs = [torch.from_numpy(rng.standard_normal(13).astype(np.float32))
          for _ in range(w)]
    a, b = LocalRing(["cpu"] * w), LocalRing(["cpu"] * w)
    got = a.hop(xs, reverse=reverse)
    want = b.permute(xs, _ring_perm(w, reverse))
    assert all(torch.equal(g, h) for g, h in zip(got, want))
    assert all(g.data_ptr() != x.data_ptr() for g, x in zip(got, xs))
    assert (a.messages, a.bytes) == (b.messages, b.bytes)
    assert a.directions == {"reverse" if reverse else "forward"}
    assert b.directions == set()


def test_differential_deadlock_check_names_the_first_divergence():
    site = coll.CollectiveSite("ppermute", ((0, 1), (1, 0)), ("int8",) * 2,
                               (8, 8))
    other = dataclasses.replace(site, rank_bytes=(9, 9))
    assert coll.check_deadlock({"normal": [site], "zero": [site]}) == []
    msgs = coll.check_deadlock({"normal": [site, site],
                                "alternating": [site, other],
                                "zero": [site]})
    assert len(msgs) == 2
    assert "'alternating'" in msgs[0] and "collective 1" in msgs[0]
    assert "'zero'" in msgs[1] and "1 collective(s) against 2" in msgs[1]


def test_input_families_flip_signs_and_include_zeros():
    w = 4
    normal = coll.family_inputs("normal", w, (5,))
    alt = coll.family_inputs("alternating", w, (5,))
    assert np.array_equal(alt[0::2], normal[0::2])
    assert np.array_equal(alt[1::2], -normal[1::2])
    assert (coll.family_inputs("negative", w, (5,)) <= 0).all()
    assert not coll.family_inputs("zero", w, (5,)).any()
    with pytest.raises(ValueError):
        coll.family_inputs("uniform", w, (5,))


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device does not raise")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        coll.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        coll.main([])
    # the Python entry points default to the card as the CLI does
    with pytest.raises(RuntimeError, match="no CUDA card"):
        coll.run_verifier()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        coll.run_self_test()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        coll.record_ring_variant(variant_by_name("f32"), 2, 96)


# ---------------------------------------------------------------------------
# recompile-hazard audits on mutated inputs
# ---------------------------------------------------------------------------

def test_static_closure_ast_audit_fires_on_mutation(tmp_path):
    src = textwrap.dedent("""
        class RingWorkerGroup:
            STATIC_CLOSURE_ATTRS = ("model", "optimizer", "lr")

            def __init__(self, model):
                self.model = model
                self.lr = 0.1

            def retune(self, lr):
                self.lr = lr        # mutates closed-over static state

            def fine(self):
                self.workers = 2    # not a static attr: allowed
        """)
    path = tmp_path / "elastic_mutated.py"
    path.write_text(src)
    findings = coll.audit_static_closure(str(path))
    assert len(findings) == 1
    f = findings[0]
    assert f.check == "recompile-hazard"
    assert f.symbol == "RingWorkerGroup.retune"
    assert "self.lr" in f.message and f.line > 0


def _group():
    from repro_torch.training.elastic import RingWorkerGroup, ring_devices
    from repro_torch.training.optimizer import make_optimizer

    return RingWorkerGroup(coll._VerifierModel(), make_optimizer("sgdm"),
                           global_batch=8, lr=1e-2, mode="ring",
                           devices=ring_devices("cpu"))


def test_cache_audit_catches_closure_mutation():
    from repro_torch.sched.backend import audit_compiled_step_cache

    group = _group()
    assert audit_compiled_step_cache(group) == []
    group.lr = 5e-3  # the hazard: ring programs closed over the old lr
    problems = audit_compiled_step_cache(group)
    assert problems and "static attrs" in problems[0]


def test_cache_audit_catches_compile_count_drift():
    from repro_torch.sched.backend import audit_compiled_step_cache

    group = _group()
    group.compile_count = 3  # claims 3 builds, zero cached programs
    problems = audit_compiled_step_cache(group)
    assert problems and "compile_count" in problems[0]


def test_compiled_step_cache_hits_on_same_key():
    group = _group()
    group._program(1)
    group._program(1)
    assert group.compile_count == 1
    assert group.cache_key(1) == (1, "ring", None, "float32")


def test_step_templates_have_no_python_scalars():
    rec = coll.record_train_step("ring", 2, device=DEVICE)
    assert coll.scalar_leaf_findings(rec.params, "params") == []
    assert coll.scalar_leaf_findings(rec.opt_state, "opt_state",
                                     params=rec.params) == []
    # a state leaf of another dtype than its parameter is the other hazard
    bad = {"mom": {"w": rec.opt_state["mom"]["w"].double()}}
    findings = coll.scalar_leaf_findings(bad, "opt_state", params=rec.params)
    assert len(findings) == 1 and "parameter w" in findings[0].message


# ---------------------------------------------------------------------------
# CLI + baseline + --json
# ---------------------------------------------------------------------------

def test_cli_exit_zero_on_repo(tmp_path, capsys):
    out_json = tmp_path / "findings.json"
    rc = coll.main(["--worlds", "2", "3", "4", "--d", "96", "777",
                    "--json", str(out_json), "--device", DEVICE])
    captured = capsys.readouterr().out
    assert rc == 0, captured
    assert "12 variant(s) + 8 step mode(s)" in captured
    data = json.loads(out_json.read_text())
    assert data["tool"] == "repro_torch.analysis.collectives"
    assert data["findings"] == []
    assert data["self_test_failures"] == []
    # variants x worlds x ds x input families
    assert data["stats"]["records"] >= 12 * 3 * 2 * len(coll.FAMILIES)


def test_cli_json_schema_matches_lint(tmp_path):
    """Both analysis CLIs emit the same per-finding record shape."""
    finding = coll.Finding(check="pricing", path="src/x.py", symbol="s",
                           message="m", line=3)
    record = finding.to_json()
    assert set(record) == {"rule", "path", "line", "symbol", "message",
                           "key"}
    assert record["rule"] == "pricing"
    assert finding.key == "pricing:src/x.py:s"


def test_cli_write_baseline_placeholders_still_fail(tmp_path, monkeypatch):
    """A bootstrapped baseline documents findings but cannot silence
    them."""
    baseline = tmp_path / "collectives_baseline.txt"

    def fake_run_verifier(*a, **k):
        return ([coll.Finding(check="pricing", path="src/x.py", symbol="s",
                              message="drift")], coll.SweepStats())

    monkeypatch.setattr(coll, "run_verifier", fake_run_verifier)
    cpu = ["--device", DEVICE]
    rc = coll.main(["--write-baseline", "--baseline", str(baseline),
                    "--skip-self-test"] + cpu)
    assert rc == 0
    assert "TODO justify" in baseline.read_text()

    # the written placeholder is malformed -> still exit 1
    rc = coll.main(["--baseline", str(baseline), "--skip-self-test"] + cpu)
    assert rc == 1

    # a real justification suppresses it
    baseline.write_text("pricing:src/x.py:s  # accepted drift, priced apart\n")
    rc = coll.main(["--baseline", str(baseline), "--skip-self-test"] + cpu)
    assert rc == 0

    # stale entries fail once the finding is gone
    monkeypatch.setattr(coll, "run_verifier",
                        lambda *a, **k: ([], coll.SweepStats()))
    rc = coll.main(["--baseline", str(baseline), "--skip-self-test"] + cpu)
    assert rc == 1


def test_cli_fails_when_mutation_suite_goes_silent(monkeypatch, capsys):
    monkeypatch.setattr(coll, "run_verifier",
                        lambda *a, **k: ([], coll.SweepStats()))
    monkeypatch.setattr(coll, "run_self_test",
                        lambda *a, **k: ["broken-x: expected pricing"])
    rc = coll.main(["--device", DEVICE])
    assert rc == 1
    assert "MUTATION SUITE NOT FIRING" in capsys.readouterr().out


def test_default_baseline_absent_and_loadable():
    """The shipped sweep is clean, so no baseline file exists — and the
    shared loader treats that as an empty, well-formed baseline."""
    path = coll.default_baseline_path()
    assert not os.path.exists(path)
    loaded = Baseline.load(path)
    assert loaded.entries == {} and loaded.malformed == []
