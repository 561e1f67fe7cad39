"""The port's race tier (`avenir_tpu_torch/analysis/race.py`) on the
CPU, held against the JAX package's:

- every bad and good fixture of `tests/test_graftlint_race.py` gives the
  same findings (rule id, line, scope, message) under each of the port's
  five rules as under the reference's;
- the interleave-site registry agrees with the port's `sched_point`
  calls (the reference's 8 sites over 12 hook names);
- the explorer validates two real sites on the CPU with the reference's
  rows (two resident actor interpreters, the file turnstile, depth 1 and
  two seeds), and a seeded schedule replays to the same trace;
- it flags the reference's deliberately racy check-then-act claim as the
  reference does, with the same failing schedule, which replays to the
  same verdict through `--schedule`.
"""

import os

import pytest

import test_graftlint_race as ref_fx
import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.analysis import engine as jax_engine
from avenir_tpu.analysis import race as jax_race
from avenir_tpu_torch.analysis import engine, race

FIXTURES = sorted(n for n in vars(ref_fx)
                  if n.startswith("_") and n.endswith(("_BAD", "_GOOD"))
                  and isinstance(getattr(ref_fx, n), str))


def _findings(eng, tmp_path, source, rule):
    p = tmp_path / "snippet.py"
    p.write_text(source)
    report = eng.run_paths([str(p)], rules=[rule], baseline=[],
                           root=str(tmp_path))
    assert not report.errors
    return [(f.rule, f.line, f.scope, f.message) for f in report.findings]


def test_the_port_has_the_references_rules():
    assert [r.rule_id for r in race.ALL_RACE_RULES] == \
        [r.rule_id for r in jax_race.ALL_RACE_RULES]
    assert race.race_rule_ids() == jax_race.race_rule_ids()
    assert len(FIXTURES) == 10


@pytest.mark.parametrize("fixture", FIXTURES)
def test_rules_match_the_reference_on_its_fixtures(tmp_path, fixture):
    source = getattr(ref_fx, fixture)
    fired = 0
    for port_rule, ref_rule in zip(race.ALL_RACE_RULES,
                                   jax_race.ALL_RACE_RULES):
        got = _findings(engine, tmp_path, source, port_rule())
        assert got == _findings(jax_engine, tmp_path, source, ref_rule())
        fired += len(got)
    if fixture.endswith("_BAD"):
        assert fired


def _reference_site_names():
    """The reference's registered sites whose seam lies in its package:
    a fixture site another test appended to the reference's list (its
    racy check-then-act claim, path "bad_fixture.py") is not one."""
    return [s.name for s in jax_race.INTERLEAVE_SITES
            if s.path.startswith("avenir_tpu/")]


def _registry_agrees():
    """The port's registry against what the reference's code says: the
    hooks against the sched_point names read from the reference's
    sources, the sites against its package's own sites."""
    refs = race.check_sched_registry()
    hooks = sorted({h for s in race.INTERLEAVE_SITES for h in s.sched})
    assert sorted(refs) == hooks and len(hooks) == 12
    assert hooks == sorted(jax_race.sched_annotations())
    names = [s.name for s in race.INTERLEAVE_SITES]
    assert names == _reference_site_names() and len(names) == 8


def test_registry_matches_the_annotations():
    _registry_agrees()


def test_registry_check_ignores_a_leaked_fixture_site(monkeypatch):
    # the reference's racy fixture module appends its site to the
    # reference's list at import; a ghost of it must not move the check
    ghost = jax_race.InterleaveSite(
        "bad.claim", "bad_fixture.py", ("bad.claim",), lambda root: None,
        (lambda root: {}, lambda root: {}), lambda *a: [])
    monkeypatch.setattr(jax_race, "INTERLEAVE_SITES",
                        jax_race.INTERLEAVE_SITES + [ghost])
    assert "bad.claim" in [s.name for s in jax_race.INTERLEAVE_SITES]
    _registry_agrees()
    assert "bad.claim" not in _reference_site_names()


def _rows(rows):
    return [{k: v for k, v in r.items() if k not in ("path", "line")}
            for r in rows]


def test_audit_validates_real_sites_like_the_reference():
    names = ("checkpoint.save", "sidecar.manifest")
    got, findings = race.audit_interleavings(
        sites=[s for s in race.INTERLEAVE_SITES if s.name in names],
        depth=1, seeds=2)
    want, ref_findings = jax_race.audit_interleavings(
        sites=[s for s in jax_race.INTERLEAVE_SITES if s.name in names],
        depth=1, seeds=2)
    assert findings == [] and ref_findings == []
    assert _rows(got) == _rows(want)
    assert [r["schedules"] for r in got] == \
        [{"exhaustive": 2, "seeded": 2, "replay": 0}] * 2


def test_seeded_schedule_replays_deterministically(tmp_path):
    site = next(s for s in race.INTERLEAVE_SITES if s.name == "ledger.claim")
    pool = race._ActorPool(str(tmp_path / "pool"))
    try:
        runs = []
        for n in range(3):
            rd = tmp_path / f"r{n}"
            rd.mkdir()
            decider = (race._seeded_decider(site.name, 7) if n < 2
                       else race._replay_decider(runs[0][2]))
            runs.append(race._run_schedule(pool, site, decider, str(rd)))
    finally:
        pool.close()
    assert runs[0][2] == runs[1][2] == runs[2][2]
    assert runs[0][3] == runs[1][3] == runs[2][3]


def _bad_site(module, pkg, tmp_path, monkeypatch):
    """The reference's racy claim site, as a module of `pkg` the actor
    children import (`SITE_MODULE_ENV`)."""
    name = f"race_bad_site_{pkg}"
    (tmp_path / f"{name}.py").write_text(
        ref_fx._BAD_SITE_MODULE.replace("from avenir_tpu.", f"from {pkg}."))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(tmp_path), os.environ.get("PYTHONPATH")) if p))
    monkeypatch.setenv(module.SITE_MODULE_ENV, name)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(module, "INTERLEAVE_SITES",
                        list(module.INTERLEAVE_SITES))
    import importlib
    return importlib.import_module(name).BAD_CLAIM


def test_audit_flags_a_racy_claim_as_the_reference_does(tmp_path,
                                                        monkeypatch):
    want, ref_findings = jax_race.audit_interleavings(
        sites=[_bad_site(jax_race, "avenir_tpu", tmp_path, monkeypatch)],
        depth=2, seeds=0)
    site = _bad_site(race, "avenir_tpu_torch", tmp_path, monkeypatch)
    got, findings = race.audit_interleavings(sites=[site], depth=2, seeds=0)
    assert got == want
    assert got[0]["interleaving_validated"] is False
    failing = got[0]["failing_schedule"]
    assert failing and failing.startswith("bad.claim:")
    assert "2 claim winners" in findings[0].message
    assert f"--schedule {failing}" in findings[0].message
    assert findings[0].message.replace(
        "python -m avenir_tpu_torch.analysis", "graftlint") \
        == ref_findings[0].message
    rows, again = race.audit_interleavings(
        sites=[site], schedule=race.parse_schedule(failing))
    assert rows[0]["failing_schedule"] == failing
    assert rows[0]["schedules"] == {"exhaustive": 0, "seeded": 0,
                                    "replay": 1}
    assert "2 claim winners" in again[0].message
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    report = race.run_race(
        paths=[str(clean)], root=str(tmp_path), sites=[site], depth=2,
        seeds=0, device="cpu",
        baseline=[engine.BaselineEntry(
            f"bad_fixture.py::{race.RACE_AUDIT_RULE}::bad.claim",
            "trying to allowlist a schedule failure", 1)])
    assert [f.rule for f in report.findings] == [race.RACE_AUDIT_RULE]
    assert not report.suppressed


def test_unknown_replay_site_is_an_audit_error():
    with pytest.raises(race.RaceAuditError, match="no.such.site"):
        race.audit_interleavings(schedule=("no.such.site", [0, 1]))
