"""The port's keys tier (`avenir_tpu_torch/analysis/keys.py`) on the CPU,
held against the JAX package's:

- every bad and good fixture of `tests/test_graftlint_keys.py` gives the
  same findings (rule id, line, scope, message) under each of the port's
  five rules as under the reference's;
- the key-site registry agrees with the port's `key_site` annotations
  (the reference's 11 names), and a dangling entry fails loudly;
- the perturbation audit validates two real sites on the CPU (the byte
  sidecar, and the Markov model served by the scorer) with the
  reference's rows, and flags the reference's under-keyed fixture site
  as the reference does, never allowlisted;
- the audit wants a card unless the caller asks for the CPU.
"""

import pytest
import torch

import test_graftlint_keys as ref_fx
import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.analysis import engine as jax_engine
from avenir_tpu.analysis import keys as jax_keys
from avenir_tpu_torch.analysis import engine, keys

FIXTURES = sorted(n for n in vars(ref_fx)
                  if n.startswith("_") and n.endswith(("_BAD", "_GOOD"))
                  and isinstance(getattr(ref_fx, n), str))
RULES = [r.rule_id for r in keys.ALL_KEYS_RULES]


def _findings(eng, tmp_path, source, rule):
    p = tmp_path / "snippet.py"
    p.write_text(source)
    report = eng.run_paths([str(p)], rules=[rule], baseline=[],
                           root=str(tmp_path))
    assert not report.errors
    return [(f.rule, f.line, f.scope, f.message) for f in report.findings]


def test_the_port_has_the_references_rules():
    assert RULES == [r.rule_id for r in jax_keys.ALL_KEYS_RULES]
    assert keys.keys_rule_ids() == jax_keys.keys_rule_ids()
    assert len(FIXTURES) == 10


@pytest.mark.parametrize("fixture", FIXTURES)
def test_rules_match_the_reference_on_its_fixtures(tmp_path, fixture):
    source = getattr(ref_fx, fixture)
    fired = 0
    for port_rule, ref_rule in zip(keys.ALL_KEYS_RULES,
                                   jax_keys.ALL_KEYS_RULES):
        got = _findings(engine, tmp_path, source, port_rule())
        assert got == _findings(jax_engine, tmp_path, source, ref_rule())
        fired += len(got)
    if fixture.endswith("_BAD"):
        assert fired


def test_registry_matches_the_annotations():
    refs = keys.check_key_registry()
    assert sorted(refs) == sorted(s.name for s in keys.KEY_SITES)
    assert sorted(refs) == sorted(s.name for s in jax_keys.KEY_SITES)
    assert all(path.startswith("avenir_tpu_torch/")
               for path, _line in refs.values())


def test_registry_fails_on_a_dangling_entry(monkeypatch):
    ghost = keys.KeySite(name="ghost.site", path="nowhere.py",
                         seed=lambda r: None, key=lambda r: [],
                         serve=lambda r: None)
    monkeypatch.setattr(keys, "KEY_SITES", list(keys.KEY_SITES) + [ghost])
    with pytest.raises(keys.KeysAuditError, match="ghost.site"):
        keys.check_key_registry()


def _rows(rows):
    return [{k: v for k, v in r.items() if k not in ("path", "line")}
            for r in rows]


def test_audit_validates_real_sites_like_the_reference():
    names = ("sidecar.bytes", "score.model")
    port = [s for s in keys.KEY_SITES if s.name in names]
    ref = [s for s in jax_keys.KEY_SITES if s.name in names]
    got, findings = keys.audit_keys(sites=port, device="cpu")
    want, ref_findings = jax_keys.audit_keys(sites=ref)
    assert findings == [] and ref_findings == []
    assert _rows(got) == _rows(want)
    assert [r["key_validated"] for r in got] == [True, True]
    assert got[1]["perturbations"] == {"affecting": 2, "neutral": 1,
                                       "format": 1}


def _bad_site(module):
    return module.KeySite(
        name="fixture.underkeyed", path="fixture.py",
        seed=ref_fx._fix_seed, key=ref_fx._fix_key,
        serve=lambda root: module._memo_serve(
            root, "memo.json", ref_fx._fix_key(root),
            lambda: [line.count(ref_fx._fix_conf(root)["delim"])
                     for line in open(f"{root}/corpus.csv").read()
                     .splitlines()]),
        perturbs=(module.KeyPerturb("conf:delim", "affecting",
                                    ref_fx._fix_set_delim),))


def test_audit_flags_an_underkeyed_site_as_the_reference_does(tmp_path):
    got, findings = keys.audit_keys(sites=[_bad_site(keys)], device="cpu")
    want, ref_findings = jax_keys.audit_keys(sites=[_bad_site(jax_keys)])
    assert got == want
    assert got[0]["key_validated"] is False
    assert got[0]["failing_perturbation"] == "fixture.underkeyed:conf:delim"
    assert [(f.rule, f.message) for f in findings] == \
        [(f.rule, f.message) for f in ref_findings]
    assert "left the key unchanged" in findings[0].message
    assert "stale serve" in findings[0].message
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    report = keys.run_keys(
        paths=[str(clean)], root=str(tmp_path), device="cpu",
        sites=[_bad_site(keys)],
        baseline=[engine.BaselineEntry(
            f"fixture.py::{keys.KEYS_AUDIT_RULE}::fixture.underkeyed",
            "trying to allowlist a stale serve", 1)])
    assert [f.rule for f in report.findings] == [keys.KEYS_AUDIT_RULE]
    assert not report.suppressed


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the default device is present")
def test_audit_wants_the_card_by_default():
    with pytest.raises(keys.KeysAuditError, match="CUDA device"):
        keys.audit_keys(sites=[_bad_site(keys)])
