"""The port's proto tier (`avenir_tpu_torch/analysis/proto.py`) on the
CPU, held against the JAX package's:

- every bad and good fixture of `tests/test_graftlint_proto.py` gives the
  same findings (rule id, line, scope, message) under each of the port's
  seven rules as under the reference's;
- the commit-site registry agrees with the port's `crash_point` /
  `site=` annotations (the reference's 13 names);
- the crash audit validates two real sites on the CPU with the
  reference's rows (each killed before and after its rename in a fresh
  interpreter, recovered byte-identical), and flags the reference's
  injected bad sites (a non-atomic append, a site whose hook is never
  reached, a driver that raises) as the reference does.
"""

import pytest

import test_graftlint_proto as ref_fx
import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.analysis import engine as jax_engine
from avenir_tpu.analysis import proto as jax_proto
from avenir_tpu_torch.analysis import engine, proto
from avenir_tpu_torch.core.atomic import AFTER_RENAME, BEFORE_RENAME

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
    assert [r.rule_id for r in proto.ALL_PROTO_RULES] == \
        [r.rule_id for r in jax_proto.ALL_PROTO_RULES]
    assert proto.proto_rule_ids() == jax_proto.proto_rule_ids()
    assert len(FIXTURES) == 14


@pytest.mark.parametrize("fixture", FIXTURES)
def test_rules_match_the_reference_on_its_fixtures(tmp_path, fixture):
    source = getattr(ref_fx, fixture)
    fired = 0
    for port_rule, ref_rule in zip(proto.ALL_PROTO_RULES,
                                   jax_proto.ALL_PROTO_RULES):
        got = _findings(engine, tmp_path, source, port_rule())
        assert got == _findings(jax_engine, tmp_path, source, ref_rule())
        fired += len(got)
    if fixture.endswith("_BAD"):
        assert fired


def test_registry_matches_the_annotations():
    refs = proto.check_site_registry()
    assert sorted(refs) == sorted(s.name for s in proto.COMMIT_SITES)
    assert sorted(refs) == sorted(s.name for s in jax_proto.COMMIT_SITES)
    assert len(refs) == 13


def _rows(rows):
    return [{k: v for k, v in r.items() if k not in ("path", "line")}
            for r in rows]


def test_audit_validates_real_sites_like_the_reference():
    names = ("checkpoint.save", "profile.save")
    got, findings = proto.audit_commit_points(
        sites=[s for s in proto.COMMIT_SITES if s.name in names])
    want, ref_findings = jax_proto.audit_commit_points(
        sites=[s for s in jax_proto.COMMIT_SITES if s.name in names])
    assert findings == [] and ref_findings == []
    assert _rows(got) == _rows(want)
    assert all(r["commit_point_validated"] for r in got)
    assert {s["stage"] for s in got[0]["stages"]} == {BEFORE_RENAME,
                                                      AFTER_RENAME}


def _append_site(module, pkg):
    child = ref_fx._APPEND_CHILD.replace("from avenir_tpu.",
                                         f"from {pkg}.")
    return module.CommitSite("bad.append", "nowhere.py", ref_fx._append_run,
                             child_source=child)


def _no_hook_site(module):
    child = ('import os\nwith open(os.path.join(r"__ROOT__", "x.json"), '
             '"w") as fh:\n    fh.write(\'{"ok": true}\')\n')

    def run(root):
        with open(f"{root}/x.json", "w") as fh:
            fh.write('{"ok": true}')

    return module.CommitSite("no.hook", "nowhere.py", run,
                             child_source=child)


def test_audit_flags_the_references_bad_sites_as_it_does():
    got, findings = proto.audit_commit_points(
        sites=[_append_site(proto, "avenir_tpu_torch"),
               _no_hook_site(proto)])
    want, ref_findings = jax_proto.audit_commit_points(
        sites=[_append_site(jax_proto, "avenir_tpu"),
               _no_hook_site(jax_proto)])
    assert _rows(got) == _rows(want)
    assert [r["commit_point_validated"] for r in got] == [False, False]
    stages = {s["stage"]: s for s in got[0]["stages"]}
    assert stages[BEFORE_RENAME]["crashed"]
    assert not stages[BEFORE_RENAME]["byte_identical"]
    assert all(not s["crashed"] for s in got[1]["stages"])
    assert [(f.rule, f.scope, f.message) for f in findings] == \
        [(f.rule, f.scope, f.message) for f in ref_findings]
    assert "never reached" in findings[1].message

    def boom(root):
        raise ValueError("synthetic publish failure")

    with pytest.raises(proto.ProtoAuditError, match="boom.site"):
        proto.audit_commit_points(
            sites=[proto.CommitSite("boom.site", "nowhere.py", boom)])


def test_commit_point_findings_meet_the_allowlist_as_the_references(
        tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    out = []
    for module, eng, kw in ((proto, engine, {"device": "cpu"}),
                            (jax_proto, jax_engine, {})):
        report = module.run_proto(
            paths=[str(clean)], root=str(tmp_path),
            sites=[_no_hook_site(module)],
            baseline=[eng.BaselineEntry(
                f"nowhere.py::{module.PROTO_AUDIT_RULE}::no.hook",
                "an allowlisted commit point", 1)], **kw)
        out.append(([f.rule for f in report.findings],
                    [f.key for f in report.suppressed], report.clean))
    assert out[0] == out[1]
