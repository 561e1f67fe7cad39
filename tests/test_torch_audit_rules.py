"""The port's auditor rules, engine and small audits on the CPU, held
against the JAX package's where both have them:

- every bad and good fixture of the reference's rule corpora
  (`tests/test_graftlint.py`, `test_graftlint_flow.py`,
  `test_graftlint_merge.py`, `test_graftlint_mem.py`) gives the same
  (rule id, line, scope) findings under the port's rule as under the
  reference's, and torch's constructors count as numpy's do; the AST
  rules read torch's syncs, draws and placements;
- the port's own surface is clean under its allowlist for each tier's
  rules, and every allowlist entry is used;
- the allowlist's format errors and its stale entries;
- the flow auditor's negative cases (a layout drift, layouts that do not
  differ, a kernel that fails, the hook restored) and the coverage
  auditor's (a fold with no spans, an entry that fails);
- the footprint audit: every stream entry within its band, the
  reference's negative cases, the memory manifest's jobs equal to the
  reference's, the kernel rows from their shapes, `corpus_stats` equal
  to the reference's.
"""

import dataclasses
import os
import time

import numpy as np
import pytest

import test_graftlint as ref_ast
import test_graftlint_flow as ref_flow
import test_graftlint_mem as ref_mem
import test_graftlint_merge as ref_merge
import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.analysis import engine as jax_engine
from avenir_tpu.analysis import flow as jax_flow
from avenir_tpu.analysis import mem as jax_mem
from avenir_tpu.analysis import merge as jax_merge
from avenir_tpu.analysis import rules as jax_rules
from avenir_tpu_torch.analysis import (engine, flow, keys, mem, merge, proto,
                                       race, rules)
from avenir_tpu_torch.analysis.manifest import (StreamKernelSpec,
                                                stream_entries)
from avenir_tpu_torch.obs.coverage import SpanCoverageError, audit_entry
from test_torch_audit_entries import NAMES, _entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (reference test module, fixture stem, rule class name)
FIXTURES = [
    (ref_flow, "_QGET", "UnboundedQueueGetRule"),
    (ref_flow, "_THREAD", "UnjoinedThreadRule"),
    (ref_flow, "_SHARED", "SharedStateUnlockedRule"),
    (ref_flow, "_IO", "BlockingIoInFoldRule"),
    (ref_flow, "_ORDER", "OrderSensitiveFoldRule"),
    (ref_merge, "_MISSING", "MergeMissingOpRule"),
    (ref_merge, "_FLOAT", "MergeOrderSensitiveFloatRule"),
    (ref_merge, "_ALIAS", "MergeInplaceAliasedStateRule"),
    (ref_merge, "_SERIAL", "MergeUnserializableCarryRule"),
    (ref_mem, "_CARRY", "UnboundedCarryRule"),
    (ref_mem, "_TEMP", "CorpusScaledTemporaryRule"),
    (ref_mem, "_CACHE", "CacheSpillUnbudgetedRule"),
    (ref_mem, "_DTYPE", "DtypeExpansionAtParseRule"),
    (ref_ast, "_INT64", "DefaultInt64Rule"),
    (ref_ast, "_SYNC", "HostSyncInFoldRule"),
    (ref_ast, "_UNSEEDED", "UnseededStochasticTestRule"),
    (ref_ast, "_SHARDED", "ShardedHostMaterializeRule"),
]
_PORT = {"test_graftlint_flow": flow, "test_graftlint_merge": merge,
         "test_graftlint_mem": mem, "test_graftlint": rules}
_REF = {"test_graftlint_flow": jax_flow, "test_graftlint_merge": jax_merge,
        "test_graftlint_mem": jax_mem, "test_graftlint": jax_rules}


def _lint(eng, tmp_path, source, rule):
    p = tmp_path / "snippet.py"
    p.write_text(source)
    report = eng.run_paths([str(p)], rules=[rule], baseline=[],
                           root=str(tmp_path))
    assert not report.errors
    return [(f.rule, f.line, f.scope) for f in report.findings]


@pytest.mark.parametrize("module,stem,rule", FIXTURES,
                         ids=[f"{r}{s}" for _m, s, r in FIXTURES])
@pytest.mark.parametrize("kind", ["_BAD", "_GOOD"])
def test_rule_fixture_matches_the_reference(tmp_path, module, stem, rule,
                                            kind):
    source = getattr(module, stem + kind)
    got = _lint(engine, tmp_path, source,
                getattr(_PORT[module.__name__], rule)())
    want = _lint(jax_engine, tmp_path, source,
                 getattr(_REF[module.__name__], rule)())
    assert got == want
    assert bool(got) == (kind == "_BAD")


_TORCH_ORDER = """
import torch
from avenir_tpu_torch.core.stream import prefetched

def fold(chunks):
    acc = torch.zeros(3, 4)            # positional sizes: float32
    exact = torch.zeros(4, dtype=torch.int64)
    for c in prefetched(chunks):
        acc += c.float().mean(dim=0)   # fires
        exact += c.sum(dim=0)          # integer: silent
    return acc, exact
"""

_TORCH_TEMP = """
import torch
from avenir_tpu_torch.core.stream import prefetched

def collect(chunks):
    parts = []
    for c in prefetched(chunks):
        parts.append(c)
    return torch.cat(parts)            # the whole stream as one tensor
"""


def test_rules_read_torch_constructors(tmp_path):
    got = _lint(engine, tmp_path, _TORCH_ORDER,
                flow.OrderSensitiveFoldRule())
    assert [(r, line) for r, line, _s in got] == \
        [("flow-order-sensitive-fold", 9)]
    got = _lint(engine, tmp_path, _TORCH_TEMP,
                mem.CorpusScaledTemporaryRule())
    assert [(r, line) for r, line, _s in got] == \
        [("mem-corpus-scaled-temporary", 9)]


#: torch's forms of the AST rules' hazards, with the lines that fire
_TORCH_SYNC = """
import numpy as np
import torch
from avenir_tpu_torch.ops import sequence_kernels
from avenir_tpu_torch.ops.cluster_kernels import centre_sums

@torch.compile
def step(x):
    return x.sum()

def fold(chunks, acc):
    for c in chunks:
        acc += c.sum().cpu()                               # 13
        rows = c.tolist()                                  # 14
        torch.cuda.synchronize()                           # 15
        n = int(sequence_kernels.subseq_support_fold(acc, c, c, c, 3))  # 16
        m = np.asarray(centre_sums(c, c, 3))               # 17
        t = float(step(c))                                 # 18
        s = float(c.sum())                                 # a host tensor
        acc = acc + c.to(torch.float32)                    # stays put
    return acc.cpu(), rows, n, m, t, s                     # once, after
"""

_TORCH_UNSEEDED = """
import torch

def test_global_draws():
    x = torch.rand(10)                                     # 5
    i = torch.randint(0, 9, (4,))                          # 6
    assert x.max() < 1 and i.min() >= 0

def test_pinned_draws():
    g = torch.Generator().manual_seed(7)
    x = torch.randn(10, generator=g)
    assert x.shape == (10,)

def helper():
    return torch.rand(3)                                   # no assert
"""

_TORCH_SHARDED = """
import numpy as np
from avenir_tpu_torch.parallel.mesh import replicated, shard_rows

def gather(mesh, x):
    xs = shard_rows(mesh, x)
    w = replicated(mesh, x)
    a = xs.cpu()                                           # 8
    b = np.asarray(w)                                      # 9
    c = shard_rows(mesh, np.asarray(x))                    # feeds it
    return a, b, c, x.cpu()                                # x is not placed
"""


@pytest.mark.parametrize("source,rule,lines", [
    (_TORCH_SYNC, "HostSyncInFoldRule", [13, 14, 15, 16, 17, 18]),
    (_TORCH_UNSEEDED, "UnseededStochasticTestRule", [5, 6]),
    (_TORCH_SHARDED, "ShardedHostMaterializeRule", [8, 9]),
], ids=["sync", "unseeded", "sharded"])
def test_ast_rules_read_torch(tmp_path, source, rule, lines):
    got = _lint(engine, tmp_path, source, getattr(rules, rule)())
    assert sorted(line for _r, line, _s in got) == lines


def test_ast_rules_not_ported_are_named():
    """Four of the reference's eight AST rules are ported; the module's
    docstring names the other four, which have no torch counterpart."""
    ported = set(rules.rule_ids())
    assert ported == {"default-int64", "host-sync-in-fold",
                      "unseeded-stochastic-test", "sharded-host-materialize"}
    rest = set(jax_rules.rule_ids()) - ported
    assert rest == {"recompile-hazard", "tracer-leak",
                    "int64-literal-in-jnp", "fold-undonated-carry"}
    assert all(f"`{r}`" in rules.__doc__ for r in rest)


@pytest.mark.parametrize("tier", ["flow", "mem", "merge", "rules", "keys",
                                  "proto", "race"])
def test_the_port_is_clean_under_its_allowlist(tier):
    run = {"flow": flow.run_flow, "mem": mem.run_mem,
           "merge": merge.run_merge, "keys": keys.run_keys,
           "proto": proto.run_proto, "race": race.run_race}.get(tier)
    baseline = engine.load_baseline()
    if run is None:
        report = rules.run_rules([os.path.join(REPO, "avenir_tpu_torch")],
                                 baseline=baseline, root=REPO)
    else:
        report = run(baseline=baseline, root=REPO, audit=False)
    assert not report.errors and not report.findings, \
        [f.render() for f in report.findings]
    assert not report.stale
    ids = {"flow": flow.flow_rule_ids(), "mem": mem.mem_rule_ids(),
           "merge": merge.merge_rule_ids(), "rules": rules.rule_ids(),
           "keys": keys.keys_rule_ids(), "proto": proto.proto_rule_ids(),
           "race": race.race_rule_ids()}[tier]
    used = [e for e in baseline if e.key.split("::")[1] in ids]
    assert all(e.used for e in used)


def test_allowlist_format_errors(tmp_path):
    bad = tmp_path / "bad.txt"
    bad.write_text("a.py::flow-unjoined-thread::f\n")
    with pytest.raises(ValueError, match="justification"):
        engine.load_baseline(str(bad))
    bad.write_text("a.py::f -- why\n")
    with pytest.raises(ValueError, match="path::rule::scope"):
        engine.load_baseline(str(bad))
    assert engine.load_baseline(str(tmp_path / "missing.txt")) == []


def test_flow_findings_roundtrip_through_the_allowlist(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text(ref_flow._SHARED_BAD)
    key = "mod.py::flow-shared-state-unlocked::Stream.step"
    report = flow.run_flow(paths=[str(p)], baseline=[
        engine.BaselineEntry(key, "fixture", 1)], root=str(tmp_path),
        audit=False)
    assert not report.findings and len(report.suppressed) == 2
    p.write_text(ref_flow._SHARED_GOOD)
    report = flow.run_flow(paths=[str(p)], baseline=[
        engine.BaselineEntry(key, "fixture", 1)], root=str(tmp_path),
        audit=False)
    assert [e.key for e in report.stale] == [key]


# ------------------------------------------------------- the flow auditor
def _block_file(ctx):
    path = os.path.join(ctx["dir"], "rows.txt")
    if not os.path.exists(path):
        with open(path, "w") as fh:
            fh.write("".join(f"{i}\n" for i in range(400)))
    return path


def _toy(run, name="toy_kernel", layouts=(64.0, 0.001, 0.0002)):
    return StreamKernelSpec(name, "toy.py", 1, lambda d: {"dir": d}, run,
                            layouts=tuple(layouts), device="cpu")


def _blocks(ctx, block_mb):
    from avenir_tpu_torch.core.stream import iter_byte_blocks, prefetched

    return list(prefetched(iter_byte_blocks(
        _block_file(ctx), max(int(block_mb * (1 << 20)), 16)), depth=1))


def test_flow_auditor_validates_an_invariant_kernel():
    def run(ctx, block_mb):
        return str(sum(int(x) for b in _blocks(ctx, block_mb)
                       for x in b.split())).encode()

    row, finding = flow.audit_stream(_toy(run))
    assert row["invariance_validated"] is True and finding is None
    assert len(set(row["chunk_counts"])) == 3


def test_flow_auditor_catches_layout_drift():
    def run(ctx, block_mb):
        return str(len(_blocks(ctx, block_mb))).encode()

    row, finding = flow.audit_stream(_toy(run, name="drifty"))
    assert row["invariance_validated"] is False
    assert finding is not None and finding.rule == flow.FLOW_AUDIT_RULE
    assert finding.scope == "drifty" and "drift" in finding.message


def test_flow_auditor_requires_layouts_to_differ():
    row, finding = flow.audit_stream(_toy(lambda c, m: b"constant",
                                          name="vacuous"))
    assert row["chunk_counts"] == [0, 0, 0]
    assert row["invariance_validated"] is False
    assert finding is not None and "did not differ" in finding.message


def test_flow_auditor_wraps_kernel_failures():
    def run(ctx, block_mb):
        raise ValueError("synthetic kernel failure")

    with pytest.raises(flow.FlowAuditError, match="boomkern"):
        flow.audit_stream(_toy(run, name="boomkern"))


def test_flow_auditor_restores_the_stream_hook():
    from avenir_tpu_torch.core import stream

    def run(ctx, block_mb):
        assert stream._produce_hook is not None
        return b"ok"

    before = stream._produce_hook
    flow.audit_stream(_toy(run, name="hooky"))
    assert stream._produce_hook is before


# --------------------------------------------------- the coverage auditor
def test_coverage_fails_a_fold_without_spans():
    def blind_run(ctx, layout_mb):
        return bytes(sum(len(c) for c in (b"a,b\n" * 10, b"c,d\n" * 10)))

    row = audit_entry(_toy(blind_run, name="fake_stream", layouts=(0.01,)))
    assert not row["span_coverage_validated"]
    assert set(row["missing"]) == {"stream.read", "stream.parse",
                                   "stream.fold", "job.finish"}


def test_coverage_broken_entry_raises():
    def broken_run(ctx, layout_mb):
        raise OSError("corpus went missing")

    with pytest.raises(SpanCoverageError, match="failed to run"):
        audit_entry(_toy(broken_run, name="fake_stream", layouts=(0.01,)))


# ----------------------------------------------------- the footprint audit
@pytest.mark.parametrize("name", NAMES)
def test_footprint_audit_holds_every_entry(name):
    spec = _entry(stream_entries("cpu"), name)
    row, finding = mem.audit_footprint(spec)
    assert finding is None, row
    assert row["footprint_model_validated"] is True
    assert row["jobs"] == list(spec.jobs)
    assert [r["block_mb"] for r in row["runs"]] == \
        list(mem.DEFAULT_AUDIT_BLOCKS_MB)
    for run in row["runs"]:
        assert 0 < run["observed_max_block_bytes"] <= \
            int(run["block_mb"] * (1 << 20)) + 65536
        assert run["predicted_bytes"] == sum(run["terms"].values())


def _quiet_run(ctx, block_mb):
    from avenir_tpu_torch.core.stream import iter_byte_blocks, prefetched

    return sum(len(b) for b in prefetched(iter_byte_blocks(
        ctx["csv"], max(int(block_mb * (1 << 20)), 64)), depth=1))


def _mem_toy(run, name="toy_job"):
    def prepare(workdir):
        csv = os.path.join(workdir, "toy.csv")
        with open(csv, "w") as fh:
            fh.write("id,a,b\n" * 2000)
        return {"dir": workdir, "csv": csv}

    return StreamKernelSpec(name, "toy.py", 1, prepare, run,
                            jobs=("bayesianDistr",), device="cpu")


def test_footprint_auditor_catches_a_vacuous_model():
    row, finding = mem.audit_footprint(
        _mem_toy(_quiet_run, name="vacuous_model"),
        model_fn=lambda bb: mem.FootprintEstimate("toy", bb,
                                                  {"nonsense": 4 << 30}))
    assert row["footprint_model_validated"] is False
    assert finding is not None and finding.rule == mem.MEM_AUDIT_RULE
    assert finding.scope == "vacuous_model"


def test_footprint_auditor_catches_an_underpredicting_model():
    def hungry_run(ctx, block_mb):
        _quiet_run(ctx, block_mb)
        ball = np.ones((mem.AUDIT_SLACK_BYTES + (32 << 20)) // 8, np.float64)
        time.sleep(0.08)
        return float(ball[0])

    row, finding = mem.audit_footprint(
        _mem_toy(hungry_run, name="underpredicted"),
        model_fn=lambda bb: mem.FootprintEstimate("toy", bb,
                                                  {"tiny": 1 << 20}))
    assert row["footprint_model_validated"] is False
    assert finding is not None and finding.rule == mem.MEM_AUDIT_RULE


def test_footprint_auditor_errors():
    def run(ctx, block_mb):
        raise ValueError("synthetic job failure")

    with pytest.raises(mem.MemAuditError, match="boomjob"):
        mem.audit_footprint(_mem_toy(run, name="boomjob"))
    with pytest.raises(mem.MemAuditError, match=">= 2 block sizes"):
        mem.audit_footprint(_mem_toy(_quiet_run), block_sizes_mb=[0.5])
    with pytest.raises(mem.MemAuditError, match="names no runner jobs"):
        mem.audit_footprint(dataclasses.replace(_mem_toy(_quiet_run),
                                                jobs=()))


def test_memory_manifest_jobs_equal_the_reference():
    got = mem.memory_manifest(include_kernels=False)
    want = jax_mem.memory_manifest(include_kernels=False)
    assert got["jobs"] == want["jobs"]
    assert got["tolerance"] == want["tolerance"]
    assert "kernels" not in got


def test_kernel_rows_from_their_shapes():
    rows = mem.kernel_device_entries("cpu")
    assert [r["kernel"] for r in rows] == [
        "knn_topk", "knn_topk_packed", "knn_topk_lanes",
        "knn_classify_lanes", "knn_partial_mma", "knn_prepass",
        "matmul_ceiling", "subseq_support", "centre_sums",
        "metropolis_walk"]
    for r in rows:
        assert r["source"] == "shapes" and r["temp_bytes"] is None
        assert os.path.exists(os.path.join(REPO, r["path"]))
        assert r["argument_bytes"] > 0
        assert r["peak_live_bytes"] == r["argument_bytes"] + \
            r["output_bytes"]
    by = {r["kernel"]: r for r in rows}
    assert by["knn_topk"]["argument_bytes"] == (256 + 8192) * 6 * 4
    assert by["knn_topk"]["output_bytes"] == 256 * 5 * 8
    # the support count adds into its argument: no new output
    assert by["subseq_support"]["output_bytes"] == 0


def test_corpus_stats_equal_the_reference_and_follow_the_file(tmp_path):
    rng = np.random.default_rng(3)
    p = tmp_path / "c.csv"
    p.write_text("".join(f"r{i}, t{rng.integers(0, 9000)} ,x{i % 7}\r\n"
                         for i in range(12000)))
    assert mem.corpus_stats([str(p)]).to_json() == \
        jax_mem.corpus_stats([str(p)]).to_json()
    assert mem.corpus_stats([str(p)]).distinct_tokens == 4096
    with open(p, "a") as fh:
        fh.write("r, only ,x\n")
    grown = mem.corpus_stats([str(p)])
    assert grown.to_json() == jax_mem.corpus_stats([str(p)]).to_json()
    assert grown.total_bytes == os.path.getsize(p)
