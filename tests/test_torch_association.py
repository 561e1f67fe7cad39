"""The port's association-mining path against the JAX package on the CPU.

`frequentItemsApriori` in RAM, streamed through the native encoder and
streamed through the Python rows (the native encoder switched off), each
writes `itemsets-<k>.txt` byte-identical to the JAX package's in-RAM and
streamed runs, for lengths 1-4, several thresholds, with and without the
infrequent-item marker and `fia.emit.trans.id`, on corpora with the
awkward rows: a row of only an id, a trailing delimiter, the marker
token, CRLF endings, padded tokens, an item repeated in one transaction,
blank and delimiter-only lines. Then the merge algebra
(`mine_stream_merged` over shards, an item frequent in one shard only),
fold checkpoints (the JAX package's `serialize_state` loaded into the
port's fold), `associationRuleMiner` (over the port's and the JAX
package's itemset files), `infrequentItemMarker`, `association_pipeline`,
`run_shared` on the bytes kind, and the tutorial's data.
"""

import functools
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.models.association import (
    FrequentItemsApriori as JaxApriori,
    StreamingTransactionSource as JaxSource)
from avenir_tpu.pipelines import association_pipeline as jax_assoc_pipeline
from avenir_tpu.runner import JobConfig as JaxJobConfig
from avenir_tpu.runner import run_job as jax_run_job
from avenir_tpu.runner import stream_fold_ops as jax_stream_fold_ops
from avenir_tpu_torch import obs
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.stream import stream_job_byte_blocks
from avenir_tpu_torch.models import association
from avenir_tpu_torch.models.association import (
    FrequentItemsApriori, ItemSetList, StreamingTransactionSource)
from avenir_tpu_torch.native import ingest
from avenir_tpu_torch.pipelines import association_pipeline
from avenir_tpu_torch.runner import (job_names, run_job, run_shared,
                                     stream_fold_names, stream_fold_ops)
from avenir_tpu_torch.tools.bench import apriori_picks

CPU = "cpu"
ROUTES = ("ram", "native", "python")

AWKWARD = [
    "Tonly",                        # an id and no item
    "Ttrail,i1,i2,",                # a trailing delimiter
    "Tmark,i1,*,i2,*",              # the marker token
    " Tpad , i1 ,\ti3\t, i2 ",      # padded tokens
    "Trep,i2,i2,i1,i2",             # an item repeated in one transaction
    ",,,",                          # a line of delimiters
    "Tstar,*,*",                    # only the marker
]


def _lines(n: int, seed: int):
    """n seeded baskets (the bench's distribution), every 20th with the
    marker token `*` too (frequent unless the marker is set), and the
    awkward rows."""
    picks = apriori_picks(n, seed)
    out = [",".join([f"T{r}"] + [f"i{j}" for j in row]
                    + (["*"] if r % 20 == 0 else []))
           for r, row in enumerate(picks)]
    for i, ln in enumerate(AWKWARD):        # spread through the corpus
        out.insert((i * 7919) % len(out), ln)
    out.insert(n // 2, "")
    out.insert(n // 3, "   \t ")
    return out


def _corpus(path: Path, n: int = 1500, seed: int = 2,
            crlf: bool = False) -> str:
    end = "\r\n" if crlf else "\n"
    path.write_text(end.join(_lines(n, seed)) + end)
    return str(path)


def _files(outputs):
    return {os.path.basename(p): Path(p).read_bytes() for p in outputs}


def _props(threshold, length, emit=False, marker=None, block=None):
    p = {"fia.support.threshold": str(threshold),
         "fia.item.set.length": str(length),
         "fia.emit.trans.id": "true" if emit else "false"}
    if marker is not None:
        p["fia.infreq.item.marker"] = marker
    if block is not None:
        p["fia.stream.block.size.mb"] = str(block)
    return p


#: (threshold, length, emit.trans.id, marker, CRLF)
CONFIGS = [(0.02, 3, False, None, False), (0.02, 4, False, "*", True),
           (0.05, 4, True, None, False), (0.1, 2, True, "*", True),
           (0.3, 3, False, None, False)]


def _cid(config) -> str:
    return "-".join(map(str, config))


@functools.lru_cache(maxsize=None)
def _jax_outputs(root: str, config) -> dict:
    """The JAX package's files of one config, in RAM and streamed (which
    must agree)."""
    threshold, length, emit, marker, crlf = config
    d = Path(root)
    d.mkdir(parents=True, exist_ok=True)
    csv = _corpus(d / "x.csv", crlf=crlf)
    ram = jax_run_job("frequentItemsApriori",
                      _props(threshold, length, emit, marker), [csv],
                      str(d / "ram"))
    streamed = jax_run_job("frequentItemsApriori",
                           _props(threshold, length, emit, marker, 0.01),
                           [csv], str(d / "streamed"))
    assert _files(ram.outputs) == _files(streamed.outputs)
    return {"files": _files(ram.outputs), "csv": csv,
            "records": ram.counters["Basic:Records"],
            "max_length": ram.counters["Apriori:MaxLength"]}


@pytest.fixture(scope="module")
def jax_root(tmp_path_factory):
    return tmp_path_factory.mktemp("jax_apriori")


def _port_apriori(monkeypatch, route, props, inputs, out):
    """The port's job on the CPU through one route."""
    if route == "python":
        monkeypatch.setattr(ingest, "native_seq_ready", lambda delim: False)
    if route != "ram":
        # the sidecar off: pass 1 parses with the route's engine
        props = {**props, "fia.stream.block.size.mb": "0.01",
                 "fia.stream.sidecar": "false"}
    with obs.capture() as rec:
        res = run_job("frequentItemsApriori", props, inputs, out, device=CPU)
    monkeypatch.undo()
    engines = {sp.attrs["engine"] for sp in rec.spans()
               if sp.name == "stream.parse"}
    want = {"ram": {"python"}, "python": {"python"},
            "native": {"native", "python"}}[route]
    # the native route's id pass reads the Python rows
    assert engines <= want and engines, (route, engines)
    return res


# ------------------------------------------------------------- the routes
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("config", CONFIGS, ids=_cid)
def test_itemsets_byte_identical_to_jax(tmp_path, jax_root, monkeypatch,
                                        route, config):
    want = _jax_outputs(str(jax_root / _cid(config)), config)
    threshold, length, emit, marker, _crlf = config
    res = _port_apriori(monkeypatch, route,
                        _props(threshold, length, emit, marker),
                        [want["csv"]], str(tmp_path / "out"))
    assert _files(res.outputs) == want["files"]
    assert res.counters["Apriori:MaxLength"] == want["max_length"]
    assert res.counters["Basic:Records"] == want["records"]
    assert res.counters["Basic:RowsPerSec"] > 0


def test_the_corpora_reach_length_four_and_the_marker(jax_root):
    """The configs are not trivial: sets of length 4, the marker counted
    as an item when no marker is set and dropped when it is, and the
    padded id trimmed in the id lists."""
    out = {c: _jax_outputs(str(jax_root / _cid(c)), c)["files"]
           for c in CONFIGS}
    assert out[CONFIGS[1]]["itemsets-4.txt"]
    assert (b"\n" + out[CONFIGS[0]]["itemsets-1.txt"]).count(b"\n*,") == 1
    assert b"*" not in out[CONFIGS[1]]["itemsets-1.txt"]
    assert b",Tpad" in out[CONFIGS[2]]["itemsets-1.txt"]


def test_a_count_at_the_threshold_drops(tmp_path, monkeypatch):
    """min_count = threshold * n: a count equal to it drops, one above it
    stays (n = 100, threshold 0.05: `a` in 5 rows drops, `b` in 6
    stays)."""
    rows = [f"T{r},{'a,' if r < 5 else ''}{'b,' if r < 6 else ''}c"
            for r in range(100)]
    csv = tmp_path / "t.csv"
    csv.write_text("\n".join(rows) + "\n")
    want = _files(jax_run_job("frequentItemsApriori", _props(0.05, 2),
                              [str(csv)], str(tmp_path / "jax")).outputs)
    assert want["itemsets-1.txt"] == b"b,0.060000\nc,1.000000\n"
    for route in ROUTES:
        res = _port_apriori(monkeypatch, route, _props(0.05, 2), [str(csv)],
                            str(tmp_path / route))
        assert _files(res.outputs) == want, route


@pytest.mark.parametrize("route", ROUTES)
def test_trans_ids_on_long_lines(tmp_path, monkeypatch, route):
    """A frequent item lists most rows: its id line is long; ids in row
    order."""
    csv = _corpus(tmp_path / "x.csv", n=4000, seed=9)
    want = _files(jax_run_job("frequentItemsApriori", _props(0.02, 3, True),
                              [csv], str(tmp_path / "jax")).outputs)
    res = _port_apriori(monkeypatch, route, _props(0.02, 3, True), [csv],
                        str(tmp_path / "port"))
    got = _files(res.outputs)
    assert got == want
    longest = max(got["itemsets-1.txt"].splitlines(), key=len).split(b",")
    assert len(longest) > 1000
    ids = [int(t[1:]) for t in longest[2:] if t[1:].isdigit()]
    assert ids == sorted(ids)


# ---------------------------------------------------------- merge algebra
def _shards(tmp_path, parts):
    """The corpus cut into `parts` shard files at line boundaries; `zz`
    is in every row of the first shard only (frequent there, and overall
    by the global count)."""
    lines = _lines(1200, 5)
    cut = len(lines) // parts
    paths = []
    for p in range(parts):
        chunk = lines[p * cut:(p + 1) * cut if p < parts - 1 else None]
        if p == 0:
            chunk = [ln + ",zz" if ln.strip() else ln for ln in chunk]
        path = tmp_path / f"shard{p}.csv"
        path.write_text("\n".join(chunk) + "\n")
        paths.append(str(path))
    whole = tmp_path / "whole.csv"
    whole.write_text("".join(Path(p).read_text() for p in paths))
    return paths, str(whole)


def _lines_of(levels):
    return [[s.line() for s in isl.item_sets] for isl in levels]


@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("emit", [False, True])
def test_mine_stream_merged_equals_one_scan_and_jax(tmp_path, parts, emit):
    paths, whole = _shards(tmp_path, parts)
    kw = dict(support_threshold=0.03, max_length=3, emit_trans_id=emit)
    block = 2 << 10
    merged = FrequentItemsApriori(**kw, device=CPU).mine_stream_merged(
        [StreamingTransactionSource([p], block_bytes=block) for p in paths])
    one = FrequentItemsApriori(**kw, device=CPU).mine_stream(
        StreamingTransactionSource([whole], block_bytes=block))
    jax = JaxApriori(**kw).mine_stream_merged(
        [JaxSource([p], block_bytes=block, spill_cache=False)
         for p in paths])
    assert _lines_of(merged) == _lines_of(one) == _lines_of(jax)
    assert any("zz" in s.items for isl in merged for s in isl.item_sets)


def test_merge_support_counts_and_frequent_tokens():
    merged = association.merge_support_counts(
        {"a": 3, ("a", "b"): 2}, {"a": np.int32(2**31 - 1), "c": 1}, {})
    assert merged == {"a": 2**31 + 2, ("a", "b"): 2, "c": 1}
    assert association.frequent_tokens({"b": 5, "a": 5, "c": 4}, 4.0) == \
        ["a", "b"]


# ------------------------------------------------------------ fold state
FIA_BLOCK = {"fia.support.threshold": "0.03", "fia.item.set.length": "3",
             "fia.stream.block.size.mb": "0.004"}


def _blocks(csv):
    return list(stream_job_byte_blocks(JobConfig(FIA_BLOCK, "fia"), [csv]))


def test_jax_fold_checkpoint_finishes_in_the_port(tmp_path):
    """A JAX fold checkpointed half-way through pass 1 loads into the
    port's fold, which finishes to the JAX package's bytes."""
    csv = _corpus(tmp_path / "x.csv", n=2500, seed=3)
    blocks = _blocks(csv)
    assert len(blocks) >= 4
    jax_ops = jax_stream_fold_ops("frequentItemsApriori")
    jcfg = JaxJobConfig(FIA_BLOCK, "fia")
    jfold = jax_ops.factory(jcfg, [csv])
    for b in blocks[:len(blocks) // 2]:
        jfold.consume(b)
    blob = jax_ops.serialize_state(jfold)
    ops = stream_fold_ops("apriori")
    assert ops.kind == "bytes"
    fold = ops.restore_state(JobConfig(FIA_BLOCK, "fia"), [csv], blob,
                             device=CPU)
    for b in blocks[len(blocks) // 2:]:
        fold.consume(b)
    got = _files(fold.finish(str(tmp_path / "port")).outputs)
    want = _files(jax_run_job("frequentItemsApriori", FIA_BLOCK, [csv],
                              str(tmp_path / "jax")).outputs)
    assert got == want
    # and a port checkpoint, taken at the same point, loads into the port
    fold2 = ops.factory(JobConfig(FIA_BLOCK, "fia"), [csv], None,
                        torch.device(CPU))
    for b in blocks[:len(blocks) // 2]:
        fold2.consume(b)
    again = ops.restore_state(JobConfig(FIA_BLOCK, "fia"), [csv],
                              ops.serialize_state(fold2), device=CPU)
    for b in blocks[len(blocks) // 2:]:
        again.consume(b)
    assert _files(again.finish(str(tmp_path / "port2")).outputs) == want


def test_merged_shard_folds_equal_the_whole_file(tmp_path):
    paths, whole = _shards(tmp_path, 2)
    ops = stream_fold_ops("frequentItemsApriori")
    cfg = JobConfig(FIA_BLOCK, "fia")
    folds = []
    for p in paths:
        f = ops.factory(cfg, [p], None, torch.device(CPU))
        for b in _blocks(p):
            f.consume(b)
        folds.append(f)
    merged = ops.merge_states(folds[0], folds[1])
    got = merged.finish(str(tmp_path / "merged"))
    want = run_job("frequentItemsApriori", FIA_BLOCK, [whole],
                   str(tmp_path / "whole"), device=CPU)
    assert _files(got.outputs) == _files(want.outputs)
    assert got.counters["Basic:Records"] == want.counters["Basic:Records"]
    with pytest.raises(ValueError, match="before merging"):
        ops.serialize_state(merged)


def test_fold_refuses_another_jobs_checkpoint(tmp_path):
    import io
    import json

    csv = _corpus(tmp_path / "x.csv", n=200)
    buf = io.BytesIO()
    np.savez(buf, meta=np.array(json.dumps(
        {"job": "candidateGenerationWithSelfJoin", "vocab": [], "n": 0,
         "sealed": False, "t_max": 1})), counts=np.zeros(0, np.int64))
    with pytest.raises(ValueError, match="candidateGenerationWithSelfJoin"):
        stream_fold_ops("frequentItemsApriori").restore_state(
            JobConfig(FIA_BLOCK, "fia"), [csv], buf.getvalue(), device=CPU)


# -------------------------------------------------------- rules and marker
RULES = [{"arm.conf.threshold": "0.5"},
         {"arm.conf.threshold": "0.1", "arm.max.ante.size": "1"},
         {"arm.conf.threshold": "0.0", "arm.max.ante.size": "2"}]


@pytest.mark.parametrize("rules", RULES, ids=["conf0.5", "ante1", "ante2"])
def test_rules_byte_identical_on_both_packages_files(tmp_path, rules):
    csv = _corpus(tmp_path / "x.csv", n=2000, seed=4)
    props = {**_props(0.02, 3), **rules}
    jax_sets = jax_run_job("frequentItemsApriori", props, [csv],
                           str(tmp_path / "jax_sets"))
    port_sets = run_job("frequentItemsApriori", props, [csv],
                        str(tmp_path / "port_sets"), device=CPU)
    want = jax_run_job("associationRuleMiner", props, jax_sets.outputs,
                       str(tmp_path / "jax_rules.txt"))
    text = Path(want.outputs[0]).read_bytes()
    assert want.counters["Rules:Count"] > 0
    for sets, name in ((jax_sets, "from_jax"), (port_sets, "from_port")):
        got = run_job("associationRuleMiner", props, sets.outputs,
                      str(tmp_path / f"{name}.txt"), device=CPU)
        assert Path(got.outputs[0]).read_bytes() == text, name
        assert got.counters == want.counters


@pytest.mark.parametrize("emit", [False, True])
def test_infrequent_item_marker_byte_identical(tmp_path, emit):
    csv = _corpus(tmp_path / "x.csv", n=1000, seed=6, crlf=emit)
    sets = jax_run_job("frequentItemsApriori", _props(0.05, 1, emit), [csv],
                       str(tmp_path / "sets"))
    props = {"iim.item.set.file.path": sets.outputs[0],
             "iim.contains.trans.id": "true" if emit else "false",
             "iim.infreq.item.marker": "#"}
    want = jax_run_job("infrequentItemMarker", props, [csv],
                       str(tmp_path / "jax.txt"))
    got = run_job("infrequentItemMarker", props, [csv],
                  str(tmp_path / "port.txt"), device=CPU)
    assert Path(got.outputs[0]).read_bytes() == \
        Path(want.outputs[0]).read_bytes()
    assert got.counters == want.counters
    assert got.counters["Marker:Replaced"] > 0
    with pytest.raises(ValueError, match="length 1"):
        run_job("infrequentItemMarker",
                {**props, "iim.item.set.length": "2"}, [csv],
                str(tmp_path / "bad.txt"), device=CPU)


def test_marked_corpus_mines_as_the_unmarked_one(tmp_path, monkeypatch):
    """Apriori over the marker job's output, with the marker set, finds
    the itemsets of the unmarked corpus."""
    csv = _corpus(tmp_path / "x.csv", n=1500, seed=8)
    plain = run_job("frequentItemsApriori", _props(0.04, 3, marker="*"),
                    [csv],
                    str(tmp_path / "plain"), device=CPU)
    marked = run_job("infrequentItemMarker",
                     {"iim.item.set.file.path": plain.outputs[0],
                      "iim.contains.trans.id": "false"}, [csv],
                     str(tmp_path / "marked.csv"), device=CPU)
    for route in ROUTES:
        res = _port_apriori(monkeypatch, route, _props(0.04, 3, marker="*"),
                            marked.outputs, str(tmp_path / route))
        assert _files(res.outputs) == _files(plain.outputs), route


# -------------------------------------------- pipeline, shared scan, jobs
def test_association_pipeline_chains_and_equals_jax(tmp_path):
    csv = _corpus(tmp_path / "x.csv", n=1500, seed=10)
    props = {**_props(0.03, 3), "arm.conf.threshold": "0.4"}
    jax = jax_assoc_pipeline(props, csv, str(tmp_path / "jax")).run()
    pipe = association_pipeline(props, csv, str(tmp_path / "port"),
                                device=CPU)
    with pytest.raises(RuntimeError, match="apriori stage first"):
        pipe.run(only="rules")
    first = pipe.run(only="apriori")
    assert set(first) == {"apriori"}
    res = pipe.run(only="rules")
    assert set(res) == {"apriori", "rules"}
    assert pipe.stages[1].inputs == res["apriori"].outputs
    for stage in ("apriori", "rules"):
        assert _files(res[stage].outputs) == _files(jax[stage].outputs)
    whole = association_pipeline(props, csv, str(tmp_path / "again"),
                                 device=CPU).run()
    assert _files(whole["rules"].outputs) == _files(jax["rules"].outputs)


def test_run_shared_bytes_kind_equals_run_job(tmp_path):
    csv = _corpus(tmp_path / "x.csv", n=2000, seed=12)
    props = _props(0.03, 3, block=0.004)
    assert "frequentItemsApriori" in stream_fold_names()
    with obs.capture() as rec:
        shared = run_shared([("apriori", props, str(tmp_path / "shared"))],
                            [csv], device=CPU)
    solo = run_job("frequentItemsApriori", props, [csv],
                   str(tmp_path / "solo"), device=CPU)
    assert set(shared) == {"frequentItemsApriori"}
    got = shared["frequentItemsApriori"]
    assert _files(got.outputs) == _files(solo.outputs)
    assert got.counters["Basic:Records"] == solo.counters["Basic:Records"]
    assert got.counters["Apriori:MaxLength"] == \
        solo.counters["Apriori:MaxLength"]
    sinks = {(sp.name, sp.attrs.get("sink")) for sp in rec.spans()}
    assert {("stream.parse", "StreamingTransactionSource"),
            ("stream.fold", "apriori_support"),
            ("stream.fold", "frequentItemsApriori")} <= sinks
    assert any(sp.name == "job.dispatch" for sp in rec.spans())


def test_run_shared_refuses_mixed_scan_kinds(tmp_path):
    csv = _corpus(tmp_path / "x.csv", n=100)
    with pytest.raises(ValueError, match="mixed scan kinds"):
        run_shared([("frequentItemsApriori", _props(0.1, 2),
                     str(tmp_path / "a")),
                    ("bayesianDistr", {}, str(tmp_path / "b"))],
                   [csv], device=CPU)


def test_jobs_are_registered_and_want_a_card(tmp_path, monkeypatch):
    names = set(job_names())
    assert {"frequentItemsApriori", "apriori",
            "org.avenir.association.FrequentItemsApriori",
            "associationRuleMiner",
            "org.avenir.association.AssociationRuleMiner",
            "infrequentItemMarker",
            "org.avenir.association.InfrequentItemMarker"} <= names
    csv = _corpus(tmp_path / "x.csv", n=100)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_job("apriori", _props(0.1, 2), [csv], str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        association_pipeline(_props(0.1, 2), csv, str(tmp_path / "p"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FrequentItemsApriori(0.1)


def test_streamed_run_spans(tmp_path):
    csv = _corpus(tmp_path / "x.csv", n=1500)
    with obs.capture() as rec:
        run_job("frequentItemsApriori", _props(0.03, 3, block=0.004), [csv],
                str(tmp_path / "o"), device=CPU)
    names = {(sp.name, sp.attrs.get("sink")) for sp in rec.spans()}
    assert {("job.run", None), ("stream.read", None),
            ("stream.parse", "StreamingTransactionSource"),
            ("stream.fold", "apriori_support"), ("job.finish", None)} <= names
    with obs.capture() as rec:
        run_job("frequentItemsApriori", _props(0.03, 3), [csv],
                str(tmp_path / "r"), device=CPU)
    names = {(sp.name, sp.attrs.get("sink")) for sp in rec.spans()}
    assert {("stream.parse", "TransactionSet"),
            ("stream.fold", "apriori_resident")} <= names


def test_rules_from_itemset_files_use_the_six_decimal_supports():
    sets = [ItemSetList(1, [association.ItemSet(("a",), 0.333333, 1),
                            association.ItemSet(("b",), 0.5, 1)]),
            ItemSetList(2, [association.ItemSet(("a", "b"), 0.166667, 1)])]
    rules = association.AssociationRuleMiner(0.3).mine(sets)
    assert [(r.antecedent, r.consequent) for r in rules] == \
        [(("a",), ("b",)), (("b",), ("a",))]
    assert rules[0].confidence == 0.166667 / 0.333333


# --------------------------------------------------------------- tutorial
def test_tutorial_data_through_both_packages(tmp_path):
    """docs/tutorial_freq_items_apriori.md: the planted triple, all three
    rounds, rules; in RAM and streamed at 0.05 MB blocks."""
    rng = np.random.default_rng(11)
    items = [f"I{i:03d}" for i in range(40)]
    csv = tmp_path / "xactions.csv"
    with open(csv, "w") as fh:
        for t in range(2000):
            basket = set(rng.choice(items, rng.integers(2, 6), replace=False))
            if rng.random() < 0.25:
                basket |= {"I000", "I001", "I002"}
            fh.write(",".join([f"T{t:05d}"] + sorted(basket)) + "\n")
    props = {"fia.support.threshold": "0.1", "fia.item.set.length": "3",
             "arm.conf.threshold": "0.5"}
    for block in (None, "0.05"):
        p = dict(props, **({"fia.stream.block.size.mb": block}
                           if block else {}))
        want = jax_run_job("frequentItemsApriori", p, [str(csv)],
                           str(tmp_path / f"jax{block}"))
        got = run_job("frequentItemsApriori", p, [str(csv)],
                      str(tmp_path / f"port{block}"), device=CPU)
        assert got.counters["Apriori:MaxLength"] == 3
        assert _files(got.outputs) == _files(want.outputs)
        level3 = Path(got.outputs[2]).read_text().splitlines()
        assert any(ln.startswith("I000,I001,I002") for ln in level3)
        rules = run_job("associationRuleMiner", p, got.outputs,
                        str(tmp_path / f"rules{block}.csv"), device=CPU)
        jax_rules = jax_run_job("associationRuleMiner", p, want.outputs,
                                str(tmp_path / f"jax_rules{block}.csv"))
        assert Path(rules.outputs[0]).read_bytes() == \
            Path(jax_rules.outputs[0]).read_bytes()
        assert rules.counters["Rules:Count"] > 0
