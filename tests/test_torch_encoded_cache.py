"""The miners' encoded-block spill cache in the port, held against the JAX
package: the segment files byte for byte, the dtype codes, the budget's
eviction and the per-source gates, a changed source re-parsed, the solo
streamed Apriori and GSP jobs with the cache on and off (files and
`Cache:*` counters equal to the reference's), and `packed_block_nbytes`."""

import os

import numpy as np
import pytest

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.native import ingest as jingest
from avenir_tpu.ops import bitset as jbitset
from avenir_tpu_torch.native import ingest
from avenir_tpu_torch.ops import bitset
from avenir_tpu_torch.runner import run_job, run_shared

CPU = "cpu"


def _blocks(seed, n_blocks=4):
    """Per-row region counts and codes of a few blocks, with codes wide
    enough to need each of the three dtypes."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_blocks):
        rows = int(rng.integers(1, 40))
        counts = rng.integers(0, 6 + 300 * (b == 3), rows, dtype=np.int64)
        top = [200, 60000, 70000, 50][b % 4]
        codes = rng.integers(0, top, int(counts.sum())).astype(np.int32)
        out.append((counts, codes))
    return out


def _write(cls, d, sources, blocks, budget=None, per_source=True):
    cache = cls(sources, cache_dir=str(d), byte_budget=budget)
    cache.begin()
    for i, (counts, codes) in enumerate(blocks):
        if per_source:
            cache.set_source(i % len(sources))
        cache.add_block(counts, codes)
    assert cache.commit()
    return cache


@pytest.mark.parametrize("value", [0, 255, 256, 65535, 65536, 2**31 - 1])
def test_dtype_code_equals_the_reference(value):
    assert ingest._enc_dtype_code(value) == jingest._enc_dtype_code(value)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("per_source", [True, False])
def test_segments_byte_identical_and_round_trip(tmp_path, seed, per_source):
    srcs = []
    for i in range(2 if per_source else 1):
        p = tmp_path / f"s{i}.csv"
        p.write_text("a,b\n")
        srcs.append(str(p))
    blocks = _blocks(seed)
    port = _write(ingest.EncodedBlockCache, tmp_path / "port", srcs, blocks,
                  per_source=per_source)
    ref = _write(jingest.EncodedBlockCache, tmp_path / "ref", srcs, blocks,
                 per_source=per_source)
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        data = (tmp_path / "port" / name).read_bytes()
        assert data == (tmp_path / "ref" / name).read_bytes()
        assert data[:8] == b"AVNRENC1"
    assert port.nbytes() == ref.nbytes() and port.valid and ref.valid
    got = list(port.blocks())
    want = [(c.astype(np.int32), k.astype(np.int32)) for c, k in
            (blocks if not per_source else
             [blocks[i] for i in range(0, len(blocks), 2)]
             + [blocks[i] for i in range(1, len(blocks), 2)])]
    assert len(got) == len(want)
    for (gc, gk), (wc, wk) in zip(got, want):
        assert gc.dtype == gk.dtype == np.int32
        assert np.array_equal(gc, wc) and np.array_equal(gk, wk)
    assert port.replays == 1
    port.close()
    ref.close()


@pytest.mark.parametrize("budget", [10, 700, 2500, 10**6])
def test_budget_eviction_and_source_gates(tmp_path, budget):
    srcs = []
    for i in range(3):
        p = tmp_path / f"s{i}.csv"
        p.write_text(f"row,{i}\n")
        srcs.append(str(p))
    blocks = _blocks(7, n_blocks=6)
    port = _write(ingest.EncodedBlockCache, tmp_path / "port", srcs, blocks,
                  budget=budget)
    ref = _write(jingest.EncodedBlockCache, tmp_path / "ref", srcs, blocks,
                 budget=budget)
    assert port.evicted_bytes == ref.evicted_bytes
    assert port.nbytes() == ref.nbytes() <= budget or port.nbytes() == 0
    assert port.valid == ref.valid
    for i in range(3):
        assert port.source_valid(i) == ref.source_valid(i)
        if port.source_valid(i):
            assert [b[1].tolist() for b in port.blocks(i)] == \
                [b[1].tolist() for b in ref.blocks(i)]
        else:
            with pytest.raises(RuntimeError):
                list(port.blocks(i))
    # a segment evicted by a later evict_to call, least recently replayed
    # first
    assert port.evict_to(0) == ref.evict_to(0)
    assert not port.valid and not any(port.source_valid(i)
                                      for i in range(3))


def test_changed_source_reparses_in_full(tmp_path):
    """A source that changed since the scan closes both full-replay gates,
    as the reference's do; an append keeps the prefix gate
    (`source_delta`), so the per-k pages replay the committed blocks and
    parse only the appended row: the support counts see it, as a fresh
    scan's do."""
    from avenir_tpu.models.association import \
        StreamingTransactionSource as RefSource
    from avenir_tpu_torch.models.association import (
        StreamingTransactionSource, count_token_supports)

    csv = tmp_path / "t.csv"
    csv.write_text("".join(f"t{i},a,b,c\n" for i in range(400)))
    port = StreamingTransactionSource([str(csv)], block_bytes=1024)
    ref = RefSource([str(csv)], block_bytes=1024)
    port.scan_items()
    ref.scan_items()
    assert port.cache_nbytes == ref.cache_nbytes > 0
    assert port._cache.valid and port._cache.source_valid(0)
    cands = [("a", "b"), ("b", "c")]
    assert count_token_supports(port, cands, 8, device=CPU).tolist() == \
        [400, 400]
    size = csv.stat().st_size
    with open(csv, "a") as fh:
        fh.write("t400,a,b\n")
    assert port._cache.source_valid(0) == ref._cache.source_valid(0) is False
    assert port._cache.valid == ref._cache.valid is False
    assert port._cache.source_delta(0) == ref._cache.source_delta(0) == size
    assert count_token_supports(port, cands, 8, device=CPU).tolist() == \
        [401, 400]
    port.close()
    ref.close()
    assert port._cache is None and port.cache_nbytes == 0


def _basket_corpus(path, n=3000, seed=5):
    rng = np.random.default_rng(seed)
    items = [f"i{j}" for j in range(10)]
    with open(path, "w") as fh:
        for r in range(n):
            k = int(rng.integers(1, 7))
            fh.write(",".join([f"t{r}"] + list(rng.choice(items, k))) + "\n")
    return str(path)


def _seq_corpus(path, n=3000, seed=6):
    rng = np.random.default_rng(seed)
    toks = ["L", "M", "H", "X", "Y"]
    with open(path, "w") as fh:
        for r in range(n):
            k = int(rng.integers(2, 9))
            fh.write(",".join([f"c{r}"] + list(rng.choice(toks, k))) + "\n")
    return str(path)


def _cache_props(prefix, cache, budget_mb):
    props = {f"{prefix}.stream.block.size.mb": "0.004"}
    if cache is not None:
        props[f"{prefix}.stream.encoded.cache"] = cache
    if budget_mb is not None:
        props[f"{prefix}.stream.encoded.cache.budget.mb"] = budget_mb
    return props


@pytest.mark.parametrize("job", ["frequentItemsApriori",
                                 "candidateGenerationWithSelfJoin"])
@pytest.mark.parametrize("cache,budget_mb", [
    (None, None), ("false", None), ("true", "0.002"), ("true", "0.05")])
def test_solo_miners_with_and_without_the_cache_equal_jax(
        tmp_path, job, cache, budget_mb):
    from avenir_tpu.runner import run_job as jax_run_job

    if job == "frequentItemsApriori":
        corpus = _basket_corpus(tmp_path / "b.csv")
        props = {"fia.support.threshold": "0.03",
                 "fia.item.set.length": "3",
                 **_cache_props("fia", cache, budget_mb)}
        key = "Apriori:MaxLength"
    else:
        corpus = _seq_corpus(tmp_path / "s.csv")
        props = {"cgs.support.threshold": "0.05",
                 "cgs.item.set.length": "3",
                 **_cache_props("cgs", cache, budget_mb)}
        key = "GSP:MaxLength"
    got = run_job(job, props, [corpus], str(tmp_path / "port"), device=CPU)
    want = jax_run_job(job, props, [corpus], str(tmp_path / "jax"))
    assert sorted(os.path.basename(p) for p in got.outputs) == \
        sorted(os.path.basename(p) for p in want.outputs)
    for a, b in zip(sorted(got.outputs), sorted(want.outputs)):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert got.counters[key] == want.counters[key] >= 2
    for name in ("Cache:SpillBytes", "Cache:EvictedBytes"):
        assert got.counters[name] == want.counters[name]
    if cache == "false":
        assert got.counters["Cache:SpillBytes"] == 0
    elif budget_mb == "0.002":
        assert got.counters["Cache:EvictedBytes"] > 0
    else:
        assert got.counters["Cache:SpillBytes"] > 0
        assert got.counters["Cache:EvictedBytes"] == 0


@pytest.mark.parametrize("native", [True, False])
def test_per_k_rounds_replay_instead_of_parsing(tmp_path, monkeypatch,
                                                native):
    """With the cache on, only pass 1 parses; with it off, every round
    re-reads the file. Both routes write the same itemsets."""
    from avenir_tpu_torch import obs

    if not native:
        monkeypatch.setattr(ingest, "native_seq_ready", lambda delim: False)
    corpus = _basket_corpus(tmp_path / "b.csv")
    parses = {}
    outs = {}
    for cache in ("true", "false"):
        props = {"fia.support.threshold": "0.03", "fia.item.set.length": "3",
                 **_cache_props("fia", cache, None)}
        with obs.capture() as rec:
            res = run_job("frequentItemsApriori", props, [corpus],
                          str(tmp_path / cache), device=CPU)
        parses[cache] = sum(1 for sp in rec.spans()
                            if sp.name == "stream.parse")
        outs[cache] = [open(p, "rb").read() for p in sorted(res.outputs)]
    assert outs["true"] == outs["false"]
    assert 0 < parses["true"] < parses["false"]


def test_shared_scan_counters_equal_jax(tmp_path):
    """run_shared's miner folds spill one combined segment from the shared
    read and report the same Cache:* counters as the reference's."""
    from avenir_tpu.runner import run_shared as jax_run_shared

    corpus = _seq_corpus(tmp_path / "s.csv", n=2000)
    fia = {"fia.support.threshold": "0.05", "fia.item.set.length": "2",
           "fia.skip.field.count": "1",
           "fia.stream.block.size.mb": "0.004"}
    cgs = {"cgs.support.threshold": "0.05", "cgs.item.set.length": "3",
           "cgs.stream.block.size.mb": "0.004"}
    specs = lambda d: [("frequentItemsApriori", fia, str(d / "fia")),  # noqa
                       ("candidateGenerationWithSelfJoin", cgs,
                        str(d / "cgs"))]
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got = run_shared(specs(tmp_path / "p"), [corpus], device=CPU)
    want = jax_run_shared(specs(tmp_path / "j"), [corpus])
    for job, res in got.items():
        for name in ("Cache:SpillBytes", "Cache:EvictedBytes"):
            assert res.counters[name] == want[job].counters[name]
        assert res.counters["Cache:SpillBytes"] > 0
        for a, b in zip(sorted(res.outputs), sorted(want[job].outputs)):
            assert open(a, "rb").read() == open(b, "rb").read()


def test_restored_scan_drops_the_cache(tmp_path):
    from avenir_tpu_torch.models.sequence import StreamingSequenceSource

    corpus = _seq_corpus(tmp_path / "s.csv", n=200)
    src = StreamingSequenceSource([corpus], block_bytes=1024)
    sink = src.scan_consumer()
    assert src._cache is not None
    src.restore_scan_state(["L"], [3])
    assert src._cache is None and src.spill_cache is False
    sink.finish()
    assert src.cache_nbytes == 0 and src.cache_evicted_bytes == 0


@pytest.mark.parametrize("rows,bits", [(1, 1), (8192, 0), (8192, 31),
                                       (8192, 32), (100, 33), (7, 1000)])
def test_packed_block_nbytes_equals_jax(rows, bits):
    assert bitset.packed_block_nbytes(rows, bits) == \
        jbitset.packed_block_nbytes(rows, bits)
