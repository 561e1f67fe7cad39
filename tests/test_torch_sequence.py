"""The port's sequence-mining path against the JAX package on the CPU.

The GSP join rules and candidate generation; the subsequence support
count's plain version (`ops.sequence_kernels.subseq_support_plain`, the
route of CPU tensors) against the reference's `_subseq_support_kernel`
on random rows and candidates with pads, mixed lengths, lengths of 0 and
-2 codes, tiled and untiled, exact (int32 counts: tolerance 0);
`SequenceSet` and the streamed blocks against the reference's; the
miner in RAM, streamed and merged over shards against the reference's
levels; then `candidateGenerationWithSelfJoin` (in RAM, streamed through
the native encoder and through the Python rows), `sequencePositionalCluster`
and `sequenceGenerator`, each byte-identical to the JAX package's files;
`run_shared` on the bytes kind, alone and beside `frequentItemsApriori`;
fold checkpoints taken mid-scan and the shard merge.
"""

import functools
import io
import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.models import sequence as jseq
from avenir_tpu.runner import JobConfig as JaxJobConfig
from avenir_tpu.runner import run_job as jax_run_job
from avenir_tpu.runner import stream_fold_ops as jax_stream_fold_ops
from avenir_tpu_torch import obs
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.stream import stream_job_byte_blocks
from avenir_tpu_torch.data import generate_token_sequences
from avenir_tpu_torch.models import sequence
from avenir_tpu_torch.native import ingest
from avenir_tpu_torch.ops import sequence_kernels as sk
from avenir_tpu_torch.runner import (job_names, run_job, run_shared,
                                     stream_fold_names, stream_fold_ops)

CPU = "cpu"
ROUTES = ("ram", "native", "python")

AWKWARD = [
    "sonly",                        # an id and no token
    "strail,e1,e2,",                # a trailing delimiter
    " spad , e1 ,\te3\t, e2 ",      # padded tokens
    "srep,e2,e2,e1,e2,e2",          # a token repeated in one sequence
    ",,,",                          # a line of delimiters
    "sgap,e1,,e2,,e1",              # empty tokens inside
]


def _lines(n: int, seed: int, vocab: int = 12):
    out = generate_token_sequences(n, vocab=vocab, mean_len=6, max_len=20,
                                   seed=seed)
    for i, ln in enumerate(AWKWARD):        # spread through the corpus
        out.insert((i * 7919) % len(out), ln)
    out.insert(n // 2, "")
    out.insert(n // 3, "   \t ")
    return out


def _corpus(path: Path, n: int = 1200, seed: int = 2, crlf: bool = False,
            vocab: int = 12) -> str:
    end = "\r\n" if crlf else "\n"
    path.write_text(end.join(_lines(n, seed, vocab)) + end)
    return str(path)


def _files(outputs):
    return {os.path.basename(p): Path(p).read_bytes() for p in outputs}


def _props(threshold, length, block=None):
    p = {"cgs.support.threshold": str(threshold),
         "cgs.item.set.length": str(length)}
    if block is not None:
        p["cgs.stream.block.size.mb"] = str(block)
    return p


# ------------------------------------------------------------ the joins
@pytest.mark.parametrize("seed", range(4))
def test_candidate_generation_equals_jax(seed):
    rng = np.random.default_rng(seed)
    toks = [f"t{i}" for i in range(5)]
    for k in (1, 2, 3):
        freq = {tuple(rng.choice(toks, k)) for _ in range(12)}
        assert sequence.generate_sequence_candidates(freq) == \
            jseq.generate_sequence_candidates(freq)
        for a in freq:
            assert sequence.self_join_sequence(a) == \
                jseq.self_join_sequence(a)
            for b in freq:
                assert sequence.join_sequences(a, b) == \
                    jseq.join_sequences(a, b)


def test_join_rules():
    assert sequence.join_sequences(["a", "b"], ["b", "c"]) == ["a", "b", "c"]
    assert sequence.join_sequences(["b", "c"], ["a", "b"]) == ["a", "b", "c"]
    assert sequence.join_sequences(["a", "b"], ["c", "d"]) is None
    assert sequence.self_join_sequence(["x", "x"]) == ["x", "x", "x"]
    assert sequence.self_join_sequence(["x", "y"]) is None
    assert sequence.generate_sequence_candidates([("a",), ("b",)]) == \
        [("a", "a"), ("a", "b"), ("b", "a"), ("b", "b")]


# -------------------------------------------------------- support counts
def _random_case(seed: int):
    """Rows with -1 pads (trailing and inside), candidates with -2 pads,
    codes no row holds, lengths 0, -1 and past the code width."""
    rng = np.random.default_rng(seed)
    n, t = int(rng.integers(1, 90)), int(rng.integers(1, 14))
    c, k = int(rng.integers(1, 50)), int(rng.choice([1, 2, 4, 8]))
    v = int(rng.integers(1, 7))
    lens = rng.integers(0, t + 1, n)
    rows = rng.integers(0, v, (n, t)).astype(np.int32)
    rows[np.arange(t)[None, :] >= lens[:, None]] = -1
    rows[rng.random((n, t)) < 0.1] = -1
    cands = rng.integers(-2, v + 1, (c, k)).astype(np.int32)
    kv = rng.integers(-1, k + 2, c).astype(np.int32)
    return rows, cands, kv


def _n_codes(cands) -> int:
    """The code range a caller passes: 1 + the largest code, 0 if none."""
    return max(int(np.max(cands, initial=-1)) + 1, 0)


def _jax_counts(rows, cands, kv) -> list:
    return np.asarray(jseq._subseq_support_kernel(
        jnp.asarray(rows), jnp.asarray(cands), jnp.asarray(kv))).tolist()


@pytest.mark.parametrize("seed", range(12))
def test_plain_support_equals_jax(seed):
    """Exact: int32 counts equal the reference's scan, tiled or not."""
    rows, cands, kv = _random_case(seed)
    want = np.asarray(_jax_counts(rows, cands, kv))
    r, c, k = (torch.from_numpy(x) for x in (rows, cands, kv))
    got = sequence._subseq_support(r, c, k, _n_codes(cands))
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == want.tolist()
    tiled = sk.subseq_support_plain(r, c, k, max_cells=3 * rows.shape[0])
    assert torch.equal(tiled, got)
    acc = torch.arange(c.shape[0], dtype=torch.int32)
    assert sequence._subseq_fold(acc, r, c, k, _n_codes(cands)) is acc
    assert acc.numpy().tolist() == (want + np.arange(len(want))).tolist()


def _kernel_walk_compares(rows, cands, kv) -> int:
    """The compares of the CUDA kernel's loop, walked in Python: a row up
    to its last token, stopping at k or at a negative code."""
    kmax, total = cands.shape[1], 0
    for row in rows.tolist():
        length = max((i + 1 for i, x in enumerate(row) if x >= 0),
                     default=0)
        for code, k in zip(cands.tolist(), kv.tolist()):
            p, e = 0, code[0]
            if k <= 0 or e < 0:
                continue
            for x in row[:length]:
                total += 1
                if x == e:
                    p += 1
                    if p == k:
                        break
                    e = code[min(p, kmax - 1)]
                    if e < 0:
                        break
    return total


@pytest.mark.parametrize("seed", range(6))
def test_walk_steps_counts_the_kernels_compares(seed):
    """Exact: the walk route's bound counts what its walks do on the data
    (the kernel's only route before the mask route; now its second
    route, for rows past 64 tokens or tables past shared memory)."""
    rows, cands, kv = _random_case(seed)
    want = _kernel_walk_compares(rows, cands, kv)
    r, c, k = (torch.from_numpy(x) for x in (rows, cands, kv))
    assert sk.walk_steps(r, c, k) == want
    assert sk.walk_steps(r, c, k, max_cells=3 * rows.shape[0]) == want


def _mask_test(rows, cands, kv):
    """(counts, lookups) of the mask route's test walked in Python: each
    row's position masks by code; a live candidate (1 <= k <= T, no
    negative code among the codes min(j, K - 1) of its k steps) makes k
    lookups, m = mask[code_0], then m = mask[code_j] & ~(m ^ (m - 1)),
    and counts when the last m is not 0."""
    t, kmax = rows.shape[1], cands.shape[1]
    counts, lookups = [0] * len(cands), 0
    for row in rows.tolist():
        masks = {}
        for i, tok in enumerate(row):
            if tok >= 0:
                masks[tok] = masks.get(tok, 0) | 1 << i
        for ci, (code, k) in enumerate(zip(cands.tolist(), kv.tolist())):
            steps = [code[min(j, kmax - 1)] for j in range(k)] \
                if 1 <= k <= t else []
            if not steps or min(steps) < 0:
                continue
            m = 0
            for j, cj in enumerate(steps):
                found = masks.get(cj, 0)
                m = found if j == 0 else found & ~(m ^ (m - 1))
                lookups += 1
            counts[ci] += m != 0
    return counts, lookups


@pytest.mark.parametrize("seed", range(6))
def test_lookup_steps_counts_the_mask_tests_lookups(seed):
    """Exact: the mask route's bound counts the lookups its test makes on
    the data, and that test's counts are the reference's."""
    rows, cands, kv = _random_case(seed)
    counts, want = _mask_test(rows, cands, kv)
    assert counts == _jax_counts(rows, cands, kv)
    r, c, k = (torch.from_numpy(x) for x in (rows, cands, kv))
    assert sk.lookup_steps(r, c, k) == want


@pytest.mark.parametrize("t", [16, 32, 48, 64, 80])
def test_plain_support_edges_by_width(t):
    """Exact, against the reference and the mask test, at the widths of
    both mask forms (T <= 32, T <= 64) and of the walk route (T > 64):
    rows of one token repeated, rows of pads, a token at the last
    position, candidates with a repeated code, longer than their code
    width, and with the top code of the range."""
    rng = np.random.default_rng(t)
    n, v = 60, 5
    rows = rng.integers(0, v, (n, t)).astype(np.int32)
    lens = rng.integers(0, t + 1, n)
    rows[np.arange(t)[None, :] >= lens[:, None]] = -1
    rows[0] = -1
    rows[1] = 2
    rows[2] = -1
    rows[2, t - 1] = v - 1
    cands = np.array([[2, 2, -2, -2], [2, 2, 2, -2], [v - 1, -2, -2, -2],
                      [0, v - 1, -2, -2], [v - 1, 0, -2, -2],
                      [1, 1, 1, 1], [0, 1, 2, 3], [3, -2, -2, -2],
                      [2, 2, -2, -2]], np.int32)
    kv = np.array([2, 3, 1, 2, 2, 4, 4, 3, t + 1], np.int32)
    want = _jax_counts(rows, cands, kv)
    assert want[0] >= 1 and want[2] >= 1    # rows 1 and 2 hold them
    assert _mask_test(rows, cands, kv)[0] == want
    r, c, k = (torch.from_numpy(x) for x in (rows, cands, kv))
    assert sequence._subseq_support(r, c, k, v).tolist() == want
    assert sequence._subseq_support(r, c, k, 10 * v).tolist() == want


def test_n_codes_is_required_and_checked():
    rows, cands, kv = (torch.from_numpy(x) for x in _random_case(4))
    top = _n_codes(cands.numpy())
    acc = torch.zeros(cands.shape[0], dtype=torch.int32)
    with pytest.raises(TypeError):
        sk.subseq_support_fold(acc, rows, cands, kv)
    with pytest.raises(TypeError):
        sequence._subseq_support(rows, cands, kv)
    with pytest.raises(TypeError, match="n_codes"):
        sk.subseq_support_fold(acc, rows, cands, kv, float(top))
    for bad in (-1, sk.MAX_CODES + 1):
        with pytest.raises(ValueError, match="n_codes"):
            sk.subseq_support_fold(acc, rows, cands, kv, bad)
    with pytest.raises(ValueError, match="largest code"):
        sk.subseq_support_fold(acc, rows, cands, kv, top - 1)
    assert acc.abs().sum() == 0
    want = sk.subseq_support_plain(rows, cands, kv)
    for ok in (top, np.int64(top), top + 7):
        assert torch.equal(
            sk.subseq_support_fold(acc.zero_(), rows, cands, kv, ok), want)


def test_plain_support_edges():
    rows = torch.tensor([[0, 1, -1], [1, 0, 0], [-1, -1, -1]],
                        dtype=torch.int32)
    cands = torch.tensor([[0, 0], [1, 0], [0, -2], [-1, -1], [0, 1]],
                         dtype=torch.int32)
    kv = torch.tensor([2, 2, 1, 1, 0], dtype=torch.int32)
    assert sequence._subseq_support(rows, cands, kv, 2).tolist() == \
        [1, 1, 2, 0, 0]
    empty = torch.zeros((0, 4), dtype=torch.int32)
    assert sequence._subseq_support(empty, cands, kv, 2).tolist() == [0] * 5
    # compares: c0 2+3, c1 2+2, c2 1+2; c3 opens on a pad, c4 is length 0
    assert sk.walk_steps(rows, cands, kv) == 12
    # lookups: 3 rows each of c0 and c1 (2 steps) and c2 (1)
    assert sk.lookup_steps(rows, cands, kv) == 15
    with pytest.raises(TypeError, match="int32"):
        sequence._subseq_support(rows.long(), cands, kv, 2)
    with pytest.raises(ValueError, match="lengths"):
        sequence._subseq_support(rows, cands, kv[:2], 2)
    with pytest.raises(ValueError, match="acc"):
        sk.subseq_support_fold(torch.zeros(2, dtype=torch.int32), rows,
                               cands, kv, 2)


def test_cpu_tensors_launch_nothing():
    sk.reset_launches()
    rows, cands, kv = _random_case(3)
    sequence._subseq_support(*(torch.from_numpy(x) for x in
                               (rows, cands, kv)), _n_codes(cands))
    assert sk.subseq_support_fold.launches == 0


# ----------------------------------------------------------------- ingest
def test_sequence_set_equals_jax():
    rows = [ln.split(",") for ln in _lines(300, 5)]
    got = sequence.SequenceSet.from_token_rows(rows)
    want = jseq.SequenceSet.from_token_rows(rows)
    assert got.vocab == want.vocab and got.index == want.index
    assert np.array_equal(got.rows, want.rows)
    assert np.array_equal(got.lengths, want.lengths)
    empty = sequence.SequenceSet.from_token_rows([])
    assert empty.rows.shape == jseq.SequenceSet.from_token_rows([]).rows.shape


@pytest.mark.parametrize("route", ["native", "python"])
def test_streamed_blocks_equal_jax(tmp_path, monkeypatch, route):
    """Pass 1 and the masked blocks of every page equal the reference's
    (its cache off, so it re-reads the CSV as the port does)."""
    from avenir_tpu.native import ingest as jax_ingest

    csv = _corpus(tmp_path / "x.csv", n=3000, crlf=True)
    if route == "python":
        for mod in (ingest, jax_ingest):
            monkeypatch.setattr(mod, "native_seq_ready", lambda delim: False)
    port = sequence.StreamingSequenceSource([csv], block_bytes=4096,
                                            spill_cache=False)
    ref = jseq.StreamingSequenceSource([csv], block_bytes=4096,
                                       spill_cache=False)
    vocab, counts, n = port.scan()
    jv, jc, jn = ref.scan()
    assert (vocab, counts.tolist(), n, port.t_max) == \
        (jv, jc.tolist(), jn, ref.t_max)
    keep = [i for i, c in enumerate(counts) if c > 0.3 * n]
    assert port.mask_tokens(keep) == ref.mask_tokens(keep) < len(vocab)
    got, want = list(port.chunks(512)), list(ref.chunks(512))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        assert a.dtype == np.int32 and np.array_equal(a, b)
    assert port.token_code("nope") == -2 == ref.token_code("nope")


# ------------------------------------------------------------------ miner
def _levels(out):
    return {k: sorted(v.items()) for k, v in out.items()}


@pytest.mark.parametrize("threshold,length", [(0.05, 3), (0.02, 4),
                                              (0.3, 2)])
def test_miner_equals_jax_in_ram_and_streamed(tmp_path, threshold, length):
    csv = _corpus(tmp_path / "x.csv")
    rows = [[t.strip(" \t\r") for t in ln.split(",")]
            for ln in Path(csv).read_text().splitlines() if ln.strip()]
    want = jseq.GSPMiner(threshold, length).mine(
        jseq.SequenceSet.from_token_rows(rows))
    ram = sequence.GSPMiner(threshold, length, device=CPU).mine(
        sequence.SequenceSet.from_token_rows(rows))
    streamed = sequence.GSPMiner(threshold, length, block=256,
                                 device=CPU).mine_stream(
        sequence.StreamingSequenceSource([csv], block_bytes=3000))
    assert _levels(ram) == _levels(streamed) == _levels(want)
    assert len(want) >= 2


def test_mine_stream_merged_equals_one_scan_and_jax(tmp_path):
    lines = _lines(1500, 7)
    lines.insert(100, "sonly2,zz,zz,zz")    # a token of one shard only
    paths = []
    for i in range(3):
        p = tmp_path / f"part{i}.csv"
        p.write_text("\n".join(lines[i::3]) + "\n")
        paths.append(str(p))
    whole = tmp_path / "whole.csv"
    whole.write_text("".join(Path(p).read_text() for p in paths))
    miner = sequence.GSPMiner(0.0005, 3, block=128, device=CPU)
    merged = miner.mine_stream_merged(
        [sequence.StreamingSequenceSource([p], block_bytes=2048)
         for p in paths])
    one = sequence.GSPMiner(0.0005, 3, block=128, device=CPU).mine_stream(
        sequence.StreamingSequenceSource([str(whole)], block_bytes=2048))
    jax = jseq.GSPMiner(0.0005, 3, block=128).mine_stream_merged(
        [jseq.StreamingSequenceSource([p], block_bytes=2048,
                                      spill_cache=False) for p in paths])
    assert _levels(merged) == _levels(one) == _levels(jax)
    assert ("zz", "zz", "zz") in merged[3]


# ------------------------------------------------------------------- jobs
CONFIGS = [(0.05, 3, False), (0.02, 4, True), (0.2, 2, False)]


@functools.lru_cache(maxsize=None)
def _jax_outputs(root: str, config) -> dict:
    """The JAX package's files of one config, in RAM and streamed (which
    must agree)."""
    threshold, length, crlf = config
    d = Path(root)
    d.mkdir(parents=True, exist_ok=True)
    csv = _corpus(d / "x.csv", crlf=crlf)
    ram = jax_run_job("candidateGenerationWithSelfJoin",
                      _props(threshold, length), [csv], str(d / "ram"))
    streamed = jax_run_job("candidateGenerationWithSelfJoin",
                           _props(threshold, length, 0.005), [csv],
                           str(d / "streamed"))
    assert _files(ram.outputs) == _files(streamed.outputs)
    return {"files": _files(ram.outputs), "csv": csv,
            "max_length": ram.counters["GSP:MaxLength"]}


@pytest.fixture(scope="module")
def jax_root(tmp_path_factory):
    return tmp_path_factory.mktemp("jax_gsp")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: "-".join(map(str, c)))
def test_sequences_byte_identical_to_jax(tmp_path, jax_root, monkeypatch,
                                         route, config):
    want = _jax_outputs(str(jax_root / "-".join(map(str, config))), config)
    threshold, length, _crlf = config
    props = _props(threshold, length, None if route == "ram" else 0.005)
    # the sidecar off: pass 1 parses with the route's engine
    props["cgs.stream.sidecar"] = "false"
    if route == "python":
        monkeypatch.setattr(ingest, "native_seq_ready", lambda delim: False)
    with obs.capture() as rec:
        res = run_job("gspMiner", props, [want["csv"]], str(tmp_path / "o"),
                      device=CPU)
    engines = {sp.attrs["engine"] for sp in rec.spans()
               if sp.name == "stream.parse"}
    # streamed, only pass 1 parses: the later rounds replay its
    # encoded-block cache
    assert engines == {"ram": {"python"}, "python": {"python"},
                       "native": {"native"}}[route]
    assert _files(res.outputs) == want["files"]
    assert len(want["files"]) >= 2
    assert res.counters["GSP:MaxLength"] == want["max_length"]
    assert res.counters["Basic:Records"] == 1206


def test_a_count_at_the_threshold_drops(tmp_path):
    """Kept only when above support * n: 2 of 4 rows at 0.5 drops."""
    csv = tmp_path / "x.csv"
    csv.write_text("s1,a,b\ns2,a,b\ns3,c\ns4,c\n")
    for block in (None, 0.001):
        res = run_job("candidateGenerationWithSelfJoin",
                      _props(0.5, 3, block), [str(csv)],
                      str(tmp_path / f"o{block}"), device=CPU)
        want = jax_run_job("candidateGenerationWithSelfJoin",
                           _props(0.5, 3, block), [str(csv)],
                           str(tmp_path / f"j{block}"))
        assert _files(res.outputs) == _files(want.outputs)
        assert Path(res.outputs[0]).read_text() == ""


def _events(path: Path, n: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    ts = np.cumsum(rng.exponential(3.0, n))
    rng.shuffle(ts)
    lines = [f"ev{i % 7},{t:.3f},{rng.integers(0, 100)},u{i % 13}"
             for i, t in enumerate(ts)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("props", [
    {"spc.window.time.span": "20", "spc.window.time.step": "2",
     "spc.score.threshold": "0.1"},
    {"spc.window.time.span": "9.5", "spc.window.time.step": "0.75",
     "spc.score.threshold": "0.3", "spc.min.occurence": "3",
     "spc.quant.threshold": "40"},
])
def test_positional_cluster_byte_identical(tmp_path, props):
    csv = _events(tmp_path / "ev.csv", 400, 8)
    got = run_job("sequencePositionalCluster", props, [csv],
                  str(tmp_path / "port.txt"), device=CPU)
    want = jax_run_job("sequencePositionalCluster", props, [csv],
                       str(tmp_path / "jax.txt"))
    assert Path(got.outputs[0]).read_bytes() == \
        Path(want.outputs[0]).read_bytes()
    assert got.counters == want.counters
    assert got.counters["Windows:Found"] > 0


@pytest.mark.parametrize("props", [
    {"seg.id.field.ordinals": "0", "seg.val.field.ordinals": "1,2",
     "seg.seq.field": "0"},
    {"seg.id.field.ordinals": "3,0", "seg.val.field.ordinals": "2,1",
     "seg.seq.field": "1", "field.delim.out": ";"},
])
def test_sequence_generator_byte_identical(tmp_path, props):
    csv = _events(tmp_path / "ev.csv", 300, 9)
    with open(csv, "a") as fh:        # sort keys that are no number
        fh.write("ev1,nan,5,u1\nev1,late,6,u1\nev2,,7,u2\n")
    got = run_job("sequenceGenerator", props, [csv],
                  str(tmp_path / "port.txt"), device=CPU)
    want = jax_run_job("sequenceGenerator", props, [csv],
                       str(tmp_path / "jax.txt"))
    assert Path(got.outputs[0]).read_bytes() == \
        Path(want.outputs[0]).read_bytes()
    assert got.counters == want.counters


# -------------------------------------------------------------- the folds
CGS_BLOCK = _props(0.03, 3, 0.004)


def test_run_shared_equals_run_job(tmp_path):
    csv = _corpus(tmp_path / "x.csv", n=2000, seed=12)
    assert "candidateGenerationWithSelfJoin" in stream_fold_names()
    with obs.capture() as rec:
        shared = run_shared([("gspMiner", CGS_BLOCK,
                              str(tmp_path / "shared"))], [csv], device=CPU)
    solo = run_job("candidateGenerationWithSelfJoin", CGS_BLOCK, [csv],
                   str(tmp_path / "solo"), device=CPU)
    got = shared["candidateGenerationWithSelfJoin"]
    assert _files(got.outputs) == _files(solo.outputs)
    assert got.counters["Basic:Records"] == solo.counters["Basic:Records"]
    assert got.counters["GSP:MaxLength"] == solo.counters["GSP:MaxLength"]
    sinks = {(sp.name, sp.attrs.get("sink")) for sp in rec.spans()}
    assert {("stream.parse", "StreamingSequenceSource"),
            ("stream.fold", "gsp_support"),
            ("stream.fold", "candidateGenerationWithSelfJoin")} <= sinks


def test_run_shared_pair_with_apriori(tmp_path):
    """GSP and Apriori over one `id,tok,...` file in one scan: each job's
    files equal its solo run's and the JAX package's."""
    csv = _corpus(tmp_path / "x.csv", n=2000, seed=13)
    props = {**CGS_BLOCK, "fia.support.threshold": "0.03",
             "fia.item.set.length": "3", "fia.stream.block.size.mb": "0.004"}
    shared = run_shared([("candidateGenerationWithSelfJoin", props,
                          str(tmp_path / "s_gsp")),
                         ("frequentItemsApriori", props,
                          str(tmp_path / "s_fia"))], [csv], device=CPU)
    for job, short in (("candidateGenerationWithSelfJoin", "gsp"),
                       ("frequentItemsApriori", "fia")):
        solo = run_job(job, props, [csv], str(tmp_path / f"solo_{short}"),
                       device=CPU)
        jax = jax_run_job(job, props, [csv], str(tmp_path / f"jax_{short}"))
        assert _files(shared[job].outputs) == _files(solo.outputs) == \
            _files(jax.outputs)


def _blocks(csv):
    return list(stream_job_byte_blocks(JobConfig(CGS_BLOCK, "cgs"), [csv]))


@pytest.mark.parametrize("source", ["port", "jax"])
def test_checkpoint_mid_scan_finishes_to_jax_bytes(tmp_path, source):
    """A fold checkpointed half-way through pass 1 (the port's, or the
    JAX package's) restores into the port's fold, which finishes to the
    JAX package's bytes."""
    csv = _corpus(tmp_path / "x.csv", n=2500, seed=3)
    blocks = _blocks(csv)
    assert len(blocks) >= 4
    ops = stream_fold_ops("gspMiner")
    assert ops.kind == "bytes"
    cfg = JobConfig(CGS_BLOCK, "cgs")
    if source == "jax":
        jops = jax_stream_fold_ops("candidateGenerationWithSelfJoin")
        first = jops.factory(JaxJobConfig(CGS_BLOCK, "cgs"), [csv])
    else:
        jops = ops
        first = ops.factory(cfg, [csv], None, torch.device(CPU))
    for b in blocks[:len(blocks) // 2]:
        first.consume(b)
    blob = jops.serialize_state(first)
    fold = ops.restore_state(cfg, [csv], blob, device=CPU)
    assert fold.src.t_max >= 1 and fold.src.n_rows > 0
    for b in blocks[len(blocks) // 2:]:
        fold.consume(b)
    got = fold.finish(str(tmp_path / "port"))
    want = jax_run_job("candidateGenerationWithSelfJoin", CGS_BLOCK, [csv],
                       str(tmp_path / "jax"))
    assert _files(got.outputs) == _files(want.outputs)
    assert got.counters["Basic:Records"] == want.counters["Basic:Records"]


def test_merged_shard_folds_equal_the_whole_file(tmp_path):
    lines = _lines(1800, 4)
    paths = []
    for i in range(2):
        p = tmp_path / f"part{i}.csv"
        p.write_text("\n".join(lines[i::2]) + "\n")
        paths.append(str(p))
    whole = tmp_path / "whole.csv"
    whole.write_text("".join(Path(p).read_text() for p in paths))
    ops = stream_fold_ops("candidateGenerationWithSelfJoin")
    cfg = JobConfig(CGS_BLOCK, "cgs")
    folds = []
    for p in paths:
        f = ops.factory(cfg, [p], None, torch.device(CPU))
        for b in _blocks(p):
            f.consume(b)
        folds.append(f)
    merged = ops.merge_states(folds[0], folds[1])
    got = merged.finish(str(tmp_path / "merged"))
    want = run_job("candidateGenerationWithSelfJoin", CGS_BLOCK,
                   [str(whole)], str(tmp_path / "whole"), device=CPU)
    assert _files(got.outputs) == _files(want.outputs)
    assert got.counters["Basic:Records"] == want.counters["Basic:Records"]
    with pytest.raises(ValueError, match="before merging"):
        ops.serialize_state(merged)
    other = stream_fold_ops("apriori").factory(
        JobConfig({"fia.support.threshold": "0.1"}, "fia"), [paths[0]],
        None, torch.device(CPU))
    with pytest.raises(ValueError, match="cannot merge"):
        ops.merge_states(folds[0], other)


def test_fold_refuses_another_jobs_checkpoint(tmp_path):
    csv = _corpus(tmp_path / "x.csv", n=200)
    buf = io.BytesIO()
    np.savez(buf, meta=np.array(json.dumps(
        {"job": "frequentItemsApriori", "vocab": [], "n": 0,
         "sealed": False, "t_max": None})), counts=np.zeros(0, np.int64))
    with pytest.raises(ValueError, match="frequentItemsApriori"):
        stream_fold_ops("candidateGenerationWithSelfJoin").restore_state(
            JobConfig(CGS_BLOCK, "cgs"), [csv], buf.getvalue(), device=CPU)


def test_jobs_are_registered_and_want_a_card(tmp_path, monkeypatch):
    assert {"candidateGenerationWithSelfJoin", "gspMiner",
            "org.avenir.sequence.CandidateGenerationWithSelfJoin",
            "sequencePositionalCluster",
            "org.avenir.sequence.SequencePositionalCluster",
            "sequenceGenerator",
            "org.avenir.spark.sequence.SequenceGenerator"} <= set(job_names())
    csv = _corpus(tmp_path / "x.csv", n=100)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_job("gspMiner", _props(0.1, 2), [csv], str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sequence.GSPMiner(0.1)
