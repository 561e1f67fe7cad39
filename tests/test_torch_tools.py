"""The port's tools on the CPU: `kernel_check` passes every case with
the plain versions and refuses to start without a device; `knn_sweep`
covers every kernel in both dtypes and runs at a tiny size; `bench` gives
every section of its JSON line at a small size."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from avenir_tpu_torch.ops import knn_kernels as kk
from avenir_tpu_torch.ops import matmul_ceiling as mc
from avenir_tpu_torch.tools import bench, kernel_check, knn_sweep

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", kernel_check.CASE_NAMES)
def test_kernel_check_case_passes_on_cpu(name):
    lines = []
    results = kernel_check.run("cpu", names=[name], out=lines.append)
    assert results == {name: []}
    assert lines[0] == f"PASS {name}"
    assert json.loads(lines[-1]) == {"metric": "kernel_check", "device": "cpu",
                                     "passed": 1, "total": 1}


def test_kernel_check_covers_the_reference_cases():
    """The JAX package's check: 6 top-k cases x exact, packed, lanes, plus
    lanes-bf16 for the 5 euclidean ones; 3 fused votes, 2 exhausted, 2
    mixed, 1 collision."""
    names = kernel_check.CASE_NAMES
    assert len(names) == 6 * 3 + 5 + 3 + 2 + 2 + 1 == 31
    for label, *_ in kernel_check.TOPK_CASES:
        assert f"packed/{label}" in names
    assert {"fused-vote-exhausted/float32", "fused-vote-exhausted/bfloat16",
            "lanes/same-lane-collision"} <= set(names)


def test_kernel_check_fails_a_wrong_result():
    """The oracle check is not vacuous: a swapped neighbour, a distance
    off by 1% and a stray index each fail."""
    import numpy as np

    q, t = kernel_check.case_data()["basic"]
    full = kernel_check.oracle(q[:16], t[:512], "euclidean")
    idx = np.argsort(full, axis=1, kind="stable")[:, :5].astype(np.int32)
    dist = np.take_along_axis(full, idx, 1).astype(np.float32)
    assert kernel_check.topk_faults(dist, idx, full, 5, 1e-3) == []
    far = np.argsort(full, axis=1)[:, -1:].astype(np.int32)
    bad_i = np.concatenate([idx[:, :4], far], 1)
    assert any("recall" in f for f in
               kernel_check.topk_faults(dist, bad_i, full, 5, 1e-3))
    assert kernel_check.topk_faults(dist * 1.01, idx, full, 5, 1e-3)
    stray = idx.copy()
    stray[0, 0] = 512
    assert "index out of range" in kernel_check.topk_faults(dist, stray, full,
                                                            5, 1e-3)


def test_kernel_check_main_on_cpu(capsys):
    assert kernel_check.main(["--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["passed"] == summary["total"] == 31


def test_kernel_check_raises_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kernel_check.main([])


def test_kernel_check_module_exits_nonzero_without_cuda():
    """No "skipped, exit 0" on a machine without a GPU: the command fails
    and prints no summary."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import runpy, torch; torch.cuda.is_available = lambda: False; "
         "runpy.run_module('avenir_tpu_torch.tools.kernel_check', "
         "run_name='__main__')"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "RuntimeError" in proc.stderr
    assert "kernel_check" not in proc.stdout


def test_sweep_configs_name_every_kernel_and_dtype():
    got = {(name, dtype) for name, _, dtype in knn_sweep.CONFIGS}
    assert got == {(k, d) for k in ("exact", "packed", "lanes")
                   for d in kk.COMPUTE_DTYPES}
    wrappers = {name: fn for name, fn, _ in knn_sweep.CONFIGS}
    assert wrappers == {"exact": kk.knn_topk, "packed": kk.knn_topk_packed,
                        "lanes": kk.knn_topk_lanes}
    assert (knn_sweep.QUERIES, knn_sweep.TRAIN, knn_sweep.DIM, knn_sweep.K) \
        == (8192, 131072, 128, 5)


def test_sweep_runs_on_cpu_at_a_tiny_size():
    lines = []
    rows = knn_sweep.run(8, 64, 512, device="cpu", reps=1, out=lines.append)
    kernels = [(r["kernel"], r["dtype"]) for r in rows if "kernel" in r]
    assert kernels == [(name, dtype) for name, _, dtype in knn_sweep.CONFIGS]
    arms = [r for r in rows if "classify" in r]
    assert [r["classify"] for r in arms] == ["composed", "fused"]
    assert arms[0]["agreement"] == 1.0
    assert all(r["ms"] > 0 and r["qps"] > 0 for r in rows)
    assert lines[0].startswith("knn_sweep on cpu: 64 queries x 512 train rows")
    assert all(line.endswith("(cpu)") for line in lines[1:-1])
    assert [fn.launches for fn in kk.KERNEL_WRAPPERS] == [0, 0, 0, 0]


def test_sweep_main_takes_sizes_and_device(capsys):
    assert knn_sweep.main(["6", "--queries", "32", "--train", "256",
                           "--reps", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "32 queries x 256 train rows, D=6" in out
    assert out.count(" q/s") == 8


def test_sweep_raises_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        knn_sweep.run(8, 32, 256)


BENCH_SECTIONS = {"nb": {"rows", "train_rps", "predict_rps", "nb_rps"},
                  "knn_d8": {"qps", "tflops"}, "knn_d128": {"qps", "tflops"},
                  "fused_d8": {"fused_qps"}, "fused_d128": {"fused_qps"},
                  "ceiling_d128": {"ms", "tflops", "kernel_quality"}}


def test_bench_runs_every_section_on_cpu():
    import math

    lines = []
    kk.reset_launches()
    mc.reset_launches()
    result = bench.run(device="cpu", nb_rows=20000, queries=512, train=4096,
                       reps=1, rf_rows=2000, out=lines.append)
    assert json.loads(lines[-1]) == result
    assert (result["metric"], result["device"], result["power_limit"]) == \
        ("port_bench", "cpu", None)
    assert set(result) == {"metric", "device", "power_limit", *BENCH_SECTIONS,
                           "rf_rls", "rf_levels", "rf_predict_rps",
                           "vs_baseline"}
    # 5 trees of depth 4: every tree reaches its depth on 2,000 rows
    assert result["rf_levels"] == 5 * 4
    assert result["rf_rls"] > 0 and result["rf_predict_rps"] > 0
    for section, keys in BENCH_SECTIONS.items():
        # a CPU run states no share of the card's peak
        assert set(result[section]) == keys, section
        assert all(math.isfinite(v) and v > 0
                   for v in result[section].values()), section
    assert result["nb"]["rows"] == 20000
    nb = result["nb"]
    assert nb["nb_rps"] == pytest.approx(
        1 / (1 / nb["train_rps"] + 1 / nb["predict_rps"]))
    assert result["ceiling_d128"]["kernel_quality"] == pytest.approx(
        result["knn_d128"]["tflops"] / result["ceiling_d128"]["tflops"])
    assert [fn.launches for fn in kk.KERNEL_WRAPPERS + mc.KERNEL_WRAPPERS] \
        == [0] * 5


def test_bench_defaults_are_the_root_bench_configs():
    assert (bench.NB_ROWS, bench.NB_BASE_ROWS, bench.NB_STEPS) == \
        (1_000_000, 100_000, 8)
    assert (bench.KNN_QUERIES, bench.KNN_TRAIN, bench.CEILING_DIM) == \
        (8192, 131072, 128)
    assert (bench.RF_ROWS, bench.RF_TREES, bench.RF_DEPTH) == \
        (100_000, 5, 4)
    assert knn_sweep.K == 5


def test_bench_main_prints_one_json_line(capsys):
    assert bench.main(["--device", "cpu", "--nb-rows", "5000", "--queries",
                       "128", "--train", "1024", "--reps", "1",
                       "--rf-rows", "1000"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0])["nb"]["rows"] == 5000


def test_bench_apriori_section_on_cpu(capsys):
    """The Apriori section (the root bench's market baskets, support 0.02,
    length 3) at a small size: its three figures, rounds and sets equal to
    the JAX package's miner on the same baskets."""
    import numpy as np

    from avenir_tpu.models.association import (
        FrequentItemsApriori as JaxApriori, TransactionSet as JaxTx)

    assert (bench.APRIORI_TX, bench.APRIORI_VOCAB, bench.APRIORI_PICKS) == \
        (500_000, 100, 8)
    lines = []
    result = bench.run(device="cpu", nb_rows=5000, queries=128, train=1024,
                       reps=1, rf_rows=1000, apriori_tx=4000,
                       out=lines.append)
    assert json.loads(lines[-1]) == result
    picks = bench.apriori_picks(4000)
    mh = np.zeros((4000, 100), np.uint8)
    mh[np.arange(4000)[:, None], picks] = 1
    want = JaxApriori(0.02, 3).mine(JaxTx(
        mh, [f"i{j}" for j in range(100)],
        np.array([str(i) for i in range(4000)], dtype=object)))
    assert result["apriori_rounds"] == len(want) == 3
    assert result["apriori_frequent_sets"] == sum(len(isl) for isl in want)
    assert result["apriori_tx_scans_per_sec"] > 0
    capsys.readouterr()
    assert bench.main(["--device", "cpu", "--nb-rows", "5000", "--queries",
                       "128", "--train", "1024", "--reps", "1", "--rf-rows",
                       "1000", "--apriori-tx", "2000"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["apriori_rounds"] == 3


def test_bench_bandit_section_on_cpu(capsys):
    """The bandit section (the root bench's price-optimizer round: batch
    3, prob 0.5, constant 2.0, seed 3, 10 arms of seed-6 stats, 8 rounds)
    at a small size: its rate and groups; its last round's picks equal
    the JAX package's bandit on the same stats."""
    import numpy as np

    from avenir_tpu.models.bandits import (GreedyRandomBandit as JaxBandit,
                                           GroupBanditData as JaxData)

    assert (bench.BANDIT_GROUPS, bench.BANDIT_ARMS, bench.BANDIT_ROUNDS) == \
        (1_000_000, 10, 8)
    lines = []
    result = bench.run(device="cpu", nb_rows=5000, queries=128, train=1024,
                       reps=1, rf_rows=1000, bandit_groups=3000,
                       out=lines.append)
    assert json.loads(lines[-1]) == result
    assert result["bandit_groups"] == 3000
    assert result["bandit_group_decisions_per_sec"] > 0
    rng = np.random.default_rng(6)
    counts = rng.integers(0, 50, (3000, 10)).astype(np.int32)
    rewards = rng.random((3000, 10)).astype(np.float32) * 100.0
    ids = [[f"p{a}" for a in range(10)] for _ in range(3000)]
    kw = dict(batch_size=3, random_selection_prob=0.5,
              prob_reduction_constant=2.0, seed=3)
    from avenir_tpu_torch.models.bandits import (GreedyRandomBandit,
                                                 GroupBanditData)
    mine = GreedyRandomBandit(**kw, device="cpu")
    theirs = JaxBandit(**kw)
    data = GroupBanditData([f"g{i}" for i in range(3000)], ids, counts,
                           rewards, np.ones((3000, 10), bool))
    jdata = JaxData([f"g{i}" for i in range(3000)], ids, counts, rewards,
                    np.ones((3000, 10), bool))
    for r in range(1, bench.BANDIT_ROUNDS + 2):
        assert mine.select(data, r).tolist() == \
            np.asarray(theirs.select(jdata, r)).tolist()
    capsys.readouterr()
    assert bench.main(["--device", "cpu", "--nb-rows", "5000", "--queries",
                       "128", "--train", "1024", "--reps", "1", "--rf-rows",
                       "1000", "--bandit-groups", "500"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["bandit_groups"] == 500


def test_bench_nb_stream_csv_counts_equal_jax(tmp_path):
    """The NB CSV leg at 6,000 rows in 32 KB blocks: its end-to-end model's
    counts equal the JAX package's NaiveBayesModel streamed over the same
    file; every rate positive, the overlap a ratio of them."""
    import numpy as np

    from avenir_tpu.core import stream as jstream
    from avenir_tpu.core.schema import FeatureSchema as JaxSchema
    from avenir_tpu.models.naive_bayes import NaiveBayesModel as JaxNB
    from avenir_tpu_torch.data import churn_schema

    assert (bench.STREAM_ROWS, bench.STREAM_CHUNK, bench.STREAM_CSV_ROWS) \
        == (1_000_000_000, 8_000_000, 100_000_000)
    fig, model, path = bench.nb_stream_csv(torch.device("cpu"), 6000,
                                           block_bytes=32 << 10,
                                           stream_dir=tmp_path)
    assert path.read_text().count("\n") == 6000
    schema = JaxSchema.from_json(churn_schema().to_json())
    want = JaxNB.empty(schema)
    for ds in jstream.prefetched(jstream.iter_csv_chunks(
            str(path), schema, block_bytes=32 << 10)):
        codes, _ = ds.feature_codes(want.binned_fields)
        want.accumulate(codes, ds.labels(),
                        np.zeros((len(ds), 0), np.float32), defer=True)
    want.flush()
    np.testing.assert_array_equal(model.post_counts, want.post_counts)
    np.testing.assert_array_equal(model.class_counts, want.class_counts)
    assert model.class_counts.sum() == 6000
    rates = ("csv_rows_per_sec", "csv_parse_rows_per_sec",
             "csv_fold_rows_per_sec")
    assert all(fig[r] > 0 for r in rates)
    assert fig["csv_overlap_efficiency"] == pytest.approx(
        fig["csv_rows_per_sec"] / min(fig["csv_parse_rows_per_sec"],
                                      fig["csv_fold_rows_per_sec"]))
    # a second run finds the cached file by its marker
    mtime = path.stat().st_mtime_ns
    bench.nb_stream_csv(torch.device("cpu"), 6000, block_bytes=32 << 10,
                        stream_dir=tmp_path)
    assert path.stat().st_mtime_ns == mtime


def test_bench_knn_stream_merge_matches_jax_blocked():
    """The KNN stream's running merge over 4 rotated blocks of 4096 rows
    (64 queries, D 16, the lane kernel's plain version in float32)
    against the JAX package's blocked_topk_neighbors over the four blocks
    concatenated: the same indices, distances within the lane quantum."""
    import jax.numpy as jnp
    import numpy as np

    from avenir_tpu.ops.distance import blocked_topk_neighbors

    assert (bench.KNN_STREAM_BLOCK, bench.KNN_STREAM_TRAIN,
            bench.KNN_STREAM_QUERIES, bench.KNN_STREAM_DIM) == \
        (524_288, 1_000_341_504, 512, 128)
    assert bench.KNN_STREAM_BLOCK == kk.LANE_CORPUS_CAP
    q, t0 = bench.knn_stream_inputs(torch.device("cpu"), 4096, 16, 64)
    got_d, got_i = bench.knn_stream_fold(
        q, bench.rotated_blocks(t0, 4), compute_dtype="float32")
    t = torch.cat([torch.roll(t0, i, dims=1) for i in range(4)])
    ref_d, ref_i = blocked_topk_neighbors(jnp.asarray(q.numpy()),
                                          jnp.asarray(t.numpy()), k=5,
                                          block=4096, metric="euclidean")
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    quantum = 2.0 ** -(23 - kk.lane_pack_bits(4096))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d),
                               rtol=quantum, atol=0)
    assert got_i.dtype == torch.int64 and int(got_i.max()) < 4 * 4096


def test_bench_anchor_measures_positive_rates():
    """measure_baseline_anchor gives finite, positive per-node rates (as
    tests/test_stream_jobs.py holds the root bench's), and vs_baseline is
    the geometric mean of the two speedups."""
    import math

    anchor = bench.measure_baseline_anchor()
    assert set(anchor) == {"nb_node_rps", "pair_node_pps"}
    assert math.isfinite(anchor["nb_node_rps"]) and \
        anchor["nb_node_rps"] > 1e4
    assert math.isfinite(anchor["pair_node_pps"]) and \
        anchor["pair_node_pps"] > 1e5
    ratio = bench.vs_baseline(2e6, 488.28125, 131072, anchor)
    assert ratio["vs_baseline"] == pytest.approx(2.0)
    scale = 32 * 0.10
    assert ratio["vs_baseline_measured_anchor"] == pytest.approx(math.sqrt(
        2e6 / (scale * anchor["nb_node_rps"]) * 488.28125
        / (scale * anchor["pair_node_pps"] / 131072)))


def test_bench_stream_sections_in_the_json_line(capsys, tmp_path):
    """Every stream leg and the anchor through the CLI at tiny sizes: the
    JSON line carries vs_baseline and its anchored form beside the
    device's name and power limit, and the legs' figures."""
    assert bench.main(["--device", "cpu", "--nb-rows", "5000", "--queries",
                       "128", "--train", "1024", "--reps", "1", "--rf-rows",
                       "1000", "--anchor", "--nb-stream-rows", "20000",
                       "--nb-stream-csv-rows", "3000", "--knn-stream-train",
                       "8192", "--knn-csv-rows", "2048", "--stream-dir",
                       str(tmp_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert (line["device"], line["power_limit"]) == ("cpu", None)
    assert line["vs_baseline"] > 0 and line["vs_baseline_measured_anchor"] > 0
    assert line["nb_stream"]["class_count_sum"] == 20000
    assert line["nb_stream_csv"]["csv_rows"] == 3000
    assert line["knn_stream"]["train_rows"] == 8192
    assert line["knn_stream"]["lanes_launches"] == 0     # plain on the CPU
    assert line["knn_stream_csv"]["csv_rows"] == 2048
    for leg, rate in (("nb_stream", "gen_rows_per_sec"),
                      ("nb_stream_csv", "csv_rows_per_sec"),
                      ("knn_stream", "train_rows_per_sec"),
                      ("knn_stream_csv", "train_rows_per_sec")):
        assert line[leg][rate] > 0, leg


def test_bench_raises_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.run(nb_rows=5000, queries=128, train=1024, reps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])


# ------------------------------------------------------------------ knn_ab
def test_knn_ab_raises_without_a_device(monkeypatch, tmp_path):
    from avenir_tpu_torch.tools import knn_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        knn_ab.run(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA device"):
        knn_ab.main(["--parent", str(tmp_path)])


def test_knn_ab_counts_a_kernels_sass_instructions():
    """One function's instructions of `cuobjdump -sass` output, predicated
    ones included, never the encoding comments or another function's."""
    from avenir_tpu_torch.tools import knn_ab

    sass = """
\tcode for sm_90a
\t\tFunction : _ZN3knn19partial_topk_kernelILi16ELi0ELi0EEEvPKf
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                             /* 0x000e700000000800 */
\t\tFunction : _ZN3knn19partial_topk_kernelILi8ELi0ELi0EEEvPKf
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                             /* 0x000e700000000800 */
        /*0010*/              @!P0 FADD R2, R3, -R4 ;       /* 0x0000000403027221 */
        /*0020*/              @UP1 BRA 0x1c0 ;              /* 0x0000000000007947 */
        /*0030*/                   EXIT ;                   /* 0x000000000000794d */
"""
    assert knn_ab.sass_instructions(sass, knn_ab.K8_L1_EXACT) == 4
    assert knn_ab.sass_instructions(sass, "ILi16ELi0ELi0E") == 1
    assert knn_ab.sass_instructions(sass, "ILi64E") == 0


def _bf16_pair(mode, scale=1.0):
    """[keys, indices] (or [scores]) of the plain bf16 version on a small
    CPU corpus, and the same with every distance key scaled by `scale`."""
    gen = torch.Generator().manual_seed(11)
    q = torch.rand(64, 16, generator=gen)
    t = torch.rand(900, 16, generator=gen)
    labels = torch.randint(0, 2, (900,), generator=gen, dtype=torch.int32)
    if mode == "labels":
        ref = kk.knn_classify_lanes_plain(q, t, labels, 5, 2, 16, "gaussian",
                                          30.0, compute_dtype="bfloat16")
        return q, t, [ref], [ref * scale]
    _, mask, empty = kk._key_spec(mode, t)
    key, idx = kk._select_plain(q, t, 5, "euclidean", 900, mode, mask, empty,
                                True)
    bits = (key & ~mask).view(torch.float32) * scale
    return q, t, [key, idx], [(bits.view(torch.int32) & ~mask) | (key & mask),
                              idx]


@pytest.mark.parametrize("mode", ["exact", "lanes", "packed", "labels"])
def test_knn_ab_bf16_row_is_held_by_the_tolerance(monkeypatch, mode):
    """A bfloat16 row compares the two forms by bf16_agrees, not bit for
    bit: a change of 2e-6 in every distance agrees, 2% does not (a vote by
    its arg-max), and the row gives both times and their ratio."""
    from avenir_tpu_torch.tools import knn_ab

    times = iter([4.0, 1.0, 1.2, 4.2] * 2)
    monkeypatch.setattr(knn_ab, "cuda_ms", lambda fn, reps: next(times))
    lines = []
    for scale, agrees in ((1 + 2e-6, True), (1.02 if mode != "labels"
                                             else -1.0, False)):
        q, t, old, new = _bf16_pair(mode, scale)

        def bf16_close(a, b):
            return knn_ab.bf16_agrees(mode, q, t, 5, a, b)
        row = knn_ab.ab_row(lambda: old, lambda: new, 1, lines.append,
                            agree=bf16_close, d=16, metric="euclidean",
                            mode=mode, dtype="bfloat16",
                            forms="cuda-core/tensor-core")
        assert row["agree"] is agrees and row["by"] == "bf16_close"
        assert row["ratio"] == pytest.approx(4.1 / 1.1)
    assert lines[0].startswith(f"close D=16 euclidean {mode} bfloat16 "
                               "cuda-core/tensor-core")
    assert lines[1].startswith("DIFF (")
    assert not knn_ab.bit_equal(old, old) and knn_ab.bit_equal(old, new)


def test_knn_ab_earlier_bf16_side_is_its_own_cuda_core_form(monkeypatch):
    """The earlier version's bfloat16 call runs its own pre-pass with its
    own bf16 operands, then its own tensor-core entries (the form this
    checkout's replaces), never the CUDA-core form; an earlier library
    without the persistent schedule's plan entry takes (splits,
    rows_per_split) from its own stage rows."""
    from avenir_tpu_torch.tools import knn_ab
    from test_torch_knn_kernels import _FakeFormLib, _on_a_fake_card

    class Prepass:
        def __init__(self):
            self.bf16 = []

        def knn_prepass_launch(self, q, nq, t, nt, d, bf16, *rest):
            self.bf16.append(bf16)
            return 0

    _on_a_fake_card(monkeypatch)
    q, t = torch.rand(32, 8), torch.rand(512, 8)
    labels = torch.zeros(512, dtype=torch.int32)
    for mode in ("lanes", "labels"):
        topk, classify, pre = _FakeFormLib(), _FakeFormLib(), Prepass()
        knn_ab.current_call(mode, q, t, labels, "euclidean", True,
                            (topk, classify, pre))()
        lib = classify if mode == "labels" else topk
        name = "knn_classify" if mode == "labels" else "knn_topk"
        assert lib.called == [f"{name}_mma_info", f"{name}_mma_launch"]
        assert pre.bf16 == [1]
        splits, rows = kk._splits(32, knn_ab.NT, 132, 3, 64, kk.MMA_BQ)
        at = 15 if mode == "labels" else 11
        assert tuple(lib.args[0][at:at + 2]) == (splits, rows)
    assert kk.knn_partial_mma.launches == 2


def test_bind_skips_entries_an_earlier_build_lacks():
    """An earlier version's library has the launch entries but not this
    checkout's further ones: bind declares what it has, and a missing
    launch entry still fails."""
    import ctypes

    from avenir_tpu_torch.ops import _build

    class Entry:
        pass

    class Earlier:
        knn_topk_launch = Entry()
        knn_topk_partial_info = Entry()

    lib = _build.bind(Earlier(), "knn_topk")
    assert lib.knn_topk_launch.restype is ctypes.c_int
    assert lib.knn_topk_launch.argtypes == _build.LIBRARIES["knn_topk"][2]
    assert lib.knn_topk_partial_info.argtypes == \
        _build.INFO["knn_topk"]["knn_topk_partial_info"]
    assert not hasattr(lib, "knn_topk_mma_launch")

    class Broken:
        knn_topk_partial_info = Entry()
    with pytest.raises(AttributeError):
        _build.bind(Broken(), "knn_topk")


def test_knn_ab_merge_lists_cover_the_paths_and_every_width():
    """The merge rows run on the job's lists (D=6 manhattan float32, k=5,
    exact), the bench's (D=128 euclidean bfloat16, k=5, lanes) and lists
    of every carry width."""
    from avenir_tpu_torch.tools import knn_ab

    lists = {name: rest for name, *rest in knn_ab.MERGE_LISTS}
    assert lists["job"] == [6, "manhattan", "float32", knn_ab.K, "exact"]
    assert lists["bench"] == [128, "euclidean", "bfloat16", knn_ab.K,
                              "lanes"]
    assert {kk._carry_width(k) for *_, k, _ in lists.values()} == \
        {8, 16, 32, 64}


def test_knn_ab_row_times_by_its_timer_in_turns():
    """A merge row is timed by its own timer (the device's time), in the
    turns earlier, current, current, earlier."""
    from avenir_tpu_torch.tools import knn_ab

    calls, lines = [], []
    old, new = (lambda: [torch.ones(3)]), (lambda: [torch.ones(3)])

    def timer(fn, reps):
        calls.append("earlier" if fn is old else "current")
        return 0.004 if fn is old else 0.002
    row = knn_ab.ab_row(old, new, 3, lines.append, timer=timer, d=6,
                        metric="manhattan", mode="merge_topk", dtype="float32")
    assert calls == ["earlier", "current", "current", "earlier"]
    assert row["agree"] and row["ratio"] == pytest.approx(2.0)
    assert lines == ["same D=6 manhattan merge_topk float32: earlier 0.00400 "
                     "ms (0.00400, 0.00400), current 0.00200 ms (0.00200, "
                     "0.00200), x2.00"]


def test_bind_declares_the_merge_entries():
    """The merge instances' info entries, the merges' layout and the
    launch floor are bound with their argument types where a library has
    them."""
    import ctypes

    from avenir_tpu_torch.ops import _build

    class Entry:
        pass

    class Current:
        knn_topk_launch = Entry()
        knn_topk_merge_info = Entry()
        knn_merge_layout = Entry()
        knn_merge_floor_launch = Entry()

    lib = _build.bind(Current(), "knn_topk")
    for name in ("knn_topk_merge_info", "knn_merge_layout",
                 "knn_merge_floor_launch"):
        assert getattr(lib, name).argtypes == _build.INFO["knn_topk"][name]
        assert getattr(lib, name).restype is ctypes.c_int


@pytest.mark.parametrize("vote", [False, True])
def test_merge_info_reads_the_instance_or_raises(vote):
    """merge_info asks the library's merge_info entry for the instance of
    k's carry width and raises on a CUDA error."""
    name = "knn_classify_merge_info" if vote else "knn_topk_merge_info"

    class Lib:
        def __init__(self, err):
            self.err, self.ks = err, []

        def __getattr__(self, entry):
            assert entry == name

            def info(k, out):
                self.ks.append(k)
                out[0], out[1], out[2] = 5, 47, 0
                return self.err
            return info
    lib = Lib(0)
    assert kk.merge_info(13, vote, lib) == (5, 47, 0) and lib.ks == [13]
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        kk.merge_info(5, vote, Lib(98))


def test_merge_layout_reads_the_library_or_raises():
    """merge_layout gives the group, blocks, threads and lists a lane that
    the library's knn_merge_layout reports for (nq, splits), and raises on
    a CUDA error."""
    class Lib:
        def __init__(self, err):
            self.err, self.calls = err, []

        def knn_merge_layout(self, nq, splits, out):
            self.calls.append((nq, splits))
            out[0], out[1], out[2], out[3] = 32, 1024, 256, 2
            return self.err
    lib = Lib(0)
    assert kk.merge_layout(8192, 33, lib) == dict(group=32, blocks=1024,
                                                  threads=256, own=2)
    assert lib.calls == [(8192, 33)]
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        kk.merge_layout(8192, 6, Lib(1))


# -------------------------------------------------------------- ceiling_ab
def test_ceiling_ab_raises_without_a_device(monkeypatch, tmp_path):
    from avenir_tpu_torch.tools import ceiling_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ceiling_ab.run(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ceiling_ab.main(["--parent", str(tmp_path)])


def test_ceiling_ab_counts_tensor_core_and_tma_instructions():
    """HGMMA, HMMA and UTMALDG instructions of `cuobjdump -sass` output,
    predicated and suffixed ones included, never the encoding comments."""
    from avenir_tpu_torch.tools import ceiling_ab

    sass = """
\t\tFunction : _ZN20ceiling_wgmma_kernelILi2EEEv
        /*0000*/                   UTMALDG.2D [UR8], [UR14] ;   /* 0x00000008ff0075b4 */
                                                                 /* 0x0001e20008019000 */
        /*0010*/              @!P0 UTMALDG.2D [UR16], [UR14] ;  /* 0x00000010ff0075b4 */
        /*0020*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24 ;
        /*0030*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0040*/                   EXIT ;                       /* 0x000000000000794d */
"""
    assert ceiling_ab.sass_counts(sass) == {"HGMMA": 1, "HMMA": 1,
                                            "UTMALDG": 2}
    assert ceiling_ab.sass_counts("") == {"HGMMA": 0, "HMMA": 0,
                                          "UTMALDG": 0}


def test_ceiling_ab_reads_resource_usage_and_spills():
    from avenir_tpu_torch.tools import ceiling_ab

    usage = """
Resource usage:
 Common:
  GLOBAL:0
 Function _Z21ceiling_reduce_kernelPKfiixiiPf:
  REG:30 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:400 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN20ceiling_wgmma_kernelILi2EEEv14CUtensorMap_st:
  REG:168 STACK:8 SHARED:0 LOCAL:16 CONSTANT[0]:700 TEXTURE:0 SURFACE:0 SAMPLER:0
"""
    assert ceiling_ab.res_usage(usage, ceiling_ab.MAIN_KERNEL["current"]) \
        == (168, 8, 16)
    assert ceiling_ab.res_usage(usage, "ceiling_reduce") == (30, 0, 0)
    assert ceiling_ab.res_usage(usage, "ILi1E") is None
    log = """ptxas info    : Function properties for _Z3fooPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _Z3barPf
    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads
"""
    assert ceiling_ab.ptxas_spills(log) == {"_Z3fooPf": 0, "_Z3barPf": 16}


def test_ceiling_ab_binds_the_earlier_interface():
    """The earlier mma.sync ceiling takes 9 arguments and 4096 train rows
    a split; this checkout's takes 12."""
    from avenir_tpu_torch.ops import _build
    from avenir_tpu_torch.tools import ceiling_ab

    assert len(ceiling_ab.PARENT_ARGS) == 9
    assert ceiling_ab.PARENT_ROWS_PER_SPLIT == 4096
    assert len(_build.LIBRARIES["matmul_ceiling"][2]) == 12
