"""The port's sharded surface on the CPU: the CLI's `--shard` (the same
bytes as `run_sharded` and the solo job; a non-streamed job refused with
the reference's error), lost workers raising `ShardError`, a worker that
cannot open the plan's device failing the run with its log (never folding
on the CPU instead), and the per-k rounds under a cache budget smaller
than a block, which count from slice files of the blocks' bytes."""

import json
import os
import subprocess
import sys

import pytest
import torch_reference_native  # noqa: F401  (settles the reference's native route)
import torch

from avenir_tpu_torch.dist import ShardError, StragglerPolicy, run_sharded
from avenir_tpu_torch.dist import driver
from avenir_tpu_torch.runner import run_job

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
TIMEOUT_S = 150.0
QUIET = StragglerPolicy(mirror_floor_s=60.0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from avenir_tpu.data import churn_schema, generate_churn

    d = tmp_path_factory.mktemp("dist_cli")
    csv = str(d / "churn.csv")
    with open(csv, "w") as fh:
        fh.write(generate_churn(2000, seed=19, as_csv=True))
    schema = str(d / "churn.json")
    churn_schema().save(schema)
    seq = str(d / "seq.csv")
    with open(seq, "w") as fh:
        for i in range(1500):
            tail = ",".join("LMHX"[(i * 7 + j) % 4] for j in range(i % 5 + 2))
            fh.write(f"c{i},{'T' if i % 2 else 'F'},{tail}\n")
    return {"csv": csv, "schema": schema, "seq": seq}


def _cli(*args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "avenir_tpu_torch", *args],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT, env=env)


def test_cli_shard_flag(corpus, tmp_path):
    conf = str(tmp_path / "gsp.properties")
    with open(conf, "w") as fh:
        fh.write("cgs.support.threshold=0.2\ncgs.item.set.length=3\n"
                 "cgs.skip.field.count=2\ncgs.stream.block.size.mb=0.005\n")
    solo = run_job("candidateGenerationWithSelfJoin", conf, [corpus["seq"]],
                   str(tmp_path / "solo"), device=CPU)
    out = str(tmp_path / "cli")
    proc = _cli("candidateGenerationWithSelfJoin", "--shard", "2",
                "--device", "cpu", "--conf", conf, corpus["seq"], out)
    assert proc.returncode == 0, proc.stderr[-2000:]
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    assert row["counters"]["Shard:Workers"] == 2.0
    assert row["counters"]["Shard:PerKRounds"] >= 1.0
    assert sorted(w["worker"] for w in row["workers"]) == [0, 1]
    assert all(w["device"] == "cpu" for w in row["workers"])
    res = run_sharded("candidateGenerationWithSelfJoin", conf,
                      [corpus["seq"]], str(tmp_path / "api"), procs=2,
                      device=CPU, timeout_s=TIMEOUT_S)
    for a, b, c in zip(sorted(solo.outputs), sorted(row["outputs"]),
                       sorted(res.outputs)):
        assert open(a, "rb").read() == open(b, "rb").read() == \
            open(c, "rb").read()


def test_cli_shard_refuses_a_job_without_a_stream_fold(corpus, tmp_path):
    conf = str(tmp_path / "dt.properties")
    with open(conf, "w") as fh:
        fh.write(f"dtb.feature.schema.file.path={corpus['schema']}\n")
    proc = _cli("decTree", "--shard", "2", "--device", "cpu", "--conf",
                conf, corpus["csv"], str(tmp_path / "o"), timeout=120)
    assert proc.returncode != 0
    assert "has no registered stream fold; streamed jobs:" in proc.stderr
    from avenir_tpu.runner import stream_fold_ops as jax_ops
    from avenir_tpu_torch.runner import stream_fold_ops

    with pytest.raises(KeyError) as port_err:
        stream_fold_ops("decTree")
    with pytest.raises(KeyError) as jax_err:
        jax_ops("decTree")
    assert str(port_err.value) == str(jax_err.value)


def test_lost_workers_raise_with_blocks_outstanding(corpus, tmp_path):
    def kill_all(pids, root):
        import signal

        for pid in pids:
            os.kill(pid, signal.SIGKILL)

    with pytest.raises(ShardError, match="lost its workers"):
        run_sharded("mutualInformation",
                    {"mut.feature.schema.file.path": corpus["schema"]},
                    [corpus["csv"]], str(tmp_path / "dead.txt"), procs=2,
                    factor=2, worker_hook=kill_all, device=CPU,
                    timeout_s=TIMEOUT_S)


def test_a_worker_without_the_device_fails_the_run(corpus, tmp_path,
                                                   monkeypatch):
    """A plan on cuda, here where no worker can open cuda: every worker
    dies before the barrier and the run raises with their logs; nothing
    is folded on the CPU."""
    assert not torch.cuda.is_available()
    monkeypatch.setattr(driver, "resolve_device",
                        lambda device: torch.device("cuda"))
    root = str(tmp_path / "root")
    os.makedirs(root)
    with pytest.raises(ShardError) as err:
        run_sharded("mutualInformation",
                    {"mut.feature.schema.file.path": corpus["schema"]},
                    [corpus["csv"]], str(tmp_path / "nodev.txt"), procs=2,
                    device="cuda", shard_root=root, timeout_s=TIMEOUT_S)
    assert "runs on a CUDA device by default and none is available" in \
        str(err.value)
    assert json.load(open(os.path.join(root, "plan.json")))["device"] == \
        "cuda"
    assert not os.listdir(os.path.join(root, "ledger", "states")) or \
        os.listdir(os.path.join(root, "ledger", "states")) == ["FORMAT.json"]
    assert not os.path.exists(str(tmp_path / "nodev.txt"))


@pytest.mark.parametrize("job,prefix", [
    ("frequentItemsApriori", "fia"),
    ("candidateGenerationWithSelfJoin", "cgs")])
def test_per_k_rounds_from_slices_under_a_tiny_cache_budget(
        corpus, tmp_path, job, prefix):
    """Every block's cache is larger than a 524-byte budget, so it is
    evicted as it spills: each per-k count reads a slice file of its
    block."""
    conf = {f"{prefix}.support.threshold": "0.2",
            f"{prefix}.item.set.length": "3",
            f"{prefix}.skip.field.count": "2",
            f"{prefix}.stream.block.size.mb": "0.005",
            f"{prefix}.stream.encoded.cache.budget.mb": "0.0005"}
    solo = run_job(job, conf, [corpus["seq"]], str(tmp_path / "solo"),
                   device=CPU)
    assert solo.counters["Cache:EvictedBytes"] > 0
    root = str(tmp_path / "root")
    os.makedirs(root)
    res = run_sharded(job, conf, [corpus["seq"]], str(tmp_path / "sharded"),
                      procs=2, factor=2, policy=QUIET, device=CPU,
                      shard_root=root, timeout_s=TIMEOUT_S)
    for a, b in zip(sorted(solo.outputs), sorted(res.outputs)):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert len(res.outputs) == len(solo.outputs) >= 2
    assert res.counters["Cache:EvictedBytes"] > 0
    assert res.counters["Shard:PerKRounds"] >= 1.0
    # a slice file of each block, by whichever worker counted it
    slices = os.listdir(os.path.join(root, "slices"))
    assert {s.split("_b")[1] for s in slices} == \
        {f"{b}.bin" for b in range(4)}
