"""The port's batch bandits against the JAX package on the CPU.

Each of the four round jobs writes the JAX package's selection file, at
rounds 1, 2 and 10 and batch sizes 1 and 3: epsilon-greedy with linear
and logLinear decay and with selection.unique, auerGreedy, UCB1 with
untried items tied at +inf, random-first and softmax, on ragged groups
(groups with fewer items, repeated rewards, untried items). A decision
that hangs on a float32 log may round apart from XLA's; such a group is
counted by `tools.bandit_check.near_tie_groups` (within 2 float32 ULP,
recomputed in float64), every differing group must be one of them, and
on these seeds there are none: the files are byte-identical. Then the `bandit_round`
loop of the reference's tests/test_pipelines.py:109.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.data import generate_price_opt as jax_generate_price_opt
from avenir_tpu.models import bandits as jb
from avenir_tpu.pipelines import bandit_round as jax_bandit_round
from avenir_tpu.runner import run_job as jax_run_job
from avenir_tpu_torch.data import generate_price_opt
from avenir_tpu_torch.models import bandits
from avenir_tpu_torch.pipelines import bandit_round
from avenir_tpu_torch.runner import (build_bandit_job, job_names, job_prefix,
                                     run_job)
from avenir_tpu_torch.tools import bandit_check

CPU = "cpu"


def _stats(path: Path, groups: int = 60, seed: int = 5) -> str:
    """Group item stats rows: 2-10 items a group, a fifth untried (count
    0), rewards in [0, 100) with repeats."""
    rng = np.random.default_rng(seed)
    lines = []
    for g in range(groups):
        for a in range(int(rng.integers(2, 11))):
            count = 0 if rng.random() < 0.2 else int(rng.integers(1, 60))
            reward = float(rng.integers(0, 40)) * 2.5
            lines.append(f"g{g},p{a},{count},{reward}")
    order = rng.permutation(len(lines))
    path.write_text("\n".join(lines[i] for i in order) + "\n")
    return str(path)


#: (job, its keys): every selection route of the four jobs
CASES = {
    "linear": ("greedyRandomBandit",
               {"grb.random.selection.prob": "0.5",
                "grb.prob.reduction.constant": "2.0"}),
    "logLinear": ("greedyRandomBandit",
                  {"grb.random.selection.prob": "0.6",
                   "grb.prob.reduction.algorithm": "logLinear",
                   "grb.prob.reduction.constant": "1.5"}),
    "unique": ("greedyRandomBandit",
               {"grb.random.selection.prob": "0.4",
                "grb.selection.unique": "true"}),
    "auerGreedy": ("greedyRandomBandit",
                   {"grb.prob.reduction.algorithm": "auerGreedy",
                    "grb.auer.greedy.constant": "0.3"}),
    "ucb1": ("auerDeterministic", {}),
    "randomFirst": ("randomFirstGreedyBandit", {}),
    "softmax": ("softMaxBandit", {"smb.temp.constant": "12.5"}),
}


def _rows(path: str):
    return [ln.split(",") for ln in Path(path).read_text().splitlines()]


def _by_group(path: str):
    out = {}
    for g, item in _rows(path):
        out.setdefault(g, []).append(item)
    return out


def _near_ties(name, props, csv, round_num, got_path):
    """The groups of the port's selection within 2 ULP of a float32 log
    decision."""
    data = bandits.GroupBanditData.from_rows(_rows(csv))
    got = _by_group(got_path)
    sel = np.array([[data.item_ids[gi].index(it) for it in got[g]]
                    for gi, g in enumerate(data.group_ids)])
    near = bandit_check.near_tie_groups(build_bandit_job(name, props, CPU),
                                        data, round_num, sel)
    assert near.shape == (len(data.group_ids),)
    return {g for g, n in zip(data.group_ids, near) if n}


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("round_num", [1, 2, 10])
@pytest.mark.parametrize("case", sorted(CASES))
def test_selection_file_equals_jax(tmp_path, case, round_num, batch):
    name, props = CASES[case]
    prefix = job_prefix(name)
    csv = _stats(tmp_path / "stats.csv", seed=round_num * 7 + batch)
    props = {**props, f"{prefix}.global.batch.size": str(batch),
             f"{prefix}.current.round.num": str(round_num)}
    got = run_job(name, props, [csv], str(tmp_path / "port.txt"), device=CPU)
    want = jax_run_job(name, props, [csv], str(tmp_path / "jax.txt"))
    assert got.counters == want.counters == {"Bandit:Groups": 60}
    a, b = _by_group(got.outputs[0]), _by_group(want.outputs[0])
    differ = {g for g in a if a[g] != b[g]}
    near = _near_ties(name, props, csv, round_num, got.outputs[0])
    assert differ <= near, f"not near ties: {sorted(differ - near)}"
    assert not differ
    assert Path(got.outputs[0]).read_bytes() == \
        Path(want.outputs[0]).read_bytes()


def test_untried_items_rank_lower_index_first(tmp_path):
    """UCB1 and auerGreedy rank the +inf scores of untried items as
    jax.lax.top_k does: the lower index first."""
    csv = tmp_path / "s.csv"
    csv.write_text("".join(f"g{g},p{a},0,{a}\n" for g in range(3)
                           for a in range(6)))
    for name, props in (("auerDeterministic", {"aue.global.batch.size": "4"}),
                        ("greedyRandomBandit",
                         {"grb.global.batch.size": "4",
                          "grb.prob.reduction.algorithm": "auerGreedy",
                          "grb.auer.greedy.constant": "0.0"})):
        got = run_job(name, props, [str(csv)], str(tmp_path / "p.txt"),
                      device=CPU)
        want = jax_run_job(name, props, [str(csv)], str(tmp_path / "j.txt"))
        text = Path(got.outputs[0]).read_text()
        assert text == Path(want.outputs[0]).read_text()
        assert _by_group(got.outputs[0])["g0"] == ["p0", "p1", "p2", "p3"]


def test_decision_counts_and_output_modes(tmp_path):
    csv = _stats(tmp_path / "s.csv", groups=20, seed=3)
    props = {"grb.global.batch.size": "5", "grb.output.decision.count":
             "true", "grb.random.selection.prob": "0.9"}
    got = run_job("greedyRandomBandit", props, [csv],
                  str(tmp_path / "p.txt"), device=CPU)
    want = jax_run_job("greedyRandomBandit", props, [csv],
                       str(tmp_path / "j.txt"))
    assert Path(got.outputs[0]).read_bytes() == \
        Path(want.outputs[0]).read_bytes()
    assert all(len(r) == 3 for r in _rows(got.outputs[0]))


def test_selection_math_against_jax_kernels():
    """The selection functions on tensors against the reference's jitted
    kernels at 400 groups: equal picks."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    g, a = 400, 9
    mask = rng.random((g, a)) < 0.8
    mask[:, 0] = True
    rewards = (rng.integers(0, 30, (g, a)) * 1.5).astype(np.float32)
    counts = rng.integers(0, 4, (g, a)).astype(np.int32)
    key = bandits.prng.PRNGKey(9)
    jkey = jax.random.PRNGKey(9)
    for log_linear, unique in ((False, False), (True, True)):
        got = bandits._eps_greedy(key, torch.from_numpy(rewards),
                                  torch.from_numpy(mask), 3.0, 0.7, 1.2,
                                  0.05, 4, log_linear, unique)
        want = jb._eps_greedy_kernel(jkey, jnp.asarray(rewards),
                                     jnp.asarray(mask), 3.0, 0.7, 1.2, 0.05,
                                     4, log_linear, unique)
        assert got.numpy().tolist() == np.asarray(want).tolist()
    got = bandits._ucb1(torch.from_numpy(counts), torch.from_numpy(rewards),
                        torch.from_numpy(mask), 4.0, 50.0, 3)
    want = jb._ucb1_kernel(jnp.asarray(counts), jnp.asarray(rewards),
                           jnp.asarray(mask), 4.0, 50.0, 3)
    assert got.numpy().tolist() == np.asarray(want).tolist()
    got = bandits._softmax(key, torch.from_numpy(rewards),
                           torch.from_numpy(mask), 5.0, 3)
    want = jb._softmax_kernel(jkey, jnp.asarray(rewards), jnp.asarray(mask),
                              5.0, 3)
    assert got.numpy().tolist() == np.asarray(want).tolist()
    score = np.where(mask, rewards, -1e30).astype(np.float32)
    got = bandits._ranked_batch(torch.from_numpy(score),
                                torch.from_numpy(mask), 12)
    want = jb._ranked_batch(jnp.asarray(score), jnp.asarray(mask), 12)
    assert got.numpy().tolist() == np.asarray(want).tolist()


def test_group_data_equals_jax(tmp_path):
    rows = _rows(_stats(tmp_path / "s.csv", groups=25, seed=8))
    got = bandits.GroupBanditData.from_rows(rows)
    want = jb.GroupBanditData.from_rows(rows)
    assert got.group_ids == want.group_ids and got.item_ids == want.item_ids
    for f in ("counts", "rewards", "mask"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    sel = np.zeros((25, 2), np.int64)
    assert got.selections_to_rows(sel, True) == \
        want.selections_to_rows(sel, True)


@pytest.mark.parametrize("delim", [",", ";", "::"])
def test_group_data_from_lines_equals_jax(tmp_path, delim):
    """The column-wise parse of the job's lines equals the reference's
    row parse (tokens stripped), white space and a wide row included."""
    lines = Path(_stats(tmp_path / "s.csv", groups=25, seed=9)) \
        .read_text().splitlines()
    lines = [ln.replace(",", delim) for ln in lines]
    lines[3] = " " + lines[3].replace(delim, f" {delim}\t") + f"{delim}x"
    got = bandits.GroupBanditData.from_lines(lines, delim)
    want = jb.GroupBanditData.from_rows(
        [[t.strip() for t in ln.split(delim)] for ln in lines])
    assert got.group_ids == want.group_ids and got.item_ids == want.item_ids
    for f in ("counts", "rewards", "mask"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    swapped = [delim.join([*f[:2], f[3], f[2]]) for f in
               (ln.split(delim) for ln in lines)]
    got = bandits.GroupBanditData.from_lines(swapped, delim, count_ord=3,
                                             reward_ord=2)
    want = jb.GroupBanditData.from_rows(
        [[t.strip() for t in ln.split(delim)] for ln in swapped],
        count_ord=3, reward_ord=2)
    for f in ("counts", "rewards", "mask"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    with pytest.raises(IndexError, match="row 1 has 3 fields"):
        bandits.GroupBanditData.from_lines(
            [lines[0], delim.join(lines[1].split(delim)[:3])], delim)


@pytest.mark.parametrize("seed", [17, 44])
def test_price_opt_rows_equal_jax(seed):
    assert generate_price_opt(num_products=6, seed=seed) == \
        jax_generate_price_opt(num_products=6, seed=seed)


def test_bandit_round_loop(tmp_path):
    """The price-optimize tutorial loop (the reference's
    tests/test_pipelines.py:109): rounds feed rewards back, greedy with no
    exploration repeats itself; every round's file equals the JAX
    package's."""
    rows = generate_price_opt(num_products=4, seed=44)
    stats = str(tmp_path / "stats.csv")
    with open(stats, "w") as fh:
        for r in rows:
            fh.write(",".join(r) + "\n")
    picks = []
    conf = {"grb.global.batch.size": "1", "grb.random.selection.prob": "0.0"}
    for rnd in [1, 10, 100]:
        out = str(tmp_path / f"round{rnd}.txt")
        res = bandit_round(conf, stats, out, rnd, device=CPU)
        assert res.counters["Bandit:Groups"] == 4
        jax_out = str(tmp_path / f"jax{rnd}.txt")
        jax_bandit_round(conf, stats, jax_out, rnd)
        picks.append(open(out).read())
        assert picks[-1] == open(jax_out).read()
    assert picks[1] == picks[2]


def test_jobs_are_registered_and_want_a_card(tmp_path, monkeypatch):
    assert {"greedyRandomBandit", "auerDeterministic",
            "randomFirstGreedyBandit", "softMaxBandit",
            "org.avenir.reinforce.GreedyRandomBandit",
            "org.avenir.reinforce.SoftMaxBandit"} <= set(job_names())
    assert [job_prefix(n) for n in ("greedyRandomBandit",
                                    "auerDeterministic",
                                    "randomFirstGreedyBandit",
                                    "softMaxBandit")] == \
        ["grb", "aue", "rfg", "smb"]
    csv = _stats(tmp_path / "s.csv", groups=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_job("softMaxBandit", {}, [csv], str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bandit_round({}, csv, str(tmp_path / "o"), 1)
    with pytest.raises(ValueError, match="invalid bandit job"):
        bandits.make_bandit_job("nope", 1, device=CPU)
