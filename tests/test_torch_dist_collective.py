"""The collective merge (`dist/collective.py`) and the scaling module
(`parallel/scaling.py`) on a gloo world of two CPU ranks
(`tests/torch_parallel_world.py` `pair_main`): `allsum_carry` equal to the
float64 sum of both ranks' carries and refused outside a group, each
family's logged collective payloads equal to `collective_payload_model`,
and `measure_scaling`'s table. One module-scoped fixture spawns the
world."""

import numpy as np
import pytest

import torch_parallel_world as world
from avenir_tpu_torch.dist.collective import (CollectiveUnavailable,
                                              allsum_carry, collective_ready)
from avenir_tpu_torch.parallel.scaling import (collective_payload_model,
                                               nb_payload_bytes,
                                               project_efficiency)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return world.spawn_world(str(tmp_path_factory.mktemp("pair")), 120,
                             target=world.pair_main, world=2)


def test_gate_is_closed_outside_a_group():
    assert collective_ready() is False
    with pytest.raises(CollectiveUnavailable, match="more than one rank"):
        allsum_carry({"counts": np.zeros(3)})


def test_gate_in_the_world(ranks):
    for r in (0, 1):
        assert ranks[r]["ready_before"] is False
        assert "more than one rank" in ranks[r]["refused_before"]
        assert ranks[r]["ready"] is True


def test_allsum_carry_is_the_float64_sum(ranks):
    a, b = world._carry(0), world._carry(1)
    for r in (0, 1):
        got = ranks[r]["allsum"]
        assert sorted(got) == sorted(a)
        for k in a:
            want = np.add(a[k], b[k], dtype=np.float64)
            assert got[k].dtype == np.float64
            assert got[k].shape == np.shape(a[k])
            assert np.array_equal(got[k], want)


def _dims(fam, mesh_name):
    shape = {"2x1": {"data": 2}, "1x2": {"data": 1, "model": 2}}[mesh_name]
    d = world.inputs()
    dims = {"knn_topk": dict(nq=d["knn_topk"]["q"].shape[0], k=world.K_NN),
            "nb_train": dict(n_feat=d["nb_train"]["codes"].shape[1],
                             **world.NB),
            "tree_level": world.TREE,
            "lr_step": dict(d=d["lr_step"]["x"].shape[1]),
            "markov_counts": world.MARKOV,
            "apriori_support": dict(
                n_cand=d["apriori_support"]["cand"].shape[0]),
            "bandit_select": {}, "crosscount": world.CROSS}[fam]
    return shape, dims


@pytest.mark.parametrize("mesh_name", ["2x1", "1x2"])
@pytest.mark.parametrize("fam", ["knn_topk", "nb_train", "tree_level",
                                 "lr_step", "markov_counts",
                                 "apriori_support", "bandit_select",
                                 "crosscount"])
def test_logged_payload_equals_the_model(ranks, mesh_name, fam):
    shape, dims = _dims(fam, mesh_name)
    want = collective_payload_model(fam, shape, **dims)
    for r in (0, 1):
        log = ranks[r][mesh_name][fam]
        assert ranks[r][mesh_name]["shape"] == shape
        assert sum(c["payload_bytes"] for c in log) == want
        ops = {c["op"] for c in log}
        if fam == "bandit_select" or (fam == "knn_topk"
                                      and mesh_name == "2x1"):
            assert log == [] and want == 0
        elif fam == "knn_topk":
            assert ops == {"all_gather"} and len(log) == 2
        else:
            assert ops == {"all_reduce"}


def test_payload_model_is_the_reference_layout_in_port_types():
    """The count families' cells are int64 here, float32 in the
    reference's psums: twice the bytes, the same cells."""
    from avenir_tpu.parallel import scaling as jscaling

    cases = [("nb_train", {}, dict(n_feat=8, num_classes=2, bmax=10)),
             ("tree_level", {}, dict(n_leaves=4, n_splits=5, smax=3,
                                     num_classes=2)),
             ("lr_step", {}, dict(d=7)),
             ("markov_counts", {}, dict(n_classes=2, n_states=4)),
             ("apriori_support", {}, dict(n_cand=33)),
             ("crosscount", {}, dict(bins_a=4, bins_b=5))]
    for fam, shape, dims in cases:
        assert collective_payload_model(fam, shape, **dims) == \
            2 * jscaling.collective_payload_model(fam, shape, **dims)
    for shape in ({"data": 4}, {"data": 2, "model": 2},
                  {"data": 1, "model": 4}):
        assert collective_payload_model("knn_topk", shape, nq=64, k=5) == \
            jscaling.collective_payload_model("knn_topk", shape, nq=64,
                                              k=5)
    assert collective_payload_model("bandit_select", {}) == 0
    assert nb_payload_bytes() == 2 * jscaling.nb_payload_bytes()
    with pytest.raises(KeyError):
        collective_payload_model("nope", {})


def test_measure_scaling_on_the_world(ranks):
    for r in (0, 1):
        s = ranks[r]["scaling"]
        assert s["ranks"] == 2 and s["device"] == "cpu"
        assert s["payload_model_validated"] is True
        assert s["nb_logged_allreduce_payload_bytes"] == nb_payload_bytes()
        for fam in ("nb", "knn"):
            assert s[f"{fam}_per_sec"] > 0 and s[f"{fam}_alone_per_sec"] > 0
            assert s[f"{fam}_efficiency"] > 0
        assert [row["ranks"] for row in s["projection"]] == [2, 4, 8]


def test_project_efficiency_shape():
    rows = project_efficiency(1e-3, 1024.0, counts=(1, 2, 8))
    assert rows[0]["projected_efficiency"] == 1.0
    assert rows[0]["t_collective_us"] == 0.0
    effs = [r["projected_efficiency"] for r in rows]
    assert effs == sorted(effs, reverse=True) and effs[-1] < 1.0
