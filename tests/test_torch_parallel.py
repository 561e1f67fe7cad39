"""`avenir_tpu_torch.parallel` held against `avenir_tpu.parallel`.

One module-scoped fixture spawns a gloo world of four CPU ranks
(`torch_parallel_world`), meshed 4x1 and 2x2, which runs all eight
families and both `fit(mesh=)` calls. Every count equals the JAX family's
on conftest's 8-device mesh and the port's single-process result
exactly; the KNN lists and the trees' decision paths are identical; LR
is within 1e-7. The world has 120 s: a hung collective fails the tests
instead of holding tier-1's clock. The single-process cases hold the
input splits (`split_byte_ranges`, `iter_byte_blocks(byte_range=)`,
`CsvBlockReader(byte_range=)`) to the reference's.
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_world as world
from avenir_tpu.parallel import distributed as jdist
from avenir_tpu.parallel import mesh as jmesh
from avenir_tpu_torch.core import stream as pstream
from avenir_tpu_torch.parallel import FAMILIES, multihost
from avenir_tpu_torch.parallel import mesh as pmesh

LR_ATOL = 1e-7
WORLD_TIMEOUT = 120.0
FAMILY_NAMES = ["knn_topk", "nb_train", "tree_level", "lr_step",
                "markov_counts", "apriori_support", "bandit_select",
                "crosscount"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return world.spawn_world(str(tmp_path_factory.mktemp("world")),
                             WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def data():
    return world.inputs()


def _replicated(ranks, mesh_name, key):
    """The one value every rank holds, after checking they agree."""
    first = ranks[0][mesh_name][key]
    for r in range(1, world.WORLD):
        other = ranks[r][mesh_name][key]
        if isinstance(first, dict):
            assert other == first
        else:
            _same(other, first)
    return first


def _row_sharded(ranks, mesh_name, key, axes):
    """The global rows of an output sharded over `axes`, from the ranks at
    coordinate 0 of every other axis, in shard order."""
    mp = world.MESHES[mesh_name]
    shape = {pmesh.DATA_AXIS: world.WORLD // mp, pmesh.MODEL_AXIS: mp}
    parts = {}
    for r in range(world.WORLD):
        idx = ranks[r][mesh_name]["index"]
        if any(idx[a] for a in idx if a not in axes):
            continue
        shard = 0
        for a in axes:
            shard = shard * shape[a] + idx[a]
        parts[shard] = ranks[r][mesh_name][key]
    out = [parts[s] for s in sorted(parts)]
    if isinstance(out[0], tuple):
        return tuple(np.concatenate([p[i] for p in out])
                     for i in range(len(out[0])))
    return np.concatenate(out)


def _jax_mesh(model_parallel):
    return jmesh.data_mesh(jax.devices(), model_parallel=model_parallel)


def _put(mesh, a, spec):
    return jax.device_put(np.asarray(a), NamedSharding(mesh, spec))


def _pad(a, n, value=0):
    rem = (-len(a)) % n
    if not rem:
        return a
    return np.concatenate([a, np.full((rem,) + a.shape[1:], value, a.dtype)])


def _jax_family(name, data, model_parallel):
    """The JAX family's output on the 8-device mesh (4x2 for the KNN of a
    2x2 port mesh), the rows padded to eight shards as the port pads."""
    m = _jax_mesh(model_parallel if name == "knn_topk" else 1)
    axes = m.axis_names
    d = data[name]

    def rows(a, value=0):
        return _put(m, _pad(a, 8, value), P(axes))

    if name == "knn_topk":
        has_model = model_parallel > 1
        fn = jdist.distributed_topk_fn(m, world.K_NN)
        out = fn(_put(m, d["q"], P(jmesh.DATA_AXIS, None)),
                 _put(m, d["t"], P(jmesh.MODEL_AXIS, None) if has_model
                      else P()),
                 _put(m, d["t_labels"], P(jmesh.MODEL_AXIS) if has_model
                      else P()))
    elif name == "nb_train":
        out = jdist.distributed_nb_train_fn(m, **world.NB)(
            rows(d["codes"]), rows(d["labels"]), rows(d["w"]))
    elif name == "tree_level":
        out = jdist.distributed_tree_level_fn(m, **world.TREE)(
            rows(d["leaf_id"]), rows(d["seg"]), rows(d["labels"]),
            rows(d["w"]))
    elif name == "lr_step":
        out = jdist.distributed_lr_step_fn(m, world.LR_RATE)(
            _put(m, d["coeff"], P()), rows(d["x"]), rows(d["y"]),
            rows(d["w"]))
    elif name == "markov_counts":
        out = jdist.distributed_markov_counts_fn(m, **world.MARKOV)(
            rows(d["padded"], -1), rows(d["labels"]))
    elif name == "apriori_support":
        out = jdist.distributed_apriori_support_fn(m, world.APRIORI_K)(
            rows(d["trans"]), _put(m, d["cand"], P()))
    elif name == "bandit_select":
        out = jdist.distributed_bandit_select_fn(m, **world.BANDIT)(
            rows(d["counts"]), rows(d["rewards"]), rows(d["mask"], False),
            float(d["round_num"]))
    else:
        out = jdist.distributed_crosscount_fn(m, **world.CROSS)(
            rows(d["a"]), rows(d["b"]), rows(d["w"]))
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _port_single(name, data):
    """The port's single-process answer from its single-device cores."""
    from avenir_tpu_torch.models.association import _contain_counts_resident
    from avenir_tpu_torch.models.bandits import _ucb1
    from avenir_tpu_torch.models.markov import bigram_counts
    from avenir_tpu_torch.models.regress import _lr_step
    from avenir_tpu_torch.models.tree import _level_histogram
    from avenir_tpu_torch.ops.distance import _block_topk, pairwise_distance

    d = {k: torch.from_numpy(np.asarray(v)) for k, v in data[name].items()}
    if name == "knn_topk":
        dd = pairwise_distance(d["q"], d["t"])
        cols = torch.arange(dd.shape[1]).expand_as(dd)
        dist, idx = _block_topk(dd, cols, world.K_NN, "manhattan")
        return dist.numpy(), d["t_labels"][idx].numpy()
    if name == "nb_train":
        codes, labels = data[name]["codes"], data[name]["labels"]
        post = np.zeros((codes.shape[1], world.NB["num_classes"],
                         world.NB["bmax"]), np.int64)
        for f in range(codes.shape[1]):
            np.add.at(post[f], (labels, codes[:, f]), 1)
        return post, np.bincount(labels, minlength=world.NB["num_classes"])
    if name == "tree_level":
        t = world.TREE
        return _level_histogram(d["leaf_id"], d["seg"], d["labels"], d["w"],
                                t["n_leaves"], t["n_splits"], t["smax"],
                                t["num_classes"], dtype=torch.int64).numpy()
    if name == "lr_step":
        return _lr_step(d["coeff"], d["x"], d["y"], world.LR_RATE)[0].numpy()
    if name == "markov_counts":
        return bigram_counts(d["padded"], d["labels"],
                             **world.MARKOV).numpy()
    if name == "apriori_support":
        return _contain_counts_resident(d["trans"], d["cand"],
                                        world.APRIORI_K, 8192).numpy()
    if name == "bandit_select":
        return _ucb1(d["counts"], d["rewards"], d["mask"],
                     float(d["round_num"]), world.BANDIT["max_reward"],
                     world.BANDIT["batch_size"]).numpy()
    out = np.zeros((world.CROSS["bins_a"], world.CROSS["bins_b"]), np.int64)
    np.add.at(out, (data[name]["a"], data[name]["b"]), 1)
    return out


def _port_world(name, ranks, mesh_name):
    if name == "knn_topk":
        return _row_sharded(ranks, mesh_name, name, (pmesh.DATA_AXIS,))
    if name == "bandit_select":
        axes = ((pmesh.DATA_AXIS,) if mesh_name == "4x1"
                else (pmesh.DATA_AXIS, pmesh.MODEL_AXIS))
        return _row_sharded(ranks, mesh_name, name, axes)
    return _replicated(ranks, mesh_name, name)


def _same(got, want, exact=True):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=LR_ATOL)


def test_families_have_the_reference_keys():
    assert list(FAMILIES) == list(jdist.FAMILIES) == FAMILY_NAMES


@pytest.mark.parametrize("mesh_name", list(world.MESHES))
@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_family_equals_jax_and_single_process(ranks, data, name, mesh_name):
    got = _port_world(name, ranks, mesh_name)
    if name == "knn_topk":
        got = tuple(g[:len(data[name]["q"])] for g in got)
    if name == "bandit_select":
        got = got[:len(data[name]["counts"])]
    exact = name != "lr_step"
    _same(got, _port_single(name, data), exact)
    want = _jax_family(name, data, world.MESHES[mesh_name])
    if name == "bandit_select":
        want = want[:len(data[name]["counts"])]
    _same(got, want, exact)


@pytest.mark.parametrize("mesh_name", list(world.MESHES))
def test_tree_fit_on_mesh_equals_fit_and_jax(ranks, mesh_name, mesh8):
    from avenir_tpu.data import generate_churn as jchurn
    from avenir_tpu.models.tree import DecisionTreeBuilder as JTree
    from avenir_tpu_torch.data import generate_churn
    from avenir_tpu_torch.models.tree import DecisionTreeBuilder

    got = _replicated(ranks, mesh_name, "tree_fit")
    ds = generate_churn(world.TREE_ROWS, seed=world.TREE_SEED)
    single = DecisionTreeBuilder(ds.schema, max_depth=world.TREE_DEPTH,
                                 device="cpu").fit(ds).to_json()
    jds = jchurn(world.TREE_ROWS, seed=world.TREE_SEED)
    jax_mesh = JTree(jds.schema, max_depth=world.TREE_DEPTH).fit(
        jds, mesh=mesh8).to_json()
    assert got == single == jax_mesh


@pytest.mark.parametrize("mesh_name", list(world.MESHES))
def test_lr_fit_on_mesh_equals_fit(ranks, mesh_name, mesh8):
    from avenir_tpu.data import generate_elearn as jelearn
    from avenir_tpu.models.regress import LogisticRegression as JLR
    from avenir_tpu_torch.data import generate_elearn
    from avenir_tpu_torch.models.regress import LogisticRegression

    got = _replicated(ranks, mesh_name, "lr_fit")
    ds = generate_elearn(world.LR_ROWS, seed=world.LR_SEED)
    single = LogisticRegression(iteration_limit=world.LR_ITERS,
                                device="cpu").fit(ds).coeff
    np.testing.assert_allclose(got, single, rtol=0, atol=LR_ATOL)
    jds = jelearn(world.LR_ROWS, seed=world.LR_SEED)
    jax_mesh = JLR(iteration_limit=world.LR_ITERS).fit(jds, mesh=mesh8).coeff
    np.testing.assert_allclose(got, jax_mesh, rtol=0, atol=LR_ATOL)


@pytest.mark.parametrize("mesh_name", list(world.MESHES))
def test_sharded_keyed_count_sums_over_the_data_axis(ranks, data, mesh_name):
    a = data["crosscount"]["a"]
    for r in range(world.WORLD):
        got = ranks[r][mesh_name]["keyed_count"]
        np.testing.assert_array_equal(
            got["bins"], np.bincount(a, minlength=world.CROSS["bins_a"]))
        np.testing.assert_array_equal(got["rows"][0], [len(a)])


def test_mesh_grid_and_indivisible_world(ranks):
    for r in range(world.WORLD):
        assert ranks[r]["4x1"]["index"] == {"data": r}
        assert ranks[r]["2x2"]["index"] == {"data": r // 2, "model": r % 2}
        assert ranks[r]["indivisible"].startswith(
            "device count 4 is not divisible by model_parallel=3")
    with pytest.raises(ValueError, match="not divisible"):
        jmesh.data_mesh(jax.devices()[:4], model_parallel=3)


def test_host_shard_bounds_tile_the_rows(ranks):
    bounds = [tuple(ranks[r]["bounds"]) for r in range(world.WORLD)]
    assert bounds == pstream.split_byte_ranges(10, world.WORLD)
    assert bounds == [(0, 3), (3, 6), (6, 9), (9, 10)]


# ------------------------------------------------------- single process
def test_single_process_helpers():
    assert multihost.initialize() == 1
    assert multihost.host_shard_bounds(1000) == (0, 1000)
    with pytest.raises(RuntimeError, match="initialize"):
        pmesh.data_mesh(device="cpu")


@pytest.mark.parametrize("total,n", [(3, 8), (12, 2), (5, 4), (0, 3),
                                     (1000, 7), (1, 1)])
def test_split_byte_ranges_equal_reference(total, n):
    from avenir_tpu.core.stream import split_byte_ranges
    assert pstream.split_byte_ranges(total, n) == split_byte_ranges(total, n)


def test_split_byte_ranges_reject_bad_arguments():
    with pytest.raises(ValueError):
        pstream.split_byte_ranges(10, 0)
    with pytest.raises(ValueError):
        pstream.split_byte_ranges(-1, 2)


_CORPORA = {
    "no_trailing_newline": b"a,1\nb,2\nc,3",
    "trailing_newline": b"a,1\nb,2\nc,3\n",
    "single_line": b"onlyline,42",
    "single_line_nl": b"onlyline,42\n",
    "empty": b"",
    "blank_lines": b"a,1\n\n  \nb,2\n\n\nc,3\n   \n",
    "ragged": b"".join(b"r%d,%s\n" % (i, b"x" * (i * 7 % 23))
                       for i in range(60)),
}


@pytest.mark.parametrize("block", [1, 7, 64])
@pytest.mark.parametrize("corpus", sorted(_CORPORA))
def test_byte_range_splits_partition_lines_as_reference(tmp_path, corpus,
                                                        block):
    from avenir_tpu.core.stream import iter_byte_blocks as jblocks
    content = _CORPORA[corpus]
    path = tmp_path / "c.csv"
    path.write_bytes(content)
    want_lines = [ln for ln in content.split(b"\n") if ln.strip()]
    for n in (1, 2, 3, 5, 8):
        ranges = pstream.split_byte_ranges(len(content), n)
        got = [list(pstream.iter_byte_blocks(str(path), block, byte_range=r))
               for r in ranges]
        ref = [list(jblocks(str(path), block, byte_range=r)) for r in ranges]
        assert got == ref
        lines = [ln for blks in got for b in blks for ln in b.split(b"\n")
                 if ln.strip()]
        assert lines == want_lines
        offs = [list(pstream.iter_byte_blocks(str(path), block, byte_range=r,
                                              with_offsets=True))
                for r in ranges]
        jof = [list(jblocks(str(path), block, byte_range=r,
                            with_offsets=True)) for r in ranges]
        assert offs == jof
        # with offsets the blocks tile the lines gap-free, blanks kept
        for parts in offs:
            for (o1, b1), (o2, _b2) in zip(parts, parts[1:]):
                assert o1 + len(b1) == o2
        assert [b for parts in offs for _o, b in parts
                if not pstream.is_blank_block(b)] == \
            [b for parts in got for b in parts]


def test_is_blank_block():
    assert pstream.is_blank_block(b"")
    assert pstream.is_blank_block(b" \n\t\r\n")
    assert not pstream.is_blank_block(b"\n a")


def test_csv_block_reader_byte_ranges_equal_reference(tmp_path):
    from avenir_tpu.core.stream import CsvBlockReader as JReader
    from avenir_tpu.data import churn_schema as jschema
    from avenir_tpu_torch.data import churn_schema, generate_churn
    path = tmp_path / "churn.csv"
    path.write_text(generate_churn(500, seed=3, as_csv=True))
    size = os.path.getsize(path)
    for n in (1, 3, 4):
        got, want = [], []
        for r in pstream.split_byte_ranges(size, n):
            got += [ds.ids() for ds in pstream.CsvBlockReader(
                str(path), churn_schema(), block_bytes=2048, byte_range=r)]
            want += [ds.ids() for ds in JReader(
                str(path), jschema(), block_bytes=2048, byte_range=r,
                engine="python")]
        assert [list(i) for i in got] == [list(i) for i in want]
        assert sum(len(i) for i in got) == 500
    with pytest.raises(ValueError, match="byte_range"):
        pstream.CsvBlockReader(str(path), churn_schema(), byte_range=(5, 2))


def test_shard_rows_pads_and_partitions():
    mesh = pmesh.Mesh((pmesh.DATA_AXIS, pmesh.MODEL_AXIS),
                      {"data": 2, "model": 2}, {"data": 1, "model": 0},
                      torch.device("cpu"), {})
    a = np.arange(10).reshape(5, 2)
    np.testing.assert_array_equal(pmesh.shard_rows(mesh, a, -1).numpy(),
                                  [[6, 7], [8, 9], [-1, -1]])
    np.testing.assert_array_equal(
        pmesh.shard_rows(mesh, a, -1, axes=mesh.axis_names).numpy(),
        [[8, 9], [-1, -1]])
    np.testing.assert_array_equal(pmesh.row_mask(mesh, 5, 6).numpy(),
                                  [1.0, 1.0, 0.0])
    assert mesh.shard_index(mesh.axis_names) == (2, 4)
