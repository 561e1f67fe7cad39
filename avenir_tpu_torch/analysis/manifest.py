"""The units the auditors drive: the IR tier's op and family entries,
and the stream entries of the flow, mem and merge audits.

The port of `avenir_tpu/analysis/manifest.py`, both halves.

The IR half (`KernelSpec`, `manifest_entries`) is what `analysis/ir.py`
records: for each hot op of the reference's manifest the port's
counterpart with its inputs, and for each family of
`parallel/distributed.FAMILIES` its builder on a mesh of AUDIT_DEVICES
ranks and the analytic collective bytes it must ship
(`parallel/scaling.collective_payload_model`). The names, shapes, dtypes
and pinned dims are the reference's; the inputs are concrete, seeded
with numpy for the op entries, zeros and ones for the families as the
reference places them. An op entry's tensors live on its `device`
("cuda" unless the caller asks for "cpu", as every entry point of the
port); a family runs on the CPU ranks of a gloo world, so its builder is
a module-level function that a spawned rank can import.

The stream half (`StreamKernelSpec`, `_job_runner`, `_shared_runner`,
`_churn_corpus`, `_seq_corpus`, `stream_entries`): the same eight
entries as the reference's, NB, MI, Fisher, Markov, Apriori and GSP each
on its own scan, and the churn trio and the Markov + Apriori pair fused
on one `SharedScan`, over the same seeded corpora and confs. Each
entry's `path:line` is the port's fold, so a finding lands on the code
that owns the invariant.

Every stream runner turns the columnar sidecar off
(`stream.sidecar=false`): an entry runs several times over one corpus,
and a replay parses nothing, so its chunk counts would not differ
between layouts and its `stream.parse` span would be missing. Each
entry runs on its `device` (`stream_entries(device=...)`).
"""

from __future__ import annotations

import inspect
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _loc(obj) -> Tuple[str, int]:
    """(repo-relative posix path, first line) of a def."""
    src = inspect.getsourcefile(inspect.unwrap(obj))
    rel = os.path.relpath(os.path.abspath(src), _REPO_ROOT)
    try:
        line = inspect.getsourcelines(inspect.unwrap(obj))[1]
    except OSError:
        line = 1
    return rel.replace(os.sep, "/"), line


#: every family runs on a world of this many ranks: the reference's
#: 8-device mesh
AUDIT_DEVICES = 8

#: the reference's pinned dims, from which every payload model below
#: derives: ROWS global rows, 8 a rank
ROWS = 8 * AUDIT_DEVICES
KNN_K, KNN_D = 5, 8
TREE = dict(n_leaves=4, n_splits=3, smax=2, num_classes=2)
LR_D = 8
MARKOV = dict(n_states=3, n_classes=2)
APRIORI_CAND, APRIORI_VOCAB, APRIORI_K = 16, 12, 2
BANDIT_ARMS, BANDIT_BATCH = 6, 2
CROSS = dict(bins_a=10, bins_b=2)
_NB_CLASSES, _NB_FEAT, _NB_BMAX = 2, 8, 10


@dataclass(frozen=True)
class KernelSpec:
    """One unit of the IR tier.

    ``build(mesh)`` returns ``(fn, args)``: `fn(*args)` is the call the
    tier records, `args` concrete tensors (an op entry's on its device,
    a family's this rank's shard on `mesh`, a `parallel.mesh.Mesh`; None
    for an op entry). ``payload_model(shape)`` gives a family's analytic
    collective bytes on a mesh of `shape` ({axis: size}); None marks an
    op entry."""

    name: str                     # finding scope (rule keys use it)
    path: str                     # repo-relative module the op lives in
    line: int
    build: Callable
    model_parallel: int = 1       # family mesh: ranks//mp x mp
    payload_model: Optional[Callable] = None

    @property
    def is_family(self) -> bool:
        return self.payload_model is not None


def audit_shape(spec: KernelSpec) -> Dict[str, int]:
    """The {axis: size} of a family's audit mesh, the reference's:
    {data: 8}, or {data: 4, model: 2} for model_parallel 2."""
    if spec.model_parallel > 1:
        return {"data": AUDIT_DEVICES // spec.model_parallel,
                "model": spec.model_parallel}
    return {"data": AUDIT_DEVICES}


# ------------------------------------------------------------- op entries
def _op_entries(device: str = "cuda") -> List[KernelSpec]:
    """The reference's seven op entries on the port's counterparts, with
    seeded inputs on `device`."""
    import torch

    from avenir_tpu_torch.ops import bitset, infotheory, knn_kernels, reduce

    def on(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    def words(rng, rows):
        return on(rng.integers(0, 1 << 32, (rows, 4), dtype=np.uint64)
                  .astype(np.uint32).view(np.int32))

    def bitset_counts(_mesh):
        rng = np.random.default_rng(0)
        return bitset.bitset_contain_counts, (words(rng, 256), words(rng, 64))

    def bitset_mask(_mesh):
        rng = np.random.default_rng(1)
        return bitset.bitset_contain_mask, (words(rng, 256), words(rng, 64))

    def keyed(_mesh):
        rng = np.random.default_rng(2)
        return (lambda k: reduce.keyed_reduce(k, 64),
                (on(rng.integers(0, 64, 1024).astype(np.int32)),))

    def onehot(_mesh):
        rng = np.random.default_rng(3)
        return (lambda c: reduce.one_hot_count(c, 32),
                (on(rng.integers(0, 32, (1024, 4)).astype(np.int32)),))

    def split_score(_mesh):
        rng = np.random.default_rng(4)
        return (lambda c: infotheory.weighted_split_score(c, "entropy"),
                (on(rng.integers(0, 50, (16, 4, 3)).astype(np.float32)),))

    def mi(_mesh):
        rng = np.random.default_rng(5)
        return (infotheory.mutual_information,
                (on(rng.integers(0, 50, (8, 4)).astype(np.float32)),))

    def knn(_mesh):
        rng = np.random.default_rng(6)
        return (lambda q, t: knn_kernels.knn_topk(q, t, k=5,
                                                  metric="euclidean"),
                (on(rng.random((128, 8), dtype=np.float32)),
                 on(rng.random((256, 8), dtype=np.float32))))

    def spec(name, ref, build):
        path, line = _loc(ref)
        return KernelSpec(name, path, line, build)

    return [
        spec("bitset_contain_counts", bitset.bitset_contain_counts,
             bitset_counts),
        spec("bitset_contain_mask", bitset.bitset_contain_mask, bitset_mask),
        spec("keyed_reduce", reduce.keyed_reduce, keyed),
        spec("one_hot_count", reduce.one_hot_count, onehot),
        spec("weighted_split_score", infotheory.weighted_split_score,
             split_score),
        spec("mutual_information", infotheory.mutual_information, mi),
        spec("knn_topk_pallas", knn_kernels.knn_topk, knn),
    ]


# --------------------------------------------------------- family entries
def _rows(mesh, arr, pad=0):
    """This rank's shard of `arr`, rows over every axis of the mesh (the
    reference's P(axes))."""
    from avenir_tpu_torch.parallel.mesh import shard_rows

    return shard_rows(mesh, arr, pad, mesh.axis_names)


def _whole(mesh, arr):
    from avenir_tpu_torch.parallel.mesh import replicated

    return replicated(mesh, arr)


def knn_build(mesh):
    from avenir_tpu_torch.parallel.distributed import distributed_topk_fn
    from avenir_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                shard_rows)

    data_n = mesh.shape[DATA_AXIS]
    model_n = mesh.shape.get(MODEL_AXIS, 1)
    nq, train = 8 * data_n, 16 * model_n
    t_axes = (MODEL_AXIS,) if MODEL_AXIS in mesh.axis_names else ()
    fn = distributed_topk_fn(mesh, k=KNN_K, metric="euclidean")
    return fn, (
        shard_rows(mesh, np.zeros((nq, KNN_D), np.float32), 0, (DATA_AXIS,)),
        shard_rows(mesh, np.zeros((train, KNN_D), np.float32), 0, t_axes),
        shard_rows(mesh, np.zeros((train,), np.int32), 0, t_axes))


def knn_payload(shape):
    from avenir_tpu_torch.parallel.scaling import collective_payload_model

    return collective_payload_model("knn_topk", shape, nq=8 * shape["data"],
                                    k=KNN_K)


def nb_build(mesh):
    from avenir_tpu_torch.parallel.distributed import distributed_nb_train_fn

    fn = distributed_nb_train_fn(mesh, _NB_CLASSES, _NB_BMAX)
    return fn, (_rows(mesh, np.zeros((ROWS, _NB_FEAT), np.int32)),
                _rows(mesh, np.zeros((ROWS,), np.int32)),
                _rows(mesh, np.ones((ROWS,), np.float32)))


def nb_payload(shape):
    from avenir_tpu_torch.parallel.scaling import collective_payload_model

    return collective_payload_model("nb_train", shape, n_feat=_NB_FEAT,
                                    num_classes=_NB_CLASSES, bmax=_NB_BMAX)


def tree_build(mesh):
    from avenir_tpu_torch.parallel.distributed import (
        distributed_tree_level_fn)

    fn = distributed_tree_level_fn(mesh, TREE["n_leaves"], TREE["n_splits"],
                                   TREE["smax"], TREE["num_classes"])
    return fn, (_rows(mesh, np.zeros((ROWS,), np.int32)),
                _rows(mesh, np.zeros((ROWS, TREE["n_splits"]), np.int8)),
                _rows(mesh, np.zeros((ROWS,), np.int32)),
                _rows(mesh, np.ones((ROWS,), np.float32)))


def tree_payload(shape):
    from avenir_tpu_torch.parallel.scaling import collective_payload_model

    return collective_payload_model("tree_level", shape, **TREE)


def lr_build(mesh):
    from avenir_tpu_torch.parallel.distributed import distributed_lr_step_fn

    fn = distributed_lr_step_fn(mesh, learning_rate=0.5)
    return fn, (_whole(mesh, np.zeros((LR_D,), np.float32)),
                _rows(mesh, np.zeros((ROWS, LR_D), np.float32)),
                _rows(mesh, np.zeros((ROWS,), np.float32)),
                _rows(mesh, np.ones((ROWS,), np.float32)))


def lr_payload(shape):
    from avenir_tpu_torch.parallel.scaling import collective_payload_model

    return collective_payload_model("lr_step", shape, d=LR_D)


def markov_build(mesh):
    from avenir_tpu_torch.parallel.distributed import (
        distributed_markov_counts_fn)

    fn = distributed_markov_counts_fn(mesh, MARKOV["n_states"],
                                      MARKOV["n_classes"])
    return fn, (_rows(mesh, np.zeros((ROWS, 6), np.int32)),
                _rows(mesh, np.zeros((ROWS,), np.int32)))


def markov_payload(shape):
    from avenir_tpu_torch.parallel.scaling import collective_payload_model

    return collective_payload_model("markov_counts", shape, **MARKOV)


def apriori_build(mesh):
    from avenir_tpu_torch.parallel.distributed import (
        distributed_apriori_support_fn)

    fn = distributed_apriori_support_fn(mesh, APRIORI_K)
    return fn, (_rows(mesh, np.zeros((ROWS, APRIORI_VOCAB), np.uint8)),
                _whole(mesh, np.zeros((APRIORI_CAND, APRIORI_VOCAB),
                                      np.float32)))


def apriori_payload(shape):
    from avenir_tpu_torch.parallel.scaling import collective_payload_model

    return collective_payload_model("apriori_support", shape,
                                    n_cand=APRIORI_CAND)


def bandit_build(mesh):
    from avenir_tpu_torch.parallel.distributed import (
        distributed_bandit_select_fn)

    fn = distributed_bandit_select_fn(mesh, batch_size=BANDIT_BATCH)
    return fn, (_rows(mesh, np.zeros((ROWS, BANDIT_ARMS), np.int32)),
                _rows(mesh, np.zeros((ROWS, BANDIT_ARMS), np.float32)),
                _rows(mesh, np.ones((ROWS, BANDIT_ARMS), bool), False),
                5.0)


def bandit_payload(shape):
    from avenir_tpu_torch.parallel.scaling import collective_payload_model

    return collective_payload_model("bandit_select", shape)


def cross_build(mesh):
    from avenir_tpu_torch.parallel.distributed import (
        distributed_crosscount_fn)

    fn = distributed_crosscount_fn(mesh, CROSS["bins_a"], CROSS["bins_b"])
    return fn, (_rows(mesh, np.zeros((ROWS,), np.int32)),
                _rows(mesh, np.zeros((ROWS,), np.int32)),
                _rows(mesh, np.ones((ROWS,), np.float32)))


def cross_payload(shape):
    from avenir_tpu_torch.parallel.scaling import collective_payload_model

    return collective_payload_model("crosscount", shape, **CROSS)


def _family_entries() -> List[KernelSpec]:
    """The eight families of `parallel/distributed.FAMILIES`, each at the
    port's family function, with the reference's model_parallel."""
    from avenir_tpu_torch.parallel.distributed import FAMILIES

    builders = {
        "knn_topk": (knn_build, knn_payload, 2),
        "nb_train": (nb_build, nb_payload, 1),
        "tree_level": (tree_build, tree_payload, 1),
        "lr_step": (lr_build, lr_payload, 1),
        "markov_counts": (markov_build, markov_payload, 1),
        "apriori_support": (apriori_build, apriori_payload, 1),
        "bandit_select": (bandit_build, bandit_payload, 1),
        "crosscount": (cross_build, cross_payload, 1),
    }
    out = []
    for name, (build, payload, mp) in builders.items():
        path, line = _loc(FAMILIES[name])
        out.append(KernelSpec(name, path, line, build, model_parallel=mp,
                              payload_model=payload))
    return out


def manifest_entries(device: str = "cuda") -> List[KernelSpec]:
    """The IR tier's manifest: the hot ops on `device`, then every
    distributed family."""
    return _op_entries(device) + _family_entries()


def family_names() -> List[str]:
    return [s.name for s in _family_entries()]


# ------------------------------------------------------ stream entries
@dataclass(frozen=True)
class StreamKernelSpec:
    """One streamed fold for the auditors.

    ``prepare(workdir)`` writes the entry's seeded corpus and returns a
    context dict; ``run(ctx, block_mb)`` runs the real streamed job (or
    fused group) over it at that block size on ``device`` and returns
    the artifact's bytes, every output file name-tagged. ``layouts``
    holds three block sizes that chunk the corpus visibly differently.
    ``jobs`` names the runner jobs (the footprint model is keyed on
    them); ``fold_specs`` holds them as ``(job, prefix, conf)`` with
    ``{schema}``-style placeholders, which the merge auditor formats as
    the runners do and feeds to each job's registered fold sink."""

    name: str
    path: str                     # repo-relative module of the fold
    line: int
    prepare: Callable             # workdir -> ctx dict
    run: Callable                 # (ctx, block_mb) -> bytes
    layouts: Tuple[float, ...] = (64.0, 0.002, 0.0005)
    jobs: Tuple[str, ...] = ()
    fold_specs: Tuple[Tuple[str, str, dict], ...] = ()
    device: str = "cuda"


def _props(conf: dict, ctx: dict, prefix: str, block_mb: float) -> dict:
    """`conf` with its placeholders filled from `ctx` and the block size
    pinned."""
    props = {k: (v.format(**ctx) if isinstance(v, str) else v)
             for k, v in conf.items()}
    props[f"{prefix}.stream.block.size.mb"] = repr(float(block_mb))
    return props


def _tagged(outputs, out: str, tag: str = "") -> List[bytes]:
    """Each output file's bytes behind its name relative to `out` (and
    `tag`), so a missing per-k file cannot pass for a reordered one."""
    blobs = []
    for p in sorted(outputs):
        rel = os.path.relpath(p, out)
        with open(p, "rb") as fh:
            blobs.append(f"{tag}{rel}".encode() + b"\0" + fh.read())
    return blobs


def _job_runner(job: str, prefix: str, conf: dict, device: str,
                inputs_key: str = "csv"):
    """run(ctx, block_mb): the registered job through `run_job` over the
    entry's corpus, the whole streamed path (prefetched reads, the
    parse, the fold on `device`, the writer)."""

    def run(ctx: dict, block_mb: float) -> bytes:
        from avenir_tpu_torch.runner import run_job

        ctx["runs"] = ctx.get("runs", 0) + 1
        out = os.path.join(ctx["dir"], f"out_{ctx['runs']}.txt")
        res = run_job(job, _props(conf, ctx, prefix, block_mb),
                      [ctx[inputs_key]], out, device=device)
        return b"\n".join(_tagged(res.outputs, out))

    return run


def _shared_runner(specs, device: str):
    """run(ctx, block_mb): N registered jobs through `run_shared`, one
    read and parse a chunk for N fold sinks, every job's block size
    pinned; every output file of every job is in the artifact, tagged
    with its job. `specs` is [(job, prefix, conf)]."""

    def run(ctx: dict, block_mb: float) -> bytes:
        from avenir_tpu_torch.runner import run_shared

        ctx["runs"] = ctx.get("runs", 0) + 1
        shared, outs = [], []
        for job, prefix, conf in specs:
            out = os.path.join(ctx["dir"], f"out_{ctx['runs']}_{job}")
            shared.append((job, _props(conf, ctx, prefix, block_mb), out))
            outs.append(out)
        results = run_shared(shared, [ctx["csv"]], device=device)
        blobs = []
        for (job, _prefix, _conf), out in zip(specs, outs):
            blobs.extend(_tagged(results[job].outputs, out, f"{job}:"))
        return b"\n".join(blobs)

    return run


def _churn_corpus(workdir: str) -> dict:
    from avenir_tpu_torch.data import churn_schema, generate_churn

    csv = os.path.join(workdir, "churn.csv")
    with open(csv, "w") as fh:
        fh.write(generate_churn(600, seed=11, as_csv=True))
    schema = os.path.join(workdir, "churn.json")
    churn_schema().save(schema)
    return {"dir": workdir, "csv": csv, "schema": schema}


def _seq_corpus(workdir: str) -> dict:
    """The Markov and miner corpus: 400 rows of 3-state token sequences
    with a class column, the miner tripwire's rows at audit size."""
    rng = np.random.default_rng(12)
    states = ["L", "M", "H"]
    csv = os.path.join(workdir, "seq.csv")
    with open(csv, "w") as fh:
        for i in range(400):
            up = i % 2 == 0
            s, toks = 1, []
            for _ in range(6):
                p = [0.1, 0.3, 0.6] if up else [0.6, 0.3, 0.1]
                s = int(np.clip(s + rng.choice([-1, 0, 1], p=p), 0, 2))
                toks.append(states[s])
            fh.write(f"c{i},{'T' if up else 'F'}," + ",".join(toks) + "\n")
    return {"dir": workdir, "csv": csv}


def stream_entries(device: str = "cuda") -> List[StreamKernelSpec]:
    """The eight stream entries on `device`: NB, MI, Fisher, Markov,
    Apriori and GSP on their own scans, then the churn trio and the
    Markov + Apriori pair fused, each `path:line` at the port's fold."""
    from avenir_tpu_torch.core.stream import SharedScan
    from avenir_tpu_torch.models.association import FrequentItemsApriori
    from avenir_tpu_torch.models.discriminant import FisherDiscriminant
    from avenir_tpu_torch.models.explore import MutualInformationAnalyzer
    from avenir_tpu_torch.models.markov import MarkovStateTransitionModel
    from avenir_tpu_torch.models.naive_bayes import NaiveBayesModel
    from avenir_tpu_torch.models.sequence import GSPMiner

    def job_spec(job, prefix, conf):
        return job, prefix, {**conf, f"{prefix}.stream.sidecar": "false"}

    def schema_conf(prefix):
        return {f"{prefix}.feature.schema.file.path": "{schema}"}

    # one conf a job, shared by the runners and the merge auditor's
    # fold_specs
    nb = job_spec("bayesianDistr", "bad", schema_conf("bad"))
    mi = job_spec("mutualInformation", "mut", {
        **schema_conf("mut"),
        "mut.mutual.info.score.algorithms":
            "mutual.info.maximization,min.redundancy.max.relevance"})
    fid = job_spec("fisherDiscriminant", "fid", schema_conf("fid"))
    mst = job_spec("markovStateTransitionModel", "mst", {
        "mst.model.states": "L,M,H", "mst.class.label.field.ord": "1",
        "mst.skip.field.count": "2", "mst.class.labels": "T,F"})
    fia = job_spec("frequentItemsApriori", "fia", {
        "fia.support.threshold": "0.3", "fia.item.set.length": "2",
        "fia.skip.field.count": "2"})
    cgs = job_spec("candidateGenerationWithSelfJoin", "cgs", {
        "cgs.support.threshold": "0.3", "cgs.item.set.length": "2",
        "cgs.skip.field.count": "2"})

    def spec(name, ref, prepare, run, fold_specs):
        path, line = _loc(ref)
        return StreamKernelSpec(
            name, path, line, prepare, run,
            jobs=tuple(job for job, _p, _c in fold_specs),
            fold_specs=tuple((job, p, dict(c)) for job, p, c in fold_specs),
            device=device)

    def solo(name, ref, prepare, js):
        return spec(name, ref, prepare, _job_runner(*js, device), [js])

    def fused(name, prepare, group):
        return spec(name, SharedScan.run, prepare,
                    _shared_runner(group, device), group)

    return [
        solo("nb_stream", NaiveBayesModel.accumulate, _churn_corpus, nb),
        solo("mi_stream", MutualInformationAnalyzer.add, _churn_corpus, mi),
        solo("discriminant_stream", FisherDiscriminant.accumulate,
             _churn_corpus, fid),
        solo("markov_stream", MarkovStateTransitionModel.fit_csr,
             _seq_corpus, mst),
        solo("apriori_stream", FrequentItemsApriori.mine_stream,
             _seq_corpus, fia),
        solo("gsp_stream", GSPMiner.mine_stream, _seq_corpus, cgs),
        fused("shared_churn_stream", _churn_corpus, [nb, mi, fid]),
        fused("shared_seq_stream", _seq_corpus, [mst, fia]),
    ]


def stream_kernel_names() -> List[str]:
    return [s.name for s in stream_entries()]
