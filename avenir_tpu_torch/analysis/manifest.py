"""The stream entries the auditors drive: the port's streamed folds.

The port of the stream half of `avenir_tpu/analysis/manifest.py`
(`StreamKernelSpec`, `_job_runner`, `_shared_runner`, `_churn_corpus`,
`_seq_corpus`, `stream_entries`): the same eight entries, NB, MI, Fisher,
Markov, Apriori and GSP each on its own scan, and the churn trio and the
Markov + Apriori pair fused on one `SharedScan`, over the same seeded
corpora and confs. Each entry's `path:line` is the port's fold, so a
finding lands on the code that owns the invariant.

Every runner turns the columnar sidecar off (`stream.sidecar=false`): an
entry runs several times over one corpus, and a replay parses nothing,
so its chunk counts would not differ between layouts and its
`stream.parse` span would be missing. Each entry runs on its `device`
(`stream_entries(device=...)`): "cuda" unless the caller asks for
"cpu", as every entry point of the port.

The IR half (`KernelSpec`, the op and family entries) lowers jaxprs and
is not ported.
"""

from __future__ import annotations

import inspect
import os
from dataclasses import dataclass
from typing import Callable, List, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _loc(obj) -> Tuple[str, int]:
    """(repo-relative posix path, first line) of a fold's def."""
    src = inspect.getsourcefile(inspect.unwrap(obj))
    rel = os.path.relpath(os.path.abspath(src), _REPO_ROOT)
    try:
        line = inspect.getsourcelines(inspect.unwrap(obj))[1]
    except OSError:
        line = 1
    return rel.replace(os.sep, "/"), line


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
