"""The port's columnar sidecar (`native/sidecar.py`) held against the JAX
package on the CPU.

1. Format: for the same corpus, schema and block size the port writes the
   reference's `columns.bin` and `MANIFEST.json` byte for byte (the
   manifest's `source` path aside), names the same directory, and each
   package replays what the other packed.
2. Equivalence: all six fold families write the same artifact cold
   (`stream.sidecar=false`), packing and replaying, equal to the JAX
   package's; the replay records no `stream.parse` span.
3. Never a wrong block: a torn segment, a torn or missing manifest, an
   in-place edit (the blocks before it replay), and an append (the prefix
   replays, only the tail parses) all reproduce a cold scan of the current
   bytes; a budget smaller than a block aborts the pack; a segment lost
   under an open replay finishes cold.
Corpora are made from seeds at 0.01 MB blocks."""

import glob
import os

import numpy as np
import pytest
import torch_reference_native  # noqa: F401  (settles the reference's native route)

from avenir_tpu_torch.native import sidecar
from avenir_tpu_torch.runner import run_job

CPU = "cpu"


def _churn(path, rows=1500, seed=11):
    from avenir_tpu.data import churn_schema, generate_churn

    os.makedirs(path, exist_ok=True)
    csv = os.path.join(path, "churn.csv")
    with open(csv, "w") as fh:
        fh.write(generate_churn(rows, seed=seed, as_csv=True))
    schema = os.path.join(path, "churn.json")
    churn_schema().save(schema)
    return csv, schema


def _seq(path, rows=800, name="seq.csv"):
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(12)
    csv = os.path.join(path, name)
    with open(csv, "w") as fh:
        for i in range(rows):
            toks = rng.choice(3, size=int(rng.integers(2, 9)),
                              p=[0.5, 0.3, 0.2])
            label = "T" if rng.random() < 0.4 else "F"
            fh.write(f"c{i},{label}," + ",".join("LMH"[t] for t in toks)
                     + "\n")
    return csv


_EXTRA = {
    "bayesianDistr": ("bad", "churn", {}),
    "mutualInformation": ("mut", "churn", {"mutual.info.score.algorithms":
                                           "mutual.info.maximization"}),
    "fisherDiscriminant": ("fid", "churn", {}),
    "markovStateTransitionModel": ("mst", "seq", {
        "model.states": "L,M,H", "class.label.field.ord": "1",
        "skip.field.count": "2", "class.labels": "T,F"}),
    "frequentItemsApriori": ("fia", "seq", {
        "support.threshold": "0.2", "item.set.length": "3",
        "skip.field.count": "2"}),
    "candidateGenerationWithSelfJoin": ("cgs", "seq", {
        "support.threshold": "0.15", "item.set.length": "3",
        "skip.field.count": "2"}),
}
FAMILIES = list(_EXTRA)


def _conf(job, scdir, schema=None, block="0.01", **extra):
    """The job's prefixed conf; `extra` keys come unprefixed, and a None
    `scdir` keeps the default base beside the corpus."""
    prefix, _corpus, body = _EXTRA[job]
    c = {"stream.block.size.mb": block, **body}
    if scdir is not None:
        c["stream.sidecar.dir"] = scdir
    if schema is not None:
        c["feature.schema.file.path"] = schema
    c.update(extra)
    return {f"{prefix}.{k}": v for k, v in c.items()}


def _files(res):
    return [open(p, "rb").read() for p in sorted(res.outputs)]


def _out(tmp_path, name, job):
    miner = job in ("frequentItemsApriori", "candidateGenerationWithSelfJoin")
    return str(tmp_path / name) + (os.sep if miner else ".txt")


def _sc(res, key):
    return res.counters[f"Sidecar:{key}"]


def _manifest_dirs(scdir):
    return sorted(os.path.dirname(p) for p in glob.glob(
        os.path.join(scdir, "*", sidecar.MANIFEST)))


def _corpus(tmp_path, job):
    if _EXTRA[job][1] == "churn":
        return _churn(str(tmp_path))
    return _seq(str(tmp_path)), None


# ----------------------------------------------------------- 1. format
@pytest.mark.parametrize("job", ["mutualInformation",
                                 "markovStateTransitionModel",
                                 "candidateGenerationWithSelfJoin"])
def test_segment_and_manifest_equal_reference(tmp_path, job):
    """The port's pack and the reference's pack of one corpus: the same
    directory name, columns.bin and MANIFEST.json (with its `source`
    path, the one byte difference, mapped)."""
    from avenir_tpu.runner import run_job as jax_run_job

    packed = {}
    for who, run in (("port", lambda *a: run_job(*a, device=CPU)),
                     ("jax", jax_run_job)):
        root = tmp_path / who
        csv, schema = _corpus(root, job)
        res = run(job, _conf(job, None, schema), [csv],
                  _out(root, "out", job))
        (d,) = _manifest_dirs(str(root / sidecar.SIDECAR_DIRNAME))
        packed[who] = (os.path.basename(d), res,
                       {name: open(os.path.join(d, name), "rb").read()
                        for name in (sidecar.MANIFEST, sidecar.SEGMENT)},
                       str(root).encode())
    (pname, pres, pfiles, proot), (jname, jres, jfiles, jroot) = \
        packed["port"], packed["jax"]
    assert pname == jname
    assert _files(pres) == _files(jres)
    assert pfiles[sidecar.SEGMENT] == jfiles[sidecar.SEGMENT]
    assert pfiles[sidecar.MANIFEST].replace(proot, jroot) == \
        jfiles[sidecar.MANIFEST]
    assert _sc(pres, "DeltaBlocks") == jres.counters["Sidecar:DeltaBlocks"]


@pytest.mark.parametrize("packer", ["port", "jax"])
def test_each_package_replays_the_others_pack(tmp_path, packer):
    from avenir_tpu.runner import run_job as jax_run_job

    csv, schema = _churn(str(tmp_path))
    conf = _conf("mutualInformation", str(tmp_path / "sc"), schema)
    if packer == "port":
        first = run_job("mutualInformation", conf, [csv],
                        str(tmp_path / "a.txt"), device=CPU)
        second = jax_run_job("mutualInformation", conf, [csv],
                             str(tmp_path / "b.txt"))
    else:
        first = jax_run_job("mutualInformation", conf, [csv],
                            str(tmp_path / "a.txt"))
        second = run_job("mutualInformation", conf, [csv],
                         str(tmp_path / "b.txt"), device=CPU)
    assert _files(first) == _files(second)
    assert first.counters["Sidecar:DeltaBlocks"] \
        == second.counters["Sidecar:HitBlocks"] >= 3
    assert second.counters["Sidecar:DeltaBlocks"] == 0


def test_directory_digests_equal_reference(tmp_path):
    """Schema content, delimiter, block size, kind and skip count each
    name another directory, in both packages alike; a schema's discovery
    side effects do not."""
    from avenir_tpu.core.schema import FeatureSchema as JaxSchema
    from avenir_tpu.native import sidecar as jax_sidecar
    from avenir_tpu_torch.core.schema import FeatureSchema

    csv, schema = _churn(str(tmp_path), rows=50)
    opts = {"dir": str(tmp_path / "sc"), "budget": 1 << 30}
    sch, jsch = FeatureSchema.from_file(schema), JaxSchema.from_file(schema)
    cases = [("dataset", ",", 1 << 16), ("dataset", ",", 1 << 17),
             ("dataset", ";", 1 << 16)]
    dirs = [sidecar.dataset_dir(opts, csv, sch, d, b) for _k, d, b in cases]
    assert dirs == [jax_sidecar.dataset_dir(opts, csv, jsch, d, b)
                    for _k, d, b in cases]
    for skip in (2, 3):
        dirs.append(sidecar.bytes_dir(opts, csv, ",", skip, 1 << 16))
        assert dirs[-1] == jax_sidecar.bytes_dir(opts, csv, ",", skip,
                                                 1 << 16)
    renamed = FeatureSchema.from_file(schema)
    list(renamed)[0].name = "renamed"
    dirs.append(sidecar.dataset_dir(opts, csv, renamed, ",", 1 << 16))
    assert len(set(dirs)) == len(dirs)
    assert sidecar.schema_digest(sch) == jax_sidecar.schema_digest(jsch)
    # the default base: .avenir_sidecar beside the corpus
    here = sidecar.dataset_dir({}, csv, sch, ",", 1 << 16)
    assert here == jax_sidecar.dataset_dir({}, csv, jsch, ",", 1 << 16)
    assert os.path.dirname(here) == os.path.join(str(tmp_path),
                                                 sidecar.SIDECAR_DIRNAME)


# ------------------------------------------------------ 2. equivalence
@pytest.mark.parametrize("job", FAMILIES)
def test_cold_pack_warm_byte_identical(tmp_path, job):
    from avenir_tpu.runner import run_job as jax_run_job
    from avenir_tpu_torch import obs

    csv, schema = _corpus(tmp_path, job)
    conf = _conf(job, str(tmp_path / "sc"), schema)
    prefix = _EXTRA[job][0]
    off = {**conf, f"{prefix}.stream.sidecar": "false"}
    cold = run_job(job, off, [csv], _out(tmp_path, "cold", job), device=CPU)
    want = jax_run_job(job, off, [csv], _out(tmp_path, "jax", job))
    pack = run_job(job, conf, [csv], _out(tmp_path, "pack", job), device=CPU)
    with obs.capture() as rec:
        warm = run_job(job, conf, [csv], _out(tmp_path, "warm", job),
                       device=CPU)
    assert _files(cold) == _files(pack) == _files(warm) == _files(want)
    assert _sc(cold, "DeltaBlocks") == 0 and _sc(cold, "HitBlocks") == 0
    assert _sc(pack, "DeltaBlocks") >= 2
    assert _sc(warm, "HitBlocks") == _sc(pack, "DeltaBlocks")
    assert _sc(warm, "DeltaBlocks") == 0
    spans = rec.spans()
    assert not [s for s in spans if s.name == "stream.parse"]
    # the miners' later rounds replay their spill cache: only pass 1
    # replays the sidecar
    assert len([s for s in spans if s.name == "stream.sidecar.replay"]) \
        == _sc(warm, "HitBlocks")


def test_shared_scan_replays_once_for_every_fold(tmp_path):
    """run_shared's feed goes through the sidecar: a warm fused scan of
    three dataset folds and of markov with the two miners parses nothing
    and writes the solo runs' bytes."""
    from avenir_tpu_torch import obs
    from avenir_tpu_torch.runner import run_shared

    csv, schema = _churn(str(tmp_path / "c"))
    seq = _seq(str(tmp_path / "s"))
    scdir = str(tmp_path / "sc")
    for jobs, corpus, sch in (
            (["bayesianDistr", "mutualInformation", "fisherDiscriminant"],
             csv, schema),
            (["markovStateTransitionModel", "frequentItemsApriori",
              "candidateGenerationWithSelfJoin"], seq, None)):
        specs = lambda tag: [(j, _conf(j, scdir, sch),
                              _out(tmp_path, f"{tag}_{j}", j)) for j in jobs]
        packed = run_shared(specs("pack"), [corpus], device=CPU)
        with obs.capture() as rec:
            warm = run_shared(specs("warm"), [corpus], device=CPU)
        assert not [s for s in rec.spans() if s.name == "stream.parse"]
        for j in jobs:
            solo = run_job(j, _conf(j, scdir, sch), [corpus],
                           _out(tmp_path, f"solo_{j}", j), device=CPU)
            assert _files(packed[j]) == _files(warm[j]) == _files(solo), j
            assert _sc(warm[j], "HitBlocks") == _sc(packed[j], "DeltaBlocks")


# ---------------------------------------------- 3. never a wrong block
def test_torn_writes_never_serve(tmp_path):
    csv, schema = _churn(str(tmp_path))
    conf = _conf("mutualInformation", str(tmp_path / "sc"), schema)
    cold = run_job("mutualInformation",
                   {**conf, "mut.stream.sidecar": "false"}, [csv],
                   str(tmp_path / "cold.txt"), device=CPU)
    run_job("mutualInformation", conf, [csv], str(tmp_path / "pack.txt"),
            device=CPU)
    (scdir,) = _manifest_dirs(str(tmp_path / "sc"))
    seg = os.path.join(scdir, sidecar.SEGMENT)
    man = os.path.join(scdir, sidecar.MANIFEST)
    # a) a segment torn mid-block: the entries past its end do not serve
    with open(seg, "rb+") as fh:
        fh.truncate(os.path.getsize(seg) // 2)
    torn = run_job("mutualInformation", conf, [csv],
                   str(tmp_path / "torn.txt"), device=CPU)
    assert _files(torn) == _files(cold)
    assert _sc(torn, "HitBlocks") == 0 and _sc(torn, "DeltaBlocks") >= 1
    # b) a writer's leftover staging file leaves a full replay alone
    with open(seg + ".tmp.99999", "wb") as fh:
        fh.write(b"\x00garbage")
    warm = run_job("mutualInformation", conf, [csv],
                   str(tmp_path / "tmpfile.txt"), device=CPU)
    assert _files(warm) == _files(cold)
    assert _sc(warm, "HitBlocks") >= 1 and _sc(warm, "DeltaBlocks") == 0
    # c) a torn manifest, and d) none at all beside a garbage segment
    for damage in ("torn", "missing"):
        if damage == "torn":
            text = open(man, "rb").read()
            open(man, "wb").write(text[: len(text) // 2])
        else:
            os.remove(man)
            with open(seg, "wb") as fh:
                fh.write(b"\x00" * 64)
        got = run_job("mutualInformation", conf, [csv],
                      str(tmp_path / f"{damage}.txt"), device=CPU)
        assert _files(got) == _files(cold), damage
        assert _sc(got, "HitBlocks") == 0, damage
        assert _sc(got, "DeltaBlocks") >= 1, damage


def test_content_drift_invalidates_from_edit_point(tmp_path):
    csv, schema = _churn(str(tmp_path))
    conf = _conf("mutualInformation", str(tmp_path / "sc"), schema)
    pack = run_job("mutualInformation", conf, [csv],
                   str(tmp_path / "pack.txt"), device=CPU)
    n_blocks = _sc(pack, "DeltaBlocks")
    assert n_blocks >= 3
    blob = bytearray(open(csv, "rb").read())
    at = blob.index(b"1", int(len(blob) * 0.6))
    blob[at:at + 1] = b"7"                  # same length, new content
    open(csv, "wb").write(bytes(blob))
    cold = run_job("mutualInformation",
                   {**conf, "mut.stream.sidecar": "false"}, [csv],
                   str(tmp_path / "cold.txt"), device=CPU)
    warm = run_job("mutualInformation", conf, [csv],
                   str(tmp_path / "warm.txt"), device=CPU)
    assert _files(warm) == _files(cold)
    assert 1 <= _sc(warm, "HitBlocks") < n_blocks
    assert _sc(warm, "HitBlocks") + _sc(warm, "DeltaBlocks") == n_blocks


@pytest.mark.parametrize("job", ["mutualInformation",
                                 "markovStateTransitionModel"])
def test_append_replays_prefix_parses_tail(tmp_path, job):
    from avenir_tpu.data import generate_churn
    from avenir_tpu_torch import obs

    csv, schema = _corpus(tmp_path, job)
    conf = _conf(job, str(tmp_path / "sc"), schema, block="0.004")
    pack = run_job(job, conf, [csv], _out(tmp_path, "pack", job), device=CPU)
    n0 = _sc(pack, "DeltaBlocks")
    assert n0 >= 3
    if schema is not None:
        with open(csv, "a") as fh:
            fh.write(generate_churn(200, seed=13, as_csv=True))
    else:
        extra = _seq(str(tmp_path / "more"), rows=150)
        with open(csv, "a") as fh:
            fh.write(open(extra).read())
    prefix = _EXTRA[job][0]
    cold = run_job(job, {**conf, f"{prefix}.stream.sidecar": "false"},
                   [csv], _out(tmp_path, "cold", job), device=CPU)
    with obs.capture() as rec:
        warm = run_job(job, conf, [csv], _out(tmp_path, "warm", job),
                       device=CPU)
    assert _files(warm) == _files(cold)
    hits, delta = _sc(warm, "HitBlocks"), _sc(warm, "DeltaBlocks")
    assert hits >= n0 - 1 >= 1 and delta >= 1
    spans = rec.spans()
    assert len([s for s in spans if s.name == "stream.parse"]) == delta
    assert len([s for s in spans
                if s.name == "stream.sidecar.replay"]) == hits
    again = run_job(job, conf, [csv], _out(tmp_path, "again", job),
                    device=CPU)
    assert _files(again) == _files(cold)
    assert _sc(again, "HitBlocks") == hits + delta
    assert _sc(again, "DeltaBlocks") == 0


def test_unterminated_last_line_append_parses_cold(tmp_path):
    """A sidecar whose coverage ends mid-line: the appended bytes extend
    that row, so the whole file parses and nothing splices."""
    csv, schema = _churn(str(tmp_path), rows=600)
    with open(csv, "rb+") as fh:
        fh.seek(-1, 2)
        fh.truncate()
    conf = _conf("mutualInformation", str(tmp_path / "sc"), schema)
    run_job("mutualInformation", conf, [csv], str(tmp_path / "pack.txt"),
            device=CPU)
    with open(csv, "a") as fh:
        fh.write("\n")
    cold = run_job("mutualInformation",
                   {**conf, "mut.stream.sidecar": "false"}, [csv],
                   str(tmp_path / "cold.txt"), device=CPU)
    warm = run_job("mutualInformation", conf, [csv],
                   str(tmp_path / "warm.txt"), device=CPU)
    assert _files(warm) == _files(cold)


def test_multi_input_disjoint_vocabularies(tmp_path):
    """Each input has its own sidecar and first-seen vocabulary: the
    miners' merge watermark restarts at every source."""
    def write(path, toks):
        with open(path, "w") as fh:
            for i in range(300):
                row = [toks[(i + j) % len(toks)] for j in range(4)]
                fh.write(f"c{i},T," + ",".join(row) + "\n")

    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    write(a, ["aa", "ab", "ac"])
    write(b, ["ba", "bb", "bc"])
    conf = _conf("frequentItemsApriori", str(tmp_path / "sc"),
                 **{"item.set.length": "2"})
    cold = run_job("frequentItemsApriori",
                   {**conf, "fia.stream.sidecar": "false"}, [a, b],
                   str(tmp_path / "cold") + os.sep, device=CPU)
    run_job("frequentItemsApriori", conf, [a, b],
            str(tmp_path / "pack") + os.sep, device=CPU)
    warm = run_job("frequentItemsApriori", conf, [a, b],
                   str(tmp_path / "warm") + os.sep, device=CPU)
    assert _files(warm) == _files(cold)
    assert _sc(warm, "HitBlocks") >= 2 and _sc(warm, "DeltaBlocks") == 0


def test_tiny_budget_aborts_the_pack(tmp_path):
    csv, schema = _churn(str(tmp_path))
    conf = _conf("mutualInformation", str(tmp_path / "sc"), schema,
                 **{"stream.sidecar.budget.mb": "0.001"})
    cold = run_job("mutualInformation",
                   {**conf, "mut.stream.sidecar": "false"}, [csv],
                   str(tmp_path / "cold.txt"), device=CPU)
    first = run_job("mutualInformation", conf, [csv],
                    str(tmp_path / "a.txt"), device=CPU)
    second = run_job("mutualInformation", conf, [csv],
                     str(tmp_path / "b.txt"), device=CPU)
    assert _files(first) == _files(second) == _files(cold)
    assert _sc(second, "HitBlocks") == 0
    for scdir in _manifest_dirs(str(tmp_path / "sc")):
        assert sidecar.sidecar_nbytes(scdir) <= 1024


@pytest.mark.parametrize("write", [True, False])
def test_lost_segment_under_replay_finishes_cold(tmp_path, write):
    """The directory removed after the first replayed block (the handle's
    close): the feed finishes from that block's end by parsing, and the
    blocks tile the file, each payload equal to a cold parse's."""
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.core.stream import iter_csv_chunks

    csv, schema = _churn(str(tmp_path))
    conf = _conf("mutualInformation", str(tmp_path / "sc"), schema)
    run_job("mutualInformation", conf, [csv], str(tmp_path / "pack.txt"),
            device=CPU)
    (scdir,) = _manifest_dirs(str(tmp_path / "sc"))
    handle = sidecar.SidecarHandle(csv, scdir)
    assert handle.cache_ready() and handle.cache_nbytes > 0
    block = int(0.01 * (1 << 20))
    sch = FeatureSchema.from_file(schema)
    feed = sidecar.dataset_blocks({"dir": str(tmp_path / "sc")}, csv, sch,
                                  ",", block, write=write)
    got, end = [], 0
    for i, (off, length, _h, payload) in enumerate(feed):
        assert off == end
        end = off + length
        got.append(payload)
        if i == 0:
            handle.close()
    assert end == os.path.getsize(csv) and not os.path.exists(scdir)
    want = list(iter_csv_chunks(csv, FeatureSchema.from_file(schema), ",",
                                block))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for fld in sch.fields:
            np.testing.assert_array_equal(a.column(fld.ordinal),
                                          b.column(fld.ordinal))
    assert not handle.cache_ready()


def test_python_engine_and_kill_switch_keep_the_sidecar_off(tmp_path):
    from avenir_tpu_torch.core.config import JobConfig

    assert sidecar.opts_from_cfg(JobConfig({}, "mut")) is not None
    for props in ({"mut.stream.sidecar": "false"},
                  {"mut.csv.engine": "python"}, {"csv.engine": "python"}):
        assert sidecar.opts_from_cfg(JobConfig(props, "mut")) is None
    csv, schema = _churn(str(tmp_path), rows=200)
    res = run_job("mutualInformation",
                  {"mut.feature.schema.file.path": schema,
                   "mut.csv.engine": "python"}, [csv],
                  str(tmp_path / "o.txt"), device=CPU)
    assert _sc(res, "DeltaBlocks") == 0
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           sidecar.SIDECAR_DIRNAME))
