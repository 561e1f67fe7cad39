"""The port's Fisher discriminant on the CPU against the JAX package:
float64 host moments on both sides, so every number and the boundary
file (and its stamp) are byte-identical at the same chunking, and the file
at any chunking; predict, predict_values, merge, load and the
`fisherDiscriminant` job too."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.core.dataset import Dataset as JaxDataset
from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.models.discriminant import FisherDiscriminant as JaxFisher
from avenir_tpu.runner import run_job as jax_run_job
from avenir_tpu_torch.core.dataset import Dataset
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.data import (churn_schema, elearn_schema, generate_churn,
                                   generate_elearn)
from avenir_tpu_torch.models.artifact import ModelFormatSkew
from avenir_tpu_torch.runner import DELTA_COUNTERS, MEM_COUNTERS
from avenir_tpu_torch.models.discriminant import FisherDiscriminant

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _chunks(text, n):
    lines = text.splitlines(True)
    step = -(-len(lines) // n)
    return ["".join(lines[i:i + step]) for i in range(0, len(lines), step)]


def _fit(text, obj, chunks):
    port, ref = FisherDiscriminant(), JaxFisher()
    ps, js = FeatureSchema.from_json(obj), JaxSchema.from_json(obj)
    for part in _chunks(text, chunks):
        port.accumulate(Dataset.from_csv(part, ps))
        ref.accumulate(JaxDataset.from_csv(part, js, engine="python"))
    return port.finalize(), ref.finalize()


@pytest.fixture(scope="module")
def corpora():
    return {"elearn": (generate_elearn(2500, seed=91, as_csv=True),
                       elearn_schema().to_json()),
            "churn": (generate_churn(2500, seed=92, as_csv=True),
                      churn_schema().to_json())}


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("corpus", ["elearn", "churn"])
def test_fit_and_file_byte_identical(corpora, tmp_path, corpus, chunks):
    port, ref = _fit(*corpora[corpus], chunks)
    for a, b in ((port._cnt, ref._cnt), (port._s1, ref._s1),
                 (port._s2, ref._s2)):
        assert a.tobytes() == b.tobytes()
    assert port.boundaries == ref.boundaries and port.means == ref.means
    port.save(str(tmp_path / "port.txt"))
    ref.save(str(tmp_path / "jax.txt"))
    for ext in ("", ".stamp.json"):
        assert (tmp_path / f"port.txt{ext}").read_bytes() == \
            (tmp_path / f"jax.txt{ext}").read_bytes()


def _file(fd, tmp_path, name) -> bytes:
    fd.save(str(tmp_path / name), stamp=False)
    return (tmp_path / name).read_bytes()


def test_chunking_does_not_move_the_file(corpora, tmp_path):
    """The chunking moves the float64 sums in their last bits, never the
    file's %.6f."""
    one, _ = _fit(*corpora["elearn"], 1)
    five, _ = _fit(*corpora["elearn"], 5)
    assert _file(one, tmp_path, "a") == _file(five, tmp_path, "b")


def test_merge_of_shards_equals_whole(corpora, tmp_path):
    text, obj = corpora["elearn"]
    whole, _ = _fit(text, obj, 1)
    halves = _chunks(text, 2)
    schema = FeatureSchema.from_json(obj)
    parts = [FisherDiscriminant().accumulate(Dataset.from_csv(h, schema))
             for h in halves]
    merged = FisherDiscriminant().merge(parts[0]).merge(parts[1]).merge(
        FisherDiscriminant()).finalize()
    assert _file(merged, tmp_path, "a") == _file(whole, tmp_path, "b")


def test_predict_load_and_refit(corpora, tmp_path):
    text, obj = corpora["elearn"]
    port, ref = _fit(text, obj, 1)
    ds = Dataset.from_csv(text, FeatureSchema.from_json(obj))
    jds = JaxDataset.from_csv(text, JaxSchema.from_json(obj), engine="python")
    for o in port.boundaries:
        np.testing.assert_array_equal(port.predict(ds, o), ref.predict(jds, o))
        x = np.linspace(-10, 110, 97)
        np.testing.assert_array_equal(port.predict_values(o, x),
                                      ref.predict_values(o, x))
    path = str(tmp_path / "fd.txt")
    ref.save(path)                          # a JAX file loads in the port
    back = FisherDiscriminant.load(path)
    assert back.boundaries.keys() == port.boundaries.keys()
    for o in port.boundaries:
        assert abs(back.boundaries[o] - port.boundaries[o]) <= 5e-7
        np.testing.assert_array_equal(back.predict(ds, o),
                                      JaxFisher.load(path).predict(jds, o))
    assert FisherDiscriminant().fit(ds).boundaries == port.boundaries
    (tmp_path / "fd.txt").write_text("1,0.0,0.0,0.0\n")
    with pytest.raises(ModelFormatSkew):
        FisherDiscriminant.load(path)


@pytest.mark.parametrize("block_mb", [None, "0.03"])
def test_job_byte_identical_to_jax_and_through_the_cli(corpora, tmp_path,
                                                       block_mb):
    text, obj = corpora["elearn"]
    csv = tmp_path / "train.csv"
    csv.write_text(text)
    schema = tmp_path / "schema.json"
    schema.write_text(json.dumps(obj))
    props = {"fid.feature.schema.file.path": str(schema)}
    if block_mb:
        props["fid.stream.block.size.mb"] = block_mb
    ref = jax_run_job("fisherDiscriminant", props, [str(csv)],
                      str(tmp_path / "jax.txt"))
    conf = tmp_path / "fid.properties"
    conf.write_text("".join(f"{k}={v}\n" for k, v in props.items()))
    proc = subprocess.run(
        [sys.executable, "-m", "avenir_tpu_torch",
         "org.avenir.discriminant.FisherDiscriminant", "--conf", str(conf),
         str(csv), str(tmp_path / "port.txt"), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    assert row["job"] == "fisherDiscriminant"
    assert set(row["counters"]) == set(DELTA_COUNTERS) | set(MEM_COUNTERS)
    assert row["counters"]["Mem:PredictedPeakBytes"] == \
        ref.counters["Mem:PredictedPeakBytes"]
    for ext in ("", ".stamp.json"):
        assert (tmp_path / f"port.txt{ext}").read_bytes() == \
            (tmp_path / f"jax.txt{ext}").read_bytes()
