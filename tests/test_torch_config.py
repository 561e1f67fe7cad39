"""The port's configuration: .properties strings and HOCON `.conf` jobs.

`avenir_tpu_torch.core.config` against `avenir_tpu.core.config`: the
cases of `tests/test_core.py` (prefixes, empty values, lists, the HOCON
blocks, values and errors) on the port, both parsers on the same texts,
and the supplier-fulfillment CTMC pair (`stateTransitionRate`,
`contTimeStateTransitionStats`) run from one `sup.conf` through
`run_job`, `run_from_cli` and `python -m avenir_tpu_torch`, every file
equal to the reference's.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.core import config as jconfig
from avenir_tpu.runner import run_job as jrun_job
from avenir_tpu_torch.core.config import (JobConfig, MissingConfigError,
                                          load_hocon, parse_properties_string)
from avenir_tpu_torch.runner import run_from_cli, run_job

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROPS = textwrap.dedent(
    """\
    # shared
    field.delim.regex=,
    debug.on=true
    num.reducer=1
    nen.top.match.count=5
    nen.kernel.function=none
    nen.class.condtion.weighted=true
    dtb.max.depth.limit=2
    dtb.min.info.gain.limit=
    costs=2,5.5
    """
)

CONF = textwrap.dedent(
    """\
    // spark job blocks
    stateTransitionRate {
        field.delim.in = ","
        key.field.ordinals = [0]
        state.values = ["10", "20", "30"]
        rate.time.unit = "day"
        trans.rate.output.precision = 9
        debug.on = false
    }
    contTimeStateTransitionStats {
        state.values = ["F", "P", "L"]
        time.horizon = 4
        state.trans.file.path="file:///tmp/tra"
        target.states = ["L"]
        nested {
            inner.key = 7
        }
    }
    """
)


# ---------------------------------------------------------- properties
def test_prefix_resolution():
    cfg = JobConfig(parse_properties_string(PROPS), prefix="nen")
    assert cfg.get_int("top.match.count") == 5
    assert cfg.get("kernel.function") == "none"
    assert cfg.get_bool("class.condtion.weighted") is True
    assert cfg.get_int("num.reducer") == 1        # the shared key
    assert cfg.debug_on is True


def test_empty_value_is_missing():
    cfg = JobConfig(parse_properties_string(PROPS), prefix="dtb")
    assert cfg.get_float("min.info.gain.limit") is None
    assert cfg.get_int("max.depth.limit") == 2


def test_assert_raises_and_lists_and_scoped():
    cfg = JobConfig(parse_properties_string(PROPS), prefix="nen")
    with pytest.raises(MissingConfigError, match="nen.nonexistent.key"):
        cfg.assert_int("nonexistent.key")
    assert JobConfig(parse_properties_string(PROPS)).get_float_list(
        "costs") == [2.0, 5.5]
    assert cfg.scoped("dtb").get_int("max.depth.limit") == 2


@pytest.mark.parametrize("text", [
    PROPS,
    "! bang comment\n a.b : c d \n\n k=v=w\nnovalue\n x:\n",
    "# only a comment\n",
    "dup=1\ndup=2\n  spaced key  =  spaced value  \n",
])
def test_parse_properties_string_equals_reference(text):
    assert parse_properties_string(text) == \
        jconfig.parse_properties_string(text)


# ---------------------------------------------------------------- HOCON
def test_hocon_blocks_and_values(tmp_path):
    p = tmp_path / "jobs.conf"
    p.write_text(CONF)
    blocks = load_hocon(str(p))
    assert set(blocks) == {"stateTransitionRate",
                           "contTimeStateTransitionStats"}
    str_blk = blocks["stateTransitionRate"]
    assert str_blk["key.field.ordinals"] == "0"
    assert str_blk["state.values"] == "10,20,30"
    assert str_blk["rate.time.unit"] == "day"
    cts = blocks["contTimeStateTransitionStats"]
    assert cts["state.trans.file.path"] == "file:///tmp/tra"
    assert cts["nested.inner.key"] == "7"
    assert blocks == jconfig.load_hocon(str(p))


def test_hocon_jobconfig_over_block(tmp_path):
    p = tmp_path / "jobs.conf"
    p.write_text(CONF)
    cfg = JobConfig.from_hocon(str(p), "contTimeStateTransitionStats",
                               prefix="cts")
    assert cfg.get_list("state.values") == ["F", "P", "L"]
    assert cfg.get_float("time.horizon") == 4.0
    assert cfg.get_list("target.states") == ["L"]
    with pytest.raises(MissingConfigError) as got:
        JobConfig.from_hocon(str(p), "noSuchJob")
    with pytest.raises(jconfig.MissingConfigError) as want:
        jconfig.JobConfig.from_hocon(str(p), "noSuchJob")
    assert str(got.value) == str(want.value)
    assert "contTimeStateTransitionStats, stateTransitionRate" in \
        str(got.value)


@pytest.mark.parametrize("text,match", [
    ("jobA {\n key = 1\n", "unclosed"),
    ("stray.key = 1\n", "outside a job block"),
    ("jobA {\n key = 1\n}\n}\n", "unbalanced"),
])
def test_hocon_malformed_raises_as_reference(tmp_path, text, match):
    p = tmp_path / "bad.conf"
    p.write_text(text)
    with pytest.raises(ValueError, match=match) as got:
        load_hocon(str(p))
    with pytest.raises(ValueError) as want:
        jconfig.load_hocon(str(p))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("text", [
    CONF,
    "a {\n  # hash comment\n  k: 'single'\n  l = []\n  m = [ x ,\"y\", 'z' ]\n"
    "  n = \"\"\n  o = ab\"c\n}\n",
    "outer {\n  mid {\n    deep {\n      k = 1\n    }\n    j = [1, 2]\n"
    "  }\n  not an entry\n}\nsecond {\n}\n",
    "a {\n  k = 1\n}\na {\n  k = 2\n  l = 3\n}\n",
])
def test_hocon_equals_reference(tmp_path, text):
    p = tmp_path / "x.conf"
    p.write_text(text)
    assert load_hocon(str(p)) == jconfig.load_hocon(str(p))


# ------------------------------------------------------ the CTMC jobs
SUP_CONF = """
stateTransitionRate {{
  field.delim.in = ","
  key.field.ordinals = [0]
  time.field.ordinal = 1
  state.field.ordinal = 2
  state.values = ["F", "P", "L"]
  rate.time.unit = "week"
  input.time.unit = "ms"
  trans.rate.output.precision = 9
}}

contTimeStateTransitionStats {{
  field.delim.in = ","
  key.field.len = 1
  state.values = ["F", "P", "L"]
  time.horizon = 4
  state.trans.file.path = "{workdir}/rates.txt"
  state.trans.stat = "stateDwellTime"
  target.states = ["L"]
}}
"""


def _ctmc_inputs(workdir):
    """The tutorial's fulfillment history (six products, 100 weeks), its
    `sup.conf` and the queries, written under `workdir`."""
    states = ["F", "P", "L"]
    profiles = {
        "reliable": [[.85, .10, .05], [.60, .25, .15], [.50, .30, .20]],
        "struggling": [[.40, .30, .30], [.25, .40, .35], [.15, .35, .50]],
    }
    rng = np.random.default_rng(13)
    week_ms = 604_800_000
    data = os.path.join(workdir, "fulfill.csv")
    with open(data, "w") as fh:
        for p in range(6):
            kind = "reliable" if p % 2 == 0 else "struggling"
            s = 0
            for w in range(100):
                fh.write(f"PROD{p:02d},{w * week_ms},{states[s]}\n")
                s = rng.choice(3, p=profiles[kind][s])
    conf = os.path.join(workdir, "sup.conf")
    with open(conf, "w") as fh:
        fh.write(SUP_CONF.format(workdir=workdir))
    queries = os.path.join(workdir, "queries.csv")
    with open(queries, "w") as fh:
        fh.write("".join(f"PROD{p:02d},L\n" for p in range(6)))
    return conf, data, queries


def _read(workdir, name):
    with open(os.path.join(workdir, name), "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def reference_ctmc(tmp_path_factory):
    ref = str(tmp_path_factory.mktemp("ref"))
    conf, data, queries = _ctmc_inputs(ref)
    jrun_job("stateTransitionRate", conf, [data],
             os.path.join(ref, "rates.txt"))
    jrun_job("contTimeStateTransitionStats", conf, [queries],
             os.path.join(ref, "dwell.csv"))
    return {n: _read(ref, n) for n in ("rates.txt", "dwell.csv")}


def test_ctmc_pair_from_one_conf_through_run_job(tmp_path, reference_ctmc):
    conf, data, queries = _ctmc_inputs(str(tmp_path))
    res = run_job("stateTransitionRate", conf, [data],
                  str(tmp_path / "rates.txt"), device="cpu")
    assert res.counters["Basic:Entities"] == 6
    run_job("contTimeStateTransitionStats", conf, [queries],
            str(tmp_path / "dwell.csv"), device="cpu")
    for name, want in reference_ctmc.items():
        assert _read(str(tmp_path), name) == want, name


def test_ctmc_pair_from_one_conf_through_run_from_cli(tmp_path,
                                                      reference_ctmc, capsys):
    conf, data, queries = _ctmc_inputs(str(tmp_path))
    run_from_cli(["stateTransitionRate", "--conf", conf, data,
                  str(tmp_path / "rates.txt"), "--device", "cpu"])
    run_from_cli(["org.avenir.spark.markov.ContTimeStateTransitionStats",
                  "--conf", conf, queries, str(tmp_path / "dwell.csv"),
                  "--device", "cpu"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["job"] for r in rows] == ["stateTransitionRate",
                                        "contTimeStateTransitionStats"]
    for name, want in reference_ctmc.items():
        assert _read(str(tmp_path), name) == want, name


def test_ctmc_pair_through_the_module_cli(tmp_path, reference_ctmc):
    conf, data, queries = _ctmc_inputs(str(tmp_path))
    for job, src, out in (("stateTransitionRate", data, "rates.txt"),
                          ("contTimeStateTransitionStats", queries,
                           "dwell.csv")):
        proc = subprocess.run(
            [sys.executable, "-m", "avenir_tpu_torch", job, "--conf", conf,
             src, str(tmp_path / out), "--device", "cpu"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert json.loads(proc.stdout.splitlines()[-1])["job"] == job
    for name, want in reference_ctmc.items():
        assert _read(str(tmp_path), name) == want, name


def test_conf_route_names_the_missing_block(tmp_path):
    p = tmp_path / "only.conf"
    p.write_text("stateTransitionRate {\n  time.field.ordinal = 1\n}\n")
    with pytest.raises(MissingConfigError, match="no block 'wordCounter'"):
        run_job("wordCounter", str(p), [], str(tmp_path / "o"), device="cpu")
