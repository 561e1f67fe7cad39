"""The autotune loop in the port's job server, spool and fleet, held against
the JAX package on the CPU: the residual-corrected tuned pricer (never
under its base, the reference's price on the same store), the admission
price of an autotuned request at its overlaid knobs, the scheduler's
fold-cost balance break, the injection of `stream.autotune.dir` into the
request conf, the spool's `--autotune-dir`, and `Fleet(profile_dir=)`:
its hosts' `--autotune-dir`, its tuned front pricer and its fold-cost
placement weight. Inputs are made from seeds."""

import json
import os

import pytest
import torch_reference_native  # noqa: F401  (settles the reference's native route)

from avenir_tpu_torch import tune
from avenir_tpu_torch.server import JobRequest, JobServer
from avenir_tpu_torch.server.jobserver import price_request_bytes
from avenir_tpu_torch.tune.store import ProfileStore, corpus_digest

CPU = "cpu"
WAIT_S = 120


def _churn(tmp_path, rows=600, seed=7):
    from avenir_tpu.data import churn_schema, generate_churn

    csv = tmp_path / "churn.csv"
    csv.write_text(generate_churn(rows, seed=seed, as_csv=True))
    schema = tmp_path / "churn.json"
    churn_schema().save(str(schema))
    return str(csv), str(schema)


def _conf(prefix, schema, **extra):
    conf = {f"{prefix}.feature.schema.file.path": schema}
    if prefix == "mut":
        conf["mut.mutual.info.score.algorithms"] = "mutual.info.maximization"
    conf.update({f"{prefix}.{k}": v for k, v in extra.items()})
    return conf


def _server(tmp_path, **kw):
    kw.setdefault("state_root", str(tmp_path / "srv_state"))
    kw.setdefault("device", CPU)
    return JobServer(**kw)


def _both_requests(job, conf, inputs, out):
    from avenir_tpu.server.jobserver import JobRequest as RefRequest

    return JobRequest(job, conf, inputs, out), RefRequest(job, conf, inputs,
                                                          out)


# =============================================================== pricing
@pytest.mark.parametrize("history", [
    [], [(1000, 500)], [(1000, 3000)], [(1000, 500), (1000, 3000)],
    [(1, 10 ** 12)], [(0, 100), (100, 0)]], ids=lambda h: f"n{len(h)}")
def test_tuned_pricer_matches_reference_and_never_undercuts(tmp_path,
                                                           history):
    """On one store both packages' tuned pricers give the same price over a
    fixed base, and it is never under the base."""
    from avenir_tpu.tune import make_tuned_pricer as ref_pricer

    csv, schema = _churn(tmp_path)
    req, ref_req = _both_requests("mutualInformation", _conf("mut", schema),
                                  [csv], str(tmp_path / "o"))
    store = ProfileStore(str(tmp_path / "t"))
    for predicted, measured in history:
        store.record_residual("mutualInformation", corpus_digest([csv]),
                              predicted, measured)

    def base(requests, reserve):
        return 1000

    got = tune.make_tuned_pricer(str(tmp_path / "t"), base=base)([req], 0)
    want = ref_pricer(str(tmp_path / "t"), base=base)([ref_req], 0)
    assert got == want >= 1000
    assert got <= int(1000 * tune.RESIDUAL_FACTOR_CAP)


def test_tuned_pricer_over_the_footprint_model(tmp_path):
    """The default base is `price_request_bytes`: the tuned price over it
    equals the reference's over its own."""
    from avenir_tpu.tune import make_tuned_pricer as ref_pricer

    csv, schema = _churn(tmp_path)
    req, ref_req = _both_requests("mutualInformation", _conf("mut", schema),
                                  [csv], str(tmp_path / "o"))
    ProfileStore(str(tmp_path / "t")).record_residual(
        "mutualInformation", corpus_digest([csv]), 1000, 2500)
    got = tune.make_tuned_pricer(str(tmp_path / "t"))([req], 1 << 20)
    want = ref_pricer(str(tmp_path / "t"))([ref_req], 1 << 20)
    assert got == want == int(price_request_bytes([req], 1 << 20) * 2.5)


def test_admission_prices_the_overlaid_knobs(tmp_path):
    """An autotuned request is priced at the knobs the runner will overlay,
    as the reference prices it; without the opt-in the profile is not
    read."""
    from avenir_tpu.server.jobserver import \
        price_request_bytes as ref_price

    csv, schema = _churn(tmp_path)
    tune_dir = str(tmp_path / "t")
    conf = _conf("mut", schema, **{"stream.autotune": "true",
                                   "stream.autotune.dir": tune_dir})
    req, ref_req = _both_requests("mutualInformation", conf, [csv],
                                  str(tmp_path / "o"))
    untuned = price_request_bytes([req])
    assert untuned == ref_price([ref_req])
    ProfileStore(tune_dir).set_knobs(
        "mutualInformation", corpus_digest([csv]),
        {"stream.block.size.mb": 256.0, "stream.prefetch.depth": 8}, [])
    tuned = price_request_bytes([req])
    assert tuned == ref_price([ref_req]) > untuned
    off = {k: v for k, v in conf.items() if "autotune" not in k}
    req_off, ref_off = _both_requests("mutualInformation", off, [csv],
                                      str(tmp_path / "o2"))
    assert price_request_bytes([req_off]) == untuned == ref_price([ref_off])


def test_server_uses_tuned_pricer_with_autotune_dir(tmp_path):
    srv = _server(tmp_path, autotune_dir=str(tmp_path / "t"))
    try:
        assert srv._pricer.__name__ == "pricer"   # the tuned wrapper
        assert srv._balance_ratio == tune.BATCH_BALANCE_RATIO
    finally:
        srv.shutdown(drain=False)


# ============================================================ scheduling
def test_scheduler_splits_imbalanced_batch(tmp_path):
    """Two compatible requests whose profiled fold costs lie far apart do
    not share a scan; inside the band they do."""
    csv, schema = _churn(tmp_path, rows=300)
    digest = corpus_digest([csv])
    for tag, cost, want in (("far", 50.0, 1.0), ("near", 2.0, 2.0)):
        tune_dir = str(tmp_path / f"t_{tag}")
        store = ProfileStore(tune_dir)
        store.note_fold_cost("bayesianDistr", digest, 1.0)
        store.note_fold_cost("mutualInformation", digest, cost)
        srv = _server(tmp_path, workers=1, autotune_dir=tune_dir,
                      state_root=str(tmp_path / f"s_{tag}"))
        try:
            t1 = srv.submit(JobRequest("bayesianDistr", _conf("bad", schema),
                                       [csv], str(tmp_path / f"nb_{tag}"),
                                       tenant="a"))
            t2 = srv.submit(JobRequest("mutualInformation",
                                       _conf("mut", schema), [csv],
                                       str(tmp_path / f"mi_{tag}"),
                                       tenant="b"))
            srv.start()
            for t in (t1, t2):
                assert t.result(timeout=WAIT_S).counters[
                    "Server:BatchSize"] == want, tag
        finally:
            srv.shutdown()


@pytest.mark.parametrize("conf_kind", ["dict", "jobconfig", "tenant_dir",
                                       "path", "no_dir"])
def test_tune_dir_injected_like_the_reference(tmp_path, conf_kind):
    from avenir_tpu.core.config import JobConfig as RefConfig
    from avenir_tpu.server.jobserver import JobServer as RefServer
    from avenir_tpu_torch.core.config import JobConfig

    props = {"mut.feature.schema.file.path": "s.json"}
    if conf_kind == "tenant_dir":
        props["stream.autotune.dir"] = "/tenant/t"
    confs = {"dict": (props, props), "tenant_dir": (props, props),
             "no_dir": (props, props),
             "jobconfig": (JobConfig(props, "mut"), RefConfig(props, "mut")),
             "path": ("j.properties", "j.properties")}[conf_kind]
    tune_dir = None if conf_kind == "no_dir" else str(tmp_path / "t")
    srv = _server(tmp_path, autotune_dir=tune_dir)
    ref = RefServer(autotune_dir=tune_dir,
                    state_root=str(tmp_path / "ref_state"))
    try:
        got = srv._conf_with_tune_dir(confs[0])
        want = ref._conf_with_tune_dir(confs[1])
        if conf_kind == "jobconfig":
            assert (got.props, got.prefix) == (want.props, want.prefix)
        else:
            assert got == want
    finally:
        srv.shutdown(drain=False)
        ref.shutdown(drain=False)


def test_served_autotuned_request_profiles_into_the_server_store(tmp_path):
    """An autotuned request with no `stream.autotune.dir` of its own records
    its profile (and its residual) in the server's autotune dir, and its
    artifact equals the solo run's."""
    from avenir_tpu_torch.runner import run_job

    csv, schema = _churn(tmp_path)
    tune_dir = str(tmp_path / "t")
    conf = _conf("mut", schema, **{"stream.autotune": "true",
                                   "stream.block.size.mb": "0.01"})
    with _server(tmp_path, workers=1, autotune_dir=tune_dir) as srv:
        srv.start()
        res = srv.submit(JobRequest("mutualInformation", conf, [csv],
                                    str(tmp_path / "served.txt"))).result(
            timeout=WAIT_S)
    prof = ProfileStore(tune_dir).load("mutualInformation",
                                       corpus_digest([csv]))
    assert prof is not None and prof["runs"] and prof["knobs"]
    assert res.counters["Mem:PredictedPeakBytes"] > 0
    solo = run_job("mutualInformation", _conf("mut", schema), [csv],
                   str(tmp_path / "solo.txt"), device=CPU)
    assert open(res.outputs[0], "rb").read() == \
        open(solo.outputs[0], "rb").read()
    assert not os.path.exists(os.path.join(str(tmp_path), ".avenir_tune",
                                           "mutualInformation_"
                                           + corpus_digest([csv]) + ".json"))


def test_spool_autotune_dir_reaches_the_server(tmp_path):
    """`serve --spool DIR --once --autotune-dir T`: the spooled autotuned
    request profiles into T."""
    from avenir_tpu_torch.server.spool import serve_main

    csv, schema = _churn(tmp_path, rows=400)
    spool = str(tmp_path / "spool")
    os.makedirs(os.path.join(spool, "in"))
    req = {"job": "mutualInformation",
           "conf": _conf("mut", schema, **{"stream.autotune": "true"}),
           "inputs": [csv], "output": str(tmp_path / "sp.txt")}
    with open(os.path.join(spool, "in", "req_1.json"), "w") as fh:
        json.dump(req, fh)
    tune_dir = str(tmp_path / "t")
    assert serve_main(["--spool", spool, "--once", "--workers", "1",
                       "--autotune-dir", tune_dir, "--device", CPU,
                       "--state-root", str(tmp_path / "st")]) == 0
    with open(os.path.join(spool, "out", "req_1.json")) as fh:
        assert json.load(fh)["ok"]
    assert ProfileStore(tune_dir).load("mutualInformation",
                                       corpus_digest([csv]))["runs"]


# ================================================================= fleet
def test_fleet_profile_dir_reaches_hosts_pricer_and_placement(tmp_path,
                                                              monkeypatch):
    """`Fleet(profile_dir=)`: each host is spawned with `--autotune-dir`,
    the front prices with the tuned pricer (the reference's price on the
    same store), and the placement cost is the profile's fold cost (the
    reference's `placement_cost_ms`)."""
    from avenir_tpu.server.jobserver import JobRequest as RefRequest
    from avenir_tpu.tune import make_tuned_pricer as ref_pricer
    from avenir_tpu.tune import placement_cost_ms as ref_cost
    from avenir_tpu_torch.net import fleet as fleet_mod

    spawned = []

    class _FakePopen:
        def __init__(self, cmd, **kw):
            spawned.append(cmd)
            self.pid = 0

        def poll(self):
            return None

    monkeypatch.setattr(fleet_mod.subprocess, "Popen", _FakePopen)
    csv, schema = _churn(tmp_path)
    prof_dir = str(tmp_path / "profiles")
    store = ProfileStore(prof_dir)
    store.note_fold_cost("mutualInformation", corpus_digest([csv]), 12.5)
    store.record_residual("mutualInformation", corpus_digest([csv]), 10, 30)
    fleet = fleet_mod.Fleet(str(tmp_path / "fleet"), hosts=2,
                            profile_dir=prof_dir, device=CPU)
    for i in range(2):
        fleet._spawn_host(i)
    assert len(spawned) == 2
    for cmd in spawned:
        assert cmd[cmd.index("--autotune-dir") + 1] == prof_dir
        assert cmd[cmd.index("--device") + 1] == CPU
    obj = {"job": "mutualInformation", "conf": _conf("mut", schema),
           "inputs": [csv], "output": str(tmp_path / "o.txt")}
    _req, priced, cost = fleet.price(obj)
    ref_req = RefRequest("mutualInformation", obj["conf"], [csv],
                         obj["output"])
    from avenir_tpu.server.jobserver import DEFAULT_RESERVE_BYTES

    assert priced == int(ref_pricer(prof_dir)([ref_req],
                                              DEFAULT_RESERVE_BYTES))
    assert priced == 3 * price_request_bytes(
        [JobRequest("mutualInformation", obj["conf"], [csv], obj["output"])],
        DEFAULT_RESERVE_BYTES)
    assert cost == 12.5 == ref_cost(prof_dir, "mutualInformation",
                                    obj["conf"], [csv])
    assert tune.placement_cost_ms(prof_dir, "mutualInformation",
                                  obj["conf"], [csv]) == cost
    # no store, an unknown job or an unmeasured corpus: bytes-only
    assert tune.placement_cost_ms(None, "mutualInformation", {}, [csv]) \
        is None
    assert tune.placement_cost_ms(prof_dir, "noSuchJob", {}, [csv]) is None
    assert tune.placement_cost_ms(prof_dir, "bayesianDistr", {}, [csv]) \
        is None


def test_fleet_cli_profile_dir_is_no_longer_refused(tmp_path, monkeypatch):
    """`fleet --profile-dir` builds a Fleet with the store (no refusal)."""
    from avenir_tpu_torch.net import fleet as fleet_mod

    seen = {}

    class _Stop(Exception):
        pass

    def fake_fleet(root, **kw):
        seen.update(kw)
        raise _Stop

    monkeypatch.setattr(fleet_mod, "Fleet", fake_fleet)
    with pytest.raises(_Stop):
        fleet_mod.fleet_main(["--root", str(tmp_path / "r"), "--hosts", "1",
                              "--profile-dir", str(tmp_path / "p"),
                              "--device", CPU, "--once"])
    assert seen["profile_dir"] == str(tmp_path / "p")
