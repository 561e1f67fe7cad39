"""The port's samplers, histogram, MCMC diagnostics and Metropolis walk
(`avenir_tpu_torch/utils/sampling.py`, `utils/mcmc.py`,
`ops/sampling_kernels.py`) against the JAX package on the CPU.

- `Histogram`, `GaussianSampler`, `NonParamSampler` and both diagnostics
  are numpy copies: every result equal (tolerance 0).
- The bin index is JAX's float floor division, not floor(x / bw): equal
  to the reference's jitted index at bin edges, at xmin and xmax, and at
  values the clamp moves.
- The float32 constants: `cur` is numpy's float64 uniform rounded once.
- The plain walk fed the JAX package's own draws equals the reference's
  `sample` bit for bit (plain and mixture modes, skips 1 and 2, calls in
  a row): the proposal's multiply-add rounds once, and in plain mode the
  std is float32 pstd * sqrt(2) on erf_inv(u), as XLA compiles it.
- The whole chain (the port's draws, whose normals are within 3 ULP of
  JAX's) by `tools.sampling_check.walk_divergence`: the chains may part
  only where two proposals fall on either side of a bin edge or of the
  clamp. On the six fixtures below (six targets, seed 0, 20,000 steps
  each; 214-232 steps a chain draw a z apart from JAX's) no chain
  parted: each tracked JAX's to its end, at most 4.8e-6 apart (the gap
  tolerance is 2^-12 bin widths, 2.4e-5 to 2.4e-4), its taken count
  equal; seed 3 gave the same on all six (196-241 z apart). A step that
  parts needs a proposal within a chain's gap of a bin edge, one in
  10^5 steps or fewer at these widths, so the test allows at most two. A constructed step that
  straddles an edge is allowed, and a shifted chain or shifted uniforms
  are refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from avenir_tpu.utils import mcmc as jmcmc
from avenir_tpu.utils import sampling as jsamp
from avenir_tpu_torch.ops import prng
from avenir_tpu_torch.ops import sampling_kernels as sk
from avenir_tpu_torch.tools.sampling_check import walk_divergence
from avenir_tpu_torch.utils import mcmc as tmcmc
from avenir_tpu_torch.utils import sampling as tsamp

BIMODAL = [3, 2, 1, 0, 0, 0, 0, 0, 1, 2, 3]
#: (values, xmin, bin width, proposal std, mixture (global std, threshold))
TARGETS = [
    (BIMODAL, 0.0, 1.0, 2.0, None),
    ([1, 2, 3, 2, 1], 0.0, 1.0, 0.5, (3.0, 0.7)),
    (list(np.random.default_rng(5).random(40)), -1.3, 0.7, 0.37, None),
    (list(np.random.default_rng(6).random(40)), -1.3, 0.7, 0.37, (5.0, 0.3)),
    ([0.5, 4.0, 0.5], 10.0, 0.1, 1.0, None),
    ([0.5, 4.0, 0.5], 10.0, 0.1, 0.02, (1.0, 0.5)),
]
WHOLE_STEPS = 20_000


def _pair(values, xmin, bw, pstd, mixture, seed):
    j = jsamp.MetropolisSampler(proposal_std=pstd, xmin=xmin, bin_width=bw,
                                values=values, seed=seed)
    t = tsamp.MetropolisSampler(proposal_std=pstd, xmin=xmin, bin_width=bw,
                                values=values, seed=seed, device="cpu")
    if mixture:
        j.set_mixture_proposal(*mixture)
        t.set_mixture_proposal(*mixture)
    return j, t


def _jax_draws(key, steps, mixture) -> tsamp.StepDraws:
    """The reference's draws of `steps` steps under the raw key: its split,
    its erf_inv (plain) or normal (mixture) and its uniforms."""
    keys = jax.random.split(jax.random.wrap_key_data(jnp.asarray(key)),
                            steps + 1)

    def one(k):
        kp, ka = jax.random.split(k)
        if mixture:
            ku, kn = jax.random.split(kp)
            return (jax.random.normal(kn), jax.random.uniform(ka),
                    jax.random.uniform(ku))
        u = jax.random.uniform(kp, (), jnp.float32, prng.NORMAL_LO, 1.0)
        return lax.erf_inv(u), jax.random.uniform(ka), jnp.float32(0)

    z, u, m = (torch.from_numpy(np.array(a)) for a in jax.vmap(one)(keys[1:]))
    return tsamp.StepDraws(z, u, m if mixture else None)


def _raw(jkey) -> np.ndarray:
    return np.asarray(jax.random.key_data(jkey))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in float32 ULPs, on the ordered integer line."""
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    ai = np.where(ai < 0, -(ai & 0x7FFFFFFF), ai)
    bi = np.where(bi < 0, -(bi & 0x7FFFFFFF), bi)
    return np.abs(ai - bi)


# ------------------------------------------------------------ numpy copies
def test_histogram_equal():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.0, 12.0, 500)
    for j, t in ((jsamp.Histogram.uninitialized(0.0, 10.0, 1.0),
                  tsamp.Histogram.uninitialized(0.0, 10.0, 1.0)),
                 (jsamp.Histogram.initialized(-0.5, 0.7, [1.0, 3.0, 0.0, 2.0]),
                  tsamp.Histogram.initialized(-0.5, 0.7, [1.0, 3.0, 0.0,
                                                          2.0]))):
        j.add(x)
        t.add(x)
        assert np.array_equal(j.bins, t.bins)
        assert np.array_equal(j.value(x), t.value(x))
        assert np.array_equal(j.bounded(x), t.bounded(x))
        assert j.min_max() == t.min_max()
        assert np.array_equal(j.normalized(), t.normalized())
        assert np.array_equal(j.cum_value(x), t.cum_value(x))
        for pct in (0, 12.5, 50, 99, 100):
            assert j.percentile(pct) == t.percentile(pct)
        with pytest.raises(ValueError):
            t.percentile(150)
    h = tsamp.Histogram.uninitialized(0.0, 10.0, 1.0)
    h.add(np.array([0.5, 0.7, 5.2]))
    assert h.value(0.6) == 2.0 and h.value(5.0) == 1.0


@pytest.mark.parametrize("n", [None, 1, 2000])
def test_gaussian_and_nonparam_samplers_equal(n):
    j = jsamp.GaussianSampler(10.0, 2.0, rng=np.random.default_rng(0))
    t = tsamp.GaussianSampler(10.0, 2.0, rng=np.random.default_rng(0))
    a, b = j.sample(n), t.sample(n)
    assert np.array_equal(a, b) and type(a) is type(b)
    j = jsamp.NonParamSampler(0.0, 1.0, [1.0, 0.0, 3.0],
                              rng=np.random.default_rng(1))
    t = tsamp.NonParamSampler(0.0, 1.0, [1.0, 0.0, 3.0],
                              rng=np.random.default_rng(1))
    a, b = j.sample(n), t.sample(n)
    assert np.array_equal(a, b) and type(a) is type(b)


def test_samplers_behave_as_the_references():
    x = tsamp.GaussianSampler(10.0, 2.0, rng=np.random.default_rng(0)).sample(
        2000)
    assert abs(x.mean() - 10.0) < 0.2
    assert np.all(x >= 4.0) and np.all(x <= 16.0)
    x = tsamp.NonParamSampler(0.0, 1.0, [1.0, 0.0, 3.0],
                              rng=np.random.default_rng(1)).sample(4000)
    assert set(np.unique(x)) <= {0.0, 2.0}
    assert abs(np.mean(x == 2.0) - 0.75) < 0.05


@pytest.mark.parametrize("p", [1e-9, 0.001, 0.02425, 0.025, 0.3, 0.5, 0.7,
                               0.975, 0.999, 1 - 1e-9])
def test_norm_ppf_equal(p):
    assert tmcmc._norm_ppf(p) == jmcmc._norm_ppf(p)


@pytest.mark.parametrize("kind", ["iid", "ar1", "trend"])
def test_diagnostics_equal(kind):
    rng = np.random.default_rng(4)
    n = 20000
    if kind == "iid":
        chain = rng.normal(0, 1, n)
    elif kind == "ar1":
        eps = rng.normal(0, 1, n)
        chain = np.zeros(n)
        for i in range(1, n):
            chain[i] = 0.95 * chain[i - 1] + eps[i]
    else:
        chain = np.linspace(0.0, 5.0, n) + rng.normal(0, 0.1, n)
    sizes = [0, 500, 5000, n - 3]
    j = jmcmc.GewekeConvergence(burn_in_sizes=sizes)
    t = tmcmc.GewekeConvergence(burn_in_sizes=sizes)
    assert j.calculate_zscores(chain) == t.calculate_zscores(chain)
    assert j.converged() == t.converged()
    for kw in ({}, {"quantile": 0.5, "thinning_interval": 3},
               {"accuracy": 0.01, "confidence": 0.9}):
        jr = jmcmc.RafteryLewisConvergence(**kw)
        tr = tmcmc.RafteryLewisConvergence(**kw)
        assert jr.find_sample_size(chain) == tr.find_sample_size(chain)
        assert jr.find_sample_size(chain, threshold=0.1) == \
            tr.find_sample_size(chain, threshold=0.1)
        assert jr.n_min() == tr.n_min()


def test_diagnostics_behave_as_the_references():
    rng = np.random.default_rng(2)
    g = tmcmc.GewekeConvergence(burn_in_sizes=[0, 500])
    zs = g.calculate_zscores(rng.normal(0.0, 1.0, 5000))
    assert len(zs) == 2 and all(abs(z) < 3.0 for _, _, z in zs)
    assert g.converged()
    rl = tmcmc.RafteryLewisConvergence(quantile=0.025, accuracy=0.005,
                                       confidence=0.95)
    burn_in, n = rl.find_sample_size(np.random.default_rng(4).normal(
        0, 1, 20000))
    assert burn_in >= 0 and 0.2 * rl.n_min() < n < 20 * rl.n_min()
    assert abs(tmcmc._norm_ppf(0.975) - 1.959964) < 1e-4


# ------------------------------------------------------------- the traps
def _jax_bin_index(x, xmin, bw, nb):
    f = jax.jit(lambda v: jnp.clip(((v - xmin) // bw).astype(jnp.int32),
                                   0, nb - 1))
    return np.asarray(f(jnp.asarray(x, jnp.float32)))


@pytest.mark.parametrize("xmin,bw,nb", [(0.0, 1.0, 11), (-1.3, 0.7, 40),
                                        (10.0, 0.1, 3), (-5.0, 0.3, 200)])
def test_bin_index_is_jax_floor_division(xmin, bw, nb):
    f32 = np.float32
    xmax = f32(xmin + bw * (nb - 1))
    edges = f32(xmin) + np.arange(-2, nb + 2, dtype=f32) * f32(bw)
    near = np.concatenate([np.nextafter(edges, f32(-np.inf)), edges,
                           np.nextafter(edges, f32(np.inf))])
    rng = np.random.default_rng(nb)
    x = np.concatenate([near, [f32(xmin), xmax, f32(xmin) - f32(3 * bw),
                               xmax + f32(5 * bw)],
                        rng.uniform(xmin - bw, float(xmax) + bw, 3000)
                        .astype(f32)]).astype(f32)
    want = _jax_bin_index(x, xmin, bw, nb)
    got = sk.bin_index(torch.from_numpy(x), float(f32(xmin)),
                       float(f32(bw)), nb).numpy()
    assert got.tolist() == want.tolist()
    scalar = [sk.bin_index_scalar(v, f32(xmin), f32(bw), nb) for v in x]
    assert scalar == want.tolist()


def test_bin_index_is_not_floor_of_the_quotient():
    """Where (x - xmin) / bw rounds up to an integer, the floor division
    keeps the bin below: the trap the walk avoids."""
    f32 = np.float32
    xmin, bw = f32(-1.3), f32(0.7)
    x = (f32(xmin) + np.arange(40, dtype=f32) * bw).astype(f32)
    x = np.concatenate([x, np.nextafter(x, f32(-np.inf))]).astype(f32)
    want = _jax_bin_index(x, xmin, bw, 40)
    naive = np.clip(np.floor((x - xmin) / bw).astype(np.int64), 0, 39)
    assert (want != naive).any()
    assert sk.bin_index(torch.from_numpy(x), float(xmin), float(bw),
                        40).numpy().tolist() == want.tolist()


def test_constants_are_float32():
    j, t = _pair(BIMODAL, -1.3, 0.7, 0.37, (5.0, 0.3), 9)
    assert t.cur == j.cur
    assert np.float32(t.cur) == np.asarray(jnp.asarray(j.cur))
    w = t.walk_target()
    f32 = np.float32
    assert (w.xmin, w.xmax, w.bin_width, w.pstd, w.gstd, w.thr) == tuple(
        float(f32(v)) for v in (-1.3, j.target.xmax, 0.7, 0.37, 5.0, 0.3))
    assert w.bins.dtype == torch.float32
    # the plain proposal's std is float32 pstd * sqrt(2), as XLA folds it
    t.global_proposal_std = None
    assert t.walk_target().pstd == float(f32(f32(0.37) * f32(np.sqrt(2))))
    assert float(sk.FLOOR) == float(np.asarray(jnp.maximum(
        jnp.float32(0), 1e-30)))


@pytest.mark.parametrize("target,seed",
                         [(t, 0) for t in TARGETS] + [(TARGETS[0], 3),
                                                      (TARGETS[3], 3)])
def test_plain_walk_on_jax_draws_is_jax_chain(target, seed):
    """The plain walk fed the reference's own draws equals its `sample`,
    bit for bit, over two calls in a row (skips 1 and 2)."""
    values, xmin, bw, pstd, mixture = target
    j, t = _pair(values, xmin, bw, pstd, mixture, seed)
    walk = t.walk_target()
    x0 = j.cur
    for n, skip in ((1500, 1), (700, 2)):
        key = _raw(j.key)
        want = j.sample(n, skip)
        draws = _jax_draws(key, n * skip, mixture is not None)
        chain, taken = sk.metropolis_walk_plain(draws.z, draws.uniforms,
                                                draws.mix, walk, x0)
        got = chain.numpy()[skip - 1::skip][:n]
        assert got.view(np.int32).tolist() == want.view(np.int32).tolist()
        x0 = float(chain[-1])
        assert x0 == j.cur
        if skip == 1:
            assert int(taken) == j.trans_count


def test_wrapper_takes_the_plain_version_on_the_cpu():
    values, xmin, bw, pstd, mixture = TARGETS[3]
    _, t = _pair(values, xmin, bw, pstd, mixture, 1)
    _key, draws = tsamp.draw_steps(t.key, 300, True, torch.device("cpu"))
    sk.reset_launches()
    a = sk.metropolis_walk(draws.z, draws.uniforms, draws.mix,
                           t.walk_target(), t.cur)
    b = sk.metropolis_walk_plain(draws.z, draws.uniforms, draws.mix,
                                 t.walk_target(), t.cur)
    assert torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])
    assert sk.metropolis_walk.launches == 0
    with pytest.raises(ValueError, match="global std"):
        sk.metropolis_walk(draws.z, draws.uniforms, None, t.walk_target(),
                           t.cur)
    with pytest.raises(ValueError, match="one value a step"):
        sk.metropolis_walk(draws.z[:-1], draws.uniforms, draws.mix,
                           t.walk_target(), t.cur)
    with pytest.raises(TypeError, match="float32"):
        sk.metropolis_walk(draws.z.double(), draws.uniforms, draws.mix,
                           t.walk_target(), t.cur)


def test_draws_are_jax_draws():
    """The port's draws: keys and uniforms bit for bit, z within 3 ULP."""
    for mixture in (False, True):
        key = prng.split(prng.PRNGKey(11), 2)[1]
        nxt, got = tsamp.draw_steps(key, 4000, mixture, torch.device("cpu"))
        want = _jax_draws(key, 4000, mixture)
        assert nxt.tolist() == _raw(jax.random.split(
            jax.random.wrap_key_data(jnp.asarray(key)), 4001)[0]).tolist()
        assert torch.equal(got.uniforms, want.uniforms)
        if mixture:
            assert torch.equal(got.mix, want.mix)
        d = _ulps(got.z.numpy(), want.z.numpy())
        assert d.max() <= 3 and (d > 0).mean() < 0.02


# ----------------------------------------------------------- whole chains
def test_whole_chain_by_the_divergence_rule():
    parted, tracked = [], 0
    for k, (values, xmin, bw, pstd, mixture) in enumerate(TARGETS):
        for seed in (0,):
            j, t = _pair(values, xmin, bw, pstd, mixture, seed)
            key = _raw(j.key)
            x0 = t.cur
            want = j.sample(WHOLE_STEPS, 1)
            chain, draws = t.walk(WHOLE_STEPS)
            res = walk_divergence(t.walk_target(), x0, chain, draws,
                                  torch.from_numpy(want.copy()),
                                  _jax_draws(key, WHOLE_STEPS,
                                             mixture is not None))
            assert res["allowed"], (k, seed, res)
            assert res["z_differ"] > 0
            assert t.key.tolist() == _raw(j.key).tolist()
            if res["first"] is None:
                tracked += 1
                assert t.trans_count == j.trans_count
                assert abs(t.cur - j.cur) <= res["gap_tol"]
            else:
                parted.append((k, seed, res["first"]))
    assert len(parted) <= 2, parted
    assert tracked + len(parted) == len(TARGETS)


def test_divergence_rule_allows_a_bin_edge():
    """Two walks whose step 400 proposals straddle a bin edge, one float32
    apart in z, both taken (uniform 0): they part there, and the rule
    allows it."""
    values, xmin, bw, pstd, mixture = TARGETS[2]
    _, t = _pair(values, xmin, bw, pstd, mixture, 0)
    walk = t.walk_target()
    x0 = t.cur
    _key, draws = tsamp.draw_steps(t.key, 1000, False, torch.device("cpu"))
    chain, _ = sk.metropolis_walk_plain(draws.z, draws.uniforms, None, walk,
                                        x0)
    nb = walk.bins.numel()
    f32 = np.float32
    i = 400
    while sk.bin_index_scalar(chain[i - 1], walk.xmin, walk.bin_width,
                              nb) >= nb - 2:
        i += 1
    prev = f32(chain[i - 1])
    k = sk.bin_index_scalar(prev, walk.xmin, walk.bin_width, nb)

    def bin_of(zv):
        return sk.bin_index_scalar(sk.fma32(walk.pstd, zv, prev), walk.xmin,
                                   walk.bin_width, nb)

    # bisect z's (positive, ordered) bits between a proposal in bin k and
    # one just past its upper edge
    lo = 0
    hi = int(f32((f32(walk.xmin) + f32(k + 1.001) * f32(walk.bin_width)
                  - prev) / f32(walk.pstd)).view(np.int32))
    assert bin_of(np.int32(hi).view(f32)) == k + 1
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if bin_of(np.int32(mid).view(f32)) <= k:
            lo = mid
        else:
            hi = mid
    z, up = np.int32(lo).view(f32), np.int32(hi).view(f32)
    assert (bin_of(z), bin_of(up)) == (k, k + 1)
    za, zb = draws.z.clone(), draws.z.clone()
    za[i], zb[i] = float(z), float(up)
    u = draws.uniforms.clone()
    u[i] = 0.0
    da, db = tsamp.StepDraws(za, u, None), tsamp.StepDraws(zb, u, None)
    ca, _ = sk.metropolis_walk_plain(za, u, None, walk, x0)
    cb, _ = sk.metropolis_walk_plain(zb, u, None, walk, x0)
    res = walk_divergence(walk, x0, ca, da, cb, db)
    assert res["first"] == i and res["allowed"], res
    assert "bins" in res["why"]


def test_divergence_rule_rejects_a_fault():
    values, xmin, bw, pstd, mixture = TARGETS[2]
    _, t = _pair(values, xmin, bw, pstd, mixture, 0)
    x0 = t.cur
    chain, draws = t.walk(3000)
    other = chain.clone()
    other[1000:] += np.float32(0.35)
    res = walk_divergence(t.walk_target(), x0, chain, draws, other, draws)
    assert not res["allowed"] and res["first"] == 1000
    res = walk_divergence(t.walk_target(), x0, chain, draws, chain, draws)
    assert res["allowed"] and res["first"] is None and res["max_gap"] == 0
    moved = tsamp.StepDraws(draws.z, torch.roll(draws.uniforms, 1), None)
    assert not walk_divergence(t.walk_target(), x0, chain, draws, chain,
                               moved)["allowed"]


def test_sampler_state_and_behaviour(monkeypatch):
    """The reference's checks on the port, and its state across calls."""
    m = tsamp.MetropolisSampler(proposal_std=2.0, xmin=0.0, bin_width=1.0,
                                values=BIMODAL, seed=0, device="cpu")
    chain = m.sample(4000, skip=2)
    assert m.trans_count > 0 and chain.dtype == np.float32
    assert np.mean(chain < 3.5) > np.mean((chain > 3.5) & (chain < 7.5))
    m = tsamp.MetropolisSampler(proposal_std=0.5, xmin=0.0, bin_width=1.0,
                                values=[1, 2, 3, 2, 1], seed=1, device="cpu")
    m.set_mixture_proposal(global_std=3.0, threshold=0.7)
    chain = m.sample(500)
    assert chain.shape == (500,)
    assert np.all(chain >= 0.0) and np.all(chain <= 4.0)
    j = jsamp.MetropolisSampler(proposal_std=0.5, xmin=0.0, bin_width=1.0,
                                values=[1, 2, 3, 2, 1], seed=1)
    j.set_mixture_proposal(global_std=3.0, threshold=0.7)
    j.sample(500)
    assert m.key.tolist() == _raw(j.key).tolist()
    assert m.sample(0).shape == (0,)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsamp.MetropolisSampler(1.0, 0.0, 1.0, [1, 2])


def test_diagnostics_on_the_ports_chain():
    m = tsamp.MetropolisSampler(proposal_std=2.0, xmin=0.0, bin_width=1.0,
                                values=BIMODAL, seed=2, device="cpu")
    chain = m.sample(5000, skip=2).astype(np.float64)
    zs = tmcmc.GewekeConvergence(burn_in_sizes=[0, 500]).calculate_zscores(
        chain)
    assert zs == jmcmc.GewekeConvergence(
        burn_in_sizes=[0, 500]).calculate_zscores(chain)
    assert tmcmc.RafteryLewisConvergence().find_sample_size(chain) == \
        jmcmc.RafteryLewisConvergence().find_sample_size(chain)
