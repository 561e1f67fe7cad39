"""The port's matmul-ceiling kernel on the CPU: its plain version against the
TPU kernel `kern` of bench.py, and the wrapper's checks.

`kern` is a closure inside `bench_knn_matmul_ceiling`, which only times it,
so its body is copied here verbatim (bench.py:797-807) and run through
`pl.pallas_call(..., interpret=True)` at nq=256, nt=8192, D=128 with
128 x 4096 blocks. Tolerance, for this test and `chip_smoke.py` alike: each
row within 2^-16 sum_j |q̂_i . t̂_j| of the other (q̂, t̂ the bf16-rounded
operands), since both sum the same exact fp32 products in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from avenir_tpu_torch.ops import matmul_ceiling as mc

TOL = 2.0 ** -16


def _data(nq, nt, d, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(nq, d)).astype(np.float32),
            rng.normal(size=(nt, d)).astype(np.float32))


def _pallas_ceiling(q, t, bq, bt):
    dim = q.shape[1]

    # bench.py:797-807, verbatim
    def kern(q_ref, t_ref, o_ref):
        tb = pl.program_id(1)

        @pl.when(tb == 0)
        def _():
            o_ref[...] = jnp.zeros_like(o_ref)

        dot = jax.lax.dot_general(
            q_ref[...].astype(jnp.bfloat16), t_ref[...].astype(jnp.bfloat16),
            (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32)
        o_ref[...] += jnp.sum(dot, axis=1, keepdims=True)

    # bench.py:812-817, with interpret=True
    return np.asarray(pl.pallas_call(
        kern, grid=(q.shape[0] // bq, t.shape[0] // bt),
        in_specs=[pl.BlockSpec((bq, dim), lambda i, j: (i, 0)),
                  pl.BlockSpec((bt, dim), lambda i, j: (j, 0))],
        out_specs=pl.BlockSpec((bq, 1), lambda i, j: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((q.shape[0], 1), jnp.float32),
        interpret=True,
    )(jnp.asarray(q), jnp.asarray(t)))


def test_plain_matches_bench_kern_in_interpret_mode():
    q, t = _data(256, 8192, 128)
    ref = _pallas_ceiling(q, t, 128, 4096)
    qt, tt = torch.from_numpy(q), torch.from_numpy(t)
    got = mc.matmul_ceiling(qt, tt).numpy()
    scale = mc.row_abs_sums_plain(qt, tt).numpy()
    assert got.shape == ref.shape == (256, 1)
    assert np.all(np.abs(got - ref) <= TOL * scale)
    # the rounding matters: the unrounded fp32 product is further away
    exact = (q.astype(np.float64) @ t.astype(np.float64).T).sum(1)[:, None]
    assert np.abs(exact - ref).max() > np.abs(got - ref).max()


@pytest.mark.parametrize("nq,nt,d", [(128, 128, 16), (256, 1024, 64),
                                     (128, 4096 + 128, 128)])
def test_plain_against_float64_oracle(nq, nt, d):
    """The bf16-rounded operands' products summed in float64."""
    q, t = _data(nq, nt, d, seed=nq + nt + d)
    qt, tt = torch.from_numpy(q), torch.from_numpy(t)
    qb = qt.to(torch.bfloat16).double().numpy()
    tb = tt.to(torch.bfloat16).double().numpy()
    oracle = (qb @ tb.T).sum(1)[:, None]
    got = mc.matmul_ceiling_plain(qt, tt).numpy()
    scale = np.abs(qb @ tb.T).sum(1)[:, None]
    assert np.all(np.abs(got - oracle) <= TOL * scale)
    np.testing.assert_allclose(mc.row_abs_sums_plain(qt, tt).numpy(), scale,
                               rtol=1e-5)


@pytest.mark.parametrize("case", ["dtype", "rank", "rows", "train_rows",
                                  "features", "too_wide", "mismatch",
                                  "contiguous", "device"])
def test_wrapper_rejects(case):
    q, t = (torch.from_numpy(x) for x in _data(128, 256, 32))
    bad = {
        "dtype": (q.double(), t.double()),
        "rank": (q[None], t),
        "rows": (q[:100], t),
        "train_rows": (q, t[:200]),
        "features": (q[:, :24], t[:, :24]),
        "too_wide": (torch.zeros(128, mc.MAX_D + 16),
                     torch.zeros(128, mc.MAX_D + 16)),
        "mismatch": (q, t[:, :16]),
        "contiguous": (q.T.contiguous().T, t),
        "device": (q, t.to("meta")),
    }[case]
    with pytest.raises((TypeError, ValueError)):
        mc.matmul_ceiling(*bad)


def test_cpu_route_counts_no_launch():
    mc.reset_launches()
    q, t = (torch.from_numpy(x) for x in _data(128, 256, 32))
    mc.matmul_ceiling(q, t)
    assert mc.matmul_ceiling.launches == 0
    assert mc.KERNEL_WRAPPERS == (mc.matmul_ceiling,)


def test_library_registers_the_kernel_source():
    from avenir_tpu_torch.ops import _build

    src, entry, args = _build.LIBRARIES["matmul_ceiling"]
    assert (src, entry, len(args)) == ("matmul_ceiling.cu",
                                       "matmul_ceiling_launch", 9)
    text = (_build.CSRC / src).read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in text
    assert "bench.py:797" in text
