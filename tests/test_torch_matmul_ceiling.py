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
    """The C interface (q, t, nq, nt, d, qb, tb, blocks, max_segs, partial,
    out, stream) and the instructions of the wgmma design: wgmma fed by
    TMA through mbarriers, a producer with fewer registers, no mma.sync."""
    from avenir_tpu_torch.ops import _build

    src, entry, args = _build.LIBRARIES["matmul_ceiling"]
    assert (src, entry, len(args)) == ("matmul_ceiling.cu",
                                       "matmul_ceiling_launch", 12)
    assert _build.INFO["matmul_ceiling"] == {
        "matmul_ceiling_info": [_build._I, _build._P]}
    text = (_build.CSRC / src).read_text()
    assert '#include "wgmma_bf16.cuh"' in text
    assert "bench.py:797" in text
    text += (_build.CSRC / "wgmma_bf16.cuh").read_text()
    for instruction in ("wgmma.mma_async", "cp.async.bulk.tensor",
                        "mbarrier.try_wait", "setmaxnreg.dec",
                        "setmaxnreg.inc"):
        assert instruction in text
    assert "mma.sync" not in text


# ------------------------------------------------------------------ the plan
SHAPES = [(128, 128, 16, 132), (384, 1024, 48, 7), (640, 5120, 128, 132),
          (8192, 131072, 128, 132), (8192, 131072, 128, 1024),
          (256 * 3 + 128, 128 * 37, 96, 13), (128, 128 * 3, 64, 1)]


@pytest.mark.parametrize("nq,nt,d,sms", SHAPES)
def test_plan_covers_every_pair_exactly_once(nq, nt, d, sms):
    p = mc.plan(nq, nt, d, sms)
    assert p["q_tiles"] == -(-nq // mc.BM) and p["t_tiles"] == nt // mc.BN
    assert p["pairs"] == p["q_tiles"] * p["t_tiles"]
    assert p["blocks"] == min(sms, p["pairs"])
    seen = [(qt, tt) for _, _, qt, lo, hi in mc.segments(p)
            for tt in range(lo, hi)]
    assert len(seen) == len(set(seen)) == p["pairs"]
    assert set(seen) == {(qt, tt) for qt in range(p["q_tiles"])
                         for tt in range(p["t_tiles"])}
    # whole shares: no block has two pairs more than another
    sizes = [p1 - p0 for p0, p1 in p["ranges"]]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert max(seg for _, seg, *_ in mc.segments(p)) + 1 == p["max_segs"]


@pytest.mark.parametrize("nq,nt,d,sms", SHAPES)
def test_reduce_sums_a_query_tiles_segments_in_train_order(nq, nt, d, sms):
    """For each query tile the reduce walks the segments that hold it in
    block order; their train tiles follow each other from 0 to t_tiles,
    and each names its own slot of the partial buffer."""
    p = mc.plan(nq, nt, d, sms)
    where = {(b, seg): (qt, lo, hi) for b, seg, qt, lo, hi in mc.segments(p)}
    slots = set()
    for qt in range(p["q_tiles"]):
        order = mc.reduce_order(p, qt)
        assert [b for b, _ in order] == sorted(b for b, _ in order)
        edge = 0
        for b, seg in order:
            assert 0 <= seg < p["max_segs"]
            tile, lo, hi = where[(b, seg)]
            assert tile == qt and lo == edge and hi > lo
            edge = hi
            slots.add(b * p["max_segs"] + seg)
        assert edge == p["t_tiles"]
    assert max(slots) * mc.BM + mc.BM <= p["partial"]
    assert len(slots) == len(where)


@pytest.mark.parametrize("d", range(16, mc.MAX_D + 1, 16))
@pytest.mark.parametrize("nq", [8192, 384])
def test_plan_scratch_and_padded_widths(d, nq):
    """Every legal D pads to whole 64-feature chunks; an nq that is not a
    multiple of the 256-query tile takes one more, part-filled, tile."""
    p = mc.plan(nq, 131072, d, 132)
    dp = 64 if d <= 64 else 128
    assert p["dp"] == mc.padded_width(d) == dp
    assert p["qb"] == (nq, dp) and p["tb"] == (131072, dp)
    assert p["q_tiles"] == (32 if nq == 8192 else 2)
    assert p["partial"] == p["blocks"] * p["max_segs"] * mc.BM
    # 384 queries: 2048 pairs, and block 66 starts the second tile
    assert p["blocks"] == 132 and p["max_segs"] == (2 if nq == 8192 else 1)


def test_plan_of_the_bench_shape():
    """8192 x 131072: 32 x 1024 pairs, 248 or 249 a block on 132 SMs."""
    p = mc.plan(8192, 131072, 128, 132)
    assert (p["q_tiles"], p["t_tiles"], p["pairs"]) == (32, 1024, 32768)
    assert {p1 - p0 for p0, p1 in p["ranges"]} == {248, 249}


def _bf16_bits_rne(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 round to nearest even, by integer arithmetic on
    the bit patterns (finite inputs), back as float32."""
    bits = x.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def test_cast_plain_rounds_to_nearest_even_and_pads_with_zeros():
    """The cast pass's plain version: each value as _round_bf16 rounds
    it, ties to the even neighbour, and zeros from D to the padded
    width."""
    ulp = 2.0 ** -7                        # bf16 spacing in [1, 2)
    ties = np.array([1 + ulp / 2, 1 + 3 * ulp / 2, -(1 + ulp / 2),
                     2 + ulp, 1 + ulp / 2 + 2.0 ** -20, 3.0e-39, 0.0, -0.0],
                    dtype=np.float32)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(40, 48)).astype(np.float32)
    x[0, :ties.size] = ties
    xt = torch.from_numpy(x)
    got = mc.cast_plain(xt, 64)
    assert got.dtype == torch.bfloat16 and got.shape == (40, 64)
    assert torch.equal(got[:, 48:].float(), torch.zeros(40, 16))
    assert torch.equal(got[:, :48].float(), mc._round_bf16(xt))
    np.testing.assert_array_equal(got[:, :48].float().numpy(),
                                  _bf16_bits_rne(x))
    assert got[0, :4].float().tolist() == [1.0, 1 + 2 * ulp, -1.0, 2.0]
    assert got[0, 4].item() == 1 + ulp      # above the tie: up


@pytest.mark.parametrize("d", [16, 48, 80, 128])
def test_plain_on_zero_padded_operands_equals_unpadded(d):
    """The zero features of the padded copies add nothing: the plain
    ceiling on the cast pass's padded rows agrees with the unpadded one
    within the tolerance, and its scale is the same."""
    q, t = (torch.from_numpy(x) for x in _data(256, 1024, d, seed=d))
    dp = mc.padded_width(d)
    qp, tp = (mc.cast_plain(x, dp).float() for x in (q, t))
    assert torch.equal(qp[:, :d], mc._round_bf16(q))
    base = mc.matmul_ceiling_plain(q, t)
    padded = mc.matmul_ceiling_plain(qp, tp)
    scale = mc.row_abs_sums_plain(q, t)
    assert torch.all((padded - base).abs() <= TOL * scale)
    torch.testing.assert_close(mc.row_abs_sums_plain(qp, tp), scale,
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("nq,nt,d,sms", [(384, 1024, 48, 7),
                                         (640, 5120, 128, 13)])
def test_planned_partials_summed_in_reduce_order_match_plain(nq, nt, d, sms):
    """The kernel's decomposition in plain torch: each segment's fp32
    partial row sums over its train tiles, then the reduce's order; rows
    past nq in the last tile are never read."""
    q, t = (torch.from_numpy(x) for x in _data(nq, nt, d, seed=sms))
    p = mc.plan(nq, nt, d, sms)
    qb = mc.cast_plain(q, p["dp"]).float()
    tb = mc.cast_plain(t, p["dp"]).float()
    partial = torch.full((p["partial"],), float("nan"))
    for b, seg, qt, lo, hi in mc.segments(p):
        rows = qb[qt * mc.BM:(qt + 1) * mc.BM]
        cols = tb[lo * mc.BN:hi * mc.BN]
        start = (b * p["max_segs"] + seg) * mc.BM
        partial[start:start + rows.shape[0]] = (rows @ cols.T).sum(1)
    out = torch.zeros(nq)
    for i in range(nq):
        for b, seg in mc.reduce_order(p, i // mc.BM):
            out[i] += partial[(b * p["max_segs"] + seg) * mc.BM + i % mc.BM]
    scale = mc.row_abs_sums_plain(q, t)[:, 0]
    assert torch.all((out - mc.matmul_ceiling_plain(q, t)[:, 0]).abs()
                     <= TOL * scale)
