"""The port's copies of XLA's CPU float32 arithmetic, for k-means and MI.

The reference's k-means is a jitted XLA program. Its float32 distances
feed an argmin and its inertia a stop rule, so the port follows the
order and rounding XLA's CPU build takes there, as `ops/reduce.py`
follows NB's moment order and `ops/prng.py` copies threefry. Its mutual
information ends in a float32 sum of a table's terms whose `%.6f` print
can fall on either side of a rounding edge:

- `inner_dot`: XLA's CPU dot of [n, d] and [k, d] over their contiguous
  last axis, x @ y.T (its runtime's Eigen contraction): below 4 columns a
  fused multiply-add chain; from 4, four lanes of fused multiply-adds
  over the columns' packets of four, added (l0 + l1) + (l2 + l3), then the
  last d % 4 columns' products added to that as p, p0 + p1, or
  (p0 + p1) + p2;
- `fma`: a float32 fused multiply-add as a float64 product (exact) plus
  the addend, rounded to float32;
- `tree_sum`: a sum over rows by halves (zero rows pad to a power of two).
  XLA sums a long reduction in eight running lanes, one chain of n/8
  steps each, which has no parallel form; this order is not XLA's, so
  k-means' inertia sits within the tolerance the tests state;
- `sum_last2`: XLA's CPU reduce of a float32 [..., R, C] table over its
  last two axes, as `jnp.sum(t, axis=(-2, -1))` compiles it, and
  `sum_axis`, its reduce over one axis (below);
- `log`: XLA's CPU float32 `log`, its Cephes polynomial with the
  multiply-adds the backend fuses, denormal inputs read as zero.

All of it is elementwise float32 and float64 arithmetic, correctly
rounded on the CPU and the card, so a card run and its CPU twin give the
same bits, and no matrix product whose precision a setting could change.

The orders of `sum_last2` and `log` were read off the kernels one XLA
build compiled for one host (`READ_ON`): LLVM's loop vectorizer picks
its lanes by the target's vector width and cost model, and the backend
fuses multiply-adds where the target has FMA. Another jaxlib, or a host
of another vector ISA (AVX2 against AVX-512), may compile the
reference's reduce and log otherwise; the bit tests then name the jaxlib
and the CPU flags they ran on beside these.
"""

from __future__ import annotations

import numpy as np
import torch


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding: the float64 product of two
    float32 values is exact, and the float64 sum rounds to float32 as a
    fused multiply-add does but on a double-rounding tie (about one in
    2^29)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def inner_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x [n, d] @ y [k, d].T -> [n, k] in the order of XLA's CPU dot over
    a contiguous depth (module docstring)."""
    n, d = x.shape

    def prod(j):
        return x[:, j, None] * y[None, :, j]

    if d < 4:
        acc = torch.zeros((n, y.shape[0]), dtype=torch.float32,
                          device=x.device)
        for j in range(d):
            acc = fma(x[:, j, None], y[None, :, j], acc)
        return acc
    lanes = [torch.zeros((n, y.shape[0]), dtype=torch.float32,
                         device=x.device) for _ in range(4)]
    for j in range(d // 4 * 4):
        lanes[j % 4] = fma(x[:, j, None], y[None, :, j], lanes[j % 4])
    out = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
    tail = list(range(d // 4 * 4, d))
    if len(tail) == 1:
        out = out + prod(tail[0])
    elif len(tail) >= 2:
        t = prod(tail[0]) + prod(tail[1])
        if len(tail) == 3:
            t = t + prod(tail[2])
        out = out + t
    return out


def tree_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the first axis of t [n, ...] by halves: rows i and
    i + h added, h halving from the power of two at or above n (zero
    rows pad; x + 0 is x). log2(n) elementwise steps."""
    n = t.shape[0]
    if n == 0:
        return torch.zeros(t.shape[1:], dtype=t.dtype, device=t.device)
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        t = torch.cat([t, t.new_zeros((p - n,) + t.shape[1:])])
    while t.shape[0] > 1:
        h = t.shape[0] // 2
        t = t[:h] + t[h:]
    return t[0]


#: where `_loop_lanes` and `log` were read: the jaxlib build and the
#: host's vector ISA that compiled the reference's reduce and log
READ_ON = {"jaxlib": "0.9.0",
           "cpu": "x86_64 Intel Xeon with fma, avx2, avx512f, avx512dq, "
                  "avx512bw, avx512vl"}

#: XLA's CPU pipeline splits a reduced axis longer than this into windows
#: (its tree reduction rewriter): a reduce-window, then a reduce of the
#: window sums
_WINDOW = 32


def _loop_lanes(rows: int, cols: int) -> int:
    """The lanes LLVM's loop vectorizer gives XLA's reduce loop nest over
    an [rows, cols] block (rows outer, the cols loop unrolled into it),
    1 for a serial loop. Read off the compiled kernels at every block of
    at most 32 x 32: one column or more than eight stay serial; below 16
    rows only a trip count of 2, 4 or 8 vectorizes (a tiny loop takes no
    scalar tail); from 16 rows the cost model picks 8 or 4 lanes by the
    rows' remainder mod 8 and the column count."""
    if cols == 1 or cols > 8:
        return 1
    if rows < 16:
        return rows if rows in (2, 4, 8) else 1
    if rows % 8 < 4:
        return 8 if cols <= 6 else 4
    return 8 if cols == 2 and rows >= 28 else 4


def _serial(init: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """init [N] + cells [N, M] added one by one from the left in float32:
    a cumulative sum (numpy accumulates in order, rounding each step)."""
    return np.cumsum(np.concatenate([init[:, None], cells], axis=1),
                     axis=1, dtype=np.float32)[:, -1]


def _loop_sum(t: np.ndarray, lanes: int) -> np.ndarray:
    """Sum a float32 block t [N, R, C] over its last two axes as the
    reduce loop with `lanes` lanes: lane l adds rows l, l + lanes, ...
    each row's cells left to right (lane 0 starts at the init 0.0, the
    others at -0.0); the lanes are then added by halves, (l0 + l4) +
    (l2 + l6) and (l1 + l5) + (l3 + l7) at eight, and the rows past the
    last full group of lanes are added to that one by one."""
    n, rows, cols = t.shape
    full = rows // lanes * lanes if lanes > 1 else 0
    zero = np.zeros(n, np.float32)
    if full == 0:
        return _serial(zero, t.reshape(n, -1))
    # [N, lanes, groups * C]: a lane's rows' cells in order
    grouped = t[:, :full].reshape(n, full // lanes, lanes, cols)
    seq = grouped.transpose(0, 2, 1, 3).reshape(n, lanes, -1)
    init = np.full((n, lanes), -0.0, np.float32)
    init[:, 0] = 0.0
    acc = np.cumsum(np.concatenate([init[:, :, None], seq], axis=2),
                    axis=2, dtype=np.float32)[:, :, -1]
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, :h] + acc[:, h:]
    return _serial(acc[:, 0], t[:, full:].reshape(n, -1))


def _reduce_2d(t: np.ndarray) -> np.ndarray:
    n, rows, cols = t.shape
    if rows <= _WINDOW and cols <= _WINDOW:
        return _loop_sum(t, _loop_lanes(rows, cols))
    wr = _WINDOW if rows > _WINDOW else rows
    wc = _WINDOW if cols > _WINDOW else cols
    nr, nc = -(-rows // wr), -(-cols // wc)
    lo_r, lo_c = (nr * wr - rows) // 2, (nc * wc - cols) // 2
    padded = nr * wr != rows or nc * wc != cols
    lanes = 1 if padded else _loop_lanes(wr, wc)
    out = np.empty((n, nr, nc), np.float32)
    for i in range(nr):
        r0, r1 = max(0, i * wr - lo_r), min(rows, (i + 1) * wr - lo_r)
        for j in range(nc):
            c0, c1 = max(0, j * wc - lo_c), min(cols, (j + 1) * wc - lo_c)
            out[:, i, j] = _loop_sum(t[:, r0:r1, c0:c1], lanes)
    return _reduce_2d(out)


def sum_last2(t: np.ndarray) -> np.ndarray:
    """float32 t [..., R, C] -> [...], summed over the last two axes in
    the order of XLA's CPU reduce (`jnp.sum(t, axis=(-2, -1))`, each
    leading index on its own):

    - an axis longer than 32 is cut into windows of 32, the padding
      split around it (lower half first) and skipped; a padded window's
      cells are added one by one, row-major; the window sums are then
      reduced by the same rules;
    - a block of at most 32 x 32 is the vectorized loop of `_loop_sum`
      with `_loop_lanes` lanes.

    On the host, in numpy (float32 cumulative sums keep each lane's order
    and rounding), as `sum_axis`.
    Checked against the compiled reduce on random tables at every shape
    up to 32 x 32 and at windowed shapes up to 1100 rows and 100 columns
    (`tests/test_torch_explore.py`)."""
    t = np.asarray(t, np.float32)
    flat = t.reshape((-1,) + t.shape[-2:])
    return _reduce_2d(flat).reshape(t.shape[:-2])


def sum_axis(t: np.ndarray, axis: int) -> np.ndarray:
    """float32 t summed over one axis (keeping it, length 1) in the order
    of XLA's CPU reduce (`jnp.sum(t, axis=axis, keepdims=True)`): each
    output adds its cells one by one from 0.0; an axis longer than 32 is
    cut into windows of 32 as in `sum_last2`, each window summed so, the
    window sums then reduced by the same rule. Checked against the
    compiled reduce over both axes at every length up to 80 and at 96 to
    1,100 (`tests/test_torch_explore.py`)."""
    x = np.moveaxis(np.asarray(t, np.float32), axis, -1)
    return np.moveaxis(np.expand_dims(_reduce_1d(x), -1), -1, axis)


def _reduce_1d(x: np.ndarray) -> np.ndarray:
    n = x.shape[-1]
    if n == 0:
        return np.zeros(x.shape[:-1], np.float32)
    lead = x.reshape(-1, n)
    if n <= _WINDOW:
        return _serial(np.zeros(lead.shape[0], np.float32),
                       lead).reshape(x.shape[:-1])
    nw = -(-n // _WINDOW)
    lo = (nw * _WINDOW - n) // 2
    sums = np.stack([
        _serial(np.zeros(lead.shape[0], np.float32),
                lead[:, max(0, i * _WINDOW - lo):
                     min(n, (i + 1) * _WINDOW - lo)])
        for i in range(nw)], axis=-1)
    return _reduce_1d(sums).reshape(x.shape[:-1])


def _c32(bits: int) -> np.float32:
    """A float32 constant from the float64 bits LLVM prints it as."""
    return np.array([bits], np.uint64).view(np.float64).astype(np.float32)[0]


#: the polynomial of XLA's CPU log (Cephes' logf), as its compiled kernel
#: holds them: three interleaved Horner chains and the ln 2 split
_LOG_P = [_c32(b) for b in (
    0x3FB2043760000000, 0xBFBD7A3700000000, 0xBFBFCBA9E0000000,
    0x3FC23D37E0000000, 0x3FC999D580000000, 0xBFCFFFFF80000000,
    0x3FBDE4A340000000, 0xBFC555CA00000000, 0x3FD5555540000000)]
_LOG_SQRTHF = _c32(0x3FE6A09E60000000)
_LOG_Q1 = _c32(0xBF2BD01060000000)
_LOG_Q2 = _c32(0x3FE6300000000000)
_FLT_MIN = _c32(0x3810000000000000)


def log(t: np.ndarray) -> np.ndarray:
    """float32 log(t) as XLA's CPU build computes `jnp.log`: the mantissa
    m in [0.5, 1) and exponent e of t (t below the smallest normal read
    as 0, as the CPU's denormals-are-zero mode reads it); x = m - 1, plus
    m when m < sqrt(1/2) (and e less one); y = three Horner chains in x,
    joined by x^3; then (x - x^2 / 2) + (y + e * -2.12194440e-4) +
    e * 0.693359375. Every multiply that feeds one add is fused into it
    (the backend contracts them; `ops/prng.fma32`), each of the others
    rounds alone. Equal to the compiled kernel on 1,108,000 values
    (`tests/test_torch_explore.py`)."""
    from avenir_tpu_torch.ops.prng import fma32

    f32 = torch.float32
    x = torch.from_numpy(np.array(t, np.float32, ndmin=1))
    x = torch.where(x.abs() < float(_FLT_MIN), 0.0, x)
    # max(x, FLT_MIN) > 0 (or NaN, which the result masks): no sign bit
    bits = torch.clamp(x, min=float(_FLT_MIN)).view(torch.int32)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(f32)
    e = 1.0 + ((bits >> 23) - 127).to(f32)
    low = m < float(_LOG_SQRTHF)
    e = e - low.to(f32)
    xr = (m - 1.0) + torch.where(low, m, 0.0)
    xsq = xr * xr
    xcu = xsq * xr

    def c(v):
        return torch.tensor(v, dtype=f32)

    p = [c(v) for v in _LOG_P]
    y = fma32(fma32(xr, p[0], p[1]), xr, p[6])
    y1 = fma32(fma32(xr, p[2], p[3]), xr, p[7])
    y2 = fma32(fma32(xr, p[4], p[5]), xr, p[8])
    y = fma32(fma32(y, xcu, y1), xcu, y2)
    y = fma32(y, xcu, float(_LOG_Q1) * e)
    out = fma32(c(_LOG_Q2), e, fma32(c(-0.5), xsq, xr) + y)
    out = torch.where(x > 0, out, float("nan"))
    out = torch.where(x == 0, float("-inf"), out)
    out = torch.where(x == float("inf"), float("inf"), out)
    return out.numpy().reshape(np.shape(t))
