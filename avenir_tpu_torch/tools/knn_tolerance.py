"""How the KNN kernels' results are held against their plain versions.

Shared by `chip_smoke.py` and `tools/knn_ab.py`: a distance is within
rtol/atol of the reference or, with a floor, within that floor in the
squared sum it came from; an index may differ from the reference only
where the row it names is as near (a tie); a vote may differ by more than
a floored score step only where the k-th and (k+1)-th neighbours tie.
"""

from __future__ import annotations

import torch

from avenir_tpu_torch.ops import knn_kernels as kk

#: the packed kernel's quantum: 12 masked mantissa bits, 2^-11 relative
PACKED_QUANTUM = 2.0 ** -11


def within(got, ref, d, rtol, atol, floor=0.0):
    """Elementwise |got - ref| <= atol + rtol |ref|; with a floor, a
    distance may instead lie within `floor` of ref in the squared sum it
    came from (d * dist^2): near zero the square root turns one fp32 ulp
    of the dot form's norms into a large share of the distance."""
    ok = (got - ref).abs() <= atol + rtol * ref.abs()
    if floor:
        ok |= ((got * got - ref * ref) * d).abs() <= floor
    return ok


def cancellation_floor(q, t) -> float:
    """A few fp32 ulps (2^-20) of the largest |q|^2 + |t|^2: the error of
    the dot form |q|^2 + |t|^2 - 2 q.t however small the result."""
    return 2.0 ** -20 * ((q * q).sum(1).max() + (t * t).sum(1).max()).item()


def recall(gi, pi) -> float:
    """Share of the reference's neighbours each query's list holds."""
    hits = (gi[:, :, None] == pi[:, None, :]).any(2).float()
    return hits.mean().item()


def tied(q, t, gi, pd, mism, metric, rtol, atol, bf16=False,
         floor=0.0) -> bool:
    """Where the kernel's index differs from the plain one, the row the
    kernel chose must be as near as the plain one's (a tie). With bf16
    the distance is the bfloat16 cross term's, taken in float64, and
    `floor` is within's."""
    rows, cols = torch.nonzero(mism, as_tuple=True)
    if rows.numel() == 0:
        return True
    a, b = q[rows], t[gi[rows, cols].long()]
    d = q.shape[1]
    if metric == "euclidean" and bf16:
        ar, br = (x.to(torch.bfloat16).double() for x in (a, b))
        sq = ((a.double() ** 2).sum(1) + (b.double() ** 2).sum(1)
              - 2.0 * (ar * br).sum(1))
        true = torch.sqrt(torch.clamp(sq, min=0.0) / d)
    elif metric == "euclidean":
        true = torch.sqrt(((a.double() - b.double()) ** 2).sum(1) / d)
    else:
        # the kernels' own fp32 sum, features in order from 0.0
        acc = torch.zeros(rows.numel(), device=q.device)
        for f in range(d):
            acc = acc + (a[:, f] - b[:, f]).abs()
        true = (acc / d).double()
    ref = pd[rows, cols].double()
    return bool(within(true, ref, d, rtol, atol, floor).all())


def boundary_tied(q, t, rows, k, metric, dtype, rtol, floor,
                  n_valid=None) -> bool:
    """A vote may differ by a whole neighbour's score only where the k-th
    and (k+1)-th nearest rows are tied, so the two sides may keep either:
    checked on the plain top-(k+1) of those queries."""
    if rows.numel() == 0:
        return True
    dist, _ = kk.knn_topk_plain(q[rows], t, k + 1, metric, n_valid,
                                compute_dtype=dtype)
    return bool(within(dist[:, k], dist[:, k - 1], q.shape[1], rtol, 1e-5,
                       floor).all())


def bf16_agrees(mode, q, t, k, old, new, n_valid=None) -> str:
    """Why two euclidean bfloat16 results of `mode` disagree ("" if they
    agree) by the tensor-core form's tolerance: [key, index] lists (or
    [scores] for "labels") from two kernels on q and t. Distances within
    rtol 1e-4 plus the mode's quantum, atol 1e-5, or the cancellation
    floor; indices apart only between ties (lanes: recall >= 0.99); votes
    apart by more than 2.0 only at a tied k-th neighbour, arg-max
    agreement >= 0.99."""
    d, floor = q.shape[1], cancellation_floor(q, t)
    if mode == "labels":
        got, ref = new[0], old[0]
        agree = (got.argmax(1) == ref.argmax(1)).float().mean().item()
        swapped = torch.nonzero(((got - ref).abs() > 2.0).any(1)).flatten()
        if agree < 0.99:
            return f"argmax agreement {agree:.5f}"
        if not boundary_tied(q, t, swapped, k, "euclidean", "bfloat16",
                             1e-4, floor, n_valid):
            return f"{swapped.numel()} votes past 2.0 without a tie"
        return ""
    tn = t if n_valid is None else t[:n_valid]
    bits, mask, empty = kk._key_spec(mode, t)
    quantum = {"exact": 0.0, "packed": PACKED_QUANTUM,
               "lanes": 2.0 ** -(23 - bits)}[mode]
    gd, gi = kk._finish(new[0], new[1], "euclidean", d, mask, empty)
    pd, pi = kk._finish(old[0], old[1], "euclidean", d, mask, empty)
    rtol = 1e-4 + quantum
    if not bool(within(gd, pd, d, rtol, 1e-5, floor).all()):
        err = (gd - pd).abs().max().item()
        return f"distances apart by {err:.3g} past rtol {rtol:.3g}"
    if mode == "lanes":
        r = recall(gi, pi)
        return "" if r >= 0.99 else f"recall {r:.5f}"
    if not tied(q, tn, gi, pd, gi != pi, "euclidean", rtol, 1e-5, True,
                floor):
        return "an index apart without a tie"
    return ""


def bf16_operand_floor(q, t) -> float:
    """How far bfloat16 operands can move a squared sum from its float32
    value: each operand rounds by at most 2^-9 relative, so
    |q.t - bf16(q).bf16(t)| <= (2^-8 + 2^-18) sum_i |q_i t_i|
    <= (2^-8 + 2^-18) |q| |t|, twice that in |q|^2 + |t|^2 - 2 q.t; taken
    at the largest norms, with room for the float32 sums (2^-6)."""
    return 2.0 ** -6 * (q.norm(dim=1).max() * t.norm(dim=1).max()).item()


def lanes_agree(q, t, got, ref, pack_bits, fp32_ref=False) -> str:
    """Why a euclidean bfloat16 lane top-k `got`, finished (distances,
    indices into t), disagrees with `ref` ("" if they agree): bf16_agrees'
    lanes rule on finished lists (distances within rtol 1e-4 plus the lane
    quantum 2^-(23 - pack_bits), atol 1e-5, or the cancellation floor;
    recall >= 0.99), and every index apart from ref's a tie under the
    bfloat16 cross term. Against a float32 reference (fp32_ref) the floor
    also holds the bfloat16 operands' rounding (bf16_operand_floor)."""
    (gd, gi), (pd, pi) = got, ref
    d = q.shape[1]
    floor = cancellation_floor(q, t)
    if fp32_ref:
        floor += bf16_operand_floor(q, t)
    rtol = 1e-4 + 2.0 ** -(23 - pack_bits)
    if not bool(within(gd, pd, d, rtol, 1e-5, floor).all()):
        err = (gd - pd).abs().max().item()
        return f"distances apart by {err:.3g} past rtol {rtol:.3g}"
    r = recall(gi, pi)
    if r < 0.99:
        return f"recall {r:.5f}"
    if not tied(q, t, gi, pd, gi != pi, "euclidean", rtol, 1e-5, True,
                floor):
        return "an index apart without a tie"
    return ""
