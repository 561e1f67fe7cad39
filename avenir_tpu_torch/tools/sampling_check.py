"""Where two routes' Metropolis chains may rightly part.

Two routes draw the walk's uniforms bit for bit (threefry's bits, exact
float operations) but their proposal draws z only within the log1p's
rounding (`ops/prng.normal`: up to 3 ULP apart on the CPU against JAX).
So two chains from one seed hold the same values up to a few ULP, take
the same proposals and stay in the same bins, until a step where the two
proposals fall on either side of a bin edge (or of the clamp): then the
targets' bin values differ, an accept may flip, and the chains part.

`walk_divergence` walks both chains over their own draws and finds the
first step where they part: a state in another bin, or values further
apart than `gap_tol`. That first divergence is allowed only where the
two proposals of that step lie within `gap_tol` of each other and in
different bins, or one of them was clamped; any other is a fault. Before
it, each chain must be its own walk (every state the previous one or
that step's proposal) and the two must share their uniforms. After it,
nothing is compared. A check of the tests and of `chip_smoke.py`, not
part of the sampling path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from avenir_tpu_torch.ops import prng
from avenir_tpu_torch.ops.sampling_kernels import WalkTarget, bin_index

#: the default gap two tracking chains' values may show, in bin widths
GAP_BINS = 2.0 ** -12


def _proposals(walk: WalkTarget, x0: float, chain: torch.Tensor, z, mix):
    """(previous states, raw proposals, clamped proposals) of a chain."""
    f32 = torch.float32
    prev = torch.cat([torch.tensor([np.float32(x0)], dtype=f32), chain[:-1]])
    std = torch.full_like(z, walk.pstd)
    if mix is not None:
        std = torch.where(mix < np.float32(walk.thr), std,
                          torch.full_like(z, walk.gstd))
    raw = prng.fma32(std, z, prev)
    return prev, raw, raw.clamp(walk.xmin, walk.xmax)


def walk_divergence(walk: WalkTarget, x0: float, chain_a: torch.Tensor,
                    draws_a, chain_b: torch.Tensor, draws_b,
                    gap_tol: Optional[float] = None) -> dict:
    """Compare chain_a (walked over draws_a) with chain_b (over draws_b),
    both from x0 under `walk`: draws are `utils.sampling.StepDraws`, on
    any device. Returns {"steps", "first" (the first step where they part,
    None if they never do), "allowed", "why", "max_gap" (the largest
    value gap before it), "gap_tol", "z_differ" (steps whose z differ)}."""
    cpu = lambda t: None if t is None else t.detach().cpu()  # noqa: E731
    walk = WalkTarget(cpu(walk.bins), walk.xmin, walk.xmax, walk.bin_width,
                      walk.pstd, walk.gstd, walk.thr)
    ca, cb = cpu(chain_a), cpu(chain_b)
    za, zb = cpu(draws_a.z), cpu(draws_b.z)
    ua, ub = cpu(draws_a.uniforms), cpu(draws_b.uniforms)
    ma, mb = cpu(draws_a.mix), cpu(draws_b.mix)
    tol = float(gap_tol if gap_tol is not None
                else GAP_BINS * abs(walk.bin_width))
    steps = len(ca)
    out = {"steps": steps, "first": None, "allowed": True, "why": "",
           "max_gap": 0.0, "gap_tol": tol,
           "z_differ": int((za != zb).sum())}
    if len(cb) != steps or len(za) != steps or len(zb) != steps:
        return {**out, "allowed": False, "why": "lengths differ"}
    if not torch.equal(ua, ub) or (ma is None) != (mb is None) or (
            ma is not None and not torch.equal(ma, mb)):
        return {**out, "allowed": False, "why": "the uniforms differ"}
    nb = walk.bins.numel()
    pa, ra, na = _proposals(walk, x0, ca, za, ma)
    pb, rb, nbp = _proposals(walk, x0, cb, zb, mb)
    own_a = (ca == pa) | (ca == na)
    own_b = (cb == pb) | (cb == nbp)
    sa = bin_index(ca, walk.xmin, walk.bin_width, nb)
    sb = bin_index(cb, walk.xmin, walk.bin_width, nb)
    gap = (ca.double() - cb.double()).abs()
    parted = torch.nonzero((sa != sb) | (gap > tol)).flatten()
    first = int(parted[0]) if len(parted) else steps
    if first:
        out["max_gap"] = float(gap[:first].max())
    bad = torch.nonzero(~(own_a & own_b)[:first]).flatten()
    if len(bad):
        return {**out, "allowed": False,
                "why": f"step {int(bad[0])} is no step of its walk"}
    if first == steps:
        return out
    out["first"] = first
    pba = int(bin_index(na[first:first + 1], walk.xmin, walk.bin_width, nb))
    pbb = int(bin_index(nbp[first:first + 1], walk.xmin, walk.bin_width, nb))
    near = abs(float(ra[first]) - float(rb[first])) <= tol
    clamped = bool((ra[first] != na[first]) or (rb[first] != nbp[first]))
    if near and (pba != pbb or clamped):
        out["why"] = ("the proposals fall in bins %d and %d" % (pba, pbb)
                      if pba != pbb else "a proposal was clamped")
    else:
        out["allowed"] = False
        out["why"] = (f"step {first}: proposals {float(ra[first])!r} and "
                      f"{float(rb[first])!r} (bins {pba}, {pbb}) part with "
                      "no bin edge or clamp between them")
    return out
