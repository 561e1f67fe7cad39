"""Same-call A/B of the KNN kernels against an earlier version of their sources.

    python -m avenir_tpu_torch.tools.knn_ab --parent DIR [--reps N]

DIR holds an earlier `knn_tile.cuh`, `knn_tile_mma.cuh`, `knn_topk.cu`,
`knn_classify.cu` and `knn_prepass.cu` (and the headers they include)
with this checkout's C interface, for example those of an earlier commit
written out with `git show` into a git-ignored directory.
They build with the same nvcc flags (`ops/_build.py`) into a build
directory of their own. Both versions' K=8 manhattan exact partial
instances are printed with their registers, local bytes, blocks per SM
and SASS instructions (`cuobjdump -sass`), and both versions' tensor-core
instances (every carry width and mode, D 6 and 128) with their
registers, local bytes and blocks per SM.

The inputs are `chip_smoke.py` phase 2's: for D in (6, 128), q [8192, D],
t [131072, D] and labels [131072] drawn from a device generator seeded
1234, in that order. For each D, metric, mode (exact, lanes, packed and
the fused vote, k=5, C=2, gaussian 30) and compute dtype (float32, and
bfloat16 for euclidean), both versions run on the same tensors, each on
the grid its own occupancy gives:

- float32 rows: both versions' CUDA-core partial and merge kernels after
  this checkout's pre-pass; their selection keys and indices (the vote:
  its scores) are compared bit for bit. This is the bar: the float32
  instances do not change.
- bfloat16 rows (euclidean): the earlier version's tensor-core form (its
  pre-pass with its bf16 operands, then its tensor-core partial and merge
  kernels) beside this checkout's. The two accumulate in another order,
  so they are compared by the tensor-core form's tolerance with the tie
  rule (`knn_tolerance.bf16_agrees`), not bit for bit.

For each D and dtype the two pre-passes run alone on q and t, their norms
and bf16 values compared bit for bit (an earlier pre-pass may write fp32
copies of D values where this one writes bf16 rows zero-padded to a
multiple of 16; `knn_prepass_rows16` tells them apart, and the values
are compared where both have them). Times are CUDA-event medians of
`--reps` calls, taken in turns (earlier, current, current, earlier) and
averaged per side; each row prints their ratio.

Merge rows: both versions' merge kernels alone (`knn_topk_merge_launch`,
`knn_classify_merge_launch`) on the same split lists, which one launch of
this checkout's partial kernel leaves: the job's (D=6 manhattan float32,
k=5: exact lists for the top-k merge, label lists for the vote), the
bench's (D=128 euclidean bfloat16 on the tensor-core form, k=5: lane
lists and label lists) and lists at k=16, 32 and 64 (D=6 manhattan
float32); the vote at C=2 under the kernels none and gaussian(30). Keys,
indices and scores are compared bit for bit. A merge launch takes a few
microseconds of the device and more of the host, so a merge row's time
is the device's: torch.profiler's mean kernel time (`profiled_ms`) over
`--reps` calls of MERGE_LAUNCHES back-to-back launches, in the same turns.

Prints the card's name and power limit, one line per row and one JSON
line; exits 1 if any float32 or merge row differs or any bfloat16 row
disagrees.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Callable, List, Optional

import torch

from avenir_tpu_torch.ops import _build
from avenir_tpu_torch.ops import knn_kernels as kk
from avenir_tpu_torch.tools.knn_tolerance import bf16_agrees

NQ, NT, K, C, SEED = 8192, 131072, 5, 2, 1234
#: back-to-back launches of a merge row's call
MERGE_LAUNCHES = 20
#: mangled-name part of the K=8 manhattan exact partial instance
K8_L1_EXACT = "partial_topk_kernelILi8ELi0ELi0E"


def sass_instructions(sass: str, kernel: str) -> int:
    """Instructions of the first function of `cuobjdump -sass` output
    whose mangled name contains `kernel` (0 if none does): the lines that
    start with an address comment, predicated or not."""
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        if kernel in part.split("\n", 1)[0]:
            return len(re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?[A-Z]", part))
    return 0


def library_sass(build: Path) -> str:
    """`cuobjdump -sass` of the knn_topk library built in `build`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(build / "libknn_topk.so")],
                          capture_output=True, text=True, timeout=300).stdout


def load_parent(parent: Path):
    """(knn_topk, knn_classify, knn_prepass) libraries built from
    `parent`'s sources, bound with this checkout's C interface."""
    names = ("knn_topk", "knn_classify", "knn_prepass")
    _build.build_all(csrc=parent, names=names)
    return tuple(_build.bind(ctypes.CDLL(str(_build.build_dir(parent) /
                                             f"lib{name}.so")), name)
                 for name in names)


def current_call(mode: str, q, t, labels, metric: str, bf16: bool,
                 libs=(None, None, None)) -> Callable[[], List[torch.Tensor]]:
    """A call of this checkout's kernels (the pre-pass where euclidean,
    then the partial and merge kernels in the form the wrapper routes to)
    giving [keys, indices] or [scores]. With `libs`, another build's
    (topk, classify, prepass) libraries with the same interface: for
    bfloat16 their own pre-pass makes the bf16 operands and norms their
    tensor-core form takes."""
    euclid = metric == "euclidean"
    earlier_bf16 = libs[0] is not None and euclid and bf16

    def run():
        kw = {}
        if earlier_bf16:
            qn, tn, qr, tr = prepass_call(q, t, True, libs[2])()
            kw = dict(mma=True, operands=(qr, tr, qn, tn))
        if mode == "labels":
            return [kk._classify_scores(q, t, labels, K, euclid, bf16, C,
                                        q.shape[1], "gaussian", 30.0, NT,
                                        libs[1], **kw)]
        return list(kk._topk_keys(mode, q, t, K, euclid, bf16, NT, libs[0],
                                  **kw))
    return run


def rows16(lib) -> bool:
    """Whether `lib`'s pre-pass writes bf16 rows of depth16(D) values
    (else fp32 copies of D values, as earlier ones did)."""
    return hasattr(lib, "knn_prepass_rows16") and lib.knn_prepass_rows16() == 1


def prepass_call(q, t, bf16: bool, lib) -> Callable[[], List[torch.Tensor]]:
    """A launch of `lib`'s pre-pass over q and t giving [qn, tn] and, with
    bf16, its bf16 operands in the layout it writes (rows16)."""
    (nq, d), nt = q.shape, t.shape[0]
    layout = rows16(lib)

    def run():
        out = [torch.empty(n, dtype=torch.float32, device=q.device)
               for n in (nq, nt)]
        if bf16 and layout:
            out += [torch.empty((n, kk._depth16(d)), dtype=torch.bfloat16,
                                device=q.device) for n in (nq, nt)]
        elif bf16:
            out += [torch.empty_like(q), torch.empty_like(t)]
        ptrs = [x.data_ptr() for x in out] + [None] * (4 - len(out))
        kk._raise_on(lib.knn_prepass_launch(
            q.data_ptr(), nq, t.data_ptr(), nt, d, int(bf16), *ptrs,
            kk._stream(q.device)), "knn_prepass")
        return out
    return run


def bit_equal(old: List[torch.Tensor], new: List[torch.Tensor]) -> str:
    """Why two results differ bit for bit ("" where every tensor of
    them is equal)."""
    return "" if all(torch.equal(a, b) for a, b in zip(old, new)) \
        else "not bit-equal"


def prepass_equal(old: List[torch.Tensor], new: List[torch.Tensor]) -> str:
    """bit_equal for two pre-passes' [qn, tn, q', t'] whose bf16 operands
    may lie in either layout: fp32 copies [n, D] or bf16 rows [n,
    depth16(D)] (zero past D) compare as their bf16 values over D."""
    def values(x, d):
        return x[:, :d].to(torch.bfloat16) if x.dim() == 2 else x
    d = min(x.shape[1] for x in old[2:] + new[2:]) if len(old) > 2 else 0
    pads = [x[:, d:] for x in old[2:] + new[2:] if x.shape[1] > d]
    if any(bool(p.any()) for p in pads):
        return "padding not zero"
    return bit_equal([values(x, d) for x in old], [values(x, d) for x in new])


def ab_row(old, new, reps: int, out, agree=bit_equal, timer=None,
           **row) -> dict:
    """Compare old() and new() by `agree` (bit for bit unless told
    otherwise: it returns why they disagree, "" if they do not), time
    them in turns by `timer` (fn, reps) -> ms, cuda_ms unless told
    otherwise, print and return the row."""
    timer = timer or cuda_ms
    why = agree(old(), new())
    p1, n1, n2, p2 = (timer(fn, reps) for fn in (old, new, new, old))
    row.update(agree=not why, by=agree.__name__, earlier_ms=(p1 + p2) / 2,
               current_ms=(n1 + n2) / 2)
    row["ratio"] = row["earlier_ms"] / row["current_ms"]
    verdict = ("same" if agree in (bit_equal, prepass_equal)
               else "close") if not why \
        else f"DIFF ({why})"
    digits = 3 if timer is cuda_ms else 5
    out(f"{verdict} D={row['d']} {row['metric']} {row['mode']} "
        f"{row['dtype']}{' ' + row['forms'] if 'forms' in row else ''}: "
        f"earlier {row['earlier_ms']:.{digits}f} ms ({p1:.{digits}f}, "
        f"{p2:.{digits}f}), current {row['current_ms']:.{digits}f} ms "
        f"({n1:.{digits}f}, {n2:.{digits}f}), x{row['ratio']:.2f}")
    return row


def profiled_ms(fn: Callable[[], object], kernel: str, reps: int
                ) -> Optional[float]:
    """torch.profiler's mean device time (ms) of the kernels whose name
    holds `kernel` over reps calls of fn, after one warm-up; None if no
    such kernel is recorded (a profile that records none is retaken
    once)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = count = 0
        for ev in prof.key_averages():
            if kernel in ev.key:
                us += (ev.device_time_total
                       if hasattr(ev, "device_time_total")
                       else ev.cuda_time_total)
                count += ev.count
        if count:
            return us / count / 1e3
    return None


def merge_ms(fn: Callable[[], object], reps: int) -> float:
    """A merge row's timer: the merge kernels' mean device time."""
    ms = profiled_ms(fn, "merge_", reps)
    return float("nan") if ms is None else ms


def split_lists(q, t, labels, k: int, mode: str, metric: str, bf16: bool):
    """(part_key, part_idx, splits): the split lists one launch of this
    checkout's kernels in `mode` leaves on q and t, through the route the
    wrapper takes (after the pre-pass where euclidean)."""
    euclid = metric == "euclidean"
    mma = kk._mma(euclid, bf16)
    nq, d = q.shape
    ops = [kk._ptr(x) for x in kk._operands(q, t, euclid, bf16, NT)]
    _, _, splits, rows = kk._grid(q, k, euclid, mode, NT, bf16=mma)
    part_k, part_i = kk._partial_buffers(q, k, splits)
    stream = kk._stream(q.device)
    if mode == "labels":
        out = torch.empty((nq, C), dtype=torch.float32, device=q.device)
        kk._launch(_build.load("knn_classify"), "knn_classify", mma,
                   "knn_classify_lanes", *ops, labels.data_ptr(), nq, d, NT,
                   k, int(euclid), kk.label_bits(C), C, 1.0 / d, 0, 1.0,
                   splits, rows, part_k.data_ptr(), part_i.data_ptr(),
                   out.data_ptr(), stream)
    else:
        out = torch.empty((2, nq, k), dtype=torch.int32, device=q.device)
        kk._launch(_build.load("knn_topk"), "knn_topk", mma,
                   f"knn_topk ({mode})", *ops, nq, d, NT, k, int(euclid),
                   kk.MODES[mode], kk._key_spec(mode, t)[0], splits, rows,
                   part_k.data_ptr(), part_i.data_ptr(), out[0].data_ptr(),
                   out[1].data_ptr(), stream)
    return part_k, part_i, splits


def merge_call(lib, lists, nq: int, k: int, mode: str, metric: str, d: int,
               kernel_fn: Optional[str] = None,
               launches: int = MERGE_LAUNCHES, kernel_param: float = 30.0
               ) -> Callable[[], List[torch.Tensor]]:
    """`launches` launches of `lib`'s merge kernel alone on `lists`
    (split_lists), giving [keys, indices] (the top-k merge of `mode`) or,
    with kernel_fn, [scores] (the merge and vote, C classes, over d
    attributes). Its output starts as -7 (scores NaN), so a slot no
    launch writes shows."""
    part_k, part_i, splits = lists
    stream = kk._stream(part_k.device)
    ptrs = (part_k.data_ptr(), part_i.data_ptr())
    if kernel_fn is None:
        out = torch.full((2, nq, k), -7, dtype=torch.int32,
                         device=part_k.device)

        def launch():
            kk._raise_on(lib.knn_topk_merge_launch(
                *ptrs, nq, splits, k, kk.MODES[mode], out[0].data_ptr(),
                out[1].data_ptr(), stream), "knn_topk_merge")
    else:
        out = torch.full((nq, C), float("nan"), device=part_k.device)

        def launch():
            kk._raise_on(lib.knn_classify_merge_launch(
                *ptrs, nq, splits, k, int(metric == "euclidean"),
                kk.label_bits(C), C, 1.0 / d, kk.KERNEL_FNS.index(kernel_fn),
                kernel_param, out.data_ptr(), stream), "knn_classify_merge")

    def run():
        for _ in range(launches):
            launch()
        return list(out) if kernel_fn is None else [out]
    return run


#: the merge rows' lists: (name, D, metric, dtype, k, top-k mode)
MERGE_LISTS = (("job", 6, "manhattan", "float32", K, "exact"),
               ("K=16", 6, "manhattan", "float32", 16, "exact"),
               ("K=32", 6, "manhattan", "float32", 32, "exact"),
               ("K=64", 6, "manhattan", "float32", 64, "exact"),
               ("bench", 128, "euclidean", "bfloat16", K, "lanes"))


def merge_rows(q, t, labels, libs, reps: int, out) -> List[dict]:
    """Both versions' merge kernels on the MERGE_LISTS of this D."""
    rows = []
    nq, d = q.shape
    for name, dl, metric, dtype, k, mode in MERGE_LISTS:
        if dl != d:
            continue
        bf16 = dtype == "bfloat16"
        for lmode, fns in ((mode, (None,)), ("labels", ("none", "gaussian"))):
            lists = split_lists(q, t, labels, k, lmode, metric, bf16)
            torch.cuda.synchronize()
            splits = lists[2]
            group = kk.merge_layout(nq, splits)["group"]
            for fn in fns:
                kernel = "merge_topk" if fn is None else f"merge_vote {fn}"
                row = ab_row(
                    merge_call(libs[1 if fn else 0], lists, nq, k, lmode,
                               metric, d, fn),
                    merge_call(_build.load("knn_classify" if fn
                                           else "knn_topk"), lists, nq, k,
                               lmode, metric, d, fn),
                    reps, out, timer=merge_ms, d=d, metric=metric,
                    mode=f"{kernel} ({lmode} lists of the {name} shape, k={k},"
                         f" {splits} splits, G={group})",
                    dtype=dtype)
                row.update(kernel=kernel, lists=name, k=k, splits=splits,
                           group=group)
                rows.append(row)
    return rows


def cuda_ms(fn: Callable[[], object], reps: int) -> float:
    """Median CUDA-event time of fn() over reps runs, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"


def run(parent: Path, reps: int = 5, out=print) -> List[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError("knn_ab compares CUDA kernels and needs a CUDA "
                           "device")
    dev = torch.device("cuda")
    libs = load_parent(parent)
    here = _build.load("knn_prepass")
    out(card())
    for name, lib, build in (("earlier", libs[0], _build.build_dir(parent)),
                             ("current", None, _build.build_dir())):
        n = sass_instructions(library_sass(build), K8_L1_EXACT)
        for d in (6, 128):
            info = kk.partial_info(8, False, "exact", d, lib)
            out(f"{name} K=8 manhattan exact D={d}: {info[1]} registers, "
                f"{info[2]} local bytes, {info[0]} blocks/SM, {n} SASS "
                f"instructions")
    for name, topk, classify in (("earlier", libs[0], libs[1]),
                                 ("current", None, None)):
        for mode in kk.MODES:
            for k in (8, 16, 32, 64):
                for d in (6, 128):
                    info = kk.partial_info(
                        k, True, mode, d,
                        classify if mode == "labels" else topk, bf16=True)
                    out(f"{name} K={k} euclidean bfloat16 {mode} "
                        f"(tensor-core) D={d}: {info[1]} registers, "
                        f"{info[2]} local bytes, {info[0]} blocks/SM, "
                        f"{info[3]} rows x {info[4]} stages")
    for vote in (False, True):
        for k in (8, 16, 32, 64):
            info = kk.merge_info(k, vote)
            out(f"current merge_{'vote' if vote else 'topk'} K={k}: "
                f"{info[1]} registers, {info[2]} local bytes, {info[0]} "
                f"blocks/SM")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for d in (6, 128):
        q = torch.rand((NQ, d), generator=gen, device=dev)
        t = torch.rand((NT, d), generator=gen, device=dev)
        labels = torch.randint(0, 2, (NT,), generator=gen, device=dev,
                               dtype=torch.int32)
        for dtype, bf16 in (("float32", False), ("bfloat16", True)):
            rows.append(ab_row(prepass_call(q, t, bf16, libs[2]),
                               prepass_call(q, t, bf16, here), reps, out,
                               agree=prepass_equal, d=d, metric="-",
                               mode="prepass", dtype=dtype))
        for metric in ("manhattan", "euclidean"):
            dtypes = (("float32", False), ("bfloat16", True)) \
                if metric == "euclidean" else (("float32", False),)
            for mode in ("exact", "lanes", "packed", "labels"):
                for dtype, bf16 in dtypes:
                    kw = {}
                    if bf16:       # the two versions' tensor-core forms
                        def bf16_close(old, new, mode=mode):
                            return bf16_agrees(mode, q, t, K, old, new)
                        kw = dict(agree=bf16_close,
                                  forms="tensor-core/tensor-core")
                    rows.append(ab_row(
                        current_call(mode, q, t, labels, metric, bf16, libs),
                        current_call(mode, q, t, labels, metric, bf16), reps,
                        out, d=d, metric=metric, mode=mode, dtype=dtype,
                        **kw))
        rows += merge_rows(q, t, labels, libs, reps, out)
    out(json.dumps({"metric": "knn_ab", "device": torch.cuda.get_device_name(0),
                    "card": card(), "rows": rows}))
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory of the earlier knn_tile.cuh, knn_topk.cu, "
                         "knn_classify.cu and knn_prepass.cu")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    rows = run(args.parent, args.reps)
    return 0 if all(r["agree"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
