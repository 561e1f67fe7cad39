#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`avenir_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line per check; any failed check exits non-zero:

1. Card: name and power limit (nvidia-smi), torch and CUDA versions, and
   the nvcc build of every kernel from `avenir_tpu_torch/ops/csrc/`.
2. Kernels against their plain PyTorch versions on the card, at the
   e-learning workload's size (8192 queries x 131072 train rows, k=5),
   D in {6, 128}, both metrics, and for the vote C=2 with the kernels
   none and gaussian(30). Tolerances: manhattan exact rtol 1e-6;
   euclidean exact rtol 1e-4, atol 1e-5; lane-packed keys within one
   quantum 2^-(23-pack_bits) with neighbour-set recall >= 0.99; vote
   scores equal for the kernel none (neighbour counts) and within 2.0
   for gaussian, with arg-max agreement >= 0.99. Index mismatches
   are allowed only between tied distances. Times are CUDA-event medians.
3. The main path: the `nearestNeighbor` job through `runner.run_job` on
   seeded e-learning CSVs (131072 train, 8192 test rows, 6 features), in
   its three modes (default exact top-k, nen.device.packed.kernel,
   nen.device.fused.vote); each must launch its kernel, score accuracy
   above 60, and agree with the others on >= 99% of predictions; the
   default run's first 1024 lines must equal the job's on the CPU.
4. The kernel-check path: `avenir_tpu_torch.tools.kernel_check` on the
   card, every case against its float64 oracle; any failed case fails.
5. The packed kernel and every bfloat16 variant against their plain
   versions at 8192 x 131072, D in {6, 128}: packed manhattan bit-equal;
   packed euclidean within the exact tolerance plus one 2^-11 quantum;
   bfloat16 euclidean within each kernel's float32 tolerance against the
   bfloat16 plain version (index mismatches only between ties); bfloat16
   manhattan bit-equal to float32. Then `avenir_tpu_torch.tools.knn_sweep`
   at its full width (8192 x 131072, D=128).

Phases 4 and 5's sweep are the second path: each kernel's launches there
are counted from zero, beside its launches on the job path. Then one JSON
line of per-kernel numbers, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NQ, NT, K = 8192, 131072, 5
CHECK_ROWS = 1024
DEVICE = "cuda"

#: fp32 CUDA-core peak (FLOP/s, an FMA counted as 2), memory rate
#: (bytes/s) and dense bf16 tensor-core peak (FLOP/s) at the full power
#: limit, from NVIDIA's H100 data sheet
PEAKS = (("H100 PCIe", 51.2e12, 2.0e12, 756e12),
         ("H100 NVL", 60.0e12, 3.9e12, 835e12),
         ("H100", 66.9e12, 3.35e12, 989e12))
#: the packed kernel's quantum: 12 masked mantissa bits, 2^-11 relative
PACKED_QUANTUM = 2.0 ** -11
CHECK_PATH = "kernel_check+knn_sweep"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    print(("ok   " if ok else "FAIL ") + msg, flush=True)
    if not ok:
        sys.exit(1)


def peaks(name: str):
    for key, *rates in PEAKS:
        if key in name:
            return rates
    fail(f"no peak rates known for {name!r}")


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() over reps runs, after one warm-up."""
    import torch

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


def _timed_once(fn):
    """(fn(), CUDA-event ms of that one call): the plain versions take
    0.1-1.7 s at full size, so each is timed on the call compared."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


# ------------------------------------------------------------------ phase 1
def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    from avenir_tpu_torch.ops import _build

    t0 = time.perf_counter()
    secs = _build.build_all()
    total = time.perf_counter() - t0
    print(f"build {total:.1f}s {json.dumps({k: round(v, 1) for k, v in secs.items()})} "
          f"into {_build.build_dir().relative_to(ROOT)}", flush=True)
    for name in _build.LIBRARIES:
        log = _build.build_dir() / f"{name}.log"
        if log.exists():
            text = log.read_text()
            regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
            spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", text))
            print(f"ptxas {name}: {len(regs)} kernels, registers "
                  f"{min(regs)}..{max(regs)}, spill stores {spills} bytes",
                  flush=True)
        _build.load(name)


# ------------------------------------------------------------------ phase 2
def bound_ms(metric: str, d: int, k: int, flops: float, rate: float,
             extra_bytes: int = 0, bf16_flops: float = 0.0):
    """(ms, "operations" or "bytes"): the least time for the work, the
    larger of operations over the fp32 peak (euclidean 2*D per pair,
    manhattan 3*D, plus one selection compare per pair) and bytes over the
    memory rate (inputs read once, outputs once), and which one it was.
    With bf16_flops (a euclidean bfloat16 cross term) the 2*D products and
    sums per pair count at that tensor-core peak and the compare at the
    fp32 one, and the larger of the two is the operations' time."""
    pairs = NQ * NT
    if bf16_flops:
        ops_ms = max(pairs * 2 * d / bf16_flops, pairs / flops) * 1e3
    else:
        ops_ms = pairs * ((2 if metric == "euclidean" else 3) * d + 1) / flops * 1e3
    nbytes = (NQ + NT) * d * 4 + NQ * k * 8 + extra_bytes
    bytes_ms = nbytes / rate * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _warm_plain() -> None:
    """Run every plain version once at a tiny size: CUDA loads a library
    kernel at its first use, which no once-timed plain call should pay."""
    import torch

    from avenir_tpu_torch.ops import knn_kernels as kk

    q = torch.rand((8, 4), device=DEVICE)
    t = torch.rand((64, 4), device=DEVICE)
    labels = torch.zeros(64, dtype=torch.int32, device=DEVICE)
    for metric in ("manhattan", "euclidean"):
        for dtype in kk.COMPUTE_DTYPES:
            for plain in (kk.knn_topk_plain, kk.knn_topk_packed_plain,
                          kk.knn_topk_lanes_plain):
                plain(q, t, K, metric, compute_dtype=dtype)
            kk.knn_classify_lanes_plain(q, t, labels, K, 2, 4, "gaussian",
                                        30.0, metric, compute_dtype=dtype)
    torch.cuda.synchronize()


def phase_kernels(flops: float, rate: float):
    import torch

    from avenir_tpu_torch.ops import knn_kernels as kk

    _warm_plain()
    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    results = []
    for d in (6, 128):
        q = torch.rand((NQ, d), generator=gen, device=DEVICE)
        t = torch.rand((NT, d), generator=gen, device=DEVICE)
        labels = torch.randint(0, 2, (NT,), generator=gen, device=DEVICE,
                               dtype=torch.int32)
        for metric in ("manhattan", "euclidean"):
            p = 1.0 if metric == "manhattan" else 2.0
            lib_ms = cuda_ms(lambda: torch.topk(torch.cdist(q, t, p=p), K,
                                                dim=1, largest=False), 2)
            bound, bound_by = bound_ms(metric, d, K, flops, rate)
            for name in ("knn_topk", "knn_topk_lanes"):
                wrap = getattr(kk, name)
                plain = getattr(kk, name + "_plain")
                gd, gi = wrap(q, t, K, metric)
                torch.cuda.synchronize()
                (pd, pi), plain_ms = _timed_once(lambda: plain(q, t, K, metric))
                err = (gd - pd).abs().max().item()
                mism = gi != pi
                rtol, atol = (1e-6, 0.0) if metric == "manhattan" else (1e-4, 1e-5)
                if name == "knn_topk_lanes":
                    # one quantum, on top of the exact kernel's tolerance
                    tol = 2.0 ** -(23 - kk.lane_pack_bits(NT))
                    close = bool(((gd - pd).abs()
                                  <= atol + (rtol + tol) * pd.abs()).all())
                    recall = _recall(gi, pi)
                    ok = close and recall >= 0.99
                    how = f"quantum {tol:.2e} recall {recall:.5f}"
                else:
                    close = bool(((gd - pd).abs() <= atol + rtol * pd.abs()).all())
                    tied = _tied(q, t, gi, pd, mism, metric, rtol, atol)
                    ok = close and tied
                    how = f"rtol {rtol} atol {atol} ties-only {tied}"
                ms = cuda_ms(lambda: wrap(q, t, K, metric), 5)
                row = dict(name=name, metric=metric, d=d, max_abs_err=err,
                           index_mismatch=int(mism.sum()), ms=ms,
                           plain_ms=plain_ms, bound_ms=bound,
                           bound_by=bound_by, library_ms=lib_ms)
                results.append(row)
                check(ok, f"{name} {metric} D={d}: max|err| {err:.3g} "
                      f"index mismatches {int(mism.sum())} ({how}); "
                      f"{ms:.3f} ms, plain {plain_ms:.1f} ms, "
                      f"bound {bound:.3f} ms, cdist+topk {lib_ms:.1f} ms")
            for fn in ("none", "gaussian"):
                def run(impl=kk.knn_classify_lanes):
                    return impl(q, t, labels, K, 2, d, fn, 30.0, metric)
                got = run()
                torch.cuda.synchronize()
                ref, plain_ms = _timed_once(
                    lambda: run(kk.knn_classify_lanes_plain))
                err = (got - ref).abs().max().item()
                agree = (got.argmax(1) == ref.argmax(1)).float().mean().item()
                ms = cuda_ms(run, 5)
                cbound, cbound_by = bound_ms(metric, d, 0, flops, rate,
                                             extra_bytes=NT * 4 + NQ * 2 * 4)
                # no PyTorch call computes the vote: library_ms is null
                results.append(dict(name="knn_classify_lanes", metric=metric,
                                    d=d, kernel_fn=fn, max_abs_err=err,
                                    argmax_agreement=agree, ms=ms,
                                    plain_ms=plain_ms, bound_ms=cbound,
                                    bound_by=cbound_by, library_ms=None))
                # "none" counts neighbours: no floored score may round apart
                tol = 0.0 if fn == "none" else 2.0
                check(err <= tol and agree >= 0.99,
                      f"knn_classify_lanes {metric} D={d} {fn}: max|err| "
                      f"{err:.3g} argmax agreement {agree:.5f}; {ms:.3f} ms, "
                      f"plain {plain_ms:.1f} ms, bound {cbound:.3f} ms")
        # padded corpus: rows at and past n_valid never enter
        nv = NT - 777
        gd, gi = kk.knn_topk(q, t, K, "manhattan", n_valid=nv)
        pd, pi = kk.knn_topk_plain(q, t, K, "manhattan", n_valid=nv)
        check(bool((gi < nv).all()) and torch.equal(gd, pd),
              f"knn_topk manhattan D={d} n_valid={nv}: padding masked")
    return results


def _recall(gi, pi) -> float:
    import torch

    hits = (gi[:, :, None] == pi[:, None, :]).any(2).float()
    return hits.mean().item()


def _within(got, ref, d, rtol, atol, floor=0.0):
    """Elementwise |got - ref| <= atol + rtol |ref|; with a floor, a
    distance may instead lie within `floor` of ref in the squared sum it
    came from (d * dist^2): near zero the square root turns one fp32 ulp
    of the dot form's norms into a large share of the distance."""
    ok = (got - ref).abs() <= atol + rtol * ref.abs()
    if floor:
        ok |= ((got * got - ref * ref) * d).abs() <= floor
    return ok


def _cancellation_floor(q, t) -> float:
    """A few fp32 ulps (2^-20) of the largest |q|^2 + |t|^2: the error of
    the dot form |q|^2 + |t|^2 - 2 q.t however small the result."""
    return 2.0 ** -20 * ((q * q).sum(1).max() + (t * t).sum(1).max()).item()


def _tied(q, t, gi, pd, mism, metric, rtol, atol, bf16=False,
          floor=0.0) -> bool:
    """Where the kernel's index differs from the plain one, the row the
    kernel chose must be as near as the plain one's (a tie). With bf16
    the distance is the bfloat16 cross term's, taken in float64, and
    `floor` is _within's."""
    import torch

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
    return bool(_within(true, ref, d, rtol, atol, floor).all())


# ------------------------------------------------------------------ phase 3
def phase_main_path():
    import torch

    from avenir_tpu_torch.data import elearn_schema, generate_elearn
    from avenir_tpu_torch.ops import knn_kernels as kk
    from avenir_tpu_torch.runner import run_job

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    schema = str(work / "elearn.json")
    elearn_schema().save(schema)
    train, test = str(work / "train.csv"), str(work / "test.csv")
    Path(train).write_text(generate_elearn(NT, seed=101, as_csv=True))
    test_csv = generate_elearn(NQ, seed=102, as_csv=True)
    Path(test).write_text(test_csv)
    small = str(work / "test_small.csv")
    Path(small).write_text("".join(test_csv.splitlines(True)[:CHECK_ROWS]))
    base = {"nen.feature.schema.file.path": schema,
            "nen.top.match.count": str(K),
            "nen.kernel.function": "gaussian", "nen.kernel.param": "30",
            "nen.validation.mode": "true"}
    modes = (("default", {}, kk.knn_topk),
             ("packed", {"nen.device.packed.kernel": "true"}, kk.knn_topk_lanes),
             ("fused", {"nen.device.fused.vote": "true"}, kk.knn_classify_lanes))
    launches, preds = {}, {}     # launches: summed over the three runs
    for mode, extra, wrapper in modes:
        out = str(work / f"out_{mode}.txt")
        kk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_job("nearestNeighbor", {**base, **extra}, [train, test], out,
                      device=DEVICE)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {fn.__name__: fn.launches for fn in kk.KERNEL_WRAPPERS}
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        acc = res.counters["Validation:Accuracy"]
        lines = Path(out).read_text().splitlines()
        preds[mode] = [ln.split(",")[1] for ln in lines]
        check(wrapper.launches >= 1 and acc > 60 and len(lines) == NQ,
              f"nearestNeighbor {mode}: {secs:.2f}s, {wrapper.__name__} "
              f"launched {wrapper.launches}x, launches {counts}, "
              f"Validation:Accuracy {acc}, {len(lines)} rows")
    for mode in ("packed", "fused"):
        agree = sum(a == b for a, b in zip(preds["default"], preds[mode])) / NQ
        check(agree >= 0.99, f"default vs {mode}: predictions agree {agree:.5f}")
    cpu_out = str(work / "out_cpu.txt")
    run_job("nearestNeighbor", base, [train, small], cpu_out, device="cpu")
    gpu_head = Path(work / "out_default.txt").read_text().splitlines()[:CHECK_ROWS]
    cpu_lines = Path(cpu_out).read_text().splitlines()
    check(gpu_head == cpu_lines,
          f"default run's first {CHECK_ROWS} lines equal the CPU run's")
    shutil.rmtree(work)
    return launches


# ------------------------------------------------------------------ phase 4
def _launch_counts():
    from avenir_tpu_torch.ops import knn_kernels as kk

    return {fn.__name__: fn.launches for fn in kk.KERNEL_WRAPPERS}


def phase_kernel_check():
    """Every kernel_check case on the card; its launch counts."""
    import torch

    from avenir_tpu_torch.ops import knn_kernels as kk
    from avenir_tpu_torch.tools import kernel_check

    kk.reset_launches()
    t0 = time.perf_counter()
    results = kernel_check.run(DEVICE)
    torch.cuda.synchronize()
    counts = _launch_counts()
    failed = [name for name, faults in results.items() if faults]
    check(not failed, f"kernel_check: {len(results) - len(failed)} of "
          f"{len(results)} cases pass in {time.perf_counter() - t0:.1f}s, "
          f"launches {counts}" + (f"; failed {failed}" if failed else ""))
    return counts


# ------------------------------------------------------------------ phase 5
def _boundary_tied(q, t, rows, metric, dtype, rtol, floor) -> bool:
    """A vote may differ by a whole neighbour's score only where the k-th
    and (k+1)-th nearest rows are tied, so the two sides may keep either:
    checked on the plain top-(k+1) of those queries."""
    from avenir_tpu_torch.ops import knn_kernels as kk

    if rows.numel() == 0:
        return True
    dist, _ = kk.knn_topk_plain(q[rows], t, K + 1, metric,
                                compute_dtype=dtype)
    return bool(_within(dist[:, K], dist[:, K - 1], q.shape[1], rtol, 1e-5,
                        floor).all())


def phase_packed_bf16(flops: float, rate: float, bf16_flops: float,
                      phase2_rows):
    """The packed kernel and every bfloat16 variant against their plain
    versions; plain versions are timed once, on the compared call."""
    import torch

    from avenir_tpu_torch.ops import knn_kernels as kk

    gen = torch.Generator(device=DEVICE).manual_seed(4321)
    topk = (("knn_topk", 0.0), ("knn_topk_packed", PACKED_QUANTUM),
            ("knn_topk_lanes", 2.0 ** -(23 - kk.lane_pack_bits(NT))))
    results = []
    for d in (6, 128):
        q = torch.rand((NQ, d), generator=gen, device=DEVICE)
        t = torch.rand((NT, d), generator=gen, device=DEVICE)
        labels = torch.randint(0, 2, (NT,), generator=gen, device=DEVICE,
                               dtype=torch.int32)
        # manhattan ignores the dtype: bfloat16 is float32, bit for bit
        for name, _ in topk:
            wrap = getattr(kk, name)
            same = all(torch.equal(x, y) for x, y in zip(
                wrap(q, t, K, "manhattan", compute_dtype="bfloat16"),
                wrap(q, t, K, "manhattan")))
            check(same, f"{name} manhattan D={d}: bfloat16 equals float32")
        vote = [kk.knn_classify_lanes(q, t, labels, K, 2, d, "gaussian", 30.0,
                                      "manhattan", compute_dtype=dt)
                for dt in kk.COMPUTE_DTYPES]
        check(torch.equal(*vote), f"knn_classify_lanes manhattan D={d}: "
              f"bfloat16 equals float32")
        cases = [("knn_topk_packed", "manhattan", "float32"),
                 ("knn_topk_packed", "euclidean", "float32")]
        cases += [(name, "euclidean", "bfloat16") for name, _ in topk]
        for name, metric, dtype in cases:
            bf16 = dtype == "bfloat16"
            wrap = getattr(kk, name)
            plain = getattr(kk, name + "_plain")
            gd, gi = wrap(q, t, K, metric, compute_dtype=dtype)
            torch.cuda.synchronize()
            (pd, pi), plain_ms = _timed_once(
                lambda: plain(q, t, K, metric, compute_dtype=dtype))
            err = (gd - pd).abs().max().item()
            mism = gi != pi
            rtol = 1e-4 + dict(topk)[name]
            floor = _cancellation_floor(q, t) if bf16 else 0.0
            close = bool(_within(gd, pd, d, rtol, 1e-5, floor).all())
            if metric == "manhattan":
                ok = torch.equal(gd, pd) and torch.equal(gi, pi)
                how = "bit-equal"
            elif name == "knn_topk_lanes":
                recall = _recall(gi, pi)
                ok = close and recall >= 0.99
                how = f"rtol {rtol:.3g} floor {floor:.2g} recall {recall:.5f}"
            else:
                tied = _tied(q, t, gi, pd, mism, metric, rtol, 1e-5, bf16,
                             floor)
                ok = close and tied
                how = (f"rtol {rtol:.3g} atol 1e-05 floor {floor:.2g} "
                       f"ties-only {tied}")
            ms = cuda_ms(lambda: wrap(q, t, K, metric, compute_dtype=dtype), 5)
            bound, bound_by = bound_ms(metric, d, K, flops, rate,
                                       bf16_flops=bf16_flops if bf16 else 0.0)
            lib = next(r["library_ms"] for r in phase2_rows
                       if r["metric"] == metric and r["d"] == d)
            results.append(dict(name=name, metric=metric, d=d, dtype=dtype,
                                max_abs_err=err,
                                index_mismatch=int(mism.sum()), ms=ms,
                                plain_ms=plain_ms, bound_ms=bound,
                                bound_by=bound_by, library_ms=lib))
            check(ok, f"{name} {metric} {dtype} D={d}: max|err| {err:.3g} "
                  f"index mismatches {int(mism.sum())} ({how}); "
                  f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound:.3f} ms "
                  f"({bound_by}), cdist+topk {lib:.1f} ms")

        def run(impl=kk.knn_classify_lanes):
            return impl(q, t, labels, K, 2, d, "gaussian", 30.0, "euclidean",
                        compute_dtype="bfloat16")
        got = run()
        torch.cuda.synchronize()
        ref, plain_ms = _timed_once(lambda: run(kk.knn_classify_lanes_plain))
        err = (got - ref).abs().max().item()
        agree = (got.argmax(1) == ref.argmax(1)).float().mean().item()
        # beyond a floored-score step (2.0), only a tie at the k-th
        # neighbour may change a vote
        swapped = torch.nonzero(((got - ref).abs() > 2.0).any(1)).flatten()
        tied = _boundary_tied(q, t, swapped, "euclidean", "bfloat16", 1e-4,
                              _cancellation_floor(q, t))
        ms = cuda_ms(run, 5)
        bound, bound_by = bound_ms("euclidean", d, 0, flops, rate,
                                   extra_bytes=NT * 4 + NQ * 2 * 4,
                                   bf16_flops=bf16_flops)
        results.append(dict(name="knn_classify_lanes", metric="euclidean",
                            d=d, dtype="bfloat16", kernel_fn="gaussian",
                            max_abs_err=err, argmax_agreement=agree, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound,
                            bound_by=bound_by, library_ms=None))
        check(tied and agree >= 0.99,
              f"knn_classify_lanes euclidean bfloat16 D={d} gaussian: "
              f"max|err| {err:.3g}, {swapped.numel()} queries past 2.0 "
              f"(k-th neighbour tied: {tied}), argmax agreement "
              f"{agree:.5f}; {ms:.3f} ms, "
              f"plain {plain_ms:.1f} ms, bound {bound:.3f} ms ({bound_by})")
    return results


def phase_sweep():
    """The KNN sweep at its full width; its launch counts."""
    import torch

    from avenir_tpu_torch.ops import knn_kernels as kk
    from avenir_tpu_torch.tools import knn_sweep

    kk.reset_launches()
    t0 = time.perf_counter()
    knn_sweep.run(device=DEVICE)
    torch.cuda.synchronize()
    counts = _launch_counts()
    print(f"knn_sweep: {time.perf_counter() - t0:.1f}s, launches {counts}",
          flush=True)
    return counts


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch unavailable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke run needs a GPU")
    sys.path.insert(0, str(ROOT))
    try:
        import avenir_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the avenir_tpu_torch package is not beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_card()
    flops, rate, bf16_flops = peaks(torch.cuda.get_device_name(0))
    checks = phase_kernels(flops, rate)
    launches = phase_main_path()
    check_counts = phase_kernel_check()
    checks += phase_packed_bf16(flops, rate, bf16_flops, checks)
    sweep_counts = phase_sweep()
    path_counts = {n: check_counts[n] + sweep_counts[n] for n in check_counts}
    check(min(path_counts.values()) >= 1,
          f"{CHECK_PATH} launched every kernel: {path_counts}")

    # each kernel's row at the shape of the path it is reported on: the
    # job's (manhattan, D=6) for the three it runs; the sweep's
    # (euclidean, D=128) for the packed kernel, which only the second path
    # runs
    main_shape = {"knn_topk": ("manhattan", 6, None),
                  "knn_topk_lanes": ("manhattan", 6, None),
                  "knn_classify_lanes": ("manhattan", 6, "gaussian"),
                  "knn_topk_packed": ("euclidean", 128, None)}
    sources = {"knn_topk": ("knn_topk.cu", 99),
               "knn_topk_lanes": ("knn_topk.cu", 223),
               "knn_classify_lanes": ("knn_classify.cu", 426),
               "knn_topk_packed": ("knn_topk.cu", 131)}
    kernels = []
    for name, (metric, d, fn) in main_shape.items():
        row = next(r for r in checks if r["name"] == name and r["metric"] == metric
                   and r["d"] == d and r.get("kernel_fn") == fn
                   and r.get("dtype", "float32") == "float32")
        src, line = sources[name]
        by_path = {"nearestNeighbor": launches[name],
                   CHECK_PATH: path_counts[name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"avenir_tpu_torch/ops/csrc/{src}",
            "replaces": f"avenir_tpu/ops/pallas_knn.py:{line}",
            "launches": by_path[CHECK_PATH if name == "knn_topk_packed"
                                else "nearestNeighbor"],
            "launches_by_path": by_path, "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
