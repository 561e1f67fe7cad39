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

Then one JSON line of per-kernel numbers, and as the last line
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

#: fp32 CUDA-core peak (FLOP/s, an FMA counted as 2) and memory rate
#: (bytes/s) at the full power limit, from NVIDIA's H100 data sheet
PEAKS = (("H100 PCIe", 51.2e12, 2.0e12), ("H100 NVL", 60.0e12, 3.9e12),
         ("H100", 66.9e12, 3.35e12))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    print(("ok   " if ok else "FAIL ") + msg, flush=True)
    if not ok:
        sys.exit(1)


def peaks(name: str):
    for key, flops, rate in PEAKS:
        if key in name:
            return flops, rate
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
             extra_bytes: int = 0):
    """(ms, "operations" or "bytes"): the least time for the work, the
    larger of operations over the fp32 peak (euclidean 2*D per pair,
    manhattan 3*D, plus one selection compare per pair) and bytes over the
    memory rate (inputs read once, outputs once), and which one it was."""
    ops = NQ * NT * ((2 if metric == "euclidean" else 3) * d + 1)
    nbytes = (NQ + NT) * d * 4 + NQ * k * 8 + extra_bytes
    ops_ms, bytes_ms = ops / flops * 1e3, nbytes / rate * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def phase_kernels(flops: float, rate: float):
    import torch

    from avenir_tpu_torch.ops import knn_kernels as kk

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
                pd, pi = plain(q, t, K, metric)
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
                plain_ms = cuda_ms(lambda: plain(q, t, K, metric), 2)
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
                ref = run(kk.knn_classify_lanes_plain)
                err = (got - ref).abs().max().item()
                agree = (got.argmax(1) == ref.argmax(1)).float().mean().item()
                ms = cuda_ms(run, 5)
                plain_ms = cuda_ms(lambda: run(kk.knn_classify_lanes_plain), 2)
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


def _tied(q, t, gi, pd, mism, metric, rtol, atol) -> bool:
    """Where the kernel's index differs from the plain one, the row the
    kernel chose must be as near as the plain one's (a tie)."""
    import torch

    rows, cols = torch.nonzero(mism, as_tuple=True)
    if rows.numel() == 0:
        return True
    a, b = q[rows], t[gi[rows, cols].long()]
    d = q.shape[1]
    if metric == "euclidean":
        true = torch.sqrt(((a.double() - b.double()) ** 2).sum(1) / d)
    else:
        # the kernels' own fp32 sum, features in order from 0.0
        acc = torch.zeros(rows.numel(), device=q.device)
        for f in range(d):
            acc = acc + (a[:, f] - b[:, f]).abs()
        true = (acc / d).double()
    ref = pd[rows, cols].double()
    return bool(((true - ref).abs() <= atol + rtol * ref).all())


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
    launches, preds = {}, {}
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
        launches[wrapper.__name__] = wrapper.launches
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
    flops, rate = peaks(torch.cuda.get_device_name(0))
    checks = phase_kernels(flops, rate)
    launches = phase_main_path()

    main_shape = {"knn_topk": ("manhattan", 6, None),
                  "knn_topk_lanes": ("manhattan", 6, None),
                  "knn_classify_lanes": ("manhattan", 6, "gaussian")}
    sources = {"knn_topk": ("knn_topk.cu", 99), "knn_topk_lanes": ("knn_topk.cu", 223),
               "knn_classify_lanes": ("knn_classify.cu", 426)}
    kernels = []
    for name, (metric, d, fn) in main_shape.items():
        row = next(r for r in checks if r["name"] == name and r["metric"] == metric
                   and r["d"] == d and r.get("kernel_fn") == fn)
        src, line = sources[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"avenir_tpu_torch/ops/csrc/{src}",
            "replaces": f"avenir_tpu/ops/pallas_knn.py:{line}",
            "launches": launches[name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
