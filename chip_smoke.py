#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`avenir_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line per check; any failed check exits non-zero:

1. Card: name and power limit (nvidia-smi), torch and CUDA versions, and
   the nvcc build of every kernel from `avenir_tpu_torch/ops/csrc/`.
   Fails on any spill: ptxas's spill bytes of every partial instance and
   the local bytes cudaFuncGetAttributes reports for each of the 32
   CUDA-core and 16 tensor-core (euclidean bfloat16) instances; prints
   the registers and blocks per SM of the K=8 CUDA-core instances and of
   every tensor-core one, and holds each instance's stage plan to the
   wrapper's. The diagnostic instance (clock64 sections) is only listed.
   The matmul ceiling's kernels: ptxas's spill bytes of each, and the
   registers, local bytes, shared bytes, threads and blocks per SM of its
   two wgmma instances (D <= 64 and D <= 128); fails on any spill or a
   tile that differs from the wrapper's plan. The eight merge instances
   (two kernels x four carry widths): ptxas's spill bytes, and the
   registers, local bytes and blocks per SM cudaFuncGetAttributes gives;
   fails on any spill. The merges' layout as the C side picks it
   (knn_merge_layout) against the design's rule and the CPU model's
   MERGE_OWN.
2. Kernels against their plain PyTorch versions on the card, at the
   e-learning workload's size (8192 queries x 131072 train rows, k=5),
   D in {6, 128}, both metrics, and for the vote C=2 with the kernels
   none and gaussian(30). Tolerances: manhattan exact rtol 1e-6;
   euclidean exact rtol 1e-4, atol 1e-5; lane-packed keys within one
   quantum 2^-(23-pack_bits) with neighbour-set recall >= 0.99; vote
   scores equal for the kernel none (neighbour counts) and within 2.0
   for gaussian, with arg-max agreement >= 0.99. Index mismatches
   are allowed only between tied distances. The euclidean pre-pass
   (`knn_prepass`, norms alone and with bfloat16 copies) bit-equal to its
   plain version, there and at ragged shapes up to MAX_D. The merge
   kernels (knn_topk.cu, knn_classify.cu on knn_merge.cuh) timed apart
   from the partial kernel on the job's split lists, bit-equal to the
   plain merge and vote, beside the launch floor (an empty kernel on the
   merges' grid). Times are
   CUDA-event medians; each row prints its share of its bound, its
   blocks per SM, grid and waves, and its launches. The pre-pass and the
   merges also get device-alone times: one CUDA-event pair around 200
   back-to-back launches through their C entries, over 200, and
   torch.profiler's mean device time of their kernel over 200 launches.
3. The main path: the `nearestNeighbor` job through `runner.run_job` on
   seeded e-learning CSVs (131072 train, 8192 test rows, 6 features), in
   its four modes (default exact top-k, nen.device.packed.kernel,
   nen.device.fused.vote, and nen.class.condtion.weighted, which weights
   each neighbour by its Naive Bayes feature posterior and runs the
   exact top-k with `_vote`); each must launch its kernel and score
   accuracy above 60, the packed and fused modes agree with the default
   on >= 99% of predictions, and the default and class-conditional runs'
   first 1024 lines must equal the job's on the CPU. Each mode's seconds
   are printed beside the card's name and power limit.
4. The kernel-check path: `avenir_tpu_torch.tools.kernel_check` on the
   card, every case against its float64 oracle; any failed case fails.
5. The packed kernel and every bfloat16 variant against their plain
   versions at 8192 x 131072, D in {6, 128}: packed manhattan bit-equal;
   packed euclidean within the exact tolerance plus one 2^-11 quantum;
   bfloat16 euclidean, which takes the tensor-core form of the partial
   kernel (one launch on `knn_partial_mma` per call), within each
   kernel's float32 tolerance plus the dot form's cancellation floor
   against the bfloat16 plain version (index mismatches only between
   ties): its products are exact and only its fp32 accumulation order
   differs; bfloat16 manhattan bit-equal to float32. The tensor-core
   form's clock64 section shares at D=128 and D=6, its merge kernels on
   the bench's lists (with device-alone times and the launch floor, as
   in phase 2), and every carry width and mode at ragged shapes, D
   1..MAX_D. The merge kernels alone on ragged split lists (splits 1 to
   65, every carry width, empty queries, ties, sign bits, keys at
   SENTINEL and INF_BITS; votes scoring NaN: gaussian at kernel_param 0
   on zero distances, sign-bit NaN keys under every kernel function and
   both metrics), bit-equal to merge_splits_plain and _vote (NaN where it
   has NaN) and on a rerun; NaN under every kernel function but none on
   the NaN keys. A question, printed: does the partial kernel make a
   sign-bit NaN key from features that hold NaNs? Then
   `avenir_tpu_torch.tools.knn_sweep` at its full width (8192 x 131072,
   D=128).

6. The Naive Bayes path: `bayesianDistr` through `runner.run_job` on a
   seeded churn train CSV of 1,000,000 rows streamed in 4 MB blocks; the
   model file and its stamp must be byte-identical to the same job's run
   with device="cpu". Then `bayesianPredictor` on a 100,000-row churn test
   CSV with validation and cost arbitration: accuracy above 70, the
   predicted class equal to the CPU run's on every row, the appended
   percent within 1 of it (float sums run in another order on the card).
   NB has no TPU kernel: this path launches none.
7. The bench path: `matmul_ceiling` (a cast pass, then wgmma fed by TMA)
   against its plain version at 8192 x 131072 x 128, each row within
   2^-16 sum_j |q̂_i . t̂_j| of the plain row (fp32 accumulation in another
   order), and bit-equal across two runs; its time, bound, plain and
   library (cuBLAS bf16 GEMM) times. The same at every legal D (16..128)
   at 384 x 4736, where the last 256-query tile is half filled. Then
   `avenir_tpu_torch.tools.bench` at full size, its JSON line printed on a
   line of its own; the ceiling kernel and the two lane kernels must launch
   there, and every KNN launch of it (all euclidean bfloat16) on the
   tensor-core form.

8. The pipeline path: `pipelines.knn_pipeline` (recordSimilarity,
   bayesianDistr, bayesianPredictor's feature posteriors,
   featureCondProbJoiner, class-conditional nearestNeighbor) on seeded
   e-learning CSVs at 8192 train x 512 test rows (the distance file has a
   line per pair: 4,194,304), each stage timed through
   `Pipeline.run(only=)`, then the same on the CPU: 4,194,304 pairs and
   joins, accuracy above 60, `knn_topk` launched, and all five files
   byte-identical to the CPU run's.

Phases 4 and 5's sweep are the second path, phase 7's bench the third and
phase 8's pipeline the fourth: each kernel's launches are counted from
zero on each path. Then one JSON
line of per-kernel numbers (the pre-pass beside the five kernels, at the
sweep's D=128 float32; the tensor-core form at the bench's D=128
bfloat16; the two merge kernels at the job's shape), and as the last line
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
CHECK_PATH = "kernel_check+knn_sweep"
BENCH_PATH = "bench"
#: phase 6: churn rows trained on and scored
NB_TRAIN_ROWS, NB_TEST_ROWS = 1_000_000, 100_000
#: phase 7: the bench's ceiling shape (bench.py:792-795)
CEIL_NQ, CEIL_NT, CEIL_D = 8192, 131072, 128
#: phase 8: the knn pipeline's train and test rows at the e-learning
#: width; its distance file has a line per pair
PIPE_NT, PIPE_NQ = 8192, 512
PIPE_PATH = "knn_pipeline"
PIPE_FILES = ("simi.txt", "distr.csv", "condProb.txt", "join.txt",
              "knn_out.txt")
#: nvidia-smi's name and power limit of the card (phase 1)
CARD = ""


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


def device_alone(launch, kernel: str, n: int = 200):
    """(ms, profiler ms) of one launch through a kernel's C entry, on the
    device alone: one CUDA-event pair around n back-to-back launches, over
    n; and torch.profiler's mean device time of the kernels whose name
    holds `kernel` over n launches (knn_ab.profiled_ms; None if it records
    none)."""
    import torch

    from avenir_tpu_torch.tools.knn_ab import profiled_ms

    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, profiled_ms(launch, kernel, n)


def _device_text(ms: float, prof_ms) -> str:
    return (f"device alone {ms:.4f} ms (200 launches a CUDA-event pair), "
            + ("profiler not measured" if prof_ms is None
               else f"profiler {prof_ms:.4f} ms"))


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
    global CARD
    CARD = card
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    from avenir_tpu_torch.ops import _build

    t0 = time.perf_counter()
    secs = _build.build_all()
    total = time.perf_counter() - t0
    print(f"build {total:.1f}s {json.dumps({k: round(v, 1) for k, v in secs.items()})} "
          f"into {_build.build_dir().relative_to(ROOT)}", flush=True)
    merges = {}
    for name in _build.LIBRARIES:
        log = _build.build_dir() / f"{name}.log"
        if log.exists():
            text = log.read_text()
            merges.update({fn: int(st) + int(ld) for fn, st, ld in re.findall(
                r"Function properties for (\S*merge_(?:topk|vote)_kernel\S*)"
                r"\s+\d+ bytes stack frame, (\d+) bytes spill stores, "
                r"(\d+) bytes spill loads", text)})
            regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
            spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", text))
            print(f"ptxas {name}: {len(regs)} kernels, registers "
                  f"{min(regs)}..{max(regs)}, spill stores {spills} bytes",
                  flush=True)
            partial = {fn: int(st) + int(ld) for fn, st, ld in re.findall(
                r"Function properties for (\S*partial_topk(?:_mma)?_kernel\S*)"
                r"\s+\d+ bytes stack frame, (\d+) bytes spill stores, "
                r"(\d+) bytes spill loads", text)}
            # the diagnostic instance (PROFILE, "Lb1E") runs on no path
            diag = {fn: n for fn, n in partial.items() if "ELb1E" in fn}
            partial = {fn: n for fn, n in partial.items() if fn not in diag}
            if partial:
                spilled = sorted(fn for fn, n in partial.items() if n)
                check(not spilled, f"ptxas {name}: {len(partial)} partial "
                      f"instances ({sum('_mma_' in fn for fn in partial)} "
                      f"tensor-core), {len(spilled)} spill" +
                      (f": {spilled}" if spilled else ""))
            for fn, n in diag.items():
                print(f"ptxas {name}: diagnostic instance (clock64 sections) "
                      f"spills {n} bytes", flush=True)
        _build.load(name)
    spilled = sorted(fn for fn, n in merges.items() if n)
    check(len(merges) == 8 and not spilled, f"ptxas: {len(merges)} merge "
          f"instances (2 kernels x 4 carry widths), {len(spilled)} spill"
          + (f": {spilled}" if spilled else ""))
    partial_instances()
    merge_instances()
    ceiling_instances()


def ceiling_instances() -> None:
    """The matmul ceiling's kernels: no spill in ptxas's log, and each
    wgmma instance's resources from cudaFuncGetAttributes, with its tile
    held to the wrapper's plan."""
    from avenir_tpu_torch.ops import _build
    from avenir_tpu_torch.ops import matmul_ceiling as mc
    from avenir_tpu_torch.tools.ceiling_ab import ptxas_spills

    log = _build.build_dir() / "matmul_ceiling.log"
    spills = ptxas_spills(log.read_text()) if log.exists() else {}
    bad = []
    for d in (64, 128):
        info = mc.ceiling_info(d)
        print(f"matmul_ceiling wgmma instance D<={d}: {info['registers']} "
              f"registers at launch, {info['local_bytes']} local bytes, "
              f"{info['smem_bytes']} shared bytes, {info['threads']} "
              f"threads, {info['blocks_per_sm']} block/SM, {info['bm']} "
              f"queries x {info['bn']} train rows, {info['stages']} stages",
              flush=True)
        if info["local_bytes"] or (info["bm"], info["bn"]) != (mc.BM, mc.BN):
            bad.append(d)
    check(not bad and not any(spills.values()),
          f"matmul_ceiling: {len(spills)} kernels in ptxas's log, spill "
          f"bytes {sum(spills.values())}; the wgmma instances' local bytes "
          f"0 and tiles equal to the plan" + (f"; not at D<={bad}" if bad
                                               else ""))


def partial_instances() -> None:
    """Every partial instance's registers and local (spilled) bytes from
    cudaFuncGetAttributes, and its blocks per SM at D=6 and D=128; fails
    on any local bytes. Prints the K=8 instances, which the job runs."""
    from avenir_tpu_torch.ops import knn_kernels as kk

    spilled, plans = [], []
    n = 0
    # the CUDA-core instances (both metrics), then the tensor-core ones
    # (euclidean bfloat16)
    forms = [(metric, False, kk._stage_plan) for metric in
             ("manhattan", "euclidean")] + [("euclidean", True,
                                            kk._mma_stage_plan)]
    for mode in kk.MODES:
        for metric, mma, stage_plan in forms:
            what = f"{mode} {metric}" + (" bfloat16 tensor-core" if mma
                                         else "")
            for k in (8, 16, 32, 64):
                per_sm = {}
                for d in (6, 128, kk.MAX_D):
                    per_sm[d], regs, local, *plan = kk.partial_info(
                        k, metric == "euclidean", mode, d, bf16=mma)
                    if tuple(plan) != stage_plan(d, k):
                        plans.append(f"{what}/K={k}/D={d}")
                n += 1
                if local:
                    spilled.append(f"{what}/K={k}")
                if k == 8 or mma:
                    print(f"partial K={k} {what}: {regs} registers, "
                          f"{local} local bytes, blocks/SM {per_sm[6]} at "
                          f"D=6, {per_sm[128]} at D=128, {per_sm[kk.MAX_D]} "
                          f"at D={kk.MAX_D}", flush=True)
    check(not spilled, f"{n} partial instances, {len(spilled)} with local "
          f"(spilled) bytes" + (f": {spilled}" if spilled else ""))
    check(not plans, "the kernels' stage plans (rows, stages, bytes) equal "
          "knn_kernels._stage_plan and _mma_stage_plan"
          + (f"; not {plans}" if plans else ""))


def merge_instances() -> None:
    """Every merge instance's registers, local (spilled) bytes and blocks
    per SM from cudaFuncGetAttributes; fails on any local bytes. The
    merges' layout (knn_merge_layout) at 1 to 65 splits: G the fewest of
    8, 16 and 32 lanes that cover min(splits, 32), blocks of whole groups,
    and MERGE_OWN lists a lane at G=32, the count the CPU model of the
    merge (merge_splits_group_plain) takes."""
    from avenir_tpu_torch.ops import knn_kernels as kk

    spilled = []
    threads = kk.merge_layout(NQ, 1)["threads"]
    for vote in (False, True):
        name = "merge_vote" if vote else "merge_topk"
        for k in (8, 16, 32, 64):
            per_sm, regs, local = kk.merge_info(k, vote)
            print(f"{name} K={k}: {regs} registers, {local} local bytes, "
                  f"{per_sm} blocks/SM of {threads} threads", flush=True)
            if local:
                spilled.append(f"{name}/K={k}")
    check(not spilled, "8 merge instances, "
          f"{len(spilled)} with local (spilled) bytes"
          + (f": {spilled}" if spilled else ""))
    bad = []
    for splits in range(1, 66):
        lay = kk.merge_layout(NQ, splits)
        g = min(c for c in (8, 16, 32) if c >= min(splits, 32))
        if (lay["group"], lay["blocks"], lay["own"]) != (
                g, -(-NQ // (threads // g)),
                kk.MERGE_OWN if g == 32 else 1) or threads % g:
            bad.append(f"{splits}: {lay}")
    check(not bad, f"merge layout at 1..65 splits of {NQ} queries: G the "
          f"fewest of 8/16/32 lanes covering min(splits, 32), "
          f"{threads}-thread blocks of whole groups, {kk.MERGE_OWN} lists a "
          "lane at G=32 as the CPU model takes"
          + (f"; not {bad[:5]}" if bad else ""))


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
    from avenir_tpu_torch.tools import knn_tolerance as tol

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
                    quantum = 2.0 ** -(23 - kk.lane_pack_bits(NT))
                    close = bool(((gd - pd).abs()
                                  <= atol + (rtol + quantum) * pd.abs()).all())
                    recall = tol.recall(gi, pi)
                    ok = close and recall >= 0.99
                    how = f"quantum {quantum:.2e} recall {recall:.5f}"
                else:
                    close = bool(((gd - pd).abs() <= atol + rtol * pd.abs()).all())
                    tied = tol.tied(q, t, gi, pd, mism, metric, rtol, atol)
                    ok = close and tied
                    how = f"rtol {rtol} atol {atol} ties-only {tied}"
                n0 = wrap.launches
                ms = cuda_ms(lambda: wrap(q, t, K, metric), 5)
                plan = _plan(q, t, metric, name)
                row = dict(name=name, metric=metric, d=d, max_abs_err=err,
                           index_mismatch=int(mism.sum()), ms=ms,
                           plain_ms=plain_ms, bound_ms=bound,
                           bound_by=bound_by, library_ms=lib_ms, **plan)
                results.append(row)
                check(ok, f"{name} {metric} D={d}: max|err| {err:.3g} "
                      f"index mismatches {int(mism.sum())} ({how}); "
                      f"{ms:.3f} ms, plain {plain_ms:.1f} ms, "
                      f"bound {bound:.3f} ms ({bound / ms:.1%} of it), "
                      f"cdist+topk {lib_ms:.1f} ms; {_plan_text(plan)}, "
                      f"{wrap.launches - n0} launches timed")
            for fn in ("none", "gaussian"):
                def run(impl=kk.knn_classify_lanes):
                    return impl(q, t, labels, K, 2, d, fn, 30.0, metric)
                got = run()
                torch.cuda.synchronize()
                ref, plain_ms = _timed_once(
                    lambda: run(kk.knn_classify_lanes_plain))
                err = (got - ref).abs().max().item()
                agree = (got.argmax(1) == ref.argmax(1)).float().mean().item()
                n0 = kk.knn_classify_lanes.launches
                ms = cuda_ms(run, 5)
                cbound, cbound_by = bound_ms(metric, d, 0, flops, rate,
                                             extra_bytes=NT * 4 + NQ * 2 * 4)
                plan = _plan(q, t, metric, "knn_classify_lanes")
                # no PyTorch call computes the vote: library_ms is null
                results.append(dict(name="knn_classify_lanes", metric=metric,
                                    d=d, kernel_fn=fn, max_abs_err=err,
                                    argmax_agreement=agree, ms=ms,
                                    plain_ms=plain_ms, bound_ms=cbound,
                                    bound_by=cbound_by, library_ms=None,
                                    **plan))
                # "none" counts neighbours: no floored score may round apart
                limit = 0.0 if fn == "none" else 2.0
                check(err <= limit and agree >= 0.99,
                      f"knn_classify_lanes {metric} D={d} {fn}: max|err| "
                      f"{err:.3g} argmax agreement {agree:.5f}; {ms:.3f} ms, "
                      f"plain {plain_ms:.1f} ms, bound {cbound:.3f} ms "
                      f"({cbound / ms:.1%} of it); {_plan_text(plan)}, "
                      f"{kk.knn_classify_lanes.launches - n0} launches timed")
        results += _check_prepass(q, t, d, flops, rate)
        if d == 6:     # the job's shape
            results += _merge_rows(q, t, labels, "manhattan", "float32",
                                   rate, "job")
        # padded corpus: rows at and past n_valid never enter
        nv = NT - 777
        gd, gi = kk.knn_topk(q, t, K, "manhattan", n_valid=nv)
        pd, pi = kk.knn_topk_plain(q, t, K, "manhattan", n_valid=nv)
        check(bool((gi < nv).all()) and torch.equal(gd, pd),
              f"knn_topk manhattan D={d} n_valid={nv}: padding masked")
    _check_prepass_shapes()
    return results


#: wrapper -> the knn_kernels mode of its partial instance
PLAN_MODES = {"knn_topk": "exact", "knn_topk_lanes": "lanes",
              "knn_topk_packed": "packed", "knn_classify_lanes": "labels"}


def _plan(q, t, metric, name, dtype="float32") -> dict:
    """The launch's blocks per SM, grid and waves (knn_kernels.launch_plan):
    euclidean bfloat16 takes the tensor-core instance's grid."""
    from avenir_tpu_torch.ops import knn_kernels as kk

    plan = kk.launch_plan(q, t, K, metric, PLAN_MODES[name],
                          compute_dtype=dtype)
    return {key: plan[key] for key in ("blocks_per_sm", "grid", "waves")}


def _plan_text(plan) -> str:
    return (f"{plan['blocks_per_sm']} blocks/SM, grid {plan['grid']}, "
            f"{plan['waves']:.2f} waves")


def _merge_reads(part_k, nq, splits, empty):
    """(keys, indices) a serial merge must read from these split lists,
    the bound's bytes (cb9153e's merge_splits, one thread a query): each
    split's keys in order up to and including the first that is not
    below the carry's worst, and the index of each key it inserts. A
    carry of the lists' width is replayed on the card, a slot at a time."""
    import torch

    pk = part_k.view(splits, nq, -1)
    best = torch.full((nq, pk.shape[2]), empty, dtype=torch.int32,
                      device=part_k.device)
    keys = idx = 0
    for s in range(splits):
        live = torch.ones(nq, dtype=torch.bool, device=part_k.device)
        for j in range(pk.shape[2]):
            key = pk[s, :, j]
            ins = live & (key < best[:, -1])
            keys += int(live.sum())
            idx += int(ins.sum())
            merged = torch.sort(torch.cat([best[:, :-1], key[:, None]], 1),
                                dim=1).values
            best = torch.where(ins[:, None], merged, best)
            live = ins
    return keys, idx


def _merge_rows(q, t, labels, metric, dtype, rate, shape):
    """The two merge kernels timed apart from the partial kernel: one
    launch of the wrapper's route leaves the split lists, then
    knn_topk_merge_launch / knn_classify_merge_launch alone on them,
    bit-equal to merge_splits_plain (and _vote) and to the full launch's
    output. Bound: the bytes the merge must move on these lists
    (_merge_reads, and its output). Library: torch.topk over each query's
    splits x K keys (laid out [nq, splits * K] once, outside the timing).
    Beside them the launch floor: an empty kernel on the merges' grid
    (knn_merge_floor_launch), timed as they are on the device alone."""
    import torch

    from avenir_tpu_torch.ops import _build
    from avenir_tpu_torch.ops import knn_kernels as kk

    from avenir_tpu_torch.tools.knn_ab import merge_call

    euclid = metric == "euclidean"
    bf16 = kk._bf16(dtype, metric)
    mma = kk._mma(euclid, bf16)
    (nq, d), stream = q.shape, kk._stream(q.device)
    ops = [None if x is None else x.data_ptr()
           for x in kk._operands(q, t, euclid, bf16, NT)]
    rows = []
    floors = {}
    for name, mode in (("merge_topk", "lanes" if shape == "bench"
                        else "exact"), ("merge_vote", "labels")):
        _, _, splits, per_split = kk._grid(q, K, euclid, mode, NT, bf16=bf16)
        part_k, part_i = kk._partial_buffers(q, K, splits)
        ptrs = (part_k.data_ptr(), part_i.data_ptr())
        if mode == "labels":
            lib = _build.load("knn_classify")
            full = torch.empty((nq, 2), dtype=torch.float32, device=q.device)
            kk._launch(lib, "knn_classify", mma, "knn_classify_lanes", *ops,
                       labels.data_ptr(), nq, d, NT, K, int(euclid), 1, 2,
                       1.0 / d, kk.KERNEL_FNS.index("gaussian"), 30.0, splits,
                       per_split, *ptrs, full.data_ptr(), stream)
            empty, fn = kk.SENTINEL, "gaussian"

            def plain():
                keys = kk.merge_splits_plain(part_k, part_i, nq, splits, K)[0]
                return kk._vote(keys, 1, 2, d, metric, "gaussian", 30.0)
            out_bytes = nq * 2 * 4
        else:
            lib = _build.load("knn_topk")
            full = torch.empty((2, nq, K), dtype=torch.int32, device=q.device)
            bits, _, empty = kk._key_spec(mode, t)
            kk._launch(lib, "knn_topk", mma, f"knn_topk ({mode})", *ops, nq,
                       d, NT, K, int(euclid), kk.MODES[mode], bits, splits,
                       per_split, *ptrs, full[0].data_ptr(),
                       full[1].data_ptr(), stream)
            fn = None

            def plain():
                return torch.stack(kk.merge_splits_plain(part_k, part_i, nq,
                                                         splits, K))
            out_bytes = nq * K * 8
        merge = merge_call(lib, (part_k, part_i, splits), nq, K, mode, metric,
                           d, fn, launches=1)
        out = torch.stack(merge())
        out = out[0] if fn else out
        torch.cuda.synchronize()
        ref, plain_ms = _timed_once(plain)
        if mode == "labels":
            err = (out - ref).abs().max().item()
        else:
            err = (out.long() - ref.long()).abs().max().item()
        ok = torch.equal(out, full) and torch.equal(out, ref)
        ms = cuda_ms(merge, 20)
        dev_ms, prof_ms = device_alone(merge, f"{name}_kernel")
        if splits not in floors:
            floors[splits] = _merge_floor(nq, splits, shape, stream)
        floor_ms, floor_prof = floors[splits]
        keys, idx = _merge_reads(part_k, nq, splits, empty)
        bound = (4 * (keys + idx) + out_bytes) / rate * 1e3
        lib_ms = None
        if mode != "labels":
            cand = part_k.view(splits, nq, -1).permute(1, 0, 2).reshape(nq, -1)
            lib_ms = cuda_ms(lambda: torch.topk(cand, K, dim=1, largest=False),
                             20)
        lay = kk.merge_layout(nq, splits)
        group, blocks = lay["group"], lay["blocks"]
        rows.append(dict(name=name, metric=metric, d=d, dtype=dtype,
                         shape=shape, splits=splits, group=group,
                         blocks=blocks, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                         library_ms=lib_ms, keys_read=keys,
                         device_ms=dev_ms, profiler_ms=prof_ms,
                         floor_ms=floor_ms, floor_profiler_ms=floor_prof))
        share = bound / prof_ms if prof_ms else None
        check(ok, f"{name} ({mode} lists of the {shape} shape, {metric} "
              f"{dtype} D={d}, {splits} splits, G={group}, {blocks} blocks): "
              f"bit-equal to the full launch's and the plain merge's, "
              f"max|err| {err:.3g}; {ms:.4f} ms, plain {plain_ms:.1f} ms, "
              f"bound {bound:.5f} ms (bytes: {keys} keys and {idx} indices "
              f"read of {part_k.numel()}, {bound / ms:.1%} of a call"
              + ("" if share is None else f", {share:.1%} of the device "
                 "time") + ")"
              + ("" if lib_ms is None else f", torch.topk {lib_ms:.4f} ms")
              + f"; {_device_text(dev_ms, prof_ms)}")
    return rows


def _merge_floor(nq, splits, shape, stream):
    """(ms, profiler ms) of an empty kernel on the merges' grid for nq
    queries' splits lists, on the device alone (device_alone), printed."""
    from avenir_tpu_torch.ops import _build
    from avenir_tpu_torch.ops import knn_kernels as kk

    lib = _build.load("knn_topk")

    def launch():
        kk._raise_on(lib.knn_merge_floor_launch(nq, splits, stream),
                     "knn_merge_floor")
    ms, prof_ms = device_alone(launch, "merge_floor_kernel")
    lay = kk.merge_layout(nq, splits)
    print(f"merge launch floor (an empty kernel on the merges' grid at the "
          f"{shape} shape: {nq} queries, {splits} splits, G={lay['group']}, "
          f"{lay['blocks']} blocks): {_device_text(ms, prof_ms)}",
          flush=True)
    return ms, prof_ms


def _check_prepass(q, t, d, flops, rate):
    """knn_prepass against its plain version, bit for bit, in both forms:
    norms alone (float32) and norms with bfloat16 copies."""
    import torch

    from avenir_tpu_torch.ops import _build
    from avenir_tpu_torch.ops import knn_kernels as kk

    rows = []
    qt = torch.cat([q, t])
    lib = _build.load("knn_prepass")
    for dtype in kk.COMPUTE_DTYPES:
        bf16 = dtype == "bfloat16"
        got = kk.knn_prepass(q, t, bf16)
        torch.cuda.synchronize()
        ref, plain_ms = _timed_once(lambda: kk.knn_prepass_plain(q, t, bf16))
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        n0 = kk.knn_prepass.launches
        ms = cuda_ms(lambda: kk.knn_prepass(q, t, bf16), 20)
        n = NQ + NT
        nbytes = n * d * 4 + n * 4 + (n * d * 4 if bf16 else 0)
        ops_ms, bytes_ms = 2 * n * d / flops * 1e3, nbytes / rate * 1e3
        bound, bound_by = ((ops_ms, "operations") if ops_ms >= bytes_ms
                           else (bytes_ms, "bytes"))
        # the norms alone are one PyTorch call; nothing computes the pair
        lib_ms = None if bf16 else cuda_ms(
            lambda: torch.einsum("ij,ij->i", qt, qt), 20)
        out = [torch.empty(n, dtype=torch.float32, device=q.device) for n
               in (NQ, NT)] + ([torch.empty_like(q), torch.empty_like(t)]
                               if bf16 else [None, None])
        ptrs = [None if x is None else x.data_ptr() for x in out]

        def launch():
            kk._raise_on(lib.knn_prepass_launch(
                q.data_ptr(), NQ, t.data_ptr(), NT, d, int(bf16), *ptrs,
                kk._stream(q.device)), "knn_prepass")
        dev_ms, prof_ms = device_alone(launch, "prepass_kernel")
        rows.append(dict(name="knn_prepass", metric="euclidean", d=d,
                         dtype=dtype, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                         library_ms=lib_ms, device_ms=dev_ms,
                         profiler_ms=prof_ms))
        check(same, f"knn_prepass {dtype} D={d}: bit-equal to the plain "
              f"version {same} (max|err| {err:.3g}); {ms:.4f} ms, plain "
              f"{plain_ms:.1f} ms, bound {bound:.4f} ms ({bound_by}, "
              f"{bound / ms:.1%} of it)"
              + ("" if lib_ms is None else f", einsum {lib_ms:.4f} ms")
              + f"; {kk.knn_prepass.launches - n0} launches timed; "
              + _device_text(dev_ms, prof_ms))
    return rows


def _check_prepass_shapes():
    """knn_prepass bit-equal to its plain version where its blocks are
    ragged, its rows span several shared-memory chunks, and t starts one
    row into its storage (off a 16-byte boundary unless 4 divides D)."""
    import torch

    from avenir_tpu_torch.ops import knn_kernels as kk

    gen = torch.Generator(device=DEVICE).manual_seed(1235)
    bad = []
    for d in (1, 3, 7, 128, 129, 300, kk.MAX_D):
        q = torch.randn((37, d), generator=gen, device=DEVICE)
        t = torch.randn((1002, d), generator=gen, device=DEVICE)[1:]
        for bf16 in (False, True):
            got = kk.knn_prepass(q, t, bf16)
            ref = kk.knn_prepass_plain(q, t, bf16)
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                bad.append((d, bf16))
    check(not bad, "knn_prepass at 37 x 1001 rows, D 1..MAX_D, t one row "
          "into its storage: bit-equal to the plain version"
          + (f"; not at (D, bf16) {bad}" if bad else ""))


def _wrappers():
    from avenir_tpu_torch.ops import knn_kernels as kk
    from avenir_tpu_torch.ops import matmul_ceiling as mc

    return kk.COUNTED_WRAPPERS + mc.KERNEL_WRAPPERS


def _reset_launches() -> None:
    for fn in _wrappers():
        fn.launches = 0


def _launch_counts():
    return {fn.__name__: fn.launches for fn in _wrappers()}


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
             ("fused", {"nen.device.fused.vote": "true"}, kk.knn_classify_lanes),
             ("class_cond", {"nen.class.condtion.weighted": "true"},
              kk.knn_topk))
    launches, preds, secs_by_mode = {}, {}, {}   # launches: summed over runs
    for mode, extra, wrapper in modes:
        out = str(work / f"out_{mode}.txt")
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_job("nearestNeighbor", {**base, **extra}, [train, test], out,
                      device=DEVICE)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _launch_counts()
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        acc = res.counters["Validation:Accuracy"]
        lines = Path(out).read_text().splitlines()
        preds[mode] = [ln.split(",")[1] for ln in lines]
        secs_by_mode[mode] = round(secs, 3)
        check(wrapper.launches >= 1 and acc > 60 and len(lines) == NQ,
              f"nearestNeighbor {mode}: {secs:.2f}s, {wrapper.__name__} "
              f"launched {wrapper.launches}x, launches {counts}, "
              f"Validation:Accuracy {acc}, {len(lines)} rows")
    for mode in ("packed", "fused"):
        agree = sum(a == b for a, b in zip(preds["default"], preds[mode])) / NQ
        check(agree >= 0.99, f"default vs {mode}: predictions agree {agree:.5f}")
    print(f"nearestNeighbor seconds by mode ({NT} x {NQ}, {CARD}): "
          f"{json.dumps(secs_by_mode)}", flush=True)
    for mode, extra in (("default", {}),
                        ("class_cond", {"nen.class.condtion.weighted": "true"})):
        cpu_out = str(work / f"out_cpu_{mode}.txt")
        run_job("nearestNeighbor", {**base, **extra}, [train, small], cpu_out,
                device="cpu")
        gpu_head = Path(work / f"out_{mode}.txt").read_text().splitlines()[
            :CHECK_ROWS]
        cpu_lines = Path(cpu_out).read_text().splitlines()
        check(gpu_head == cpu_lines,
              f"{mode} run's first {CHECK_ROWS} lines equal the CPU run's")
    shutil.rmtree(work)
    return launches


# ------------------------------------------------------------------ phase 4
def phase_kernel_check():
    """Every kernel_check case on the card; its launch counts."""
    import torch

    from avenir_tpu_torch.tools import kernel_check

    _reset_launches()
    t0 = time.perf_counter()
    results = kernel_check.run(DEVICE)
    torch.cuda.synchronize()
    counts = _launch_counts()
    failed = [name for name, faults in results.items() if faults]
    check(not failed, f"kernel_check: {len(results) - len(failed)} of "
          f"{len(results)} cases pass in {time.perf_counter() - t0:.1f}s, "
          f"launches {counts}" + (f"; failed {failed}" if failed else ""))
    check(counts["knn_partial_mma"] >= 1, "kernel_check: its bfloat16 "
          "euclidean cases took the tensor-core form "
          f"({counts['knn_partial_mma']} launches)")
    return counts


# ------------------------------------------------------------------ phase 5
def phase_packed_bf16(flops: float, rate: float, bf16_flops: float,
                      phase2_rows):
    """The packed kernel and every bfloat16 variant against their plain
    versions; plain versions are timed once, on the compared call."""
    import torch

    from avenir_tpu_torch.ops import knn_kernels as kk
    from avenir_tpu_torch.tools import knn_tolerance as tol

    gen = torch.Generator(device=DEVICE).manual_seed(4321)
    topk = (("knn_topk", 0.0), ("knn_topk_packed", tol.PACKED_QUANTUM),
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
            n_mma = kk.knn_partial_mma.launches
            gd, gi = wrap(q, t, K, metric, compute_dtype=dtype)
            torch.cuda.synchronize()
            # euclidean bfloat16 takes the tensor-core form, nothing else
            mma = kk.knn_partial_mma.launches - n_mma
            form = int(bf16 and metric == "euclidean")
            (pd, pi), plain_ms = _timed_once(
                lambda: plain(q, t, K, metric, compute_dtype=dtype))
            err = (gd - pd).abs().max().item()
            mism = gi != pi
            rtol = 1e-4 + dict(topk)[name]
            floor = tol.cancellation_floor(q, t) if bf16 else 0.0
            close = bool(tol.within(gd, pd, d, rtol, 1e-5, floor).all())
            if metric == "manhattan":
                ok = torch.equal(gd, pd) and torch.equal(gi, pi)
                how = "bit-equal"
            elif name == "knn_topk_lanes":
                recall = tol.recall(gi, pi)
                ok = close and recall >= 0.99
                how = f"rtol {rtol:.3g} floor {floor:.2g} recall {recall:.5f}"
            else:
                tied = tol.tied(q, t, gi, pd, mism, metric, rtol, 1e-5, bf16,
                                floor)
                ok = close and tied
                how = (f"rtol {rtol:.3g} atol 1e-05 floor {floor:.2g} "
                       f"ties-only {tied}")
            ok = ok and mma == form
            ms = cuda_ms(lambda: wrap(q, t, K, metric, compute_dtype=dtype), 5)
            bound, bound_by = bound_ms(metric, d, K, flops, rate,
                                       bf16_flops=bf16_flops if bf16 else 0.0)
            lib = next(r["library_ms"] for r in phase2_rows
                       if r["name"] == "knn_topk" and r["metric"] == metric
                       and r["d"] == d)
            plan = _plan(q, t, metric, name, dtype)
            results.append(dict(name=name, metric=metric, d=d, dtype=dtype,
                                max_abs_err=err,
                                index_mismatch=int(mism.sum()), ms=ms,
                                plain_ms=plain_ms, bound_ms=bound,
                                bound_by=bound_by, library_ms=lib,
                                mma_launches=mma, **plan))
            check(ok, f"{name} {metric} {dtype} D={d}: max|err| {err:.3g} "
                  f"index mismatches {int(mism.sum())} ({how}); "
                  f"{mma} tensor-core launch{'es' if mma != 1 else ''}; "
                  f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound:.3f} ms "
                  f"({bound_by}, {bound / ms:.1%} of it), cdist+topk "
                  f"{lib:.1f} ms; {_plan_text(plan)}")

        def run(impl=kk.knn_classify_lanes):
            return impl(q, t, labels, K, 2, d, "gaussian", 30.0, "euclidean",
                        compute_dtype="bfloat16")
        n_mma = kk.knn_partial_mma.launches
        got = run()
        torch.cuda.synchronize()
        mma = kk.knn_partial_mma.launches - n_mma
        ref, plain_ms = _timed_once(lambda: run(kk.knn_classify_lanes_plain))
        err = (got - ref).abs().max().item()
        agree = (got.argmax(1) == ref.argmax(1)).float().mean().item()
        # beyond a floored-score step (2.0), only a tie at the k-th
        # neighbour may change a vote
        swapped = torch.nonzero(((got - ref).abs() > 2.0).any(1)).flatten()
        tied = tol.boundary_tied(q, t, swapped, K, "euclidean", "bfloat16",
                                 1e-4, tol.cancellation_floor(q, t))
        ms = cuda_ms(run, 5)
        bound, bound_by = bound_ms("euclidean", d, 0, flops, rate,
                                   extra_bytes=NT * 4 + NQ * 2 * 4,
                                   bf16_flops=bf16_flops)
        plan = _plan(q, t, "euclidean", "knn_classify_lanes", "bfloat16")
        results.append(dict(name="knn_classify_lanes", metric="euclidean",
                            d=d, dtype="bfloat16", kernel_fn="gaussian",
                            max_abs_err=err, argmax_agreement=agree, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound,
                            bound_by=bound_by, library_ms=None,
                            mma_launches=mma, **plan))
        check(tied and agree >= 0.99 and mma == 1,
              f"knn_classify_lanes euclidean bfloat16 D={d} gaussian: "
              f"max|err| {err:.3g}, {swapped.numel()} queries past 2.0 "
              f"(k-th neighbour tied: {tied}), argmax agreement "
              f"{agree:.5f}; {mma} tensor-core launch; {ms:.3f} ms, "
              f"plain {plain_ms:.1f} ms, bound {bound:.3f} ms ({bound_by}, "
              f"{bound / ms:.1%} of it); {_plan_text(plan)}")
        shares = kk.mma_sections(q, t)
        torch.cuda.synchronize()
        print(f"tensor-core sections D={d} (K=8 lane keys, share of warp "
              f"cycles): " + ", ".join(f"{name} {v:.1%}"
                                       for name, v in shares.items()),
              flush=True)
        results.append(dict(name="mma_sections", d=d, shares=shares))
        if d == 128:   # the bench's shape
            results += _merge_rows(q, t, labels, "euclidean", "bfloat16",
                                   rate, "bench")
    _check_mma_shapes()
    _check_merge_ragged()
    _partial_nan_keys()
    return results


#: keys on the empty slots' edges, and an exact key with the sign bit set
EDGE_KEYS = (0, 1, 0x7F6FFFFF, 0x7F700000, 0x7F700001, 0x7F7FFFFF,
             0x7F800000, 0x7F800001, -2 ** 31)


def _ragged_lists(rng, splits, nq, kw, mode):
    """Split lists [splits][nq][kw] as the partial kernel leaves them, on
    the card: each sorted by (key, column), columns rising by split, a key
    >= the mode's empty key only as (empty, -1) at its end, queries 0 and
    nq // 2 all empty. Keys: exact, a mix of a few small values (equal
    keys across splits, within a lane's and across lanes), EDGE_KEYS and
    random int32 (half with the sign bit set); lanes and labels, bits(d)
    with the low bits masked and a chunk id or label (C=2) in them, d from
    a few values (ties, exact zeros), some of which reach SENTINEL; mode
    "nan": label keys with, among those d, a NaN with the sign bit set
    (what a manhattan sum over a NaN row may give), which sorts first."""
    import numpy as np
    import torch

    from avenir_tpu_torch.ops import knn_kernels as kk

    shape = (splits, nq, kw)
    if mode == "exact":
        pick = rng.integers(0, 3, shape)
        key = np.where(pick == 0, rng.integers(0, 6, shape),
                       np.where(pick == 1, rng.choice(EDGE_KEYS, shape),
                                rng.integers(-2 ** 31, 2 ** 31, shape)))
        empty = kk.INF_BITS
    else:
        below = np.int32(0x7F6FF000).view(np.float32)   # just under it
        nan = np.uint32(0xFFC00000).view(np.float32)
        dist = rng.choice(np.float32([0.0, 0.004, 0.25, 1.0, 3.0, below,
                                      3.2e38, float("inf")]
                                     + ([nan] if mode == "nan" else [])),
                          shape)
        mask = 0xFFF if mode == "lanes" else 1
        low = rng.integers(0, mask + 1, shape)
        key = (dist.view(np.int32).astype(np.int64) & ~mask) | low
        empty = kk.SENTINEL
    col = rng.integers(0, 1000, shape) + 1000 * np.arange(splits)[:, None,
                                                                    None]
    order = np.lexsort((col, key), axis=-1)
    key = np.take_along_axis(key, order, -1)
    col = np.take_along_axis(col, order, -1)
    gone = key >= empty
    gone[:, [0, nq // 2]] = True
    key[gone], col[gone] = empty, -1
    return (torch.from_numpy(key.astype(np.int32).ravel()).to(DEVICE),
            torch.from_numpy(col.astype(np.int32).ravel()).to(DEVICE))


def _same(a, b, nan_bits: bool = True) -> bool:
    """a and b bit for bit; without nan_bits a NaN only where the other
    has one (the card's NaN and the plain version's may differ in sign and
    payload)."""
    import torch

    if a.is_floating_point():
        if not nan_bits:
            if not torch.equal(a.isnan(), b.isnan()):
                return False
            a, b = a.nan_to_num(0.0), b.nan_to_num(0.0)
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _check_merge_ragged() -> None:
    """Both merge kernels alone (their C entries) on ragged lists
    (_ragged_lists): splits 1, 7, 33, 40 and 65 (one lane owning one,
    two and three splits, and the batches past 64), every carry width
    with k at and below it; the top-k merge on exact and lane lists
    against merge_splits_plain, the vote on label lists (C=2, both
    metrics, every kernel function, gaussian at 30 and at 0, which
    scores NaN on a zero distance) and on label lists with sign-bit NaN
    keys (both metrics, every kernel function: a NaN distance scores NaN
    but under none, on the card as in _vote) against _vote of those, each
    bit for bit (a NaN where the plain version has one) and bit-equal on
    a rerun."""
    import numpy as np
    import torch

    from avenir_tpu_torch.ops import _build
    from avenir_tpu_torch.ops import knn_kernels as kk
    from avenir_tpu_torch.tools.knn_ab import merge_call

    rng = np.random.default_rng(8)
    nq, n, bad = 300, 0, []
    topk, vote = _build.load("knn_topk"), _build.load("knn_classify")
    scorings = [(metric, fn, param) for metric in ("manhattan", "euclidean")
                for fn, param in [(fn, 30.0) for fn in kk.KERNEL_FNS]
                + [("gaussian", 0.0)]]
    votes = {"labels": scorings, "nan": scorings}
    nan_votes = set()    # the NaN-key scorings whose vote had a NaN
    for splits in (1, 7, 33, 40, 65):
        for k in (5, 8, 13, 16, 32, 50, 64):
            kw = kk._carry_width(k)
            for mode in ("exact", "lanes", "labels", "nan"):
                lists = (*_ragged_lists(rng, splits, nq, kw, mode), splits)
                ref_k, ref_i = kk.merge_splits_plain(lists[0], lists[1], nq,
                                                     splits, k)
                cases = []       # (what, two runs, the plain version's)
                if mode not in votes:
                    cases.append((mode, [merge_call(
                        topk, lists, nq, k, mode, "-", 6, launches=1)()
                        for _ in range(2)], [ref_k, ref_i]))
                for metric, fn, param in votes.get(mode, ()):
                    cases.append((f"{mode} {metric} {fn}({param:g})", [
                        merge_call(vote, lists, nq, k, "labels", metric, 6,
                                   fn, launches=1, kernel_param=param)()
                        for _ in range(2)], [kk._vote(
                            ref_k, 1, 2, 6, metric, fn, param)]))
                torch.cuda.synchronize()
                for what, runs, ref in cases:
                    n += 1
                    if not all(_same(a, b) and _same(a, c, nan_bits=False)
                               for a, b, c in zip(runs[0], runs[1], ref)):
                        bad.append(f"splits={splits}/k={k}/{what}")
                    if mode == "nan" and bool(runs[0][0].isnan().any()):
                        nan_votes.add(what)
    check(not bad, f"merge kernels on ragged lists ({nq} queries, two all "
          f"empty; splits 1/7/33/40/65, k 5..64, exact, lane and label "
          f"keys with ties, sign bits and keys at SENTINEL and INF_BITS; "
          f"votes with gaussian(0) and sign-bit NaN keys under every "
          f"kernel function and both metrics): {n - len(bad)} "
          f"of {n} bit-equal to merge_splits_plain / _vote and on a rerun"
          + (f"; not {bad[:10]}" if bad else ""))
    # a NaN key scores NaN under every kernel function but none
    want = {f"nan {metric} {fn}({param:g})" for metric, fn, param in scorings
            if fn != "none"}
    check(want <= nan_votes, f"votes on sign-bit NaN keys: NaN under "
          f"{len(nan_votes)} scorings, every one but none's of "
          f"{sorted(want)}" + ("" if want <= nan_votes else
                               f"; missing {sorted(want - nan_votes)}"))


def _partial_nan_keys() -> None:
    """Asks whether the partial kernel can make a key that is a NaN with
    the sign bit set, the one kind of NaN key that sorts before every
    distance (a positive NaN key is at or above the empty key: an empty
    slot). Queries and train rows hold NaN and sign-bit NaN features
    (a missing value parses to NaN); for each mode, metric and dtype the
    count of final keys with the sign bit and an all-ones exponent (a
    negative NaN, or -inf where the low bits were masked) is printed, and
    the count of keys at or above the empty key. A question, not a check:
    the answer is what PERF.md records."""
    import numpy as np
    import torch

    from avenir_tpu_torch.ops import knn_kernels as kk

    rng = np.random.default_rng(9)
    q = rng.random((256, 6), dtype=np.float32)
    t = rng.random((4096, 6), dtype=np.float32)
    nan, neg_nan = (np.uint32(b).view(np.float32)
                    for b in (0x7FC00000, 0xFFC00000))
    q[::4, 0], q[1::4, 2] = neg_nan, nan
    t[::3, 1], t[1::3, 5] = neg_nan, nan
    qd, td = torch.from_numpy(q).to(DEVICE), torch.from_numpy(t).to(DEVICE)
    found = {}
    for mode in ("exact", "lanes"):
        for metric in ("manhattan", "euclidean"):
            for dtype in ("float32", "bfloat16"):
                bf16 = kk._bf16(dtype, metric)
                if dtype == "bfloat16" and not bf16:
                    continue
                key, _ = kk._topk_keys(mode, qd, td, K, metric == "euclidean",
                                       bf16, td.shape[0])
                empty = kk._key_spec(mode, td)[2]
                found[f"{mode}/{metric}/{dtype}"] = (
                    int(((key >> 23) & 0x1FF).eq(0x1FF).sum()),
                    int((key >= empty).sum()))
    torch.cuda.synchronize()
    print(f"partial kernel on NaN and sign-bit NaN features ({q.shape[0]} x "
          f"{t.shape[0]}, k={K}, {K * q.shape[0]} keys each): sign-bit NaN "
          f"or -inf keys, keys at or above the empty key: "
          f"{json.dumps(found)}; a sign-bit NaN key "
          + ("was made" if any(v[0] for v in found.values())
             else "was never made"), flush=True)


def _check_mma_shapes() -> None:
    """The tensor-core form at every carry width and mode where its
    blocks, tiles and k-steps are ragged: D from 1 to MAX_D, 300 queries,
    3000 train rows of which 2900 valid; each launch counted on
    knn_partial_mma and within bf16_agrees of the plain version."""
    import torch

    from avenir_tpu_torch.ops import knn_kernels as kk
    from avenir_tpu_torch.tools import knn_tolerance as tol

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    nv, bad, n = 2900, [], 0
    for d in (1, 6, 37, 128, 129, 300, kk.MAX_D):
        q = torch.randn((300, d), generator=gen, device=DEVICE)
        t = torch.randn((3000, d), generator=gen, device=DEVICE)
        labels = torch.randint(0, 3, (3000,), generator=gen, device=DEVICE,
                               dtype=torch.int32)
        for k in (5, 16, 32, 64):
            for mode in ("exact", "lanes", "packed", "labels"):
                n0 = kk.knn_partial_mma.launches
                if mode == "labels":
                    args = (q, t, labels, k, 3, None, "gaussian", 30.0,
                            "euclidean", nv)
                    new = [kk.knn_classify_lanes(*args,
                                                 compute_dtype="bfloat16")]
                    old = [kk.knn_classify_lanes_plain(
                        *args, compute_dtype="bfloat16")]
                else:
                    new = list(kk._topk_keys(mode, q, t, k, True, True, nv))
                    _, mask, empty = kk._key_spec(mode, t)
                    old = list(kk._select_plain(q, t, k, "euclidean", nv,
                                                mode, mask, empty, True))
                torch.cuda.synchronize()
                why = tol.bf16_agrees(mode, q, t, k, old, new, nv)
                launched = kk.knn_partial_mma.launches - n0
                n += 1
                if why or launched != 1:
                    bad.append(f"D={d}/k={k}/{mode}: {why or launched}")
    check(not bad, f"tensor-core form at 300 x 3000 rows (2900 valid), D "
          f"1..{kk.MAX_D}, k 5/16/32/64, 4 modes: {n - len(bad)} of {n} "
          f"within bf16_agrees of the plain version, one launch each"
          + (f"; not {bad}" if bad else ""))


def phase_sweep():
    """The KNN sweep at its full width; its launch counts."""
    import torch

    from avenir_tpu_torch.tools import knn_sweep

    _reset_launches()
    t0 = time.perf_counter()
    knn_sweep.run(device=DEVICE)
    torch.cuda.synchronize()
    counts = _launch_counts()
    check(counts["knn_partial_mma"] >= 1,
          f"knn_sweep: {time.perf_counter() - t0:.1f}s, launches {counts}; "
          f"its bfloat16 calls took the tensor-core form")
    return counts


# ------------------------------------------------------------------ phase 6
def phase_naive_bayes():
    """bayesianDistr and bayesianPredictor on the card, each against the
    same job with device="cpu"."""
    import torch

    from avenir_tpu_torch.data import churn_schema, generate_churn
    from avenir_tpu_torch.runner import run_job

    work = ROOT / "build" / "chip_smoke_nb"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    schema = str(work / "churn.json")
    churn_schema().save(schema)
    train, test = work / "train.csv", work / "test.csv"
    t0 = time.perf_counter()
    train.write_text(generate_churn(NB_TRAIN_ROWS, seed=201, as_csv=True))
    test.write_text(generate_churn(NB_TEST_ROWS, seed=202, as_csv=True))
    blocks = -(-train.stat().st_size // (4 << 20))
    print(f"churn CSVs: {NB_TRAIN_ROWS} train rows ({blocks} blocks of 4 MB), "
          f"{NB_TEST_ROWS} test rows, written in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    def timed(name, props, inputs, out, device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_job(name, props, inputs, str(out), device=device)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    distr = {"bad.feature.schema.file.path": schema,
             "bad.stream.block.size.mb": "4"}
    models, secs = {}, {}
    for dev in (DEVICE, "cpu"):
        models[dev] = work / f"model_{dev}.csv"
        res, secs[dev] = timed("bayesianDistr", distr, [str(train)],
                               models[dev], dev)
        check(res.counters["Distribution Data:Records"] == NB_TRAIN_ROWS,
              f"bayesianDistr {dev}: {secs[dev]:.2f}s, {res.counters}")
    same = all((work / f"model_{DEVICE}.csv{ext}").read_bytes()
               == (work / f"model_cpu.csv{ext}").read_bytes()
               for ext in ("", ".stamp.json"))
    check(same, "bayesianDistr: model file and stamp byte-identical to the "
          "CPU run's")
    predict = {"bap.feature.schema.file.path": schema,
               "bap.bayesian.model.file.path": str(models[DEVICE]),
               "bap.validation.mode": "true",
               "bap.positive.class.value": "closed",
               "bap.predict.class.cost": "2,1",
               "bap.predict.class": "open,closed"}
    rows, psecs = {}, {}
    for dev in (DEVICE, "cpu"):
        out = work / f"pred_{dev}.txt"
        res, psecs[dev] = timed("bayesianPredictor", predict, [str(test)],
                                out, dev)
        rows[dev] = [ln.rsplit(",", 2)[1:] for ln in
                     out.read_text().splitlines()]
        acc = res.counters["Validation:Accuracy"]
        check(acc > 70 and len(rows[dev]) == NB_TEST_ROWS,
              f"bayesianPredictor {dev}: {psecs[dev]:.2f}s, "
              f"Validation:Accuracy {acc}, {len(rows[dev])} rows, "
              f"{res.counters}")
    classes = sum(a[0] == b[0] for a, b in zip(rows[DEVICE], rows["cpu"]))
    pct = max(abs(int(a[1]) - int(b[1]))
              for a, b in zip(rows[DEVICE], rows["cpu"]))
    check(classes == NB_TEST_ROWS and pct <= 1,
          f"bayesianPredictor: class equal to the CPU run's on {classes} of "
          f"{NB_TEST_ROWS} rows, percent within {pct}")
    shutil.rmtree(work)
    return {"distr_s": secs[DEVICE], "distr_cpu_s": secs["cpu"],
            "predict_s": psecs[DEVICE], "predict_cpu_s": psecs["cpu"]}


# ------------------------------------------------------------------ phase 8
def phase_pipeline():
    """`knn_pipeline` (the five stages of resource/knn.sh) on the card,
    stage by stage through `Pipeline.run(only=)`, then its CPU twin on
    the same CSVs: every file byte-identical. Returns the card run's
    launch counts."""
    import torch

    from avenir_tpu_torch.data import elearn_schema, generate_elearn
    from avenir_tpu_torch.ops import knn_kernels as kk
    from avenir_tpu_torch.pipelines import knn_pipeline

    work = ROOT / "build" / "chip_smoke_pipe"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    schema = str(work / "elearn.json")
    elearn_schema().save(schema)
    train, test = str(work / "train.csv"), str(work / "test.csv")
    Path(train).write_text(generate_elearn(PIPE_NT, seed=301, as_csv=True))
    Path(test).write_text(generate_elearn(PIPE_NQ, seed=302, as_csv=True))
    props = {"nen.top.match.count": str(K), "nen.validation.mode": "true",
             "nen.class.condtion.weighted": "true"}
    pairs = PIPE_NT * PIPE_NQ
    counts = None
    for dev in (DEVICE, "cpu"):
        pipe = knn_pipeline(props, train, test, str(work / dev),
                            schema_path=schema, device=dev)
        secs = {}
        if dev == DEVICE:
            _reset_launches()
        for st in pipe.stages:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.run(only=st.name)
            torch.cuda.synchronize()
            secs[st.name] = round(time.perf_counter() - t0, 3)
        if dev == DEVICE:
            counts = _launch_counts()
        res = pipe.results
        sim = res["similarity"].counters["Similarity:Pairs"]
        join = res["join"].counters["Join:Pairs"]
        acc = res["nearestNeighbor"].counters["Validation:Accuracy"]
        check(sim == join == pairs and acc > 60
              and (dev != DEVICE or kk.knn_topk.launches >= 1),
              f"knn_pipeline {dev} ({PIPE_NT} x {PIPE_NQ}, {CARD}): "
              f"{sum(secs.values()):.2f}s, stage seconds {json.dumps(secs)}, "
              f"Similarity:Pairs {sim}, Join:Pairs {join}, "
              f"Validation:Accuracy {acc}"
              + (f", launches {counts}" if dev == DEVICE else ""))
    same = [f for f in PIPE_FILES if (work / DEVICE / f).read_bytes()
            == (work / "cpu" / f).read_bytes()]
    check(len(same) == len(PIPE_FILES), f"knn_pipeline: {same} byte-identical "
          f"to the CPU run's, of {list(PIPE_FILES)}")
    shutil.rmtree(work)
    return counts


# ------------------------------------------------------------------ phase 7
def phase_ceiling(rate: float, bf16_flops: float):
    """matmul_ceiling against its plain version at the bench's shape."""
    import numpy as np
    import torch

    from avenir_tpu_torch.ops import matmul_ceiling as mc

    rng = np.random.default_rng(3)
    q, t = (torch.from_numpy(rng.normal(size=(n, CEIL_D)).astype(np.float32))
            .to(DEVICE) for n in (CEIL_NQ, CEIL_NT))
    mc.matmul_ceiling_plain(q[:128], t[:128])       # warm the library
    got = mc.matmul_ceiling(q, t)
    again = mc.matmul_ceiling(q, t)
    torch.cuda.synchronize()
    ref, plain_ms = _timed_once(lambda: mc.matmul_ceiling_plain(q, t))
    tol = 2.0 ** -16 * mc.row_abs_sums_plain(q, t)
    err = (got - ref).abs()
    ms = cuda_ms(lambda: mc.matmul_ceiling(q, t), 20)
    qb, tb = q.to(torch.bfloat16), t.to(torch.bfloat16)
    lib_ms = cuda_ms(lambda: torch.matmul(qb, tb.T).float().sum(1, keepdim=True),
                     5)
    flops = 2.0 * CEIL_NQ * CEIL_NT * CEIL_D
    ops_ms = flops / bf16_flops * 1e3
    bytes_ms = ((CEIL_NQ + CEIL_NT) * CEIL_D * 4 + CEIL_NQ * 4) / rate * 1e3
    bound, bound_by = ((ops_ms, "operations") if ops_ms >= bytes_ms
                       else (bytes_ms, "bytes"))
    row = dict(name="matmul_ceiling", max_abs_err=err.max().item(),
               max_err_over_tol=(err / tol).max().item(), ms=ms,
               plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
               library_ms=lib_ms)
    check(bool((err <= tol).all()) and torch.equal(got, again),
          f"matmul_ceiling {CEIL_NQ}x{CEIL_NT}x{CEIL_D}: max|err| "
          f"{row['max_abs_err']:.4g}, at most {row['max_err_over_tol']:.3g} "
          f"of 2^-16 sum|q.t|, bit-equal rerun; {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TF/s, {bound / ms:.1%} of the bound "
          f"{bound:.3f} ms, {bound_by}), plain {plain_ms:.1f} ms, "
          f"cuBLAS bf16 matmul + sum {lib_ms:.3f} ms")
    _check_ceiling_widths()
    return row


def _check_ceiling_widths() -> None:
    """matmul_ceiling at every legal D, 384 queries (the second 256-query
    tile half filled) x 4736 train rows: each within 2^-16 sum|q.t| of
    its plain version, and a rerun bit-equal."""
    import torch

    from avenir_tpu_torch.ops import matmul_ceiling as mc

    gen = torch.Generator(device=DEVICE).manual_seed(17)
    nq, nt = 384, 128 * 37
    bad, worst = [], 0.0
    widths = range(16, mc.MAX_D + 1, 16)
    for d in widths:
        q = torch.randn((nq, d), generator=gen, device=DEVICE)
        t = torch.randn((nt, d), generator=gen, device=DEVICE)
        got = mc.matmul_ceiling(q, t)
        again = mc.matmul_ceiling(q, t)
        torch.cuda.synchronize()
        err = (got - mc.matmul_ceiling_plain(q, t)).abs()
        tol = 2.0 ** -16 * mc.row_abs_sums_plain(q, t)
        worst = max(worst, (err / tol).max().item())
        if not (bool((err <= tol).all()) and torch.equal(got, again)):
            bad.append(d)
    check(not bad, f"matmul_ceiling at {nq} x {nt}, D 16..{mc.MAX_D}: "
          f"{len(widths) - len(bad)} of {len(widths)} within 2^-16 "
          f"sum|q.t| (at most {worst:.3g} of it) with bit-equal reruns"
          + (f"; not at D={bad}" if bad else ""))


def phase_bench():
    """The port-side bench at full size; its launch counts."""
    import torch

    from avenir_tpu_torch.tools import bench

    _reset_launches()
    t0 = time.perf_counter()
    line = []
    bench.run(device=DEVICE, out=line.append)
    torch.cuda.synchronize()
    counts = _launch_counts()
    print(line[0], flush=True)
    need = ("knn_topk_lanes", "knn_classify_lanes", "matmul_ceiling",
            "knn_partial_mma")
    # every KNN launch of the bench is euclidean bfloat16: each one takes
    # the tensor-core form
    bf16 = counts["knn_topk_lanes"] + counts["knn_classify_lanes"]
    check(all(counts[n] >= 1 for n in need)
          and counts["knn_partial_mma"] == bf16,
          f"bench: {time.perf_counter() - t0:.1f}s, launches {counts}; "
          f"{counts['knn_partial_mma']} of {bf16} bfloat16 KNN launches on "
          f"the tensor-core form")
    return counts


#: this slice's kernels: (name, source, what it replaces, the row of
#: `checks` it reports: name, metric, D, dtype, the path whose launches
#: count, and the wrappers whose launches launch it)
NEW_KERNELS = (
    ("knn_partial_mma", "knn_tile_mma.cuh", "avenir_tpu/ops/pallas_knn.py:64",
     ("knn_topk_lanes", "euclidean", 128, "bfloat16"), BENCH_PATH,
     ("knn_partial_mma",)),
    ("merge_topk", "knn_topk.cu", "avenir_tpu/ops/pallas_knn.py:78",
     ("merge_topk", "manhattan", 6, "float32"), "nearestNeighbor",
     ("knn_topk", "knn_topk_packed", "knn_topk_lanes")),
    ("merge_vote", "knn_classify.cu", "avenir_tpu/ops/pallas_knn.py:501",
     ("merge_vote", "manhattan", 6, "float32"), "nearestNeighbor",
     ("knn_classify_lanes",)))


def _new_kernel_rows(checks, paths):
    """The kernels line's rows of NEW_KERNELS; `paths` maps each path to
    its launch counts. A merge kernel is launched once by each launch of
    its wrappers, so its launches are theirs."""
    rows = []
    for name, src, replaces, (row_name, metric, d, dtype), path, by in \
            NEW_KERNELS:
        row = next(r for r in checks if r["name"] == row_name
                   and r.get("metric") == metric and r["d"] == d
                   and r.get("dtype", "float32") == dtype
                   and r.get("kernel_fn") is None)
        by_path = {p: sum(counts[w] for w in by)
                   for p, counts in paths.items()}
        rows.append({
            "name": name, "route": "cuda",
            "source": f"avenir_tpu_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": by_path[path],
            "launches_by_path": by_path,
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
            **{k: row[k] for k in ("device_ms", "profiler_ms", "floor_ms",
                                   "floor_profiler_ms", "group", "blocks")
               if k in row}})
    return rows


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
    check(min(v for n, v in path_counts.items() if n != "matmul_ceiling") >= 1,
          f"{CHECK_PATH} launched every KNN kernel: {path_counts}")
    nb_secs = phase_naive_bayes()
    ceiling = phase_ceiling(rate, bf16_flops)
    bench_counts = phase_bench()
    pipe_counts = phase_pipeline()
    print(f"naive bayes seconds: {json.dumps(nb_secs)}", flush=True)
    paths = {"nearestNeighbor": launches, CHECK_PATH: path_counts,
             BENCH_PATH: bench_counts, PIPE_PATH: pipe_counts}

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
        by_path = {p: counts[name] for p, counts in paths.items()}
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
    pre = next(r for r in checks if r["name"] == "knn_prepass"
               and r["d"] == 128 and r["dtype"] == "float32")
    kernels.append({
        "name": "knn_prepass", "route": "cuda",
        "source": "avenir_tpu_torch/ops/csrc/knn_prepass.cu",
        "replaces": "avenir_tpu/ops/pallas_knn.py:54",
        "launches": path_counts["knn_prepass"],
        "launches_by_path": {p: counts["knn_prepass"]
                             for p, counts in paths.items()},
        **{k: pre[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "device_ms",
                               "profiler_ms")}})
    kernels.append({
        "name": "matmul_ceiling", "route": "cuda",
        "source": "avenir_tpu_torch/ops/csrc/matmul_ceiling.cu",
        "sources": ["avenir_tpu_torch/ops/csrc/matmul_ceiling.cu",
                    "avenir_tpu_torch/ops/csrc/wgmma_bf16.cuh"],
        "replaces": "bench.py:797", "launches": bench_counts["matmul_ceiling"],
        "launches_by_path": {p: counts["matmul_ceiling"]
                             for p, counts in paths.items()},
        **{k: ceiling[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}})
    kernels += _new_kernel_rows(checks, paths)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
