"""Where the tensor-core KNN partial kernel's time goes, on the card.

    python -m avenir_tpu_torch.tools.mma_sections [--shapes table,stream]
        [--reps N] [--out FILE]

For each shape, D and mode it runs the diagnostic instance of the
tensor-core form (`knn_kernels.mma_sections`: K=8, clock64() around each
of `knn_kernels.MMA_SECTIONS`, summed over the warps that take part) and
prints each section's share of the warps' cycles, beside the CUDA-event
median of `--reps` calls of the form's partial and merge kernels on the
pre-pass's operands (made once, outside the timing), k=5:

- table: q [8192, D], t [131072, D] for D in (6, 128), `chip_smoke.py`
  phase 2's inputs (uniform, a device generator seeded 1234, in that
  order, labels of 2 classes);
- stream: q [512, 128], t [524288, 128], one launch of the KNN stream
  leg (`tools/bench.py` `knn_stream_inputs`: seed-12 normals).

Modes exact, lanes, packed and labels. Prints the card's name and power
limit first and one JSON line last (also written to `--out`). Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

import torch

from avenir_tpu_torch.ops import knn_kernels as kk
from avenir_tpu_torch.tools.knn_ab import card, cuda_ms

K = 5
MODES = ("exact", "lanes", "packed", "labels")


def _inputs(shape: str, d: int, dev: torch.device):
    if shape == "stream":
        from avenir_tpu_torch.tools import bench

        q, t = bench.knn_stream_inputs(dev)
        gen = torch.Generator(device=dev).manual_seed(1234)
    else:
        gen = torch.Generator(device=dev).manual_seed(1234)
        q = torch.rand((8192, d), generator=gen, device=dev)
        t = torch.rand((131072, d), generator=gen, device=dev)
    labels = torch.randint(0, 2, (t.shape[0],), generator=gen, device=dev,
                           dtype=torch.int32)
    return q, t, labels


def form_call(mode: str, q, t, labels):
    """A call of the tensor-core form's partial and merge kernels (k=5) on
    operands the pre-pass made once."""
    nt = t.shape[0]
    ops = kk._operands(q, t, True, True, nt)

    def run():
        if mode == "labels":
            return kk._classify_scores(q, t, labels, K, True, True, 2,
                                       q.shape[1], "gaussian", 30.0, nt,
                                       operands=ops)
        return kk._topk_keys(mode, q, t, K, True, True, nt, operands=ops)
    return run


def run(shapes=("table", "stream"), reps: int = 5, out=print) -> List[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError("mma_sections measures a CUDA kernel and needs a "
                           "CUDA device")
    dev = torch.device("cuda")
    out(card())
    rows = []
    for shape in shapes:
        for d in ((128,) if shape == "stream" else (6, 128)):
            q, t, labels = _inputs(shape, d, dev)
            for mode in MODES:
                with torch.cuda.device(dev):
                    ms = cuda_ms(form_call(mode, q, t, labels), reps)
                    shares = kk.mma_sections(q, t, mode, labels)
                    plan = kk.launch_plan(q, t, K, "euclidean", mode,
                                          compute_dtype="bfloat16")
                row = dict(shape=shape, nq=q.shape[0], nt=t.shape[0], d=d,
                           mode=mode, ms=ms, shares=shares,
                           splits=plan["splits"],
                           blocks_per_sm=plan["blocks_per_sm"])
                rows.append(row)
                out(f"{shape} {q.shape[0]} x {t.shape[0]} D={d} {mode}: "
                    f"{ms:.3f} ms (partial and merge, k={K}), "
                    f"{plan['splits']} splits; " + ", ".join(
                        f"{name} {v:.1%}" for name, v in shares.items()))
            del q, t, labels
    out(json.dumps({"metric": "mma_sections",
                    "device": torch.cuda.get_device_name(0), "card": card(),
                    "rows": rows}))
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default="table,stream")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    lines: List[str] = []

    def out(line: str) -> None:
        print(line, flush=True)
        lines.append(line)
    run(tuple(args.shapes.split(",")), args.reps, out)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
