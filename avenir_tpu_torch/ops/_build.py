"""Build the port's CUDA kernels with nvcc at first use; bind them with ctypes.

Each source under `ops/csrc/` compiles on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
         -split-compile=0

The libraries land in `build/avenir_tpu_torch/<hash>/` at the root of the
checkout, keyed on a hash of every source, header and flag, so an edited
kernel rebuilds and an unchanged one is reused. `build_all()` starts one
nvcc per source, all at once. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "avenir_tpu_torch"
#: -split-compile=0 optimizes a source's kernels on every CPU at once: the
#: partial kernel's template instances otherwise build one after another
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
#: library -> (source, C entry, argtypes); pointers and the stream are
#: c_void_p so ctypes never cuts them to 32 bits
LIBRARIES = {
    "knn_topk": ("knn_topk.cu", "knn_topk_launch",
                 [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                  _P, _P, _P]),
    "knn_classify": ("knn_classify.cu", "knn_classify_launch",
                     [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                      _F, _I, _I, _P, _P, _P, _P]),
    "knn_prepass": ("knn_prepass.cu", "knn_prepass_launch",
                    [_P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P]),
    "matmul_ceiling": ("matmul_ceiling.cu", "matmul_ceiling_launch",
                       [_P, _P, _I, _I, _I, _P, _P, _I, _I, _P, _P, _P]),
    "subseq_support": ("subseq_support.cu", "subseq_support_launch",
                       [_P, _I, _I, _P, _I, _I, _P, _I, _P, _P]),
    "centre_sums": ("centre_sums.cu", "centre_sums_launch",
                    [_P, _I, _I, _P, _I, _P, _P, _L, _P]),
    "metropolis_walk": ("metropolis_walk.cu", "metropolis_walk_launch",
                        [_P, _P, _P, _L, _P, _I, _F, _F, _F, _F, _F, _F, _F,
                         _P, _P, _P]),
}
_TOPK_ARGS = LIBRARIES["knn_topk"][2]
_CLASSIFY_ARGS = LIBRARIES["knn_classify"][2]
#: library -> {further C entry: argtypes}: what a partial instance takes
#: (blocks per SM, registers, local bytes); the tensor-core form's launch
#: and info (same arguments as the CUDA-core form's) and its persistent
#: schedule's plan (blocks, segments); the merge kernels
#: alone, their instances' resources, their grid's layout and an empty
#: kernel on that grid (the launch floor); the tensor-core form's
#: diagnostic instance with clock64() sections; the ceiling's main-kernel
#: instance for a D (registers, local bytes, shared bytes, threads, blocks
#: per SM, tile); the pre-pass's bf16 layout; the subsequence count's
#: route and each of its kernels' registers and local bytes; the centre
#: sums' workspace bytes, each of
#: its two launches alone and the dependent-FADD chain; the Metropolis
#: walk's step chain on draws held in registers. bind() skips the
#: ones a library lacks (an earlier version's sources), and calling one
#: of those raises AttributeError.
INFO = {
    "knn_topk": {"knn_topk_partial_info": [_I, _I, _I, _I, _P],
                 "knn_topk_mma_launch": _TOPK_ARGS,
                 "knn_topk_mma_info": [_I, _I, _I, _I, _P],
                 "knn_topk_mma_plan": [_I, _I, _I, _I, _P],
                 "knn_topk_merge_launch": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
                 "knn_topk_merge_info": [_I, _P],
                 "knn_merge_layout": [_I, _I, _P],
                 "knn_merge_floor_launch": [_I, _I, _P],
                 "knn_topk_mma_profile": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                          _I, _I, _I, _P, _P, _P, _P]},
    "knn_classify": {"knn_classify_partial_info": [_I, _I, _I, _P],
                     "knn_classify_mma_launch": _CLASSIFY_ARGS,
                     "knn_classify_mma_info": [_I, _I, _I, _P],
                     "knn_classify_mma_plan": [_I, _I, _I, _I, _P],
                     "knn_classify_merge_launch": [_P, _P, _I, _I, _I, _I, _I,
                                                   _I, _F, _I, _F, _P, _P],
                     "knn_classify_merge_info": [_I, _P]},
    "knn_prepass": {"knn_prepass_rows16": []},
    "matmul_ceiling": {"matmul_ceiling_info": [_I, _P]},
    "subseq_support": {"subseq_support_route": [_I, _I, _I],
                       "subseq_support_info": [_I, _P]},
    "centre_sums": {"centre_sums_workspace": [_I, _I, _I, _P],
                    "centre_sums_partition_launch": [_P, _I, _I, _P, _I, _P,
                                                     _L, _P],
                    "centre_sums_chains_launch": [_I, _I, _I, _P, _L, _P, _P],
                    "centre_sums_fadd_chain_launch": [_I, _F, _P, _P, _P]},
    "metropolis_walk": {"metropolis_chain_latency_launch": [
        _P, _P, _L, _P, _I, _F, _F, _F, _F, _F, _P, _P, _P]},
}

_loaded: Dict[str, ctypes.CDLL] = {}
#: nvcc runs started (`build_all`) and libraries bound (`bind`) by this
#: process, wherever they were asked for: `load` builds and binds a
#: library once, so a count that grows with a job's blocks is a rebuild
#: or re-bind a block (the miner and shared-scan tripwires read it)
counts: Dict[str, int] = {"builds": 0, "binds": 0}
#: held around build-and-bind: threads of one process (the job server's
#: executors, the score plane's dispatcher) may reach a kernel for the
#: first time at once, and must run nvcc once between them
_load_lock = threading.Lock()
#: the set that `libraries_asked()` is filling, or None
_asked: Optional[Set[str]] = None


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                           "CUDA kernels build only where the toolkit is")
    return found


def build_dir(csrc: Path = CSRC) -> Path:
    """Directory of this build: a hash of every source, header and flag."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(csrc.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all(csrc: Path = CSRC, names: Iterable[str] = LIBRARIES
              ) -> Dict[str, float]:
    """Compile every library of `names` (sources under `csrc`) that is not
    built yet, one nvcc per source, all started together. Returns
    {library: seconds} of the builds run. Raises RuntimeError with the
    compiler's output if any build fails."""
    out = build_dir(csrc)
    out.mkdir(parents=True, exist_ok=True)
    jobs: List[tuple] = []
    for name in names:
        src = LIBRARIES[name][0]
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out / f".lib{name}.{os.getpid()}.{threading.get_ident()}.so"
        log = open(out / f"{name}.log", "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / src)]
        counts["builds"] += 1
        jobs.append((name, lib, tmp, log, time.perf_counter(),
                     subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    secs: Dict[str, float] = {}
    failed = []
    for name, lib, tmp, log, t0, proc in jobs:
        rc = proc.wait()
        log.close()
        secs[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (rc {rc}):\n{(out / f'{name}.log').read_text()}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Declare the argument and return types of a library's C entries:
    its launch entry, which it must have, and those of INFO it has."""
    counts["binds"] += 1
    _src, main, args = LIBRARIES[name]
    for entry, args in {main: args, **INFO.get(name, {})}.items():
        if entry != main and not hasattr(lib, entry):
            continue
        fn = getattr(lib, entry)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


@contextmanager
def libraries_asked():
    """Yield a set that receives the name of every library `load` is
    asked for inside the block, bound already or not (the IR tier reads
    the SASS of what an entry's call binds)."""
    global _asked
    outer, _asked = _asked, set()
    try:
        yield _asked
    finally:
        _asked = outer


def library_path(name: str) -> Path:
    """Where this checkout's build of library `name` lands."""
    return build_dir() / f"lib{name}.so"


def load(name: str) -> ctypes.CDLL:
    """The bound library `name`, built first if it is not yet. Safe from
    several threads at once: one of them builds and binds, the others
    wait for it."""
    if _asked is not None:
        _asked.add(name)
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _load_lock:
        if name not in _loaded:
            path = library_path(name)
            if not path.exists():
                build_all()
            _loaded[name] = bind(ctypes.CDLL(str(path)), name)
        return _loaded[name]
