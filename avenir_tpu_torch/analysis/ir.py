"""The IR tier: what the port's hot ops and distributed families really
run, below their source.

The port of `avenir_tpu/analysis/ir.py`. The AST rules (`rules.py`) stop
at what the source says; the reference walks the traced jaxpr of every
manifest entry (`analysis/manifest.py`) and the compiled HLO of every
distributed family. The port runs eagerly and has neither, so it records
what an entry's call dispatches:

- a `TorchDispatchMode` records every aten and c10d op of the call: the
  op, its outputs' dtypes and devices, its inputs' devices, and the
  frames of the code that made it. The entry is called once to warm
  (kernel builds, caches); its second call is recorded (`record`);
- "inside a loop" maps each frame's position in its source to the AST
  and asks `engine.ModuleContext.in_loop`, from the op's frame out to
  the entry's call: an op runs once an iteration when any frame on that
  chain sits in a lexical loop, so a read inside a helper that a loop
  body calls counts, and the same read once after the loop does not;
- kernel bodies are invisible to dispatch. On a card the libraries a
  call bound (`ops._build.libraries_asked`) are read as SASS
  (`cuobjdump -sass`, `scan_sass`) for double-precision instructions.

The rules keep the reference's ids:

- ``ir-widen-64bit``: an op output or a `_to_copy` target of an 8-byte
  dtype, one finding per (op, dtype) an entry; and, on a card, fp64
  instructions in a bound library's SASS (scoped `<entry>.lib<name>`);
- ``ir-callback-in-loop``: a read from the device back to the host
  inside a loop: `aten._local_scalar_dense` (`.item()`, `int()`,
  `bool()`), an op whose output size the host must read (`nonzero`,
  `bincount`, a boolean index, ...), or a copy from the entry's device
  to the CPU;
- ``ir-host-transfer-in-loop``: host data placed inside a loop:
  `aten.lift_fresh` (a tensor made from host data, the reference's
  `device_put`) or a copy from the CPU onto another device.

On the CPU most reads back to the host dispatch nothing (`.tolist()`,
`.cpu()`) or only a `detach` (`.numpy()`): there the host rules see
`_local_scalar_dense`, the ops that size their output from the data,
`lift_fresh` and copies onto the `meta` device. On a card,
`torch.cuda.set_sync_debug_mode("warn")` is on around the recorded
call, and each synchronizing call it reports is kept by the line it
returned to (`Capture.syncs`): the card's own account of what the
capture must have seen (`Capture.unexplained_syncs`).

The payload audit runs the eight families on a world of AUDIT_DEVICES
gloo ranks on the CPU, fresh interpreters (`spawn`) on the reference's
meshes ({data: 8}, {data: 4, model: 2} for knn_topk). Each rank records
a family's second step: the c10d ops in it are what its process group
was handed, and the bytes of their results are the observed payload,
whatever the family writes down itself (`distributed.recorded_payloads`,
which the row keeps beside it). A row is validated only when the
observed, recorded and model bytes are all equal on every rank; else a
``ir-collective-payload`` finding scoped to the family. A world smaller
than AUDIT_DEVICES (the `AVENIR_IR_DEVICES` cap) raises IRTraceError.

Findings key ``path::rule::entry`` against the shared allowlist
(`audit_baseline.txt`; an IR entry tagged ``[cpu]`` or ``[cuda]`` holds
on that device only, `for_device`), merged into a `Report` whose
`payload_audit` holds each family's row. Entry points: ``python -m
avenir_tpu_torch.analysis --ir [--device cuda]`` or `run_ir`. An entry
that fails to build or run raises IRTraceError, which the CLI maps to
exit 2: a broken capture means the auditor is broken, not that a
hazard was found. Nothing here imports torch at import time.
"""

from __future__ import annotations

import ast
import os
import re
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import time
import warnings
from dataclasses import dataclass, field, replace
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from avenir_tpu_torch.analysis.engine import (BaselineEntry, Finding,
                                              ModuleContext, Report,
                                              apply_baseline)
from avenir_tpu_torch.analysis.manifest import (AUDIT_DEVICES, KernelSpec,
                                                audit_shape,
                                                manifest_entries)

#: the audit's pseudo-rule id: payload mismatches surface as findings
#: under it (the right fix is to correct the model or the family, never
#: to excuse the drift)
PAYLOAD_RULE = "ir-collective-payload"

#: caps the ranks the payload audit may start (default AUDIT_DEVICES);
#: a cap below AUDIT_DEVICES is a trace error
DEVICES_ENV = "AVENIR_IR_DEVICES"

#: the seconds the world of ranks may take before it is killed
WORLD_TIMEOUT_S = 300.0

#: ops whose output size depends on the data: the host reads it back
#: before the op can return (on a card, a synchronizing call)
_SIZE_READS = frozenset((
    "aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
    "aten.bincount", "aten._unique", "aten._unique2", "aten.unique_dim",
    "aten.unique_consecutive", "aten.unique_dim_consecutive",
    "aten.is_nonzero", "aten.equal"))
#: ops that index with a boolean mask read its count the same way
_MASK_INDEX = frozenset(("aten.index", "aten.index_put", "aten.index_put_",
                         "aten._index_put_impl_"))
_COPIES = frozenset(("aten._to_copy", "aten.copy_", "aten.copy"))
_LIFTS = frozenset(("aten.lift_fresh", "aten.lift_fresh_copy", "aten.lift"))

#: c10d op -> the reference's HLO name of the collective
_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "collective-broadcast"}

_SYNC_WARNING = "synchronizing CUDA operation"

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class IRTraceError(RuntimeError):
    """A manifest entry could not be built or run, or the world of ranks
    could not be brought up."""


# ----------------------------------------------------------------- capture
@dataclass
class OpEvent:
    """One dispatched op of a recorded call."""

    op: str                          # "aten._to_copy", "c10d.allreduce_"
    wide: Tuple[str, ...]            # 8-byte dtypes of the outputs / target
    src: str                         # device type of the first tensor input
    dst: str                         # device type of the (first) output
    site: str                        # path:line of the code that called it
    loop_site: Optional[str]         # path:line of the loop it runs in
    chain: Tuple[str, ...] = ()      # path:line of every frame out to the call
    mask_index: bool = False         # indexes with a boolean mask
    payload_bytes: int = 0           # c10d: the bytes of its results


@dataclass
class Capture:
    """What one entry's recorded call ran: its ops, the kernel libraries
    it bound, their SASS scans, and on a card the path:line at which
    each synchronizing call the card reported returned to Python."""

    name: str
    device: str                      # the entry's device type
    events: List[OpEvent] = field(default_factory=list)
    libraries: Tuple[str, ...] = ()
    sass: Dict[str, Dict[str, Dict[str, int]]] = field(default_factory=dict)
    syncs: List[str] = field(default_factory=list)
    seconds: float = 0.0

    def unexplained_syncs(self) -> List[str]:
        """The sites of the card's synchronizing calls at which the
        capture recorded no device-to-host read: what it missed."""
        reads = {site for e in self.events if is_host_read(e)
                 for site in e.chain}
        return [s for s in self.syncs if s not in reads]

    def collectives(self) -> List[dict]:
        """The collectives the call handed its process group, in order,
        with the bytes of their results."""
        return [{"op": _COLLECTIVES.get(e.op.split(".", 1)[1], e.op),
                 "c10d": e.op, "payload_bytes": e.payload_bytes}
                for e in self.events if e.op.startswith("c10d.")]


def _rel(path: str) -> str:
    full = os.path.abspath(path)
    rel = os.path.relpath(full, _REPO_ROOT)
    return (full if rel.startswith("..") else rel).replace(os.sep, "/")


class _Sites:
    """Frame positions -> the AST node they execute, and whether it runs
    once an iteration of a lexical loop (cached per file and position)."""

    def __init__(self):
        self._modules: Dict[str, Optional[Tuple[ModuleContext, dict]]] = {}
        self._positions: Dict[object, list] = {}
        self._loops: Dict[Tuple[str, tuple], bool] = {}

    def _module(self, path: str):
        if path not in self._modules:
            try:
                with open(path, encoding="utf-8") as fh:
                    tree = ast.parse(fh.read())
            except (OSError, SyntaxError, ValueError):
                self._modules[path] = None
            else:
                index = {}
                for node in ast.walk(tree):
                    if getattr(node, "end_lineno", None) is not None:
                        index.setdefault(
                            (node.lineno, node.end_lineno, node.col_offset,
                             node.end_col_offset), node)
                self._modules[path] = (ModuleContext(path, tree), index)
        return self._modules[path]

    def position(self, frame) -> tuple:
        code = frame.f_code
        if code not in self._positions:
            self._positions[code] = list(code.co_positions())
        positions = self._positions[code]
        i = frame.f_lasti // 2
        return positions[i] if 0 <= i < len(positions) else (None,) * 4

    def in_loop(self, frame) -> bool:
        path = frame.f_code.co_filename
        pos = self.position(frame)
        key = (path, pos)
        if key not in self._loops:
            self._loops[key] = self._lookup(path, pos)
        return self._loops[key]

    def _lookup(self, path: str, pos: tuple) -> bool:
        mod = self._module(path)
        if mod is None or pos[0] is None:
            return False
        ctx, index = mod
        node = index.get(pos)
        if node is None:            # the smallest node that holds it
            line, end, col, end_col = pos
            best = None
            for (l0, l1, c0, c1), cand in index.items():
                if (l0, c0 or 0) <= (line, col or 0) and \
                        (l1, c1 or 0) >= (end or line, end_col or 0):
                    span = (l1 - l0, (c1 or 0) - (c0 or 0))
                    if best is None or span < best[0]:
                        best = (span, cand)
            if best is None:
                return False
            node = best[1]
        return ctx.in_loop(node)


def _dtype(dt) -> str:
    return str(dt).replace("torch.", "")


def _skipped_dirs() -> Tuple[str, ...]:
    import torch

    paths = sysconfig.get_paths()
    return tuple(os.path.join(os.path.abspath(p), "")
                 for p in (os.path.dirname(torch.__file__),
                           paths["stdlib"], paths["platstdlib"]))


def _mode_class():
    """The dispatch mode of `record`, made at first use (so importing
    this module imports no torch)."""
    global _MODE
    if _MODE is not None:
        return _MODE
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    this = os.path.abspath(__file__)
    skipped = _skipped_dirs()

    def tensors(tree):
        return [t for t in tree_flatten(tree)[0]
                if isinstance(t, torch.Tensor)]

    class _Recorder(TorchDispatchMode):
        def __init__(self, boundary):
            super().__init__()
            self.boundary = boundary
            self.events: List[OpEvent] = []
            self.sites = _Sites()

        def _frames(self):
            """(site of the innermost caller outside torch, site of the
            innermost loop on the chain out to the entry's call, every
            frame's site on that chain)."""
            site = loop = None
            chain = []
            f = sys._getframe(2)
            while f is not None and f.f_code is not self.boundary:
                path = os.path.abspath(f.f_code.co_filename)
                if path != this:
                    here = f"{_rel(path)}:{f.f_lineno}"
                    chain.append(here)
                    if not path.startswith(skipped):
                        site = site or here
                        if loop is None and self.sites.in_loop(f):
                            loop = here
                f = f.f_back
            return site or "?", loop, tuple(chain)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func._schema.name.replace("::", ".")
            ins, outs = tensors((args, kwargs)), tensors(out)
            to = kwargs.get("dtype") if name == "aten._to_copy" else None
            wide = {_dtype(t.dtype) for t in outs if t.dtype.itemsize == 8}
            if to is not None and to.itemsize == 8:
                wide.add(_dtype(to))
            if name == "aten.copy_" and len(ins) >= 2:
                src, dst = ins[1].device.type, ins[0].device.type
            else:
                src = ins[0].device.type if ins else "cpu"
                dst = outs[0].device.type if outs else src
            mask = name in _MASK_INDEX and len(args) > 1 and any(
                t.dtype in (torch.bool, torch.uint8)
                for t in tensors(args[1]))
            payload = 0
            if name.startswith("c10d.") and args:
                payload = sum(t.numel() * t.element_size()
                              for t in tensors(args[0]))
            site, loop, chain = self._frames()
            self.events.append(OpEvent(name, tuple(sorted(wide)), src, dst,
                                       site, loop, chain, mask, payload))
            return out

    # the first dispatch mode a process enters imports torch's tensor
    # subclass machinery (seconds): pay it here, outside any entry's call
    with _Recorder(_mode_class.__code__):
        torch.zeros(1) + 1
    _MODE = _Recorder
    return _MODE


_MODE = None


def _recorded_call(fn, args):
    """The recorded call itself: the frame walk stops here."""
    return fn(*args)


def record(fn, args, device: str, warm: bool = True, name: str = ""
           ) -> Capture:
    """Call `fn(*args)` once to warm (unless `warm` is False), then once
    more under the dispatch recorder; on a CUDA device under
    `torch.cuda.set_sync_debug_mode("warn")` too, each synchronizing
    call's warning kept by the site it returned to (a warning from C++
    reaches Python when the outermost call returns, so it names the line
    that made it). Returns the Capture of the second call."""
    import torch

    from avenir_tpu_torch.ops import _build

    dev = torch.device(device).type
    if warm:
        fn(*args)
    mode = _mode_class()(_recorded_call.__code__)
    cap = Capture(name, dev)
    t0 = time.perf_counter()
    with _build.libraries_asked() as libs:
        if dev == "cuda":
            torch.cuda.synchronize()
            before = torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", message="Synchronization "
                                        "debug mode is a prototype")
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    with mode:
                        _recorded_call(fn, args)
            finally:
                torch.cuda.set_sync_debug_mode(before)
            torch.cuda.synchronize()
            cap.syncs = [f"{_rel(w.filename)}:{w.lineno}" for w in caught
                         if _SYNC_WARNING in str(w.message)]
            for w in caught:
                if _SYNC_WARNING not in str(w.message):
                    warnings.warn_explicit(w.message, w.category,
                                           w.filename, w.lineno)
        else:
            with mode:
                _recorded_call(fn, args)
    cap.seconds = time.perf_counter() - t0
    cap.events = mode.events
    cap.libraries = tuple(sorted(libs))
    return cap


# ------------------------------------------------------------------- SASS
_SASS_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)", re.M)
_SASS_OP = re.compile(
    r"\b(DADD|DMUL|DFMA|DSETP|DMNMX|DSET|F2F|I2F|F2I)((?:\.[A-Z0-9_]+)*)")


def scan_sass(text: str) -> Dict[str, Dict[str, int]]:
    """{kernel function: {fp64 instruction: count}} of `cuobjdump -sass`
    text: DADD, DMUL, DFMA, DSETP, DMNMX, and the conversions with an F64
    side (F2F.F64.*, F2F.*.F64, I2F.F64, F2I.*.F64). Functions without
    one are left out."""
    out: Dict[str, Dict[str, int]] = {}
    spans = [(m.start(), m.group(1)) for m in _SASS_FUNCTION.finditer(text)]
    spans.append((len(text), None))
    if spans[0][0] > 0:
        spans.insert(0, (0, "<no function>"))
    for (start, name), (end, _next) in zip(spans, spans[1:]):
        for m in _SASS_OP.finditer(text, start, end):
            op, mods = m.group(1), m.group(2)
            if not op.startswith("D") and ".F64" not in mods:
                continue
            key = op + mods
            hits = out.setdefault(name, {})
            hits[key] = hits.get(key, 0) + 1
    return out


def library_sass(name: str) -> str:
    """`cuobjdump -sass` of this checkout's build of library `name`."""
    from avenir_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise IRTraceError("cuobjdump not found (PATH or /usr/local/cuda/"
                           "bin): the SASS leg needs the CUDA toolkit")
    proc = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise IRTraceError(f"cuobjdump -sass lib{name}.so failed: "
                           f"{proc.stderr.strip()[-400:]}")
    return proc.stdout


# ------------------------------------------------------------------ rules
class IRRule:
    rule_id: str = ""
    description: str = ""
    hint: str = ""

    def check(self, spec: KernelSpec, capture: Capture) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, spec: KernelSpec, message: str,
                scope: Optional[str] = None) -> Finding:
        return Finding(spec.path, spec.line, self.rule_id, message,
                       self.hint, scope or spec.name)


class Widen64BitRule(IRRule):
    """8-byte element types in what an entry's call runs: an op's output
    or a `_to_copy` target, wherever the source spelled it (a `.long()`,
    an index op's int64, a `.double()` in a helper); and, on a card, fp64
    instructions in the SASS of a library the call bound, which dispatch
    cannot see. The port counts in int64 and takes LR's gradient in
    float64 by design: those findings stand in the allowlist with their
    reasons, and a new one is a widening nobody chose."""

    rule_id = "ir-widen-64bit"
    description = "64-bit dtype or fp64 instruction in an entry's call"
    hint = ("narrow the producing op (int32/float32) or widen at the host "
            "boundary; in a kernel, use float arithmetic and fp32 "
            "intrinsics")

    def check(self, spec: KernelSpec, capture: Capture) -> Iterator[Finding]:
        seen = set()
        for e in capture.events:
            for dt in e.wide:
                if (e.op, dt) in seen:
                    continue
                seen.add((e.op, dt))
                yield self.finding(
                    spec, f"`{spec.name}` materializes {dt} through "
                          f"`{e.op}` ({e.site}): a 64-bit temporary")
        for lib, scan in sorted(capture.sass.items()):
            for fn_name, hits in sorted(scan.items()):
                ops = ", ".join(f"{k} x{v}" for k, v in sorted(hits.items()))
                yield self.finding(
                    spec, f"lib{lib}.so, bound by `{spec.name}`, runs fp64 "
                          f"instructions in `{fn_name}`: {ops}",
                    scope=f"{spec.name}.lib{lib}")


def is_host_read(e: OpEvent) -> bool:
    """`e` reads the device back to the host: a scalar read, an op whose
    output size the host reads, or a copy from a device to the CPU."""
    if e.op in _SIZE_READS or e.mask_index:
        return True
    return e.op in _COPIES and e.src != "cpu" and e.dst == "cpu"


def is_host_transfer(e: OpEvent) -> bool:
    """`e` places host data: a tensor made from it, or a copy from the
    CPU onto a device."""
    if e.op in _LIFTS:
        return True
    return e.op in _COPIES and e.src == "cpu" and e.dst != "cpu"


class CallbackInLoopRule(IRRule):
    """A read from the device back to the host inside a loop: each
    iteration waits for the device and drains the launch queue, the
    port's counterpart of a host callback inside a scan body. The port
    is host-bound, so a stall a chunk is what it cannot afford."""

    rule_id = "ir-callback-in-loop"
    description = "device-to-host read inside a loop"
    hint = ("accumulate on the device and read once after the loop, or "
            "size the output on the host before the loop")

    def check(self, spec: KernelSpec, capture: Capture) -> Iterator[Finding]:
        seen = set()
        for e in capture.events:
            if e.loop_site is None or not is_host_read(e):
                continue
            if (e.op, e.loop_site) in seen:
                continue
            seen.add((e.op, e.loop_site))
            yield self.finding(
                spec, f"`{e.op}` reads the device back to the host inside "
                      f"a loop ({e.loop_site}) of `{spec.name}`: one host "
                      f"round-trip per iteration")


class HostTransferInLoopRule(IRRule):
    """Host data placed inside a loop: a per-iteration host-to-device copy
    in a fold path (the reference's `device_put` in a scan body)."""

    rule_id = "ir-host-transfer-in-loop"
    description = "host data placed inside a loop"
    hint = ("place operands before the loop (one transfer, then loop over "
            "device-resident tensors)")

    def check(self, spec: KernelSpec, capture: Capture) -> Iterator[Finding]:
        seen = set()
        for e in capture.events:
            if e.loop_site is None or not is_host_transfer(e):
                continue
            if (e.op, e.loop_site) in seen:
                continue
            seen.add((e.op, e.loop_site))
            yield self.finding(
                spec, f"`{e.op}` places host data inside a loop "
                      f"({e.loop_site}) of `{spec.name}`: a per-iteration "
                      f"transfer in a fold path")


ALL_IR_RULES = [Widen64BitRule, CallbackInLoopRule, HostTransferInLoopRule]


def ir_rule_ids() -> List[str]:
    return [r.rule_id for r in ALL_IR_RULES] + [PAYLOAD_RULE]


def check_capture(spec: KernelSpec, capture: Capture,
                  rules: Optional[Sequence[IRRule]] = None) -> List[Finding]:
    """Run the IR rules over one recorded call (the fixtures' entry
    point: tests record bad and good snippets and feed them here)."""
    active = list(rules) if rules is not None else [r() for r in ALL_IR_RULES]
    out: List[Finding] = []
    for rule in active:
        out.extend(rule.check(spec, capture))
    return out


# ------------------------------------------------------------ the world
def _world_cap() -> int:
    raw = os.environ.get(DEVICES_ENV)
    if raw is None:
        return AUDIT_DEVICES
    try:
        return int(raw)
    except ValueError:
        raise IRTraceError(f"{DEVICES_ENV}={raw!r} is not a rank count")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, outdir: str,
               specs: List[KernelSpec]) -> None:
    """One rank of the audit world: every family on its mesh, a warm
    step, then a recorded step inside `recorded_payloads()`; rank 0 keeps
    the whole capture, every rank its collectives."""
    import pickle
    import traceback

    try:
        import torch

        torch.set_num_threads(1)
        from avenir_tpu_torch.parallel.distributed import recorded_payloads
        from avenir_tpu_torch.parallel.mesh import data_mesh
        from avenir_tpu_torch.parallel.multihost import initialize, shutdown

        initialize(f"tcp://127.0.0.1:{port}", world, rank, device="cpu")
        meshes, out = {}, {}
        for spec in specs:
            mp = spec.model_parallel
            if mp not in meshes:
                meshes[mp] = data_mesh(model_parallel=mp, device="cpu")
            mesh = meshes[mp]
            fn, args = spec.build(mesh)
            fn(*args)
            with recorded_payloads() as rec:
                cap = record(fn, args, "cpu", warm=False, name=spec.name)
            out[spec.name] = {
                "mesh": dict(mesh.shape), "recorded": list(rec),
                "collectives": cap.collectives(),
                "capture": cap if rank == 0 else None}
        shutdown()
        with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    except BaseException:
        with open(os.path.join(outdir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def _run_world(specs: List[KernelSpec]) -> Dict[int, dict]:
    """Run the families on AUDIT_DEVICES spawned gloo ranks; every
    rank's results by rank. A rank that fails, or a world that outlives
    WORLD_TIMEOUT_S (a hung collective), kills the others and raises
    IRTraceError with what the ranks said."""
    import multiprocessing as mp
    import pickle

    ctx = mp.get_context("spawn")
    # a rank imports each spec's build by name; the model is the parent's
    sendable = [replace(s, payload_model=None) for s in specs]
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="avenir_ir_") as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, AUDIT_DEVICES, port, tmp, sendable))
                 for r in range(AUDIT_DEVICES)]
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        try:
            for p in procs:
                p.start()
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.pid is None:       # never started
                    continue
                if p.is_alive():
                    p.kill()
                p.join(10)
        errs = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as fh:
                    errs.append(f"rank {r}:\n{fh.read()[-800:]}")
            elif p.exitcode != 0:
                errs.append(f"rank {r} exit {p.exitcode}")
        if errs:
            timed_out = time.monotonic() > deadline
            raise IRTraceError(
                "the families' world of ranks failed"
                + (f" (killed after {WORLD_TIMEOUT_S:.0f} s)" if timed_out
                   else "")
                + ":\n" + "\n".join(errs))
        results = {}
        for r in range(AUDIT_DEVICES):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                results[r] = pickle.load(fh)
        return results


def audit_family(spec: KernelSpec, ranks: Dict[int, dict]
                 ) -> Tuple[dict, Optional[Finding]]:
    """One family's payload row from every rank's results, held to its
    model on the audit mesh: (row, mismatch finding or None)."""
    shape = audit_shape(spec)
    want = int(spec.payload_model(shape))
    per_rank = [(r, res[spec.name]) for r, res in sorted(ranks.items())]
    first = per_rank[0][1]
    observed = sum(c["payload_bytes"] for c in first["collectives"])
    recorded = sum(c["payload_bytes"] for c in first["recorded"])
    bad = []
    for r, res in per_rank:
        got = (sum(c["payload_bytes"] for c in res["collectives"]),
               sum(c["payload_bytes"] for c in res["recorded"]))
        if res["mesh"] != shape or got != (want, want):
            bad.append((r, res["mesh"], got))
    row = {
        "family": spec.name,
        "mesh": shape,
        "collectives": first["collectives"],
        "observed_payload_bytes": observed,
        "recorded_payload_bytes": recorded,
        "analytic_payload_bytes": want,
        "payload_model_validated": not bad,
    }
    finding = None
    if bad:
        r, mesh, (got_obs, got_rec) = bad[0]
        finding = Finding(
            spec.path, spec.line, PAYLOAD_RULE,
            f"family `{spec.name}` handed its process group {got_obs} "
            f"collective bytes on rank {r} of the {mesh} mesh and recorded "
            f"{got_rec}; the scaling.py model says {want}: the traffic "
            f"model (and every projection built on it) is stale, or a "
            f"collective ran unrecorded",
            "re-derive scaling.collective_payload_model for this family, "
            "or record every collective it runs (distributed._reduce, "
            "_gather)", spec.name)
    return row, finding


# -------------------------------------------------------------- execution
def _op_capture(spec: KernelSpec, device: str) -> Capture:
    try:
        fn, args = spec.build(None)
    except Exception as e:
        raise IRTraceError(f"{spec.name}: could not build: {e!r}") from e
    try:
        cap = record(fn, args, device, name=spec.name)
    except Exception as e:
        raise IRTraceError(f"{spec.name}: could not run on {device}: "
                           f"{e!r}") from e
    for lib in cap.libraries:
        cap.sass[lib] = scan_sass(library_sass(lib))
    return cap


def run_ir(rules: Optional[Sequence[IRRule]] = None,
           baseline: Optional[Sequence[BaselineEntry]] = None,
           entries: Optional[Sequence[KernelSpec]] = None,
           audit: bool = True, device: str = "cuda",
           captures: Optional[Dict[str, Capture]] = None) -> Report:
    """Record every manifest entry, run the IR rules, audit every
    family's collective payload, and apply the allowlist.

    The op entries run on `device` ("cuda" unless the caller asks for
    "cpu"; a missing device raises IRTraceError, never a fall back), the
    families on a gloo world of AUDIT_DEVICES CPU ranks. `captures`, a
    dict, receives each entry's Capture (a family's from rank 0)."""
    import torch

    from avenir_tpu_torch.utils.devices import resolve_device

    cap_n = _world_cap()
    if cap_n < AUDIT_DEVICES:
        raise IRTraceError(
            f"the collective-payload audit needs a world of "
            f"{AUDIT_DEVICES} ranks; {DEVICES_ENV} allows {cap_n}")
    try:
        dev = str(resolve_device(device))
    except (RuntimeError, ValueError) as e:
        raise IRTraceError(f"device {device!r}: {e}") from e
    specs = (list(entries) if entries is not None
             else manifest_entries(torch.device(dev).type))
    active = list(rules) if rules is not None else [r() for r in ALL_IR_RULES]
    report = Report()
    raw: List[Finding] = []
    for spec in specs:
        if spec.path not in report.scanned:
            report.scanned.append(spec.path)
    for spec in specs:
        if spec.is_family:
            continue
        cap = _op_capture(spec, dev)
        if captures is not None:
            captures[spec.name] = cap
        raw.extend(check_capture(spec, cap, active))
    families = [s for s in specs if s.is_family]
    if families and (active or audit):
        ranks = _run_world(families)
        for spec in families:
            cap = ranks[0][spec.name]["capture"]
            if captures is not None:
                captures[spec.name] = cap
            raw.extend(check_capture(spec, cap, active))
            if audit:
                row, finding = audit_family(spec, ranks)
                report.payload_audit.append(row)
                if finding is not None:
                    raw.append(finding)
    active_ids = {r.rule_id for r in active}
    if audit:
        active_ids.add(PAYLOAD_RULE)
    apply_baseline(report, raw, for_device(baseline, torch.device(dev).type),
                   active_ids)
    return report


def for_device(baseline: Optional[Sequence[BaselineEntry]], dev_type: str
               ) -> Optional[List[BaselineEntry]]:
    """The allowlist entries that hold on `dev_type`. An op entry runs a
    wrapper's plain version on the CPU and its kernel on a card, so an
    IR entry whose justification starts with a device tag, ``[cpu]`` or
    ``[cuda]``, holds (and can go stale) on that device only."""
    if baseline is None:
        return None
    out = []
    for e in baseline:
        tag = re.match(r"\[(\w+)\]", e.justification)
        if tag and e.key.split("::")[1].startswith("ir-") \
                and tag.group(1) != dev_type:
            continue
        out.append(e)
    return out
