"""Run the docs/ tutorials' ```python fences on the port.

`tests/test_tutorials.py` runs each fence verbatim against the JAX
package. Here each fence is loaded through `port_source`, an AST rewrite
that leaves the docs as they are:

- `avenir_tpu` becomes `avenir_tpu_torch`: in imports, in the bare name
  an `import avenir_tpu.x` binds, and in a string that names a module;
- every call goes through `_port_call`, which adds `device="cpu"` to a
  port callable whose `device` parameter is annotated `DeviceLike` and is
  not given, and `"--device", "cpu"` to `run_from_cli`'s argv. Which
  callables take a device is read off the port's signatures, so a
  `device: bool` route flag (`RandomForestBuilder.predict`) is left alone.

`run_tutorial` runs one tutorial's fences in order in one namespace, with
`workdir` bound to a directory; `written_files` reads back what they wrote.
"""

from __future__ import annotations

import ast
import inspect
import os
import re
from typing import Callable, Dict

DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "docs")

TUTORIALS = sorted(
    f for f in os.listdir(DOCS)
    if f.startswith("tutorial_") and f.endswith(".md"))

#: tutorials whose modules the port does not have yet, and what they wait
#: for: none (the job server's tutorial runs since server/jobserver.py and
#: net/ were ported)
WAITING: Dict[str, str] = {}

RUNNABLE = [t for t in TUTORIALS if t not in WAITING]

_FENCE = re.compile(r"```python\n(.*?)```", re.DOTALL)
_MODULE_NAME = re.compile(r"^avenir_tpu(?=\.|$)")
_PORT = "avenir_tpu_torch"
_CALL_HOOK = "__port_call__"


def fences(name: str):
    with open(os.path.join(DOCS, name)) as fh:
        return _FENCE.findall(fh.read())


def _to_port(module: str) -> str:
    return _MODULE_NAME.sub(_PORT, module)


class _ToPort(ast.NodeTransformer):
    def visit_ImportFrom(self, node):
        if node.module and node.level == 0:
            node.module = _to_port(node.module)
        return node

    def visit_Import(self, node):
        for alias in node.names:
            alias.name = _to_port(alias.name)
        return node

    def visit_Name(self, node):
        if node.id == "avenir_tpu":
            node.id = _PORT
        return node

    def visit_Constant(self, node):
        if isinstance(node.value, str) and _MODULE_NAME.match(node.value):
            node.value = _to_port(node.value)
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        if isinstance(node.func, ast.Name) and node.func.id == "super":
            return node   # a zero-argument super() reads its own frame
        node.func = ast.Call(func=ast.Name(id=_CALL_HOOK, ctx=ast.Load()),
                             args=[node.func], keywords=[])
        return node


def port_source(block: str, filename: str):
    """The code object of one fence, rewritten to run on the port."""
    tree = ast.fix_missing_locations(_ToPort().visit(ast.parse(block)))
    return compile(tree, filename, "exec")


def _device_slot(fn):
    """None if `fn` is not a port callable with a `DeviceLike` device
    parameter, else that parameter's position (-1: keyword only)."""
    if not (getattr(fn, "__module__", None) or "").startswith(_PORT):
        return None
    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return None
    from avenir_tpu_torch.utils.devices import DeviceLike
    for i, p in enumerate(params):
        if p.name != "device":
            continue
        ann = p.annotation
        takes = ("DeviceLike" in ann if isinstance(ann, str)
                 else ann == DeviceLike)
        if not takes:
            return None
        return i if p.kind is p.POSITIONAL_OR_KEYWORD else -1
    return None


def _port_call(fn: Callable) -> Callable:
    from avenir_tpu_torch.runner import run_from_cli
    if fn is run_from_cli:
        def cli(argv, *args, **kwargs):
            argv = list(argv)
            if "--device" not in argv:
                argv += ["--device", "cpu"]
            return fn(argv, *args, **kwargs)
        return cli
    slot = _device_slot(fn)
    if slot is None:
        return fn

    def call(*args, **kwargs):
        if "device" not in kwargs and (slot < 0 or len(args) <= slot):
            kwargs["device"] = "cpu"
        return fn(*args, **kwargs)
    return call


def run_tutorial(name: str, workdir: str, port: bool) -> None:
    """Run every fence of `name` in order in one namespace; `port` picks
    the rewritten fences, else the fences run verbatim (the reference)."""
    ns: Dict[str, object] = {"workdir": workdir, _CALL_HOOK: _port_call}
    for i, block in enumerate(fences(name)):
        label = f"{name}[block {i}]"
        code = port_source(block, label) if port else compile(block, label,
                                                               "exec")
        try:
            exec(code, ns)
        except Exception as e:
            raise AssertionError(
                f"{label} failed on the {'port' if port else 'reference'}: "
                f"{e}\n--- block ---\n{block}") from e


def written_files(workdir: str) -> Dict[str, bytes]:
    """Every file under `workdir` by relative path, with `workdir` itself
    replaced by a token (a config may name its own directory)."""
    out = {}
    root = os.fsencode(workdir)
    for base, _dirs, files in os.walk(workdir):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, workdir)] = \
                    fh.read().replace(root, b"<workdir>")
    return out
