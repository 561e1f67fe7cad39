"""The AST tier: ``python -m avenir_tpu_torch.analysis <paths>``.

The port's share of `avenir_tpu/analysis/rules.py`: the rules whose
scope exists in torch and numpy source.

default-int64            numpy constructors and index calls on a hot
                         path (inside a loop) that default to a 64-bit
                         element type; the port's host folds are numpy
                         as the reference's are, so the rule is the
                         reference's.
host-sync-in-fold        a device-to-host transfer inside a chunk or
                         fold loop: `.item()`, `.cpu()`, `.tolist()`,
                         `torch.cuda.synchronize()`, and `float()` /
                         `int()` / `bool()` / `np.asarray()` of a kernel
                         wrapper's or a compiled callable's result. Each
                         blocks until the card has drained the stream.
unseeded-stochastic-test a scope that asserts and draws unpinned
                         randomness: numpy's and Python's global draws,
                         an unseeded `default_rng()`, a `torch.rand*`
                         draw with no `generator=`, a clock-seeded key.
sharded-host-materialize host materialization (`np.asarray`,
                         `np.array`, `np.copy`, `.cpu()`, `.numpy()`,
                         `.tolist()`) of a tensor that `parallel/`'s
                         `shard_rows` or `replicated` placed.

The reference's `recompile-hazard`, `tracer-leak`,
`int64-literal-in-jnp` and `fold-undonated-carry` have no torch
counterpart: the port has no jit trace to recompile or leak a tracer
from, no weak-typed int32 device literals, and no donated buffers (a
torch fold adds into its carry in place), so they are not ported.

Rules are lexical (`engine.py`); each finding is fixed or allowlisted
with a one-line reason in `analysis/audit_baseline.txt`.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set

from avenir_tpu_torch.analysis.engine import Finding, ModuleContext

_NUMPY = "numpy"


class Rule:
    rule_id: str = ""
    description: str = ""
    hint: str = ""

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: ModuleContext, node: ast.AST, message: str,
                hint: Optional[str] = None) -> Finding:
        return Finding(ctx.path, getattr(node, "lineno", 1), self.rule_id,
                       message, hint or self.hint, ctx.scope_of(node))


class DefaultInt64Rule(Rule):
    """numpy constructors and accumulators on hot paths (lexically inside
    a loop) without an explicit narrow dtype, and the numpy calls whose
    index result is always int64. A doubled temporary in a loop is paid
    once a block instead of once a process."""

    rule_id = "default-int64"
    description = ("numpy call on a hot path defaults to a 64-bit dtype "
                   "(or always returns int64 indices)")
    hint = ("pass an explicit narrow dtype (np.int32/np.float32), or use an "
            "int32 cumsum/region-mask form for index math")

    # func -> index of the positional dtype argument
    DTYPE_POS = {"zeros": 1, "ones": 1, "empty": 1, "full": 2,
                 "arange": 3, "cumsum": 2, "cumprod": 2}
    ALWAYS_INT64 = {"argsort", "flatnonzero", "nonzero", "searchsorted"}

    @staticmethod
    def _fill_sets_narrow_dtype(node: ast.Call) -> bool:
        fill = (node.args[1] if len(node.args) > 1 else
                next((kw.value for kw in node.keywords
                      if kw.arg == "fill_value"), None))
        return (isinstance(fill, ast.Constant)
                and isinstance(fill.value, (str, bool)))

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = ctx.dotted(node.func)
            if name is None or "." not in name:
                continue
            mod, _, func = name.rpartition(".")
            if mod != _NUMPY or not ctx.in_loop(node):
                continue
            if func in self.DTYPE_POS:
                has_dtype = (len(node.args) > self.DTYPE_POS[func]
                             or any(kw.arg == "dtype"
                                    for kw in node.keywords))
                if func == "full" and self._fill_sets_narrow_dtype(node):
                    continue        # dtype follows a str/bool fill value
                if not has_dtype:
                    yield self.finding(
                        ctx, node,
                        f"np.{func} inside a loop without an explicit "
                        f"dtype defaults to a 64-bit element type")
            elif func in self.ALWAYS_INT64:
                yield self.finding(
                    ctx, node,
                    f"np.{func} inside a loop materializes int64 indices "
                    f"(8 bytes/element) on a hot path")


class HostSyncInFoldRule(Rule):
    """Device-to-host transfers inside chunk or fold loops: `.item()`,
    `.cpu()` and `.tolist()` (no arguments), `torch.cuda.synchronize()`,
    `jax.device_get`, and `float()`/`int()`/`bool()`/`np.asarray()`/
    `np.array()`/`np.copy()` wrapping a call of a kernel wrapper
    (`avenir_tpu_torch.ops`' kernel modules) or of a compiled callable
    (`ModuleContext.compiled_names`). Each one waits for the card to
    drain its stream, so the next block's parse cannot overlap the
    fold's launches, unless the transfer is the fold's own accumulation,
    which is allowlisted with that reason."""

    rule_id = "host-sync-in-fold"
    description = "host sync of a device value inside a chunk/fold loop"
    hint = ("keep the accumulator on the device (fold into a device "
            "tensor, read it back once after the loop), or allowlist if "
            "the once-a-block transfer is the fold itself")

    WRAPPERS = {"numpy.asarray", "numpy.array", "numpy.copy"}
    SCALARS = {"float", "int", "bool"}
    SYNC_METHODS = {"item": "a scalar device->host sync",
                    "cpu": "a device->host copy",
                    "tolist": "a device->host copy"}
    SYNC_CALLS = {"torch.cuda.synchronize", "jax.device_get"}
    #: the port's kernel wrapper modules: a call into one launches a kernel
    KERNEL_MODULES = tuple(f"avenir_tpu_torch.ops.{m}." for m in (
        "knn_kernels", "sequence_kernels", "cluster_kernels",
        "sampling_kernels", "matmul_ceiling"))

    def _kernel_result(self, ctx: ModuleContext, call: ast.Call
                       ) -> Optional[str]:
        """The called name when `call` is a kernel wrapper's or a
        compiled callable's call, else None."""
        inner = ctx.dotted(call.func)
        if inner is None:
            return None
        tail = inner.rpartition(".")[2]
        if tail in ctx.compiled_names \
                or inner.startswith(self.KERNEL_MODULES):
            return tail
        return None

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not ctx.in_loop(node):
                continue
            name = ctx.dotted(node.func)
            if name in self.SYNC_CALLS:
                yield self.finding(ctx, node,
                                   f"{name} inside a loop blocks on the "
                                   f"device every iteration")
                continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in self.SYNC_METHODS \
                    and not node.args and not node.keywords:
                what = self.SYNC_METHODS[node.func.attr]
                yield self.finding(ctx, node,
                                   f".{node.func.attr}() inside a loop is "
                                   f"{what} per iteration")
                continue
            first_call = (node.args[0] if node.args
                          and isinstance(node.args[0], ast.Call) else None)
            if first_call is None:
                continue
            kernel = self._kernel_result(ctx, first_call)
            if kernel is None:
                continue
            if name in self.WRAPPERS or name in self.SCALARS:
                yield self.finding(
                    ctx, node,
                    f"{name}(...) of `{kernel}`'s result inside a loop "
                    f"synchronizes host and device every iteration")


class UnseededStochasticTestRule(Rule):
    """A scope that asserts and draws unpinned randomness: numpy's or
    Python's global draws, `np.random.default_rng()` with no seed, a
    `torch.rand`/`randn`/`randint`/`randperm`/`normal`/`bernoulli`/
    `multinomial`/`rand_like`/`randn_like`/`randint_like` draw with no
    `generator=`, or a key seeded from a call (`time.time()`, ...).
    Run-to-run varying assertions are flakes."""

    rule_id = "unseeded-stochastic-test"
    description = "assert over unpinned randomness (flaky by construction)"
    hint = ("pin the seed: np.random.default_rng(<int>), a "
            "torch.Generator().manual_seed(<int>) passed as generator=, "
            "or thread an explicit seeded generator through the test")

    NP_GLOBAL_DRAWS = {"normal", "uniform", "choice", "rand", "randn",
                       "randint", "random", "permutation", "shuffle",
                       "binomial", "poisson", "standard_normal", "sample"}
    PY_DRAWS = {"random", "uniform", "randint", "choice", "shuffle",
                "sample", "gauss", "randrange", "betavariate"}
    TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
                   "bernoulli", "multinomial", "poisson", "rand_like",
                   "randn_like", "randint_like"}
    KEY_CALLS = {"jax.random.key", "jax.random.PRNGKey",
                 "torch.manual_seed"}

    @staticmethod
    def _walk_scope(root: ast.AST) -> Iterator[ast.AST]:
        """Nodes owned by `root`'s scope: everything but nested function
        defs (their draws and asserts belong to the inner scope)."""
        stack = list(ast.iter_child_nodes(root))
        while stack:
            node = stack.pop()
            yield node
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                stack.extend(ast.iter_child_nodes(node))

    def _unseeded_calls(self, ctx: ModuleContext, nodes: List[ast.AST]
                        ) -> Iterator[ast.Call]:
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            name = ctx.dotted(node.func)
            if name is None:
                continue
            tail = name.rpartition(".")[2]
            if name == "numpy.random.default_rng" and not node.args \
                    and not node.keywords:
                yield node
            elif name.startswith("numpy.random.") \
                    and tail in self.NP_GLOBAL_DRAWS:
                yield node
            elif name.startswith("random.") and tail in self.PY_DRAWS:
                yield node
            elif name == f"torch.{tail}" and tail in self.TORCH_DRAWS \
                    and not any(kw.arg == "generator"
                                for kw in node.keywords):
                yield node
            elif name in self.KEY_CALLS and node.args and any(
                    isinstance(sub, ast.Call)
                    for sub in ast.walk(node.args[0])):
                # a call inside the seed expression (time.time(),
                # os.getpid(), ...) is an entropy source; arithmetic over
                # constants and loop indices is deterministic
                yield node

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        scopes: List[ast.AST] = [ctx.tree]
        scopes += [n for n in ast.walk(ctx.tree)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for scope in scopes:
            nodes = list(self._walk_scope(scope))
            if not any(isinstance(n, ast.Assert) for n in nodes):
                continue
            for call in self._unseeded_calls(ctx, nodes):
                name = ctx.dotted(call.func)
                yield self.finding(
                    ctx, call,
                    f"`{name}` draws unpinned randomness in a scope that "
                    f"asserts on the result")


class ShardedHostMaterializeRule(Rule):
    """Host materialization of a placed tensor: `np.asarray`/`np.array`/
    `np.copy` of, or `.cpu()`/`.numpy()`/`.tolist()` on, a direct
    placement call's result or a name bound from one (`parallel/`'s
    `shard_rows` and `replicated`; `device_put` as the reference names
    it). Gathering every rank's shard through one process is the
    all-to-one transfer the mesh exists to avoid; the collectives
    (`all_reduce`, `all_gather`) are the sanctioned path. Lexical, like
    every rule here."""

    rule_id = "sharded-host-materialize"
    description = "host materialization of a placed (sharded) tensor"
    hint = ("keep the consumer on the device and reduce through a "
            "collective, or read back once after the last device step; "
            "never re-wrap a placement's result with host numpy")

    WRAPPERS = {"numpy.asarray", "numpy.array", "numpy.copy"}
    METHODS = {"cpu", "numpy", "tolist"}
    # placement helpers, recognized by tail name so both
    # `from ..mesh import shard_rows` and `mesh.shard_rows(...)` match
    PLACER_TAILS = {"device_put", "shard_rows", "replicated"}

    def _is_placer(self, ctx: ModuleContext, call: ast.Call) -> bool:
        name = ctx.dotted(call.func)
        return (name is not None
                and name.rpartition(".")[2] in self.PLACER_TAILS)

    def _placed_names(self, ctx: ModuleContext) -> Set[str]:
        """Names bound anywhere in the module from a placement call,
        tuple unpacks `a, b = put(x), put(y)` included."""
        out: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            pairs = []
            tgt, val = node.targets[0], node.value
            if isinstance(tgt, ast.Name):
                pairs.append((tgt, val))
            elif isinstance(tgt, ast.Tuple) and isinstance(val, ast.Tuple) \
                    and len(tgt.elts) == len(val.elts):
                pairs.extend(zip(tgt.elts, val.elts))
            for t, v in pairs:
                if isinstance(t, ast.Name) and isinstance(v, ast.Call) \
                        and self._is_placer(ctx, v):
                    out.add(t.id)
        return out

    def _feeds_placement(self, ctx: ModuleContext, node: ast.AST) -> bool:
        """True when `node` sits inside a placer call's arguments, as in
        ``shard_rows(mesh, np.asarray(x))``: host to device, the
        placement's input, not a placed value's materialization."""
        cur = ctx.parent(node)
        while cur is not None:
            if isinstance(cur, ast.Call) and self._is_placer(ctx, cur):
                return True
            cur = ctx.parent(cur)
        return False

    def _placed(self, ctx: ModuleContext, expr: ast.AST,
                placed: Set[str]) -> Optional[str]:
        if isinstance(expr, ast.Call) and self._is_placer(ctx, expr):
            return "a placement call's result"
        if isinstance(expr, ast.Name) and expr.id in placed:
            return f"`{expr.id}` (placed above)"
        return None

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        placed = self._placed_names(ctx)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) \
                    or self._feeds_placement(ctx, node):
                continue
            what = None
            if ctx.dotted(node.func) in self.WRAPPERS and node.args:
                what = self._placed(ctx, node.args[0], placed)
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in self.METHODS and not node.args:
                what = self._placed(ctx, node.func.value, placed)
            if what is not None:
                yield self.finding(
                    ctx, node,
                    f"host materialization of {what}: every shard "
                    f"transfers back through this process")


ALL_RULES = [DefaultInt64Rule, HostSyncInFoldRule,
             UnseededStochasticTestRule, ShardedHostMaterializeRule]


def rule_ids() -> List[str]:
    return [r.rule_id for r in ALL_RULES]


def run_rules(paths, rules=None, baseline=None, root=None,
              include_md: bool = True):
    """Check `paths` with `rules` (default: every rule here) and split
    the findings by the allowlist: the AST tier's report."""
    from avenir_tpu_torch.analysis.engine import run_paths

    active = list(rules) if rules is not None else [r() for r in ALL_RULES]
    return run_paths(paths, active, baseline, root, include_md)
