"""The port's lint rules over the shared FileContext, one invariant each,
in the reference's order (`repro.analysis.rules`, RPA001-RPA007); the ids
are stable (baseline fingerprints and `# noqa: RPTxxx` marks name them):

  RPT001 chunk-host-sync  Python control flow or scalar coercion of a
                          tensor inside a chunk function (a host read
                          mid-chunk: a sync, and no CUDA-graph capture).
  RPT002 loop-host-sync   An implicit device->host read in a host loop
                          (`.item()`, `.tolist()`, `.cpu()`, `.numpy()`,
                          `float/int/bool(t)`): one blocking sync per
                          iteration.  The driver's one read per chunk is
                          marked where it stands.
  RPT003 select-dtype     The selection dtype contract: arrays and tensors
                          created in scheduling modules name their dtype
                          (numpy defaults to float64/int64, torch's
                          arange to int64, and they drift across the
                          host/device boundary).
  RPT004 nondeterminism   Wall-clock values, global RNG (`random`,
                          `np.random.*`), torch draws without
                          `generator=`, `torch.manual_seed` in library
                          code and a `torch.Generator` never seeded.
  RPT005 compile-cache    Per-call `torch.compile` / kernel loading of an
                          ephemeral callable, and unhashable objects in a
                          cache-key tuple (`GraphSession._device_step_fn`).
  RPT006 f64-device       Explicit float64 (`torch.float64`,
                          `torch.double`, `.double()`): on a card it
                          halves the bandwidth and the rate; the port's
                          deliberate exact sums are marked.
  RPT007 set-iteration    Iterating a set in scheduling code: hash order
                          reaches the schedule.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from repro_torch.analysis.lint import (DEVICE_ATTRS, META_ATTRS,
                                       FileContext, Finding, LintRule,
                                       attr_chain, call_chain,
                                       is_tensor_call, mentions_device_value,
                                       method_name, own_nodes, parents,
                                       tensor_params)

#: modules whose array creations participate in scheduling decisions:
#: the selection dtype contract (RPT003) applies to them
SELECTION_MODULES = ("core/do_select.py", "core/global_q.py",
                     "core/policy.py", "core/scheduler.py",
                     "core/priority.py", "serve/concurrent.py")

_COERCIONS = ("float", "int", "bool", "complex")
_NP_MATERIALIZE = ("np.asarray", "np.array", "numpy.asarray", "numpy.array")
#: tensor methods that read the device from the host
_READS = ("item", "tolist", "cpu", "numpy")
#: methods only a tensor has (flagged whatever the receiver looks like)
_TENSOR_ONLY_READS = ("cpu", "numpy")
#: ops whose output shape depends on the data (a host sync on a card)
_DATA_SHAPED = ("nonzero", "masked_select", "unique", "unique_consecutive",
                "argwhere")


def _in_selection_module(ctx: FileContext) -> bool:
    return any(ctx.path.endswith(m) for m in SELECTION_MODULES)


def _dtype_of_call(node: ast.Call) -> Optional[ast.AST]:
    """The dtype argument of an array-creation call, positional (numpy) or
    keyword."""
    for kw in node.keywords:
        if kw.arg == "dtype":
            return kw.value
    chain = call_chain(node) or ""
    if chain.startswith("torch."):
        return None                       # torch takes dtype by keyword
    leaf = chain.rsplit(".", 1)[-1]
    pos = {"zeros": 1, "ones": 1, "empty": 1, "arange": None,
           "full": 2, "asarray": 1, "array": 1}.get(leaf)
    if pos is not None and len(node.args) > pos:
        return node.args[pos]
    return None


def _names_64bit(node: ast.AST) -> bool:
    chain = attr_chain(node)
    if chain and chain.rsplit(".", 1)[-1] in ("float64", "int64", "uint64"):
        return True
    return (isinstance(node, ast.Constant)
            and node.value in ("float64", "int64", "uint64"))


def _read_of(sub: ast.Call, device) -> Optional[str]:
    """The host read `sub` makes of a device value, as a label, else None:
    a read method, a scalar coercion or a numpy materialization."""
    meth = method_name(sub)
    parent = getattr(sub, "_parent", None)
    if meth == "cpu" and isinstance(parent, ast.Attribute) \
            and parent.attr == "numpy":
        return None                       # `t.cpu().numpy()`: one read
    if meth in _READS:
        if meth in _TENSOR_ONLY_READS or mentions_device_value(
                sub.func.value, device):
            return f"`.{meth}()`"
        return None
    chain = call_chain(sub)
    if (chain in _COERCIONS or chain in _NP_MATERIALIZE) and sub.args \
            and mentions_device_value(sub.args[0], device):
        return f"`{chain}()`"
    return None


class ChunkHostSyncRule(LintRule):
    rule_id = "RPT001"
    name = "chunk-host-sync"
    invariant = ("a chunk function never branches on / coerces / reads a "
                 "tensor on the host (`if`/`while`/`assert`, `bool()`/"
                 "`int()`/`float()`, `.item()`/`.tolist()`/`.cpu()`/"
                 "`.numpy()`, data-shaped ops): use torch.where and keep "
                 "the read to the driver")

    @staticmethod
    def _tensor_test(test: ast.AST, device) -> bool:
        """A tensor reaches `test` in a VALUE position.  A seed is
        discounted when, climbing toward the test root, it passes through
        structure that makes the branch static: an attribute read
        (`x.shape`, `ov.capacity`; not a method call, `x.sum()`, but
        those in `META_ATTRS`, `x.numel()`), an `is`/`is not` comparison, a
        comparison against a string constant, or membership in an
        all-constant collection (the reference's rule)."""
        def _static_compare(cmp: ast.Compare) -> bool:
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in cmp.ops):
                return True
            operands = [cmp.left] + list(cmp.comparators)
            if any(isinstance(o, ast.Constant) and isinstance(o.value, str)
                   for o in operands):
                return True
            if all(isinstance(op, (ast.In, ast.NotIn)) for op in cmp.ops):
                return all(
                    isinstance(c, (ast.Tuple, ast.List, ast.Set))
                    and all(isinstance(e, ast.Constant) for e in c.elts)
                    for c in cmp.comparators)
            return False

        seeds = []
        for sub in ast.walk(test):
            if isinstance(sub, ast.Name) and sub.id in device:
                seeds.append(sub)
            elif isinstance(sub, ast.Attribute) \
                    and sub.attr in DEVICE_ATTRS:
                seeds.append(sub)
            elif is_tensor_call(sub):
                seeds.append(sub)
        for seed in seeds:
            static = False
            for p in parents(seed):
                if isinstance(p, ast.Attribute):
                    up = getattr(p, "_parent", None)
                    if p.attr in META_ATTRS or not (
                            isinstance(up, ast.Call) and up.func is p):
                        static = True   # metadata read off the value
                        break
                    continue            # a tensor method: a tensor still
                if isinstance(p, ast.Compare) and _static_compare(p):
                    static = True
                    break
                if p is test:
                    break
            if not static:
                return True
        return False

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for fn in ctx.functions():
            if fn.name not in ctx.chunks:
                continue
            device = ctx.local_device_names(fn, tensor_params(fn))
            for sub in own_nodes(fn):
                if isinstance(sub, (ast.If, ast.While, ast.Assert,
                                    ast.IfExp)):
                    if self._tensor_test(sub.test, device):
                        kind = type(sub).__name__.lower()
                        out.append(self.finding(
                            ctx, sub,
                            f"Python `{kind}` on a tensor inside chunk "
                            f"function `{fn.name}`: a host read mid-chunk "
                            f"(use torch.where)"))
                elif isinstance(sub, ast.Call):
                    label = _read_of(sub, device)
                    if label is None and (
                            method_name(sub) in _DATA_SHAPED
                            or (call_chain(sub) or "").rsplit(".", 1)[-1]
                            in _DATA_SHAPED and is_tensor_call(sub)):
                        label = f"`{method_name(sub)}` (data-shaped)"
                    if label is not None:
                        out.append(self.finding(
                            ctx, sub,
                            f"{label} of a tensor inside chunk function "
                            f"`{fn.name}`: a host read mid-chunk"))
        return out


class LoopHostSyncRule(LintRule):
    rule_id = "RPT002"
    name = "loop-host-sync"
    invariant = ("host loops never read device tensors per iteration "
                 "(`.item()`, `.tolist()`, `.cpu()`, `.numpy()`, "
                 "`float/int/bool(t)`): hoist one batched read above the "
                 "loop; the driver's one read per chunk is marked")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for fn in ctx.functions():
            if fn.name in ctx.chunks:
                continue  # chunk bodies are RPT001's territory
            device = ctx.local_device_names(fn)
            for sub in own_nodes(fn):
                if not isinstance(sub, ast.Call) \
                        or ctx.enclosing_loop(sub) is None:
                    continue
                label = _read_of(sub, device)
                if label is not None:
                    out.append(self.finding(
                        ctx, sub,
                        f"{label} on a device tensor inside a loop: one "
                        f"blocking device->host sync per iteration — "
                        f"hoist a single batched read above the loop"))
        return out


class SelectDtypeRule(LintRule):
    rule_id = "RPT003"
    name = "select-dtype"
    invariant = ("arrays and tensors created in scheduling modules name "
                 "their dtype (numpy's float64/int64 and torch.arange's "
                 "int64 defaults drift across the host/device boundary); "
                 "selections are int32")

    _CREATORS = ("np.zeros", "np.ones", "np.empty", "np.full", "np.arange",
                 "numpy.zeros", "numpy.ones", "numpy.empty", "numpy.full",
                 "numpy.arange", "torch.zeros", "torch.ones", "torch.empty",
                 "torch.full", "torch.arange")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if not _in_selection_module(ctx):
            return []
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = call_chain(node)
            if chain in self._CREATORS:
                if _dtype_of_call(node) is None:
                    out.append(self.finding(
                        ctx, node,
                        f"`{chain}` without an explicit dtype in a "
                        f"scheduling module: its default dtype drifts "
                        f"when it crosses between host and device"))
            elif method_name(node) == "astype" and node.args:
                tgt = node.args[0]
                if (_names_64bit(tgt) or (isinstance(tgt, ast.Name)
                                          and tgt.id == "int")) \
                        and mentions_device_value(node.func.value, set()):
                    out.append(self.finding(
                        ctx, node,
                        "64-bit astype on a device value breaks the int32 "
                        "selection contract"))
        return out


class NondeterminismRule(LintRule):
    rule_id = "RPT004"
    name = "nondeterminism"
    invariant = ("library code draws no entropy outside a threaded seed: "
                 "no wall-clock values, no global numpy/stdlib RNG, torch "
                 "draws through a seeded `generator=`, no "
                 "`torch.manual_seed` — schedules replay bit-identically")

    _NP_GLOBAL = {"seed", "rand", "randn", "randint", "random", "choice",
                  "shuffle", "permutation", "uniform", "normal",
                  "standard_normal", "integers"}
    _STDLIB = {"random.random", "random.randint", "random.choice",
               "random.shuffle", "random.seed", "random.sample",
               "random.uniform", "random.randrange", "random.getrandbits"}
    _TORCH_DRAWS = {"torch.rand", "torch.randn", "torch.randint",
                    "torch.randperm", "torch.normal", "torch.multinomial",
                    "torch.bernoulli", "torch.poisson", "torch.rand_like",
                    "torch.randn_like", "torch.randint_like"}
    _TENSOR_DRAWS = {"uniform_", "normal_", "random_", "bernoulli_",
                     "exponential_", "geometric_", "cauchy_", "log_normal_"}
    _TORCH_SEEDS = {"torch.manual_seed", "torch.seed",
                    "torch.random.manual_seed", "torch.random.seed",
                    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                    "torch.cuda.seed", "torch.cuda.seed_all"}

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = call_chain(node) or ""
            f = self._language(ctx, node, chain) or self._torch(
                ctx, node, chain)
            if f is not None:
                out.append(f)
        return out

    def _language(self, ctx, node, chain) -> Optional[Finding]:
        """The reference's findings (the language's and numpy's RNG)."""
        if chain in ("time.time", "time.time_ns"):
            return self.finding(
                ctx, node,
                "`time.time()` in library code: wall-clock values leak "
                "into behaviour (use time.perf_counter for durations, a "
                "threaded seed for randomness)")
        if chain in ("datetime.datetime.now", "datetime.now",
                     "datetime.datetime.utcnow"):
            return self.finding(ctx, node, f"`{chain}()` in library code "
                                           f"is nondeterministic")
        if chain in ("np.random.default_rng", "numpy.random.default_rng"):
            if not node.args and not node.keywords:
                return self.finding(
                    ctx, node,
                    "`np.random.default_rng()` without a seed draws OS "
                    "entropy — thread an explicit seed")
            return None
        if chain.startswith(("np.random.", "numpy.random.")) \
                and chain.rsplit(".", 1)[-1] in self._NP_GLOBAL:
            return self.finding(
                ctx, node,
                f"global numpy RNG `{chain}` — shared mutable state, not "
                f"replayable; use np.random.default_rng(seed)")
        if chain in self._STDLIB:
            return self.finding(ctx, node, f"stdlib `{chain}` — global "
                                           f"RNG in library code")
        if chain in ("os.urandom", "uuid.uuid4", "secrets.token_hex"):
            return self.finding(ctx, node, f"`{chain}` draws OS entropy "
                                           f"in library code")
        return None

    def _torch(self, ctx, node, chain) -> Optional[Finding]:
        has_gen = any(kw.arg == "generator" for kw in node.keywords)
        if chain in self._TORCH_DRAWS and not has_gen:
            return self.finding(
                ctx, node,
                f"`{chain}` without `generator=` draws from torch's global "
                f"RNG — pass a seeded torch.Generator")
        if method_name(node) in self._TENSOR_DRAWS and not has_gen:
            return self.finding(
                ctx, node,
                f"`.{method_name(node)}()` without `generator=` draws "
                f"from torch's global RNG — pass a seeded torch.Generator")
        if chain in self._TORCH_SEEDS:
            return self.finding(
                ctx, node,
                f"`{chain}` in library code reseeds the process-global "
                f"RNG — thread a seeded torch.Generator instead")
        if chain == "torch.Generator" and not self._seeded(ctx, node):
            return self.finding(
                ctx, node,
                "`torch.Generator` never seeded: it starts from a fixed "
                "default seed shared by every unseeded generator — call "
                ".manual_seed(seed) on it")
        return None

    @staticmethod
    def _seeded(ctx: FileContext, node: ast.Call) -> bool:
        """`torch.Generator(...).manual_seed(...)`, or a name it is bound
        to whose `.manual_seed(...)` is called in the same function."""
        parent = next(iter(parents(node)), None)
        if isinstance(parent, ast.Attribute) and parent.attr == "manual_seed":
            return True
        if not (isinstance(parent, ast.Assign) and len(parent.targets) == 1
                and isinstance(parent.targets[0], ast.Name)):
            return False
        name = parent.targets[0].id
        scope = next((p for p in parents(node)
                      if isinstance(p, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))), ctx.tree)
        return any(isinstance(sub, ast.Call)
                   and attr_chain(sub.func) == f"{name}.manual_seed"
                   for sub in ast.walk(scope))


class CompileCacheRule(LintRule):
    rule_id = "RPT005"
    name = "compile-cache"
    invariant = ("compiled callables and kernel libraries are built once "
                 "and cached: no per-call `torch.compile` / library load "
                 "of an ephemeral lambda/closure, and cache-key tuples "
                 "hold only hashable, stable components")

    _COMPILERS = ("torch.compile", "torch.jit.script", "torch.jit.trace",
                  "ctypes.CDLL", "ctypes.cdll.LoadLibrary",
                  "torch.utils.cpp_extension.load",
                  "torch.utils.cpp_extension.load_inline",
                  "cpp_extension.load", "cpp_extension.load_inline",
                  "load_library", "common.load_library", "triton.jit")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) \
                    and call_chain(node) in self._COMPILERS and node.args:
                f = self._check_site(ctx, node)
                if f is not None:
                    out.append(f)
            elif isinstance(node, ast.Assign):
                out.extend(self._check_key_tuple(ctx, node))
        return out

    def _check_site(self, ctx: FileContext,
                    node: ast.Call) -> Optional[Finding]:
        chain = call_chain(node)
        fns = [p for p in parents(node)
               if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef))]
        if not fns:
            return None  # module level: built once per process
        if any(attr_chain(d) in ("functools.cache", "functools.lru_cache",
                                 "cache", "lru_cache")
               or call_chain(d) in ("functools.lru_cache", "lru_cache")
               for d in fns[0].decorator_list):
            return None  # the enclosing function is itself cached
        parent = next(iter(parents(node)), None)
        if isinstance(parent, ast.Call) and parent.func is node:
            return self.finding(
                ctx, node,
                f"`{chain}(...)(...)` called inline: the compiled callable "
                f"dies with the expression — every call compiles again; "
                f"hoist it")
        guarded = cached = returned = in_loop = False
        for p in parents(node):
            if isinstance(p, ast.If) and any(
                    isinstance(op, (ast.NotIn, ast.Is))
                    for cmp in ast.walk(p.test)
                    if isinstance(cmp, ast.Compare) for op in cmp.ops):
                guarded = True
            if isinstance(p, ast.Assign) and any(
                    isinstance(t, ast.Subscript) for t in p.targets):
                cached = True
            if isinstance(p, ast.Return):
                returned = True
            if isinstance(p, (ast.For, ast.While)):
                in_loop = True
        if guarded or cached:
            return None
        if returned and not in_loop:
            return None  # factory: the caller owns caching
        if isinstance(node.args[0], ast.Lambda) or in_loop:
            return self.finding(
                ctx, node,
                f"per-call `{chain}` of an ephemeral callable without a "
                f"cache guard: every call compiles again — store it in a "
                f"keyed cache (see GraphSession._jit_cache)")
        return None

    def _check_key_tuple(self, ctx: FileContext,
                         node: ast.Assign) -> Iterable[Finding]:
        tgt = node.targets[0] if len(node.targets) == 1 else None
        if not (isinstance(tgt, ast.Name) and "key" in tgt.id.lower()):
            return []
        if not isinstance(node.value, ast.Tuple):
            return []
        out = []
        for elt in node.value.elts:
            if isinstance(elt, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                                ast.DictComp, ast.SetComp)):
                out.append(self.finding(
                    ctx, elt,
                    f"unhashable {type(elt).__name__} inside the cache-key "
                    f"tuple `{tgt.id}`: the cache lookup raises TypeError "
                    f"— use a tuple"))
        return out


class F64DeviceRule(LintRule):
    rule_id = "RPT006"
    name = "f64-device"
    invariant = ("tensors never name float64: on a card it doubles the "
                 "bytes and runs at a fraction of the float32 rate; a "
                 "deliberate exact sum is marked with its reason")

    _NAMES = ("torch.float64", "torch.double", "torch.complex128",
              "torch.cdouble")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Attribute) \
                    and attr_chain(node) in self._NAMES:
                out.append(self.finding(
                    ctx, node, f"`{attr_chain(node)}` names a 64-bit "
                               f"float dtype"))
            elif isinstance(node, ast.Call) \
                    and method_name(node) == "double" and not node.args:
                out.append(self.finding(
                    ctx, node, "`.double()` makes a float64 tensor"))
        return out


class SetIterationRule(LintRule):
    rule_id = "RPT007"
    name = "set-iteration"
    invariant = ("scheduling code never iterates a set directly: hash "
                 "order (PYTHONHASHSEED-dependent for strings) would reach "
                 "the schedule — wrap in sorted()")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        iters = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters.append((node, node.iter))
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                iters.extend((node, gen.iter) for gen in node.generators)
        for node, it in iters:
            if self._is_set_expr(it):
                out.append(self.finding(
                    ctx, node,
                    "iterating a set: order is hash-dependent and can "
                    "reach scheduling decisions — iterate sorted(...) "
                    "instead"))
        return out

    @staticmethod
    def _is_set_expr(node: ast.AST) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call) and call_chain(node) in ("set",
                                                               "frozenset"):
            return True
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitOr, ast.BitAnd, ast.Sub)):
            return (SetIterationRule._is_set_expr(node.left)
                    or SetIterationRule._is_set_expr(node.right))
        return False


def default_rules() -> List[LintRule]:
    """The registry, id-ordered (stable for docs, CLI and reports)."""
    return [ChunkHostSyncRule(), LoopHostSyncRule(), SelectDtypeRule(),
            NondeterminismRule(), CompileCacheRule(), F64DeviceRule(),
            SetIterationRule()]
