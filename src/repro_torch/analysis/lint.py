"""AST lint engine for the port's PyTorch invariants (the reference's
`repro.analysis.lint`, retargeted to torch).

The runtime can only observe a broken contract after the fact (a host
sync inside a chunk, a float64 tensor on the card, a draw from the
global RNG); these rules check them at the SOURCE level.  The engine is
stdlib-`ast` only: one parse per file, one shared `FileContext` carrying
the facts every rule needs (which functions are chunk functions, which
names hold device tensors, where `# noqa` comments sit), and a registry
of small single-invariant rules (`repro_torch.analysis.rules`).

Torch's notions replace JAX's:
  device value     a tensor from a `torch.*` factory (any `torch.` call
                   but those that return no tensor, `NON_TENSOR_CALLS`),
                   one moved with `.to(...)` / `.cuda()`, an attribute in
                   `DEVICE_ATTRS`, or a name assigned from one of these;
  chunk function   the function a chunk builder (`CHUNK_BUILDERS`:
                   `core.policy.build_device_step`, `dist.mesh2d.
                   build_device_step_2d`) returns, and every function of
                   the module it reaches by name.  A chunk must enqueue
                   its work with no host read (the driver reads once
                   after it), as CUDA-graph capture will need too.  Its
                   parameters are tensors unless annotated with another
                   type or given a constant default.

Suppression is two-level:
  * inline  -- ``# noqa`` or ``# noqa: RPT002[,RPT006]`` on the flagged
               line (an intentional read, float64 sum or draw, with its
               reason on the same line);
  * baseline -- a JSON file of accepted fingerprints
               (`repro_torch.analysis.baseline`).  The acceptance bar for
               the port is an EMPTY baseline.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set

#: attribute names that hold device tensors in the port (ViewGroup /
#: BlockedGraph / TileOverlay fields): rules use them to recognize device
#: values behind host-side containers
DEVICE_ATTRS = frozenset({
    "values", "deltas", "tiles", "nbr_ids", "push_scale", "overlay",
})

#: `torch.` calls that return no tensor (dtypes, devices, limits, the
#: runtime's own switches)
NON_TENSOR_CALLS = frozenset({
    "torch.device", "torch.dtype", "torch.finfo", "torch.iinfo",
    "torch.Size", "torch.Generator", "torch.is_tensor",
    "torch.is_floating_point", "torch.get_default_dtype",
    "torch.set_default_dtype", "torch.manual_seed", "torch.no_grad",
    "torch.inference_mode", "torch.enable_grad", "torch.set_grad_enabled",
    "torch.compile", "torch.set_num_threads", "torch.get_num_threads",
    "torch.promote_types", "torch.result_type", "torch.can_cast",
    "torch.use_deterministic_algorithms",
})
#: `torch.` sub-namespaces whose calls return no tensor
NON_TENSOR_ROOTS = ("torch.cuda.", "torch.distributed.", "torch.backends.",
                    "torch.utils.", "torch.autograd.", "torch.jit.",
                    "torch.profiler.", "torch.overrides.", "torch._C.")

#: builders whose returned function is a chunk function
CHUNK_BUILDERS = frozenset({"build_device_step", "build_device_step_2d"})

#: annotations of a tensor parameter
TENSOR_ANNOTATIONS = ("torch.Tensor", "Tensor", "Optional[torch.Tensor]",
                      "Optional[Tensor]")

_NOQA_RE = re.compile(r"#\s*noqa(?::\s*(?P<codes>[A-Z]{3}\d{3}"
                      r"(?:\s*,\s*[A-Z]{3}\d{3})*))?", re.IGNORECASE)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str          # rule id, e.g. "RPT002"
    path: str          # as given to the engine (normalized to "/")
    line: int          # 1-indexed
    col: int           # 0-indexed
    message: str
    snippet: str = ""  # the stripped source line (fingerprint input)

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}: " \
               f"{self.rule} {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class LintRule:
    """Base rule: subclasses set `rule_id`/`name`/`invariant` and implement
    `check(ctx) -> Iterable[Finding]`."""

    rule_id = "RPT000"
    name = "abstract"
    #: one-line statement of the invariant the rule protects (docs + CLI)
    invariant = ""

    def check(self, ctx: "FileContext") -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, ctx: "FileContext", node: ast.AST,
                message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        snippet = (ctx.lines[line - 1].strip()
                   if 0 < line <= len(ctx.lines) else "")
        return Finding(rule=self.rule_id, path=ctx.path, line=line,
                       col=getattr(node, "col_offset", 0),
                       message=message, snippet=snippet)


# ---------------------------------------------------------------------------
# shared AST facts
# ---------------------------------------------------------------------------


def attr_chain(node: ast.AST) -> Optional[str]:
    """Dotted name of a Name/Attribute chain ("np.random.seed"), else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_chain(node: ast.AST) -> Optional[str]:
    """Dotted name of a call's callee, else None."""
    return attr_chain(node.func) if isinstance(node, ast.Call) else None


def method_name(node: ast.AST) -> Optional[str]:
    """The method a call invokes on a value (`x.item()` -> "item")."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def is_tensor_call(node: ast.AST) -> bool:
    """A call that makes a device tensor: a `torch.` call returning one,
    or `.to(...)` / `.cuda()` of anything."""
    if not isinstance(node, ast.Call):
        return False
    chain = call_chain(node) or ""
    if chain.startswith("torch."):
        return (chain not in NON_TENSOR_CALLS
                and not chain.startswith(NON_TENSOR_ROOTS))
    return method_name(node) in ("to", "cuda")


#: attributes and methods of a tensor that the host knows without
#: reading the device
META_ATTRS = frozenset({
    "shape", "dtype", "device", "ndim", "is_cuda", "numel", "size", "dim",
    "element_size", "nbytes", "itemsize", "data_ptr", "is_contiguous",
    "stride", "layout", "requires_grad",
})


def _metadata_read(node: ast.AST) -> bool:
    """Whether `node` is read only for its metadata (`t.shape[0]`,
    `t.numel()`)."""
    parent = getattr(node, "_parent", None)
    return isinstance(parent, ast.Attribute) and parent.attr in META_ATTRS


def mentions_device_value(node: ast.AST, device_names: Set[str]) -> bool:
    """True when any sub-expression reads a known device value: a tensor
    call (`is_tensor_call`), an attribute in DEVICE_ATTRS, or a name in
    `device_names`, other than for its metadata (`META_ATTRS`)."""
    for sub in ast.walk(node):
        hit = ((isinstance(sub, ast.Attribute) and sub.attr in DEVICE_ATTRS)
               or is_tensor_call(sub)
               or (isinstance(sub, ast.Name) and sub.id in device_names))
        if hit and not _metadata_read(sub):
            return True
    return False


def own_nodes(fn: ast.AST) -> Iterable[ast.AST]:
    """The nodes of a function's own body: nested functions and lambdas
    are left to their own checks."""
    work = list(ast.iter_child_nodes(fn))
    while work:
        node = work.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            work.extend(ast.iter_child_nodes(node))


class _ParentAnnotator(ast.NodeVisitor):
    def visit(self, node):
        for child in ast.iter_child_nodes(node):
            child._parent = node  # type: ignore[attr-defined]
        super().generic_visit(node)


def parents(node: ast.AST) -> Iterable[ast.AST]:
    while True:
        node = getattr(node, "_parent", None)
        if node is None:
            return
        yield node


def _defs(tree: ast.Module) -> List[ast.FunctionDef]:
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _chunk_seeds(tree: ast.Module) -> Set[str]:
    """Names of the functions a chunk builder returns by name."""
    seeds: Set[str] = set()
    for fn in _defs(tree):
        if fn.name not in CHUNK_BUILDERS:
            continue
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Return) and isinstance(sub.value,
                                                          ast.Name):
                seeds.add(sub.value.id)
    return seeds


def _local_call_graph(tree: ast.Module) -> Dict[str, Set[str]]:
    """function name -> names of module/nested functions it calls."""
    defs = {n.name for n in _defs(tree)}
    graph: Dict[str, Set[str]] = {}
    for node in _defs(tree):
        callees: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                    and sub.func.id in defs:
                callees.add(sub.func.id)
            elif isinstance(sub, ast.Name) and sub.id in defs:
                callees.add(sub.id)
        graph[node.name] = callees - {node.name}
    return graph


def chunk_functions(tree: ast.Module) -> Set[str]:
    """Names of the chunk functions: the builders' returned functions
    plus everything they reach through local calls."""
    seeds = _chunk_seeds(tree)
    graph = _local_call_graph(tree)
    reached, work = set(seeds), list(seeds)
    while work:
        for callee in graph.get(work.pop(), ()):
            if callee not in reached:
                reached.add(callee)
                work.append(callee)
    return reached - CHUNK_BUILDERS


def tensor_params(fn: ast.FunctionDef) -> Set[str]:
    """A chunk function's parameters that hold tensors: all but those
    annotated with another type or given a constant (not None)
    default."""
    args = fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
    pos_defaults = [None] * (len(fn.args.posonlyargs + fn.args.args)
                             - len(fn.args.defaults)) + fn.args.defaults
    defaults = pos_defaults + list(fn.args.kw_defaults)
    out = set()
    for a, d in zip(args, defaults):
        if a.annotation is not None and \
                ast.unparse(a.annotation) not in TENSOR_ANNOTATIONS:
            continue
        if isinstance(d, ast.Constant) and d.value is not None:
            continue
        out.add(a.arg)
    return out


class FileContext:
    """Everything rules need about one source file, computed once."""

    def __init__(self, path: str, source: str):
        self.path = path.replace("\\", "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        _ParentAnnotator().visit(self.tree)
        self.chunks: Set[str] = chunk_functions(self.tree)
        self._noqa: Dict[int, Optional[Set[str]]] = {}
        for i, line in enumerate(self.lines, 1):
            m = _NOQA_RE.search(line)
            if m:
                codes = m.group("codes")
                self._noqa[i] = (None if codes is None else
                                 {c.strip().upper()
                                  for c in codes.split(",")})

    # -- helpers -------------------------------------------------------------

    def functions(self) -> List[ast.FunctionDef]:
        return _defs(self.tree)

    def in_chunk_function(self, node: ast.AST) -> bool:
        for p in parents(node):
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return p.name in self.chunks
        return False

    def enclosing_loop(self, node: ast.AST) -> Optional[ast.AST]:
        """Nearest enclosing host loop (incl. comprehensions: a per-
        element read in a listcomp is the same cost as in a for loop),
        stopping at a function boundary."""
        for p in parents(node):
            if isinstance(p, (ast.For, ast.While, ast.ListComp,
                              ast.SetComp, ast.DictComp,
                              ast.GeneratorExp)):
                return p
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return None
        return None

    def local_device_names(self, fn: ast.AST,
                           seed: Iterable[str] = ()) -> Set[str]:
        """Names assigned (anywhere in `fn`) from a tensor call, a
        DEVICE_ATTRS attribute read, another such name or a method of one
        (`x = t.sum()`), and `seed` names (a chunk function's tensor
        parameters), to a fixpoint."""
        assigns = [(sub.targets[0], sub.value) for sub in own_nodes(fn)
                   if isinstance(sub, ast.Assign) and len(sub.targets) == 1]
        names: Set[str] = set(seed)
        while True:
            before = len(names)
            for tgt, src in assigns:
                if _device_source(src, names):
                    if isinstance(tgt, ast.Name):
                        names.add(tgt.id)
                    elif isinstance(tgt, ast.Tuple):
                        names.update(e.id for e in tgt.elts
                                     if isinstance(e, ast.Name))
            if len(names) == before:
                return names

    def suppressed(self, finding: Finding) -> bool:
        codes = self._noqa.get(finding.line, False)
        if codes is False:
            return False
        return codes is None or finding.rule in codes


#: tensor methods whose result lives on the host
_HOST_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "__array__"})


def _device_source(src: ast.AST, names: Set[str]) -> bool:
    """Whether an assignment from `src` holds a device value: a tensor
    call, a DEVICE_ATTRS read, or a method (not a host read) of a name
    in `names`, subscripts looked through."""
    while isinstance(src, ast.Subscript):
        src = src.value
    if is_tensor_call(src) or (isinstance(src, ast.Attribute)
                               and src.attr in DEVICE_ATTRS):
        return True
    if isinstance(src, ast.Name):           # `it, vs = carry[:2]`
        return src.id in names
    if not (isinstance(src, ast.Call) and isinstance(src.func, ast.Attribute)
            and src.func.attr not in _HOST_METHODS):
        return False
    root = src.func.value
    while isinstance(root, (ast.Attribute, ast.Subscript, ast.Call)):
        if isinstance(root, ast.Call):
            if method_name(root) in _HOST_METHODS:
                return False
            root = root.func
        else:
            root = root.value
    return isinstance(root, ast.Name) and root.id in names


# ---------------------------------------------------------------------------
# running
# ---------------------------------------------------------------------------


def lint_source(path: str, source: str,
                rules: Sequence[LintRule]) -> List[Finding]:
    """All (non-inline-suppressed) findings for one file."""
    try:
        ctx = FileContext(path, source)
    except SyntaxError as e:
        return [Finding(rule="RPT999", path=path, line=e.lineno or 1,
                        col=(e.offset or 1) - 1,
                        message=f"syntax error: {e.msg}")]
    out: List[Finding] = []
    for rule in rules:
        for f in rule.check(ctx):
            if not ctx.suppressed(f):
                out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def lint_paths(paths: Sequence[str],
               rules: Optional[Sequence[LintRule]] = None) -> List[Finding]:
    """Lint every .py file under `paths` (files or directories)."""
    from repro_torch.analysis.rules import default_rules
    rules = list(rules) if rules is not None else default_rules()
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    findings: List[Finding] = []
    for fp in files:
        with open(fp, "r", encoding="utf-8") as fh:
            findings.extend(lint_source(fp, fh.read(), rules))
    return findings
