"""The port's analysis layer (`repro_torch.analysis`) against
`repro.analysis`.

(a) One flagging and one passing source fixture per rule (RPT001-RPT007,
the reference's invariants retargeted to torch); (b) the engine's
mechanics as the reference's: `# noqa` and `# noqa: RPTxxx`, the
baseline and its fingerprints (equal to `repro.analysis.baseline`'s for
the same finding), the CLI's exit codes and report; (c) the language-
level rules (wall clock, global RNG, set iteration) give the reference's
findings, line and column, on every source snippet of the reference's
own tests (tests/test_analysis_lint.py); (d) `src/repro_torch` lints
clean with an empty baseline and the new modules import neither JAX nor
`repro`; (e) the runtime sentinels; (f) `contracts.check_all` on the
CPU, and a chunk with an added host read or a float64 op flagged.
"""

import ast
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import __main__ as rmain  # noqa: E402
from repro.analysis import baseline as rbaseline  # noqa: E402
from repro.analysis import lint as rlint  # noqa: E402
from repro.analysis import rules as rrules  # noqa: E402
from repro_torch.analysis import __main__ as tmain  # noqa: E402
from repro_torch.analysis import baseline as tbaseline  # noqa: E402
from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.analysis.lint import lint_paths, lint_source  # noqa: E402
from repro_torch.analysis.rules import default_rules  # noqa: E402
from repro_torch.analysis.sentinels import (HostSyncError,  # noqa: E402
                                            RetraceError, no_implicit_syncs,
                                            retrace_sentinel)

ROOT = Path(__file__).resolve().parent.parent
RULES = default_rules()
SCHED = "src/repro_torch/core/policy.py"


def ids(source: str, path: str = SCHED):
    return {f.rule for f in lint_source(path, textwrap.dedent(source),
                                        RULES)}


# --------------------------------------------------------------------------
# (a) one flagging and one passing fixture per rule
# --------------------------------------------------------------------------

FLAGGED = {
    "RPT001": """
        import torch

        def build_device_step(policy, sess):
            def step_fn(state, max_steps):
                if state.sum() > 0:          # a host read mid-chunk
                    state = state + 1
                return state, float(state.max())
            return step_fn
        """,
    "RPT002": """
        import torch

        def drive(step, n, dev):
            state = torch.zeros(4, device=dev)
            out = []
            for _ in range(n):
                state = step(state)
                out.append(state.sum().item())   # one sync an iteration
            return out
        """,
    "RPT003": """
        import numpy as np
        import torch

        def queue(n, dev):
            return np.zeros(n), torch.arange(n, device=dev)
        """,
    "RPT004": """
        import torch

        def draw(shape):
            g = torch.Generator()
            return torch.randn(shape), torch.rand(shape, generator=g)
        """,
    "RPT005": """
        import torch

        def step(f, x):
            return torch.compile(f)(x)
        """,
    "RPT006": """
        import torch

        def exact(x):
            return x.to(torch.float64).sum(), x.double()
        """,
    "RPT007": """
        def seeds_to_stack(seeds):
            return [s for s in set(seeds)]
        """,
}

PASSING = {
    "RPT001": """
        import torch

        def build_device_step(policy, sess):
            q = int(sess.q)                  # the builder runs on the host

            def superstep(carry, overlay, semiring: str,
                          use_kernel: bool = False):
                if overlay is None or overlay.capacity == 0:
                    carry = carry + 0
                if semiring == "plus_times" and use_kernel:
                    carry = carry * 2
                if carry.shape[0] > 1:
                    carry = torch.where(carry > 0, carry, 0.0)
                return carry

            def step_fn(state):
                return superstep(state, None, "plus_times"), q
            return step_fn

        def report(t):
            if t.sum() > 0:                  # host code may read
                return float(t.max())
        """,
    "RPT002": """
        import numpy as np
        import torch

        def drive(xs, arrays):
            vals = torch.stack(xs).tolist()   # one batched read
            sizes = [int(x.shape[0]) for x in xs]
            return vals, sizes, [a.item() for a in arrays]
        """,
    "RPT003": """
        import numpy as np
        import torch

        def queue(n, dev):
            return (np.zeros(n, dtype=np.int32),
                    torch.arange(n, dtype=torch.int32, device=dev))
        """,
    "RPT004": """
        import time
        import torch

        def draw(shape, seed, dev):
            g = torch.Generator(device=dev)
            g.manual_seed(seed)
            h = torch.Generator().manual_seed(seed)
            t0 = time.perf_counter()
            x = torch.randn(shape, generator=g) + torch.rand(shape,
                                                             generator=h)
            return x, time.perf_counter() - t0
        """,
    "RPT005": """
        import functools
        import torch

        _CACHE = {}

        @functools.cache
        def compiled(f):
            return torch.compile(f)

        def step(key, f, x):
            if key not in _CACHE:
                _CACHE[key] = torch.compile(f)
            cache_key = ("superstep", key, (1, 2))
            return _CACHE[key](x), cache_key
        """,
    "RPT006": """
        import numpy as np
        import torch

        def counts(x):
            return x.to(torch.float32), np.zeros(3, dtype=np.float64)
        """,
    "RPT007": """
        def seeds_to_stack(seeds):
            return sorted(set(seeds))
        """,
}


@pytest.mark.parametrize("rule", sorted(FLAGGED))
def test_rule_flags_its_fixture(rule):
    assert rule in ids(FLAGGED[rule])


@pytest.mark.parametrize("rule", sorted(PASSING))
def test_rule_passes_its_fixture(rule):
    assert rule not in ids(PASSING[rule])


def test_rules_are_the_reference_invariants_in_order():
    assert [r.rule_id for r in RULES] == [f"RPT00{i}" for i in range(1, 8)]
    assert len(rrules.default_rules()) == len(RULES)


def test_chunk_reads_counted_one_by_one():
    """Every host read of RPT001's fixture is its own finding."""
    src = textwrap.dedent(FLAGGED["RPT001"])
    found = [f for f in lint_source(SCHED, src, RULES) if f.rule == "RPT001"]
    assert [f.line for f in found] == [6, 8]


def test_select_dtype_scoped_to_selection_modules():
    src = FLAGGED["RPT003"]
    assert "RPT003" not in ids(src, "src/repro_torch/graph/generators.py")


def test_torch_rng_findings():
    found = [f for f in lint_source(SCHED, textwrap.dedent(
        FLAGGED["RPT004"]), RULES) if f.rule == "RPT004"]
    assert [f.line for f in found] == [5, 6]     # unseeded, no generator=
    assert "RPT004" in ids("import torch\ndef f():\n    torch.manual_seed(0)\n")


# --------------------------------------------------------------------------
# (b) engine mechanics, against the reference's
# --------------------------------------------------------------------------

def test_noqa_suppresses_as_the_reference():
    base = "import time\ndef f():\n    return time.time()"
    for suffix, want in (("", {"RPT004"}), ("  # noqa", set()),
                         ("  # noqa: RPT004 - a reason", set()),
                         ("  # noqa: RPT006", {"RPT004"})):
        assert ids(base + suffix + "\n", "src/x.py") == want, suffix


def test_fingerprints_equal_the_reference():
    src = ("import time\ndef f():\n    a = time.time()\n"
           "    b = time.time()\n    return a + b\n")
    port = lint_source("src/x.py", src, RULES)
    ref = rlint.lint_source("src/x.py", src, rrules.default_rules())
    assert len(port) == len(ref) == 2
    for (pf, pfp), (rf, rfp) in zip(tbaseline.fingerprints(port),
                                    rbaseline.fingerprints(ref)):
        assert pfp.replace("RPT004", "RPA004") == rfp
        assert tbaseline.fingerprint(pf) .replace("RPT", "RPA") == \
            rbaseline.fingerprint(rf)


def test_baseline_roundtrip_filters(tmp_path):
    src = ("import time\ndef f():\n"
           "    a = time.time()\n    b = time.time()\n    return a + b\n")
    findings = lint_source("src/x.py", src, RULES)
    bl = tmp_path / "baseline.json"
    assert tbaseline.write(str(bl), findings) == 2
    accepted = tbaseline.load(str(bl))
    assert tbaseline.filter_findings(findings, accepted) == []
    assert len(accepted) == 2


def test_syntax_error_reported_not_raised():
    assert [f.rule for f in lint_source("src/b.py", "def f(:\n", RULES)] \
        == ["RPT999"]


@pytest.mark.parametrize("case", ["clean", "dirty", "usage", "baseline",
                                  "json"])
def test_cli_exit_codes_equal_the_reference(tmp_path, case, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("import numpy as np\n\n\ndef f(n):\n"
                     "    return np.arange(n, dtype=np.int32)\n")
    dirty = tmp_path / "dirty.py"
    dirty.write_text("import time\n\n\ndef f():\n    return time.time()\n")
    codes = {}
    for tag, main in (("ref", rmain.main), ("port", tmain.main)):
        out = tmp_path / tag
        out.mkdir()
        argv = {"clean": [str(clean)], "dirty": [str(dirty)], "usage": [],
                "json": [str(dirty), "--json", str(out / "r.json")]}.get(
            case)
        if case == "baseline":
            bl = str(out / "bl.json")
            assert main([str(dirty), "--write-baseline", bl]) == 0
            argv = [str(dirty), "--baseline", bl]
        codes[tag] = main(argv)
        if case == "json":
            report = json.loads((out / "r.json").read_text())
            assert report["findings"][0]["line"] == 5
            assert sum(report["counts"].values()) == 1
            assert len(report["rules"]) == 7
    capsys.readouterr()
    assert codes["port"] == codes["ref"] == {
        "clean": 0, "dirty": 1, "usage": 2, "baseline": 0, "json": 1}[case]


# --------------------------------------------------------------------------
# (c) the language-level rules against the reference's own snippets
# --------------------------------------------------------------------------

def _reference_snippets():
    """Every source string the reference's lint tests hand the engine
    (`run_lint(...)`, `lint_source(path, ...)`, the TP table)."""
    tree = ast.parse((ROOT / "tests" / "test_analysis_lint.py").read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            args = {"run_lint": node.args[:1],
                    "lint_source": node.args[1:2]}.get(node.func.id, [])
            out += [textwrap.dedent(a.value) for a in args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str)]
        elif isinstance(node, ast.Assign) and isinstance(node.value,
                                                         ast.Dict):
            out += [v.value for v in node.value.values
                    if isinstance(v, ast.Constant)
                    and isinstance(v.value, str)]
    return out


def test_language_rules_match_the_reference_on_its_snippets():
    snippets = _reference_snippets()
    assert len(snippets) >= 30
    pairs = (("RPA004", "RPT004"), ("RPA007", "RPT007"),
             ("RPA999", "RPT999"))
    port_rules = [r for r in RULES if r.rule_id in ("RPT004", "RPT007")]
    ref_rules = [r for r in rrules.default_rules()
                 if r.rule_id in ("RPA004", "RPA007")]
    hits = 0
    for src in snippets:
        ref = [(f.rule, f.line, f.col) for f in rlint.lint_source(
            "src/repro/core/policy.py", src, ref_rules)]
        port = [(f.rule, f.line, f.col) for f in lint_source(
            "src/repro/core/policy.py", src, port_rules)]
        for a, b in pairs:
            ref = [(b,) + r[1:] if r[0] == a else r for r in ref]
        assert port == ref, src
        hits += len(ref)
    assert hits >= 6


# --------------------------------------------------------------------------
# (d) the tree and its imports
# --------------------------------------------------------------------------

def test_port_tree_lints_clean_with_an_empty_baseline(tmp_path, capsys):
    findings = lint_paths([str(ROOT / "src" / "repro_torch")], RULES)
    assert findings == [], "\n".join(f.format() for f in findings)
    empty = tmp_path / "empty.json"
    empty.write_text('{"fingerprints": []}\n')
    assert tmain.main([str(ROOT / "src" / "repro_torch"), "--baseline",
                       str(empty)]) == 0
    capsys.readouterr()


def test_new_modules_import_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch.analysis, repro_torch.analysis.contracts\n"
            "import repro_torch.analysis.__main__\n"
            "import repro_torch.launch.graph_dryrun\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


# --------------------------------------------------------------------------
# (e) the runtime sentinels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("read", ["item", "tolist", "cpu", "bool",
                                  "nonzero"])
def test_no_implicit_syncs_catches_a_host_read(read):
    t = torch.arange(4.0)
    fn = {"item": lambda: t[0].item(), "tolist": lambda: t.tolist(),
          "cpu": lambda: t.cpu(), "bool": lambda: bool(t.sum() > 0),
          "nonzero": lambda: t.nonzero()}[read]
    with pytest.raises(HostSyncError):
        with no_implicit_syncs("cpu"):
            fn()


def test_no_implicit_syncs_passes_device_work():
    t = torch.arange(4.0)
    with no_implicit_syncs("cpu") as log:
        torch.where(t > 1, t, 0.0).sum()
    assert log.reads == []


def test_retrace_sentinel():
    from repro_torch.core import TwoLevel
    sess = contracts.canonical_session("cpu")
    pol = TwoLevel(backend="device", steps_per_sync=4)
    with pytest.raises(RetraceError):
        with retrace_sentinel(sess):
            sess._device_step_fn(pol)
    with retrace_sentinel(sess):             # pinned: reused
        sess._device_step_fn(pol)
    with retrace_sentinel(sess, allow_new=("superstep",)):
        sess._device_step_fn(TwoLevel(backend="device", steps_per_sync=2))


# --------------------------------------------------------------------------
# (f) the contracts
# --------------------------------------------------------------------------

def test_contracts_hold_on_the_cpu():
    results = contracts.check_all(device="cpu")
    names = {r.name for r in results}
    assert names == {"one-sync", "no-f64", "smem-budget", "tile-bytes",
                     "push-flops"}
    failed = [r for r in results if not r.ok]
    assert not failed, failed


def _break_chunk(sess, policy, extra):
    """Replace the session's chunk function by one that runs `extra` on
    its result inside the chunk."""
    real = sess._device_step_fn(policy)
    key = next(k for k, v in sess._jit_cache.items() if v is real)

    def broken(*args):
        state, un = real(*args)
        return state, extra(un)

    broken.chunk = real.chunk
    sess._jit_cache[key] = broken


def test_a_chunk_with_a_host_read_is_flagged():
    from repro_torch.core import TwoLevel
    pol = TwoLevel(backend="device", steps_per_sync=math.inf)
    sess = contracts.canonical_session("cpu")
    _break_chunk(sess, pol, lambda un: un + un.item() * 0)
    r = contracts.check_one_sync(sess, pol)
    assert not r.ok and "item" in r.detail
    assert contracts.check_one_sync(contracts.canonical_session("cpu"),
                                    pol).ok


def test_a_chunk_with_a_float64_op_is_flagged():
    from repro_torch.core import TwoLevel
    pol = TwoLevel(backend="device", steps_per_sync=4)
    sess = contracts.canonical_session("cpu")
    _break_chunk(sess, pol, lambda un: un.to(torch.float64).to(un.dtype))
    r = contracts.check_no_f64(sess, pol)
    assert not r.ok and "float64" in r.detail
