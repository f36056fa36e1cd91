"""Contracts on the port's device superstep (the reference's
`repro.analysis.contracts`, which checks XLA's compiled HLO).

The port compiles nothing, so each contract runs the REAL chunk function
(`GraphSession._device_step_fn`, the function `core.policy._run_device`
calls) on a live session and watches what it does:

  one-sync      a chunk reads nothing on the host: every chunk of a run
                runs under `sentinels.no_implicit_syncs` (on the card
                `set_sync_debug_mode("error")`), so the run's one read per
                chunk is the driver's; `RunMetrics.host_syncs` equals the
                chunks called, ceil(supersteps / INF_CHUNK) of them on the
                inf cadence, and the run converges.
  no-f64        no op of a one-device chunk, nor of the host driver's
                pairs and counts, takes or makes a float64 tensor (a
                `TorchDispatchMode` looks at every op).  The mesh's exact
                float64 sums (ROADMAP C) are outside it.
  smem-budget   the counterpart of the reference's vmem-budget: the
                shared memory of one thread block of B1/B2
                (`fused_superstep`, at the job layout it launches with,
                `layout`, under the thread limit too) and B3
                (`mj_spmm`, at its own pass of min(J, JR) jobs,
                `pass_jobs`, through its `check_shape`) for
                every view's job count fits `kernels.common.SMEM_BUDGET`
                for every Vb in their `SUPPORTED_VB`.
  tile-bytes    a run's `RunMetrics.tile_pair_loads` x Vb^2 x 4 bytes
                never exceeds what its chunks could move: every pair tile
                of every view once a superstep.
  push-flops    the plus-times push is a matrix product: one chunk
                carries matmul FLOPs under `FlopCounterMode`.  Through
                the kernels on the card (whose work the counter cannot
                see) B1 must have launched in that chunk instead.

`check_all(device)` builds the reference's small canonical session (one
plus-times and one min-plus view) for each policy: the device inf
cadence and K=4 on the plain route, the host driver's programs, then the
inf cadence with `use_pallas=True` (the kernels on the card, their plain
versions on the CPU).  `device=None` means CUDA and raises without a
card; tests pass "cpu".  The CLI runs it as ``python -m
repro_torch.analysis --contracts [--device cpu]``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.sentinels import no_implicit_syncs
from repro_torch.kernels import common


@dataclasses.dataclass
class ContractResult:
    name: str
    ok: bool
    detail: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def canonical_session(device=None, seed: int = 0,
                      use_pallas: bool = False):
    """Small two-view session (plus-times PageRank + min-plus SSSP), the
    reference's `_canonical_session`."""
    from repro_torch.algorithms import SSSP, PageRank
    from repro_torch.core import GraphSession
    from repro_torch.graph import rmat_graph
    sess = GraphSession(rmat_graph(200, 5, seed=7), 32, capacity=2,
                        seed=seed, use_pallas=use_pallas, device=device)
    sess.submit(PageRank())
    sess.submit(SSSP(source=0))
    return sess


@contextlib.contextmanager
def watched_chunks(sess, policy, watch: Callable):
    """Within: every call of the session's chunk function for `policy`
    runs inside `watch()` (a context manager factory); yields the list of
    what each call's `watch()` yielded, one entry a chunk."""
    step_fn = sess._device_step_fn(policy)
    key = next(k for k, v in sess._jit_cache.items() if v is step_fn)
    seen: list = []

    def watched(*args):
        with watch() as w:
            out = step_fn(*args)
        seen.append(w)
        return out

    watched.chunk = step_fn.chunk
    sess._jit_cache[key] = watched
    try:
        yield seen
    finally:
        sess._jit_cache[key] = step_fn


def one_chunk(sess, policy, max_steps: int = 1024):
    """Call the session's chunk function for `policy` once on the device
    driver's carry (`core.policy.device_inputs`), as `_run_device` does;
    the session keeps its state (the result is not written back)."""
    from repro_torch.core.policy import device_inputs
    state, *args = device_inputs(sess)
    return sess._device_step_fn(policy)(state, *args, max_steps, sess.seed,
                                        sess.scheduler._step)


def check_one_sync(sess, policy, budget: int = 2000) -> ContractResult:
    """Run `policy` to convergence with every chunk under
    `no_implicit_syncs`; the chunks read nothing, and the driver's reads
    are one a chunk."""
    return _one_sync(sess, policy, budget)[0]


def _one_sync(sess, policy, budget: int):
    """(the one-sync result, the run's RunMetrics or None)."""
    from repro_torch.core.policy import INF_CHUNK
    try:
        with watched_chunks(sess, policy,
                            lambda: no_implicit_syncs(sess.device)) as seen:
            m = sess.run(policy, budget)
    except (AssertionError, RuntimeError) as e:
        return ContractResult("one-sync", False,
                              f"a chunk read the device on the host: "
                              f"{e}"), None
    chunks = len(seen)
    ok = m.converged and m.host_syncs == chunks
    detail = (f"{chunks} chunk(s), none reading the host; host_syncs="
              f"{m.host_syncs}, converged={m.converged}")
    if policy.steps_per_sync == math.inf:
        expect = -(-m.supersteps // INF_CHUNK)
        ok = ok and chunks == expect
        detail += (f"; {m.supersteps} supersteps at {INF_CHUNK} a chunk: "
                   f"{expect} expected")
    return ContractResult("one-sync", ok, detail), m


class _Float64Ops(TorchDispatchMode):
    """Lists every op that takes or makes a float64 tensor."""

    def __init__(self):
        super().__init__()
        self.ops: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(isinstance(t, torch.Tensor) and t.dtype == torch.float64  # noqa: RPT006 - the check
               for t in tree_leaves((args, kwargs, out))):
            self.ops.append(str(func))
        return out


def _no_f64(label: str, fn) -> ContractResult:
    mode = _Float64Ops()
    with mode:
        fn()
    if mode.ops:
        return ContractResult(
            "no-f64", False, f"{len(mode.ops)} float64 op(s) in {label} "
                             f"(first: {mode.ops[0]})")
    return ContractResult("no-f64", True, f"no float64 op in {label}")


def check_no_f64(sess, policy) -> ContractResult:
    """No float64 op in one chunk of `policy`."""
    return _no_f64("a chunk", lambda: one_chunk(sess, policy))


def check_host_programs(sess) -> List[ContractResult]:
    """No float64 op in the host driver's per-group pairs and counts."""
    from repro_torch.core.push import compute_pairs
    out = []
    for g in sess.view_groups():
        out.append(_no_f64(f"pairs[{g.key!r}]", lambda g=g: compute_pairs(
            g.alg, g.values, g.deltas)))
        out.append(_no_f64(f"counts[{g.key!r}]",
                           lambda g=g: sess._counts(g)))
    return out


def check_smem_budget(sess) -> List[ContractResult]:
    """B1/B2 and B3 at their launch sizing, every Vb they take, each
    view's job count."""
    from repro_torch.kernels.fused_superstep import kernel as fk
    from repro_torch.kernels.mj_spmm import kernel as mk

    kernels = (
        # B1/B2 at its (J, Vb) layout: the jobs one pass holds
        ("fused_superstep", fk, lambda j, vb: fk.layout(j, vb).pass_jobs,
         fk.check_shape,
         lambda j, vb: fk.smem_bytes(vb, j, fk.layout(j, vb))),
        # B3 checks its own pass, which need not divide J
        ("mj_spmm", mk, lambda j, vb: mk.pass_jobs(j), mk.check_shape,
         lambda j, vb: mk.smem_bytes(mk.pass_jobs(j), vb)))
    out = []
    for g in sess.view_groups():
        j = g.capacity
        sizes, fails = [], []
        for name, mod, pick, check, smem in kernels:
            for vb in mod.SUPPORTED_VB:
                try:
                    check(j, vb)
                except ValueError as e:
                    fails.append(str(e))
                sizes.append(f"{name}[Vb={vb}, jb={pick(j, vb)}] "
                             f"{smem(j, vb)} B")
        out.append(ContractResult(
            "smem-budget", not fails,
            f"view {g.key!r} J={j}: " + ("; ".join(fails) if fails else
                                         ", ".join(sizes))
            + f" vs budget {common.SMEM_BUDGET} B"))
    return out


def check_tile_bytes(sess, metrics) -> ContractResult:
    """The run's staged pair tiles against every pair tile of every view
    once a superstep."""
    groups = sess.view_groups()
    vb = groups[0].graph.block_size
    tile = vb * vb * 4
    staged = int(metrics.tile_pair_loads) * tile
    pairs = sum(sess._pair_data(g).num_pairs for g in groups)
    capacity = int(metrics.supersteps) * pairs * tile
    return ContractResult(
        "tile-bytes", staged <= capacity,
        f"measured pair loads={metrics.tile_pair_loads} -> {staged} B "
        f"staged vs {capacity} B movable ({metrics.supersteps} supersteps "
        f"x {pairs} pair tiles)")


def check_push_flops(sess, policy) -> ContractResult:
    """One chunk's matmul FLOPs (or, through the kernels on the card, B1's
    launches)."""
    from repro_torch.kernels.fused_superstep import kernel as fk
    before = fk.launches["plus_times"]
    fc = FlopCounterMode(display=False)
    with fc:
        one_chunk(sess, policy)
    flops = float(fc.get_total_flops())
    launched = fk.launches["plus_times"] - before
    if sess.use_pallas and sess.device.type == "cuda":
        return ContractResult(
            "push-flops", launched > 0,
            f"the plus-times push ran through B1: {launched} launch(es) "
            f"in one chunk ({flops:.3g} FLOPs counted outside it)")
    return ContractResult(
        "push-flops", flops > 0,
        f"{flops:.3g} matmul FLOPs in one chunk"
        + ("" if flops > 0 else " — the plus-times push lost its matrix "
                                "product"))


def check_device_contracts(sess, policy,
                           run_budget: int = 2000) -> List[ContractResult]:
    """The device contract bundle for one session and policy."""
    results = [check_no_f64(sess, policy)]
    results.extend(check_smem_budget(sess))
    results.append(check_push_flops(sess, policy))
    one, m = _one_sync(sess, policy, run_budget)
    results.append(one)
    results.append(check_tile_bytes(sess, m) if m is not None else
                   ContractResult("tile-bytes", False, "the run failed"))
    return results


def check_all(device=None) -> List[ContractResult]:
    """The CI sweep: the device inf cadence and K=4 on the plain route,
    the host driver's programs, then the inf cadence through the kernels
    (`use_pallas=True`)."""
    from repro_torch.core import TwoLevel
    device = common.resolve_device(device)
    inf = TwoLevel(backend="device", steps_per_sync=math.inf)
    results: List[ContractResult] = []
    results += check_device_contracts(canonical_session(device), inf)
    results += check_device_contracts(
        canonical_session(device), TwoLevel(backend="device",
                                            steps_per_sync=4))
    results += check_host_programs(canonical_session(device))
    results += check_device_contracts(
        canonical_session(device, use_pallas=True), inf)
    return results
