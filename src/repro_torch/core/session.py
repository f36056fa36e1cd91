"""GraphSession: a long-lived job-lifecycle API over one shared graph.

  submit(alg) -> JobHandle     admit a job at ANY superstep
  run(policy, max_supersteps)  advance all active jobs under a SchedulePolicy
  step(policy)                 a single superstep
  converged(handle)            per-job convergence test
  result(handle)               per-job result extraction
  detach(handle)               release the job's slot for reuse
  apply_updates(batch)         absorb live edge updates (repro_torch.stream)
  compact()                    rebuild every view from the updated CSR

Sessions are HETEROGENEOUS: jobs of both semiring families coexist over
one shared CSR.  The session keeps a registry of ViewGroups, one per
graph-view key `(semiring, fill, normalize, symmetrize)`; every view is
built with the same block size, so block id b names the same vertex range
in every view and one scheduling decision drives every family at once.

Each group keeps a PADDED [J_view_cap, B_N, Vb] job axis plus an active
mask: free slots hold the semiring's inert state (delta 0 / +inf), which
makes them arithmetic no-ops in every policy.  Slots are recycled (handle
generations catch stale use); a group's capacity doubles only when
submissions exceed it.  Job state is updated in place on submit/detach.

The session lives on one device: ``device=None`` means CUDA and raises
without one (pass ``device="cpu"``).  ``use_pallas=None`` pushes through
the fused superstep kernel on CUDA and through the plain pair sweep on
the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.algorithms.base import Algorithm, PLUS_TIMES
from repro_torch.core.policy import RunMetrics, SchedulePolicy, TwoLevel
from repro_torch.core.push import push_plus_one, push_min_one
from repro_torch.core.scheduler import (TwoLevelScheduler,
                                        optimal_queue_length, PRITER_C)
from repro_torch.core.do_select import DEFAULT_SAMPLES
from repro_torch.core.global_q import DEFAULT_ALPHA
from repro_torch.graph.structure import (BlockedGraph, BlockPairs, CSRGraph,
                                         TileOverlay, build_block_pairs,
                                         build_blocked, empty_overlay)
from repro_torch.kernels.common import resolve_device
from repro_torch.obs.telemetry import TelemetryConfig
from repro_torch.obs.trace import TraceRecorder


@dataclasses.dataclass(frozen=True)
class JobHandle:
    """Ticket for a submitted job; stale after detach (generation check)."""

    slot: int
    gen: int
    alg: Algorithm
    view: Optional[tuple] = None   # graph-view key; derived from alg if None


def _view_key(alg: Algorithm) -> tuple:
    return (alg.semiring, alg.graph_fill, alg.graph_normalize,
            alg.graph_symmetrize)


@dataclasses.dataclass
class ViewGroup:
    """One graph view + the padded job axis of every job using it.  `alg`
    is the view's exemplar (the first job submitted into it): it supplies
    the pair computation / convergence test for the whole group."""

    key: tuple
    alg: Algorithm
    graph: BlockedGraph
    push_one: Callable
    values: torch.Tensor       # [cap, B_N, Vb]
    deltas: torch.Tensor       # [cap, B_N, Vb]
    push_scale: torch.Tensor   # [cap]
    algs: List[Optional[Algorithm]]
    active: np.ndarray         # [cap] bool
    gens: List[int]
    # evolving-graph state (repro_torch.stream): the bounded per-block
    # delta-COO staged alongside the tiles (capacity 0 until the first
    # structural insert), plus host mirrors of the blocked structure that
    # apply_updates needs to classify edits, built lazily on first use
    overlay: Optional[TileOverlay] = None
    pair_slot: Optional[Dict[Tuple[int, int], int]] = None
    ov_used: Optional[np.ndarray] = None   # [B_N, C] bool
    ov_entry: Optional[Dict[Tuple[int, int], Tuple[int, int]]] = None
    # destination-sorted pair view of `graph`, built lazily and dropped
    # to None whenever the tiles change (stream edits, compaction)
    pairs: Optional[BlockPairs] = None

    @property
    def capacity(self) -> int:
        return len(self.algs)

    @property
    def semiring(self) -> str:
        return self.key[0]

    @property
    def num_active(self) -> int:
        return int(self.active.sum())


def _no_stream_counts() -> dict:
    """The stream counters a session accumulates between runs."""
    return {"updates_applied": 0, "dirty_blocks": 0, "reseed_num": 0,
            "reseed_den": 0}


def _inert_state(semiring: str, g: BlockedGraph, n: int):
    """State for free slots: converged-everywhere, pushes are no-ops."""
    fill = 0.0 if semiring == PLUS_TIMES else float("inf")
    shape = (n, g.num_blocks, g.block_size)
    return (torch.full(shape, fill, dtype=torch.float32, device=g.device),
            torch.full(shape, fill, dtype=torch.float32, device=g.device))


class GraphSession:
    """Owns the shared graph data + per-view padded, recyclable job axes."""

    def __init__(self, csr: Optional[CSRGraph] = None, block_size: int = 64,
                 *, capacity: int = 4, c: float = PRITER_C,
                 alpha: float = DEFAULT_ALPHA, samples: int = DEFAULT_SAMPLES,
                 seed: int = 0, use_pallas: Optional[bool] = None,
                 overlay_capacity: int = 32, telemetry=None, device=None):
        self.device = resolve_device(device)
        self._csr = csr
        # observability: telemetry=True / TelemetryConfig(...) turns on
        # the per-superstep series and, with cfg.trace, the trace events
        # (submit/detach, supersteps, apply_updates, compactions);
        # None/False (the default) leaves both drivers as they are
        self.telemetry: Optional[TelemetryConfig] = \
            TelemetryConfig.coerce(telemetry)
        self.trace = TraceRecorder(
            enabled=self.telemetry is not None and self.telemetry.trace)
        self.trace.name_thread(2, "supersteps")
        self.block_size = block_size
        self._capacity0 = max(1, int(capacity))   # initial per-view capacity
        self.c = c
        self._alpha = alpha
        self._samples = samples
        self._seed = seed
        # the fused kernel on CUDA; the plain pair sweep on the CPU
        self.use_pallas = (self.device.type == "cuda" if use_pallas is None
                           else bool(use_pallas))
        # evolving graphs: per-block delta-COO budget a view grows to on
        # its first structural insert; a full block row triggers
        # compaction (BlockedGraph rebuilt from the updated CSR)
        self.overlay_capacity = max(1, int(overlay_capacity))
        # view registry, insertion-ordered (the order defines the
        # concatenated job-metric layout, see job_index)
        self.groups: Dict[tuple, ViewGroup] = {}
        self.scheduler: Optional[TwoLevelScheduler] = None
        self.q = 0
        # device-backend step functions, keyed on what shapes the program
        self._jit_cache: Dict[tuple, Callable] = {}
        # [B_N] pending priority injection for update-affected blocks
        self._dirty_boost: Optional[np.ndarray] = None
        self._stream_pending = _no_stream_counts()

    # alpha/samples/seed live canonically on the scheduler once it exists

    @property
    def alpha(self) -> float:
        return self.scheduler.alpha if self.scheduler else self._alpha

    @alpha.setter
    def alpha(self, value: float) -> None:
        self._alpha = value
        if self.scheduler:
            self.scheduler.alpha = value

    @property
    def samples(self) -> int:
        return self.scheduler.samples if self.scheduler else self._samples

    @samples.setter
    def samples(self, value: int) -> None:
        self._samples = value
        if self.scheduler:
            self.scheduler.samples = value

    @property
    def seed(self) -> int:
        return self.scheduler.seed if self.scheduler else self._seed

    @seed.setter
    def seed(self, value: int) -> None:
        self._seed = value
        if self.scheduler:
            self.scheduler.reset(value)  # re-seeds AND restarts the stream

    # -- view registry -------------------------------------------------------

    def view_groups(self) -> List[ViewGroup]:
        """All view groups in creation order (the metric layout order)."""
        return list(self.groups.values())

    @property
    def total_capacity(self) -> int:
        return sum(g.capacity for g in self.groups.values())

    @property
    def capacity(self) -> int:
        """Total padded slots across views (initial capacity pre-submit)."""
        return self.total_capacity if self.groups else self._capacity0

    def _sole_group(self) -> ViewGroup:
        if len(self.groups) != 1:
            raise ValueError(
                f"session holds {len(self.groups)} graph views; "
                "per-view state has no single values/deltas/graph — use "
                "view_groups()")
        return next(iter(self.groups.values()))

    @property
    def graph(self):
        return next(iter(self.groups.values())).graph if self.groups else None

    @property
    def view_alg(self) -> Optional[Algorithm]:
        return next(iter(self.groups.values())).alg if self.groups else None

    @property
    def values(self):
        return self._sole_group().values

    @property
    def deltas(self):
        return self._sole_group().deltas

    @property
    def push_scale(self):
        return self._sole_group().push_scale

    # -- construction from a legacy ConcurrentRun ---------------------------

    @classmethod
    def from_run(cls, run, *, c: float = PRITER_C,
                 alpha: float = DEFAULT_ALPHA,
                 samples: int = DEFAULT_SAMPLES, seed: int = 0,
                 use_pallas: Optional[bool] = None) -> "GraphSession":
        """Adopt a pre-built ConcurrentRun on its graph's device: one view,
        capacity == J, no padding, so the legacy engine shim drives exactly
        what a static session batch would."""
        sess = cls(None, run.graph.block_size, capacity=run.num_jobs,
                   c=c, alpha=alpha, samples=samples, seed=seed,
                   use_pallas=use_pallas, device=run.graph.device)
        a0 = run.algs[0]
        sess._install_scheduler(run.graph)
        sess.groups[_view_key(a0)] = ViewGroup(
            key=_view_key(a0), alg=a0, graph=run.graph,
            push_one=(push_plus_one if a0.semiring == PLUS_TIMES
                      else push_min_one),
            values=run.values, deltas=run.deltas, push_scale=run.push_scale,
            algs=list(run.algs),
            active=np.ones(run.num_jobs, dtype=bool),
            gens=[0] * run.num_jobs,
            overlay=empty_overlay(run.graph.num_blocks, device=sess.device))
        return sess

    # -- graph / scheduler initialisation ------------------------------------

    def _install_scheduler(self, g: BlockedGraph) -> None:
        """First view sets q + the scheduler; later views must be
        block-aligned (same B_N)."""
        if self.scheduler is None:
            self.q = optimal_queue_length(g.num_blocks, g.n_real, self.c)
            self.scheduler = TwoLevelScheduler(
                g.num_blocks, self.q, alpha=self.alpha, samples=self.samples,
                seed=self.seed)
        elif g.num_blocks != self.scheduler.num_blocks:
            raise ValueError(
                f"view is not block-aligned: {g.num_blocks} blocks != "
                f"{self.scheduler.num_blocks}")

    def _group_for(self, alg: Algorithm) -> ViewGroup:
        key = _view_key(alg)
        grp = self.groups.get(key)
        if grp is not None:
            return grp
        if self._csr is None:
            raise ValueError("GraphSession needs a CSRGraph to build from")
        g_csr = (self._csr.symmetrized() if alg.graph_symmetrize
                 else self._csr)
        g = build_blocked(g_csr, self.block_size, fill=alg.graph_fill,
                          normalize=alg.graph_normalize, device=self.device)
        self._install_scheduler(g)
        cap = self._capacity0
        values, deltas = _inert_state(alg.semiring, g, cap)
        grp = ViewGroup(
            key=key, alg=alg, graph=g,
            push_one=(push_plus_one if alg.semiring == PLUS_TIMES
                      else push_min_one),
            values=values, deltas=deltas,
            push_scale=torch.ones(cap, dtype=torch.float32,
                                  device=self.device),
            algs=[None] * cap, active=np.zeros(cap, dtype=bool),
            gens=[0] * cap,
            overlay=empty_overlay(g.num_blocks, device=self.device))
        self.groups[key] = grp
        return grp

    def _grow(self, grp: ViewGroup) -> None:
        extra = grp.capacity
        iv, idl = _inert_state(grp.semiring, grp.graph, extra)
        grp.values = torch.cat([grp.values, iv])
        grp.deltas = torch.cat([grp.deltas, idl])
        grp.push_scale = torch.cat(
            [grp.push_scale, torch.ones(extra, dtype=torch.float32,
                                        device=self.device)])
        grp.algs.extend([None] * extra)
        grp.gens.extend([0] * extra)
        grp.active = np.concatenate(
            [grp.active, np.zeros(extra, dtype=bool)])

    # -- job lifecycle -------------------------------------------------------

    @property
    def num_active(self) -> int:
        return sum(g.num_active for g in self.groups.values())

    def submit(self, alg: Algorithm) -> JobHandle:
        """Admit a job at any superstep; recycles a free slot or grows its
        view group.  A NEW graph view is built lazily from the shared CSR."""
        grp = self._group_for(alg)
        free = np.nonzero(~grp.active)[0]
        if len(free) == 0:
            self._grow(grp)
            free = np.nonzero(~grp.active)[0]
        slot = int(free[0])
        v, d = alg.init(grp.graph)
        grp.values[slot] = v
        grp.deltas[slot] = d
        grp.push_scale[slot] = alg.get_push_scale()
        grp.algs[slot] = alg
        grp.active[slot] = True
        self.trace.instant("submit", cat="job", alg=type(alg).__name__,
                           view=str(grp.key), slot=slot)
        return JobHandle(slot=slot, gen=grp.gens[slot], alg=alg, view=grp.key)

    def _handle_group(self, handle: JobHandle) -> ViewGroup:
        key = handle.view if handle.view is not None else _view_key(handle.alg)
        grp = self.groups.get(key)
        if grp is None or not (0 <= handle.slot < grp.capacity) \
                or grp.gens[handle.slot] != handle.gen \
                or not grp.active[handle.slot]:
            raise KeyError(f"stale or unknown job handle {handle}")
        return grp

    def job_index(self, handle: JobHandle) -> int:
        """Index of this job in the concatenated per-group layout used by
        `unconverged_counts()` and `RunMetrics.iterations_per_job`."""
        grp = self._handle_group(handle)
        off = 0
        for g in self.groups.values():
            if g is grp:
                return off + handle.slot
            off += g.capacity
        raise KeyError(f"unknown view for handle {handle}")

    def _counts(self, grp: ViewGroup) -> torch.Tensor:
        """[cap] unconverged-vertex count per slot, on the device."""
        return grp.alg.unconverged(grp.values, grp.deltas).sum(dim=(1, 2))

    def unconverged_counts(self) -> np.ndarray:
        """[total_capacity] unconverged-vertex count per slot, view groups
        concatenated in creation order (0 for free slots)."""
        parts = [self._counts(g).cpu().numpy() for g in self.groups.values()]
        return (np.concatenate(parts) if parts
                else np.zeros(0, dtype=np.int64))

    def converged(self, handle: JobHandle) -> bool:
        grp = self._handle_group(handle)
        counts = self._counts(grp).cpu().numpy()
        return bool(counts[handle.slot] == 0)

    def result(self, handle: JobHandle) -> np.ndarray:
        """[n_real] float32 result for one job (valid at any superstep)."""
        grp = self._handle_group(handle)
        res = handle.alg.result(grp.values[handle.slot],
                                grp.deltas[handle.slot])
        # a copy: on the CPU .numpy() would alias the session's state,
        # which submit/detach update in place
        return res.reshape(-1)[:grp.graph.n_real].to("cpu", copy=True).numpy()

    def detach(self, handle: JobHandle) -> np.ndarray:
        """Extract the job's result and free its slot for reuse."""
        res = self.result(handle)
        grp = self._handle_group(handle)
        slot = handle.slot
        iv, idl = _inert_state(grp.semiring, grp.graph, 1)
        grp.values[slot] = iv[0]
        grp.deltas[slot] = idl[0]
        grp.push_scale[slot] = 1.0
        grp.algs[slot] = None
        grp.active[slot] = False
        grp.gens[slot] += 1
        self.trace.instant("detach", cat="job",
                           alg=type(handle.alg).__name__,
                           view=str(grp.key), slot=slot)
        return res

    # -- evolving graphs (repro_torch.stream) --------------------------------

    def apply_updates(self, batch):
        """Apply a live edge insert/delete/reweight batch while jobs run.

        The shared CSR is the source of truth: the batch updates it
        exactly, then every view group absorbs the change — in-place tile
        edits for block pairs that own a tile slot, the bounded per-block
        delta-COO overlay for structurally-new pairs (a full overlay row
        compacts the view: BlockedGraph rebuilt from the updated CSR,
        bit-identical to a from-scratch build) — and every job's state is
        invalidated just enough to converge to the NEW graph's fixpoint.
        Affected blocks are injected as priority boosts into the next
        run()'s first superstep.  Callable between run()/step() calls;
        returns this batch's `stream.StreamStats` (the counters also
        drain into the next run()'s RunMetrics)."""
        from repro_torch.stream.apply import apply_updates_to_session
        return apply_updates_to_session(self, batch)

    def compact(self) -> None:
        """Force compaction of every view: rebuild each BlockedGraph from
        the updated CSR (bit-identical to a from-scratch build) and empty
        the overlays.  Happens automatically when an overlay row fills."""
        from repro_torch.stream.apply import compact_group
        if self._csr is None:
            raise ValueError(
                "compact needs the session-owned CSRGraph (sessions "
                "adopted from a legacy ConcurrentRun have none)")
        for grp in self.view_groups():
            compact_group(self, grp)

    def _consume_dirty_boost(self) -> Optional[np.ndarray]:
        """[B_N] pending priority injection for update-affected blocks, or
        None; consumed by the first superstep of the next run."""
        boost, self._dirty_boost = self._dirty_boost, None
        return boost

    def _drain_stream_stats(self, metrics: RunMetrics) -> None:
        """Move the stream counters accumulated since the last run into
        `metrics` and reset them."""
        p = self._stream_pending
        metrics.updates_applied = p["updates_applied"]
        metrics.dirty_blocks = p["dirty_blocks"]
        metrics.reseed_fraction = (p["reseed_num"] / p["reseed_den"]
                                   if p["reseed_den"] else 0.0)
        self._stream_pending = _no_stream_counts()

    def _device_step_fn(self, policy):
        """The device-backend chunk function for `policy`, cached on the
        session.

        Keyed on everything that shapes the program: the policy's
        selection code (the `device_select` function itself plus
        needs_pairs, so `Fused()` and the literal
        `TwoLevel(backend="device", steps_per_sync=inf)` share one entry
        while a subclass overriding `device_select` gets its own),
        steps_per_sync, the view keys, per-view capacities, overlay
        capacities, q, alpha, samples, the kernel toggle and the telemetry
        capacity (0 when off, so a telemetry-off session runs the chunk
        without the series and an on/off pair never shares an entry).
        Repeated run() calls and submit/detach cycles at unchanged
        capacity reuse the entry."""
        from repro_torch.core.policy import build_device_step
        groups = self.view_groups()
        tel_cap = self.telemetry.capacity if self.telemetry else 0
        key = ("superstep", type(policy).device_select, policy.needs_pairs,
               policy.steps_per_sync,
               tuple(g.key for g in groups),
               tuple(g.capacity for g in groups),
               tuple(g.overlay.capacity for g in groups),
               self.q, float(self.alpha), int(self.samples),
               self.use_pallas, tel_cap)
        if key not in self._jit_cache:
            self._jit_cache[key] = build_device_step(policy, self)
        return self._jit_cache[key]

    def _pair_data(self, grp: ViewGroup) -> BlockPairs:
        """The view's destination-sorted `BlockPairs`, built lazily from
        the current tiles and cached on the group."""
        if grp.pairs is None:
            grp.pairs = build_block_pairs(grp.graph)
        return grp.pairs

    # -- driving -------------------------------------------------------------

    def run(self, policy: Optional[SchedulePolicy] = None,
            max_supersteps: int = 100000, *, mesh=None) -> RunMetrics:
        """Advance all active jobs until they converge (or the budget ends).
        Jobs submitted after this returns resume from the shared state:
        call run() again to drive the new mix."""
        if mesh is not None:
            raise NotImplementedError(
                "multi-device placement is not ported yet (ROADMAP A11)")
        if not self.groups:
            raise ValueError("no jobs submitted yet")
        policy = TwoLevel() if policy is None else policy
        t_run = self.trace.now_us() if self.trace.enabled else 0.0
        m = policy.run(self, max_supersteps)
        self._drain_stream_stats(m)
        if self.trace.enabled:
            self._trace_run(policy, m, t_run)
        return m

    def _trace_run(self, policy, m: RunMetrics, t_run: float) -> None:
        """One run() span + counter tracks from the telemetry series."""
        dur = self.trace.now_us() - t_run
        self.trace.complete("run", t_run, dur, cat="run",
                            policy=policy.name, **m.to_dict())
        if m.converged:
            self.trace.instant("converged", cat="run",
                               supersteps=int(m.supersteps))
        tel = m.telemetry
        if tel is None or len(tel) == 0:
            return
        # counter samples interpolated across the run span (the device
        # backend has no per-superstep wall clock); the stride caps the
        # event volume of very long runs
        k = len(tel)
        stride = max(1, k // 2000)
        for i in range(0, k, stride):
            ts = t_run + dur * (i + 1) / k
            vals = {"active_jobs": int(tel.active_jobs[i]),
                    "tile_loads": int(tel.tile_loads[i]),
                    "job_block_pushes": int(tel.job_block_pushes[i]),
                    "gq_occupancy": int(tel.gq_occupancy[i]),
                    "dirty_blocks": int(tel.dirty_blocks[i]),
                    "tile_pair_loads": int(tel.tile_pair_loads[i]),
                    "halo_bytes": float(tel.halo_bytes[i])}
            self.trace.counter("telemetry", vals, ts_us=ts)
            for gi in range(tel.num_groups):
                self.trace.counter(
                    f"group{gi}",
                    {"unconverged": int(tel.unconverged[i, gi]),
                     "max_residual": float(tel.max_residual[i, gi])},
                    ts_us=ts)

    def step(self, policy: Optional[SchedulePolicy] = None) -> RunMetrics:
        """A single superstep under `policy`."""
        return self.run(policy, max_supersteps=1)
