"""Deterministic open-loop load generation for the serve front.

The paper's claim — two-level scheduling accelerates the convergence of
CONCURRENT jobs — is only testable under sustained traffic.  This module
supplies it, open-loop (Hauck et al., PAPERS.md; the arrival schedule is
fixed up front and never reacts to service time, so a slow scheduler
builds queue instead of quietly throttling its own offered load):

  generate_arrivals  seeded Poisson base rate modulated by a diurnal
                     burst envelope; hundreds of tenants, each pinned to
                     one algorithm family drawn from a weighted mix
  OpenLoopHarness    drives a long-lived GraphSession and a
                     ConcurrentServeScheduler pair tick by tick: inject
                     arrivals -> schedule_step() admits -> each admitted
                     request submits a REAL algorithm job into the shared
                     session -> supersteps advance -> converged jobs
                     complete() and detach.  Optionally interleaves
                     seeded `UpdateBatch` graph mutations and forwards
                     the dirty blocks to `notify_group_update`, closing
                     the update loop across BOTH layers.

Every random draw comes from `np.random.default_rng(cfg.seed)` (RPA004)
and every latency is counted in scheduler TICKS, so two runs with one
seed produce bit-identical admission and completion sequences.

Copied from the reference (`repro.obs.loadgen`) onto the port's session,
algorithms, serve scheduler and `graph.mutation_stream`: for a seed the
arrivals are the reference's, and on the host backend so are the
admission and completion logs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.algorithms import (BFS, Katz, PageRank,
                                    PersonalizedPageRank, SSSP, WCC)

__all__ = ["LoadgenConfig", "Arrival", "generate_arrivals",
           "OpenLoopHarness", "FAMILY_FACTORIES"]


# family name -> factory(source_vertex) for the job an admitted request
# submits; source-free families ignore the argument
FAMILY_FACTORIES = {
    "pagerank": lambda src: PageRank(),
    "ppr": lambda src: PersonalizedPageRank(source=src),
    "sssp": lambda src: SSSP(source=src),
    "bfs": lambda src: BFS(source=src),
    "wcc": lambda src: WCC(),
    "katz": lambda src: Katz(),
}


@dataclasses.dataclass(frozen=True)
class LoadgenConfig:
    """Open-loop traffic shape (everything derives from `seed`).

    ticks            arrival horizon in scheduler ticks
    base_rate        mean arrivals per tick (Poisson)
    burst_amplitude  diurnal envelope: rate(t) = base_rate *
                     max(0, 1 + amplitude * sin(2*pi*t / burst_period))
    n_tenants        tenant population; each tenant is pinned to one
                     algorithm family at generation time
    families         (name, weight) mix the tenants draw from; names must
                     be FAMILY_FACTORIES keys
    update_every     interleave one seeded UpdateBatch every N ticks
                     (0 = static graph)
    """

    seed: int = 0
    ticks: int = 400
    base_rate: float = 0.5
    burst_amplitude: float = 0.6
    burst_period: int = 200
    n_tenants: int = 100
    families: Tuple[Tuple[str, float], ...] = (
        ("pagerank", 0.35), ("ppr", 0.25), ("sssp", 0.25), ("bfs", 0.15))
    update_every: int = 0
    update_inserts: int = 8
    update_deletes: int = 4

    def __post_init__(self):
        if self.ticks < 1 or self.n_tenants < 1:
            raise ValueError("ticks and n_tenants must be >= 1")
        if self.base_rate <= 0:
            raise ValueError(f"base_rate must be > 0: {self.base_rate}")
        for name, w in self.families:
            if name not in FAMILY_FACTORIES:
                raise ValueError(f"unknown family {name!r} "
                                 f"(have {sorted(FAMILY_FACTORIES)})")
            if w <= 0:
                raise ValueError(f"family weight must be > 0: {name}={w}")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One open-loop request: fixed before the run, never rescheduled."""

    tick: int       # when it enters its tenant's waiting queue
    tenant: int     # RequestStream id
    family: str     # the tenant's algorithm family
    group: int      # request group == graph block id
    source: int     # source vertex for source-parameterized families
    urgency: float  # higher = more urgent (scheduler P_mean input)


def generate_arrivals(cfg: LoadgenConfig, n_groups: int,
                      n_vertices: int) -> List[Arrival]:
    """The full arrival schedule, bit-deterministic under cfg.seed."""
    if n_groups < 1 or n_vertices < 1:
        raise ValueError("n_groups and n_vertices must be >= 1")
    rng = np.random.default_rng(cfg.seed)
    names = [n for n, _ in cfg.families]
    weights = np.asarray([w for _, w in cfg.families], dtype=np.float64)
    weights = weights / weights.sum()
    tenant_family = rng.choice(len(names), size=cfg.n_tenants, p=weights)
    arrivals: List[Arrival] = []
    for t in range(cfg.ticks):
        envelope = 1.0 + cfg.burst_amplitude * math.sin(
            2.0 * math.pi * t / max(1, cfg.burst_period))
        rate = cfg.base_rate * max(0.0, envelope)
        for _ in range(int(rng.poisson(rate))):
            tenant = int(rng.integers(cfg.n_tenants))
            arrivals.append(Arrival(
                tick=t, tenant=tenant,
                family=names[int(tenant_family[tenant])],
                group=int(rng.integers(n_groups)),
                source=int(rng.integers(n_vertices)),
                urgency=float(np.round(rng.uniform(0.1, 1.0), 6))))
    return arrivals


class OpenLoopHarness:
    """Drive a GraphSession + ConcurrentServeScheduler under open loop.

    `max_running` is the inter-job parallelism knob (Hauck et al.'s
    trade-off axis): at most that many admitted jobs share the session's
    supersteps concurrently; the admission budget each tick is the free
    headroom.  One tick = one `schedule_step()` (the deterministic wait /
    latency clock) + `supersteps_per_tick` shared supersteps when any job
    is live + one convergence poll.  The arrival schedule is precomputed;
    nothing about service time feeds back into it."""

    def __init__(self, sess, sched, cfg: LoadgenConfig, *,
                 policy=None, max_running: int = 8,
                 supersteps_per_tick: int = 1,
                 drain_ticks: int = 50_000):
        from repro_torch.core.policy import TwoLevel
        # before the first submit the session has no scheduler yet; the
        # block count is still fixed by (n, block_size)
        num_blocks = (sess.scheduler.num_blocks if sess.scheduler
                      else -(-int(sess._csr.n) // int(sess.block_size)))
        if sched.n_groups != num_blocks:
            raise ValueError(
                f"scheduler n_groups ({sched.n_groups}) must equal the "
                f"session's block count ({num_blocks}) — "
                "request groups ARE graph blocks")
        if max_running < 1:
            raise ValueError(f"max_running must be >= 1: {max_running}")
        self.sess = sess
        self.sched = sched
        self.cfg = cfg
        self.policy = TwoLevel() if policy is None else policy
        self.max_running = int(max_running)
        self.supersteps_per_tick = int(supersteps_per_tick)
        self.drain_ticks = int(drain_ticks)
        self.arrivals = generate_arrivals(
            cfg, n_groups=sched.n_groups, n_vertices=int(sess._csr.n))
        # deterministic run records (the determinism property is asserted
        # on these two sequences)
        self.admission_log: List[tuple] = []
        self.completion_log: List[tuple] = []
        self.ticks_run = 0
        self.supersteps_run = 0
        self.updates_applied = 0
        self._counters = {"tile_loads": 0, "tile_pair_loads": 0,
                          "job_block_pushes": 0, "host_syncs": 0,
                          "halo_bytes": 0.0}

    # -- internals -----------------------------------------------------------

    def _ensure_stream(self, arr: Arrival):
        from repro_torch.serve.concurrent import RequestStream
        if arr.tenant not in self.sched.streams:
            self.sched.add_stream(RequestStream(arr.tenant,
                                                family=arr.family))

    def _inject(self, tick: int, cursor: int) -> int:
        from repro_torch.serve.concurrent import Request
        while cursor < len(self.arrivals) \
                and self.arrivals[cursor].tick <= tick:
            arr = self.arrivals[cursor]
            self._ensure_stream(arr)
            req = Request(stream_id=arr.tenant, group=arr.group,
                          urgency=arr.urgency, tokens_left=1)
            req._arrival = arr
            self.sched.streams[arr.tenant].add(req)
            cursor += 1
        return cursor

    def _apply_update(self, tick: int) -> None:
        from repro_torch.graph.generators import mutation_stream
        batch = mutation_stream(
            self.sess._csr, n_batches=1,
            inserts_per_batch=self.cfg.update_inserts,
            deletes_per_batch=self.cfg.update_deletes,
            seed=self.cfg.seed + 7919 * (tick + 1))[0]
        self.sess.apply_updates(batch)
        self.updates_applied += 1
        boost = getattr(self.sess, "_dirty_boost", None)
        if boost is not None:
            dirty = np.nonzero(np.asarray(boost) > 0)[0]
            if dirty.size:
                self.sched.notify_group_update(dirty.tolist())

    def _accumulate(self, m) -> None:
        self.supersteps_run += int(m.supersteps)
        self._counters["tile_loads"] += int(m.tile_loads)
        self._counters["tile_pair_loads"] += int(m.tile_pair_loads)
        self._counters["job_block_pushes"] += int(m.job_block_pushes)
        self._counters["host_syncs"] += int(m.host_syncs)
        self._counters["halo_bytes"] += float(m.halo_bytes)

    # -- the drive loop ------------------------------------------------------

    def run(self) -> dict:
        """Run arrivals + drain; returns the deterministic summary."""
        running: Dict[int, tuple] = {}   # id(req) -> (req, handle, tick)
        cursor = 0
        tick = 0
        total = len(self.arrivals)
        while True:
            horizon_done = tick >= self.cfg.ticks
            if not horizon_done:
                cursor = self._inject(tick, cursor)
                if self.cfg.update_every and tick > 0 \
                        and tick % self.cfg.update_every == 0:
                    self._apply_update(tick)
            waiting = sum(len(s.waiting)
                          for s in self.sched.streams.values())
            if horizon_done and not running and not waiting:
                break
            if horizon_done and tick >= self.cfg.ticks + self.drain_ticks:
                break   # bounded drain: report whatever is still in flight
            # admission budget = free inter-job headroom this tick; the
            # step runs even at 0 so the wait/latency clock keeps ticking
            self.sched.batch_budget = max(
                0, self.max_running - len(running))
            for req in self.sched.schedule_step():
                arr = req._arrival
                alg = FAMILY_FACTORIES[arr.family](arr.source)
                handle = self.sess.submit(alg)
                running[id(req)] = (req, handle, tick)
                self.admission_log.append(
                    (tick, arr.tick, arr.tenant, arr.family, arr.group))
            if running:
                m = self.sess.run(self.policy,
                                  max_supersteps=self.supersteps_per_tick)
                self._accumulate(m)
                counts = self.sess.unconverged_counts()
                for key in sorted(
                        running,
                        key=lambda k: self.sess.job_index(running[k][1])):
                    req, handle, t_admit = running[key]
                    if counts[self.sess.job_index(handle)] == 0:
                        # the deterministic clock: service time in ticks
                        self.sched.complete(
                            req, service_s=float(tick + 1 - t_admit))
                        self.sess.detach(handle)
                        arr = req._arrival
                        self.completion_log.append(
                            (tick + 1, arr.tenant, arr.family,
                             tick + 1 - arr.tick))
                        del running[key]
            tick += 1
        self.ticks_run = tick
        return self.summary()

    # -- reporting -----------------------------------------------------------

    def summary(self) -> dict:
        from repro_torch.obs.serve import percentile_summary
        lat_all = [float(c[3]) for c in self.completion_log]
        by_family: Dict[str, List[float]] = {}
        for _, _, fam, lat in self.completion_log:
            by_family.setdefault(fam, []).append(float(lat))
        return {
            "arrivals": len(self.arrivals),
            "admitted": len(self.admission_log),
            "completed": len(self.completion_log),
            "ticks": self.ticks_run,
            "supersteps": self.supersteps_run,
            "updates_applied": self.updates_applied,
            "max_running": self.max_running,
            "throughput_per_tick": (
                round(len(self.completion_log) / self.ticks_run, 6)
                if self.ticks_run else 0.0),
            "latency_ticks": percentile_summary(lat_all),
            "latency_by_family": {
                fam: percentile_summary(v)
                for fam, v in sorted(by_family.items())},
            "counters": {k: (round(v, 3) if isinstance(v, float) else v)
                         for k, v in self._counters.items()},
        }
