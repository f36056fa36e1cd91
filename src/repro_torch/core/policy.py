"""Pluggable schedule policies over a GraphSession (host backend).

A policy decides, per superstep, WHICH blocks are staged and WHO processes
them; the driver owns everything else (convergence test, metrics, the push
dispatch).  All policies reach the same per-job fixpoint — they differ
only in schedule and therefore in tile_loads / supersteps:

  TwoLevel    - the paper: per-job DO queues -> global queue -> one staging
                of each selected block serves ALL jobs (CAJS + MPDS).
  Independent - redundancy baseline: each job selects and stages its own
                queue (paper Fig. 3 "current mode").
  AllBlocks   - non-prioritized baseline: every block, every superstep.

The host driver `_run_host` schedules on the host (numpy + exact CBP) and
pushes on the session's device.  Each superstep reads the device exactly
once per view group (its <Node_un, P_mean> pairs, `_read_pairs`);
`RunMetrics.host_syncs` counts the supersteps that did.  The device
backend (`backend="device"`, `Fused`) is the next slice of the port.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import priority as prio
from repro_torch.core.push import compute_pairs, indep_push_fn, shared_push_fn

HOST, DEVICE = "host", "device"

_NEXT_SLICE = ("the device scheduling backend (backend='device', Fused) is "
               "not ported yet: ROADMAP A5/A6, the next slice")


@dataclasses.dataclass
class RunMetrics:
    supersteps: int = 0
    tile_loads: int = 0            # adjacency-block stagings
    # real adjacency bytes: nonzero (src, dst) block pairs moved, summed
    # over pushed view groups (tile_pair_loads * Vb^2 * 4 bytes)
    tile_pair_loads: int = 0
    job_block_pushes: int = 0      # (job, block) processing events
    host_syncs: int = 0            # scheduling host<->device round-trips
    halo_bytes: float = 0.0        # multi-device frontier payload (0 here)
    iterations_per_job: Optional[np.ndarray] = None
    converged: bool = False
    wall_time_s: float = 0.0       # driver wall time of this run()
    updates_applied: int = 0       # live-update counters (0 until ported)
    dirty_blocks: int = 0
    reseed_fraction: float = 0.0
    telemetry: Optional[object] = None

    def to_dict(self) -> dict:
        """Scalar record of this run (the reference's keys)."""
        return {"supersteps": int(self.supersteps),
                "tile_loads": int(self.tile_loads),
                "tile_pair_loads": int(self.tile_pair_loads),
                "job_block_pushes": int(self.job_block_pushes),
                "host_syncs": int(self.host_syncs),
                "halo_bytes": float(self.halo_bytes),
                "converged": bool(self.converged),
                "wall_time_s": round(float(self.wall_time_s), 6),
                "updates_applied": int(self.updates_applied),
                "dirty_blocks": int(self.dirty_blocks),
                "reseed_fraction": round(float(self.reseed_fraction), 6)}


@dataclasses.dataclass
class Selection:
    """One superstep's staging decision.

    shared=True: `sel`/`msk` are [q] — ONE staging of each selected block
    serves every job in every view group (CAJS; tile_loads counted once).
    shared=False: `sel`/`msk` are per-group lists of [J_g, q] — each job
    stages its own queue (the redundancy baseline).  Host policies fill
    it with numpy values and python-int counters.
    """

    sel: Union[np.ndarray, List[np.ndarray]]
    msk: Union[np.ndarray, List[np.ndarray]]
    shared: bool
    tile_loads: int
    job_block_pushes: int


class SchedulePolicy:
    """Base policy: subclasses implement `select` (host).

    It receives per-view-group lists (creation order): node_un[g] and
    p_mean[g] are [J_g, B_N] numpy arrays, active[g] is [J_g] bool."""

    name = "abstract"
    needs_pairs = True  # driver computes <Node_un, P_mean> before select()

    def __init__(self, *, backend: str = HOST,
                 steps_per_sync: Union[int, float] = 1):
        if backend == DEVICE:
            raise NotImplementedError(_NEXT_SLICE)
        if backend != HOST:
            raise ValueError(f"backend must be 'host' or 'device': {backend}")
        if steps_per_sync != 1:
            raise ValueError(
                "host scheduling decides every superstep — "
                "steps_per_sync requires backend='device'")
        self.backend = backend
        self.steps_per_sync = steps_per_sync

    def select(self, sess, node_un: Optional[Sequence[np.ndarray]],
               p_mean: Optional[Sequence[np.ndarray]],
               active: Sequence[np.ndarray]) -> Optional[Selection]:
        """Host staging decision, or None when nothing is schedulable
        (the driver then declares convergence)."""
        raise NotImplementedError

    def run(self, sess, max_supersteps: int = 100000) -> RunMetrics:
        t0 = time.perf_counter()
        m = _run_host(self, sess, max_supersteps)
        if sess.device.type == "cuda":
            torch.cuda.synchronize(sess.device)
        m.wall_time_s = time.perf_counter() - t0
        return m


# ---------------------------------------------------------------------------
# host driver: counts fall out of the pairs read; select on host
# ---------------------------------------------------------------------------


def _read_pairs(node_un: torch.Tensor, p_mean: torch.Tensor):
    """The ONE device->host read of a view group per superstep: both
    [J, B_N] pair arrays in a single copy."""
    both = torch.stack([node_un, p_mean]).cpu().numpy()
    return both[0], both[1]


def _run_host(policy: SchedulePolicy, sess,
              max_supersteps: int) -> RunMetrics:
    """Host driver: pairs -> select -> push, one scheduling sync per
    superstep.  The convergence counts are derived from the pairs
    (counts == node_un.sum(-1)), so policies that need pairs cost ONE
    device read per group per superstep; AllBlocks reads per-job counts
    only (needs_pairs=False)."""
    groups = sess.view_groups()
    dev = sess.device
    offs = np.cumsum([0] + [g.capacity for g in groups])
    grp_pairs = [sess._pair_data(g) for g in groups]
    # host mirror of the per-source-block real-pair counts, read once
    nnz_host = [p.src_nnz.cpu().numpy() for p in grp_pairs]
    shared_fns = [shared_push_fn(g.semiring, g.push_one, sess.use_pallas)
                  for g in groups]
    indep_fns = [indep_push_fn(g.push_one) for g in groups]
    m = RunMetrics(
        iterations_per_job=np.zeros(int(offs[-1]), dtype=np.int64))
    # a group observed fully converged stays converged for the rest of this
    # run (no job can arrive mid-run), so its read is skipped outright
    done = [None] * len(groups)
    bn = sess.scheduler.num_blocks

    def _mark_done(gi):
        g = groups[gi]
        done[gi] = (np.zeros(g.capacity, dtype=bool),
                    np.zeros((g.capacity, bn), np.float32)
                    if policy.needs_pairs else None)

    for _ in range(max_supersteps):
        actives = []
        node_un = []
        p_mean = [] if policy.needs_pairs else None
        for gi, g in enumerate(groups):
            if done[gi] is not None:
                actives.append(done[gi][0])
                if policy.needs_pairs:
                    node_un.append(done[gi][1])
                    p_mean.append(done[gi][1])
                else:
                    node_un.append(np.zeros(g.capacity, dtype=np.int32))
                continue
            if policy.needs_pairs:
                nu, pm = _read_pairs(*compute_pairs(g.alg, g.values,
                                                    g.deltas))
                node_un.append(nu)
                p_mean.append(pm)
                actives.append(prio.counts_from_pairs(nu) > 0)
            else:
                counts = sess._counts(g).cpu().numpy()   # the one read
                node_un.append(counts)
                actives.append(counts > 0)
            if not actives[gi].any():
                _mark_done(gi)
        for gi in range(len(groups)):
            m.iterations_per_job[offs[gi]:offs[gi + 1]][actives[gi]] += 1
        m.host_syncs += 1
        if not any(a.any() for a in actives):
            m.converged = True
            break
        selection = policy.select(sess, node_un if policy.needs_pairs
                                  else None, p_mean, actives)
        if selection is None:
            m.converged = True
            break
        # a fully-converged group is never pushed
        pair_step = 0
        if selection.shared:
            sel = torch.as_tensor(selection.sel, dtype=torch.int32,
                                  device=dev)
            msk = torch.as_tensor(selection.msk, dtype=torch.float32,
                                  device=dev)
            sel_np = np.asarray(selection.sel)
            on_np = np.asarray(selection.msk) > 0
            for gi, g in enumerate(groups):
                if not actives[gi].any():
                    continue
                pair_step += int(nnz_host[gi][sel_np][on_np].sum())
                g.values, g.deltas = shared_fns[gi](
                    g.values, g.deltas, g.graph.tiles, g.graph.nbr_ids,
                    sel, msk, g.push_scale, g.overlay, grp_pairs[gi])
        else:
            for gi, g in enumerate(groups):
                if not actives[gi].any():
                    continue
                sel_np = np.asarray(selection.sel[gi])
                on_np = np.asarray(selection.msk[gi]) > 0
                pair_step += int((nnz_host[gi][sel_np] * on_np).sum())
                g.values, g.deltas = indep_fns[gi](
                    g.values, g.deltas, g.graph.tiles, g.graph.nbr_ids,
                    torch.as_tensor(sel_np, dtype=torch.int32, device=dev),
                    torch.as_tensor(selection.msk[gi], dtype=torch.float32,
                                    device=dev),
                    g.push_scale, g.overlay)
        m.tile_pair_loads += pair_step
        m.supersteps += 1
        m.tile_loads += int(selection.tile_loads)
        m.job_block_pushes += int(selection.job_block_pushes)
    return m


class TwoLevel(SchedulePolicy):
    """The paper's schedule: MPDS (DO queues + global queue) + CAJS push.

    The global queue is synthesized across ALL jobs' DO queues regardless
    of view (block ids are view-agnostic); one staging of each selected
    block then serves both semiring families in the same superstep."""

    name = "two_level"

    def select(self, sess, node_un, p_mean, active):
        sched = sess.scheduler
        queues = []
        for nu, pm, act in zip(node_un, p_mean, active):
            queues.extend(sched.job_queues(nu, pm, act))
        gq = sched.synthesize(queues)
        if len(gq) == 0:
            return None
        q = sess.q
        gq = gq[:q]
        sel = np.zeros(q, dtype=np.int32)
        msk = np.zeros(q, dtype=np.float32)
        sel[:len(gq)] = gq
        msk[:len(gq)] = 1.0
        # CAJS: staged once, dispatched only to jobs unconverged on the block
        pushes = sum(int((nu[:, gq] > 0).sum()) for nu in node_un)
        return Selection(sel, msk, shared=True, tile_loads=int(len(gq)),
                         job_block_pushes=pushes)


class Independent(SchedulePolicy):
    """Per-job queues processed separately (paper Fig. 3 'current mode')."""

    name = "independent"

    def select(self, sess, node_un, p_mean, active):
        q = sess.q
        sels, msks = [], []
        loads = pushes = 0
        for nu, pm, act in zip(node_un, p_mean, active):
            j_cap = nu.shape[0]
            sel = np.zeros((j_cap, q), dtype=np.int32)
            msk = np.zeros((j_cap, q), dtype=np.float32)
            for j, qj in enumerate(sess.scheduler.job_queues(nu, pm, act)):
                if len(qj) == 0:
                    continue
                sel[j, :len(qj)] = qj[:q]
                msk[j, :len(qj)] = 1.0
                loads += int(len(qj))          # each job stages its own
                pushes += int(len(qj))
            sels.append(sel)
            msks.append(msk)
        return Selection(sels, msks, shared=False, tile_loads=loads,
                         job_block_pushes=pushes)


class AllBlocks(SchedulePolicy):
    """Non-prioritized synchronous baseline: all blocks, shared staging."""

    name = "all_blocks"
    needs_pairs = False

    def select(self, sess, node_un, p_mean, active):
        bn = sess.scheduler.num_blocks
        sel = np.arange(bn, dtype=np.int32)
        msk = np.ones(bn, dtype=np.float32)
        n_active = sum(int(a.sum()) for a in active)
        return Selection(sel, msk, shared=True, tile_loads=bn,
                         job_block_pushes=bn * n_active)


class Fused(TwoLevel):
    """TwoLevel(backend="device", steps_per_sync=inf) in the reference;
    the port's device backend is the next slice, so this raises."""

    name = "fused"

    def __init__(self, *, steps_per_sync: Union[int, float] = math.inf):
        raise NotImplementedError(_NEXT_SLICE)


POLICIES = {p.name: p for p in (TwoLevel, Fused, Independent, AllBlocks)}
