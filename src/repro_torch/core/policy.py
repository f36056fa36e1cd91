"""Pluggable schedule policies over a GraphSession.

A policy decides, per superstep, WHICH blocks are staged and WHO processes
them; the driver owns everything else (convergence test, metrics, the push
dispatch).  All policies reach the same per-job fixpoint — they differ
only in schedule and therefore in tile_loads / supersteps:

  TwoLevel    - the paper: per-job DO queues -> global queue -> one staging
                of each selected block serves ALL jobs (CAJS + MPDS).
  Independent - redundancy baseline: each job selects and stages its own
                queue (paper Fig. 3 "current mode").
  AllBlocks   - non-prioritized baseline: every block, every superstep.
  Fused       - TwoLevel(backend="device", steps_per_sync=inf).

Every policy runs on either BACKEND:

  backend="host"   - scheduling on the host (numpy + exact CBP), push on
                     the session's device; `_run_host` reads the device
                     once per view group per superstep (`_read_pairs`).
  backend="device" - both scheduling levels run on the session's device
                     beside the push (`build_device_step`): the DO
                     queues (`do_select_device`, the port's counter-based
                     draw), the global synthesis (`accumulate_priority`,
                     `synthesize_topq`) and the push, with no host read
                     inside a chunk.  `steps_per_sync=K` runs K gated
                     supersteps back to back, then reads (it,
                     unconverged_total) once; a gated superstep (all
                     converged, or the budget spent) leaves the state
                     bit-identical and counts nothing.  The superstep at
                     stream position p draws `step_key(seed, p)`, as the
                     scheduler's list interface does at p.

Known difference from the reference: torch runs eagerly and has no
device-side while loop, so `steps_per_sync=math.inf` runs repeated chunks
of `INF_CHUNK` supersteps and `host_syncs` is ceil(supersteps / chunk)
where the reference's while_loop reports 1.  The schedule itself does not
depend on the cadence: the superstep at stream position p draws the same
numbers whatever the chunk length and wherever runs begin and end.

`RunMetrics.host_syncs` counts scheduling round-trips (host backend: one
per superstep including the final all-converged poll; device backend: one
per chunk).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import priority as prio
from repro_torch.core.do_select import group_queues_device, step_key
from repro_torch.core.global_q import accumulate_priority, synthesize_topq
from repro_torch.core.push import compute_pairs, indep_push_fn, shared_push_fn

HOST, DEVICE = "host", "device"

#: supersteps per host read under steps_per_sync=math.inf (the device
#: driver has no device-side while loop, so "until the fixpoint" is
#: repeated chunks of this length)
INF_CHUNK = 16


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
    """Base policy: subclasses implement `select` (host) / `device_select`.

    Both receive per-view-group lists (creation order): node_un[g] and
    p_mean[g] are [J_g, B_N] (numpy arrays on the host, tensors on the
    device), active[g] is [J_g] bool."""

    name = "abstract"
    needs_pairs = True  # driver computes <Node_un, P_mean> before select()

    def __init__(self, *, backend: str = HOST,
                 steps_per_sync: Union[int, float] = 1):
        if backend not in (HOST, DEVICE):
            raise ValueError(f"backend must be 'host' or 'device': {backend}")
        if backend == HOST:
            if steps_per_sync != 1:
                raise ValueError(
                    "host scheduling decides every superstep — "
                    "steps_per_sync requires backend='device'")
        elif steps_per_sync != math.inf and (
                steps_per_sync != int(steps_per_sync) or steps_per_sync < 1):
            raise ValueError(
                f"steps_per_sync must be a positive int or math.inf: "
                f"{steps_per_sync}")
        self.backend = backend
        self.steps_per_sync = steps_per_sync

    def select(self, sess, node_un: Optional[Sequence[np.ndarray]],
               p_mean: Optional[Sequence[np.ndarray]],
               active: Sequence[np.ndarray]) -> Optional[Selection]:
        """Host staging decision, or None when nothing is schedulable
        (the driver then declares convergence)."""
        raise NotImplementedError

    def device_select(self, node_uns, p_means, actives, key, *, q: int,
                      alpha: float, samples: int,
                      num_blocks: int) -> Selection:
        """Staging decision on the device, inside the superstep.  `key` is
        this superstep's draw key, `step_key(seed, position)` (an int64
        0-dim tensor)."""
        raise NotImplementedError

    def run(self, sess, max_supersteps: int = 100000) -> RunMetrics:
        t0 = time.perf_counter()
        if self.backend == DEVICE:
            m = _run_device(self, sess, max_supersteps)
        else:
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


# ---------------------------------------------------------------------------
# device driver: gated supersteps on the device, one host read per chunk
# ---------------------------------------------------------------------------


def build_device_step(policy: SchedulePolicy, sess):
    """The session's superstep for `policy` as one chunk function:

        step_fn(state, scales, tiles, nbrs, overlays, pairs, max_steps,
                seed, stream_pos) -> (state, unconverged_total)

    where state = (it, values_tuple, deltas_tuple, loads, pushes,
    pair_loads, iters_tuple, boost), `pairs` is the per-group `BlockPairs`
    tuple and `stream_pos` the stream position at the run's start.  One
    call runs a chunk of supersteps back to back on the device —
    steps_per_sync of them, or `INF_CHUNK` for math.inf — each GATED:
    where all jobs have converged or `it` has reached max_steps, the
    superstep leaves every carry entry bit-identical, counts nothing and
    does not advance `it`
    (`torch.where` on a 0-dim device bool; counters add live x count).
    Nothing in a chunk reads the device from the host: no `.item()`, no
    data-dependent shape (`nonzero`, boolean masks), no host branch on a
    device value.  Superstep t of the run draws from
    step_key(seed, stream_pos + t), so the schedule does not depend on the
    chunk length.

    The kernels still launch in a gated superstep and for a converged
    group, but read that gate (`live & group active`) on the device at
    entry and return before any load; their results are discarded.  So
    the kernels' launch counters count chunk slots, not live supersteps.
    Cache via session._device_step_fn."""
    groups = sess.view_groups()
    n_groups = len(groups)
    algs = [g.alg for g in groups]
    q = int(sess.q)
    alpha = float(sess.alpha)
    samples = int(sess.samples)
    bn = int(sess.scheduler.num_blocks)
    chunk = (INF_CHUNK if policy.steps_per_sync == math.inf
             else int(policy.steps_per_sync))
    needs_pairs = policy.needs_pairs

    shared_push = [shared_push_fn(g.semiring, g.push_one, sess.use_pallas)
                   for g in groups]
    indep_push = [indep_push_fn(g.push_one) for g in groups]

    def unconverged_total(vs, ds):
        tot = 0
        for gi in range(n_groups):
            tot = tot + algs[gi].unconverged(vs[gi], ds[gi]).sum()
        return tot

    def superstep(carry, scales, tiles, nbrs, ovs, prs, max_steps, seed,
                  stream_pos):
        it, vs, ds, loads, pushes, pair_loads, iters, boost = carry
        live = (unconverged_total(vs, ds) > 0) & (it < max_steps)
        node_uns, p_means, actives = [], [], []
        for gi in range(n_groups):
            if needs_pairs:
                nu, pm = compute_pairs(algs[gi], vs[gi], ds[gi])
                pm = pm + boost[None, :] * (nu > 0)
            else:   # Node_un alone suffices (AllBlocks): cheaper reduce
                un = algs[gi].unconverged(vs[gi], ds[gi])
                nu = un.sum(-1).to(torch.float32)
                pm = None
            node_uns.append(nu)
            p_means.append(pm)
            actives.append(prio.counts_from_pairs(nu) > 0)
        selection = policy.device_select(
            node_uns, p_means, actives, step_key(seed, stream_pos + it),
            q=q, alpha=alpha, samples=samples, num_blocks=bn)
        new_vs, new_ds, new_iters = [], [], []
        pair_step = torch.zeros((), dtype=torch.float32, device=it.device)
        for gi in range(n_groups):
            # a fully-converged group is never pushed, exactly as in the
            # host driver: freezing it keeps sub-tolerance plus-times
            # residual mass where convergence left it
            keep = actives[gi].any()
            upd = live & keep
            if selection.shared:
                # the kernel reads `upd` at entry: a gated slot or a
                # converged group loads nothing (its result is discarded)
                v2, d2 = shared_push[gi](
                    vs[gi], ds[gi], tiles[gi], nbrs[gi],
                    selection.sel, selection.msk, scales[gi], ovs[gi],
                    prs[gi], gate=upd)
                pair_cnt = (prs[gi].src_nnz[selection.sel.long()]
                            * (selection.msk > 0)).sum()
            else:
                v2, d2 = indep_push[gi](
                    vs[gi], ds[gi], tiles[gi], nbrs[gi],
                    selection.sel[gi], selection.msk[gi], scales[gi],
                    ovs[gi])
                pair_cnt = (prs[gi].src_nnz[selection.sel[gi].long()]
                            * (selection.msk[gi] > 0)).sum()
            new_vs.append(torch.where(upd, v2, vs[gi]))
            new_ds.append(torch.where(upd, d2, ds[gi]))
            new_iters.append(iters[gi]
                             + (live & actives[gi]).to(torch.int32))
            pair_step = pair_step + (keep.to(torch.float32)
                                     * pair_cnt.to(torch.float32))
        lf = live.to(torch.float32)
        # the counters accumulate in float32, as the reference's carry does
        # (exact up to 2^24, rounded beyond)
        return (it + live.to(it.dtype), tuple(new_vs), tuple(new_ds),
                loads + lf * selection.tile_loads.to(torch.float32),
                pushes + lf * selection.job_block_pushes.to(torch.float32),
                pair_loads + lf * pair_step,
                tuple(new_iters),
                torch.where(live, torch.zeros_like(boost), boost))

    def step_fn(state, scales, tiles, nbrs, ovs, prs, max_steps, seed,
                stream_pos):
        for _ in range(chunk):
            state = superstep(state, scales, tiles, nbrs, ovs, prs,
                              max_steps, seed, stream_pos)
        return state, unconverged_total(state[1], state[2])

    step_fn.chunk = chunk
    return step_fn


def device_inputs(sess):
    """(state, scales, tiles, nbrs, overlays, pairs): the device driver's
    initial carry over the session's current job state, and the per-group
    graph arguments of its step function."""
    groups = sess.view_groups()
    dev = sess.device
    boost = sess._consume_dirty_boost()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    state = (torch.zeros((), dtype=torch.int64, device=dev),
             tuple(g.values for g in groups),
             tuple(g.deltas for g in groups),
             zero, zero.clone(), zero.clone(),
             tuple(torch.zeros(g.capacity, dtype=torch.int32, device=dev)
                   for g in groups),
             torch.zeros(sess.scheduler.num_blocks, dtype=torch.float32,
                         device=dev) if boost is None
             else torch.as_tensor(boost, dtype=torch.float32, device=dev))
    return (state,
            tuple(g.push_scale for g in groups),
            tuple(g.graph.tiles for g in groups),
            tuple(g.graph.nbr_ids for g in groups),
            tuple(g.overlay for g in groups),
            tuple(sess._pair_data(g) for g in groups))


def _run_device(policy: SchedulePolicy, sess,
                max_supersteps: int) -> RunMetrics:
    """Device driver: call the cached chunk function, read once per chunk.

    The draw mirrors the host scheduler RNG's semantics: superstep t of
    the run draws step_key(seed, stream_pos + t), where stream_pos is the
    scheduler's persistent position — advanced here by the supersteps
    consumed — so repeated run()/step() calls keep drawing fresh samples
    (and `reset()` restores the stream).  The trajectory does not depend
    on steps_per_sync, so supersteps / tile_loads are identical across
    cadences."""
    groups = sess.view_groups()
    step_fn = sess._device_step_fn(policy)
    state, *args = device_inputs(sess)
    budget = int(min(max_supersteps, np.iinfo(np.int32).max))
    seed, pos = sess.seed, sess.scheduler._step
    m = RunMetrics()
    while True:
        state, un = step_fn(state, *args, budget, seed, pos)
        # the ONE host read of the chunk: (it, unconverged_total) together
        it_h, un_h = torch.stack([state[0], un.to(torch.int64)]).tolist()
        m.host_syncs += 1
        if un_h == 0 or it_h >= budget:
            break
    sess.scheduler._step += it_h
    for gi, g in enumerate(groups):
        g.values, g.deltas = state[1][gi], state[2][gi]
    m.supersteps = it_h
    loads_h, pushes_h, pair_loads_h = torch.stack(
        [state[3], state[4], state[5]]).tolist()
    m.tile_loads = int(loads_h)
    m.job_block_pushes = int(pushes_h)
    m.tile_pair_loads = int(pair_loads_h)
    m.converged = un_h == 0
    m.iterations_per_job = np.concatenate(
        [x.cpu().numpy().astype(np.int64) for x in state[6]])
    return m


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------


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

    def device_select(self, node_uns, p_means, actives, key, *, q, alpha,
                      samples, num_blocks):
        dev = node_uns[0].device
        pri = torch.zeros(num_blocks, dtype=torch.float32, device=dev)
        heads = torch.zeros(num_blocks, dtype=torch.bool, device=dev)
        for gi, (nu, pm) in enumerate(zip(node_uns, p_means)):
            sel, msk = group_queues_device(nu, pm, key, gi, q, samples)
            pri, heads = accumulate_priority(pri, heads, sel, msk, q)
        gsel, gmsk = synthesize_topq(pri, heads, q, alpha)
        gl = gsel.long()
        pushes = sum(((nu[:, gl] > 0) & (gmsk > 0)[None, :]).sum()
                     for nu in node_uns)
        return Selection(gsel, gmsk, shared=True,
                         tile_loads=(gmsk > 0).sum().to(torch.int32),
                         job_block_pushes=pushes.to(torch.int32))


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

    def device_select(self, node_uns, p_means, actives, key, *, q, alpha,
                      samples, num_blocks):
        sels, msks = [], []
        loads = 0
        for gi, (nu, pm) in enumerate(zip(node_uns, p_means)):
            sel, msk = group_queues_device(nu, pm, key, gi, q, samples)
            sels.append(sel)
            msks.append(msk)
            loads = loads + (msk > 0).sum()
        loads = loads.to(torch.int32)
        return Selection(sels, msks, shared=False, tile_loads=loads,
                         job_block_pushes=loads)


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

    def device_select(self, node_uns, p_means, actives, key, *, q, alpha,
                      samples, num_blocks):
        dev = node_uns[0].device
        n_active = sum(act.sum() for act in actives).to(torch.int32)
        return Selection(
            torch.arange(num_blocks, dtype=torch.int32, device=dev),
            torch.ones(num_blocks, dtype=torch.float32, device=dev),
            shared=True,
            tile_loads=torch.full((), num_blocks, dtype=torch.int32,
                                  device=dev),
            job_block_pushes=n_active * num_blocks)


class Fused(TwoLevel):
    """TwoLevel(backend="device", steps_per_sync=inf): the whole two-level
    loop — pairs, DO sampling, global synthesis, push, convergence test —
    on the device, read by the host once per `INF_CHUNK` supersteps.  It
    only pins the backend; pass a finite steps_per_sync to trade
    convergence latency for submit/detach opportunities."""

    name = "fused"

    def __init__(self, *, steps_per_sync: Union[int, float] = math.inf):
        super().__init__(backend=DEVICE, steps_per_sync=steps_per_sync)


POLICIES = {p.name: p for p in (TwoLevel, Fused, Independent, AllBlocks)}
