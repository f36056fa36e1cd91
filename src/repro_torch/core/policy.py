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

Telemetry (`repro_torch.obs.telemetry`): a session built with
`telemetry=...` gets a per-superstep `TelemetrySeries` on
`RunMetrics.telemetry` from either driver, with no extra host read: the
host driver's residual rides the pairs read, the device driver's series
rides the chunk carry and the run's final counter read.
"""

from __future__ import annotations

import contextlib
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
from repro_torch.obs.telemetry import (SERIES_FIELDS, HostSeriesBuilder,
                                       TelemetrySeries, device_buffers,
                                       device_rows, device_write,
                                       series_from_rows)

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
    # evolving-graph counters (repro_torch.stream), drained from the
    # session's apply_updates() calls since the previous run()
    updates_applied: int = 0       # edge insert/delete ops absorbed
    dirty_blocks: int = 0          # blocks marked update-affected
    reseed_fraction: float = 0.0   # re-seeded share of active job state
    # per-superstep series, only when the session was built with
    # telemetry=...; None otherwise
    telemetry: Optional[TelemetrySeries] = None

    def to_dict(self, include_telemetry: bool = False) -> dict:
        """Scalar record of this run (the reference's keys), with the
        series under "telemetry" when asked for and recorded."""
        d = {"supersteps": int(self.supersteps),
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
        if include_telemetry and self.telemetry is not None:
            d["telemetry"] = self.telemetry.to_dict()
        return d


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


def _profiler_span(sess, name: str):
    """A `torch.profiler.record_function` span around one driver phase,
    opt-in via TelemetryConfig(jax_profiler=True); a no-op otherwise."""
    cfg = sess.telemetry
    if cfg is not None and cfg.jax_profiler:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def _selection_occupancy(selection: Selection) -> int:
    """Staged-selection occupancy for telemetry: shared policies report the
    global-queue length (<= q), independent the total queue entries."""
    if selection.shared:
        return int(np.sum(np.asarray(selection.msk) > 0))
    return sum(int(np.sum(np.asarray(msk) > 0)) for msk in selection.msk)


def _pairs_and_resid(alg, values: torch.Tensor, deltas: torch.Tensor):
    """compute_pairs plus the group's max vertex priority (telemetry's
    max_residual), all from one vertex-priority tensor."""
    vp = alg.vertex_priority(values, deltas)
    node_un, p_mean = prio.block_pairs(vp)
    return node_un, p_mean, vp.max()


def _read_pairs(node_un: torch.Tensor, p_mean: torch.Tensor,
                resid: Optional[torch.Tensor] = None):
    """The ONE device->host read of a view group per superstep: both
    [J, B_N] pair arrays in a single copy.  With telemetry, the group's
    max residual (a 0-dim float32) rides the same copy and is returned
    third."""
    if resid is None:
        both = torch.stack([node_un, p_mean]).cpu().numpy()
        return both[0], both[1]
    n = node_un.numel()
    flat = torch.cat([node_un.reshape(-1), p_mean.reshape(-1),
                      resid.reshape(1)]).cpu().numpy()
    return (flat[:n].reshape(node_un.shape),
            flat[n:2 * n].reshape(p_mean.shape), float(flat[-1]))


def _read_counts(counts: torch.Tensor, resid: torch.Tensor):
    """[cap] unconverged counts and the max residual in one copy (float64
    holds both exactly)."""
    flat = torch.cat([counts.to(torch.float64),
                      resid.reshape(1).to(torch.float64)]).cpu().numpy()
    return flat[:-1].astype(np.int64), float(flat[-1])


def _run_host(policy: SchedulePolicy, sess,
              max_supersteps: int) -> RunMetrics:
    """Host driver: pairs -> select -> push, one scheduling sync per
    superstep.  The convergence counts are derived from the pairs
    (counts == node_un.sum(-1)), so policies that need pairs cost ONE
    device read per group per superstep; AllBlocks reads per-job counts
    only (needs_pairs=False).

    Telemetry: with the session built telemetry=..., each superstep
    appends one row to a HostSeriesBuilder.  The max-residual column
    rides the same read as the pairs (or the counts), so telemetry adds
    no host read."""
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
    telemetry = sess.telemetry is not None
    series = (HostSeriesBuilder([g.key for g in groups]) if telemetry
              else None)
    resids = [0.0] * len(groups)
    # a group observed fully converged stays converged for the rest of this
    # run (no job can arrive mid-run), so its read is skipped outright
    done = [None] * len(groups)
    bn = sess.scheduler.num_blocks
    trace = sess.trace if sess.trace.enabled else None
    # dirty-block priority injection (repro_torch.stream): update-affected
    # blocks enter every job's DO queue boosted on the FIRST superstep
    # after apply_updates, only where the job has pending work there
    boost = sess._consume_dirty_boost()

    def _mark_done(gi):
        g = groups[gi]
        done[gi] = (np.zeros(g.capacity, dtype=bool),
                    np.zeros((g.capacity, bn), np.float32)
                    if policy.needs_pairs else None)

    for _ in range(max_supersteps):
        t_step = trace.now_us() if trace else 0.0
        dirty_n = int((boost > 0).sum()) if boost is not None else 0
        actives = []
        node_un = []
        p_mean = [] if policy.needs_pairs else None
        with _profiler_span(sess, "superstep.schedule"):
            for gi, g in enumerate(groups):
                if done[gi] is not None:
                    actives.append(done[gi][0])
                    if policy.needs_pairs:
                        node_un.append(done[gi][1])
                        p_mean.append(done[gi][1])
                    else:
                        node_un.append(np.zeros(g.capacity, dtype=np.int32))
                    resids[gi] = 0.0
                    continue
                if policy.needs_pairs:
                    if telemetry:
                        nu, pm, resids[gi] = _read_pairs(
                            *_pairs_and_resid(g.alg, g.values, g.deltas))
                    else:
                        nu, pm = _read_pairs(*compute_pairs(
                            g.alg, g.values, g.deltas))
                    if boost is not None:
                        pm = pm + boost[None, :] * (nu > 0)
                    node_un.append(nu)
                    p_mean.append(pm)
                    actives.append(prio.counts_from_pairs(nu) > 0)
                else:
                    if telemetry:   # the one read, residual riding along
                        counts, resids[gi] = _read_counts(
                            sess._counts(g), g.alg.vertex_priority(
                                g.values, g.deltas).max())
                    else:
                        counts = sess._counts(g).cpu().numpy()
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
        boost = None
        selection = policy.select(sess, node_un if policy.needs_pairs
                                  else None, p_mean, actives)
        if selection is None:
            m.converged = True
            break
        # a fully-converged group is never pushed
        pair_step = 0
        with _profiler_span(sess, "superstep.push"):
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
                        torch.as_tensor(sel_np, dtype=torch.int32,
                                        device=dev),
                        torch.as_tensor(selection.msk[gi],
                                        dtype=torch.float32, device=dev),
                        g.push_scale, g.overlay)
        m.tile_pair_loads += pair_step
        if series is not None:
            # everything but pair_step is a pre-push read; the row is
            # appended post-push only so that pair_step can join it
            series.append(
                active_jobs=sum(int(a.sum()) for a in actives),
                tile_loads=int(selection.tile_loads),
                job_block_pushes=int(selection.job_block_pushes),
                gq_occupancy=_selection_occupancy(selection),
                dirty_blocks=dirty_n,
                unconverged=[int(np.sum(nu)) for nu in node_un],
                max_residual=resids, tile_pair_loads=pair_step)
        m.supersteps += 1
        m.tile_loads += int(selection.tile_loads)
        m.job_block_pushes += int(selection.job_block_pushes)
        if trace:
            trace.complete("superstep", t_step, trace.now_us() - t_step,
                           cat="superstep", tid=2, step=m.supersteps - 1,
                           tile_loads=int(selection.tile_loads))
    if series is not None:
        m.telemetry = series.build()
    return m


# ---------------------------------------------------------------------------
# device driver: gated supersteps on the device, one host read per chunk
# ---------------------------------------------------------------------------


def build_device_step(policy: SchedulePolicy, sess):
    """The session's superstep for `policy` as one chunk function:

        step_fn(state, scales, tiles, nbrs, overlays, pairs, max_steps,
                seed, stream_pos) -> (state, unconverged_total)

    where state = (it, values_tuple, deltas_tuple, loads, pushes,
    pair_loads, iters_tuple, boost), with the telemetry row buffer
    (`obs.telemetry.device_buffers`) as a ninth entry only when the
    session has telemetry, `pairs` is the per-group `BlockPairs` tuple
    and `stream_pos` the stream position at the run's start.  One
    call runs a chunk of supersteps back to back on the device —
    steps_per_sync of them, or `INF_CHUNK` for math.inf — each GATED:
    where all jobs have converged or `it` has reached max_steps, the
    superstep leaves every carry entry bit-identical, counts nothing and
    does not advance `it`
    (`torch.where` on a 0-dim device bool; the int64 counters add
    live x count).
    Nothing in a chunk reads the device from the host: no `.item()`, no
    data-dependent shape (`nonzero`, boolean masks), no host branch on a
    device value.  Superstep t of the run draws from
    step_key(seed, stream_pos + t), so the schedule does not depend on the
    chunk length.

    The kernels still launch in a gated superstep and for a converged
    group, but read that gate (`live & group active`) on the device at
    entry and return before any load; their results are discarded.  So
    the kernels' launch counters count chunk slots, not live supersteps.

    Telemetry on, each superstep also writes its series row in place
    into the buffer at min(it, capacity - 1): pure reads of the pre-push
    state (max_residual is the max vertex priority before the push) plus
    the push loop's pair count.  The write is gated like the totals: a
    gated slot writes back the row it finds, so a truncated series keeps
    the last executed superstep in its last row and the series sums equal
    the run totals.  Telemetry off, the chunk issues exactly the
    operations it issues without it.
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
    tel_cap = (int(sess.telemetry.capacity) if sess.telemetry is not None
               else 0)

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
        it, vs, ds, loads, pushes, pair_loads, iters, boost = carry[:8]
        live = (unconverged_total(vs, ds) > 0) & (it < max_steps)
        node_uns, p_means, actives, resids = [], [], [], []
        for gi in range(n_groups):
            if needs_pairs:
                if tel_cap:
                    nu, pm, resid = _pairs_and_resid(algs[gi], vs[gi],
                                                     ds[gi])
                    resids.append(resid)
                else:
                    nu, pm = compute_pairs(algs[gi], vs[gi], ds[gi])
                pm = pm + boost[None, :] * (nu > 0)
            else:   # Node_un alone suffices (AllBlocks): cheaper reduce
                un = algs[gi].unconverged(vs[gi], ds[gi])
                nu = un.sum(-1).to(torch.float32)
                pm = None
                if tel_cap:
                    resids.append(algs[gi].vertex_priority(
                        vs[gi], ds[gi]).max())
            node_uns.append(nu)
            p_means.append(pm)
            actives.append(prio.counts_from_pairs(nu) > 0)
        selection = policy.device_select(
            node_uns, p_means, actives, step_key(seed, stream_pos + it),
            q=q, alpha=alpha, samples=samples, num_blocks=bn)
        new_vs, new_ds, new_iters = [], [], []
        pair_step = torch.zeros((), dtype=torch.int64, device=it.device)
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
            pair_step = pair_step + keep.to(torch.int64) * pair_cnt
        tel = ()
        if tel_cap:
            if selection.shared:
                occ = (selection.msk > 0).sum()
            else:
                occ = sum((msk > 0).sum() for msk in selection.msk)
            tel = (device_write(
                carry[8], torch.clamp(it, max=tel_cap - 1).reshape(1), live,
                active_jobs=sum(a.sum() for a in actives),
                tile_loads=selection.tile_loads,
                job_block_pushes=selection.job_block_pushes,
                gq_occupancy=occ, dirty_blocks=(boost > 0).sum(),
                unconverged=torch.stack([nu.sum() for nu in node_uns]),
                max_residual=torch.stack(resids),
                tile_pair_loads=pair_step),)
        li = live.to(torch.int64)
        # the counters accumulate in int64, exact at any length (the
        # reference's float32 carry rounds past 2^24)
        return (it + li, tuple(new_vs), tuple(new_ds),
                loads + li * selection.tile_loads,
                pushes + li * selection.job_block_pushes,
                pair_loads + li * pair_step,
                tuple(new_iters),
                torch.where(live, torch.zeros_like(boost), boost)) + tel

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
    initial carry over the session's current job state (with fresh
    telemetry buffer when the session has telemetry), and the per-group
    graph arguments of its step function."""
    groups = sess.view_groups()
    dev = sess.device
    boost = sess._consume_dirty_boost()
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    state = (torch.zeros((), dtype=torch.int64, device=dev),
             tuple(g.values for g in groups),
             tuple(g.deltas for g in groups),
             zero, zero.clone(), zero.clone(),
             tuple(torch.zeros(g.capacity, dtype=torch.int32, device=dev)
                   for g in groups),
             torch.zeros(sess.scheduler.num_blocks, dtype=torch.float32,
                         device=dev) if boost is None
             else torch.as_tensor(boost, dtype=torch.float32, device=dev))
    if sess.telemetry is not None:
        state = state + (device_buffers(sess.telemetry.capacity,
                                        len(groups), dev),)
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
    trace = sess.trace if sess.trace.enabled else None
    m = RunMetrics()
    while True:
        t_chunk = trace.now_us() if trace else 0.0
        with _profiler_span(sess, "device_chunk"):
            state, un = step_fn(state, *args, budget, seed, pos)
            # the ONE host read of the chunk: (it, unconverged_total)
            it_h, un_h = torch.stack([state[0],
                                      un.to(torch.int64)]).tolist()
        m.host_syncs += 1
        if trace:
            trace.complete("device_chunk", t_chunk,
                           trace.now_us() - t_chunk, cat="superstep", tid=2,
                           sync=m.host_syncs - 1, supersteps_done=it_h)
        if un_h == 0 or it_h >= budget:
            break
    sess.scheduler._step += it_h
    for gi, g in enumerate(groups):
        g.values, g.deltas = state[1][gi], state[2][gi]
    m.supersteps = it_h
    m.converged = un_h == 0
    # the run's totals, iteration counts and series in one read (float64
    # holds the counts exactly up to 2^53)
    parts = [torch.stack([state[3], state[4], state[5]]).to(torch.float64)]
    parts += [x.to(torch.float64) for x in state[6]]
    if sess.telemetry is not None:
        parts.append(device_rows(state[8], it_h).reshape(-1))
    flat = torch.cat(parts).cpu().numpy()
    m.tile_loads, m.job_block_pushes, m.tile_pair_loads = (
        int(x) for x in flat[:3])
    n_iters = sum(g.capacity for g in groups)
    m.iterations_per_job = flat[3:3 + n_iters].astype(np.int64)
    if sess.telemetry is not None:
        m.telemetry = series_from_rows(
            flat[3 + n_iters:].reshape(
                min(it_h, sess.telemetry.capacity),
                len(SERIES_FIELDS) + 2 * len(groups)),
            it_h, sess.telemetry.capacity, [g.key for g in groups])
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
