"""Rank-side scenarios of tests/test_torch_dist_stream.py (no tests here).

Live updates, compaction, new views, growth and the serve front on a
session placed on a mesh.  Each world function runs in every rank of a
`repro_torch.dist.world.run_world` world (spawned processes, gloo on the
CPU) and returns, from rank 0, plain numpy/python results for the test
process to hold against the port on one device and against `repro`.
This module imports torch and `repro_torch` only: the ranks check that
neither JAX nor `repro` was imported into them.
"""

from __future__ import annotations

import dataclasses
import sys
import warnings

import numpy as np
import torch.distributed as dist

BLOCK = 16
CASES = ("mutation", "rescale", "overlay", "overflow")
OVERLAY_CAPACITY = 2
FREE_ROW = 7          # the source block with the most pairs without a tile


def _imports_clean() -> bool:
    return not any(m == "jax" or m.startswith("jax.") or m == "repro"
                   or m.startswith("repro.") for m in sys.modules)


def _all_ranks(x):
    """`x` from every rank, in rank order (on every rank)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, x)
    return out


# ---------------------------------------------------------------------------
# sessions and batches (the test process builds the same ones on one device)
# ---------------------------------------------------------------------------


def core_algs():
    """Three views: out-degree plus-times (PageRank twice), raw min-plus
    (SSSP twice) and a symmetrized plus-times one (Katz, the full-reseed
    path)."""
    import repro_torch.algorithms as ta
    return [ta.PageRank(), ta.PageRank(damping=0.7), ta.SSSP(source=3),
            ta.SSSP(source=17), ta.Katz(alpha=0.02, graph_symmetrize=True)]


def core_session(device="cpu", **kw):
    """rmat_graph(128, 4, seed=7) at Vb 16 (B_N = 8), capacity 2 a view,
    overlay rows of 2."""
    import repro_torch.core as tc
    import repro_torch.graph as tg
    csr = tg.rmat_graph(128, 4, seed=7)
    sess = tc.GraphSession(csr, BLOCK, capacity=2, seed=0, device=device,
                           overlay_capacity=OVERLAY_CAPACITY, **kw)
    return sess, [sess.submit(a) for a in core_algs()]


def new_pairs(csr, row: int, count: int):
    """`count` inserts from block `row` to destination blocks it has no
    tile for (in the raw view), none an existing edge."""
    taken = {int(v) // BLOCK for u in range(row * BLOCK, (row + 1) * BLOCK)
             for v in csr.row(u)[0]}
    free = [db for db in range(-(-csr.n // BLOCK)) if db not in taken]
    if len(free) < count:
        raise ValueError(f"block {row} has {len(free)} free pairs")
    u = row * BLOCK
    return [u] * count, [db * BLOCK + 1 for db in free[:count]]


def case_batch(csr, case: str):
    """The single batch of each case of the single-batch scenario."""
    import repro_torch.graph as tg
    from repro_torch.stream import UpdateBatch
    from repro_torch.stream.updates import DELETE, INSERT
    if case == "mutation":
        return tg.mutation_stream(csr, 1, inserts_per_batch=6,
                                  deletes_per_batch=3, seed=4,
                                  weighted=True)[0]
    if case == "rescale":
        # inserts on pairs that own a tile and deletes: the sources'
        # out-degrees change, so their out-degree rows rescale
        src, dst, op = [], [], []
        for u in (5, 40, 77, 100):
            row = set(csr.row(u)[0].tolist())
            blocks = sorted({v // BLOCK for v in row})
            v = next(db * BLOCK + k for db in blocks for k in range(BLOCK)
                     if db * BLOCK + k not in row and db * BLOCK + k != u)
            src.append(u)
            dst.append(v)
            op.append(INSERT)
        for u in (9, 63):
            src.append(u)
            dst.append(int(csr.row(u)[0][0]))
            op.append(DELETE)
        return UpdateBatch(src, dst, np.full(len(src), 2.0, np.float32), op)
    rows = (OVERLAY_CAPACITY if case == "overlay"
            else OVERLAY_CAPACITY + 1)
    return UpdateBatch.inserts(*new_pairs(csr, FREE_ROW, rows))


def reweight_batch(csr):
    """Inserts on existing edges (reweights): tile edits in every view,
    no new pair and no degree change."""
    from repro_torch.stream import UpdateBatch
    src = [5, 40, 77, 100]
    dst = [int(csr.row(u)[0][0]) for u in src]
    return UpdateBatch.inserts(src, dst, np.full(len(src), 0.5, np.float32))


def group_state(sess) -> dict:
    """{view key: (values, deltas, push_scale, active)} of a session on
    one device (what `convert.load_group_state` takes)."""
    return {g.key: (g.values.numpy().copy(), g.deltas.numpy().copy(),
                    g.push_scale.numpy().copy(), g.active.copy())
            for g in sess.view_groups()}


def load_state(sess, state: dict) -> None:
    from repro_torch import convert
    for key, (v, d, ps, act) in state.items():
        convert.load_group_state(sess, key, v, d, ps, act)


def stream_batches(csr):
    """The reference's STREAM_SCRIPT batches."""
    import repro_torch.graph as tg
    return tg.mutation_stream(csr, 2, inserts_per_batch=4,
                              deletes_per_batch=2, seed=9, weighted=False,
                              w_max=4.0)


def stream_algs():
    import repro_torch.algorithms as ta
    return [ta.PageRank(), ta.SSSP(source=5), ta.Katz(alpha=0.02)]


def harness(device="cpu", policy=None, supersteps_per_tick=1):
    """tests/test_serve_slo.py's `_world` (its defaults) on the port."""
    import repro_torch.core as tc
    import repro_torch.graph as tg
    import repro_torch.obs as to
    import repro_torch.serve as tsv
    csr = tg.rmat_graph(192, 5, seed=9)
    sess = tc.GraphSession(csr, 32, capacity=3, seed=3, device=device)
    slo = to.SLOTracker(targets=[to.SLOTarget(
        family="*", p99_latency_steps=500, deadline_steps=600)], window=128)
    sched = tsv.ConcurrentServeScheduler(-(-csr.n // 32), batch_budget=3,
                                         seed=5, slo=slo)
    cfg = to.LoadgenConfig(seed=11, ticks=90, base_rate=0.25, n_tenants=30,
                           update_every=30)
    return to.OpenLoopHarness(sess, sched, cfg, max_running=3,
                              policy=policy,
                              supersteps_per_tick=supersteps_per_tick)


def harness_logs(h) -> dict:
    s = h.run()
    return dict(admission=list(h.admission_log),
                completion=list(h.completion_log), summary=s,
                active=sum(g.num_active for g in h.sess.view_groups()),
                capacities=[g.capacity for g in h.sess.view_groups()])


# ---------------------------------------------------------------------------
# what a rank holds
# ---------------------------------------------------------------------------


PAIR_FIELDS = ("src", "dst", "slot", "first", "last", "src_nnz",
               "dst_touched", "tiles", "run_start", "chunk_start",
               "chunk_run")


def held(sess) -> dict:
    """This rank's slices of every view: block range, ELL rows, pair
    shard, overlay (numpy)."""
    spec = sess._mesh2d
    out = {}
    for g in sess.view_groups():
        lay = spec.layout(g)
        ps = sess._pair_shards(g)
        ov = g.overlay
        out[g.key] = dict(
            block_range=spec.block_range(g.graph.num_blocks, lay),
            shard=(ps.num_shards, ps.shard, ps.shard_pairs),
            ell={f: getattr(g.graph, f).numpy().copy()
                 for f in ("tiles", "nbr_ids", "nbr_mask")},
            pairs={f: getattr(ps.local, f).numpy().copy()
                   for f in PAIR_FIELDS},
            overlay=dict(capacity=ov.capacity, **{
                f: getattr(ov, f).numpy().copy()
                for f in ("src_u", "dst", "w", "mask")}))
    return out


def whole_state(sess) -> dict:
    """Every view's gathered (values, deltas) (a collective)."""
    return {g.key: tuple(x.numpy().copy() for x in sess._full_state(g)[:2])
            for g in sess.view_groups()}


def _metrics(m) -> dict:
    return dict(converged=m.converged, supersteps=m.supersteps,
                tile_loads=m.tile_loads, collectives=m.collectives)


def _layout_warnings(fn):
    from repro_torch.dist.mesh2d import MeshLayoutWarning
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(x.message) for x in w
                 if issubclass(x.category, MeshLayoutWarning)]


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------


def world4(rank: int, state: dict) -> dict:
    """Every 4-rank scenario: one batch of each case on (1 x 4) and
    (2 x 2) from the same loaded state; STREAM_SCRIPT on (2 x 2) under
    both drivers, then `unshard_session`; the step cache across edits,
    overlay growth and compaction on (1 x 4); a new view and growth on
    (2 x 2)."""
    import repro_torch.algorithms as ta
    import repro_torch.core as tc
    from repro_torch.dist import mesh2d as m2
    from repro_torch.dist.graph import shard_session, unshard_session

    out = {"imports_clean": _imports_clean()}
    meshes = {"1x4": m2.make_mesh2d(1, 4, device_type="cpu"),
              "2x2": m2.make_mesh2d(2, 2, device_type="cpu")}

    # -- one batch of each case from the same loaded state -----------------
    for shape, mesh in meshes.items():
        for case in CASES:
            sess, _ = core_session()
            load_state(sess, state)
            shard_session(mesh, sess)
            m2.reset_collectives()
            st = sess.apply_updates(case_batch(sess._csr, case))
            n_coll = m2.COLLECTIVES["count"]
            out[f"{shape}/{case}"] = dict(
                stats=dataclasses.asdict(st), stats_all=_all_ranks(
                    dataclasses.asdict(st)),
                collectives=_all_ranks(n_coll), held=_all_ranks(held(sess)),
                state=whole_state(sess))
            if case == "overlay":
                # the host driver pushes the live overlay: the state it
                # leaves must stay what the CUDA kernels take (contiguous;
                # two jobs a rank on (1 x 4))
                sess.run(tc.TwoLevel(), 3)
                out[f"{shape}/{case}"]["dense"] = _all_ranks(all(
                    t.is_contiguous() for g in sess.view_groups()
                    for t in (g.values, g.deltas)))

    # -- STREAM_SCRIPT on (2 x 2), then unshard ----------------------------
    for tag, policy in (("host", tc.TwoLevel()), ("device", tc.Fused())):
        import repro_torch.graph as tg
        csr = tg.rmat_graph(96, 3, seed=3)
        sess = tc.GraphSession(csr, BLOCK, capacity=2, seed=11,
                               overlay_capacity=2, device="cpu")
        hs = [sess.submit(a) for a in stream_algs()]
        sess.run(policy, 6, mesh=meshes["2x2"])
        stats, live, dense = [], [], []
        for b in stream_batches(csr):
            stats.append(dataclasses.asdict(sess.apply_updates(b)))
            live.append([int(g.overlay.mask.sum())
                         for g in sess.view_groups()])
            sess.run(policy, 4)
            # what the CUDA kernels take: contiguous state after a run
            # that pushed the live overlay
            dense.append(all(t.is_contiguous() for g in sess.view_groups()
                             for t in (g.values, g.deltas)))
        sess.compact()
        m = sess.run(policy, 50000)
        run = dict(metrics=_metrics(m), stats=stats, live=live, dense=dense,
                   results=[sess.result(h) for h in hs],
                   held=_all_ranks(held(sess)))
        m2.reset_collectives()
        unshard_session(sess)
        run["unshard_collectives"] = m2.COLLECTIVES["count"]
        run["unsharded"] = {g.key: {f: getattr(g.graph, f).numpy().copy()
                                    for f in ("tiles", "nbr_ids",
                                              "nbr_mask")}
                            for g in sess.view_groups()}
        run["csr"] = (sess._csr.indptr, sess._csr.indices,
                      sess._csr.weights)
        out["stream/" + tag] = run

    # -- the device step cache across edits, overlay growth, compaction ---
    sess, hs = core_session()
    sess.run(tc.Fused(), 20000, mesh=meshes["1x4"])
    sizes = [len(sess._jit_cache)]
    for batch in (reweight_batch(sess._csr),
                  case_batch(sess._csr, "overlay"),
                  case_batch(sess._csr, "overflow")):
        sess.apply_updates(batch)
        m = sess.run(tc.Fused(), 20000)
        sizes.append(len(sess._jit_cache))
    out["cache/1x4"] = dict(sizes=sizes, converged=m.converged,
                            results=[sess.result(h) for h in hs])

    # -- a new view and growth on (2 x 2) -----------------------------------
    sess, hs = core_session()
    sess.run(tc.TwoLevel(), 20000, mesh=meshes["2x2"])
    hs.append(sess.submit(ta.BFS(source=0)))            # a new view
    new_view = held(sess)[hs[-1].view]
    hs += [sess.submit(ta.SSSP(source=s)) for s in (30, 60, 90)]  # 2 -> 8
    m = sess.run(tc.TwoLevel(), 20000)
    out["grow/2x2"] = dict(
        metrics=_metrics(m), results=[sess.result(h) for h in hs],
        new_view=_all_ranks(new_view),
        capacities=[g.capacity for g in sess.view_groups()],
        local_jobs=[int(g.values.shape[0]) for g in sess.view_groups()])
    return out


def world2(rank: int) -> dict:
    """Every 2-rank scenario: updates and runs on a (2,) job mesh against
    one device, growth from a capacity that does not divide the mesh,
    and the serve harness on (1 x 2) and on (2,)."""
    import repro_torch.algorithms as ta
    import repro_torch.core as tc
    from repro_torch.dist.graph import make_job_mesh, shard_session
    from repro_torch.dist.mesh2d import make_mesh2d, reset_layout_warnings
    from repro_torch.stream import UpdateBatch

    out = {"imports_clean": _imports_clean()}
    jobs = make_job_mesh(device_type="cpu")

    def stream_run(mesh):
        """Runs after a batch of each case and two generated batches."""
        import repro_torch.graph as tg
        sess, hs = core_session()
        steps = []

        def run(policy):
            m = sess.run(policy, 20000, mesh=mesh)
            steps.append(dict(metrics=_metrics(m),
                              results=[sess.result(h) for h in hs]))
        run(tc.TwoLevel())
        batches = tg.mutation_stream(sess._csr, 2, inserts_per_batch=6,
                                     deletes_per_batch=3, seed=4,
                                     weighted=True)
        for i, b in enumerate(batches):
            sess.apply_updates(b)
            run(tc.Fused() if i % 2 else tc.TwoLevel())
        # one overlay insert (block 3), then an overflowing row (block 7)
        sess.apply_updates(UpdateBatch.inserts(*new_pairs(sess._csr, 3, 1)))
        run(tc.Fused())
        sess.apply_updates(case_batch(sess._csr, "overflow"))
        run(tc.TwoLevel())
        return steps

    out["jobs/stream"] = stream_run(jobs)

    def grow_run(mesh):
        import repro_torch.graph as tg
        sess = tc.GraphSession(tg.rmat_graph(128, 4, seed=7), BLOCK,
                               capacity=1, seed=0, device="cpu")
        hs = [sess.submit(ta.PageRank())]
        runs = [sess.run(tc.TwoLevel(), 20000, mesh=mesh)]
        hs += [sess.submit(ta.PageRank(damping=0.7))]               # 1 -> 2
        hs += [sess.submit(ta.PersonalizedPageRank(source=s))
               for s in (2, 15)]                                   # 2 -> 4
        runs.append(sess.run(tc.Fused(), 20000))
        return dict(metrics=[_metrics(m) for m in runs],
                    results=[sess.result(h) for h in hs],
                    capacity=sess.view_groups()[0].capacity,
                    local_jobs=int(sess.view_groups()[0].values.shape[0]))

    reset_layout_warnings()
    out["jobs/grow"], out["jobs/grow_warnings"] = _layout_warnings(
        lambda: grow_run(jobs))

    # the one-device runs the job mesh is held to, split over the ranks
    mine = {}
    if rank == 0:
        mine["stream"] = stream_run(None)
    else:
        mine["grow"] = grow_run(None)
    out["one_device"] = {k: v for d in _all_ranks(mine) for k, v in d.items()}

    # the serve front on (1 x 2) under TwoLevel(), on (2,) on the device
    # backend; the session placed before its first view exists
    for tag, mesh, policy, k in (
            ("1x2/two_level", make_mesh2d(1, 2, device_type="cpu"),
             tc.TwoLevel(), 1),
            ("jobs/device", jobs,
             tc.TwoLevel(backend="device", steps_per_sync=8), 8)):
        h = harness(policy=policy, supersteps_per_tick=k)
        shard_session(mesh, h.sess)
        out["serve/" + tag] = harness_logs(h)
    return out


def shard_kernel_check(sess, seed: int) -> dict:
    """B1/B2 on this rank's pair shard of every view against the plain
    version on numpy-seeded state (d at [J, B_N, Vb], base/values at
    [J, B_loc, Vb]); raises unless min-plus is bit-equal and plus-times
    within rtol = atol = 1e-5 (node_un exact) on the rows the shard
    touches.  Returns the pairs checked per view."""
    import torch
    from repro_torch.kernels.fused_superstep.kernel import (
        fused_superstep_call)
    from repro_torch.kernels.fused_superstep.ref import fused_superstep_ref
    rng = np.random.default_rng(seed)
    checked = {}
    for g in sess.view_groups():
        sr, ps = g.semiring, sess._pair_shards(g)
        lp = ps.local
        j, b_loc, vb = g.values.shape

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=sess.device)
        if sr == "plus_times":
            d, base, vals = (t(rng.random((j, ps.num_blocks, vb))),
                             t(rng.random((j, b_loc, vb))), None)
        else:
            d = rng.random((j, ps.num_blocks, vb)) * 10
            d[rng.random(d.shape) < 0.5] = np.inf
            v = rng.random((j, b_loc, vb)) * 10
            d, base, vals = (t(d), t(np.where(rng.random(v.shape) < 0.5, v,
                                              np.inf)), t(v))
        got = fused_superstep_call(
            lp.src, lp.dst, lp.first, lp.last, d, base, lp.tiles,
            values=vals, run_start=lp.run_start, chunk_start=lp.chunk_start,
            chunk_run=lp.chunk_run, arrivals=lp.arrivals(), semiring=sr)
        want = fused_superstep_ref(lp.src, lp.dst, lp.first, lp.last, d,
                                   base, lp.tiles, values=vals, semiring=sr)
        rows = lp.dst_touched.cpu().numpy()
        got = [x.cpu().numpy()[:, rows] for x in got]
        want = [x.cpu().numpy()[:, rows] for x in want]
        if sr == "plus_times":
            np.testing.assert_allclose(got[0], want[0], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_array_equal(got[1], want[1])
        else:
            for a, b in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(a, b)
        checked[g.key] = lp.num_pairs
    return checked


def compact_and_resubmit(sess, hs) -> None:
    """compact(), then every job detached and submitted again (the same
    slots, fresh state), so the next run pushes through the compacted
    pair shards from the start."""
    sess.compact()
    algs = [h.alg for h in hs]
    for h in hs:
        sess.detach(h)
    hs[:] = [sess.submit(a) for a in algs]


def cuda_world(rank: int) -> dict:
    """A (1 x 2) blocks mesh of two ranks sharing the card: a structural
    batch (tile edits, degree rescales, overlay inserts), B1/B2 on every
    rank's edited pair shard against the plain version, a Fused() rerun;
    then compact() and the jobs resubmitted, the same on the compacted
    shards, a TwoLevel() run from the start.  The B1/B2 launches of the reruns are counted per rank."""
    import repro_torch.core as tc
    from repro_torch.dist.mesh2d import make_mesh2d
    from repro_torch.kernels.fused_superstep import kernel as fk

    sess, hs = core_session(device=None)
    sess.run(tc.Fused(), 20000, mesh=make_mesh2d(1, 2))
    out = {}
    for tag, step, policy in (
            ("batch", lambda: sess.apply_updates(
                case_batch(sess._csr, "mutation")), tc.Fused()),
            ("compacted", lambda: compact_and_resubmit(sess, hs),
             tc.TwoLevel())):
        step()
        checked = shard_kernel_check(sess, 31 + rank)
        fk.reset_launches()
        m = sess.run(policy, 20000)
        out[tag] = dict(converged=m.converged, checked=_all_ranks(checked),
                        launches=_all_ranks(dict(fk.launches)),
                        results=[sess.result(h) for h in hs])
    return out
