"""Rank-side scenarios of tests/test_torch_dist.py (no tests here).

Each world function runs in every rank of a `repro_torch.dist.world.
run_world` world (spawned processes, gloo on the CPU) and returns, from
rank 0, plain numpy/python results for the test process to hold against
`repro`.  This module imports torch and `repro_torch` only: the ranks
check that neither JAX nor `repro` was imported into them.
"""

from __future__ import annotations

import contextlib
import sys
import warnings

import numpy as np
import torch
import torch.distributed as dist

BLOCK = 16


def _imports_clean() -> bool:
    return not any(m == "jax" or m.startswith("jax.") or m == "repro"
                   or m.startswith("repro.") for m in sys.modules)


def _all_ranks(x):
    """`x` from every rank, in rank order (on every rank)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, x)
    return out


def build_core(device="cpu", **kw):
    """The reference's tests/test_dist_mesh2d.py CORE/GRID session."""
    import repro_torch.algorithms as ta
    import repro_torch.core as tc
    import repro_torch.graph as tg
    csr = tg.rmat_graph(128, 4, seed=7)
    sess = tc.GraphSession(csr, BLOCK, capacity=2, seed=0, device=device,
                           **kw)
    hs = [sess.submit(ta.PageRank()), sess.submit(ta.PageRank(damping=0.7)),
          sess.submit(ta.SSSP(source=3)), sess.submit(ta.SSSP(source=17))]
    return sess, hs


def build_fault():
    """The reference's FAULT_SCRIPT session."""
    import repro_torch.algorithms as ta
    import repro_torch.core as tc
    import repro_torch.graph as tg
    csr = tg.rmat_graph(128, 4, seed=13)
    sess = tc.GraphSession(csr, BLOCK, capacity=2, seed=2, device="cpu")
    hs = [sess.submit(ta.SSSP(source=3)), sess.submit(ta.SSSP(source=40)),
          sess.submit(ta.PageRank())]
    return sess, hs


def build_odd():
    """B_N = 6: does not divide 4 block shards."""
    import repro_torch.algorithms as ta
    import repro_torch.core as tc
    import repro_torch.graph as tg
    csr = tg.rmat_graph(96, 3, seed=5)
    sess = tc.GraphSession(csr, BLOCK, capacity=2, seed=0, device="cpu")
    return sess, sess.submit(ta.SSSP(source=1))


def build_stream():
    """The reference's STREAM_SCRIPT session after two update batches
    (live overlay entries, pending dirty-block boosts), before placement
    (tests/test_torch_dist_stream.py applies updates on a placed one)."""
    import repro_torch.algorithms as ta
    import repro_torch.core as tc
    import repro_torch.graph as tg
    csr = tg.rmat_graph(96, 3, seed=3)
    sess = tc.GraphSession(csr, BLOCK, capacity=2, seed=11, device="cpu",
                           overlay_capacity=2)
    hs = [sess.submit(a) for a in (ta.PageRank(), ta.SSSP(source=5),
                                   ta.Katz(alpha=0.02))]
    sess.run(tc.TwoLevel(), 6)
    for b in tg.mutation_stream(csr, 2, inserts_per_batch=4,
                                deletes_per_batch=2, seed=9, weighted=False,
                                w_max=4.0):
        sess.apply_updates(b)
    return sess, hs


def job_algs(n=8):
    """The reference's tests/test_dist_graph.py job mix."""
    import repro_torch.algorithms as ta
    algs = [ta.PageRank(), ta.PageRank(damping=0.7)] + [
        ta.PersonalizedPageRank(source=13 * i + 2) for i in range(6)]
    return algs[:n]


def dry_core(mesh, device):
    """`build_core`'s graph and jobs the way the graph dry run builds a
    session: placed on `mesh` while empty, then its jobs submitted."""
    import repro_torch.algorithms as ta
    import repro_torch.core as tc
    import repro_torch.graph as tg
    from repro_torch.dist.mesh2d import shard_session_2d
    sess = tc.GraphSession(tg.rmat_graph(128, 4, seed=7), BLOCK, capacity=2,
                           seed=0, device=device)
    shard_session_2d(mesh, sess)
    for a in (ta.PageRank(), ta.PageRank(damping=0.7), ta.SSSP(source=3),
              ta.SSSP(source=17)):
        sess.submit(a)
    return sess


def _metrics(m) -> dict:
    d = m.to_dict()
    d["collectives"] = m.collectives
    d["iterations_per_job"] = np.asarray(m.iterations_per_job)
    return d


def _layout_warnings(fn):
    """fn() under a warnings recorder: (its value, MeshLayoutWarning
    messages)."""
    from repro_torch.dist.mesh2d import MeshLayoutWarning
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(x.message) for x in w
                 if issubclass(x.category, MeshLayoutWarning)]


GRID = [
    ("host/two_level", "TwoLevel", {}),
    ("host/independent", "Independent", {}),
    ("host/all_blocks", "AllBlocks", {}),
    ("device/two_level", "TwoLevel", dict(backend="device",
                                          steps_per_sync=2)),
    ("device/independent", "Independent", dict(backend="device",
                                               steps_per_sync=1)),
    ("device/all_blocks", "AllBlocks", dict(backend="device",
                                            steps_per_sync=2)),
    ("device/fused", "Fused", {}),
]


def world4(rank: int) -> dict:
    """Every 4-rank scenario: the (1 x 4) blocks mesh, the (2 x 2) policy
    grid, compression, layout fallbacks, the step cache, a mid-run
    checkpoint on (2 x 2), one recorded superstep of a session built the
    graph dry run's way on both placements, and the (1 x 4) runs again
    inside `comm.record()`."""
    import repro_torch.core as tc
    from repro_torch.dist import comm
    from repro_torch.dist import mesh2d as m2
    from repro_torch.dist.fault import checkpoint_session
    from repro_torch.dist.graph import shard_session, unshard_session
    from repro_torch.dist.mesh2d import make_mesh2d, reset_layout_warnings
    from repro_torch.launch.graph_dryrun import recorded_step
    from repro_torch.obs.telemetry import TelemetryConfig

    out = {"imports_clean": _imports_clean()}
    mesh14 = make_mesh2d(1, 4, device_type="cpu")
    mesh22 = make_mesh2d(2, 2, device_type="cpu")

    # -- (1 x 4): Fused and TwoLevel, memory per shard, halo -------------
    for name, pol in (("fused", tc.Fused()), ("two_level", tc.TwoLevel())):
        sess, hs = build_core(telemetry=TelemetryConfig(trace=False))
        m = sess.run(pol, 20000, mesh=mesh14)
        shards = [sess._pair_shards(g) for g in sess.view_groups()]
        tel = m.telemetry
        out["1x4/" + name] = dict(
            metrics=_metrics(m), results=[sess.result(h) for h in hs],
            shard_bytes=_all_ranks([ps.tile_bytes for ps in shards]),
            view_bytes=[sum(ps.shard_pairs) * BLOCK * BLOCK * 4
                        for ps in shards],
            shard_pairs=[ps.shard_pairs for ps in shards],
            capacities=[g.capacity for g in sess.view_groups()], q=sess.q,
            num_blocks=sess.scheduler.num_blocks,
            series=dict(halo=tel.halo_bytes, occ=tel.gq_occupancy,
                        active=tel.active_jobs,
                        loads=tel.tile_loads))

    # -- (2 x 2): the policy grid, both drivers ---------------------------
    for name, pol_name, kw in GRID:
        sess, hs = build_core()
        m = sess.run(getattr(tc, pol_name)(**kw), 20000, mesh=mesh22)
        out["2x2/" + name] = dict(metrics=_metrics(m),
                                  results=[sess.result(h) for h in hs])
    for shape, mesh in (("1x4", mesh14), ("2x2", mesh22)):
        sess, hs = build_core()
        shard_session(mesh, sess, axes=("jobs", "blocks"),
                      compress_halo=True)
        m = sess.run(tc.Fused(), 20000)
        out[shape + "/compressed"] = dict(
            metrics=_metrics(m), results=[sess.result(h) for h in hs])

    # -- a view with live overlay entries and a pending boost, (2 x 2) ---
    for name, pol in (("two_level", tc.TwoLevel()), ("fused", tc.Fused())):
        one, h1 = build_stream()
        one.run(pol, 20000)
        sess, hs = build_stream()
        live = [int(g.overlay.mask.sum()) for g in sess.view_groups()]
        m = sess.run(pol, 20000, mesh=mesh22)
        out["overlay/" + name] = dict(
            metrics=_metrics(m), live=live,
            results=[sess.result(h) for h in hs],
            one_device=[one.result(h) for h in h1],
            semirings=[h.alg.semiring for h in hs])

    # -- layout fallbacks: one warning each, the same results -------------
    reset_layout_warnings()
    runs = {}
    for tag, mesh in (("blocks", mesh14), ("blocks_again", mesh14),
                      ("jobs", make_mesh2d(4, 1, device_type="cpu"))):
        sess, h = build_odd()
        m, msgs = _layout_warnings(
            lambda: sess.run(tc.TwoLevel(), 20000, mesh=mesh))
        runs[tag] = dict(converged=m.converged, result=sess.result(h),
                         warnings=msgs)
    out["fallback"] = runs

    # -- the step cache: one entry per (policy, placement) ----------------
    sess, hs = build_core()
    pol = tc.Fused()
    sizes = []
    sess.run(pol, 20000)
    sizes.append(len(sess._jit_cache))
    sess.run(pol, 20000, mesh=mesh14)
    sizes.append(len(sess._jit_cache))
    unshard_session(sess)
    sess.run(pol, 20000)
    sizes.append(len(sess._jit_cache))
    shard_session(mesh14, sess, axes=("jobs", "blocks"))
    sess.run(pol, 20000)
    sizes.append(len(sess._jit_cache))
    out["cache"] = dict(sizes=sizes, keys=len(
        [k for k in sess._jit_cache if k[0] == "superstep"]),
        results=[sess.result(h) for h in hs])

    # -- a checkpoint on (2 x 2), five supersteps in -----------------------
    sess, hs = build_fault()
    m = sess.run(tc.TwoLevel(), 5, mesh=mesh22)
    out["fault"] = dict(metrics=_metrics(m),
                        snapshot=checkpoint_session(sess))

    # -- the graph dry run's session, one recorded superstep ---------------
    for shape, mesh in (("1x4", mesh14), ("2x2", mesh22)):
        rec = recorded_step(dry_core(mesh, "cpu"))
        out["dryrun/" + shape] = _all_ranks(dict(
            calls=[tuple(c) for c in rec["calls"]],
            resident_bytes=rec["resident_bytes"], flops=rec["flops"]))

    # -- the (1 x 4) runs without and inside comm.record() -----------------
    for name, pol in (("fused", tc.Fused()), ("two_level", tc.TwoLevel())):
        for tag in ("plain", "recorded"):
            sess, hs = build_core()
            comm.reset_stats()
            m2.reset_collectives()
            with (comm.record() if tag == "recorded"
                  else contextlib.nullcontext([])) as calls:
                m = sess.run(pol, 20000, mesh=mesh14)
            out[f"{tag}/{name}"] = dict(
                metrics=_metrics(m), collectives=m2.COLLECTIVES["count"],
                comm_stats=(comm.STATS["calls"], comm.STATS["bytes"]),
                calls=list(calls), results=[sess.result(h) for h in hs])
    return out


def world2(rank: int, snapshots: dict) -> dict:
    """Every 2-rank scenario: the job mesh, and restores onto (1 x 2)."""
    import repro_torch.core as tc
    import repro_torch.graph as tg
    from repro_torch.dist.fault import restore_session
    from repro_torch.dist.graph import make_job_mesh, shard_run
    from repro_torch.dist.mesh2d import make_mesh2d, reset_layout_warnings

    out = {"imports_clean": _imports_clean()}
    csr = tg.rmat_graph(256, 5, seed=11)
    mesh = make_job_mesh(device_type="cpu")
    for name, call in (("two_level", "run_two_level"),
                       ("fused", "run_fused")):
        eng = tc.ConcurrentEngine(tc.make_run(job_algs(), csr, BLOCK,
                                              device="cpu"), seed=0)
        m = getattr(eng, call)(20000, mesh=mesh)
        out["jobs/" + name] = dict(metrics=_metrics(m),
                                   results=eng.results(),
                                   local_jobs=int(eng.run.values.shape[0]))
    reset_layout_warnings()
    eng = tc.ConcurrentEngine(tc.make_run(job_algs(5), csr, BLOCK,
                                          device="cpu"), seed=0)
    m, msgs = _layout_warnings(lambda: eng.run_two_level(20000, mesh=mesh))
    out["jobs/remainder"] = dict(metrics=_metrics(m), results=eng.results(),
                                 warnings=msgs,
                                 local_jobs=int(eng.run.values.shape[0]))
    run = tc.make_run(job_algs(), csr, BLOCK, device="cpu")
    out["shard_run"] = tuple(shard_run(run, mesh).values.shape)

    # the one-device runs the job mesh is held to, split over the ranks
    mine = {}
    for n, call in ((((8, "run_two_level"), (5, "run_two_level")),
                     ((8, "run_fused"),))[rank]):
        eng = tc.ConcurrentEngine(tc.make_run(job_algs(n), csr, BLOCK,
                                              device="cpu"), seed=0)
        mine[(n, call)] = dict(metrics=_metrics(getattr(eng, call)(20000)),
                               results=eng.results())
    out["one_device"] = {k: v for d in _all_ranks(mine) for k, v in d.items()}

    mesh12 = make_mesh2d(1, 2, device_type="cpu")
    for tag, snap in snapshots.items():
        sess, hs = build_fault()
        restore_session(sess, snap, mesh=mesh12)
        m = sess.run(tc.TwoLevel(), 20000)
        out["restore/" + tag] = dict(metrics=_metrics(m),
                                     results=[sess.result(h) for h in hs])
    return out


def fail_on_rank_one(rank: int) -> None:
    """A world in which one rank raises."""
    if rank == 1:
        raise RuntimeError("rank 1 failed")


def cuda_world(rank: int) -> dict:
    """A (1 x 2) blocks mesh of two ranks sharing the card: Fused and the
    host TwoLevel with B1/B2 launches counted per rank, and one device
    chunk whose last slots are gated run with and without the gate
    reaching the kernels (the carries must be equal)."""
    import repro_torch.core as tc
    from repro_torch.dist import mesh2d as m2
    from repro_torch.kernels.fused_superstep import kernel as fk

    mesh = m2.make_mesh2d(1, 2)
    out = {}
    for name, pol in (("fused", tc.Fused()), ("two_level", tc.TwoLevel())):
        sess, hs = build_core(device=None)
        fk.reset_launches()
        m = sess.run(pol, 20000, mesh=mesh)
        launches = dict(fk.launches)
        out[name] = dict(metrics=_metrics(m),
                         results=[sess.result(h) for h in hs],
                         launches=_all_ranks(launches))

    real = m2.fused_superstep_call
    seen = []

    def no_gate(*a, gate=None, **kw):
        seen.append(gate)
        return real(*a, **kw)

    carries = []
    try:
        for strip in (False, True):
            sess, _ = build_core(device=None)
            sess.run(tc.Fused(), 1, mesh=mesh)       # place, one step
            policy = tc.TwoLevel(backend="device", steps_per_sync=8)
            step_fn = sess._device_step_fn(policy)
            state, *args = m2.device_inputs_2d(policy, sess)
            if strip:
                m2.fused_superstep_call = no_gate
            state, _ = step_fn(state, *args, 5, 5, 0)    # 3 gated slots
            torch.cuda.synchronize()
            carries.append(state)
    finally:
        m2.fused_superstep_call = real
    a, b = carries
    same = int(a[0]) == int(b[0]) == 5
    for x, y in zip(a, b):
        if x is None:
            continue
        for u, v in zip(x if isinstance(x, tuple) else (x,),
                        y if isinstance(y, tuple) else (y,)):
            same = same and torch.equal(u, v)
    out["gate"] = dict(same=_all_ranks(bool(same)), gates=len(seen),
                       last_closed=not bool(seen[-1]))
    return out
