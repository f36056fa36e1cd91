"""Job-axis placement for concurrent graph runs: multi-device CAJS.

J concurrent jobs share one graph.  On a ("jobs",) `DeviceMesh` of D
ranks:

  * every view's adjacency (ELL tiles, neighbour ids, the pair view) is
    REPLICATED: each rank builds it from the same CSR and stages a
    selected block once for all of its jobs;
  * the stacked job state (values/deltas [J, B_N, Vb], push_scale [J])
    is SHARDED: rank r keeps job rows [r*J/D, (r+1)*J/D).

Every per-job computation of the engine is independent across jobs, so
partitioning the job axis changes which rank runs a job, not one
operation on it: a job-mesh run reaches the one-device run's schedule
and results bit for bit.  The scheduler still decides once for all
jobs: the host driver gathers every job's pairs (one collective per
view a superstep) and runs the same numpy scheduler on every rank; the
device driver sums the queues' rank weights and the unconverged counts
over the mesh (one collective a superstep).  A job mesh is the jobs x
blocks program of `dist.mesh2d` with one block shard.

A group whose job count does not divide the mesh falls back to
replication (identical math) with a one-time `MeshLayoutWarning`.

Every rank builds the same session from the same seed and calls
``sess.run(policy, mesh=mesh)``; `sess.result(h)`, `unshard_session` and
`dist.fault.checkpoint_session` gather, so every rank calls them.  Live
updates, compaction, new views and growth run on a placed session as on
one device (every rank calls them with the same arguments, in the same
order); on a job mesh every rank edits its whole replicated view, and
the schedule and results after updates still equal one device bit for
bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.dist import mesh2d as m2
from repro_torch.kernels.common import resolve_device

JOB_AXIS = "jobs"


def make_job_mesh(n_devices: Optional[int] = None,
                  axis_name: str = JOB_AXIS, *,
                  device_type: Optional[str] = None) -> DeviceMesh:
    """1-D ("jobs",) DeviceMesh over the ranks of the default process
    group (`n_devices`, when given, must be the world size: a session's
    mesh spans every rank).  `device_type` None means CUDA and raises
    without a card (pass "cpu")."""
    device_type = resolve_device(device_type).type
    if not dist.is_initialized():
        raise RuntimeError("make_job_mesh needs an initialized default "
                           "process group (dist.world.run_world)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"asked for {n} ranks, the world has {world}")
    return DeviceMesh(device_type, torch.arange(n),
                      mesh_dim_names=(axis_name,))


def shard_job_state(mesh: DeviceMesh, values, deltas, push_scale, graph,
                    axis_name: Optional[str] = None, view_key=None):
    """This rank's slice of stacked job state on a job mesh: rows
    [r*J/D, (r+1)*J/D) of values/deltas/push_scale, the shared graph
    replicated (every rank holds it already).  Jobs that do not divide
    the axis stay whole (replicated) with a one-time warning."""
    del graph
    m2.check_mesh(mesh)
    axis = axis_name or mesh.mesh_dim_names[0]
    n = int(mesh.size(mesh.mesh_dim_names.index(axis)))
    j = values.shape[0]
    if j % n:
        if n > 1:
            m2.warn_layout_once(view_key if view_key is not None
                                else ("run",), axis, n, j,
                                "jobs-replicated")
        return values, deltas, push_scale
    jl = j // n
    j0 = int(mesh.get_local_rank(axis)) * jl
    return (values[j0:j0 + jl].contiguous(),
            deltas[j0:j0 + jl].contiguous(),
            push_scale[j0:j0 + jl].contiguous())


def shard_session(mesh: DeviceMesh, session, axis_name: Optional[str] = None,
                  axes=None, *, compress_halo: bool = False, bits: int = 8):
    """Place a (possibly heterogeneous) GraphSession on `mesh`.

    A 1-D mesh shards EVERY view group's job axis independently (each
    keeps its own padded [J_view_cap, ...] state; a group whose capacity
    does not divide the mesh replicates) and replicates every view's
    tiles, overlay and pair view.  `axes=("jobs", "blocks")`, or any
    mesh with two named axes, selects the jobs x blocks placement of
    `dist.mesh2d` (`compress_halo`/`bits` apply only there)."""
    m2.check_mesh(mesh)
    names = tuple(mesh.mesh_dim_names or ())
    if axes is not None or len(names) >= 2:
        ax = tuple(axes) if axes is not None else names[:2]
        return m2.shard_session_2d(mesh, session, axes=ax,
                                   compress_halo=compress_halo, bits=bits)
    axis = axis_name or names[0]
    return m2.place_session(session, m2.Mesh2DSpec(mesh, axis, None))


def unshard_session(session):
    """Gather a placed session back to one-device placement (a
    collective: every rank calls it)."""
    return m2.unshard_session(session)


def shard_run(run, mesh: DeviceMesh, axis_name: Optional[str] = None):
    """This rank's slice of a ConcurrentRun on a job mesh: job state
    sharded over the job axis, graph replicated.  Returns a new
    ConcurrentRun."""
    values, deltas, push_scale = shard_job_state(
        mesh, run.values, run.deltas, run.push_scale, run.graph, axis_name)
    return dataclasses.replace(run, values=values, deltas=deltas,
                               push_scale=push_scale)
