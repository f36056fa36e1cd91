"""repro_torch.dist: the multi-device graph engine over torch.distributed.

  world        - `run_world`: start one process per rank (spawn, a
                 ``file://`` store) and return rank 0's result
  graph        - job-axis placement: job state sharded over a ("jobs",)
                 DeviceMesh, every view's tiles replicated
  mesh2d       - jobs x blocks placement: block rows of the job state,
                 of the ELL tiles and of the pair view sharded over a
                 ("jobs", "blocks") DeviceMesh, only the frontier
                 exchanged per superstep
  fault        - the training restart loop (`RestartManager`), checkpoint /
                 restore of a session's resumable state onto another mesh
                 (elastic reshard), the straggler watchdog
  compression  - int8 quantization with error feedback (the compressed
                 frontier exchange and data-parallel gradient)
  sharding     - the sharding rules: logical axes to mesh axes, placements
                 of a rank's slices (FSDP), gathers and gradient reductions
  act          - the models' activation-sharding hooks (identity outside a
                 sharding context, the rules' answers inside one) and the
                 batch's sums over the ranks that split it
  pipeline     - `make_pipelined_loss`: the GPipe schedule over a mesh axis
  comm         - the counted collectives of training and serving over
                 ranks (gloo stages a CUDA tensor through the host)
  tp           - tensor-parallel serving: each product's share and
                 collective from where its weight is split ("tp" rules)

The reference (`repro.dist`) is single-controller SPMD: `shard_map` over
a `jax.sharding.Mesh`.  Here every rank is a process holding its own
slice; `psum`/`pmin` become `all_reduce` SUM/MIN on the mesh axis's
process group.  Submodules are imported by their call sites, so
importing `repro_torch.dist` touches no process group.
"""

__all__ = ["graph", "mesh2d", "fault", "compression", "world", "act",
           "sharding", "pipeline", "comm", "tp"]
