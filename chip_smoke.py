#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. Device and settings: the card's name and power limit, TF32 off, and
   the CUDA kernels built from the sources in this checkout; B1/B2's
   ptxas registers and spills at Vb=64 and their thread blocks per SM.
2. Each kernel against its plain PyTorch version on the card, on the
   slice's real block pairs (rmat_graph(2**16, 8), Vb=64) with
   numpy-seeded random state and every source live: J=4 (the main
   path's job axis), a prime J, and a width-contract case (d at B_N,
   outputs at B_loc < B_N).  Bars: plus-times rtol = atol = 1e-5 with
   node_un exact; min-plus values, deltas and node_un bit-equal, p_sum
   rtol 1e-6.  Each kernel and its plain version are timed (`Timer`:
   device time per launch by CUDA events around a run of back-to-back
   launches queued behind a spin, and host time per call by the host
   clock around a run of calls) beside the all-pairs bound.
3. The main path at full size: GraphSession(rmat_graph(2**16, 8), 64,
   capacity=4) on CUDA with PageRank, PPR(3), SSSP(0), SSSP(4097) — two
   graph views — run under TwoLevel() to convergence with the launch
   counts set to 0 just before and read just after, keeping each
   push's selection mask.  SSSP is held bit-equal to scipy's Dijkstra,
   PageRank/PPR to a float64 power iteration at rtol 5e-3, atol 1e-4.
2b. B1/B2 on the main path's own selections: the masks of an early, a
   middle and a late push of phase 3, d masked by them, against the
   plain version at phase 2's bars, a repeat call bit-identical, timed
   beside the bound of the live pairs alone.
4. The device scheduling backend at full size, on the same session: the
   four jobs resubmitted and run under Fused() (both scheduling levels
   and the push on the card, one host read per chunk), checked as in
   phase 3 with the launch counts set to 0 just before and read just
   after; then resubmitted under TwoLevel(backend="device",
   steps_per_sync=8), which must give the same supersteps, tile_loads and
   tile_pair_loads (chunk invariance); then a cadence sweep, K = 4, 8,
   16 (INF_CHUNK), 32 and back, each run held to the same schedule and
   results (ms per superstep, host_syncs and B1/B2 launches against K;
   the two passes show the drift of the host's speed within the run);
   then one chunk of the step function under
   torch.cuda.set_sync_debug_mode("error").  Then telemetry
   (TelemetryConfig() on the same session, its own step-function entry):
   Fused() and TwoLevel() rerun from the same start as their
   telemetry-off runs must give the same supersteps, tile_loads,
   tile_pair_loads, job_block_pushes and host_syncs and bit-identical
   values and deltas, with series that sum to the totals; ms per
   superstep on and off; two telemetry chunks, the second under
   set_sync_debug_mode("error"), rows written in place; telemetry's
   cost as medians over 20 interleaved off/on pairs of a Fused chunk's
   host enqueue and of an 8-superstep TwoLevel() run, beside the torch
   ops a Fused superstep dispatches.  The scheduler's stream is put back,
   so phases 5-6 run as they would without telemetry.
5. B3 and B4 at their entry points on the full-size views: mj_spmm
   (both semirings, J=4 and a prime J=7, q=400 distinct rows of the
   view's ELL tiles) against its plain version, timed beside
   torch.matmul for plus-times; push_shared on both views (the jobs'
   fresh state, the host TwoLevel's first global queue with padded
   slots) against the port's ELL push; priority_pairs on each view's
   vertex priorities at submit and after 20 host supersteps ([4, 1024,
   64], L2-resident) against core.priority.block_pairs, then at the
   byte-bound size [16, 16384, 64] (64 MB, more than the L2), beside the
   scalar variant on the same inputs and the launch floor (an empty
   kernel timed the same way).  B3's and B4's
   launch counts are read around their entry-point runs (push_shared,
   priority_pairs).
6. Evolving graphs at full size, on the same session: the four jobs
   converge, then take the reference's own update generator,
   mutation_stream(csr, 2, inserts_per_batch=512, deletes_per_batch=256,
   seed=1) (768 updates a batch, about 0.15% of the edges), each batch
   applied with `apply_updates` and the jobs rerun to convergence
   (Fused() after batch 1, TwoLevel() after batch 2); then a
   hand-built batch of inserts on block pairs that own no tile slot (the
   overlay and the kernel route's ride-along, under Fused(), with live
   overlay entries asserted) and a batch with more new pairs in one
   block row than its overlay holds (compaction, under TwoLevel()); then
   an explicit `compact()`.  Each rerun is held to phase 3's bars on the
   updated graph, the session's CSR to a plain application of the
   batches, and after compaction every view's tiles, neighbour ids and
   mask and its rebuilt BlockPairs to a fresh build on the card.  Per
   batch it prints the apply_updates seconds, the StreamStats, the live
   overlay entries, the pair-view rebuild seconds and the rerun's wall,
   supersteps, tile_loads, tile_pair_loads and host_syncs; then the
   phase's peak device memory.  B1/B2 launches over the reruns are the
   `stream` entry of `launches_by_path`.
7. The serve front at full size, with the first session freed: the
   open-loop harness (obs.loadgen: seeded Poisson arrivals with a burst
   envelope, 64 tenants on the default family mix pagerank/ppr/sssp/bfs,
   35 requests over a horizon of 88 ticks, a mutation_stream batch of 8 inserts and 4 deletes every 80 ticks
   forwarded to notify_group_update) admits requests through a
   ConcurrentServeScheduler over 1024 request groups (one per block)
   into GraphSession(rmat_graph(2**16, 8), 64, capacity=8,
   telemetry=True), at most 8 running, 8 supersteps a tick; once under
   TwoLevel() and once under TwoLevel(backend="device",
   steps_per_sync=8), each on a fresh session whose three views are
   built before the first tick.  Every SSSP/BFS result is held bit-equal
   to scipy's Dijkstra/BFS on the CSR it finished on, the first three
   PageRank/PPR results to phase 3's bars; every request admitted and
   completed, at most 8 running and 8 at the peak (the load of 0.4
   requests a tick, as in examples/serve_slo.py, fills the slots: the
   admission headroom reaches 0), the series' tile_loads summing to the
   harness's, the exported trace (build/chip_smoke/serve_trace_*.json) valid
   with serve.admit instants, the MetricsRegistry snapshot valid.  It
   prints arrivals, ticks, supersteps, throughput, p50/p99 latency in
   ticks (overall and by family), wall, ms per tick and per superstep,
   B1/B2 launches (the `serve` entry of `launches_by_path`) and the
   peak device memory.
8. The multi-device engine at full size (repro_torch.dist), after phase
   7's sessions are freed: ranks are processes sharing the card over
   gloo (`dist.world.run_world`), each placing an empty session on its
   mesh and submitting the jobs, so every view is built as the rank's
   own slices straight from the CSR (`build_view_shard`), all ranks at
   once.  Once placed, every rank holds B1/B2 on its own pair shard
   (local destinations, the shard's run and chunk tables) against the
   plain version at the mesh path's shapes, d at [J, B_N, Vb] and
   base/values at [J, B_loc, Vb], at phase 2's bars (`shard_kernels`).
   8a: a (1 x 4) blocks mesh with both views and phase 3's four jobs
   under Fused() with the int8 frontier exchange (its TwoLevel() and
   exact-exchange Fused() runs are cut for the time limit: 9a's reruns
   drive both on the same session); 8b: a (2 x 2) mesh, the min-plus
   view alone with four SSSP jobs, under TwoLevel(backend="device",
   steps_per_sync=8), then half the run, a snapshot
   (`dist.fault.checkpoint_session`), the rest, and the snapshot
   restored here onto one device and finished; 8c: a (2,)
   job mesh with the same jobs under TwoLevel(), held bit for bit
   (results, supersteps, tile_loads, tile_pair_loads) to a one-device
   run here.  Every run is checked as in phase 3 (SSSP bit-equal to
   Dijkstra), halo_bytes under the frontier bound, B1/B2 launched on
   every rank; it prints wall, ms per superstep, host syncs, collectives
   per superstep and their host time, halo bytes per superstep, each
   shard's real pairs against pair_cap, each rank's set-up time and
   device memory, the phase's nvidia-smi peak and a gloo all_reduce's
   time with the ranks lined up.  B1/B2 launches over every rank and
   run are the `mesh` entry of `launches_by_path`.
9. Live updates and the serve front on a placed session, in 8a's world
   after its runs.  9a: phase 6's traffic on the (1 x 4) session (two
   `mutation_stream` batches of 768 updates, Fused after 1, TwoLevel
   after 2; the overlay batch under Fused; the overflow
   batch, both views compacting, under TwoLevel; then `compact()`),
   each rerun held to phase 3's bars on a plain application of the
   batches; every rank holds B1/B2 on its edited pair shard after the
   first batch and on its compacted one after `compact()`, and its
   compacted slices to a fresh `build_view_shard` of the final CSR.  Per
   batch: apply_updates seconds on every rank, the collectives it cost,
   the rerun's wall, supersteps and collectives, each rank's memory;
   compact() seconds and build peak per rank; phase 9's nvidia-smi peak.
   9b: the jobs detached, phase 7's load with its horizon cut to 24
   ticks and its update period to 20 (`MESH_SERVE_LOAD`) served on the
   same session under TwoLevel(), 8 supersteps a tick, at most 8
   running: groups grow past capacity 4 and the BFS view is built as a
   new view on the mesh.  Every request admitted and completed, 8
   running at the peak, every SSSP/BFS result bit-equal to scipy on the
   CSR it finished on, the first PageRank/PPR results within phase 3's
   bars; it prints latency in ticks, ms per tick and per superstep
   inside run(), collectives per superstep and each rank's memory.
   B1/B2 launches over the ranks are the `mesh_stream` and `mesh_serve`
   entries of `launches_by_path`.

10. The LM serving path (repro_torch.models, .serve.ServeEngine,
   .launch.serve), which launches none of the kernels above, after
   everything before it is freed.  10a: every architecture's smoke
   config, one seeded CPU init copied to the card, forward_train,
   prefill and four decode steps: float32 (TF32 off) at rtol = atol =
   1e-4 with the final cache; bf16 each block fed the CPU's own input
   and cache at 2e-2, the whole model at 2e-2 or within the CPU run's
   own one-ulp spread.  10b: qwen2.5-14b at its published widths and all
   48 layers in bf16 (14.77 G parameters drawn on the card), served
   through launch.serve's build_engine / make_scheduler / serve: 16
   requests from 4 streams over 8 groups, batch budget 8, prompts of
   2048 tokens, 32 greedy decode steps; the first batch's first two
   sequences held to the port's own forward_train (prefill at 2e-2,
   decode steps within LM_DECODE_BAR of the logits' std) and the first
   to the plain float32 forward (models/ref.py, within LM_PLAIN_BAR);
   prefill ms and decode ms a step beside their bounds, tokens a
   second, torch ops a decode step, peak memory.  10c: the same widths
   in float32 at 2 layers, prefill of 600 tokens and 8 decode steps
   through the ServeEngine against the plain forward at 1e-4.

11. LM training (repro_torch.models' LM.loss, .train, .data,
   .dist.fault.RestartManager, .launch.train), which launches none of
   the kernels above either.  11a: every architecture's smoke config,
   one seeded CPU init copied to the card, LM.loss, every gradient and
   one make_train_step step with accum_steps=2: float32 (TF32 off) loss
   at 1e-5, each gradient leaf and the step's mu at 1e-4 of its largest
   entry plus 1e-7 of the model's largest, stepped parameters at 1e-5
   plus lr x the difference of the two sides' AdamW directions (read
   from their moments); bf16 loss at 2e-2.  11b: minicpm-2b at its published widths, 40
   layers, bf16, seeded weights drawn on the card, launch.train's AdamW
   (WSD), SyntheticTokens(seed=0) batches of 8 x 2048, 6 steps through
   make_train_step: each step's loss, grad norm, lr, s and tokens/s
   beside the 0.29 s bound, peak memory split into state and the rest,
   the step's parts timed one by one; the loss must fall and every grad
   norm be finite (a first step past 75 GB halves the batch, said so).
   11c, in a child process (`--phases 11c`) that sets
   CUBLAS_WORKSPACE_CONFIG before CUDA starts: launch.train's
   RestartManager loop at the same widths cut to 2 layers, a checkpoint
   every 2 steps under build/chip_smoke/ckpt (removed after), a failure
   injected at step 3, under deterministic algorithms: one restart, the replayed losses bit-equal to their
   first pass, the final state equal to an uninterrupted run's; the
   checkpoint's GB and its save and restore s.

12. LM training over several ranks (repro_torch.dist.sharding's
   placements, .dist.comm, .dist.pipeline, FSDP in .train), which
   launches none of the kernels above either; ranks share the card over
   gloo through `run_world`, as in phase 8.  12-0: which gloo
   collectives take CPU and CUDA tensors in float32 and bf16, printed
   only (a collective that kills a rank is recorded, the rest run in a
   new world).  12a, in a (2, 1) world: minicpm-2b's and mixtral-8x7b's
   float32 smoke configs (TF32 off, the MoE in two groups) on the card
   against the same world on CPU tensors at 11a's bars (loss, the
   gathered gradients, one make_train_step step with accum_steps=2), and
   a 2-stage pipeline of the smoke blocks against their sequential loss
   and gradients at the reference's bars (1e-5; rtol 1e-4, atol 1e-5).
   12b, the same world: minicpm-2b at its published widths, 40 layers,
   bf16, FSDP-DP through launch.train's `setup` and step (11b's AdamW,
   its total_steps included), SyntheticTokens(seed=0) batches of 8 x
   2048 (4 x 2048 a rank), 1 step, its loss within 2e-2 of phase 11b's
   same step (or of a one-device run of its first step here when
   phase 12 runs alone) and its grad norm within 2e-2 relative; per step
   s, tokens/s, the collectives' calls, bytes and host s (the host
   copies apart) and their share of the step; each rank's peak.  The
   restart loop's full-width checkpoints (2 x 32.7 GB) stay out of 12b;
   12d runs the loop.  12c: a ("pod",) world of 4 ranks, the 40 blocks
   cut to 8, in 4 stages of 2 (each block under a checkpoint, the
   model's remat), the batch in 4 microbatches, the loss the final norm
   and the chunked cross-entropy with the tied head, held within 2e-2 of
   the same blocks run in sequence on rank 0; s a step, bytes a tick,
   each rank's peak.
   12d, in a child process with cuBLAS's deterministic workspace (`--phases
   12d`): launch.train's loop at the same widths cut to 2 layers in a
   (2, 1) world, a checkpoint every 2 steps, a failure injected at step 3
   on every rank: one restart, the replayed losses bit-equal; the world's
   last checkpoint restored on one device and a checkpoint of the
   gathered state restored onto the world, each bit for bit.

13. Tensor-parallel LM serving under the "tp" rules (repro_torch.dist.tp,
   the placed LM), which launches none of the kernels above either; two
   ranks share the card over gloo in a (1, 2) ("data", "model") world
   through `run_world`, each drawing its slices of `LM(cfg, seed=0)`
   (`param_shardings(rules, ..., serve=True)`) and serving inside
   `activation_sharding(rules, serve=True)`, held against one process
   on the card with the same weights, run first in this process and
   freed before the world starts.  13a: every architecture's smoke
   config, prefill of 20 tokens and 4 decode steps, float32 (TF32 off)
   at rtol = atol = 1e-4, bf16 at 2e-2 (or within the one process's own
   one-ulp spread).  13b: qwen2.5-14b at its published widths, 48
   layers, bf16: 4 prompts of 512 tokens, then 8 decode steps fed the
   one process's greedy picks, each step's logits within 0.25 of the
   one-process logits' std; prefill s and decode ms a step beside the
   one-process times and the bound of `launch.analytic`, the
   collectives' calls, bytes and host s (copies apart) a prefill and a
   decode step, each rank's resident weights against half the model's,
   the weights gathered a decode step (under 1% of a rank's), each
   rank's peak.  13c: the same widths and traffic in float32 at 2
   layers, at 1e-4.

14. LM training under the "tp" rules (repro_torch.launch.specs'
   train cell, the train layout of .dist.tp, LM.loss within
   .dist.act.seq_split, the gradient sums over "model"), which launches
   none of the kernels above either; two ranks share the card over gloo
   in a (1, 2) ("data", "model") world through `run_world` (their
   allocator on expandable segments), each holding whole weights, the
   whole batch and its half of every sequence, held against one process
   on the card with the same weights and batches, run first in this
   process and freed before the world starts.  14a: mixtral-8x7b's
   (capacity factor 1) and qwen2.5-14b's float32 smoke configs (TF32
   off): the loss, every gradient (within 1e-4 of each leaf's largest
   entry), one make_train_step step at accum 2 (loss and grad norm at
   1e-4, every first moment as the gradients).  14b: mixtral-8x7b at its
   published widths cut to 1 layer (1,713,418,240 parameters), bf16,
   through `specs.build_cell("mixtral-8x7b", "train_4k", mesh,
   model=...)` (the "tp" policy), SyntheticTokens(seed=0) batches of 4 x
   4096, 2 AdamW steps: each loss within 2e-2 of the one process's and
   each grad norm within 2e-2 relative; per step s, tokens/s, the
   collectives' calls, bytes and host s (copies apart) and their share,
   the bytes of the gradient sums over "model", each rank's peak beside
   the one process's, `launch.analytic`'s bound of the same cell.

15. The dry run (repro_torch.launch.dryrun: a cell's step run once on
   meta tensors as one rank of a fake world, under FlopCounterMode,
   MemTracker and dist.comm.record) held against the card; no kernel
   either.  15a: the dry run of three single-pod (16, 16) cells at
   published widths (qwen2.5-14b decode_32k, minicpm-2b train_4k,
   mixtral-8x7b train_4k), each in a process of its own (no card;
   the whole script starts them beside 12d's child), and `report`'s
   tables of them; cost.HBM_PER_CARD equal to the card's
   total_memory.  15b: minicpm-2b at its published widths cut to 4
   layers, 8 x 2048 (11b's batch), on a (1, 1) mesh through
   `dryrun.placed_cell` (`specs.build_cell(..., shape=)`), 2 steps on
   the card against the dry run of the same cell: the argument bytes to
   the byte, the FLOPs equal to FlopCounterMode's count of step 1 on the
   card and within 0.5-2x of launch.analytic's forward x 3, the
   predicted peak within 15% of each step's max_memory_allocated (reset
   before the step).  15c (when phase 14 ran): 14b's cell in a fake
   world of 2, ranks 0 and 1: calls and bytes equal to 14b rank 0's
   `comm.STATS` each step, each rank's predicted peak within 15% of its
   14b peak.
16. The graph dry run (repro_torch.launch.graph_dryrun) and the analysis
   layer (repro_torch.analysis).  16a: the paper's fleet (2^20 vertices,
   64 PageRank jobs, Vb=512, 32 neighbour blocks a block) dry-run on
   meta as rank 0 of the (16, 16) and (2, 16, 16) meshes, its table;
   cost.HBM_PER_CARD equal to the card's total_memory.  16b, in 8a's
   world as soon as its session is built (the dry run's way: 8a's
   graph, both views, Vb=64, placed while empty, then its four jobs),
   before anything else runs on it: every rank runs one recorded
   Fused(steps_per_sync=1) superstep with every job live through B1/B2
   (counts set to 0 just before, read just after; the session keeps its
   state); after the world, here, the dry run of
   the same session in a fake world of 4, for every rank: calls equal
   call for call, resident bytes to the byte, the predicted peak (the
   dry run's, plus what the rank held besides the session) within 15%
   of max_memory_allocated (reset before the superstep); the measured
   tile_pair_loads beside the dry run's live-pair estimate, no bar.
   16c: `analysis.contracts.check_all()` on the card (every chunk under
   `no_implicit_syncs`, the last bundle through B1/B2), and the lint CLI
   over src/repro_torch exits 0.
17. The paper's block widths, on rmat_graph(2**15, 8).  17a: B1/B2 and
   B3 against their plain versions on the real block pairs (B1/B2) and
   ELL rows (B3, at most 400 read through `tile_index`) of each view at
   Vb 8, 256 and 512, every source live, numpy-seeded state: J=4 (timed
   beside the all-pairs bound, with the tile reads a job chunk costs), a
   prime J, and at Vb=512 the width contract; phase 2's bars.  17b:
   GraphSession(rmat_graph(2**15, 8), 512, capacity=4) on CUDA with phase
   3's four jobs under TwoLevel() and then Fused() to convergence, B1/B2
   counts set to 0 just before each and read just after, phase 3's bars;
   its views' bytes beside the graph dry run's.  17c: the fleet's records
   (16a's) on the kernel route, B1/B2 with two jobs a thread block.

Then one JSON line of kernel figures (each B1/B2/B3 entry with its
phase-17 widths), one of the LM figures, one of the training figures,
one of the multi-rank training figures, one of the tensor-parallel
serving figures, one of the tensor-parallel training figures, one of
the dry run's, one of the graph dry run's (16d), one of phase 17's, the
card's name and power limit, and last {"ok": true, "device": {...}}.

    python3 chip_smoke.py --trace

adds traced reruns of the same four jobs under torch.profiler after the
checks, one on each backend (the per-layer breakdown: device time by
kernel, the device's busy share), in phase 10 a traced decode step and
prefill, and in phase 11 one traced 11b step; the untraced runs above
give the end-to-end numbers.

    python3 chip_smoke.py --phases 10 [--trace]
    python3 chip_smoke.py --phases 11 [--trace]
    python3 chip_smoke.py --phases 12
    python3 chip_smoke.py --phases 13
    python3 chip_smoke.py --phases 14
    python3 chip_smoke.py --phases 15
    python3 chip_smoke.py --phases 16
    python3 chip_smoke.py --phases 17

run phase 1 and phase 10 (the LM serving path), phase 11 (training),
phase 12 (training over ranks), phase 13 (serving over ranks), phase
14 (training under the "tp" rules), phase 15 (the dry run; 15c needs
phase 14 and is skipped), phase 16 (16a and 16c; 16b needs 8a's world)
or phase 17 (17c on the fleet's records made there) alone, for
iterating; no kernels line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

N_VERTICES = 2**16
AVG_DEGREE = 8
BLOCK = 64
CAPACITY = 4
MAX_SUPERSTEPS = 5000
PPR_SOURCE = 3
SSSP_SOURCES = (0, 4097)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
SOURCE = "src/repro_torch/kernels/fused_superstep/csrc/fused_superstep.cu"
REPLACES = {"plus_times": "src/repro/kernels/fused_superstep/kernel.py:46",
            "min_plus": "src/repro/kernels/fused_superstep/kernel.py:75"}
B3_SOURCE = "src/repro_torch/kernels/mj_spmm/csrc/mj_spmm.cu"
B3_REPLACES = {"plus_times": "src/repro/kernels/mj_spmm/kernel.py:29",
               "min_plus": "src/repro/kernels/mj_spmm/kernel.py:35"}
B4_SOURCE = ("src/repro_torch/kernels/priority_pairs/csrc/"
             "priority_pairs.cu")
B4_REPLACES = "src/repro/kernels/priority_pairs/kernel.py:19"
SEMIRINGS = ("plus_times", "min_plus")
Q_B3 = 400                     # selected rows of the mj_spmm entry point
DEVICE_CADENCE = 8             # steps_per_sync of the chunk-invariance run
CADENCE_SWEEP = (4, 8, 16, 32)  # run in this order, then in reverse
PADDED_SLOTS = 3               # padded slots in push_shared's queue
SELECTION_POINTS = (("early", 0.1), ("middle", 0.5), ("late", 0.9))
B4_BIG = (16, 16384, 64)       # 16 jobs over 2**20 vertices: 64 MB > L2
# phase 6: the reference's own update generator, 0.15% of the edges a batch
# two batches (four before): the whole script's depth, cut for time
STREAM_BATCHES, STREAM_INSERTS, STREAM_DELETES, STREAM_SEED = 2, 512, 256, 1
STREAM_DELETE = 1              # UpdateBatch.op of a delete
# phase 7: the serve front, one request group per block, the load
# generator's default family mix
SERVE_CAPACITY = 8             # the session's job slots per view
SERVE_MAX_RUNNING = 8          # admitted jobs sharing the supersteps
SERVE_STEPS_PER_TICK = 8
# phase 7's horizon and 9b's (17 arrivals, both BFS, one
# update at tick 20) are cut in depth so that the whole script keeps
# inside its time limit
SERVE_LOAD = dict(seed=33, ticks=88, base_rate=0.4, burst_amplitude=0.6,
                  burst_period=60, n_tenants=64, update_every=80)
SERVE_PT_CHECKED = 3           # PageRank/PPR results held per run
# phase 8: the multi-device engine, ranks sharing the card over gloo
MESH_RANKS = 4
MESH_SSSP_SOURCES = (0, 4097, 8192, 49152)   # 8b/8c: the min-plus view only
MESH_THREADS = 2               # intra-op CPU threads a rank (8 cores, 4 ranks)
# phase 9: phase 7's load on 8a's mesh, its horizon and update period cut
MESH_SERVE_LOAD = dict(SERVE_LOAD, ticks=24, update_every=20)
TELEMETRY_PAIRS = 20           # interleaved off/on timings of telemetry
HOST_TIMED_STEPS = 8           # supersteps per timed TwoLevel() run
# back-to-back calls per timed run, so that a run lasts about 1 ms or more
R_B1B2, R_B3, R_B4, R_B4_BIG = 20, 10, 200, 50
R_PLAIN, R_B4_PLAIN, R_B4_BIG_PLAIN = 2, 20, 10
TIMING = ("ms: device time per launch, CUDA events around a run of "
          "back-to-back launches queued behind a spin, median of 5 runs; "
          "host_ms_per_call: host clock around a run of calls, no sync")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Time per call of a function on the card.

    Host time: the host clock around `launches` back-to-back calls with no
    synchronise inside, over the count (what a caller pays before it can
    go on).  Device time: a pair of CUDA events around `launches`
    back-to-back calls, over the count.  A spin kernel
    (`torch.cuda._sleep`) is queued first and outlasts the host's enqueue
    of the whole run, so the device runs the launches back to back and
    never waits for the host: the events read device time even where the
    host's wrapper takes longer than the kernel.  `queued` says whether
    every run was still behind the spin when its last call was enqueued
    (False for a function that waits on the device itself).  Each value
    is the median over `runs` runs, after `warmup` calls (with the range of
    the host runs, since the host's clock varies more than the card's);
    each call's outputs are released within the run."""

    def __init__(self, torch):
        self.torch = torch
        cycles = 10**7
        self._sleep(cycles)                  # warm the spin kernel
        a, b = self._events()
        a.record()
        self._sleep(cycles)
        b.record()
        b.synchronize()
        self.cycles_per_ms = cycles / a.elapsed_time(b)

    def _events(self):
        ev = self.torch.cuda.Event
        return ev(enable_timing=True), ev(enable_timing=True)

    def _sleep(self, cycles):
        self.torch.cuda._sleep(int(cycles))

    def __call__(self, fn, launches: int, runs: int = 5,
                 warmup: int = 2) -> dict:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        host = []
        for _ in range(runs):
            t0 = time.perf_counter()
            for _ in range(launches):
                fn()
            host.append(1e3 * (time.perf_counter() - t0) / launches)
            torch.cuda.synchronize()
        host_ms = statistics.median(host)
        dev, queued = [], True
        for _ in range(runs):
            a, b = self._events()
            self._sleep(self.cycles_per_ms * (2 * host_ms * launches + 1))
            a.record()
            for _ in range(launches):
                fn()
            b.record()
            queued &= not a.query()
            b.synchronize()
            dev.append(a.elapsed_time(b) / launches)
        return dict(ms=statistics.median(dev), host_ms=host_ms,
                    host_ms_range=[min(host), max(host)],
                    launches_per_run=launches, queued=queued)


def fmt(t: dict) -> str:
    """A Timer reading as text."""
    return (f"{t['ms']:.5f} ms device ({t['launches_per_run']} back to "
            f"back{'' if t['queued'] else ', NOT queued behind the spin'})"
            f", {t['host_ms']:.5f} ms host per call (runs "
            f"{t['host_ms_range'][0]:.5f}-{t['host_ms_range'][1]:.5f})")


def random_state(torch, rng, j, bn_src, bn_loc, vb, semiring, device):
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    if semiring == "plus_times":
        # non-negative, as the main path's PageRank/PPR deltas are (signed
        # inputs over runs of ~1000 pairs cancel, and a fixed atol then
        # measures the cancellation, not the kernel)
        return (t(rng.random((j, bn_src, vb))),
                t(rng.random((j, bn_loc, vb))), None)
    d = (rng.random((j, bn_src, vb)) * 10).astype(np.float32)
    d[rng.random(d.shape) < 0.5] = np.inf
    vals = (rng.random((j, bn_loc, vb)) * 10).astype(np.float32)
    base = np.where(rng.random(vals.shape) < 0.5, vals, np.inf)
    return t(d), t(base), t(vals)


def compare(semiring, got, want, rows) -> float:
    """Raise unless the kernel's outputs meet the bar; max |error|."""
    got = [x.cpu().numpy()[:, rows] for x in got]
    want = [x.cpu().numpy()[:, rows] for x in want]
    if semiring == "plus_times":
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)
    else:
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got[3], want[3], rtol=1e-6)
    err = 0.0
    for a, b in zip(got, want):
        fin = np.isfinite(a) & np.isfinite(b)
        if fin.any():
            err = max(err, float(np.abs(a[fin] - b[fin]).max()))
    return err


def bound(semiring, j, bn_src, bn_loc, vb, p, runs):
    """Least time for one call with every source live: bytes each
    read/written once over HBM rate vs flops over the float32 rate, over
    all P tiles."""
    states_in = 1 if semiring == "plus_times" else 2       # base (+values)
    states_out = 1 if semiring == "plus_times" else 2      # out (+values)
    nbytes = (4 * p * vb * vb                              # tiles
              + 4 * (2 * p + runs + 1)                     # src, dst, runs
              + 4 * j * bn_src * vb                        # d
              + 4 * j * bn_loc * vb * (states_in + states_out)
              + 4 * 2 * j * bn_loc)                        # node_un, p_sum
    flops = 2.0 * j * p * vb * vb
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def live_bound(semiring, j, bn_loc, vb, src_np, live_np, runs, chunks):
    """Least time for one call on a selection: the tiles of the live pairs
    (source selected) and the d rows of their distinct sources, src for
    all P, the run and chunk tables, the [B_N] mask and the state, each
    read or written once, over the HBM rate vs 2*J*Vb^2 flops per live
    pair over the float32 rate.  Returns (ms, by, live pairs)."""
    from repro_torch.launch import cost
    on = live_np[src_np]
    n_live = int(on.sum())
    n_src = int(np.unique(src_np[on]).size)
    nbytes = cost.fused_live_bytes(semiring, j, live_np.size, bn_loc, vb,
                                   len(src_np), n_live, n_src, runs, chunks)
    flops = cost.fused_live_flops(j, n_live, vb)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", n_live)


def masked_state(torch, rng, j, bn, vb, semiring, live, device):
    """random_state with the rows of d outside `live` set to the semiring
    identity (what fused_push hands the kernel)."""
    d, base, vals = random_state(torch, rng, j, bn, bn, vb, semiring, device)
    ident = 0.0 if semiring == "plus_times" else float("inf")
    return torch.where(live[None, :, None], d, ident), base, vals


def record_selections(fops):
    """Wrap fused_superstep_call in kernels.fused_superstep.ops so each
    push's `src_live` mask is kept per semiring (a reference only: no
    device work, no sync).  Returns (masks, restore)."""
    real = fops.fused_superstep_call
    masks = {"plus_times": [], "min_plus": []}

    def spy(*a, **kw):
        masks[kw["semiring"]].append(kw["src_live"])
        return real(*a, **kw)
    fops.fused_superstep_call = spy

    def restore():
        fops.fused_superstep_call = real
    return masks, restore


def check_selections(torch, timer, sess, groups, device, masks):
    """Phase 2b: B1/B2 on the main path's own selections (the src_live
    masks of an early, a middle and a late push of the phase-3 run), d
    masked by them, against the plain version; timed beside the plain
    version and the live-pair bound.  Returns {semiring: [selection
    figures]}."""
    from repro_torch.kernels.fused_superstep import kernel as fk
    from repro_torch.kernels.fused_superstep.ops import _pick_job_block
    from repro_torch.kernels.fused_superstep.ref import fused_superstep_ref

    figures = {}
    for semiring, grp in groups.items():
        bp = sess._pair_data(grp)
        bn, vb = grp.graph.num_blocks, grp.graph.block_size
        jb = _pick_job_block(CAPACITY, vb, semiring)
        rows = bp.dst_touched.cpu().numpy()
        src_np = bp.src.cpu().numpy()
        rec = masks[semiring]
        rng = np.random.default_rng(17)
        inputs = [("all live", None,
                   random_state(torch, rng, CAPACITY, bn, bn, vb, semiring,
                                device))]
        for label, frac in SELECTION_POINTS:
            k = min(len(rec) - 1, int(frac * len(rec)))
            live = rec[k]
            inputs.append((f"{label} (push {k} of {len(rec)})", live,
                           masked_state(torch, rng, CAPACITY, bn, vb,
                                        semiring, live, device)))
        figures[semiring] = []
        for label, live, (d, base, vals) in inputs:
            def kern():
                return fk.fused_superstep_call(
                    bp.src, bp.dst, bp.first, bp.last, d, base, bp.tiles,
                    values=vals, run_start=bp.run_start,
                    chunk_start=bp.chunk_start, chunk_run=bp.chunk_run,
                    arrivals=bp.arrivals(CAPACITY // jb), src_live=live,
                    semiring=semiring, job_block=jb)

            def plain():
                return fused_superstep_ref(
                    bp.src, bp.dst, bp.first, bp.last, d, base, bp.tiles,
                    values=vals, src_live=live, semiring=semiring)
            want = plain()
            got = kern()
            got2 = kern()
            torch.cuda.synchronize()
            err = compare(semiring, got, want, rows)
            for a, b in zip(got, got2):
                if not torch.equal(a[:, bp.dst_touched],
                                   b[:, bp.dst_touched]):
                    raise AssertionError(f"{semiring} {label}: two calls "
                                         f"on the same inputs differ")
            if live is None:
                continue
            live_np = live.cpu().numpy()
            k = timer(kern, R_B1B2)
            p = timer(plain, R_PLAIN)
            b_ms, b_by, n_live = live_bound(
                semiring, CAPACITY, bn, vb, src_np, live_np, bp.num_runs,
                bp.chunk_run.numel())
            log(f"  {semiring} main-path selection {label}: "
                f"{int(live_np.sum())} of {bn} sources live, {n_live} of "
                f"{bp.num_pairs} pairs; matches plain (max |err| {err:.3g}),"
                f" repeat call bit-identical; kernel {fmt(k)}; plain "
                f"{fmt(p)}; live-pair bound {b_ms:.4f} ms ({b_by}); "
                f"{100 * b_ms / k['ms']:.1f}% of the bound")
            figures[semiring].append(dict(
                selection=label, live_sources=int(live_np.sum()),
                live_pairs=n_live, ms=k["ms"],
                host_ms_per_call=k["host_ms"],
                host_ms_range=k["host_ms_range"], queued=k["queued"],
                plain_ms=p["ms"], bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err))
        del inputs
        torch.cuda.empty_cache()
    return figures


def ptxas_report(common, fk):
    """The fused superstep kernels' ptxas lines at Vb=64 (registers,
    spills), their shared memory and thread blocks per SM at J=4."""
    name = None
    info = {}
    for line in common.build_log("fused_superstep").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            info.setdefault(name, []).append(line.strip())
    for sr, tag in (("plus_times", "ILi64ELb0E"), ("min_plus", "ILi64ELb1E")):
        for fn, lines in info.items():
            if tag in fn:
                log(f"  ptxas {sr} Vb=64: {' | '.join(lines)}")
        log(f"  {sr} Vb=64 jb=4: {fk.smem_bytes(4, 64)} B shared memory, "
            f"{fk.blocks_per_sm(4, 64, sr)} thread blocks per SM")


def check_kernels(torch, timer, sess, groups, device):
    """Phase 2: kernels vs plain versions on the real pairs."""
    from repro_torch.kernels.fused_superstep import kernel as fk
    from repro_torch.kernels.fused_superstep.ops import _pick_job_block
    from repro_torch.kernels.fused_superstep.ref import fused_superstep_ref

    figures = {}
    for semiring, grp in groups.items():
        bp = sess._pair_data(grp)
        bn, vb = grp.graph.num_blocks, grp.graph.block_size
        rows_all = bp.dst_touched.cpu().numpy()
        rng = np.random.default_rng(11)
        cases = [(CAPACITY, bn, None), (7, bn, None), (7, bn, 1),
                 (CAPACITY, bn // 2, None)]
        errs = []
        for j, bn_loc, jb in cases:
            d, base, vals = random_state(torch, rng, j, bn, bn_loc, vb,
                                         semiring, device)
            jb = jb or _pick_job_block(j, vb, semiring)

            def kern():
                return fk.fused_superstep_call(
                    bp.src, bp.dst, bp.first, bp.last, d, base, bp.tiles,
                    values=vals, run_start=bp.run_start,
                    chunk_start=bp.chunk_start, chunk_run=bp.chunk_run,
                    arrivals=bp.arrivals(j // jb), semiring=semiring,
                    job_block=jb)

            def plain():
                return fused_superstep_ref(
                    bp.src, bp.dst, bp.first, bp.last, d, base, bp.tiles,
                    values=vals, semiring=semiring)

            got = kern()
            torch.cuda.synchronize()
            want = plain()
            err = compare(semiring, got, want, rows_all[:bn_loc])
            errs.append(err)
            log(f"  {semiring}: J={j} jb={jb} B_loc={bn_loc} P={bp.num_pairs}"
                f" matches plain (max |err| {err:.3g})")
            if (j, bn_loc, jb) == (CAPACITY, bn,
                                   _pick_job_block(j, vb, semiring)):
                k = timer(kern, R_B1B2)
                p = timer(plain, R_PLAIN)
                b_ms, b_by = bound(semiring, j, bn, bn_loc, vb,
                                   bp.num_pairs, bp.num_runs)
                log(f"  {semiring}: kernel {fmt(k)}; plain {fmt(p)}; bound "
                    f"{b_ms:.4f} ms ({b_by}); {k['ms'] / b_ms:.2f}x the "
                    f"bound")
                figures[semiring] = dict(
                    ms=k["ms"], host_ms_per_call=k["host_ms"],
                    queued=k["queued"], plain_ms=p["ms"], bound_ms=b_ms,
                    bound_by=b_by)
        figures[semiring]["max_abs_err"] = max(errs)
        del d, base, vals, got, want
        torch.cuda.empty_cache()
    return figures


def pagerank_ref(csr, damping, source=None, tol=1e-13, max_iter=2000):
    """float64 power iteration of x = (1-d) s + d P^T x (s = 1 for
    PageRank, the unit vector at `source` for PPR), independent of the
    code under test."""
    import scipy.sparse as sp
    n = csr.n
    deg = np.diff(csr.indptr).astype(np.float64)
    src = np.repeat(np.arange(n), np.diff(csr.indptr))
    w = csr.weights.astype(np.float64) / deg[src]
    pt = sp.csr_matrix((w, (csr.indices, src)), shape=(n, n))
    s = np.ones(n) if source is None else np.eye(1, n, source).ravel()
    x = (1 - damping) * s
    for _ in range(max_iter):
        nxt = (1 - damping) * s + damping * (pt @ x)
        if np.abs(nxt - x).sum() < tol * max(1.0, np.abs(x).sum()):
            return nxt
        x = nxt
    return x


def timed_policy(base):
    """`base` (a SchedulePolicy class) with its host select timed: the
    scheduling layer's time (DO queues + global queue), per superstep."""
    class Timed(base):
        select_s = 0.0

        def select(self, sess, node_un, p_mean, active):
            t0 = time.perf_counter()
            try:
                return super().select(sess, node_un, p_mean, active)
            finally:
                self.select_s += time.perf_counter() - t0

    return Timed()


def resubmit(torch, sess, handles):
    """Detach the jobs and submit them again (fresh state, same slots):
    the next run starts over from the initial state."""
    algs = [h.alg for h in handles]
    for h in handles:
        sess.detach(h)
    out = [sess.submit(a) for a in algs]
    torch.cuda.synchronize()
    return out


def kernel_rows(prof) -> list:
    """(device us, calls, name) of each kernel in a torch.profiler run,
    largest first.  Only the device's own events: an operator's row
    (aten::mm) carries the device time of the kernels it launched, and
    counting both would count that time twice."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0 and getattr(e, "device_type", None) == DeviceType.CUDA:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    return rows


def traced_rerun(torch, sess, handles, policy):
    """Resubmit the jobs and rerun them under torch.profiler: device time
    by kernel and the device's busy share of the run's wall time."""
    from torch.profiler import ProfilerActivity, profile
    handles = resubmit(torch, sess, handles)
    sess.scheduler.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = sess.run(policy, MAX_SUPERSTEPS)
        wall = time.perf_counter() - t0
    rows = kernel_rows(prof)
    busy_us = sum(r[0] for r in rows)
    log(f"traced rerun ({policy.name}, backend={policy.backend}): "
        f"supersteps={m.supersteps} wall {wall:.3f} s, device "
        f"busy {busy_us / 1e3:.1f} ms = {100 * busy_us / 1e6 / wall:.1f}% "
        f"of wall (idle {100 - 100 * busy_us / 1e6 / wall:.1f}%)")
    for dev_us, count, key in rows[:10]:
        log(f"  {dev_us / 1e3:9.2f} ms  {count:6d} calls  {key[:90]}")
    return handles


def sssp_ref(csr, sources):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra
    a = sp.csr_matrix((csr.weights.astype(np.float64), csr.indices,
                       csr.indptr), shape=(csr.n, csr.n))
    return dijkstra(a, directed=True, indices=list(sources))


def check_results(sess, handles, csr, refs, label):
    """Phase 3's checks of a run's results: SSSP bit-equal to scipy's
    Dijkstra, PageRank/PPR within rtol 5e-3, atol 1e-4 of the float64
    power iteration."""
    check_values([sess.result(h) for h in handles],
                 [h.alg for h in handles], csr, refs, label)


def check_values(res, algs, csr, refs, label):
    """`check_results` on results already read (`algs` the jobs')."""
    for r in res:
        if r.shape != (csr.n,) or r.dtype != np.float32:
            raise RuntimeError(f"result shape/dtype {r.shape} {r.dtype}")
    for r, alg, want in zip(res, algs, refs):
        if alg.semiring == "min_plus":
            np.testing.assert_array_equal(r, want)
            log(f"{label}: SSSP(source={alg.source}) bit-equal to scipy "
                f"dijkstra ({int(np.isfinite(want).sum())} reachable)")
        else:
            if not np.isfinite(r).all():
                raise RuntimeError(f"{alg.name}: non-finite result")
            np.testing.assert_allclose(r, want, rtol=5e-3, atol=1e-4)
            log(f"{label}: {alg.name} within rtol 5e-3, atol 1e-4 of the "
                f"float64 power iteration (max |err| "
                f"{np.abs(r - want).max():.3g})")


def drive(torch, sess, policy, fk):
    """Run `policy` to convergence with the fused kernels' launch counts
    set to 0 just before and read just after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launches()
    t0 = time.perf_counter()
    m = sess.run(policy, MAX_SUPERSTEPS)       # ends in a device sync
    wall = time.perf_counter() - t0
    return m, wall, dict(fk.launches), torch.cuda.max_memory_allocated()


def report_run(torch, label, m, wall, launches, peak):
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"{label}: converged={m.converged} supersteps={m.supersteps} "
        f"tile_loads={m.tile_loads} tile_pair_loads={m.tile_pair_loads} "
        f"job_block_pushes={m.job_block_pushes} host_syncs={m.host_syncs}")
    log(f"{label}: wall {wall:.3f} s, "
        f"{1e3 * wall / max(1, m.supersteps):.3f} ms/superstep; "
        f"launches {launches}; peak device memory {peak / 1e9:.2f} GB "
        f"({100.0 * peak / total:.1f}% of {total / 1e9:.1f} GB)")
    if not m.converged:
        raise RuntimeError(f"{label}: no convergence in {MAX_SUPERSTEPS} "
                           f"supersteps")
    for k, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{label}: kernel {k} was not launched")


def device_backend(torch, sess, handles, csr, refs, fk, host):
    """Phase 4: Fused() and TwoLevel(device, K) at full size, then one
    chunk under the sync-debug mode.  Returns (handles, Fused's launch
    counts, (Fused's RunMetrics, wall, final state))."""
    from repro_torch.core import Fused, TwoLevel
    from repro_torch.core.policy import INF_CHUNK, device_inputs

    handles = resubmit(torch, sess, handles)
    sess.scheduler.reset()
    m, wall, launches, peak = drive(torch, sess, Fused(), fk)
    report_run(torch, "device backend (Fused)", m, wall, launches, peak)
    fused = (m, wall, snapshot(sess))
    check_results(sess, handles, csr, refs, "device backend")
    hm, hwall, _ = host
    log(f"host vs device backend: supersteps {hm.supersteps} vs "
        f"{m.supersteps}, tile_loads {hm.tile_loads} vs {m.tile_loads}, "
        f"host_syncs {hm.host_syncs} vs {m.host_syncs}, wall {hwall:.3f} vs "
        f"{wall:.3f} s, ms/superstep "
        f"{1e3 * hwall / max(1, hm.supersteps):.3f} vs "
        f"{1e3 * wall / max(1, m.supersteps):.3f}")

    handles = resubmit(torch, sess, handles)
    sess.scheduler.reset()
    pol_k = TwoLevel(backend="device", steps_per_sync=DEVICE_CADENCE)
    mk_, wall_k, launches_k, peak_k = drive(torch, sess, pol_k, fk)
    report_run(torch, f"device backend (steps_per_sync={DEVICE_CADENCE})",
               mk_, wall_k, launches_k, peak_k)
    for f in ("supersteps", "tile_loads", "tile_pair_loads"):
        if getattr(mk_, f) != getattr(m, f):
            raise RuntimeError(f"chunk invariance: {f} {getattr(mk_, f)} "
                               f"at steps_per_sync={DEVICE_CADENCE} != "
                               f"{getattr(m, f)} under Fused()")
    log(f"chunk invariance: supersteps, tile_loads and tile_pair_loads "
        f"identical for Fused() and steps_per_sync={DEVICE_CADENCE}")
    check_results(sess, handles, csr, refs, "device backend, K=8")

    # the cadence against what it costs: host reads, gated launches, time;
    # each K runs once on the way up and once on the way down
    sweep = {k: [] for k in CADENCE_SWEEP}
    for k in CADENCE_SWEEP + CADENCE_SWEEP[::-1]:
        handles = resubmit(torch, sess, handles)
        sess.scheduler.reset()
        m_s, wall_s, launches_s, _ = drive(
            torch, sess, TwoLevel(backend="device", steps_per_sync=k), fk)
        for f in ("supersteps", "tile_loads", "tile_pair_loads"):
            if getattr(m_s, f) != getattr(m, f):
                raise RuntimeError(f"chunk invariance: {f} at "
                                   f"steps_per_sync={k} differs")
        check_results(sess, handles, csr, refs, f"device backend, K={k}")
        sweep[k].append((m_s, wall_s, launches_s))
    for k, runs in sweep.items():
        m_s, _, launches_s = runs[0]
        ms = [f"{1e3 * w / m_s.supersteps:.6f}" for _, w, _ in runs]
        log(f"cadence K={k}{' (INF_CHUNK)' if k == INF_CHUNK else ''}: "
            f"host_syncs {m_s.host_syncs}, launches {launches_s} for "
            f"{m_s.supersteps} supersteps, ms/superstep up, down: "
            f"{', '.join(ms)}")

    handles = resubmit(torch, sess, handles)
    step_fn = sess._device_step_fn(pol_k)
    state, *args = device_inputs(sess)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, un = step_fn(state, *args, MAX_SUPERSTEPS, sess.seed, 0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    it_h, un_h = torch.stack([state[0], un.to(torch.int64)]).tolist()
    if it_h != step_fn.chunk:
        raise RuntimeError(f"sync-debug chunk ran {it_h} supersteps")
    log(f"one chunk ({step_fn.chunk} supersteps) ran under "
        f"set_sync_debug_mode('error'): no implicit sync; "
        f"{un_h} vertices unconverged after it")
    # is a chunk bound by the host's enqueue or by the device?
    t0 = time.perf_counter()
    state, un = step_fn(state, *args, MAX_SUPERSTEPS, sess.seed, 0)
    t_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    log(f"next chunk: host enqueue {1e3 * t_enq / step_fn.chunk:.3f} ms "
        f"per superstep, enqueue + drain {1e3 * t_all / step_fn.chunk:.3f} "
        f"ms per superstep")
    return handles, launches, fused


def snapshot(sess):
    """Copies of every view group's values and deltas."""
    return [(g.values.clone(), g.deltas.clone()) for g in sess.view_groups()]


def check_series(m, label):
    """A run's telemetry series against its totals."""
    tel = m.telemetry
    if tel is None or len(tel) != m.supersteps or tel.truncated:
        raise RuntimeError(f"{label}: series of {len(tel or ())} rows for "
                           f"{m.supersteps} supersteps")
    for f in ("tile_loads", "job_block_pushes", "tile_pair_loads"):
        if int(getattr(tel, f).sum()) != getattr(m, f):
            raise RuntimeError(f"{label}: the series' {f} sums to "
                               f"{int(getattr(tel, f).sum())}, the run "
                               f"counted {getattr(m, f)}")


class OpCount:
    """Counts the torch operations dispatched inside a `with` block."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(mode, func, types, args=(), kwargs=None):
                self.n += 1
                return func(*args, **(kwargs or {}))
        self.n = 0
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def telemetry_on_off(torch, sess, handles, csr, refs, fk, host, fused):
    """Phase 4, telemetry: the same session with TelemetryConfig() (its
    step-function cache gets a telemetry entry beside the one without),
    Fused() and then TwoLevel() from the same start as the telemetry-off
    runs of phases 3 and 4.  Same schedule, host reads and bit-identical
    state; the series sums equal the totals; one chunk with the series
    under set_sync_debug_mode("error"); the cost per superstep.  The
    scheduler's stream leaves as it came, so the later phases run as
    they would without this one.  Returns the handles."""
    from repro_torch.core import Fused, TwoLevel
    from repro_torch.core.policy import device_inputs
    from repro_torch.obs import TelemetryConfig

    stream = (copy.deepcopy(sess.scheduler.rng), sess.scheduler._step)

    def same(label, m, wall, off):
        m_off, wall_off, state_off = off
        for f in ("supersteps", "tile_loads", "tile_pair_loads",
                  "job_block_pushes", "host_syncs"):
            if getattr(m, f) != getattr(m_off, f):
                raise RuntimeError(f"{label}: telemetry on gives {f} "
                                   f"{getattr(m, f)}, off "
                                   f"{getattr(m_off, f)}")
        for g, (v, d) in zip(sess.view_groups(), state_off):
            if not (torch.equal(g.values, v) and torch.equal(g.deltas, d)):
                raise RuntimeError(f"{label}: {g.semiring} state with "
                                   f"telemetry differs from without")
        check_series(m, label)
        tel = m.telemetry
        log(f"{label}: telemetry on = off in supersteps, tile_loads, "
            f"tile_pair_loads, job_block_pushes, host_syncs "
            f"({m.host_syncs}) and bit for bit in every view's values and "
            f"deltas; series of {len(tel)} rows sums to the totals "
            f"(max_residual first/last "
            f"{tel.max_residual[0].tolist()} / "
            f"{tel.max_residual[-1].tolist()}); ms/superstep off "
            f"{1e3 * wall_off / max(1, m_off.supersteps):.3f}, on "
            f"{1e3 * wall / max(1, m.supersteps):.3f}")

    sess.telemetry = TelemetryConfig()
    try:
        handles = resubmit(torch, sess, handles)
        sess.scheduler.reset()
        m, wall, launches, peak = drive(torch, sess, Fused(), fk)
        report_run(torch, "device backend (Fused), telemetry on", m, wall,
                   launches, peak)
        same("Fused", m, wall, fused)
        check_results(sess, handles, csr, refs, "device backend, telemetry")

        handles = resubmit(torch, sess, handles)
        step_fn = sess._device_step_fn(Fused())
        state, *args = device_inputs(sess)
        ptr = state[8].data_ptr()
        state, un = step_fn(state, *args, MAX_SUPERSTEPS, sess.seed, 0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, un = step_fn(state, *args, MAX_SUPERSTEPS, sess.seed, 0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        rows = state[8][:, 1].cpu().numpy()                 # tile_loads
        it_h = int(state[0].item())
        if (state[8].data_ptr() != ptr
                or not (rows[:it_h] > 0).all() or rows[it_h:].any()):
            raise RuntimeError("telemetry chunk: rows or buffers wrong")
        log(f"two chunks ({it_h} supersteps) with telemetry, the second "
            f"under set_sync_debug_mode('error'): no implicit sync; "
            f"{it_h} rows written in place")

        handles = resubmit(torch, sess, handles)
        sess.scheduler.reset()
        m, wall, launches, peak = drive(torch, sess, TwoLevel(), fk)
        report_run(torch, "main path (TwoLevel), telemetry on", m, wall,
                   launches, peak)
        same("TwoLevel", m, wall, host)
        check_results(sess, handles, csr, refs, "main path, telemetry")

        # the cost per superstep, off and on interleaved: the host enqueue
        # of one Fused chunk (the chunk's ops do not depend on the data,
        # and a sync before each call keeps the device from holding the
        # host back), and a TwoLevel() run of HOST_TIMED_STEPS supersteps
        # from the jobs' initial state; medians over TELEMETRY_PAIRS each
        cfg = sess.telemetry
        chunks = {}
        for on in (False, True):
            sess.telemetry = cfg if on else None
            handles = resubmit(torch, sess, handles)
            step_fn = sess._device_step_fn(Fused())
            state, *args = device_inputs(sess)
            chunks[on] = [step_fn, state, args]
        enq_ms, host_ms = {False: [], True: []}, {False: [], True: []}
        for i in range(TELEMETRY_PAIRS):
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                step_fn, state, args = chunks[on]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = step_fn(state, *args, MAX_SUPERSTEPS, sess.seed,
                                   0)
                enq_ms[on].append(1e3 * (time.perf_counter() - t0)
                                  / step_fn.chunk)
                chunks[on][1] = state
        torch.cuda.synchronize()
        del chunks, state, args
        for i in range(TELEMETRY_PAIRS):
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                sess.telemetry = cfg if on else None
                handles = resubmit(torch, sess, handles)
                sess.scheduler.reset()
                t0 = time.perf_counter()
                m = sess.run(TwoLevel(), HOST_TIMED_STEPS)  # ends in a sync
                host_ms[on].append(1e3 * (time.perf_counter() - t0)
                                   / m.supersteps)
        # and what a Fused chunk dispatches: torch ops per superstep
        ops = {}
        for on in (False, True):
            sess.telemetry = cfg if on else None
            handles = resubmit(torch, sess, handles)
            step_fn = sess._device_step_fn(Fused())
            state, *args = device_inputs(sess)
            with OpCount() as count:
                step_fn(state, *args, MAX_SUPERSTEPS, sess.seed, 0)
            ops[on] = count.n / step_fn.chunk
            del state, args
        torch.cuda.synchronize()
        log(f"torch ops dispatched per Fused superstep: telemetry off "
            f"{ops[False]:.2f}, on {ops[True]:.2f}")
        for name, ms in (("Fused chunk, host enqueue", enq_ms),
                         (f"TwoLevel, {HOST_TIMED_STEPS}-superstep run",
                          host_ms)):
            q = {on: statistics.quantiles(ms[on], n=4) for on in ms}
            # within a pair the two timings are adjacent, so the host's
            # drift across the loop cancels in their difference
            diff = [b - a for a, b in zip(ms[False], ms[True])]
            log(f"telemetry cost, {name}: ms/superstep over "
                f"{TELEMETRY_PAIRS} interleaved off/on pairs, median (lower"
                f" quartile, upper quartile): off {q[False][1]:.4f} "
                f"({q[False][0]:.4f}, {q[False][2]:.4f}), on "
                f"{q[True][1]:.4f} ({q[True][0]:.4f}, {q[True][2]:.4f}); "
                f"on - off {q[True][1] - q[False][1]:+.4f} ms; within a "
                f"pair on - off median {statistics.median(diff):+.4f} ms, "
                f"on slower in {sum(d > 0 for d in diff)} of "
                f"{len(diff)} pairs")
    finally:
        sess.telemetry = None
        sess.scheduler.rng, sess.scheduler._step = stream
    return handles


def max_err(got, want) -> float:
    a, b = got.cpu().numpy(), want.cpu().numpy()
    fin = np.isfinite(a) & np.isfinite(b)
    if not np.array_equal(np.isfinite(a), np.isfinite(b)):
        raise AssertionError("kernel and plain version differ in which "
                             "entries are infinite")
    return float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0


def b3_bound(q, k, j, vb):
    """Least time of one mj_spmm call: each selected tile, d row and
    output read/written once over the HBM rate vs 2 operations per
    (row, slot, job, v, w) over the float32 rate."""
    nbytes = 4 * (q * k * vb * vb + q * j * vb + q * k * j * vb)
    ops = 2.0 * q * k * j * vb * vb
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def b3_state(torch, rng, q, j, vb, semiring, device):
    d = rng.random((q, j, vb)).astype(np.float32)
    if semiring == "min_plus":
        d = d * 10
        d[rng.random(d.shape) < 0.5] = np.inf
    return torch.as_tensor(d, device=device)


def check_mj_spmm(torch, timer, groups, device):
    """Phase 5a: mj_spmm kernel against its plain version on q=400
    distinct rows of each view's real ELL tiles; timed beside the plain
    version and (plus-times) one torch.matmul."""
    from repro_torch.kernels.mj_spmm import mj_spmm
    from repro_torch.kernels.mj_spmm.ref import mj_spmm_ref

    figures = {}
    rng = np.random.default_rng(23)
    for semiring, grp in groups.items():
        tiles = grp.graph.tiles
        bn, k, vb = tiles.shape[0], tiles.shape[1], tiles.shape[2]
        rows = rng.choice(bn, Q_B3, replace=False).astype(np.int32)
        idx = torch.as_tensor(rows, device=device)
        tiles_sel = tiles[idx.long()]                  # [q, K, Vb, Vb]
        errs = []
        for j in (CAPACITY, 7):
            d = b3_state(torch, rng, Q_B3, j, vb, semiring, device)
            got = mj_spmm(d, tiles_sel, semiring)
            got_i = mj_spmm(d, tiles, semiring, tile_index=idx)
            torch.cuda.synchronize()
            want = mj_spmm_ref(d, tiles_sel, semiring)
            if semiring == "min_plus":
                np.testing.assert_array_equal(got.cpu().numpy(),
                                              want.cpu().numpy())
            else:
                np.testing.assert_allclose(got.cpu().numpy(),
                                           want.cpu().numpy(), rtol=1e-5,
                                           atol=1e-5)
            if not torch.equal(got, got_i):
                raise AssertionError("tile_index read differs from the "
                                     "gathered read")
            errs.append(max_err(got, want))
            log(f"  mj_spmm {semiring}: q={Q_B3} K={k} J={j} Vb={vb} "
                f"matches plain (max |err| {errs[-1]:.3g}); tile_index "
                f"read bit-equal to the gathered read")
            if j != CAPACITY:
                continue
            del got, got_i, want
            kt = timer(lambda: mj_spmm(d, tiles_sel, semiring), R_B3)
            ki = timer(lambda: mj_spmm(d, tiles, semiring, tile_index=idx),
                       R_B3)
            p = timer(lambda: mj_spmm_ref(d, tiles_sel, semiring), R_PLAIN)
            lib = None
            if semiring == "plus_times":
                lib = timer(lambda: torch.matmul(d[:, None], tiles_sel),
                            R_B3)
            b_ms, b_by = b3_bound(Q_B3, k, j, vb)
            log(f"  mj_spmm {semiring}: kernel {fmt(kt)}; with tile_index "
                f"{fmt(ki)}; plain {fmt(p)}; library "
                f"{'none' if lib is None else fmt(lib)}; bound "
                f"{b_ms:.4f} ms ({b_by}); {kt['ms'] / b_ms:.2f}x the bound")
            figures[semiring] = dict(
                ms=kt["ms"], host_ms_per_call=kt["host_ms"],
                queued=kt["queued"], indexed_ms=ki["ms"], plain_ms=p["ms"],
                library_ms=None if lib is None else lib["ms"],
                bound_ms=b_ms, bound_by=b_by)
        figures[semiring]["max_abs_err"] = max(errs)
        del tiles_sel, d
        torch.cuda.empty_cache()
    return figures


def check_push_shared(torch, timer, sess, groups, device):
    """Phase 5b: push_shared (the kernel-backed engine push through
    mj_spmm with tile_index) on both views, launch counts around it;
    then held against the port's ELL push."""
    from repro_torch.core import TwoLevel
    from repro_torch.core.policy import _read_pairs
    from repro_torch.core.push import compute_pairs, shared_push_fn
    from repro_torch.kernels.mj_spmm import kernel as mk
    from repro_torch.kernels.mj_spmm import push_shared

    nus, pms, acts = [], [], []
    for g in sess.view_groups():
        nu, pm = _read_pairs(*compute_pairs(g.alg, g.values, g.deltas))
        nus.append(nu)
        pms.append(pm)
        acts.append(nu.sum(-1) > 0)
    selection = TwoLevel().select(sess, nus, pms, acts)
    sel = np.asarray(selection.sel, np.int32).copy()
    msk = np.asarray(selection.msk, np.float32).copy()
    n = int((msk > 0).sum())
    sel[n - PADDED_SLOTS:n] = 0          # padded slots alias block 0
    msk[n - PADDED_SLOTS:n] = 0.0
    sel_t = torch.as_tensor(sel, device=device)
    msk_t = torch.as_tensor(msk, device=device)
    log(f"  push_shared: the host TwoLevel's first global queue, "
        f"{n - PADDED_SLOTS} blocks + {len(sel) - n + PADDED_SLOTS} padded "
        f"slots (q={len(sel)})")

    def kern(grp):
        return push_shared(grp.values, grp.deltas, grp.graph.tiles,
                           grp.graph.nbr_ids, sel_t, msk_t, grp.push_scale,
                           semiring=grp.semiring)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    outs = {sr: kern(grp) for sr, grp in groups.items()}
    torch.cuda.synchronize()
    launches = dict(mk.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"  push_shared on both views: mj_spmm launches {launches}; peak "
        f"device memory {peak / 1e9:.2f} GB")
    for sr, n_l in launches.items():
        if n_l <= 0:
            raise RuntimeError(f"mj_spmm {sr} was not launched by "
                               f"push_shared")
    for sr, grp in groups.items():
        ell = shared_push_fn(sr, grp.push_one, use_pallas=False)
        want = ell(grp.values, grp.deltas, grp.graph.tiles,
                   grp.graph.nbr_ids, sel_t, msk_t, grp.push_scale,
                   grp.overlay, None)
        (v_k, d_k), (v_e, d_e) = outs[sr], want
        if sr == "min_plus":
            np.testing.assert_array_equal(v_k.cpu().numpy(),
                                          v_e.cpu().numpy())
            np.testing.assert_array_equal(d_k.cpu().numpy(),
                                          d_e.cpu().numpy())
        else:
            np.testing.assert_allclose(v_k.cpu().numpy(), v_e.cpu().numpy(),
                                       rtol=1e-6)
            np.testing.assert_allclose(d_k.cpu().numpy(), d_e.cpu().numpy(),
                                       rtol=1e-5, atol=1e-6)
        err = max(max_err(v_k, v_e), max_err(d_k, d_e))
        del want, v_e, d_e
        k = timer(lambda: kern(grp), R_B3)
        e = timer(lambda: ell(
            grp.values, grp.deltas, grp.graph.tiles, grp.graph.nbr_ids,
            sel_t, msk_t, grp.push_scale, grp.overlay, None), 1, runs=3,
            warmup=0)
        log(f"  push_shared {sr}: matches the ELL push (max |err| "
            f"{err:.3g}); {fmt(k)} (ELL push {fmt(e)})")
    del outs
    torch.cuda.empty_cache()
    return launches


def b4_bound(j, bn, vb):
    nbytes = 4 * (j * bn * vb + 2 * j * bn)
    ops = 2.0 * j * bn * vb
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_priority_pairs(torch, timer, sess, groups):
    """Phase 5c: priority_pairs on each view's vertex priorities at
    submit and after 20 host supersteps (launch counts around those
    calls), then against core.priority.block_pairs, and timed; then at
    the byte-bound size B4_BIG, numpy-seeded with half the entries <= 0,
    against block_pairs and timed; the scalar variant (`lanes=0`) on the
    same inputs at both sizes, held and timed beside the vector one; and
    the library's empty kernel, the launch floor."""
    from repro_torch.core import TwoLevel
    from repro_torch.core.priority import block_pairs
    from repro_torch.kernels.priority_pairs import kernel as pk
    from repro_torch.kernels.priority_pairs import priority_pairs

    torch.cuda.synchronize()
    pk.reset_launches()
    outs = []
    for stage in ("at submit", "after 20 host supersteps"):
        if stage != "at submit":
            sess.run(TwoLevel(), 20)
        for sr, grp in groups.items():
            vp = grp.alg.vertex_priority(grp.values, grp.deltas)
            outs.append((stage, sr, vp, priority_pairs(vp)))
    torch.cuda.synchronize()
    launches = pk.launches["priority_pairs"]
    if launches <= 0:
        raise RuntimeError("priority_pairs was not launched")

    def held(vp, nu, pm):
        nu_p, pm_p = block_pairs(vp)
        np.testing.assert_array_equal(nu.cpu().numpy(), nu_p.cpu().numpy())
        np.testing.assert_allclose(pm.cpu().numpy(), pm_p.cpu().numpy(),
                                   rtol=1e-6)
        return max(max_err(nu, nu_p), max_err(pm, pm_p))

    def variant(vp):
        lanes = pk.pick_variant(vp.shape[-1], vp.data_ptr())
        return f"vector, {lanes} lanes per row" if lanes else "scalar"

    errs = []
    for stage, sr, vp, (nu, pm) in outs:
        errs.append(held(vp, nu, pm))
        log(f"  priority_pairs {sr} {stage}: {tuple(vp.shape)} "
            f"({variant(vp)}), node_un exact, p_mean within rtol 1e-6 "
            f"(max |err| {errs[-1]:.3g}; {int(nu.sum().item())} "
            f"unconverged vertices)")
    vp = outs[-2][2]
    floor = timer(lambda: pk.launch_empty(vp.device), R_B4)
    log(f"  launch floor (the priority_pairs library's empty kernel): "
        f"{fmt(floor)}")
    k = timer(lambda: priority_pairs(vp), R_B4)
    p = timer(lambda: block_pairs(vp), R_B4_PLAIN)
    sc_err = held(vp, *pk.priority_pairs_call(vp, lanes=0))
    sc = timer(lambda: pk.priority_pairs_call(vp, lanes=0), R_B4)
    b_ms, b_by = b4_bound(*vp.shape)
    log(f"  priority_pairs {tuple(vp.shape)}: kernel {fmt(k)}; scalar "
        f"variant (a warp per row) on the same input "
        f"{fmt(sc)} (max |err| {sc_err:.3g}); plain {fmt(p)}; bound "
        f"{b_ms:.6f} ms ({b_by}); {k['ms'] / floor['ms']:.2f}x the launch "
        f"floor; launches on its path {launches}")

    rng = np.random.default_rng(29)
    big = torch.as_tensor(rng.standard_normal(B4_BIG, dtype=np.float32),
                          device=vp.device)        # half the entries <= 0
    nu, pm = priority_pairs(big)
    torch.cuda.synchronize()
    big_err = held(big, nu, pm)
    del nu, pm
    kb = timer(lambda: priority_pairs(big), R_B4_BIG)
    pb = timer(lambda: block_pairs(big), R_B4_BIG_PLAIN)
    scb_err = held(big, *pk.priority_pairs_call(big, lanes=0))
    scb = timer(lambda: pk.priority_pairs_call(big, lanes=0), R_B4_BIG)
    bb_ms, bb_by = b4_bound(*B4_BIG)
    log(f"  priority_pairs {B4_BIG} ({variant(big)}; "
        f"{big.numel() * 4 / 2**20:.0f} MiB): node_un exact, p_mean within "
        f"rtol 1e-6 (max |err| {big_err:.3g}); kernel {fmt(kb)}; scalar "
        f"variant {fmt(scb)} (max |err| {scb_err:.3g}); plain {fmt(pb)}; "
        f"bound {bb_ms:.6f} ms ({bb_by}); {100 * bb_ms / kb['ms']:.1f}% of "
        f"the bound (scalar {100 * bb_ms / scb['ms']:.1f}%)")
    del big
    torch.cuda.empty_cache()
    return dict(ms=k["ms"], device_ms=k["ms"], host_ms_per_call=k["host_ms"],
                host_ms_range=k["host_ms_range"],
                queued=k["queued"], launch_floor_ms=floor["ms"],
                launch_floor_host_ms=floor["host_ms"], plain_ms=p["ms"],
                scalar_variant_device_ms=sc["ms"],
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape=list(vp.shape),
                max_abs_err=max(errs + [big_err, sc_err, scb_err]),
                launches=launches,
                byte_bound_size=dict(
                    shape=list(B4_BIG), device_ms=kb["ms"],
                    host_ms_per_call=kb["host_ms"],
                    host_ms_range=kb["host_ms_range"], queued=kb["queued"],
                    scalar_variant_device_ms=scb["ms"],
                    plain_ms=pb["ms"], bound_ms=bb_ms, bound_by=bb_by,
                    max_abs_err=max(big_err, scb_err)))


# -- phase 6: evolving graphs ------------------------------------------------


def plain_adjacency(csr):
    """The graph as a scipy CSR matrix: the plain side of phase 6."""
    import scipy.sparse as sp
    return sp.csr_matrix((csr.weights.astype(np.float32), csr.indices,
                          csr.indptr), shape=(csr.n, csr.n))


def plain_update(adj, batch):
    """`adj` after `batch`, independent of the port's apply_to_csr: ops in
    order, an insert sets the weight (in-batch duplicate inserts keep the
    smaller), a delete removes the edge."""
    import scipy.sparse as sp
    coo = adj.tocoo()
    edges = dict(zip(zip(coo.row.tolist(), coo.col.tolist()),
                     coo.data.tolist()))
    fresh = set()
    for u, v, w, op in zip(batch.src.tolist(), batch.dst.tolist(),
                           batch.w.tolist(), batch.op.tolist()):
        if op == STREAM_DELETE:
            edges.pop((u, v), None)
            fresh.discard((u, v))
        elif (u, v) in fresh:
            edges[(u, v)] = min(edges[(u, v)], w)
        else:
            edges[(u, v)] = w
            fresh.add((u, v))
    keys = np.array(sorted(edges), dtype=np.int64).reshape(-1, 2)
    w = np.array([edges[k] for k in map(tuple, keys.tolist())], np.float32)
    out = sp.csr_matrix((w, (keys[:, 0], keys[:, 1])), shape=adj.shape)
    out.sort_indices()
    return out


def plain_csr(adj):
    """The (n, indptr, indices, weights) view the references read."""
    return types.SimpleNamespace(n=adj.shape[0], indptr=adj.indptr,
                                 indices=adj.indices, weights=adj.data)


def references(csr, algs):
    """Each job's plain answer on `csr`: Dijkstra for SSSP, the float64
    power iteration for PageRank/PPR."""
    sources = [a.source for a in algs if a.semiring == "min_plus"]
    dist = iter(sssp_ref(csr, sources).astype(np.float32))
    return [next(dist) if a.semiring == "min_plus"
            else pagerank_ref(csr, a.damping, getattr(a, "source", None))
            for a in algs]


def tile_rows(grp):
    """Each source block's destination blocks that own a tile slot in
    `grp`, from the group's host mirror of the whole view (`pair_slot`,
    built by its first apply_updates; on a mesh the ELL rows are
    sliced)."""
    rows = [set() for _ in range(grp.graph.num_blocks)]
    for sb, db in grp.pair_slot:
        rows[sb].add(db)
    return rows


def new_pairs(sess, grp, rows, per_row, reach):
    """Inserts (u, v) on block pairs that own no tile slot in `grp`: for
    each source block of `rows`, `per_row` edges from its first vertex
    `reach` marks (finite SSSP distance) to distinct destination blocks
    outside its ELL row, none an existing edge."""
    slots = tile_rows(grp)
    n, bn = sess._csr.n, grp.graph.num_blocks
    src, dst = [], []
    for b in rows:
        lanes = [u for u in range(b * BLOCK, min(n, (b + 1) * BLOCK))
                 if reach[u]]
        if not lanes:
            raise RuntimeError(f"block {b} has no reachable vertex")
        u = lanes[0]
        taken = slots[b]
        free = [db for db in range(bn) if db not in taken]
        picked = 0
        for db in free:
            v = db * BLOCK + (u % BLOCK)
            if v < n and v != u and sess._csr.edge_weight(u, v) is None:
                src.append(u)
                dst.append(v)
                picked += 1
                if picked == per_row:
                    break
        if picked < per_row:
            raise RuntimeError(f"block {b}: {picked} of {per_row} pairs")
    return src, dst


def stream_phase(torch, sess, handles, csr, fk):
    """Phase 6: the evolving-graph path at full size on the session of
    phases 3-5.  The jobs converge on the generated graph, then take
    `mutation_stream` batches (Fused after batch 1, TwoLevel after
    batch 2), a hand-built batch of inserts on block pairs without
    a tile slot (the overlay and the kernel route's ride-along, under
    Fused) and a batch that overflows one block row's overlay (compaction,
    under TwoLevel); then an explicit compact().  Each rerun is held to
    the phase 3 bars on the updated graph, and the session's CSR to a
    plain application of the batches; after compaction each view's tiles
    and pair view to a fresh build.  Returns the B1/B2 launch counts of
    the reruns."""
    from repro_torch.core import Fused, TwoLevel
    from repro_torch.graph import (build_block_pairs, build_blocked,
                                   mutation_stream)
    from repro_torch.stream import UpdateBatch

    groups = sess.view_groups()
    handles = resubmit(torch, sess, handles)
    m0 = sess.run(TwoLevel(), MAX_SUPERSTEPS)
    if not m0.converged:
        raise RuntimeError("phase 6: no convergence before the stream")
    adj = plain_adjacency(csr)
    t0 = time.perf_counter()
    batches = mutation_stream(csr, STREAM_BATCHES,
                              inserts_per_batch=STREAM_INSERTS,
                              deletes_per_batch=STREAM_DELETES,
                              seed=STREAM_SEED)
    log(f"stream: mutation_stream({STREAM_BATCHES} batches of "
        f"{STREAM_INSERTS} inserts + {STREAM_DELETES} deletes, seed "
        f"{STREAM_SEED}) generated in {time.perf_counter() - t0:.2f} s")
    totals = {sr: 0 for sr in SEMIRINGS}
    peak = [0]
    total_mem = torch.cuda.get_device_properties(0).total_memory

    def peak_of(fn):
        """fn()'s result and the device memory peak while it ran, in GB."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        got = torch.cuda.max_memory_allocated()
        peak[0] = max(peak[0], got)
        return out, got / 1e9

    def step(label, batch, policy):
        nonlocal adj
        t0 = time.perf_counter()
        st, apply_gb = peak_of(lambda: sess.apply_updates(batch))
        apply_s = time.perf_counter() - t0
        adj = plain_update(adj, batch)
        for f, want in (("indptr", adj.indptr), ("indices", adj.indices),
                        ("weights", adj.data)):
            if not np.array_equal(getattr(sess._csr, f), want):
                raise RuntimeError(f"{label}: the session's CSR {f} differs "
                                   f"from the plain application")
        live = sum(int(g.overlay.mask.sum()) for g in groups)
        t0 = time.perf_counter()
        for g in groups:
            sess._pair_data(g)
        torch.cuda.synchronize()
        pairs_s = time.perf_counter() - t0
        m, wall, launches, run_peak = drive(torch, sess, policy, fk)
        peak[0] = max(peak[0], run_peak)
        for sr in totals:
            totals[sr] += launches[sr]
        log(f"{label} ({policy.name}, backend={policy.backend}): "
            f"apply_updates {apply_s:.3f} s; updates {st.updates_applied}, "
            f"dirty_blocks {st.dirty_blocks}, reseed_fraction "
            f"{st.reseed_fraction:.6f}, compacted_views "
            f"{st.compacted_views}; overlay entries live {live}, pair view "
            f"rebuilt in {pairs_s:.3f} s; rerun wall {wall:.3f} s, "
            f"supersteps {m.supersteps}, tile_loads {m.tile_loads}, "
            f"tile_pair_loads {m.tile_pair_loads}, host_syncs "
            f"{m.host_syncs}, launches {launches}; updates_applied "
            f"{m.updates_applied}, dirty_blocks {m.dirty_blocks} in "
            f"RunMetrics; device memory peak {apply_gb:.2f} GB in "
            f"apply_updates, {run_peak / 1e9:.2f} GB in the rerun")
        if not m.converged:
            raise RuntimeError(f"{label}: no convergence in "
                               f"{MAX_SUPERSTEPS} supersteps")
        if (m.updates_applied, m.dirty_blocks) != (st.updates_applied,
                                                   st.dirty_blocks):
            raise RuntimeError(f"{label}: RunMetrics did not drain the "
                               f"stream counters")
        check_results(sess, handles, plain_csr(adj),
                      references(plain_csr(adj), [h.alg for h in handles]),
                      label)
        return st, live

    for i, b in enumerate(batches):
        step(f"stream batch {i + 1}/{len(batches)}", b,
             Fused() if i % 2 == 0 else TwoLevel())

    # inserts on block pairs without a tile slot: they land in the overlay
    reach = np.isfinite(sess.result(handles[-2]))
    bn = groups[0].graph.num_blocks
    src, dst = new_pairs(sess, groups[0], range(7, bn, bn // 8), 1, reach)
    _, live = step("stream overlay batch", UpdateBatch.inserts(src, dst),
                   Fused())
    if live == 0:
        raise RuntimeError("the overlay batch left no live overlay entry")

    # more new pairs in one block row than its overlay holds: compaction
    row = int(np.argmin([len(r) for r in tile_rows(groups[0])]))
    src, dst = new_pairs(sess, groups[0], [row],
                         sess.overlay_capacity + 1,
                         np.ones(sess._csr.n, dtype=bool))
    st, _ = step(f"stream overflow batch (block row {row})",
                 UpdateBatch.inserts(src, dst), TwoLevel())
    if st.compacted_views != len(groups):
        raise RuntimeError(f"overflow batch compacted {st.compacted_views} "
                           f"of {len(groups)} views")
    t0 = time.perf_counter()
    _, compact_gb = peak_of(sess.compact)
    compact_s = time.perf_counter() - t0

    def same_as_fresh(g):
        _, fill, normalize, _ = g.key
        fresh = build_blocked(sess._csr, BLOCK, fill=fill,
                              normalize=normalize, device=sess.device)
        bp, fb = sess._pair_data(g), build_block_pairs(fresh)
        for f in ("tiles", "nbr_ids", "nbr_mask"):
            if not torch.equal(getattr(g.graph, f), getattr(fresh, f)):
                raise RuntimeError(f"compacted {g.semiring} view: {f} "
                                   f"differs from a fresh build")
        for f in ("src", "dst", "tiles", "run_start", "chunk_start",
                  "chunk_run"):
            if not torch.equal(getattr(bp, f), getattr(fb, f)):
                raise RuntimeError(f"compacted {g.semiring} view: pairs "
                                   f"{f} differ from a fresh build")

    check_gb = []
    for g in groups:
        check_gb.append(peak_of(lambda: same_as_fresh(g))[1])
        torch.cuda.empty_cache()
    log(f"stream: compact() of {len(groups)} views {compact_s:.3f} s "
        f"(device memory peak {compact_gb:.2f} GB); tiles, nbr_ids, "
        f"nbr_mask and pairs (src, dst, tiles, run_start, chunk_start, "
        f"chunk_run) bit-equal to a fresh build of the final CSR "
        f"({sess._csr.nnz} edges) on the card (peak "
        f"{', '.join(f'{x:.2f}' for x in check_gb)} GB while checking)")
    log(f"stream: peak device memory {peak[0] / 1e9:.2f} GB "
        f"({100.0 * peak[0] / total_mem:.1f}% of {total_mem / 1e9:.1f} GB)"
        f"; launches over the reruns {totals}")
    for sr, n in totals.items():
        if n <= 0:
            raise RuntimeError(f"stream: kernel {sr} was not launched")
    return handles, totals


# -- phase 7: the serve front ------------------------------------------------


def peak_running(h) -> int:
    """Most requests running at once, from the harness's logs: admissions
    at tick t join before completions stamped t + 1 leave."""
    admits = sorted(t for t, *_ in h.admission_log)
    leaves = sorted(t for t, *_ in h.completion_log)
    peak, ai, li = 0, 0, 0
    for t in range(h.ticks_run + 1):
        while ai < len(admits) and admits[ai] <= t:
            ai += 1
        peak = max(peak, ai - li)
        while li < len(leaves) and leaves[li] <= t + 1:
            li += 1
    return peak


def check_served(done, label):
    """Each detached result (alg, result, the CSR it finished on) against
    its plain answer: SSSP/BFS bit-equal to scipy's Dijkstra/BFS, the
    first `SERVE_PT_CHECKED` PageRank/PPR within phase 3's bars.  Returns
    (min-plus checked, plus-times checked, CSR versions)."""
    from scipy.sparse.csgraph import dijkstra
    import scipy.sparse as sp
    versions, cache = {}, {}
    n_min = n_pt = 0
    for alg, res, g in done:
        v = versions.setdefault(id(g), len(versions))
        if alg.semiring == "min_plus":
            key = (v, alg.name, alg.source)
            if key not in cache:
                a = sp.csr_matrix((g.weights.astype(np.float64), g.indices,
                                   g.indptr), shape=(g.n, g.n))
                cache[key] = dijkstra(a, directed=True, indices=alg.source,
                                      unweighted=alg.name == "bfs"
                                      ).astype(np.float32)
            np.testing.assert_array_equal(res, cache[key])
            n_min += 1
        elif n_pt < SERVE_PT_CHECKED:
            src = getattr(alg, "source", None)
            key = (v, alg.name, src)
            if key not in cache:
                cache[key] = pagerank_ref(g, alg.damping, src)
            if not np.isfinite(res).all():
                raise RuntimeError(f"{label}: non-finite {alg.name}")
            np.testing.assert_allclose(res, cache[key], rtol=5e-3,
                                       atol=1e-4)
            n_pt += 1
    return n_min, n_pt, len(versions)


def serve_run(torch, csr, policy, fk, out_dir):
    """One open-loop harness run of phase 7 on a fresh session; returns
    its B1/B2 launch counts."""
    from repro_torch.algorithms import BFS, PageRank, SSSP
    from repro_torch.core import GraphSession
    from repro_torch.obs import (LoadgenConfig, MetricsRegistry,
                                 OpenLoopHarness, SLOTarget, SLOTracker,
                                 validate_registry_snapshot,
                                 validate_trace_events)
    from repro_torch.serve import ConcurrentServeScheduler

    label = f"serve ({policy.name}, backend={policy.backend})"
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sess = GraphSession(csr, BLOCK, capacity=SERVE_CAPACITY, seed=0,
                        telemetry=True)
    # set-up outside the served ticks: the three views the family mix
    # needs (plus-times, min-plus, unit-weight min-plus) and their pairs
    for alg in (PageRank(), SSSP(source=0), BFS(source=0)):
        sess.detach(sess.submit(alg))
    for g in sess.view_groups():
        sess._pair_data(g)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mem_setup = torch.cuda.memory_allocated()
    n_groups = sess.scheduler.num_blocks
    slo = SLOTracker(targets=[SLOTarget(family="*", p99_latency_steps=60)])
    sched = ConcurrentServeScheduler(n_groups, batch_budget=SERVE_MAX_RUNNING,
                                     seed=5, trace=sess.trace, slo=slo)
    h = OpenLoopHarness(sess, sched, LoadgenConfig(**SERVE_LOAD),
                        policy=policy, max_running=SERVE_MAX_RUNNING,
                        supersteps_per_tick=SERVE_STEPS_PER_TICK)
    # the script's view of the run: every RunMetrics, each detached job's
    # result with the CSR it finished on, and the seconds and device
    # memory peak inside run() and apply_updates() against the rest (the
    # harness, submit, detach, the convergence poll)
    runs, done = [], []
    secs = {"run": 0.0, "apply_updates": 0.0}
    peaks = {"run": 0, "apply_updates": 0, "rest": 0}
    real = {k: getattr(sess, k) for k in ("run", "apply_updates",
                                           "detach")}

    def segment(name):
        def call(*a, **kw):
            torch.cuda.synchronize()
            peaks["rest"] = max(peaks["rest"],
                                torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = real[name](*a, **kw)
            torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t0
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            if name == "run":
                runs.append(out)
            return out
        return call

    def detach(handle):
        res = real["detach"](handle)
        done.append((handle.alg, res, sess._csr))
        return res
    sess.run, sess.apply_updates = segment("run"), segment("apply_updates")
    sess.detach = detach

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launches()
    t0 = time.perf_counter()
    s = h.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fk.launches)
    peaks["rest"] = max(peaks["rest"], torch.cuda.max_memory_allocated())
    peak = max(peaks.values())

    # -- checks ------------------------------------------------------------
    if not s["admitted"] == s["completed"] == s["arrivals"] > 0:
        raise RuntimeError(f"{label}: arrivals {s['arrivals']}, admitted "
                           f"{s['admitted']}, completed {s['completed']}")
    # the load must fill the slots: at the peak the admission headroom
    # (the scheduler's batch budget) is 0
    most = peak_running(h)
    if most != SERVE_MAX_RUNNING:
        raise RuntimeError(f"{label}: at most {most} requests ran at once, "
                           f"not the {SERVE_MAX_RUNNING} the load should "
                           f"fill")
    # request-ticks of service over the ticks: the mean number running
    mean_running = (sum(c[0] for c in h.completion_log)
                    - sum(a[0] for a in h.admission_log)) / h.ticks_run
    for m in runs:
        check_series(m, label)
    tel_loads = sum(int(m.telemetry.tile_loads.sum()) for m in runs)
    if tel_loads != s["counters"]["tile_loads"]:
        raise RuntimeError(f"{label}: series tile_loads {tel_loads} != "
                           f"harness {s['counters']['tile_loads']}")
    for k, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{label}: kernel {k} was not launched")
    trace_path = out_dir / f"serve_trace_{policy.backend}.json"
    sess.trace.export(str(trace_path))
    doc = json.loads(trace_path.read_text())
    n_events = validate_trace_events(doc)
    admits = sum(e["name"] == "serve.admit" for e in doc["traceEvents"])
    if admits == 0:
        raise RuntimeError(f"{label}: no serve.admit instant in the trace")
    reg = MetricsRegistry()
    reg.register("serve", sched.metrics)
    reg.register("slo", slo)
    reg.register("loadgen", s)
    reg.register("last_run", runs[-1].to_dict(include_telemetry=True))
    n_sources = validate_registry_snapshot(reg.snapshot())

    n_min, n_pt, n_versions = check_served(done, label)

    lat, fams = s["latency_ticks"], s["latency_by_family"]
    steps = max(1, s["supersteps"])
    log(f"{label}: device memory {mem0 / 1e9:.2f} GB allocated before the "
        f"session, {mem_setup / 1e9:.2f} GB after its set-up; peak "
        f"{peaks['run'] / 1e9:.2f} GB in run(), "
        f"{peaks['apply_updates'] / 1e9:.2f} GB in apply_updates(), "
        f"{peaks['rest'] / 1e9:.2f} GB elsewhere; seconds in run() "
        f"{secs['run']:.3f}, in apply_updates() {secs['apply_updates']:.3f},"
        f" elsewhere {wall - secs['run'] - secs['apply_updates']:.3f} (the "
        f"harness, submit, detach, the convergence poll; each call fenced "
        f"by a sync)")
    log(f"{label}: set-up {setup_s:.2f} s (3 views + pairs); arrivals "
        f"{s['arrivals']}, admitted {s['admitted']}, completed "
        f"{s['completed']}, at most {most} running, {mean_running:.3f} "
        f"on average; ticks {s['ticks']}, "
        f"supersteps {s['supersteps']}, updates {s['updates_applied']}; "
        f"throughput {s['throughput_per_tick']} per tick; latency ticks "
        f"p50 {lat['p50']} p99 {lat['p99']} max {lat['max']}")
    log(f"{label}: by family " + "; ".join(
        f"{f} n={x['count']} p50 {x['p50']} p99 {x['p99']}"
        for f, x in fams.items()))
    log(f"{label}: wall {wall:.3f} s, {1e3 * wall / max(1, s['ticks']):.3f} "
        f"ms/tick, {1e3 * wall / steps:.3f} ms/superstep; launches "
        f"{launches}; counters {s['counters']}; peak device memory "
        f"{peak / 1e9:.2f} GB")
    log(f"{label}: {n_min} SSSP/BFS results bit-equal to scipy on the CSR "
        f"they finished on ({n_versions} CSR versions), {n_pt} "
        f"PageRank/PPR within rtol 5e-3, atol 1e-4; every run's series "
        f"sums to its totals, {len(runs)} runs' tile_loads {tel_loads} = "
        f"the harness's; trace {n_events} events ({admits} serve.admit) "
        f"valid; registry snapshot of {n_sources} sources valid; SLO "
        f"p99 <= 60 ticks met by family: " + ", ".join(
            f"{f} {e['slo']['ok']}"
            for f, e in slo.report()["families"].items() if "slo" in e))
    for k, fn in real.items():
        setattr(sess, k, fn)
    del sess, h, sched, runs, done
    return launches


def serve_phase(torch, csr, fk, out_dir):
    """Phase 7: the open-loop serve front at full size, once on each
    scheduling backend.  Returns the B1/B2 launches of both runs."""
    from repro_torch.core import TwoLevel
    totals = {sr: 0 for sr in SEMIRINGS}
    for policy in (TwoLevel(), TwoLevel(backend="device",
                                        steps_per_sync=SERVE_STEPS_PER_TICK)):
        launches = serve_run(torch, csr, policy, fk, out_dir)
        for sr in totals:
            totals[sr] += launches[sr]
        gc.collect()
        torch.cuda.empty_cache()
    return totals


# -- phase 8: the multi-device engine ---------------------------------------


class MemoryPoll:
    """The card's peak `nvidia-smi` memory.used (MiB) while a phase runs:
    a thread polls every 0.5 s until stopped."""

    def __init__(self):
        import threading
        self.peak_mib = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)

    def _read(self) -> int:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60)
        return int(out.stdout.split()[0])

    def _poll(self):
        while not self._stop.is_set():
            self.peak_mib = max(self.peak_mib, self._read())
            self._stop.wait(0.5)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak_mib = max(self.peak_mib, self._read())


def mesh_algs(views: int):
    """Phase 8's jobs: the main path's four (two views) or four SSSP
    sources on the min-plus view alone."""
    from repro_torch.algorithms import PageRank, PersonalizedPageRank, SSSP
    if views == 2:
        return [PageRank(), PersonalizedPageRank(source=PPR_SOURCE)] + [
            SSSP(source=s) for s in SSSP_SOURCES]
    return [SSSP(source=s) for s in MESH_SSSP_SOURCES]


def mesh_policy(name: str):
    from repro_torch.core import Fused, TwoLevel
    return {"TwoLevel()": TwoLevel, "Fused()": Fused,
            "TwoLevel(device, 8)": lambda: TwoLevel(
                backend="device", steps_per_sync=DEVICE_CADENCE)}[name]()


def shard_kernels(torch, sess, rank: int) -> dict:
    """B1/B2 on this rank's placed pair shard (`PairShards.local`: local
    dst, the shard's run and chunk tables, the inert pad of an empty
    shard) at the shapes the mesh path gives them, d at [J, B_N, Vb] and
    base/values at [J, B_loc, Vb], against the plain version on the same
    inputs at phase 2's bars on the rows the shard touches.  Raises on a
    mismatch; returns max |err| per semiring.  Runs before the timed
    runs, whose launch counts start at 0."""
    from repro_torch.kernels.fused_superstep import kernel as fk
    from repro_torch.kernels.fused_superstep.ops import _pick_job_block
    from repro_torch.kernels.fused_superstep.ref import fused_superstep_ref
    rng = np.random.default_rng(23 + rank)
    errs = {}
    for g in sess.view_groups():
        sr, ps = g.semiring, sess._pair_shards(g)
        lp = ps.local
        j, b_loc, vb = g.values.shape
        d, base, vals = random_state(torch, rng, j, ps.num_blocks, b_loc, vb,
                                     sr, sess.device)
        jb = _pick_job_block(j, vb, sr)
        got = fk.fused_superstep_call(
            lp.src, lp.dst, lp.first, lp.last, d, base, lp.tiles,
            values=vals, run_start=lp.run_start,
            chunk_start=lp.chunk_start, chunk_run=lp.chunk_run,
            arrivals=lp.arrivals(j // jb), semiring=sr, job_block=jb)
        torch.cuda.synchronize()
        want = fused_superstep_ref(lp.src, lp.dst, lp.first, lp.last, d,
                                   base, lp.tiles, values=vals, semiring=sr)
        errs[sr] = compare(sr, got, want, lp.dst_touched.cpu().numpy())
        log(f"  rank {rank}: {sr} B1/B2 on shard {ps.shard} of "
            f"{ps.num_shards} (J={j} jb={jb} B_loc={b_loc} d at "
            f"B_N={ps.num_blocks}, P={lp.num_pairs}) matches plain (max "
            f"|err| {errs[sr]:.3g})")
    return errs


def mesh_rank(rank: int, csr, plan: dict, world_t0: float) -> dict:
    """One rank of a phase-8 world (every rank runs it; the ranks share
    the card over gloo).  Each rank places an empty session on the mesh
    and submits the jobs, so each view is built as this rank's slices
    alone (`build_view_shard`: no whole view on any rank), all ranks at
    once; then every run of `plan` goes through `GraphSession.run(mesh=
    ...)` with the B1/B2 counts set to 0 just before and read just after,
    and with `plan["stream"]` phase 9 follows in the same world.  Returns
    rank 0's results and every rank's figures."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import GraphSession
    from repro_torch.dist.fault import checkpoint_session
    from repro_torch.dist.graph import make_job_mesh, shard_session
    from repro_torch.dist.mesh2d import make_mesh2d
    from repro_torch.kernels.fused_superstep import kernel as fk

    def everyone(x):
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, x)
        return out

    mesh = (make_job_mesh() if plan["mesh"] == "jobs"
            else make_mesh2d(*plan["mesh"]))
    mesh_ready = time.time()      # the wall clock: comparable across ranks
    t0 = time.perf_counter()
    sess = GraphSession(csr, BLOCK, capacity=CAPACITY, seed=0)
    shard_session(mesh, sess)
    handles = [sess.submit(a) for a in mesh_algs(plan["views"])]
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated()
    log(f"  rank {rank}: view slices built at {time.perf_counter() - t0:.1f}"
        f" s (build peak {build_peak / 1e9:.2f} GB, held "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB)")
    dist.barrier()
    setup_s = time.perf_counter() - t0
    # 16b: the session as built (placed while empty, then its jobs), before
    # anything else runs on it or caches a kernel table in its shards
    graph = graph_rank(torch, sess) if plan.get("graph") else None
    shard_err = shard_kernels(torch, sess, rank)

    def collective_ms(numel, device, reps=10):
        """ms per gloo all_reduce of `numel` float32 on `device` over the
        world, the ranks lined up by a barrier first."""
        t = torch.zeros(numel, device=device)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        dist.barrier()
        t1 = time.perf_counter()
        for _ in range(reps):
            dist.all_reduce(t)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t1) / reps

    frontier = max(g.values.shape[0] for g in sess.view_groups()) * sess.q \
        * BLOCK
    shards = {g.semiring: sess._pair_shards(g) for g in sess.view_groups()}
    mine = dict(
        setup_s=setup_s, build_peak=build_peak,
        held=torch.cuda.memory_allocated(),
        tile_bytes={sr: ps.tile_bytes for sr, ps in shards.items()},
        ell_bytes={g.semiring: g.graph.tiles.numel() * 4
                   for g in sess.view_groups()},
        jobs_local={g.semiring: int(g.values.shape[0])
                    for g in sess.view_groups()},
        shard_err=shard_err, runs=[], graph=graph)
    info = dict(q=sess.q, num_blocks=sess.scheduler.num_blocks,
                mesh_ready_s=mesh_ready - world_t0,
                collective_ms={(n, dev): collective_ms(n, dev)
                               for dev in (sess.device, "cpu")
                               for n in (4096, frontier)},
                capacities=[g.capacity for g in sess.view_groups()],
                shard_pairs={sr: ps.shard_pairs for sr, ps in shards.items()},
                pair_cap={sr: ps.pair_cap for sr, ps in shards.items()},
                runs=[])
    # phase 9 replaces the shards (compaction): a name bound here would
    # keep the old pair tiles alive
    del shards

    def timed(label, policy, budget=MAX_SUPERSTEPS):
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        fk.reset_launches()
        t0 = time.perf_counter()
        m = sess.run(policy, budget, mesh=mesh)
        wall = time.perf_counter() - t0
        launches = dict(fk.launches)
        mine["runs"].append(dict(
            label=label, launches=launches,
            peak=torch.cuda.max_memory_allocated(),
            collective_s=m.collective_s))
        results = [sess.result(h) for h in handles]
        info["runs"].append(dict(
            label=label, wall=wall, metrics=m.to_dict(),
            collectives=m.collectives, collective_s=m.collective_s,
            results=results))
        return m

    for i, (label, name, compress) in enumerate(plan["runs"]):
        if i:
            handles = resubmit(torch, sess, handles)
            sess.scheduler.reset()
        if compress:
            shard_session(mesh, sess, compress_halo=True)
        timed(label, mesh_policy(name))
        if compress:
            shard_session(mesh, sess)
    if plan.get("checkpoint"):
        # half the run, a snapshot, then the rest (same stream: the same
        # total supersteps as the full run above)
        label, name = plan["checkpoint"]
        total = info["runs"][-1]["metrics"]["supersteps"]
        handles = resubmit(torch, sess, handles)
        sess.scheduler.reset()
        pre = timed(label + " first half", mesh_policy(name), total // 2)
        info["snapshot"] = checkpoint_session(sess)
        info["snapshot_supersteps"] = pre.supersteps
        timed(label + " resumed", mesh_policy(name))
    if plan.get("stream"):
        with (MemoryPoll() if rank == 0 else contextlib.nullcontext()) as mp:
            info["stream"], mine["stream"], handles = mesh_stream(
                torch, sess, handles, rank)
            info["serve"], mine["serve"] = mesh_serve(torch, sess, handles,
                                                      rank)
        info["smi_peak_mib_9"] = mp.peak_mib if rank == 0 else None
    info["ranks"] = everyone(mine)
    return info


def cuda_census(torch, min_bytes=2 ** 26):
    """(bytes of the CUDA tensors Python can reach, {shape: count} of those
    of at least `min_bytes`): who holds what `memory_allocated` counts."""
    gc.collect()
    seen, total, big = set(), 0, {}
    for o in gc.get_objects():
        if not (isinstance(o, torch.Tensor) and o.is_cuda):
            continue
        st = o.untyped_storage()
        if st.data_ptr() in seen:
            continue
        seen.add(st.data_ptr())
        total += st.nbytes()
        if st.nbytes() >= min_bytes:
            key = str(tuple(o.shape))
            big[key] = big.get(key, 0) + 1
    return total, big


def mesh_stream(torch, sess, handles, rank: int):
    """Phase 9a in every rank of 8a's world, on its placed session (the
    four jobs converged by 8a's last run): phase 6's traffic, the two
    `mutation_stream` batches (Fused after 1, TwoLevel after 2), the
    overlay batch (Fused) and the overflow batch (TwoLevel, both
    views compact), each applied and rerun to convergence; then an
    explicit compact().  B1/B2 are held against the plain version on
    this rank's edited pair shard after the first batch and on its
    compacted one after compact(), whose slices are then held to a fresh
    `build_view_shard` of the final CSR.  Returns (rank 0's results and
    figures, this rank's figures, the handles)."""
    import torch.distributed as dist
    from repro_torch.core import Fused, TwoLevel
    from repro_torch.dist import mesh2d as m2
    from repro_torch.graph import mutation_stream
    from repro_torch.graph.structure import build_view_shard
    from repro_torch.kernels.fused_superstep import kernel as fk
    from repro_torch.stream import UpdateBatch

    groups = sess.view_groups()
    info = {"batches": []}
    mine = {"batches": [], "shard_err": {}}

    def shard_check(tag):
        for sr, e in shard_kernels(torch, sess, rank).items():
            mine["shard_err"][sr] = max(mine["shard_err"].get(sr, 0.0), e)
        log(f"  rank {rank}: B1/B2 on the {tag} pair shards match plain")

    def step(label, batch, policy):
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        m2.reset_collectives()
        t0 = time.perf_counter()
        st = sess.apply_updates(batch)
        torch.cuda.synchronize()
        apply_s = time.perf_counter() - t0
        coll = dict(m2.COLLECTIVES)
        apply_peak = torch.cuda.max_memory_allocated()
        if not info["batches"]:
            shard_check("edited")
        live = sum(int(g.overlay.mask.sum()) for g in groups)
        dist.barrier()
        fk.reset_launches()
        t0 = time.perf_counter()
        m = sess.run(policy, MAX_SUPERSTEPS)
        wall = time.perf_counter() - t0
        launches = dict(fk.launches)
        mine["batches"].append(dict(
            apply_s=apply_s, apply_collectives=coll["count"],
            apply_collective_s=coll["seconds"], apply_peak=apply_peak,
            held=torch.cuda.memory_allocated(), launches=launches))
        info["batches"].append(dict(
            label=label, policy=policy.name, stats=dataclasses.asdict(st),
            live=live, metrics=m.to_dict(), wall=wall,
            collectives=m.collectives, collective_s=m.collective_s,
            update=(batch.src, batch.dst, batch.w, batch.op),
            results=[sess.result(h) for h in handles]))
        return st, live

    batches = mutation_stream(sess._csr, STREAM_BATCHES,
                              inserts_per_batch=STREAM_INSERTS,
                              deletes_per_batch=STREAM_DELETES,
                              seed=STREAM_SEED)
    for i, b in enumerate(batches):
        step(f"9a batch {i + 1}/{len(batches)}", b,
             Fused() if i % 2 == 0 else TwoLevel())
    reach = np.isfinite(sess.result(handles[-2]))
    bn = groups[0].graph.num_blocks
    src, dst = new_pairs(sess, groups[0], range(7, bn, bn // 8), 1, reach)
    _, live = step("9a overlay batch", UpdateBatch.inserts(src, dst), Fused())
    if live == 0:
        raise RuntimeError("9a: the overlay batch left no live overlay entry")
    census = {"before compaction": (torch.cuda.memory_allocated(),
                                    *cuda_census(torch))}
    row = int(np.argmin([len(r) for r in tile_rows(groups[0])]))
    src, dst = new_pairs(sess, groups[0], [row], sess.overlay_capacity + 1,
                         np.ones(sess._csr.n, dtype=bool))
    st, _ = step(f"9a overflow batch (block row {row})",
                 UpdateBatch.inserts(src, dst), TwoLevel())
    if st.compacted_views != len(groups):
        raise RuntimeError(f"9a: the overflow batch compacted "
                           f"{st.compacted_views} of {len(groups)} views")
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess.compact()
    torch.cuda.synchronize()
    mine["compact_s"] = time.perf_counter() - t0
    mine["compact_peak"] = torch.cuda.max_memory_allocated()
    mine["compact_held"] = torch.cuda.memory_allocated()
    census["after compact()"] = (mine["compact_held"], *cuda_census(torch))
    for tag, (held, seen, big) in census.items():
        log(f"  rank {rank}: {tag}: allocated {held / 1e9:.3f} GB, CUDA "
            f"tensors Python reaches {seen / 1e9:.3f} GB; of 64 MB or more "
            f"{big}")
    shard_check("compacted")
    spec = sess._mesh2d
    for g in groups:
        _, fill, normalize, _ = g.key
        ps = sess._pair_shards(g)
        fg, fp, counts = build_view_shard(
            sess._csr, BLOCK, ps.num_shards, ps.shard, fill=fill,
            normalize=normalize, device=sess.device)
        same = counts == ps.shard_pairs and all(
            torch.equal(getattr(g.graph, f), getattr(fg, f))
            for f in ("tiles", "nbr_ids", "nbr_mask")) and all(
            torch.equal(getattr(ps.local, f), getattr(fp, f))
            for f in ("src", "dst", "slot", "first", "last", "src_nnz",
                      "dst_touched", "tiles", "run_start", "chunk_start",
                      "chunk_run"))
        if not same or g.overlay.capacity:
            raise RuntimeError(f"9a rank {rank}: the compacted {g.semiring} "
                               f"slices differ from a fresh build")
        del fg, fp
    torch.cuda.empty_cache()
    log(f"  rank {rank}: compacted slices (block rows "
        f"{spec.block_range(bn, spec.layout(groups[0]))}) bit-equal to a "
        f"fresh build_view_shard of the final CSR ({sess._csr.nnz} edges)")
    info["csr_nnz"] = sess._csr.nnz
    return info, mine, handles


def mesh_serve(torch, sess, handles, rank: int):
    """Phase 9b in every rank of 8a's world: the jobs detached, phase 7's
    load (horizon and update period cut, MESH_SERVE_LOAD) served on the
    placed session under TwoLevel(), 8 supersteps a tick, at most 8
    running: the min-plus and plus-times groups grow past capacity 4 and
    the BFS (unit) view is built as a new view, as this rank's slices.
    Rank 0 holds every detached result to its plain answer
    (`check_served`).  Returns (rank 0's figures, this rank's)."""
    import torch.distributed as dist
    from repro_torch.core import TwoLevel
    from repro_torch.kernels.fused_superstep import kernel as fk
    from repro_torch.obs import LoadgenConfig, OpenLoopHarness
    from repro_torch.serve import ConcurrentServeScheduler

    for h in handles:
        sess.detach(h)
    caps0 = {g.key: g.capacity for g in sess.view_groups()}
    sched = ConcurrentServeScheduler(sess.scheduler.num_blocks,
                                     batch_budget=SERVE_MAX_RUNNING, seed=5)
    h = OpenLoopHarness(sess, sched, LoadgenConfig(**MESH_SERVE_LOAD),
                        policy=TwoLevel(), max_running=SERVE_MAX_RUNNING,
                        supersteps_per_tick=SERVE_STEPS_PER_TICK)
    runs, done = [], []
    real_run, real_detach = sess.run, sess.detach

    def run(*a, **kw):
        t0 = time.perf_counter()
        m = real_run(*a, **kw)          # ends in a host read
        runs.append((time.perf_counter() - t0, m.supersteps, m.collectives,
                     m.collective_s))
        return m

    def detach(handle):
        res = real_detach(handle)
        if rank == 0:
            done.append((handle.alg, res, sess._csr))
        return res
    sess.run, sess.detach = run, detach
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launches()
    t0 = time.perf_counter()
    try:
        s = h.run()
        torch.cuda.synchronize()
    finally:
        sess.run, sess.detach = real_run, real_detach
    wall = time.perf_counter() - t0
    mine = dict(launches=dict(fk.launches),
                peak=torch.cuda.max_memory_allocated(),
                held=torch.cuda.memory_allocated(),
                run_s=sum(r[0] for r in runs))
    info = dict(summary=s, wall=wall, most=peak_running(h), caps0=caps0,
                caps1={g.key: g.capacity for g in sess.view_groups()},
                run_s=sum(r[0] for r in runs),
                supersteps=sum(r[1] for r in runs),
                collectives=sum(r[2] for r in runs),
                collective_s=sum(r[3] for r in runs))
    if rank == 0:
        label = "9b serve on (1 x 4)"
        if not s["admitted"] == s["completed"] == s["arrivals"] > 0:
            raise RuntimeError(f"{label}: arrivals {s['arrivals']}, admitted "
                               f"{s['admitted']}, completed {s['completed']}")
        if info["most"] != SERVE_MAX_RUNNING:
            raise RuntimeError(f"{label}: at most {info['most']} requests "
                               f"ran at once, not {SERVE_MAX_RUNNING}")
        info["checked"] = check_served(done, label)
    return info, mine


def mesh_world(torch, csr, label, plan, out_dir):
    """Run one phase-8 world of ranks on the card; returns rank 0's
    figures with the phase's nvidia-smi peak and wall."""
    from repro_torch.dist.world import choose_backend, run_world
    world = 2 if plan["mesh"] == "jobs" else plan["mesh"][0] * \
        plan["mesh"][1]
    log(f"{label}: {world} ranks on {torch.cuda.device_count()} card(s) "
        f"over {choose_backend('cuda', world)}")
    t0 = time.perf_counter()
    with MemoryPoll() as mem:
        out = run_world(mesh_rank, world, device="cuda",
                        store_dir=str(out_dir / "mesh"),
                        args=(csr, plan, time.time()),
                        threads=MESH_THREADS)
    out["wall"] = time.perf_counter() - t0
    out["smi_peak_mib"] = mem.peak_mib
    return out


def report_mesh(label, out, csr, refs, views):
    """Phase 8's checks and figures of one world: every run's results
    against the phase-3 references, halo_bytes under the frontier bound,
    B1/B2 launched on every rank.  Returns the runs' B1/B2 launches
    summed over the ranks."""
    log(f"{label}: world wall {out['wall']:.3f} s (spawn, builds, runs); "
        f"rank 0 on its mesh {out['mesh_ready_s']:.1f} s after the spawn; "
        f"peak nvidia-smi memory {out['smi_peak_mib']} MiB")
    log(f"{label}: gloo all_reduce over the world, ranks lined up: " +
        ", ".join(f"{4 * n / 1e3:.0f} KB on {dev} {ms:.3f} ms"
                  for (n, dev), ms in out["collective_ms"].items()))
    for sr, pairs in out["shard_pairs"].items():
        log(f"{label}: view {sr} real pairs per block shard {list(pairs)} "
            f"(total {sum(pairs)}), pair_cap {out['pair_cap'][sr]}")
    for r, mine in enumerate(out["ranks"]):
        log(f"{label}: rank {r}: B1/B2 on its shard match plain (max |err| "
            f"{mine['shard_err']})")
        log(f"{label}: rank {r}: set-up {mine['setup_s']:.2f} s; jobs "
            f"{mine['jobs_local']}; pair tiles "
            f"{ {k: round(v / 1e9, 3) for k, v in mine['tile_bytes'].items()} }"
            f" GB, ELL rows "
            f"{ {k: round(v / 1e9, 3) for k, v in mine['ell_bytes'].items()} }"
            f" GB; held {mine['held'] / 1e9:.2f} GB after placement, build "
            f"peak {mine['build_peak'] / 1e9:.2f} GB, run peaks "
            f"{[round(x['peak'] / 1e9, 2) for x in mine['runs']]} GB")
    bound_per_step = (sum(c * out["q"] * BLOCK * 4 for c in out["capacities"])
                      + 8 * out["num_blocks"])
    totals = {sr: 0 for sr in SEMIRINGS}
    for i, run in enumerate(out["runs"]):
        m = run["metrics"]
        steps = max(1, m["supersteps"])
        tag = f"{label} {run['label']}"
        log(f"{tag}: converged={m['converged']} supersteps="
            f"{m['supersteps']} tile_loads={m['tile_loads']} "
            f"tile_pair_loads={m['tile_pair_loads']} host_syncs="
            f"{m['host_syncs']}; wall {run['wall']:.3f} s, "
            f"{1e3 * run['wall'] / steps:.3f} ms/superstep; collectives "
            f"{run['collectives'] / steps:.2f}/superstep, "
            f"{1e3 * run['collective_s'] / steps:.3f} ms/superstep of host "
            f"time ({100 * run['collective_s'] / max(run['wall'], 1e-9):.1f}%"
            f" of wall); halo_bytes {m['halo_bytes']:.0f} = "
            f"{m['halo_bytes'] / steps:.0f}/superstep (bound "
            f"{bound_per_step}/superstep)")
        if m["halo_bytes"] > steps * bound_per_step:
            raise RuntimeError(f"{tag}: halo_bytes over the frontier bound")
        if out["runs"][0]["metrics"]["supersteps"] and not (
                m["halo_bytes"] > 0 or label.startswith("8c")):
            raise RuntimeError(f"{tag}: no frontier was exchanged")
        for r, mine in enumerate(out["ranks"]):
            ln = mine["runs"][i]["launches"]
            for sr in SEMIRINGS:
                totals[sr] += ln[sr]
            wanted = (SEMIRINGS if label.startswith("8a")
                      else ("min_plus",))
            for sr in wanted:
                if ln[sr] <= 0:
                    raise RuntimeError(f"{tag}: rank {r} launched no "
                                       f"{sr} kernel")
        log(f"{tag}: B1/B2 launches per rank "
            f"{[mine['runs'][i]['launches'] for mine in out['ranks']]}")
        budget_cut = "first half" in run["label"]
        if not budget_cut:
            if not m["converged"]:
                raise RuntimeError(f"{tag}: no convergence")
            check_values(run["results"], mesh_algs(views), csr, refs, tag)
    return totals


def report_stream(out, csr):
    """Phase 9a's checks and figures from 8a's world: every rerun's
    results against Dijkstra / the power iteration on a plain application
    of the batches; per batch the apply_updates seconds (max over ranks),
    its collectives, the rerun's wall, supersteps and collectives, the
    compaction seconds and every rank's memory.  Returns the reruns' B1/B2
    launches summed over the ranks."""
    st9 = out["stream"]
    algs = mesh_algs(2)
    adj = plain_adjacency(csr)
    totals = {sr: 0 for sr in SEMIRINGS}
    for i, b in enumerate(st9["batches"]):
        per = [mine["stream"]["batches"][i] for mine in out["ranks"]]
        m = b["metrics"]
        steps = max(1, m["supersteps"])
        tag = b["label"]
        apply_s = [p["apply_s"] for p in per]
        log(f"{tag} ({b['policy']}): apply_updates {max(apply_s):.3f} s "
            f"(max over ranks; {[round(x, 3) for x in apply_s]}), "
            f"{per[0]['apply_collectives']} collectives "
            f"({1e3 * max(p['apply_collective_s'] for p in per):.1f} ms); "
            f"{b['stats']}; overlay entries live {b['live']}; rerun "
            f"converged={m['converged']} wall {b['wall']:.3f} s, supersteps "
            f"{m['supersteps']}, {1e3 * b['wall'] / steps:.3f} ms/superstep, "
            f"collectives {b['collectives'] / steps:.2f}/superstep "
            f"({100 * b['collective_s'] / max(b['wall'], 1e-9):.1f}% of "
            f"wall), tile_loads {m['tile_loads']}, tile_pair_loads "
            f"{m['tile_pair_loads']}; launches per rank "
            f"{[p['launches'] for p in per]}; apply peak / held per rank "
            f"{[round(p['apply_peak'] / 1e9, 2) for p in per]} / "
            f"{[round(p['held'] / 1e9, 2) for p in per]} GB")
        if not m["converged"]:
            raise RuntimeError(f"{tag}: no convergence")
        for r, p in enumerate(per):
            for sr in SEMIRINGS:
                if p["launches"][sr] <= 0:
                    raise RuntimeError(f"{tag}: rank {r} launched no {sr} "
                                       f"kernel")
                totals[sr] += p["launches"][sr]
        src, dst, w, op = b["update"]
        adj = plain_update(adj, types.SimpleNamespace(src=src, dst=dst, w=w,
                                                      op=op))
        g = plain_csr(adj)
        check_values(b["results"], algs, g, references(g, algs), tag)
    if adj.nnz != st9["csr_nnz"]:
        raise RuntimeError(f"9a: {st9['csr_nnz']} edges on the ranks, "
                           f"{adj.nnz} in the plain application")
    log("9a: compact() per rank " + ", ".join(
        f"{mine['stream']['compact_s']:.3f} s (peak "
        f"{mine['stream']['compact_peak'] / 1e9:.2f} GB, held "
        f"{mine['stream']['compact_held'] / 1e9:.2f} GB)"
        for mine in out["ranks"]))
    log(f"9a: launches over the reruns (all ranks) {totals}; phase 9 "
        f"nvidia-smi peak {out['smi_peak_mib_9']} MiB")
    return totals


def report_serve(out):
    """Phase 9b's figures from 8a's world (rank 0 checked the results);
    returns the B1/B2 launches summed over the ranks."""
    sv = out["serve"]
    s = sv["summary"]
    steps = max(1, sv["supersteps"])
    totals = {sr: 0 for sr in SEMIRINGS}
    for r, mine in enumerate(out["ranks"]):
        ln = mine["serve"]["launches"]
        for sr in SEMIRINGS:
            if ln[sr] <= 0:
                raise RuntimeError(f"9b: rank {r} launched no {sr} kernel")
            totals[sr] += ln[sr]
    grown = [k for k, c in sv["caps1"].items() if c > sv["caps0"].get(k, 0)]
    new = [k for k in sv["caps1"] if k not in sv["caps0"]]
    if not new or not any(k in sv["caps0"] for k in grown):
        raise RuntimeError(f"9b: capacities {sv['caps0']} -> {sv['caps1']}: "
                           f"no view grew or none was built")
    lat = s["latency_ticks"]
    n_min, n_pt, n_versions = sv["checked"]
    log(f"9b serve on (1 x 4): arrivals {s['arrivals']}, admitted "
        f"{s['admitted']}, completed {s['completed']}, at most {sv['most']} "
        f"running; ticks {s['ticks']}, supersteps {s['supersteps']}, updates "
        f"{s['updates_applied']}; latency ticks p50 {lat['p50']} p99 "
        f"{lat['p99']} max {lat['max']}; by family " + "; ".join(
            f"{f} n={x['count']} p50 {x['p50']} p99 {x['p99']}"
            for f, x in s["latency_by_family"].items()))
    log(f"9b: wall {sv['wall']:.3f} s, {1e3 * sv['wall'] / max(1, s['ticks']):.3f}"
        f" ms/tick; inside run() {sv['run_s']:.3f} s, "
        f"{1e3 * sv['run_s'] / steps:.3f} ms/superstep, collectives "
        f"{sv['collectives'] / steps:.2f}/superstep "
        f"({1e3 * sv['collective_s'] / steps:.3f} ms/superstep); capacities "
        f"{sv['caps0']} -> {sv['caps1']} (grown {grown}, new {new}); "
        f"launches {totals}; per rank peak / held "
        f"{[round(m['serve']['peak'] / 1e9, 2) for m in out['ranks']]} / "
        f"{[round(m['serve']['held'] / 1e9, 2) for m in out['ranks']]} GB, "
        f"run() s {[round(m['serve']['run_s'], 3) for m in out['ranks']]}")
    log(f"9b: {n_min} SSSP/BFS results bit-equal to scipy on the CSR they "
        f"finished on ({n_versions} CSR versions), {n_pt} PageRank/PPR "
        f"within rtol 5e-3, atol 1e-4")
    return totals


def mesh_phase(torch, csr, refs, fk, out_dir):
    """Phase 8: the multi-device engine at full size, ranks sharing the
    card over gloo.  8a: (1 x 4) blocks mesh, both views, Fused() with
    compress_halo; 8b: (2 x 2), the min-plus
    view alone, four SSSP jobs under TwoLevel(device, 8), then half the
    run, a snapshot, the rest, and the snapshot restored here onto one
    device; 8c: job mesh (2,), the same jobs under TwoLevel(), bit-equal
    to a one-device run here with the same supersteps and tile_loads.
    Returns B1/B2 launches summed over every rank and run, and the
    largest |err| of B1/B2 against the plain version on any rank's
    shard."""
    from repro_torch.core import GraphSession, TwoLevel
    from repro_torch.dist.fault import restore_session
    t_phase = time.perf_counter()
    sssp = list(sssp_ref(csr, MESH_SSSP_SOURCES).astype(np.float32))
    totals = {sr: 0 for sr in SEMIRINGS}
    worlds = [
        # 8a's TwoLevel() and Fused() runs are cut for the script's time
        # limit: 9a's reruns drive both on the same placed session
        ("8a (1 x 4)", dict(mesh=(1, MESH_RANKS), views=2, runs=[
            ("Fused() compress_halo", "Fused()", True)], stream=True,
            graph=True), refs),
        ("8b (2 x 2)", dict(mesh=(2, 2), views=1, runs=[
            ("TwoLevel(device, 8)", "TwoLevel(device, 8)", False)],
            checkpoint=("TwoLevel(device, 8)", "TwoLevel(device, 8)")),
         sssp),
        ("8c (2,) jobs", dict(mesh="jobs", views=1, runs=[
            ("TwoLevel()", "TwoLevel()", False)]), sssp)]
    outs = {}
    errs = {sr: 0.0 for sr in SEMIRINGS}
    for label, plan, want in worlds:
        out = mesh_world(torch, csr, label, plan, out_dir)
        for sr, n in report_mesh(label, out, csr, want,
                                 plan["views"]).items():
            totals[sr] += n
        for mine in out["ranks"]:
            for sr, e in list(mine["shard_err"].items()) + list(
                    mine.get("stream", {}).get("shard_err", {}).items()):
                errs[sr] = max(errs[sr], e)
        if plan.get("stream"):
            stream_totals = report_stream(out, csr)
            serve_totals = report_serve(out)
        outs[label[:2]] = out
    # one device here: 8c's reference run, then 8b's snapshot restored
    t0 = time.perf_counter()
    sess = GraphSession(csr, BLOCK, capacity=CAPACITY, seed=0)
    handles = [sess.submit(a) for a in mesh_algs(1)]
    torch.cuda.synchronize()
    log(f"8c/8b one-device session built in {time.perf_counter() - t0:.2f}"
        f" s")
    m, wall, launches, peak = drive(torch, sess, TwoLevel(), fk)
    report_run(torch, "8c one device", m, wall,
               {"min_plus": launches["min_plus"]}, peak)
    got = outs["8c"]["runs"][0]
    for k in ("supersteps", "tile_loads", "tile_pair_loads"):
        if got["metrics"][k] != m.to_dict()[k]:
            raise RuntimeError(f"8c: {k} {got['metrics'][k]} on the job "
                               f"mesh, {m.to_dict()[k]} on one device")
    for r, h in zip(got["results"], handles):
        np.testing.assert_array_equal(r, sess.result(h))
    log("8c: the job mesh equals one device bit for bit (results, "
        "supersteps, tile_loads, tile_pair_loads)")
    snap = outs["8b"]["snapshot"]
    handles = resubmit(torch, sess, handles)
    restore_session(sess, snap)
    m, wall, launches, peak = drive(torch, sess, mesh_policy(
        "TwoLevel(device, 8)"), fk)
    report_run(torch, "8b restored onto one device", m, wall,
               {"min_plus": launches["min_plus"]}, peak)
    check_results(sess, handles, csr, sssp, "8b restored onto one device")
    log(f"8b: snapshot after {outs['8b']['snapshot_supersteps']} supersteps "
        f"on (2 x 2), {m.supersteps} more on one device; the mesh's own "
        f"resumed run took "
        f"{outs['8b']['runs'][-1]['metrics']['supersteps']} more")
    del sess, handles
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phases 8-9: {time.perf_counter() - t_phase:.1f} s")
    return (totals, stream_totals, serve_totals, errs,
            [r["graph"] for r in outs["8a"]["ranks"]])


# -- phase 10: the LM serving path -------------------------------------------

BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
LM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# 10a: every architecture's smoke config, the card against the CPU
LM_SMOKE_B, LM_SMOKE_S, LM_SMOKE_DECODE, LM_SMOKE_LEN = 2, 20, 4, 32
# 10b: qwen2.5-14b at its published widths through launch.serve's path
LM_ARCH = "qwen2.5-14b"
LM_SERVE_ARGV = ["--arch", LM_ARCH, "--streams", "4", "--requests", "16",
                 "--groups", "8", "--batch-budget", "8", "--prompt-len",
                 "2048", "--steps", "32", "--seed", "0", "--device", "cuda"]
LM_CHECKED_ROWS = 2            # sequences held to forward_train
# bars of 10b's decode steps, as a share of the logits' standard deviation
# (the first run on an H100: 0.109 and 0.101).  bf16 rounding departs by
# one ulp at layer 0 (a decode's [8, 5120] GEMMs round otherwise than the
# forward's [4160, 5120]) and accumulates, without a jump, to 3% of the
# hidden state at layer 47; a fault of the cache path (a slot, a
# position, a head) moves the logits by whole standard deviations.
LM_DECODE_BAR = 0.25           # decode steps against forward_train
LM_PLAIN_BAR = 0.25            # the served bf16 logits against float32
# 10c: the full widths in float32 at a cut depth
LM_F32_LAYERS, LM_F32_B, LM_F32_PROMPT, LM_F32_DECODE = 2, 2, 600, 8


class Bars:
    """Collects the phase's checks, so one run reports every figure; the
    phase raises at its end if any check failed."""

    def __init__(self):
        self.failed = []

    def check(self, ok: bool, what: str) -> None:
        log(f"  {'ok  ' if ok else 'FAIL'} {what}")
        if not ok:
            self.failed.append(what)

    def raise_if_failed(self, phase: str) -> None:
        if self.failed:
            raise RuntimeError(f"{phase}: {len(self.failed)} check(s) "
                               f"failed: {self.failed}")


def _within(got, want, tol: float) -> tuple:
    """(allclose at rtol = atol = tol, max |got - want|), on the CPU in
    float32."""
    g, w = got.float().cpu(), want.float().cpu()
    ok = bool(((g - w).abs() <= tol + tol * w.abs()).all()) and \
        bool(g.isfinite().all())
    return ok, float((g - w).abs().max())


def _lm_inputs(torch, cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape).astype(
        np.int32))
    pe = None
    if cfg.patch_prefix:
        pe = torch.from_numpy(rng.standard_normal(
            (b, cfg.patch_prefix, cfg.d_model)).astype(np.float32))
    return toks, pe


def _lm_steps(torch, model, toks, pe, s):
    """forward_train over all of toks, then prefill of s tokens and a
    decode step for each token after: {label: logits}, the final cache."""
    dev = model.device

    def on(t):
        return None if t is None else t.to(dev)
    out = {}
    with torch.inference_mode():
        out["forward_train"] = model.forward_train(on(toks), on(pe))[0]
        cache = model.init_cache(toks.shape[0], LM_SMOKE_LEN +
                                 model.cfg.patch_prefix)
        out["prefill"], cache = model.prefill(on(toks[:, :s]), cache, on(pe))
        for j in range(toks.shape[1] - s):
            out[f"decode {j}"], cache = model.decode_step(
                on(toks[:, s + j:s + j + 1]), cache)
    return out, cache


def _block_walk(torch, cpu, gpu, toks, pe, s, bars, label):
    """bf16, block by block: each block on the card fed the CPU run's own
    input and cache (forward, prefill, each decode step), its output and
    cache held at the bf16 bar.  Returns the largest |difference|."""
    from repro_torch.models import model as TM
    cfg = cpu.cfg
    b, worst = toks.shape[0], 0.0
    caches = [m.init_cache(b, LM_SMOKE_LEN + cfg.patch_prefix)["layers"]
              for m in (cpu, gpu)]
    steps = [("forward", toks, pe, None, None),
             ("prefill", toks[:, :s], pe, caches, 0)]
    steps += [(f"decode {j}", toks[:, s + j:s + j + 1], None, caches,
               s + cfg.patch_prefix + j) for j in range(toks.shape[1] - s)]
    with torch.inference_mode():
        for what, tk, p, cc, pos0 in steps:
            x = cpu._embed(tk, p)
            n = x.shape[1]
            pos = (torch.arange(n, dtype=torch.int32) + (pos0 or 0)
                   ).expand(b, n)
            for i, (bc, bg) in enumerate(zip(cpu.blocks, gpu.blocks)):
                c_c = None if cc is None else cc[0][i]
                c_g = None if cc is None else cc[1][i]
                y, _, _, _ = TM.apply_block(bc.kind, x, bc, cfg, c_c, pos,
                                            pos0)
                yg, _, _, _ = TM.apply_block(bg.kind, x.to(gpu.device), bg,
                                             cfg, c_g, pos.to(gpu.device),
                                             pos0)
                ok, err = _within(yg, y, LM_TOL["bfloat16"])
                worst = max(worst, err)
                if not ok:
                    bars.check(False, f"10a {label} {what} block {i}: max "
                                      f"|d| {err:.3e}")
                if cc is not None:
                    for k in c_c:
                        ok, err = _within(c_g[k], c_c[k], LM_TOL["bfloat16"])
                        worst = max(worst, err)
                        if not ok:
                            bars.check(False, f"10a {label} {what} block {i}"
                                              f" cache {k}: {err:.3e}")
                        c_g[k].copy_(c_c[k])
                x = y
    return worst


def lm_smoke_phase(torch, bars) -> dict:
    """10a: every architecture at its smoke size, one seeded CPU init
    copied to the card.  float32 (TF32 off): forward_train, prefill and
    four decode steps, logits and the final cache at rtol = atol = 1e-4.
    bf16: each block fed the CPU's own input and cache at 2e-2 (a bf16
    op that differs on CUDA beyond its rounding shows there), and the
    whole model's logits at 2e-2 or, where the random smoke model
    amplifies last-bit differences past that, no further than the CPU
    run's own logits move under a one-ulp change of one embedding
    weight."""
    from repro_torch import configs
    from repro_torch.kernels.common import resolve_device
    from repro_torch.models import LM
    card = resolve_device(None)
    figures = {}
    t_phase = time.perf_counter()
    for name in configs.ARCH_NAMES:
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            cfg = dataclasses.replace(configs.get_smoke(name),
                                      param_dtype=dtype)
            cpu = LM(cfg, device="cpu", seed=0)
            gpu = LM(cfg, device="meta")
            gpu.load_state_dict({k: v.to(card) for k, v in
                                 cpu.state_dict().items()}, assign=True)
            toks, pe = _lm_inputs(torch, cfg, LM_SMOKE_B,
                                  LM_SMOKE_S + LM_SMOKE_DECODE)
            want, c_cpu = _lm_steps(torch, cpu, toks, pe, LM_SMOKE_S)
            got, c_gpu = _lm_steps(torch, gpu, toks, pe, LM_SMOKE_S)
            label = f"{name} {dtype}"
            tol = LM_TOL[dtype]
            errs = {k: _within(got[k], want[k], tol) for k in want}
            worst = max(e for _, e in errs.values())
            if dtype == "float32":
                for k, (ok, err) in errs.items():
                    if not ok:
                        bars.check(False, f"10a {label} {k}: max |d| "
                                          f"{err:.3e} (bar {tol})")
                for i, (lc, lg) in enumerate(zip(c_cpu["layers"],
                                                 c_gpu["layers"])):
                    for k in lc:
                        ok, err = _within(lg[k], lc[k], tol)
                        worst = max(worst, err)
                        if not ok:
                            bars.check(False, f"10a {label} cache layer {i}"
                                              f" {k}: {err:.3e}")
                fig = {"max_abs_err": worst}
            else:
                block_err = _block_walk(torch, cpu, gpu, toks, pe,
                                        LM_SMOKE_S, bars, label)
                e2e_ok = all(ok for ok, _ in errs.values())
                spread = None
                if not e2e_ok:
                    emb = cpu.embed.data
                    tok = int(toks[0, 3, 0] if cfg.n_codebooks else toks[0, 3])
                    row = emb[0] if cfg.n_codebooks else emb
                    orig = row[tok, 5].clone()
                    row[tok, 5] = (orig.view(torch.int16) + 1).view(
                        torch.bfloat16)
                    with torch.inference_mode():
                        bumped = cpu.forward_train(toks, pe)[0]
                    row[tok, 5] = orig
                    spread = _within(bumped, want["forward_train"], 0.0)[1]
                    e2e_ok = worst <= spread
                bars.check(e2e_ok, f"10a {label} end to end: max |d| "
                                   f"{worst:.3e} (bar {tol}" + (
                                       "" if spread is None else
                                       f"; beyond it, the CPU's own one-ulp "
                                       f"spread {spread:.3e}") + ")")
                fig = {"max_abs_err": worst, "block_max_abs_err": block_err,
                       "one_ulp_spread": spread}
            fig["s"] = round(time.perf_counter() - t0, 3)
            figures[label] = fig
            log(f"10a {label}: max |d| {worst:.3e} in {fig['s']:.2f} s")
            del cpu, gpu
    log(f"10a: {len(figures)} cases in {time.perf_counter() - t_phase:.1f} s")
    return figures


class ServeObserver:
    """Times each batch of launch.serve's loop on the card (a sync at each
    hook) and keeps the first batch's logits of LM_CHECKED_ROWS rows."""

    def __init__(self, torch):
        self.torch = torch
        self.batches = []
        self.first = None

    def _now(self):
        self.torch.cuda.synchronize()
        return time.perf_counter()

    def start(self, admitted, prompts):
        self.cur = {"b": len(admitted), "t": [self._now()]}
        if self.first is None:
            self.first = {"prompts": prompts[:LM_CHECKED_ROWS].clone(),
                          "logits": []}

    def logits(self, i, logits):
        self.cur["t"].append(self._now())
        if len(self.batches) == 0:
            self.first["logits"].append(
                logits[:LM_CHECKED_ROWS, -1].float().clone())

    def end(self, tokens):
        t = self.cur["t"]
        self.cur.update(prefill_ms=1e3 * (t[1] - t[0]),
                        decode_ms=[1e3 * (b - a) for a, b in
                                   zip(t[1:], t[2:])])
        if len(self.batches) == 0:
            self.first["tokens"] = tokens[:LM_CHECKED_ROWS].clone()
        self.batches.append(self.cur)


def _first_departing_layers(torch, model, seq, pos):
    """Diagnostic for a step outside the bar: each layer's output at
    position `pos` from forward_train over `seq` and from a prefill of the
    tokens before it plus one decode step, as max |d| over max |h|."""
    from repro_torch.models import model as TM
    taps = {"train": [], "decode": []}
    orig, mode = TM.apply_block, {"k": "train"}

    def tap(kind, x, p, cfg, cache, positions, pos0, x32=None):
        out = orig(kind, x, p, cfg, cache, positions, pos0, x32)
        if mode["k"] in taps:
            taps[mode["k"]].append(out[0][:, pos if mode["k"] == "train"
                                          else -1].float().clone())
        return out
    TM.apply_block = tap
    try:
        with torch.inference_mode():
            model.forward_train(seq)
            cache = model.init_cache(seq.shape[0], pos + 8)
            mode["k"] = "prefill"
            model.prefill(seq[:, :pos], cache)
            mode["k"] = "decode"
            model.decode_step(seq[:, pos:pos + 1], cache)
    finally:
        TM.apply_block = orig
    for i, (a, b) in enumerate(zip(taps["train"], taps["decode"])):
        log(f"    layer {i}: max |d| / max |h| = "
            f"{float((a - b).abs().max() / a.abs().max()):.3e}")


def lm_serve_phase(torch, trace: bool, bars) -> dict:
    """10b: qwen2.5-14b at its published widths, all 48 layers, bf16,
    served by repro_torch.launch.serve's own functions: 16 requests from 4
    streams over 8 groups, batch budget 8, prompts of 2048 tokens, 32
    greedy decode steps.  The first batch's first two sequences are held
    to the port's own no-cache forward_train over the same tokens at the
    bf16 bar, and the first of them to the plain float32 forward."""
    from repro_torch.launch import serve as lserve
    from repro_torch.models.ref import plain_forward
    args = lserve.build_parser().parse_args(LM_SERVE_ARGV)
    lserve.set_numerics()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = lserve.build_engine(args, args.device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model, cfg = engine.model, engine.model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    non_embed = n_params - cfg.vocab_size * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    log(f"10b {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} query / {cfg.n_kv_heads} KV heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocabulary {cfg.vocab_size}: "
        f"{n_params:,} parameters ({non_embed:,} outside embed and head), "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, drawn on the card "
        f"in {init_s:.2f} s")
    rng = np.random.default_rng(args.seed)
    sched = lserve.make_scheduler(args, rng)
    obs = ServeObserver(torch)
    t0 = time.perf_counter()
    served = lserve.serve(engine, sched, rng, prompt_len=args.prompt_len,
                          steps=args.steps, observer=obs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    bars.check(served == args.requests,
               f"10b served {served} of {args.requests} requests")
    b, s, n = obs.batches[0]["b"], args.prompt_len, args.steps
    prefill_ms = [x["prefill_ms"] for x in obs.batches]
    decode_ms = [statistics.median(x["decode_ms"]) for x in obs.batches]
    tokens = b * s
    attn_flops = 4 * b * cfg.n_heads * cfg.head_dim * cfg.n_layers * (
        s * (s + 1) // 2)
    prefill_bound = 2 * non_embed * tokens / BF16_FLOPS
    prefill_bound_attn = (2 * non_embed * tokens + attn_flops) / BF16_FLOPS
    kv_bytes = (2 * cfg.n_layers * b * cfg.n_kv_heads * cfg.head_dim * 2
                * (s + n // 2))
    weight_bytes = (n_params - cfg.vocab_size * cfg.d_model) * 2
    decode_bound = (weight_bytes + kv_bytes) / HBM_BYTES_PER_S
    cache_gb = 2 * cfg.n_layers * b * engine.max_len * cfg.n_kv_heads * \
        cfg.head_dim * 2 / 1e9
    log(f"10b served {served} requests in {len(obs.batches)} batches of "
        f"{[x['b'] for x in obs.batches]}, KV max_len {engine.max_len} "
        f"({cache_gb:.2f} GB a batch): wall {wall:.3f} s, "
        f"{served * n / wall:.1f} generated tokens/s")
    log(f"10b prefill of {b} x {s} tokens: {prefill_ms} ms (bound "
        f"{1e3 * prefill_bound:.1f} ms: 2 x {non_embed / 1e9:.2f} G "
        f"parameters x {tokens} tokens at {BF16_FLOPS / 1e12:.0f} TFLOP/s; "
        f"{1e3 * prefill_bound_attn:.1f} ms with the causal attention's "
        f"{attn_flops / 1e12:.1f} TFLOP)")
    log(f"10b decode step, batch {b}: median {decode_ms} ms (bound "
        f"{1e3 * decode_bound:.2f} ms: {weight_bytes / 1e9:.2f} GB of "
        f"weights and head + {kv_bytes / 1e9:.2f} GB of cache at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); per-step range "
        f"{min(min(x['decode_ms']) for x in obs.batches):.3f}-"
        f"{max(max(x['decode_ms']) for x in obs.batches):.3f} ms")
    # beside the hand-worked bounds, launch.analytic's count of the cells
    from repro_torch.launch import analytic
    from repro_torch.models.config import ShapeConfig
    an_pre = analytic.cell_flops(cfg, ShapeConfig(
        "10b_prefill", "prefill", s, b))["fwd_flops"]
    an_dec = analytic.cell_flops(cfg, ShapeConfig(
        "10b_decode", "decode", s + n // 2, b))["fwd_flops"]
    log(f"10b launch.analytic: prefill {an_pre / 1e12:.2f} TFLOP "
        f"({1e3 * an_pre / BF16_FLOPS:.1f} ms at {BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s, its chunked attention's kv blocks and the head counted) "
        f"against the hand-worked {(2 * non_embed * tokens + attn_flops) / 1e12:.2f}"
        f" TFLOP; a decode step {an_dec / 1e9:.1f} GFLOP "
        f"({1e3 * an_dec / BF16_FLOPS:.3f} ms, under the bytes' "
        f"{1e3 * decode_bound:.2f} ms)")
    log(f"10b peak device memory {peak:.2f} GB")

    # the cache path against the port's own no-cache forward
    first = obs.first
    seq = torch.cat([first["prompts"], first["tokens"]], dim=1)
    with torch.inference_mode():
        full = model.forward_train(seq)[0]
    std = float(full.float().std())
    ok, pre_err = _within(first["logits"][0], full[:, s - 1],
                          LM_TOL["bfloat16"])
    bars.check(ok, f"10b prefill's last logits against forward_train "
                   f"(the same chunks): max |d| {pre_err:.3e} (bar "
                   f"{LM_TOL['bfloat16']})")
    errs = [_within(lg, full[:, s - 1 + j], 0.0)[1]
            for j, lg in enumerate(first["logits"]) if j > 0]
    dec_err = max(errs)
    if dec_err > LM_DECODE_BAR * std:
        log("  10b a decode step outside the bar: layer by layer")
        _first_departing_layers(torch, model, seq[:1],
                                s - 1 + 1 + int(np.argmax(errs)))
    bars.check(dec_err <= LM_DECODE_BAR * std,
               f"10b {n} decode steps x {LM_CHECKED_ROWS} rows against "
               f"forward_train: max |d| {dec_err:.4f} = "
               f"{dec_err / std:.4f} of the logits' std {std:.4f} (bar "
               f"{LM_DECODE_BAR}); within 2e-2 at "
               f"{sum(e <= LM_TOL['bfloat16'] for e in errs)} of {n} steps")
    del full

    # the plain float32 forward of the first sequence, one layer at a time
    t0 = time.perf_counter()
    plain = plain_forward(model, seq[:1])[0]
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    served_logits = torch.stack([lg[0] for lg in first["logits"]])
    d = (served_logits.float() - plain[s - 1:s - 1 + len(first["logits"])]
         ).abs()
    plain_err = float(d.max())
    bars.check(plain_err <= LM_PLAIN_BAR * std,
               f"10b bf16 served logits against the plain float32 forward "
               f"({plain_s:.2f} s): max |d| {plain_err:.4f}, "
               f"{plain_err / std:.4f} of the logits' std {std:.4f} (bar "
               f"{LM_PLAIN_BAR}); mean |d| {float(d.mean()):.5f}")
    del plain, seq, d
    figures = {
        "arch": LM_ARCH, "n_params": n_params, "non_embedding": non_embed,
        "layers": cfg.n_layers, "init_s": init_s, "served": served,
        "batches": [x["b"] for x in obs.batches], "prompt_len": s,
        "decode_steps": n, "wall_s": wall,
        "tokens_per_s": served * n / wall,
        "prefill_ms": prefill_ms, "prefill_bound_ms": 1e3 * prefill_bound,
        "prefill_bound_with_attention_ms": 1e3 * prefill_bound_attn,
        "decode_ms_median": decode_ms, "decode_bound_ms": 1e3 * decode_bound,
        "analytic_flops": {"prefill": an_pre, "decode": an_dec},
        "peak_gb": peak, "prefill_vs_forward_max_abs_err": pre_err,
        "decode_vs_forward_max_abs_err": dec_err,
        "vs_plain_f32_max_abs_err": plain_err, "logits_std": std,
        "vs_plain_f32_ratio_to_std": plain_err / std}

    # torch ops a decode step, and (--trace) its device-time breakdown
    cache = engine.new_cache(b)
    tok = torch.zeros((b, 16), dtype=torch.int32, device=model.device)
    engine.prefill(tok, cache)
    step = tok[:, :1]
    engine.decode(step, cache)
    with OpCount() as ops:
        engine.decode(step, cache)
    figures["ops_per_decode_step"] = ops.n
    log(f"10b torch ops a decode step: {ops.n} "
        f"({ops.n / cfg.n_layers:.1f} a layer)")
    if trace:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.decode(step, cache)
            torch.cuda.synchronize()
            wall_step = time.perf_counter() - t0
        rows = kernel_rows(prof)
        busy = sum(r[0] for r in rows) / 1e3
        log(f"10b traced decode step: wall {1e3 * wall_step:.3f} ms, device "
            f"busy {busy:.3f} ms = {100 * busy / (1e3 * wall_step):.1f}%")
        for dev_us, count, key in rows[:15]:
            log(f"  {dev_us / 1e3:9.3f} ms  {count:6d} calls  {key[:90]}")
        figures["traced_decode"] = {"wall_ms": 1e3 * wall_step,
                                    "busy_ms": busy}
        # one prefill of a batch of 8 x 2048, on a fresh cache
        prompts = torch.zeros((b, s), dtype=torch.int32, device=model.device)
        cache2 = engine.new_cache(b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.prefill(prompts, cache2)
            torch.cuda.synchronize()
            wall_pre = time.perf_counter() - t0
        rows = kernel_rows(prof)
        busy = sum(r[0] for r in rows) / 1e3
        log(f"10b traced prefill of {b} x {s}: wall {1e3 * wall_pre:.1f} ms,"
            f" device busy {busy:.1f} ms = {100 * busy / (1e3 * wall_pre):.1f}%")
        for dev_us, count, key in rows[:15]:
            log(f"  {dev_us / 1e3:9.3f} ms  {count:6d} calls  {key[:90]}")
        figures["traced_prefill"] = {"wall_ms": 1e3 * wall_pre,
                                     "busy_ms": busy}
        del cache2, prompts
    del cache, engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return figures


def lm_f32_phase(torch, bars) -> dict:
    """10c: qwen2.5-14b's published widths in float32 cut to 2 layers:
    prefill of 600 tokens (two q chunks, the second padded) and 8 decode
    steps on given tokens through the ServeEngine, against the plain
    float32 forward over the same tokens at rtol = atol = 1e-4."""
    from repro_torch import configs
    from repro_torch.models import LM
    from repro_torch.models.ref import plain_forward
    from repro_torch.serve import ServeEngine
    cfg = dataclasses.replace(configs.get(LM_ARCH), param_dtype="float32",
                              n_layers=LM_F32_LAYERS)
    t0 = time.perf_counter()
    model = LM(cfg, device=None, seed=1)
    n_params = sum(p.numel() for p in model.parameters())
    toks, _ = _lm_inputs(torch, cfg, LM_F32_B,
                         LM_F32_PROMPT + LM_F32_DECODE + 1, seed=2)
    toks = toks.to(model.device)
    # prefill, then decode steps on the given tokens, through the engine
    eng = ServeEngine(model, max_len=LM_F32_PROMPT + LM_F32_DECODE + 8)
    cache = eng.new_cache(LM_F32_B)
    steps = [eng.prefill(toks[:, :LM_F32_PROMPT], cache)[0][:, -1]]
    for j in range(LM_F32_DECODE):
        steps.append(eng.decode(
            toks[:, LM_F32_PROMPT + j:LM_F32_PROMPT + j + 1], cache)[0][:, -1])
    plain = plain_forward(model, toks)
    worst, oks = 0.0, []
    for j, lg in enumerate(steps):
        ok, err = _within(lg, plain[:, LM_F32_PROMPT - 1 + j], 1e-4)
        worst = max(worst, err)
        oks.append(ok)
    bars.check(all(oks),
               f"10c {LM_F32_LAYERS} layers in float32 ({n_params:,} "
               f"parameters): prefill of {LM_F32_B} x {LM_F32_PROMPT} and "
               f"{LM_F32_DECODE} decode steps against the plain forward, "
               f"max |d| {worst:.3e} (bar 1e-4), "
               f"{time.perf_counter() - t0:.2f} s")
    del model, plain, cache
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": LM_F32_LAYERS, "n_params": n_params,
            "max_abs_err": worst}


def lm_phase(torch, trace: bool) -> dict:
    """Phase 10: 10a, 10b, 10c; raises at its end if any check failed."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bars = Bars()
    t0 = time.perf_counter()
    out = {"smoke": lm_smoke_phase(torch, bars)}
    out["serve"] = lm_serve_phase(torch, trace, bars)
    out["f32_depth"] = lm_f32_phase(torch, bars)
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 10 in {out['phase_s']:.1f} s")
    bars.raise_if_failed("phase 10")
    return out


# -- phase 11: LM training ----------------------------------------------------

#: the device of phases 11c and 12 (a CPU rehearsal of their control
#: flow sets "cpu")
CARD = "cuda"
TRAIN_ARCH = "minicpm-2b"
# 11a: every architecture's smoke config, one train step card against CPU
TRAIN_SMOKE_B, TRAIN_SMOKE_S, TRAIN_SMOKE_LR = 4, 20, 3e-4
TRAIN_TOL = {"loss": 1e-5, "grad": 1e-4, "param": 1e-5, "bf16_loss": 2e-2}
# every gradient leaf is held at 1e-4 of its largest entry plus 1e-7 of
# the model's largest (about one float32 ulp of it: xLSTM's input-gate
# biases, which the stabilizer cancels to rounding noise of ~1e-7 against
# ~18, first run on an H100).  The first AdamW step moves a weight by
# lr x g/(|g| + eps), g the step's clipped gradient: where |g| is near eps
# or its sign differs between card and CPU, gradients within their bar
# still move the weight differently.  So each stepped weight is held to
# 1e-5 plus lr x the difference of the two sides' AdamW directions, read
# from each side's own moments (mu, nu), which are held to the gradient
# bar themselves
TRAIN_NOISE_FLOOR = 1e-7
# 11b: minicpm-2b at its published widths, launch.train's AdamW (WSD)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 2048, 6
TRAIN_PEAK_CAP = 75e9          # above it the batch is halved (and said so)
# 11c: the restart loop at the same widths, cut to 2 layers, in a child
# process: cuBLAS reads its workspace setting once, when CUDA starts, and
# the deterministic one slows the other phases' GEMMs
TRAIN_RESTART_LAYERS, TRAIN_RESTART_STEPS = 2, 4
TRAIN_SAVE_EVERY, TRAIN_FAIL_AT = 2, 3
RESTART_CUBLAS = ":4096:8"
RESTART_TAG = "11c-result: "


def _train_batch(torch, cfg, b, s, seed=0):
    toks, pe = _lm_inputs(torch, cfg, b, s, seed)
    batch = {"tokens": toks}
    if pe is not None:
        batch["patch_embeds"] = pe.to(torch.bfloat16)
    return batch


def _loss_grads(torch, model, batch):
    """(loss, {name: grad}) of one batch on the model's device."""
    batch = {k: v.to(model.device) for k, v in batch.items()}
    for p in model.parameters():
        p.grad = None
    loss = model.loss(batch)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return loss.detach(), grads


def _one_step(torch, model, batch, lr):
    """One make_train_step step with accum_steps=2 from a fresh state:
    (loss, grad_norm, lr, {name: stepped parameter}, {name: mu},
    {name: AdamW direction (mu/c1) / (sqrt(nu/c2) + eps)}), on the CPU."""
    from repro_torch.train import AdamWConfig, make_init_state, \
        make_train_step
    from repro_torch.tree import leaves, members
    opt = AdamWConfig(peak_lr=lr, warmup_steps=1, total_steps=10)
    state = make_init_state(model, opt)()
    step = make_train_step(model, opt, accum_steps=2)
    state, m = step(state, {k: v.to(model.device) for k, v in batch.items()})
    assert state["opt"]["step"] == 1
    names = {id(p): n for n, p in model.named_parameters()}
    mus, dirs = {}, {}
    for lp, lm, ln in zip(leaves(state["params"]), leaves(state["opt"]["mu"]),
                          leaves(state["opt"]["nu"])):
        for p, mu, nu in zip(members(lp), members(lm), members(ln)):
            mu, nu = mu.float().cpu(), nu.float().cpu()
            mus[names[id(p)]] = mu
            dirs[names[id(p)]] = (mu / (1 - opt.b1)) / (
                torch.sqrt(nu / (1 - opt.b2)) + opt.eps)
    return (float(m["loss"]), float(m["grad_norm"]), float(m["lr"]),
            {n: p.detach().float().cpu() for n, p in
             model.named_parameters()}, mus, dirs)


def _leaf_bars(grads: dict) -> dict:
    """{name: 1e-4 of the leaf's largest |entry| + TRAIN_NOISE_FLOOR of the
    model's largest}."""
    top = max(float(g.float().abs().max()) for g in grads.values())
    return {n: TRAIN_TOL["grad"] * float(g.float().abs().max())
            + TRAIN_NOISE_FLOOR * top for n, g in grads.items()}


def _hold_step(torch, bars, label, err, gc, gg, sc, sg) -> dict:
    """11a's bars on one float32 model, CPU against card: every gradient
    leaf ({name: tensor}, gc / gg) within 1e-4 of its largest entry plus
    the floor; one make_train_step step's results (`_one_step`'s tuples,
    sc / sg): loss at 1e-5, the lr equal, mu at the gradient bar, each
    stepped weight at 1e-5 plus lr x the two sides' AdamW directions'
    difference.  `err` is the loss's |d|.  Returns the figures."""
    bar = _leaf_bars(gc)
    worst = 0.0
    for n, g in gc.items():
        e = float((gg[n].float().cpu() - g.float()).abs().max())
        worst = max(worst, e / max(bar[n], 1e-30))
        if e > bar[n]:
            bars.check(False, f"{label} grad {n}: |d| "
                              f"{e:.3e} > {bar[n]:.3e}")
    ok_l, e_l = _within(torch.tensor(sg[0]), torch.tensor(sc[0]),
                        TRAIN_TOL["loss"])
    bars.check(sg[2] == sc[2], f"{label} step lr "
                               f"{sg[2]!r} against {sc[2]!r}")
    # the step's accumulated gradient (in mu) at the gradient bar
    mu_bar = _leaf_bars(sc[4])
    mu_worst = 0.0
    for n, mu in sc[4].items():
        e = float((sg[4][n] - mu).abs().max())
        mu_worst = max(mu_worst, e / max(mu_bar[n], 1e-30))
        if e > mu_bar[n]:
            bars.check(False, f"{label} step mu {n}: |d| "
                              f"{e:.3e} > {mu_bar[n]:.3e}")
    lr = sc[2]
    p_worst, n_apart, n_flip, a_worst, a_over = 0.0, 0, 0, 0.0, 0.0
    for n, p in sc[3].items():
        d = (sg[3][n] - p).abs()
        base = TRAIN_TOL["param"] * (1 + p.abs())
        spread = lr * (sg[5][n] - sc[5][n]).abs()
        apart = spread > TRAIN_TOL["param"]
        n_apart += int(apart.sum())
        n_flip += int((torch.sign(sg[4][n]) !=
                       torch.sign(sc[4][n])).sum())
        p_worst = max(p_worst, float(
            torch.where(apart, 0.0, d).max()))
        if bool(apart.any()):
            a_worst = max(a_worst, float(d[apart].max()))
            a_over = max(a_over, float(
                (d - spread)[apart].max()))
        if not bool((d <= base + spread).all()):
            bars.check(False, f"{label} stepped {n}: |d| "
                              f"{float(d.max()):.3e} beyond "
                              f"1e-5 + lr x direction spread")
    bars.check(ok_l and worst <= 1.0 and mu_worst <= 1.0,
               f"{label}: loss |d| {err:.3e}, grads at "
               f"{worst:.3f} of their bars, step loss |d| "
               f"{e_l:.3e}, step mu at {mu_worst:.3f} of the "
               f"gradient bar, stepped params max |d| "
               f"{p_worst:.3e} (bar 1e-5) where the two AdamW "
               f"directions agree to 1e-5/lr; {n_apart} weights "
               f"where they differ more ({n_flip} step "
               f"gradients of opposite sign): max |d| "
               f"{a_worst:.3e}, at most {a_over:.3e} beyond "
               f"lr x the direction difference (bar 1e-5), "
               f"grad_norm {sg[1]:.5f} / {sc[1]:.5f}")
    return dict(loss_err=err, grad_share_of_bar=worst,
                mu_share_of_bar=mu_worst, param_err=p_worst,
                direction_apart=n_apart, sign_flips=n_flip,
                apart_param_err=a_worst, apart_beyond_spread=a_over)


def train_smoke_phase(torch, bars) -> dict:
    """11a: every architecture at its smoke size, one seeded CPU init
    copied to the card: LM.loss, every gradient and one make_train_step
    step with accum_steps=2.  float32 (TF32 off): loss at 1e-5, each
    gradient leaf and the step's mu within 1e-4 of its largest entry
    (plus the floor above), the stepped parameters at 1e-5 plus lr x the
    difference of the two sides' AdamW directions; bf16: the loss at
    2e-2."""
    from repro_torch import configs
    from repro_torch.kernels.common import resolve_device
    from repro_torch.models import LM
    card = resolve_device(None)
    figures = {}
    for name in configs.ARCH_NAMES:
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            cfg = dataclasses.replace(configs.get_smoke(name),
                                      param_dtype=dtype)
            cpu = LM(cfg, device="cpu", seed=0)
            gpu = LM(cfg, device="meta")
            gpu.load_state_dict({k: v.to(card, copy=True) for k, v in
                                 cpu.state_dict().items()}, assign=True)
            batch = _train_batch(torch, cfg, TRAIN_SMOKE_B, TRAIN_SMOKE_S)
            label = f"{name} {dtype}"
            lc, gc = _loss_grads(torch, cpu, batch)
            lg, gg = _loss_grads(torch, gpu, batch)
            fig = {"loss_cpu": float(lc), "loss_card": float(lg)}
            if dtype == "bfloat16":
                ok, err = _within(lg, lc, TRAIN_TOL["bf16_loss"])
                bars.check(ok, f"11a {label} loss {float(lg):.5f} against "
                               f"{float(lc):.5f}: |d| {err:.3e} (bar 2e-2)")
                fig["loss_err"] = err
            else:
                ok, err = _within(lg, lc, TRAIN_TOL["loss"])
                bars.check(ok, f"11a {label} loss: |d| {err:.3e} (bar 1e-5)")
                fig.update(_hold_step(torch, bars, f"11a {label}", err, gc, gg,
                                      _one_step(torch, cpu, batch,
                                                TRAIN_SMOKE_LR),
                                      _one_step(torch, gpu, batch,
                                                TRAIN_SMOKE_LR)))
            fig["s"] = time.perf_counter() - t0
            figures[label] = fig
            del cpu, gpu
    return figures


def _state_gb(model, grads_dtype_bytes: int) -> dict:
    n = sum(p.numel() for p in model.parameters())
    pb = sum(p.numel() * p.element_size() for p in model.parameters())
    return {"params_gb": pb / 1e9, "grads_gb": n * grads_dtype_bytes / 1e9,
            "moments_gb": 2 * 4 * n / 1e9}


def _train_bound(cfg, n_params, b, s) -> dict:
    """The least time a step can take at 989 TFLOP/s bf16: 6 x parameters
    x tokens for the weights, 3 x the causal attention's forward FLOPs,
    and with remat the recomputed forward (2 x non-embedding parameters
    x tokens + the attention forward again)."""
    tokens = b * s
    weights = 6 * n_params * tokens
    attn_fwd = 4 * b * cfg.n_heads * cfg.head_dim * cfg.n_layers * (
        s * (s + 1) // 2)
    non_embed = n_params - cfg.vocab_size * cfg.d_model
    remat = 2 * non_embed * tokens + attn_fwd
    # beside it, launch.analytic's count of the same cell (3 x forward
    # with the chunked attention's kv blocks, plus the optimizer update)
    from repro_torch.launch import analytic
    from repro_torch.models.config import ShapeConfig
    an = analytic.cell_flops(cfg, ShapeConfig("11b", "train", s, b))
    return {"flops": weights + 3 * attn_fwd,
            "bound_s": (weights + 3 * attn_fwd) / BF16_FLOPS,
            "bound_remat_s": (weights + 3 * attn_fwd + remat) / BF16_FLOPS,
            "analytic_flops": an["hlo_est_flops"],
            "analytic_bound_s": an["hlo_est_flops"] / BF16_FLOPS}


def _timed(torch, fn, reps=1):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps, out


def _train_components(torch, model, batch, opt_cfg, opt_state) -> dict:
    """Device-synced host times of one step's parts at 11b's widths: the
    loss forward, its backward (the recomputed forward inside), AdamW over
    the whole state, one layer's attention forward and forward+backward,
    and the chunked cross-entropy forward+backward."""
    from repro_torch.models import layers as L
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.tree import Stacked, tree_map
    cfg = model.cfg
    out = {}
    for p in model.parameters():
        p.grad = None
    out["loss_forward_s"], loss = _timed(torch, lambda: model.loss(batch))
    out["backward_s"], _ = _timed(torch, loss.backward)
    params = model.param_tree()

    def grad(p):
        return Stacked(grad(t) for t in p) if isinstance(p, Stacked) \
            else p.grad
    grads = tree_map(grad, params)
    out["adamw_s"], _ = _timed(
        torch, lambda: adamw_update(opt_cfg, grads, opt_state, params))
    del grads
    for p in model.parameters():
        p.grad = None
    b, s = batch["tokens"].shape[:2]
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((b, s, cfg.n_heads, cfg.head_dim), generator=gen,
                           device=dev, dtype=torch.float32).to(torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)

    def attn():
        return L.flash_attention(q, k, v, pos, pos, q_chunk=cfg.q_chunk,
                                 kv_chunk=cfg.kv_chunk, triangular=True)
    with torch.no_grad():
        attn()
        out["attention_forward_s_per_layer"], _ = _timed(
            torch, lambda: attn(), 3)

    def fwd_bwd():
        o = attn()
        o.float().sum().backward()
    fwd_bwd()
    out["attention_fwd_bwd_s_per_layer"], _ = _timed(torch, fwd_bwd, 3)
    del q, k, v
    x = torch.randn((b, s - 1, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.float32).to(torch.bfloat16)
    x.requires_grad_(True)
    labels = batch["tokens"][:, 1:].long()

    def ce():
        total, _ = model.chunked_nll(x, labels)
        total.backward()
    ce()
    out["cross_entropy_fwd_bwd_s"], _ = _timed(torch, ce, 2)
    for p in model.parameters():
        p.grad = None
    return out


def _kernel_kinds(rows) -> dict:
    """Device ms of a trace's kernel rows by kind: float32 GEMMs on FFMA
    (the attention's scores and p @ v, TF32 off), bf16 GEMMs on the
    tensor cores (the weights, the head), copies and casts, reductions,
    the other elementwise kernels."""
    kinds = {"float32 FFMA GEMM": 0.0, "bf16 tensor-core GEMM": 0.0,
             "copies and casts": 0.0, "reductions": 0.0,
             "other elementwise": 0.0}
    for dev_us, _, key in rows:
        k = key.lower()
        if "gemm" in k and ("f32f32" in k or "sgemm" in k or "ffma" in k):
            kind = "float32 FFMA GEMM"
        elif "gemm" in k or "nvjet" in k or "cutlass" in k:
            kind = "bf16 tensor-core GEMM"
        elif "copy" in k:
            kind = "copies and casts"
        elif "reduce" in k:
            kind = "reductions"
        else:
            kind = "other elementwise"
        kinds[kind] += dev_us / 1e3
    return kinds


def train_full_phase(torch, trace: bool, bars) -> dict:
    """11b: minicpm-2b at its published widths, all 40 layers, bf16,
    seeded weights drawn on the card, launch.train's AdamW (WSD, peak
    3e-4, warmup 1, 6 steps), SyntheticTokens(seed=0) batches of 8 x
    2048 through make_train_step: each step's loss, grad norm, lr, s and
    tokens/s beside the bound; the loss must fall (the mean of the last
    five below the first five) and every grad norm be finite."""
    from repro_torch import configs
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import train as ltrain
    from repro_torch.models import LM
    from repro_torch.train import make_init_state, make_train_step
    lserve.set_numerics()
    cfg = configs.get(TRAIN_ARCH)
    args = ltrain.build_parser().parse_args(
        ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--seed", "0"])
    opt_cfg = ltrain.opt_config(args)
    batch_size, cut = TRAIN_B, None
    while True:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = LM(cfg, device=None, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        data = SyntheticTokens(cfg.vocab_size, batch_size, TRAIN_S, seed=0,
                               device=model.device)
        state = make_init_state(model, opt_cfg)()
        step = make_train_step(model, opt_cfg)
        rows, over = [], False
        try:
            for i in range(TRAIN_STEPS):
                batch = data(i)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                rows.append({"step": i + 1, "loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "lr": float(m["lr"]), "s": dt})
                if i == 0 and torch.cuda.max_memory_allocated() > \
                        TRAIN_PEAK_CAP:
                    over = True
                    break
        except torch.cuda.OutOfMemoryError:
            over = True
        if not over:
            break
        peak = torch.cuda.max_memory_allocated() / 1e9
        del model, state, step
        if batch_size == 1:
            raise RuntimeError("11b does not fit at batch 1")
        cut = (f"batch {batch_size} -> {batch_size // 2}: the first step "
               f"peaked at {peak:.2f} GB (cap {TRAIN_PEAK_CAP / 1e9:.0f})")
        log(f"11b CUT {cut}")
        batch_size //= 2
    peak = torch.cuda.max_memory_allocated() / 1e9
    bound = _train_bound(cfg, n_params, batch_size, TRAIN_S)
    tokens = batch_size * TRAIN_S
    log(f"11b {TRAIN_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"vocabulary {cfg.vocab_size}, tied: {n_params:,} parameters, "
        f"drawn on the card in {init_s:.2f} s; batches of {batch_size} x "
        f"{TRAIN_S}; bound {bound['bound_s']:.3f} s a step "
        f"({bound['flops'] / 1e12:.1f} TFLOP at {BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s), {bound['bound_remat_s']:.3f} s with remat's forward; "
        f"launch.analytic counts {bound['analytic_flops'] / 1e12:.1f} "
        f"TFLOP, {bound['analytic_bound_s']:.3f} s")
    for r in rows:
        log(f"  step {r['step']:2d}: loss {r['loss']:.5f} grad_norm "
            f"{r['grad_norm']:.4f} lr {r['lr']:.3e} {r['s']:.3f} s "
            f"{tokens / r['s']:.0f} tokens/s, {bound['bound_s'] / r['s']:.3f}"
            f" of the bound")
    losses = [r["loss"] for r in rows]
    steady = [r["s"] for r in rows[1:]]
    falls = float(np.mean(losses[-5:])) < float(np.mean(losses[:5]))
    bars.check(falls, f"11b loss falls: mean of the last five "
                      f"{np.mean(losses[-5:]):.5f} < first five "
                      f"{np.mean(losses[:5]):.5f}")
    bars.check(all(np.isfinite(r["grad_norm"]) and np.isfinite(r["loss"])
                   for r in rows), "11b every grad norm and loss finite")
    st = _state_gb(model, 2)
    state_gb = st["params_gb"] + st["grads_gb"] + st["moments_gb"]
    log(f"11b peak device memory {peak:.2f} GB: state {state_gb:.2f} GB "
        f"(params {st['params_gb']:.2f} + grads {st['grads_gb']:.2f} + "
        f"moments {st['moments_gb']:.2f}), the rest {peak - state_gb:.2f} GB")
    med = statistics.median(steady)
    log(f"11b median step (2-{TRAIN_STEPS}) {med:.3f} s: "
        f"{tokens / med:.0f} tokens/s, {bound['bound_s'] / med:.3f} of the "
        f"{bound['bound_s']:.3f} s bound")
    figures = {"arch": TRAIN_ARCH, "n_params": n_params,
               "layers": cfg.n_layers, "batch": batch_size,
               "seq_len": TRAIN_S, "cut": cut, "init_s": init_s,
               "steps": rows, "median_step_s": med,
               "tokens_per_s": tokens / med, "bound_s": bound["bound_s"],
               "bound_remat_s": bound["bound_remat_s"],
               "analytic_bound_s": bound["analytic_bound_s"],
               "share_of_bound": bound["bound_s"] / med, "peak_gb": peak,
               "state_gb": state_gb, "rest_gb": peak - state_gb, **st}

    # where the step's time goes, part by part (device-synced host clock)
    batch = data(0)
    parts = _train_components(torch, model, batch, opt_cfg, state["opt"])
    for k, v in parts.items():
        log(f"  11b {k}: {v:.4f}")
    figures["parts"] = parts
    if trace:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows_k = kernel_rows(prof)
        busy = sum(r[0] for r in rows_k) / 1e6
        log(f"11b traced step: wall {wall:.3f} s, device busy {busy:.3f} s "
            f"= {100 * busy / wall:.1f}%")
        for dev_us, count, key in rows_k[:20]:
            log(f"  {dev_us / 1e3:10.3f} ms  {count:7d} calls  {key[:90]}")
        kinds = _kernel_kinds(rows_k)
        for kind, ms in kinds.items():
            log(f"  11b traced step by kind: {kind} {ms:.1f} ms")
        figures["traced_step"] = {"wall_s": wall, "busy_s": busy,
                                  "by_kind_ms": kinds,
                                  "top": [(r[0] / 1e3, r[1], r[2][:90])
                                          for r in rows_k[:20]]}
    del model, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return figures


def _restart_run(torch, cfg, ckpt, fail_at):
    """launch.train's loop at `cfg` with a failure injected at `fail_at`
    (None: uninterrupted): its result dict."""
    from repro_torch.launch import train as ltrain
    args = ltrain.build_parser().parse_args(
        ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_RESTART_STEPS),
         "--batch", str(TRAIN_B), "--seq-len", str(TRAIN_S),
         "--save-every", str(TRAIN_SAVE_EVERY), "--ckpt-dir", str(ckpt),
         "--seed", "0", "--device", CARD])
    pending = {fail_at} if fail_at is not None else set()

    def hook(step):
        if step in pending:
            pending.remove(step)
            raise RuntimeError(f"injected failure at step {step}")
    return ltrain.train(args, cfg=cfg, failure_hook=hook)


def train_restart_phase(torch, out_dir, bars) -> dict:
    """11c: launch.train's loop with RestartManager at 11b's widths cut to
    2 layers, a checkpoint every 2 steps, a failure injected at step 3,
    under deterministic algorithms: one restart, the replayed steps'
    losses bit-equal to their first pass, the final state equal to an
    uninterrupted run's; the checkpoint's GB and save/restore s."""
    import shutil
    from repro_torch import configs
    from repro_torch.train import checkpoint as ck
    from repro_torch.tree import leaves, members
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH),
                              n_layers=TRAIN_RESTART_LAYERS)
    root = out_dir / "ckpt"
    shutil.rmtree(root, ignore_errors=True)
    det_reason, rtol = None, 0.0
    torch.use_deterministic_algorithms(True)
    try:
        # a step that fails would be restarted by the loop: probe the
        # path's ops first, so a missing deterministic kernel shows here
        from repro_torch.models import LM
        probe = LM(cfg, device=None, seed=0)
        toks = _train_batch(torch, cfg, 1, 256)["tokens"].to(probe.device)
        try:
            probe.loss({"tokens": toks}).backward()
        except RuntimeError as e:
            if "deterministic" not in str(e):
                raise
            det_reason = str(e).splitlines()[0]
            log(f"11c an op has no deterministic CUDA version "
                f"({det_reason}): rtol 1e-3 instead of bit-equal")
            torch.use_deterministic_algorithms(True, warn_only=True)
            rtol = 1e-3
        del probe
        a = _restart_run(torch, cfg, root / "a", TRAIN_FAIL_AT)
        b = _restart_run(torch, cfg, root / "b", None)
    finally:
        torch.use_deterministic_algorithms(False)
    bars.check(a["restarts"] == 1 and a["steps"] == TRAIN_RESTART_STEPS,
               f"11c {a['restarts']} restart(s), {a['steps']} steps")
    first, replay = {}, []
    for s, loss in a["history"]:
        if s in first:
            replay.append((s, first[s], loss))
        else:
            first[s] = loss
    want = dict(b["history"])

    def same(x, y):
        return x == y if rtol == 0.0 else abs(x - y) <= rtol * abs(y)
    bars.check(bool(replay) and all(same(l2, l1) for _, l1, l2 in replay),
               f"11c replayed steps {[s for s, _, _ in replay]}: losses "
               f"{[(l1, l2) for _, l1, l2 in replay]} "
               + ("bit-equal to their first pass" if rtol == 0.0
                  else f"within rtol {rtol}"))
    bars.check(all(same(first[s], want[s]) for s in want),
               f"11c every step's loss equal to the uninterrupted run's")
    worst = 0.0
    for la, lb in zip(leaves(a["state"]), leaves(b["state"])):
        for x, y in zip(members(la), members(lb)):
            if isinstance(x, int):
                worst = max(worst, float(x != y))
            else:
                worst = max(worst, float((x.detach().float() -
                                          y.detach().float()).abs().max()))
    bars.check(worst <= (0.0 if rtol == 0.0 else 1e-3),
               f"11c final state against the uninterrupted run: max |d| "
               f"{worst:.3e}")
    # checkpoint size and IO
    d = root / "io"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ck.save_checkpoint(str(d), a["steps"], a["state"])
    save_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in Path(path).iterdir())
    t0 = time.perf_counter()
    got, _ = ck.restore_checkpoint(str(d), ck.spec_of(a["state"]))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same_io = all(torch.equal(x, y) if not isinstance(x, int) else x == y
                  for la, lb in zip(leaves(got), leaves(a["state"]))
                  for x, y in zip(members(la), members(lb)))
    bars.check(same_io, "11c a saved checkpoint restores bit for bit")
    n_params = sum(p.numel() for p in a["model"].parameters())
    log(f"11c {TRAIN_RESTART_LAYERS} layers ({n_params:,} parameters): "
        f"checkpoint {size / 1e9:.3f} GB, save {save_s:.2f} s "
        f"({size / 1e9 / save_s:.2f} GB/s), restore {restore_s:.2f} s; "
        f"run with the failure {a['seconds']:.1f} s, without "
        f"{b['seconds']:.1f} s")
    del a, b, got
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": TRAIN_RESTART_LAYERS, "n_params": n_params,
            "restarts": 1, "replayed": replay, "ckpt_gb": size / 1e9,
            "save_s": save_s, "restore_s": restore_s,
            "deterministic_fallback": det_reason, "state_max_abs": worst}


def child_phase(phase: str, tag: str, bars) -> dict:
    """Phase `phase` (11c or 12d) in a child process (`--phases phase`)
    with cuBLAS's deterministic workspace; its lines are relayed, its
    failed checks added to `bars`; returns its figures."""
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--phases", phase], capture_output=True,
                         text=True, timeout=900)
    result = None
    for line in res.stdout.splitlines():
        if line.startswith(tag):
            result = json.loads(line[len(tag):])
        else:
            log(line)
    sys.stderr.write(res.stderr)          # the restart manager's own line
    if res.returncode != 0 or result is None:
        log(res.stderr[-4000:])
        raise RuntimeError(f"{phase}'s child process failed (exit "
                           f"{res.returncode})")
    for what in result["failed"]:
        bars.failed.append(what)
    return result["figures"]


def train_phase(torch, trace: bool, out_dir) -> dict:
    """Phase 11: 11a, 11b, 11c; raises at its end if any check failed."""
    gc.collect()
    torch.cuda.empty_cache()
    bars = Bars()
    t0 = time.perf_counter()
    out = {"smoke": train_smoke_phase(torch, bars)}
    log(f"11a in {time.perf_counter() - t0:.1f} s")
    out["full"] = train_full_phase(torch, trace, bars)
    out["restart"] = child_phase("11c", RESTART_TAG, bars)
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 11 in {out['phase_s']:.1f} s")
    bars.raise_if_failed("phase 11")
    return out


# -- phase 12: LM training over several ranks ---------------------------------

DIST_RANKS = 2                 # 12-0, 12a, 12b: a (2, 1) world on the card
DIST_STEPS = 1                 # 12b: held to the one-device run's first
DIST_TOL = 2e-2                # 12b/12c: losses; 12b's grad norm, relative
PIPE_RANKS, PIPE_MICRO = 4, 4  # 12c: a ("pod",) world, 4 stages of 2
PIPE_LAYERS = 8                # 12c: minicpm-2b's 40 blocks cut to 8
PIPE_TOL = {"loss": 1e-5, "rtol": 1e-4, "atol": 1e-5}   # 12a's pipeline
DIST_TAG = "12d-result: "
PROBE_OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
             "broadcast", "all_to_all_single", "batch_isend_irecv")
PROBE_TIMEOUT_S = 60


def _probe_one(torch, dist, grp, dev, dtype, op) -> str:
    """One gloo collective on two small tensors: "ok", "wrong result" or
    the error's first line."""
    n, r = dist.get_world_size(), dist.get_rank()
    x = torch.full((n * 4,), float(r + 1), dtype=dtype, device=dev)
    try:
        if op == "all_reduce":
            dist.all_reduce(x, group=grp)
            ok = float(x[0]) == n * (n + 1) / 2
        elif op == "all_gather_into_tensor":
            o = torch.empty(n * n * 4, dtype=dtype, device=dev)
            dist.all_gather_into_tensor(o, x, group=grp)
            ok = float(o[-1]) == n
        elif op == "reduce_scatter_tensor":
            o = torch.empty(4, dtype=dtype, device=dev)
            dist.reduce_scatter_tensor(o, x, group=grp)
            ok = float(o[0]) == n * (n + 1) / 2
        elif op == "broadcast":
            dist.broadcast(x, 0, group=grp)
            ok = float(x[0]) == 1
        elif op == "all_to_all_single":
            o = torch.empty_like(x)
            dist.all_to_all_single(o, x, group=grp)
            ok = float(o[-1]) == n
        else:
            o = torch.empty_like(x)
            for w in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, (r + 1) % n, grp),
                    dist.P2POp(dist.irecv, o, (r - 1) % n, grp)]):
                w.wait()
            ok = float(o[0]) == (r - 1) % n + 1
        if x.is_cuda:
            torch.cuda.synchronize()
        return "ok" if ok else "wrong result"
    except Exception as e:        # recorded: what the probe is for
        return f"{type(e).__name__}: {str(e).splitlines()[0][:100]}"


def probe_rank(rank: int, cases: list, progress: str) -> None:
    """12-0 on a rank: each (dtype, op) of `cases` on CUDA tensors, on a
    new group with a short timeout.  Rank 0 writes each case's name to
    `progress` before it runs and its result after, so the results of a
    world that a collective kills are kept and the case that killed it
    is known."""
    import datetime
    import torch
    import torch.distributed as dist
    for dtype, op in cases:
        key = f"{dtype} {op}"
        if rank == 0:
            with open(progress, "a") as f:
                f.write(key + "\n")
        # a group of its own: a refused op can leave its group's
        # connections broken for the ops after it
        grp = dist.new_group(list(range(dist.get_world_size())),
                             timeout=datetime.timedelta(
                                 seconds=PROBE_TIMEOUT_S))
        res = _probe_one(torch, dist, grp, CARD, getattr(torch, dtype), op)
        if rank == 0:
            with open(progress, "a") as f:
                f.write(f"{key}\t{res}\n")
        dist.barrier()


def probe_phase(out_dir) -> dict:
    """12-0: which gloo collectives take CUDA tensors, in float32 and
    bf16, in (2, 1) worlds on the card, the point-to-point ones last.  A
    collective that kills a rank is recorded and the cases after it run
    in a new world.  Printed only: the port's path stages CUDA tensors
    through the host."""
    from repro_torch.dist.world import run_world
    ops = [op for op in PROBE_OPS if op != "batch_isend_irecv"]
    cases = [(dtype, op) for op in ops + ["batch_isend_irecv"]
             for dtype in ("float32", "bfloat16")]
    progress = out_dir / "probe_progress.txt"
    out = {}
    while cases:
        progress.unlink(missing_ok=True)
        died = None
        try:
            run_world(probe_rank, DIST_RANKS, device=CARD,
                      store_dir=str(out_dir / "world12p"),
                      args=(cases, str(progress)))
        except RuntimeError as e:
            died = "the rank died: " + str(e).splitlines()[0][:100]
        lines = progress.read_text().splitlines() if progress.exists() \
            else []
        started = [ln for ln in lines if "\t" not in ln]
        for ln in lines:
            if "\t" in ln:
                key, res = ln.split("\t", 1)
                out[key] = res
        if died is None:
            break
        if not started:
            raise RuntimeError(f"12-0's world failed before a probe: {died}")
        # the case last started killed the world, also where rank 0 saw
        # its own part end first (the peer's send thread aborts later)
        last = started[-1]
        out[last] = f"{out[last]}; {died}" if last in out else died
        cases = cases[len(started):]
    return out


def _named(model, tree) -> dict:
    """{parameter name: float32 CPU tensor} of a whole tree in the
    model's layout (a Stacked leaf member by member)."""
    from repro_torch.tree import leaves, members
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}
    for own, leaf in zip(leaves(model.param_tree()), leaves(tree)):
        for o, t in zip(members(own), members(leaf)):
            out[names[id(o)]] = t.detach().float().cpu()
    return out


def _dist_smoke_side(torch, cfg, batch, dev) -> tuple:
    """One side of 12a on this world: (loss, {name: gathered grad}, the
    step tuple of `_one_step`: one make_train_step step with accum 2)."""
    from repro_torch.dist import act
    from repro_torch.dist.sharding import (ShardingRules, batch_shardings,
                                           gather, param_shardings, reshard)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LM
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import (_batch_axes, _value_and_grad,
                                              bind_params)
    cpu = LM(cfg, device="cpu", seed=0)
    model = LM(cfg, device="meta")
    model.load_state_dict({k: v.to(dev, copy=True) for k, v in
                           cpu.state_dict().items()}, assign=True)
    rules = ShardingRules(make_host_mesh(device=dev), "dp")
    sh = param_shardings(rules, model.param_tree())

    def placed_batch():
        b = {k: v.to(dev) for k, v in batch.items()}
        return reshard(b, batch_shardings(rules, b))
    params = reshard(model.param_tree(), sh)
    bind_params(model, params)
    b = placed_batch()
    with act.activation_sharding(rules):
        loss, grads = _value_and_grad(model, params, b, *_batch_axes(b))
    grads = _named(model, gather(grads))
    opt = AdamWConfig(peak_lr=TRAIN_SMOKE_LR, warmup_steps=1, total_steps=10)
    params = reshard(model.param_tree(), sh)
    state = {"params": params, "opt": adamw_init(params)}
    step = make_train_step(model, opt, accum_steps=2)
    with act.activation_sharding(rules):
        state, m = step(state, placed_batch())
    whole = gather(state)
    mus = _named(model, whole["opt"]["mu"])
    nus = _named(model, whole["opt"]["nu"])
    dirs = {n: (mus[n] / (1 - opt.b1)) / (torch.sqrt(nus[n] / (1 - opt.b2))
                                          + opt.eps) for n in mus}
    return (float(loss), grads,
            (float(m["loss"]), float(m["grad_norm"]), float(m["lr"]),
             _named(model, whole["params"]), mus, dirs))


def _dist_pipeline_smoke(torch) -> dict:
    """12a's pipeline: minicpm-2b's float32 smoke blocks in 2 stages on
    the card, each block under a checkpoint, against the same blocks in
    sequence: the losses and every block gradient's worst |d| over its
    bar (atol + rtol x |want|)."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch import configs
    from repro_torch.dist import comm
    from repro_torch.dist.pipeline import make_pipelined_loss
    from repro_torch.dist.sharding import Placement, reshard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import LM
    from repro_torch.models import layers as L
    from repro_torch.models.model import ParamView, apply_block
    from repro_torch.tree import leaves, tree_map
    import torch.distributed as dist
    n = dist.get_world_size()
    dev = torch.device(CARD)
    cfg = dataclasses.replace(configs.get_smoke(TRAIN_ARCH),
                              param_dtype="float32")
    model = LM(cfg, device=dev, seed=0)
    per, kind = cfg.n_layers // n, model.blocks[0].kind
    mesh = make_mesh((n,), ("pod",), [dev] * n)
    toks = _train_batch(torch, cfg, TRAIN_SMOKE_B, TRAIN_SMOKE_S)[
        "tokens"].to(dev)
    labels = toks[:, 1:].long()
    x = model._embed(toks).detach()

    def run(p, h, j):
        pos = torch.arange(h.shape[1], dtype=torch.int32,
                           device=dev).expand(h.shape[0], h.shape[1])
        return apply_block(kind, h, ParamView(tree_map(lambda v: v[j], p)),
                           cfg, None, pos, None)[0]

    def stage_fn(p, h):
        for j in range(per):
            h = checkpoint(run, p, h, j, use_reentrant=False)
        return h

    def loss_fn(out, labels):
        hn = L.rmsnorm(out, model.final_norm, cfg.norm_eps)
        total, count = model.chunked_nll(hn[:, :-1], labels)
        return total / count
    trees = [model.blocks[i].tree() for i in range(cfg.n_layers)]
    stacked = tree_map(lambda *vs: torch.stack(vs).detach().reshape(
        (n, per) + tuple(vs[0].shape)), *trees)
    placed = reshard(stacked, tree_map(lambda v: Placement(
        mesh, ("pod",) + (None,) * (v.dim() - 1)), stacked))
    for v in leaves(placed):
        v.requires_grad_(True)
    lp = make_pipelined_loss(mesh, stage_fn, loss_fn, "pod",
                             n_micro=2)(placed, x, labels)
    lp.backward()
    got = [comm.all_gather(v.grad, 0, None, n).reshape(
        (cfg.n_layers,) + tuple(v.shape[2:])) for v in leaves(placed)]
    whole = tree_map(lambda v: v.reshape((cfg.n_layers,) + tuple(v.shape[2:]))
                     .clone().requires_grad_(True), stacked)
    h = x
    for i in range(cfg.n_layers):
        h = run(whole, h, i)
    ls = loss_fn(h, labels)
    ls.backward()
    worst = max(float(((g - w.grad).abs() / (PIPE_TOL["atol"] + PIPE_TOL[
        "rtol"] * w.grad.abs())).max()) for g, w in zip(got, leaves(whole)))
    return {"loss_pipelined": float(lp.detach()),
            "loss_sequential": float(ls.detach()), "grad_worst": worst,
            "leaves": len(got)}


def _dist_full(torch) -> dict:
    """12b on this rank: launch.train's set-up and step at minicpm-2b's
    published widths (11b's AdamW, its total_steps included), DIST_STEPS
    steps of the global batch of 8 x 2048: per step the loss, grad norm,
    s and the collectives' calls, bytes, host s and copy s; this rank's
    peak."""
    import torch.distributed as dist
    from repro_torch.dist import comm
    from repro_torch.launch import train as ltrain
    # --steps sets only the schedule's total_steps (11b's): the loop
    # below runs DIST_STEPS of it
    args = ltrain.build_parser().parse_args(
        ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
         str(TRAIN_B), "--seq-len", str(TRAIN_S), "--seed", "0",
         "--device", CARD])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comm.reset_stats()
    run = ltrain.setup(args)
    torch.cuda.synchronize()
    setup = {"s": time.perf_counter() - t0, "collective_s":
             comm.STATS["seconds"]}
    state, rows = run["state"], []
    for i in range(DIST_STEPS):
        batch = run["data"](i)
        torch.cuda.synchronize()
        comm.reset_stats()
        t0 = time.perf_counter()
        state, m = run["step"](state, batch)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        rows.append({"step": i + 1, "loss": loss, "grad_norm": gn,
                     "lr": float(m["lr"]), "s": time.perf_counter() - t0,
                     **{f"collective_{k}": v for k, v in
                        comm.STATS.items()}})
    peaks = [torch.zeros(1, dtype=torch.float64)
             for _ in range(dist.get_world_size())]
    dist.all_gather(peaks, torch.tensor(
        [torch.cuda.max_memory_allocated() / 1e9], dtype=torch.float64))
    n_params = sum(p.numel() for p in run["model"].parameters())
    del run, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"rows": rows, "peaks_gb": [float(p) for p in peaks],
            "setup": setup, "n_params": n_params}


def dist_rank(rank: int) -> dict:
    """A rank of phase 12's (2, 1) world on the card: 12a, then 12b."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import serve as lserve
    lserve.set_numerics()
    out = {"smoke": {}}
    for name in ("minicpm-2b", "mixtral-8x7b"):
        cfg = dataclasses.replace(configs.get_smoke(name),
                                  param_dtype="float32")
        batch = _train_batch(torch, cfg, TRAIN_SMOKE_B, TRAIN_SMOKE_S)
        out["smoke"][name] = {dev: _dist_smoke_side(torch, cfg, batch, dev)
                              for dev in ("cpu", CARD)}
    out["pipeline"] = _dist_pipeline_smoke(torch)
    out["full"] = _dist_full(torch)
    return out


def pipe_rank(rank: int) -> dict:
    """12c on a rank of a ("pod",) world of PIPE_RANKS on the card:
    minicpm-2b at its published widths, its 40 blocks cut to PIPE_LAYERS,
    drawn from the seed, this rank's stage of PIPE_LAYERS / PIPE_RANKS
    blocks stacked and placed P("pod"), the global batch of 8 x 2048 in
    PIPE_MICRO microbatches, the loss the final norm and the chunked
    cross-entropy with the tied head; one forward and backward.  Rank 0
    then runs the blocks in sequence (no grad) for the loss it is held
    to."""
    import torch
    import torch.distributed as dist
    from torch.utils.checkpoint import checkpoint
    from repro_torch import configs
    from repro_torch.data import SyntheticTokens
    from repro_torch.dist import comm
    from repro_torch.dist.pipeline import make_pipelined_loss
    from repro_torch.dist.sharding import Placement, with_placement
    from repro_torch.launch import serve as lserve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import LM
    from repro_torch.models import layers as L
    from repro_torch.models.model import ParamView, apply_block
    from repro_torch.tree import leaves, tree_map
    lserve.set_numerics()
    dev = torch.device(CARD)
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH), n_layers=PIPE_LAYERS)
    model = LM(cfg, device=dev, seed=0)
    per = cfg.n_layers // PIPE_RANKS
    mesh = make_mesh((PIPE_RANKS,), ("pod",), [dev] * PIPE_RANKS)
    trees = [model.blocks[i].tree()
             for i in range(rank * per, (rank + 1) * per)]

    def stage_leaf(*vs):
        t = torch.stack([v.detach() for v in vs]).unsqueeze(0)
        return with_placement(t.requires_grad_(True), Placement(
            mesh, ("pod",) + (None,) * (t.dim() - 1)))
    params = tree_map(stage_leaf, *trees)
    del trees
    if rank != 0:
        del model.blocks        # this rank's stage is its own copy
        gc.collect()
        torch.cuda.empty_cache()
    toks = SyntheticTokens(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=0,
                           device=dev)(0)["tokens"]
    labels = toks[:, 1:].long()
    with torch.no_grad():
        x = model._embed(toks)

    def run(p, h, j):
        pos = torch.arange(h.shape[1], dtype=torch.int32,
                           device=dev).expand(h.shape[0], h.shape[1])
        return apply_block("attn", h, ParamView(tree_map(lambda v: v[j], p)),
                           cfg, None, pos, None)[0]

    def stage_fn(p, h):
        for j in range(per):      # the model's remat: a cycle is a block
            h = checkpoint(run, p, h, j, use_reentrant=False)
        return h

    def loss_fn(out, labels):
        hn = L.rmsnorm(out, model.final_norm, cfg.norm_eps)
        total, count = model.chunked_nll(hn[:, :-1], labels)
        return total / count
    pipe = make_pipelined_loss(mesh, stage_fn, loss_fn, "pod",
                               n_micro=PIPE_MICRO)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    dist.barrier()
    comm.reset_stats()
    t0 = time.perf_counter()
    loss = pipe(params, x, labels)
    loss.backward()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    stats = dict(comm.STATS)
    peaks = [torch.zeros(1, dtype=torch.float64) for _ in range(PIPE_RANKS)]
    dist.all_gather(peaks, torch.tensor(
        [torch.cuda.max_memory_allocated() / 1e9], dtype=torch.float64))
    out = {"loss": float(loss.detach()), "s": step_s, "collectives": stats,
           "peaks_gb": [float(p) for p in peaks],
           "grads_finite": all(bool(torch.isfinite(v.grad).all())
                               for v in leaves(params))}
    del loss, params
    gc.collect()
    if rank == 0:
        with torch.no_grad():
            pos = torch.arange(TRAIN_S, dtype=torch.int32,
                               device=dev).expand(TRAIN_B, TRAIN_S)
            h = x
            for blk in model.blocks:
                h = apply_block(blk.kind, h, blk, cfg, None, pos, None)[0]
            out["loss_sequential"] = float(loss_fn(h, labels))
    return out


def restart_rank(rank: int, root: str) -> dict:
    """12d on a rank of a (2, 1) world on the card (cuBLAS's
    deterministic workspace set before CUDA started, deterministic
    algorithms): launch.train's loop at 11b's widths cut to 2 layers, a
    checkpoint every 2 steps, a failure injected at step 3 on every rank;
    then the final state gathered, the world's last checkpoint restored
    on one device, and a checkpoint of the whole state (what one device
    writes) restored onto the world's placements, both bit for bit."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.dist.sharding import gather
    from repro_torch.launch import serve as lserve
    from repro_torch.train import checkpoint as ck
    from repro_torch.tree import leaves, members
    lserve.set_numerics()
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH),
                              n_layers=TRAIN_RESTART_LAYERS)
    root = Path(root)
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        a = _restart_run(torch, cfg, root / "world", TRAIN_FAIL_AT)
        run_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)

    def same(x, y):
        return all(torch.equal(p, q) if isinstance(p, torch.Tensor)
                   else p == q for lx, ly in zip(leaves(x), leaves(y))
                   for p, q in zip(members(lx), members(ly)))
    whole = gather(a["state"])
    last = ck.latest_step(str(root / "world"))
    out = {"restarts": a["restarts"], "steps": a["steps"],
           "history": a["history"], "run_s": run_s, "last": last}
    if rank == 0:
        t0 = time.perf_counter()
        got, step = ck.restore_checkpoint(str(root / "world"),
                                          ck.spec_of(whole))
        out["world_to_one_device"] = bool(step == last and same(got, whole))
        out["restore_one_device_s"] = time.perf_counter() - t0
        del got
    t0 = time.perf_counter()
    path = ck.save_checkpoint(str(root / "one"), last, whole)
    out["save_whole_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, _ = ck.restore_checkpoint(str(root / "one"), ck.spec_of(a["state"]),
                                    a["shardings"])
    out["restore_placed_s"] = time.perf_counter() - t0
    flag = torch.tensor([int(same(gather(back), whole))])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    out["one_device_to_world"] = bool(flag.item())
    if rank == 0:
        data = [Path(p) / "data.msgpack" for p in
                (path, root / "world" / f"step_{last:010d}")]
        out["same_files"] = data[0].read_bytes() == data[1].read_bytes()
        out["ckpt_gb"] = data[0].stat().st_size / 1e9
    return out


def _one_device_steps(torch) -> list:
    """12b's reference where phase 11b did not run: 11b's run on one
    device (its AdamW, total_steps included), DIST_STEPS steps."""
    from repro_torch import configs
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import train as ltrain
    from repro_torch.models import LM
    from repro_torch.train import make_init_state, make_train_step
    lserve.set_numerics()
    cfg = configs.get(TRAIN_ARCH)
    opt_cfg = ltrain.opt_config(ltrain.build_parser().parse_args(
        ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS)]))
    model = LM(cfg, device=CARD, seed=0)
    data = SyntheticTokens(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=0,
                           device=model.device)
    state = make_init_state(model, opt_cfg)()
    step = make_train_step(model, opt_cfg)
    rows = []
    for i in range(DIST_STEPS):
        state, m = step(state, data(i))
        rows.append({"step": i + 1, "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"])})
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def dist_phase(torch, out_dir, one_device, before_12d=None) -> dict:
    """Phase 12: 12-0's probes, then 12a and 12b in a (2, 1) world of ranks
    sharing the card, 12c in a ("pod",) world of PIPE_RANKS, 12d in a child
    process (`before_12d()`, where given, called just before it starts);
    `one_device` is phase 11b's rows (None: run the first DIST_STEPS of it
    here).  Raises at its end if any check failed."""
    from repro_torch import configs
    from repro_torch.dist.world import choose_backend, run_world
    gc.collect()
    torch.cuda.empty_cache()
    bars = Bars()
    t_phase = time.perf_counter()
    if one_device is None:
        t0 = time.perf_counter()
        one_device = _one_device_steps(torch)
        log(f"12b's one-device reference ({DIST_STEPS} steps of 11b): "
            f"{time.perf_counter() - t0:.1f} s")
    log(f"12: {DIST_RANKS} ranks on {torch.cuda.device_count()} card(s) "
        f"over {choose_backend('cuda', DIST_RANKS)}")
    t0 = time.perf_counter()
    probe = probe_phase(out_dir)
    log(f"12-0 gloo probes in {time.perf_counter() - t0:.1f} s")
    for k, v in probe.items():
        log(f"  12-0 gloo on CUDA tensors, {k}: {v}")
    t0 = time.perf_counter()
    with MemoryPoll() as mem:
        res = run_world(dist_rank, DIST_RANKS, device=CARD,
                        store_dir=str(out_dir / "world12"), threads=4)
    out = {"world_s": time.perf_counter() - t0, "smi_peak_mib": mem.peak_mib}

    out["probe"] = probe

    # 12a: the smoke configs, the world on the card against the world on
    # CPU tensors, at 11a's bars; the 2-stage pipeline at the reference's
    out["smoke"] = {}
    for name, sides in res["smoke"].items():
        (lc, gcpu, sc), (lg, gcard, sg) = sides["cpu"], sides[CARD]
        ok, err = _within(torch.tensor(lg), torch.tensor(lc),
                          TRAIN_TOL["loss"])
        bars.check(ok, f"12a {name} float32 (2, 1) world: loss {lg:.6f} "
                       f"against {lc:.6f} on CPU tensors, |d| {err:.3e} "
                       f"(bar 1e-5)")
        out["smoke"][name] = _hold_step(torch, bars, f"12a {name} float32",
                                        err, gcpu, gcard, sc, sg)
    p = res["pipeline"]
    d = abs(p["loss_pipelined"] - p["loss_sequential"])
    bars.check(d <= PIPE_TOL["loss"] and p["grad_worst"] <= 1.0,
               f"12a 2-stage pipeline of {TRAIN_ARCH}'s smoke blocks: loss "
               f"{p['loss_pipelined']:.6f} against {p['loss_sequential']:.6f}"
               f" in sequence, |d| {d:.3e} (bar 1e-5); {p['leaves']} "
               f"gradient leaves at {p['grad_worst']:.3f} of rtol 1e-4 + "
               f"atol 1e-5")
    out["pipeline_smoke"] = p

    # 12b: minicpm-2b at its published widths, FSDP-DP on (2, 1)
    f = res["full"]
    tokens = TRAIN_B * TRAIN_S
    log(f"12b {TRAIN_ARCH}: {f['n_params']:,} parameters, FSDP-DP over "
        f"{DIST_RANKS} ranks, global batch {TRAIN_B} x {TRAIN_S}; set-up "
        f"{f['setup']['s']:.2f} s (draw, slice, moments)")
    for r, want in zip(f["rows"], one_device):
        dl = abs(r["loss"] - want["loss"])
        dg = abs(r["grad_norm"] - want["grad_norm"]) / abs(want["grad_norm"])
        bars.check(dl <= DIST_TOL and dg <= DIST_TOL,
                   f"12b step {r['step']}: loss {r['loss']:.5f} against "
                   f"{want['loss']:.5f} on one device (|d| {dl:.2e}, bar "
                   f"2e-2), grad_norm {r['grad_norm']:.4f} against "
                   f"{want['grad_norm']:.4f} (rel {dg:.2e}, bar 2e-2)")
        log(f"  step {r['step']}: {r['s']:.3f} s, {tokens / r['s']:.0f} "
            f"tokens/s; collectives {r['collective_calls']} calls, "
            f"{r['collective_bytes'] / 1e9:.3f} GB, "
            f"{r['collective_seconds']:.3f} s host "
            f"({r['collective_copy_seconds']:.3f} s of it host copies), "
            f"{100 * r['collective_seconds'] / r['s']:.1f}% of the step")
    # steps 2.. where there are any (DIST_STEPS cut to 1 for time: step 1)
    steady = [r["s"] for r in f["rows"][1:] or f["rows"]]
    med = statistics.median(steady)
    log(f"12b median step ({min(2, DIST_STEPS)}-{DIST_STEPS}) {med:.3f} s, "
        f"{tokens / med:.0f} tokens/s; peak per rank "
        f"{', '.join(f'{g:.2f}' for g in f['peaks_gb'])} GB; nvidia-smi "
        f"peak {mem.peak_mib} MiB")
    out["full"] = dict(f, median_step_s=med, tokens_per_s=tokens / med,
                       one_device=one_device[:DIST_STEPS])

    # 12c: GPipe at the same widths over PIPE_RANKS ranks
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with MemoryPoll() as mem:
        c = run_world(pipe_rank, PIPE_RANKS, device=CARD,
                      store_dir=str(out_dir / "world12c"), threads=2)
    d = abs(c["loss"] - c["loss_sequential"])
    bars.check(d <= DIST_TOL and c["grads_finite"],
               f"12c {PIPE_RANKS}-stage GPipe of {TRAIN_ARCH}'s "
               f"{PIPE_LAYERS} blocks (of "
               f"{configs.get(TRAIN_ARCH).n_layers}), "
               f"{PIPE_MICRO} microbatches: loss {c['loss']:.5f} against "
               f"{c['loss_sequential']:.5f} in sequence on one rank (|d| "
               f"{d:.2e}, bar 2e-2); stage gradients finite")
    mb_bytes = TRAIN_B // PIPE_MICRO * TRAIN_S * configs.get(
        TRAIN_ARCH).d_model * 2
    st = c["collectives"]
    log(f"12c a step {c['s']:.3f} s ({tokens / c['s']:.0f} tokens/s); "
        f"{mb_bytes / 1e6:.1f} MB a tick a rank each way; rank 0's "
        f"collectives {st['calls']} calls, {st['bytes'] / 1e9:.3f} GB, "
        f"{st['seconds']:.3f} s host ({st['copy_seconds']:.3f} s copies); "
        f"peak per rank {', '.join(f'{g:.2f}' for g in c['peaks_gb'])} GB; "
        f"nvidia-smi peak {mem.peak_mib} MiB; world "
        f"{time.perf_counter() - t0:.1f} s")
    out["pipeline"] = dict(c, tick_bytes=mb_bytes, smi_peak_mib=mem.peak_mib)

    # 12d: elastic restart in a child process (cuBLAS's workspace)
    gc.collect()
    torch.cuda.empty_cache()
    if before_12d is not None:
        before_12d()
    r = child_phase("12d", DIST_TAG, bars)
    first, replay = {}, []
    for s, loss in r["history"]:
        if s in first:
            replay.append((s, first[s], loss))
        else:
            first[s] = loss
    bars.check(r["restarts"] == 1 and r["steps"] == TRAIN_RESTART_STEPS
               and bool(replay) and all(l2 == l1 for _, l1, l2 in replay),
               f"12d {r['restarts']} restart(s) of the (2, 1) world, "
               f"{r['steps']} steps; replayed steps "
               f"{[s for s, _, _ in replay]} bit-equal to their first pass")
    bars.check(r["world_to_one_device"] and r["one_device_to_world"]
               and r["same_files"],
               f"12d the world's step-{r['last']} checkpoint "
               f"({r['ckpt_gb']:.3f} GB) restores on one device bit for "
               f"bit, a one-device checkpoint of the gathered state restores "
               f"onto the world bit for bit, the two data files byte-equal "
               f"(loop {r['run_s']:.1f} s, save {r['save_whole_s']:.2f} s, "
               f"placed restore {r['restore_placed_s']:.2f} s)")
    out["restart"] = dict(r, replayed=replay)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 12 in {out['phase_s']:.1f} s")
    bars.raise_if_failed("phase 12")
    return out


def restart_world(out_dir) -> dict:
    """12d's world, in the child process."""
    import shutil
    from repro_torch.dist.world import run_world
    root = out_dir / "ckpt12"
    shutil.rmtree(root, ignore_errors=True)
    try:
        return run_world(restart_rank, DIST_RANKS, device=CARD,
                         store_dir=str(out_dir / "world12d"),
                         args=(str(root),), threads=4)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- phase 13: tensor-parallel serving over ranks sharing the card -----------

TP_RANKS = 2                   # a (1, 2) ("data", "model") world
TP_B, TP_PROMPT, TP_STEPS = 4, 512, 8      # 13b's traffic (13c's too)
TP_F32_LAYERS = 2              # 13c: 13b's widths in float32 at this depth
TP_BAR = 0.25                  # 13b: of the one-process logits' std
TP_THREADS = 4                 # intra-op CPU threads a rank (8 cores)


def _tp_smoke_cases(torch):
    """13a's cases: (name, dtype, tokens [B, S + steps(, cb)], patch
    embeddings or None), 10a's inputs."""
    from repro_torch import configs
    out = []
    for name in configs.ARCH_NAMES:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(configs.get_smoke(name),
                                      param_dtype=dtype)
            toks, pe = _lm_inputs(torch, cfg, LM_SMOKE_B,
                                  LM_SMOKE_S + LM_SMOKE_DECODE)
            out.append((name, dtype, toks, pe))
    return out


def _tp_cfg(dtype: str, layers=None):
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get(LM_ARCH), param_dtype=dtype)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def _tp_steps(torch, engine, toks, pe, s, sync=False):
    """Prefill of toks[:, :s], then a decode step on each later token:
    the logits of each (float32, on the CPU), and with `sync` the host
    seconds of each call (a device sync before and after)."""
    dev = engine.model.device

    def on(t):
        return None if t is None else t.to(dev)
    logits, secs = [], []
    cache = engine.new_cache(toks.shape[0])
    for j in range(toks.shape[1] - s + 1):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if j == 0:
            lg, cache = engine.prefill(on(toks[:, :s]), cache, on(pe))
        else:
            lg, cache = engine.decode(on(toks[:, s + j - 1:s + j]), cache)
        if sync:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        logits.append(lg.float().cpu())
    return logits, secs


def _tp_full_inputs(torch, cfg, greedy):
    """13b/13c's prompts of TP_PROMPT tokens and the TP_STEPS tokens fed
    to the decode steps (13b's one-process greedy picks)."""
    toks, _ = _lm_inputs(torch, cfg, TP_B, TP_PROMPT)
    return torch.cat([toks, greedy], dim=1)


def tp_reference(torch, cases) -> dict:
    """One process on the card, before the world: 13a's smoke cases; 13b
    (qwen2.5-14b, 48 layers, bf16, `LM(cfg, seed=0)`, prefill of TP_B x
    TP_PROMPT and TP_STEPS greedy decode steps); 13c (2 layers, float32,
    fed 13b's picks).  Each model is freed before the next."""
    from repro_torch.models import LM
    from repro_torch.serve import ServeEngine
    out = {"smoke": {}}
    for name, dtype, toks, pe in cases:
        cfg = dataclasses.replace(_smoke(name), param_dtype=dtype)
        engine = ServeEngine(LM(cfg, device=CARD, seed=0),
                             max_len=LM_SMOKE_LEN + cfg.patch_prefix)
        out["smoke"][(name, dtype)] = _tp_steps(torch, engine, toks, pe,
                                                LM_SMOKE_S)[0]
    # 13b: greedy, so the decode steps' tokens are this run's picks
    cfg = _tp_cfg("bfloat16")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg, device=CARD, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    engine = ServeEngine(model, max_len=TP_PROMPT + TP_STEPS)
    prompt, _ = _lm_inputs(torch, cfg, TP_B, TP_PROMPT)
    logits, secs, picks = [], [], []
    with torch.inference_mode():
        cache = engine.new_cache(TP_B)
        for j in range(TP_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if j == 0:
                lg, cache = engine.prefill(prompt.to(CARD), cache)
            else:
                lg, cache = engine.decode(picks[-1], cache)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            logits.append(lg.float().cpu())
            picks.append(torch.argmax(lg[:, -1:], dim=-1).to(torch.int32))
    greedy = torch.cat(picks[:TP_STEPS], dim=1).cpu()
    out["full"] = {"logits": logits, "secs": secs, "greedy": greedy,
                   "init_s": init_s, "n_params": n_params,
                   "weight_bytes": weight_bytes,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del model, engine, cache, lg
    gc.collect()
    torch.cuda.empty_cache()
    # 13c: float32 at TP_F32_LAYERS layers, fed 13b's picks
    cfg = _tp_cfg("float32", TP_F32_LAYERS)
    engine = ServeEngine(LM(cfg, device=CARD, seed=0),
                         max_len=TP_PROMPT + TP_STEPS)
    toks = _tp_full_inputs(torch, cfg, greedy)
    out["f32"] = _tp_steps(torch, engine, toks, None, TP_PROMPT)[0]
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _smoke(name):
    from repro_torch import configs
    return configs.get_smoke(name)


def tp_rank(rank: int, cases, greedy) -> dict:
    """A rank of phase 13's (1, 2) world: every model drawn as this rank's
    slices of `LM(cfg, seed=0)` (`param_shardings(rules, ...,
    serve=True)`) and served inside `activation_sharding(rules,
    serve=True)`: 13a's smoke cases, 13b at full width (timed, its
    collectives, weights gathered and memory read a step), 13c."""
    import torch
    from repro_torch.dist import act, comm, tp
    from repro_torch.dist.sharding import (ShardingRules, param_shardings,
                                           placement_of)
    from repro_torch.kernels.fused_superstep import kernel as fk
    from repro_torch.kernels.mj_spmm import kernel as mk
    from repro_torch.kernels.priority_pairs import kernel as pk
    from repro_torch.launch import serve as lserve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LM
    from repro_torch.serve import ServeEngine
    lserve.set_numerics()
    rules = ShardingRules(make_host_mesh(model_axis=TP_RANKS, device=CARD),
                          "tp")
    kernels0 = (dict(fk.launches), dict(mk.launches), dict(pk.launches))

    def placed(cfg):
        sh = param_shardings(rules, LM(cfg, device="meta").param_tree(),
                             serve=True)
        return LM(cfg, device=CARD, seed=0, shardings=sh)

    out = {"smoke": {}}
    t0 = time.perf_counter()
    with act.activation_sharding(rules, serve=True):
        for name, dtype, toks, pe in cases:
            cfg = dataclasses.replace(_smoke(name), param_dtype=dtype)
            engine = ServeEngine(placed(cfg),
                                 max_len=LM_SMOKE_LEN + cfg.patch_prefix)
            out["smoke"][(name, dtype)] = _tp_steps(
                torch, engine, toks, pe, LM_SMOKE_S)[0]
    out["smoke_s"] = time.perf_counter() - t0

    # 13b: qwen2.5-14b at its published widths, all layers, bf16
    cfg = _tp_cfg("bfloat16")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = placed(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    place_peak = torch.cuda.max_memory_allocated()
    resident = split = vectors = 0
    for p in model.parameters():
        nbytes = p.numel() * p.element_size()
        resident += nbytes
        if placement_of(p) is None:
            vectors += nbytes
        else:
            split += nbytes
    engine = ServeEngine(model, max_len=TP_PROMPT + TP_STEPS)
    toks = _tp_full_inputs(torch, cfg, greedy)
    rows = []
    logits = []
    with act.activation_sharding(rules, serve=True), torch.inference_mode():
        cache = engine.new_cache(TP_B)
        for j in range(TP_STEPS + 1):
            comm.reset_stats()
            tp.reset_gathered()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if j == 0:
                lg, cache = engine.prefill(
                    toks[:, :TP_PROMPT].to(CARD), cache)
            else:
                lg, cache = engine.decode(
                    toks[:, TP_PROMPT + j - 1:TP_PROMPT + j].to(CARD), cache)
            torch.cuda.synchronize()
            rows.append(dict(s=time.perf_counter() - t1, **{
                f"collective_{k}": v for k, v in comm.STATS.items()},
                gathered_calls=tp.GATHERED["calls"],
                gathered_bytes=tp.GATHERED["bytes"]))
            if rank == 0:
                logits.append(lg.float().cpu())
    out["full"] = {"rows": rows, "logits": logits, "init_s": init_s,
                   "resident_bytes": resident, "split_bytes": split,
                   "whole_bytes": vectors,
                   "place_peak_gb": place_peak / 1e9,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "cache_k": tuple(cache["layers"][0]["k"].shape)}
    del model, engine, cache, lg
    gc.collect()
    torch.cuda.empty_cache()

    # 13c: the same widths in float32 at TP_F32_LAYERS layers
    cfg = _tp_cfg("float32", TP_F32_LAYERS)
    engine = ServeEngine(placed(cfg), max_len=TP_PROMPT + TP_STEPS)
    with act.activation_sharding(rules, serve=True):
        out["f32"] = _tp_steps(torch, engine,
                               _tp_full_inputs(torch, cfg, greedy), None,
                               TP_PROMPT)[0]
    del engine
    out["kernel_launches"] = sum(
        sum(now.values()) - sum(then.values()) for now, then in zip(
            (fk.launches, mk.launches, pk.launches), kernels0))
    if rank != 0:
        out["smoke"], out["f32"] = {}, []
    return out


def _tp_within_spread(torch, name, dtype, toks, pe):
    """13a bf16 beyond 2e-2: no further from the one-process run than that
    run's own logits move under a one-ulp change of one embedding weight
    (10a's end-to-end bar)."""
    from repro_torch.models import LM
    cfg = dataclasses.replace(_smoke(name), param_dtype=dtype)
    model = LM(cfg, device=CARD, seed=0)
    toks, pe = toks.to(CARD), None if pe is None else pe.to(CARD)
    with torch.inference_mode():
        base = model.forward_train(toks, pe)[0]
        emb = model.embed.data
        tok = int(toks[0, 3, 0] if cfg.n_codebooks else toks[0, 3])
        row = emb[0] if cfg.n_codebooks else emb
        row[tok, 5] = (row[tok, 5].view(torch.int16) + 1).view(torch.bfloat16)
        bumped = model.forward_train(toks, pe)[0]
    return _within(bumped, base, 0.0)[1]


def tp_phase(torch, out_dir) -> dict:
    """Phase 13: the one-process references, then a (1, 2) world of ranks
    sharing the card under the "tp" rules: 13a every smoke architecture
    (float32 at 1e-4, bf16 at 2e-2), 13b qwen2.5-14b at its published
    widths (each step's logits within TP_BAR of the one-process logits'
    std), 13c its widths in float32 at 2 layers (1e-4).  Raises at its
    end if any check failed."""
    from repro_torch.dist.world import choose_backend, run_world
    from repro_torch.launch import analytic
    from repro_torch.launch import serve as lserve
    from repro_torch.models.config import ShapeConfig
    lserve.set_numerics()
    gc.collect()
    torch.cuda.empty_cache()
    bars = Bars()
    t_phase = time.perf_counter()
    cases = _tp_smoke_cases(torch)
    t0 = time.perf_counter()
    ref = tp_reference(torch, cases)
    ref_s = time.perf_counter() - t0
    log(f"13: one-process references in {ref_s:.1f} s; {TP_RANKS} ranks on "
        f"{torch.cuda.device_count()} card(s) over "
        f"{choose_backend('cuda', TP_RANKS)}")
    t0 = time.perf_counter()
    with MemoryPoll() as mem:
        res = run_world(tp_rank, TP_RANKS, device=CARD,
                        store_dir=str(out_dir / "world13"),
                        args=(cases, ref["full"]["greedy"]),
                        threads=TP_THREADS)
    world_s = time.perf_counter() - t0
    out = {"world_s": world_s, "reference_s": ref_s,
           "smi_peak_mib": mem.peak_mib,
           "kernel_launches": res["kernel_launches"], "smoke": {}}

    # 13a
    for (name, dtype, toks, pe) in cases:
        got, want = res["smoke"][(name, dtype)], ref["smoke"][(name, dtype)]
        tol = LM_TOL[dtype]
        errs = [_within(g, w, tol) for g, w in zip(got, want)]
        worst = max(e for _, e in errs)
        ok = all(o for o, _ in errs)
        spread = None
        if not ok and dtype == "bfloat16":
            spread = _tp_within_spread(torch, name, dtype, toks, pe)
            ok = worst <= spread
        bars.check(ok, f"13a {name} {dtype}: prefill and {LM_SMOKE_DECODE} "
                       f"decode steps on (1, {TP_RANKS}) against one "
                       f"process, max |d| {worst:.3e} (bar {tol}" + (
                           "" if spread is None else
                           f"; beyond it, the one process's own one-ulp "
                           f"spread {spread:.3e}") + ")")
        out["smoke"][f"{name} {dtype}"] = {"max_abs_err": worst,
                                           "one_ulp_spread": spread}
    log(f"13a: {len(cases)} cases in {res['smoke_s']:.1f} s in the world")

    # 13b
    f, r = res["full"], ref["full"]
    cfg = _tp_cfg("bfloat16")
    std = float(torch.cat([x.flatten() for x in r["logits"]]).std())
    errs = [_within(g, w, 0.0)[1] for g, w in zip(f["logits"], r["logits"])]
    bars.check(max(errs) <= TP_BAR * std,
               f"13b {LM_ARCH} (1, {TP_RANKS}): prefill of {TP_B} x "
               f"{TP_PROMPT} and {TP_STEPS} decode steps fed the one "
               f"process's picks: max |d| {max(errs):.4f} = "
               f"{max(errs) / std:.4f} of the one-process logits' std "
               f"{std:.4f} (bar {TP_BAR}); prefill |d| {errs[0]:.4f}")
    rows = f["rows"]
    pre, dec = rows[0], rows[1:]
    dec_ms = statistics.median(1e3 * x["s"] for x in dec)
    one_pre, one_dec = r["secs"][0], statistics.median(r["secs"][1:])
    prefill_flops = analytic.cell_flops(cfg, ShapeConfig(
        "13b_prefill", "prefill", TP_PROMPT, TP_B))["fwd_flops"]
    decode_flops = analytic.cell_flops(cfg, ShapeConfig(
        "13b_decode", "decode", TP_PROMPT + TP_STEPS // 2, TP_B))[
        "fwd_flops"]
    kv_bytes = (2 * cfg.n_layers * TP_B * cfg.n_kv_heads * cfg.head_dim * 2
                * (TP_PROMPT + TP_STEPS // 2))
    decode_bytes = r["weight_bytes"] - cfg.vocab_size * cfg.d_model * 2 \
        + kv_bytes
    bound_pre = prefill_flops / BF16_FLOPS
    bound_dec = max(decode_flops / BF16_FLOPS, decode_bytes / HBM_BYTES_PER_S)
    log(f"13b {LM_ARCH}: {r['n_params']:,} parameters, "
        f"{r['weight_bytes'] / 1e9:.3f} GB; placed on each rank in "
        f"{f['init_s']:.2f} s (one process draws the whole model in "
        f"{r['init_s']:.2f} s)")
    log(f"13b prefill of {TP_B} x {TP_PROMPT}: {pre['s']:.3f} s on "
        f"(1, {TP_RANKS}) against {one_pre:.3f} s in one process (bound "
        f"{1e3 * bound_pre:.1f} ms: {prefill_flops / 1e12:.2f} TFLOP of "
        f"launch.analytic at {BF16_FLOPS / 1e12:.0f} TFLOP/s); "
        f"{TP_B * TP_PROMPT / pre['s']:.0f} prompt tokens/s")
    log(f"13b decode step, batch {TP_B}: median {dec_ms:.2f} ms "
        f"(range {1e3 * min(x['s'] for x in dec):.2f}-"
        f"{1e3 * max(x['s'] for x in dec):.2f}) against {1e3 * one_dec:.2f} "
        f"ms in one process (bound {1e3 * bound_dec:.2f} ms: "
        f"{decode_bytes / 1e9:.2f} GB of weights and cache at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; {decode_flops / 1e9:.1f} "
        f"GFLOP); {TP_B * 1e3 / dec_ms:.1f} generated tokens/s")
    for label, x in (("prefill", pre), ("decode step (median)",
                                        sorted(dec, key=lambda y: y["s"])[
                                            len(dec) // 2])):
        log(f"13b collectives a {label}: {x['collective_calls']} calls, "
            f"{x['collective_bytes'] / 1e9:.4f} GB, "
            f"{x['collective_seconds']:.3f} s host "
            f"({x['collective_copy_seconds']:.3f} s of it host copies), "
            f"{100 * x['collective_seconds'] / x['s']:.1f}% of it; weights "
            f"gathered {x['gathered_calls']} ({x['gathered_bytes']} bytes)")
    half = r["weight_bytes"] / 2
    bars.check(abs(f["resident_bytes"] - half) <= f["whole_bytes"],
               f"13b rank 0 holds {f['resident_bytes'] / 1e9:.4f} GB of "
               f"weights against half the model's "
               f"{half / 1e9:.4f} GB ({f['split_bytes'] / 1e9:.4f} GB of "
               f"slices, {f['whole_bytes'] / 1e6:.3f} MB of vectors kept "
               f"whole)")
    gathered = max(x["gathered_bytes"] for x in dec)
    bars.check(gathered < 0.01 * f["resident_bytes"],
               f"13b weight bytes gathered a decode step {gathered} (under "
               f"1% of a rank's weights)")
    log(f"13b KV cache a layer on rank 0 {f['cache_k']} (its KV heads); "
        f"peak rank 0 {f['peak_gb']:.2f} GB ({f['place_peak_gb']:.2f} GB "
        f"while placing); one process {r['peak_gb']:.2f} GB; nvidia-smi "
        f"peak {mem.peak_mib} MiB; world {world_s:.1f} s")
    out["full"] = {
        "n_params": r["n_params"], "weight_bytes": r["weight_bytes"],
        "rows": rows, "max_abs_err": max(errs), "logits_std": std,
        "prefill_s": pre["s"], "decode_ms_median": dec_ms,
        "tokens_per_s": TP_B * 1e3 / dec_ms,
        "one_process": {"prefill_s": one_pre, "decode_ms_median":
                        1e3 * one_dec, "peak_gb": r["peak_gb"]},
        "prefill_bound_ms": 1e3 * bound_pre,
        "decode_bound_ms": 1e3 * bound_dec,
        "analytic_flops": {"prefill": prefill_flops,
                           "decode": decode_flops},
        **{k: f[k] for k in ("init_s", "resident_bytes", "split_bytes",
                             "whole_bytes", "place_peak_gb", "peak_gb",
                             "cache_k")}}

    # 13c
    errs = [_within(g, w, LM_TOL["float32"])
            for g, w in zip(res["f32"], ref["f32"])]
    worst = max(e for _, e in errs)
    bars.check(all(o for o, _ in errs),
               f"13c {LM_ARCH} widths, {TP_F32_LAYERS} layers, float32: "
               f"prefill of {TP_B} x {TP_PROMPT} and {TP_STEPS} decode "
               f"steps on (1, {TP_RANKS}) against one process, max |d| "
               f"{worst:.3e} (bar {LM_TOL['float32']})")
    out["f32"] = {"max_abs_err": worst}
    bars.check(res["kernel_launches"] == 0,
               f"13: B1-B4 launched {res['kernel_launches']} times in the "
               f"world (the LM path reaches none)")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 13 in {out['phase_s']:.1f} s")
    bars.raise_if_failed("phase 13")
    return out

# -- phase 14: LM training under the "tp" rules over ranks -----------------

TPT_RANKS = 2                  # a (1, 2) ("data", "model") world on the card
TPT_ARCH = "mixtral-8x7b"
TPT_LAYERS = 1                 # 14b: two layers' state on two ranks (38 GB
#                                each) would not fit one card
TPT_B, TPT_S = 4, 4096         # train_4k's sequence; its batch of 256 cut
TPT_STEPS = 2
TPT_TOL = 2e-2                 # 14b: each loss; each grad norm, relative
TPT_SMOKE = ("mixtral-8x7b", "qwen2.5-14b")     # 14a, float32, TF32 off
TPT_SMOKE_TOL = 1e-4
#: the ranks' allocator: two ranks' state and activations share the card
TPT_ALLOC = "expandable_segments:True"


def _tpt_cfg():
    from repro_torch import configs
    return dataclasses.replace(configs.get(TPT_ARCH), n_layers=TPT_LAYERS)


def _scaled_err(got, want) -> float:
    """The largest |got - want| of any leaf over that leaf's largest
    |want| plus 1e-8 of the largest |want| of all (lists of tensors)."""
    top = max(float(w.abs().max()) for w in want)
    return max(float((g - w).abs().max())
               / (float(w.abs().max()) + 1e-8 * top + 1e-30)
               for g, w in zip(got, want))


def _tpt_smoke_side(torch, rules) -> dict:
    """14a on this process under `rules` (a (1, 1) mesh in the parent,
    (1, 2) in the world): per architecture `LM(cfg, seed=0)` at its
    float32 smoke config (the MoE at capacity factor 1) on the card, the
    loss and every gradient of one batch, then one make_train_step step
    at accum 2 (loss, grad norm, every first moment), on the CPU."""
    from repro_torch.dist import act
    from repro_torch.dist.sharding import batch_shardings, reshard
    from repro_torch.models import LM
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import (_batch_axes, _value_and_grad,
                                              make_train_step)
    from repro_torch.tree import leaves, members

    def host(tree):
        return [m.detach().float().cpu() for leaf in leaves(tree)
                for m in members(leaf)]
    out = {}
    for name in TPT_SMOKE:
        cfg = dataclasses.replace(_smoke(name), param_dtype="float32")
        if cfg.moe:
            cfg = dataclasses.replace(cfg, capacity_factor=1.0)
        model = LM(cfg, device=CARD, seed=0)
        b = _train_batch(torch, cfg, TRAIN_SMOKE_B, TRAIN_SMOKE_S)
        b = {k: v.to(CARD) for k, v in b.items()}
        batch = reshard(b, batch_shardings(rules, b))
        params = model.param_tree()
        with act.activation_sharding(rules):
            loss, grads = _value_and_grad(model, params, batch,
                                          *_batch_axes(batch))
            grads = host(grads)
            state = {"params": params, "opt": adamw_init(params)}
            step = make_train_step(model, AdamWConfig(
                peak_lr=TRAIN_SMOKE_LR), accum_steps=2)
            state, m = step(state, batch)
        out[name] = {"loss": float(loss), "grads": grads,
                     "step_loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "mu": host(state["opt"]["mu"])}
        del model, params, grads, state
    return out


def _tpt_full(torch, mesh) -> dict:
    """14b on this process's `mesh`: mixtral-8x7b at its published widths
    cut to TPT_LAYERS, bf16, `LM(cfg, seed=0)` on the card, stepped by
    `specs.build_cell(TPT_ARCH, "train_4k", mesh, model=...)`'s function
    (the "tp" policy, the cell's AdamW) on SyntheticTokens(seed=0)
    batches of TPT_B x TPT_S: per step the loss, grad norm, s, the
    collectives and the gradient sums over "model"; the peak."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.dist import comm
    from repro_torch.dist.sharding import (MODEL_SUMS, batch_shardings,
                                           reset_model_sums, reshard)
    from repro_torch.launch import specs
    from repro_torch.models import LM
    from repro_torch.train.optimizer import adamw_init
    cfg = _tpt_cfg()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = LM(cfg, device=CARD, seed=0)
    cell = specs.build_cell(TPT_ARCH, "train_4k", mesh, model=model)
    rules = cell.meta["rules"]
    params = reshard(model.param_tree(), cell.in_shardings[0]["params"])
    state = {"params": params, "opt": adamw_init(params)}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data = SyntheticTokens(cfg.vocab_size, TPT_B, TPT_S, seed=0,
                           device=CARD)
    rows = []
    for i in range(TPT_STEPS):
        batch = data(i)
        batch = reshard(batch, batch_shardings(rules, batch))
        torch.cuda.synchronize()
        comm.reset_stats()
        reset_model_sums()
        t1 = time.perf_counter()
        state, m = cell.fn(state, batch)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        rows.append({"step": i + 1, "loss": loss, "grad_norm": gn,
                     "lr": float(m["lr"]), "s": time.perf_counter() - t1,
                     "model_sum_calls": MODEL_SUMS["calls"],
                     "model_sum_bytes": MODEL_SUMS["bytes"],
                     **{f"collective_{k}": v for k, v in
                        comm.STATS.items()}})
    n_params = sum(p.numel() for p in model.parameters())
    out = {"rows": rows, "policy": cell.meta["policy"], "init_s": init_s,
           "n_params": n_params,
           "weight_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters()),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del model, cell, params, state, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tpt_rank(rank: int) -> dict:
    """A rank of phase 14's (1, 2) world on the card under the "tp"
    rules: 14a, then 14b; every rank's peak; B1-B4's launches."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.kernels.fused_superstep import kernel as fk
    from repro_torch.kernels.mj_spmm import kernel as mk
    from repro_torch.kernels.priority_pairs import kernel as pk
    from repro_torch.launch import serve as lserve
    from repro_torch.launch.mesh import make_host_mesh
    lserve.set_numerics()
    kernels0 = (dict(fk.launches), dict(mk.launches), dict(pk.launches))
    mesh = make_host_mesh(model_axis=TPT_RANKS, device=CARD)
    t0 = time.perf_counter()
    out = {"smoke": _tpt_smoke_side(torch, ShardingRules(mesh, "tp"))}
    out["smoke_s"] = time.perf_counter() - t0
    out["full"] = _tpt_full(torch, mesh)
    peaks = [torch.zeros(1, dtype=torch.float64)
             for _ in range(dist.get_world_size())]
    dist.all_gather(peaks, torch.tensor([out["full"]["peak_gb"]],
                                        dtype=torch.float64))
    out["peaks_gb"] = [float(p) for p in peaks]
    out["kernel_launches"] = sum(
        sum(now.values()) - sum(then.values()) for now, then in zip(
            (fk.launches, mk.launches, pk.launches), kernels0))
    if rank != 0:
        out["smoke"] = {}
    return out


def tpt_phase(torch, out_dir) -> dict:
    """Phase 14: one process on the card (14a's smoke configs, 14b), then
    a (1, 2) world of ranks sharing the card under the "tp" rules: 14a at
    TPT_SMOKE_TOL, 14b's losses within TPT_TOL of the one process and its
    grad norms within TPT_TOL relative.  Raises at its end if any check
    failed."""
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.dist.world import choose_backend, run_world
    from repro_torch.launch import analytic
    from repro_torch.launch import serve as lserve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import ShapeConfig
    lserve.set_numerics()
    gc.collect()
    torch.cuda.empty_cache()
    bars = Bars()
    t_phase = time.perf_counter()
    one = make_host_mesh(device=CARD)
    ref_smoke = _tpt_smoke_side(torch, ShardingRules(one, "tp"))
    ref = _tpt_full(torch, one)
    ref_s = time.perf_counter() - t_phase
    log(f"14: one-process references in {ref_s:.1f} s; {TPT_RANKS} ranks "
        f"on {torch.cuda.device_count()} card(s) over "
        f"{choose_backend('cuda', TPT_RANKS)}")
    t0 = time.perf_counter()
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = TPT_ALLOC     # the ranks' own
    try:
        with MemoryPoll() as mem:
            res = run_world(tpt_rank, TPT_RANKS, device=CARD,
                            store_dir=str(out_dir / "world14"),
                            threads=TP_THREADS)
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    world_s = time.perf_counter() - t0
    out = {"world_s": world_s, "reference_s": ref_s,
           "smi_peak_mib": mem.peak_mib,
           "kernel_launches": res["kernel_launches"], "smoke": {}}

    # 14a
    for name in TPT_SMOKE:
        g, w = res["smoke"][name], ref_smoke[name]
        errs = {"loss": abs(g["loss"] - w["loss"]),
                "grads": _scaled_err(g["grads"], w["grads"]),
                "step_loss": abs(g["step_loss"] - w["step_loss"]),
                "grad_norm": abs(g["grad_norm"] - w["grad_norm"])
                / w["grad_norm"],
                "mu": _scaled_err(g["mu"], w["mu"])}
        tol = TPT_SMOKE_TOL
        ok = (errs["loss"] <= tol * (1 + abs(w["loss"]))
              and errs["step_loss"] <= tol * (1 + abs(w["step_loss"]))
              and errs["grads"] <= tol and errs["grad_norm"] <= tol
              and errs["mu"] <= tol)
        bars.check(ok, f"14a {name} float32 smoke on (1, {TPT_RANKS}) "
                       f"against one process: loss |d| "
                       f"{errs['loss']:.2e}, gradients "
                       f"{errs['grads']:.2e} of each leaf's largest, step "
                       f"(accum 2) loss |d| {errs['step_loss']:.2e}, grad "
                       f"norm {errs['grad_norm']:.2e} relative, mu "
                       f"{errs['mu']:.2e} (bar {tol})")
        out["smoke"][name] = errs
    log(f"14a: {len(TPT_SMOKE)} cases in {res['smoke_s']:.1f} s in the "
        f"world")

    # 14b
    f = res["full"]
    cfg = _tpt_cfg()
    bars.check(f["policy"] == "tp" and ref["policy"] == "tp",
               f"14b build_cell({TPT_ARCH!r}, 'train_4k') chose "
               f"{f['policy']!r} on (1, {TPT_RANKS}) and {ref['policy']!r}"
               f" on one device")
    for g, w in zip(f["rows"], ref["rows"]):
        dl = abs(g["loss"] - w["loss"])
        dg = abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
        bars.check(dl <= TPT_TOL and dg <= TPT_TOL and
                   np.isfinite(g["loss"]),
                   f"14b step {g['step']}: loss {g['loss']:.5f} against "
                   f"{w['loss']:.5f} in one process (|d| {dl:.2e}, bar "
                   f"{TPT_TOL}); grad norm {g['grad_norm']:.5f} against "
                   f"{w['grad_norm']:.5f} ({dg:.2e} relative, bar "
                   f"{TPT_TOL})")
    tokens = TPT_B * TPT_S
    an = analytic.cell_flops(cfg, ShapeConfig("14b", "train", TPT_S, TPT_B))
    bound_s = an["hlo_est_flops"] / BF16_FLOPS
    log(f"14b {TPT_ARCH} at its published widths, {TPT_LAYERS} layer(s), "
        f"bf16: {f['n_params']:,} parameters, {f['weight_bytes'] / 1e9:.3f}"
        f" GB; drawn and placed on each rank in {f['init_s']:.2f} s")
    for g, w in zip(f["rows"], ref["rows"]):
        share = g["collective_seconds"] / g["s"]
        log(f"14b step {g['step']}: {g['s']:.3f} s on (1, {TPT_RANKS}) "
            f"({tokens / g['s']:.0f} tokens/s) against {w['s']:.3f} s in "
            f"one process ({tokens / w['s']:.0f} tokens/s); "
            f"launch.analytic's bound {bound_s * 1e3:.1f} ms "
            f"({an['hlo_est_flops'] / 1e12:.2f} TFLOP at "
            f"{BF16_FLOPS / 1e12:.0f} TFLOP/s); collectives "
            f"{g['collective_calls']} calls, "
            f"{g['collective_bytes'] / 1e9:.4f} GB, "
            f"{g['collective_seconds']:.3f} s host "
            f"({g['collective_copy_seconds']:.3f} s of it host copies), "
            f"{100 * share:.1f}% of the step; gradient sums over \"model\" "
            f"{g['model_sum_calls']} calls, "
            f"{g['model_sum_bytes'] / 1e9:.4f} GB")
    log(f"14b peak a rank {', '.join(f'{p:.2f}' for p in res['peaks_gb'])}"
        f" GB against {ref['peak_gb']:.2f} GB in one process; nvidia-smi "
        f"peak {mem.peak_mib} MiB; world {world_s:.1f} s")
    out["full"] = {
        "arch": TPT_ARCH, "layers": TPT_LAYERS, "batch": [TPT_B, TPT_S],
        "n_params": f["n_params"], "weight_bytes": f["weight_bytes"],
        "rows": f["rows"], "one_process": {"rows": ref["rows"],
                                           "peak_gb": ref["peak_gb"]},
        "peaks_gb": res["peaks_gb"], "init_s": f["init_s"],
        "analytic_flops": an["hlo_est_flops"], "bound_ms": 1e3 * bound_s}
    bars.check(res["kernel_launches"] == 0,
               f"14: B1-B4 launched {res['kernel_launches']} times in the "
               f"world (the LM path reaches none)")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 14 in {out['phase_s']:.1f} s")
    bars.raise_if_failed("phase 14")
    return out


# -- phase 15: the dry run held against the card ----------------------------

#: 15a: single-pod (16, 16) cells at their published widths, each in a
#: process of its own (they need no card: meta tensors in a fake world)
DRY_CELLS = (("qwen2.5-14b", "decode_32k"), ("minicpm-2b", "train_4k"),
             ("mixtral-8x7b", "train_4k"))
DRY_ARCH = "minicpm-2b"        # 15b: published widths cut to 4 layers, 11b's
DRY_LAYERS = 4                 # batch of 8 x 2048, on a (1, 1) mesh
DRY_STEPS = 2
DRY_PEAK_TOL = 0.15            # 15b/15c: the predicted peak, relative
DRY_FLOP_BAND = (0.5, 2.0)     # 15b: counted FLOPs over the analytic fwd x 3
DRY_TIMEOUT_S = 600            # 15a's processes


def _dry_cfg():
    from repro_torch import configs
    return dataclasses.replace(configs.get(DRY_ARCH), n_layers=DRY_LAYERS)


def _dry_shape(b, s):
    from repro_torch.models.config import ShapeConfig
    return ShapeConfig(f"train_{b}x{s}", "train", s, b)


def _dry_card(torch, cfg, shape) -> dict:
    """15b on the card: the cell of `dryrun.placed_cell` (the port's
    `specs.build_cell(..., shape=)` train cell on a (1, 1) mesh, the LM
    drawn from seed 0) stepped DRY_STEPS times on SyntheticTokens(seed=0)
    batches: the bytes of the placed state and batch, each step's peak
    (`max_memory_allocated`, reset before the step), loss and s, and
    `FlopCounterMode`'s count of the first step."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cell, (state, batch) = dryrun.placed_cell(
        DRY_ARCH, "train_4k", make_host_mesh(device=CARD), device=CARD,
        cfg=cfg, shape=shape)
    data = SyntheticTokens(cfg.vocab_size, shape.global_batch,
                           shape.seq_len, seed=0, device=CARD)
    out = {"policy": cell.meta["policy"], "before_bytes": before,
           "arg_bytes": dryrun.tensor_bytes(dryrun.members_of(
               (state, batch))), "rows": []}
    del batch
    for i in range(DRY_STEPS):
        batch = data(i)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fc = FlopCounterMode(display=False)
        t0 = time.perf_counter()
        with fc if i == 0 else contextlib.nullcontext():
            state, m = cell.fn(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        out["rows"].append({"step": i + 1, "loss": loss,
                            "grad_norm": float(m["grad_norm"]),
                            "s": time.perf_counter() - t0,
                            "peak_bytes": torch.cuda.max_memory_allocated(),
                            "flops": (float(fc.get_total_flops()) if i == 0
                                      else None)})
        del m, batch
    del cell, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _dry_procs(out_dir: Path) -> list:
    """15a's dry runs started, one process a cell: (cell, process, path).
    They need no card and about a minute of the host's CPU, so the whole
    script starts them beside 12d's child (a correctness check of the
    restart loop, whose times no bar holds), where they add nothing to
    its time."""
    root = Path(__file__).resolve().parent
    # one thread each: meta tensors compute nothing, and four processes
    # (these three and this one) share the host's cores
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    procs = []
    for arch, shape in DRY_CELLS:
        path = out_dir / f"dryrun15a_{arch}_{shape}.json"
        if path.exists():
            path.unlink()
        procs.append(((arch, shape), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out",
             str(path)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), path))
    return procs


def dry_phase(torch, out_dir, tp_train, procs=None) -> dict:
    """Phase 15: 15a the dry run's tables for DRY_CELLS (processes of
    their own: `procs` of `_dry_procs` where already started, else
    started here; meanwhile:) 15b a cut minicpm-2b trained on the card
    against its dry run, 15c (when phase 14 ran: `tp_train`) 14b's cell
    in a fake world of 2 against 14b's collectives and peaks.  Raises at
    its end if any check failed."""
    if not procs:
        procs = _dry_procs(out_dir)
    try:
        return _dry_checks(torch, out_dir, tp_train, procs)
    finally:
        _stop(procs)


def _stop(procs) -> None:
    """Kill those of `procs` (`_dry_procs`'s) still running."""
    for _, proc, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _dry_checks(torch, out_dir, tp_train, procs) -> dict:
    """`dry_phase`'s body, 15a's processes started."""
    from repro_torch.kernels.fused_superstep import kernel as fk
    from repro_torch.kernels.mj_spmm import kernel as mk
    from repro_torch.kernels.priority_pairs import kernel as pk
    from repro_torch.launch import analytic, cost, dryrun, report
    bars = Bars()
    t_phase = time.perf_counter()
    kernels0 = [sum(k.launches.values()) for k in (fk, mk, pk)]
    card = card_line()
    out = {"card": card}
    total = torch.cuda.get_device_properties(0).total_memory
    bars.check(cost.HBM_PER_CARD == total,
               f"15 cost.HBM_PER_CARD {cost.HBM_PER_CARD:,} = the card's "
               f"total_memory {total:,} ({card})")
    log(f"15: the dry run's published figures ({card}): "
        f"{cost.PEAK_FLOPS / 1e12:.1f} TFLOP/s dense bf16, HBM "
        f"{cost.HBM_BW / 1e12:.2f} TB/s, NVLink {cost.NVLINK_BW / 1e9:.0f}"
        f" GB/s within a node of {cost.NODE_SIZE}, network "
        f"{cost.NETWORK_BW / 1e9:.0f} GB/s between nodes")

    # 15b
    cfg, shape = _dry_cfg(), _dry_shape(TRAIN_B, TRAIN_S)
    t0 = time.perf_counter()
    got = _dry_card(torch, cfg, shape)
    card_s = time.perf_counter() - t0
    pred = dryrun.run_cell(DRY_ARCH, "train_4k", False, cfg=cfg,
                           shape=shape, mesh_shape=(1, 1))
    an = analytic.cell_flops(cfg, shape)
    fwd3 = 3 * an["fwd_flops"]
    bars.check(got["policy"] == pred["policy"] == "dp",
               f"15b policy {got['policy']!r} on the card, "
               f"{pred['policy']!r} in the dry run")
    bars.check(pred["arg_bytes_per_dev"] == got["arg_bytes"]
               and pred["arg_bytes_analytic"] == got["arg_bytes"] + 4,
               f"15b argument bytes: the placed state and batch on the card "
               f"{got['arg_bytes']:,}; the dry run's "
               f"{pred['arg_bytes_per_dev']:,} held, "
               f"{pred['arg_bytes_analytic']:,} by the reference's rule "
               f"(the step's int32, a host int in the port, its 4 bytes)")
    flops = got["rows"][0]["flops"]
    bars.check(pred["hlo_flops_per_dev"] == flops,
               f"15b FLOPs: the dry run's {pred['hlo_flops_per_dev']:.6e} "
               f"= FlopCounterMode's {flops:.6e} of step 1 on the card")
    ratio = flops / fwd3
    bars.check(DRY_FLOP_BAND[0] < ratio < DRY_FLOP_BAND[1],
               f"15b FLOPs {ratio:.3f}x launch.analytic's forward x 3 "
               f"({fwd3:.6e}; band {DRY_FLOP_BAND})")
    for r in got["rows"]:
        err = pred["peak_bytes_per_dev"] / r["peak_bytes"] - 1
        bars.check(abs(err) <= DRY_PEAK_TOL and np.isfinite(r["loss"]),
                   f"15b step {r['step']}: peak {r['peak_bytes'] / 1e9:.3f}"
                   f" GB (max_memory_allocated, reset before the step; "
                   f"{got['before_bytes'] / 1e6:.1f} MB allocated before the"
                   f" cell) against the dry run's "
                   f"{pred['peak_bytes_per_dev'] / 1e9:.3f} GB ({100 * err:+.1f}"
                   f"%, bar {100 * DRY_PEAK_TOL:.0f}%); loss "
                   f"{r['loss']:.5f}, {r['s']:.3f} s")
    log(f"15b {DRY_ARCH} at its published widths, {DRY_LAYERS} layers, "
        f"{shape.global_batch} x {shape.seq_len}: on the card in "
        f"{card_s:.1f} s; dry run traced in {pred['trace_s']:.1f} s "
        f"(peak by kind {pred['peak_by_kind']}, resident "
        f"{pred['resident_bytes_per_dev'] / 1e9:.3f} GB, temp "
        f"{pred['temp_bytes_per_dev'] / 1e9:.3f} GB)")
    out["15b"] = {"card": got, "dry": {k: pred[k] for k in (
        "arg_bytes_per_dev", "arg_bytes_analytic", "peak_bytes_per_dev",
        "temp_bytes_per_dev", "hlo_flops_per_dev", "trace_s",
        "peak_by_kind", "roofline")}, "analytic_fwd3": fwd3}

    # 15c
    if tp_train is not None:
        f = tp_train["full"]
        c_cfg = _tpt_cfg()
        c_shape = _dry_shape(TPT_B, TPT_S)
        preds = [dryrun.run_cell(TPT_ARCH, "train_4k", False, cfg=c_cfg,
                                 shape=c_shape, mesh_shape=(1, TPT_RANKS),
                                 rank=r) for r in range(TPT_RANKS)]
        p0 = preds[0]
        for row in f["rows"]:
            bars.check(p0["comm_calls"] == row["collective_calls"]
                       and p0["comm_bytes"] == row["collective_bytes"],
                       f"15c step {row['step']}: the fake world's "
                       f"{p0['comm_calls']} calls of "
                       f"{p0['comm_bytes'] / 1e9:.4f} GB = 14b rank 0's "
                       f"{row['collective_calls']} of "
                       f"{row['collective_bytes'] / 1e9:.4f} GB")
        for r, (p, peak) in enumerate(zip(preds, f["peaks_gb"])):
            err = p["peak_bytes_per_dev"] / (peak * 1e9) - 1
            bars.check(abs(err) <= DRY_PEAK_TOL,
                       f"15c rank {r}: 14b's peak {peak:.3f} GB against the "
                       f"dry run's {p['peak_bytes_per_dev'] / 1e9:.3f} GB "
                       f"({100 * err:+.1f}%, bar "
                       f"{100 * DRY_PEAK_TOL:.0f}%)")
        c = p0["collectives"]
        log(f"15c {TPT_ARCH} at 1 layer, {TPT_B} x {TPT_S}, (1, "
            f"{TPT_RANKS}), rank 0: wire {c['total_wire_bytes'] / 1e9:.4f}"
            f" GB a device ({c['nvlink_wire_bytes'] / 1e9:.4f} over NVLink)"
            f", roofline {p0['roofline']}; traced in "
            f"{p0['trace_s']:.1f} + {preds[1]['trace_s']:.1f} s")
        out["15c"] = [{k: p[k] for k in (
            "rank", "comm_calls", "comm_bytes", "peak_bytes_per_dev",
            "collectives", "roofline", "trace_s")} for p in preds]
    else:
        log("15c: phase 14 did not run in this invocation; skipped")

    # 15a
    records = []
    for (arch, shape_name), proc, path in procs:
        try:
            text, _ = proc.communicate(timeout=DRY_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
        ok = proc.returncode == 0 and path.exists()
        recs = json.loads(path.read_text()) if path.exists() else []
        bars.check(ok and len(recs) == 1 and recs[0]["status"] == "ok",
                   f"15a {arch} {shape_name} (16, 16): exit "
                   f"{proc.returncode}: {text.strip().splitlines()[-1:]}")
        records.extend(recs)
    print(report.dryrun_table(records), flush=True)
    print(report.roofline_table(records), flush=True)
    out["15a"] = [{k: r.get(k) for k in (
        "arch", "shape", "mesh", "status", "policy", "trace_s",
        "arg_bytes_analytic", "arg_bytes_per_dev", "peak_bytes_per_dev",
        "fits_80gb", "collectives", "hlo_flops_per_dev",
        "model_flops_ratio", "roofline")} for r in records]
    out["kernel_launches"] = sum(sum(k.launches.values()) - n for k, n in
                                 zip((fk, mk, pk), kernels0))
    bars.check(out["kernel_launches"] == 0,
               f"15: B1-B4 launched {out['kernel_launches']} times (the LM "
               f"path and the meta device reach none)")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 15 in {out['phase_s']:.1f} s")
    bars.raise_if_failed("phase 15")
    return out


# -- phase 16: the graph dry run and the analysis layer ----------------------

GRAPH_PEAK_BAR = 0.15          # 16b: predicted peak against the card's


def graph_session(csr, mesh, device):
    """8a's session as the graph dry run builds it (and as `mesh_rank`
    builds it): 8a's graph, block size, capacity and four jobs (both
    views), placed on `mesh` while empty, then submitted."""
    from repro_torch.core import GraphSession
    from repro_torch.dist.mesh2d import shard_session_2d
    sess = GraphSession(csr, BLOCK, capacity=CAPACITY, seed=0, device=device)
    shard_session_2d(mesh, sess)
    for alg in mesh_algs(2):
        sess.submit(alg)
    return sess


def graph_rank(torch, sess) -> dict:
    """16b in one rank of 8a's world: one recorded `Fused(steps_per_sync=1)`
    superstep with every job live on 8a's session as built (the session
    keeps its state: the carry is not written back), through B1/B2
    (counts set to 0 just before, read just after): its calls, the bytes
    the session holds, the card's memory around it (`max_memory_allocated`
    reset before), its launches and the carry's tile_pair_loads share."""
    from repro_torch.kernels.fused_superstep import kernel as fk
    from repro_torch.launch.graph_dryrun import recorded_step
    fk.reset_launches()
    rec = recorded_step(sess, count_flops=False)
    return dict(calls=[tuple(c) for c in rec["calls"]],
                resident=rec["resident_bytes"], base=rec["card_base_bytes"],
                peak=rec["card_peak_bytes"], launches=dict(fk.launches),
                pair_loads=int(rec["state"][5]), step_s=rec["trace_s"],
                q=int(sess.q))


def graph_records(torch, bars) -> list:
    """16a: the two published records of the paper's fleet on meta."""
    from repro_torch.launch import cost
    from repro_torch.launch import graph_dryrun as G
    total = torch.cuda.get_device_properties(0).total_memory
    bars.check(cost.HBM_PER_CARD == total,
               f"16a cost.HBM_PER_CARD {cost.HBM_PER_CARD:,} = the card's "
               f"total_memory {total:,}")
    recs = []
    for mp in (False, True):
        r = G.run(multi_pod=mp)
        recs.append(r)
        bars.check((r["q"], r["num_blocks"], r["vb"]) == (200, 2048, 512),
                   f"16a {r['mesh']}: q {r['q']}, B_N {r['num_blocks']}, "
                   f"Vb {r['vb']} (the reference's 200, 2048, 512)")
        bars.check(r["kernel_route"] == "B1/B2",
                   f"16a {r['mesh']}: kernel route {r['kernel_route']!r}")
        held = r["arg_bytes_per_dev"] + r["temp_bytes_per_dev"]
        log(f"16a {r['mesh']}: held {r['arg_bytes_per_dev']:,} B + temp "
            f"{r['temp_bytes_per_dev']:,} B a rank = {held / total:.3f} of "
            f"the card; wire {r['collectives']['total_wire_bytes']:,.0f} B "
            f"a superstep; traced in {r['trace_s']:.3f} s")
    log("16a the graph dry run's records (one rank, meta device):\n"
        + G.graph_table(recs))
    return recs


def graph_superstep(torch, csr, ranks, bars) -> dict:
    """16b's parent side: the dry run of `graph_session` in a fake world
    of 4 for every rank, against what each rank of 8a's world measured."""
    from repro_torch.graph.structure import block_adjacency
    from repro_torch.launch.graph_dryrun import dry_run_session
    rows = []
    for rank, got in enumerate(ranks):
        t0 = time.perf_counter()
        dry = dry_run_session(
            lambda mesh, dev: graph_session(csr, mesh, dev),
            (1, MESH_RANKS), rank)
        dry_s = time.perf_counter() - t0
        calls = [tuple(c) for c in dry["calls"]]
        bars.check(calls == got["calls"],
                   f"16b rank {rank}: {len(calls)} calls equal call for "
                   f"call (op, bytes, group, dtype, shape): "
                   f"{[(c[0], c[3], c[4]) for c in calls]}")
        bars.check(dry["resident_bytes"] == got["resident"],
                   f"16b rank {rank}: resident {dry['resident_bytes']:,} B "
                   f"in the dry run, {got['resident']:,} B on the card")
        other = got["base"] - got["resident"]
        pred = dry["peak_bytes"] + other
        rel = (pred - got["peak"]) / got["peak"]
        bars.check(abs(rel) <= GRAPH_PEAK_BAR,
                   f"16b rank {rank}: predicted peak {pred / 1e9:.3f} GB "
                   f"(the dry run's {dry['peak_bytes'] / 1e9:.3f} GB + "
                   f"{other / 1e6:.1f} MB the rank held besides) against "
                   f"max_memory_allocated {got['peak'] / 1e9:.3f} GB "
                   f"({100 * rel:+.1f}%, bar {100 * GRAPH_PEAK_BAR:.0f}%)")
        bars.check(all(got["launches"][sr] > 0 for sr in SEMIRINGS),
                   f"16b rank {rank}: B1/B2 launches {got['launches']}")
        rows.append(dict(rank=rank, calls=len(calls),
                         resident=got["resident"], pred_peak=pred,
                         card_peak=got["peak"], rel=rel,
                         dry_temp=dry["peak_bytes"] - dry["tracked_bytes"],
                         card_temp=got["peak"] - got["base"],
                         step_s=got["step_s"], dry_s=dry_s))
    q = ranks[0]["q"]
    est = 0.0
    for alg in mesh_algs(2)[::2]:            # one job of each view
        g = csr.symmetrized() if alg.graph_symmetrize else csr
        adj = block_adjacency(g, BLOCK, alg.graph_normalize)
        est += q * len(adj.tile_sb) / adj.num_blocks
    measured = sum(r["pair_loads"] for r in ranks)
    log(f"16b tile_pair_loads of the superstep: {measured} measured (both "
        f"views), the dry run's live-pair estimate q x pairs per block "
        f"{est:.0f} (no bar)")
    return dict(ranks=rows, tile_pair_loads=measured, live_estimate=est,
                launches={sr: sum(r["launches"][sr] for r in ranks)
                          for sr in SEMIRINGS})


def graph_analysis(torch, root, bars) -> dict:
    """16c: `analysis.contracts.check_all()` on the card (each chunk under
    `no_implicit_syncs`, the last bundle through B1/B2, counts set to 0
    just before and read just after), then the lint CLI over
    src/repro_torch."""
    from repro_torch.analysis import contracts
    from repro_torch.analysis.__main__ import main as lint_main
    from repro_torch.kernels.fused_superstep import kernel as fk
    t0 = time.perf_counter()
    fk.reset_launches()
    results = contracts.check_all()
    launches = dict(fk.launches)
    contracts_s = time.perf_counter() - t0
    for r in results:
        bars.check(r.ok, f"16c {r.name}: {r.detail}")
    bars.check(all(launches[sr] > 0 for sr in SEMIRINGS),
               f"16c B1/B2 launched by the contracts: {launches}")
    t0 = time.perf_counter()
    rc = lint_main([str(root / "src" / "repro_torch")])
    bars.check(rc == 0, f"16c python -m repro_torch.analysis src/repro_torch"
                        f" exits {rc} (empty baseline)")
    return dict(contracts=[r.to_dict() for r in results],
                contracts_s=contracts_s, lint_rc=rc,
                lint_s=time.perf_counter() - t0, launches=launches)


def graph_phase(torch, root, csr=None, ranks=None) -> dict:
    """Phase 16: 16a the fleet's published records, 16b (when 8a's world
    ran it: `ranks`) one superstep on every rank against the dry run of
    the same session, 16c the contracts and the lint on the card.
    Raises at its end if any check failed; returns 16d's figures."""
    bars = Bars()
    t_phase = time.perf_counter()
    card = card_line()
    out = {"card": card, "16a": graph_records(torch, bars)}
    zero = {sr: 0 for sr in SEMIRINGS}
    out["launches"] = {"16b": zero}
    if ranks is not None:
        out["16b"] = graph_superstep(torch, csr, ranks, bars)
        out["launches"]["16b"] = out["16b"]["launches"]
    out["16c"] = graph_analysis(torch, root, bars)
    out["launches"]["16c"] = out["16c"]["launches"]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 16 in {out['phase_s']:.1f} s ({card})")
    bars.raise_if_failed("phase 16")
    return out


# -- phase 17: the paper's block widths ------------------------------------

WIDE_N = 2**15                 # rmat_graph(2**15, 8): B_N 64 at Vb = 512
WIDE_VBS = (8, 256, 512)       # 17a: B1/B2/B3 at each width
WIDE_VB = 512                  # 17b: the paper's fleet's width
WIDE_PRIME_J = 7
WIDE_Q_B3 = 400                # B3's selected rows (all where B_N <= 400)


def wide_session(torch, csr, vb):
    """A CUDA session at block size `vb` with phase 3's four jobs: both
    views built (ELL tiles, then the pairs).  Returns (session, handles,
    {semiring: view group}, set-up s)."""
    from repro_torch.algorithms import (PageRank, PersonalizedPageRank,
                                        SSSP)
    from repro_torch.core import GraphSession
    t0 = time.perf_counter()
    sess = GraphSession(csr, vb, capacity=CAPACITY, seed=0)
    if not sess.use_pallas:
        raise RuntimeError("a CUDA session must push through the kernels")
    handles = [sess.submit(a) for a in [
        PageRank(), PersonalizedPageRank(source=PPR_SOURCE)] + [
        SSSP(source=s) for s in SSSP_SOURCES]]
    groups = {g.semiring: g for g in sess.view_groups()}
    for g in groups.values():
        sess._pair_data(g)
    torch.cuda.synchronize()
    return sess, handles, groups, time.perf_counter() - t0


def wide_fused(torch, timer, sess, groups, vb, device) -> dict:
    """17a, B1/B2: against the plain version on the view's real pairs,
    every source live, at J = 4 (timed beside the all-pairs bound), a
    prime J and, at the fleet's width, the width contract (d at B_N,
    outputs at B_loc = B_N/2).  Phase 2's bars."""
    from repro_torch.kernels.fused_superstep import kernel as fk
    from repro_torch.kernels.fused_superstep.ops import _pick_job_block
    from repro_torch.kernels.fused_superstep.ref import fused_superstep_ref

    figures = {}
    for semiring, grp in groups.items():
        bp = sess._pair_data(grp)
        bn = grp.graph.num_blocks
        rows_all = bp.dst_touched.cpu().numpy()
        rng = np.random.default_rng(vb + 31)
        cases = [(CAPACITY, bn), (WIDE_PRIME_J, bn)]
        if vb == WIDE_VB:
            cases.append((CAPACITY, bn // 2))
        f = dict(errs=[])
        for j, bn_loc in cases:
            d, base, vals = random_state(torch, rng, j, bn, bn_loc, vb,
                                         semiring, device)
            jb = _pick_job_block(j, vb, semiring)

            def kern():
                return fk.fused_superstep_call(
                    bp.src, bp.dst, bp.first, bp.last, d, base, bp.tiles,
                    values=vals, run_start=bp.run_start,
                    chunk_start=bp.chunk_start, chunk_run=bp.chunk_run,
                    arrivals=bp.arrivals(j // jb), semiring=semiring,
                    job_block=jb)

            def plain():
                return fused_superstep_ref(
                    bp.src, bp.dst, bp.first, bp.last, d, base, bp.tiles,
                    values=vals, semiring=semiring)

            before = fk.launches[semiring]
            got = kern()
            torch.cuda.synchronize()
            if fk.launches[semiring] != before + 1:
                raise AssertionError(f"17a {semiring} Vb={vb}: the wrapper "
                                     f"did not launch the kernel")
            want = plain()
            err = compare(semiring, got, want, rows_all[:bn_loc])
            f["errs"].append(err)
            log(f"  17a {semiring} Vb={vb}: J={j} jb={jb} B_loc={bn_loc} "
                f"P={bp.num_pairs} matches plain (max |err| {err:.3g})")
            if (j, bn_loc) != (CAPACITY, bn):
                continue
            del got, want
            k = timer(kern, R_B1B2)
            p = timer(plain, R_PLAIN)
            b_ms, b_by = bound(semiring, j, bn, bn_loc, vb, bp.num_pairs,
                               bp.num_runs)
            reads = j // jb
            log(f"  17a {semiring} Vb={vb}: kernel {fmt(k)}; plain "
                f"{fmt(p)}; bound {b_ms:.4f} ms ({b_by}); "
                f"{100 * b_ms / k['ms']:.1f}% of the bound; each tile "
                f"staged by {reads} thread block(s) (jb {jb}, "
                f"{fk.blocks_per_sm(jb, vb, semiring)} block(s) per SM, "
                f"{fk.smem_bytes(jb, vb)} B shared memory)")
            f.update(ms=k["ms"], host_ms_per_call=k["host_ms"],
                     queued=k["queued"], plain_ms=p["ms"], library_ms=None,
                     bound_ms=b_ms, bound_by=b_by, pairs=bp.num_pairs,
                     jb=jb, tile_reads=reads)
        f["max_abs_err"] = max(f.pop("errs"))
        figures[semiring] = f
        del d, base, vals
    return figures


def wide_mj_spmm(torch, timer, groups, vb, device) -> dict:
    """17a, B3: against the plain version on min(400, B_N) distinct rows
    of each view's real ELL tiles read at `tile_index` (push_shared's
    route), J = 4 (timed beside the bound) and a prime J."""
    from repro_torch.kernels.mj_spmm import kernel as mk
    from repro_torch.kernels.mj_spmm import mj_spmm
    from repro_torch.kernels.mj_spmm.ops import _pick_job_block
    from repro_torch.kernels.mj_spmm.ref import mj_spmm_ref

    figures = {}
    rng = np.random.default_rng(vb + 37)
    for semiring, grp in groups.items():
        tiles = grp.graph.tiles
        bn, k = tiles.shape[0], tiles.shape[1]
        q = min(WIDE_Q_B3, bn)
        idx = torch.as_tensor(rng.choice(bn, q, replace=False).astype(
            np.int32), device=device)
        f = dict(errs=[])
        for j in (CAPACITY, WIDE_PRIME_J):
            d = b3_state(torch, rng, q, j, vb, semiring, device)
            before = mk.launches[semiring]
            got = mj_spmm(d, tiles, semiring, tile_index=idx)
            torch.cuda.synchronize()
            if mk.launches[semiring] != before + 1:
                raise AssertionError(f"17a mj_spmm {semiring} Vb={vb}: the "
                                     f"wrapper did not launch the kernel")
            want = mj_spmm_ref(d, tiles, semiring, tile_index=idx)
            if semiring == "min_plus":
                np.testing.assert_array_equal(got.cpu().numpy(),
                                              want.cpu().numpy())
            else:
                np.testing.assert_allclose(got.cpu().numpy(),
                                           want.cpu().numpy(), rtol=1e-5,
                                           atol=1e-5)
            f["errs"].append(max_err(got, want))
            jb = _pick_job_block(j, vb)
            log(f"  17a mj_spmm {semiring} Vb={vb}: q={q} K={k} J={j} "
                f"jb={jb} matches plain (max |err| {f['errs'][-1]:.3g})")
            del got, want
            if j != CAPACITY:
                continue
            kt = timer(lambda: mj_spmm(d, tiles, semiring, tile_index=idx),
                       R_B3)
            p = timer(lambda: mj_spmm_ref(d, tiles, semiring,
                                          tile_index=idx), R_PLAIN)
            lib = None
            if semiring == "plus_times":     # phase 5's yardstick
                tiles_sel = tiles[idx.long()]
                lib = timer(lambda: torch.matmul(d[:, None], tiles_sel),
                            R_B3)
                del tiles_sel
            b_ms, b_by = b3_bound(q, k, j, vb)
            log(f"  17a mj_spmm {semiring} Vb={vb}: kernel {fmt(kt)}; plain"
                f" {fmt(p)}; library "
                f"{'none' if lib is None else fmt(lib)}; bound "
                f"{b_ms:.4f} ms ({b_by}); {100 * b_ms / kt['ms']:.1f}% of "
                f"the bound; each tile streamed {j // jb} time(s) (jb {jb})")
            f.update(ms=kt["ms"], host_ms_per_call=kt["host_ms"],
                     queued=kt["queued"], plain_ms=p["ms"],
                     library_ms=None if lib is None else lib["ms"],
                     bound_ms=b_ms, bound_by=b_by, q=q, k=k, jb=jb,
                     tile_reads=j // jb)
        f["max_abs_err"] = max(f.pop("errs"))
        figures[semiring] = f
        del d
    return figures


def wide_main_path(torch, fk, sess, handles, csr, bars) -> dict:
    """17b: phase 3's four jobs at the fleet's width under TwoLevel() and
    then Fused(), to convergence, each with the B1/B2 counts set to 0 just
    before and read just after; phase 3's bars."""
    from repro_torch.core import Fused, TwoLevel
    refs = [pagerank_ref(csr, h.alg.damping, getattr(h.alg, "source", None))
            for h in handles[:2]] + list(
        sssp_ref(csr, SSSP_SOURCES).astype(np.float32))
    out = {}
    for i, policy in enumerate((TwoLevel(), Fused())):
        if i:
            handles = resubmit(torch, sess, handles)
            sess.scheduler.reset()
        label = f"17b Vb={WIDE_VB} {policy.name}"
        m, wall, launches, peak = drive(torch, sess, policy, fk)
        report_run(torch, label, m, wall, launches, peak)
        check_results(sess, handles, csr, refs, label)
        bars.check(m.converged and all(launches[sr] > 0 for sr in SEMIRINGS),
                   f"{label}: converged in {m.supersteps} supersteps, B1/B2 "
                   f"launches {launches}")
        out[policy.name] = dict(
            wall_s=wall, supersteps=m.supersteps,
            ms_per_superstep=1e3 * wall / max(1, m.supersteps),
            tile_loads=m.tile_loads, tile_pair_loads=m.tile_pair_loads,
            host_syncs=m.host_syncs, peak_gb=peak / 1e9, launches=launches)
    return out


def wide_phase(torch, timer, records=None) -> dict:
    """Phase 17: 17b's session at the fleet's width (its bytes against the
    graph dry run's), 17a B1/B2/B3 against their plain versions at every
    width of WIDE_VBS, 17b the main path at Vb = 512, 17c the fleet's
    records (16a's when given, else made here) on the kernel route.
    Raises at its end if any check failed."""
    from repro_torch.graph import rmat_graph
    from repro_torch.kernels.fused_superstep import kernel as fk
    from repro_torch.launch import graph_dryrun as G
    bars = Bars()
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    csr = rmat_graph(WIDE_N, AVG_DEGREE, seed=0)
    out = {"card": card_line(), "vertices": WIDE_N, "edges": int(csr.nnz),
           "kernels": {}}
    for vb in sorted(WIDE_VBS, key=lambda v: v != WIDE_VB):
        base = torch.cuda.memory_allocated()
        sess, handles, groups, setup_s = wide_session(torch, csr, vb)
        held = torch.cuda.memory_allocated() - base
        bp = {sr: sess._pair_data(g) for sr, g in groups.items()}
        g0 = next(iter(groups.values())).graph
        log(f"17 Vb={vb}: B_N={g0.num_blocks} K={g0.max_nbr_blocks} "
            f"P={bp['plus_times'].num_pairs} runs="
            f"{bp['plus_times'].num_runs}; both views {held / 1e9:.3f} GB "
            f"held, built in {setup_s:.2f} s")
        if vb == WIDE_VB:
            t0 = time.perf_counter()
            dry = wide_dry_run(csr, vb)
            # the plan, no bar: the dry run places the session on a (1, 1)
            # mesh (a pair shard), the card's session is not placed
            log(f"17b the graph dry run's resident bytes of the session "
                f"placed on (1, 1): {dry['resident_bytes']:,} B (q "
                f"{dry['q']}, {time.perf_counter() - t0:.2f} s on meta); "
                f"held on the card, not placed: {held:,} B")
            out["dry_resident_bytes"] = dry["resident_bytes"]
            out["held_bytes"] = held
        fig = {"fused": wide_fused(torch, timer, sess, groups, vb,
                                   sess.device),
               "mj_spmm": wide_mj_spmm(torch, timer, groups, vb,
                                       sess.device),
               "setup_s": setup_s, "held_bytes": held}
        if vb == WIDE_VB:
            out["main_path"] = wide_main_path(torch, fk, sess, handles, csr,
                                              bars)
        out["kernels"][vb] = fig
        del sess, handles, groups, bp, g0
        gc.collect()
        torch.cuda.empty_cache()
    if records is None:
        records = [G.run(multi_pod=mp) for mp in (False, True)]
    for r in records:
        want = (r["local_jobs"], 2)
        bars.check((r["kernel_route"], r["kernel_job_block"]) == (
            "B1/B2", 2), f"17c {r['mesh']}: the fleet (Vb {r['vb']}, "
            f"{want[0]} local jobs) on the kernel route: "
            f"{r['kernel_route']!r}, job chunk {r['kernel_job_block']}")
    log("17c the fleet's records:\n" + G.graph_table(records))
    out["fleet_routes"] = {r["mesh"]: [r["kernel_route"],
                                       r["kernel_job_block"]]
                           for r in records}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 17 in {out['phase_s']:.1f} s ({out['card']})")
    bars.raise_if_failed("phase 17")
    return out


def wide_dry_run(csr, vb) -> dict:
    """The graph dry run (meta, a fake world of one) of 17b's session:
    its resident bytes and q."""
    from repro_torch.algorithms import (PageRank, PersonalizedPageRank,
                                        SSSP)
    from repro_torch.core import GraphSession
    from repro_torch.dist.mesh2d import shard_session_2d
    from repro_torch.launch.graph_dryrun import dry_run_session

    def build(mesh, dev):
        sess = GraphSession(csr, vb, capacity=CAPACITY, device=dev)
        shard_session_2d(mesh, sess)
        for a in [PageRank(), PersonalizedPageRank(source=PPR_SOURCE)] + [
                SSSP(source=s) for s in SSSP_SOURCES]:
            sess.submit(a)
        return sess
    return dry_run_session(build, (1, 1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", action="store_true",
                    help="add a traced rerun (per-layer breakdown)")
    ap.add_argument("--phases", choices=("all", "10", "11", "11c", "12",
                                         "12d", "13", "14", "15", "16",
                                         "17"),
                    default="all",
                    help="'10' / '11' / '12' / '13' / '14' / '15' / '16' / "
                         "'17': phase 1 and the LM serving / training / "
                         "multi-rank training / tensor-parallel serving / "
                         "tensor-parallel training / dry-run / graph "
                         "dry-run and analysis / block-width phase alone "
                         "(for iterating; no kernels line; 16 without "
                         "16b); '11c' / '12d': that part alone, the child "
                         "process phase 11 / 12 starts")
    args = ap.parse_args()
    t_script = time.perf_counter()
    if args.phases in ("11c", "12d"):
        # the bit-equal replays need cuBLAS's deterministic workspace, set
        # before CUDA starts; only these child processes run with it (a
        # world's spawned ranks inherit it)
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = RESTART_CUBLAS
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root / "src"))
    out_dir = root / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.phases == "11c":
        from repro_torch.launch import serve as lserve
        lserve.set_numerics()
        bars = Bars()
        figures = train_restart_phase(torch, out_dir, bars)
        print(RESTART_TAG + json.dumps({"figures": figures,
                                        "failed": bars.failed}), flush=True)
        return 0
    if args.phases == "12d":
        print(DIST_TAG + json.dumps({"figures": restart_world(out_dir),
                                     "failed": []}), flush=True)
        return 0
    from repro_torch.algorithms import (PageRank, PersonalizedPageRank,
                                        SSSP)
    from repro_torch.core import Fused, GraphSession, TwoLevel
    from repro_torch.graph import rmat_graph
    from repro_torch.kernels import common
    from repro_torch.kernels.fused_superstep import kernel as fk
    from repro_torch.kernels.fused_superstep import ops as fops

    # -- phase 1: device and settings ------------------------------------
    card = card_line()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    common.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name in common.KERNEL_SOURCES:
        for line in common.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas ({name}): {line.strip()}")
    ptxas_report(common, fk)
    if args.phases in ("10", "11", "12", "13", "14", "15", "16", "17"):
        if args.phases == "10":
            print(json.dumps({"lm": lm_phase(torch, args.trace)}),
                  flush=True)
        elif args.phases == "11":
            print(json.dumps({"train": train_phase(torch, args.trace,
                                                   out_dir)}), flush=True)
        elif args.phases == "13":
            print(json.dumps({"tp": tp_phase(torch, out_dir)}), flush=True)
        elif args.phases == "14":
            print(json.dumps({"tp_train": tpt_phase(torch, out_dir)}),
                  flush=True)
        elif args.phases == "15":
            print(json.dumps({"dryrun": dry_phase(torch, out_dir, None)}),
                  flush=True)
        elif args.phases == "16":
            print(json.dumps({"graph_dryrun": graph_phase(torch, root)}),
                  flush=True)
        elif args.phases == "17":
            print(json.dumps({"widths": wide_phase(torch, Timer(torch))}),
                  flush=True)
        else:
            print(json.dumps({"dist": dist_phase(torch, out_dir, None)}),
                  flush=True)
        print(card_line(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # -- the slice's graph and session (two views) -------------------------
    t0 = time.perf_counter()
    csr = rmat_graph(N_VERTICES, AVG_DEGREE, seed=0)
    log(f"rmat_graph({N_VERTICES}, {AVG_DEGREE}): {csr.nnz} edges in "
        f"{time.perf_counter() - t0:.2f} s")
    sess = GraphSession(csr, BLOCK, capacity=CAPACITY, seed=0)
    if not sess.use_pallas:
        raise RuntimeError("a CUDA session must push through the kernels")
    algs = [PageRank(), PersonalizedPageRank(source=PPR_SOURCE)] + [
        SSSP(source=s) for s in SSSP_SOURCES]
    handles = []
    for alg in algs:
        t0 = time.perf_counter()
        handles.append(sess.submit(alg))
        torch.cuda.synchronize()
        log(f"submit {type(alg).__name__}: {time.perf_counter() - t0:.2f} s"
            f" (the first job of a view builds its block-ELL tiles)")
    groups = {g.semiring: g for g in sess.view_groups()}
    for sr, g in groups.items():
        t0 = time.perf_counter()
        bp = sess._pair_data(g)
        torch.cuda.synchronize()
        gr = g.graph
        log(f"view {sr}: B_N={gr.num_blocks} K={gr.max_nbr_blocks} "
            f"P={bp.num_pairs} runs={bp.num_runs}; ELL tiles "
            f"{gr.tiles.numel() * 4 / 1e9:.2f} GB, pair tiles "
            f"{bp.tiles.numel() * 4 / 1e9:.2f} GB; pairs built in "
            f"{time.perf_counter() - t0:.2f} s")
    # phases 6 and 7 replace or free the views: a name bound here would
    # keep one alive
    del bp, gr, g

    # -- phase 2: kernels against their plain versions ---------------------
    timer = Timer(torch)
    figures = check_kernels(torch, timer, sess, groups, sess.device)

    # -- phase 3: the main path (host backend) ------------------------------
    dist = sssp_ref(csr, SSSP_SOURCES).astype(np.float32)
    refs = [pagerank_ref(csr, a.damping, getattr(a, "source", None))
            for a in algs[:2]] + list(dist)
    policy = timed_policy(TwoLevel)
    masks, restore = record_selections(fops)
    try:
        m, wall, launches, peak = drive(torch, sess, policy, fk)
    finally:
        restore()
    report_run(torch, "main path", m, wall, launches, peak)
    host_state = snapshot(sess)
    check_results(sess, handles, csr, refs, "main path")

    # -- phase 2b: B1/B2 on the main path's selections ---------------------
    sel_figures = check_selections(torch, timer, sess, groups, sess.device,
                                   masks)
    del masks
    steps = max(1, m.supersteps)
    select_ms = 1e3 * policy.select_s / steps
    kern_all = sum(launches[k] * figures[k]["ms"] for k in launches)
    kern_sel = sum(launches[k] * statistics.mean(
        f["ms"] for f in sel_figures[k]) for k in launches)
    log(f"main path per superstep: host scheduling (select) "
        f"{select_ms:.3f} ms; kernels {kern_sel / steps:.3f} ms (launches x "
        f"mean time on the three main-path selections; "
        f"{kern_all / steps:.3f} ms at the all-live time); the rest "
        f"{1e3 * wall / steps - select_ms - kern_sel / steps:.3f}"
        f" ms (pair reduction and its read, state ops, Python)")

    # -- phase 4: the device scheduling backend ----------------------------
    handles, dev_launches, fused = device_backend(
        torch, sess, handles, csr, refs, fk, (m, wall, host_state))
    handles = telemetry_on_off(torch, sess, handles, csr, refs, fk,
                               (m, wall, host_state), fused)
    del host_state, fused

    # -- phase 5: B3 and B4 at their entry points ---------------------------
    handles = resubmit(torch, sess, handles)
    b3 = check_mj_spmm(torch, timer, groups, sess.device)
    b3_launches = check_push_shared(torch, timer, sess, groups, sess.device)
    b4 = check_priority_pairs(torch, timer, sess, groups)

    if args.trace:
        handles = traced_rerun(torch, sess, handles, TwoLevel())
        handles = traced_rerun(torch, sess, handles, Fused())

    # -- phase 6: evolving graphs -------------------------------------------
    handles, stream_launches = stream_phase(torch, sess, handles, csr, fk)

    # -- phase 7: the serve front (the first session's views freed) ---------
    del sess, groups, handles
    gc.collect()
    torch.cuda.empty_cache()
    serve_launches = serve_phase(torch, csr, fk, out_dir)

    # -- phases 8-9: the multi-device engine (ranks sharing the card) -----
    gc.collect()
    torch.cuda.empty_cache()
    (mesh_launches, mesh_stream_launches, mesh_serve_launches, mesh_errs,
     graph_ranks) = mesh_phase(torch, csr, refs, fk, out_dir)

    # -- phase 10: the LM serving path (launches none of the kernels) -------
    lm = lm_phase(torch, args.trace)

    # -- phase 11: LM training (launches none of the kernels) ---------------
    train = train_phase(torch, args.trace, out_dir)

    # -- phase 12: LM training over ranks sharing the card (none either) -----
    dry_procs = []
    try:
        dist = dist_phase(torch, out_dir, train["full"]["steps"],
                          lambda: dry_procs.extend(_dry_procs(out_dir)))

        # -- phase 13: tensor-parallel serving over ranks (none either) ------
        tp = tp_phase(torch, out_dir)

        # -- phase 14: training under the "tp" rules over ranks (none either)
        tp_train = tpt_phase(torch, out_dir)

        # -- phase 15: the dry run against the card (none of the kernels) ---
        dry = dry_phase(torch, out_dir, tp_train, dry_procs)
    finally:
        _stop(dry_procs)

    # -- phase 16: the graph dry run (16b in 8a's world) and the analysis
    graph = graph_phase(torch, root, csr, graph_ranks)

    # -- phase 17: B1/B2/B3 at the paper's block widths, the main path at
    # the fleet's Vb = 512
    wide = wide_phase(torch, timer, graph["16a"])
    wide_launches = {sr: sum(r["launches"][sr]
                             for r in wide["main_path"].values())
                     for sr in SEMIRINGS}

    def widths(name, sr):
        return {str(vb): f[name][sr] for vb, f in wide["kernels"].items()}

    kernels = []
    for sr in SEMIRINGS:
        f = figures[sr]
        kernels.append({
            "name": f"fused_superstep_{sr}", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES[sr],
            "launches": (launches[sr] + dev_launches[sr]
                         + stream_launches[sr] + serve_launches[sr]
                         + mesh_launches[sr] + mesh_stream_launches[sr]
                         + mesh_serve_launches[sr]
                         + graph["launches"]["16b"][sr]
                         + graph["launches"]["16c"][sr]
                         + wide_launches[sr]),
            "launches_by_path": {"host_two_level": launches[sr],
                                 "device_fused": dev_launches[sr],
                                 "stream": stream_launches[sr],
                                 "serve": serve_launches[sr],
                                 "mesh": mesh_launches[sr],
                                 "mesh_stream": mesh_stream_launches[sr],
                                 "mesh_serve": mesh_serve_launches[sr],
                                 "graph_superstep": graph["launches"][
                                     "16b"][sr],
                                 "contracts": graph["launches"]["16c"][sr],
                                 "paper_width": wide_launches[sr]},
            "max_abs_err": max([f["max_abs_err"], mesh_errs[sr]] + [
                x["max_abs_err"] for x in sel_figures[sr]] + [
                x["max_abs_err"] for x in widths("fused", sr).values()]),
            "mesh_shard_max_abs_err": mesh_errs[sr],
            "ms": f["ms"], "kernel_ms": f["ms"], "device_ms": f["ms"],
            "host_ms_per_call": f["host_ms_per_call"],
            "queued": f["queued"], "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
            "library_ms": None, "timing": TIMING,
            "main_path_selections": sel_figures[sr],
            "widths": widths("fused", sr)})
    for sr in SEMIRINGS:
        f = b3[sr]
        kernels.append({
            "name": f"mj_spmm_{sr}", "route": "cuda", "source": B3_SOURCE,
            "replaces": B3_REPLACES[sr], "launches": b3_launches[sr],
            "max_abs_err": max([f["max_abs_err"]] + [
                x["max_abs_err"] for x in widths("mj_spmm", sr).values()]),
            "ms": f["ms"],
            "kernel_ms": f["ms"], "device_ms": f["ms"],
            "host_ms_per_call": f["host_ms_per_call"],
            "queued": f["queued"], "indexed_ms": f["indexed_ms"],
            "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"], "library_ms": f["library_ms"],
            "timing": TIMING, "widths": widths("mj_spmm", sr)})
    kernels.append({
        "name": "priority_pairs", "route": "cuda", "source": B4_SOURCE,
        "replaces": B4_REPLACES, "kernel_ms": b4["ms"], "timing": TIMING,
        **b4})
    log(f"chip_smoke: {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"lm": lm}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"dist": dist}), flush=True)
    print(json.dumps({"tp": tp}), flush=True)
    print(json.dumps({"tp_train": tp_train}), flush=True)
    print(json.dumps({"dryrun": dry}), flush=True)
    print(json.dumps({"graph_dryrun": graph}), flush=True)
    print(json.dumps({"widths": wide}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
