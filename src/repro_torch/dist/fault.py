"""Fault tolerance: the checkpoint-resume restart loop, checkpoint and
restore of graph sessions onto another mesh (elastic reshard), and
straggler detection.

`RestartManager` wraps a training loop with the standard preemption
contract: periodic (async) checkpoints, and on any step failure the loop
restores the latest checkpoint and replays forward.  With deterministic
data (data_fn keyed by step) and deterministic kernels the recovered run
is bit-identical to an uninterrupted one.  On a world of ranks every rank
runs the loop: the step-0 snapshot and each restore sit behind a
barrier, and a failure that every rank raises at the same step restarts
them all (one rank failing alone is not handled: its peers wait in
their next collective).

`checkpoint_session` gathers a session's resumable state to host numpy;
`restore_session` loads it into a session built with the same
submissions and places it on a survivor mesh, or on none.
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.dist import comm
from repro_torch.train.checkpoint import (AsyncCheckpointer, latest_step,
                                          restore_checkpoint,
                                          save_checkpoint, spec_of)


class RestartManager:
    """Run a step loop to completion across simulated/real preemptions."""

    def __init__(self, directory: str, *, save_every: int = 10,
                 max_restarts: int = 100):
        self.directory = directory
        self.save_every = max(1, int(save_every))
        self.max_restarts = max_restarts
        self._ckpt = AsyncCheckpointer(directory)

    def _restore(self, like: Any, shardings: Any) -> Tuple[Any, int]:
        comm.barrier()      # rank 0's write is done before anyone reads
        state, step = restore_checkpoint(self.directory, like, shardings)
        return state, int(step)

    def run(self, init_state: Any,
            step_fn: Callable[[Any, Any], Tuple[Any, Any]],
            data_fn: Callable[[int], Any],
            total_steps: int, *,
            failure_hook: Optional[Callable[[int], None]] = None,
            shardings: Any = None) -> Tuple[Any, int, int]:
        """Returns (final_state, steps_completed, restarts).

        step_fn(state, batch) -> (state, metrics); data_fn(step) -> batch
        must be deterministic in `step` for exact recovery.  failure_hook
        (tests / chaos injection) runs before each step and may raise.
        Checkpoints land every `save_every` completed steps; a crash between
        checkpoints replays at most save_every - 1 steps.
        """
        like = spec_of(init_state)
        fresh = latest_step(self.directory) is None
        comm.barrier()      # every rank has looked before rank 0 writes
        if fresh:
            # durable step-0 snapshot BEFORE the first step: the step
            # updates the state's tensors in place, so after step 1
            # init_state holds step 1's values; a failure before the first
            # periodic checkpoint must restore from disk, never from memory
            save_checkpoint(self.directory, 0, init_state)
            state, step = init_state, 0   # still step 0's values here
        else:
            state, step = self._restore(like, shardings)
        restarts = 0
        while step < total_steps:
            try:
                if failure_hook is not None:
                    failure_hook(step)
                batch = data_fn(step)
                state, _ = step_fn(state, batch)
                step += 1
                if step % self.save_every == 0 or step == total_steps:
                    self._ckpt.save(step, state)
            except KeyboardInterrupt:
                raise
            except Exception as e:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                # surface every failure: a deterministic step bug replays
                # identically and would otherwise burn max_restarts in silence
                print(f"[restart-manager] step {step} failed ({e!r}); "
                      f"restart {restarts}/{self.max_restarts}",
                      file=sys.stderr)
                self._ckpt.wait()  # never restore a half-written checkpoint
                state, step = self._restore(like, shardings)
        self._ckpt.wait()
        return state, step, restarts


def checkpoint_session(sess) -> dict:
    """Host snapshot of a GraphSession's resumable state: every view's
    values/deltas (the convergence state; adjacency is rebuilt from the
    session's own graph, never checkpointed), the scheduler's stream
    position and its host generator's state, so a resumed run draws what
    it would have drawn uninterrupted.  On a mesh the state is gathered
    first (a collective: every rank calls it), so the snapshot restores
    onto any placement, a smaller mesh after a shard loss included.
    After live updates it still carries job state only, as the
    reference's does: the graph it converges on is the session's CSR,
    which the snapshot does not hold."""
    groups = sess.view_groups()
    vals, dels = [], []
    for g in groups:
        v, d, _ = sess._full_state(g)
        vals.append(v.cpu().numpy().copy())  # noqa: RPT002 - a checkpoint, a read a view
        dels.append(d.cpu().numpy().copy())  # noqa: RPT002 - a checkpoint, a read a view
    return {"keys": [g.key for g in groups], "values": vals,
            "deltas": dels, "step": int(sess.scheduler._step),
            "rng": sess.scheduler.rng.bit_generator.state}


def restore_session(sess, snapshot: dict, mesh=None, **shard_kwargs):
    """Elastic reshard: load `snapshot` into `sess` (built with the same
    submissions) and place it on the survivor `mesh` (jobs x blocks when
    it has two named axes, see `dist.graph.shard_session`) or on one
    device when None.  The scheduler resumes at the snapshot's stream
    position (and host generator state, when the snapshot has one), so
    a min-plus run restored onto a different block-shard count reaches
    the bit-identical fixpoint.  The snapshot holds no graph: after live
    updates `sess` must hold the same CSR (the same batches applied), or
    the restored state belongs to another graph."""
    from repro_torch.dist.mesh2d import unshard_session
    unshard_session(sess)
    by_key = {g.key: g for g in sess.view_groups()}
    keys = [tuple(k) for k in snapshot["keys"]]
    if set(keys) != set(by_key):
        raise ValueError(f"snapshot views {keys} do not match the "
                         f"session's {list(by_key)}")
    for key, v, d in zip(keys, snapshot["values"], snapshot["deltas"]):
        grp = by_key[key]
        if tuple(np.shape(v)) != tuple(grp.values.shape):
            raise ValueError(f"view {key}: snapshot state "
                             f"{tuple(np.shape(v))} != the session's "
                             f"{tuple(grp.values.shape)}")
        grp.values = torch.as_tensor(np.asarray(v, np.float32),
                                     device=sess.device).clone()
        grp.deltas = torch.as_tensor(np.asarray(d, np.float32),
                                     device=sess.device).clone()
    sess.scheduler._step = int(snapshot["step"])
    if snapshot.get("rng") is not None:
        sess.scheduler.rng.bit_generator.state = snapshot["rng"]
    if mesh is not None:
        from repro_torch.dist.graph import shard_session
        shard_session(mesh, sess, **shard_kwargs)
    return sess


@dataclasses.dataclass
class StragglerReport:
    step: int
    duration: float
    median: float
    ratio: float


class StragglerWatchdog:
    """Sliding-window step-duration monitor.

    observe(step, duration) returns a StragglerReport when `duration`
    exceeds threshold x the median of the last `window` durations, or None
    (including while the window is still filling)."""

    def __init__(self, window: int = 8, threshold: float = 2.0):
        self.window = max(1, int(window))
        self.threshold = threshold
        self._durations: list = []

    def observe(self, step: int,
                duration: float) -> Optional[StragglerReport]:
        report = None
        if len(self._durations) >= self.window:
            med = statistics.median(self._durations[-self.window:])
            if med > 0 and duration >= self.threshold * med:
                report = StragglerReport(step=step, duration=duration,
                                         median=med,
                                         ratio=duration / med)
        if report is None:
            # straggler steps stay out of the baseline window
            self._durations.append(float(duration))
            if len(self._durations) > self.window:
                self._durations = self._durations[-self.window:]
        return report
