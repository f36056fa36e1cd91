"""The paper's user-facing API (§4.4), mapped onto the core.

  initPtable     - per-block initial priority state for a newly-arrived job
                   (what `GraphSession.submit` runs when a job arrives)
  De_In_Priority - per-job block priority queues (pairs + Function 2;
                   `TwoLevelScheduler.job_queues`)
  De_Gl_Priority - global priority queue (Fig. 7 synthesis;
                   `TwoLevelScheduler.synthesize`)
  Con_processing - schedule all jobs over the global queue (the CAJS push
                   one `TwoLevel.select` + shared push performs per step),
                   through `kernels.mj_spmm.push_shared`: the mj_spmm
                   kernel on CUDA tensors, its plain version on the CPU

Thin, composable wrappers, so a traditional engine can adopt the two
strategies one at a time, as the paper prescribes.  The session/policy
API is the batteries-included version of the same four steps.  The port
runs eagerly, so `Con_processing` needs no compiled-push cache.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.algorithms.base import Algorithm
from repro_torch.core.do_select import DEFAULT_SAMPLES
from repro_torch.core.engine import ConcurrentRun
from repro_torch.core.global_q import DEFAULT_ALPHA
from repro_torch.core.push import compute_pairs
from repro_torch.core.scheduler import TwoLevelScheduler
from repro_torch.kernels.mj_spmm import push_shared


def initPtable(alg: Algorithm, graph) -> Tuple[torch.Tensor, torch.Tensor]:
    """Initial (values, deltas) for a new job — every block starts with
    the same priority (paper step 2: 'priority values ... set to the same
    in the first iteration'), which falls out of the algorithm's uniform
    init."""
    return alg.init(graph)


def De_In_Priority(alg: Algorithm, values: torch.Tensor,
                   deltas: torch.Tensor, q: int, rng: np.random.Generator,
                   samples: int = DEFAULT_SAMPLES) -> List[np.ndarray]:
    """Per-job priority queues for stacked [J, B_N, Vb] state."""
    node_un, p_mean = (x.cpu().numpy()  # noqa: RPT002 - the two pair arrays, one read each
                       for x in compute_pairs(alg, values, deltas))
    sched = TwoLevelScheduler(node_un.shape[1], q, samples=samples)
    sched.rng = rng  # caller-owned stream, paper-API style
    return sched.job_queues(node_un, p_mean)


def De_Gl_Priority(job_queues: Sequence[np.ndarray], num_blocks: int, q: int,
                   alpha: float = DEFAULT_ALPHA) -> np.ndarray:
    return TwoLevelScheduler(num_blocks, q, alpha=alpha).synthesize(job_queues)


def Con_processing(run: ConcurrentRun, gq: np.ndarray, q: int):
    """CAJS: stage each selected block once; every job processes it."""
    g = run.graph
    dev = run.values.device
    sel = np.zeros(q, dtype=np.int32)
    msk = np.zeros(q, dtype=np.float32)
    sel[:len(gq)] = gq[:q]
    msk[:len(gq)] = 1.0
    return push_shared(run.values, run.deltas, g.tiles, g.nbr_ids,
                       torch.as_tensor(sel, device=dev),
                       torch.as_tensor(msk, device=dev), run.push_scale,
                       semiring=run.algs[0].semiring)
