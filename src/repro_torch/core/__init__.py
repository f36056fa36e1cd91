"""The paper's primary contribution: two-level scheduling (MPDS + CAJS),
host backend.

  GraphSession / JobHandle        - job-lifecycle API (submit/run/result/detach)
  SchedulePolicy + TwoLevel,
  Independent, AllBlocks          - pluggable schedules over a session
  TwoLevelScheduler               - pairs -> DO queues -> global queue
"""

from repro_torch.core.priority import (block_pairs, cbp, cbp_key_sort,
                                       counts_from_pairs, do_score,
                                       EPS_FACTOR)
from repro_torch.core.do_select import do_select, DEFAULT_SAMPLES
from repro_torch.core.global_q import (global_queue, reserved_slots,
                                       DEFAULT_ALPHA)
from repro_torch.core.scheduler import (TwoLevelScheduler,
                                        optimal_queue_length, PRITER_C)
from repro_torch.core.push import (push_plus_one, push_min_one,
                                   compute_pairs, shared_push_fn,
                                   indep_push_fn)
from repro_torch.core.policy import (RunMetrics, Selection, SchedulePolicy,
                                     TwoLevel, Fused, Independent, AllBlocks,
                                     POLICIES)
from repro_torch.core.session import GraphSession, JobHandle, ViewGroup

__all__ = [
    "block_pairs", "cbp", "cbp_key_sort", "counts_from_pairs", "do_score",
    "EPS_FACTOR",
    "do_select", "DEFAULT_SAMPLES",
    "global_queue", "reserved_slots", "DEFAULT_ALPHA",
    "TwoLevelScheduler", "optimal_queue_length", "PRITER_C",
    "push_plus_one", "push_min_one", "compute_pairs", "shared_push_fn",
    "indep_push_fn",
    "RunMetrics", "Selection", "SchedulePolicy",
    "TwoLevel", "Fused", "Independent", "AllBlocks", "POLICIES",
    "GraphSession", "JobHandle", "ViewGroup",
]
