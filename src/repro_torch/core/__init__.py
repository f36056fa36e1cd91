"""The paper's primary contribution: two-level scheduling (MPDS + CAJS).

  GraphSession / JobHandle        - job-lifecycle API (submit/run/result/detach)
  SchedulePolicy + TwoLevel,
  Fused, Independent, AllBlocks   - pluggable schedules over a session, on
                                    the host or the device backend
  TwoLevelScheduler               - pairs -> DO queues -> global queue
  ConcurrentEngine / make_run     - legacy fixed-job-set shim
  initPtable, De_In_Priority,
  De_Gl_Priority, Con_processing  - the paper's four-function API
"""

from repro_torch.core.priority import (block_pairs, cbp, cbp_key_sort,
                                       counts_from_pairs, do_score,
                                       EPS_FACTOR)
from repro_torch.core.do_select import (do_select, do_select_device,
                                        DEFAULT_SAMPLES)
from repro_torch.core.global_q import (global_queue, global_queue_device,
                                       accumulate_priority, priority_topq,
                                       synthesize_topq, reserved_slots,
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
from repro_torch.core.engine import ConcurrentEngine, ConcurrentRun, make_run
from repro_torch.core.api import (initPtable, De_In_Priority, De_Gl_Priority,
                                  Con_processing)

__all__ = [
    "block_pairs", "cbp", "cbp_key_sort", "counts_from_pairs", "do_score",
    "EPS_FACTOR",
    "do_select", "do_select_device", "DEFAULT_SAMPLES",
    "global_queue", "global_queue_device", "accumulate_priority",
    "priority_topq", "synthesize_topq", "reserved_slots", "DEFAULT_ALPHA",
    "TwoLevelScheduler", "optimal_queue_length", "PRITER_C",
    "push_plus_one", "push_min_one", "compute_pairs", "shared_push_fn",
    "indep_push_fn",
    "RunMetrics", "Selection", "SchedulePolicy",
    "TwoLevel", "Fused", "Independent", "AllBlocks", "POLICIES",
    "GraphSession", "JobHandle", "ViewGroup",
    "ConcurrentEngine", "ConcurrentRun", "make_run",
    "initPtable", "De_In_Priority", "De_Gl_Priority", "Con_processing",
]
