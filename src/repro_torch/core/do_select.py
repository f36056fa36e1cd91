"""Function 2: the DO algorithm — approximate top-q block selection (host).

Paper §4.2.2: instead of sorting all B_N blocks, sample s (default 500)
pairs, sort the sample, estimate the q-th priority threshold as the
(q*s/B_N)-th sample, then one O(B_N) pass collects blocks above the
threshold; only those ~q blocks are sorted.

Copied from the reference's host `do_select`: from identical numpy inputs
and an identical `np.random.Generator` state it returns identical queues.
The device sampler (`do_select_device`) waits for the port's device
backend.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.priority import cbp, cbp_key_sort

DEFAULT_SAMPLES = 500  # paper default


def do_select(node_un: np.ndarray, p_mean: np.ndarray, q: int,
              rng: np.random.Generator, s: int = DEFAULT_SAMPLES) -> np.ndarray:
    """Return ~q block indices in CBP-descending order (Function 2).

    Converged blocks (node_un == 0) never enter the queue.
    """
    b_n = len(node_un)
    live = np.nonzero(node_un > 0)[0]
    if len(live) == 0:
        return np.empty(0, dtype=np.int64)
    q = max(1, min(q, len(live)))
    if len(live) <= q:           # queue covers everything that is unconverged
        order = cbp_key_sort(node_un[live], p_mean[live])
        return live[order]

    s_eff = min(s, len(live))
    samples = rng.choice(live, size=s_eff, replace=False)
    order = cbp_key_sort(node_un[samples], p_mean[samples])
    samples = samples[order]  # priority-descending

    # lower bound of the top-q priority estimated from the sample
    cutindex = min(int(q * s_eff / b_n), s_eff - 1)
    thresh = (float(node_un[samples[cutindex]]),
              float(p_mean[samples[cutindex]]))

    picked = [int(r) for r in live
              if cbp((float(node_un[r]), float(p_mean[r])), thresh)]
    if not picked:  # threshold estimate too aggressive; fall back to samples
        picked = [int(x) for x in samples[:q]]
    picked = np.asarray(picked, dtype=np.int64)
    order = cbp_key_sort(node_un[picked], p_mean[picked])
    return picked[order][:q]
