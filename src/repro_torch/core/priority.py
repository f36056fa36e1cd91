"""Block priority pairs <Node_un, P_mean> and the CBP comparator (Function 1).

Paper §4.2.1: the priority of a block is the pair
  Node_un  = number of unconverged vertices in the block
  P_mean   = mean priority value over the *unconverged* vertices (Eq. 1)

Function 1 (CBP) compares two pairs: higher mean wins, unless the means are
within the epsilon band (eps = 0.2 * P_mean_a, the paper's default), in which
case the *total* priority Node_un * P_mean decides.

`block_pairs` sums the Vb lanes with torch's own reduction order, which is
not XLA's: node_un is exact, p_mean agrees with the reference to a few ulp
(held at rtol 1e-6 by tests/test_torch_scheduler.py), not bit for bit.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

EPS_FACTOR = 0.2  # paper: eps = 0.2 * P_mean_a


# --------------------------------------------------------------------------
# device-side pair computation
# --------------------------------------------------------------------------

def block_pairs(vertex_priority: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., B_N, Vb] positive priorities (0 == converged) ->
    (node_un [..., B_N] float32, p_mean [..., B_N] float32)."""
    un = vertex_priority > 0.0
    node_un = un.sum(-1).to(torch.float32)
    p_sum = torch.where(un, vertex_priority, 0.0).sum(-1)
    p_mean = p_sum / torch.clamp(node_un, min=1.0)
    return node_un, p_mean


def counts_from_pairs(node_un):
    """Per-job unconverged-vertex totals derived from the pair computation
    (a vertex is unconverged iff its positive priority entered Node_un).
    Works on numpy arrays and tensors alike ([..., B_N] -> [...])."""
    return node_un.sum(-1)


# --------------------------------------------------------------------------
# Function 1: CBP — host scalar comparator, verbatim from the paper
# --------------------------------------------------------------------------

def cbp(pair_a: Tuple[float, float], pair_b: Tuple[float, float],
        eps_factor: float = EPS_FACTOR) -> bool:
    """Is the priority of block a higher than block b?

    pair = (node_un, p_mean).  Transcribes the paper's Function 1 exactly,
    including the swap/negate structure.
    """
    (n_a, m_a), (n_b, m_b) = pair_a, pair_b
    state = True
    if m_a < m_b:
        (n_a, m_a), (n_b, m_b) = (n_b, m_b), (n_a, m_a)
        state = not state
    # invariant: m_a >= m_b
    if n_a < n_b:
        if (m_a - m_b) < eps_factor * m_a and (m_a * n_a) < (m_b * n_b):
            state = not state
    return state


def cbp_key_sort(node_un: np.ndarray, p_mean: np.ndarray) -> np.ndarray:
    """Sort block indices in CBP-descending order (host, exact), with
    functools.cmp_to_key over Function 1 — used only on already-selected
    ~q blocks (Function 2 keeps the full pass O(B))."""
    idx = list(range(len(node_un)))

    def cmp(i: int, j: int) -> int:
        if i == j:
            return 0
        return -1 if cbp((node_un[i], p_mean[i]), (node_un[j], p_mean[j])) else 1

    idx.sort(key=functools.cmp_to_key(cmp))
    return np.asarray(idx, dtype=np.int64)


# --------------------------------------------------------------------------
# device-side DO-order score
# --------------------------------------------------------------------------

def do_score(node_un: torch.Tensor, p_mean: torch.Tensor) -> torch.Tensor:
    """Scalar score whose descending order approximates CBP order: bucket
    log(P_mean) with width ln(1.25), break ties inside a bucket by the
    normalized total priority.  Converged blocks (node_un == 0) score -inf.
    """
    total = node_un * p_mean
    bucket = torch.floor(torch.log(torch.clamp(p_mean, min=1e-30))
                         / float(np.float32(np.log(1.25))))
    tiebreak = total / (total + 1.0)
    score = bucket + tiebreak
    return torch.where(node_un > 0, score, float("-inf"))
