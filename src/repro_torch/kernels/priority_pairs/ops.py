"""Entry point of the priority_pairs kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels.priority_pairs.kernel import priority_pairs_call


def priority_pairs(vertex_priority: torch.Tensor):
    """[J, B_N, Vb] -> (node_un, p_mean), both [J, B_N] float32."""
    return priority_pairs_call(vertex_priority.to(torch.float32))
