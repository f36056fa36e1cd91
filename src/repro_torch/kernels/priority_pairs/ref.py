"""Plain PyTorch version of the priority_pairs kernel (the same function
as `core.priority.block_pairs`): the CPU route runs it; on a CUDA device
it serves only to check the kernel."""

from __future__ import annotations

import torch


def priority_pairs_ref(vertex_priority: torch.Tensor):
    """[J, B_N, Vb] -> (node_un [J, B_N], p_mean [J, B_N]) float32."""
    un = vertex_priority > 0.0
    node_un = un.sum(-1).to(torch.float32)
    p_sum = torch.where(un, vertex_priority, 0.0).sum(-1)
    p_mean = p_sum / torch.clamp(node_un, min=1.0)
    return node_un, p_mean
