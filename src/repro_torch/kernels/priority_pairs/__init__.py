from repro_torch.kernels.priority_pairs.kernel import (
    launches, priority_pairs_call, reset_launches)
from repro_torch.kernels.priority_pairs.ops import priority_pairs
from repro_torch.kernels.priority_pairs.ref import priority_pairs_ref

__all__ = ["priority_pairs", "priority_pairs_call", "priority_pairs_ref",
           "launches", "reset_launches"]
