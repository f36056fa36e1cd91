from repro_torch.kernels.fused_superstep.kernel import (
    SUPPORTED_VB, b1b2_counts, fused_superstep_call, launches, layout,
    reset_launches)
from repro_torch.kernels.fused_superstep.ops import fused_push, job_live
from repro_torch.kernels.fused_superstep.ref import fused_superstep_ref

__all__ = ["fused_superstep_call", "fused_push", "fused_superstep_ref",
           "job_live", "layout", "b1b2_counts", "launches",
           "reset_launches", "SUPPORTED_VB"]
