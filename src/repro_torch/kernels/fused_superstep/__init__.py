from repro_torch.kernels.fused_superstep.kernel import (
    SUPPORTED_VB, fused_superstep_call, launches, reset_launches)
from repro_torch.kernels.fused_superstep.ops import fused_push, _pick_job_block
from repro_torch.kernels.fused_superstep.ref import fused_superstep_ref

__all__ = ["fused_superstep_call", "fused_push", "fused_superstep_ref",
           "_pick_job_block", "launches", "reset_launches", "SUPPORTED_VB"]
