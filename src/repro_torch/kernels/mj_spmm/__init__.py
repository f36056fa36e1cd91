from repro_torch.kernels.mj_spmm.kernel import (SUPPORTED_VB, launches,
                                                mj_spmm_call, reset_launches)
from repro_torch.kernels.mj_spmm.ops import fold_min, mj_spmm, push_shared
from repro_torch.kernels.mj_spmm.ref import mj_spmm_ref

__all__ = ["mj_spmm", "mj_spmm_call", "mj_spmm_ref", "push_shared",
           "fold_min", "launches", "reset_launches", "SUPPORTED_VB"]
