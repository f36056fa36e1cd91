"""The <Node_un, P_mean> pair reduction as a CUDA kernel
(csrc/priority_pairs.cu).

Replaces the TPU kernel `repro/kernels/priority_pairs/kernel.py`
(`priority_pairs_call` -> `_pairs_kernel`).  One warp per (job, block)
row; lanes stride the Vb values and reduce by warp shuffles.  See the
note at the top of the .cu file for what bounds it.

Dispatch (kernels.common): a CPU tensor runs `ref.priority_pairs_ref`; a
CUDA tensor launches the kernel or raises.  `launches` counts kernel
launches only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import common
from repro_torch.kernels.priority_pairs.ref import priority_pairs_ref

#: kernel launches since the last reset (plain runs excluded)
launches = {"priority_pairs": 0}


def reset_launches() -> None:
    launches["priority_pairs"] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signature."""
    lib = common.load_library("priority_pairs")
    lib.pp_priority_pairs.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int, ctypes.c_void_p]
    lib.pp_priority_pairs.restype = ctypes.c_int
    lib.pp_error_string.argtypes = [ctypes.c_int]
    lib.pp_error_string.restype = ctypes.c_char_p
    return lib


def priority_pairs_call(vertex_priority: torch.Tensor):
    """[J, B_N, Vb] float32 -> (node_un [J, B_N], p_mean [J, B_N])."""
    if not common.on_cuda(vertex_priority):
        return priority_pairs_ref(vertex_priority)
    p = vertex_priority
    if p.dtype != torch.float32:
        raise TypeError(f"vertex_priority must be float32, got {p.dtype}")
    if p.dim() != 3:
        raise ValueError(f"vertex_priority must be [J, B_N, Vb], got "
                         f"{tuple(p.shape)}")
    p = p.contiguous()
    j, bn, vb = p.shape
    node_un = torch.empty((j, bn), dtype=torch.float32, device=p.device)
    p_mean = torch.empty((j, bn), dtype=torch.float32, device=p.device)
    rows = j * bn
    if rows == 0:
        return node_un, p_mean
    if vb < 1:
        raise ValueError("Vb must be at least 1")
    lib = _lib()
    with torch.cuda.device(p.device):
        rc = lib.pp_priority_pairs(
            p.data_ptr(), node_un.data_ptr(), p_mean.data_ptr(), rows, vb,
            torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"priority_pairs launch failed: "
                           f"{lib.pp_error_string(rc).decode()}")
    launches["priority_pairs"] += 1
    return node_un, p_mean
