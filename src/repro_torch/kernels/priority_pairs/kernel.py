"""The <Node_un, P_mean> pair reduction as a CUDA kernel
(csrc/priority_pairs.cu).

Replaces the TPU kernel `repro/kernels/priority_pairs/kernel.py`
(`priority_pairs_call` -> `_pairs_kernel`).  Two variants: the vector
one reads a row as float4s with a segment of lanes per row, the scalar
one (any other Vb, or a misaligned input) a warp per row with 4-byte
loads; `pick_variant` chooses.  See the note at the top of the .cu file
for what bounds it.

Dispatch (kernels.common): a CPU tensor runs `ref.priority_pairs_ref`; a
CUDA tensor launches one of the two variants or raises.  `launches`
counts kernel launches only.
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
    """The kernel library, built on first use, with its C signatures."""
    lib = common.load_library("priority_pairs")
    lib.pp_priority_pairs.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
    lib.pp_priority_pairs.restype = ctypes.c_int
    lib.pp_empty.argtypes = [ctypes.c_void_p]
    lib.pp_empty.restype = ctypes.c_int
    lib.pp_error_string.argtypes = [ctypes.c_int]
    lib.pp_error_string.restype = ctypes.c_char_p
    return lib


def pick_variant(vb: int, data_ptr: int) -> int:
    """The kernel variant for rows of `vb` floats starting at `data_ptr`:
    the vector variant's lanes per row (the next power of two >= Vb/4, at
    most 32) when Vb % 4 == 0 and the input is 16-byte aligned, else 0
    (the scalar variant)."""
    if vb % 4 or data_ptr % 16:
        return 0
    return min(32, 1 << (vb // 4 - 1).bit_length())


def priority_pairs_call(vertex_priority: torch.Tensor, lanes=None):
    """[J, B_N, Vb] float32 -> (node_un [J, B_N], p_mean [J, B_N]), the
    two rows of one [2, J, B_N] buffer.  `lanes` is the variant as
    `pick_variant` gives it; None picks it, 0 forces the scalar variant
    on any input (to time the two designs on the same data)."""
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
    dev = p.device
    out = torch.empty((2, j, bn), dtype=torch.float32, device=dev)
    rows = j * bn
    if rows == 0:
        return out[0], out[1]
    if vb < 1:
        raise ValueError("Vb must be at least 1")
    lib = _lib()
    ptr = p.data_ptr()
    if lanes is None:
        lanes = pick_variant(vb, ptr)
    common.launch(lib.pp_priority_pairs, dev, lib.pp_error_string, ptr,
                  out.data_ptr(), rows, vb, lanes)
    launches["priority_pairs"] += 1
    return out[0], out[1]


def launch_empty(device: torch.device) -> None:
    """Launch the library's empty kernel on the current stream of `device`
    (a CUDA device with its index, as a tensor's `.device`): the least
    that one launch costs on the card.  Not counted in `launches`."""
    lib = _lib()
    common.launch(lib.pp_empty, device, lib.pp_error_string)
