"""The multi-job block SpMM as a CUDA kernel (csrc/mj_spmm.cu), both
semirings.

Replaces the TPU kernel `repro/kernels/mj_spmm/kernel.py`
(`mj_spmm_call` -> `_plus_kernel` / `_min_kernel`).  One thread block per
(selected row i, ELL slot k) stages the [Vb, Vb] tile in shared memory
once and serves every job from it (from Vb = 256 each job chunk streams
it in 64 KB slices of source rows, `rows`); each thread owns one (job,
lane) output.  With `tile_index` the kernel reads `tiles[tile_index[i], k]`
straight from the [B_N, K, Vb, Vb] block-ELL array, so no gathered
[q, K, Vb, Vb] copy is written.  Bound by device-memory bytes; see the
note at the top of the .cu file.

Dispatch (kernels.common): CPU tensors run `ref.mj_spmm_ref`; CUDA
tensors launch the kernel or raise.  `launches` counts kernel launches
only, per semiring.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import common
from repro_torch.kernels.mj_spmm.ref import mj_spmm_ref

#: Vb values the kernel is instantiated for: every power of two from 8 to
#: 512 (the reference's Pallas kernel takes any Vb; ROADMAP C)
SUPPORTED_VB = (8, 16, 32, 64, 128, 256, 512)

#: kernel launches per semiring since the last reset (plain runs excluded)
launches = {"plus_times": 0, "min_plus": 0}

_MAX_GRID = 2**31 - 1


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def rows(vb: int) -> int:
    """Source rows of a tile staged at once: the whole tile up to Vb =
    128, a 64 KB slice above (mirrors `rows` in the .cu file)."""
    return 16384 // vb if vb >= 256 else vb


def smem_bytes(jb: int, vb: int) -> int:
    """Dynamic shared memory of one thread block: an [rows(Vb), Vb] tile
    slice (the whole tile up to Vb = 128) and a job chunk's [jb,
    rows(Vb)] d-row slices (mirrors `smem_bytes` in the .cu file)."""
    return 4 * (rows(vb) * vb + jb * rows(vb))


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = common.load_library("mj_spmm")
    lib.ms_mj_spmm.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.ms_mj_spmm.restype = i
    lib.ms_error_string.argtypes = [i]
    lib.ms_error_string.restype = ctypes.c_char_p
    lib.ms_smem_bytes.argtypes = [i, i]
    lib.ms_smem_bytes.restype = i
    return lib


def check_shape(j: int, vb: int, jb: int) -> None:
    """Raise for a (J, Vb, job chunk) the kernel does not take."""
    common.check_job_chunk("mj_spmm", j, vb, jb, SUPPORTED_VB, smem_bytes)


def mj_spmm_call(d_sel: torch.Tensor, tiles: torch.Tensor, *,
                 tile_index: Optional[torch.Tensor] = None,
                 semiring: str = "plus_times",
                 job_block: Optional[int] = None) -> torch.Tensor:
    """d_sel [q, J, Vb] f32 and tiles [q, K, Vb, Vb] f32 (or [T, K, Vb,
    Vb] read at tile_index [q] int32) -> [q, K, J, Vb] f32."""
    ts = [d_sel, tiles] + ([tile_index] if tile_index is not None else [])
    if not common.on_cuda(*ts):
        return mj_spmm_ref(d_sel, tiles, semiring, tile_index=tile_index)
    if semiring not in launches:
        raise ValueError(f"unknown semiring {semiring!r}")
    q, j, vb = d_sel.shape
    num_tiles, k = tiles.shape[:2]
    if tiles.shape[2:] != (vb, vb):
        raise ValueError(f"tiles {tuple(tiles.shape)} do not match Vb={vb}")
    if tile_index is None:
        if num_tiles != q:
            raise ValueError(f"tiles hold {num_tiles} rows for q={q}; pass "
                             f"tile_index to read selected rows")
    else:
        tile_index = common.checked("tile_index", tile_index, torch.int32)
        if tuple(tile_index.shape) != (q,):
            raise ValueError(f"tile_index {tuple(tile_index.shape)} != "
                             f"({q},)")
    jb = job_block or j
    check_shape(j, vb, jb)
    d_sel = common.checked("d_sel", d_sel, torch.float32)
    tiles = common.checked("tiles", tiles, torch.float32)
    out = torch.empty((q, k, j, vb), dtype=torch.float32,
                      device=d_sel.device)
    if q * k * j == 0:
        return out
    if q * k > _MAX_GRID:
        raise ValueError(f"q*K={q * k} thread blocks exceed the grid limit")
    lib = _lib()
    common.launch(lib.ms_mj_spmm, d_sel.device, lib.ms_error_string,
                  d_sel.data_ptr(), tiles.data_ptr(),
                  None if tile_index is None else tile_index.data_ptr(),
                  out.data_ptr(), q, k, j, jb, num_tiles, vb,
                  int(semiring == "min_plus"))
    launches[semiring] += 1
    return out
