"""The fused superstep as two CUDA kernels (csrc/fused_superstep.cu).

Replaces the TPU kernel `repro/kernels/fused_superstep/kernel.py`
(`fused_superstep_call` -> `_make_plus_kernel` / `_make_min_kernel`).
One thread block per (destination run, job chunk) walks the run's pairs
in order with a cp.async double buffer; each thread owns one (job, lane)
output and the block reduces <Node_un, P_sum> at the run's end.  The
calls are bound by device-memory bytes (every call sweeps all P tiles);
see the note at the top of the .cu file.

Dispatch (kernels.common): CPU tensors run `ref.fused_superstep_ref`; CUDA
tensors launch the kernel or raise.  `launches` counts kernel launches
only, per semiring.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import common
from repro_torch.kernels.fused_superstep.ref import fused_superstep_ref

#: Vb values the kernels are instantiated for
SUPPORTED_VB = (16, 32, 64, 128)

#: kernel launches per semiring since the last reset (plain runs excluded):
#: a plain host count.  Under the device backend every superstep slot of
#: a chunk launches for every view group, gated ones and converged groups
#: included (their results are discarded on the device), so there it
#: counts chunk slots x groups, not pushes.
launches = {"plus_times": 0, "min_plus": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def smem_bytes(jb: int, vb: int) -> int:
    """Dynamic shared memory of one thread block: a double-buffered
    [Vb, Vb] tile, double-buffered [jb, Vb] d rows and the flush's
    per-warp partial sums (mirrors `smem_bytes` in the .cu file)."""
    nw = vb // 32 if vb >= 32 else 1
    return 4 * (2 * vb * vb + 2 * jb * vb + 2 * jb * nw)


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures."""
    lib = common.load_library("fused_superstep")
    lib.fs_plus_times.argtypes = [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, ctypes.c_float, _P]
    lib.fs_plus_times.restype = _I
    lib.fs_min_plus.argtypes = [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                                _P, _I, _I, _I, _I, _I, _P]
    lib.fs_min_plus.restype = _I
    lib.fs_error_string.argtypes = [_I]
    lib.fs_error_string.restype = ctypes.c_char_p
    lib.fs_smem_bytes.argtypes = [_I, _I]
    lib.fs_smem_bytes.restype = _I
    return lib


def check_shape(j: int, vb: int, jb: int) -> None:
    """Raise for a (J, Vb, job chunk) the kernels do not take."""
    common.check_job_chunk("fused_superstep", j, vb, jb, SUPPORTED_VB,
                           smem_bytes)


def fused_superstep_call(src, dst, first, last, d, base, tiles, *,
                         values=None, run_start=None,
                         semiring: str = "plus_times",
                         tolerance: float = 1e-6,
                         job_block: int | None = None):
    """One fused push + priority update over destination-sorted pairs.

    src/dst/first/last [P] int32 (`BlockPairs` metadata, dst-sorted);
    run_start [R+1] int32 run offsets (`BlockPairs.run_start`; derived
    from `first` when None); d [J, B_N, Vb] consumed pending deltas with
    NON-selected source rows masked to the semiring identity (0 / +inf),
    pre-scaled for plus-times; base [J, B_loc, Vb] post-consume deltas;
    tiles [P, Vb, Vb].

    plus-times  -> (delta_out, node_un, p_sum)
    min-plus    -> (values_out, delta_out, node_un, p_sum)  (`values`
                   [J, B_loc, Vb] required)

    Outputs are defined only for blocks that appear as a destination.
    Output width follows `base` (B_loc); `d` is read at the global source
    width B_N.  node_un/p_sum [J, B_loc] reduce the POST-push state.
    """
    ts = [src, dst, d, base, tiles] + ([values] if values is not None
                                       else [])
    if not common.on_cuda(*ts):
        return fused_superstep_ref(src, dst, first, last, d, base, tiles,
                                   values=values, semiring=semiring,
                                   tolerance=tolerance)
    if semiring not in launches:
        raise ValueError(f"unknown semiring {semiring!r}")
    if semiring == "min_plus" and values is None:
        raise ValueError("the min-plus fused call needs `values`")
    j, bn_src, vb = d.shape
    bn_loc = base.shape[1]
    jb = job_block or j
    check_shape(j, vb, jb)
    if run_start is None:
        first_l = first.long()
        run_start = torch.cat([
            torch.nonzero(first_l).flatten(),
            torch.tensor([first_l.numel()], device=first.device)]
        ).to(torch.int32)
    num_runs = run_start.numel() - 1
    src = common.checked("src", src, torch.int32)
    dst = common.checked("dst", dst, torch.int32)
    run_start = common.checked("run_start", run_start, torch.int32)
    d = common.checked("d", d, torch.float32)
    base = common.checked("base", base, torch.float32)
    tiles = common.checked("tiles", tiles, torch.float32)
    if tiles.shape[1:] != (vb, vb) or tiles.shape[0] != src.shape[0]:
        raise ValueError(f"tiles {tuple(tiles.shape)} do not match "
                         f"P={src.shape[0]}, Vb={vb}")
    if base.shape != (j, bn_loc, vb):
        raise ValueError(f"base {tuple(base.shape)} != {(j, bn_loc, vb)}")
    kw = dict(dtype=torch.float32, device=d.device)
    state = (j, bn_loc, vb)
    pair_out = (torch.empty((j, bn_loc), **kw),
                torch.empty((j, bn_loc), **kw))      # node_un, p_sum
    if semiring == "plus_times":
        ins = (d, base, tiles)
        result = (torch.empty(state, **kw),) + pair_out
        scalars = (j, jb, bn_src, bn_loc, vb, float(tolerance))
    else:
        values = common.checked("values", values, torch.float32)
        if values.shape != base.shape:
            raise ValueError(f"values {tuple(values.shape)} != "
                             f"base {tuple(base.shape)}")
        ins = (d, values, base, tiles)
        result = (torch.empty(state, **kw), torch.empty(state, **kw)) + pair_out
        scalars = (j, jb, bn_src, bn_loc, vb)
    if num_runs == 0:                 # nothing to write: outputs undefined
        return result
    lib = _lib()
    launch = lib.fs_plus_times if semiring == "plus_times" else lib.fs_min_plus
    ptrs = [t.data_ptr() for t in (src, dst, run_start)]
    with torch.cuda.device(d.device):
        rc = launch(*ptrs, num_runs, *(t.data_ptr() for t in ins + result),
                    *scalars, torch.cuda.current_stream(d.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_superstep {semiring} launch failed: "
                           f"{lib.fs_error_string(rc).decode()}")
    launches[semiring] += 1
    return result
