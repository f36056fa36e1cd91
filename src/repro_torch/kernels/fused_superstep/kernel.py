"""The fused superstep as two CUDA kernels (csrc/fused_superstep.cu).

Replaces the TPU kernel `repro/kernels/fused_superstep/kernel.py`
(`fused_superstep_call` -> `_make_plus_kernel` / `_make_min_kernel`).
One thread block per (chunk of at most `PAIR_CHUNK` pairs of one
destination run, job chunk) streams its chunk's live pairs through a
TMA ring; each thread owns one (job, lane) output, and the last block of
a run combines the run's partials in chunk order and reduces
<Node_un, P_sum>.  The calls are bound by the bytes of the live pairs'
tiles; see the note at the top of the .cu file.

Dispatch (kernels.common): CPU tensors run `ref.fused_superstep_ref`; CUDA
tensors launch the kernel or raise.  `launches` counts kernel launches
only, per semiring.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.graph.structure import PAIR_CHUNK, chunk_table
from repro_torch.kernels import common
from repro_torch.kernels.fused_superstep.ref import fused_superstep_ref

#: Vb values the kernels are instantiated for
SUPPORTED_VB = (16, 32, 64, 128)

#: live pairs compacted per pass in one thread block (mirrors WINDOW in
#: the .cu file)
WINDOW = 256

#: kernel launches per semiring since the last reset (plain runs excluded):
#: a plain host count.  Under the device backend every superstep slot of
#: a chunk launches for every view group, gated ones and converged groups
#: included (those read their closed gate and return before any load), so
#: there it counts chunk slots x groups, not pushes.
launches = {"plus_times": 0, "min_plus": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def stages(vb: int) -> int:
    """Depth of the TMA ring (mirrors `stages` in the .cu file)."""
    return 3 if vb >= 128 else 4 if vb >= 64 else 6


def smem_bytes(jb: int, vb: int) -> int:
    """Dynamic shared memory of one thread block: the ring's stages of a
    [Vb, Vb] tile and [jb, Vb] d rows, the live-pair list, per-warp
    counts, the flush's per-warp sums, four ints and the ring's 2*NS
    mbarriers (mirrors `smem_bytes` in the .cu file)."""
    ns = stages(vb)
    nw = vb // 32 if vb >= 32 else 1
    floats = ns * (vb * vb + jb * vb) + 2 * WINDOW + 32 + 2 * jb * nw + 4
    return 4 * floats + 16 * ns


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures."""
    lib = common.load_library("fused_superstep")
    head = [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P]
    lib.fs_plus_times.argtypes = head + [_P] * 6 + [_I] * 5 + [
        ctypes.c_float, _P]
    lib.fs_plus_times.restype = _I
    lib.fs_min_plus.argtypes = head + [_P] * 8 + [_I] * 5 + [_P]
    lib.fs_min_plus.restype = _I
    lib.fs_error_string.argtypes = [_I]
    lib.fs_error_string.restype = ctypes.c_char_p
    lib.fs_smem_bytes.argtypes = [_I, _I]
    lib.fs_smem_bytes.restype = _I
    lib.fs_blocks_per_sm.argtypes = [_I, _I, _I]
    lib.fs_blocks_per_sm.restype = _I
    return lib


def blocks_per_sm(jb: int, vb: int, semiring: str) -> int:
    """Thread blocks of the kernel that one SM holds at (jb, Vb), by the
    CUDA occupancy calculator (registers, shared memory, threads)."""
    return _lib().fs_blocks_per_sm(jb, vb, int(semiring == "min_plus"))


def check_shape(j: int, vb: int, jb: int) -> None:
    """Raise for a (J, Vb, job chunk) the kernels do not take."""
    common.check_job_chunk("fused_superstep", j, vb, jb, SUPPORTED_VB,
                           smem_bytes)


def _run_start(first: torch.Tensor) -> torch.Tensor:
    """[R+1] run offsets from the first-of-run flags (a host read)."""
    first_l = first.long()
    return torch.cat([
        torch.nonzero(first_l).flatten(),
        torch.tensor([first_l.numel()], device=first.device)]
    ).to(torch.int32)


def _chunks(run_start: torch.Tensor):
    """The chunk table of `run_start` at `PAIR_CHUNK` (a host read)."""
    cs, cr = chunk_table(run_start.cpu().numpy(), PAIR_CHUNK)
    dev = run_start.device
    return (torch.as_tensor(cs, device=dev),
            torch.as_tensor(cr, device=dev))


def _flag(name: str, t, device, shape) -> int | None:
    """Data pointer of an optional bool / uint8 flag tensor, or None."""
    if t is None:
        return None
    if t.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"{name} must be bool or uint8, got {t.dtype}")
    if tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name} must be {shape} on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def fused_superstep_call(src, dst, first, last, d, base, tiles, *,
                         values=None, run_start=None, chunk_start=None,
                         chunk_run=None, arrivals=None, src_live=None,
                         gate=None, semiring: str = "plus_times",
                         tolerance: float = 1e-6,
                         job_block: int | None = None):
    """One fused push + priority update over destination-sorted pairs.

    src/dst/first/last [P] int32 (`BlockPairs` metadata, dst-sorted);
    d [J, B_N, Vb] consumed pending deltas with NON-selected source rows
    masked to the semiring identity (0 / +inf), pre-scaled for
    plus-times; base [J, B_loc, Vb] post-consume deltas; tiles [P, Vb, Vb].

    plus-times  -> (delta_out, node_un, p_sum)
    min-plus    -> (values_out, delta_out, node_un, p_sum)  (`values`
                   [J, B_loc, Vb] required)

    Outputs are defined only for blocks that appear as a destination.
    Output width follows `base` (B_loc); `d` is read at the global source
    width B_N.  node_un/p_sum [J, B_loc] reduce the POST-push state.

    Optional, for the CUDA kernels (the plain version reads only
    `src_live`):

      run_start [R+1] int32     run offsets (`BlockPairs.run_start`;
                                derived from `first` when None)
      chunk_start, chunk_run    the work items (`BlockPairs.chunk_start`,
                                `.chunk_run`; `graph.chunk_table` of
                                run_start at `PAIR_CHUNK` when None)
      arrivals [>= R*J/jb] int32  per-(run, job chunk) counters, zero
                                between calls (`BlockPairs.arrivals`;
                                fresh zeros when None)
      src_live [B_N] bool/uint8  the live source blocks; pairs from other
                                sources are not staged.  Precondition:
                                their rows of `d` are already the
                                semiring identity, so skipping them is
                                exact (min-plus bitwise, plus-times up to
                                the sign of a zero).  None: all live.
      gate      0-dim bool      read by the kernel at entry: when False
                                it loads nothing and the outputs are
                                undefined (the caller discards them).
                                None: open.

    Deriving run_start or the chunk table reads the device from the host.
    """
    ts = [src, dst, d, base, tiles] + ([values] if values is not None
                                       else [])
    if not common.on_cuda(*ts):
        return fused_superstep_ref(src, dst, first, last, d, base, tiles,
                                   values=values, src_live=src_live,
                                   semiring=semiring, tolerance=tolerance)
    if semiring not in launches:
        raise ValueError(f"unknown semiring {semiring!r}")
    if semiring == "min_plus" and values is None:
        raise ValueError("the min-plus fused call needs `values`")
    if (chunk_start is None) != (chunk_run is None):
        raise ValueError("pass chunk_start and chunk_run together")
    j, bn_src, vb = d.shape
    bn_loc = base.shape[1]
    jb = job_block or j
    check_shape(j, vb, jb)
    if run_start is None:
        run_start = _run_start(first)
    if chunk_start is None:
        chunk_start, chunk_run = _chunks(run_start)
    num_runs = run_start.numel() - 1
    n_chunks = chunk_run.numel()
    src = common.checked("src", src, torch.int32)
    dst = common.checked("dst", dst, torch.int32)
    run_start = common.checked("run_start", run_start, torch.int32)
    chunk_start = common.checked("chunk_start", chunk_start, torch.int32)
    chunk_run = common.checked("chunk_run", chunk_run, torch.int32)
    if chunk_start.numel() != n_chunks + 1:
        raise ValueError(f"chunk_start has {chunk_start.numel()} entries "
                         f"for {n_chunks} chunks")
    d = common.checked("d", d, torch.float32)
    base = common.checked("base", base, torch.float32)
    tiles = common.checked("tiles", tiles, torch.float32)
    if tiles.shape[1:] != (vb, vb) or tiles.shape[0] != src.shape[0]:
        raise ValueError(f"tiles {tuple(tiles.shape)} do not match "
                         f"P={src.shape[0]}, Vb={vb}")
    if base.shape != (j, bn_loc, vb):
        raise ValueError(f"base {tuple(base.shape)} != {(j, bn_loc, vb)}")
    need = num_runs * (j // jb)
    if arrivals is None:
        arrivals = torch.zeros(need, dtype=torch.int32, device=d.device)
    arrivals = common.checked("arrivals", arrivals, torch.int32)
    if arrivals.numel() < need:
        raise ValueError(f"arrivals holds {arrivals.numel()} counters, "
                         f"the call needs {need}")
    flags = (_flag("src_live", src_live, d.device, (bn_src,)),
             _flag("gate", gate, d.device, ()))
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
    if n_chunks == 0:                 # nothing to write: outputs undefined
        return result
    partial = torch.empty((n_chunks, j, vb), **kw)
    lib = _lib()
    launch = lib.fs_plus_times if semiring == "plus_times" else lib.fs_min_plus
    ptrs = [t.data_ptr() for t in (src, dst, run_start, chunk_start,
                                   chunk_run)]
    with torch.cuda.device(d.device):
        rc = launch(*ptrs, n_chunks, *flags, arrivals.data_ptr(),
                    partial.data_ptr(),
                    *(t.data_ptr() for t in ins + result),
                    *scalars, torch.cuda.current_stream(d.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_superstep {semiring} launch failed: "
                           f"{lib.fs_error_string(rc).decode()}")
    launches[semiring] += 1
    return result
