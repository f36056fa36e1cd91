"""The multi-job block SpMM as a CUDA kernel (csrc/mj_spmm.cu), both
semirings.

Replaces the TPU kernel `repro/kernels/mj_spmm/kernel.py`
(`mj_spmm_call` -> `_plus_kernel` / `_min_kernel`).  A persistent grid
walks work items (selected row i, a run of consecutive ELL slots, a pass
of up to `JR` jobs); a producer warp streams each run's contiguous tiles
through a ring of `STAGES` shared-memory stages of `STAGE_FLOATS` with
bulk copies, and consumer threads carry each pass's jobs in registers, so
each tile is read ceil(J / JR) times whatever J's divisors.  With
`tile_index` the kernel reads `tiles[tile_index[i], k]` straight from the
[B_N, K, Vb, Vb] block-ELL array, so no gathered [q, K, Vb, Vb] copy is
written.  Bound by device-memory bytes; see the note at the top of the
.cu file, whose geometry the functions below mirror.

Dispatch (kernels.common): CPU tensors run `ref.mj_spmm_ref`; CUDA
tensors launch the kernel or raise.  `launches` counts kernel launches
only, per semiring.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple, Optional

import torch

from repro_torch.kernels import common
from repro_torch.kernels.mj_spmm.ref import mj_spmm_ref

#: Vb values the kernel is instantiated for: every power of two from 8 to
#: 512 (the reference's Pallas kernel takes any Vb; ROADMAP C)
SUPPORTED_VB = (8, 16, 32, 64, 128, 256, 512)
#: jobs one pass carries in registers, at most (`JR` in the .cu file)
JR = 8
#: floats one ring stage holds (32 KB) and the ring's stages
STAGE_FLOATS = 8192
STAGES = 3
#: consumer threads of a thread block, at most (one producer warp beside)
MAX_CONSUMERS = 256

#: kernel launches per semiring since the last reset (plain runs excluded)
launches = {"plus_times": 0, "min_plus": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def rows(vb: int) -> int:
    """Source rows of a tile one stage holds: the whole tile up to Vb =
    64, a slice of STAGE_FLOATS / Vb rows above."""
    return vb if vb * vb <= STAGE_FLOATS else STAGE_FLOATS // vb


def tiles_per_stage(vb: int) -> int:
    """Whole tiles one stage holds up to Vb = 64 (128 at Vb = 8), else 1
    (a slice of one)."""
    return STAGE_FLOATS // (vb * vb) if vb * vb <= STAGE_FLOATS else 1


def consumers(vb: int) -> int:
    """Consumer threads of a thread block: one a (tile, lane) unit of a
    stage, at most MAX_CONSUMERS."""
    return min(MAX_CONSUMERS, tiles_per_stage(vb) * vb)


def units_per_thread(vb: int) -> int:
    """(tile, lane) units of a stage each consumer thread owns."""
    return tiles_per_stage(vb) * vb // consumers(vb)


def run_tiles(vb: int) -> int:
    """ELL slots of one work item: two stages of whole tiles up to Vb =
    64, one tile above."""
    return 2 * tiles_per_stage(vb) if vb * vb <= STAGE_FLOATS else 1


def job_pass(jb: int) -> int:
    """Jobs the kernel instance of a pass of `jb` jobs carries: 4 or JR
    (the 4-job instance is the faster at J = 4; PERF.md)."""
    return 4 if jb <= 4 else JR


def pass_jobs(j: int, job_block: Optional[int] = None) -> int:
    """Jobs one pass carries: min(job_block, JR), and min(J, JR) when the
    caller gives none, so ceil(J / JR) passes of the wrapper's own."""
    return min(job_block or j, JR)


def tile_reads(j: int, jb: int) -> int:
    """Times the design reads each tile: one per pass, ceil(J / jb)."""
    return -(-j // jb)


def smem_bytes(jb: int, vb: int) -> int:
    """Dynamic shared memory of one thread block: the ring, two d buffers
    of [job_pass(jb), Vb] and 2 * STAGES + 4 mbarriers (mirrors
    `smem_bytes_of` in the .cu file)."""
    return 4 * (STAGES * STAGE_FLOATS + 2 * job_pass(jb) * vb) + \
        8 * (2 * STAGES + 4)


def geometry(jb: int, vb: int) -> tuple:
    """(rows, tiles a stage, consumers, units a thread, slots a run, jobs
    the instance carries, shared memory bytes) of a pass of `jb` jobs at
    `vb`, as the .cu file's `ms_geometry` gives them."""
    return (rows(vb), tiles_per_stage(vb), consumers(vb),
            units_per_thread(vb), run_tiles(vb), job_pass(jb),
            smem_bytes(jb, vb))


class WorkItem(NamedTuple):
    """One work item: row `i`, slots [k0, k0 + nk), jobs [j0, j0 + jn)."""
    i: int
    k0: int
    nk: int
    j0: int
    jn: int


def work_items(q: int, k: int, j: int, vb: int,
               jb: Optional[int] = None) -> Iterator[WorkItem]:
    """The kernel's work items in its order (`item_of` in the .cu file):
    the pass fastest, then the run, then the row."""
    jb = pass_jobs(j, jb)
    runs, passes = -(-k // run_tiles(vb)), tile_reads(j, jb)
    for n in range(q * runs * passes):
        rest, p = divmod(n, passes)
        i, c = divmod(rest, runs)
        k0 = c * run_tiles(vb)
        yield WorkItem(i, k0, min(run_tiles(vb), k - k0), p * jb,
                       min(jb, j - p * jb))


def stage_units(vb: int, nk: int) -> Iterator[tuple]:
    """The kernel's walk of one run of `nk` slots: for each stage the
    producer cuts, each consumer thread's units (`u = tid + r *
    consumers`) that own a tile of it, as (stage, tid, r, slot in the
    run, (first, one past the last) source row, lane)."""
    rs, tps = rows(vb), tiles_per_stage(vb)
    nsl = vb // rs
    n_stages = -(-nk // tps) if nsl == 1 else nk * nsl
    nc = consumers(vb)
    for s in range(n_stages):
        sl = s % nsl
        kt = s * tps if nsl == 1 else s // nsl
        nt = min(tps, nk - kt) if nsl == 1 else 1
        for tid in range(nc):
            for r in range(units_per_thread(vb)):
                u = tid + r * nc
                tt, w = divmod(u, vb)
                if tt < nt:
                    yield s, tid, r, kt + tt, (sl * rs, sl * rs + rs), w


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = common.load_library("mj_spmm")
    lib.ms_mj_spmm.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.ms_mj_spmm.restype = i
    lib.ms_error_string.argtypes = [i]
    lib.ms_error_string.restype = ctypes.c_char_p
    lib.ms_geometry.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.ms_geometry.restype = i
    lib.ms_blocks_per_sm.argtypes = [i, i, i]
    lib.ms_blocks_per_sm.restype = i
    return lib


def check_shape(j: int, vb: int, jb: Optional[int] = None) -> None:
    """Raise for a (J, Vb, job_block) the kernel does not take: a Vb it
    is not instantiated for, an explicit `job_block` that does not divide
    J (the reference's rule; the kernel runs it as passes of
    `pass_jobs`), or shared memory over `common.SMEM_BUDGET`."""
    if vb not in SUPPORTED_VB:
        raise ValueError(f"the mj_spmm kernel takes Vb in {SUPPORTED_VB}, "
                         f"not {vb}")
    if jb is not None and (jb < 1 or j % jb):
        raise ValueError(f"job_block={jb} must divide J={j}")
    jp = pass_jobs(j, jb)
    if smem_bytes(jp, vb) > common.SMEM_BUDGET:
        raise ValueError(f"passes of {jp} jobs at Vb={vb} need "
                         f"{smem_bytes(jp, vb)} B of shared memory > "
                         f"{common.SMEM_BUDGET}")


def kernel_geometry(jb: int, vb: int) -> tuple:
    """The .cu file's own `ms_geometry` of a pass of `jb` jobs at `vb`
    (builds the kernel)."""
    g = (ctypes.c_int * 7)()
    rc = _lib().ms_geometry(jb, vb, g)
    if rc != 0:
        raise ValueError(f"mj_spmm geometry (jb={jb}, Vb={vb}): "
                         f"{_lib().ms_error_string(rc).decode()}")
    return tuple(g)


def blocks_per_sm(jb: int, vb: int, semiring: str) -> int:
    """Thread blocks of the kernel of a pass of `jb` jobs one SM holds
    (the persistent grid is SMs x this), from the CUDA occupancy
    calculator."""
    check_shape(jb, vb, jb)
    n = _lib().ms_blocks_per_sm(jb, vb, int(semiring == "min_plus"))
    if n < 0:
        raise RuntimeError(f"mj_spmm occupancy query failed: "
                           f"{_lib().ms_error_string(-n).decode()}")
    return n


def mj_spmm_call(d_sel: torch.Tensor, tiles: torch.Tensor, *,
                 tile_index: Optional[torch.Tensor] = None,
                 semiring: str = "plus_times",
                 job_block: Optional[int] = None) -> torch.Tensor:
    """d_sel [q, J, Vb] f32 and tiles [q, K, Vb, Vb] f32 (or [T, K, Vb,
    Vb] read at tile_index [q] int32) -> [q, K, J, Vb] f32.  `job_block`
    must divide J, as in the reference; it does not change the result."""
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
    check_shape(j, vb, job_block)
    jb = pass_jobs(j, job_block)
    d_sel = common.checked("d_sel", d_sel, torch.float32)
    tiles = common.checked("tiles", tiles, torch.float32)
    out = torch.empty((q, k, j, vb), dtype=torch.float32,
                      device=d_sel.device)
    if q * k * j == 0:
        return out
    lib = _lib()
    common.launch(lib.ms_mj_spmm, d_sel.device, lib.ms_error_string,
                  d_sel.data_ptr(), tiles.data_ptr(),
                  None if tile_index is None else tile_index.data_ptr(),
                  out.data_ptr(), q, k, j, jb, num_tiles, vb,
                  int(semiring == "min_plus"))
    launches[semiring] += 1
    return out
