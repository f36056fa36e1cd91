"""The fused superstep as two CUDA kernels (csrc/fused_superstep.cu).

Replaces the TPU kernel `repro/kernels/fused_superstep/kernel.py`
(`fused_superstep_call` -> `_make_plus_kernel` / `_make_min_kernel`).
A first kernel packs the live jobs' d rows source-major; then one thread
block per work item (a chunk of at most `PAIR_CHUNK` pairs of one
destination run, or a share of its live pairs when a call has fewer
chunks than the card has SMs: `split`) walks passes of the view's live
jobs, JR jobs of one lane a thread (`layout`), and streams the item's live
pairs through a TMA ring once a pass, a whole tile a stage up to Vb = 128
and 32 KB slices of source rows above (`rows`).  The last item of a run
combines the run's partials in item order and reduces <Node_un, P_sum>;
dead jobs are written through from their base.  See the note at the top
of the .cu file.

Dispatch (kernels.common): CPU tensors run `ref.fused_superstep_ref`; CUDA
tensors launch the kernels or raise.  `launches` counts kernel launches
only, per semiring; `b1b2_counts` accumulates the stagings and skipped
jobs of every call on a device, on the device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.graph.structure import PAIR_CHUNK, chunk_table
from repro_torch.kernels import common
from repro_torch.kernels.fused_superstep.ref import fused_superstep_ref

#: Vb values the kernels are instantiated for: every power of two from 8
#: to 512 (the reference's Pallas kernels take any Vb; ROADMAP C)
SUPPORTED_VB = (8, 16, 32, 64, 128, 256, 512)

#: live pairs compacted per pass in one thread block (mirrors WINDOW in
#: the .cu file)
WINDOW = 256

#: work items a chunk is split into, at most (`split`)
MAX_SPLIT = 8

#: shared memory of one SM on sm_90, and what the card reserves of it for
#: each resident thread block
SMEM_PER_SM = 228 * 1024
SMEM_PER_BLOCK_RESERVED = 1024

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
    """Depth of the TMA ring of the one-job-a-thread layout: 3 thread
    blocks an SM at Vb = 64 (4 x 17 KB stages each), one from Vb = 256
    with 6 stages of 32 KB slices.  The kernels take the depth from
    `layout`."""
    return 6 if vb >= 256 else 3 if vb >= 128 else 4 if vb >= 64 else 6


def rows(vb: int) -> int:
    """Source rows of a tile one ring stage holds: the whole tile up to
    Vb = 128, a 32 KB slice above (mirrors `rows` in the .cu file)."""
    return 8192 // vb if vb >= 256 else vb


def wide_jobs(vb: int) -> int:
    """Jobs a thread carries in the many-jobs layout, JW (mirrors
    `wide_jobs` in the .cu file)."""
    return 12 if vb >= 256 else 8


class Layout(NamedTuple):
    """The kernels' job layout at (J, Vb): `jr` jobs of one lane a thread,
    `groups` groups of Vb threads a thread block, `ns` ring stages.  A
    pass holds `pass_jobs` = jr x groups live jobs."""
    jr: int
    groups: int
    ns: int

    @property
    def pass_jobs(self) -> int:
        return self.jr * self.groups

    def passes(self, n_live: int) -> int:
        """Passes (and stagings of each live tile) for n_live live jobs."""
        return -(-n_live // self.pass_jobs)


def smem_bytes(vb: int, j: int, lay: Layout) -> int:
    """Dynamic shared memory of one thread block: 2*NS mbarriers, NS ring
    stages of an [rows(Vb), Vb] tile slice and [pass_jobs, rows(Vb)]
    packed d rows, the flush's per-warp sums, the live-pair list, per-warp
    counts, four ints and J job ids (mirrors `smem_bytes_of` in the .cu
    file)."""
    ns, rs, pj = lay.ns, rows(vb), lay.pass_jobs
    nw = vb // 32 if vb >= 32 else 1
    return 16 * ns + 4 * (ns * (rs * vb + pj * rs) + 2 * pj * nw
                          + 2 * WINDOW + 32 + 4 + j)


def layout(j: int, vb: int) -> Layout:
    """The job layout table: where J jobs x Vb lanes fit one thread block
    (1024 threads), a thread owns one (job, lane) and one pass holds every
    job, with the ring of `stages(vb)`; else a thread carries JW jobs of
    its lane, as many groups of Vb threads as the view's jobs fill (at
    most 1024 threads), and the deepest ring (up to `stages(vb)`, 6 from
    Vb = 256) that leaves two thread blocks an SM up to Vb = 128 and one
    above."""
    if j * vb <= common.MAX_THREADS:
        return Layout(1, j, stages(vb))
    jr = wide_jobs(vb)
    groups = min(common.MAX_THREADS // vb, -(-j // jr))
    budget = (SMEM_PER_SM // 2 - SMEM_PER_BLOCK_RESERVED if vb <= 128
              else common.SMEM_BUDGET)
    ns = stages(vb)
    while ns > 2 and smem_bytes(vb, j, Layout(jr, groups, ns)) > budget:
        ns -= 1
    return Layout(jr, groups, ns)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split(n_chunks: int, sms: int) -> int:
    """Work items a chunk's live pairs are split into: one item an SM when
    the call has fewer chunks than SMs, at most `MAX_SPLIT`."""
    return max(1, min(MAX_SPLIT, sms // max(n_chunks, 1)))


_P = ctypes.c_void_p
_I = ctypes.c_int
_LAYOUT = ctypes.c_int * 7
_PL = ctypes.POINTER(ctypes.c_int)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures."""
    lib = common.load_library("fused_superstep")
    head = [_P, _P, _P, _P, _P, _I] + [_P] * 8
    lib.fs_plus_times.argtypes = head + [_P] * 5 + [_PL, _I, ctypes.c_float,
                                                    _P]
    lib.fs_plus_times.restype = _I
    lib.fs_min_plus.argtypes = head + [_P] * 7 + [_PL, _I, _P]
    lib.fs_min_plus.restype = _I
    lib.fs_error_string.argtypes = [_I]
    lib.fs_error_string.restype = ctypes.c_char_p
    lib.fs_smem_bytes.argtypes = [_I] * 5
    lib.fs_smem_bytes.restype = _I
    lib.fs_wide_jobs.argtypes = [_I]
    lib.fs_wide_jobs.restype = _I
    lib.fs_blocks_per_sm.argtypes = [_I] * 6
    lib.fs_blocks_per_sm.restype = _I
    return lib


def blocks_per_sm(vb: int, j: int, semiring: str) -> int:
    """Thread blocks of the kernel that one SM holds at (Vb, J)'s layout,
    by the CUDA occupancy calculator (registers, shared memory,
    threads)."""
    lay = layout(j, vb)
    return _lib().fs_blocks_per_sm(vb, j, lay.jr, lay.groups, lay.ns,
                                   int(semiring == "min_plus"))


def kernel_geometry(vb: int, j: int) -> dict:
    """The .cu file's own view of (Vb, J)'s layout (needs the library):
    JW and the shared memory bytes, to hold the mirrors against."""
    lay = layout(j, vb)
    lib = _lib()
    return {"wide_jobs": lib.fs_wide_jobs(vb),
            "smem_bytes": lib.fs_smem_bytes(vb, j, lay.jr, lay.groups,
                                            lay.ns)}


def check_shape(j: int, vb: int) -> None:
    """Raise for a (J, Vb) the kernels do not take: a Vb they are not
    instantiated for, or a layout over the thread or shared memory
    budget."""
    if vb not in SUPPORTED_VB:
        raise ValueError(f"the fused_superstep kernel takes Vb in "
                         f"{SUPPORTED_VB}, not {vb}")
    if j < 1:
        raise ValueError(f"the fused_superstep kernel needs J >= 1, not {j}")
    lay = layout(j, vb)
    if common.threads(lay.groups, vb) > common.MAX_THREADS:
        raise ValueError(f"{lay.groups} groups x Vb={vb} exceed "
                         f"{common.MAX_THREADS} threads per block")
    if smem_bytes(vb, j, lay) > common.SMEM_BUDGET:
        raise ValueError(f"J={j} x Vb={vb} needs {smem_bytes(vb, j, lay)} B "
                         f"of shared memory > {common.SMEM_BUDGET}")


_COUNTS: dict = {}


def b1b2_counts(device) -> torch.Tensor:
    """The device's [2] int64 counters of B1/B2 work, accumulated by every
    `fused_superstep_call` on it without a host read: live pairs x the
    passes that staged them, and (job slot, call) pairs whose arithmetic
    was skipped (a job without a live row).  A gated call adds nothing.
    The drivers zero them at a run's start and read them with the run's
    last read."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:   # one tensor a card
        dev = torch.device("cuda", torch.cuda.current_device())
    t = _COUNTS.get(dev)
    if t is None:
        t = torch.zeros(2, dtype=torch.int64, device=dev)
        _COUNTS[dev] = t
    return t


def expected_counts(src, dst, src_live, job_live, j: int, vb: int,
                    bn_src: int, bn_loc: int) -> torch.Tensor:
    """(stagings, jobs skipped) of one open call, as [2] int64 on the
    inputs' device: the live pairs (a source in range and live, a
    destination in range) times the passes of the live jobs, and the
    jobs without a live row."""
    s = src.long()
    ok = (s >= 0) & (s < bn_src) & (dst.long() >= 0) & (dst.long() < bn_loc)
    if src_live is not None:
        ok = ok & src_live.bool()[s.clamp(0, bn_src - 1)]
    n_live = (job_live.bool().sum() if job_live is not None
              else torch.tensor(j, device=src.device))
    pj = layout(j, vb).pass_jobs
    passes = torch.div(n_live + pj - 1, pj, rounding_mode="floor")
    return torch.stack([ok.sum() * passes, j - n_live]).to(torch.int64)


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
                         job_live=None, gate=None,
                         semiring: str = "plus_times",
                         tolerance: float = 1e-6):
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

    Optional (the plain version reads `src_live` and `job_live`):

      run_start [R+1] int32     run offsets (`BlockPairs.run_start`;
                                derived from `first` when None)
      chunk_start, chunk_run    the work items (`BlockPairs.chunk_start`,
                                `.chunk_run`; `graph.chunk_table` of
                                run_start at `PAIR_CHUNK` when None)
      arrivals [>= R] int32     per-run counters, zero between calls
                                (`BlockPairs.arrivals()`; fresh zeros
                                when None)
      src_live [B_N] bool/uint8  the live source blocks; pairs from other
                                sources are not staged.  Precondition:
                                their rows of `d` are already the
                                semiring identity, so skipping them is
                                exact (min-plus bitwise, plus-times up to
                                the sign of a zero).  None: all live.
      job_live [J] bool/uint8   the live jobs; the others are not pushed:
                                their base is written through (min-plus:
                                values and base) and flushed.
                                Precondition: their rows of `d` are the
                                semiring identity, so skipping them is
                                exact as above.  None: all live.
      gate      0-dim bool      read by the kernels at entry: when False
                                they load nothing, count nothing and the
                                outputs are undefined (the caller
                                discards them).  None: open.

    Every call adds its stagings and skipped jobs to `b1b2_counts` of the
    device.  Deriving run_start or the chunk table reads the device from
    the host.
    """
    ts = [src, dst, d, base, tiles] + ([values] if values is not None
                                       else [])
    j, bn_src, vb = d.shape
    bn_loc = base.shape[1]
    if not common.on_cuda(*ts):
        out = fused_superstep_ref(src, dst, first, last, d, base, tiles,
                                  values=values, src_live=src_live,
                                  job_live=job_live, semiring=semiring,
                                  tolerance=tolerance)
        cnt = expected_counts(src, dst, src_live, job_live, j, vb, bn_src,
                              bn_loc)
        if gate is not None:          # a closed gate counts nothing
            cnt = cnt * gate.to(torch.int64)
        b1b2_counts(d.device).add_(cnt)
        return out
    if semiring not in launches:
        raise ValueError(f"unknown semiring {semiring!r}")
    if semiring == "min_plus" and values is None:
        raise ValueError("the min-plus fused call needs `values`")
    if (chunk_start is None) != (chunk_run is None):
        raise ValueError("pass chunk_start and chunk_run together")
    check_shape(j, vb)
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
    if arrivals is None:
        arrivals = torch.zeros(num_runs, dtype=torch.int32, device=d.device)
    arrivals = common.checked("arrivals", arrivals, torch.int32)
    if arrivals.numel() < num_runs:
        raise ValueError(f"arrivals holds {arrivals.numel()} counters, "
                         f"the call needs {num_runs}")
    flags = (_flag("src_live", src_live, d.device, (bn_src,)),
             _flag("job_live", job_live, d.device, (j,)),
             _flag("gate", gate, d.device, ()))
    kw = dict(dtype=torch.float32, device=d.device)
    state = (j, bn_loc, vb)
    pair_out = (torch.empty((j, bn_loc), **kw),
                torch.empty((j, bn_loc), **kw))      # node_un, p_sum
    if semiring == "plus_times":
        ins = (base, tiles)
        result = (torch.empty(state, **kw),) + pair_out
        tail = (float(tolerance),)
    else:
        values = common.checked("values", values, torch.float32)
        if values.shape != base.shape:
            raise ValueError(f"values {tuple(values.shape)} != "
                             f"base {tuple(base.shape)}")
        ins = (values, base, tiles)
        result = (torch.empty(state, **kw), torch.empty(state, **kw)) + pair_out
        tail = ()
    if n_chunks == 0:                 # nothing to write: outputs undefined
        return result
    lay = layout(j, vb)
    sp = split(n_chunks, _sm_count(d.device.index))
    partial = torch.empty((n_chunks * sp, j, vb), **kw)
    d_pack = torch.empty((bn_src, j, vb), **kw)
    counts = b1b2_counts(d.device)
    geom = _LAYOUT(j, lay.jr, lay.groups, lay.ns, sp, bn_src, bn_loc)
    lib = _lib()
    fn = lib.fs_plus_times if semiring == "plus_times" else lib.fs_min_plus
    ptrs = [t.data_ptr() for t in (src, dst, run_start, chunk_start,
                                   chunk_run)]
    common.launch(fn, d.device, lib.fs_error_string, *ptrs, n_chunks,
                  *flags, counts.data_ptr(), arrivals.data_ptr(),
                  partial.data_ptr(), d.data_ptr(), d_pack.data_ptr(),
                  *(t.data_ptr() for t in ins + result), geom, vb, *tail)
    launches[semiring] += 1
    return result
