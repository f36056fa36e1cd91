"""Per-superstep telemetry: a fixed-schema time series over one run().

A ``TelemetrySeries`` records, per superstep:

  active_jobs       [K]    jobs with pending work this superstep
  tile_loads        [K]    adjacency-block stagings this superstep
  job_block_pushes  [K]    (job, block) processing events this superstep
  tile_pair_loads   [K]    nonzero block-pair stagings this superstep
  halo_bytes        [K]    frontier bytes exchanged across block shards
                           this superstep (0 on one device)
  gq_occupancy      [K]    staged-selection occupancy (shared policies:
                           global-queue length <= q; independent: total
                           per-job queue entries)
  dirty_blocks      [K]    update-affected blocks boosted this superstep
                           (nonzero only on the first superstep after
                           apply_updates)
  unconverged       [K, G] unconverged-vertex count per view group
  max_residual      [K, G] max vertex priority per view group, read from
                           the state before the superstep's push

Collection is opt-in via ``GraphSession(telemetry=...)``.  Off, the host
driver skips the bookkeeping and the device driver's chunk issues
exactly the operations it issues without this module (the session's
step-function cache key carries the capacity, 0 when off).

On the device path the series rides the chunk's carry as one
preallocated ``[capacity, 7 + 2G]`` row buffer, written in place at a
device index (``device_write``), so nothing in a chunk reads the device
from the host and the buffer keeps its address from chunk to chunk.  A run longer
than ``capacity`` supersteps keeps converging; its series is marked
``truncated`` and the overflow supersteps collapse into the last row.

The schema, the host builder and the host series are the reference's
(`repro.obs.telemetry`); the device buffers are torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["TelemetryConfig", "TelemetrySeries", "HostSeriesBuilder",
           "device_buffers", "device_write", "device_rows",
           "series_from_rows", "series_from_device", "SERIES_FIELDS",
           "GROUP_FIELDS", "DEFAULT_CAPACITY"]

# the fixed schema: per-superstep scalars ...
SERIES_FIELDS = ("active_jobs", "tile_loads", "job_block_pushes",
                 "gq_occupancy", "dirty_blocks", "tile_pair_loads",
                 "halo_bytes")
# ... and per-(superstep, view-group) columns
GROUP_FIELDS = ("unconverged", "max_residual")

DEFAULT_CAPACITY = 4096


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """What ``GraphSession(telemetry=...)`` turns on.

    capacity      device-path buffer length (~30 bytes per superstep)
    trace         record structured trace events on ``session.trace``
                  (submit/detach, superstep spans, apply_updates batches,
                  compactions) for Chrome/Perfetto export
    jax_profiler  additionally wrap the drivers' scheduling and push
                  phases in ``torch.profiler.record_function`` spans
                  (visible under an active torch.profiler session).  The
                  name is the reference's, so one config drives both
                  packages.
    """

    capacity: int = DEFAULT_CAPACITY
    trace: bool = True
    jax_profiler: bool = False

    @staticmethod
    def coerce(value: Union[None, bool, "TelemetryConfig"]
               ) -> Optional["TelemetryConfig"]:
        """None/False -> disabled; True -> defaults; a config -> itself."""
        if value is None or value is False:
            return None
        if value is True:
            return TelemetryConfig()
        if isinstance(value, TelemetryConfig):
            return value
        raise TypeError(
            f"telemetry must be None, bool or TelemetryConfig: {value!r}")


@dataclasses.dataclass
class TelemetrySeries:
    """One run()'s per-superstep series (numpy, host-side)."""

    view_keys: Tuple[tuple, ...]
    active_jobs: np.ndarray        # [K] int64
    tile_loads: np.ndarray         # [K] int64
    job_block_pushes: np.ndarray   # [K] int64
    gq_occupancy: np.ndarray       # [K] int64
    dirty_blocks: np.ndarray       # [K] int64
    tile_pair_loads: np.ndarray    # [K] int64
    halo_bytes: np.ndarray         # [K] float64
    unconverged: np.ndarray        # [K, G] int64
    max_residual: np.ndarray       # [K, G] float32
    truncated: bool = False        # device buffer overflowed (capacity < K)

    def __len__(self) -> int:
        return int(self.active_jobs.shape[0])

    @property
    def num_groups(self) -> int:
        return int(self.unconverged.shape[1])

    def to_dict(self) -> dict:
        """JSON-ready dict (the trace exporter's and the registry's)."""
        d = {"schema": list(SERIES_FIELDS) + list(GROUP_FIELDS),
             "supersteps": len(self),
             "view_keys": [list(map(str, k)) for k in self.view_keys],
             "truncated": self.truncated}
        for f in SERIES_FIELDS:
            d[f] = getattr(self, f).tolist()
        d["halo_bytes"] = [round(float(x), 6) for x in self.halo_bytes]
        d["unconverged"] = self.unconverged.tolist()
        d["max_residual"] = [[round(float(x), 8) for x in row]
                             for row in self.max_residual]
        return d


class HostSeriesBuilder:
    """Per-superstep appender for the host driver (python lists)."""

    def __init__(self, view_keys: Sequence[tuple]):
        self.view_keys = tuple(view_keys)
        self._rows: List[tuple] = []

    def append(self, active_jobs: int, tile_loads: int,
               job_block_pushes: int, gq_occupancy: int, dirty_blocks: int,
               unconverged: Sequence[int],
               max_residual: Sequence[float],
               tile_pair_loads: int = 0, halo_bytes: float = 0.0) -> None:
        self._rows.append((int(active_jobs), int(tile_loads),
                           int(job_block_pushes), int(gq_occupancy),
                           int(dirty_blocks),
                           int(tile_pair_loads), float(halo_bytes),
                           tuple(int(u) for u in unconverged),
                           tuple(float(r) for r in max_residual)))

    def build(self) -> TelemetrySeries:
        g = len(self.view_keys)
        k = len(self._rows)
        cols = list(zip(*self._rows)) if k else [()] * 9
        return TelemetrySeries(
            view_keys=self.view_keys,
            active_jobs=np.asarray(cols[0], dtype=np.int64),
            tile_loads=np.asarray(cols[1], dtype=np.int64),
            job_block_pushes=np.asarray(cols[2], dtype=np.int64),
            gq_occupancy=np.asarray(cols[3], dtype=np.int64),
            dirty_blocks=np.asarray(cols[4], dtype=np.int64),
            tile_pair_loads=np.asarray(cols[5], dtype=np.int64),
            halo_bytes=np.asarray(cols[6], dtype=np.float64),
            unconverged=np.asarray(cols[7], dtype=np.int64).reshape(k, g),
            max_residual=np.asarray(cols[8], dtype=np.float32).reshape(k, g))


# ---------------------------------------------------------------------------
# the device-path buffer (rides the device driver's chunk carry)
# ---------------------------------------------------------------------------


def device_buffers(capacity: int, n_groups: int, device) -> torch.Tensor:
    """One preallocated [capacity, 7 + 2G] float64 tensor on `device`, a
    row per superstep: the SERIES_FIELDS columns, then unconverged [G],
    then max_residual [G].  float64 holds the counts and the float32
    residuals exactly, so one row write serves every field."""
    return torch.zeros((capacity, len(SERIES_FIELDS) + 2 * n_groups),
                       dtype=torch.float64, device=device)


def device_write(buf: torch.Tensor, idx: torch.Tensor, live: torch.Tensor,
                 active_jobs, tile_loads, job_block_pushes, gq_occupancy,
                 dirty_blocks, unconverged, max_residual, tile_pair_loads,
                 halo_bytes=None) -> torch.Tensor:
    """Write one superstep's row into `buf` in place, at `idx` (a [1]
    int64 device tensor, pre-clamped to capacity - 1 by the caller).

    The counts are 0-dim integer device tensors, `unconverged` and
    `max_residual` [G] device tensors; `halo_bytes=None` writes 0.
    Where the 0-dim bool `live` is False (a gated superstep) the row keeps
    what it held: `torch.where(live, new, old)` is written, so a
    truncated series' last row stays the last executed superstep's.
    Nothing here reads the device from the host; the buffer keeps its
    address.  Returns `buf`."""
    counts = torch.stack([active_jobs, tile_loads, job_block_pushes,
                          gq_occupancy, dirty_blocks, tile_pair_loads]
                         ).to(torch.float64)
    halo = (torch.zeros(1, dtype=torch.float64, device=buf.device)
            if halo_bytes is None else halo_bytes.reshape(1))
    # cat promotes the float32 columns to float64, exactly
    new = torch.cat([counts, halo, unconverged, max_residual])
    old = buf.index_select(0, idx)
    buf.index_copy_(0, idx, torch.where(live, new, old))
    return buf


def device_rows(buf: torch.Tensor, supersteps: int) -> torch.Tensor:
    """The executed supersteps' rows of `buf`, [min(supersteps,
    capacity), 7 + 2G] float64 on the device.  No host read."""
    return buf[:min(int(supersteps), int(buf.shape[0]))]


def series_from_rows(rows: np.ndarray, supersteps: int, capacity: int,
                     view_keys: Sequence[tuple]) -> TelemetrySeries:
    """The series from `device_rows`' values, read to the host."""
    n = len(SERIES_FIELDS)
    g = (rows.shape[1] - n) // 2
    a, t, p, o, d, pl, h = (rows[:, i] for i in range(n))
    return TelemetrySeries(
        view_keys=tuple(view_keys),
        active_jobs=a.astype(np.int64), tile_loads=t.astype(np.int64),
        job_block_pushes=p.astype(np.int64),
        gq_occupancy=o.astype(np.int64), dirty_blocks=d.astype(np.int64),
        tile_pair_loads=pl.astype(np.int64), halo_bytes=h,
        unconverged=rows[:, n:n + g].astype(np.int64),
        max_residual=rows[:, n + g:].astype(np.float32),
        truncated=int(supersteps) > int(capacity))


def series_from_device(buf: torch.Tensor, supersteps: int,
                       view_keys: Sequence[tuple]) -> TelemetrySeries:
    """The executed supersteps' rows, read to the host in one copy."""
    rows = device_rows(buf, supersteps).cpu().numpy()
    return series_from_rows(rows, supersteps, int(buf.shape[0]), view_keys)
