"""repro_torch.stream — evolving graphs: live edge updates under
concurrent jobs.

A running GraphSession absorbs edge insert/delete/reweight batches at any
superstep (`GraphSession.apply_updates`) with incremental recomputation
instead of restart: a CSR delta overlay staged alongside the base tiles
(graph.structure.TileOverlay), exact delta-invariant correction for
plus-times jobs, support-test re-seeding for min-plus jobs, and dirty
blocks injected as priorities into the two-level scheduler on both
backends.  The port of `repro.stream`, with the same public names.
"""

from repro_torch.stream.updates import (INSERT, DELETE, UpdateBatch,
                                        apply_to_csr)
from repro_torch.stream.apply import (DIRTY_BOOST, StreamStats,
                                      apply_updates_to_session,
                                      compact_group)
from repro_torch.stream.invalidate import (adjust_plus_times,
                                           full_reseed_plus_times,
                                           reactivate_sources,
                                           reseed_min_plus)

__all__ = [
    "INSERT", "DELETE", "UpdateBatch", "apply_to_csr",
    "DIRTY_BOOST", "StreamStats", "apply_updates_to_session",
    "compact_group",
    "adjust_plus_times", "full_reseed_plus_times", "reactivate_sources",
    "reseed_min_plus",
]
