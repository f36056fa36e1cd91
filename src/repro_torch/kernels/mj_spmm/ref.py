"""Plain PyTorch version of the multi-job block SpMM (what the CUDA
kernel computes).  The CPU route runs it; on a CUDA device it serves only
to check the kernel.

The min-plus form walks q in chunks so its [c, K, J, Vb, Vb] temporary
stays bounded (unchunked it would be [q, K, J, Vb, Vb]: 23.7 GB at
q=400, K=903, J=4, Vb=64).  With `tile_index` the tiles are gathered
chunk by chunk as well.
"""

from __future__ import annotations

from typing import Optional

import torch

#: elements of the min-plus [c, K, J, Vb, Vb] temporary (128 MB of f32)
MIN_PLUS_CHUNK_ELEMS = 2**25


def _tiles_of(tiles: torch.Tensor, tile_index: Optional[torch.Tensor],
              c0: int, c1: int) -> torch.Tensor:
    """Rows c0:c1 of the operand tiles; index entries are clamped to
    [0, T), as the reference's gather clamps."""
    if tile_index is None:
        return tiles[c0:c1]
    idx = tile_index[c0:c1].long().clamp(0, tiles.shape[0] - 1)
    return tiles[idx]


def mj_spmm_ref(d_sel: torch.Tensor, tiles: torch.Tensor,
                semiring: str = "plus_times", *,
                tile_index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """d_sel [q, J, Vb], tiles [q, K, Vb, Vb] (or [T, K, Vb, Vb] read at
    tile_index [q]) -> [q, K, J, Vb]."""
    q, j, vb = d_sel.shape
    k = tiles.shape[1]
    if semiring == "plus_times":
        return torch.einsum("qjv,qkvw->qkjw", d_sel,
                            _tiles_of(tiles, tile_index, 0, q))
    if semiring != "min_plus":
        raise ValueError(f"unknown semiring {semiring!r}")
    out = torch.empty((q, k, j, vb), dtype=torch.float32,
                      device=d_sel.device)
    chunk = max(1, MIN_PLUS_CHUNK_ELEMS // max(1, k * j * vb * vb))
    for c0 in range(0, q, chunk):
        c1 = min(q, c0 + chunk)
        t = _tiles_of(tiles, tile_index, c0, c1)
        out[c0:c1] = (d_sel[c0:c1, None, :, :, None]
                      + t[:, :, None, :, :]).amin(3)
    return out
