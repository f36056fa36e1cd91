from repro_torch.graph.structure import (CSRGraph, BlockedGraph, BlockPairs,
                                         TileOverlay, build_blocked,
                                         build_block_pairs, build_view,
                                         chunk_table,
                                         empty_overlay, run_starts)
from repro_torch.graph.generators import (rmat_graph, uniform_graph,
                                          chain_graph, grid_graph,
                                          mutation_stream)

__all__ = [
    "CSRGraph",
    "BlockedGraph",
    "BlockPairs",
    "TileOverlay",
    "build_blocked",
    "build_block_pairs",
    "build_view",
    "empty_overlay",
    "run_starts",
    "chunk_table",
    "rmat_graph",
    "uniform_graph",
    "chain_graph",
    "grid_graph",
    "mutation_stream",
]
