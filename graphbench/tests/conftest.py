"""Fixtures of the benchmark's own tests (run with
`python -m pytest graphbench/tests` from the repository's root; the
repository's test run collects `tests/` only)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: a cell cut to a size the CPU runs in seconds: 1,024 vertices, Vb 32,
#: 4 job slots a view, 8 clients over the three views, a poll every 4
#: supersteps
TINY_CONFIG = dict(scale=10, edgefactor=8, block_size=32, capacity=4)
TINY_CLIENTS = [{"family": "pagerank", "count": 1},
                {"family": "ppr", "count": 3},
                {"family": "sssp", "count": 2},
                {"family": "bfs", "count": 2}]


def tiny(cell):
    cell.config.update(TINY_CONFIG)
    cell.mix["clients"] = [dict(c) for c in TINY_CLIENTS]
    cell.mix["poll_supersteps"] = 4
    return cell


@pytest.fixture
def tiny_cell():
    """tiny_cell(workload) -> that cell of BENCHMARK.json, cut to size."""
    from graphbench.harness import load_cell
    return lambda workload: tiny(load_cell(ROOT, workload))


@pytest.fixture
def card():
    """Skips a test of the card when there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
