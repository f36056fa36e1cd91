#!/usr/bin/env python3
"""The port's benchmark: one run of one cell on the card.

    python3 graphbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout.  The cell (a configuration under
`graphbench/configs/` and a traffic mix under `graphbench/mixes/`) is
found by name in `BENCHMARK.json`.  With --trace 0 the last line of
standard output is the result with the cell's end-to-end metrics; with
--trace 1 with its per-layer metrics, read from a torch.profiler trace of
a stretch of the window and from the benchmark's own spans.  The numbers
compared with the reference are the last lines of standard error, and
the last key of the result.  Without a CUDA card the run exits non-zero
and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record", type=Path, default=None,
                    help="also write what the per-layer readers read "
                         "(JSON) to this file")
    args = ap.parse_args()

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from graphbench.harness import load_cell, run_cell
    cell = load_cell(ROOT, args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   t_start=T_START)
    if args.record is not None:
        args.record.parent.mkdir(parents=True, exist_ok=True)
        args.record.write_text(json.dumps(out["record"]))
    for line in out["lines"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    # one process, one host thread for the libraries' pools: the window
    # is paced by the host, and idle pool threads only add jitter
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
