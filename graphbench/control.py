#!/usr/bin/env python3
"""The control of the comparison that decides `correct`: the reference
computed in bfloat16 (`reference.solve(..., bf16=True)`), put in the
program's place, must come out not correct.

    python3 graphbench/control.py --workload <cell> --seeds 11 12 13 \
        --seconds 15

runs, for each seed, a window of the cell at its own size and load on
the card (as `run.py` does, in one process), and prints one JSON line:
the numbers compared for the program's answers, and for the same answers
(every PageRank, the seeded sample with each family's longest job) with
the control's put in their place, both judged by `harness.check`.  The
benchmark's runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, seconds: float, **kwargs) -> dict:
    """The program's and the control's numbers for one seed, with the
    limits a run holds them to."""
    from graphbench.harness import run_cell
    out = run_cell(cell, seed, seconds, False, control=True, **kwargs)
    return {"program": out["result"]["checks"],
            "program_correct": out["result"]["correct"],
            "control": {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in out["control"]["checks"].items()},
            "control_correct": out["control"]["correct"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from graphbench.harness import load_cell
    cell = load_cell(ROOT, args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(cell, seed, args.seconds, t_start=t)
        r.update(workload=args.workload, seed=seed,
                 seconds=time.perf_counter() - t)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
