"""repro_torch.analysis — torch-aware static lint, runtime sentinels and
contracts on the port's superstep (the reference's `repro.analysis`).

Three layers, one invariant surface:

- :mod:`repro_torch.analysis.lint` / :mod:`repro_torch.analysis.rules` —
  stdlib-``ast`` lint engine with the port's rules (RPT001–RPT007, in
  the reference's order): host reads inside a chunk function, implicit
  host syncs in loops, the selection dtype contract, nondeterminism
  (global and unseeded torch RNG included), per-call compilation and
  cache-key hazards, float64 on the card and set iteration.
- :mod:`repro_torch.analysis.contracts` — runs the real device superstep
  per policy and checks it: one host read per chunk on the inf cadence,
  no float64 op in a chunk, the kernels' shared memory within budget,
  tile bytes against what the chunks could move, matmul FLOPs in the
  push.
- :mod:`repro_torch.analysis.sentinels` — runtime guards: no implicit
  host sync inside a block (`torch.cuda.set_sync_debug_mode("error")` on
  the card, a counting mode on the CPU) and a retrace sentinel pinning a
  session's step cache.

CLI: ``python -m repro_torch.analysis src/repro_torch`` (see ``--help``);
exits non-zero on any unbaselined finding, which is the CI gate.
"""

from repro_torch.analysis.lint import (Finding, LintRule, lint_paths,
                                       lint_source)
from repro_torch.analysis.rules import default_rules
from repro_torch.analysis.sentinels import (HostSyncError, RetraceError,
                                            no_implicit_syncs,
                                            retrace_sentinel)

__all__ = ["Finding", "LintRule", "lint_paths", "lint_source",
           "default_rules", "HostSyncError", "RetraceError",
           "no_implicit_syncs", "retrace_sentinel"]
