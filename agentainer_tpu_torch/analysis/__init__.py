"""Invariant analysis plane of the port.

Reference: ``agentainer_tpu/analysis/`` — own copies, in the port's terms.
Two legs:

1. **AST rules** (:mod:`.rules`): the repo's invariants — exception
   discipline, hot-path host-sync bans, lock-hold discipline, failpoint
   catalog parity, graph capture via the warmed builders, feature-flag
   quads — checked as visitor rules with per-rule IDs (ATP001..ATP006)
   over ``agentainer_tpu_torch/`` and a checked-in ``baseline.json``
   ratchet of the port's own: pre-existing violations are frozen with
   per-site justifications, new ones fail the run.
2. **Runtime contracts** (:mod:`.contracts`): the engine's per-token
   disciplines as assertions over a live engine — a capture budget, step
   buffers written in place, no implicit host sync, kernel launches per
   graph replay — in place of the reference's compiled-HLO contracts.

Run the lint leg: ``python -m agentainer_tpu_torch.analysis`` (add
``--update-baseline`` to re-freeze, then write each new entry's
justification into ``baseline.json``).
"""

from .framework import (  # noqa: F401
    AnalysisError,
    Baseline,
    Rule,
    Violation,
    load_baseline,
    run_rules,
)
from .rules import ALL_RULES  # noqa: F401
