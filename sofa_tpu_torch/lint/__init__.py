"""sofa-lint over the PyTorch port: static analysis of the package's own
contracts (the JAX package's ``sofa_tpu/lint``, pointed at this package's
layout and registries).

The port keeps the runtime invariants its counterpart established: every
pipeline pool sized by --jobs, every subprocess bounded by a deadline,
every broad except routed through printing/telemetry, every derived write
atomic, every pass declaring its contract, every thread stoppable, and the
fleet protocol closed over one vocabulary.  Nothing in pytest stops the
next patch from silently violating them; these rules do, without ever
importing the code they check.

Layout:

  core.py             single-pass AST engine: per-file visitor dispatch,
                      import alias resolution, ``# sofa-lint:
                      disable=RULE`` suppressions, the project context
                      (trace schema, pass declarations, index families)
  rules.py            SL001..SL009, and ALL_RULES
  pass_rules.py       SL010..SL013 over ``@analysis_pass``/``@fleet_pass``
  artifact_rules.py   SL014..SL018 over record.py's lifecycle registry
  concurrency_rules.py SL019..SL023: guards, lock order, commit ordering,
                      thread contexts, stop paths
  protocol_rules.py   SL024..SL028 over archive/protocol.py's vocabulary
  baseline.py         the fingerprint ratchet
                      (``sofa_tpu_torch/lint_baseline.json``: shrinks,
                      never grows)
  cli.py              exit-code contract (0 clean / 1 new findings / 2
                      internal error), --json, --update-baseline; backs
                      ``python -m sofa_tpu_torch lint`` and
                      ``python -m sofa_tpu_torch.tools.sofa_lint``

sofa_tpu_torch/docs/STATIC_ANALYSIS.md is the rule catalog.
"""

from sofa_tpu_torch.lint.core import (  # noqa: F401
    Finding,
    LintEngine,
    ProjectContext,
    lint_paths,
)
from sofa_tpu_torch.lint.baseline import Baseline  # noqa: F401
from sofa_tpu_torch.lint.cli import run_lint  # noqa: F401
