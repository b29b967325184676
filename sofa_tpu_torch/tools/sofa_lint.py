"""sofa-lint entry point — the AST invariant checker over this package.

    python -m sofa_tpu_torch.tools.sofa_lint [paths] [--json]
        [--no-baseline] [--update-baseline] [--rule SLxxx] [--explain SLxxx]
        [--jobs N]

Exit codes: 0 clean, 1 new findings, 2 internal error.  The same as
``python -m sofa_tpu_torch lint``; sofa_tpu_torch/docs/STATIC_ANALYSIS.md
is the rule catalog, sofa_tpu_torch/lint_baseline.json the baseline.
"""

import sys

from sofa_tpu_torch.lint.cli import run_lint

if __name__ == "__main__":
    sys.exit(run_lint())
