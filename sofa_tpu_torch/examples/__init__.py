"""Small self-contained programs to point ``python -m sofa_tpu_torch stat``
at: the counterparts of the repo's ``examples/`` (see this directory's
README.md).  Each runs as ``python -m sofa_tpu_torch.examples.<name>``, on
the card unless ``--device cpu`` is given."""

from __future__ import annotations

import argparse


def device_arg(argv=None) -> dict:
    """``main``'s keywords from the command line: ``--device`` only (the
    card when absent; a run without a card then raises)."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="cpu to run on the CPU on purpose (default: cuda)")
    return {"device": p.parse_args(argv).device}
