"""``export --folded``: collapsed stacks for flame-graph tools (the JAX
package's ``sofa_tpu/export_folded.py``).

Brendan Gregg's format, ``frame;frame;leaf count`` a line, which
speedscope.app, flamegraph.pl and inferno read:

  pystacks.folded  the Python sampler's whole stacks (``pystacks``'
                   ``module`` column), root first
  cputrace.folded  perf's samples: the leaf and up to three callers
                   ("leaf<-c1<-c2 @ dso"), written caller first
  memprof.folded   bytes held per allocation stack at the peak snapshot
                   (``ingest/memprof.py``): a memory flame graph, width in
                   bytes; a cluster export roots each host's stacks at the
                   host's name
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, List, Optional

import pandas as pd

from sofa_tpu_torch.printing import print_progress, print_warning

FOLDED_FRAMES = ["pystacks", "cputrace"]


def _fold_pystacks(df: pd.DataFrame) -> Counter:
    return Counter(s for s in df["module"] if s)


def _fold_cputrace(df: pd.DataFrame) -> Counter:
    counts: Counter = Counter()
    for name in df["name"]:
        if not name:
            continue
        # the dso annotates the leaf: split it off before the callers
        name, _, dso = str(name).partition(" @ ")
        frames = name.split("<-")
        if dso:
            frames[0] = f"{frames[0]} [{dso}]"
        counts[";".join(reversed(frames))] += 1
    return counts


def _fold_memprof(cfg) -> Counter:
    """Bytes held per allocation stack, root first (pprof stacks are leaf
    first); over every host's snapshot for a cluster export."""
    from sofa_tpu_torch.ingest.memprof import load_memprof

    sources = [(cfg.logdir, "")]
    if getattr(cfg, "cluster_hosts", None):
        from sofa_tpu_torch.analyze import cluster_host_cfgs

        sources = [(host_cfg.logdir, hostname + ";")
                   for _i, hostname, host_cfg in cluster_host_cfgs(cfg)]
    counts: Counter = Counter()
    for logdir, prefix in sources:
        try:
            df, _meta = load_memprof(logdir)
        except Exception as e:  # noqa: BLE001 - one host's snapshot, not all
            print_warning(f"folded export: unreadable memprof snapshot in "
                          f"{logdir}: {e}")
            continue
        if df is None:
            continue
        held = df[(df["kind"] == "buffer") & (df["bytes"] > 0)]
        for stack, nbytes in zip(held["stack"], held["bytes"]):
            frames = [f for f in str(stack).split(";") if f]
            if frames:
                counts[prefix + ";".join(reversed(frames))] += int(nbytes)
    return counts


def _write(counts: Counter, path: str) -> bool:
    if not counts:
        return False
    from sofa_tpu_torch.trace import atomic_write

    with atomic_write(path) as f:
        for stack, n in counts.most_common():
            f.write(f"{stack} {n}\n")
    return True


def export_folded(cfg, frames: Optional[Dict[str, pd.DataFrame]] = None
                  ) -> List[str]:
    """Write the ``*.folded`` files into the logdir; returns their
    paths (none, with a warning, when nothing was sampled)."""
    if frames is None:
        from sofa_tpu_torch.preprocess import load_frames

        frames = load_frames(cfg, only=FOLDED_FRAMES)
    os.makedirs(cfg.logdir, exist_ok=True)
    written: List[str] = []
    for name, fold in (("pystacks", _fold_pystacks),
                       ("cputrace", _fold_cputrace)):
        df = frames.get(name)
        if df is None or df.empty:
            continue
        path = cfg.path(f"{name}.folded")
        if _write(fold(df), path):
            written.append(path)
    mem_path = cfg.path("memprof.folded")
    if _write(_fold_memprof(cfg), mem_path):
        written.append(mem_path)
    if written:
        print_progress("folded stacks -> " + ", ".join(written)
                       + "  (open in speedscope.app / flamegraph.pl)")
    else:
        print_warning("folded export: no sampled stacks in this capture "
                      "(--enable_py_stacks / perf)")
    return written
