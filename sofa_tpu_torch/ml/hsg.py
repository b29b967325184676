"""HSG: swarms of host samples (the JAX package's ``sofa_tpu/ml/hsg.py``).

The samples are perf's (``cputrace``, ``event`` = log10 of the sampled
instruction pointer) when perf ran, else the host trace's events
(``hosttrace``: the aten ops, ``record_function`` ranges and CUDA runtime
calls Kineto recorded).  They are split into at most ``--num_swarms``
clusters on that one scalar, at its largest gaps, which is the partition
single linkage gives; each swarm is captioned by its most common name.
``auto_caption.csv`` (every sample with its ``cluster_ID``) is what
``diff`` compares between two runs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import pandas as pd

from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.printing import print_progress, print_title, print_warning


def pick_samples(frames) -> Tuple[Optional[pd.DataFrame], str]:
    cputrace = frames.get("cputrace")
    if cputrace is not None and not cputrace.empty:
        return cputrace, "cputrace"
    hosttrace = frames.get("hosttrace")
    if hosttrace is not None and not hosttrace.empty:
        return hosttrace, "hosttrace"
    return None, ""


def hsg_cluster(df: pd.DataFrame, num_swarms: int,
                max_samples: int = 200_000) -> pd.DataFrame:
    """``df`` with a ``cluster_ID`` column: the sorted ``event`` values
    split at their ``num_swarms - 1`` largest gaps, in O(n log n)."""
    if len(df) > max_samples:
        df = df.iloc[:: int(np.ceil(len(df) / max_samples))]
    df = df.reset_index(drop=True)
    k = min(num_swarms, len(df))
    if k < 2:
        return df.assign(cluster_ID=0)
    values = df["event"].to_numpy(dtype=float)
    order = np.argsort(values)
    sorted_vals = values[order]
    gaps = np.diff(sorted_vals)
    if len(gaps) == 0 or not np.any(gaps > 0):
        return df.assign(cluster_ID=0)
    k = min(k, int(np.count_nonzero(gaps > 0)) + 1)
    cut_positions = np.sort(np.argsort(gaps)[-(k - 1):])
    boundaries = sorted_vals[cut_positions]  # last value of each lower swarm
    # side="left": a value equal to a boundary belongs to the lower swarm
    labels = np.searchsorted(boundaries, values, side="left")
    return df.assign(cluster_ID=labels)


def sofa_hsg(frames, cfg, features: Features) -> Optional[pd.DataFrame]:
    """Cluster the host samples; writes auto_caption.csv,
    swarms_report.csv and swarms_report.txt, and ``hsg_swarms``."""
    from sofa_tpu_torch.trace import atomic_write

    df, source = pick_samples(frames)
    if df is None:
        print_warning("hsg: no cputrace or hosttrace samples to cluster")
        return None
    clustered = hsg_cluster(df, cfg.num_swarms)
    report_rows = []
    for cid, rows in clustered.groupby("cluster_ID"):
        names = rows["name"].astype(str)
        caption = names.mode().iloc[0] if not names.empty else ""
        report_rows.append({
            "cluster_ID": int(cid), "caption": caption,
            "samples": len(rows),
            "total_duration": float(rows["duration"].sum()),
            "function_names": "|".join(names.unique()[:50]),
        })
    report = pd.DataFrame(report_rows).sort_values(
        "total_duration", ascending=False).reset_index(drop=True)
    clustered.to_csv(cfg.path("auto_caption.csv"), index=False)
    report.to_csv(cfg.path("swarms_report.csv"), index=False)
    with atomic_write(cfg.path("swarms_report.txt")) as f:
        f.write(report.drop(columns=["function_names"]).to_string(
            index=False) + "\n")
    features.add("hsg_swarms", len(report))
    print_progress(f"hsg: {len(report)} swarms over {len(clustered)} "
                   f"{source} samples")
    if cfg.verbose:
        print_title("Function Swarm Report")
        print(report.drop(columns=["function_names"]).head(20).to_string(
            index=False))
    return clustered


def swarm_series(clustered: Optional[pd.DataFrame], max_swarms: int = 10):
    """One timeline series per swarm, the longest first."""
    if clustered is None or clustered.empty or "cluster_ID" not in clustered:
        return []
    from sofa_tpu_torch.trace import SofaSeries

    palette = [
        "tomato", "gold", "mediumseagreen", "deepskyblue", "orchid",
        "darkkhaki", "salmon", "turquoise", "plum", "lightslategray",
    ]
    out = []
    top = (clustered.groupby("cluster_ID")["duration"].sum()
           .sort_values(ascending=False).head(max_swarms))
    for i, cid in enumerate(top.index):
        rows = clustered[clustered["cluster_ID"] == cid]
        caption = rows["name"].astype(str).mode()
        title = (f"swarm {cid}: "
                 f"{caption.iloc[0][:40] if not caption.empty else ''}")
        out.append(SofaSeries(f"swarm_{cid}", title,
                              palette[i % len(palette)],
                              rows.drop(columns=["cluster_ID"])))
    return out
