"""Windowed concurrency breakdown: what dominates each slice of wall time.

The port's counterpart of the JAX package's ``analysis/concurrency.py``.
Each 1/sys_mon_rate window of the run (or of the region of interest) is
classed by its dominant activity: ``gpu`` (the kernel utilization,
``gpuutil``'s ``kernel_util``, where the JAX package reads ``tpuutil``'s
``tc_util``), ``usr``, ``sys`` or ``iow`` (mpstat's aggregate row), or
``idl`` when even the dominant one is below ``IDLE_THRESHOLD``.
Features: ``elapsed_<class>_ratio`` (``elapsed_gpu_ratio`` where the JAX
package writes ``elapsed_tpu_ratio``), ``breakdown_windows``,
``breakdown_elapsed``, and the Pearson correlation of the GPU's activity
with each host metric and the HBM rate, ``corr_gpu_<metric>``
(``corr_tpu_<metric>`` in the JAX package).  ``performance.csv`` holds
the windows: class and metrics, ``gpu_util`` where the JAX column is
``tpu_util``.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.printing import print_title

CLASSES = ("gpu", "usr", "sys", "iow", "idl")
# A window whose dominant activity is below this share (of 1) is idle: the
# JAX package's default ``is_idle_threshold``.
IDLE_THRESHOLD = 0.01


def _window_series(df, name_filter, t0, t1, window, value_col="event"):
    """The mean of a metric per window, over the edges [t0, t1)."""
    edges = np.arange(t0, t1 + window, window)
    out = np.zeros(len(edges) - 1)
    rows = df[df["name"] == name_filter] if name_filter else df
    # samples outside [t0, t1) are dropped: clamped into the edge windows
    # they would pour all the history before the ROI into window 0
    rows = rows[(rows["timestamp"] >= t0) & (rows["timestamp"] < t1)]
    if rows.empty:
        return edges, out
    idx = np.clip(((rows["timestamp"] - t0) / window).astype(int), 0,
                  len(out) - 1)
    sums = np.zeros(len(out))
    counts = np.zeros(len(out))
    np.add.at(sums, idx, rows[value_col].to_numpy(dtype=float))
    np.add.at(counts, idx, 1)
    mask = counts > 0
    out[mask] = sums[mask] / counts[mask]
    return edges, out


def concurrency_breakdown(frames, cfg, features: Features) -> None:
    mpstat = frames.get("mpstat")
    if mpstat is None or mpstat.empty:
        return
    agg = mpstat[mpstat["deviceId"] == -1]
    if agg.empty:
        return
    window = 1.0 / max(cfg.sys_mon_rate, 1)
    t0 = float(agg["timestamp"].min())
    t1 = float(agg["timestamp"].max())
    if cfg.roi_end > cfg.roi_begin > 0:
        t0, t1 = cfg.roi_begin, cfg.roi_end
    if t1 <= t0:
        return

    edges, usr = _window_series(agg, "usr", t0, t1, window)
    _, sys_ = _window_series(agg, "sys", t0, t1, window)
    _, iow = _window_series(agg, "iow", t0, t1, window)
    gpuutil = frames.get("gpuutil")
    if gpuutil is not None and not gpuutil.empty:
        _, gpu = _window_series(gpuutil, "kernel_util", t0, t1, window)
        _, hbm = _window_series(gpuutil, "hbm_gbps", t0, t1, window)
    else:
        gpu = np.zeros(len(edges) - 1)
        hbm = np.zeros(len(edges) - 1)
    net = frames.get("netbandwidth")
    if net is not None and not net.empty:
        _, tx = _window_series(net[net["name"].str.endswith(".tx")], None,
                               t0, t1, window)
        _, rx = _window_series(net[net["name"].str.endswith(".rx")], None,
                               t0, t1, window)
    else:
        tx = np.zeros(len(edges) - 1)
        rx = np.zeros(len(edges) - 1)

    idle_floor = IDLE_THRESHOLD * 100.0
    classes = []
    for i in range(len(edges) - 1):
        candidates = {"gpu": gpu[i], "usr": usr[i], "sys": sys_[i],
                      "iow": iow[i]}
        dominant = max(candidates, key=candidates.get)
        if candidates[dominant] < idle_floor:
            dominant = "idl"
        classes.append(dominant)

    pd.DataFrame({
        "timestamp": edges[:-1],
        "class": classes,
        "usr": usr,
        "sys": sys_,
        "iow": iow,
        "gpu_util": gpu,
        "hbm_gbps": hbm,
        "net_tx": tx,
        "net_rx": rx,
    }).to_csv(cfg.path("performance.csv"), index=False)

    counts = pd.Series(classes).value_counts()
    for cls in CLASSES:
        ratio = counts.get(cls, 0) / len(classes) if classes else 0.0
        features.add(f"elapsed_{cls}_ratio", ratio)
    features.add("breakdown_windows", len(classes))
    features.add("breakdown_elapsed", t1 - t0)

    if gpu.any():
        for name, arr in (("usr", usr), ("sys", sys_), ("iow", iow),
                          ("net_tx", tx), ("net_rx", rx), ("hbm", hbm)):
            if arr.any() and np.std(arr) > 0 and np.std(gpu) > 0:
                features.add(f"corr_gpu_{name}",
                             float(np.corrcoef(gpu, arr)[0, 1]))
    if cfg.verbose:
        print_title("Concurrency breakdown (dominant class per window)")
        print(counts.to_string())
