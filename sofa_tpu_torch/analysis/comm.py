"""Host-network passes: the NIC byte counters, the packet profile and how
the network traffic follows the device's activity.

The port's counterpart of the JAX package's ``analysis/comm.py``, its
host-network half for now (``netbandwidth_profile``, ``net_profile``,
``dcn_step_correlation``, ``_busy_bins``; ``comm_profile`` and
``comm_scatter`` come with multi-GPU).  Device activity is the CUDA
kernels (``gputrace`` rows of copyKind KERNEL) where the JAX package reads
its device ops (``tputrace`` category 0).  The feature names stay the JAX
package's (``net_*``, ``dcn_top_peer``, ``dcn_top_peer_corr``): they name
the host network (DCN, the data-centre network), not the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd

from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.trace import CopyKind


def _kernels(frames) -> Optional[pd.DataFrame]:
    """The device's busy rows: CUDA kernels of gputrace, or None."""
    dev = frames.get("gputrace")
    if dev is None or dev.empty:
        return None
    return dev[dev["copyKind"] == int(CopyKind.KERNEL)]


def dcn_step_correlation(frames, n_bins: int = 64) -> Optional[float]:
    """Pearson correlation between the host network's tx bandwidth and the
    device's busy time over a common grid of ``n_bins`` bins ("is the
    network gating the steps?"), per host, for ``cluster_analyze``'s
    summary.  None when either signal is absent or constant."""
    net = frames.get("netbandwidth")
    ops = _kernels(frames)
    if net is None or net.empty or ops is None:
        return None
    tx = net[net["name"].str.endswith(".tx")]
    if tx.empty or ops.empty:
        return None
    t0 = float(min(tx["timestamp"].min(), ops["timestamp"].min()))
    t1 = float(max(tx["timestamp"].max(),
                   (ops["timestamp"] + ops["duration"]).max()))
    if t1 <= t0:
        return None
    edges = np.linspace(t0, t1, n_bins + 1)
    # per-bin mean tx bandwidth
    tx_bins = np.zeros(n_bins)
    idx = np.clip(np.searchsorted(edges, tx["timestamp"].to_numpy()) - 1,
                  0, n_bins - 1)
    counts = np.zeros(n_bins)
    np.add.at(tx_bins, idx, tx["event"].to_numpy(dtype=float))
    np.add.at(counts, idx, 1)
    tx_bins = np.divide(tx_bins, np.maximum(counts, 1))
    busy = _busy_bins(ops, edges)
    if tx_bins.std() == 0 or busy.std() == 0:
        return None
    return float(np.corrcoef(tx_bins, busy)[0, 1])


def _busy_bins(ops: pd.DataFrame, edges: np.ndarray) -> np.ndarray:
    """Per-bin device busy time (durations clipped into each bin), in
    O(ops + bins): the first and last bin of a row take the partial
    overlaps, the bins between them their full width through a difference
    array."""
    n_bins = len(edges) - 1
    starts = ops["timestamp"].to_numpy(dtype=float)
    ends = np.maximum(starts + ops["duration"].to_numpy(dtype=float), starts)
    width = edges[1] - edges[0]
    i0 = np.clip(np.searchsorted(edges, starts, "right") - 1, 0, n_bins - 1)
    i1 = np.clip(np.searchsorted(edges, ends, "left") - 1, 0, n_bins - 1)
    busy = np.zeros(n_bins)
    same = i0 == i1
    np.add.at(busy, i0[same], (ends - starts)[same])
    sp = ~same
    np.add.at(busy, i0[sp], (edges[i0[sp] + 1] - starts[sp]))
    np.add.at(busy, i1[sp], (ends[sp] - edges[i1[sp]]))
    # the full bins i0+1 .. i1-1 through a prefix-summed difference array
    diff = np.zeros(n_bins + 1)
    np.add.at(diff, i0[sp] + 1, width)
    np.add.at(diff, i1[sp], -width)
    busy += np.cumsum(diff[:-1])
    return busy


def net_profile(frames, cfg, features: Features) -> None:
    """The packet profile: packets, bytes and time, and ``netrank.csv``,
    the (src, dst) flows by bytes with, for the top 8, how their bytes
    follow the device's busy time (``corr_step``); the best of them is
    ``dcn_top_peer``."""
    df = frames.get("nettrace")
    if df is None or df.empty:
        return
    from sofa_tpu_torch.trace import read_net_addrs, unpack_ip

    # id -> literal of interned (IPv6) addresses; empty when all are v4
    addrs = read_net_addrs(cfg.path("net_addrs.csv"))

    features.add("net_packets", len(df))
    features.add("net_total_bytes", float(df["payload"].sum()))
    features.add("net_total_time", float(df["duration"].sum()))
    pairs = (
        df.groupby(["pkt_src", "pkt_dst"])["payload"]
        .agg(["sum", "count"])
        .sort_values("sum", ascending=False)
        .reset_index()
    )
    pairs["src"] = pairs["pkt_src"].map(lambda v: unpack_ip(v, addrs))
    pairs["dst"] = pairs["pkt_dst"].map(lambda v: unpack_ip(v, addrs))
    out_cols = ["src", "dst", "sum", "count"]
    ops = _kernels(frames)
    if ops is not None and not ops.empty and len(df) >= 8:
        n_bins = 64
        t0 = float(min(df["timestamp"].min(), ops["timestamp"].min()))
        t1 = float(max(df["timestamp"].max(),
                       (ops["timestamp"] + ops["duration"]).max()))
        if t1 > t0:
            edges = np.linspace(t0, t1, n_bins + 1)
            busy = _busy_bins(ops, edges)
            if busy.std() > 0:
                corrs = []
                top = pairs.head(8)
                pkt_idx = np.clip(
                    np.searchsorted(edges, df["timestamp"].to_numpy()) - 1,
                    0, n_bins - 1)
                payload = df["payload"].to_numpy(dtype=float)
                # one partition of the rows for all peers, not a scan each
                pair_rows = df.groupby(["pkt_src", "pkt_dst"]).indices
                for r in top.itertuples(index=False):
                    sel = pair_rows.get((r.pkt_src, r.pkt_dst), [])
                    bins = np.zeros(n_bins)
                    np.add.at(bins, pkt_idx[sel], payload[sel])
                    corrs.append(
                        round(float(np.corrcoef(bins, busy)[0, 1]), 4)
                        if bins.std() > 0 else None)
                pairs["corr_step"] = pd.Series(
                    corrs + [None] * (len(pairs) - len(corrs)))
                out_cols.append("corr_step")
                ranked = [c for c in corrs if c is not None]
                if ranked:
                    best = int(np.nanargmax(np.array(
                        [c if c is not None else -2 for c in corrs])))
                    features.add("dcn_top_peer_corr", corrs[best])
                    features.add_info(
                        "dcn_top_peer",
                        f"{top.iloc[best]['src']}->{top.iloc[best]['dst']}")
    pairs[out_cols].to_csv(cfg.path("netrank.csv"), index=False)


def netbandwidth_profile(frames, cfg, features: Features) -> None:
    """The NIC byte counters: quartiles of the tx and rx rates and the
    bytes each direction moved."""
    df = frames.get("netbandwidth")
    if df is None or df.empty:
        return
    for direction in ("tx", "rx"):
        rows = df[df["name"].str.endswith("." + direction)]
        if rows.empty:
            continue
        q = rows["event"].quantile([0.25, 0.5, 0.75])
        features.add(f"net_{direction}_q1", float(q.loc[0.25]))
        features.add(f"net_{direction}_median", float(q.loc[0.5]))
        features.add(f"net_{direction}_q3", float(q.loc[0.75]))
        features.add(f"net_{direction}_total_bytes",
                     float(rows["payload"].sum()))
