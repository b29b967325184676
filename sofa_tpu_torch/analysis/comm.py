"""Communication passes: data movement by kind and the card-to-card link
traffic, and the host network.

The port's counterpart of the JAX package's ``analysis/comm.py``.

The device half (``load_topology``, ``_wire_bytes``, ``comm_profile``,
``link_traffic_matrix``, ``comm_scatter``) reads ``gputrace``: NCCL
kernels carry copyKind 20-25 or P2P 10 with their payload and process
group (``ingest/kineto.py``), memcpys and memsets the copy kinds.  Where
the JAX package reads its synchronous op line (category 0) the port reads
the kernels, and its asynchronous DMA line (category 2) the copy engines'
memcpys and memsets: ingest writes the same categories.  The TPU's
inter-chip links (ICI) are the cards' links here (NVLink, PCIe), under
one name map, which the parity tests apply:

  ====================  ======================
  JAX package           port
  ====================  ======================
  ``tputrace``          ``gputrace``
  ``tpu_topo.json``     ``gpu_topo.json`` (the ranks' merged records)
  ``comm_*_ici_bytes``  ``comm_*_link_bytes``
  ``comm_ici_bytes``    ``comm_link_bytes``
  ``comm_ici_bandwidth``  ``comm_link_bandwidth``
  ``ici_est_bytes``     ``link_est_bytes``
  ``ici_matrix.csv``    ``link_matrix.csv``
  ``ici_bytes`` column  ``link_bytes`` (and ``link_bandwidth``)
  ``cls=ici``           ``cls=link``
  peers ``tpu<N>``      peers ``gpu<N>`` (N the global rank)
  ====================  ======================

A device's id is its rank's global index, so the devices order by id where
the JAX package snakes over torus coordinates (a card has none).  One
deliberate difference: an NCCL P2P kernel (a ring's send/recv hop,
category 0, copyKind P2P) always counts as moved data, where the JAX
package takes P2P ops of its synchronous line only when the trace has no
asynchronous copy (which a run with any memcpy always has): the ring
attention's hops would otherwise vanish from comm.csv.  They are not
collectives, so ``comm_time`` and the link matrix leave them out, as the
JAX package's do; ``comm_ratio``'s denominator is every kernel's time.

The host-network half (``netbandwidth_profile``, ``net_profile``,
``dcn_step_correlation``, ``_busy_bins``): device activity is the CUDA
kernels (``gputrace`` rows of copyKind KERNEL) where the JAX package reads
its device ops (``tputrace`` category 0).  The feature names stay the JAX
package's (``net_*``, ``dcn_top_peer``, ``dcn_top_peer_corr``): they name
the host network (DCN, the data-centre network), not the device.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import pandas as pd

from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.analysis.registry import analysis_pass
from sofa_tpu_torch.printing import print_title
from sofa_tpu_torch.trace import CK_NAMES, CopyKind

#: the kinds whose payload crosses a card-to-card link as it is
_PAIRWISE = (int(CopyKind.COLLECTIVE_PERMUTE),
             int(CopyKind.COLLECTIVE_BROADCAST), int(CopyKind.P2P))


def load_topology(cfg) -> Optional[dict]:
    """The topology (``gpu_topo.json``: the ranks' merged records, or one
    process's cards), or None.  Each device's ``id`` is its trace
    deviceId: the rank where ranks merged, else the CUDA ordinal."""
    try:
        with open(cfg.path("gpu_topo.json")) as f:
            topo = json.load(f)
    except (OSError, ValueError):
        return None
    for d in topo.get("devices", []):
        d.setdefault("id", d.get("index"))
    return topo


def _copy_mask(df: pd.DataFrame) -> pd.Series:
    """The copy engines' memcpys and memsets (category 2), and the NCCL
    P2P kernels (category 0), which count beside them."""
    ck, cat = df["copyKind"], df["category"]
    return (((cat == 2) & (ck > 0) & (ck < 20))
            | ((cat == 0) & (ck == int(CopyKind.P2P))))


def _group_size(groups_json: str) -> int:
    """Size of the first group of a ``groups`` cell (0 when unknown)."""
    if not groups_json:
        return 0
    try:
        parsed = json.loads(groups_json)
    except ValueError:
        return 0
    return len(parsed[0]) if parsed and parsed[0] else 0


def _wire_bytes(sel: pd.DataFrame, kind: int, n_devices: int) -> float:
    """Estimated bytes a collective moves over the links, per device row:
    nccl-tests' bus factors with each op's own group size g
    (``workloads/collectives._bus_factor``):

      all-reduce            2 P (g-1)/g
      all-gather / r-s        P (g-1)/g
      all-to-all              P (g-1)/g
      permute / broadcast     P        (P2P too)

    P is the op's payload; ops with no recorded group count every device
    of the topology."""
    total = 0.0
    for groups_json, payload in sel.groupby("groups")["payload"].sum().items():
        payload = float(payload)
        g = _group_size(groups_json)
        if g < 2:
            g = n_devices
        if kind in _PAIRWISE:
            total += payload
        elif g >= 2:
            factor = (g - 1) / g
            if kind == int(CopyKind.ALL_REDUCE):
                factor *= 2.0
            total += payload * factor
    return total


@analysis_pass(
    name="comm_profile", order=210,
    reads_frames=("gputrace",),
    reads_columns=("timestamp", "duration", "deviceId", "category",
                   "copyKind", "payload", "groups"),
    provides_features=("comm_*_time", "comm_*_bytes", "comm_*_link_bytes",
                       "comm_link_bytes", "comm_link_bandwidth", "comm_time",
                       "comm_ratio", "link_est_bytes"),
    provides_artifacts=("comm.csv", "link_matrix.csv"),
    after=("spotlight",),
)
def comm_profile(frames, cfg, features: Features) -> None:
    """Data movement by kind (``comm.csv``): count, time, bytes and rate of
    the copies (H2D, D2H, D2D, P2P) and the collectives, with each
    collective's and P2P's estimated link bytes; ``comm_ratio``, the
    collectives' share of the kernels' time; and the estimated link
    traffic between the ranks (``link_matrix.csv``)."""
    from sofa_tpu_torch.trace import narrow, roi_clip

    df = frames.get("gputrace")
    if df is None or df.empty:
        return
    df = narrow(df, ["timestamp", "duration", "deviceId", "category",
                     "copyKind", "payload", "groups"])
    # the same window as the device passes, so that comm_ratio's numerator
    # and denominator come from one interval
    df = roi_clip(df, cfg)
    if df.empty:
        return
    # kernels (collectives among them) are category 0, the copy engines'
    # memcpys and memsets category 2; copies among the kernels count only
    # where no copy engine ran
    sync = df[df["category"] == 0]
    coll_rows = sync[sync["copyKind"] >= 20]
    copies = df[_copy_mask(df)]
    if copies.empty:
        copies = sync[(sync["copyKind"] > 0) & (sync["copyKind"] < 20)]
    moved = pd.concat([coll_rows, copies], ignore_index=True)
    if moved.empty:
        features.add("comm_time", 0.0)
        return
    topo = load_topology(cfg)
    n_devices = len((topo or {}).get("devices", []))
    rows = []
    total_link = 0.0
    for kind, sel in moved.groupby("copyKind"):
        kname = CK_NAMES.get(int(kind), str(kind))
        dur = float(sel["duration"].sum())
        payload = float(sel["payload"].sum())
        row = {
            "copyKind": int(kind),
            "kind": kname,
            "count": len(sel),
            "total_time": dur,
            "total_bytes": payload,
            "mean_bandwidth": payload / dur if dur > 0 else 0.0,
        }
        features.add(f"comm_{kname.lower()}_time", dur)
        features.add(f"comm_{kname.lower()}_bytes", payload)
        if int(kind) >= 20 or int(kind) == int(CopyKind.P2P):
            # what crosses the links (the bus factors), beside the payload
            wire = _wire_bytes(sel, int(kind), n_devices)
            row["link_bytes"] = wire
            row["link_bandwidth"] = wire / dur if dur > 0 else 0.0
            features.add(f"comm_{kname.lower()}_link_bytes", wire)
            total_link += wire
        else:
            row["link_bytes"] = 0.0
            row["link_bandwidth"] = 0.0
        rows.append(row)
    if total_link > 0:
        features.add("comm_link_bytes", total_link)
        link_mask = (moved["copyKind"] >= 20) | \
                    (moved["copyKind"] == int(CopyKind.P2P))
        link_dur = float(moved.loc[link_mask, "duration"].sum())
        if link_dur > 0:
            features.add("comm_link_bandwidth", total_link / link_dur)
    summary = pd.DataFrame(rows).sort_values("total_time", ascending=False)
    summary.to_csv(cfg.path("comm.csv"), index=False)

    coll = moved[moved["copyKind"] >= 20]
    comm_time = float(coll["duration"].sum())
    features.add("comm_time", comm_time)
    total = float(df[df["category"] == 0]["duration"].sum())
    features.add("comm_ratio", comm_time / total if total > 0 else 0.0)
    if cfg.verbose and not summary.empty:
        print_title("Data movement by kind")
        print(summary.to_string(index=False))

    matrix = link_traffic_matrix(coll, topo)
    if matrix is not None:
        matrix.to_csv(cfg.path("link_matrix.csv"))
        features.add("link_est_bytes", float(matrix.to_numpy().sum()))


def link_traffic_matrix(coll: pd.DataFrame, topo: Optional[dict]
                        ) -> Optional[pd.DataFrame]:
    """Estimated traffic between the ranks from their collective rows,
    participant-aware (the JAX package's ``ici_traffic_matrix``): each
    rank's row of an op sends to its successor within the op's group (a
    ring over the group, in rank order), by kind (P the payload, g the
    group size):

      all-reduce          2 P (g-1)/g
      all-gather / r-s      P (g-1)/g
      all-to-all            P/g to EACH other member
      permute/broadcast/p2p P to the ring successor

    Ops with no recorded group count every rank of the topology.  None
    without a topology of two ranks or more, or without collectives."""
    if topo is None:
        return None
    devices = topo.get("devices", [])
    n = len(devices)
    if n < 2 or coll is None or coll.empty:
        return None
    ids = sorted(int(d["id"]) for d in devices)
    pos = {d: i for i, d in enumerate(ids)}
    mat = np.zeros((n, n))
    # one booking per distinct (rank, kind, group), not per op instance
    agg = coll.groupby(["deviceId", "copyKind", "groups"])["payload"].sum()
    for (dev, kind, groups_json), payload in agg.items():
        payload = float(payload)
        dev = int(dev)
        if payload <= 0 or dev not in pos:
            continue
        groups: List[List[int]] = []
        if groups_json:
            try:
                groups = json.loads(groups_json)
            except ValueError:
                groups = []
        group = next((g for g in groups if dev in g), None)
        if group is None:
            group = ids
        members = [d for d in ids if d in set(group)]
        g = len(members)
        if g < 2:
            continue
        i = pos[dev]
        kind = int(kind)
        if kind == int(CopyKind.ALL_TO_ALL):
            for m in members:
                if m != dev:
                    mat[i, pos[m]] += payload / g
            continue
        if kind == int(CopyKind.ALL_REDUCE):
            sent = 2.0 * payload * (g - 1) / g
        elif kind in (int(CopyKind.ALL_GATHER),
                      int(CopyKind.REDUCE_SCATTER)):
            sent = payload * (g - 1) / g
        else:
            sent = payload
        succ = members[(members.index(dev) + 1) % g]
        mat[i, pos[succ]] += sent
    labels = [f"gpu{d}" for d in ids]
    return pd.DataFrame(mat, index=labels, columns=labels)


@analysis_pass(
    name="comm_scatter", order=220,
    reads_frames=("gputrace", "nettrace"),
    reads_columns=("timestamp", "duration", "deviceId", "category",
                   "copyKind", "payload", "pkt_src", "pkt_dst"),
    provides_artifacts=("commtrace.csv",),
    after=("spotlight",),
)
def comm_scatter(frames, cfg, features: Features) -> None:
    """Time-resolved communication for the board's scatter
    (``commtrace.csv``): the collectives and copies (cls ``link``: peer
    the rank, dst and kind the collective's or copy's kind) and the
    host's packets (cls ``dcn``: peer the source address, dst the
    destination) on one time axis, each class downsampled with the
    straggler-preserving sampler so that the big transfers stay."""
    from sofa_tpu_torch.trace import (downsample, downsample_indices,
                                      read_net_addrs, roi_bounds, roi_clip,
                                      unpack_ip)

    parts = []
    df = frames.get("gputrace")
    if df is not None and not df.empty:
        ck = df["copyKind"].to_numpy()
        cat = df["category"].to_numpy()
        coll_m = (cat == 0) & (ck >= 20)
        async_m = _copy_mask(df).to_numpy()
        if not async_m.any():
            async_m = (cat == 0) & (ck > 0) & (ck < 20)
        mask = coll_m | async_m
        bounds = roi_bounds(cfg)
        if bounds is not None:
            begin, end = bounds
            starts = df["timestamp"].to_numpy(dtype=float)
            ends = starts + df["duration"].to_numpy(dtype=float)
            mask &= (starts <= end) & (ends >= begin)
        sel = np.flatnonzero(mask)
        if sel.size:
            pay = pd.to_numeric(df["payload"].iloc[sel],
                                errors="coerce").fillna(0.0).to_numpy()
            sel = sel[downsample_indices(sel.size, cfg.viz_downsample_to,
                                         pay)]
            link = df[["timestamp", "duration", "payload", "deviceId",
                       "copyKind"]].iloc[sel]
            kinds = link["copyKind"].map(
                lambda k: CK_NAMES.get(int(k), str(int(k))))
            parts.append(pd.DataFrame({
                "timestamp": link["timestamp"],
                "duration": link["duration"],
                "payload": link["payload"],
                "peer": "gpu" + link["deviceId"].astype(int).astype(str),
                "dst": kinds,
                "kind": kinds,
                "cls": "link",
            }))
    net = frames.get("nettrace")
    if net is not None and not net.empty:
        net = roi_clip(net, cfg)
    if net is not None and not net.empty:
        net = downsample(
            net[["timestamp", "duration", "payload", "pkt_src", "pkt_dst"]],
            cfg.viz_downsample_to, rank_col="payload")
        addrs = read_net_addrs(cfg.path("net_addrs.csv"))
        parts.append(pd.DataFrame({
            "timestamp": net["timestamp"],
            "duration": net["duration"],
            "payload": net["payload"],
            "peer": net["pkt_src"].map(lambda v: unpack_ip(v, addrs)),
            "dst": net["pkt_dst"].map(lambda v: unpack_ip(v, addrs)),
            "kind": "packet",
            "cls": "dcn",
        }))
    if not parts:
        return
    merged = pd.concat(parts, ignore_index=True).sort_values("timestamp")
    merged.to_csv(cfg.path("commtrace.csv"), index=False)


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


@analysis_pass(
    name="net_profile", order=100,
    reads_frames=("nettrace", "gputrace"),
    reads_columns=("timestamp", "duration", "copyKind", "payload",
                   "pkt_src", "pkt_dst"),
    provides_features=("net_packets", "net_total_bytes", "net_total_time",
                       "dcn_top_peer_corr", "dcn_top_peer"),
    provides_artifacts=("netrank.csv",),
)
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


@analysis_pass(
    name="netbandwidth_profile", order=90,
    reads_frames=("netbandwidth",),
    reads_columns=("name", "event", "payload"),
    provides_features=("net_*_q1", "net_*_median", "net_*_q3",
                       "net_*_total_bytes"),
)
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
