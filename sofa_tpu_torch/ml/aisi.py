"""AISI: automatic iteration detection and the per-step profile (the JAX
package's ``sofa_tpu/ml/aisi.py`` over the CUDA trace).

Where the iterations come from (``--iterations_from``):

  steps   the ``gpusteps`` frame: one row per ``sofa_step_N`` range (what
          ``workloads.common.step_annotation`` opens) at the device span of
          the work it launched (``ingest/kineto.py``); exact
  marker  the ``sofa_step_N`` ranges in ``hosttrace``, each anchored to
          the device through the ``gpusteps`` row of its step (the launch
          correlation ingest already resolved); without one, the host
          spans, their last end padded to a median period
  op      kernel-name mining: the kernels of the busiest device in launch
          order, interned to symbols; the suffix automaton proposes the
          patterns that repeat about ``--num_iterations`` times, a
          non-overlapping scan verifies them, a fuzzy scan is the fallback
  auto    steps, else marker, else op

The JAX package's fourth source, ``module`` (XLA module launches), has no
counterpart in a CUDA trace: ``config.SofaConfig`` refuses it with a usage
error, and this pass raises for it, never mining kernels in its place.

Each iteration's row adds what its window holds: kernel, copy and
collective time (the collective split and the copy kinds keep the JAX
numbers, ``trace.CopyKind``), flops and bytes, the fw/bw split, and the
host's syscalls, Python samples and runtime time.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np
import pandas as pd

from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.config import ITERATION_SOURCES, MODULE_REFUSAL
from sofa_tpu_torch.ml.suffix import (SuffixAutomaton, find_occurrences,
                                      fuzzy_occurrences)
from sofa_tpu_torch.printing import print_hint, print_progress, print_warning
from sofa_tpu_torch.trace import CopyKind

COMM_BOUND_RATIO = 0.15  # the verdict's threshold, as the JAX package's

_STEP_MARKER_RE = re.compile(r"^sofa_step_(\d+)$")


def _busiest_device(df):
    """The device carrying the most total span time: every boundary and
    sequence source anchors to the same device."""
    return df.groupby("deviceId")["duration"].sum().idxmax()


def _iterations_from_steps(frames) -> Optional[Tuple[List[float],
                                                     List[float]]]:
    """Exact (begins, ends) from ``gpusteps``: each step's device span."""
    steps = frames.get("gpusteps")
    if steps is None or steps.empty:
        return None
    dev = _busiest_device(steps)
    rows = steps[steps["deviceId"] == dev].sort_values("timestamp")
    if len(rows) < 2:
        return None
    begins = rows["timestamp"].astype(float).tolist()
    ends = (rows["timestamp"] + rows["duration"]).astype(float).tolist()
    return begins, ends


def _iterations_from_markers(frames) -> Optional[Tuple[List[float],
                                                       List[float]]]:
    """(begins, ends) from the ``sofa_step_N`` ranges of ``hosttrace``.

    The ranges wrap the host's dispatch of each step; the device runs it
    later.  So the markers give the steps' count and order, and each is
    anchored to its step's device span (``_anchor_to_device``).  Without
    an anchor for every marker the host spans stand, the last end padded
    to at least one median period."""
    host = frames.get("hosttrace")
    if host is None or host.empty:
        return None
    marks = host[host["name"].str.match(_STEP_MARKER_RE)].copy()
    marks["step"] = marks["name"].str.extract(_STEP_MARKER_RE).astype(int)
    marks = marks.sort_values(["step", "timestamp"]).drop_duplicates("step")
    if len(marks) < 2:
        return None
    begins = marks["timestamp"].astype(float).tolist()
    span_ends = (marks["timestamp"] + marks["duration"]).astype(float) \
        .tolist()

    anchored = _anchor_to_device(frames, marks["step"].tolist())
    if anchored is not None:
        return anchored
    last_end = span_ends[-1]
    if len(begins) >= 2:
        period = float(np.median(np.diff(np.asarray(begins))))
        last_end = max(last_end, begins[-1] + period)
    return begins, begins[1:] + [last_end]


def _anchor_to_device(frames, step_numbers: List[int]):
    """Each marked step's device begin: the ``gpusteps`` row of that step
    number on the busiest device (its span runs from the first to the
    last end of the work the step's range launched, matched by launch
    correlation in ingest).  None unless every step has one."""
    steps = frames.get("gpusteps")
    if steps is None or steps.empty:
        return None
    on_device = steps[steps["deviceId"] >= 0]
    if on_device.empty:
        return None
    dev = _busiest_device(on_device)
    rows = on_device[on_device["deviceId"] == dev].sort_values("timestamp") \
        .drop_duplicates("event")
    by_step = {int(r.event): (float(r.timestamp),
                              float(r.timestamp + r.duration))
               for r in rows.itertuples(index=False)}
    if not all(s in by_step for s in step_numbers):
        return None
    begins = [by_step[s][0] for s in step_numbers]
    return begins, begins[1:] + [by_step[step_numbers[-1]][1]]


def detect_iterations(
    names: List[str],
    num_iterations: int,
    tolerance: int = 2,
    fuzzy: bool = True,
) -> Tuple[List[int], int]:
    """Return (start indices of each detected iteration, pattern length).

    Candidate patterns come from the suffix automaton's overlapping
    counts, then each is re-verified with a non-overlapping scan: periodic
    sequences make a k-period pattern "occur" nearly as often as the true
    period, so the candidate whose non-overlapping count lands closest to
    the target (best coverage on ties) wins."""
    if len(names) < num_iterations:
        return [], 0
    symbols = {}
    seq = [symbols.setdefault(n, len(symbols)) for n in names]
    sa = SuffixAutomaton(seq)
    candidates = sa.repeat_candidates(
        num_iterations, tolerance=tolerance,
        # the expected period orders the candidates: without it a long
        # periodic trace yields thousands of multi-period candidates and
        # the truncated list never holds the true step pattern
        prefer_len=len(seq) / max(num_iterations, 1))
    best_occ: List[int] = []
    best_len = 0
    best_key = None
    for start, length, _count in candidates:
        pattern = seq[start:start + length]
        occ = find_occurrences(seq, pattern)
        if abs(len(occ) - num_iterations) > tolerance:
            continue
        key = (-abs(len(occ) - num_iterations), length * len(occ), length)
        if best_key is None or key > best_key:
            best_key = key
            best_occ = occ
            best_len = length
    if not best_occ and candidates and fuzzy:
        start, length, _count = candidates[0]
        best_occ = fuzzy_occurrences(seq, seq[start:start + length],
                                     min_ratio=0.9)
        best_len = length
    return best_occ, best_len


def _window_time(df: pd.DataFrame, t0: float, t1: float) -> Tuple[float,
                                                                   int]:
    """(total span time clipped to [t0, t1), number of overlapping
    spans)."""
    ts = df["timestamp"].to_numpy(dtype=float)
    dur = df["duration"].to_numpy(dtype=float)
    s = np.clip(ts, t0, t1)
    e = np.clip(ts + dur, t0, t1)
    ov = np.maximum(e - s, 0.0)
    # a zero-duration span (strace can report <0.000000>) still counts
    # when it starts inside the window
    inside = (ts >= t0) & (ts < t1)
    return float(ov.sum()), int(((ov > 0) | inside).sum())


def _sample_period(pystacks: Optional[pd.DataFrame]) -> float:
    """The Python sampler's tick, from the capture itself (the median gap
    between distinct sample timestamps)."""
    if pystacks is None or pystacks.empty:
        return 0.0
    ts = np.sort(pystacks["timestamp"].unique())
    if len(ts) < 2:
        return 0.0
    return float(np.median(np.diff(ts)))


def sofa_aisi(frames, cfg, features: Features) -> Optional[pd.DataFrame]:
    """Detect the iterations and profile each one: writes iterations.csv
    and adds the per-step features and the compute- or
    communication-bound verdict."""
    source = cfg.iterations_from
    if source not in ITERATION_SOURCES:
        raise ValueError(MODULE_REFUSAL if source == "module" else
                         f"--iterations_from {source!r}: not one of "
                         f"{ITERATION_SOURCES}")
    gputrace = frames.get("gputrace")

    marked = None
    label = ""
    if source in ("auto", "steps"):
        marked = _iterations_from_steps(frames)
        label = "device step spans"
        if marked is None and source == "steps":
            print_warning("aisi: iterations_from=steps but gpusteps has "
                          "fewer than two step spans")
            return None
    if marked is None and source in ("auto", "marker"):
        marked = _iterations_from_markers(frames)
        label = "explicit sofa_step markers"
        if marked is None and source == "marker":
            print_warning("aisi: iterations_from=marker but no usable "
                          "sofa_step ranges in the host trace")
            return None
    if marked is not None:
        bounds, ends = marked
        print_progress(f"aisi: {len(bounds)} iterations from {label}")
    else:
        if gputrace is None or gputrace.empty:
            return None
        seq_df, label = _op_sequence(gputrace), "kernels"
        if seq_df.empty:
            return None

        names = list(seq_df["name"])
        starts, pattern_len = detect_iterations(names, cfg.num_iterations)
        if len(starts) < 2:
            print_warning(
                f"aisi: no pattern repeating ~{cfg.num_iterations}x in "
                f"{label} ({len(names)} events)")
            return None
        print_progress(f"aisi: detected {len(starts)} iterations over "
                       f"{label}")

        ts = seq_df["timestamp"].to_numpy(dtype=float)
        dur = seq_df["duration"].to_numpy(dtype=float)
        bounds = [float(ts[i]) for i in starts]
        # each iteration ends where the next begins; the last after its own
        # pattern_len events (not len / num_iterations, which would take in
        # the warm-up's or the teardown's kernels)
        last_end_idx = min(starts[-1] + pattern_len, len(ts))
        ends = bounds[1:] + [float((ts + dur)[last_end_idx - 1])]

    strace = frames.get("strace")
    pystacks = frames.get("pystacks")
    hosttrace = frames.get("hosttrace")
    py_period = _sample_period(pystacks)
    rows = []
    for it, (t0, t1) in enumerate(zip(bounds, ends)):
        row = {"iteration": it, "begin": t0, "end": t1, "step_time": t1 - t0}
        # the host's share of each step: syscall time and count, Python
        # time (distinct sample ticks x the sampler's period) and the
        # runtime's time on the host trace
        if strace is not None and not strace.empty:
            t, c = _window_time(strace, t0, t1)
            row["syscall_time"], row["syscall_count"] = t, c
        if pystacks is not None and not pystacks.empty and py_period > 0:
            in_win = pystacks[(pystacks["timestamp"] >= t0)
                              & (pystacks["timestamp"] < t1)]
            row["host_python_time"] = (
                float(in_win["timestamp"].nunique()) * py_period)
        if hosttrace is not None and not hosttrace.empty:
            t, _ = _window_time(hosttrace, t0, t1)
            row["host_runtime_time"] = t
        if gputrace is not None and not gputrace.empty:
            ops = gputrace[
                (gputrace["timestamp"] >= t0)
                & (gputrace["timestamp"] < t1)
                & (gputrace["category"] == 0)
            ]
            row["op_time"] = float(ops["duration"].sum())
            row["kernel_time"] = float(
                ops.loc[ops["copyKind"] == int(CopyKind.KERNEL),
                        "duration"].sum())
            coll = ops[ops["copyKind"] >= 20]
            row["collective_time"] = float(coll["duration"].sum())
            row["collective_bytes"] = float(coll["payload"].sum())
            row["flops"] = float(ops["flops"].sum())
            row["bytes_accessed"] = float(ops["bytes_accessed"].sum())
            row["fw_time"] = float(
                ops.loc[ops["phase"] == "fw", "duration"].sum())
            row["bw_time"] = float(
                ops.loc[ops["phase"] == "bw", "duration"].sum())
            # compute only: a collective carries a phase too, so these and
            # collective_time are disjoint slices of the step
            comp = ops[ops["copyKind"] < 20]
            row["fw_compute_time"] = float(
                comp.loc[comp["phase"] == "fw", "duration"].sum())
            row["bw_compute_time"] = float(
                comp.loc[comp["phase"] == "bw", "duration"].sum())
            copies = gputrace[
                (gputrace["timestamp"] >= t0) & (gputrace["timestamp"] < t1)
                & (gputrace["copyKind"].isin([int(CopyKind.H2D),
                                              int(CopyKind.D2H)]))
            ]
            row["transfer_time"] = float(copies["duration"].sum())
        rows.append(row)
    table = pd.DataFrame(rows)
    table.to_csv(cfg.path("iterations.csv"), index=False)

    steps = table["step_time"].to_numpy(dtype=float)
    steps = steps[steps > 0]
    if len(steps):
        features.add("aisi_iterations", len(table))
        features.add("aisi_step_time_mean", float(np.mean(steps)))
        features.add("aisi_step_time_gmean",
                     float(np.exp(np.mean(np.log(steps)))))
        features.add("aisi_step_time_std", float(np.std(steps)))
    if "op_time" in table.columns and table["op_time"].sum() > 0:
        comm_ratio = float(table["collective_time"].sum()
                           / table["op_time"].sum())
        features.add("aisi_comm_ratio", comm_ratio)
        bound = ("COMMUNICATION" if comm_ratio >= COMM_BOUND_RATIO
                 else "COMPUTE")
        print_hint(f"aisi verdict: {bound}-bound (collectives "
                   f"{comm_ratio:.0%} of per-step device time)")
    return table


def _op_sequence(gputrace: pd.DataFrame) -> pd.DataFrame:
    """The kernels (category 0) of the busiest device, in time order."""
    sync = gputrace[gputrace["category"] == 0]
    if sync.empty:
        return sync
    dev = _busiest_device(sync)
    return sync[sync["deviceId"] == dev].sort_values("timestamp")


def iteration_series(table: Optional[pd.DataFrame]):
    """The iterations as a timeline series for the board."""
    if table is None or table.empty:
        return None
    from sofa_tpu_torch.trace import SofaSeries, make_frame

    rows = [{"timestamp": r["begin"], "event": 0.0,
             "duration": r["step_time"],
             "name": f"iter {int(r['iteration'])}", "device_kind": "gpu"}
            for _, r in table.iterrows()]
    return SofaSeries("iterations", "Iterations", "black", make_frame(rows),
                      kind="scatter")
