"""``diff``: two runs side by side (the JAX package's
``sofa_tpu/ml/diff.py``).

Three tables, each sorted by how much a row moved, written into
``--logdir``:

  gpu_diff.csv    device time per kernel name over both runs' ``gputrace``
                  (the JAX package's ``tpu_diff.csv`` per HLO op): kernel
                  symbols are stable between runs of the same program, so
                  an exact join of the names gives each kernel's delta
  mem_diff.csv    bytes held per allocation site at the peak snapshot
                  (``ingest/memprof.py``), by (site, kind)
  swarm_diff.csv  each base swarm (``ml/hsg.py``'s ``auto_caption.csv``)
                  matched to the match run's by the similarity of their
                  function names, with the duration delta and the names'
                  intersection rate

``delta = match - base``; ``ratio`` is ``inf`` for a row only the match
run has, 0 for one only the base has, 1 for one that is 0 in both.
"""

from __future__ import annotations

import difflib
import os
from typing import Dict, Optional

import numpy as np
import pandas as pd

from sofa_tpu_torch.printing import print_progress, print_title, print_warning


def _cluster_signatures(df: pd.DataFrame) -> Dict[int, dict]:
    out: Dict[int, dict] = {}
    for cid, rows in df.groupby("cluster_ID"):
        names = rows["name"].astype(str)
        out[int(cid)] = {
            "names": " ".join(sorted(names.unique())[:80]),
            "name_set": set(names.unique()),
            "duration": float(rows["duration"].sum()),
            "samples": len(rows),
        }
    return out


def match_swarms(base: Dict[int, dict],
                 match: Dict[int, dict]) -> Dict[int, Optional[int]]:
    """Greedy best-ratio matching of base swarms onto match swarms."""
    pairs = []
    for b, bs in base.items():
        for m, ms in match.items():
            ratio = difflib.SequenceMatcher(None, bs["names"],
                                            ms["names"]).ratio()
            pairs.append((ratio, b, m))
    pairs.sort(reverse=True)
    used_b, used_m = set(), set()
    out: Dict[int, Optional[int]] = {b: None for b in base}
    for ratio, b, m in pairs:
        if ratio < 0.3:
            break
        if b in used_b or m in used_m:
            continue
        out[b] = m
        used_b.add(b)
        used_m.add(m)
    return out


def _delta_table(base: pd.DataFrame, match: pd.DataFrame, value_col: str,
                 out_path: str) -> pd.DataFrame:
    """Outer-join two per-key aggregates: ``delta`` and ``ratio`` (see the
    module's docstring), sorted by |delta| and written to ``out_path``."""
    joined = base.join(match, how="outer",
                       lsuffix="_base", rsuffix="_match").fillna(0.0)
    b, m = f"{value_col}_base", f"{value_col}_match"
    joined["delta"] = joined[m] - joined[b]
    joined["ratio"] = np.where(
        joined[b] > 0,
        joined[m] / joined[b].replace(0, np.nan),
        np.where(joined[m] > 0, np.inf, 1.0))
    table = joined.reindex(
        joined["delta"].abs().sort_values(ascending=False).index
    ).reset_index()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    table.to_csv(out_path, index=False)
    return table


def sofa_gpu_diff(cfg) -> Optional[pd.DataFrame]:
    """Device time per kernel name, base against match, in the region of
    interest: ``gpu_diff.csv``; prints the movers over 20 %."""
    from sofa_tpu_torch.trace import read_frame, roi_clip

    base = read_frame(os.path.join(cfg.base_logdir, "gputrace"))
    match = read_frame(os.path.join(cfg.match_logdir, "gputrace"))
    if base is None or match is None or base.empty or match.empty:
        print_warning("diff: no gputrace in one of the runs — skipping "
                      "the kernel diff")
        return None

    def per_kernel(df):
        kern = roi_clip(df, cfg)
        kern = kern[kern["category"] == 0]
        return kern.groupby("name").agg(
            time=("duration", "sum"), count=("duration", "count"))

    out_path = os.path.join(cfg.logdir, "gpu_diff.csv")
    table = _delta_table(per_kernel(base), per_kernel(match), "time",
                         out_path)
    tb, tm = float(table["time_base"].sum()), float(table["time_match"].sum())
    print_title("GPU kernel diff (base vs match)")
    print(table.head(15).to_string(index=False))
    moved = table[(table["ratio"] > 1.2) | (table["ratio"] < 1 / 1.2)]
    print_progress(
        f"diff: device time {tb:.4f}s -> {tm:.4f}s "
        f"({(tm / tb - 1) * 100 if tb else 0:+.1f}%); "
        f"{len(moved)} kernels moved >20%; wrote {out_path}")
    return table


def sofa_mem_diff(cfg) -> Optional[pd.DataFrame]:
    """Bytes held per (site, kind) at the two runs' peak snapshots:
    ``mem_diff.csv``."""
    from sofa_tpu_torch.ingest.memprof import load_memprof

    base_df, _ = load_memprof(cfg.base_logdir)
    match_df, _ = load_memprof(cfg.match_logdir)
    if base_df is None or match_df is None or base_df.empty \
            or match_df.empty:
        print_warning("diff: no memprof.pb.gz in one of the runs — "
                      "skipping the memory diff")
        return None

    def per_site(df):
        return df.groupby(["site", "kind"]).agg(
            bytes=("bytes", "sum"), count=("count", "sum"))

    out_path = os.path.join(cfg.logdir, "mem_diff.csv")
    table = _delta_table(per_site(base_df), per_site(match_df), "bytes",
                         out_path)
    bb = float(table["bytes_base"].sum())
    bm = float(table["bytes_match"].sum())
    print_title("HBM attribution diff (base vs match)")
    print(table.head(15).to_string(index=False))
    grown = table[table["delta"] > 0.05 * max(bb, 1)]
    print_progress(
        f"diff: held bytes {bb / 1e9:.3f}GB -> {bm / 1e9:.3f}GB "
        f"({(bm / bb - 1) * 100 if bb else 0:+.1f}%); "
        f"{len(grown)} sites grew >5% of the base total; wrote {out_path}")
    return table


_CLUSTER_COLUMNS = ("cluster_ID", "name", "duration")


def sofa_swarm_diff(cfg) -> Optional[pd.DataFrame]:
    """The swarms of the two runs' ``auto_caption.csv``, matched:
    ``swarm_diff.csv``.  A side without its clustered samples is a
    warning, and the other two tables are still written."""
    base_path = os.path.join(cfg.base_logdir, "auto_caption.csv")
    match_path = os.path.join(cfg.match_logdir, "auto_caption.csv")
    for p in (base_path, match_path):
        if not os.path.isfile(p):
            print_warning(f"diff: {p} missing — run `analyze "
                          "--enable_hsg` or `diff`")
            return None
    tables = []
    for p in (base_path, match_path):
        try:
            df = pd.read_csv(p)
        except Exception as e:  # noqa: BLE001 - skip this table, not the verb
            print_warning(f"diff: cannot read {p} ({e}) — skipping the "
                          "swarm diff")
            return None
        missing = [c for c in _CLUSTER_COLUMNS if c not in df.columns]
        if missing or df.empty:
            why = (f"missing column(s) {missing}" if missing
                   else "no clustered samples")
            print_warning(f"diff: {p} has {why} — skipping the swarm diff "
                          "(run `analyze --enable_hsg` on that logdir)")
            return None
        tables.append(df)
    base = _cluster_signatures(tables[0])
    match = _cluster_signatures(tables[1])
    mapping = match_swarms(base, match)

    rows = []
    for b, m in mapping.items():
        bs = base[b]
        row = {"base_cluster": b,
               "match_cluster": m if m is not None else -1,
               "base_duration": bs["duration"],
               "base_samples": bs["samples"]}
        if m is not None:
            ms = match[m]
            inter = bs["name_set"] & ms["name_set"]
            union = bs["name_set"] | ms["name_set"]
            row.update({
                "match_duration": ms["duration"],
                "duration_delta": ms["duration"] - bs["duration"],
                "duration_ratio": (ms["duration"] / bs["duration"]
                                   if bs["duration"] > 0 else 0.0),
                "intersection_rate": len(inter) / len(union) if union
                else 0.0,
            })
        rows.append(row)
    table = pd.DataFrame(rows).sort_values("base_duration", ascending=False)
    out_path = os.path.join(cfg.logdir, "swarm_diff.csv")
    os.makedirs(cfg.logdir, exist_ok=True)
    table.to_csv(out_path, index=False)
    print_title("Swarm diff (base vs match)")
    print(table.to_string(index=False))
    matched = table[table["match_cluster"] >= 0]
    print_progress(f"diff: matched {len(matched)}/{len(table)} swarms; "
                   f"wrote {out_path}")
    return table


def sofa_diff(cfg) -> int:
    """``diff --base_logdir A --match_logdir B``: preprocess and cluster
    both runs, write the three tables and stage the board into
    ``--logdir``, then refresh the digests of every logdir written into
    (``auto_caption.csv`` and the frames in A and B, the tables in the
    diff's own), so that the next ``fsck`` does not read this verb's
    output as damage.  Exits 1 when none of the three tables could be
    written (each missing one is a warning)."""
    import copy

    from sofa_tpu_torch import durability
    from sofa_tpu_torch.analysis.features import Features
    from sofa_tpu_torch.analyze import stage_board
    from sofa_tpu_torch.ml.hsg import sofa_hsg
    from sofa_tpu_torch.preprocess import sofa_preprocess

    for d in (cfg.base_logdir, cfg.match_logdir):
        c = copy.deepcopy(cfg)
        c.logdir = d
        c.__post_init__()
        frames = sofa_preprocess(c)
        sofa_hsg(frames, c, Features())
    tables = [sofa_swarm_diff(cfg), sofa_gpu_diff(cfg), sofa_mem_diff(cfg)]
    stage_board(cfg)
    for d in {os.path.normpath(p)
              for p in (cfg.logdir, cfg.base_logdir, cfg.match_logdir)}:
        if os.path.isdir(d):
            durability.write_digests(d)
    return 0 if any(t is not None for t in tables) else 1
