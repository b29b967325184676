"""analyze: run the analysis passes over the preprocessed frames.

Every pass runs through the registry (``analysis/registry.py``): the
built-ins declared in ``analysis/device.py``, ``host.py``, ``comm.py``,
``gpu.py``, ``concurrency.py``, ``advice.py`` and ``sol.py`` at the JAX
registry's positions, and any plugin's (``--plugin``).  They run in waves
on the ``--jobs`` pool, a pass that raises is a warning and a ``failed``
entry, and the run's ledger lands in the manifest as ``meta.passes``.
Then, in the JAX package's order: the tile pyramid is brought up to date
(nothing to do after a ``report``; built for an older logdir), the
feature vector is printed and saved as ``features.csv``, the remote advice
service is asked when one is configured (``--hint_server`` or
``SOFA_HINT_SERVER``; an unreachable one is a warning), the rule-based
hints are printed and written to ``hints.txt``, the board's pages are
staged beside the data, and the run ends with the ``Complete!!`` line.
The run lands in the run manifest (``telemetry.py``; the JAX package's
``analyze.py:192-212``), and the manifest's health warnings ride the hints
as ``[self]`` lines.

``cluster_analyze`` (``report --cluster_hosts``) analyzes each host's
``<logdir>-<host>/`` and writes one merged, clock-aligned timeline and
``cluster_summary.csv`` into the logdir (the JAX package's
``analyze.py:102-132, 334-446``).
"""

from __future__ import annotations

import copy
import os
import shutil
from typing import Dict, Iterator, Optional, Tuple

import pandas as pd

from sofa_tpu_torch import pool, telemetry
from sofa_tpu_torch.analysis import advice, comm, registry
from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.preprocess import (build_series, load_frames, read_misc,
                                       read_time_base)
from sofa_tpu_torch.printing import print_hint, print_progress, print_warning
from sofa_tpu_torch.trace import derived_write_guard, reap_stale_sentinel

BOARD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "board")


def board_pages():
    """The board's static files, by name."""
    return sorted(os.listdir(BOARD_DIR))


def stage_board(cfg: SofaConfig) -> None:
    """Copy the board's pages beside the data, where viz serves them."""
    os.makedirs(cfg.logdir, exist_ok=True)
    for name in board_pages():
        shutil.copy2(os.path.join(BOARD_DIR, name), cfg.path(name))


def sofa_analyze(cfg: SofaConfig,
                 frames: Optional[Dict[str, pd.DataFrame]] = None
                 ) -> Features:
    reap_stale_sentinel(cfg.logdir)
    tel = telemetry.begin("analyze")
    ok = False
    try:
        features = _analyze_body(cfg, frames, tel)
        ok = True
        return features
    finally:
        tel.write(cfg.logdir, rc=0 if ok else 1, cfg=cfg)
        telemetry.end(tel)


def _analyze_body(cfg: SofaConfig, frames, tel) -> Features:
    if frames is None:
        with tel.span("load_frames", cat="stage"):
            frames = load_frames(cfg)
    misc = read_misc(cfg)
    features = Features()
    features.add("elapsed_time", float(misc.get("elapsed_time", 0) or 0))
    registry.load_builtin_passes()
    with tel.span("passes", cat="stage"):
        ledger, series = registry.run_passes(frames, cfg, features, tel=tel)
    tel.set_meta(passes=ledger)
    if series:
        print_warning(f"analyze: {len(series)} board series from passes are "
                      "not merged into report.js")
    # without the mpstat sampler (api.profile()), the cores record wrote
    if not features.get("num_cores") and misc.get("cores"):
        features.add("num_cores", int(misc["cores"]))
    if cfg.enable_tiles:
        from sofa_tpu_torch import tiles

        try:
            with derived_write_guard(cfg.logdir):
                tiles.ensure_tiles(cfg, frames)
        except Exception as e:  # noqa: BLE001 - the overview still works
            print_warning(f"analyze: tile pyramid failed ({e!r}); the board "
                          "serves the overview only")
    print(features.render())
    features.save(cfg.path("features.csv"))
    from sofa_tpu_torch.analysis.hint_service import fetch_hints

    with tel.span("hint_service", cat="stage"):
        for hint in fetch_hints(cfg, features):
            print_hint(f"[remote] {hint}")
    with tel.span("hints", cat="stage"):
        advice.hint_report(features, cfg)
    with tel.span("stage_board", cat="stage"):
        stage_board(cfg)
    print("Complete!!")
    return features


# --- the cluster report ------------------------------------------------------

#: The features of each host's row in cluster_summary.csv.  The JAX
#: package's ``tpu0_op_time`` is ``gpu0_kernel_time`` here (device 0's
#: kernel time, ``analysis/gpu.py``) and its ``tc_util_mean`` (TensorCore
#: duty cycle) is ``kernel_util_mean`` (``gpuutil``'s kernel utilization).
SUMMARY_KEYS = ("elapsed_time", "cpu_util", "gpu0_kernel_time",
                "comm_ratio", "net_tx_total_bytes", "net_rx_total_bytes",
                "kernel_util_mean")


def cluster_host_cfgs(cfg: SofaConfig
                      ) -> Iterator[Tuple[int, str, SofaConfig]]:
    """(ordinal, host, host config) for each host of
    ``cfg.cluster_hosts``: the one place that names the per-host logdirs
    (``<logdir>-<host>/``, as ``record.cluster_record`` writes them).  The
    ordinal follows the configured list, so a missing logdir never
    renumbers the hosts after it."""
    for i, hostname in enumerate(cfg.cluster_hosts):
        host_cfg = copy.deepcopy(cfg)
        host_cfg.logdir = cfg.logdir.rstrip("/") + f"-{hostname}/"
        host_cfg.__post_init__()
        yield i, hostname, host_cfg


def cluster_clock_shifts(time_bases: Dict[str, float]
                         ) -> Tuple[float, Dict[str, float]]:
    """(cluster zero, shift per host) from the hosts' sofa_time.txt bases:
    the earliest readable base is zero, each host shifts by its base
    minus it.  A host without a readable base gets shift 0 and a warning
    (excluding it from the zero keeps one broken fetch from shifting every
    healthy host by an epoch)."""
    known = [tb for tb in time_bases.values() if tb > 0]
    tb0 = min(known) if known else 0.0
    shifts = {}
    for hostname, tb in time_bases.items():
        if tb > 0:
            shifts[hostname] = tb - tb0
        else:
            print_warning(
                f"cluster: {hostname} has no sofa_time.txt; its series are "
                "not clock-aligned on the merged timeline")
            shifts[hostname] = 0.0
    return tb0, shifts


def cluster_analyze(cfg: SofaConfig,
                    preloaded: Optional[Dict[str, Dict[str, pd.DataFrame]]]
                    = None) -> Dict[str, Features]:
    """Analyze each host's logdir (on ``pool.thread_map``: each host
    writes into its own logdir only), then write into ``cfg.logdir`` the
    merged timeline, every host's series renamed ``<host>_<series>`` and
    shifted onto the cluster clock (``cluster_clock_shifts``), with
    ``meta.cluster_hosts`` and ``meta.time_base``, its tile pyramid and
    the staged board; and ``cluster_summary.csv``, one row per host
    (``SUMMARY_KEYS`` and the host's ``dcn_step_corr``).  ``preloaded``
    maps a host to the frames its preprocess just returned, so that they
    are not read back from the CSVs.  Returns each host's features."""
    from sofa_tpu_torch.trace import derived_write_guard, series_to_report_js

    host_list = []
    for _i, hostname, host_cfg in cluster_host_cfgs(cfg):
        if not os.path.isdir(host_cfg.logdir):
            print_warning(f"cluster: missing logdir {host_cfg.logdir}")
            continue
        host_list.append((hostname, host_cfg))

    def analyze_host(item):
        hostname, host_cfg = item
        print_progress(f"cluster: analyzing {hostname}")
        frames = (preloaded[hostname]
                  if preloaded and hostname in preloaded
                  else load_frames(host_cfg))
        # a pass one host's analyze registers stays that host's
        with registry.scoped():
            features = sofa_analyze(host_cfg, frames)
        return (hostname, frames, features, read_time_base(host_cfg),
                comm.dcn_step_correlation(frames))

    results: Dict[str, Features] = {}
    rows = []
    host_frames: Dict[str, Dict[str, pd.DataFrame]] = {}
    time_bases: Dict[str, float] = {}
    cfg_by_host = dict(host_list)
    for hostname, frames, features, time_base, corr in pool.thread_map(
            analyze_host, host_list, pool.cfg_jobs(cfg)):
        host_frames[hostname] = frames
        results[hostname] = features
        time_bases[hostname] = time_base
        row = {"host": hostname}
        for key in SUMMARY_KEYS:
            value = features.get(key)
            if value is not None:
                row[key] = value
        if corr is not None:
            row["dcn_step_corr"] = round(corr, 4)
        rows.append(row)

    if host_frames:
        tb0, shifts = cluster_clock_shifts(time_bases)
        merged_series = []
        for hostname, frames in host_frames.items():
            for s in build_series(cfg_by_host[hostname], frames):
                data = s.data.copy()
                data["timestamp"] = data["timestamp"] + shifts[hostname]
                s.data = data
                s.name = f"{hostname}_{s.name}"
                s.title = f"[{hostname}] {s.title}"
                merged_series.append(s)
        os.makedirs(cfg.logdir, exist_ok=True)
        meta = {"cluster_hosts": list(host_frames), "time_base": tb0}
        with derived_write_guard(cfg.logdir):
            if cfg.enable_tiles:
                from sofa_tpu_torch import tiles

                try:
                    meta["tiles"] = tiles.build_tiles(cfg, merged_series)
                except Exception as e:  # noqa: BLE001 - the overview works
                    print_warning(f"cluster: tile pyramid failed ({e!r}); "
                                  "the merged board serves the overview "
                                  "only")
            series_to_report_js(merged_series, cfg.path("report.js"),
                                cfg.viz_downsample_to, meta)
        stage_board(cfg)
        print_progress(
            f"cluster: merged timeline of {len(host_frames)} hosts "
            f"({len(merged_series)} series) -> {cfg.path('report.js')}")

    if rows:
        summary = pd.DataFrame(rows)
        os.makedirs(cfg.logdir, exist_ok=True)
        summary.to_csv(cfg.path("cluster_summary.csv"), index=False)
        print_progress("cluster summary:")
        print(summary.to_string(index=False))
    return results
