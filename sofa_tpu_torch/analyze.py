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
as ``[self]`` lines.  The run journal's ``begin`` and ``commit`` bracket
it, and the digests are refreshed before the commit (``durability.py``).
Frames come from ``open_frames``: lazy handles over the chunk store, so
that each pass reads only its declared columns.

The board series the passes return (AISI's iterations, HSG's swarms) are
merged into the report.js preprocess wrote.

``cluster_analyze`` (``report --cluster_hosts``) analyzes each host's
``<logdir>-<host>/`` and writes one merged, clock-aligned timeline and
``cluster_summary.csv`` into the logdir (the JAX package's
``analyze.py:102-132, 334-446``); ``load_cluster_frames`` gives the
exporters every host's frames on the same clock.
"""

from __future__ import annotations

import copy
import os
import shutil
from typing import Dict, Iterator, Optional, Tuple

import pandas as pd

from sofa_tpu_torch import durability, pool, telemetry
from sofa_tpu_torch import frames as framestore
from sofa_tpu_torch.analysis import advice, comm, registry
from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.preprocess import (build_series, frame_names,
                                       load_frames, read_misc,
                                       read_time_base)
from sofa_tpu_torch.printing import print_hint, print_progress, print_warning
from sofa_tpu_torch.trace import (derived_write_guard, read_frame,
                                  reap_stale_sentinel)

BOARD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "board")


def board_pages():
    """The board's static files, by name."""
    return sorted(os.listdir(BOARD_DIR))


def stage_board(cfg: SofaConfig) -> None:
    """Copy the board's pages beside the data, where viz serves them."""
    os.makedirs(cfg.logdir, exist_ok=True)
    for name in board_pages():
        shutil.copy2(os.path.join(BOARD_DIR, name), cfg.path(name))


def open_frames(cfg: SofaConfig) -> Dict[str, object]:
    """The frames for the passes: one with a chunk store as a lazy
    ``frames.FrameHandle`` (each pass reads only its declared columns,
    ``registry.run_passes``), any other read whole (``load_frames``)."""
    out: Dict[str, object] = {}
    for name in frame_names():
        handle = framestore.open_frame(cfg.logdir, name)
        df = handle if handle is not None else read_frame(cfg.path(name))
        if df is not None:
            out[name] = df
    return out


def sofa_analyze(cfg: SofaConfig,
                 frames: Optional[Dict[str, pd.DataFrame]] = None
                 ) -> Features:
    reap_stale_sentinel(cfg.logdir)
    tel = telemetry.begin("analyze")
    journal = durability.Journal(cfg.logdir)
    journal.begin("analyze", key=durability.logdir_raw_key(cfg.logdir))
    ok = False
    try:
        features = _analyze_body(cfg, frames, tel)
        ok = True
        return features
    finally:
        tel.write(cfg.logdir, rc=0 if ok else 1, cfg=cfg)
        if ok:
            # analyze added its artifacts: refresh the digests, then commit
            durability.write_digests(cfg.logdir)
            journal.commit("analyze",
                           key=durability.logdir_raw_key(cfg.logdir))
        telemetry.end(tel)


def _analyze_body(cfg: SofaConfig, frames, tel) -> Features:
    if frames is None:
        with tel.span("load_frames", cat="stage"):
            frames = open_frames(cfg)
    misc = read_misc(cfg)
    features = Features()
    features.add("elapsed_time", float(misc.get("elapsed_time", 0) or 0))
    registry.load_builtin_passes()
    with tel.span("passes", cat="stage"):
        ledger, series = registry.run_passes(frames, cfg, features, tel=tel)
    tel.set_meta(passes=ledger)
    if series:
        try:
            _append_report_series(cfg, series)
        except Exception as e:  # noqa: BLE001 - the passes' output stands
            print_warning(f"cannot merge analysis series into report.js: "
                          f"{e}")
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


def _append_report_series(cfg: SofaConfig, series) -> None:
    """Merge the series the passes returned (aisi's iterations, hsg's
    swarms) into the report.js preprocess wrote, replacing same-named
    ones; a report.js that cannot be read is left untouched."""
    from sofa_tpu_torch.trace import read_report_js_doc, write_report_js_doc

    path = cfg.path("report.js")
    doc = {"series": [], "meta": {}}
    if os.path.isfile(path):
        try:
            doc = read_report_js_doc(path)
        except (ValueError, OSError) as e:
            print_warning(f"cannot merge into report.js (left untouched): "
                          f"{e}")
            return
    replace = {s.name for s in series}
    doc["series"] = [s for s in doc["series"] if s["name"] not in replace]
    doc["series"] += [{"name": s.name, "title": s.title, "color": s.color,
                       "kind": s.kind,
                       "data": s.to_columnar(cfg.viz_downsample_to)}
                      for s in series]
    write_report_js_doc(doc, path)


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


#: Frames whose deviceId is a device: a cluster merge moves host i's onto
#: i * 256 (its ordinal base, as the JAX package's ingest numbers hosts).
_DEVICE_ID_FRAMES = frozenset({"gputrace", "gpusteps", "gpuutil", "gpumon"})
#: Host samplers whose deviceId is a core or lane and whose pid is unused:
#: a cluster merge writes the host's ordinal into pid.
_HOST_SAMPLER_FRAMES = frozenset({"mpstat", "vmstat", "diskstat",
                                  "netbandwidth", "nettrace"})


def load_cluster_frames(cfg: SofaConfig, only=None
                        ) -> Dict[str, pd.DataFrame]:
    """Every host's frames (``only`` these names, else all) on the cluster
    clock, for the exporters: the alignment of ``cluster_analyze``'s
    merged report (the earliest time base is zero, each host shifted by
    its base's difference, ``cluster_clock_shifts``), and each host's
    identity kept: device rows move onto the host's ordinal base (i *
    256; the heartbeat rows, -1, stay), the host trace's rows (deviceId -1
    in a CUDA trace) take the base itself, the host samplers' pid the
    ordinal; every row gets ``host`` = i."""
    import numpy as np

    present = []
    for i, hostname, host_cfg in cluster_host_cfgs(cfg):
        if not os.path.isdir(host_cfg.logdir):
            print_warning(f"cluster: missing logdir {host_cfg.logdir}")
            continue
        present.append((i, hostname, host_cfg))
    host_frames = pool.thread_map(
        lambda item: (item[0], item[1], load_frames(item[2], only=only)),
        present, pool.cfg_jobs(cfg))
    _, shifts = cluster_clock_shifts(
        {hostname: read_time_base(host_cfg)
         for _i, hostname, host_cfg in present})
    merged: Dict[str, list] = {}
    for i, hostname, frames in host_frames:
        for key, df in frames.items():
            if df.empty:
                continue
            df = df.copy()
            df["timestamp"] = df["timestamp"] + shifts[hostname]
            if key in _DEVICE_ID_FRAMES and i:
                dev = df["deviceId"].to_numpy()
                df["deviceId"] = np.where(dev >= 0, dev + i * 256, dev)
            elif key == "hosttrace":
                df["deviceId"] = i * 256
            elif key in _HOST_SAMPLER_FRAMES:
                df["pid"] = i
            df["host"] = i
            merged.setdefault(key, []).append(df)
    return {k: pd.concat(v, ignore_index=True) for k, v in merged.items()}


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
