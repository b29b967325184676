"""preprocess: fold a recording's raw traces into the unified schema.

A table of ingest tasks in the JAX package's order: the host samplers
(mpstat, diskstat, netbandwidth, cpuinfo, vmstat), perf's CPU samples
(cputrace), syscalls (strace), Python stacks (pystacks), packets
(nettrace), the GPU memory sampler (gpumon), block IO (blktrace), then the
Kineto capture (one source, ``kineto``, for the gputrace, gpusteps and
hosttrace frames and the gpuutil series derived from them).

The task dispatch is the JAX package's (``sofa_tpu/preprocess.py:223-433``):

  * every source first tries the content-keyed ingest cache
    (``ingest/cache.py``; loads overlap on threads), unless an injected
    ``<source>:corrupt`` fault names it;
  * the misses run on a thread pool of ``--jobs`` workers, the CPU-heavy
    parsers (perf script, pcap) on a forkserver or spawn process pool when
    their raw bytes make it worth the spawn (``SOFA_PREPROCESS_POOL``
    always|never overrides);
  * a parser that finds its raw file corrupt (``CorruptRawError``, a
    Kineto JSON that does not decode) moves it to ``<logdir>/_quarantine/``
    and purges the source from the cache; a failed converter
    (``IngestToolError``) is ``failed``, any other error ``degraded``; each
    costs its own frames only;
  * each source lands one entry in the run manifest (status, cache
    outcome, wall_s, events).

The frames come back in the table's order whatever the pool, so ``--jobs
1`` and ``--jobs N`` write the same bytes.  Each frame is written in the
run's format (``--trace_format``, ``trace.resolve_trace_format``): by
default into the chunk store ``_frames/<name>/`` (``frames.py``), with the
board's downsampled ``<name>.csv`` beside it; then the frames become the
board's timeline series (``build_series``), their deep-zoom tile pyramid
(``tiles.py``) and ``report.js``, all under the derived-write guard.  The
run journal's ``begin`` and ``commit`` bracket the verb, and the digests
are refreshed once the guard is released (``durability.py``; the JAX
package's ``preprocess.py:474-650``).

``live`` (``live.py``) runs the same ingest over the sources it does not
tail (``_run_ingest(only=...)``) and assembles its frames through the same
``assemble_frames``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, NamedTuple, Tuple

import pandas as pd

from sofa_tpu_torch import durability, faults, pool, telemetry
from sofa_tpu_torch import trace
from sofa_tpu_torch.analysis.sol import device_peaks
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.ingest import CorruptRawError, IngestToolError, procfs
from sofa_tpu_torch.ingest.blktrace_parse import ingest_blktrace
from sofa_tpu_torch.ingest.cache import (CACHE_DIR_NAME, IngestCache,
                                         make_key, raw_files_present)
from sofa_tpu_torch.ingest.gpumon_parse import gpumon_files, ingest_gpumon
from sofa_tpu_torch.ingest.kineto import (capture_files, gpu_utilization,
                                          ingest_kineto_dir)
from sofa_tpu_torch.ingest.pcap import ingest_pcap
from sofa_tpu_torch.ingest.perf_script import ingest_perf
from sofa_tpu_torch.ingest.timebase_align import converter
from sofa_tpu_torch.printing import print_info, print_progress, print_warning
from sofa_tpu_torch.trace import (SofaSeries, derived_write_guard,
                                  downsample, empty_frame, read_frame,
                                  reap_stale_sentinel, resolve_trace_format,
                                  series_to_report_js)

KINETO_FRAMES = ("gputrace", "gpusteps", "hosttrace", "gpuutil")
UTIL_WINDOW_S = 0.1         # gpuutil's window, as the JAX tpuutil's

# The columns the board reads (build_series and the tile pyramid): what a
# columnar frame materializes for the viz path.
VIZ_COLUMNS = ("timestamp", "event", "duration", "deviceId", "name",
               "hlo_category", "phase")

# Corrupt raw inputs are moved here (never deleted: the bytes are
# evidence); clean removes it.
QUARANTINE_DIR_NAME = "_quarantine"

# The timeline's series, in legend order: frame -> (title, colour).  The
# colours are the JAX package's, the device frames taking their TPU
# counterparts' (tputrace, tpuutil, tpumon, tpusteps).
_SERIES_STYLE = {
    "cputrace": ("CPU samples", "dodgerblue"),
    "hosttrace": ("Host runtime", "slategray"),
    "pystacks": ("Python stacks", "goldenrod"),
    "strace": ("Syscalls", "brown"),
    "mpstat": ("CPU util %", "steelblue"),
    "vmstat": ("vmstat", "darkkhaki"),
    "diskstat": ("Disk", "sienna"),
    "netbandwidth": ("NIC B/s", "seagreen"),
    "nettrace": ("Packets", "olive"),
    "gputrace": ("GPU kernels", "darkorchid"),
    "gpuutil": ("GPU util", "crimson"),
    "gpumon": ("GPU memory", "firebrick"),
    "gpusteps": ("GPU steps", "black"),
    "blktrace": ("Block IO latency (ms)", "peru"),
}
LINE_SERIES = ("mpstat", "vmstat", "diskstat", "netbandwidth", "gpuutil",
               "gpumon")


def read_time_base(cfg: SofaConfig) -> float:
    """The run's time zero (unix seconds) from ``sofa_time.txt``."""
    try:
        with open(cfg.path("sofa_time.txt")) as f:
            return float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        print_warning("sofa_time.txt missing; timestamps stay absolute")
        return 0.0


def read_misc(cfg: SofaConfig) -> Dict[str, str]:
    out: Dict[str, str] = {}
    try:
        with open(cfg.path("misc.txt")) as f:
            for line in f:
                p = line.split()
                if len(p) == 2:
                    out[p[0]] = p[1]
    except OSError:
        pass
    return out


# --- ingest workers ---------------------------------------------------------
# Module-level, so that they cross a process-pool boundary, and resolving
# their parser by name at call time.

def _ingest_procfs(path: str, parser_name: str, time_base: float,
                   **kw) -> pd.DataFrame:
    return procfs.load(path, getattr(procfs, parser_name), time_base, **kw)


def _ingest_text(path: str, parser_name: str, time_base: float,
                 **kw) -> pd.DataFrame:
    from sofa_tpu_torch.ingest import strace_parse

    return procfs.load(path, getattr(strace_parse, parser_name), time_base,
                       **kw)


def _ingest_cputrace(logdir: str, time_base: float) -> pd.DataFrame:
    """perf samples, with perf's monotonic clock bridged to unix time
    (timebase.txt) and cycles turned into seconds at the sampled MHz."""
    mono_to_unix = converter(os.path.join(logdir, "timebase.txt"),
                             "monotonic")
    cpuinfo = procfs.load(os.path.join(logdir, "cpuinfo.txt"),
                          procfs.parse_cpuinfo, time_base)
    return ingest_perf(logdir, time_base, mono_to_unix,
                       procfs.cpu_mhz_interpolator(cpuinfo))


def _ingest_kineto(kineto_dir: str, time_base: float,
                   peaks: dict) -> Dict[str, pd.DataFrame]:
    """The Kineto frames, and gpuutil derived from gputrace against the
    card's peaks (gpu_topo.json's, read when the task was built)."""
    frames = ingest_kineto_dir(kineto_dir, time_base)
    frames["gpuutil"] = gpu_utilization(frames["gputrace"], UTIL_WINDOW_S,
                                        peaks)
    return frames


class _IngestTask(NamedTuple):
    name: str                 # source name == cache key
    kind: str                 # "thread" (small or IO) | "proc" (CPU-heavy)
    fn: object                # a module-level callable
    args: tuple
    kwargs: dict
    raw_paths: tuple          # the raw files the cache key signs
    params: dict              # the parameters that shape the output
    frame_names: tuple        # frames produced, in output order


def _ingest_tasks(cfg: SofaConfig, time_base: float) -> List[_IngestTask]:
    """THE task table; its order is the frames' order."""
    P = cfg.path
    tasks: List[_IngestTask] = []

    def T(name, kind, fn, args, raw, kwargs=None, params=None, frames=None):
        merged = {"time_base": time_base}
        merged.update(params or {})
        tasks.append(_IngestTask(name, kind, fn, tuple(args), kwargs or {},
                                 tuple(raw), merged,
                                 tuple(frames or (name,))))

    for name, raw, parser in (("mpstat", "mpstat.txt", "parse_mpstat"),
                              ("diskstat", "diskstat.txt", "parse_diskstat"),
                              ("netbandwidth", "netstat.txt",
                               "parse_netstat"),
                              ("cpuinfo", "cpuinfo.txt", "parse_cpuinfo")):
        T(name, "thread", _ingest_procfs, (P(raw), parser, time_base),
          [P(raw)])
    T("vmstat", "thread", _ingest_procfs,
      (P("vmstat.txt"), "parse_vmstat", time_base), [P("vmstat.txt")],
      kwargs={"record_start": time_base})
    T("cputrace", "proc", _ingest_cputrace, (cfg.logdir, time_base),
      [P("perf.data"), P("perf.script"), P("kallsyms"), P("timebase.txt"),
       P("cpuinfo.txt")])
    T("strace", "thread", _ingest_text,
      (P("strace.txt"), "parse_strace", time_base), [P("strace.txt")],
      kwargs={"min_time": cfg.strace_min_time},
      params={"min_time": cfg.strace_min_time})
    T("pystacks", "thread", _ingest_text,
      (P("pystacks.txt"), "parse_pystacks", time_base), [P("pystacks.txt")])
    T("nettrace", "proc", ingest_pcap, (P("sofa.pcap"), time_base),
      [P("sofa.pcap")])
    T("gpumon", "thread", ingest_gpumon, (cfg.logdir, time_base),
      gpumon_files(cfg.logdir))
    # blkparse times are already trace-relative
    T("blktrace", "thread", ingest_blktrace, (cfg.logdir, 0.0),
      [P("blktrace.txt")])
    peaks = device_peaks(cfg)
    T("kineto", "thread", _ingest_kineto, (cfg.kineto_dir, time_base, peaks),
      capture_files(cfg.kineto_dir), frames=KINETO_FRAMES,
      params={"util_window_s": UTIL_WINDOW_S, "peaks": peaks})
    return tasks


def frame_names() -> List[str]:
    """Every frame preprocess writes, in order."""
    return [name for t in _ingest_tasks(SofaConfig(logdir="/nonexistent"),
                                        0.0)
            for name in t.frame_names]


def _normalize(task: _IngestTask, res) -> Dict[str, pd.DataFrame]:
    """A worker's result -> {frame name: df} in the declared order."""
    if isinstance(res, dict):
        return {fn: res.get(fn, empty_frame()) for fn in task.frame_names}
    return {task.name: res if res is not None else empty_frame()}


# Raw bytes below this parse faster than a process-pool worker spawns;
# SOFA_PREPROCESS_POOL (always|never) overrides.
_PROC_POOL_MIN_BYTES = 32 * 2 ** 20


def _timed_call(fn, args, kwargs) -> tuple:
    """(result, parse seconds): module-level, so that the wall time crosses
    a process-pool boundary."""
    t0 = time.perf_counter()
    return fn(*args, **kwargs), time.perf_counter() - t0


def _run_pending(pending: List[_IngestTask], jobs: int) -> Dict[str, tuple]:
    """Run the cache misses -> {name: (result | None, error | None, parse
    seconds)}.  The "proc" tasks go to a process pool when the policy and
    their size allow, beside the thread pool's; a pool that cannot start
    or breaks degrades to running in this process."""

    def run_local(t: _IngestTask) -> tuple:
        t0 = time.perf_counter()
        try:
            return t.fn(*t.args, **t.kwargs), None, time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 - routed to the manifest
            return None, e, time.perf_counter() - t0

    outcomes: Dict[str, tuple] = {}
    policy = os.environ.get("SOFA_PREPROCESS_POOL", "auto")
    proc_tasks = [t for t in pending if t.kind == "proc"]
    proc_bytes = 0
    for t in proc_tasks:
        for p in t.raw_paths:
            try:
                proc_bytes += os.path.getsize(p)
            except OSError:
                pass
    use_proc = (jobs > 1 and proc_tasks and policy != "never"
                and (policy == "always" or proc_bytes >= _PROC_POOL_MIN_BYTES))
    procpool, futs = None, {}
    if use_proc:
        try:
            from concurrent.futures import ProcessPoolExecutor

            procpool = ProcessPoolExecutor(
                max_workers=pool.pool_size(jobs, len(proc_tasks)),
                mp_context=pool.process_context())
            for t in proc_tasks:
                futs[t.name] = procpool.submit(_timed_call, t.fn, t.args,
                                               t.kwargs)
        except Exception as e:  # noqa: BLE001 - no /dev/shm, no spawn
            print_warning(f"preprocess: process pool unavailable ({e}); "
                          "parsing in threads")
            procpool, futs = None, {}
    local = [t for t in pending if t.name not in futs]
    for t, out in zip(local, pool.thread_map(run_local, local, jobs)):
        outcomes[t.name] = out
    if procpool is not None:
        from concurrent.futures import BrokenExecutor

        broken = False
        for t in proc_tasks:
            if broken:
                outcomes[t.name] = run_local(t)
                continue
            try:
                res, dt = futs[t.name].result()
                outcomes[t.name] = (res, None, dt)
            except BrokenExecutor as e:
                # a crashed worker poisons every pending future: an
                # environment failure, not a parse failure
                print_warning(f"preprocess: process pool broke ({e!r}); "
                              "reparsing the remaining sources here")
                broken = True
                outcomes[t.name] = run_local(t)
            except Exception as e:  # noqa: BLE001 - routed like run_local's
                outcomes[t.name] = (None, e, 0.0)
        procpool.shutdown()
    return outcomes


def _frame_rows(frames: Dict[str, pd.DataFrame]) -> int:
    return int(sum(len(df) for df in frames.values() if df is not None))


def _run_ingest(cfg: SofaConfig, time_base: float, jobs: int, tel,
                only=None):
    """Cache or parse every source (``only`` these names, else all) ->
    (tasks, {name: (frames, error)}, cache), with one manifest entry per
    source.  ``live`` passes the sources it does not tail."""
    tasks = _ingest_tasks(cfg, time_base)
    if only is not None:
        tasks = [t for t in tasks if t.name in only]
    cache = IngestCache(cfg.path(CACHE_DIR_NAME), enabled=cfg.ingest_cache)
    keys = {t.name: make_key(t.name, t.raw_paths, t.params) for t in tasks}
    plan = faults.active()

    def _load(t: _IngestTask) -> tuple:
        if plan is not None and plan.corrupt_for(t.name) is not None:
            return None, 0.0        # a warm hit must not mask the fault
        t0 = time.perf_counter()
        hit = cache.load(t.name, keys[t.name])
        return hit, time.perf_counter() - t0

    loaded = pool.thread_map(_load, tasks, jobs)
    results: Dict[str, tuple] = {}
    pending: List[_IngestTask] = []
    for t, (hit, load_dt) in zip(tasks, loaded):
        if hit is not None:
            frames = _normalize(t, hit["frames"])
            results[t.name] = (frames, None)
            tel.source_event(t.name, status="cached", cache="hit",
                             wall_s=round(load_dt, 6),
                             events=_frame_rows(frames))
        else:
            pending.append(t)
    cache_outcome = "miss" if cache.enabled else "bypass"
    # An injected corruption becomes its CorruptRawError before dispatch:
    # the plan need not cross a process-pool boundary.
    outcomes: Dict[str, tuple] = {}
    if plan is not None and pending:
        still = []
        for t in pending:
            if plan.corrupt_for(t.name) is not None:
                path = next((p for p in t.raw_paths if os.path.isfile(p)),
                            t.raw_paths[0] if t.raw_paths else "")
                outcomes[t.name] = (
                    None, CorruptRawError(path, "injected corruption "
                                                "(--inject_faults)"), 0.0)
            else:
                still.append(t)
        pending = still
    if pending:
        outcomes.update(_run_pending(pending, jobs))
    for t in [t for t in tasks if t.name in outcomes]:
        res, err, parse_dt = outcomes[t.name]
        if err is None:
            frames = _normalize(t, res)
            results[t.name] = (frames, None)
            # re-keyed at store time: a parse may write one of its own raw
            # inputs (perf.data -> perf.script)
            key = make_key(t.name, t.raw_paths, t.params)
            if raw_files_present(key):
                cache.store(t.name, key, frames)
            status = ("parsed" if raw_files_present(keys[t.name])
                      or _frame_rows(frames) else "empty")
            tel.source_event(t.name, status=status, cache=cache_outcome,
                             wall_s=round(parse_dt, 6),
                             events=_frame_rows(frames))
            continue
        results[t.name] = ({fn: empty_frame() for fn in t.frame_names}, err)
        if isinstance(err, CorruptRawError):
            _quarantine_source(cfg, t.name, err, cache, tel, cache_outcome,
                               parse_dt)
        else:
            # a broken converter over existing bytes is `failed` (a rerun
            # can recover it), any other parse error `degraded`
            status = ("failed" if isinstance(err, IngestToolError)
                      else "degraded")
            tel.source_event(t.name, status=status, cache=cache_outcome,
                             wall_s=round(parse_dt, 6), events=0,
                             error=str(err)[:300])
    return tasks, results, cache


def _quarantine_source(cfg: SofaConfig, name: str, err: CorruptRawError,
                       cache: IngestCache, tel, cache_outcome: str,
                       parse_dt: float) -> None:
    """Corrupt raw input -> <logdir>/_quarantine/, a manifest entry, and a
    purged cache, so that the poisoned parse is never served warm."""
    moved = None
    src = err.path
    if src and os.path.isfile(src):
        qdir = cfg.path(QUARANTINE_DIR_NAME)
        try:
            os.makedirs(qdir, exist_ok=True)
            dest = os.path.join(qdir, os.path.basename(src))
            n = 1
            while os.path.exists(dest):
                dest = os.path.join(qdir, f"{os.path.basename(src)}.{n}")
                n += 1
            os.replace(src, dest)           # the logdir's filesystem
            moved = dest
        except OSError as e:
            print_warning(f"preprocess {name}: cannot quarantine {src}: {e}")
    cache.invalidate(name)
    fields = {"status": "quarantined", "cache": cache_outcome,
              "wall_s": round(parse_dt, 6), "events": 0,
              "error": str(err)[:300]}
    if moved is not None:
        fields["quarantined_file"] = moved
    tel.source_event(name, **fields)
    print_warning(f"preprocess {name}: corrupt raw input "
                  f"({err}) — quarantined to "
                  f"{moved or cfg.path(QUARANTINE_DIR_NAME)}; the source "
                  "is empty this run")


def sofa_preprocess(cfg: SofaConfig) -> Dict[str, pd.DataFrame]:
    reap_stale_sentinel(cfg.logdir)
    tel = telemetry.begin("preprocess")
    fmt = resolve_trace_format(cfg)     # inside the run: its warning counts
    journal = durability.Journal(cfg.logdir)
    journal.begin("preprocess", key=durability.logdir_raw_key(cfg.logdir),
                  trace_format=fmt)
    try:
        faults.install_from(cfg)
        frames = _preprocess_body(cfg, tel, fmt)
        # only once every artifact and the digests are on disk: `resume`
        # replays anything short of this line
        journal.commit("preprocess",
                       key=durability.logdir_raw_key(cfg.logdir))
        return frames
    finally:
        telemetry.end(tel)
        faults.clear()


def write_frames(cfg: SofaConfig, frames: Dict[str, pd.DataFrame],
                 fmt: str, jobs: int) -> dict:
    """Write every frame in ``fmt`` on the thread pool; returns
    ``meta.frames``.  Beside a columnar or parquet frame lands the board's
    ``<name>.csv``, downsampled to ``viz_downsample_to`` rows.  A frame
    the chunk store refuses is written as CSV (``fallback`` names it)."""

    def write_one(item) -> tuple:
        name, df = item
        base = cfg.path(name)
        path, stats = trace.write_frame(df, base, fmt)
        if path != base + ".csv":
            # not write_frame's csv mode: that would delete the store
            trace.write_csv(downsample(df, cfg.viz_downsample_to),
                            base + ".csv")
        return name, stats

    wrote = pool.thread_map(write_one, list(frames.items()), jobs)
    stats = [s for _n, s in wrote if s]
    return {"format": fmt, "dir": "_frames" if fmt == "columnar" else "",
            "frames": len(wrote),
            "chunks": int(sum(s["wrote"] + s["reused"] for s in stats)),
            "reused": int(sum(s["reused"] for s in stats)),
            "bytes": int(sum(s["bytes"] for s in stats)),
            "fallback": sorted(n for n, s in wrote
                               if s is None and fmt == "columnar")}


def assemble_frames(cfg: SofaConfig, tasks, results
                    ) -> Dict[str, pd.DataFrame]:
    """The ingest results -> {frame name: df} in the task table's order,
    shifted by the manual clock fixes (--cpu_time_offset_ms,
    --gpu_time_offset_ms).  They apply after the cache, which holds the
    frames unshifted, so a changed offset reaches a warm run too.  Batch
    and ``live`` both assemble through here."""
    cpu_off = cfg.cpu_time_offset_ms / 1e3
    gpu_off = cfg.gpu_time_offset_ms / 1e3
    frames: Dict[str, pd.DataFrame] = {}
    for t in tasks:
        task_frames, err = results[t.name]
        if err is not None and not isinstance(err, CorruptRawError):
            # a quarantine has warned already, with the destination
            print_warning(f"preprocess: {t.name} failed ({err!r}); its "
                          "frames stay empty")
        shift = gpu_off if t.name == "kineto" else cpu_off
        for name, df in task_frames.items():
            if shift and not df.empty:
                df = df.assign(timestamp=df["timestamp"] + shift)
            frames[name] = df
    return frames


def _preprocess_body(cfg: SofaConfig, tel, fmt: str
                     ) -> Dict[str, pd.DataFrame]:
    from sofa_tpu_torch.collectors.kineto import merge_rank_topology

    time_base = read_time_base(cfg)
    merge_rank_topology(cfg.logdir)     # the ranks' records, before peaks
    jobs = pool.cfg_jobs(cfg)
    tel.set_meta(pool={"jobs": jobs, "cpu_count": os.cpu_count() or 1})
    with tel.span("ingest", cat="stage"):
        tasks, results, cache = _run_ingest(cfg, time_base, jobs, tel)
    frames = assemble_frames(cfg, tasks, results)
    with derived_write_guard(cfg.logdir):
        t0, t0_unix = time.perf_counter(), time.time()
        tel.set_meta(frames=write_frames(cfg, frames, fmt, jobs))
        tel.add_span("write_frames", "stage", t0_unix,
                     time.perf_counter() - t0, frames=len(frames),
                     format=fmt)
        for name, df in frames.items():
            if not df.empty:
                print_info(f"{name}: {len(df)} rows ({fmt})")
        write_board_data(cfg, frames, time_base, tel)
    # the digests hash the final bytes: after the guard is released
    with tel.span("digests", cat="stage"):
        digest_doc = durability.write_digests(cfg.logdir)
    tel.set_meta(ingest_cache=cache.stats())
    manifest = tel.write(cfg.logdir, rc=0, cfg=cfg)
    if digest_doc is not None and "digests" not in (manifest or {}):
        # the write above made this logdir's first manifest
        durability.attach_digests(cfg.logdir, digest_doc)
    summary = telemetry.preprocess_summary(manifest)
    if summary:
        print_progress(summary)
    return frames


def _contains(col: pd.Series, keyword: str) -> pd.Series:
    """Case-insensitive substring match, over the column's unique values
    (kernel names repeat heavily)."""
    kw = keyword.lower()
    return col.isin([u for u in col.unique() if kw in str(u).lower()])


def build_series(cfg: SofaConfig,
                 frames: Dict[str, pd.DataFrame]) -> List[SofaSeries]:
    """The timeline: one series per non-empty frame of ``_SERIES_STYLE``,
    then the CPU filters over cputrace, the fw/bw phases of gputrace and
    the GPU filters over gputrace."""
    series: List[SofaSeries] = []
    for key, (title, color) in _SERIES_STYLE.items():
        df = frames.get(key)
        if df is None or df.empty:
            continue
        if key == "mpstat":
            # the aggregate non-idle share; per-core rows feed cpu-report
            df = df[(df["deviceId"] == -1) & df["name"].isin(["usr", "sys"])]
        series.append(SofaSeries(
            key, title, color, df,
            kind="line" if key in LINE_SERIES else "scatter"))
    cputrace = frames.get("cputrace", empty_frame())
    for filt in cfg.cpu_filters:
        if cputrace.empty:
            break
        sel = cputrace[_contains(cputrace["name"], filt.keyword)]
        if not sel.empty:
            series.append(SofaSeries(f"cpu_{filt.keyword}",
                                     f"CPU: {filt.keyword}", filt.color, sel))
    gputrace = frames.get("gputrace", empty_frame())
    if not gputrace.empty:
        for phase, title, color in (("fw", "GPU forward", "mediumseagreen"),
                                    ("bw", "GPU backward", "crimson")):
            sel = gputrace[gputrace["phase"] == phase]
            if not sel.empty:
                series.append(SofaSeries(f"gpu_phase_{phase}", title, color,
                                         sel))
    for filt in cfg.gpu_filters:
        if gputrace.empty:
            break
        sel = gputrace[_contains(gputrace["name"], filt.keyword)
                       | _contains(gputrace["hlo_category"], filt.keyword)]
        if not sel.empty:
            series.append(SofaSeries(f"gpu_{filt.keyword}",
                                     f"GPU: {filt.keyword}", filt.color, sel))
    return series


def _gpu_meta(cfg: SofaConfig):
    """The card's meta (gpu_topo.json), or None without one."""
    try:
        with open(cfg.path("gpu_topo.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def report_meta(cfg: SofaConfig, time_base: float) -> dict:
    """report.js's ``meta``, before the tile manifest."""
    return {"elapsed_time": float(read_misc(cfg).get("elapsed_time", 0)
                                  or 0),
            "time_base": time_base, "gpu_meta": _gpu_meta(cfg),
            "logdir": cfg.logdir}


def write_board_data(cfg: SofaConfig, frames: Dict[str, pd.DataFrame],
                     time_base: float, tel=None) -> None:
    """The series, their tile pyramid (a failure costs the deep zoom only)
    and report.js; prints each stage's time (and records it as the
    ``tiles`` and ``report_js`` spans of ``tel``)."""
    t0 = time.perf_counter()
    series = build_series(cfg, frames)
    t1 = time.perf_counter()
    manifest = None
    if cfg.enable_tiles:
        from sofa_tpu_torch import tiles

        try:
            manifest = tiles.build_tiles(cfg, series)
        except Exception as e:  # noqa: BLE001 - the overview still works
            print_warning(f"preprocess: tile pyramid failed ({e!r}); the "
                          "board serves the overview only")
    t2 = time.perf_counter()
    meta = report_meta(cfg, time_base)
    if manifest is not None:
        meta["tiles"] = manifest
    path = cfg.path("report.js")
    series_to_report_js(series, path, cfg.viz_downsample_to, meta)
    t3 = time.perf_counter()
    if tel is not None:
        now = time.time()
        tel.add_span("tiles", "stage", now - (t3 - t1), t2 - t1)
        tel.add_span("report_js", "stage", now - (t3 - t2), t3 - t2)
    print_progress(
        f"board data: {len(series)} series in {t1 - t0:.3f} s, tiles in "
        f"{t2 - t1:.3f} s, report.js ({os.path.getsize(path)} bytes) in "
        f"{t3 - t2:.3f} s")


def load_frames(cfg: SofaConfig, only=None) -> Dict[str, pd.DataFrame]:
    """The frames a previous preprocess wrote (``only`` these names, else
    all), each from its chunk store, parquet file or CSV
    (``trace.read_frame``); missing ones are skipped."""
    out = {}
    for name in frame_names() if only is None else only:
        df = read_frame(cfg.path(name))
        if df is not None:
            out[name] = df
    return out
