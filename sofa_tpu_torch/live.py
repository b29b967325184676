"""``live``: streaming ingest over a growing logdir (the JAX package's
``sofa_tpu/live.py``).

Every other verb is batch: nothing shows until ``record`` ends.  ``live``
is an epoch loop over a logdir the collectors are still writing: each
epoch tails the raw files from a committed byte offset, folds in only the
new whole records, and refreshes the frames, the tiles, the passes and
``report.js``, so that the board grows while the job runs.

* **The offset ledger**, ``_live_offsets.json`` (schema
  ``sofa_tpu/live_offsets`` v1): per source the committed byte offset,
  the chunk table, a signature of the file's head, and the stall clocks.
  It is the epoch's commit point, written fsync'd and last: chunk files
  come before it and the journal's ``commit`` after it.  A kill at any
  instant leaves the old ledger (the epoch replays) or the new one.
* **Torn tails**: an epoch consumes new bytes only up to the last newline
  (``whole_records``); a half-flushed record waits for the next epoch.
* **Chunks**: each committed ``[start, end)`` range parses once into the
  chunk store (``ingest/cache.ChunkStore``); later epochs and replays load
  it.  ``chunks_parsed`` and ``chunks_loaded`` in ``meta.live`` count both.
  Past ``CHUNK_COMPACT_COUNT`` chunks a source compacts into one, by load
  and store only.
* **Rotation**: a file that shrank or whose head changed (or a
  ``<source>:rotate`` fault) is read again from byte 0; its chunks go.
* **Stalls**: a source that stops growing for ``--live_stall_s`` while
  another streams is ``stalled`` (``supervisor.GrowthWatermark``); when
  every source is quiet they are all ``idle``.
* **Convergence**: ``live --drain`` is the batch ``preprocess`` +
  ``analyze`` itself.  Live tile indexes carry no batch key, so the batch
  build rebuilds them from scratch and the drained outputs equal a batch
  run's byte for byte.

The tailed sources are those whose parser is a pure function of each
record: ``strace``, ``pystacks``, ``cpuinfo`` and ``gpumon``
(``TAILABLE_SOURCES``).  Each gpumon file (``gpumon.txt``,
``gpumon.rank<r>.txt``, ``gpumon.pid<pid>.txt``) is a source of its own,
named after the file, and the frame is assembled by
``gpumon_parse.combine_gpumon``, which renumbers a rank file's card over
the whole file as batch does.  The sampler renames a pid file to its
rank's name once the process joins a group: a source whose file vanished
hands its ledger entry and chunks to a new file with the same committed
head, or else drops them, so that no row counts twice.  Every other
source (the samplers with state, perf, pcap, blktrace, the Kineto
capture) is rescanned through the whole-source ingest cache; a Kineto
capture lands whole (the tracer writes it by tmp+rename, and only
``*.json`` is read).

Every derived write of an epoch is atomic and no epoch raises the
``derived_write_guard`` sentinel, so ``viz`` serves the last committed
generation while an epoch runs.  Passes re-run only where their declared
inputs changed (``registry.select_for_dirty``), and tiles only where
their window reaches the new suffix (``tiles.build_tiles_live``).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, Optional

import pandas as pd

from sofa_tpu_torch import faults, pool
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.printing import print_error, print_progress, print_warning

OFFSETS_NAME = "_live_offsets.json"
OFFSETS_SCHEMA = "sofa_tpu/live_offsets"
OFFSETS_VERSION = 1

# Bytes of a file's head that sign it: different bytes there under the
# same name are a rotated file, not an append.  The signature covers the
# committed bytes only (at most this many), so a file younger than this
# does not look rotated when it grows.
_HEAD_SIG_BYTES = 256

# Committed chunks of a source before they compact into one.
CHUNK_COMPACT_COUNT = 64

# The per-source statuses of ``meta.live.sources``.
LIVE_SOURCE_STATUSES = ("streaming", "idle", "stalled", "rotated", "torn",
                        "absent")

# The ingest sources the tailer owns; the rest are rescanned.
TAILABLE_SOURCES = ("strace", "pystacks", "cpuinfo", "gpumon")


def _gpumon_source(path: str) -> str:
    """A gpumon file's source name: its name without ``.txt``."""
    return os.path.basename(path)[:-len(".txt")]


def _tail_sources(cfg: SofaConfig) -> List[tuple]:
    """(source, raw path, parser of text and time base) of every tailed
    source, the gpumon files in ``gpumon_files`` order."""
    from sofa_tpu_torch.ingest import procfs, strace_parse
    from sofa_tpu_torch.ingest.gpumon_parse import gpumon_files, parse_gpumon

    def p_strace(text, tb):
        return strace_parse.parse_strace(text, time_base=tb,
                                         min_time=cfg.strace_min_time)

    def p_pystacks(text, tb):
        return strace_parse.parse_pystacks(text, time_base=tb)

    def p_cpuinfo(text, tb):
        return procfs.parse_cpuinfo(text, time_base=tb)

    out = [("strace", cfg.path("strace.txt"), p_strace),
           ("pystacks", cfg.path("pystacks.txt"), p_pystacks),
           ("cpuinfo", cfg.path("cpuinfo.txt"), p_cpuinfo)]
    out += [(_gpumon_source(p), p, parse_gpumon)
            for p in gpumon_files(cfg.logdir)]
    return out


# --- the offset ledger --------------------------------------------------------

class OffsetLedger:
    """The fsync'd per-source offsets: the commit point of an epoch.
    Everything in it derives from the raw files; losing it costs a
    reparse, never data."""

    def __init__(self, logdir: str):
        self.path = os.path.join(logdir, OFFSETS_NAME)
        self.doc: dict = {
            "schema": OFFSETS_SCHEMA, "version": OFFSETS_VERSION,
            "epoch": 0, "updated_unix": 0.0, "time_base": None,
            "watermark_s": None, "sources": {}, "growth": {},
            "features_rows": 0,
        }

    @classmethod
    def load(cls, logdir: str) -> "OffsetLedger":
        """The committed ledger; a missing or torn one starts from byte 0,
        and so does a foreign one, with a warning."""
        ledger = cls(logdir)
        try:
            with open(ledger.path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return ledger
        if not isinstance(doc, dict) or doc.get("schema") != OFFSETS_SCHEMA \
                or doc.get("version") != OFFSETS_VERSION:
            print_warning(f"live: {OFFSETS_NAME} is not a v{OFFSETS_VERSION}"
                          " offset ledger; starting from byte 0")
            return ledger
        ledger.doc.update(doc)
        return ledger

    def source(self, name: str) -> dict:
        return self.doc["sources"].setdefault(
            name, {"offset": 0, "chunks": [], "head_sha": None,
                   "events": 0})

    def reset_source(self, name: str) -> dict:
        self.doc["sources"][name] = {"offset": 0, "chunks": [],
                                     "head_sha": None, "events": 0}
        return self.doc["sources"][name]

    def commit(self) -> None:
        from sofa_tpu_torch.trace import atomic_write

        self.doc["updated_unix"] = round(time.time(), 3)
        try:
            with atomic_write(self.path, fsync=True) as f:
                json.dump(self.doc, f, indent=1, sort_keys=True)
        except OSError as e:
            print_warning(f"live: cannot write {self.path}: {e}; the next "
                          "epoch tails this one's bytes again")


# --- the tailer ---------------------------------------------------------------

def _read_range(path: str, start: int, end: int) -> Optional[bytes]:
    try:
        with open(path, "rb") as f:
            f.seek(start)
            return f.read(max(end - start, 0))
    except OSError:
        return None


def _head_sig(path: str, offset: int) -> Optional[str]:
    """sha1 of the file's first min(_HEAD_SIG_BYTES, offset) bytes; None
    when it cannot be read or is shorter than that."""
    n = min(_HEAD_SIG_BYTES, int(offset))
    head = _read_range(path, 0, n)
    if head is None or len(head) < n:
        return None
    return hashlib.sha1(head).hexdigest()


def whole_records(buf: bytes) -> bytes:
    """The prefix of ``buf`` that ends at its last newline: a half-flushed
    final record is never parsed."""
    idx = buf.rfind(b"\n")
    return buf[:idx + 1] if idx >= 0 else b""


class _TailOutcome:
    """One source's epoch: its cumulative frame, its ``meta.live`` row and
    whether anything changed."""

    def __init__(self):
        self.frame: Optional[pd.DataFrame] = None
        self.dirty = False
        self.info: dict = {"status": "idle", "offset": 0, "lag_bytes": 0,
                           "chunks": 0, "chunks_parsed": 0,
                           "chunks_loaded": 0, "events": 0}


def _parse(parser, buf: bytes, time_base: float) -> pd.DataFrame:
    return parser(buf.decode("utf-8", errors="replace"), time_base)


def _tail_source(ledger: OffsetLedger, chunks, source: str, path: str,
                 parser, time_base: float, epoch: int,
                 watermark) -> _TailOutcome:
    """One epoch of one source: detect a rotation, back off a torn tail,
    parse exactly the new whole records, and assemble the source's frame
    from its committed chunks (loads, not parses)."""
    from sofa_tpu_torch.trace import _conform, empty_frame

    out = _TailOutcome()
    entry = ledger.source(source)
    spec = faults.maybe_stream_fault(source, epoch)
    kind = spec.kind if spec is not None else None
    try:
        size = os.path.getsize(path)
    except OSError:
        size = -1
    if size < 0 and not entry["chunks"]:
        out.info["status"] = "absent"
        out.frame = empty_frame()
        return out

    if size >= 0:
        offset = int(entry["offset"])
        rotated = (kind == "rotate" or size < offset
                   or (offset > 0 and entry["head_sha"] is not None
                       and _head_sig(path, offset) != entry["head_sha"]))
        if rotated:
            print_warning(f"live: {os.path.basename(path)} rotated; "
                          f"reading {source} again from byte 0 (its "
                          "committed chunks dropped)")
            chunks.drop(source)
            entry = ledger.reset_source(source)
            out.info["status"] = "rotated"
            out.dirty = True

    start = int(entry["offset"])
    end = size if size >= 0 else start
    if kind == "stall":
        end = start            # the source freezes for this epoch
    elif kind == "tail_truncate":
        end = start + (end - start) // 2
    new_rows = 0
    if end > start:
        buf = _read_range(path, start, end)
        if buf and kind == "tail_torn":
            buf = buf[:-min(7, len(buf))]       # cut mid-record
        consumed = whole_records(buf or b"")
        if consumed:
            t0 = time.perf_counter()
            try:
                df = _parse(parser, consumed, time_base)
            except Exception as e:  # noqa: BLE001 - this source only
                print_warning(f"live: {source} chunk parse failed ({e!r}); "
                              "the chunk stays unconsumed")
                df = None
            if df is not None:
                cend = start + len(consumed)
                chunks.store(source, start, cend, df)
                entry["chunks"].append([start, cend, int(len(df))])
                entry["offset"] = cend
                entry["events"] = int(entry.get("events", 0) + len(df))
                new_rows = len(df)
                out.dirty = True
                out.info["chunks_parsed"] += 1
                out.info["parse_wall_s"] = round(time.perf_counter() - t0, 6)
        elif buf:
            out.info["status"] = "torn"
    if size >= 0 and entry["offset"] > 0 and (
            entry["head_sha"] is None or start < _HEAD_SIG_BYTES):
        # the signature covers the committed head, up to its full length
        entry["head_sha"] = _head_sig(path, entry["offset"])

    # the cumulative frame: committed chunks load; the fresh one too
    parts: List[pd.DataFrame] = []
    for s, e, _rows in entry["chunks"]:
        df = chunks.load(source, s, e)
        if df is None:
            # a missing or unreadable chunk: derive exactly its range
            rbuf = _read_range(path, s, e)
            if rbuf is None:
                continue
            try:
                df = _parse(parser, rbuf, time_base)
            except Exception as e2:  # noqa: BLE001 - this source only
                print_warning(f"live: {source} chunk re-derive failed "
                              f"({e2!r})")
                continue
            chunks.store(source, s, e, df)
            out.info["chunks_parsed"] += 1
        else:
            out.info["chunks_loaded"] += 1
        if len(df):
            parts.append(df)
    if len(entry["chunks"]) > CHUNK_COMPACT_COUNT and parts:
        # one merged chunk replaces the table: load and store, no parse
        merged = pd.concat(parts, ignore_index=True)
        s0, e1 = int(entry["chunks"][0][0]), int(entry["chunks"][-1][1])
        if chunks.store(source, s0, e1, merged):
            for s, e, _r in entry["chunks"]:
                if (s, e) != (s0, e1):
                    chunks.discard(source, s, e)
            entry["chunks"] = [[s0, e1, int(len(merged))]]
    out.frame = _conform(pd.concat(parts, ignore_index=True) if parts
                         else empty_frame())
    out.info["events"] = int(len(out.frame))
    out.info["offset"] = int(entry["offset"])
    out.info["chunks"] = len(entry["chunks"])
    out.info["lag_bytes"] = int(max(size - entry["offset"], 0)) \
        if size >= 0 else 0
    if out.info["status"] == "idle":
        if new_rows:
            out.info["status"] = "streaming"
            watermark.update(source, max(size, 0), time.time())
        else:
            # an injected stall freezes the size the clock sees, so its
            # window elapses even while the file grows underneath
            seen = int(entry["offset"]) if kind == "stall" else max(size, 0)
            grown = watermark.update(source, seen, time.time())
            if grown == "stalled":
                out.info["status"] = "stalled"
    return out


def _follow_renames(ledger: OffsetLedger, chunks, sources) -> bool:
    """A gpumon source whose file vanished: hand its ledger entry and
    chunks to a file not yet in the ledger whose head matches its
    committed head (the sampler's pid -> rank rename), else drop them
    (the rows left with the file, as batch would see).  Returns whether
    any entry moved or went."""
    present = {name: path for name, path, _p in sources}
    changed = False
    for name in sorted(ledger.doc["sources"]):
        if not name.startswith("gpumon") or name in present and \
                os.path.isfile(present[name]):
            continue
        entry = ledger.doc["sources"][name]
        offset = int(entry.get("offset", 0))
        if not offset and not entry.get("chunks"):
            continue        # a file not seen yet: nothing committed
        heir = None
        for new, path in present.items():
            if new.startswith("gpumon") and new not in ledger.doc["sources"] \
                    and offset > 0 and os.path.isfile(path) \
                    and os.path.getsize(path) >= offset \
                    and _head_sig(path, offset) == entry.get("head_sha"):
                heir = new
                break
        del ledger.doc["sources"][name]
        if heir is not None and chunks.rename(name, heir):
            ledger.doc["sources"][heir] = entry
            print_progress(f"live: {name}.txt became {heir}.txt; its "
                           "committed chunks follow it")
        else:
            chunks.drop(name)
            print_warning(f"live: {name}.txt is gone; its committed rows "
                          "go with it")
        changed = True
    return changed


# --- the epoch ----------------------------------------------------------------

def _inject_previous_features(cfg: SofaConfig, features, selected) -> int:
    """Seed ``features`` with the previous epoch's rows of every enabled
    pass outside the window (its inputs did not change, so its features
    still hold); rows a selected pass provides are left to it."""
    from fnmatch import fnmatchcase

    from sofa_tpu_torch.analysis import registry

    path = cfg.path("features.csv")
    if not os.path.isfile(path):
        return 0
    try:
        prev = pd.read_csv(path)
    except Exception as e:  # noqa: BLE001 - a torn table seeds nothing
        print_warning(f"live: cannot read the previous features.csv ({e})")
        return 0
    specs = [s for s in registry.registered() if s.enabled(cfg)]
    kept = [p for s in specs if s.name not in selected
            for p in s.provides_features]
    fresh = [p for s in specs if s.name in selected
             for p in s.provides_features]
    n = 0
    for name, value in zip(prev.get("name", []), prev.get("value", [])):
        name = str(name)
        if any(fnmatchcase(name, p) for p in fresh):
            continue
        if any(fnmatchcase(name, p) for p in kept):
            try:
                features.add(name, float(value))
                n += 1
            except (TypeError, ValueError):
                continue
    return n


def _write_frame_atomic(cfg: SofaConfig, df: pd.DataFrame, name: str,
                        fmt: str) -> None:
    """A frame of a live epoch, readable at every instant: the chunk
    store or parquet file (each written by tmp+rename; a columnar store
    rewrites only the chunks whose content changed), then the board's
    downsampled ``<name>.csv`` by tmp+rename.  In csv mode the whole CSV
    is written by tmp+rename and the other formats' files go."""
    from sofa_tpu_torch import frames as framestore
    from sofa_tpu_torch.trace import (atomic_replace, downsample, write_csv,
                                      write_frame)

    base = cfg.path(name)
    if fmt == "csv":
        with atomic_replace(base + ".csv") as tmp:
            write_csv(df, tmp)
        framestore.delete_frame_store(cfg.logdir, name)
        if os.path.isfile(base + ".parquet"):
            os.unlink(base + ".parquet")
        return
    path, _stats = write_frame(df, base, fmt)
    if path == base + ".csv":
        return          # the store refused the frame: the CSV is it whole
    with atomic_replace(base + ".csv") as tmp:
        write_csv(downsample(df, cfg.viz_downsample_to), tmp)


def _run_epoch(cfg: SofaConfig, ledger: OffsetLedger) -> dict:
    """One epoch; returns the ``meta.live`` it recorded."""
    from sofa_tpu_torch import durability, telemetry
    from sofa_tpu_torch.analysis import advice, registry
    from sofa_tpu_torch.analysis.features import Features
    from sofa_tpu_torch.analyze import stage_board
    from sofa_tpu_torch.collectors.kineto import merge_rank_topology
    from sofa_tpu_torch.ingest.cache import (CACHE_DIR_NAME, IngestCache,
                                             make_key, raw_files_present)
    from sofa_tpu_torch.ingest.gpumon_parse import combine_gpumon
    from sofa_tpu_torch.preprocess import (_ingest_tasks, _run_ingest,
                                           assemble_frames, build_series,
                                           frame_names, read_misc,
                                           read_time_base, report_meta)
    from sofa_tpu_torch.supervisor import GrowthWatermark
    from sofa_tpu_torch.trace import (atomic_replace, reap_stale_sentinel,
                                      resolve_trace_format,
                                      series_to_report_js)

    reap_stale_sentinel(cfg.logdir)
    epoch = int(ledger.doc["epoch"]) + 1
    first = ledger.doc["epoch"] == 0
    tel = telemetry.begin("live")
    journal = durability.Journal(cfg.logdir)
    journal.begin("live", key=durability.logdir_raw_key(cfg.logdir),
                  epoch=epoch)
    try:
        time_base = read_time_base(cfg)
        cache = IngestCache(cfg.path(CACHE_DIR_NAME),
                            enabled=cfg.ingest_cache)
        chunks = cache.chunks()
        if ledger.doc.get("time_base") is not None \
                and ledger.doc["time_base"] != time_base:
            print_warning("live: sofa_time.txt changed; the committed "
                          "chunks were parsed against the old time base, "
                          "so every source is read again from byte 0")
            for name in list(ledger.doc["sources"]):
                chunks.drop(name)
                ledger.reset_source(name)
        ledger.doc["time_base"] = time_base
        merge_rank_topology(cfg.logdir)     # the ranks' records, as batch
        jobs = pool.cfg_jobs(cfg)
        tel.set_meta(pool={"jobs": jobs, "cpu_count": os.cpu_count() or 1})
        cpu_off = cfg.cpu_time_offset_ms / 1e3
        watermark = GrowthWatermark.from_doc(cfg.live_stall_s,
                                             ledger.doc.get("growth"))

        # --- tail -------------------------------------------------------
        dirty: set = set()
        live_sources: Dict[str, dict] = {}
        tail_frames: Dict[str, pd.DataFrame] = {}
        gpumon_parts: List[tuple] = []
        sources = _tail_sources(cfg)
        with tel.span("tail", cat="stage"):
            if _follow_renames(ledger, chunks, sources):
                dirty.add("gpumon")
            for source, path, parser in sources:
                o = _tail_source(ledger, chunks, source, path, parser,
                                 time_base, epoch, watermark)
                live_sources[source] = o.info
                frame = "gpumon" if source.startswith("gpumon") else source
                if o.dirty:
                    dirty.add(frame)
                if frame == "gpumon":
                    gpumon_parts.append((path, o.frame))
                else:
                    tail_frames[source] = o.frame
                tel.source_event(
                    source,
                    status=("parsed" if o.info["chunks_parsed"] else
                            "cached" if o.info["events"] else "empty"),
                    cache=("bypass" if not chunks.enabled else
                           "miss" if o.info["chunks_parsed"] else "hit"),
                    wall_s=o.info.get("parse_wall_s", 0.0),
                    events=o.info["events"])
        tail_frames["gpumon"] = combine_gpumon(gpumon_parts)
        if cpu_off:
            tail_frames = {n: df.assign(timestamp=df["timestamp"] + cpu_off)
                           if not df.empty else df
                           for n, df in tail_frames.items()}
        # `stalled` is wedged while siblings stream: with every source
        # quiet the job is done or idle, not degraded
        if not any(i["status"] == "streaming" for i in live_sources.values()):
            for i in live_sources.values():
                if i["status"] == "stalled":
                    i["status"] = "idle"
        ledger.doc["growth"] = watermark.to_doc()

        # --- rescan the rest through the whole-source cache ---------------
        rescan = {t.name for t in _ingest_tasks(cfg, time_base)
                  if t.name not in TAILABLE_SOURCES}
        with tel.span("ingest", cat="stage"):
            tasks, results, cache = _run_ingest(cfg, time_base, jobs, tel,
                                                only=rescan)
        rescanned = assemble_frames(cfg, tasks, results)
        for t in tasks:
            keyed = raw_files_present(make_key(t.name, t.raw_paths,
                                               t.params))
            if t.name not in cache.hits and (keyed or not cache.enabled):
                dirty.update(t.frame_names)
        frames = {n: tail_frames[n] if n in tail_frames else rescanned[n]
                  for n in frame_names()}
        if first:
            dirty = set(frames)

        # --- refresh the derived files, each by tmp+rename -----------------
        meta_live: dict = {"active": True, "epoch": epoch,
                           "updated_unix": round(time.time(), 3),
                           "interval_s": cfg.live_interval_s,
                           "sources": live_sources,
                           "dirty": sorted(dirty)}
        marks = [float(df["timestamp"].max())
                 for df in tail_frames.values() if len(df)]
        meta_live["watermark_s"] = round(min(marks), 6) if marks else None
        ledger.doc["watermark_s"] = meta_live["watermark_s"]
        meta_live["tiles"] = {"rebuilt": 0, "kept": 0, "full_rebuilds": 0}
        meta_live["passes"] = {"ran": 0, "skipped_clean": 0}
        if dirty:
            fmt = resolve_trace_format(cfg)
            with tel.span("write_frames", cat="stage", format=fmt):
                pool.thread_map(
                    lambda n: _write_frame_atomic(cfg, frames[n], n, fmt),
                    sorted(dirty), jobs)
            series = build_series(cfg, frames)
            manifest = None
            if cfg.enable_tiles:
                from sofa_tpu_torch import tiles

                with tel.span("tiles", cat="stage"):
                    try:
                        manifest, tstats = tiles.build_tiles_live(
                            cfg, series, jobs=jobs)
                        meta_live["tiles"] = {
                            k: int(tstats[k])
                            for k in ("rebuilt", "kept", "full_rebuilds")}
                    except Exception as e:  # noqa: BLE001 - the overview stays
                        print_warning(f"live: tile refresh failed ({e!r}); "
                                      "the board serves the overview only")

            # the passes, on the dirty window
            registry.load_builtin_passes()
            misc = read_misc(cfg)
            features = Features()
            features.add("elapsed_time",
                         float(misc.get("elapsed_time", 0) or 0))
            select = None
            if not first:
                select = registry.select_for_dirty(cfg, dirty)
                _inject_previous_features(cfg, features, select)
            with tel.span("passes", cat="stage"):
                ledger_passes, extra = registry.run_passes(
                    frames, cfg, features, tel=tel, select=select)
            tel.set_meta(passes=ledger_passes)
            entries = ledger_passes["passes"].values()
            statuses = [e.get("status") for e in entries]
            meta_live["passes"] = {
                "ran": statuses.count("ok") + statuses.count("failed"),
                "skipped_clean": sum(
                    1 for e in entries
                    if "unchanged" in str(e.get("skip_reason", "")))}
            if not features.get("num_cores") and misc.get("cores"):
                features.add("num_cores", int(misc["cores"]))
            with atomic_replace(cfg.path("features.csv")) as tmp:
                features.save(tmp)

            with tel.span("report_js", cat="stage"):
                meta = report_meta(cfg, time_base)
                meta["live"] = {"epoch": epoch, "active": True}
                if manifest is not None:
                    meta["tiles"] = manifest
                series_to_report_js(series + list(extra),
                                    cfg.path("report.js"),
                                    cfg.viz_downsample_to, meta)
            with tel.span("hints", cat="stage"):
                advice.hint_report(features, cfg)
            if first:
                stage_board(cfg)

        meta_live["chunks_parsed"] = sum(
            s["chunks_parsed"] for s in live_sources.values())
        meta_live["chunks_loaded"] = sum(
            s["chunks_loaded"] for s in live_sources.values())
        tel.set_meta(live=meta_live, ingest_cache=cache.stats())
        ledger.doc["epoch"] = epoch
        ledger.commit()
        tel.write(cfg.logdir, rc=0, cfg=cfg)
        if dirty:
            with tel.span("digests", cat="stage"):
                durability.write_digests(cfg.logdir)
        journal.commit("live", key=durability.logdir_raw_key(cfg.logdir),
                       epoch=epoch)
        n_streaming = sum(1 for s in live_sources.values()
                          if s["status"] == "streaming")
        print_progress(
            f"live epoch {epoch}: {n_streaming} source(s) streaming, "
            f"{meta_live['chunks_parsed']} chunk(s) parsed, "
            f"{meta_live['chunks_loaded']} loaded, tiles "
            f"{meta_live['tiles']['rebuilt']} rebuilt / "
            f"{meta_live['tiles']['kept']} kept, passes "
            f"{meta_live['passes']['ran']} ran / "
            f"{meta_live['passes']['skipped_clean']} clean")
        return meta_live
    finally:
        telemetry.end(tel)


# --- the verb -----------------------------------------------------------------

def _drain(cfg: SofaConfig) -> int:
    """Converge to the batch output: a whole ``preprocess`` + ``analyze``
    (live tile indexes carry no batch key, so every pyramid rebuilds
    through the batch path), then mark ``meta.live`` drained."""
    from sofa_tpu_torch.analyze import sofa_analyze
    from sofa_tpu_torch.durability import _patch_manifest
    from sofa_tpu_torch.preprocess import sofa_preprocess
    from sofa_tpu_torch.telemetry import load_manifest

    print_progress("live: draining through the batch preprocess and "
                   "analyze")
    sofa_analyze(cfg, sofa_preprocess(cfg))
    doc = load_manifest(cfg.logdir) or {}
    live_meta = dict((doc.get("meta") or {}).get("live") or {})
    if live_meta:
        live_meta["active"] = False
        live_meta["drained"] = True
        _patch_manifest(cfg.logdir, meta={"live": live_meta})
    return 0


def sofa_live(cfg: SofaConfig, epochs: Optional[int] = None,
              drain: bool = False) -> int:
    """``live <logdir> [--live_epochs N] [--drain]``: the epoch loop (N
    epochs, 0 until interrupted), then the drain when asked; with
    ``--drain`` and no epoch budget, the drain alone.  Exit 0, 1 when the
    last epoch left a source stalled, 2 without the logdir."""
    if not os.path.isdir(cfg.logdir):
        print_error(f"logdir {cfg.logdir} does not exist: point `live` at "
                    "a recording, or at a directory collectors write into")
        return 2
    n = cfg.live_epochs if epochs is None else int(epochs)
    if drain and n == 0:
        return _drain(cfg)
    faults.install_from(cfg)
    last: dict = {}
    try:
        ledger = OffsetLedger.load(cfg.logdir)
        i = 0
        while n == 0 or i < n:
            i += 1
            last = _run_epoch(cfg, ledger)
            if n == 0 or i < n:
                time.sleep(max(cfg.live_interval_s, 0.0))
    except KeyboardInterrupt:
        print_progress("live: interrupted; the offset ledger holds the "
                       "committed state, and `live` resumes from it")
    finally:
        faults.clear()
    if drain:
        return _drain(cfg)
    stalled = sorted(name for name, s in (last.get("sources") or {}).items()
                     if s.get("status") == "stalled")
    if stalled:
        print_warning("live: stalled source(s) at exit: "
                      + ", ".join(stalled) + "; their series end early, the "
                      "other sources kept streaming")
        return 1
    return 0
