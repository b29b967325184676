"""Self-telemetry: the profiler's own run, made legible (the JAX package's
``sofa_tpu/telemetry.py``).

Every pipeline verb records spans and counters and lands two files in the
logdir:

``run_manifest.json``, the health ledger, the same document the JAX
package writes (schema ``sofa_tpu/run_manifest``, version 5)::

    schema / schema_version   "sofa_tpu/run_manifest" / 5
    generated_unix            last write time
    runs.<verb>               started_unix, wall_s, rc, counters
                              (warnings/errors), warning_tail
    env                       python/platform/host/cpu snapshot and the
                              SOFA_* variables that shape a run
    config                    the SofaConfig of the writing verb
    digests                   sha256, bytes, mtime_ns and kind (raw or
                              derived) of every artifact, refreshed by each
                              verb (``durability.py``; ``_digests.json`` is
                              the fsync'd copy ``fsck`` reads first)
    meta                      pool sizing, ingest-cache stats, disk budget,
                              ``frames`` (the frames' format, chunks
                              written and reused, bytes, CSV fallbacks),
                              ``fsck`` (the last fsck: ok, checked, counts
                              by verdict, repaired), and ``passes``: the
                              analysis-pass ledger (``analysis/
                              registry.py``: schedule, order, jobs, per
                              pass status in PASS_STATUSES, origin, wave,
                              wall_s, error or skip_reason), ``archive``
                              (the last ingest: run id, files, new
                              objects, bytes added, root, wall_s, the
                              index refresh), ``regress`` (verdict,
                              counts, the verdict file), and from
                              ``agent`` ``agent`` (spool, run, service,
                              push), ``serve`` (the service's ack),
                              ``tier``, ``metrics`` and ``health`` (the
                              client's endpoints and breakers)
    collectors.<name>         status (COLLECTOR_STATUSES), degraded flag
                              and reason, died/deaths/restarts (the
                              supervisor), timed_out and phase, exit_code,
                              bytes_captured, start/stop seq and walls
    sources.<name>            status (SOURCE_STATUSES), cache
                              (CACHE_OUTCOMES), wall_s, events, error,
                              quarantined_file
    stages                    flat span list {verb,name,cat,t0_unix,dur_s}

``sofa_self_trace.json``: the same spans in Chrome Trace Event Format (pid
1, one tid lane per verb, numbered as the JAX package's), with timestamps
in microseconds from the run's ``sofa_time.txt`` zero, so that the
pipeline's own run lines up with the workload's timeline.

Writes merge by verb: ``record`` then ``preprocess`` on one logdir build
one manifest, and a verb run again replaces its own sections only.  A
manifest of another schema or version is replaced whole, never merged.
``status`` renders the manifest as a health table and exits 1 when a
collector ended failed, killed, died, timed out or truncated by the disk
budget, an analysis pass failed, the last ``fsck`` found damage, or a
``live`` source stalled (2 when there is no manifest).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

from sofa_tpu_torch.concurrency import Guard
from sofa_tpu_torch.printing import print_error, print_title, print_warning

MANIFEST_NAME = "run_manifest.json"
SELF_TRACE_NAME = "sofa_self_trace.json"
MANIFEST_SCHEMA = "sofa_tpu/run_manifest"
# The JAX package's version: one document reads the same in both packages.
MANIFEST_VERSION = 5

COLLECTOR_STATUSES = ("probed", "started", "stopped", "failed", "skipped",
                      "killed", "died", "timed_out", "truncated_by_budget")
SOURCE_STATUSES = ("parsed", "cached", "degraded", "empty", "quarantined",
                   "failed")
CACHE_OUTCOMES = ("hit", "miss", "bypass")
# An analysis pass's outcome in meta.passes (analysis/registry.py runs them).
PASS_STATUSES = ("ok", "failed", "skipped")

# Terminal bad outcomes: sticky over the started/stopped that the
# epilogue still records afterwards.
_STICKY_STATUSES = ("failed", "killed", "died", "timed_out",
                    "truncated_by_budget")

# Environment variables that shape a run enough to belong in the snapshot.
_ENV_KEYS = ("SOFA_JOBS", "SOFA_PREPROCESS_POOL", "SOFA_FAULTS",
             "SOFA_SUPERVISOR_POLL_S", "CUDA_VISIBLE_DEVICES", "NO_COLOR")

# Self-trace lanes: one per verb, as parallel tracks of one process.
_SELF_TRACE_LANES = {"record": 1, "preprocess": 2, "analyze": 3,
                     "archive": 5, "regress": 6, "agent": 7}
_OTHER_LANE = 4

_WARNING_TAIL_MAX = 20

# The active-run stack: written by each verb's begin/end, read from
# collector and supervisor threads and pool workers.
_registry_lock = Guard("telemetry.registry", protects=("_active",))
_active: List["Telemetry"] = []


class Telemetry:
    """One verb's recorder.  Thread-safe: pool workers, collector threads
    and the supervisor report while the main thread runs.  Create with
    :func:`begin`, persist with :meth:`write`, release with :func:`end`."""

    def __init__(self, verb: str):
        self.verb = verb
        self.started_unix = time.time()
        self._lock = Guard("telemetry.run", protects=(
            "spans", "counters", "collectors", "sources", "meta",
            "warning_tail", "_seq"))
        self.spans: List[dict] = []
        self.counters: Dict[str, int] = {"warnings": 0, "errors": 0}
        self.collectors: Dict[str, dict] = {}
        self.sources: Dict[str, dict] = {}
        self.meta: Dict[str, object] = {}
        self.warning_tail: List[str] = []
        self._seq = 0

    # -- spans -------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, cat: str = "stage", **args):
        t0_unix = time.time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_span(name, cat, t0_unix, time.perf_counter() - t0,
                          **args)

    def add_span(self, name: str, cat: str, t0_unix: float, dur_s: float,
                 **args) -> None:
        with self._lock:
            self.spans.append({
                "verb": self.verb, "name": str(name), "cat": str(cat),
                "t0_unix": round(float(t0_unix), 6),
                "dur_s": round(max(float(dur_s), 0.0), 6),
                "args": args,
            })

    # -- counters / console ------------------------------------------------
    def console(self, level: str, msg: str) -> None:
        """A print_warning / print_error passed through this run."""
        key = "errors" if level == "error" else "warnings"
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + 1
            if key == "warnings" and \
                    len(self.warning_tail) < _WARNING_TAIL_MAX:
                self.warning_tail.append(str(msg)[:300])

    def next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    # -- ledgers -----------------------------------------------------------
    def collector_event(self, name: str, status: Optional[str] = None,
                        **fields) -> None:
        """Merge a lifecycle fact into the collector ledger.  ``degraded``
        is a flag, not a status; the terminal bad statuses are sticky over
        started/stopped, so the epilogue cannot whitewash them."""
        with self._lock:
            ent = self.collectors.setdefault(name, {"status": "probed"})
            if status == "degraded":
                ent["degraded"] = True
                if "reason" in fields:
                    ent["degraded_reason"] = fields.pop("reason")
            elif status is not None:
                sticky = ent.get("status") in _STICKY_STATUSES
                if not (sticky and status in ("started", "stopped")):
                    ent["status"] = status
            ent.update(fields)

    def source_event(self, name: str, **fields) -> None:
        with self._lock:
            self.sources.setdefault(name, {}).update(fields)

    def set_meta(self, **kw) -> None:
        with self._lock:
            self.meta.update(kw)

    # -- persistence -------------------------------------------------------
    def write(self, logdir: str, rc: Optional[int] = None,
              cfg=None) -> Optional[dict]:
        """Merge this run into ``run_manifest.json`` and the self trace.
        A failure to write is a warning, never an exception: telemetry
        must not fail the pipeline it observes."""
        from sofa_tpu_torch.trace import atomic_write

        try:
            os.makedirs(logdir, exist_ok=True)
            doc = load_manifest(logdir) or {}
            if doc.get("schema") != MANIFEST_SCHEMA or \
                    doc.get("schema_version") != MANIFEST_VERSION:
                doc = {}
            doc["schema"] = MANIFEST_SCHEMA
            doc["schema_version"] = MANIFEST_VERSION
            doc["generated_unix"] = round(time.time(), 3)
            with self._lock:
                doc.setdefault("runs", {})[self.verb] = {
                    "started_unix": round(self.started_unix, 3),
                    "wall_s": round(time.time() - self.started_unix, 6),
                    "rc": rc,
                    "counters": dict(self.counters),
                    "warning_tail": list(self.warning_tail),
                }
                doc["env"] = _env_snapshot()
                if cfg is not None:
                    doc["config"] = _config_snapshot(cfg)
                if self.meta:
                    doc.setdefault("meta", {}).update(
                        json.loads(json.dumps(self.meta)))
                if self.collectors:
                    doc["collectors"] = json.loads(
                        json.dumps(self.collectors))
                if self.sources:
                    doc["sources"] = json.loads(json.dumps(self.sources))
                stages = [s for s in doc.get("stages", [])
                          if s.get("verb") != self.verb]
                doc["stages"] = stages + list(self.spans)
            with atomic_write(os.path.join(logdir, MANIFEST_NAME)) as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            self._write_self_trace(logdir)
            return doc
        except (OSError, TypeError, ValueError) as e:
            print_warning(f"telemetry: cannot write {MANIFEST_NAME}: {e}")
            return None

    def _write_self_trace(self, logdir: str) -> None:
        from sofa_tpu_torch.trace import atomic_write

        path = os.path.join(logdir, SELF_TRACE_NAME)
        events: List[dict] = []
        other: Dict[str, object] = {}
        try:
            with open(path) as f:
                prev = json.load(f)
            other = dict(prev.get("otherData") or {})
            # keep other verbs' spans; the metadata is written anew
            events = [e for e in prev.get("traceEvents", [])
                      if e.get("ph") != "M"
                      and (e.get("args") or {}).get("verb") != self.verb]
        except (OSError, ValueError):
            pass
        zero = other.get("ts_zero_unix")
        if not isinstance(zero, (int, float)):
            zero = _read_time_base(logdir)
        with self._lock:
            spans = list(self.spans)
        if not isinstance(zero, (int, float)) or zero <= 0:
            t0s = [s["t0_unix"] for s in spans] or [self.started_unix]
            existing = [e["ts"] / 1e6 for e in events
                        if isinstance(e.get("ts"), (int, float))]
            zero = min(t0s) - (max(existing) if existing else 0.0)
        lane = _SELF_TRACE_LANES.get(self.verb, _OTHER_LANE)
        for s in spans:
            events.append({
                "name": s["name"], "ph": "X", "cat": s["cat"],
                "ts": round((s["t0_unix"] - zero) * 1e6, 3),
                "dur": round(s["dur_s"] * 1e6, 3),
                "pid": 1, "tid": lane,
                "args": {"verb": s["verb"], **(s.get("args") or {})},
            })
        meta = [{"name": "process_name", "ph": "M", "pid": 1,
                 "args": {"name": "sofa_tpu_torch self-trace"}}]
        for verb, tid in sorted(_SELF_TRACE_LANES.items(),
                                key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                         "tid": tid, "args": {"name": f"sofa {verb}"}})
        meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                     "tid": _OTHER_LANE, "args": {"name": "sofa other"}})
        doc = {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {**other, "ts_zero_unix": round(float(zero), 6),
                          "producer": "sofa_tpu_torch self-telemetry"},
        }
        with atomic_write(path) as f:
            json.dump(doc, f)


# --- run registry -----------------------------------------------------------

def begin(verb: str) -> Telemetry:
    """Open a run; pair with :func:`end` in a finally."""
    tel = Telemetry(verb)
    with _registry_lock:
        _active.append(tel)
    return tel


def end(tel: Telemetry) -> None:
    with _registry_lock:
        try:
            _active.remove(tel)
        except ValueError:
            pass


def current() -> Optional[Telemetry]:
    with _registry_lock:
        return _active[-1] if _active else None


def collector_event(name: str, status: Optional[str] = None,
                    **fields) -> None:
    """Forward to the innermost active run; a no-op outside one."""
    tel = current()
    if tel is not None:
        tel.collector_event(name, status, **fields)


def console_event(level: str, msg: str) -> None:
    """Called by print_warning / print_error: every active run counts it."""
    with _registry_lock:
        active = list(_active)
    for tel in active:
        tel.console(level, msg)


@contextlib.contextmanager
def maybe_span(name: str, cat: str = "stage", **args):
    """A span on the current run when one is active, else nothing."""
    tel = current()
    if tel is None:
        yield
        return
    with tel.span(name, cat, **args):
        yield


# --- snapshots --------------------------------------------------------------

def _env_snapshot() -> dict:
    import platform
    import socket
    import sys

    from sofa_tpu_torch import __version__

    return {
        "sofa_tpu_version": __version__,
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "hostname": socket.gethostname(),
        "cpu_count": os.cpu_count() or 1,
        "pid": os.getpid(),
        "vars": {k: os.environ[k] for k in _ENV_KEYS if k in os.environ},
    }


def _config_snapshot(cfg) -> dict:
    try:
        doc = dataclasses.asdict(cfg)
    except TypeError:               # not a dataclass (a stand-in in tests)
        return {}
    return json.loads(json.dumps(doc, default=str))


def _read_time_base(logdir: str) -> Optional[float]:
    try:
        with open(os.path.join(logdir, "sofa_time.txt")) as f:
            return float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None


def output_files(paths: List[str]) -> List[str]:
    """The files among ``paths``, directories walked (the Kineto
    collector lists its ``kineto/`` directory)."""
    files = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                files += [os.path.join(root, n) for n in sorted(names)]
        elif os.path.isfile(p):
            files.append(p)
    return files


def collector_bytes(paths: List[str]) -> int:
    """Bytes on disk across a collector's outputs (directories walked)."""
    total = 0
    for p in output_files(paths):
        try:
            total += os.path.getsize(p)
        except OSError:
            pass
    return total


# --- readers ----------------------------------------------------------------

def load_manifest(logdir: str) -> Optional[dict]:
    try:
        with open(os.path.join(logdir, MANIFEST_NAME)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def load_self_trace(logdir: str) -> Optional[dict]:
    try:
        with open(os.path.join(logdir, SELF_TRACE_NAME)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or \
            not isinstance(doc.get("traceEvents"), list):
        return None
    return doc


def manifest_warnings(doc: Optional[dict]) -> List[str]:
    """Health warnings from a manifest, which analyze folds into its
    hints as ``[self]`` lines (the JAX package's wording, line for line)."""
    if not doc:
        return []
    out: List[str] = []
    for name, ent in sorted((doc.get("collectors") or {}).items()):
        status = ent.get("status")
        if status == "died":
            code = ent.get("exit_code")
            out.append(f"collector {name} died mid-run"
                       + (f" (exit {code})" if code is not None else "")
                       + " and was not restarted — its series end early")
        elif status == "timed_out":
            phase = ent.get("phase") or "stop"
            out.append(f"collector {name} exceeded its {phase} deadline and "
                       "was abandoned — its series may be partial")
        elif status == "truncated_by_budget":
            out.append(f"collector {name} hit the disk budget and was "
                       "stopped — its series are truncated (raise "
                       "--disk_budget / --collector_disk_budget to keep "
                       "more)")
        elif status in ("failed", "killed"):
            detail = ent.get("error") or ent.get("phase") or ""
            out.append(f"collector {name} {status}"
                       + (f" ({detail})" if detail else "")
                       + " — its timeline series are missing or partial")
        elif ent.get("degraded"):
            why = ent.get("degraded_reason") or "reduced fidelity"
            out.append(f"collector {name} ran degraded: {why}")
        elif ent.get("died"):
            n = ent.get("restarts", 0)
            out.append(f"collector {name} died mid-run and was restarted "
                       f"{n}x — its series have a gap")
        if ent.get("output_stalled") and status not in ("died", "timed_out",
                                                        "failed", "killed"):
            out.append(f"collector {name} stopped producing output mid-run "
                       "while still alive — series may be incomplete")
        if ent.get("rotated_files") and status != "truncated_by_budget":
            out.append(f"collector {name} had {ent['rotated_files']} "
                       "output file(s) rotated away by the disk budget — "
                       "its oldest data is gone")
    for name, ent in sorted((doc.get("sources") or {}).items()):
        if ent.get("status") == "degraded":
            why = ent.get("error") or "parse failed"
            out.append(f"ingest source {name} degraded to an empty frame: "
                       f"{why}")
        elif ent.get("status") == "failed":
            why = ent.get("error") or "conversion tool failed"
            out.append(f"ingest source {name} failed: {why} — raw bytes "
                       "exist; re-run preprocess once the tool works")
        elif ent.get("status") == "quarantined":
            where = ent.get("quarantined_file") or "_quarantine/"
            out.append(f"ingest source {name} had corrupt raw input — "
                       f"quarantined to {where}; its series are empty "
                       "this run")
    passes = ((doc.get("meta") or {}).get("passes") or {}).get("passes")
    if isinstance(passes, dict):
        for name, ent in sorted(passes.items()):
            if ent.get("status") == "failed":
                why = ent.get("error") or "crashed"
                out.append(f"analysis pass {name} failed ({why}) — its "
                           "features and artifacts are missing this run; "
                           "`sofa passes` shows its contract")
    live_meta = (doc.get("meta") or {}).get("live")
    if isinstance(live_meta, dict):
        for name, ent in sorted((live_meta.get("sources") or {}).items()):
            if isinstance(ent, dict) and ent.get("status") == "stalled":
                out.append(f"live source {name} stalled — it stopped "
                           "growing while the other sources kept "
                           "streaming; its series end early")
    agent_meta = (doc.get("meta") or {}).get("agent")
    if isinstance(agent_meta, dict):
        push = agent_meta.get("push")
        if isinstance(push, dict) and push.get("status") != "pushed":
            where = agent_meta.get("service") or "the fleet service"
            out.append(
                f"the agent could not deliver this run to {where} "
                f"({push.get('status')}) — it is durable in the spool "
                f"({agent_meta.get('spool')}) and retries on the next "
                "agent pass")
    metrics_meta = (doc.get("meta") or {}).get("metrics")
    if isinstance(metrics_meta, dict):
        from sofa_tpu_torch import metrics as fleet_metrics

        age = metrics_meta.get("scrape_age_s")
        if isinstance(age, (int, float)) and \
                age > fleet_metrics.STALE_SCRAPE_S:
            out.append(
                f"the tier worker that committed this run had not "
                f"scraped its metrics for {age:.0f}s at commit time — "
                "its /v1/metrics view (and any SLO verdict) was stale; "
                "check the worker's scrape loop")
    slo_meta = (doc.get("meta") or {}).get("slo")
    if isinstance(slo_meta, dict) and slo_meta.get("ok") is False:
        names = ", ".join(str(n) for n in
                          (slo_meta.get("breaching") or [])) or "unknown"
        out.append(
            f"the tier was BREACHING its declared SLO ({names}) when "
            "this run committed — `status --fleet` shows the live "
            "verdict")
    fsck = (doc.get("meta") or {}).get("fsck")
    if isinstance(fsck, dict) and fsck.get("ok") is False:
        problems = fsck.get("problems") or {}
        detail = ", ".join(f"{v} {k}" for k, v in sorted(problems.items())
                           if isinstance(v, int) and v)
        out.append("the last `sofa fsck` found damaged artifacts"
                   + (f" ({detail})" if detail else "")
                   + " — run `sofa fsck --repair`")
    for verb, run in sorted((doc.get("runs") or {}).items()):
        counters = run.get("counters") or {}
        if counters.get("errors"):
            out.append(f"`sofa {verb}` logged {counters['errors']} "
                       "error line(s) — check the console output")
        rc = run.get("rc")
        if isinstance(rc, int) and rc != 0 and verb == "record":
            out.append(f"the profiled command exited rc={rc}")
    return out


def preprocess_summary(doc: Optional[dict]) -> Optional[str]:
    """One line from the manifest's preprocess stages."""
    if not doc:
        return None
    stages = {s["name"]: s for s in doc.get("stages", [])
              if s.get("verb") == "preprocess"}
    if not stages:
        return None
    sources = doc.get("sources") or {}
    cached = sum(1 for s in sources.values() if s.get("cache") == "hit")
    parts = []
    for name, label in (("ingest", "ingest"), ("write_frames", "write"),
                        ("tiles", "tiles"), ("report_js", "report")):
        if name in stages:
            parts.append(f"{label} {stages[name]['dur_s']:.2f}s")
    jobs = ((doc.get("meta") or {}).get("pool") or {}).get("jobs")
    line = "preprocess timing: " + ", ".join(parts)
    line += f" ({cached}/{len(sources)} sources cached"
    line += f", jobs={jobs})" if jobs else ")"
    return line


# --- `status` ---------------------------------------------------------------

def _fmt_bytes(n) -> str:
    if not isinstance(n, (int, float)):
        return "-"
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024 or unit == "GB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return "-"


def _table(rows: List[List[str]]) -> List[str]:
    if not rows:
        return []
    widths = [max(len(str(r[i])) for r in rows) for i in range(len(rows[0]))]
    return ["  ".join(str(c).ljust(w) for c, w in zip(r, widths)).rstrip()
            for r in rows]


def render_status(doc: dict, logdir: str) -> "tuple[List[str], int]":
    """(report lines, exit code): 1 when a collector ended in a terminal
    bad status, an analysis pass failed or the last fsck found damage."""
    lines: List[str] = []
    rc = 0
    runs = doc.get("runs") or {}
    lines.append(f"run manifest: {os.path.join(logdir, MANIFEST_NAME)} "
                 f"(schema v{doc.get('schema_version')})")
    for verb in ("record", "preprocess", "analyze"):
        run = runs.get(verb)
        if not run:
            continue
        counters = run.get("counters") or {}
        rc_txt = run.get("rc")
        lines.append(
            f"  {verb}: wall {run.get('wall_s', 0):.2f}s"
            + (f", rc={rc_txt}" if rc_txt is not None else "")
            + f", {counters.get('warnings', 0)} warning(s), "
            f"{counters.get('errors', 0)} error(s)")
    for verb in sorted(set(runs) - {"record", "preprocess", "analyze"}):
        lines.append(f"  {verb}: wall {runs[verb].get('wall_s', 0):.2f}s")
    digests = doc.get("digests")
    if isinstance(digests, dict) and isinstance(digests.get("files"), dict):
        line = (f"  integrity: {len(digests['files'])} artifact(s) "
                f"digested ({digests.get('algo', 'sha256')}; "
                "`sofa fsck` verifies)")
        fsck = (doc.get("meta") or {}).get("fsck")
        if isinstance(fsck, dict):
            if fsck.get("ok"):
                line += " — last fsck: healthy"
            else:
                probs = fsck.get("problems") or {}
                n = sum(v for v in probs.values() if isinstance(v, int))
                line += f" — last fsck: {n} problem(s)"
                rc = 1
        lines.append(line)
    passes = (doc.get("meta") or {}).get("passes")
    if isinstance(passes, dict) and isinstance(passes.get("passes"), dict):
        ledger = passes["passes"]
        n_failed = sum(1 for e in ledger.values()
                       if e.get("status") == "failed")
        n_clean = sum(1 for e in ledger.values()
                      if e.get("status") == "skipped"
                      and "unchanged" in str(e.get("skip_reason", "")))
        n_skipped = sum(1 for e in ledger.values()
                        if e.get("status") == "skipped") - n_clean
        line = (f"  analysis passes: {len(ledger)} registered, "
                f"{len(ledger) - n_failed - n_skipped - n_clean} ok")
        if n_failed:
            line += f", {n_failed} FAILED"
            rc = 1
        if n_clean:
            line += f", {n_clean} clean (live incremental)"
        if n_skipped:
            line += f", {n_skipped} skipped (gated off)"
        line += " (`sofa passes` shows the DAG)"
        lines.append(line)
    live_meta = (doc.get("meta") or {}).get("live")
    if isinstance(live_meta, dict):
        srcs = [e for e in (live_meta.get("sources") or {}).values()
                if isinstance(e, dict)]
        n_stream = sum(1 for e in srcs if e.get("status") == "streaming")
        n_stall = sum(1 for e in srcs if e.get("status") == "stalled")
        line = (f"  live: epoch {live_meta.get('epoch')} "
                f"{'active' if live_meta.get('active') else 'drained'}, "
                f"{n_stream} source(s) streaming")
        if n_stall:
            line += f", {n_stall} STALLED"
            rc = 1
        wm = live_meta.get("watermark_s")
        if isinstance(wm, (int, float)):
            line += f", watermark {wm:.3f}s"
        lines.append(line)
    archive = (doc.get("meta") or {}).get("archive")
    if isinstance(archive, dict):
        lines.append(
            f"  archive: run {str(archive.get('run', '?'))[:12]} — "
            f"{archive.get('files', 0)} file(s), "
            f"{archive.get('new_objects', 0)} new object(s), "
            f"{_fmt_bytes(archive.get('bytes_added'))} added -> "
            f"{archive.get('root', '?')}")
    regress = (doc.get("meta") or {}).get("regress")
    if isinstance(regress, dict):
        counts = regress.get("counts") or {}
        lines.append(
            f"  regress: {regress.get('verdict', '?')} ("
            + ", ".join(f"{counts.get(v, 0)} {v}"
                        for v in ("regressed", "improved", "noise"))
            + f") ({regress.get('out', '?')})")
    agent_meta = (doc.get("meta") or {}).get("agent")
    if isinstance(agent_meta, dict):
        push = agent_meta.get("push") or {}
        line = (f"  fleet: run {str(agent_meta.get('run') or '?')[:12]} "
                f"{push.get('status') or 'spooled (no service)'}")
        serve_meta = (doc.get("meta") or {}).get("serve")
        if isinstance(serve_meta, dict):
            line += (f" -> {serve_meta.get('url')} "
                     f"(tenant {serve_meta.get('tenant')})")
        elif agent_meta.get("spool"):
            line += f" (spool {agent_meta['spool']})"
        lines.append(line)
    whatif = (doc.get("meta") or {}).get("whatif")
    if isinstance(whatif, dict):
        pred = whatif.get("predicted_step_time_s")
        lines.append(
            f"  what-if: {whatif.get('verdict', '?')} over "
            f"{whatif.get('n_steps', 0)} step(s), "
            f"{whatif.get('scenarios', 0)} scenario(s)"
            + (f", predicted step {pred * 1e3:.3f} ms"
               if isinstance(pred, (int, float)) else "")
            + f" ({whatif.get('report', '?')})")
    from sofa_tpu_torch.record import VERB_FILES

    held = [n for n in VERB_FILES if os.path.isfile(os.path.join(logdir, n))]
    if held:
        lines.append(f"  analysis outputs: {', '.join(held)}")
    budget = (doc.get("meta") or {}).get("disk_budget")
    if isinstance(budget, dict):
        lines.append(
            f"  disk budget: {budget.get('budget_mb') or 'off'} MB total / "
            f"{budget.get('collector_budget_mb') or 'off'} MB per "
            f"collector — {budget.get('rotated_files', 0)} file(s) "
            f"rotated, {len(budget.get('truncated') or [])} collector(s) "
            "truncated")

    collectors = doc.get("collectors") or {}
    if collectors:
        lines.append("")
        rows = [["COLLECTOR", "STATUS", "BYTES", "DETAIL"]]
        for name, ent in sorted(collectors.items()):
            status = str(ent.get("status", "?"))
            if status in _STICKY_STATUSES:
                rc = 1
            detail = (ent.get("error") or ent.get("reason")
                      or ent.get("degraded_reason") or "")
            if ent.get("degraded"):
                status += " (degraded)"
            if ent.get("died") and status not in ("died",):
                status += (f" (died, restarted "
                           f"{ent.get('restarts', 0)}x)")
            if ent.get("timed_out") and status != "timed_out":
                status += " (timed_out)"
            exit_code = ent.get("exit_code")
            if isinstance(exit_code, int) and exit_code not in (0, -15):
                detail = (detail + f" exit_code={exit_code}").strip()
            rows.append([name, status,
                         _fmt_bytes(ent.get("bytes_captured")),
                         str(detail)[:60]])
        lines += _table(rows)

    sources = doc.get("sources") or {}
    if sources:
        lines.append("")
        rows = [["SOURCE", "STATUS", "CACHE", "EVENTS", "WALL", "DETAIL"]]
        for name, ent in sorted(sources.items()):
            wall = ent.get("wall_s")
            rows.append([
                name, str(ent.get("status", "?")),
                str(ent.get("cache", "-")),
                str(ent.get("events", "-")),
                f"{wall:.3f}s" if isinstance(wall, (int, float)) else "-",
                str(ent.get("error") or "")[:60],
            ])
        lines += _table(rows)

    problems = manifest_warnings(doc)
    lines.append("")
    if problems:
        lines += [f"! {p}" for p in problems]
    else:
        lines.append("all recorded stages healthy")
    return lines, rc


def sofa_status(cfg) -> int:
    """The ``status`` verb: render the health ledger; exit 1 on a
    collector in a terminal bad status, a failed analysis pass, damage
    the last fsck found or a stalled live source, 2 when there is no
    manifest."""
    doc = load_manifest(cfg.logdir)
    if doc is None:
        print_error(f"no {MANIFEST_NAME} in {cfg.logdir} — run `record` / "
                    "`preprocess` first")
        return 2
    if doc.get("schema") != MANIFEST_SCHEMA:
        print_error(f"{cfg.path(MANIFEST_NAME)} is not a run manifest")
        return 2
    print_title(f"run health — {cfg.logdir}")
    lines, rc = render_status(doc, cfg.logdir)
    print("\n".join(lines))
    if rc != 0:
        print_error("one or more collectors failed, died, timed out, or "
                    "hit the disk budget, an analysis pass failed, the "
                    "last fsck found damage, or a live source stalled — "
                    "see the report above")
    return rc
