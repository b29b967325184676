"""Validate a ``run_manifest.json`` against its schema (the JAX package's
``tools/manifest_check.py``, for the sections this package writes: runs,
env, collectors, sources, stages, ``digests``, ``meta.pool``,
``meta.ingest_cache``, ``meta.disk_budget``, ``meta.passes``,
``meta.fsck``, ``meta.frames``, ``meta.whatif``, ``meta.live``,
``meta.archive``, ``meta.regress``, ``meta.backup``, and the sections the
agent writes: ``meta.agent``, ``meta.serve``, ``meta.tier``,
``meta.metrics`` and ``meta.health``; the JAX package's ``meta.slo``
reader waits for the fleet tier's SLOs).
Given a logdir, it also validates every ``_frames/<name>/frame_index.json``,
the ``whatif_report.json`` (``validate_whatif``), the
``regress_verdict.json`` (``validate_verdict``) and ``live``'s offset
ledger ``_live_offsets.json`` (``validate_live_offsets``) where they are.
Given an archive root (``sofa_archive.json``), it validates the columnar
index instead: ``_index/index_commit.json`` (``validate_index_commit``)
and each family's ``frame_index.json`` against it (no index at all is
valid: the readers scan).  Given a ``regress_verdict.json``, it validates
that.  Under ``--require-healthy`` a stalled live source and an active
stream whose ``updated_unix`` is older than ``_LIVE_STALE_S`` and a run
the agent could not deliver are problems; under ``--require-passing`` a
``regressed`` verdict is one.

    python -m sofa_tpu_torch.tools.manifest_check
        <logdir | manifest.json | archive root | regress_verdict.json>
        [--require-healthy] [--require-passing]

Exit codes: 0 valid, 1 invalid (one problem a line), 2 missing or
unreadable.  Keys beyond the ones checked are allowed (additive evolution
does not bump the schema version); missing or mistyped structure and
out-of-vocabulary statuses are not.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List

from sofa_tpu_torch.archive import ARCHIVE_MARKER_NAME, VERDICT_NAME
from sofa_tpu_torch.archive.client import HEALTH_SCHEMA, HEALTH_VERSION
from sofa_tpu_torch.archive.index import (FAMILIES, INDEX_COMMIT_NAME,
                                          INDEX_DIR_NAME, INDEX_SCHEMA,
                                          INDEX_VERSION)
from sofa_tpu_torch.archive.store import BACKUP_SCHEMA, BACKUP_VERSION
from sofa_tpu_torch.archive.tier import TIER_SCHEMA, TIER_VERSION
from sofa_tpu_torch.archive.verdict import (VERDICT_SCHEMA, VERDICT_VERSION,
                                            VERDICTS)
from sofa_tpu_torch.frames import (FRAME_INDEX_NAME, FRAME_INDEX_SCHEMA,
                                   FRAME_INDEX_VERSION, FRAMES_DIR_NAME)
from sofa_tpu_torch.live import (LIVE_SOURCE_STATUSES, OFFSETS_NAME,
                                 OFFSETS_SCHEMA, OFFSETS_VERSION)
from sofa_tpu_torch.telemetry import (CACHE_OUTCOMES, COLLECTOR_STATUSES,
                                      MANIFEST_NAME, MANIFEST_SCHEMA,
                                      MANIFEST_VERSION, PASS_STATUSES,
                                      SOURCE_STATUSES)
from sofa_tpu_torch.trace import TRACE_FORMATS

_UNHEALTHY = ("failed", "killed", "died", "timed_out", "truncated_by_budget")
_WHATIF_SCHEMA = "sofa_tpu/whatif_report"
_WHATIF_VERSION = 1
_WHATIF_REPORT = "whatif_report.json"
_WHATIF_CALIBRATION = ("calibrated", "uncalibrated")
_WHATIF_SCENARIO_STATUSES = ("parsed", "unknown")
_WHATIF_ATTRIBUTION_STATUSES = ("applied", "no_match", "unknown")
# An active live stream whose last epoch is older than this is stale.
_LIVE_STALE_S = 600.0


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _is_count(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v >= 0


def _check_runs(runs, probs: List[str]) -> None:
    for verb, run in runs.items():
        where = f"runs.{verb}"
        if not isinstance(run, dict):
            probs.append(f"{where}: not an object")
            continue
        if not _is_num(run.get("started_unix")):
            probs.append(f"{where}.started_unix: missing or not a number")
        if not _is_num(run.get("wall_s")) or run.get("wall_s", 0) < 0:
            probs.append(f"{where}.wall_s: missing or negative")
        rc = run.get("rc")
        if rc is not None and not isinstance(rc, int):
            probs.append(f"{where}.rc: not an int or null")
        counters = run.get("counters")
        if not isinstance(counters, dict):
            probs.append(f"{where}.counters: missing")
            continue
        for key in ("warnings", "errors"):
            if not _is_count(counters.get(key, 0)):
                probs.append(f"{where}.counters.{key}: not a "
                             "non-negative int")


def _check_collectors(collectors, probs: List[str]) -> None:
    for name, ent in collectors.items():
        where = f"collectors.{name}"
        if not isinstance(ent, dict):
            probs.append(f"{where}: not an object")
            continue
        if ent.get("status") not in COLLECTOR_STATUSES:
            probs.append(f"{where}.status: {ent.get('status')!r} not in "
                         f"{COLLECTOR_STATUSES}")
        for key in ("bytes_captured", "exit_code", "restarts", "deaths",
                    "rotated_files", "budget_bytes"):
            if key in ent and not isinstance(ent[key], int):
                probs.append(f"{where}.{key}: not an int")
        for key in ("bytes_captured", "restarts", "deaths", "rotated_files",
                    "budget_bytes"):
            if key in ent and isinstance(ent[key], int) and ent[key] < 0:
                probs.append(f"{where}.{key}: negative")
        for key in ("died", "timed_out", "output_stalled"):
            if key in ent and not isinstance(ent[key], bool):
                probs.append(f"{where}.{key}: not a bool")


def _check_sources(sources, probs: List[str]) -> None:
    for name, ent in sources.items():
        where = f"sources.{name}"
        if not isinstance(ent, dict):
            probs.append(f"{where}: not an object")
            continue
        if ent.get("status") not in SOURCE_STATUSES:
            probs.append(f"{where}.status: {ent.get('status')!r} not in "
                         f"{SOURCE_STATUSES}")
        if ent.get("cache") not in CACHE_OUTCOMES:
            probs.append(f"{where}.cache: {ent.get('cache')!r} not in "
                         f"{CACHE_OUTCOMES}")
        if not _is_num(ent.get("wall_s")) or ent.get("wall_s", 0) < 0:
            probs.append(f"{where}.wall_s: missing or negative")
        if not _is_count(ent.get("events")):
            probs.append(f"{where}.events: missing or negative")
        if "quarantined_file" in ent and \
                not isinstance(ent["quarantined_file"], str):
            probs.append(f"{where}.quarantined_file: not a string")


def _check_passes(passes, probs: List[str]) -> None:
    """meta.passes: in-vocabulary statuses, and a schedule that holds
    every pass that ran (analysis/registry.py writes it)."""
    if passes is None:
        return
    if not isinstance(passes, dict):
        probs.append("meta.passes: not an object")
        return
    sched = passes.get("schedule")
    if not isinstance(sched, list) or any(
            not isinstance(w, list) or any(not isinstance(n, str) for n in w)
            for w in sched):
        probs.append("meta.passes.schedule: not a list of name-list waves")
        sched = []
    if not isinstance(passes.get("jobs"), int) \
            or isinstance(passes.get("jobs"), bool):
        probs.append("meta.passes.jobs: missing or not an int")
    ledger = passes.get("passes")
    if not isinstance(ledger, dict):
        probs.append("meta.passes.passes: missing per-pass ledger")
        return
    scheduled = {n for w in sched for n in w}
    for name, ent in sorted(ledger.items()):
        if not isinstance(ent, dict):
            probs.append(f"meta.passes.passes.{name}: not an object")
            continue
        if ent.get("status") not in PASS_STATUSES:
            probs.append(f"meta.passes.passes.{name}.status: "
                         f"{ent.get('status')!r} not in {PASS_STATUSES}")
        if ent.get("status") != "skipped":
            if not _is_num(ent.get("wall_s")):
                probs.append(f"meta.passes.passes.{name}.wall_s: missing "
                             "or not a number")
            if name not in scheduled:
                probs.append(f"meta.passes.passes.{name}: ran but absent "
                             "from meta.passes.schedule")


def _check_digests(digests, probs: List[str]) -> None:
    """``digests``: the sha256 ledger ``fsck`` verifies."""
    if digests is None:
        return
    if not isinstance(digests, dict) or \
            not isinstance(digests.get("files"), dict):
        probs.append("digests: not an object with a files map")
        return
    if not isinstance(digests.get("algo"), str):
        probs.append("digests.algo: missing or not a string")
    for rel, ent in digests["files"].items():
        where = f"digests.files[{rel!r}]"
        if not isinstance(ent, dict):
            probs.append(f"{where}: not an object")
            continue
        sha = ent.get("sha256")
        if not (isinstance(sha, str) and len(sha) == 64):
            probs.append(f"{where}.sha256: not a 64-hex digest")
        for key in ("bytes", "mtime_ns"):
            if not _is_count(ent.get(key)):
                probs.append(f"{where}.{key}: missing or not a "
                             "non-negative int")
        if ent.get("kind") not in ("raw", "derived"):
            probs.append(f"{where}.kind: {ent.get('kind')!r} not "
                         "raw/derived")


def _check_frames_meta(fmeta, probs: List[str]) -> None:
    """``meta.frames``: the frames' format and the chunk store's
    accounting."""
    if fmeta is None:
        return
    if not isinstance(fmeta, dict):
        probs.append("meta.frames: not an object")
        return
    if fmeta.get("format") not in TRACE_FORMATS:
        probs.append(f"meta.frames.format: {fmeta.get('format')!r} not in "
                     f"{TRACE_FORMATS}")
    for key in ("frames", "chunks", "reused", "bytes"):
        if not _is_count(fmeta.get(key)):
            probs.append(f"meta.frames.{key}: missing or not a "
                         "non-negative int")
    if _is_count(fmeta.get("chunks")) and _is_count(fmeta.get("reused")) \
            and fmeta["reused"] > fmeta["chunks"]:
        probs.append("meta.frames: reused exceeds chunks")


def validate_frame_index(doc) -> List[str]:
    """Schema problems of one ``_frames/<name>/frame_index.json``, the
    commit point of a frame's chunk store."""
    if not isinstance(doc, dict):
        return ["frame index is not a JSON object"]
    probs: List[str] = []
    if doc.get("schema") != FRAME_INDEX_SCHEMA:
        probs.append(f"schema: expected {FRAME_INDEX_SCHEMA!r}, "
                     f"got {doc.get('schema')!r}")
    if doc.get("version") != FRAME_INDEX_VERSION:
        probs.append(f"version: expected {FRAME_INDEX_VERSION}, "
                     f"got {doc.get('version')!r}")
    if not isinstance(doc.get("name"), str) or not doc.get("name"):
        probs.append("name: missing or empty")
    cols = doc.get("columns")
    if not isinstance(cols, list) or not cols \
            or not all(isinstance(c, str) for c in cols):
        probs.append("columns: missing or not a list of column names")
    rows = doc.get("rows")
    if not _is_count(rows):
        probs.append("rows: missing or not a non-negative int")
    step = doc.get("chunk_rows")
    if not _is_count(step) or step < 1:
        probs.append("chunk_rows: missing or not a positive int")
    if doc.get("format") != "arrow":
        probs.append(f"format: expected 'arrow', got {doc.get('format')!r}")
    chunks = doc.get("chunks")
    if not isinstance(chunks, list):
        probs.append("chunks: not a list")
        chunks = []
    total = 0
    for i, c in enumerate(chunks):
        # t_min and t_max are null together where every timestamp is NaN
        t_ok = isinstance(c, dict) and (
            (_is_num(c.get("t_min")) and _is_num(c.get("t_max")))
            or (c.get("t_min") is None and c.get("t_max") is None))
        if not t_ok or not isinstance(c.get("file"), str) \
                or not isinstance(c.get("sha"), str) \
                or not _is_count(c.get("rows")) or c["rows"] < 1:
            probs.append(f"chunks[{i}]: needs file, sha, positive rows, "
                         "and numeric (or paired-null) t_min/t_max")
            continue
        total += c["rows"]
        if _is_count(step) and step >= 1 and i < len(chunks) - 1 \
                and c["rows"] != step:
            probs.append(f"chunks[{i}].rows: {c['rows']} — every "
                         f"non-final chunk must hold exactly chunk_rows "
                         f"({step}) rows")
    if chunks and _is_count(rows) and total != rows:
        probs.append(f"rows: {rows} disagrees with the chunk-table sum "
                     f"{total}")
    return probs


def check_frame_indexes(logdir: str) -> List[str]:
    """``validate_frame_index`` over every committed index under the
    logdir's ``_frames/`` (no store: nothing to check)."""
    root = os.path.join(logdir, FRAMES_DIR_NAME)
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return []
    probs: List[str] = []
    for name in names:
        path = os.path.join(root, name, FRAME_INDEX_NAME)
        if not os.path.isfile(path):
            continue
        where = f"{FRAMES_DIR_NAME}/{name}/{FRAME_INDEX_NAME}"
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            probs.append(f"{where}: unreadable ({e})")
            continue
        probs.extend(f"{where}: {p}" for p in validate_frame_index(doc))
    return probs


def _check_whatif_meta(whatif, probs: List[str]) -> None:
    """meta.whatif (the ``whatif`` verb): the verdict and identity error
    its report carries in full."""
    if whatif is None:
        return
    if not isinstance(whatif, dict):
        probs.append("meta.whatif: not an object")
        return
    if whatif.get("verdict") not in _WHATIF_CALIBRATION:
        probs.append(f"meta.whatif.verdict: {whatif.get('verdict')!r} not "
                     f"in {_WHATIF_CALIBRATION}")
    v = whatif.get("identity_error_pct")
    if not _is_num(v) or v < 0:
        probs.append("meta.whatif.identity_error_pct: missing or not a "
                     "non-negative number")
    for key in ("n_steps", "scenarios"):
        if not _is_count(whatif.get(key)):
            probs.append(f"meta.whatif.{key}: missing or not a "
                         "non-negative int")
    if not isinstance(whatif.get("report"), str):
        probs.append("meta.whatif.report: missing report filename")


def validate_whatif(doc, require_healthy: bool = False) -> List[str]:
    """Schema problems in a ``whatif_report.json``; with
    ``require_healthy`` an ``uncalibrated`` identity gate is one too."""
    if not isinstance(doc, dict):
        return ["whatif report is not a JSON object"]
    probs: List[str] = []
    if doc.get("schema") != _WHATIF_SCHEMA:
        probs.append(f"schema: expected {_WHATIF_SCHEMA!r}, "
                     f"got {doc.get('schema')!r}")
    if doc.get("version") != _WHATIF_VERSION:
        probs.append(f"version: expected {_WHATIF_VERSION}, "
                     f"got {doc.get('version')!r}")
    if not _is_num(doc.get("generated_unix")):
        probs.append("generated_unix: missing or not a number")
    calib = doc.get("calibration")
    if not isinstance(calib, dict):
        probs.append("calibration: missing")
        calib = {}
    verdict = calib.get("verdict")
    if verdict not in _WHATIF_CALIBRATION:
        probs.append(f"calibration.verdict: {verdict!r} not in "
                     f"{_WHATIF_CALIBRATION}")
    if not isinstance(calib.get("reason"), str):
        probs.append("calibration.reason: a verdict must state its reason")
    n = calib.get("n_steps")
    if not _is_count(n):
        probs.append("calibration.n_steps: missing or not a "
                     "non-negative int")
    elif n > 0:
        for key in ("measured_mean_s", "measured_median_s",
                    "identity_mean_s", "identity_error_pct"):
            if not _is_num(calib.get(key)):
                probs.append(f"calibration.{key}: missing or not a number")
        ci = calib.get("ci")
        if ci is not None and not (isinstance(ci, list) and len(ci) == 2
                                   and all(_is_num(v) for v in ci)):
            probs.append("calibration.ci: not null or a [lo, hi] pair")
    scenarios = doc.get("scenarios")
    if not isinstance(scenarios, list):
        probs.append("scenarios: not a list")
        scenarios = []
    for i, sc in enumerate(scenarios):
        if not isinstance(sc, dict) or not isinstance(sc.get("spec"), str) \
                or sc.get("status") not in _WHATIF_SCENARIO_STATUSES:
            probs.append(f"scenarios[{i}]: needs a spec and a status in "
                         f"{_WHATIF_SCENARIO_STATUSES}")
    pred = doc.get("predicted")
    if not isinstance(pred, dict):
        probs.append("predicted: missing")
        pred = {}
    if not _is_num(pred.get("step_time_mean_s")):
        probs.append("predicted.step_time_mean_s: missing or not a number")
    bars = pred.get("error_bars")
    if bars is not None and not (isinstance(bars, list) and len(bars) == 2
                                 and all(_is_num(v) for v in bars)):
        probs.append("predicted.error_bars: not null or a [lo, hi] pair")
    att = pred.get("attribution")
    if not isinstance(att, list):
        probs.append("predicted.attribution: not a list")
        att = []
    for i, a in enumerate(att):
        if not isinstance(a, dict) \
                or not isinstance(a.get("scenario"), str) \
                or a.get("status") not in _WHATIF_ATTRIBUTION_STATUSES \
                or not _is_num(a.get("delta_s")):
            probs.append(f"predicted.attribution[{i}]: needs scenario, a "
                         f"status in {_WHATIF_ATTRIBUTION_STATUSES}, and "
                         "a numeric delta_s")
    steps = doc.get("steps")
    if not isinstance(steps, list):
        probs.append("steps: not a list")
        steps = []
    for i, st in enumerate(steps):
        if not isinstance(st, dict) or not all(
                _is_num(st.get(k)) for k in ("deviceId", "step",
                                             "measured_s", "predicted_s")):
            probs.append(f"steps[{i}]: needs numeric deviceId/step/"
                         "measured_s/predicted_s")
            break  # one line for a malformed overlay, not one a step
    if require_healthy and verdict == "uncalibrated":
        probs.append("gate: the identity replay is uncalibrated ("
                     + str(calib.get("reason", "?")) + ")")
    return probs


def _check_meta(meta, probs: List[str]) -> None:
    budget = meta.get("disk_budget")
    if budget is not None:
        if not isinstance(budget, dict):
            probs.append("meta.disk_budget: not an object")
        else:
            for key in ("budget_mb", "collector_budget_mb"):
                v = budget.get(key)
                if v is not None and (not _is_num(v) or v < 0):
                    probs.append(f"meta.disk_budget.{key}: not a "
                                 "non-negative number or null")
            if not _is_count(budget.get("rotated_files")):
                probs.append("meta.disk_budget.rotated_files: missing or "
                             "not a non-negative int")
            t = budget.get("truncated")
            if not isinstance(t, list) or \
                    any(not isinstance(n, str) for n in t):
                probs.append("meta.disk_budget.truncated: not a list of "
                             "collector names")
    pool = meta.get("pool")
    if pool is not None:
        if not isinstance(pool, dict):
            probs.append("meta.pool: not an object")
        else:
            for key in ("jobs", "cpu_count"):
                v = pool.get(key)
                if not _is_count(v) or v < 1:
                    probs.append(f"meta.pool.{key}: missing or not a "
                                 "positive int")
    _check_passes(meta.get("passes"), probs)
    _check_frames_meta(meta.get("frames"), probs)
    fsck = meta.get("fsck")
    if fsck is not None:
        if not isinstance(fsck, dict) or \
                not isinstance(fsck.get("ok"), bool):
            probs.append("meta.fsck: not an object with a bool ok")
        elif not isinstance(fsck.get("problems"), dict):
            probs.append("meta.fsck.problems: missing verdict counts")
    _check_whatif_meta(meta.get("whatif"), probs)
    _check_archive_meta(meta, probs)
    icache = meta.get("ingest_cache")
    if icache is not None:
        if not isinstance(icache, dict) or \
                not isinstance(icache.get("enabled"), bool):
            probs.append("meta.ingest_cache: not an object with a bool "
                         "enabled")
        else:
            for key in ("hits", "misses"):
                v = icache.get(key)
                if not isinstance(v, list) or \
                        any(not isinstance(s, str) for s in v):
                    probs.append(f"meta.ingest_cache.{key}: not a list of "
                                 "source names")
            if not isinstance(icache.get("stored_bytes", {}), dict):
                probs.append("meta.ingest_cache.stored_bytes: not an "
                             "object")


def _check_archive_meta(meta, probs: List[str]) -> None:
    """``meta.archive`` (the last ingest), ``meta.regress`` (the verdict
    and its counts) and ``meta.backup`` (the last snapshot)."""
    archive = meta.get("archive")
    if archive is not None:
        if not isinstance(archive, dict):
            probs.append("meta.archive: not an object")
        else:
            run = archive.get("run")
            if not (isinstance(run, str) and len(run) == 64):
                probs.append("meta.archive.run: not a 64-hex run id")
            for key in ("files", "new_objects", "bytes_added"):
                if not _is_count(archive.get(key)):
                    probs.append(f"meta.archive.{key}: missing or not a "
                                 "non-negative int")
    regress = meta.get("regress")
    if regress is not None:
        if not isinstance(regress, dict) or \
                regress.get("verdict") not in VERDICTS:
            probs.append(f"meta.regress.verdict: not in {VERDICTS}")
        elif not isinstance(regress.get("counts"), dict):
            probs.append("meta.regress.counts: missing verdict counts")
    backup = meta.get("backup")
    if backup is None:
        return
    if not isinstance(backup, dict):
        probs.append("meta.backup: not an object")
        return
    if backup.get("schema") != BACKUP_SCHEMA:
        probs.append(f"meta.backup.schema: expected {BACKUP_SCHEMA!r}, "
                     f"got {backup.get('schema')!r}")
    if backup.get("version") != BACKUP_VERSION:
        probs.append(f"meta.backup.version: expected {BACKUP_VERSION}, "
                     f"got {backup.get('version')!r}")
    if not _is_count(backup.get("snapshot")) or backup["snapshot"] < 1:
        probs.append("meta.backup.snapshot: missing or not a positive int")
    for key in ("dest", "source_root"):
        if not isinstance(backup.get(key), str) or not backup[key]:
            probs.append(f"meta.backup.{key}: missing or empty")
    for key in ("files", "new_objects", "bytes_added"):
        if not _is_count(backup.get(key)):
            probs.append(f"meta.backup.{key}: missing or not a "
                         "non-negative int")
    sha = backup.get("commit_sha")
    if not isinstance(sha, str) or (sha and len(sha) != 40):
        probs.append("meta.backup.commit_sha: not a 40-hex sha or empty")
    if not _is_num(backup.get("taken_unix")):
        probs.append("meta.backup.taken_unix: missing or not a number")


def _is_run_id(v) -> bool:
    return isinstance(v, str) and len(v) == 64


def _check_fleet_meta(meta, probs: List[str]) -> None:
    """The sections ``agent`` writes (agent.py): ``meta.agent`` (the spool
    and the push), ``meta.serve`` (the service's ack), ``meta.tier`` (the
    worker that committed it and its WAL depth), ``meta.metrics`` (the
    push's trace id and the worker's metrics fold) and ``meta.health``
    (the client's endpoints, failovers and open breakers)."""
    agent = meta.get("agent")
    if agent is not None and not isinstance(agent, dict):
        probs.append("meta.agent: not an object")
    elif agent is not None:
        if not isinstance(agent.get("spool"), str):
            probs.append("meta.agent.spool: missing spool root")
        if not _is_run_id(agent.get("run")):
            probs.append("meta.agent.run: not a 64-hex run id")
        svc = agent.get("service")
        if svc is not None and not isinstance(svc, str):
            probs.append("meta.agent.service: not a string or null")
        push = agent.get("push")
        if push is not None:
            if not isinstance(push, dict) or push.get("status") not in (
                    "pushed", "spooled", "rejected"):
                probs.append("meta.agent.push.status: not in "
                             "('pushed', 'spooled', 'rejected')")
            else:
                if not _is_count(push.get("attempts")):
                    probs.append("meta.agent.push.attempts: missing or not "
                                 "a non-negative int")
                if not _is_num(push.get("wall_s")) \
                        or push.get("wall_s", 0) < 0:
                    probs.append("meta.agent.push.wall_s: missing or "
                                 "negative")
    serve = meta.get("serve")
    if serve is not None and not isinstance(serve, dict):
        probs.append("meta.serve: not an object")
    elif serve is not None:
        for key in ("url", "tenant"):
            if not isinstance(serve.get(key), str) or not serve[key]:
                probs.append(f"meta.serve.{key}: missing or empty")
        if not _is_run_id(serve.get("run")):
            probs.append("meta.serve.run: not a 64-hex run id")
        if not _is_num(serve.get("committed_unix")):
            probs.append("meta.serve.committed_unix: missing or not a "
                         "number")
    tier = meta.get("tier")
    if tier is not None and not isinstance(tier, dict):
        probs.append("meta.tier: not an object")
    elif tier is not None:
        if tier.get("schema") != TIER_SCHEMA:
            probs.append(f"meta.tier.schema: expected {TIER_SCHEMA!r}, "
                         f"got {tier.get('schema')!r}")
        if tier.get("version") != TIER_VERSION:
            probs.append(f"meta.tier.version: expected {TIER_VERSION}, "
                         f"got {tier.get('version')!r}")
        if not isinstance(tier.get("url"), str) or not tier.get("url"):
            probs.append("meta.tier.url: missing or empty")
        worker, workers = tier.get("worker"), tier.get("workers")
        for key, v in (("worker", worker), ("workers", workers),
                       ("wal_depth", tier.get("wal_depth"))):
            if not _is_count(v):
                probs.append(f"meta.tier.{key}: missing or not a "
                             "non-negative int")
        if _is_count(worker) and _is_count(workers) \
                and (workers < 1 or not worker < workers):
            probs.append(f"meta.tier: worker {worker} out of range for "
                         f"{workers} worker(s)")
    mmet = meta.get("metrics")
    if mmet is not None and not isinstance(mmet, dict):
        probs.append("meta.metrics: not an object")
    elif mmet is not None:
        if not isinstance(mmet.get("trace"), str):
            probs.append("meta.metrics.trace: missing or not a string")
        for key in ("last_scrape_unix", "scrape_age_s", "push_wall_s",
                    "push_p99_ms", "wal_depth", "replica_behind"):
            v = mmet.get(key)
            if v is not None and not _is_num(v):
                probs.append(f"meta.metrics.{key}: not a number or null")
        if mmet.get("slo_ok") is not None \
                and not isinstance(mmet["slo_ok"], bool):
            probs.append("meta.metrics.slo_ok: not a bool or null")
        br = mmet.get("slo_breaching")
        if br is not None and (not isinstance(br, list)
                               or any(not isinstance(n, str) for n in br)):
            probs.append("meta.metrics.slo_breaching: not a list of metric "
                         "names")
    mh = meta.get("health")
    if mh is not None and not isinstance(mh, dict):
        probs.append("meta.health: not an object")
    elif mh is not None:
        if mh.get("schema") != HEALTH_SCHEMA:
            probs.append(f"meta.health.schema: expected {HEALTH_SCHEMA!r}, "
                         f"got {mh.get('schema')!r}")
        if mh.get("version") != HEALTH_VERSION:
            probs.append(f"meta.health.version: expected {HEALTH_VERSION}, "
                         f"got {mh.get('version')!r}")
        eps = mh.get("endpoints")
        if not isinstance(eps, list) or not eps or any(
                not isinstance(u, str) or not u for u in eps):
            probs.append("meta.health.endpoints: not a non-empty list of "
                         "URLs")
        active = mh.get("active")
        if not isinstance(active, str) or not active:
            probs.append("meta.health.active: missing or empty")
        elif isinstance(eps, list) and eps and active not in eps:
            probs.append(f"meta.health.active: {active!r} not in endpoints")
        if not _is_count(mh.get("failovers")):
            probs.append("meta.health.failovers: missing or not a "
                         "non-negative int")
        bo = mh.get("breakers_open")
        if not isinstance(bo, list) or any(not isinstance(u, str)
                                           for u in bo):
            probs.append("meta.health.breakers_open: not a list of "
                         "endpoint URLs")


def validate_verdict(doc, require_passing: bool = False) -> List[str]:
    """Schema problems in a ``regress_verdict.json`` (archive/verdict.py);
    with ``require_passing`` an overall ``regressed`` verdict is one too
    (the CI gate)."""
    if not isinstance(doc, dict):
        return ["verdict is not a JSON object"]
    probs: List[str] = []
    if doc.get("schema") != VERDICT_SCHEMA:
        probs.append(f"schema: expected {VERDICT_SCHEMA!r}, "
                     f"got {doc.get('schema')!r}")
    if doc.get("version") != VERDICT_VERSION:
        probs.append(f"version: expected {VERDICT_VERSION}, "
                     f"got {doc.get('version')!r}")
    if not _is_num(doc.get("generated_unix")):
        probs.append("generated_unix: missing or not a number")
    if doc.get("verdict") not in VERDICTS:
        probs.append(f"verdict: {doc.get('verdict')!r} not in {VERDICTS}")
    counts = doc.get("counts")
    if not isinstance(counts, dict) or any(
            not _is_count(counts.get(v)) for v in VERDICTS):
        probs.append("counts: missing per-verdict int counters")
    for section in ("features", "clusters"):
        rows = doc.get(section)
        if not isinstance(rows, list):
            probs.append(f"{section}: not a list")
            continue
        for i, r in enumerate(rows):
            if not isinstance(r, dict) or \
                    not isinstance(r.get("name"), str) or \
                    r.get("verdict") not in VERDICTS:
                probs.append(f"{section}[{i}]: needs a name and a typed "
                             f"verdict in {VERDICTS}")
            elif r.get("verdict") != "noise" and \
                    not isinstance(r.get("reason"), str):
                probs.append(f"{section}[{i}]: a non-noise verdict must "
                             "state its reason")
    base = doc.get("baseline")
    if not isinstance(base, dict) or base.get("mode") not in (
            "pairwise", "rolling"):
        probs.append("baseline.mode: not pairwise/rolling")
    if require_passing and doc.get("verdict") == "regressed":
        probs.append("gate: overall verdict is regressed")
    return probs


def validate_index_commit(doc) -> List[str]:
    """Schema problems in an archive's ``_index/index_commit.json``
    (archive/index.py), the columnar index's fsync'd-last commit point."""
    if not isinstance(doc, dict):
        return ["index commit is not a JSON object"]
    probs: List[str] = []
    if doc.get("schema") != INDEX_SCHEMA:
        probs.append(f"schema: expected {INDEX_SCHEMA!r}, "
                     f"got {doc.get('schema')!r}")
    if doc.get("version") != INDEX_VERSION:
        probs.append(f"version: expected {INDEX_VERSION}, "
                     f"got {doc.get('version')!r}")
    for key in ("catalog_offset", "catalog_gen", "events", "ingest_events",
                "bench_events", "runs", "features_rows"):
        if not _is_count(doc.get(key)):
            probs.append(f"{key}: missing or not a non-negative int")
    if not isinstance(doc.get("catalog_head_sha"), str):
        probs.append("catalog_head_sha: missing")
    if not isinstance(doc.get("commit_sha"), str) \
            or not doc.get("commit_sha"):
        probs.append("commit_sha: missing")
    fams = doc.get("families")
    if not isinstance(fams, dict) or sorted(fams) != sorted(FAMILIES):
        probs.append(f"families: expected exactly {sorted(FAMILIES)}, got "
                     f"{sorted(fams) if isinstance(fams, dict) else fams}")
        fams = {}
    for name, ent in sorted(fams.items()):
        if not isinstance(ent, dict) or not _is_count(ent.get("rows")) \
                or not _is_count(ent.get("chunks")):
            probs.append(f"families.{name}: needs int rows and chunks")
    return probs


def check_archive_index(root: str) -> List[str]:
    """An archive root's columnar index: the commit, and each family's
    ``frame_index.json`` against it.  No ``_index/`` at all is valid (the
    readers scan); an ``_index/`` without a commit is not."""
    idir = os.path.join(root, INDEX_DIR_NAME)
    if not os.path.isdir(idir):
        return []
    where = f"{INDEX_DIR_NAME}/{INDEX_COMMIT_NAME}"
    try:
        with open(os.path.join(idir, INDEX_COMMIT_NAME)) as f:
            doc = json.load(f)
    except OSError:
        return [f"{where}: missing (an {INDEX_DIR_NAME}/ without a commit; "
                "`archive fsck --repair` rebuilds it)"]
    except ValueError as e:
        return [f"{where}: not JSON: {e}"]
    probs = [f"{where}: {p}" for p in validate_index_commit(doc)]
    families = doc.get("families") if isinstance(doc, dict) else None
    for family in FAMILIES:
        fwhere = f"{INDEX_DIR_NAME}/{family}/{FRAME_INDEX_NAME}"
        try:
            with open(os.path.join(idir, family, FRAME_INDEX_NAME)) as f:
                fdoc = json.load(f)
        except (OSError, ValueError) as e:
            probs.append(f"{fwhere}: unreadable ({e})")
            continue
        probs += [f"{fwhere}: {p}" for p in validate_frame_index(fdoc)]
        want = ((families or {}).get(family) or {}).get("rows") \
            if isinstance(families, dict) else None
        if _is_count(want) and fdoc.get("rows") != want:
            probs.append(f"{fwhere}: rows {fdoc.get('rows')} disagrees "
                         f"with the commit ({want})")
    return probs


def _check_live_meta(live, probs: List[str]) -> None:
    """``meta.live``: the epoch, its stamp, the watermark, the no-reparse
    counters and each source's status and offsets."""
    if live is None:
        return
    if not isinstance(live, dict):
        probs.append("meta.live: not an object")
        return
    if not isinstance(live.get("active"), bool):
        probs.append("meta.live.active: missing or not a bool")
    ep = live.get("epoch")
    if not _is_count(ep) or ep < 1:
        probs.append("meta.live.epoch: missing or not a positive int")
    if not _is_num(live.get("updated_unix")):
        probs.append("meta.live.updated_unix: missing or not a number")
    wm = live.get("watermark_s")
    if wm is not None and not _is_num(wm):
        probs.append("meta.live.watermark_s: not a number or null")
    for key in ("chunks_parsed", "chunks_loaded"):
        if not _is_count(live.get(key)):
            probs.append(f"meta.live.{key}: missing or not a non-negative "
                         "int")
    sources = live.get("sources")
    if not isinstance(sources, dict):
        probs.append("meta.live.sources: missing per-source map")
        sources = {}
    for name, ent in sorted(sources.items()):
        where = f"meta.live.sources.{name}"
        if not isinstance(ent, dict):
            probs.append(f"{where}: not an object")
            continue
        if ent.get("status") not in LIVE_SOURCE_STATUSES:
            probs.append(f"{where}.status: {ent.get('status')!r} not in "
                         f"{LIVE_SOURCE_STATUSES}")
        for key in ("offset", "lag_bytes", "chunks", "chunks_parsed",
                    "chunks_loaded", "events"):
            if not _is_count(ent.get(key)):
                probs.append(f"{where}.{key}: missing or not a "
                             "non-negative int")
    tiles = live.get("tiles")
    if tiles is not None and (not isinstance(tiles, dict) or any(
            not _is_count(tiles.get(k))
            for k in ("rebuilt", "kept", "full_rebuilds"))):
        probs.append("meta.live.tiles: needs non-negative "
                     "rebuilt/kept/full_rebuilds ints")


def validate_live_offsets(doc) -> List[str]:
    """Schema problems in ``live``'s offset ledger, the commit point of
    its epochs: per source a non-negative offset and a gapless table of
    ``[start, end, rows]`` chunks ending at it."""
    if not isinstance(doc, dict):
        return ["offset ledger is not a JSON object"]
    probs: List[str] = []
    if doc.get("schema") != OFFSETS_SCHEMA:
        probs.append(f"schema: expected {OFFSETS_SCHEMA!r}, "
                     f"got {doc.get('schema')!r}")
    if doc.get("version") != OFFSETS_VERSION:
        probs.append(f"version: expected {OFFSETS_VERSION}, "
                     f"got {doc.get('version')!r}")
    if not _is_count(doc.get("epoch")):
        probs.append("epoch: missing or not a non-negative int")
    sources = doc.get("sources")
    if not isinstance(sources, dict):
        probs.append("sources: missing per-source map")
        sources = {}
    for name, ent in sorted(sources.items()):
        where = f"sources.{name}"
        if not isinstance(ent, dict):
            probs.append(f"{where}: not an object")
            continue
        off = ent.get("offset")
        if not _is_count(off):
            probs.append(f"{where}.offset: missing or not a non-negative "
                         "int")
        chunks = ent.get("chunks")
        if not isinstance(chunks, list) or any(
                not (isinstance(c, list) and len(c) == 3
                     and all(isinstance(v, int) for v in c))
                for c in chunks):
            probs.append(f"{where}.chunks: not a list of [start, end, "
                         "rows] triples")
            continue
        prev_end = None
        for c in chunks:
            if c[0] >= c[1]:
                probs.append(f"{where}.chunks: empty/inverted range {c}")
            if prev_end is not None and c[0] != prev_end:
                probs.append(f"{where}.chunks: gap/overlap at {c} "
                             f"(previous chunk ended at {prev_end})")
            prev_end = c[1]
        if chunks and _is_count(off) and chunks[-1][1] != off:
            probs.append(f"{where}: offset {off} disagrees with the last "
                         f"chunk end {chunks[-1][1]}")
    return probs


def validate_manifest(doc, require_healthy: bool = False) -> List[str]:
    """Every schema problem found (an empty list: valid).  With
    ``require_healthy`` a collector in a terminal bad status, a
    quarantined or failed source, and a verb that logged errors are
    problems too."""
    if not isinstance(doc, dict):
        return ["manifest is not a JSON object"]
    probs: List[str] = []
    if doc.get("schema") != MANIFEST_SCHEMA:
        probs.append(f"schema: expected {MANIFEST_SCHEMA!r}, "
                     f"got {doc.get('schema')!r}")
    if doc.get("schema_version") != MANIFEST_VERSION:
        probs.append(f"schema_version: expected {MANIFEST_VERSION}, "
                     f"got {doc.get('schema_version')!r}")
    if not _is_num(doc.get("generated_unix")):
        probs.append("generated_unix: missing or not a number")
    runs = doc.get("runs")
    if not isinstance(runs, dict) or not runs:
        probs.append("runs: missing or empty")
        runs = {}
    _check_runs(runs, probs)
    env = doc.get("env")
    if not isinstance(env, dict) or "sofa_tpu_version" not in env:
        probs.append("env: missing or lacks sofa_tpu_version")
    collectors = doc.get("collectors", {})
    if not isinstance(collectors, dict):
        probs.append("collectors: not an object")
        collectors = {}
    _check_collectors(collectors, probs)
    sources = doc.get("sources", {})
    if not isinstance(sources, dict):
        probs.append("sources: not an object")
        sources = {}
    _check_sources(sources, probs)
    meta = doc.get("meta") or {}
    if not isinstance(meta, dict):
        probs.append("meta: not an object")
        meta = {}
    _check_meta(meta, probs)
    _check_live_meta(meta.get("live"), probs)
    _check_fleet_meta(meta, probs)
    _check_digests(doc.get("digests"), probs)
    stages = doc.get("stages", [])
    if not isinstance(stages, list):
        probs.append("stages: not a list")
        stages = []
    for i, s in enumerate(stages):
        if not isinstance(s, dict) or not isinstance(s.get("name"), str) \
                or not _is_num(s.get("t0_unix")) \
                or not _is_num(s.get("dur_s")):
            probs.append(f"stages[{i}]: needs name + numeric t0_unix/dur_s")
        elif s.get("dur_s") < 0:
            probs.append(f"stages[{i}].dur_s: negative")
    if "record" in runs and not collectors:
        probs.append("a record run is present but the collectors ledger "
                     "is empty")
    if "preprocess" in runs and not sources:
        probs.append("a preprocess run is present but the sources ledger "
                     "is empty")
    if require_healthy:
        for name, ent in collectors.items():
            if isinstance(ent, dict) and ent.get("status") in _UNHEALTHY:
                probs.append(f"unhealthy: collector {name} "
                             f"{ent.get('status')}")
        for name, ent in sources.items():
            if isinstance(ent, dict) and \
                    ent.get("status") in ("quarantined", "failed"):
                probs.append(f"unhealthy: source {name} "
                             f"{ent.get('status')}")
        for verb, run in runs.items():
            if isinstance(run, dict) and \
                    (run.get("counters") or {}).get("errors"):
                probs.append(f"unhealthy: `{verb}` logged error lines")
        ledger = ((meta.get("passes") or {}).get("passes")
                  if isinstance(meta.get("passes"), dict) else None)
        for name, ent in sorted((ledger or {}).items()):
            if isinstance(ent, dict) and ent.get("status") == "failed":
                probs.append(f"unhealthy: analysis pass {name} failed"
                             + (f" ({ent['error']})"
                                if ent.get("error") else ""))
        agent = meta.get("agent")
        if isinstance(agent, dict) and \
                isinstance(agent.get("push"), dict) and \
                agent["push"].get("status") != "pushed":
            probs.append("unhealthy: the agent could not deliver this "
                         f"run ({agent['push'].get('status')}) — it is "
                         "spooled locally, not in the fleet archive")
        whatif = meta.get("whatif")
        if isinstance(whatif, dict) and \
                whatif.get("verdict") == "uncalibrated":
            probs.append("unhealthy: the what-if identity gate is "
                         "uncalibrated — the replay model does not "
                         "reproduce this run's measured step times")
        live = meta.get("live")
        if isinstance(live, dict):
            for name, ent in sorted((live.get("sources") or {}).items()):
                if isinstance(ent, dict) and ent.get("status") == "stalled":
                    probs.append(f"unhealthy: live source {name} stalled — "
                                 "it stopped growing while siblings kept "
                                 "streaming")
            upd = live.get("updated_unix")
            if live.get("active") and _is_num(upd) \
                    and time.time() - upd > _LIVE_STALE_S:
                probs.append("unhealthy: meta.live says the stream is "
                             "active but its last epoch is "
                             f"{time.time() - upd:.0f} s old — is `live` "
                             "still running?")
    return probs


def _load(path: str, probs: List[str], where: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        probs.append(f"{where}: unreadable ({e})")
        return None


def check_path(path: str, require_healthy: bool = False,
               require_passing: bool = False) -> int:
    """0 valid, 1 invalid (each problem printed), 2 missing or
    unreadable."""
    probs: List[str] = []
    if os.path.isdir(path) and \
            os.path.isfile(os.path.join(path, ARCHIVE_MARKER_NAME)):
        probs = check_archive_index(path)
        for prob in probs:
            print(prob)
        if not probs:
            has = os.path.isfile(os.path.join(path, INDEX_DIR_NAME,
                                              INDEX_COMMIT_NAME))
            print(f"{path}: valid archive root (index "
                  f"{'committed' if has else 'absent: the readers scan'})")
        return 1 if probs else 0
    if os.path.isdir(path):
        probs += check_frame_indexes(path)
        for name, check in (
                (_WHATIF_REPORT,
                 lambda d: validate_whatif(d, require_healthy)),
                (VERDICT_NAME,
                 lambda d: validate_verdict(d, require_passing)),
                (OFFSETS_NAME, validate_live_offsets)):
            if os.path.isfile(os.path.join(path, name)):
                doc = _load(os.path.join(path, name), probs, name)
                if doc is not None:
                    probs += [f"{name}: {p}" for p in check(doc)]
        path = os.path.join(path, MANIFEST_NAME)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        print(f"cannot read {path}: {e}", file=sys.stderr)
        return 2
    if isinstance(doc, dict) and doc.get("schema") == VERDICT_SCHEMA:
        probs = validate_verdict(doc, require_passing)
    else:
        probs = validate_manifest(doc, require_healthy) + probs
    for prob in probs:
        print(prob)
    if not probs:
        print(f"{path}: valid")
    return 1 if probs else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", help="a logdir, a run_manifest.json, an archive "
                   "root or a regress_verdict.json")
    p.add_argument("--require-healthy", action="store_true")
    p.add_argument("--require-passing", action="store_true",
                   help="a regressed verdict is a problem (the CI gate)")
    args = p.parse_args(argv)
    return check_path(args.path, args.require_healthy, args.require_passing)


if __name__ == "__main__":
    sys.exit(main())
