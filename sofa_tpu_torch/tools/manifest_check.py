"""Validate a ``run_manifest.json`` against its schema (the JAX package's
``tools/manifest_check.py``, for the sections this package writes: runs,
env, collectors, sources, stages, ``meta.pool``, ``meta.ingest_cache``,
``meta.disk_budget`` and ``meta.passes``).

    python -m sofa_tpu_torch.tools.manifest_check <logdir-or-manifest.json>
        [--require-healthy]

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
from typing import List

from sofa_tpu_torch.telemetry import (CACHE_OUTCOMES, COLLECTOR_STATUSES,
                                      MANIFEST_NAME, MANIFEST_SCHEMA,
                                      MANIFEST_VERSION, PASS_STATUSES,
                                      SOURCE_STATUSES)

_UNHEALTHY = ("failed", "killed", "died", "timed_out", "truncated_by_budget")


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
    return probs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", help="a logdir or a run_manifest.json")
    p.add_argument("--require-healthy", action="store_true")
    args = p.parse_args(argv)
    path = args.path
    if os.path.isdir(path):
        path = os.path.join(path, MANIFEST_NAME)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        print(f"cannot read {path}: {e}", file=sys.stderr)
        return 2
    probs = validate_manifest(doc, args.require_healthy)
    for prob in probs:
        print(prob)
    if not probs:
        print(f"{path}: valid")
    return 1 if probs else 0


if __name__ == "__main__":
    sys.exit(main())
