"""The agent's durable spool: a local archive root and its push state
(the JAX package's ``sofa_tpu/archive/spool.py``, whole).

Every run the agent finds is first ingested into a local content-addressed
archive (``store.py``: dedup, the fsync'd catalog, ``archive_fsck``) and
only then pushed to the service, so an unreachable, slow or full service
costs latency and never a run: the next pass re-pushes from the service's
have-list and re-sends no committed object.

* The spool's journal (``<spool>/_journal.jsonl``) brackets every push: a
  SIGKILLed agent leaves a ``push`` begun and not committed, and the next
  pass runs it again (the protocol makes the replay free).
* The push state (``<spool>/agent_state.json``, tmp+rename) maps each
  source logdir to its spooled run id, its manifest's fingerprint and its
  delivery, so a quiet logdir is not re-ingested on every poll and a
  delivered run is not re-pushed on every restart.

The spool stays after delivery: it is an archive root like any other
(``archive ls``, ``regress``, ``archive gc --archive_root <spool>``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from sofa_tpu_torch.archive.store import ArchiveStore, ingest_run
from sofa_tpu_torch.printing import print_warning

STATE_NAME = "agent_state.json"
STATE_SCHEMA = "sofa_tpu/agent_state"
STATE_VERSION = 1

DEFAULT_SPOOL = "sofa_spool"


def resolve_spool(cfg=None) -> str:
    """The spool root: ``--spool``, else SOFA_AGENT_SPOOL, else
    ``./sofa_spool`` (a sibling default like the archive's)."""
    root = getattr(cfg, "agent_spool", "") if cfg is not None else ""
    return root or os.environ.get("SOFA_AGENT_SPOOL", "") or DEFAULT_SPOOL


class Spool:
    """One spool root: local store + state ledger + push journal."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.store = ArchiveStore(self.root, create=True)
        from sofa_tpu_torch.durability import Journal

        self.journal = Journal(self.root)
        self._state = self._load_state()

    # -- state ledger ------------------------------------------------------
    def _load_state(self) -> dict:
        try:
            with open(os.path.join(self.root, STATE_NAME)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return {"schema": STATE_SCHEMA, "version": STATE_VERSION,
                    "logdirs": {}}
        if not isinstance(doc, dict) or doc.get("schema") != STATE_SCHEMA \
                or not isinstance(doc.get("logdirs"), dict):
            return {"schema": STATE_SCHEMA, "version": STATE_VERSION,
                    "logdirs": {}}
        return doc

    def _save_state(self) -> None:
        from sofa_tpu_torch.trace import atomic_write

        self._state["generated_unix"] = round(time.time(), 3)
        try:
            with atomic_write(os.path.join(self.root, STATE_NAME),
                              fsync=True) as f:
                json.dump(self._state, f, indent=1, sort_keys=True)
        except OSError as e:
            print_warning(f"spool: cannot persist {STATE_NAME}: {e} — "
                          "state will be recomputed next pass")

    def entry(self, logdir: str) -> dict:
        return self._state["logdirs"].setdefault(
            os.path.abspath(logdir), {})

    def pending_runs(self) -> Dict[str, str]:
        """{run_id: source logdir} for every spooled-but-undelivered run."""
        out: Dict[str, str] = {}
        for logdir, ent in sorted(self._state["logdirs"].items()):
            run = ent.get("run")
            if isinstance(run, str) and not ent.get("pushed"):
                out[run] = logdir
        return out

    # -- spooling ----------------------------------------------------------
    def needs_ingest(self, logdir: str) -> bool:
        """Whether the logdir changed since it was last spooled (manifest
        fingerprint comparison — re-ingest of an unchanged run would be a
        cheap no-op, but the daemon polls every few seconds and must not
        grow the catalog by a line per tick)."""
        ent = self.entry(logdir)
        return ent.get("manifest_mtime_ns") != _manifest_mtime(logdir) \
            or "run" not in ent

    def spool(self, cfg) -> Optional[dict]:
        """Ingest ``cfg.logdir`` into the spool store (journaled in the
        LOGDIR's journal like any archive ingest, so `sofa resume`
        replays a killed spooling).  Returns the ingest summary or None
        on failure (the run stays discoverable next pass)."""
        logdir = cfg.logdir
        mtime = _manifest_mtime(logdir)
        try:
            summary = ingest_run(cfg, self.root)
        except OSError as e:
            print_warning(f"spool: cannot ingest {logdir}: {e} — "
                          "will retry next pass")
            return None
        ent = self.entry(logdir)
        ent.update(run=summary["run"], manifest_mtime_ns=mtime,
                   spooled_unix=round(time.time(), 3))
        # a changed run id means new content: the previous delivery does
        # not cover it
        if ent.get("pushed_run") != summary["run"]:
            ent["pushed"] = False
        self._save_state()
        return summary

    def refresh_fingerprint(self, logdir: str) -> None:
        """Absorb the agent's OWN manifest write (meta.agent/meta.serve)
        into the fingerprint — without this every tick would read its
        own stamp as a changed run and re-ingest forever.  (The run ID
        is immune either way: ingest normalization strips the transport
        sections — store._SELF_VERBS.)"""
        self.entry(logdir)["manifest_mtime_ns"] = _manifest_mtime(logdir)
        self._save_state()

    # -- delivery ----------------------------------------------------------
    def mark_pushed(self, logdir: str, run_id: str, server: dict) -> None:
        ent = self.entry(logdir)
        ent.update(pushed=True, pushed_run=run_id,
                   pushed_unix=round(time.time(), 3),
                   server_run=str((server or {}).get("run", "")))
        self._save_state()

    def push(self, run_id: str, client) -> dict:
        """Journaled push of one spooled run: begin -> protocol ->
        commit.  The journal is the audit trail; resumability itself
        comes from the have-list (client.push_run)."""
        from sofa_tpu_torch.archive.client import push_run

        self.journal.begin("push", run=run_id, service=client.base,
                           tenant=client.tenant)
        result = push_run(self.store, run_id, client)
        self.journal.commit("push", run=run_id,
                            status=result.get("status"))
        return result


def _manifest_mtime(logdir: str) -> Optional[int]:
    from sofa_tpu_torch.telemetry import MANIFEST_NAME

    try:
        return os.stat(os.path.join(logdir, MANIFEST_NAME)).st_mtime_ns
    except OSError:
        return None
