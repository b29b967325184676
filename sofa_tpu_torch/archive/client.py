"""The fleet's upload client: the agent's half of the protocol (the JAX
package's ``sofa_tpu/archive/client.py``, whole).

* **Bounded**: every request carries a connect and read deadline
  (``--push_timeout_s``); a stalled link is a retry, never a wedged
  agent.
* **Retrying with jitter**: refused connections, timeouts, 5xx, 503s and
  a 422 of a torn upload retry up to ``--push_retries`` times with capped
  exponential backoff and jitter (``concurrency.jittered_backoff``); a
  ``Retry-After`` is the floor of the wait.
* **Typed refusals**: 401/403 and a quota 429 raise
  :class:`ServiceRejected`, which no retry clears: the agent keeps the run
  in its spool.
* **Failover**: ``--service url1,url2`` prefers the first endpoint whose
  circuit breaker is closed; a connection-level failure opens the
  endpoint's breaker, and a failed endpoint must pass ``GET /v1/health``
  before it is trusted again.
* **Resumable**: :func:`push_run` starts from the service's have-list, so
  a push interrupted anywhere re-sends no committed object.

The network fault kinds (``faults.py``, target ``service``) act in
:meth:`ServiceClient._attempt`: ``conn_refused``, ``conn_reset``,
``stall`` and ``http_500`` raise what the real failure raises, and
``partial@<f>`` truncates an object body so that the service's hash check
rejects it.
"""

from __future__ import annotations

import json
import os
import socket
import time
import urllib.error
import urllib.request
from typing import Dict, Optional

from sofa_tpu_torch import faults
from sofa_tpu_torch.archive.protocol import (
    CLIENT_FATAL_STATUSES, CLIENT_RETRY_FLOOR, CLIENT_RETRY_STATUSES,
    ERR_QUOTA)
from sofa_tpu_torch.concurrency import jittered_backoff
from sofa_tpu_torch.printing import print_warning

#: The ``meta.health`` manifest section (docs/OBSERVABILITY.md): the
#: agent's view of its endpoint set at push time — active endpoint,
#: failover count, open breakers.  Bumps on BREAKING shape changes.
HEALTH_SCHEMA = "sofa_tpu/fleet_health"
HEALTH_VERSION = 1


class ServiceUnavailable(Exception):
    """A transient transport failure — retry with backoff."""

    def __init__(self, msg: str, status: Optional[int] = None,
                 retry_after: Optional[float] = None):
        super().__init__(msg)
        self.status = status
        self.retry_after = retry_after


class ServiceRejected(Exception):
    """A typed refusal that retrying cannot clear (auth, quota, bad
    request) — the agent's cue to fall back to the durable spool."""

    def __init__(self, msg: str, status: Optional[int] = None,
                 quota: bool = False):
        super().__init__(msg)
        self.status = status
        self.quota = quota


class ServiceIncomplete(Exception):
    """Commit refused: objects are missing server-side (409) — resume
    from the attached have-list."""

    def __init__(self, msg: str, missing):
        super().__init__(msg)
        self.missing = list(missing or [])


class ServiceClient:
    """One service endpoint SET + tenant + token, with the retry policy.

    ``url`` may be a comma-separated failover list (``--service
    url1,url2,...``): requests prefer the first endpoint whose circuit
    breaker is closed.  A connection-level failure (refused, reset,
    timeout — the endpoint itself is suspect) opens that endpoint's
    breaker for a jittered-backoff window and the next attempt moves to
    a sibling, health-probed first (``GET /v1/health``) so a dead
    sibling costs one cheap GET, not a full request cycle.  An HTTP
    error (the endpoint answered — it is alive, just loaded or
    refusing) never trips the breaker.  Failing over is never silent:
    it is printed, counted (``failovers``), and stamped into
    ``meta.health``."""

    def __init__(self, url: str, token: str, tenant: str = "default",
                 timeout_s: float = 10.0, retries: int = 4,
                 backoff_s: float = 0.5, backoff_cap_s: float = 30.0,
                 rng=None):
        self.endpoints = [u.strip().rstrip("/") for u in url.split(",")
                          if u.strip()]
        self.base = self.endpoints[0] if self.endpoints \
            else url.rstrip("/")
        self.token = token
        self.tenant = tenant
        self.timeout_s = max(float(timeout_s), 0.1)
        self.retries = max(int(retries), 0)
        self.backoff_s = max(float(backoff_s), 0.0)
        self.backoff_cap_s = max(float(backoff_cap_s), self.backoff_s)
        import random

        self.rng = rng if rng is not None else random
        # transparency counters the agent folds into meta.agent
        self.attempts = 0
        self.retried = 0
        self.failovers = 0
        #: url -> (consecutive fails, monotonic open-until) — the
        #: per-endpoint circuit breaker ledger
        self._breaker: Dict[str, tuple] = {}
        # cross-process push trace id (docs/FLEET.md "Observing the
        # tier"): when set, every request carries it as X-Sofa-Trace so
        # the service's spans join the agent's under ONE id
        self.trace_id = ""

    # -- circuit breaker ---------------------------------------------------
    def _note_endpoint_down(self, url: str) -> None:
        fails, _until = self._breaker.get(url, (0, 0.0))
        fails += 1
        hold = jittered_backoff(fails - 1, self.backoff_s,
                                self.backoff_cap_s, self.rng)
        self._breaker[url] = (fails, time.monotonic() + hold)

    def _note_endpoint_up(self, url: str) -> None:
        self._breaker.pop(url, None)

    def breaker_open(self, url: str) -> bool:
        """True while the endpoint is untrusted — its ledger entry
        stands until a request on it succeeds (``_note_endpoint_up``).
        The jittered hold only delays when ``_select_endpoint`` starts
        health-probing it again; a probe pass still routes ONE request
        there before the ledger clears, so expiry alone never re-opens
        this answer."""
        fails, _until = self._breaker.get(url, (0, 0.0))
        return fails > 0

    def check_health(self, url: str) -> bool:
        """``GET /v1/health`` (unauthenticated, like the server's ping):
        True only for an endpoint that is up AND accepting — a draining
        worker answers 503 here, so the breaker routes around a rolling
        restart without burning a real push on it."""
        req = urllib.request.Request(f"{url}/v1/health")
        try:
            with urllib.request.urlopen(
                    req, timeout=min(self.timeout_s, 3.0)) as resp:
                doc = json.loads(resp.read() or b"{}")
        except (OSError, ValueError, urllib.error.URLError):
            return False
        return bool(isinstance(doc, dict) and doc.get("ok", True))

    def _select_endpoint(self) -> str:
        """The endpoint this attempt should use: first closed-breaker
        endpoint in preference order (a previously-failed one must pass
        a health probe before being trusted again).  With EVERY breaker
        open, the one that re-closes soonest — the client never refuses
        to try at all; the service may be back."""
        now = time.monotonic()
        best, best_until = None, None
        for url in self.endpoints:
            fails, until = self._breaker.get(url, (0, 0.0))
            if until <= now:
                if fails == 0 or self.check_health(url):
                    return url
                # the probe said no: re-open and keep looking
                self._note_endpoint_down(url)
                _f, until = self._breaker.get(url, (0, 0.0))
            if best_until is None or until < best_until:
                best, best_until = url, until
        return best or self.base

    # -- single attempt ----------------------------------------------------
    def _attempt(self, method: str, path: str, body: "bytes | None",
                 op: str, key: str) -> dict:
        url = f"{self.base}{path}"
        self.attempts += 1
        try:
            spec = faults.maybe_service_fault(op, key)
            if spec is not None:
                if spec.kind == "conn_refused":
                    raise urllib.error.URLError(
                        ConnectionRefusedError("injected conn_refused"))
                if spec.kind == "conn_reset":
                    # the connection died mid-request: the ack (if any)
                    # is lost in flight and the request may or may not
                    # have landed server-side — exactly why every verb
                    # is idempotent (the retry is a committed no-op)
                    raise ConnectionResetError("injected conn_reset")
                if spec.kind == "stall":
                    # models the read deadline having expired — the
                    # exception the bounded timeout would raise, without
                    # actually burning the wall-clock
                    raise socket.timeout("injected stall")
                if spec.kind == "http_500":
                    raise urllib.error.HTTPError(
                        url, 500, "injected http_500", None, None)
                if spec.kind == "partial" and body and op == "put":
                    # truncated-upload fault: only object bodies — the
                    # SERVER's hash check is the rejection under test
                    # (a cut JSON control request would just be a 400)
                    body = body[:max(int(len(body) * spec.fraction), 1)]
            req = urllib.request.Request(url, data=body, method=method)
            req.add_header("Authorization", f"Bearer {self.token}")
            # the push deadline (absolute unix seconds): when THIS
            # request's read timeout expires the client is gone — a
            # worker that sees the deadline already passed abandons the
            # work instead of answering nobody (docs/FLEET.md)
            req.add_header(
                "X-Sofa-Deadline",
                f"{time.time() + self.timeout_s:.3f}")
            if self.trace_id:
                req.add_header("X-Sofa-Trace", self.trace_id)
            if body is not None:
                req.add_header("Content-Type", "application/octet-stream")
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            doc = _error_doc(e)
            if e.code in CLIENT_FATAL_STATUSES:
                raise ServiceRejected(
                    f"{op}: service rejected the token ({e.code})",
                    status=e.code) from None
            if e.code == 429 and doc.get("error") == ERR_QUOTA:
                raise ServiceRejected(
                    f"{op}: tenant {self.tenant!r} is over quota "
                    f"({doc.get('used_mb')}/{doc.get('quota_mb')} MB)",
                    status=429, quota=True) from None
            if e.code == 409:
                raise ServiceIncomplete(
                    f"{op}: commit refused, "
                    f"{len(doc.get('missing') or [])} object(s) missing "
                    "server-side", doc.get("missing")) from None
            if e.code in CLIENT_RETRY_STATUSES or \
                    e.code >= CLIENT_RETRY_FLOOR:
                raise ServiceUnavailable(
                    f"{op}: HTTP {e.code} ({doc.get('error') or e.reason})",
                    status=e.code,
                    retry_after=_retry_after(e)) from None
            raise ServiceRejected(f"{op}: HTTP {e.code} "
                                  f"({doc.get('error') or e.reason})",
                                  status=e.code) from None
        except (socket.timeout, TimeoutError) as e:
            raise ServiceUnavailable(f"{op}: timed out after "
                                     f"{self.timeout_s}s: {e}") from None
        except urllib.error.URLError as e:
            raise ServiceUnavailable(f"{op}: {e.reason}") from None
        except (ConnectionError, OSError, ValueError) as e:
            raise ServiceUnavailable(f"{op}: {e}") from None

    # -- retry loop --------------------------------------------------------
    def _call(self, method: str, path: str, body: "bytes | None",
              op: str, key: str = "") -> dict:
        attempt = 0
        while True:
            if len(self.endpoints) > 1:
                url = self._select_endpoint()
                if url != self.base:
                    self.failovers += 1
                    print_warning(
                        f"service: failing over {self.base} -> {url} "
                        "(circuit breaker)")
                    self.base = url
            try:
                result = self._attempt(method, path, body, op, key)
                self._note_endpoint_up(self.base)
                return result
            except ServiceUnavailable as e:
                if e.status is None:
                    # connection-level (refused/reset/timeout): the
                    # ENDPOINT is suspect — open its breaker so the
                    # retry prefers a sibling.  An HTTP status means
                    # the endpoint answered; it stays trusted.
                    self._note_endpoint_down(self.base)
                if attempt >= self.retries:
                    raise
                delay = jittered_backoff(attempt, self.backoff_s,
                                         self.backoff_cap_s, self.rng)
                if e.retry_after is not None:
                    delay = min(max(delay, float(e.retry_after)),
                                self.backoff_cap_s)
                self.retried += 1
                attempt += 1
                time.sleep(delay)

    # -- protocol ----------------------------------------------------------
    def ping(self) -> dict:
        return self._call("GET", "/v1/ping", None, "ping")

    def have(self, files: Dict[str, dict]) -> dict:
        body = json.dumps({"files": files}).encode()
        return self._call("POST", f"/v1/{self.tenant}/have", body, "have")

    def put_object(self, sha: str, data: bytes) -> dict:
        return self._call("PUT", f"/v1/{self.tenant}/object/{sha}", data,
                          "put", key=sha)

    def commit(self, doc: dict) -> dict:
        body = json.dumps(doc).encode()
        return self._call("POST", f"/v1/{self.tenant}/commit", body,
                          "commit")


def _error_doc(e: urllib.error.HTTPError) -> dict:
    try:
        doc = json.loads(e.read() or b"{}")
        return doc if isinstance(doc, dict) else {}
    except (OSError, ValueError, AttributeError):
        return {}


def _retry_after(e: urllib.error.HTTPError) -> Optional[float]:
    try:
        v = (e.headers or {}).get("Retry-After")
        return float(v) if v is not None else None
    except (TypeError, ValueError):
        return None


def client_from_cfg(cfg, rng=None) -> "ServiceClient | None":
    """A client for the configured service, or None in spool-only mode
    (no ``--service`` / SOFA_AGENT_SERVICE)."""
    from sofa_tpu_torch.archive.service import resolve_token

    url = (getattr(cfg, "agent_service", "")
           or os.environ.get("SOFA_AGENT_SERVICE", "") or "").strip()
    if not url:
        return None
    return ServiceClient(
        url, resolve_token(cfg),
        tenant=getattr(cfg, "fleet_tenant", "default") or "default",
        timeout_s=getattr(cfg, "agent_timeout_s", 10.0),
        retries=getattr(cfg, "agent_retries", 4),
        backoff_s=getattr(cfg, "agent_backoff_s", 0.5),
        backoff_cap_s=getattr(cfg, "agent_backoff_cap_s", 30.0),
        rng=rng)


def push_run(store, run_id: str, client: ServiceClient) -> dict:
    """Push one spooled run to the service; idempotent and resumable.

    Always begins from the server's have-list, so only objects the
    server lacks travel; returns ``{"run", "status", "objects_sent",
    "bytes_sent", "new", "server": <commit ack>}``.  Raises the client's
    typed exceptions on failure — the caller (agent.py) owns
    the spool-and-retry-later decision."""
    doc = store.load_run(run_id)
    if doc is None:
        raise ServiceRejected(
            f"spooled run {run_id[:12]} has no readable run doc — run "
            "`archive fsck` on the spool", status=None)
    files = doc.get("files") or {}
    sent = 0
    sent_bytes = 0
    for round_no in (1, 2):
        have = client.have(files)
        if have.get("committed"):
            return {"run": run_id, "status": "committed", "new": False,
                    "objects_sent": sent, "bytes_sent": sent_bytes,
                    "server": have}
        for sha in have.get("missing") or []:
            data = store.read_object(sha)
            if data is None:
                raise ServiceRejected(
                    f"spool object {sha[:12]} is unreadable — run "
                    "`archive fsck` on the spool", status=None)
            client.put_object(sha, data)
            sent += 1
            sent_bytes += len(data)
        try:
            ack = client.commit(doc)
            return {"run": run_id, "status": "pushed",
                    "new": bool(ack.get("new")), "objects_sent": sent,
                    "bytes_sent": sent_bytes, "server": ack}
        except ServiceIncomplete as e:
            # an object vanished between have and commit (gc racing a
            # slow push, or a competing agent's store sweep): one more
            # have->put->commit round resolves it, a second miss is real
            if round_no == 2:
                raise ServiceUnavailable(
                    f"commit still missing {len(e.missing)} object(s) "
                    "after a resume round") from None
            print_warning(
                f"push {run_id[:12]}: server reports "
                f"{len(e.missing)} object(s) missing at commit — "
                "resuming from a fresh have-list")
    raise ServiceUnavailable("unreachable")  # pragma: no cover
