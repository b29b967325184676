"""``serve``: the authenticated, multi-tenant write service of the fleet
(the JAX package's ``sofa_tpu/archive/service.py``, at one primary
worker).

Agents (``agent.py``) push finished runs into it.  The unit of upload is
one content-addressed object: the client POSTs the run's ``(rel ->
sha256)`` file map to ``have`` and gets back the objects the service
lacks, PUTs only those (each body re-hashed: a mismatch is a 422, so a
torn upload never reaches the store), then POSTs ``commit``.  A re-sent
object and a replayed commit are no-ops, so an upload interrupted anywhere
resumes from a fresh have-list.

Each tenant is an archive root under ``<root>/tenants/<tenant>/``.
``--quota_mb`` caps a tenant's object store (429 ``{"error": "quota"}``).
More than ``--max_inflight`` concurrent writes, or a tenant root mid-gc,
answers 503 with ``Retry-After``.  Every commit is write-ahead: one
fsync'd WAL record (``archive/tier.py``), acked once the drainer applied
it; the index refresh runs after the ack.  SIGTERM stops new writes
(``draining``), drains the WAL to empty and exits 0.

The bearer token (``--token`` / ``SOFA_SERVE_TOKEN``) is compared in
constant time; without one the service refuses to start.
``SOFA_SERVE_EXIT_AFTER=<n>`` hard-exits the process (86) at the start of
the n-th write request: the kill-service-mid-upload cell.

Not ported yet (the fleet tier), each refused by name (see
``UNPORTED_SERVE``): the worker pool (``--workers`` above 1), read
replicas (``--replica-of``), SLOs (``--slo``), the rolling restart
(``--rolling-restart``): usage errors, exit 2; and the routes ``GET
/v1/tier``, ``/v1/metrics`` and ``/v1/<tenant>/fleet``: 404 ``{"error":
"no_such_route", "unported": "fleet tier"}``.
"""

from __future__ import annotations

import errno
import hashlib
import hmac
import http.server
import json
import os
import re
import time
import urllib.parse
from typing import Dict, List, Tuple

from sofa_tpu_torch.archive import catalog, tier
from sofa_tpu_torch.archive.protocol import (
    ERR_BAD_FILES_MAP, ERR_BAD_JSON, ERR_BAD_KIND, ERR_BAD_PARAMS,
    ERR_BAD_TENANT, ERR_BROWNOUT, ERR_DEADLINE_EXPIRED, ERR_DRAINING,
    ERR_HASH_MISMATCH, ERR_LENGTH_REQUIRED, ERR_LOADED, ERR_MID_GC,
    ERR_MISSING_OBJECTS, ERR_NO_INDEX, ERR_NO_SPACE, ERR_NO_SUCH_CHUNK,
    ERR_NO_SUCH_ROUTE, ERR_NO_SUCH_RUN, ERR_QUOTA, ERR_TOO_LARGE,
    ERR_UNAUTHORIZED, ERR_WAL_BACKLOG)
from sofa_tpu_torch.archive.store import ArchiveStore, run_content_id
from sofa_tpu_torch.concurrency import Guard
from sofa_tpu_torch.durability import FLEET_MARKER_NAME
from sofa_tpu_torch.printing import print_error, print_progress, print_warning

SERVICE_SCHEMA = "sofa_tpu/fleet_service"
# Bumps on a breaking route or payload change; additive keys do not.
SERVICE_VERSION = 1

TENANTS_DIR_NAME = "tenants"

# What the JAX service has and this one refuses by name until the tier is
# ported: the options (usage errors, exit 2) and the routes (404 with
# ``"unported": UNPORTED_MODULE``).
UNPORTED_MODULE = "fleet tier"
UNPORTED_OPTIONS = (("serve_workers", "--workers above 1"),
                    ("serve_replica_of", "--replica-of"),
                    ("serve_slo", "--slo"),
                    ("serve_rolling_restart", "--rolling-restart"))
UNPORTED_SERVE = tuple(flag for _f, flag in UNPORTED_OPTIONS) + (
    "GET /v1/tier", "GET /v1/metrics", "GET /v1/<tenant>/fleet")

_TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")
_SHA_RE = re.compile(r"^[0-9a-f]{64}$")

# One object per request keeps memory bounded; anything larger in a
# logdir is a misconfiguration.
_MAX_BODY = 1 << 30

_RETRY_AFTER_S = "1"

# An ``X-Sofa-Deadline`` further out than this is a skewed client clock:
# treated as absent, never obeyed.
_DEADLINE_SKEW_CAP_S = 24 * 3600.0

# The CORS grant of the read-only query route (the fleet board is served
# from another origin).  Writes carry no CORS header.
_CORS_HEADERS = (
    ("Access-Control-Allow-Origin", "*"),
    ("Access-Control-Allow-Headers", "Authorization, If-None-Match"),
    ("Access-Control-Allow-Methods", "GET, OPTIONS"),
)


def _chaos_exit_after() -> int:
    """The kill-service-mid-upload knob (0 = off)."""
    try:
        return int(os.environ.get("SOFA_SERVE_EXIT_AFTER", "0"))
    except ValueError:
        return 0


class _FleetServer(http.server.ThreadingHTTPServer):
    """The state shared by the handler threads, under one guard: the
    response counters, the in-flight write gauge, the per-tenant byte
    ledger, ``draining``; and the WAL drainer, stopped in
    ``server_close``."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, handler, root: str, token: str,
                 quota_mb: float = 0.0, max_inflight: int = 8):
        super().__init__(addr, handler)
        from sofa_tpu_torch import metrics

        self.root = os.path.abspath(root)
        self.token = token
        self.quota_bytes = int(max(quota_mb, 0.0) * 2 ** 20)
        self.max_inflight = max(int(max_inflight), 1)
        self.worker = 0
        self.workers = 1
        self.role = "primary"
        self._state_guard = Guard("serve.state", protects=(
            "stats", "inflight", "tenant_bytes", "writes_handled",
            "drainer", "draining", "_wal_depth", "_appenders"))
        self.stats: Dict[str, int] = {}
        self.inflight = 0
        self.tenant_bytes: Dict[str, int] = {}
        self.writes_handled = 0
        # SIGTERM sets it: new writes answer 503 ``draining`` while the
        # WAL empties
        self.draining = False
        # tenant -> (sampled monotonic, depth): the admission check's
        # once-a-second WAL depth
        self._wal_depth: Dict[str, Tuple[float, int]] = {}
        self._appenders: Dict[str, tier.WalAppender] = {}
        self.metrics = metrics.for_root(self.root, worker=self.worker)
        self.drainer = tier.Drainer(self.root, worker=self.worker,
                                    workers=self.workers)
        self.drainer.start()

    def server_close(self):
        # detach under the guard, stop outside it: stop() joins threads
        with self._state_guard:
            drainer, self.drainer = self.drainer, None
        if drainer is not None:
            drainer.stop()
        super().server_close()

    # -- the write-ahead queue ---------------------------------------------
    def tier_append(self, tenant: str, record: dict) -> Tuple[str, int]:
        """Durably append a commit record to this worker's WAL file of the
        tenant, and kick the drainer."""
        with self._state_guard:
            app = self._appenders.get(tenant)
            if app is None:
                app = tier.WalAppender(self.tenant_root(tenant),
                                       self.worker)
                self._appenders[tenant] = app
            drainer = self.drainer
        name, end = app.append(record)
        if drainer is not None:
            drainer.kick()
        return name, end

    def tier_wait_applied(self, tenant: str, name: str, end: int,
                          timeout_s: "float | None" = None) -> bool:
        """The commit ack's wait (read your writes): until the drainer
        applied the record, at most COMMIT_APPLY_TIMEOUT_S or the request's
        deadline."""
        with self._state_guard:
            drainer = self.drainer
        if drainer is None:
            return False
        wait = tier.COMMIT_APPLY_TIMEOUT_S if timeout_s is None \
            else max(min(timeout_s, tier.COMMIT_APPLY_TIMEOUT_S), 0.0)
        return drainer.wait_local(tenant, name, end, timeout_s=wait)

    # -- counters ----------------------------------------------------------
    def count_response(self, key: str) -> None:
        with self._state_guard:
            self.stats[key] = self.stats.get(key, 0) + 1
        self.metrics.inc("responses")

    def count_refusal(self, key: str) -> None:
        """A typed refusal (draining, brownout, deadline, backlog): the
        stats key and the ``refusals`` counter."""
        self.count_response(key)
        self.metrics.inc("refusals")

    def stats_line(self) -> "str | None":
        with self._state_guard:
            stats = dict(self.stats)
        if not stats:
            return None
        return ", ".join(f"{v} {k}" for k, v in sorted(stats.items()))

    # -- backpressure ------------------------------------------------------
    def write_slot(self, wait_s: float = 0.5) -> bool:
        """Claim an in-flight write slot, waiting up to ``wait_s`` for one
        (an immediate 503 turns a brief load into a retry storm); False:
        loaded, answer 503."""
        deadline = time.monotonic() + wait_s
        while True:
            with self._state_guard:
                if self.inflight < self.max_inflight:
                    self.inflight += 1
                    return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.005)

    def release_slot(self) -> None:
        with self._state_guard:
            self.inflight = max(self.inflight - 1, 0)

    def is_draining(self) -> bool:
        with self._state_guard:
            return bool(self.draining)

    def wal_pressure(self, tenant: str) -> int:
        """The tenant's unapplied WAL depth for the admission check,
        sampled at most once a second."""
        now = time.monotonic()
        with self._state_guard:
            ts, depth = self._wal_depth.get(tenant, (0.0, -1))
            if depth >= 0 and now - ts < 1.0:
                return depth
        depth = tier.wal_depth(self.tenant_root(tenant))
        with self._state_guard:
            self._wal_depth[tenant] = (time.monotonic(), depth)
        return depth

    def max_cached_wal_depth(self) -> int:
        """The worst sampled WAL depth over the tenants (``/v1/health``'s
        brownout signal)."""
        with self._state_guard:
            return max((d for _ts, d in self._wal_depth.values()),
                       default=0)

    def chaos_tick(self) -> None:
        """Count a write request; hard-exit 86 at the chaos threshold."""
        n = _chaos_exit_after()
        if not n:
            return
        with self._state_guard:
            self.writes_handled += 1
            fire = self.writes_handled >= n
        if fire:
            os._exit(86)

    # -- tenancy and quota -------------------------------------------------
    def tenant_root(self, tenant: str) -> str:
        return os.path.join(self.root, TENANTS_DIR_NAME, tenant)

    def tenant_store(self, tenant: str) -> ArchiveStore:
        return ArchiveStore(self.tenant_root(tenant), create=True)

    def tenant_used_bytes(self, tenant: str) -> int:
        """The tenant's object-store size: walked once per tenant (outside
        the guard), then kept up to date by each accepted upload."""
        with self._state_guard:
            cached = self.tenant_bytes.get(tenant)
        if cached is not None:
            return cached
        used = 0
        obj_root = os.path.join(self.tenant_root(tenant), "objects")
        for dirpath, _dirs, names in os.walk(obj_root):
            for name in names:
                try:
                    used += os.path.getsize(os.path.join(dirpath, name))
                except OSError:
                    continue
        with self._state_guard:
            self.tenant_bytes.setdefault(tenant, used)
            return self.tenant_bytes[tenant]

    def charge_tenant(self, tenant: str, n: int) -> None:
        with self._state_guard:
            self.tenant_bytes[tenant] = self.tenant_bytes.get(tenant, 0) + n

    def auth_ok(self, header: "str | None") -> bool:
        if not header or not header.startswith("Bearer "):
            return False
        return hmac.compare_digest(header[len("Bearer "):], self.token)


class _FleetHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # the status line and the body land in separate writes: without
    # NODELAY, Nagle holds the second behind the peer's delayed ACK
    disable_nagle_algorithm = True
    server_version = "sofa_tpu-serve"

    def log_message(self, fmt, *args):  # noqa: A003
        pass

    # -- plumbing ----------------------------------------------------------
    def _json(self, code: int, doc: dict,
              retry_after: "str | None" = None,
              extra_headers: "List[tuple] | None" = None) -> None:
        body = json.dumps(doc).encode()
        if code >= 400 and self.command in ("POST", "PUT"):
            # an error answered before the body was read would leave its
            # bytes in the socket and desync keep-alive: close instead
            self.close_connection = True
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            self.send_header("Retry-After", retry_after)
        for key, value in extra_headers or ():
            self.send_header(key, value)
        self.end_headers()
        try:
            self.wfile.write(body)
        except OSError:
            self._count("client_disconnect")

    def _count(self, key: str) -> None:
        self.server.count_response(key)

    def _body(self) -> "bytes | None":
        """The request body, or None after answering an error."""
        try:
            n = int(self.headers.get("Content-Length") or "")
        except ValueError:
            self._json(411, {"error": ERR_LENGTH_REQUIRED})
            return None
        if n < 0 or n > _MAX_BODY:
            self._json(413, {"error": ERR_TOO_LARGE, "max_bytes": _MAX_BODY})
            return None
        data = self.rfile.read(n)
        if len(data) != n:
            # the client hung up mid-body; it will retry, nothing landed
            self._count("truncated_body")
            return None
        return data

    def _unported(self) -> None:
        """A route the JAX service has and this one does not yet."""
        self._count("404_unported")
        self._json(404, {"error": ERR_NO_SUCH_ROUTE,
                         "unported": UNPORTED_MODULE})

    def _route(self, allow_token_param: bool = False
               ) -> "Tuple[str, List[str]] | None":
        """(tenant, the path's segments under it) of an authenticated /v1/
        route; answers the error itself and returns None otherwise.
        ``allow_token_param`` also takes ``?token=`` (the read-only query
        route a board page polls cross-origin)."""
        parts = [p for p in self.path.split("?", 1)[0].split("/") if p]
        if len(parts) < 2 or parts[0] != "v1":
            self._json(404, {"error": ERR_NO_SUCH_ROUTE})
            return None
        if not self.server.auth_ok(self.headers.get("Authorization")):
            tok = None
            if allow_token_param:
                qs = urllib.parse.parse_qs(self.path.partition("?")[2])
                tok = (qs.get("token") or [None])[0]
            if not (tok and hmac.compare_digest(tok, self.server.token)):
                self._count("401_unauthorized")
                self._json(401, {"error": ERR_UNAUTHORIZED})
                return None
        tenant = parts[1]
        if not _TENANT_RE.match(tenant) or tenant in (
                TENANTS_DIR_NAME, "tier", "metrics", "..", "."):
            self._json(400, {"error": ERR_BAD_TENANT})
            return None
        return tenant, parts[2:]

    def _backpressure(self, tenant: str) -> bool:
        """True when answered 503: the tenant root is mid-gc (``archive
        gc`` holds the derived-write guard)."""
        from sofa_tpu_torch.trace import derived_writing

        if derived_writing(self.server.tenant_root(tenant)):
            self._count("503_mid_gc")
            self._json(503, {"error": ERR_MID_GC},
                       retry_after=_RETRY_AFTER_S)
            return True
        return False

    def _trace_id(self) -> str:
        """The push's trace id (X-Sofa-Trace); empty for untraced clients."""
        return self.headers.get("X-Sofa-Trace") or ""

    def _span(self, name: str, tenant: str, t0: float, **args) -> None:
        self.server.metrics.span(
            name, "service", t0, time.time() - t0,
            trace=self._trace_id(), tenant=tenant, **args)

    def _refuse(self, key: str, code: int, doc: dict,
                retry_after: "str | None" = _RETRY_AFTER_S) -> None:
        """One typed refusal, on the refusal counters."""
        self.server.count_refusal(key)
        self._json(code, doc, retry_after=retry_after)

    def _deadline_left_s(self) -> "float | None":
        """Seconds left on the request's ``X-Sofa-Deadline`` (absolute
        unix seconds, stamped by the client); None when it is absent,
        unparsable, or further out than the skew cap."""
        raw = self.headers.get("X-Sofa-Deadline")
        if not raw:
            return None
        try:
            deadline = float(raw)
        except ValueError:
            return None
        # the client's wall clock: the only one both processes share
        left = deadline - time.time()
        if left > _DEADLINE_SKEW_CAP_S:
            return None
        return left

    def _deadline_expired(self) -> bool:
        """True when refused as expired on arrival: the client gave up, so
        the work would answer nobody.  (The commit stays idempotent.)"""
        left = self._deadline_left_s()
        if left is None or left > 0:
            return False
        self._refuse("504_deadline_expired", 504,
                     {"error": ERR_DEADLINE_EXPIRED}, retry_after=None)
        return True

    # -- GET ---------------------------------------------------------------
    def do_GET(self):  # noqa: N802 — http.server handler contract
        clean = self.path.split("?", 1)[0]
        if clean == "/v1/ping":
            self._count("ping")
            self._json(200, {"ok": True, "schema": SERVICE_SCHEMA,
                             "version": SERVICE_VERSION})
            return
        if clean == "/v1/health":
            self._health()
            return
        if clean in ("/v1/tier", "/v1/metrics"):
            self._unported()
            return
        routed = self._route(allow_token_param=clean.endswith("/query"))
        if routed is None:
            return
        tenant, rest = routed
        store = ArchiveStore(self.server.tenant_root(tenant))
        if rest == ["catalog"]:
            self._catalog(tenant, store)
            return
        if rest == ["query"]:
            self._query(tenant, store)
            return
        if rest == ["fleet"]:
            self._unported()
            return
        if rest and rest[0] == "index":
            self._index_file(tenant, rest[1:])
            return
        if len(rest) == 2 and rest[0] == "run" and store.exists:
            doc = store.load_run(rest[1]) if _SHA_RE.match(rest[1]) else None
            if doc is None:
                self._json(404, {"error": ERR_NO_SUCH_RUN})
                return
            self._count("run_read")
            self._json(200, doc)
            return
        self._json(404, {"error": ERR_NO_SUCH_ROUTE})

    def do_OPTIONS(self):  # noqa: N802 — the board's CORS preflight
        # preflights carry no credentials by design: this grants nothing
        # but the right to ask
        if not self.path.startswith("/v1/"):
            self._json(404, {"error": ERR_NO_SUCH_ROUTE})
            return
        self.send_response(204)
        for key, value in _CORS_HEADERS:
            self.send_header(key, value)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _health(self) -> None:
        """``GET /v1/health``, the failover probe (unauthenticated like
        ping): 200 accepting, 503 draining; ``brownout`` says queries are
        being shed (the soft watermark)."""
        soft, hard = tier.wal_watermarks()
        depth = self.server.max_cached_wal_depth()
        draining = self.server.is_draining()
        doc = {"ok": not draining, "schema": SERVICE_SCHEMA,
               "version": SERVICE_VERSION, "role": self.server.role,
               "worker": self.server.worker, "draining": draining,
               "brownout": depth >= soft, "wal_depth": depth,
               "wal_soft": soft, "wal_hard": hard}
        if draining:
            self._refuse("503_draining", 503,
                         {"error": ERR_DRAINING, **doc})
            return
        self._count("health")
        self._json(200, doc)

    def _catalog_etag(self, store: ArchiveStore) -> Tuple[str, int]:
        """(ETag, size) keyed on the catalog's size and mtime: any append
        or rewrite moves it."""
        try:
            st = os.stat(catalog.catalog_path(store.root))
            return f'"cat-{st.st_size:x}-{st.st_mtime_ns:x}"', st.st_size
        except OSError:
            return '"cat-0-0"', 0

    def _catalog(self, tenant: str, store: ArchiveStore) -> None:
        """The raw catalog: Content-Length and ETag, 304 on If-None-Match,
        503 mid-gc; a client hanging up mid-stream is counted."""
        if self._backpressure(tenant):
            return
        etag, size = self._catalog_etag(store)
        if self.headers.get("If-None-Match") == etag:
            self._count("304_catalog")
            self.send_response(304)
            self.send_header("ETag", etag)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/jsonl")
        self.send_header("Content-Length", str(size))
        self.send_header("ETag", etag)
        self.end_headers()
        remaining = size
        try:
            with open(catalog.catalog_path(store.root), "rb") as f:
                while remaining > 0:
                    chunk = f.read(min(remaining, 1 << 16))
                    if not chunk:
                        break
                    self.wfile.write(chunk)
                    remaining -= len(chunk)
        except OSError:
            self._count("client_disconnect")
            return
        self._count("catalog_read")

    def _query(self, tenant: str, store: ArchiveStore) -> None:
        """``GET /v1/<tenant>/query``: filter, sort, limit and since over
        runs and features (``index.query``), ETag'd on the index commit
        sha (the catalog's size and mtime without an index), offset and
        limit pages.  Read-only: no write slot, no quota check."""
        from sofa_tpu_torch.archive import index as aindex

        if self._backpressure(tenant):
            return
        soft, _hard = tier.wal_watermarks()
        if self.server.wal_pressure(tenant) >= soft:
            # brownout: reads are the degradable load, shed first
            self._refuse("503_brownout", 503,
                         {"error": ERR_BROWNOUT, "tenant": tenant})
            return
        t0 = time.time()
        qs = urllib.parse.parse_qs(self.path.partition("?")[2])

        def one(key, default=None):
            return (qs.get(key) or [default])[0]

        kind = one("kind", "runs")
        if kind not in ("runs", "features"):
            self._json(400, {"error": ERR_BAD_KIND,
                             "kinds": ["runs", "features"]})
            return
        try:
            since = float(one("since")) if one("since") else None
            limit = int(one("limit") or aindex.QUERY_DEFAULT_LIMIT)
            offset = int(one("offset") or 0)
        except ValueError:
            self._json(400, {"error": ERR_BAD_PARAMS})
            return
        doc = aindex.query(store.root, kind=kind, host=one("host"),
                           label=one("label"), since=since,
                           feature=one("feature"), limit=limit,
                           offset=offset)
        if doc.get("commit_sha"):
            etag = f'"idx-{doc["commit_sha"]}"'
        else:
            etag, _size = self._catalog_etag(store)
        headers = [("ETag", etag)] + list(_CORS_HEADERS)
        if self.headers.get("If-None-Match") == etag:
            self._count("304_query")
            self.send_response(304)
            for key, value in headers:
                self.send_header(key, value)
            self.end_headers()
            return
        self._count(f"query_{doc.get('source', '?')}")
        reg = self.server.metrics
        reg.inc("queries")
        reg.inc(f"tenant_requests.{tenant}")
        reg.observe("query", (time.time() - t0) * 1e3)
        self._json(200, {"schema": SERVICE_SCHEMA,
                         "version": SERVICE_VERSION,
                         "tenant": tenant, **doc},
                   extra_headers=headers)

    _INDEX_FILE_RE = re.compile(r"^(\d{6}\.arrow|frame_index\.json)$")

    def _index_file(self, tenant: str, rest: List[str]) -> None:
        """``GET /v1/<t>/index/commit`` (ETag: the commit sha) and
        ``/v1/<t>/index/<family>/<chunk>``: the replica pull feed."""
        from sofa_tpu_torch.archive import index as aindex

        troot = self.server.tenant_root(tenant)
        if rest == ["commit"]:
            commit = aindex.load_commit(troot)
            if commit is None:
                self._json(404, {"error": ERR_NO_INDEX})
                return
            etag = f'"idx-{commit.get("commit_sha") or ""}"'
            if self.headers.get("If-None-Match") == etag:
                self._count("304_index_commit")
                self.send_response(304)
                self.send_header("ETag", etag)
                self.end_headers()
                return
            self._count("index_commit_read")
            self._json(200, commit, extra_headers=[("ETag", etag)])
            return
        if len(rest) == 2 and rest[0] in aindex.FAMILIES and \
                self._INDEX_FILE_RE.match(rest[1]):
            path = os.path.join(aindex.family_dir(troot, rest[0]), rest[1])
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                self._json(404, {"error": ERR_NO_SUCH_CHUNK})
                return
            self._count("index_chunk_read")
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            try:
                self.wfile.write(data)
            except OSError:
                self._count("client_disconnect")
            return
        self._json(404, {"error": ERR_NO_SUCH_ROUTE})

    # -- admission of a write ------------------------------------------------
    def _admit_write(self) -> bool:
        """Draining, the deadline, then a write slot; True with the slot
        held, else the refusal is answered."""
        if self.server.is_draining():
            self._refuse("503_draining", 503, {"error": ERR_DRAINING})
            return False
        if self._deadline_expired():
            return False
        if not self.server.write_slot():
            self._count("503_loaded")
            self._json(503, {"error": ERR_LOADED},
                       retry_after=_RETRY_AFTER_S)
            return False
        self._holds_slot = True
        return True

    def _drop_slot(self) -> None:
        """Release this request's write slot once.  A commit drops it
        before waiting on the drainer: the slot bounds storage writes, and
        a handler parked on a condition writes nothing."""
        if getattr(self, "_holds_slot", False):
            self._holds_slot = False
            self.server.release_slot()

    # -- POST (have / commit) ----------------------------------------------
    def do_POST(self):  # noqa: N802 — http.server handler contract
        routed = self._route()
        if routed is None:
            return
        tenant, rest = routed
        if rest not in (["have"], ["commit"]):
            self._json(404, {"error": ERR_NO_SUCH_ROUTE})
            return
        if not self._admit_write():
            return
        try:
            if self._backpressure(tenant):
                return
            self.server.chaos_tick()
            data = self._body()
            if data is None:
                return
            try:
                doc = json.loads(data)
            except ValueError:
                self._json(400, {"error": ERR_BAD_JSON})
                return
            files = doc.get("files") if isinstance(doc, dict) else None
            if not isinstance(files, dict) or not files or any(
                    not isinstance(e, dict)
                    or not _SHA_RE.match(str(e.get("sha256", "")))
                    for e in files.values()):
                self._json(400, {"error": ERR_BAD_FILES_MAP})
                return
            if rest == ["have"]:
                self._have(tenant, files)
            else:
                self._commit(tenant, doc, files)
        finally:
            self._drop_slot()

    def _committed(self, store: ArchiveStore, run_id: str) -> bool:
        """Whether the run is cataloged or queued in the WAL."""
        return any(e.get("run") == run_id
                   for e in catalog.read_catalog(store.root)
                   if e.get("ev") == "ingest") or \
            run_id in tier.wal_pending_runs(store.root)

    def _have(self, tenant: str, files: Dict[str, dict]) -> None:
        """The resume point: which of the run's objects the store holds,
        and whether the run is committed already."""
        t0 = time.time()
        store = self.server.tenant_store(tenant)
        run_id = run_content_id(files)
        shas = {e["sha256"] for e in files.values()}
        missing = sorted(s for s in shas if not store.has_object(s))
        committed = self._committed(store, run_id)
        self._count("have")
        self.server.metrics.inc(f"tenant_requests.{tenant}")
        self._span("have", tenant, t0, run=run_id)
        self._json(200, {"run": run_id, "have": len(shas) - len(missing),
                         "missing": missing, "committed": committed})

    def _commit(self, tenant: str, doc: dict,
                files: Dict[str, dict]) -> None:
        """The run's commit point, write-ahead: every referenced object
        must have landed; one fsync'd WAL record; the ack once the drainer
        applied it (the run doc and the catalog line).  A replayed commit
        of a committed run is a no-op."""
        from sofa_tpu_torch import metrics

        t0 = time.time()
        _soft, hard = tier.wal_watermarks()
        depth = self.server.wal_pressure(tenant)
        if depth >= hard:
            # bounded queueing: a WAL this deep would turn acks into
            # timeouts
            self._refuse("503_wal_depth", 503,
                         {"error": ERR_WAL_BACKLOG, "tenant": tenant,
                          "wal_depth": depth, "wal_hard": hard})
            return
        store = self.server.tenant_store(tenant)
        run_id = run_content_id(files)
        missing = sorted({e["sha256"] for e in files.values()
                          if not store.has_object(e["sha256"])})
        if missing:
            self._count("409_incomplete")
            self._json(409, {"error": ERR_MISSING_OBJECTS, "run": run_id,
                             "missing": missing})
            return
        already = self._committed(store, run_id)
        if not already:
            rec = {
                "run": run_id,
                "logdir": str(doc.get("logdir", "")),
                "hostname": str(doc.get("hostname", "")),
                "label": str(doc.get("label", "")),
                "tenant": tenant,
                "files": files,
                "features": doc.get("features") or {},
            }
            if self._trace_id():
                rec["trace"] = self._trace_id()
            try:
                name, end = self.server.tier_append(tenant, rec)
            except OSError as e:
                if getattr(e, "errno", None) != errno.ENOSPC:
                    raise
                # nothing was made durable, so nothing may be acked
                self._refuse("507_disk_full", 507,
                             {"error": ERR_NO_SPACE, "run": run_id})
                return
            self._drop_slot()  # the record is durable; the wait is memory
            if not self.server.tier_wait_applied(
                    tenant, name, end, timeout_s=self._deadline_left_s()):
                # queued durably, but the drainer is behind: come back
                # (the replayed commit is a no-op)
                self._count("503_wal_backlog")
                self._json(503, {"error": ERR_WAL_BACKLOG, "run": run_id},
                           retry_after=_RETRY_AFTER_S)
                return
        self._count("commit" if not already else "commit_replayed")
        reg = self.server.metrics
        reg.inc("pushes")
        reg.inc(f"tenant_requests.{tenant}")
        reg.observe("push", (time.time() - t0) * 1e3)
        self._span("commit", tenant, t0, run=run_id, new=not already)
        self._json(200, {
            "run": run_id, "committed": True, "new": not already,
            "tenant": tenant,
            "quota_used_mb": round(
                self.server.tenant_used_bytes(tenant) / 2 ** 20, 3),
            "tier": {"schema": tier.TIER_SCHEMA,
                     "version": tier.TIER_VERSION,
                     "worker": self.server.worker,
                     "workers": self.server.workers,
                     "wal_depth": tier.wal_depth(store.root)},
            "metrics": metrics.metrics_summary(reg),
        })

    # -- PUT (one content-addressed object) ----------------------------------
    def do_PUT(self):  # noqa: N802 — http.server handler contract
        routed = self._route()
        if routed is None:
            return
        tenant, rest = routed
        if len(rest) != 2 or rest[0] != "object" or \
                not _SHA_RE.match(rest[1]):
            self._json(404, {"error": ERR_NO_SUCH_ROUTE})
            return
        sha = rest[1]
        t0 = time.time()
        if not self._admit_write():
            return
        try:
            if self._backpressure(tenant):
                return
            self.server.chaos_tick()
            store = self.server.tenant_store(tenant)
            if store.has_object(sha):
                # a re-sent object costs a stat; the body still drains
                if self._body() is None:
                    return
                self._count("object_dedup")
                self._json(200, {"sha256": sha, "new": False})
                return
            data = self._body()
            if data is None:
                return
            quota = self.server.quota_bytes
            used = self.server.tenant_used_bytes(tenant)
            if quota and used + len(data) > quota:
                self._count("429_quota")
                self._json(429, {
                    "error": ERR_QUOTA, "tenant": tenant,
                    "quota_mb": round(quota / 2 ** 20, 3),
                    "used_mb": round(used / 2 ** 20, 3)},
                    retry_after=_RETRY_AFTER_S)
                return
            got = hashlib.sha256(data).hexdigest()
            if got != sha:
                # a truncated or corrupted upload: the store only ever
                # holds bytes that hash to their name
                self._count("422_hash_mismatch")
                self._json(422, {"error": ERR_HASH_MISMATCH,
                                 "expected": sha, "got": got})
                return
            _, added = store.put_bytes(data)
            if added:
                self.server.charge_tenant(tenant, added)
            self._count("object_stored" if added else "object_dedup")
            self.server.metrics.inc("objects_put")
            self.server.metrics.inc(f"tenant_requests.{tenant}")
            self._span("put_object", tenant, t0, sha=sha[:12],
                       bytes=len(data))
            self._json(200, {"sha256": sha, "new": bool(added)})
        finally:
            self._drop_slot()


def graceful_drain(httpd) -> int:
    """The SIGTERM drain: with the accept loop stopped and new writes
    refused, apply every owned tenant's pending WAL records to empty.
    Returns the records applied; every ack ever sent is then state on
    disk."""
    with httpd._state_guard:
        drainer = httpd.drainer
    applied = 0
    if drainer is not None:
        drainer.stop()
        for tenant in drainer.owned_tenants():
            troot = httpd.tenant_root(tenant)
            if not os.path.isdir(tier.wal_dir(troot)):
                continue
            try:
                stats = tier.drain_tenant(troot)
            except OSError as e:
                print_warning(f"serve: drain-on-term for tenant "
                              f"{tenant} failed: {e}")
                continue
            applied += stats["applied"] + stats["replayed"]
    print_progress(f"serve: worker {httpd.worker} drained "
                   f"{applied} WAL record(s) on SIGTERM — exiting 0")
    return applied


def _install_sigterm_drain(httpd):
    """On the main thread: a SIGTERM sets ``draining`` and stops the
    accept loop from a helper thread (``shutdown()`` waits for
    ``serve_forever``, which the handler interrupts, so a direct call
    deadlocks).  Returns the event that says a SIGTERM came."""
    import signal
    import threading

    got_term = threading.Event()

    def _on_term(signum, frame):  # noqa: ARG001 — signal handler contract
        got_term.set()
        with httpd._state_guard:
            httpd.draining = True
        threading.Thread(target=httpd.shutdown, daemon=True,
                         name="sofa-serve-drain").start()

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _on_term)
    return got_term


def _write_fleet_marker(root: str) -> None:
    """Initialize, or verify, the served root's marker: a root created by
    another protocol version is refused."""
    from sofa_tpu_torch.trace import atomic_write

    marker = os.path.join(root, FLEET_MARKER_NAME)
    if os.path.isfile(marker):
        try:
            with open(marker) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            raise OSError(f"unreadable {FLEET_MARKER_NAME}: {e}") from None
        if not isinstance(doc, dict) or doc.get("schema") != SERVICE_SCHEMA:
            raise OSError(f"{marker} is not a fleet-service root marker")
        if doc.get("version") != SERVICE_VERSION:
            raise OSError(
                f"{root} was created by fleet-service protocol "
                f"v{doc.get('version')}, this build speaks "
                f"v{SERVICE_VERSION} — refusing to serve a layout it "
                "might misread")
        return
    os.makedirs(os.path.join(root, TENANTS_DIR_NAME), exist_ok=True)
    with atomic_write(marker, fsync=True) as f:
        json.dump({"schema": SERVICE_SCHEMA, "version": SERVICE_VERSION,
                   "created_unix": round(time.time(), 3)}, f)


def resolve_token(cfg=None) -> str:
    """The shared bearer token: ``--token``, else SOFA_SERVE_TOKEN."""
    tok = getattr(cfg, "serve_token", "") if cfg is not None else ""
    return tok or os.environ.get("SOFA_SERVE_TOKEN", "")


def unported_options(cfg) -> List[str]:
    """The options of ``cfg`` that need the fleet tier."""
    out = []
    for field, flag in UNPORTED_OPTIONS:
        value = getattr(cfg, field, None)
        if (int(value or 1) > 1 if field == "serve_workers" else value):
            out.append(flag)
    return out


def sofa_serve(cfg, root: "str | None" = None, serve_forever: bool = True):
    """``serve <root>``: run the fleet ingest service.

    With ``serve_forever`` returns the exit code (0 a clean stop, 2 a
    usage error); otherwise the bound server (the caller drives
    ``serve_forever()`` on a thread of its own and ends with ``shutdown``
    and ``server_close``), or None on a usage error."""
    from sofa_tpu_torch.archive import resolve_root
    from sofa_tpu_torch.viz import display_host

    root = root or resolve_root(cfg)
    unported = unported_options(cfg)
    if unported:
        print_error(f"serve: {', '.join(unported)} need the "
                    f"{UNPORTED_MODULE}, which sofa_tpu_torch does not have "
                    "yet (one primary worker only)")
        return 2 if serve_forever else None
    token = resolve_token(cfg)
    if not token:
        print_error(
            "serve needs an auth token: --token <secret> or the "
            "SOFA_SERVE_TOKEN env var (an unauthenticated write service "
            "is refused, not degraded)")
        return 2 if serve_forever else None
    try:
        _write_fleet_marker(root)
    except OSError as e:
        print_error(f"serve: cannot initialize {root}: {e}")
        return 2 if serve_forever else None
    quota_mb = float(getattr(cfg, "serve_quota_mb", 0.0) or 0.0)
    max_inflight = int(getattr(cfg, "serve_max_inflight", 8) or 8)
    bind = getattr(cfg, "serve_bind", "127.0.0.1")
    base_port = int(getattr(cfg, "serve_port", 8044) or 0)
    httpd = None
    last_err = None
    ports = [0] if base_port == 0 else range(base_port, base_port + 20)
    for port_try in ports:
        try:
            httpd = _FleetServer((bind, port_try), _FleetHandler,
                                 root=root, token=token, quota_mb=quota_mb,
                                 max_inflight=max_inflight)
            break
        except OSError as e:
            last_err = e
            if getattr(e, "errno", None) != errno.EADDRINUSE:
                break
    if httpd is None:
        print_error(f"serve: cannot bind {bind} near port {base_port}: "
                    f"{last_err}")
        return 2 if serve_forever else None
    port = httpd.server_address[1]
    host = display_host(bind)
    print_progress(
        f"fleet archive service: {root} at http://{host}:{port}/v1/ "
        f"(tenants under {TENANTS_DIR_NAME}/; "
        + (f"quota {quota_mb:g} MB/tenant; " if quota_mb else "")
        + f"max {max_inflight} in-flight write(s); Ctrl-C stops)")
    print_progress(
        "push with: python -m sofa_tpu_torch agent <watch_dir> --service "
        f"http://{host}:{port} --token <secret>")
    if not serve_forever:
        return httpd
    got_term = _install_sigterm_drain(httpd)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if got_term.is_set():
            graceful_drain(httpd)
        httpd.server_close()
        served = httpd.stats_line()
        if served:
            print_progress(f"serve handled: {served}")
    return 0


def service_url(httpd) -> str:
    """The base URL of a bound server."""
    host, port = httpd.server_address[:2]
    if host in ("0.0.0.0", "::", ""):
        host = "127.0.0.1"
    return f"http://{host}:{port}"
