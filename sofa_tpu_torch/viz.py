"""viz: serve the board over the logdir (host only, no card needed).

  * ``ThreadingHTTPServer``: a zoom's burst of tile requests must not wait
    behind one large CSV download.
  * ETag and ``If-None-Match`` on every file, with ``Cache-Control``:
    derived files change between runs, so revalidation is a cheap 304.
  * gzip negotiation for the pre-gzipped tiles (``_tiles/<series>/<level>/
    <n>.json.gz``): the bytes go out as they are to a client that accepts
    gzip and are decompressed for one that does not.  ``/tiles/...`` is an
    alias of ``/_tiles/...``.
  * 503 with ``Retry-After`` on data files while a pipeline verb holds the
    derived-write guard (``trace.derived_write_guard``): a board refresh
    racing ``preprocess`` is told to retry, never given a torn file.
    ``live`` epochs never raise that guard: every live write is by
    tmp+rename, so a request during an epoch gets the last committed
    generation, and the board polls ``meta.live`` to grow the timeline.
  * ``/archive/<rel>``: the archive root (``--archive_root``, else
    ``SOFA_ARCHIVE_ROOT``, else ``./sofa_archive``), read-only, when it is
    one: the catalog, the run docs and the objects that
    ``archive-diff.html`` fetches.  A path with a ``..`` component is
    refused (404); archive files land by tmp+rename and objects never
    change, so the logdir's mid-write 503 does not apply to them.
"""

from __future__ import annotations

import errno
import functools
import gzip
import http.server
import io
import os
import posixpath
import socket
import threading
import urllib.parse

from sofa_tpu_torch.printing import print_progress, print_warning
from sofa_tpu_torch.trace import derived_writing, reap_stale_sentinel

# Answered 503 while the guard is up: the data, not the pages' chrome.
_DATA_SUFFIXES = (".csv", ".json", ".json.gz")
PORT_TRIES = 20


class BoardServer(http.server.ThreadingHTTPServer):
    """The board's server, with a request ledger that handler threads
    share under a lock (printed when viz stops)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._stats_lock = threading.Lock()
        self.stats: dict = {}

    def count_response(self, key: str) -> None:
        with self._stats_lock:
            self.stats[key] = self.stats.get(key, 0) + 1

    def stats_line(self):
        with self._stats_lock:
            stats = dict(self.stats)
        return ", ".join(f"{v} {k}" for k, v in sorted(stats.items())) \
            or None


def display_host(bind: str) -> str:
    """A host the user can reach for a bind address: the machine's name
    for a wildcard bind, localhost for loopback, brackets for IPv6."""
    if bind in ("127.0.0.1", "::1"):
        return "localhost"
    if bind in ("", "0.0.0.0", "::"):
        try:
            return socket.gethostname() or "localhost"
        except OSError:
            return "localhost"
    if ":" in bind:
        return f"[{bind}]"
    return bind


class BoardHandler(http.server.SimpleHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive across a zoom's tile burst
    server_version = "sofa_tpu_torch"

    def log_message(self, fmt, *args):  # noqa: A003
        pass

    def __init__(self, *args, archive_root=None, **kwargs):
        self.archive_root = archive_root
        super().__init__(*args, **kwargs)

    def _translate_archive(self, path: str):
        """``/archive/<rel>`` under the archive root; None when a component
        is ``..``."""
        rel = urllib.parse.unquote(
            path.split("?", 1)[0].split("#", 1)[0])[len("/archive/"):]
        parts = [p for p in rel.split("/") if p and p != "."]
        if ".." in parts:
            return None
        return os.path.join(os.path.abspath(self.archive_root), *parts)

    def translate_path(self, path):  # noqa: A003
        clean = path.split("?", 1)[0].split("#", 1)[0]
        if clean.startswith("/tiles/"):
            path = "/_tiles/" + path[len("/tiles/"):]
        elif clean.startswith("/archive/") and self.archive_root:
            return (self._translate_archive(path)
                    or super().translate_path("/archive-denied"))
        # the base class drops every ".." component: a request never
        # leaves the logdir
        return super().translate_path(path)

    def _is_data(self, fs_path: str) -> bool:
        rel = fs_path.replace(os.sep, "/")
        return (rel.endswith(_DATA_SUFFIXES)
                or posixpath.basename(rel) == "report.js"
                or "/_tiles/" in rel)

    def _count(self, key: str) -> None:
        counter = getattr(self.server, "count_response", None)
        if counter is not None:
            counter(key)

    def _unavailable(self):
        self._count("503_mid_write")
        self.send_response(503)
        self.send_header("Retry-After", "1")
        self.send_header("Content-Length", "0")
        self.end_headers()
        return None

    def _not_modified(self, etag: str):
        self._count("304_revalidated")
        self.send_response(304)
        self.send_header("ETag", etag)
        self.end_headers()
        return None

    def send_head(self):
        """The one serving path (GET and HEAD both come through here)."""
        path = self.translate_path(self.path)
        if os.path.isdir(path):
            return super().send_head()
        in_archive = bool(self.archive_root) and path.startswith(
            os.path.abspath(self.archive_root) + os.sep)
        if not in_archive and self._is_data(path) \
                and derived_writing(self.directory):
            return self._unavailable()
        actual, precompressed = path, False
        if os.path.isfile(path):
            precompressed = path.endswith(".json.gz")
        elif os.path.isfile(path + ".gz"):
            # a tile asked for without the suffix
            actual, precompressed = path + ".gz", True
        else:
            return super().send_head()      # the canonical 404
        try:
            st = os.stat(actual)
        except OSError:
            return super().send_head()
        etag = f'"{st.st_mtime_ns:x}-{st.st_size:x}"'
        if self.headers.get("If-None-Match") == etag:
            return self._not_modified(etag)
        headers = [("ETag", etag)]
        if "_tiles" in actual.replace(os.sep, "/").split("/"):
            # a tile changes only when its series' content key does
            headers.append(("Cache-Control", "max-age=60, must-revalidate"))
        else:
            headers.append(("Cache-Control", "no-cache"))
        if precompressed:
            headers.append(("Vary", "Accept-Encoding"))
            ctype = "application/json"
            if "gzip" in (self.headers.get("Accept-Encoding") or ""):
                f = open(actual, "rb")
                headers.append(("Content-Encoding", "gzip"))
                length = st.st_size
            else:
                try:
                    with open(actual, "rb") as raw:
                        body = gzip.decompress(raw.read())
                except (OSError, gzip.BadGzipFile, EOFError):
                    return self._unavailable()   # a torn tile: retry
                f = io.BytesIO(body)
                length = len(body)
        else:
            ctype = self.guess_type(path)
            f = open(actual, "rb")
            length = st.st_size
        self._count("200_served")
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(length))
        for key, value in headers:
            self.send_header(key, value)
        self.end_headers()
        return f


def archive_root(cfg):
    """The archive root ``/archive/`` serves, or None without one."""
    from sofa_tpu_torch.archive import is_archive_root, resolve_root

    root = resolve_root(cfg)
    return root if is_archive_root(root) else None


def bind_server(cfg):
    """A server on the first free port of viz_port..viz_port+19 (the next
    port is tried only when one is taken), or None.  It serves the archive
    root under ``/archive/`` when there is one."""
    handler = functools.partial(BoardHandler, directory=cfg.logdir,
                                archive_root=archive_root(cfg))
    last_err = None
    for port in range(cfg.viz_port, cfg.viz_port + PORT_TRIES):
        try:
            return BoardServer((cfg.viz_bind, port), handler)
        except OSError as e:
            last_err = e
            if e.errno != errno.EADDRINUSE:
                break        # a bad address fails the same on every port
    print_warning(f"viz: cannot bind a port in {cfg.viz_port}.."
                  f"{cfg.viz_port + PORT_TRIES - 1}: {last_err}")
    return None


def sofa_viz(cfg, serve_forever: bool = True):
    """Serve ``cfg.logdir`` until interrupted; returns the (closed) server,
    or None when it could not bind.  With ``serve_forever=False`` returns
    the bound server at once: the caller serves and closes it."""
    if not os.path.isdir(cfg.logdir):
        print_warning(f"viz: logdir {cfg.logdir} does not exist")
        return None
    reap_stale_sentinel(cfg.logdir)
    httpd = bind_server(cfg)
    if httpd is None:
        return None
    port = httpd.server_address[1]
    print_progress(
        f"serving {cfg.logdir} at http://{display_host(cfg.viz_bind)}:"
        f"{port}/ (Ctrl-C stops; bound to {cfg.viz_bind or 'all interfaces'})")
    from sofa_tpu_torch.live import OFFSETS_NAME

    if os.path.isfile(os.path.join(cfg.logdir, OFFSETS_NAME)):
        print_progress(
            "live stream: this logdir is (or was) fed by `live`; every live "
            "write is atomic, so data requests get the last committed "
            "epoch while one runs (no 503), and the board polls meta.live "
            "to grow the timeline while the job runs")
    if archive_root(cfg):
        print_progress(
            f"trace archive: /archive/ (root {archive_root(cfg)}, "
            "read-only); archive-diff.html compares two of its runs tile by "
            "tile by content hash, fetching no tile; `serve` runs the "
            "write-capable fleet service over an archive root")
        from sofa_tpu_torch.archive import index as aindex

        if aindex.is_current(archive_root(cfg)):
            print_progress(
                "fleet board: /fleet.html ranks the archive's worst "
                "speed-of-light-distance offenders from the columnar "
                "catalog index; point it at a `serve` endpoint for the "
                "fleet-pass report (/v1/<tenant>/fleet)")
        print_progress(
            "tier board: /tier.html watches a `serve` worker's metrics "
            "(push latency, WAL depth, replica lag, the SLO verdict), "
            "polled from the authenticated /v1/metrics with ETag-aware "
            "refresh")
    if not serve_forever:
        return httpd
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        served = httpd.stats_line()
        if served:
            print_progress(f"viz served: {served}")
    return httpd
