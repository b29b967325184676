"""The port's board server (sofa_tpu_torch/viz.py), as
``tests/test_tiles.py`` and ``tests/test_cli.py`` hold the JAX package's:
ETag and 304, gzip negotiation for the tiles and the /tiles/ alias, a
sparse tile's 404, 503 while a writer holds the guard, the port retry,
loopback by default, and no path outside the logdir."""

import gzip
import http.client
import json
import os
import socket
import threading

import numpy as np
import pytest

from sofa_tpu_torch import tiles
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.trace import (SofaSeries, derived_write_guard,
                                  make_frame, series_to_report_js)
from sofa_tpu_torch.viz import display_host, sofa_viz

PORT = 8960             # a base of its own: test files run in parallel
N_POINTS = 30000


def _series():
    rng = np.random.default_rng(0)
    return SofaSeries("gputrace", "GPU kernels", "darkorchid", make_frame({
        "timestamp": np.sort(rng.uniform(0.0, 10.0, N_POINTS)),
        "event": rng.normal(5.0, 2.0, N_POINTS),
        "duration": rng.exponential(1e-4, N_POINTS),
        "name": [f"kernel_{i % 50}" for i in range(N_POINTS)]}))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("served")
    d = str(root / "log") + "/"
    os.makedirs(d)
    with open(str(root / "secret.txt"), "w") as f:
        f.write("outside the logdir")
    cfg = SofaConfig(logdir=d, viz_port=PORT)
    s = _series()
    manifest = tiles.build_tiles(cfg, [s])
    series_to_report_js([s], cfg.path("report.js"), cfg.viz_downsample_to,
                        {"tiles": manifest})
    with open(cfg.path("index.html"), "w") as f:
        f.write("<html>board</html>")
    with open(cfg.path("features.csv"), "w") as f:
        f.write("name,value\nx,1\n")
    httpd = sofa_viz(cfg, serve_forever=False)
    assert httpd is not None
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield cfg, httpd, manifest
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _get(httpd, path, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1],
                                      timeout=10)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("path", ["/report.js", "/index.html",
                                  "/features.csv"])
def test_etag_304(served, path):
    _cfg, httpd, _ = served
    status, headers, body = _get(httpd, path)
    assert status == 200 and body
    assert headers.get("Cache-Control") == "no-cache"
    etag = headers["ETag"]
    status2, headers2, body2 = _get(httpd, path, {"If-None-Match": etag})
    assert status2 == 304 and body2 == b""
    assert headers2["ETag"] == etag
    # a stale tag gets the file again
    assert _get(httpd, path, {"If-None-Match": '"0-0"'})[0] == 200


def test_report_js_body(served):
    _cfg, httpd, manifest = served
    _s, headers, body = _get(httpd, "/report.js")
    assert body.startswith(b"sofa_traces = ")
    doc = json.loads(body[len(b"sofa_traces = "):].rstrip(b";\n"))
    assert doc["meta"]["tiles"] == manifest


def test_tile_gzip_negotiation(served):
    _cfg, httpd, manifest = served
    ent = manifest["series"]["gputrace"]
    url = f"/tiles/{ent['path']}/0/0.json.gz"
    status, headers, gz_body = _get(httpd, url, {"Accept-Encoding": "gzip"})
    assert status == 200
    assert headers.get("Content-Encoding") == "gzip"
    assert headers.get("Content-Type") == "application/json"
    assert "max-age" in headers.get("Cache-Control", "")
    assert json.loads(gzip.decompress(gz_body))["count"] == N_POINTS
    # without gzip: the decompressed bytes, the same document
    status2, headers2, plain = _get(httpd, url)
    assert status2 == 200 and headers2.get("Content-Encoding") is None
    assert plain == gzip.decompress(gz_body)
    # the suffixless spelling, under the on-disk name
    status3, headers3, body3 = _get(
        httpd, f"/_tiles/{ent['path']}/0/0.json", {"Accept-Encoding": "gzip"})
    assert status3 == 200 and headers3.get("Content-Encoding") == "gzip"
    assert body3 == gz_body
    # and a tile revalidates
    assert _get(httpd, url, {"If-None-Match": headers["ETag"]})[0] == 304


def test_sparse_tile_404(served):
    _cfg, httpd, manifest = served
    ent = manifest["series"]["gputrace"]
    assert _get(httpd, f"/tiles/{ent['path']}/0/999.json.gz")[0] == 404


@pytest.mark.parametrize("path", ["/../secret.txt", "/%2e%2e/secret.txt",
                                  "/tiles/../../secret.txt",
                                  "/missing.csv"])
def test_nothing_outside_the_logdir(served, path):
    _cfg, httpd, _ = served
    status, _h, body = _get(httpd, path)
    assert status == 404 and b"outside the logdir" not in body


def test_503_while_mid_write(served):
    cfg, httpd, manifest = served
    ent = manifest["series"]["gputrace"]
    with derived_write_guard(cfg.logdir):
        for path in ("/report.js", "/features.csv",
                     f"/tiles/{ent['path']}/0/0.json.gz"):
            status, headers, _b = _get(httpd, path)
            assert status == 503, path
            assert headers.get("Retry-After") == "1"
        # the pages keep serving: only data can be torn mid-write
        status, _h, body = _get(httpd, "/index.html")
        assert status == 200 and b"board" in body
    assert _get(httpd, "/report.js")[0] == 200
    assert "503_mid_write" in httpd.stats_line()


def test_port_retry_on_a_taken_port(served):
    cfg, httpd, _ = served
    second = sofa_viz(cfg, serve_forever=False)
    assert second is not None
    try:
        assert second.server_address[1] != httpd.server_address[1]
        assert cfg.viz_port <= second.server_address[1] < cfg.viz_port + 20
    finally:
        second.server_close()


def test_no_retry_on_a_bad_address(tmp_path):
    """A bind failure other than a taken port fails at once."""
    cfg = SofaConfig(logdir=str(tmp_path) + "/", viz_port=PORT + 30,
                     viz_bind="203.0.113.7")   # not an address of this host
    assert sofa_viz(cfg, serve_forever=False) is None


def test_bind_default_is_loopback(tmp_path):
    d = tmp_path / "log"
    d.mkdir()
    (d / "index.html").write_text("<html>ok</html>")
    cfg = SofaConfig(logdir=str(d) + "/", viz_port=PORT + 40)
    httpd = sofa_viz(cfg, serve_forever=False)
    assert httpd is not None
    try:
        assert httpd.server_address[0] == "127.0.0.1"
        t = threading.Thread(target=httpd.handle_request, daemon=True)
        t.start()
        status, _h, body = _get(httpd, "/index.html")
        assert status == 200 and b"ok" in body
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        httpd.server_close()


def test_display_host():
    assert display_host("127.0.0.1") == "localhost"
    assert display_host("0.0.0.0") in (socket.gethostname(), "localhost")
    assert display_host("::1") == "localhost"
    assert display_host("fe80::1") == "[fe80::1]"
    assert display_host("10.1.2.3") == "10.1.2.3"


def test_viz_flags_and_missing_logdir(tmp_path):
    from sofa_tpu_torch.cli import build_parser, config_from_args

    cfg = config_from_args(build_parser().parse_args(
        ["viz", "--viz_bind", "0.0.0.0", "--viz_port", "8123",
         "--no_tiles"]))
    assert (cfg.viz_bind, cfg.viz_port, cfg.enable_tiles) == \
        ("0.0.0.0", 8123, False)
    assert SofaConfig().viz_bind == "127.0.0.1"
    assert sofa_viz(SofaConfig(logdir=str(tmp_path / "none")),
                    serve_forever=False) is None
