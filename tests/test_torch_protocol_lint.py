"""SL024-SL028 over the port, held to the JAX package's engine
(``tests/test_protocol_lint.py``'s recipes), then seeded mutations over
copies of the port's protocol core, the port's tree's closure, and the
``protocol`` inventory verb (schema, exit codes, determinism, the port's
``manifest_check``).

Each fixture tree is written once and linted by both engines; the
(rule, file, line, severity) sets must be equal.  The companions sit where
each package looks for them, so the fixture writes them twice with the
same content: the knob registry at ``docs/OBSERVABILITY.md`` for the JAX
engine and ``pkg/docs/OBSERVABILITY.md`` for the port's, the chaos
corpus at ``tools/`` and ``pkg/tools/`` (the port's reference corpus is
its own package's tools, ``tests/test_torch_*.py`` and ``chip_smoke.py``,
never the JAX package's).  A finding anchored in the docs file names a
different path on each side, so the comparison maps the port's
``pkg/docs/`` onto ``docs/``.
"""

import json
import os
import textwrap

import pytest

from sofa_tpu.lint.core import ProjectContext as JaxProjectContext
from sofa_tpu.lint.core import lint_paths as jax_lint_paths
from sofa_tpu.lint.rules import default_rules as jax_default_rules
from sofa_tpu_torch.lint.core import ProjectContext, lint_paths
from sofa_tpu_torch.lint.protocol_rules import _KNOB_RE
from sofa_tpu_torch.lint.rules import default_rules
from sofa_tpu_torch.tools import manifest_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sofa_tpu_torch")
PROTO_IDS = ("SL024", "SL025", "SL026", "SL027", "SL028")

SLIM_VOCAB = """
    STATUS_ERRORS = {200: (), 429: (), 503: (), 504: ()}
    RETRY_AFTER_STATUSES = (429, 503)
    NO_RETRY_AFTER_STATUSES = (504,)
    CLIENT_RETRY_STATUSES = (429, 503)
    CLIENT_FATAL_STATUSES = (401,)
    CLIENT_RESUME_STATUSES = ()
    CLIENT_RETRY_FLOOR = 500
    ROUTES = ("GET /v1/ping",)
"""

FULL_VOCAB = """
    ERR_BUSY = "busy"
    ERR_QUOTA = "quota"
    STATUS_ERRORS = {
        200: (),
        429: (ERR_BUSY, ERR_QUOTA),
        503: (ERR_BUSY,),
        504: ("deadline",),
    }
    RETRY_AFTER_STATUSES = (429, 503)
    NO_RETRY_AFTER_STATUSES = (504,)
    CLIENT_RETRY_STATUSES = (429, 503)
    CLIENT_FATAL_STATUSES = (401,)
    CLIENT_RESUME_STATUSES = ()
    CLIENT_RETRY_FLOOR = 500
    FATAL_ERRORS = (ERR_QUOTA,)
    ROUTES = (
        "GET /v1/ping",
        "POST /v1/<tenant>/commit",
    )
"""

#: Companion paths: the JAX engine's -> the port's.
_PORT_COMPANIONS = {"docs/": "pkg/docs/", "tools/": "pkg/tools/"}


def _port_companion(rel):
    for jax_prefix, port_prefix in _PORT_COMPANIONS.items():
        if rel.startswith(jax_prefix):
            return port_prefix + rel[len(jax_prefix):]
    return None


def _key(f):
    file = f.file.replace("pkg/docs/", "docs/")
    return (f.rule_id, file, f.line, f.severity)


def run_protocol_rules(tmp_path, files):
    """Write {relname: src} under tmp_path (each companion also at the
    port's place), lint the .py files with both engines, assert their
    SL024-SL028 findings agree, and return the port's."""
    paths = []
    for rel, body in files.items():
        for dest in (rel, _port_companion(rel)):
            if dest is None:
                continue
            p = tmp_path / dest
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(textwrap.dedent(body))
        if rel.endswith(".py"):
            paths.append(str(tmp_path / rel))
    base = str(tmp_path)
    port = [f for f in lint_paths(paths, default_rules(),
                                  project=ProjectContext.detect(paths, base),
                                  base=base)
            if f.rule_id in PROTO_IDS]
    jax = [f for f in jax_lint_paths(
        paths, jax_default_rules(),
        project=JaxProjectContext.detect(paths, base), base=base)
        if f.rule_id in PROTO_IDS]
    assert sorted(map(_key, port)) == sorted(map(_key, jax)), (
        [f.render() for f in port], [f.render() for f in jax])
    return port


# --- the clean kitchen sink -------------------------------------------------

def test_protocol_clean_kitchen_sink(tmp_path):
    fs = run_protocol_rules(tmp_path, {
        "pkg/archive/protocol.py": FULL_VOCAB,
        "pkg/archive/service.py": """
            class H:
                def _json(self, code, doc, retry_after=None):
                    pass
                def _refuse(self, key, code, doc, retry_after="1"):
                    self._json(code, doc, retry_after=retry_after)
                def handle(self):
                    seg = "ping"
                    if seg == "commit":
                        pass
                    path = "/v1/ping"
                    self._json(200, {"ok": True})
                    self._refuse("429_busy", 429, {"error": "busy"})
                    self._refuse("429_quota", 429, {"error": "quota"})
                    self._refuse("503_busy", 503, {"error": "busy"})
                    self._refuse("504_deadline", 504,
                                 {"error": "deadline"}, retry_after=None)
        """,
        "pkg/archive/client.py": """
            class ServiceUnavailable(Exception):
                pass
            class ServiceRejected(Exception):
                pass
            def dispatch(e, doc):
                url = "/v1/<t>/commit"
                if e.code == 429 and doc.get("error") == "quota":
                    raise ServiceRejected(e)
                if e.code in (401,):
                    raise ServiceRejected(e)
                if e.code in (429, 503) or e.code >= 500:
                    raise ServiceUnavailable(e)
        """,
    })
    assert fs == [], [f.render() for f in fs]


# --- SL024 ------------------------------------------------------------------

def test_sl024_flags_undeclared_status(tmp_path):
    fs = run_protocol_rules(tmp_path, {
        "pkg/archive/protocol.py": SLIM_VOCAB,
        "pkg/archive/service.py": """
            class H:
                def _json(self, code, doc, retry_after=None):
                    pass
                def handle(self):
                    path = "/v1/ping"
                    self._json(418, {})
        """,
    })
    assert [f.rule_id for f in fs] == ["SL024"]
    assert "418" in fs[0].message and fs[0].file.endswith("service.py")


def test_sl024_flags_unknown_client_route(tmp_path):
    fs = run_protocol_rules(tmp_path, {
        "pkg/archive/protocol.py": SLIM_VOCAB,
        "pkg/archive/service.py": """
            def handle(self):
                seg = "ping"
                url = "/v1/ghost"
        """,
    })
    assert [f.rule_id for f in fs] == ["SL024"]
    assert "/v1/ghost" in fs[0].message and "404" in fs[0].message


def test_sl024_flags_dead_route_entry(tmp_path):
    fs = run_protocol_rules(tmp_path, {
        "pkg/archive/protocol.py": SLIM_VOCAB.replace(
            'ROUTES = ("GET /v1/ping",)',
            'ROUTES = ("GET /v1/ping", "GET /v1/ghost")'),
        "pkg/archive/service.py": """
            def handle(self):
                url = "/v1/ping"
        """,
    })
    assert [f.rule_id for f in fs] == ["SL024"]
    assert "ghost" in fs[0].message and "dead route" in fs[0].message
    assert fs[0].file.endswith("protocol.py")


def test_sl024_flags_dead_status_and_dead_error(tmp_path):
    fs = run_protocol_rules(tmp_path, {
        "pkg/archive/protocol.py": """
            STATUS_ERRORS = {
                200: (),
                418: (),
                429: ("busy", "dead_err"),
            }
            RETRY_AFTER_STATUSES = (429,)
            NO_RETRY_AFTER_STATUSES = ()
            CLIENT_RETRY_STATUSES = (429,)
            CLIENT_FATAL_STATUSES = ()
            CLIENT_RESUME_STATUSES = ()
            ROUTES = ("GET /v1/ping",)
        """,
        "pkg/archive/service.py": """
            class H:
                def _json(self, code, doc, retry_after=None):
                    pass
                def handle(self):
                    path = "/v1/ping"
                    self._json(200, {"ok": 1})
                    self._json(429, {"error": "busy"}, retry_after="1")
        """,
        "pkg/archive/client.py": """
            class ServiceUnavailable(Exception):
                pass
            def dispatch(e):
                if e.code in (429,):
                    raise ServiceUnavailable(e)
        """,
    })
    msgs = sorted(f.message for f in fs)
    assert [f.rule_id for f in fs] == ["SL024", "SL024"]
    assert any("418" in m and "dead status" in m for m in msgs)
    assert any("dead_err" in m and "dead vocabulary" in m for m in msgs)
    assert all(f.file.endswith("protocol.py") for f in fs)


def test_sl024_board_fetch_outside_routes(tmp_path):
    """The port's board/ (inside the package) is the board the rule reads:
    a page fetching an undeclared route fetches a 404."""
    fs = run_protocol_rules(tmp_path, {
        "pkg/archive/protocol.py": SLIM_VOCAB,
        "pkg/archive/service.py": """
            def handle(self):
                seg = "ping"
                url = "/v1/ping"
        """,
        "pkg/board/tier.html": """
            <script>fetch("/v1/ping"); fetch("/v1/nowhere");</script>
        """,
    })
    assert [f.rule_id for f in fs] == ["SL024"]
    assert "/v1/nowhere" in fs[0].message
    assert fs[0].file == "pkg/board/tier.html"


# --- SL025 ------------------------------------------------------------------

def test_sl025_flags_missing_retry_after(tmp_path):
    fs = run_protocol_rules(tmp_path, {
        "pkg/archive/protocol.py": SLIM_VOCAB,
        "pkg/archive/service.py": """
            class H:
                def _json(self, code, doc, retry_after=None):
                    pass
                def handle(self):
                    path = "/v1/ping"
                    self._json(429, {})
        """,
    })
    assert [f.rule_id for f in fs] == ["SL025"]
    assert "attaches no Retry-After" in fs[0].message


def test_sl025_flags_deadline_with_retry_after(tmp_path):
    fs = run_protocol_rules(tmp_path, {
        "pkg/archive/protocol.py": SLIM_VOCAB,
        "pkg/archive/service.py": """
            class H:
                def _json(self, code, doc, retry_after=None):
                    pass
                def handle(self):
                    path = "/v1/ping"
                    self._json(504, {}, retry_after="1")
        """,
    })
    assert [f.rule_id for f in fs] == ["SL025"]
    assert "deadline refusal" in fs[0].message


def test_sl025_flags_untyped_and_undeclared_bodies(tmp_path):
    fs = run_protocol_rules(tmp_path, {
        "pkg/archive/protocol.py": SLIM_VOCAB.replace(
            "429: ()", '429: ("busy",)'),
        "pkg/archive/service.py": """
            class H:
                def _json(self, code, doc, retry_after=None):
                    pass
                def _refuse(self, key, code, doc, retry_after="1"):
                    self._json(code, doc, retry_after=retry_after)
                def handle(self):
                    path = "/v1/ping"
                    self._refuse("k", 429, {})
                    self._refuse("k", 429, {"error": "mystery"})
                    self._refuse("k", 429, {"error": "busy"})
        """,
    })
    msgs = sorted(f.message for f in fs)
    assert [f.rule_id for f in fs] == ["SL025", "SL025"]
    assert any("no typed" in m for m in msgs)
    assert any("'mystery'" in m and "STATUS_ERRORS[429]" in m
               for m in msgs)


def test_sl025_flags_raw_send_bypass(tmp_path):
    fs = run_protocol_rules(tmp_path, {
        "pkg/archive/protocol.py": SLIM_VOCAB,
        "pkg/archive/service.py": """
            class H:
                def handle(self):
                    path = "/v1/ping"
                    self.send_response(503)
        """,
    })
    assert [f.rule_id for f in fs] == ["SL025"]
    assert "bypasses the typed refusal helpers" in fs[0].message


# --- SL026 ------------------------------------------------------------------

def test_sl026_both_directions(tmp_path):
    fs = run_protocol_rules(tmp_path, {
        "pkg/archive/protocol.py": SLIM_VOCAB,
        "pkg/svc.py": """
            import os
            ALIVE = os.environ.get("SOFA_ALIVE", "")
            GHOST = os.environ.get("SOFA_GHOST", "")
        """,
        "docs/OBSERVABILITY.md": """
            | knob | default |
            |---|---|
            | `SOFA_ALIVE` | - |
            | `SOFA_DEAD` | - |
        """,
    })
    assert [f.rule_id for f in fs] == ["SL026", "SL026"]
    ghost = next(f for f in fs if "SOFA_GHOST" in f.message)
    assert ghost.file.endswith("svc.py") and "undocumented" in ghost.message
    dead = next(f for f in fs if "SOFA_DEAD" in f.message)
    assert dead.file == "pkg/docs/OBSERVABILITY.md"
    assert "dead registry row" in dead.message


def test_sl026_inert_without_docs_registry(tmp_path):
    fs = run_protocol_rules(tmp_path, {
        "pkg/archive/protocol.py": SLIM_VOCAB,
        "pkg/svc.py": """
            import os
            GHOST = os.environ.get("SOFA_GHOST", "")
        """,
    })
    assert fs == []


def test_sl026_reads_the_port_registry_not_the_repo_docs(tmp_path):
    """Port-only: the knob registry beside the repo's own docs/ (the JAX
    package's) is not the port's.  With only that one present the port's
    SL026 stays inert, and with only the package's it reads that one."""
    paths = []
    for rel, body in {
            "pkg/archive/protocol.py": SLIM_VOCAB,
            "pkg/svc.py": 'import os\nG = os.environ.get("SOFA_GHOST")\n',
            "docs/OBSERVABILITY.md": "| `SOFA_GHOST` | - |\n"}.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(body))
        if rel.endswith(".py"):
            paths.append(str(p))
    project = ProjectContext.detect(paths, base=str(tmp_path))
    assert project.protocol.docs_knobs is None
    (tmp_path / "pkg" / "docs").mkdir()
    (tmp_path / "pkg" / "docs" / "OBSERVABILITY.md").write_text(
        "| `SOFA_OTHER` | - |\n")
    fs = [f for f in lint_paths(paths, default_rules(), base=str(tmp_path))
          if f.rule_id == "SL026"]
    assert {f.file for f in fs} == {"pkg/svc.py",
                                   "pkg/docs/OBSERVABILITY.md"}


# --- SL027 ------------------------------------------------------------------

def test_sl027_phantom_and_unconsumed_kinds(tmp_path):
    fs = run_protocol_rules(tmp_path, {
        "pkg/archive/protocol.py": SLIM_VOCAB,
        "pkg/faults.py": """
            KINDS = ("stall", "drop")
            NET_KINDS = ("refuse",)
            def consume(spec):
                if spec.kind == "stall":
                    return 1
                if spec.kind == "ghost":
                    return 2
        """,
    })
    msgs = sorted(f.message for f in fs)
    assert [f.rule_id for f in fs] == ["SL027"] * 3
    assert any("'ghost'" in m and "phantom" in m for m in msgs)
    assert any("'drop'" in m and "silent no-op" in m for m in msgs)
    assert any("'refuse'" in m and "silent no-op" in m for m in msgs)


def test_sl027_taint_scoping_in_importers(tmp_path):
    fs = run_protocol_rules(tmp_path, {
        "pkg/archive/protocol.py": SLIM_VOCAB,
        "pkg/faults.py": """
            KINDS = ("stall",)
            NET_KINDS = ("refuse",)
            def maybe_fault(op):
                return None
            def consume(spec):
                if spec.kind == "stall":
                    return 1
                if spec.kind == "refuse":
                    return 2
        """,
        "pkg/ingest.py": """
            from pkg import faults
            def go(pending):
                tasks = [t for t in pending if t.kind == "proc"]
                spec = faults.maybe_fault("op")
                if spec and spec.kind == "ghost2":
                    return spec
                return tasks
        """,
    })
    assert [f.rule_id for f in fs] == ["SL027"]
    assert "'ghost2'" in fs[0].message
    assert fs[0].file.endswith("ingest.py")


def test_sl027_chaos_reference_leg(tmp_path):
    fs = run_protocol_rules(tmp_path, {
        "pkg/archive/protocol.py": SLIM_VOCAB,
        "pkg/faults.py": """
            KINDS = ("stall",)
            NET_KINDS = ("refuse",)
            def consume(spec):
                if spec.kind == "stall":
                    return 1
                if spec.kind == "refuse":
                    return 2
        """,
        "tools/chaos.py": """
            USED = ("stall",)
        """,
    })
    assert [f.rule_id for f in fs] == ["SL027"]
    assert "'refuse'" in fs[0].message
    assert "no chaos/test reference" in fs[0].message


def test_sl027_port_corpus_is_torch_tests_and_chip_smoke(tmp_path):
    """Port-only: a kind that only a JAX test names stays untested for
    the port; tests/test_torch_*.py and chip_smoke.py count; the grammar's
    KINDS may be composed (``(...) + TIER_KINDS``), as the port's is."""
    paths = []
    for rel, body in {
            "pkg/archive/protocol.py": SLIM_VOCAB,
            "pkg/faults.py": """
                TIER_KINDS = ("tierk",)
                KINDS = ("stall",) + TIER_KINDS
                NET_KINDS = ("refuse",)
                def consume(spec):
                    if spec.kind in ("stall", "refuse", "tierk"):
                        return 1
            """,
            "tests/test_faults.py": 'K = ("stall", "refuse", "tierk")\n',
            "tests/test_torch_faults.py": 'K = ("stall",)\n',
            "chip_smoke.py": 'K = "refuse"\n'}.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(body))
        if rel.startswith("pkg/"):
            paths.append(str(p))
    fs = [f for f in lint_paths(paths, default_rules(), base=str(tmp_path))
          if f.rule_id == "SL027"]
    assert [("'tierk'" in f.message, "no chaos/test reference" in f.message)
            for f in fs] == [(True, True)]


# --- SL028 ------------------------------------------------------------------

def test_sl028_divergent_retry_set_and_floor(tmp_path):
    fs = run_protocol_rules(tmp_path, {
        "pkg/archive/protocol.py": SLIM_VOCAB,
        "pkg/archive/client.py": """
            class ServiceUnavailable(Exception):
                pass
            def dispatch(e):
                if e.code in (408,) or \\
                        e.code > 500:
                    raise ServiceUnavailable(e)
        """,
    })
    msgs = sorted(f.message for f in fs)
    assert all(f.rule_id == "SL028" for f in fs)
    assert any("[408]" in m and "CLIENT_RETRY_STATUSES" in m
               for m in msgs)
    assert any("retry floor 501" in m for m in msgs)
    assert any("429" in m and "never retries" in m for m in msgs)


def test_sl028_fatal_override_outside_vocabulary(tmp_path):
    fs = run_protocol_rules(tmp_path, {
        "pkg/archive/protocol.py": """
            STATUS_ERRORS = {200: (), 429: ("busy", "quota")}
            RETRY_AFTER_STATUSES = ()
            NO_RETRY_AFTER_STATUSES = ()
            CLIENT_RETRY_STATUSES = ()
            CLIENT_FATAL_STATUSES = ()
            CLIENT_RESUME_STATUSES = ()
            FATAL_ERRORS = ("quota",)
            ROUTES = ("GET /v1/ping",)
        """,
        "pkg/archive/client.py": """
            class ServiceRejected(Exception):
                pass
            def dispatch(e, doc):
                if e.code == 429 and doc.get("error") == "busy":
                    raise ServiceRejected(e)
        """,
    })
    sl28 = [f for f in fs if f.rule_id == "SL028"]
    msgs = sorted(f.message for f in sl28)
    assert len(sl28) == 2
    assert any("'busy'" in m and "FATAL_ERRORS does not declare" in m
               for m in msgs)
    assert any("'quota'" in m and "dead override" in m for m in msgs)


def test_sl028_fatal_vs_retryable_contradiction(tmp_path):
    fs = run_protocol_rules(tmp_path, {
        "pkg/archive/protocol.py": SLIM_VOCAB,
        "pkg/archive/client.py": """
            class ServiceUnavailable(Exception):
                pass
            class ServiceRejected(Exception):
                pass
            def dispatch(e):
                if e.code in (429, 503) or e.code >= 500:
                    raise ServiceUnavailable(e)
                if e.code in (429,):
                    raise ServiceRejected(e)
        """,
    })
    assert any(f.rule_id == "SL028"
               and "contradictory contract" in f.message for f in fs)


# --- seeded mutations over copies of the port's protocol core ---------------

SHIPPED = {
    "pkg/archive/protocol.py": "sofa_tpu_torch/archive/protocol.py",
    "pkg/archive/service.py": "sofa_tpu_torch/archive/service.py",
    "pkg/archive/tier.py": "sofa_tpu_torch/archive/tier.py",
    "pkg/archive/client.py": "sofa_tpu_torch/archive/client.py",
}


def lint_shipped_copy(tmp_path, mutations=None, extra_shipped=(),
                      extra_files=None):
    sources, paths = {}, []
    items = dict(SHIPPED)
    items.update(dict(extra_shipped))
    for destrel, realrel in items.items():
        with open(os.path.join(REPO, realrel), encoding="utf-8") as f:
            src = f.read()
        if mutations and destrel in mutations:
            src = mutations[destrel](src)
        p = tmp_path / destrel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
        sources[destrel] = src
        paths.append(str(p))
    for rel, body in (extra_files or {}).items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(body)
    project = ProjectContext.detect(paths, base=str(tmp_path))
    fs = lint_paths(paths, default_rules(), project=project,
                    base=str(tmp_path))
    return [f for f in fs if f.rule_id in PROTO_IDS], sources


def _line_of(src, needle):
    assert needle in src
    return src[:src.index(needle)].count("\n") + 1


def test_shipped_copy_is_protocol_clean(tmp_path):
    fs, _src = lint_shipped_copy(tmp_path)
    assert fs == [], [f.render() for f in fs]


def test_mutated_refusal_without_retry_after_fires_sl025(tmp_path):
    needle = 'self._refuse("503_draining", 503, {"error": ERR_DRAINING})'
    swap = needle[:-1] + ", retry_after=None)"
    fs, src = lint_shipped_copy(tmp_path, mutations={
        "pkg/archive/service.py": lambda s: s.replace(needle, swap, 1)})
    line = _line_of(src["pkg/archive/service.py"], swap)
    hits = [f for f in fs if f.rule_id == "SL025"]
    assert [(f.file.endswith("service.py"), f.line) for f in hits] == \
        [(True, line)], [f.render() for f in fs]
    assert "attaches no Retry-After" in hits[0].message


def test_mutated_route_typo_fires_sl024(tmp_path):
    needle = 'f"/v1/{self.tenant}/have"'
    swap = 'f"/v1/{self.tenant}/hav"'
    fs, src = lint_shipped_copy(tmp_path, mutations={
        "pkg/archive/client.py": lambda s: s.replace(needle, swap, 1)})
    line = _line_of(src["pkg/archive/client.py"], swap)
    hits = [f for f in fs if f.rule_id == "SL024"]
    assert [(f.file.endswith("client.py"), f.line) for f in hits] == \
        [(True, line)], [f.render() for f in fs]
    assert "/v1/<>/hav" in hits[0].message


def test_mutated_retry_tuple_fires_sl028(tmp_path):
    needle = "if e.code in CLIENT_RETRY_STATUSES or \\"
    swap = "if e.code in (408, 422, 425) or \\"
    fs, src = lint_shipped_copy(tmp_path, mutations={
        "pkg/archive/client.py": lambda s: s.replace(needle, swap, 1)})
    line = _line_of(src["pkg/archive/client.py"], swap)
    hits = [f for f in fs if f.rule_id == "SL028" and "diverge" in f.message]
    assert [(f.file.endswith("client.py"), f.line) for f in hits] == \
        [(True, line)], [f.render() for f in fs]
    assert "[408, 422, 425]" in hits[0].message


def test_mutated_ghost_knob_fires_sl026(tmp_path):
    tokens = set()
    for realrel in SHIPPED.values():
        with open(os.path.join(REPO, realrel), encoding="utf-8") as f:
            tokens |= set(_KNOB_RE.findall(f.read()))
    docs = "| knob | default |\n|---|---|\n" + "\n".join(
        f"| `{t}` | - |" for t in sorted(tokens)) + "\n"
    probe = '\n_GHOST_PROBE = os.environ.get("SOFA_GHOST_KNOB", "")\n'
    fs, src = lint_shipped_copy(
        tmp_path,
        mutations={"pkg/archive/service.py": lambda s: s + probe},
        extra_files={"pkg/docs/OBSERVABILITY.md": docs})
    line = _line_of(src["pkg/archive/service.py"], "SOFA_GHOST_KNOB")
    hits = [f for f in fs if f.rule_id == "SL026"]
    assert [(f.file.endswith("service.py"), f.line) for f in hits] == \
        [(True, line)], [f.render() for f in fs]


def test_mutated_phantom_kind_fires_sl027(tmp_path):
    probe = ('\ndef _phantom_probe(spec):\n'
             '    if spec.kind == "sl027_phantom":\n'
             '        return spec\n')
    fs, src = lint_shipped_copy(
        tmp_path,
        mutations={"pkg/faults.py": lambda s: s + probe},
        extra_shipped={"pkg/faults.py": "sofa_tpu_torch/faults.py"}.items())
    line = _line_of(src["pkg/faults.py"], 'spec.kind == "sl027_phantom"')
    hits = [f for f in fs if f.rule_id == "SL027" and "phantom" in f.message]
    assert [(f.file.endswith("faults.py"), f.line) for f in hits] == \
        [(True, line)], [f.render() for f in hits]


# --- the port's tree and the inventory verb (built once) --------------------

@pytest.fixture(scope="module")
def inventory():
    from sofa_tpu_torch.protocol import build_inventory

    return build_inventory()


def test_shipped_tree_has_zero_protocol_findings(inventory):
    assert inventory["violations"] == []


def test_build_inventory_full_closure(inventory):
    doc = inventory
    assert doc["ok"] is True
    assert doc["vocabulary"] == "sofa_tpu_torch/archive/protocol.py"
    statuses = {s["status"]: s for s in doc["statuses"]}
    assert statuses[429]["retry_after"] is True
    assert statuses[504]["no_retry_after"] is True
    assert statuses[401]["client"] == "fatal"
    assert statuses[409]["client"] == "resume"
    assert statuses[503]["client"] == "retry"
    knobs = {k["knob"]: k for k in doc["knobs"]}
    assert "SOFA_SERVE_TOKEN" in knobs and "SOFA_TORCH_GPUMON_HZ" in knobs
    assert [k for k, r in knobs.items()
            if r["read_by"] and not r["documented"]] == []
    kinds = {r["kind"]: r for r in doc["fault_kinds"]}
    assert {"http_500", "worker_die", "tail_torn", "die"} <= set(kinds)
    for row in kinds.values():
        assert row["consumed_by"] and row["referenced"], row


def test_inventory_routes_equal_the_vocabulary(inventory):
    from sofa_tpu_torch.archive.protocol import ROUTES

    got = [f"{r['method']} {r['path']}" for r in inventory["routes"]]
    assert got == list(ROUTES)


def test_protocol_inventory_schema_validates(inventory):
    doc = inventory
    assert manifest_check.validate_protocol_inventory(doc) == []
    assert manifest_check.validate_protocol_inventory(
        doc, require_healthy=True) == []
    assert manifest_check.validate_protocol_inventory(dict(doc, version=99))
    assert manifest_check.validate_protocol_inventory(dict(doc, routes=[]))


def test_manifest_check_dispatches_protocol_doc(tmp_path, inventory,
                                                capsys):
    path = tmp_path / "proto.json"
    path.write_text(json.dumps(inventory))
    assert manifest_check.check_path(str(path)) == 0
    assert manifest_check.main([str(path), "--require-healthy"]) == 0
    path.write_text(json.dumps(dict(inventory, version=2)))
    assert manifest_check.check_path(str(path)) == 1


def test_cli_protocol_verb_json_and_human(monkeypatch, inventory, capsys):
    from sofa_tpu_torch import protocol
    from sofa_tpu_torch.cli import main

    monkeypatch.setattr(protocol, "build_inventory", lambda: inventory)
    assert main(["protocol", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["schema"] == "sofa_tpu/protocol_inventory"
    assert doc["version"] == 1 and doc["ok"] is True
    assert main(["protocol"]) == 0
    out = capsys.readouterr().out
    assert "GET /v1/ping" in out and "full closure" in out
    bad = dict(inventory, ok=False, violations=[
        {"file": "x.py", "line": 1, "rule": "SL024", "message": "m"}])
    monkeypatch.setattr(protocol, "build_inventory", lambda: bad)
    assert main(["protocol"]) == 2


# --- lint CLI: --rule filter, exit codes, determinism -----------------------

def test_lint_cli_rule_filter_exit_codes(tmp_path, capsys):
    from sofa_tpu_torch.lint.cli import run_lint

    pkg = tmp_path / "pkg" / "archive"
    pkg.mkdir(parents=True)
    (pkg / "protocol.py").write_text(textwrap.dedent(SLIM_VOCAB))
    (pkg / "service.py").write_text(textwrap.dedent("""
        class H:
            def _json(self, code, doc, retry_after=None):
                pass
            def handle(self):
                path = "/v1/ping"
                self._json(418, {})
    """))
    rc = run_lint([str(tmp_path / "pkg"), "--no-baseline",
                   "--base", str(tmp_path), "--rule", "SL024"])
    capsys.readouterr()
    assert rc == 1
    rc = run_lint([str(tmp_path / "pkg"), "--no-baseline",
                   "--base", str(tmp_path), "--rule", "SL027"])
    assert rc == 0
    rc = run_lint([str(tmp_path / "pkg"), "--no-baseline",
                   "--base", str(tmp_path), "--rule", "BOGUS"])
    capsys.readouterr()
    assert rc == 2


def test_explain_covers_protocol_rules(capsys):
    from sofa_tpu_torch.lint.cli import run_lint

    for rid in PROTO_IDS:
        assert run_lint(["--explain", rid]) == 0
        assert rid in capsys.readouterr().out


def test_protocol_findings_deterministic_across_jobs(tmp_path):
    files = {
        "pkg/archive/protocol.py": SLIM_VOCAB,
        "pkg/archive/service.py": """
            class H:
                def _json(self, code, doc, retry_after=None):
                    pass
                def handle(self):
                    path = "/v1/ping"
                    self._json(418, {})
                    self._json(429, {})
                    self._json(504, {}, retry_after="1")
        """,
        "pkg/archive/client.py": """
            class ServiceUnavailable(Exception):
                pass
            def dispatch(e):
                if e.code in (408,):
                    raise ServiceUnavailable(e)
        """,
    }
    paths = []
    for rel, body in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(body))
        paths.append(str(p))
    project = ProjectContext.detect(paths, base=str(tmp_path))
    runs = []
    for jobs in (1, 4):
        fs = lint_paths(paths, default_rules(), project=project,
                        base=str(tmp_path), jobs=jobs)
        runs.append([(f.file, f.line, f.rule_id, f.message)
                     for f in fs if f.rule_id in PROTO_IDS])
    assert runs[0] == runs[1]
    assert {r[2] for r in runs[0]} >= {"SL024", "SL025", "SL028"}
