"""SL014-SL018 over the port's layout, the seeded registry mutation, the
port's tree's closure, and the ``artifacts`` inventory verb (schema, exit
codes, the logdir audit) — the JAX package's recipes
(``tests/test_artifacts.py``) on the port's registries.

The two packages keep their registries in different modules (the JAX
package's ``trace.py`` DERIVED_FILES/DERIVED_SUFFIXES; the port's
``record.py`` RAW_FILES/ANALYSIS_FILES/VERB_FILES/DERIVED_DIRS, the frames
``preprocess._ingest_tasks`` declares, the staged ``board/`` pages and
``durability.py``'s raw patterns), so these fixtures are the JAX
recipes' defects planted in a port-layout tree, and each asserts that
the same rule fires at the defect's line.  Companions sit inside the
fixture package as they do in the port: ``pkg/tools/manifest_check.py``
enables SL016 and the SL018 validator leg, ``pkg/board/`` SL017,
``pkg/docs/OBSERVABILITY.md`` the SL018 docs leg.
"""

import json
import os
import textwrap

import pytest

from sofa_tpu_torch.lint.artifact_rules import build_artifact_graph
from sofa_tpu_torch.lint.core import ProjectContext, lint_paths
from sofa_tpu_torch.lint.rules import default_rules
from sofa_tpu_torch.tools import manifest_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sofa_tpu_torch")
ARTIFACT_IDS = ("SL014", "SL015", "SL016", "SL017", "SL018")

REGISTRY = """
    RAW_FILES = ("raw.txt",)
    ANALYSIS_FILES = ("good.json", "dead.json")
    VERB_FILES = ("verb.txt",)
    DERIVED_DIRS = ("_scratch",)
    DIGEST_SKIP_FILES = frozenset({"good.json"})
    DIGEST_SKIP_DIRS = frozenset({"_scratch"})
"""
DURABILITY = """
    RAW_PATTERNS = ("gpumon.rank*.txt",)
    RAW_DIRS = ("kineto",)
"""
PREPROCESS = """
    SIDE_FRAMES = ("side_a", "side_b")

    def _ingest_tasks(cfg, time_base):
        def T(name, kind, fn, args, raw, kwargs=None, params=None,
              frames=None):
            pass
        for name, raw in (("looped", "l.txt"), ("looped2", "m.txt")):
            T(name, "thread", None, (), [raw])
        T("series", "thread", None, (), [])
        T("multi", "thread", None, (), [], frames=SIDE_FRAMES)
"""


def run_artifact_rules(tmp_path, files):
    paths = []
    for rel, body in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(body))
        if rel.endswith(".py"):
            paths.append(str(p))
    project = ProjectContext.detect(paths, base=str(tmp_path))
    fs = lint_paths(paths, default_rules(), project=project,
                    base=str(tmp_path))
    return [f for f in fs if f.rule_id in ARTIFACT_IDS]


def _line(src, needle):
    src = textwrap.dedent(src)
    return src[:src.index(needle)].count("\n") + 1


# --- SL014 ------------------------------------------------------------------

LEAK = """
    from sofa_tpu_torch.trace import atomic_write
    def w(logdir):
        with atomic_write("leak.bin") as f:
            f.write("x")
"""


def test_sl014_flags_unregistered_writer(tmp_path):
    fs = run_artifact_rules(tmp_path, {"pkg/record.py": REGISTRY,
                                       "pkg/m.py": LEAK})
    assert [f.rule_id for f in fs] == ["SL014"]
    assert fs[0].file == "pkg/m.py" and "leak.bin" in fs[0].message
    assert fs[0].line == _line(LEAK, 'atomic_write("leak.bin")')


def test_sl014_ok_registered_frame_dir_and_raw(tmp_path):
    fs = run_artifact_rules(tmp_path, {
        "pkg/record.py": REGISTRY,
        "pkg/durability.py": DURABILITY,
        "pkg/preprocess.py": PREPROCESS,
        "pkg/m.py": """
            import os
            from sofa_tpu_torch.trace import atomic_write, fsync_append
            def w(logdir, name):
                with atomic_write("good.json") as f:        # registered
                    f.write("x")
                with atomic_write("verb.txt") as f:         # verb file
                    f.write("x")
                with atomic_write("series.csv") as f:       # frame
                    f.write("x")
                with atomic_write("looped2.parquet") as f:  # frame (loop)
                    f.write("x")
                with atomic_write("side_b.csv") as f:       # frames=
                    f.write("x")
                with atomic_write(os.path.join("_scratch", "x.bin")) as f:
                    f.write("x")                            # derived dir
                fsync_append("raw.txt", "line")             # raw file
                fsync_append("gpumon.rank3.txt", "line")    # raw pattern
                with atomic_write(os.path.join("kineto", "t.json")) as f:
                    f.write("x")                            # raw dir
            def r():
                open("good.json").read()
                open("dead.json").read()
        """,
    })
    assert fs == [], [f.render() for f in fs]


def test_sl014_resolves_constants_and_scope_assigns(tmp_path):
    src = """
        import os
        from sofa_tpu_torch.trace import atomic_write
        NAME = "leak2.bin"
        def w(logdir):
            path = os.path.join(logdir, NAME)
            with atomic_write(path) as f:
                f.write("x")
    """
    fs = run_artifact_rules(tmp_path, {"pkg/record.py": REGISTRY,
                                       "pkg/m.py": src})
    assert [f.rule_id for f in fs] == ["SL014"]
    assert "leak2.bin" in fs[0].message
    assert fs[0].line == _line(src, "atomic_write(path)")


def test_sl014_a_frame_only_by_its_declared_names(tmp_path):
    """A task with frames= produces those frames, not one named after
    itself; a CSV no task declares is a leak (the port has no derived
    suffixes)."""
    src = """
        from sofa_tpu_torch.trace import atomic_write
        def w():
            with atomic_write("multi.csv") as f:
                f.write("x")
            with atomic_write("nobody.csv") as f:
                f.write("x")
    """
    fs = run_artifact_rules(tmp_path, {"pkg/record.py": REGISTRY,
                                       "pkg/preprocess.py": PREPROCESS,
                                       "pkg/m.py": src})
    assert [(f.rule_id, f.line) for f in fs] == [
        ("SL014", _line(src, '"multi.csv"')),
        ("SL014", _line(src, '"nobody.csv"'))]


# --- SL015 ------------------------------------------------------------------

def test_sl015_flags_unregistered_skip_entry_and_dir(tmp_path):
    reg = """
        RAW_FILES = ()
        ANALYSIS_FILES = ("good.json",)
        VERB_FILES = ()
        DERIVED_DIRS = ()
        DIGEST_SKIP_FILES = frozenset({"typo.json"})
        DIGEST_SKIP_DIRS = frozenset({"_ghost"})
    """
    fs = run_artifact_rules(tmp_path, {"pkg/record.py": reg})
    assert sorted(f.rule_id for f in fs) == ["SL015", "SL015"]
    by = {f.line: f.message for f in fs}
    assert "typo.json" in by[_line(reg, '"typo.json"')]
    assert "_ghost" in by[_line(reg, '"_ghost"')]
    assert all(f.file == "pkg/record.py" for f in fs)


def test_sl015_flags_digestless_verb_writer(tmp_path):
    src = """
        from sofa_tpu_torch.trace import atomic_write
        def sofa_thing(cfg):
            with atomic_write("verb.txt") as f:
                f.write("x")
    """
    fs = run_artifact_rules(tmp_path, {
        "pkg/record.py": REGISTRY,
        "pkg/cli.py": "from pkg.verb import sofa_thing\n",
        "pkg/verb.py": src,
    })
    assert [f.rule_id for f in fs] == ["SL015"]
    assert fs[0].file == "pkg/verb.py" and "verb.txt" in fs[0].message
    assert fs[0].line == _line(src, 'atomic_write("verb.txt")')


def test_sl015_ok_when_skip_listed_or_digests_refreshed(tmp_path):
    fs = run_artifact_rules(tmp_path, {
        "pkg/record.py": REGISTRY,
        "pkg/cli.py": """
            from pkg.verb import sofa_thing
            from pkg.verb2 import sofa_other
        """,
        "pkg/verb.py": """
            from sofa_tpu_torch.trace import atomic_write
            def sofa_thing(cfg):
                with atomic_write("good.json") as f:
                    f.write("x")
        """,
        "pkg/verb2.py": """
            from sofa_tpu_torch.durability import write_digests
            from sofa_tpu_torch.trace import atomic_write
            def sofa_other(cfg):
                with atomic_write("verb.txt") as f:
                    f.write("x")
                write_digests(cfg.logdir)
        """,
    })
    assert fs == []


# --- SL016 ------------------------------------------------------------------

MANIFEST_CHECK_FIXTURE = """
    def _check_meta(meta, probs):
        bar = meta.get("bar")
        if bar is None:
            probs.append("meta.bar missing")

    def validate_manifest(doc):
        probs = []
        _check_meta(doc.get("meta") or {}, probs)
        baz = (doc.get("meta") or {}).get("baz")
        return probs
"""


def test_sl016_both_directions(tmp_path):
    fs = run_artifact_rules(tmp_path, {
        "pkg/record.py": REGISTRY,
        "pkg/t.py": """
            def write(tel):
                tel.set_meta(foo={"x": 1}, baz=1)
        """,
        "pkg/tools/manifest_check.py": MANIFEST_CHECK_FIXTURE,
    })
    assert sorted(f.rule_id for f in fs) == ["SL016", "SL016"]
    unval = next(f for f in fs if "meta.foo" in f.message)
    assert unval.file == "pkg/t.py"
    unwritten = next(f for f in fs if "meta.bar" in f.message)
    assert unwritten.file == "pkg/tools/manifest_check.py"
    assert unwritten.line == _line(MANIFEST_CHECK_FIXTURE, 'meta.get("bar")')


def test_sl016_inert_without_manifest_check(tmp_path):
    fs = run_artifact_rules(tmp_path, {
        "pkg/record.py": REGISTRY,
        "pkg/t.py": """
            def write(tel):
                tel.set_meta(foo={"x": 1})
        """,
    })
    assert fs == []


# --- SL017 ------------------------------------------------------------------

def test_sl017_endpoint_without_producer_and_dead_artifact(tmp_path):
    fs = run_artifact_rules(tmp_path, {
        "pkg/record.py": REGISTRY,
        "pkg/m.py": """
            def r():
                open("good.json").read()
        """,
        "pkg/board/page.html": """
            <script>fetch("ghost.csv");</script>
        """,
    })
    assert sorted(f.rule_id for f in fs) == ["SL017", "SL017"]
    ghost = next(f for f in fs if "ghost.csv" in f.message)
    assert ghost.severity == "error" and ghost.file == "pkg/board/page.html"
    dead = next(f for f in fs if "dead.json" in f.message)
    assert dead.severity == "warn" and dead.file == "pkg/record.py"
    assert dead.line == _line(REGISTRY, '"dead.json"')


def test_sl017_ok_with_producer_route_frames_and_readers(tmp_path):
    fs = run_artifact_rules(tmp_path, {
        "pkg/record.py": REGISTRY,
        "pkg/preprocess.py": PREPROCESS,
        "pkg/viz.py": """
            ROUTE = "/tiles/"
        """,
        "pkg/m.py": """
            from sofa_tpu_torch.trace import atomic_write
            def r():
                open("good.json").read()
                open("dead.json").read()
        """,
        "pkg/board/page.html": """
            <script src="sofa_board.js"></script>
            <script>
            fetch("series.csv"); fetch("good.json"); fetch("side_a.csv");
            fetch("tiles/s/0/0.json.gz"); fetch("raw.txt");
            </script>
        """,
        "pkg/board/sofa_board.js": "// the shared helpers\n",
    })
    assert fs == [], [f.render() for f in fs]


# --- SL018 ------------------------------------------------------------------

def test_sl018_writer_validator_and_docs_agreement(tmp_path):
    fs = run_artifact_rules(tmp_path, {
        "pkg/record.py": REGISTRY,
        "pkg/w.py": """
            FOO_SCHEMA = "sofa_tpu/foo"
            FOO_VERSION = 2
        """,
        "pkg/tools/manifest_check.py": """
            _FOO_SCHEMA = "sofa_tpu/foo"
            _FOO_VERSION = 1
        """,
        "pkg/docs/OBSERVABILITY.md": """
            | schema id | version | writer | validator |
            |---|---|---|---|
            | `sofa_tpu/foo` | 3 | w.py | manifest_check |
        """,
    })
    msgs = sorted(f.message for f in fs if f.rule_id == "SL018")
    assert len(msgs) == 2
    assert any("manifest_check pins v1" in m for m in msgs)
    assert any("says v3" in m for m in msgs)


def test_sl018_missing_docs_row_and_stale_validator(tmp_path):
    fs = run_artifact_rules(tmp_path, {
        "pkg/record.py": REGISTRY,
        "pkg/w.py": """
            FOO_SCHEMA = "sofa_tpu/foo"
            FOO_VERSION = 1
        """,
        "pkg/tools/manifest_check.py": """
            _GONE_SCHEMA = "sofa_tpu/gone"
            _GONE_VERSION = 1
        """,
        "pkg/docs/OBSERVABILITY.md": """
            nothing tabled here
        """,
    })
    msgs = [f.message for f in fs if f.rule_id == "SL018"]
    assert any("no row in docs/OBSERVABILITY.md" in m for m in msgs)
    assert any("stale validator" in m for m in msgs)


def test_sl018_clean_when_all_three_agree_and_imported_pins(tmp_path):
    """The port's validator imports most writer constants: an imported
    ``<X>_SCHEMA``/``<X>_VERSION`` pair pins the writer's own version,
    and docs at the repo root (the JAX package's) are not read."""
    fs = run_artifact_rules(tmp_path, {
        "pkg/record.py": REGISTRY,
        "pkg/w.py": """
            FOO_SCHEMA = "sofa_tpu/foo"
            FOO_VERSION = 2
        """,
        "pkg/tools/manifest_check.py": """
            from pkg.w import FOO_SCHEMA, FOO_VERSION
        """,
        "pkg/docs/OBSERVABILITY.md": """
            | `sofa_tpu/foo` | 2 | w.py | manifest_check |
        """,
        "docs/OBSERVABILITY.md": """
            | `sofa_tpu/foo` | 9 | w.py | manifest_check |
        """,
    })
    assert fs == []
    g = build_artifact_graph([str(tmp_path / "pkg" / "record.py"),
                              str(tmp_path / "pkg" / "w.py")],
                             base=str(tmp_path))
    assert [(s.schema_id, s.version) for s in g.schema_validators] == [
        ("sofa_tpu/foo", 2)]


# --- the registry itself -----------------------------------------------------

def test_dropping_registry_entry_fires_sl014(tmp_path):
    """A defect planted in a copy of the port's record.py registry (drop
    run_manifest.json from ANALYSIS_FILES) surfaces as SL014 at the real
    telemetry.py's writer site."""
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    src = open(os.path.join(PKG, "record.py")).read()
    needle = '"_derived.writing", "run_manifest.json", "sofa_self_trace.json",'
    assert needle in src
    (pkg / "record.py").write_text(src.replace(
        needle, '"_derived.writing", "sofa_self_trace.json",'))
    tel = open(os.path.join(PKG, "telemetry.py")).read()
    (pkg / "telemetry.py").write_text(tel)
    paths = [str(pkg / "record.py"), str(pkg / "telemetry.py")]
    project = ProjectContext.detect(paths, base=str(tmp_path))
    assert project.artifacts.ok
    fs = lint_paths(paths, default_rules(), project=project,
                    base=str(tmp_path))
    hits = [f for f in fs if f.rule_id == "SL014"
            and "run_manifest.json" in f.message]
    want = tel[:tel.index("with atomic_write(os.path.join(logdir, "
                          "MANIFEST_NAME))")].count("\n") + 1
    assert [(h.file, h.line) for h in hits] == [("pkg/telemetry.py", want)]
    # ...and the unmutated registry is clean
    (pkg / "record.py").write_text(src)
    fs = lint_paths(paths, default_rules(),
                    project=ProjectContext.detect(paths, base=str(tmp_path)),
                    base=str(tmp_path))
    assert [f for f in fs if f.rule_id == "SL014"] == []


@pytest.fixture(scope="module")
def built():
    """The port's tree's graph and its inventory, detected once."""
    from sofa_tpu_torch import artifacts

    project, base = artifacts.build_graph()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(artifacts, "build_graph", lambda: (project, base))
        doc = artifacts.build_inventory()
    return project, base, doc


@pytest.fixture(scope="module")
def graph(built):
    return built[0].artifacts


def test_static_frames_equal_the_runtime_registry(graph):
    """The frame names read out of preprocess.py's task table equal what
    preprocess.frame_names() returns at run time, and record.py's tables
    and durability's raw patterns are the graph's."""
    from sofa_tpu_torch import durability, record
    from sofa_tpu_torch.analyze import board_pages
    from sofa_tpu_torch.preprocess import frame_names

    assert set(frame_names()) <= graph.frame_names
    assert graph.raw_files == frozenset(record.RAW_FILES)
    assert graph.derived_files == frozenset(record.ANALYSIS_FILES
                                            + record.VERB_FILES)
    assert graph.derived_dirs == frozenset(record.DERIVED_DIRS)
    assert graph.root_files == frozenset(record.ROOT_FILES)
    assert graph.skip_files == record.DIGEST_SKIP_FILES
    assert graph.skip_dirs == record.DIGEST_SKIP_DIRS
    assert graph.raw_patterns == durability.RAW_PATTERNS
    assert graph.raw_dirs == frozenset(durability.RAW_DIRS)
    assert graph.board_files == frozenset(board_pages())
    for name in record.derived_names():
        assert graph.clean_coverage(name) is not None, name


# --- the inventory verb (built once) ----------------------------------------

@pytest.fixture(scope="module")
def inventory(built):
    return built[2]


def test_shipped_tree_has_zero_artifact_findings(inventory):
    assert inventory["violations"] == []


def test_build_inventory_full_closure(inventory):
    doc = inventory
    assert doc["ok"] is True and doc["counts"]["violations"] == 0
    names = {r["name"] for r in doc["artifacts"]}
    for expected in ("report.js", "features.csv", "run_manifest.json",
                     "whatif_report.json", "regress_verdict.json",
                     "sol_roofline.csv", "gputrace.csv", "gpumon.txt",
                     "index.html"):
        assert expected in names
    for r in doc["artifacts"]:
        assert r["clean"] != "UNREGISTERED", r
    manifest = next(r for r in doc["artifacts"]
                    if r["name"] == "run_manifest.json")
    assert manifest["digest"] == "skip-list" and manifest["writers"]


def test_inventory_schema_validates(inventory):
    assert manifest_check.validate_inventory(inventory) == []
    assert manifest_check.validate_inventory(
        inventory, require_healthy=True) == []
    assert manifest_check.validate_inventory(dict(inventory, version=99))
    leaky = dict(inventory, logdir={"path": "x", "files_checked": 1,
                                    "unaccounted": ["rogue.bin"]})
    assert manifest_check.validate_inventory(leaky) == []
    assert manifest_check.validate_inventory(leaky, require_healthy=True)


def test_manifest_check_dispatches_inventory_doc(tmp_path, inventory):
    path = tmp_path / "inv.json"
    path.write_text(json.dumps(inventory))
    assert manifest_check.check_path(str(path)) == 0
    path.write_text(json.dumps(dict(inventory, artifacts=[])))
    assert manifest_check.check_path(str(path)) == 1


def test_inventory_detects_logdir_leak(tmp_path, monkeypatch, built,
                                       capsys):
    """The audit over a logdir: registered, frame, board, raw, numbered
    raw and raw-directory files are accounted for; nested archive roots
    and .tmp files are not audited; a stray file is a leak (exit 2)."""
    from sofa_tpu_torch import artifacts

    monkeypatch.setattr(artifacts, "build_graph", lambda: built[:2])
    monkeypatch.setattr(artifacts, "_violations", lambda p, b: [])
    logdir = tmp_path / "log"
    for rel in ("report.js", "mpstat.txt", "gputrace.csv", "index.html",
                "gpumon.rank1.txt", "memprof.rank1.pb.gz",
                "kineto/trace_12.json", "gpu_topo/rank0.json",
                "_frames/gputrace/frame_index.json", "_inject/x.py",
                "_tiles/s/0.json.gz", "report.js.tmp",
                "sofa_hints/sofa_archive.json", "sofa_hints/objects/x"):
        p = logdir / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("x")
    assert artifacts.sofa_artifacts(str(logdir)) == 0
    (logdir / "rogue.bin").write_text("leak me")
    (logdir / "kineto_extra").mkdir()
    (logdir / "kineto_extra" / "x.json").write_text("{}")
    assert artifacts.sofa_artifacts(str(logdir)) == 2
    doc = artifacts.build_inventory(str(logdir))
    assert doc["logdir"]["unaccounted"] == ["kineto_extra/x.json",
                                            "rogue.bin"]
    assert doc["ok"] is False
    assert "LEAK rogue.bin" in capsys.readouterr().out


def test_cli_artifacts_verb_json(monkeypatch, inventory, capsys):
    from sofa_tpu_torch import artifacts
    from sofa_tpu_torch.cli import main

    monkeypatch.setattr(artifacts, "build_inventory",
                        lambda logdir=None: inventory)
    assert main(["artifacts", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["schema"] == "sofa_tpu/artifact_inventory"
    assert doc["ok"] is True
    assert main(["artifacts"]) == 0
    assert "full closure" in capsys.readouterr().out


# --- deterministic output ordering -----------------------------------------

def test_lint_output_sorted_by_rule_file_line(tmp_path, capsys):
    from sofa_tpu_torch.lint.cli import run_lint

    (tmp_path / "b.py").write_text(
        "import subprocess\nsubprocess.run(['a'])\n"
        "try:\n    pass\nexcept Exception:\n    pass\n")
    (tmp_path / "a.py").write_text(
        "import subprocess\nsubprocess.run(['a'])\n")
    rc = run_lint([str(tmp_path), "--no-baseline", "--json",
                   "--base", str(tmp_path)])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1
    keys = [(f["rule"], f["file"], f["line"]) for f in doc["new"]]
    assert keys == sorted(keys)
    run_lint([str(tmp_path), "--no-baseline", "--base", str(tmp_path)])
    rendered = [ln for ln in capsys.readouterr().out.splitlines()
                if ": SL" in ln]
    parsed = [(ln.split(" ")[1], ln.split(":")[0]) for ln in rendered]
    assert parsed == sorted(parsed)
