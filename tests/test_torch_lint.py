"""The port's sofa-lint engine and SL001-SL013, held to the JAX package's
(``tests/test_lint.py``'s recipes): every fixture tree is written once and
linted by both engines, ``sofa_tpu.lint`` and ``sofa_tpu_torch.lint``, and
the (rule, file, line, severity) sets must be equal; each case also states
the rules it expects.  Then the suppressions, the baseline ratchet and its
location (the port's own ``sofa_tpu_torch/lint_baseline.json``, never the
repo root's JAX ledger), the exit-code contract, the self-run over the
port's tree (linted once for the module), and seeded mutations of shipped
port modules.

SL007 is the one rule whose vocabulary differs: the port's raw names are
its own (``gpumon.txt``, ``memprof.pb.gz``, the Kineto capture under
``kineto/``), so a fixture naming a device file is compared on the port's
side alone, and says so.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from sofa_tpu.lint.core import ProjectContext as JaxProjectContext
from sofa_tpu.lint.core import lint_paths as jax_lint_paths
from sofa_tpu.lint.rules import default_rules as jax_default_rules
from sofa_tpu_torch.lint.baseline import (BASELINE_NAME, Baseline,
                                          anchor_of, fingerprint_findings,
                                          locate_baseline, package_baseline)
from sofa_tpu_torch.lint.cli import run_lint
from sofa_tpu_torch.lint.core import ProjectContext, lint_paths
from sofa_tpu_torch.lint.rules import default_rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sofa_tpu_torch")
BASELINE = os.path.join(PKG, BASELINE_NAME)
PASS_IDS = ("SL010", "SL011", "SL012", "SL013")

_COLUMNS = ProjectContext.detect([]).columns  # the port's schema


def _write(tmp_path, files):
    paths = []
    for rel, body in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(body))
        if rel.endswith(".py"):
            paths.append(str(p))
    return paths


def lint_both(tmp_path, files, detect=False):
    """Lint one fixture tree with both engines: (jax findings, port
    findings).  Without ``detect`` each engine gets the same hand-built
    context (the trace schema only), as the JAX recipes do."""
    paths = _write(tmp_path, files)
    base = str(tmp_path)
    if detect:
        jp = JaxProjectContext.detect(paths, base=base)
        pp = ProjectContext.detect(paths, base=base)
    else:
        jp = JaxProjectContext(columns=frozenset(_COLUMNS))
        pp = ProjectContext(columns=frozenset(_COLUMNS))
    return (jax_lint_paths(paths, jax_default_rules(), project=jp, base=base),
            lint_paths(paths, default_rules(), project=pp, base=base))


def keys(findings, only=None):
    return sorted((f.rule_id, f.file, f.line, f.severity) for f in findings
                  if only is None or f.rule_id in only)


def assert_parity(jax_fs, port_fs, only=None):
    assert keys(port_fs, only) == keys(jax_fs, only), (
        [f.render() for f in port_fs], [f.render() for f in jax_fs])


# --- SL001-SL009, the engine: one fixture, both engines ---------------------

_RAW_OPEN = """
    import os
    def load(logdir):
        with open(os.path.join(logdir, "perf.script")) as f:
            return f.read()
"""
_KILL = """
    import os, signal
    def die(proc):
        os.killpg(proc.pid, signal.SIGTERM)
"""
_WRITE = """
    def write(path, doc):
        with open(path, "w") as f:
            f.write(doc)
"""

CASES = [
    ("sl001_flags_unbounded_subprocess", "m.py", """
        import subprocess
        subprocess.run(["ls"])
    """, ["SL001"]),
    ("sl001_ok_with_timeout_or_kwargs_or_alias", "m.py", """
        import subprocess as sp
        from subprocess import check_output
        sp.run(["ls"], timeout=5)
        check_output(["ls"], timeout=1)
        kw = {"timeout": 2}
        sp.call(["ls"], **kw)
        sp.Popen(["ls"])
    """, []),
    ("sl001_alias_and_from_import_detected", "m.py", """
        import subprocess as sp
        from subprocess import check_call
        sp.check_output(["ls"])
        check_call(["ls"])
    """, ["SL001", "SL001"]),
    ("sl001_exempt_in_collector_base", "collectors/base.py", """
        import subprocess
        subprocess.run(["ls"])
    """, []),
    ("sl002_flags_silent_broad_except", "m.py", """
        try:
            x = 1
        except Exception:
            pass
        try:
            x = 2
        except:
            x = 0
    """, ["SL002", "SL002"]),
    ("sl002_ok_when_routed_or_reraised", "m.py", """
        from sofa_tpu_torch.printing import print_warning
        try:
            x = 1
        except Exception as e:
            print_warning(f"degraded: {e}")
        try:
            x = 2
        except Exception:
            raise
        try:
            x = 3
        except (ValueError, OSError):
            pass
    """, []),
    ("sl003_flags_deadline_math", "m.py", """
        import time
        t0 = time.time()
        while time.time() - t0 < 5.0:
            pass
        retry_at = time.time() + 2.0
    """, ["SL003", "SL003"]),
    ("sl003_allows_wall_anchors", "m.py", """
        import time
        stamp = time.time()
        doc = {"t": time.time(), "pid": 1}
        wall = round(time.time() - stamp, 6)
    """, []),
    ("sl004_flags_schema_drift_in_ingest", "ingest/foo.py", """
        rows = [{"timestamp": 1.0, "duration": 0.1, "nmae": "x"}]
    """, ["SL004"]),
    ("sl004_ok_without_anchor", "ingest/foo.py", """
        rows = [{"timestamp": 1.0, "duration": 0.1, "name": "x"}]
        internal = {"flops": 1, "phase": "fw", "kind": 3}
    """, []),
    ("sl004_ok_outside_ingest", "analysis/foo.py", """
        rows = [{"timestamp": 1.0, "duration": 0.1, "nmae": "x"}]
    """, []),
    ("sl005_flags_incomplete_collector", "collectors/foo.py", """
        from sofa_tpu_torch.collectors.base import Collector
        class FooCollector(Collector):
            name = "foo"
            def probe(self):
                return None
    """, ["SL005", "SL005"]),
    ("sl005_ok_with_surface", "collectors/foo.py", """
        from sofa_tpu_torch.collectors.base import ProcessCollector
        class FooCollector(ProcessCollector):
            name = "foo"
            def start(self):
                pass
            def outputs(self):
                return []
        class Helper:
            pass
    """, []),
    ("sl006_flags_worker_global_write", "ingest/foo.py", """
        _CACHE = None
        def parse(text):
            global _CACHE
            _CACHE = text
    """, ["SL006"]),
    ("sl006_ignores_orchestration_modules", "faults.py", """
        _PLAN = None
        def install(plan):
            global _PLAN
            _PLAN = plan
    """, []),
    ("sl007_flags_raw_open_outside_ingest", "analysis/foo.py", _RAW_OPEN,
     ["SL007"]),
    ("sl007_allows_ingest", "ingest/foo.py", _RAW_OPEN, []),
    ("sl007_allows_derived_files", "analysis/foo.py", """
        def load(logdir):
            with open(logdir + "/cputrace.csv") as f:
                return f.read()
    """, []),
    ("sl008_flags_direct_kills", "collectors/foo.py", """
        import os, signal
        def die(proc):
            os.kill(proc.pid, signal.SIGKILL)
            proc.kill()
    """, ["SL008", "SL008"]),
    ("sl008_exempt_in_record", "record.py", _KILL, []),
    ("sl008_exempt_in_collector_base", "collectors/base.py", _KILL, []),
    ("sl009_flags_bare_derived_writes", "tiles.py", """
        import gzip
        def write(path, blob, doc):
            with open(path, "w") as f:
                f.write(doc)
            with gzip.open(path + ".gz", mode="wb") as f:
                f.write(blob)
    """, ["SL009", "SL009"]),
    ("sl009_allows_reads", "tiles.py", """
        def load(path):
            with open(path) as f:
                return f.read()
    """, []),
    ("sl009_exempts_the_helper_module", "durability.py", _WRITE, []),
    ("sl009_raw_producers_out_of_scope", "collectors/foo.py", _WRITE, []),
    ("inline_suppression_silences_one_line", "m.py", """
        import subprocess
        subprocess.run(["a"])  # sofa-lint: disable=SL001 — probe, bounded by caller
        subprocess.run(["b"])
    """, ["SL001"]),
    ("file_level_suppression_and_all", "m.py", """
        # sofa-lint: disable-file=SL001
        import subprocess
        subprocess.run(["a"])
        try:
            pass
        except Exception:  # sofa-lint: disable=all — anchored to the reported line
            pass
    """, []),
    ("suppression_marker_in_string_does_not_suppress", "m.py", """
        import subprocess
        subprocess.run(["sofa-lint: disable=SL001"])
    """, ["SL001"]),
    ("syntax_error_becomes_sl000_finding", "m.py", "def broken(:\n",
     ["SL000"]),
]


@pytest.mark.parametrize("name,relname,src,want", CASES,
                         ids=[c[0] for c in CASES])
def test_rule_fixture_parity(tmp_path, name, relname, src, want):
    jax_fs, port_fs = lint_both(tmp_path, {relname: src})
    assert_parity(jax_fs, port_fs)
    assert sorted(f.rule_id for f in port_fs) == sorted(want)


def test_inline_suppression_anchors_the_reported_line(tmp_path):
    _jax, fs = lint_both(tmp_path, {"m.py": CASES[25][2]})
    assert [(f.rule_id, f.line) for f in fs] == [("SL001", 4)]


def test_sl007_port_raw_names(tmp_path):
    """A device raw file: the port's names, which the JAX package's rule
    does not know (its are tpumon.txt, *.xplane.pb, memprof.pb) — so this
    fixture is held on the port's side alone."""
    src = """
        import os
        def load(logdir, name):
            a = open(os.path.join(logdir, "gpumon.txt"))
            b = open(os.path.join(logdir, "memprof.pb.gz"), "rb")
            c = open(os.path.join(logdir, "kineto", name))
            d = open(os.path.join(logdir, "gpu_top_kernels.csv"))
            return a, b, c, d
    """
    jax_fs, fs = lint_both(tmp_path, {"analysis/foo.py": src})
    assert [(f.rule_id, f.line) for f in fs] == [
        ("SL007", 4), ("SL007", 5), ("SL007", 6)]
    assert {f.rule_id for f in jax_fs} == set()
    assert lint_both(tmp_path, {"ingest/foo.py": src})[1] == []


# --- baseline semantics -----------------------------------------------------

def _lint_cli(tmp_path, *extra):
    bl = str(tmp_path / "lint_baseline.json")
    rc = run_lint([str(tmp_path), "--baseline", bl,
                   "--base", str(tmp_path), *extra])
    return rc, bl


def test_baseline_grandfathers_then_catches_new(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text("import subprocess\nsubprocess.run(['a'])\n")
    rc, bl = _lint_cli(tmp_path)
    assert rc == 1
    rc, _ = _lint_cli(tmp_path, "--update-baseline")
    assert rc == 0
    assert len(json.load(open(bl))["entries"]) == 1
    assert _lint_cli(tmp_path)[0] == 0
    mod.write_text("import subprocess\nsubprocess.run(['a'])\n"
                   "subprocess.check_call(['b'])\n")
    assert _lint_cli(tmp_path)[0] == 1


def test_baseline_entry_expires_when_fixed(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text("import subprocess\nsubprocess.run(['a'])\n"
                   "subprocess.run(['b'])\n")
    _lint_cli(tmp_path, "--update-baseline")
    mod.write_text("import subprocess\nsubprocess.run(['a'], timeout=5)\n"
                   "subprocess.run(['b'])\n")
    rc, bl = _lint_cli(tmp_path, "--update-baseline")
    assert rc == 0
    assert len(json.load(open(bl))["entries"]) == 1


def test_editing_a_baselined_line_resurfaces_it(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text("import subprocess\nsubprocess.run(['a'])\n")
    _lint_cli(tmp_path, "--update-baseline")
    mod.write_text("import subprocess\nsubprocess.run(['a', '-v'])\n")
    assert _lint_cli(tmp_path)[0] == 1


def test_line_moves_do_not_churn_baseline(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text("import subprocess\nsubprocess.run(['a'])\n")
    _lint_cli(tmp_path, "--update-baseline")
    mod.write_text("import subprocess\n\n\n# moved down\n"
                   "subprocess.run(['a'])\n")
    assert _lint_cli(tmp_path)[0] == 0


def test_cli_json_and_internal_error_rc(tmp_path, capsys):
    (tmp_path / "m.py").write_text(
        "import subprocess\nsubprocess.run(['a'])\n")
    rc = run_lint([str(tmp_path), "--no-baseline", "--json",
                   "--base", str(tmp_path)])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1 and len(doc["new"]) == 1
    bad = tmp_path / "bad_baseline.json"
    bad.write_text("{not json")
    assert run_lint([str(tmp_path), "--baseline", str(bad)]) == 2


def test_baseline_location_never_takes_the_jax_ledger(tmp_path):
    """The walk up from the port's tree stops at the port's baseline; from
    the JAX package's tree (whose only ledger is the repo root's) it falls
    back to the port's own, never the root file."""
    assert locate_baseline(os.path.join(PKG, "archive", "tier.py")) \
        == BASELINE
    assert locate_baseline(os.path.join(REPO, "sofa_tpu")) == BASELINE
    assert package_baseline() == BASELINE
    assert anchor_of(BASELINE) == REPO
    (tmp_path / "lint_baseline.json").write_text("{}")
    (tmp_path / "sub").mkdir()
    assert locate_baseline(str(tmp_path / "sub")) == \
        str(tmp_path / "lint_baseline.json")
    assert anchor_of(str(tmp_path / "lint_baseline.json")) == str(tmp_path)


# --- the gate: self-run over the port's tree, linted once -------------------

@pytest.fixture(scope="module")
def tree_findings():
    return lint_paths([PKG], default_rules(), base=REPO)


def _text_for(f):
    with open(os.path.join(REPO, f.file), errors="replace") as fh:
        lines = fh.read().splitlines()
    return lines[f.line - 1] if 1 <= f.line <= len(lines) else ""


def test_self_run_tree_is_clean(tree_findings):
    """The port's tree has zero findings outside its baseline, anchored
    at the repo root."""
    new, old = Baseline.load(BASELINE).split(
        fingerprint_findings(tree_findings, _text_for))
    assert new == [], [f.render() for f in new]
    assert all(f.file.startswith("sofa_tpu_torch/") for f in old)


def test_self_run_baseline_only_shrinks(tree_findings):
    """Every baseline entry names a live finding, and the ledger holds at
    most the ten entries the JAX package's baseline carries — each a
    counterpart of one of them (SL002/SL003 in record.py and top.py)."""
    baseline = Baseline.load(BASELINE)
    fps = fingerprint_findings(tree_findings, _text_for)
    new, old = baseline.split(fps)
    assert new == []
    assert len(old) == len(baseline.entries) <= 10
    assert {(e["rule"], e["file"]) for e in baseline.entries.values()} <= {
        ("SL002", "sofa_tpu_torch/record.py"),
        ("SL003", "sofa_tpu_torch/record.py"),
        ("SL002", "sofa_tpu_torch/top.py")}


def test_exit_code_contract_subprocess(tmp_path):
    """The tool's exit codes through a real process: 0 clean, 1 on a new
    finding."""
    r = subprocess.run(
        [sys.executable, "-m", "sofa_tpu_torch.tools.sofa_lint",
         "--explain", "SL001"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "SL001" in r.stdout
    (tmp_path / "m.py").write_text(
        "import subprocess\nsubprocess.run(['a'])\n")
    r = subprocess.run(
        [sys.executable, "-m", "sofa_tpu_torch.tools.sofa_lint",
         str(tmp_path), "--no-baseline", "--base", str(tmp_path)],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "m.py:2: SL001" in r.stdout
    (tmp_path / "m.py").write_text("x = 1\n")
    r = subprocess.run(
        [sys.executable, "-m", "sofa_tpu_torch.tools.sofa_lint",
         str(tmp_path), "--no-baseline", "--base", str(tmp_path)],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0 and "clean" in r.stdout


def test_cli_verb_lint(tmp_path, capsys):
    from sofa_tpu_torch.cli import main

    (tmp_path / "m.py").write_text(
        "import subprocess\nsubprocess.run(['a'])\n")
    assert main(["lint", str(tmp_path)]) == 1
    assert "SL001" in capsys.readouterr().out
    assert main(["lint", str(tmp_path), "--rule", "SL002"]) == 0
    capsys.readouterr()
    assert main(["lint", "--explain", "SL009"]) == 0
    assert "SL009" in capsys.readouterr().out


def test_mutation_is_caught(tmp_path):
    """A copy of a shipped port module with one timeout= deleted yields a
    fresh file:line finding."""
    src = open(os.path.join(PKG, "ingest", "perf_script.py")).read()
    needle = ",\n                             timeout=timeout_s)"
    assert needle in src
    mut = tmp_path / "ingest" / "perf_script.py"
    mut.parent.mkdir()
    mut.write_text(src.replace(needle, ")"))
    findings = lint_paths([str(mut)], default_rules(), base=str(tmp_path))
    assert any(f.rule_id == "SL001" and f.line > 0 for f in findings)


# --- SL010-SL013: the pass contract rules -----------------------------------

PASS_CASES = [
    ("sl010_flags_undeclared_frame_column_feature_access", {"p.py": '''
        from sofa_tpu_torch.analysis.registry import analysis_pass

        @analysis_pass(name="leaky", reads_frames=("gputrace",),
                       reads_columns=("timestamp",),
                       provides_features=("leaky_metric",))
        def leaky(frames, cfg, features):
            df = frames.get("cputrace")
            x = frames["mpstat"]
            y = df["duration"]
            features.add("other_metric", 1.0)
            features.get("foreign_metric")
            features.add("leaky_metric", 1.0)
    '''}, ["SL010"] * 5),
    ("sl010_clean_when_declared_including_patterns", {"p.py": '''
        from sofa_tpu_torch.analysis.registry import analysis_pass

        @analysis_pass(name="tidy", reads_frames=("gputrace",),
                       reads_columns=("timestamp", "duration", "deviceId"),
                       provides_features=("gpu*_op_time", "tidy_total"))
        def tidy(frames, cfg, features):
            df = frames.get("gputrace")
            for device_id, dev in df.groupby("deviceId"):
                features.add(f"gpu{device_id}_op_time",
                             float(dev["duration"].sum()))
            features.add("tidy_total", features.get("tidy_total") or 0.0)
            features.get("elapsed_time")
            rows = features.by_regex(r"gpu\\d+_op_time")
    '''}, []),
    ("sl011_flags_phantom_outputs", {"p.py": '''
        from sofa_tpu_torch.analysis.registry import analysis_pass

        @analysis_pass(name="phantom",
                       provides_features=("written_metric", "ghost_metric"),
                       provides_artifacts=("ghost.csv",))
        def phantom(frames, cfg, features):
            features.add("written_metric", 1.0)
    '''}, ["SL011", "SL011"]),
    ("sl011_trusts_forwarded_features", {"p.py": '''
        from sofa_tpu_torch.analysis.registry import analysis_pass

        @analysis_pass(name="wrapper",
                       provides_features=("delegated_metric",))
        def wrapper(frames, cfg, features):
            from helpers import compute
            compute(frames, cfg, features)
    '''}, []),
    ("sl012_flags_unprovided_read_unknown_after_and_cycle", {"p.py": '''
        from sofa_tpu_torch.analysis.registry import analysis_pass

        @analysis_pass(name="orphan", reads_features=("nobody_makes_this",))
        def orphan(frames, cfg, features):
            features.get("nobody_makes_this")

        @analysis_pass(name="dangling", after=("no_such_pass",))
        def dangling(frames, cfg, features):
            pass

        @analysis_pass(name="loop_a", after=("loop_b",))
        def loop_a(frames, cfg, features):
            pass

        @analysis_pass(name="loop_b", after=("loop_a",))
        def loop_b(frames, cfg, features):
            pass
    '''}, ["SL012"] * 4),
    ("sl012_sees_cross_file_providers", {
        "producer.py": '''
            from sofa_tpu_torch.analysis.registry import analysis_pass

            @analysis_pass(name="maker", provides_features=("shared_*",))
            def maker(frames, cfg, features):
                features.add("shared_count", 1.0)
        ''',
        "consumer.py": '''
            from sofa_tpu_torch.analysis.registry import analysis_pass

            @analysis_pass(name="taker", reads_features=("shared_count",))
            def taker(frames, cfg, features):
                features.get("shared_count")
        ''',
    }, []),
    ("sl013_flags_direct_pass_call", {"p.py": '''
        from sofa_tpu_torch.analysis.registry import analysis_pass

        @analysis_pass(name="first", provides_features=("first_metric",))
        def first(frames, cfg, features):
            features.add("first_metric", 1.0)

        @analysis_pass(name="second", reads_features=("first_metric",))
        def second(frames, cfg, features):
            first(frames, cfg, features)
            features.get("first_metric")
    '''}, ["SL013"]),
    ("sl013_allows_helper_calls", {"p.py": '''
        from sofa_tpu_torch.analysis.registry import analysis_pass

        def shared_helper(df):
            return df

        @analysis_pass(name="caller", reads_frames=("gputrace",))
        def caller(frames, cfg, features):
            shared_helper(frames.get("gputrace"))
    '''}, []),
]


@pytest.mark.parametrize("name,files,want", PASS_CASES,
                         ids=[c[0] for c in PASS_CASES])
def test_pass_rule_fixture_parity(tmp_path, name, files, want):
    jax_fs, port_fs = lint_both(tmp_path, files, detect=True)
    assert_parity(jax_fs, port_fs, PASS_IDS)
    got = [f for f in port_fs if f.rule_id in PASS_IDS]
    assert sorted(f.rule_id for f in got) == want, [f.render() for f in got]


def test_sl010_names_each_undeclared_access(tmp_path):
    _jax, fs = lint_both(tmp_path, PASS_CASES[0][1], detect=True)
    msgs = " ".join(f.message for f in fs if f.rule_id == "SL010")
    for name in ("'cputrace'", "'mpstat'", "'duration'", "'other_metric'",
                 "'foreign_metric'"):
        assert name in msgs


def test_pass_rules_catch_seeded_mutation_of_shipped_pass(tmp_path):
    """A copy of the port's sol.py with an undeclared feature write and
    an undeclared column read: both surface as fresh SL010 findings."""
    src = open(os.path.join(PKG, "analysis", "sol.py")).read()
    needle = 'features.add_info("sol_peak_source"'
    assert needle in src
    mut = src.replace(needle, 'features.add("sol_sneaky_metric", 1.0)\n'
                              '    ' + needle, 1)
    mut = mut.replace('rows.empty', 'rows["groups"].empty')
    p = tmp_path / "sol.py"
    p.write_text(mut)
    project = ProjectContext.detect([str(p)], base=str(tmp_path))
    fs = [f for f in lint_paths([str(p)], default_rules(), project=project,
                                base=str(tmp_path))
          if f.rule_id == "SL010"]
    assert any("'sol_sneaky_metric'" in f.message for f in fs)
    assert any("'groups'" in f.message for f in fs)
