"""SL019-SL023 over the port, held to the JAX package's engine
(``tests/test_concurrency_lint.py``'s recipes): each fixture tree is
linted by both engines with the execution-context graph detected, and the
(rule, file, line, severity) sets must be equal.  Then the seeded mutation
(a guard taken out of a copy of the port's telemetry.py fires SL019 at the
write), the port's tree (linted once for the module, at --jobs 1 and 4:
zero concurrency findings, byte-identical JSON), the embedded injection
templates (the sitecustomize, the Kineto tracer, the gpumon and pystacks
samplers) parsed as virtual modules, the import-side-effect contract, the
``--rule``/``--explain`` contract, the Guard primitive, and race tests
that hammer Guard-protected state under a tiny switch interval.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest

from sofa_tpu.lint.core import ProjectContext as JaxProjectContext
from sofa_tpu.lint.core import lint_paths as jax_lint_paths
from sofa_tpu.lint.rules import default_rules as jax_default_rules
from sofa_tpu_torch.concurrency import Guard
from sofa_tpu_torch.lint.cli import run_lint
from sofa_tpu_torch.lint.concurrency_rules import build_concurrency_graph
from sofa_tpu_torch.lint.core import ProjectContext, lint_paths
from sofa_tpu_torch.lint.rules import default_rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sofa_tpu_torch")
CONC_RULES = ("SL019", "SL020", "SL021", "SL022", "SL023")


def run_conc(tmp_path, files):
    """Write {relname: src}, lint with both engines (graphs detected),
    assert the concurrency findings agree; return the port's."""
    paths = []
    for rel, body in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(body))
        paths.append(str(p))
    base = str(tmp_path)
    port = [f for f in lint_paths(paths, default_rules(),
                                  project=ProjectContext.detect(paths, base),
                                  base=base)
            if f.rule_id in CONC_RULES]
    jax = [f for f in jax_lint_paths(
        paths, jax_default_rules(),
        project=JaxProjectContext.detect(paths, base), base=base)
        if f.rule_id in CONC_RULES]

    def key(fs):
        return sorted((f.rule_id, f.file, f.line, f.severity) for f in fs)

    assert key(port) == key(jax), ([f.render() for f in port],
                                   [f.render() for f in jax])
    return port


def ids(findings):
    return [f.rule_id for f in findings]


# --- SL019: declared-guard contracts ----------------------------------------

def test_sl019_write_outside_declared_guard(tmp_path):
    fs = run_conc(tmp_path, {"m.py": """
        from sofa_tpu_torch.concurrency import Guard

        _G = Guard("m.items", protects=("_items",))
        _items = []

        def bad(x):
            _items.append(x)

        def good(x):
            with _G:
                _items.append(x)
    """})
    assert ids(fs) == ["SL019"]
    assert "_items" in fs[0].message and "declared guard" in fs[0].message
    assert fs[0].line == 8


def test_sl019_multi_context_write_needs_guard(tmp_path):
    fs = run_conc(tmp_path, {"m.py": """
        import threading

        _count = {}

        def worker():
            _count["n"] = 1

        def main():
            t = threading.Thread(target=worker)
            t.start()
            _count["n"] = 2
            t.join()
    """})
    assert ids(fs) == ["SL019"]
    assert "multiple execution contexts" in fs[0].message


def test_sl019_imported_class_attr_mutation(tmp_path):
    fs = run_conc(tmp_path, {"m.py": """
        import http.server

        http.server.ThreadingHTTPServer.daemon_threads = True
    """})
    assert ids(fs) == ["SL019"]
    assert "process-global" in fs[0].message


def test_sl019_clean_patterns(tmp_path):
    fs = run_conc(tmp_path, {"m.py": """
        import threading

        from sofa_tpu_torch import printing
        from sofa_tpu_torch.concurrency import Guard

        printing.verbose = True

        _G = Guard("m.state", protects=("_state",))
        _state = {}

        def worker():
            with _G:
                _state["k"] = 1

        def main():
            t = threading.Thread(target=worker)
            t.start()
            with _G:
                _state["k"] = 2
            t.join()
    """})
    assert fs == []


# --- SL020: blocking under a guard, lock-order cycles -----------------------

def test_sl020_blocking_calls_under_lock(tmp_path):
    fs = run_conc(tmp_path, {"m.py": """
        import subprocess
        import threading
        import time

        _lock = threading.Lock()

        def f():
            with _lock:
                subprocess.run(["ls"], timeout=1)
                time.sleep(0.1)

        def ok():
            with _lock:
                x = 1
            subprocess.run(["ls"], timeout=1)
    """})
    assert ids(fs) == ["SL020", "SL020"]
    assert all(f.severity == "warn" for f in fs)


def test_sl020_lock_order_cycle(tmp_path):
    fs = run_conc(tmp_path, {"m.py": """
        import threading

        _a = threading.Lock()
        _b = threading.Lock()

        def f():
            with _a:
                with _b:
                    pass

        def g():
            with _b:
                with _a:
                    pass
    """})
    cycles = [f for f in fs if "cycle" in f.message]
    assert len(cycles) == 1 and cycles[0].rule_id == "SL020"
    assert cycles[0].severity == "error"


def test_sl020_consistent_order_is_clean(tmp_path):
    fs = run_conc(tmp_path, {"m.py": """
        import threading

        _a = threading.Lock()
        _b = threading.Lock()

        def f():
            with _a:
                with _b:
                    pass

        def g():
            with _a:
                with _b:
                    pass
    """})
    assert fs == []


def test_sl020_path_join_under_a_guard_misfires_and_is_suppressed(tmp_path):
    """The ``.join`` heuristic stays as it is: os.path.join under a held
    guard reads as a blocking join (warn), which the port's WAL appender
    suppresses inline, as the JAX package's does."""
    fs = run_conc(tmp_path, {"m.py": """
        import os
        import threading

        _lock = threading.Lock()

        def f(d, n):
            with _lock:
                a = os.path.join(d, n)
                b = os.path.join(d, n)  # sofa-lint: disable=SL020 — string math
            return a, b
    """})
    assert [(f.rule_id, f.line) for f in fs] == [("SL020", 9)]


# --- SL021: commit ordering -------------------------------------------------

_VERB_TMPL = """
    from sofa_tpu_torch.durability import Journal, write_digests
    from sofa_tpu_torch.trace import atomic_write

    def sofa_demo(logdir):
        j = Journal(logdir)
        {body}
"""


def _verb(body):
    return _VERB_TMPL.format(body=body.replace("\n", "\n        "))


def test_sl021_write_after_commit(tmp_path):
    fs = run_conc(tmp_path, {"verbmod.py": _verb("""
j.begin("demo")
with atomic_write(logdir + "/out.json") as f:
    f.write("{}")
write_digests(logdir)
j.commit("demo")
with atomic_write(logdir + "/late.json") as f:
    f.write("{}")
""")})
    assert ids(fs) == ["SL021"]
    assert "after commit()" in fs[0].message and "late.json" in fs[0].message


def test_sl021_begin_without_commit_and_inverted_window(tmp_path):
    fs = run_conc(tmp_path, {
        "nocommit.py": _verb('j.begin("demo")'),
        "inverted.py": _verb('j.commit("demo")\nj.begin("demo")'),
    })
    msgs = {f.file.split("/")[-1]: f.message for f in fs}
    assert "never commit()" in msgs["nocommit.py"]
    assert "before its begin()" in msgs["inverted.py"]


def test_sl021_write_between_digest_and_commit(tmp_path):
    fs = run_conc(tmp_path, {"verbmod.py": _verb("""
j.begin("demo")
write_digests(logdir)
with atomic_write(logdir + "/out.json") as f:
    f.write("{}")
j.commit("demo")
""")})
    assert ids(fs) == ["SL021"]
    assert "digest refresh" in fs[0].message


def test_sl021_well_ordered_verb_is_clean(tmp_path):
    fs = run_conc(tmp_path, {"verbmod.py": _verb("""
j.begin("demo")
with atomic_write(logdir + "/out.json") as f:
    f.write("{}")
write_digests(logdir)
j.commit("demo")
""")})
    assert fs == []


# --- SL022: thread-context safety -------------------------------------------

def test_sl022_module_level_thread_spawn(tmp_path):
    fs = run_conc(tmp_path, {"m.py": """
        import threading

        def _poll():
            pass

        _t = threading.Thread(target=_poll, daemon=True)
        _t.start()
    """})
    assert ids(fs) == ["SL022"]
    assert "module import time" in fs[0].message


def test_sl022_signal_off_main_thread(tmp_path):
    fs = run_conc(tmp_path, {"m.py": """
        import signal
        import threading

        def _handler(sig, frm):
            pass

        def _w():
            signal.signal(signal.SIGTERM, _handler)

        def go():
            t = threading.Thread(target=_w)
            t.start()
            t.join()
    """})
    assert ids(fs) == ["SL022"]
    assert "non-main execution context" in fs[0].message


def test_sl022_sentinel_check_then_act(tmp_path):
    fs = run_conc(tmp_path, {"m.py": """
        import os

        def racing(logdir):
            return os.path.exists(
                os.path.join(logdir, "_derived.writing"))
    """})
    assert ids(fs) == ["SL022"]
    assert "derived_writing" in fs[0].message


def test_sl022_embedded_template_import_spawn(tmp_path):
    pad = "#" + " padding" * 30
    fs = run_conc(tmp_path, {"coll.py": f'''
        _TEMPLATE = """
        {pad}
        import threading

        def _poll():
            pass

        _t = threading.Thread(target=_poll, daemon=True)
        _t.start()
        """
    '''})
    assert ids(fs) == ["SL022"]
    assert "embedded template" in fs[0].message
    assert fs[0].line > 5


def test_sl022_lazy_template_is_clean(tmp_path):
    pad = "#" + " padding" * 30
    fs = run_conc(tmp_path, {"coll.py": f'''
        _TEMPLATE = """
        {pad}
        import sys
        import threading

        def _arm():
            t = threading.Thread(target=_poll, daemon=True)
            t.start()
            t.join()

        def _poll():
            pass
        """
    '''})
    assert fs == []


def test_port_injection_templates_are_virtual_modules():
    """The templates the collectors write into _inject/ are found and
    parsed: the sitecustomize and the Kineto tracer (collectors/kineto.py)
    and the gpumon and pystacks samplers — and none spawns a thread at
    import (the port's tree has no SL022 finding; see the gate below)."""
    files = [os.path.join(PKG, "collectors", n)
             for n in ("kineto.py", "gpumon.py", "pystacks.py")]
    g = build_concurrency_graph(files, base=REPO)
    found = {(rel.rsplit("/", 1)[-1], name)
             for rel, vms in g.virtuals.items() for name, _l, _vm in vms}
    assert {("kineto.py", "_SITECUSTOMIZE"), ("kineto.py", "_TRACER"),
            ("gpumon.py", "_SAMPLER"), ("pystacks.py", "_SAMPLER")} <= found
    for vms in g.virtuals.values():
        for _name, _line, vm in vms:
            assert all(s.func for s in vm.spawns)


# --- SL023: shutdown liveness -----------------------------------------------

def test_sl023_thread_without_stop_path(tmp_path):
    fs = run_conc(tmp_path, {"m.py": """
        import threading

        class Daemonette:
            def start(self):
                self._thread = threading.Thread(target=self._run,
                                                daemon=True)
                self._thread.start()

            def _run(self):
                pass
    """})
    assert ids(fs) == ["SL023"]
    assert "no reachable stop path" in fs[0].message


def test_sl023_accepts_join_return_and_cancel_registry(tmp_path):
    fs = run_conc(tmp_path, {"m.py": """
        import threading

        _TIMERS = []

        class Svc:
            def start(self):
                self._thread = threading.Thread(target=self._run)
                self._thread.start()

            def stop(self):
                self._thread.join(timeout=5)

            def _run(self):
                pass

        def bounded(fn, timeout):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            t.join(timeout)

        def handoff(fn):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            return t

        def arm(fn, delay):
            t = threading.Timer(delay, fn)
            _TIMERS.append(t)
            t.start()

        def clear():
            while _TIMERS:
                _TIMERS.pop().cancel()
    """})
    assert fs == []


# --- the seeded mutation ----------------------------------------------------

def test_removing_a_guard_from_telemetry_fires_sl019(tmp_path):
    src = open(os.path.join(PKG, "telemetry.py")).read()
    guarded = ("        with self._lock:\n"
               "            self.counters[key] = "
               "self.counters.get(key, 0) + 1\n")
    assert guarded in src
    unguarded = ("        self.counters[key] = "
                 "self.counters.get(key, 0) + 1\n"
                 "        with self._lock:\n")
    mutated = src.replace(guarded, unguarded)
    p = tmp_path / "telemetry.py"
    p.write_text(mutated)
    project = ProjectContext.detect([str(p)], base=str(tmp_path))
    fs = [f for f in lint_paths([str(p)], default_rules(), project=project,
                                base=str(tmp_path))
          if f.rule_id == "SL019"]
    assert len(fs) == 1
    assert "counters" in fs[0].message
    want = mutated.splitlines().index(
        "        self.counters[key] = self.counters.get(key, 0) + 1") + 1
    assert fs[0].line == want


# --- the port's tree, linted once at --jobs 1 and once at --jobs 4 ----------

@pytest.fixture(scope="module")
def tree_json():
    import contextlib
    import io

    out = {}
    for jobs in (1, 4):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_lint([PKG, "--no-baseline", "--json", "--base", REPO,
                           "--jobs", str(jobs)])
        out[jobs] = (rc, buf.getvalue())
    return out


def test_shipped_tree_has_zero_concurrency_findings(tree_json):
    """No SL019-SL023 finding on the port's tree, baselined or not."""
    doc = json.loads(tree_json[1][1])
    conc = [f for f in doc["new"] if f["rule"] in CONC_RULES]
    assert conc == []
    assert doc["baselined"] == 0 and doc["baseline"] is None


def test_jobs_output_byte_identical(tree_json):
    rc1, out1 = tree_json[1]
    rc4, out4 = tree_json[4]
    assert rc1 == rc4
    assert out1 == out4
    assert json.loads(out1)["by_rule"]


def test_rule_filter_and_exit_contract(tmp_path, capsys):
    mod = tmp_path / "m.py"
    mod.write_text("import subprocess\nsubprocess.run(['a'])\n")
    assert run_lint([str(tmp_path), "--no-baseline",
                     "--base", str(tmp_path)]) == 1
    capsys.readouterr()
    assert run_lint([str(tmp_path), "--no-baseline", "--base",
                     str(tmp_path), "--rule", "SL019,SL023"]) == 0
    assert run_lint([str(tmp_path), "--no-baseline", "--base",
                     str(tmp_path), "--rule", "SL001"]) == 1
    assert run_lint([str(tmp_path), "--rule", "bogus"]) == 2


def test_explain_prints_catalog_row(capsys):
    assert run_lint(["--explain", "SL021"]) == 0
    out = capsys.readouterr().out
    assert "SL021" in out and "commit" in out.lower()
    assert run_lint(["--explain", "SL999"]) == 2


def test_import_sofa_tpu_torch_spawns_no_threads():
    r = subprocess.run(
        [sys.executable, "-c",
         "import sofa_tpu_torch, sofa_tpu_torch.lint, threading; "
         "print(','.join(sorted(t.name for t in threading.enumerate())))"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "MainThread"


def test_injected_sitecustomize_spawns_no_threads_without_torch(tmp_path):
    """Importing the generated sitecustomize (what every child python
    does) starts no thread in a program that never imports torch."""
    from sofa_tpu_torch.collectors.kineto import _SITECUSTOMIZE

    (tmp_path / "sitecustomize.py").write_text(_SITECUSTOMIZE)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SOFA_TORCH_")}
    env.update({"PYTHONPATH": str(tmp_path),
                "SOFA_TORCH_KINETO_OPTS": json.dumps(
                    {"enable": True, "logdir": str(tmp_path)})})
    r = subprocess.run(
        [sys.executable, "-c",
         "import threading; "
         "print(','.join(sorted(t.name for t in threading.enumerate())))"],
        capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "MainThread"


# --- the Guard primitive ----------------------------------------------------

def test_guard_is_reentrant_unless_asked():
    g = Guard("test.guard", protects=("x",))
    with g:
        with g:
            pass
    flat = Guard("test.flat", protects=("x",), reentrant=False)
    with flat:
        assert not flat._lock.acquire(blocking=False)
    assert flat._lock.acquire(blocking=False)
    flat._lock.release()
    assert "test.guard" in repr(g) and "'x'" in repr(g)


def test_guard_rejects_anonymous():
    with pytest.raises(ValueError):
        Guard("")


# --- race tests (amplified by the conftest fixture) -------------------------

@pytest.mark.race
def test_telemetry_counters_survive_contention():
    from sofa_tpu_torch import telemetry

    tel = telemetry.Telemetry("race")
    n_threads, per = 8, 400

    def hammer():
        for _ in range(per):
            tel.console("warning", "w")
            tel.collector_event("col", bytes_captured=1)
            tel.source_event("src", events=1)
            tel.next_seq()

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tel.counters["warnings"] == n_threads * per
    assert tel._seq == n_threads * per
    assert len(tel.warning_tail) <= 20


@pytest.mark.race
def test_telemetry_registry_survives_begin_end_churn():
    from sofa_tpu_torch import telemetry

    def churn():
        for _ in range(200):
            tel = telemetry.begin("race")
            telemetry.collector_event("c", "started")
            telemetry.end(tel)

    threads = [threading.Thread(target=churn) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert telemetry.current() is None


@pytest.mark.race
def test_guard_excludes_writers():
    g = Guard("race.guard", protects=("shared",))
    shared = {"n": 0}

    def bump():
        for _ in range(2000):
            with g:
                shared["n"] = shared["n"] + 1

    threads = [threading.Thread(target=bump) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert shared["n"] == 12000
