"""The port's pass registry (``sofa_tpu_torch/analysis/registry.py``)
against the JAX package's (``sofa_tpu/analysis/registry.py``), case by case
as ``tests/test_registry.py`` holds the JAX one: declaration checks, the
waves, the deterministic merge, per-pass fault isolation with the
``meta.passes`` ledger (valid by the JAX validator), plugins, the
``passes`` verb and the advice client's deadlines.  Then the built-ins:
their names, positions and contracts equal the JAX registry's under the
device name map, ``--jobs`` 1 and 4 write byte-identical features.csv and
hints.txt over a synthetic Kineto capture, and a pass that raises
``KeyError`` leaves the run complete, ``cluster_analyze`` included.
"""

import os
import re
import shutil
import subprocess
import sys
import time

import pytest

from sofa_tpu.analysis import registry as jax_registry
from sofa_tpu_torch import telemetry
from sofa_tpu_torch.analysis import registry
from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.analysis.registry import (RegistryError, register_pass,
                                              resolve_schedule, run_passes)
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.tools.manifest_check import validate_manifest
from test_torch_board import write_sink_logdir
from test_torch_faults import jax_validator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cfg(tmp_path):
    return SofaConfig(logdir=str(tmp_path / "run"))


@pytest.fixture
def scoped_registry():
    """An empty registry for one test; the built-ins come back after."""
    with registry.scoped():
        registry.clear()
        yield registry


# --- declaration checks ------------------------------------------------------

BAD_DECLARATIONS = {
    "duplicate": (dict(name="p1"), "already registered"),
    "unknown_column": (dict(name="p2", reads_columns=("timestamp",
                                                      "no_such_column")),
                       "not in trace.COLUMNS"),
    "bare_string": (dict(name="p3", provides_features="oops_not_a_tuple"),
                    "bare string"),
}


@pytest.mark.parametrize("case", sorted(BAD_DECLARATIONS))
def test_register_rejects_bad_declarations(scoped_registry, case):
    register_pass(lambda f, c, x: None, name="p1")
    contract, match = BAD_DECLARATIONS[case]
    with pytest.raises(RegistryError, match=match):
        register_pass(lambda f, c, x: None, **contract)


# --- the schedule -------------------------------------------------------------

def test_feature_reads_order_waves(scoped_registry):
    register_pass(lambda f, c, x: x.add("base_metric", 1.0),
                  name="producer", provides_features=("base_metric",))
    register_pass(lambda f, c, x: x.add("derived_metric",
                                        (x.get("base_metric") or 0) + 1),
                  name="consumer", reads_features=("base_metric",),
                  provides_features=("derived_metric",))
    waves = resolve_schedule(registry.registered(), strict=True)
    assert [[s.name for s in w] for w in waves] == [["producer"],
                                                    ["consumer"]]


def test_wildcard_patterns_schedule(scoped_registry):
    """gpu*_kernel_time provided covers a gpu0_kernel_time read."""
    register_pass(lambda f, c, x: None, name="p",
                  provides_features=("gpu*_kernel_time",))
    register_pass(lambda f, c, x: None, name="q",
                  reads_features=("gpu0_kernel_time",))
    assert registry.pass_dependencies(registry.registered())["q"] == ["p"]


def test_ambient_features_need_no_producer(scoped_registry):
    register_pass(lambda f, c, x: None, name="p",
                  reads_features=("elapsed_time",))
    assert len(resolve_schedule(registry.registered(), strict=True)) == 1
    assert registry.AMBIENT_FEATURES == jax_registry.AMBIENT_FEATURES


def test_cycle_raises_strict_degrades_at_runtime(scoped_registry, cfg,
                                                 capsys):
    register_pass(lambda f, c, x: x.add("a_metric", 1.0), name="a",
                  provides_features=("a_metric",), after=("b",))
    register_pass(lambda f, c, x: None, name="b", after=("a",))
    with pytest.raises(RegistryError, match="cycle"):
        resolve_schedule(registry.registered(), strict=True)
    ledger, _ = run_passes({}, cfg, Features())
    assert "cycle" in capsys.readouterr().err
    assert ledger["passes"]["a"]["status"] == "ok"
    assert ledger["passes"]["b"]["status"] == "ok"


def test_enabled_when_gates_to_skipped(scoped_registry, cfg):
    register_pass(lambda f, c, x: x.add("gated_metric", 1.0), name="gated",
                  provides_features=("gated_metric",),
                  enabled_when=("spotlight",))
    features = Features()
    ledger, _ = run_passes({}, cfg, features)
    assert ledger["passes"]["gated"]["status"] == "skipped"
    assert "spotlight" in ledger["passes"]["gated"]["skip_reason"]
    assert features.get("gated_metric") is None
    cfg.spotlight = True
    ledger, _ = run_passes({}, cfg, Features())
    assert ledger["passes"]["gated"]["status"] == "ok"


# --- determinism --------------------------------------------------------------

def test_run_passes_jobs_identical_rows(scoped_registry, cfg):
    """Sleep jitter inverts the completion order within a wave; the merge
    stays canonical."""
    def slow(f, c, x):
        time.sleep(0.05)
        x.add("slow_metric", 1.0)

    def fast(f, c, x):
        x.add("fast_metric", 2.0)

    def late(f, c, x):
        x.add("late_metric", (x.get("slow_metric") or 0)
              + (x.get("fast_metric") or 0))

    register_pass(slow, name="slow", order=1,
                  provides_features=("slow_metric",))
    register_pass(fast, name="fast", order=2,
                  provides_features=("fast_metric",))
    register_pass(late, name="late", order=3,
                  reads_features=("slow_metric", "fast_metric"),
                  provides_features=("late_metric",))
    f1, f4 = Features(), Features()
    ledger1, _ = run_passes({}, cfg, f1, jobs=1)
    ledger4, _ = run_passes({}, cfg, f4, jobs=4)
    assert f1._rows == f4._rows == [("slow_metric", 1.0),
                                    ("fast_metric", 2.0),
                                    ("late_metric", 3.0)]
    assert ledger1["schedule"] == ledger4["schedule"]
    assert (ledger1["jobs"], ledger4["jobs"]) == (1, 4)


def test_reads_see_completed_waves_not_siblings(scoped_registry, cfg):
    def a(f, c, x):
        x.add("wave0_metric", 7.0)

    def sib(f, c, x):
        x.add("sibling_metric", 1.0)

    def b(f, c, x):
        time.sleep(0.02)            # sib is done by now, and stays unseen
        x.add("saw_wave0", x.get("wave0_metric") or -1.0)
        x.add("saw_sibling", x.get("sibling_metric") or -1.0)
        x.add("saw_rows", float(len(x.by_regex(r"(wave0|sibling)_metric"))))

    register_pass(a, name="a", order=1, provides_features=("wave0_metric",))
    register_pass(sib, name="sib", order=2,
                  provides_features=("sibling_metric",))
    register_pass(b, name="b", order=3, reads_features=("wave0_metric",),
                  after=("a",),
                  provides_features=("saw_wave0", "saw_sibling",
                                     "saw_rows"))
    assert [[s.name for s in w] for w in resolve_schedule(
        registry.registered(), strict=True)] == [["a", "sib"], ["b"]]
    features = Features()
    run_passes({}, cfg, features, jobs=4)
    assert features.get("saw_wave0") == 7.0
    assert features.get("saw_sibling") == 1.0     # a completed wave
    assert features.get("saw_rows") == 2.0

    registry.clear()
    register_pass(sib, name="sib", order=1,
                  provides_features=("sibling_metric",))
    register_pass(b, name="b", order=2,
                  provides_features=("saw_wave0", "saw_sibling", "saw_rows"))
    assert [[s.name for s in w] for w in resolve_schedule(
        registry.registered(), strict=True)] == [["sib", "b"]]
    features = Features()
    run_passes({}, cfg, features, jobs=4)
    assert features.get("saw_sibling") == -1.0    # a same-wave sibling


# --- fault isolation ----------------------------------------------------------

def test_crashing_pass_degrades_and_the_rest_run(scoped_registry, cfg,
                                                 capsys):
    def boom(f, c, x):
        raise RuntimeError("deliberate crash")

    register_pass(boom, name="boom", order=1)
    register_pass(lambda f, c, x: x.add("healthy_metric", 1.0),
                  name="healthy", order=2,
                  provides_features=("healthy_metric",))
    features = Features()
    ledger, _ = run_passes({}, cfg, features)
    assert ledger["passes"]["boom"]["status"] == "failed"
    assert "deliberate crash" in ledger["passes"]["boom"]["error"]
    assert ledger["passes"]["healthy"]["status"] == "ok"
    assert features.get("healthy_metric") == 1.0
    assert "boom" in capsys.readouterr().err


def test_crashing_pass_lands_failed_in_manifest(cfg):
    """analyze completes past a raising pass; meta.passes marks it
    failed, both validators accept the manifest, the healthy check and
    ``status`` do not, and the warning counts in the run."""
    from sofa_tpu_torch.analyze import sofa_analyze
    from sofa_tpu_torch.cli import main

    def chaos(f, c, x):
        raise RuntimeError("chaos pass crash")

    with registry.scoped():
        registry.load_builtin_passes()
        register_pass(chaos, name="chaos")
        features = sofa_analyze(cfg, frames={})
    assert registry.get("chaos") is None
    assert features.get("elapsed_time") is not None
    doc = telemetry.load_manifest(cfg.logdir)
    ledger = doc["meta"]["passes"]["passes"]
    assert ledger["chaos"]["status"] == "failed"
    assert "chaos pass crash" in ledger["chaos"]["error"]
    assert doc["runs"]["analyze"]["counters"]["warnings"] >= 1
    assert validate_manifest(doc) == []
    assert jax_validator()(doc) == []
    assert any("chaos" in p for p in validate_manifest(
        doc, require_healthy=True))
    assert main(["status", cfg.logdir]) == 1


# --- plugins ------------------------------------------------------------------

def _write_plugin(tmp_path, name, body):
    (tmp_path / f"{name}.py").write_text(body)
    return str(tmp_path)


def test_plugin_pass_registers_with_origin(tmp_path, cfg, monkeypatch):
    monkeypatch.syspath_prepend(_write_plugin(tmp_path, "tgoodplug", """
def tgoodplug(cfg):
    from sofa_tpu_torch.analysis.registry import register_pass
    def plugin_pass(frames, cfg, features):
        features.add("plugin_metric", 42.0)
    register_pass(plugin_pass, name="plugin_pass",
                  provides_features=("plugin_metric",))
"""))
    from sofa_tpu_torch.plugins import load_plugins

    cfg.plugins = ["tgoodplug"]
    with registry.scoped():
        load_plugins(cfg)
        spec = registry.get("plugin_pass")
        assert spec.origin == "plugin:tgoodplug" and spec.order > 1000
        features = Features()
        ledger, _ = run_passes({}, cfg, features)
        assert features.get("plugin_metric") == 42.0
        assert ledger["passes"]["plugin_pass"]["origin"] == \
            "plugin:tgoodplug"
    assert registry.get("plugin_pass") is None


@pytest.mark.parametrize("body,needle", [
    ("def tbadplug(cfg):\n    raise RuntimeError('plugin load crash')\n",
     "plugin load crash"),
    ("raise RuntimeError('import-time crash')\n", "import-time crash"),
    ("x = 1\n", "no callable entry point"),
], ids=["entry_point_raises", "import_raises", "no_entry_point"])
def test_crashing_plugin_is_skipped(tmp_path, cfg, monkeypatch, capsys, body,
                                    needle):
    monkeypatch.syspath_prepend(_write_plugin(tmp_path, "tbadplug", body))
    monkeypatch.delitem(sys.modules, "tbadplug", raising=False)
    from sofa_tpu_torch.plugins import load_plugins

    cfg.plugins = ["tbadplug", "no_such_module_xyz"]
    with registry.scoped():
        load_plugins(cfg)
    err = capsys.readouterr().err
    assert needle in err and "no_such_module_xyz" in err


def test_crashing_plugin_pass_fails_not_aborts(tmp_path, cfg, monkeypatch):
    monkeypatch.syspath_prepend(_write_plugin(tmp_path, "tcrashplug", """
def tcrashplug(cfg):
    from sofa_tpu_torch.analysis.registry import register_pass
    def crashing_pass(frames, cfg, features):
        raise ValueError("third-party bug")
    register_pass(crashing_pass, name="crashing_pass")
"""))
    from sofa_tpu_torch.plugins import load_plugins

    cfg.plugins = ["tcrashplug"]
    with registry.scoped():
        load_plugins(cfg)
        ledger, _ = run_passes({}, cfg, Features())
    ent = ledger["passes"]["crashing_pass"]
    assert ent["status"] == "failed" and ent["origin"] == "plugin:tcrashplug"


# --- the `passes` verb --------------------------------------------------------

def test_passes_renders_dag_and_contracts(cfg, capsys):
    from sofa_tpu_torch.cli import main

    assert main(["passes", cfg.logdir]) == 0
    out = capsys.readouterr().out
    assert "wave 0:" in out and "wave 1:" in out
    registry.load_builtin_passes()
    for spec in registry.registered():
        assert f"{spec.name}  [builtin]" in out
    assert "provides:" in out and "after:" in out


def test_passes_shows_last_run_timings(tmp_path):
    from sofa_tpu_torch.analyze import sofa_analyze

    logdir = str(tmp_path / "run")
    sofa_analyze(SofaConfig(logdir=logdir), frames={})
    r = subprocess.run([sys.executable, "-m", "sofa_tpu_torch", "passes",
                        logdir], capture_output=True, text=True,
                       timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    registry.load_builtin_passes()
    enabled = [s for s in registry.registered() if s.enabled(SofaConfig())]
    assert r.stdout.count("[last run: ok") == len(enabled)
    # the gated mining passes say why they did not run
    assert r.stdout.count("[last run: skipped") == \
        len(registry.registered()) - len(enabled) == 2


def test_passes_exit_2_on_unschedulable_graph(scoped_registry, cfg, capsys,
                                              monkeypatch):
    register_pass(lambda f, c, x: None, name="a", after=("b",))
    register_pass(lambda f, c, x: None, name="b", after=("a",))
    monkeypatch.setattr(registry, "load_builtin_passes", lambda: None)
    assert registry.sofa_passes(cfg) == 2
    assert "cycle" in capsys.readouterr().err


# --- the advice client's bounds -----------------------------------------------

def test_fetch_hints_unreachable_server_degrades_fast(cfg, capsys,
                                                      monkeypatch):
    from sofa_tpu_torch.analysis.hint_service import fetch_hints

    monkeypatch.setenv("SOFA_HINT_CONNECT_TIMEOUT_S", "0.3")
    monkeypatch.setenv("SOFA_HINT_TIMEOUT_S", "0.3")
    cfg.hint_server = "127.0.0.1:9"         # discard port: nothing listens
    t0 = time.monotonic()
    assert fetch_hints(cfg, Features()) == []
    assert time.monotonic() - t0 < 5.0
    assert "continuing without remote hints" in capsys.readouterr().err


def test_fetch_hints_no_server_is_silent(cfg, monkeypatch):
    from sofa_tpu_torch.analysis.hint_service import fetch_hints

    monkeypatch.delenv("SOFA_HINT_SERVER", raising=False)
    assert fetch_hints(cfg, Features()) == []


@pytest.mark.parametrize("raw,want", [("2.5", 2.5), ("garbage", 5.0),
                                      ("-1", 5.0), ("", 5.0)])
def test_hint_timeout_env_parsing(monkeypatch, raw, want):
    from sofa_tpu.analysis import hint_service as jax_hs
    from sofa_tpu_torch.analysis import hint_service as hs

    monkeypatch.setenv("SOFA_HINT_TIMEOUT_S", raw)
    assert hs._env_timeout("SOFA_HINT_TIMEOUT_S", 5.0) == want == \
        jax_hs._env_timeout("SOFA_HINT_TIMEOUT_S", 5.0)


# --- the built-ins against the JAX registry -----------------------------------

def to_port(name: str) -> str:
    """A JAX registry name in the port's terms: TPU -> GPU, ICI -> link,
    and the XLA module launches' frame -> the host trace, where the
    port's record_function ranges are."""
    if name == "tpumodules":
        return "hosttrace"
    return re.sub(r"(?<![a-z])ici(?![a-z])", "link",
                  name.replace("tpu", "gpu"))


# Where a port pass reads or provides other things than its JAX twin:
# (field, the port's value).  gpu_profile counts kernels, copies and busy
# shares where tpu_profile counts XLA ops, collectives and custom calls
# (and also reads gpusteps for the in-step busy share); op_tree_profile
# and overlap_profile pick kernels and copies by copyKind (the TPU passes
# by category); the port's serving_profile derives no intensities or HBM
# rate, and finds the host's annotations by hlo_category; mpstat_profile
# reads payload to tell a frozen /proc/stat (no cpu_util) from an idle
# one; net_profile finds the device's kernels by copyKind.  aisi reads
# no XLA module frame (its markers anchor through gpusteps) but the strace
# frame its per-step profile reads; hsg reads the host trace, which its
# JAX twin falls back to without declaring it.
PORT_DIFFERENCES = {
    "aisi": {"reads_frames"},
    "hsg": {"reads_frames"},
    "gpu_profile": {"reads_frames", "reads_columns", "provides_features",
                    "provides_artifacts"},
    "mpstat_profile": {"reads_columns"},
    "net_profile": {"reads_columns"},
    "op_tree_profile": {"reads_columns"},
    "overlap_profile": {"reads_columns"},
    "serving_profile": {"provides_features", "reads_columns"},
}


def test_builtins_match_the_jax_registry():
    jax_registry.load_builtin_passes()
    registry.load_builtin_passes()
    jax_specs = {s.name: s for s in jax_registry.registered()
                 if s.origin == "builtin"}
    port_specs = {s.name: s for s in registry.registered()
                  if s.origin == "builtin"}
    assert set(port_specs) == {to_port(n) for n in jax_specs}
    for jname, j in jax_specs.items():
        p = port_specs.get(to_port(jname))
        if p is None:
            continue
        assert (p.order, p.after, p.enabled_when, p.provides_series,
                p.reads_features) == (j.order, j.after, j.enabled_when,
                                      j.provides_series,
                                      tuple(to_port(v)
                                            for v in j.reads_features))
        for field in ("reads_frames", "reads_columns", "provides_features",
                      "provides_artifacts"):
            want = tuple(to_port(v) for v in getattr(j, field))
            same = getattr(p, field) == want
            assert same != (field in PORT_DIFFERENCES.get(p.name, ())), \
                (p.name, field, getattr(p, field), want)
    # the port's differing contracts still name only what the pass does
    gp = port_specs["gpu_profile"]
    assert "gpu_total_flops" in gp.provides_features
    assert gp.provides_artifacts == ("gpu_top_kernels.csv",
                                     "gpu_categories.csv",
                                     "gpu_modules_summary.csv")


# --- the built-ins end to end -------------------------------------------------

@pytest.fixture(scope="module")
def sink_logdir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sink_registry")) + "/"
    write_sink_logdir(d)
    from sofa_tpu_torch.preprocess import sofa_preprocess

    sofa_preprocess(SofaConfig(logdir=d, jobs=1))
    return d


def _analyze_copy(src, dst, **cfg_kw):
    from sofa_tpu_torch.analyze import sofa_analyze

    shutil.copytree(src, dst)
    cfg = SofaConfig(logdir=dst, **cfg_kw)
    sofa_analyze(cfg)
    return cfg


def _outputs(cfg):
    out = {}
    for name in ("features.csv", "hints.txt"):
        with open(cfg.path(name), "rb") as f:
            out[name] = f.read()
    return out


def test_jobs_1_and_4_byte_identical_and_sequential(sink_logdir, tmp_path):
    """--jobs 1 and 4 write the same bytes, and the same rows as every
    pass run in canonical order on one Features (the plain loop the
    registry replaced); the manifest holds the ledger, valid by the JAX
    validator."""
    from sofa_tpu_torch.preprocess import load_frames, read_misc

    outs = {}
    for jobs in (1, 4):
        cfg = _analyze_copy(sink_logdir, str(tmp_path / f"j{jobs}"),
                            jobs=jobs)
        outs[jobs] = _outputs(cfg)
        doc = telemetry.load_manifest(cfg.logdir)
        assert doc["meta"]["passes"]["jobs"] == jobs
        assert validate_manifest(doc) == [] and jax_validator()(doc) == []
        statuses = {n: e["status"] for n, e in
                    doc["meta"]["passes"]["passes"].items()}
        # every pass ran but the mining passes, gated off by default
        assert {n for n, st in statuses.items() if st != "ok"} == \
            {"aisi", "hsg"}
        assert {statuses["aisi"], statuses["hsg"]} == {"skipped"}
    assert outs[1] == outs[4]
    assert b"gpu_total_flops" in outs[1]["features.csv"]
    assert outs[1]["hints.txt"].strip()

    cfg = SofaConfig(logdir=str(tmp_path / "j1"))
    frames = load_frames(cfg)
    elapsed = float(read_misc(cfg)["elapsed_time"])
    registry.load_builtin_passes()
    sequential, registered = Features(), Features()
    for f in (sequential, registered):
        f.add("elapsed_time", elapsed)
    for spec in registry.registered():
        if spec.enabled(cfg):
            spec.fn(frames, cfg, sequential)
    run_passes(frames, cfg, registered, jobs=4)
    assert sequential._rows == registered._rows
    assert sequential._info == registered._info


def _key_error_pass(frames, cfg, features):
    features.add("partial_metric", 1.0)
    raise KeyError("no_such_frame")


def test_a_raising_pass_leaves_the_run_complete(sink_logdir, tmp_path,
                                                capsys):
    """A pass that raises KeyError: features.csv and hints.txt are written,
    every other pass's features are there, and analyze prints
    Complete!!."""
    from sofa_tpu_torch.cli import main

    want = _outputs(_analyze_copy(sink_logdir, str(tmp_path / "clean")))
    bad = shutil.copytree(sink_logdir, str(tmp_path / "bad"))
    capsys.readouterr()
    with registry.scoped():
        registry.load_builtin_passes()
        register_pass(_key_error_pass, name="key_error_pass")
        assert main(["analyze", "--logdir", bad]) == 0
    out = capsys.readouterr()
    assert "Complete!!" in out.out
    assert "analyze pass key_error_pass: KeyError" in out.err
    got = _outputs(SofaConfig(logdir=bad))
    assert got["hints.txt"] == want["hints.txt"]
    # every row of the clean run, and the failed pass's own partial row
    lines = got["features.csv"].decode().splitlines(keepends=True)
    lines.remove("partial_metric,1.0\n")
    assert "".join(lines) == want["features.csv"].decode()
    doc = telemetry.load_manifest(bad)
    assert doc["meta"]["passes"]["passes"]["key_error_pass"]["status"] == \
        "failed"
    assert jax_validator()(doc) == []


def test_cluster_analyze_merges_past_a_raising_pass(sink_logdir, tmp_path):
    from sofa_tpu_torch.analyze import cluster_analyze

    for host in ("a", "b"):
        shutil.copytree(sink_logdir, str(tmp_path / f"c-{host}"))
    cfg = SofaConfig(logdir=str(tmp_path / "c"), cluster_hosts=["a", "b"],
                     jobs=2)
    with registry.scoped():
        registry.load_builtin_passes()
        register_pass(_key_error_pass, name="key_error_pass")
        results = cluster_analyze(cfg)
    assert sorted(results) == ["a", "b"]
    assert os.path.isfile(cfg.path("report.js"))
    assert os.path.isfile(cfg.path("cluster_summary.csv"))
    for host in ("a", "b"):
        doc = telemetry.load_manifest(str(tmp_path / f"c-{host}"))
        assert doc["meta"]["passes"]["passes"]["key_error_pass"][
            "status"] == "failed"
        assert results[host].get("gpu_kernels") is not None
