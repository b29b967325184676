"""The port stands alone: no module of sofa_tpu_torch, and not
chip_smoke.py, imports jax or anything of the JAX package (sofa_tpu), nor
protobuf (only an optional extra of the JAX package), and importing the
port leaves them out of sys.modules."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for base, _dirs, names in os.walk(os.path.join(REPO, "sofa_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "sofa_tpu") or module.startswith(
        "google.protobuf")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_module_imports_nothing_of_jax(path):
    with open(path) as f:
        src = f.read()
    bad = [(line, mod) for line, mod in _imports(ast.parse(src))
           if _forbidden(mod)]
    # the injected sitecustomize and samplers are source in strings
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "import " in node.value and "\n" in node.value:
            try:
                inner = ast.parse(node.value)
            except SyntaxError:
                continue
            bad += [(node.lineno, mod) for _, mod in _imports(inner)
                    if _forbidden(mod)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_scan_sees_the_whole_port():
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    assert {"chip_smoke.py", "sofa_tpu_torch/workloads/flash_cuda.py",
            "sofa_tpu_torch/collectors/kineto.py",
            "sofa_tpu_torch/collectors/gpumon.py",
            "sofa_tpu_torch/ingest/memprof.py",
            "sofa_tpu_torch/analysis/host.py", "sofa_tpu_torch/api.py",
            "sofa_tpu_torch/costs.py", "sofa_tpu_torch/analysis/device.py",
            "sofa_tpu_torch/analysis/sol.py",
            "sofa_tpu_torch/workloads/resnet.py",
            "sofa_tpu_torch/tools/overhead_budget.py",
            "sofa_tpu_torch/tiles.py", "sofa_tpu_torch/viz.py",
            "sofa_tpu_torch/analysis/advice.py",
            "sofa_tpu_torch/telemetry.py", "sofa_tpu_torch/supervisor.py",
            "sofa_tpu_torch/faults.py", "sofa_tpu_torch/concurrency.py",
            "sofa_tpu_torch/pool.py", "sofa_tpu_torch/ingest/cache.py",
            "sofa_tpu_torch/tools/manifest_check.py",
            "sofa_tpu_torch/collectors/native_build.py",
            "sofa_tpu_torch/analysis/comm.py",
            "sofa_tpu_torch/analysis/concurrency.py",
            "sofa_tpu_torch/workloads/common.py",
            "sofa_tpu_torch/workloads/ring_attention.py",
            "sofa_tpu_torch/workloads/ring_flash.py",
            "sofa_tpu_torch/workloads/collectives.py",
            "sofa_tpu_torch/workloads/transformer.py",
            "sofa_tpu_torch/analysis/registry.py",
            "sofa_tpu_torch/analysis/hint_service.py",
            "sofa_tpu_torch/plugins.py", "sofa_tpu_torch/frames.py",
            "sofa_tpu_torch/durability.py",
            "sofa_tpu_torch/ml/suffix.py", "sofa_tpu_torch/ml/aisi.py",
            "sofa_tpu_torch/ml/hsg.py", "sofa_tpu_torch/ml/diff.py",
            "sofa_tpu_torch/analysis/mlpass.py",
            "sofa_tpu_torch/whatif/__init__.py",
            "sofa_tpu_torch/whatif/scenarios.py",
            "sofa_tpu_torch/whatif/model.py",
            "sofa_tpu_torch/whatif/replay.py",
            "sofa_tpu_torch/whatif/calibrate.py",
            "sofa_tpu_torch/export_static.py",
            "sofa_tpu_torch/export_folded.py",
            "sofa_tpu_torch/export_perfetto.py", "sofa_tpu_torch/charts.py",
            "sofa_tpu_torch/top.py",
            "sofa_tpu_torch/workloads/moe.py",
            "sofa_tpu_torch/workloads/pipeline.py",
            "sofa_tpu_torch/live.py", "sofa_tpu_torch/archive/__init__.py",
            "sofa_tpu_torch/archive/catalog.py",
            "sofa_tpu_torch/archive/index.py",
            "sofa_tpu_torch/archive/store.py",
            "sofa_tpu_torch/archive/baseline.py",
            "sofa_tpu_torch/archive/verdict.py",
            "sofa_tpu_torch/archive/protocol.py",
            "sofa_tpu_torch/archive/tier.py",
            "sofa_tpu_torch/archive/service.py",
            "sofa_tpu_torch/archive/client.py",
            "sofa_tpu_torch/archive/spool.py",
            "sofa_tpu_torch/agent.py", "sofa_tpu_torch/metrics.py"} <= rel


def test_importing_the_port_loads_no_jax():
    code = ("import sys, sofa_tpu_torch, sofa_tpu_torch.cli, "
            "sofa_tpu_torch.entry, sofa_tpu_torch.workloads.inference, "
            "sofa_tpu_torch.analyze, sofa_tpu_torch.convert, "
            "sofa_tpu_torch.record, sofa_tpu_torch.preprocess, "
            "sofa_tpu_torch.ingest.memprof, sofa_tpu_torch.collectors.gpumon, "
            "sofa_tpu_torch.api, sofa_tpu_torch.costs, sofa_tpu_torch.live, "
            "sofa_tpu_torch.analysis.device, sofa_tpu_torch.analysis.sol, "
            "sofa_tpu_torch.workloads.resnet, "
            "sofa_tpu_torch.tools.overhead_budget, sofa_tpu_torch.tiles, "
            "sofa_tpu_torch.viz, sofa_tpu_torch.analysis.advice, "
            "sofa_tpu_torch.telemetry, sofa_tpu_torch.supervisor, "
            "sofa_tpu_torch.faults, sofa_tpu_torch.concurrency, "
            "sofa_tpu_torch.pool, sofa_tpu_torch.ingest.cache, "
            "sofa_tpu_torch.tools.manifest_check, "
            "sofa_tpu_torch.collectors.native_build, "
            "sofa_tpu_torch.analysis.comm, sofa_tpu_torch.analysis.concurrency, "
            "sofa_tpu_torch.workloads.common, "
            "sofa_tpu_torch.workloads.ring_attention, "
            "sofa_tpu_torch.workloads.ring_flash, "
            "sofa_tpu_torch.workloads.collectives, "
            "sofa_tpu_torch.workloads.transformer, "
            "sofa_tpu_torch.workloads.moe, sofa_tpu_torch.workloads.pipeline, "
            "sofa_tpu_torch.analysis.registry, "
            "sofa_tpu_torch.analysis.hint_service, sofa_tpu_torch.plugins, "
            "sofa_tpu_torch.frames, sofa_tpu_torch.durability, "
            "sofa_tpu_torch.ml.suffix, sofa_tpu_torch.ml.aisi, "
            "sofa_tpu_torch.ml.hsg, sofa_tpu_torch.ml.diff, "
            "sofa_tpu_torch.analysis.mlpass, sofa_tpu_torch.whatif, "
            "sofa_tpu_torch.whatif.scenarios, sofa_tpu_torch.whatif.model, "
            "sofa_tpu_torch.whatif.replay, sofa_tpu_torch.whatif.calibrate, "
            "sofa_tpu_torch.export_static, sofa_tpu_torch.export_folded, "
            "sofa_tpu_torch.export_perfetto, sofa_tpu_torch.charts, "
            "sofa_tpu_torch.top, sofa_tpu_torch.archive, "
            "sofa_tpu_torch.archive.catalog, sofa_tpu_torch.archive.index, "
            "sofa_tpu_torch.archive.store, sofa_tpu_torch.archive.baseline, "
            "sofa_tpu_torch.archive.verdict, sofa_tpu_torch.archive.protocol, "
            "sofa_tpu_torch.archive.tier, sofa_tpu_torch.archive.service, "
            "sofa_tpu_torch.archive.client, sofa_tpu_torch.archive.spool, "
            "sofa_tpu_torch.agent, sofa_tpu_torch.metrics; "
            "registry = sofa_tpu_torch.analysis.registry; "
            "registry.load_builtin_passes(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'sofa_tpu', 'grpc') "
            "or m.startswith('google.protobuf')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stdout + r.stderr


def test_board_files_are_the_ports_own():
    """The board's pages are files of the port, and no port module reads
    the JAX package's board directory."""
    from sofa_tpu_torch.analyze import BOARD_DIR, board_pages

    assert os.path.dirname(BOARD_DIR) == os.path.join(REPO, "sofa_tpu_torch")
    assert {"index.html", "gpu-report.html", "sofa_board.js",
            "style.css"} <= set(board_pages())
    for path in _port_files():
        with open(path) as f:
            src = f.read()
        assert "sofa_tpu/board" not in src and \
            '"sofa_tpu", "board"' not in src, path
