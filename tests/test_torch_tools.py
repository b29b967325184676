"""The port's card-facing tools held against the JAX package's on the CPU:
``edr``, ``kernel_perf``'s and ``tune_flash``'s pure parts, ``bench_import``
and ``chaos_tier``.

The sweeps of ``kernel_perf`` and ``tune_flash`` run only on the card
(``chip_smoke.py``'s ``kernel_perf`` phase; a ring-depth variant of each
kernel is held against its plain version in ``tests/test_torch_cuda.py``);
here their counts, bounds, shared-memory arithmetic, library hashes and
markdown are checked.  The JAX tools under ``tools/`` are loaded from their
files, as ``tests/test_bench.py`` loads ``kernel_perf``.
"""

import glob
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest

from sofa_tpu.archive import catalog as jcatalog
from sofa_tpu.tools import edr as jedr
from sofa_tpu_torch import kernels
from sofa_tpu_torch.analysis import sol
from sofa_tpu_torch.archive import catalog
from sofa_tpu_torch.tools import edr, kernel_perf, tune_flash

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(_ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- edr ---------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "starting epoch=epoch", "evaluating", " padded key ", "a=b=c", "=x",
    "final loss=train", ""])
def test_edr_parse_trigger_matches_jax(spec):
    assert edr.parse_trigger(spec) == jedr.parse_trigger(spec)


def test_edr_tail_lines_matches_jax(tmp_path):
    """The same appends through both tailers: non-UTF-8 bytes, a partial
    last line completed later, a file truncated under the reader, a missing
    file.  Lines and byte offsets must agree at every step."""
    path = str(tmp_path / "app.log")
    steps = [
        ("w", b""),
        ("a", b"setup \xff\xfe done\n"),          # non-UTF-8 bytes
        ("a", b"starting epoch 1\npartial"),      # a partial last line
        ("a", b" line ends\n\xc3\x28 bad pair\n"),
        ("a", b"no newline yet"),
        ("w", b"rotated\n"),                      # truncated: size < pos
        ("a", b"\xe2\x82 cut char\nlast\n"),
        ("rm", b""),
    ]
    pos_port = pos_jax = 0
    for op, data in steps:
        if op == "rm":
            os.unlink(path)
        else:
            with open(path, op + "b") as f:
                f.write(data)
        got = edr.tail_lines(path, pos_port)
        want = jedr.tail_lines(path, pos_jax)
        assert got == want, (op, data)
        (_, pos_port), (_, pos_jax) = got, want


def test_edr_trigger_fires(tmp_path):
    """tests/test_record.py's EDR recipe, with the port's record."""
    log = tmp_path / "train.log"
    log.write_text("setup...\nstarting epoch 1\n")
    base = str(tmp_path / "edrlog")
    rc = edr.run_edr([
        "--log", str(log),
        "--trigger", "starting epoch=epoch",
        "--record_seconds", "0.2",
        "--logdir", base + "/",
        "--poll_s", "0.1",
        "--timeout_s", "60",
    ])
    assert rc == 0
    assert os.path.isfile(f"{base}-epoch/misc.txt")
    with open(f"{base}-epoch/run_manifest.json") as f:
        assert "record" in json.load(f)["runs"]


# --- kernel_perf -------------------------------------------------------------

def test_kernel_perf_attention_flops_match_jax():
    jkp = _jax_tool("kernel_perf")
    for b in (1, 2, 4, 8):
        for t in (1, 129, 2048, 16384):
            for h, d in ((8, 128), (32, 128), (4, 64)):
                for causal in (True, False):
                    for bwd in (True, False):
                        assert kernel_perf.attention_flops(
                            b, t, h, d, causal, bwd) == jkp.attention_flops(
                            b, t, h, d, causal, bwd)


def test_kernel_perf_imports_the_sol_table():
    """One peak table for the tool and every analyze run: the tool's
    lookup reads ``sol.PEAKS``, keyed on the card's name."""
    assert kernel_perf.PEAKS is sol.PEAKS
    assert kernel_perf.PEAK_SOURCE is sol.PEAK_SOURCE
    assert kernel_perf.card_peaks("NVIDIA H100 80GB HBM3") == (989e12,
                                                                3350e9)
    assert kernel_perf.card_peaks("NVIDIA A100-SXM4-80GB") is None


def test_kernel_perf_bounds():
    """The visible pairs of the causal rule and the bound the kernel phase
    of chip_smoke.py computes (its formulas before they moved here)."""
    assert kernel_perf.visible_pairs(2048, 2048, 0) == 2048 * 2049 // 2
    assert kernel_perf.visible_pairs(300, 500, 500) == 300 * 500
    assert kernel_perf.visible_pairs(256, 256, -256) == 0
    assert kernel_perf.visible_pairs(4, 6, 1) == 2 + 3 + 4 + 5
    b, t, h, kvh, d = 4, 2048, 32, 8, 128
    q_n, kv_n = b * t * h * d, b * t * kvh * d
    flops, nbytes = kernel_perf.forward_cost(b, t, t, h, kvh, d, 0)
    assert flops == 4.0 * b * h * d * t * (t + 1) / 2
    assert nbytes == 2.0 * (2 * q_n + 2 * kv_n) + 4.0 * b * h * t
    peaks = (989e12, 3.35e12)
    ms, by = kernel_perf.bound(flops, nbytes, peaks)
    assert by == "operations" and ms == pytest.approx(0.139, abs=1e-3)
    costs = kernel_perf.backward_costs(b, t, t, h, kvh, d, 0)
    pairs = b * h * t * (t + 1) / 2
    operands, rows = 2.0 * (2 * q_n + 2 * kv_n), 2.0 * b * h * t * 4
    assert costs["sofa_flash_bwd_kv"] == (8.0 * d * pairs,
                                          operands + rows + 2.0 * 2 * kv_n)
    assert costs["sofa_flash_bwd_dq"] == (6.0 * d * pairs,
                                          operands + rows + 2.0 * q_n)
    assert kernel_perf.bound(*costs["sofa_flash_bwd_kv"], peaks)[0] == \
        pytest.approx(0.278, abs=1e-3)
    assert kernel_perf.bound(1.0, 1e12, peaks)[1] == "bytes"


def _rows(peaks):
    return [kernel_perf._row("flash fwd", 1, 16384, 8, 8, 128, True, "fwd",
                             ((2.5, 2.7), (2.0, 2.2)), peaks),
            kernel_perf._row("ring hop (non-causal)", 2, 4096, 8, 8, 128,
                             False, "fwd", ((1.0, 1.0), (0.9, 0.9)), peaks),
            kernel_perf._row("flash fwd+bwd", 8, 2048, 8, 8, 128, True,
                             "fwd+bwd", ((0.001, 0.001), (1.0, 1.0)), peaks),
            kernel_perf._row("sofa_flash_bwd_kv", 8, 2048, 8, 8, 128, True,
                             "sofa_flash_bwd_kv", ((5.0, 5.0), (4.0, 4.0)),
                             peaks)]


def test_kernel_perf_render_md_known_and_unknown_card():
    """tests/test_bench.py's recipe: rows rendered with a peak, and without
    one for a card the table does not name."""
    card = "NVIDIA H100 80GB HBM3"
    peaks = kernel_perf.card_peaks(card)
    rows = _rows(peaks)
    r = rows[0]
    assert r["ms"] == pytest.approx(2.6) and r["sdpa_ms"] == pytest.approx(
        2.1)
    assert r["tflops"] == pytest.approx(
        kernel_perf.attention_flops(1, 16384, 8, 128) / 2.6e-3 / 1e12)
    assert r["pct_peak"] == pytest.approx(100 * r["tflops"] / 989)
    md = kernel_perf.render_md(rows, peaks, card,
                               "NVIDIA H100 80GB HBM3, 700.00 W")
    assert "Card: NVIDIA H100 80GB HBM3 (nvidia-smi: NVIDIA H100 80GB " \
           "HBM3, 700.00 W)" in md
    assert "Peak: **989 TFLOP/s dense bf16, 3,350 GB/s**" in md
    assert (f"| flash fwd | 1 | 16384 | 8 / 8 | 128 | 2.6000 | "
            f"{r['tflops']:.1f} | {r['pct_peak']:.1f} | 2.1000 | "
            f"{2.6 / 2.1:.3f} | {r['bound_ms']:.4f} | operations | "
            f"{r['pct_bound']:.1f} |") in md
    assert "40 %" not in md and "target" not in md.lower()
    assert "The fwd+bwd rows are end to end" in md
    # a backward kernel alone: its own bound, its 4 model matmuls
    kv = rows[3]
    assert kv["bound_ms"] == kernel_perf.bound(*kernel_perf.backward_costs(
        8, 2048, 2048, 8, 8, 128, 0)["sofa_flash_bwd_kv"], peaks)[0]
    assert kv["tflops"] == pytest.approx(
        2 * kernel_perf.attention_flops(8, 2048, 8, 128) / 5e-3 / 1e12)
    # end to end: the three kernels' work together
    work = [kernel_perf.forward_cost(8, 2048, 2048, 8, 8, 128, 0), *(
        kernel_perf.backward_costs(8, 2048, 2048, 8, 8, 128, 0).values())]
    assert rows[2]["bound_ms"] == pytest.approx(kernel_perf.bound(
        sum(f for f, _ in work), sum(n for _, n in work), peaks)[0])
    # the fwd+bwd row at 0.001 ms runs faster than its bound: a failure
    assert [line.split(":")[0] for line in
            kernel_perf.faster_than_bound(rows)] == ["flash fwd+bwd T2048"]
    unknown = _rows(None)
    md2 = kernel_perf.render_md(unknown, None, "Some GPU", "Some GPU, 300 W")
    assert "'Some GPU' is not in analysis/sol.py's PEAKS" in md2
    assert "| — | 2.1000 |" in md2 and "| — | — | — |" in md2
    assert kernel_perf.faster_than_bound(unknown) == []


def test_kernel_perf_sweep_rows():
    """The JAX tool's rows, the Llama-3-8B shape, and each backward kernel
    alone wherever the sweep times the fwd+bwd path end to end."""
    rows = {(r[0], r[2], r[4], r[7]) for r in kernel_perf.SWEEP}
    for t in (2048, 8192, 16384):
        assert {("flash fwd", t, 8, "fwd"), ("flash fwd", t, 2, "fwd"),
                ("flash fwd+bwd", t, 8, "fwd+bwd"),
                ("sofa_flash_bwd_kv", t, 8, "sofa_flash_bwd_kv"),
                ("sofa_flash_bwd_dq", t, 8, "sofa_flash_bwd_dq")} <= rows
    assert {r[7] for r in kernel_perf.SWEEP if r[0].startswith(
        "llama3_8b")} == set(kernel_perf.MODES)
    assert ("ring hop (non-causal)", 2, 4096, 8, 8, 128, False, "fwd") in \
        kernel_perf.SWEEP


def test_kernel_perf_refuses_without_a_card(capsys):
    assert kernel_perf.main(["--out", os.devnull]) == 1
    assert "requires a CUDA device" in capsys.readouterr().err
    assert tune_flash.main(["--seq", "64"]) == 1


def test_kernel_perf_default_out_is_the_ports_doc():
    assert kernel_perf.DEFAULT_OUT == os.path.join(
        _ROOT, "sofa_tpu_torch", "docs", "KERNEL_PERF.md")


# --- tune_flash --------------------------------------------------------------

def test_tune_flash_variant_command_and_hash():
    """A variant's -D define reaches nvcc, and its library's hash covers the
    define; the default library's hash stays that of the source and the
    headers alone."""
    kern = kernels.FLASH_FWD
    assert tune_flash.default_stages(kern) == 3
    assert tune_flash.default_stages(kernels.FLASH_BWD_KV) == 3
    assert tune_flash.default_stages(kernels.FLASH_BWD_DQ) == 4
    assert tune_flash.variant_defines(kern, 3) == ()
    defines = tune_flash.variant_defines(kern, 4)
    assert defines == (("FLASH_STAGES", 4),)
    cmd = kernels.nvcc_command("nvcc", kern, "/out.so", defines)
    assert cmd[cmd.index("-DFLASH_STAGES=4") + 1:] == ["-o", "/out.so",
                                                        kern.source]
    assert not any(a.startswith("-D") for a in
                   kernels.nvcc_command("nvcc", kern, "/out.so"))
    h = hashlib.sha256()
    for path in [kern.source] + sorted(glob.glob(os.path.join(
            os.path.dirname(kern.source), "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    default = kernels.library_path(kern)
    assert os.path.basename(default) == f"libflash_fwd-{h.hexdigest()[:12]}.so"
    paths = {kernels.library_path(kern, ((n, v),))
             for n, v in (("FLASH_STAGES", 2), ("FLASH_STAGES", 4),
                          ("OTHER", 4))}
    assert len(paths) == 3 and default not in paths
    assert kernels.library_path(kern, defines) == kernels.library_path(
        kern, (("FLASH_STAGES", 4),))


def test_tune_flash_sweeps_the_defaults_neighbours():
    def depths(bwd):
        return [(k.name, s) for k, s in tune_flash.variants(bwd)]

    assert depths(False) == [("sofa_flash_fwd", s) for s in (2, 3, 4)]
    assert depths(True) == [("sofa_flash_bwd_kv", s) for s in (2, 3, 4)] \
        + [("sofa_flash_bwd_dq", s) for s in (3, 4, 5)]
    builds = [(k.name, d) for k, d in tune_flash.all_variant_builds()]
    assert builds == [(n, (("FLASH_STAGES", s),)) for n, s in (
        ("sofa_flash_fwd", 2), ("sofa_flash_fwd", 4),
        ("sofa_flash_bwd_kv", 2), ("sofa_flash_bwd_kv", 4),
        ("sofa_flash_bwd_dq", 3), ("sofa_flash_bwd_dq", 5))]


def test_tune_flash_grad_limit_in_ulps():
    """GRAD_REL of the largest |reference| in float32; one bfloat16 ulp
    there besides in bfloat16 (8 significand bits: 2**-7 at [1, 2))."""
    assert tune_flash.bf16_ulp(1.0) == tune_flash.bf16_ulp(1.99) == 2 ** -7
    assert tune_flash.bf16_ulp(2.0) == 2 ** -6
    assert tune_flash.bf16_ulp(0.75) == 2 ** -8 and tune_flash.bf16_ulp(0) == 0
    assert tune_flash.grad_limit(3.0, False) == tune_flash.GRAD_REL * 3.0
    assert tune_flash.grad_limit(3.0, True) == tune_flash.GRAD_REL * 3.0 \
        + 2 ** -6
    # one ulp just above a power of two is more than GRAD_REL of it
    assert tune_flash.bf16_ulp(1.0) > tune_flash.GRAD_REL


@pytest.mark.parametrize("name,d,stages,smem,fits", [
    # the default builds: the bytes each source's comment records
    ("sofa_flash_fwd", 128, 3, 230480, True),
    ("sofa_flash_fwd", 64, 3, 115792, True),
    ("sofa_flash_bwd_kv", 128, 3, 167224, True),
    ("sofa_flash_bwd_kv", 64, 3, 85304, True),
    ("sofa_flash_bwd_dq", 128, 4, 198728, True),
    ("sofa_flash_bwd_dq", 64, 4, 100424, True),
    # the variants: the forward at D 128 has no room for a fourth stage
    ("sofa_flash_fwd", 128, 4, 296040, False),
    ("sofa_flash_fwd", 64, 4, 148584, True),
    ("sofa_flash_fwd", 128, 2, 164920, True),
    ("sofa_flash_bwd_kv", 128, 4, 200776, True),
    ("sofa_flash_bwd_kv", 128, 5, 234328, False),
    ("sofa_flash_bwd_dq", 128, 5, 231768, True),
    ("sofa_flash_bwd_dq", 128, 6, 264808, False),
    ("sofa_flash_bwd_dq", 64, 6, 133736, True),
])
def test_tune_flash_fits_arithmetic(name, d, stages, smem, fits):
    """Against the H100's opt-in shared memory a block, 227 KB (232,448
    bytes, as torch reports it on the card)."""
    kern = next(k for k in kernels.KERNELS if k.name == name)
    assert tune_flash.smem_model(kern, d, stages) == smem
    assert tune_flash.fits(smem, 232448) is fits


def test_tune_flash_model_matches_the_source_comments():
    """Each source's comment records its default build's bytes at D 128 /
    D 64, as ``<kernel>_smem_bytes`` printed them on the card (the Hopper
    kernels, the ones tune_flash sweeps)."""
    for kern in kernels.HOPPER:
        with open(kern.source) as f:
            text = " ".join(line.strip().lstrip("/").strip() for line in f)
        m = re.search(r"memory ([\d,]+) / ([\d,]+) bytes a block at D 128 "
                      r"/ D 64", text)
        d128, d64 = (int(x.replace(",", "")) for x in m.groups())
        stages = tune_flash.default_stages(kern)
        assert (tune_flash.smem_model(kern, 128, stages),
                tune_flash.smem_model(kern, 64, stages)) == (d128, d64)


def test_tune_flash_ranks_agreeing_variants():
    results = [
        {"seq": 2048, "kernel": "sofa_flash_fwd", "variant": "a", "ms": 0.3,
         "tflops": 1.0, "agrees": True},
        {"seq": 2048, "kernel": "sofa_flash_fwd", "variant": "b", "ms": 0.2,
         "tflops": 2.0, "agrees": False},
        {"seq": 2048, "kernel": "sofa_flash_fwd", "variant": "plain",
         "ms": 0.1, "tflops": 9.0},
        {"seq": 2048, "kernel": None, "variant": "sdpa", "ms": 0.05,
         "tflops": 9.0}]
    assert tune_flash.best_per_seq(results, [2048, 4096]) == [
        "  T=2048 sofa_flash_fwd: a 0.3000 ms (1.0 TF/s)",
        "  T=4096: every variant failed or did not fit"]


# --- bench_import ------------------------------------------------------------

def _bench_root(tmp_path):
    root = tmp_path / "repo"
    root.mkdir()
    (root / "BENCH_r01.json").write_text(json.dumps({
        "metric": "resnet50_profiling_overhead", "value": 1.25,
        "preprocess_wall_time_s": 2.5, "report_js_bytes": 1000,
        "flag": True, "captured_unix": 1700000000}))
    tail = "\n".join([
        "some log line",
        json.dumps({"metric": "resnet50_profiling_overhead", "value": 0.9,
                    "tile_build_wall_time_s": None}),
        "{not json",
        json.dumps({"metric": "resnet50_profiling_overhead",
                    "tile_build_wall_time_s": 0.4,
                    "resume_wall_time_s": 1.5, "value": None})])
    (root / "BENCH_r02.json").write_text(json.dumps(
        {"n": 2, "cmd": "python bench.py", "rc": 0, "tail": tail}))
    (root / "bench_last_good.json").write_text(json.dumps(
        {"metric": "resnet50_profiling_overhead", "value": 0.8,
         "cpu_smoke_overhead_pct": 12.5}))
    (root / "BENCH_r03.json").write_text("{torn")
    return str(root)


def _import(cmd, root, aroot):
    return subprocess.run(cmd + [root, "--archive_root", aroot],
                          capture_output=True, text=True, timeout=120,
                          cwd=_ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))


def test_bench_import_matches_jax(tmp_path):
    """The same files, a run wrapper's ``tail`` among them, imported by
    both tools into two roots: equal bench events; a second import of
    either appends nothing."""
    root = _bench_root(tmp_path)
    jroot, troot = str(tmp_path / "jarch"), str(tmp_path / "tarch")
    jcmd = [sys.executable, os.path.join(_ROOT, "tools", "bench_import.py")]
    tcmd = [sys.executable, "-m", "sofa_tpu_torch.tools.bench_import"]
    for cmd, aroot in ((jcmd, jroot), (tcmd, troot)):
        r = _import(cmd, root, aroot)
        assert r.returncode == 0, r.stderr
        assert "8 event(s) imported from 4 file(s)" in r.stdout
    ours = catalog.bench_entries(catalog.read_catalog(troot))
    theirs = jcatalog.bench_entries(jcatalog.read_catalog(jroot))
    assert ours == theirs and len(ours) == 8
    assert {(e["round"], e["metric"], e["value"]) for e in ours
            if e["round"] == "r02"} == {
        ("r02", "resnet50_profiling_overhead", 0.9),
        ("r02", "tile_build_wall_time_s", 0.4),
        ("r02", "resume_wall_time_s", 1.5)}
    with open(catalog.catalog_path(troot), "rb") as f:
        before = f.read()
    r = _import(tcmd, root, troot)
    assert r.returncode == 0 and "0 event(s) imported" in r.stdout
    with open(catalog.catalog_path(troot), "rb") as f:
        assert f.read() == before


def test_bench_import_unusable_root(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    from sofa_tpu_torch.tools import bench_import

    assert bench_import.main([str(tmp_path), "--archive_root",
                              str(blocker / "arch")]) == 2


# --- chaos_tier --------------------------------------------------------------

def test_chaos_tier_smoke_matches_jax():
    """Both tools' --smoke, one after the other: ok, the same document
    keys, the same five chaos events (the killed worker's pid aside), no
    problems."""
    docs = []
    for cmd in ([sys.executable, "tools/chaos_tier.py"],
                [sys.executable, "-m", "sofa_tpu_torch.tools.chaos_tier"]):
        r = subprocess.run(cmd + ["--smoke"], capture_output=True, text=True,
                           cwd=_ROOT, timeout=120,
                           env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert r.returncode == 0, (cmd, r.stdout[-1500:], r.stderr[-1500:])
        docs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    jdoc, tdoc = docs
    assert tdoc["ok"] and jdoc["ok"]
    assert tdoc["problems"] == [] == jdoc["problems"]
    assert tdoc.keys() == jdoc.keys()
    assert tdoc["metrics"].keys() == jdoc["metrics"].keys()

    def events(doc):
        return [re.sub(r"\(pid \d+\)", "(pid)", e) for e in doc["events"]]

    assert events(tdoc) == events(jdoc) and len(tdoc["events"]) == 5
    assert tdoc["pushes"] == jdoc["pushes"] > 0
