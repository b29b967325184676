"""sofa_tpu_torch on the card: the three flash kernels, the fused forward
and the fused train step, held against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode).  The file imports neither JAX nor the JAX package, so it runs
on a machine with PyTorch alone:

    SOFA_TPU_TEST_REAL=1 python -m pytest tests/test_torch_cuda.py -m cuda

(``SOFA_TPU_TEST_REAL`` keeps tests/conftest.py from importing JAX.)
Tolerances are chip_smoke.py's: forward out atol/rtol 1e-2 (bf16 storage, p
rounded against the running max), lse atol 1e-3 (float32 throughout),
gradients against the largest reference magnitude (GRAD_REL there; the
worst reading at this file's shapes on an H100 was 1.8e-3).
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from sofa_tpu_torch import kernels
from sofa_tpu_torch.workloads import flash_cuda as tfc
from sofa_tpu_torch.workloads import transformer as ttr

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# Per-leaf gradients of the tiny bf16 config (d 256, 2 layers), fused vs
# plain attention, relative Frobenius error: the worst reading on an H100
# was 1.48e-2 (a tiny bf16 model rounds relatively more than the Llama-width
# one of chip_smoke.py).
TINY_GRAD_REL = 3e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sofa_flash_fwd kernel has no "
                    "CPU mode; chip_smoke.py runs it on the card)")
    return torch.device("cuda")


def _inputs(device, seed, b, t, h, kvh, d, tk=None):
    rng = np.random.default_rng(seed)
    tk = t if tk is None else tk
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .to(device, torch.bfloat16)
            for s in ((b, t, h, d), (b, tk, kvh, d), (b, tk, kvh, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,kvh,d,tk,shift,seg_len", [
    (2, 200, 8, 2, 128, None, 0, 0),      # ragged T, GQA 4:1
    (1, 256, 4, 4, 64, None, 256, 0),     # full attention
    (1, 128, 4, 2, 64, None, -128, 0),    # nothing visible
    (2, 192, 4, 2, 64, None, 0, 50),      # packed segments
    (1, 77, 4, 1, 128, 333, 256, 0),      # a query block at a cache end
    # the edges of the kernel's 128-row q-tiles and 128-key K/V tiles
    (2, 1, 8, 2, 128, None, 0, 0),        # one query row
    (2, 129, 8, 2, 128, None, 0, 0),      # one row past a q-tile
    (2, 64, 4, 2, 128, 1, 0, 0),          # one key
    (1, 300, 4, 2, 128, None, -1, 0),     # shift cuts every tile; row 0 blind
    (1, 300, 4, 2, 128, None, 37, 0),     # shift cuts a tile mid-way
    (2, 300, 4, 2, 128, None, 0, 100),    # segments inside and across tiles
    (2, 200, 8, 4, 64, None, 0, 0),       # D 64, ragged T
])
def test_kernel_matches_plain(cuda_device, b, t, h, kvh, d, tk, shift,
                              seg_len):
    q, k, v = _inputs(cuda_device, t + d, b, t, h, kvh, d, tk)
    seg = None
    if seg_len:
        seg = (torch.arange(t, device=cuda_device) // seg_len).expand(b, t)
    before = kernels.FLASH_FWD.launches
    out, lse = tfc._flash_forward(q, k, v, shift, segment_ids=seg)
    seg32 = None if seg is None else seg.to(torch.int32).contiguous()
    ref_out, ref_lse = tfc._flash_forward_plain(q, k, v, shift, seg32, seg32)
    assert kernels.FLASH_FWD.launches == before + 1
    torch.testing.assert_close(out.float(), ref_out.float(), atol=1e-2,
                               rtol=1e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda_device):
    """Two launches on the same inputs give bit-identical out and lse (no
    atomics, no split over keys): remat replays the forward and must
    reproduce it exactly."""
    q, k, v = _inputs(cuda_device, 7, 2, 384, 8, 2, 128)
    seg = (torch.arange(384, device=cuda_device) // 150).expand(2, 384)
    for segment_ids in (None, seg):
        first = tfc._flash_forward(q, k, v, 0, segment_ids=segment_ids)
        second = tfc._flash_forward(q, k, v, 0, segment_ids=segment_ids)
        assert torch.equal(first[0], second[0])
        assert torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(cuda_device):
    """What no kernel takes raises: another dtype, a head dim above 256,
    mixed dtypes, a strided tensor, a gradient dtype of neither kind."""
    q, k, v = _inputs(cuda_device, 1, 1, 64, 4, 2, 64)
    with pytest.raises(TypeError, match="float64"):
        tfc._flash_forward(q.double(), k.double(), v.double())
    q320, k320, v320 = _inputs(cuda_device, 2, 1, 64, 4, 2, 320)
    with pytest.raises(ValueError, match="320"):
        tfc._flash_forward(q320, k320, v320)
    with pytest.raises(TypeError, match="one dtype"):
        tfc._flash_forward(q, k.float(), v)
    with pytest.raises(ValueError, match="contiguous"):
        tfc._flash_forward(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v)
    out, lse = tfc._flash_forward(q, k, v)
    with pytest.raises(TypeError, match="one dtype"):
        tfc._flash_backward(q, k, v, out.float(), out, lse)
    with pytest.raises(TypeError, match="grad_dtype"):
        tfc._flash_backward(q, k, v, out, out, lse, grad_dtype=torch.float16)
    # a Hopper kernel refuses what the route sends elsewhere
    with pytest.raises(ValueError, match="does not take"):
        tfc._flash_forward_cuda(q.float(), k.float(), v.float(), 0,
                                static_causal=True, kern=kernels.FLASH_FWD)
    # a CUDA call that needs a gradient launches both backward kernels
    q.requires_grad_(True)
    before = kernels.counts()
    tfc.flash_causal_attention(q, k, v).float().sum().backward()
    after = kernels.counts()
    assert q.grad is not None and q.grad.dtype == torch.bfloat16
    for kern in (kernels.FLASH_BWD_KV, kernels.FLASH_BWD_DQ):
        assert after[kern.name] == before[kern.name] + 1


@pytest.mark.cuda
def test_fused_forward_matches_plain_forward(cuda_device):
    cfg = dataclasses.replace(ttr.TransformerConfig.tiny(seq=128),
                              d_model=256, n_heads=4, n_kv_heads=2)
    params = ttr.init_params(cfg, seed=0, device=cuda_device)
    tokens = torch.randint(0, cfg.vocab, (2, 128), device=cuda_device)
    assert ttr.use_flash(cfg, 128, cuda_device)
    before = kernels.FLASH_FWD.launches
    fused = ttr.forward(params, tokens, cfg)
    assert kernels.FLASH_FWD.launches == before + cfg.n_layers
    plain = ttr.forward(params, tokens, dataclasses.replace(cfg, flash=False))
    rel = ((fused - plain).norm() / plain.norm()).item()
    assert rel < 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,kvh,d,tk,shift,seg_len,f32,hop", [
    (2, 200, 8, 2, 128, None, 0, 0, False, False),     # ragged T, GQA 4:1
    (1, 256, 4, 4, 64, None, 256, 0, True, False),     # full, f32 grads
    (1, 128, 4, 2, 64, None, -128, 0, False, False),   # nothing visible
    (2, 192, 4, 2, 64, None, 0, 50, False, False),     # packed segments
    (1, 96, 4, 1, 128, 320, 224, 0, True, False),      # a ring hop, Tk != T
    # the edges of the backward tiling: 128-key dK/dV blocks of two 64-key
    # warpgroups over 64-query tiles, 128-row dQ blocks over 64-key tiles
    (2, 1, 8, 2, 128, None, 0, 0, False, True),        # one query row
    (2, 129, 8, 2, 128, None, 0, 0, False, False),     # a row past a tile
    (2, 129, 8, 4, 64, None, 0, 0, False, False),      # the same at D 64
    (2, 200, 8, 4, 64, None, 0, 0, False, False),      # D 64, ragged T
    (2, 64, 4, 2, 128, 1, 0, 0, False, True),          # one key
    (1, 300, 4, 2, 128, None, -1, 0, False, False),    # shift cuts tiles
    (1, 300, 4, 2, 128, None, 37, 0, False, False),    # ... mid-way
    (1, 300, 8, 8, 128, None, 0, 0, False, False),     # GQA group 1
    (1, 300, 16, 2, 64, None, 0, 0, False, False),     # GQA group 8
    (2, 300, 4, 2, 128, None, 0, 100, False, False),   # segments off edges
])
def test_backward_kernels_match_plain(cuda_device, b, t, h, kvh, d, tk,
                                      shift, seg_len, f32, hop):
    """hop: delta from another output, as in a ring hop (chip_smoke.py's
    ``inputs``).  With its own delta a row that sees one key has p = 1 and
    dp = delta up to rounding, so its dq and dk are rounding noise."""
    q, k, v = _inputs(cuda_device, t + d + 1, b, t, h, kvh, d, tk)
    g = _inputs(cuda_device, t + d + 2, b, t, h, kvh, d)[0]
    seg = None
    if seg_len:
        seg = (torch.arange(t, device=cuda_device) // seg_len).expand(b, t)
    static = shift <= 0
    out, lse = tfc._flash_forward(q, k, v, shift, static, seg)
    other = _inputs(cuda_device, t + d + 3, b, t, h, kvh, d)[0] if hop else out
    delta = (g.float() * other.float()).sum(-1).transpose(1, 2).contiguous()
    before = kernels.counts()
    grads = tfc._flash_backward(q, k, v, g, out, lse, shift, static,
                                delta=delta if hop else None,
                                grad_dtype=torch.float32 if f32 else None,
                                segment_ids=seg)
    after = kernels.counts()
    seg32 = None if seg is None else seg.to(torch.int32).contiguous()
    ref = tfc._flash_backward_plain(q, k, v, g, lse, delta, shift, seg32,
                                    seg32, torch.float32 if f32 else None)
    for kern in (kernels.FLASH_BWD_KV, kernels.FLASH_BWD_DQ):
        assert after[kern.name] == before[kern.name] + 1
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert bool(torch.isfinite(a.float()).all()), name
        scale = r.float().abs().max().item()
        if scale == 0:
            assert a.float().abs().max().item() == 0, name
            continue
        err = (a.float() - r.float()).abs().max().item() / scale
        assert err <= chip_smoke.GRAD_REL, (name, err)


@pytest.mark.cuda
def test_backward_kernels_are_deterministic(cuda_device):
    """Two launches of each backward kernel on the same inputs give
    bit-identical dq, dk and dv (no atomics, no split of a sum across
    blocks): remat replays the backward and must reproduce it exactly."""
    q, k, v = _inputs(cuda_device, 8, 2, 384, 8, 2, 128)
    g = _inputs(cuda_device, 9, 2, 384, 8, 2, 128)[0]
    seg = (torch.arange(384, device=cuda_device) // 150).expand(2, 384)
    for segment_ids in (None, seg):
        out, lse = tfc._flash_forward(q, k, v, 0, True, segment_ids)
        first = tfc._flash_backward(q, k, v, g, out, lse,
                                    segment_ids=segment_ids)
        second = tfc._flash_backward(q, k, v, g, out, lse,
                                     segment_ids=segment_ids)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_train_step_launches_every_kernel(cuda_device):
    cfg = dataclasses.replace(ttr.TransformerConfig.tiny(seq=128),
                              d_model=256, n_heads=4, n_kv_heads=2)
    params, opt, step, tokens = ttr.build(cfg, 2, 128, device=cuda_device)
    before = kernels.counts()
    losses = []
    for _ in range(3):
        params, opt, loss = step(params, opt, tokens)
        losses.append(loss.item())
    after = kernels.counts()
    for kern in kernels.HOPPER:
        assert after[kern.name] == before[kern.name] + 3 * cfg.n_layers
    assert losses[-1] < losses[0]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_fused_grads_match_plain_grads(cuda_device, packed):
    cfg = dataclasses.replace(ttr.TransformerConfig.tiny(seq=128),
                              d_model=256, n_heads=4, n_kv_heads=2)
    params = ttr.init_params(cfg, seed=0, device=cuda_device)
    leaves = [p.requires_grad_(True) for p in ttr.param_leaves(params)]
    torch.manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (2, 128), device=cuda_device)
    seg = None
    if packed:
        seg = (torch.arange(128, device=cuda_device) // 40).expand(2, 128)
    fused = torch.autograd.grad(ttr.loss_fn(params, tokens, cfg, seg), leaves)
    plain = torch.autograd.grad(
        ttr.loss_fn(params, tokens, dataclasses.replace(cfg, flash=False),
                    seg), leaves)
    for a, b in zip(fused, plain):
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        assert rel < TINY_GRAD_REL


@pytest.mark.cuda
def test_gpumon_sampler_reads_a_tensor_of_known_size(cuda_device, tmp_path):
    import threading
    import time

    from sofa_tpu_torch.collectors import gpumon

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    held = torch.empty(64 * 2**20, dtype=torch.uint8, device=cuda_device)
    out = tmp_path / "gpumon.txt"
    stop = threading.Event()
    t = gpumon.start_sampler(20.0, str(out), stop)
    deadline = time.time() + 10
    while time.time() < deadline and (
            not out.exists() or " 0 " not in out.read_text()):
        time.sleep(0.05)
    stop.set()
    t.join(2.0)
    rows = [[int(x) for x in ln.split()] for ln in out.read_text().splitlines()
            if ln.split()[1] == str(cuda_device.index or 0)]
    assert rows
    total = torch.cuda.get_device_properties(cuda_device).total_memory
    for _, _, used, limit, peak in rows:
        assert used == base + held.numel()
        assert limit == total and used <= peak < total
    del held


@pytest.mark.cuda
def test_memprof_snapshot_names_the_allocating_line(cuda_device, tmp_path):
    import inspect

    from sofa_tpu_torch.collectors import gpumon
    from sofa_tpu_torch.ingest.memprof import parse_memprof

    entry_points = torch.autograd.backward, torch.autograd.grad
    gpumon._ns["arm_history"](torch)      # CUDA is up: records from now on
    try:
        line = inspect.currentframe().f_lineno + 1
        held = torch.empty(48 * 2**20, dtype=torch.uint8, device=cuda_device)
        path = str(tmp_path / "memprof.pb.gz")
        assert gpumon.snapshot_memprof(torch, path, "peak", held.numel())
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
        torch.autograd.backward, torch.autograd.grad = entry_points
    df = parse_memprof(path)
    mine = df[df["site"].str.contains(f"test_torch_cuda.py:{line})",
                                      regex=False)]
    assert len(mine) == 1
    assert mine["bytes"].iloc[0] == held.numel()
    assert mine["site"].iloc[0].startswith(
        "test_memprof_snapshot_names_the_allocating_line (")
    assert mine["device"].iloc[0] == f"cuda:{cuda_device.index or 0}"
    del held


@pytest.mark.cuda
def test_memprof_names_the_backward_line_for_engine_blocks(cuda_device,
                                                           tmp_path):
    """The gradient the autograd engine allocates on its device thread (no
    Python frames there) resolves to the line that called backward."""
    import inspect

    from sofa_tpu_torch.collectors import gpumon
    from sofa_tpu_torch.ingest.memprof import parse_memprof

    entry_points = torch.autograd.backward, torch.autograd.grad
    gpumon._ns["arm_history"](torch)
    try:
        w = torch.ones(16 * 2**20, device=cuda_device, requires_grad=True)
        loss = (w * 3).sum()
        line = inspect.currentframe().f_lineno + 1
        loss.backward()
        path = str(tmp_path / "memprof.pb.gz")
        assert gpumon.snapshot_memprof(torch, path, "peak", 0)
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
        torch.autograd.backward, torch.autograd.grad = entry_points
    df = parse_memprof(path)
    grad = df[df["stack"].str.startswith("(autograd engine);")
              & (df["bytes"] == w.grad.numel() * 4)]
    assert len(grad) == 1
    assert grad["site"].iloc[0].endswith(f"test_torch_cuda.py:{line})")
    del w, loss


@pytest.mark.cuda
def test_injection_never_initializes_cuda(cuda_device, tmp_path):
    """A torch program that never touches the card stays uninitialized
    under the injection (Kineto, gpumon, memprof, pystacks all on): it
    prints False, the samplers write nothing, and the topology written
    after the profiler's stop lists no initialized device."""
    import json
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    logdir = tmp_path / "log"
    cmd = (f"{sys.executable} -c 'import torch; "
           "print(\"initialized\", torch.cuda.is_initialized())'")
    r = subprocess.run([sys.executable, "-m", "sofa_tpu_torch", "record",
                        "--logdir", str(logdir), "--enable_py_stacks", cmd],
                       capture_output=True, text=True, timeout=300, cwd=repo,
                       env=dict(os.environ, PYTHONPATH=repo))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "initialized False" in r.stdout
    assert not (logdir / "gpumon.txt").exists()
    assert not (logdir / "memprof.pb.gz").exists()
    with open(logdir / "gpu_topo.json") as f:
        topo = json.load(f)
    assert topo["cuda_available"] and topo["devices"] == []


@pytest.mark.cuda
@pytest.mark.parametrize("step", [-1, 1])
@pytest.mark.parametrize("name", [k.name for k in kernels.HOPPER])
def test_stages_variant_matches_plain(cuda_device, name, step):
    """The ring-depth variants beside each kernel's default FLASH_STAGES (as
    ``tools/tune_flash.py`` builds them: a library of their own) against
    the plain version at both head dims where they fit, over more K/V (or
    Q/dO) tiles than stages, at ``tune_flash``'s tolerances: a backward
    kernel in both output modes.  A variant's launch is not counted."""
    from sofa_tpu_torch.tools import tune_flash as tf

    kern = next(k for k in kernels.HOPPER if k.name == name)
    stages = tf.default_stages(kern) + step
    defines = tf.variant_defines(kern, stages)
    assert defines and kernels.library_path(kern, defines) != \
        kernels.library_path(kern)
    optin = torch.cuda.get_device_properties(
        cuda_device).shared_memory_per_block_optin
    held = 0
    for d in (64, 128):
        smem = kernels.smem_bytes(kern, d, defines)
        assert smem == tf.smem_model(kern, d, stages)
        if not tf.fits(smem, optin):
            continue
        held += 1
        q, k, v = _inputs(cuda_device, 60 + d, 2, 600, 8, 2, d)
        g = _inputs(cuda_device, 61 + d, 2, 600, 8, 2, d)[0]
        out, lse = tfc._flash_forward(q, k, v, 0, True)
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        args = (q, k, v, g, lse, delta, 0, None, None)
        before = kernels.counts()
        if kern is kernels.FLASH_FWD:
            got = tfc._flash_forward_cuda(q, k, v, 0, static_causal=True,
                                          defines=defines)
            ref = tfc._flash_forward_plain(q, k, v, 0)
            torch.testing.assert_close(got[0].float(), ref[0].float(),
                                       atol=tf.OUT_ATOL, rtol=tf.OUT_RTOL)
            torch.testing.assert_close(got[1], ref[1], atol=tf.LSE_ATOL,
                                       rtol=0)
            assert kernels.counts() == before
            continue
        for gd in (torch.float32, None):
            if kern is kernels.FLASH_BWD_KV:
                got = tfc._flash_bwd_kv_cuda(*args, gd, static_causal=True,
                                             defines=defines)
                ref = tfc._flash_bwd_kv_plain(*args, gd)
            else:
                got = (tfc._flash_bwd_dq_cuda(*args, gd, static_causal=True,
                                              defines=defines),)
                ref = (tfc._flash_bwd_dq_plain(*args, gd),)
            for a, r in zip(got, ref):
                assert a.dtype == (gd or torch.bfloat16)
                err = (a.float() - r.float()).abs().max().item()
                assert err <= tf.grad_limit(r.float().abs().max().item(),
                                            gd is None), (d, gd, err)
        assert kernels.counts() == before
    assert held


# --- the general kernels (every other dtype and head dim up to 256) ---------

_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


def _typed(device, seed, dtype, b, t, h, kvh, d, tk=None):
    return [x.to(dtype) for x in _inputs(device, seed, b, t, h, kvh, d, tk)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("b,t,h,kvh,d,tk,shift,seg_len", [
    (2, 130, 4, 2, 16, None, 0, 0),       # ragged T over 64-row tiles
    (1, 77, 8, 2, 8, 200, 150, 0),        # a cache end, D 8 under cap 16
    (1, 64, 4, 4, 80, None, -64, 0),      # nothing visible, D 80 of 128
    (2, 100, 8, 2, 256, None, 0, 30),     # segments, GQA 4, D 256
    (1, 1, 4, 1, 32, 1, 0, 0),            # one query, one key
    (1, 90, 4, 2, 128, None, 37, 0),      # shift cuts a tile; bf16 here
    (2, 150, 4, 2, 7, None, 0, 0),        # D 7: rows TMA cannot describe
    (1, 140, 8, 4, 100, None, 0, 45),     # D 100 of 128, segments, GQA 2
    (1, 64, 4, 2, 256, None, 0, 0),       # a 128-row block's second
                                          # warpgroup wholly past T
    (2, 129, 8, 2, 128, 300, 171, 0),     # Tk > T, a shift, and a second
                                          # block of one row
])                                        # runs the general kernel too
def test_general_kernels_match_plain(cuda_device, dtype, b, t, h, kvh, d, tk,
                                     shift, seg_len):
    """Each general kernel against its plain version (forward, and the
    backward pair in both output modes), launched by record so that bf16
    at D 128 runs it as well; each launch counted on its own record.  D 7
    and D 100 take the threads' own loads in bf16 and f16 (rows not a
    multiple of 16 bytes)."""
    dt = _DTYPES[dtype]
    q, k, v = _typed(cuda_device, t + d, dt, b, t, h, kvh, d, tk)
    g = _typed(cuda_device, t + d + 1, dt, b, t, h, kvh, d)[0]
    seg32 = None
    if seg_len:
        seg32 = (torch.arange(t, device=cuda_device) // seg_len).expand(
            b, t).to(torch.int32).contiguous()
    _hold_general(q, k, v, g, shift, seg32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f16"])
@pytest.mark.parametrize("d", [128, 16, 256])
def test_general_kernels_take_unaligned_views(cuda_device, dtype, d):
    """q, k, v and dO as contiguous views starting 2 bytes past a 16-byte
    boundary, which TMA cannot describe: the tensor-core kernels load them
    thread by thread and agree with the plain versions."""
    dt = _DTYPES[dtype]
    q, k, v = _typed(cuda_device, 11 + d, dt, 2, 150, 8, 2, d)
    g = _typed(cuda_device, 12 + d, dt, 2, 150, 8, 2, d)[0]
    views = [_unaligned(x) for x in (q, k, v, g)]
    for x, y in zip(views, (q, k, v, g)):
        assert x.is_contiguous() and x.data_ptr() % 16 == 2
        assert torch.equal(x, y)
    _hold_general(*views, 0, None)


def _unaligned(x):
    """A contiguous copy of ``x`` whose first element sits 2 bytes past a
    16-byte boundary (a 2-byte dtype)."""
    flat = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    start = ((2 - flat.data_ptr() % 16) // x.element_size()) % 8
    view = flat[start:start + x.numel()].view(x.shape)
    view.copy_(x)
    return view


def _hold_general(q, k, v, g, shift, seg32):
    """The three general kernels on one case against their plain versions
    (the forward, and the backward pair in both output modes), launched by
    record; each launch counted on its own record and no Hopper kernel's."""
    from sofa_tpu_torch.tools import tune_flash as tf

    dt = q.dtype
    before = kernels.counts()
    out, lse = tfc._flash_forward_cuda(q, k, v, shift, seg32, seg32,
                                       static_causal=shift <= 0,
                                       kern=kernels.GEN_FWD)
    ref_out, ref_lse = tfc._flash_forward_plain(q, k, v, shift, seg32, seg32)
    assert out.dtype == dt
    torch.testing.assert_close(out.float(), ref_out.float(),
                               atol=tf.OUT_ATOL, rtol=tf.OUT_RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=tf.LSE_ATOL, rtol=0)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, g, lse, delta, shift, seg32, seg32)
    for gd in (torch.float32, None):
        got = (*tfc._flash_bwd_kv_cuda(*args, gd, static_causal=shift <= 0,
                                       kern=kernels.GEN_BWD_KV),
               tfc._flash_bwd_dq_cuda(*args, gd, static_causal=shift <= 0,
                                      kern=kernels.GEN_BWD_DQ))
        ref = (*tfc._flash_bwd_kv_plain(*args, gd),
               tfc._flash_bwd_dq_plain(*args, gd))
        for name, a, r in zip(("dk", "dv", "dq"), got, ref):
            assert a.dtype == (gd or dt), name
            assert bool(torch.isfinite(a.float()).all()), name
            scale = r.float().abs().max().item()
            err = (a.float() - r.float()).abs().max().item()
            assert err <= tf.grad_limit(
                scale, gd is None and dt == torch.bfloat16), (name, gd, err)
    after = kernels.counts()
    assert after[kernels.GEN_FWD.name] == before[kernels.GEN_FWD.name] + 1
    for kern in (kernels.GEN_BWD_KV, kernels.GEN_BWD_DQ):
        assert after[kern.name] == before[kern.name] + 2
    for kern in kernels.HOPPER:
        assert after[kern.name] == before[kern.name]


@pytest.mark.cuda
def test_general_kernels_are_deterministic(cuda_device):
    """No atomics and no split of a sum across blocks: two launches agree
    bit for bit (float32, GQA 4, D 80)."""
    q, k, v = _typed(cuda_device, 5, torch.float32, 2, 200, 8, 2, 80)
    g = _typed(cuda_device, 6, torch.float32, 2, 200, 8, 2, 80)[0]
    first = tfc._flash_forward(q, k, v, 0)
    second = tfc._flash_forward(q, k, v, 0)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    grads = [tfc._flash_backward(q, k, v, g, *first) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.cuda
def test_float32_and_d16_models_take_the_general_kernels(cuda_device):
    """The auto rule sends a float32 model and tiny's head dim 16 to the
    general kernels on the card (a float32 model crashed before): each
    train step launches the three of them once a layer, and no Hopper
    kernel; the loss descends."""
    for cfg in (dataclasses.replace(ttr.TransformerConfig.tiny(seq=128),
                                    d_model=256, dtype=torch.float32),
                ttr.TransformerConfig.tiny(seq=128)):
        assert ttr.use_flash(cfg, 128, cuda_device)
        params, opt, step, tokens = ttr.build(cfg, 2, 128,
                                              device=cuda_device)
        before = kernels.counts()
        losses = []
        for _ in range(3):
            params, opt, loss = step(params, opt, tokens)
            losses.append(loss.item())
        after = kernels.counts()
        for kern in kernels.GENERAL:
            assert after[kern.name] == before[kern.name] + 3 * cfg.n_layers
        for kern in kernels.HOPPER:
            assert after[kern.name] == before[kern.name]
        assert losses[-1] < losses[0]
