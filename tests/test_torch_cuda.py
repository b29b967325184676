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
    q, k, v = _inputs(cuda_device, 1, 1, 64, 4, 2, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        tfc._flash_forward(q.float(), k.float(), v.float())
    q96, k96, v96 = _inputs(cuda_device, 2, 1, 64, 4, 2, 96)
    with pytest.raises(ValueError, match="head dims"):
        tfc._flash_forward(q96, k96, v96)
    with pytest.raises(ValueError, match="contiguous"):
        tfc._flash_forward(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v)
    out, lse = tfc._flash_forward(q, k, v)
    with pytest.raises(TypeError, match="bfloat16"):
        tfc._flash_backward(q, k, v, out.float(), out, lse)
    with pytest.raises(TypeError, match="grad_dtype"):
        tfc._flash_backward(q, k, v, out, out, lse, grad_dtype=torch.float16)
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
    for kern in kernels.KERNELS:
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
