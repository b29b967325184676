"""sofa_tpu_torch on the card: the ``sofa_flash_fwd`` kernel and the fused
forward, held against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one (the kernel has
no CPU mode).  The file imports neither JAX nor the JAX package, so it runs
on a machine with PyTorch alone:

    SOFA_TPU_TEST_REAL=1 python -m pytest tests/test_torch_cuda.py -m cuda

(``SOFA_TPU_TEST_REAL`` keeps tests/conftest.py from importing JAX.)
Tolerances are chip_smoke.py's: out atol/rtol 1e-2 (bf16 storage, p rounded
against the running max), lse atol 1e-3 (float32 throughout).
"""

import dataclasses

import numpy as np
import pytest
import torch

from sofa_tpu_torch import kernels
from sofa_tpu_torch.workloads import flash_cuda as tfc
from sofa_tpu_torch.workloads import transformer as ttr


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
@pytest.mark.parametrize("b,t,h,kvh,d,tk,shift,segmented", [
    (2, 200, 8, 2, 128, None, 0, False),      # ragged T, GQA 4:1
    (1, 256, 4, 4, 64, None, 256, False),     # full attention
    (1, 128, 4, 2, 64, None, -128, False),    # nothing visible
    (2, 192, 4, 2, 64, None, 0, True),        # packed segments
    (1, 77, 4, 1, 128, 333, 256, False),      # a query block at a cache end
])
def test_kernel_matches_plain(cuda_device, b, t, h, kvh, d, tk, shift,
                              segmented):
    q, k, v = _inputs(cuda_device, t + d, b, t, h, kvh, d, tk)
    seg = None
    if segmented:
        seg = (torch.arange(t, device=cuda_device) // 50).expand(b, t)
    before = kernels.FLASH_FWD.launches
    out, lse = tfc._flash_forward(q, k, v, shift, segment_ids=seg)
    seg32 = None if seg is None else seg.to(torch.int32).contiguous()
    ref_out, ref_lse = tfc._flash_forward_plain(q, k, v, shift, seg32, seg32)
    assert kernels.FLASH_FWD.launches == before + 1
    torch.testing.assert_close(out.float(), ref_out.float(), atol=1e-2,
                               rtol=1e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


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
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        tfc.flash_causal_attention(q, k, v)


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
