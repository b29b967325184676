"""sofa_tpu_torch flash attention held against the JAX package's kernel.

The same numpy inputs go through the JAX ``_flash_forward`` in Pallas
interpret mode (small blocks, so every case spans several q/k blocks) and
through the port's ``_flash_forward``, which on CPU tensors runs the CUDA
kernel's plain PyTorch version.  Float32, with the reference's own forward
tolerances (atol 1e-5, rtol 1e-4: tests/test_workloads.py).  Rows that see
no key are compared by semantics (out 0, lse <= -1e29): the JAX kernel's
exact floor there depends on its block walk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofa_tpu.workloads import flash_pallas as jfp
from sofa_tpu.workloads import ring_attention as jra
from sofa_tpu_torch import kernels
from sofa_tpu_torch.workloads import flash_cuda as tfc
from sofa_tpu_torch.workloads import ring_attention as tra

ATOL, RTOL = 1e-5, 1e-4


def _inputs(seed, b, t, h, kvh, d, tk=None):
    rng = np.random.default_rng(seed)
    tk = t if tk is None else tk
    return (rng.standard_normal((b, t, h, d), dtype=np.float32),
            rng.standard_normal((b, tk, kvh, d), dtype=np.float32),
            rng.standard_normal((b, tk, kvh, d), dtype=np.float32))


def _segments(seed, b, t, n_cuts=3):
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, t), np.int32)
    for row in seg:
        for c in np.sort(rng.choice(np.arange(1, t), n_cuts, replace=False)):
            row[c:] += 1
    return seg


def _visible(t, tk, shift, seg_q=None, seg_k=None):
    """[B or 1, T] bool: rows that see at least one key."""
    keep = np.arange(tk)[None, :] <= np.arange(t)[:, None] + shift
    keep = keep[None]
    if seg_q is not None:
        keep = keep & (seg_q[:, :, None] == seg_k[:, None, :])
    return keep.any(-1)


CASES = [
    # id, (b, t, h, kvh, d, tk), shift, segmented
    ("causal_multiblock", (2, 64, 2, 2, 16, None), 0, False),
    ("full_shift_ge_T", (1, 64, 2, 2, 16, None), 64, False),
    ("masked_shift_le_minus_block", (1, 64, 2, 2, 16, None), -16, False),
    ("masked_shift_le_minus_T", (1, 32, 2, 2, 8, None), -32, False),
    ("gqa_group4", (2, 64, 8, 2, 16, None), 0, False),
    ("segmented_gqa", (2, 64, 4, 2, 16, None), 0, True),
    ("ring_hop_shift_tk", (1, 32, 4, 2, 16, 64), 32, False),
]


@pytest.mark.parametrize("seed,shape,shift,segmented",
                         [(i, *c[1:]) for i, c in enumerate(CASES)],
                         ids=[c[0] for c in CASES])
def test_flash_forward_matches_jax_interpret(seed, shape, shift, segmented):
    b, t, h, kvh, d, tk = shape
    tk = t if tk is None else tk
    q, k, v = _inputs(seed, b, t, h, kvh, d, tk)
    seg = _segments(7, b, t) if segmented else None
    with jax.default_matmul_precision("highest"):
        j_out, j_lse = jfp._flash_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), shift, 16, 16,
            True, segment_ids=None if seg is None else jnp.asarray(seg))
    t_out, t_lse = tfc._flash_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), shift,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    t_out, t_lse = t_out.numpy(), t_lse.numpy()
    j_out, j_lse = np.asarray(j_out), np.asarray(j_lse)
    np.testing.assert_allclose(t_out, j_out, atol=ATOL, rtol=RTOL)
    vis = np.broadcast_to(_visible(t, tk, shift, seg, seg)[:, None, :],
                          t_lse.shape)
    np.testing.assert_allclose(t_lse[vis], j_lse[vis], atol=ATOL, rtol=RTOL)
    assert (t_lse[~vis] <= -1e29).all() and (j_lse[~vis] <= -1e29).all()
    assert np.all(t_out.transpose(0, 2, 1, 3)[~vis] == 0)


def test_flash_attention_wrappers_match_jax():
    q, k, v = _inputs(11, 2, 64, 4, 2, 16)
    seg = _segments(12, 2, 64)
    tq, tk_, tv = (torch.from_numpy(x) for x in (q, k, v))
    rep_k, rep_v = (np.repeat(x, 2, axis=2) for x in (k, v))
    with jax.default_matmul_precision("highest"):
        causal = jfp.flash_attention(q, k, v, block_q=16, block_k=16,
                                     interpret=True)
        full = jfp.flash_attention(q, k, v, causal=False, block_q=16,
                                   block_k=16, interpret=True)
        plain = jra.plain_causal_attention(q, rep_k, rep_v)
        plain_seg = jra.plain_segmented_causal_attention(q, rep_k, rep_v, seg)
    np.testing.assert_allclose(tfc.flash_attention(tq, tk_, tv).numpy(),
                               np.asarray(causal), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        tfc.flash_attention(tq, tk_, tv, causal=False).numpy(),
        np.asarray(full), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tfc.flash_causal_attention(tq, tk_, tv).numpy(),
                               np.asarray(plain), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        tfc.flash_causal_segmented_attention(
            tq, tk_, tv, torch.from_numpy(seg)).numpy(),
        np.asarray(plain_seg), atol=ATOL, rtol=RTOL)


def test_plain_attention_oracles_match_jax():
    q, k, v = _inputs(13, 2, 32, 4, 4, 8)
    seg = _segments(14, 2, 32)
    with jax.default_matmul_precision("highest"):
        ref = jra.plain_causal_attention(q, k, v)
        ref_seg = jra.plain_segmented_causal_attention(q, k, v, seg)
    tq, tk_, tv = (torch.from_numpy(x) for x in (q, k, v))
    np.testing.assert_allclose(tra.plain_causal_attention(tq, tk_, tv).numpy(),
                               np.asarray(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        tra.plain_segmented_causal_attention(
            tq, tk_, tv, torch.from_numpy(seg)).numpy(),
        np.asarray(ref_seg), atol=ATOL, rtol=RTOL)
    assert tra.NEG_INF == jra.NEG_INF


def test_kv_head_mapping_matches_jax_kv_plane():
    b, h, kvh = 3, 8, 2
    for i in range(b * h):
        assert jfp._kv_plane(i, h, kvh) == (i // h) * kvh + tfc._kv_head(
            i % h, h, kvh)


def test_cpu_path_launches_no_kernel_and_validates_inputs():
    q, k, v = (torch.from_numpy(x) for x in _inputs(15, 1, 32, 4, 2, 8))
    before = kernels.counts()
    tfc.flash_causal_attention(q, k, v)
    assert kernels.counts() == before
    with pytest.raises(ValueError, match="static_causal"):
        tfc._flash_forward(q, k, v, 1, static_causal=True)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfc._flash_forward(q, k[:, :, :1].expand(-1, -1, 3, -1).contiguous(),
                           v[:, :, :1].expand(-1, -1, 3, -1).contiguous())
    with pytest.raises(ValueError, match="segment ids"):
        tfc._flash_forward(q, k, v, segment_ids=torch.zeros(1, 31))
    with pytest.raises(ValueError, match="kv_segment_ids"):
        tfc._flash_forward(q, k, v, kv_segment_ids=torch.zeros(1, 32))


def test_supports_names_the_kernel_head_dims():
    assert tfc.supports(2048, 128) and tfc.supports(200, 64)
    assert not tfc.supports(2048, 96) and not tfc.supports(0, 128)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build(kernels.FLASH_FWD)


def test_kernel_build_command_targets_sm90a():
    cmd = kernels.nvcc_command("nvcc", kernels.FLASH_FWD, "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and cmd[-1].endswith("csrc/flash_fwd.cu")
    assert kernels.library_path(kernels.FLASH_FWD).startswith(
        kernels.BUILD_DIR)
    assert kernels.FLASH_FWD.replaces.startswith(
        "sofa_tpu/workloads/flash_pallas.py:")
