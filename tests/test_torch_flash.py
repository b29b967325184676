"""sofa_tpu_torch flash attention held against the JAX package's kernels.

The same numpy inputs go through the JAX ``_flash_forward`` and
``_flash_backward`` in Pallas interpret mode (small blocks, so every case
spans several q/k blocks) and through the port's counterparts, which on CPU
tensors run the CUDA kernels' plain PyTorch versions.  Float32, with the
reference's own tolerances (tests/test_workloads.py): forward atol 1e-5 /
rtol 1e-4, gradients atol 1e-4 / rtol 1e-3.  Rows that see no key are
compared by semantics (out 0, lse <= -1e29, zero gradient): the JAX
kernel's exact lse floor there depends on its block walk.
"""

import os

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
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3


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


def _keep(t, tk, shift, seg_q=None, seg_k=None):
    """[B or 1, T, Tk] bool: the (query, key) pairs the mask lets through."""
    keep = np.arange(tk)[None, :] <= np.arange(t)[:, None] + shift
    keep = keep[None]
    if seg_q is not None:
        keep = keep & (seg_q[:, :, None] == seg_k[:, None, :])
    return keep


def _visible(t, tk, shift, seg_q=None, seg_k=None):
    """[B or 1, T] bool: rows that see at least one key."""
    return _keep(t, tk, shift, seg_q, seg_k).any(-1)


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


BACKWARD_CASES = [(c[0], *c[1:], None, False) for c in CASES] + [
    # explicit delta (not derived from out) and float32 grad_dtype
    ("explicit_delta_f32_grads", (2, 64, 4, 2, 16, None), 0, False,
     "explicit", True),
]


@pytest.mark.parametrize("seed,shape,shift,segmented,delta,f32_grads",
                         [(i, *c[1:]) for i, c in enumerate(BACKWARD_CASES)],
                         ids=[c[0] for c in BACKWARD_CASES])
def test_flash_backward_matches_jax_interpret(seed, shape, shift, segmented,
                                              delta, f32_grads):
    b, t, h, kvh, d, tk = shape
    tk = t if tk is None else tk
    q, k, v = _inputs(seed, b, t, h, kvh, d, tk)
    g = np.random.default_rng(100 + seed).standard_normal(q.shape,
                                                          dtype=np.float32)
    seg = _segments(7, b, t) if segmented else None
    jseg = None if seg is None else jnp.asarray(seg)
    static = shift <= 0
    if delta == "explicit":
        delta = np.random.default_rng(200 + seed).standard_normal(
            (b, h, t), dtype=np.float32)
    with jax.default_matmul_precision("highest"):
        # one forward's out and lse feed both backwards
        out, lse = jfp._flash_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), shift, 16, 16,
            True, static_causal=static, segment_ids=jseg)
        ref = jfp._flash_backward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(g),
            out, lse, shift, static_causal=static,
            delta=None if delta is None else jnp.asarray(delta),
            grad_dtype=jnp.float32 if f32_grads else None, block_q=16,
            block_k=16, interpret=True, segment_ids=jseg)
    got = tfc._flash_backward(
        *(torch.from_numpy(x) for x in (q, k, v, g)),
        torch.from_numpy(np.array(out)), torch.from_numpy(np.array(lse)),
        shift, static_causal=static,
        delta=None if delta is None else torch.from_numpy(delta),
        grad_dtype=torch.float32 if f32_grads else None,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.float32 and tuple(a.shape) == r.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
    # rows that see no key, and keys no row sees, get exactly zero gradient
    vis = _visible(t, tk, shift, seg, seg)                   # [B or 1, T]
    dq = np.broadcast_to(got[0].numpy(), (b, t, h, d))
    assert np.all(dq[np.broadcast_to(~vis, (b, t))] == 0)
    seen = _keep(t, tk, shift, seg, seg).any(-2)             # keys seen
    for grad in got[1:]:
        assert np.all(np.broadcast_to(grad.numpy(), (b, tk, kvh, d))[
            np.broadcast_to(~seen, (b, tk))] == 0)


@pytest.mark.parametrize("segmented", [False, True],
                         ids=["causal", "segmented"])
def test_flash_wrapper_grads_match_jax_grad(segmented):
    q, k, v = _inputs(21, 2, 64, 4, 2, 16)
    w = np.random.default_rng(22).standard_normal(q.shape, dtype=np.float32)
    seg = _segments(23, 2, 64)

    def jloss(q, k, v):
        out = (jfp.flash_causal_segmented_attention(q, k, v, jnp.asarray(seg))
               if segmented else jfp.flash_causal_attention(q, k, v))
        return (out * w).sum()

    with jax.default_matmul_precision("highest"):
        ref = jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk_, tv = (torch.from_numpy(x).requires_grad_(True)
                   for x in (q, k, v))
    out = (tfc.flash_causal_segmented_attention(tq, tk_, tv,
                                                torch.from_numpy(seg))
           if segmented else tfc.flash_causal_attention(tq, tk_, tv))
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tq, tk_, tv))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)


def test_plain_backward_rounds_where_the_kernels_round():
    """In bfloat16 the plain versions round p and ds to bf16 before their
    products, as the kernels do: dv is the bf16 p times dO, exactly."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(31, 1, 32, 2, 2, 16))
    g = torch.from_numpy(np.random.default_rng(32).standard_normal(
        (1, 32, 2, 16), dtype=np.float32)).to(torch.bfloat16)
    out, lse = tfc._flash_forward(q, k, v, 0)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2)
    p, ds = tfc._bwd_ds(q, k, v, g, lse, delta, 0, None, None)
    assert torch.equal(ds, ds.to(torch.bfloat16).float())
    dk, dv = tfc._flash_bwd_kv_plain(q, k, v, g, lse, delta, 0,
                                     grad_dtype=torch.float32)
    want = torch.einsum("bhqk,bqhd->bkhd", p.to(torch.bfloat16).float(),
                        g.float())
    torch.testing.assert_close(dv, want, atol=0, rtol=0)
    assert dk.dtype == dv.dtype == torch.float32
    dq, dk16, _ = tfc._flash_backward(q, k, v, g, out, lse)
    assert dq.dtype == dk16.dtype == torch.bfloat16


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
    out, lse = tfc._flash_forward(q, k, v)
    with pytest.raises(ValueError, match="cotangent"):
        tfc._flash_backward(q, k, v, out[:, :16], out, lse)
    with pytest.raises(ValueError, match="static_causal"):
        tfc._flash_backward(q, k, v, out, out, lse, shift=1)
    qg = q.clone().requires_grad_(True)
    tfc.flash_causal_attention(qg, k, v).sum().backward()
    assert qg.grad is not None and kernels.counts() == before


def test_supports_names_the_kernel_head_dims():
    assert tfc.supports(2048, 128) and tfc.supports(200, 64)
    assert not tfc.supports(2048, 96) and not tfc.supports(0, 128)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build(kernels.FLASH_FWD)


@pytest.mark.parametrize("kern", kernels.KERNELS, ids=lambda k: k.name)
def test_kernel_build_command_targets_sm90a(kern):
    cmd = kernels.nvcc_command("nvcc", kern, "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and cmd[-1].endswith(f"csrc/{kern.lib}.cu")
    assert os.path.exists(kern.source)
    assert kernels.library_path(kern).startswith(kernels.BUILD_DIR)
    assert kern.replaces.startswith("sofa_tpu/workloads/flash_pallas.py:")


def test_kernel_records_name_their_pallas_calls():
    """Each record's ``replaces`` line holds the pallas_call whose name= is
    the kernel's name, and each library is one kernel's own."""
    with open(os.path.join(kernels.REPO, "sofa_tpu/workloads/"
                           "flash_pallas.py")) as f:
        lines = f.read().splitlines()
    for kern in kernels.KERNELS:
        line = int(kern.replaces.rsplit(":", 1)[1])
        assert "pl.pallas_call(" in lines[line - 1], kern.name
        call = "\n".join(lines[line - 1:line + 40])
        assert f'name="{kern.name}"' in call.split("interpret=")[0]
    assert len({k.lib for k in kernels.KERNELS}) == len(kernels.KERNELS)


def test_library_binds_every_entry_point_it_holds(monkeypatch):
    """Loading one library sets the signature of each registered entry
    point in it, so a second one is never called with default ctypes."""

    class Entry:
        argtypes = restype = None

    class Lib:
        def __init__(self):
            self.sofa_cuda_error_string = Entry()
            self.first, self.second = Entry(), Entry()
            self.first_smem_bytes, self.second_smem_bytes = Entry(), Entry()

    a = kernels.Kernel("first", "shared", "x:1", [kernels._P])
    b = kernels.Kernel("second", "shared", "x:2", [kernels._I])
    monkeypatch.setattr(kernels, "KERNELS", [a, b])
    lib = Lib()
    kernels._bind("shared", lib)
    assert lib.first.argtypes == [kernels._P]
    assert lib.second.argtypes == [kernels._I]
    assert lib.first.restype is lib.second.restype is kernels._I
    for smem in (lib.first_smem_bytes, lib.second_smem_bytes):
        assert smem.argtypes == [kernels._I] and smem.restype is kernels._I
