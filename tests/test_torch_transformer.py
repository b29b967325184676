"""sofa_tpu_torch's decoder held against the JAX package's, on one init.

The tiny float32 config's JAX params cross over as numpy arrays
(``convert.params_from_numpy``) and both packages compute logits from the
same tokens.  JAX runs at highest matmul precision, with its flash path in
Pallas interpret mode.  Tolerance atol/rtol 1e-4: two float32 layers of
matmuls, norms and rope, summed in different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofa_tpu.workloads import transformer as jtr
from sofa_tpu_torch import convert
from sofa_tpu_torch import entry as tentry
from sofa_tpu_torch.workloads import transformer as ttr

ATOL = RTOL = 1e-4


def _configs(seq=64, **kw):
    jcfg = dataclasses.replace(jtr.TransformerConfig.tiny(seq=seq),
                               dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(ttr.TransformerConfig.tiny(seq=seq),
                               dtype=torch.float32, **kw)
    return jcfg, tcfg


def _params(jcfg, seed=0):
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp))


def _tokens(seed, b, t, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, t),
                                                dtype=np.int32)


def _packed_segments(b, t):
    seg = np.zeros((b, t), np.int32)
    seg[:, t // 3:] = 1
    seg[:, 2 * t // 3:] = 2
    seg[1, t // 2:] += 5                 # a second row with other cuts
    return seg


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_forward_matches_jax(flash, packed):
    jcfg, tcfg = _configs(flash=flash)
    jp, tp = _params(jcfg)
    tokens = _tokens(1, 2, 64, jcfg.vocab)
    seg = _packed_segments(2, 64) if packed else None
    with jax.default_matmul_precision("highest"):
        ref = jtr.forward(jp, jnp.asarray(tokens), jcfg,
                          segment_ids=None if seg is None else jnp.asarray(seg))
    got = ttr.forward(tp, torch.from_numpy(tokens).long(), tcfg,
                      segment_ids=None if seg is None else torch.from_numpy(seg))
    assert got.dtype == torch.float32 and got.shape == (2, 64, jcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_flash_and_plain_paths_agree_and_auto_stays_plain_on_cpu():
    _, tcfg = _configs()
    _, tp = _params(_configs()[0])
    tokens = torch.from_numpy(_tokens(2, 2, 64, tcfg.vocab)).long()
    fused = ttr.forward(tp, tokens, dataclasses.replace(tcfg, flash=True))
    plain = ttr.forward(tp, tokens, dataclasses.replace(tcfg, flash=False))
    torch.testing.assert_close(fused, plain, atol=ATOL, rtol=RTOL)
    assert not ttr.use_flash(tcfg, 64, torch.device("cpu"))
    assert ttr.use_flash(dataclasses.replace(tcfg, flash=True), 64,
                         torch.device("cpu"))


def test_rope_and_rmsnorm_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 4, 8), dtype=np.float32)
    pos = np.stack([np.arange(16), np.arange(16)[::-1]]).astype(np.int32)
    w = rng.standard_normal((8,), dtype=np.float32)
    with jax.default_matmul_precision("highest"):
        jr = jtr._rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
        jn = jtr._rmsnorm(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(
        ttr._rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0),
        np.asarray(jr), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(
        ttr._rmsnorm(torch.from_numpy(x), torch.from_numpy(w)),
        np.asarray(jn), atol=1e-6, rtol=1e-5)


def test_configs_and_param_layout_match_jax():
    for name in ("llama3_8b", "tiny"):
        j, t = getattr(jtr.TransformerConfig, name)(), \
            getattr(ttr.TransformerConfig, name)()
        for field in ("vocab", "d_model", "n_layers", "n_heads",
                      "n_kv_heads", "d_ff", "max_seq", "rope_theta",
                      "d_head"):
            assert getattr(j, field) == getattr(t, field), (name, field)
    assert ttr.TransformerConfig.llama3_8b().dtype == torch.bfloat16
    jcfg, tcfg = _configs()
    jp = jax.tree.map(np.asarray, jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = ttr.init_params(tcfg, seed=0)
    assert jax.tree.structure(jp) == jax.tree.structure(
        jax.tree.map(lambda x: x.numpy(), tp))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp),
                            jax.tree.leaves(jax.tree.map(lambda x: x, tp))):
        assert tuple(a.shape) == tuple(b.shape), path
    again = ttr.init_params(tcfg, seed=0)
    assert torch.equal(tp["layers"]["wq"], again["layers"]["wq"])


def test_convert_keeps_norms_float32():
    jcfg = dataclasses.replace(jtr.TransformerConfig.tiny(), n_layers=1)
    jp = jax.tree.map(np.asarray, jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = convert.params_from_numpy(jp, dtype=torch.bfloat16)
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["layers"]["attn_norm"].dtype == torch.float32
    assert tp["final_norm"].dtype == torch.float32
    np.testing.assert_array_equal(
        tp["layers"]["wq"].float().numpy(),
        np.asarray(jp["layers"]["wq"], dtype=np.float32))


def test_forward_rejects_overlong_sequences():
    _, tcfg = _configs(seq=16)
    tp = ttr.init_params(tcfg)
    with pytest.raises(ValueError, match="max_seq"):
        ttr.forward(tp, torch.zeros(1, 32, dtype=torch.long), tcfg)


def test_entry_config_mirrors_graft_entry():
    fn, (params, tokens) = tentry.entry(device="cpu")
    cfg = tentry.ENTRY_CONFIG
    assert (cfg.vocab, cfg.d_model, cfg.n_layers, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_ff, cfg.max_seq) == (8192, 512, 4, 8, 4,
                                                       1408, 512)
    assert cfg.flash is True and cfg.dtype == torch.bfloat16
    assert tuple(tokens.shape) == (4, 512)
    logits = fn(params, tokens[:1, :32])
    assert logits.shape == (1, 32, 8192)
    assert bool(torch.isfinite(logits).all())
