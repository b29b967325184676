"""sofa_tpu_torch's training path held against the JAX package's, on one
init.

The tiny float32 config's JAX params cross over as numpy arrays
(``convert.params_from_numpy``); both packages take the loss and its
gradients on the same tokens.  JAX runs at highest matmul precision, with
its flash path (both backward kernels) in Pallas interpret mode; the port's
flash path on the CPU runs the kernels' plain versions through the same
autograd Function the card uses.  Gradient tolerance atol 1e-4 / rtol 1e-3,
the reference's own (tests/test_workloads.py).  The optimizer is held to
optax's adamw on the same gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sofa_tpu.workloads import transformer as jtr
from sofa_tpu_torch import convert
from sofa_tpu_torch import kernels
from sofa_tpu_torch.workloads import transformer as ttr

GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3


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


def _value_and_grad(tp, tokens, cfg, seg=None):
    leaves = [p.requires_grad_(True) for p in ttr.param_leaves(tp)]
    loss = ttr.loss_fn(tp, tokens, cfg, seg)
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_loss_and_grads_match_jax(flash, packed):
    jcfg, tcfg = _configs(flash=flash)
    jp, tp = _params(jcfg)
    tokens = _tokens(1, 2, 64, jcfg.vocab)
    seg = _packed_segments(2, 64) if packed else None
    with jax.default_matmul_precision("highest"):
        ref_loss, ref_grads = jax.value_and_grad(jtr.loss_fn)(
            jp, jnp.asarray(tokens), jcfg,
            segment_ids=None if seg is None else jnp.asarray(seg))
    loss, grads = _value_and_grad(
        tp, torch.from_numpy(tokens).long(), tcfg,
        None if seg is None else torch.from_numpy(seg))
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=GRAD_ATOL,
                               rtol=GRAD_RTOL)
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref_grads),
                            grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_param_leaves_follow_the_jax_tree_order():
    jcfg, _ = _configs()
    jp, tp = _params(jcfg)
    for a, b in zip(jax.tree.leaves(jp), ttr.param_leaves(tp)):
        assert tuple(a.shape) == tuple(b.shape)
    assert len(jax.tree.leaves(jp)) == len(list(ttr.param_leaves(tp)))


def test_adamw_matches_optax_on_the_same_grads():
    """Same grads in, same params out, for 3 steps.  Both are fed the same
    gradients on purpose: Adam's first update is the sign of the gradient,
    so a gradient computed apart could flip a near-zero entry."""
    jcfg, _ = _configs()
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(5)
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), jp) for _ in range(3)]
    tx = optax.adamw(1e-3)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
    opt = ttr.make_optimizer(tp, learning_rate=1e-3)
    for g in grads:
        for leaf, gl in zip(ttr.param_leaves(tp), jax.tree.leaves(g)):
            leaf.grad = torch.from_numpy(np.array(gl))
        opt.step()
    for a, b in zip(jax.tree.leaves(jp), ttr.param_leaves(tp)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=1e-6, rtol=0)
    group = opt.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == (
        (0.9, 0.999), 1e-8, 1e-4)


@pytest.mark.parametrize("flash", [None, True], ids=["auto", "flash"])
def test_train_step_runs_and_descends(flash):
    cfg = dataclasses.replace(ttr.TransformerConfig.tiny(seq=32), flash=flash)
    params, opt, step, tokens = ttr.build(cfg, batch=4, seq=32, device="cpu")
    assert tokens.shape == (4, 32) and tokens.device.type == "cpu"
    before = kernels.counts()
    losses = []
    for _ in range(5):
        params, opt, loss = step(params, opt, tokens)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert kernels.counts() == before          # the CPU launches no kernel
    assert opt.state[params["embed"]]["exp_avg"].dtype == cfg.dtype


def test_packed_loss_matches_separate_docs():
    """The packed loss equals the token-weighted mean of the documents'
    separate losses (the loss half of the JAX test of the same name)."""
    _, cfg = _configs(seq=96)
    jcfg, _ = _configs(seq=96)
    _, params = _params(jcfg, seed=13)
    la, lb = 40, 56
    rng = np.random.default_rng(14)
    doc_a = torch.from_numpy(rng.integers(0, cfg.vocab, (1, la)))
    doc_b = torch.from_numpy(rng.integers(0, cfg.vocab, (1, lb)))
    packed = torch.cat([doc_a, doc_b], dim=1)
    seg = torch.cat([torch.zeros(1, la, dtype=torch.int32),
                     torch.ones(1, lb, dtype=torch.int32)], dim=1)
    for flash in (False, True):
        c = dataclasses.replace(cfg, flash=flash)
        with torch.no_grad():
            loss_packed = ttr.loss_fn(params, packed, c, seg).item()
            sum_a = ttr.loss_fn(params, doc_a, c).item() * (la - 1)
            sum_b = ttr.loss_fn(params, doc_b, c).item() * (lb - 1)
        expect = (sum_a + sum_b) / (la - 1 + lb - 1)
        assert abs(loss_packed - expect) < 1e-5, flash


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("kwargs", [
    {"remat": True},
    {"remat": True, "remat_policy": "dots_with_no_batch_dims_saveable"},
    {"remat_policy": "dots_with_no_batch_dims_saveable"},
], ids=["remat", "policy", "policy_implies_remat"])
def test_remat_matches_no_remat(kwargs, flash):
    """Checkpointing each layer changes when activations are computed, not
    the loss or the grads (the JAX test's limits)."""
    _, cfg = _configs(seq=32, flash=flash)
    params = ttr.init_params(cfg, seed=0)
    tokens = torch.from_numpy(_tokens(3, 4, 32, cfg.vocab)).long()
    base, gbase = _value_and_grad(params, tokens, cfg)
    val, grad = _value_and_grad(params, tokens,
                                dataclasses.replace(cfg, **kwargs))
    np.testing.assert_allclose(val.item(), base.item(), rtol=1e-6, atol=1e-6)
    for a, b in zip(grad, gbase):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_remat_replays_the_forward(monkeypatch):
    """Under remat the backward re-runs each layer's attention forward."""
    _, cfg = _configs(seq=32, flash=True)
    params = ttr.init_params(cfg, seed=0)
    tokens = torch.from_numpy(_tokens(4, 2, 32, cfg.vocab)).long()
    calls = []
    real = ttr.flash_causal_attention

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(ttr, "flash_causal_attention", counted)
    for remat, want in ((False, cfg.n_layers), (True, 2 * cfg.n_layers)):
        calls.clear()
        _value_and_grad(params, tokens, dataclasses.replace(cfg, remat=remat))
        assert len(calls) == want, remat


def test_unknown_remat_policy_raises_and_names_the_supported():
    _, cfg = _configs(seq=16, remat_policy="nothing_saveable")
    params = ttr.init_params(cfg)
    with pytest.raises(ValueError, match="dots_with_no_batch_dims_saveable"):
        ttr.loss_fn(params, torch.zeros(1, 16, dtype=torch.long), cfg)


def test_forward_without_grad_builds_no_graph():
    _, cfg = _configs(seq=16)
    params = ttr.init_params(cfg)
    logits = ttr.forward(params, torch.zeros(1, 16, dtype=torch.long), cfg)
    assert not logits.requires_grad and logits.grad_fn is None


def test_main_trains_on_the_cpu(capsys):
    ttr.main(["--device", "cpu", "--batch", "2", "--seq", "16", "--steps",
              "2", "--d_model", "32", "--n_heads", "2", "--n_kv_heads", "1",
              "--d_ff", "64", "--vocab", "64", "--n_layers", "1"])
    out = capsys.readouterr().out
    assert out.startswith("transformer: ") and "steps/s" in out
    assert "tokens/s" in out and "loss=" in out and "device=cpu" in out
