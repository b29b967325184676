"""The port's examples (``sofa_tpu_torch/examples/``) on the CPU: the five
recipes of tests/test_examples.py, and ``train_tiny`` and ``serve_tiny``
held against the JAX examples on one init.

The JAX tiny config's params cross over as numpy arrays
(``convert.params_from_numpy``), in float32 in both packages: the loss
after the examples' steps (the warm-up step and 2 more) at the reference's
float32 gradient tolerance (atol 1e-4, rtol 1e-3, tests/test_workloads.py),
and the served tokens exactly.  JAX runs at its highest matmul precision.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sofa_tpu.workloads import transformer as jtr
from sofa_tpu.workloads.common import step_annotation as jstep_annotation
from sofa_tpu.workloads.inference import make_serving_fns as jserving_fns
from sofa_tpu_torch import convert
from sofa_tpu_torch.examples import (io_churn, long_context, matmul_burn,
                                     serve_tiny, train_tiny)
from sofa_tpu_torch.workloads import transformer as ttr

GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3


def test_io_churn_runs(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    io_churn.main(mb=4)
    assert "wrote+read 4 MiB" in capsys.readouterr().out


def test_train_tiny_runs(capsys):
    train_tiny.main(steps=2, device="cpu")
    assert "final loss" in capsys.readouterr().out


def test_long_context_runs(capsys):
    long_context.main(steps=2, seq=64, device="cpu")
    out = capsys.readouterr().out
    assert "final loss" in out and "remat=on" in out
    assert "mesh={'data': 1, 'seq': 1, 'model': 1}" in out


def test_serve_tiny_runs(capsys):
    serve_tiny.main(requests=2, prompt=16, new_tokens=4, device="cpu")
    assert "served 2 requests" in capsys.readouterr().out


def test_matmul_burn_runs(capsys):
    matmul_burn.main(seconds=0.5, n=128, device="cpu")
    assert "burns in" in capsys.readouterr().out


def test_long_context_takes_the_kernels_head_dim():
    """tiny's depth, vocab, d_ff and 2:1 GQA at head dim 64: the auto rule
    sends it to the CUDA kernels on the card (tiny's head dim 16 would go
    to the plain attention), and to the plain attention on the CPU."""
    cfg = long_context.config(512, 1, True)
    tiny = ttr.TransformerConfig.tiny(seq=512)
    assert (cfg.n_layers, cfg.vocab, cfg.d_ff) == (tiny.n_layers, tiny.vocab,
                                                   tiny.d_ff)
    assert cfg.n_heads // cfg.n_kv_heads == tiny.n_heads // tiny.n_kv_heads
    assert cfg.d_head == 64 and tiny.d_head == 16
    assert cfg.remat and not cfg.zigzag and cfg.flash is None
    assert ttr.use_flash(cfg, 512, torch.device("cuda"))
    assert not ttr.use_flash(tiny, 512, torch.device("cuda"))
    assert not ttr.use_flash(cfg, 512, torch.device("cpu"))
    assert long_context.config(512, 2, True).zigzag
    assert not long_context.config(512, 2, False).zigzag


def test_train_tiny_loss_matches_jax():
    """The JAX example's loop (a compile step, then 2 annotated steps) and
    the port's ``train`` from the same params and tokens."""
    jcfg = dataclasses.replace(jtr.TransformerConfig.tiny(seq=128),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(ttr.TransformerConfig.tiny(seq=128),
                               dtype=torch.float32)
    with jax.default_matmul_precision("highest"):
        params, opt_state, step, tokens = jtr.build(jcfg, mesh=None,
                                                    batch=8, seq=128)
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, params))
        t_tokens = torch.from_numpy(np.array(tokens)).long()
        params, opt_state, ref = step(params, opt_state, tokens)
        for i in range(2):
            with jstep_annotation(i):
                params, opt_state, ref = step(params, opt_state, tokens)
    opt, t_step = ttr.make_train_step(tcfg, tp)
    loss = train_tiny.train(tp, opt, t_step, t_tokens, 2)
    np.testing.assert_allclose(float(loss), float(ref), atol=GRAD_ATOL,
                               rtol=GRAD_RTOL)


def test_serve_tiny_tokens_match_jax():
    """The JAX example's requests (a warm-up, then one prefill and decode
    each) and the port's ``serve_requests`` on the same params and
    prompts: the same tokens."""
    prompt, new = 16, 6
    jcfg = dataclasses.replace(jtr.TransformerConfig.tiny(seq=prompt + new),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(ttr.TransformerConfig.tiny(seq=prompt + new),
                               dtype=torch.float32)
    prompts = np.random.default_rng(3).integers(0, jcfg.vocab,
                                                (3, 2, prompt),
                                                dtype=np.int32)
    with jax.default_matmul_precision("highest"):
        params = jtr.init_params(jcfg, jax.random.PRNGKey(0))
        run_prefill, run_decode = jserving_fns(jcfg, prompt, new)
        ref = []
        for r in range(prompts.shape[0]):
            tok, cache = run_prefill(params, jnp.asarray(prompts[r]))
            ref.append(np.asarray(run_decode(params, tok, cache)))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, params))
    got = serve_tiny.serve_requests(tcfg, tp, torch.from_numpy(prompts)
                                    .long(), prompt, new)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (2, new)
        np.testing.assert_array_equal(g.numpy(), r)
