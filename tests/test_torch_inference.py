"""sofa_tpu_torch's KV-cache serving loop held against the JAX package's.

Tiny float32 config, one init carried over as numpy arrays.  Greedy tokens
must be identical; prefill and decode-step logits agree within atol/rtol
1e-4 (float32 layers summed in different orders, as in the forward test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofa_tpu.workloads import inference as jinf
from sofa_tpu.workloads import transformer as jtr
from sofa_tpu_torch import convert
from sofa_tpu_torch.workloads import inference as tinf
from sofa_tpu_torch.workloads import transformer as ttr

ATOL = RTOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jtr.TransformerConfig.tiny(seq=32),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(ttr.TransformerConfig.tiny(seq=32),
                               dtype=torch.float32)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(7))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    prompt = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 8),
                                               dtype=np.int32)
    return jcfg, tcfg, jp, tp, prompt


def test_generate_greedy_matches_jax(setup):
    jcfg, tcfg, jp, tp, prompt = setup
    with jax.default_matmul_precision("highest"):
        ref = jinf.generate(jp, jnp.asarray(prompt), 6, jcfg)
    got = tinf.generate(tp, torch.from_numpy(prompt).long(), 6, tcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_prefill_and_decode_logits_match_jax(setup):
    jcfg, tcfg, jp, tp, prompt = setup
    with jax.default_matmul_precision("highest"):
        jl, jcache = jinf.prefill(jp, jnp.asarray(prompt),
                                  jinf.init_cache(jcfg, 2), jcfg)
        tok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
        jd, _ = jinf.decode_step(jp, tok, jcache, 8, jcfg)
    tl, tcache = tinf.prefill(tp, torch.from_numpy(prompt).long(),
                              tinf.init_cache(tcfg, 2), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    td, _ = tinf.decode_step(tp, torch.tensor(np.asarray(tok)).long(),
                             tcache, 8, tcfg)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL,
                               rtol=RTOL)


def test_generate_matches_teacher_forced_forward(setup):
    _, tcfg, _, tp, prompt = setup
    seq = torch.from_numpy(prompt).long()
    out = tinf.generate(tp, seq, 6, tcfg)
    for _ in range(6):
        nxt = ttr.forward(tp, seq, tcfg)[:, -1].argmax(-1)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    assert torch.equal(out, seq)


def test_serving_fns_split_phases(setup):
    _, tcfg, _, tp, prompt = setup
    x = torch.from_numpy(prompt).long()
    run_prefill, run_decode = tinf.make_serving_fns(tcfg, 8, 5)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tok, cache = run_prefill(tp, x)
        out = run_decode(tp, tok, cache)
    names = {e.name for e in prof.events()}
    assert {"run_prefill", "run_decode"} <= names
    assert torch.equal(tok, ttr.forward(tp, x, tcfg)[:, -1].argmax(-1))
    assert out.shape == (2, 5) and torch.equal(out[:, 0], tok)
    # the cache is updated in place: a second decode from it still agrees
    assert torch.equal(run_decode(tp, tok, cache), out)
    tokens, pre_tps, dec_tps = tinf.serve(tp, x, tcfg, 5)
    assert torch.equal(tokens, out) and pre_tps > 0 and dec_tps > 0


def test_sampling_respects_top_k_and_is_seeded():
    logits = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (4, 50), dtype=np.float32))
    sc = tinf.SampleConfig(temperature=0.8, top_k=3)
    top3 = logits.topk(3, dim=-1).indices

    def draw(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return tinf.sample_token(logits, sc, g)

    a = draw(1)
    assert torch.equal(a, draw(1))
    assert bool((top3 == a[:, None]).any(-1).all())
    nucleus = tinf.sample_token(logits, tinf.SampleConfig(temperature=1.0,
                                                          top_p=1e-6))
    assert torch.equal(nucleus, logits.argmax(-1))
    assert torch.equal(tinf.sample_token(logits, tinf.GREEDY),
                       logits.argmax(-1))


def test_generate_rejects_overlong_requests(setup):
    _, tcfg, _, tp, prompt = setup
    with pytest.raises(ValueError, match="exceeds max_seq"):
        tinf.generate(tp, torch.from_numpy(prompt).long(), 30, tcfg)
