"""Autoregressive inference for the Llama-style transformer (KV cache).

The counterpart of ``sofa_tpu/workloads/inference.py``.  The cache is a
static [L, B, max_seq, KVH, Dh] pair of buffers; decode positions are masked
(``j > cur_len`` -> NEG_INF) rather than sliced, prefill is one full pass
that also writes every layer's K/V, and decode runs one token per step.
Greedy argmax is the default, so runs are deterministic and the
step-vs-full-forward equivalence is testable; a SampleConfig adds
temperature / top-k / nucleus sampling from an explicit ``torch.Generator``.

Unlike the JAX package, the cache is updated in place (it would otherwise
be copied every step); a decode only ever reads positions it has written,
so handing the same cache to a second decode is still correct.

The cache attention is plain PyTorch (an einsum outside any kernel, as in
the JAX package).  ``make_serving_fns`` wraps prefill and decode in
``record_function("run_prefill")`` / ``("run_decode")`` ranges, which the
profiler's serving pass splits the phases on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import torch

from sofa_tpu_torch.workloads.ring_attention import NEG_INF
from sofa_tpu_torch.workloads.transformer import (
    TransformerConfig,
    _rmsnorm,
    layer_body,
    layer_params,
)


def init_cache(cfg: TransformerConfig, batch: int,
               device: Optional[torch.device] = None):
    """Zeroed K/V buffers: a (k, v) pair of [L, B, max_seq, KVH, Dh]."""
    shape = (cfg.n_layers, batch, cfg.max_seq, cfg.n_kv_heads, cfg.d_head)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def _attend_cache(q, k_cache, v_cache, cur_len: int):
    """q [B, T, H, Dh] attends the first cur_len + T cache positions.

    k/v_cache: [B, max_seq, KVH, Dh] (already holding this step's entries).
    Key j is valid for the query at offset i iff j <= cur_len + i; GQA runs
    as a grouped einsum over the compact heads.  Scores in float32, p rounds
    to the cache dtype before the second product."""
    b, t, h, dh = q.shape
    kvh = k_cache.shape[2]
    qg = q.reshape(b, t, kvh, h // kvh, dh)
    s = torch.einsum("btkrd,bskd->bkrts", qg.float(),
                     k_cache.float()) * dh ** -0.5
    j = torch.arange(k_cache.shape[1], device=q.device)
    q_pos = cur_len + torch.arange(t, device=q.device)
    s = s.masked_fill(j[None, :] > q_pos[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrts,bskd->btkrd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(b, t, h, dh).to(q.dtype)


def _block(params, x, positions, cache, cur_len: int, cfg: TransformerConfig):
    """Transformer stack over x [B, T, D], writing this step's K/V into the
    cache at offset cur_len (in place).  Returns logits [B, T, vocab]."""
    k_cache, v_cache = cache
    t = x.shape[1]
    for i in range(cfg.n_layers):
        kc, vc = k_cache[i], v_cache[i]

        def attn(q, kk, v, kc=kc, vc=vc):
            kc[:, cur_len:cur_len + t] = kk.to(kc.dtype)
            vc[:, cur_len:cur_len + t] = v.to(vc.dtype)
            return _attend_cache(q, kc, vc, cur_len)

        x = layer_body(x, layer_params(params, i), cfg, positions, attn)
    x = _rmsnorm(x, params["final_norm"])
    return (x @ params["lm_head"]).float()


@torch.no_grad()
def prefill(params, tokens, cache, cfg: TransformerConfig):
    """Full-sequence pass that fills the cache: (logits [B, T, vocab], cache)."""
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    x = params["embed"].to(cfg.dtype)[tokens]
    return _block(params, x, positions, cache, 0, cfg), cache


@torch.no_grad()
def decode_step(params, token, cache, cur_len: int, cfg: TransformerConfig):
    """One token in, one token's logits out.  token: [B] int64."""
    b = token.shape[0]
    positions = torch.full((b, 1), cur_len, device=token.device)
    x = params["embed"].to(cfg.dtype)[token][:, None, :]
    return _block(params, x, positions, cache, cur_len, cfg)[:, 0], cache


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """Decode-time sampling.  temperature 0.0 = greedy (the default);
    top_k 0 = unrestricted; top_p 1.0 = nucleus off."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0


GREEDY = SampleConfig()


def sample_token(logits, sc: SampleConfig,
                 generator: Optional[torch.Generator] = None):
    """Next-token choice from [B, vocab] float32 logits under ``sc``."""
    if sc.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    l = logits / sc.temperature
    if sc.top_k > 0:
        kth = torch.topk(l, sc.top_k, dim=-1).values[:, -1:]
        l = l.masked_fill(l < kth, NEG_INF)
    if sc.top_p < 1.0:
        # nucleus: keep the smallest prefix of the sorted distribution whose
        # mass reaches top_p (the first token always survives)
        sorted_l = torch.sort(l, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        drop = (probs.cumsum(dim=-1) - probs) >= sc.top_p
        cut = sorted_l.masked_fill(drop, float("inf")).amin(dim=-1,
                                                            keepdim=True)
        l = l.masked_fill(l < cut, NEG_INF)
    probs = torch.softmax(l, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def decode_loop(params, first_tok, cache, t_prompt: int, max_new: int,
                cfg: TransformerConfig, sample: SampleConfig = GREEDY,
                generator: Optional[torch.Generator] = None):
    """Tokens [B, max_new] from the first generated token: max_new - 1
    decode steps (the first new token came from prefill)."""
    toks = [first_tok]
    tok = first_tok
    for i in range(max_new - 1):
        logits, cache = decode_step(params, tok, cache, t_prompt + i, cfg)
        tok = sample_token(logits, sample, generator).to(first_tok.dtype)
        toks.append(tok)
    return torch.stack(toks, dim=1)


def generate(params, prompt, max_new: int, cfg: TransformerConfig,
             sample: SampleConfig = GREEDY,
             generator: Optional[torch.Generator] = None):
    """Decode: [B, T_prompt] -> [B, T_prompt + max_new]."""
    b, t_prompt = prompt.shape
    if t_prompt + max_new > cfg.max_seq:
        raise ValueError(f"{t_prompt} + {max_new} exceeds max_seq "
                         f"{cfg.max_seq}")
    cache = init_cache(cfg, b, prompt.device)
    logits, cache = prefill(params, prompt, cache, cfg)
    first = sample_token(logits[:, t_prompt - 1], sample,
                         generator).to(prompt.dtype)
    new = decode_loop(params, first, cache, t_prompt, max_new, cfg, sample,
                      generator)
    return torch.cat([prompt, new], dim=1)


def make_serving_fns(cfg: TransformerConfig, prompt_len: int, max_new: int):
    """The two serving entry points, each inside its own profiler range
    (``run_prefill`` / ``run_decode``) so the trace splits the phases:

      run_prefill(params, prompt)      -> (first_token, cache)
      run_decode(params, tok, cache)   -> [B, max_new] generated tokens
    """

    def run_prefill(p, x) -> Tuple[torch.Tensor, tuple]:
        with torch.profiler.record_function("run_prefill"):
            cache = init_cache(cfg, x.shape[0], x.device)
            logits, cache = prefill(p, x, cache, cfg)
            tok = torch.argmax(logits[:, x.shape[1] - 1], dim=-1).to(x.dtype)
            return tok, cache

    def run_decode(p, tok, cache) -> torch.Tensor:
        with torch.profiler.record_function("run_decode"):
            return decode_loop(p, tok, cache, prompt_len, max_new, cfg)

    return run_prefill, run_decode


def serve(params, prompts, cfg: TransformerConfig, max_new: int):
    """Serve one batch of prompts through make_serving_fns, timing each
    phase to its end on the device.  Returns (tokens [B, max_new],
    prefill tokens/s, decode tokens/s)."""
    from sofa_tpu_torch.workloads.common import fence

    b, t = prompts.shape
    run_prefill, run_decode = make_serving_fns(cfg, t, max_new)
    t0 = time.perf_counter()
    tok, cache = run_prefill(params, prompts)
    fence(tok)
    t1 = time.perf_counter()
    out = run_decode(params, tok, cache)
    fence(out)
    t2 = time.perf_counter()
    # The decode window runs max_new - 1 steps (the first new token is the
    # prefill window's argmax).
    return out, b * t / (t1 - t0), b * max(1, max_new - 1) / (t2 - t1)


def main(argv=None):
    from sofa_tpu_torch.workloads.common import (parse_workload_args,
                                                 resolve_device)
    from sofa_tpu_torch.workloads.transformer import init_params

    args = parse_workload_args(argv, {
        "batch": 4, "prompt": 128, "new_tokens": 128, "d_model": 512,
        "n_layers": 4, "n_heads": 8, "n_kv_heads": 4, "d_ff": 1408,
        "vocab": 32000, "device": None,
    })
    device = resolve_device(args.device)
    cfg = TransformerConfig(vocab=args.vocab, d_model=args.d_model,
                            n_layers=args.n_layers, n_heads=args.n_heads,
                            n_kv_heads=args.n_kv_heads, d_ff=args.d_ff,
                            max_seq=args.prompt + args.new_tokens)
    params = init_params(cfg, 0, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt),
                            generator=gen, device=device)
    serve(params, prompts, cfg, args.new_tokens)          # warm up
    _, pre_tps, dec_tps = serve(params, prompts, cfg, args.new_tokens)
    print(f"inference: prefill {pre_tps:,.1f} tokens/s, "
          f"decode {dec_tps:,.1f} tokens/s (batch {args.batch}, prompt "
          f"{args.prompt}, new {args.new_tokens}, device {device})")


if __name__ == "__main__":
    main()
