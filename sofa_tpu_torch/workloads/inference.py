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

Tensor parallelism composes: on a ("data", "model") mesh the params are
this rank's shard (``transformer.shard_params``), prefill and decode run
the tensor-parallel layer (``transformer.layer_body``), the cache holds
this rank's batch rows and KV heads (the JAX package's ``P(None, "data",
None, "model", None)``), and the next token is chosen over the
vocab-sharded logits: greedy reduces each shard's max and its index over
the model group, sampling gathers the logits.  ``generate`` and
``serve`` then gather the rows over "data", so every rank returns the
same tokens.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import torch

from sofa_tpu_torch.workloads.common import axis_size, gather, mesh_axis
from sofa_tpu_torch.workloads.ring_attention import NEG_INF
from sofa_tpu_torch.workloads.transformer import (
    TensorParallel,
    TransformerConfig,
    _rmsnorm,
    embed,
    layer_body,
    leaf_gathers,
    lm_logits,
    tensor_parallel,
    use_leaf,
)


@dataclasses.dataclass(frozen=True)
class Serving:
    """How a serving rank runs on its ("data", "model") mesh: its tensor
    parallelism (None for a model axis of 1) and the leaves gathered
    before use (the KV projections, where their heads do not divide over
    "model"); ``rows`` cuts its requests out of a batch, ``all_rows``
    gathers every rank's back."""

    tp: Optional[TensorParallel] = None
    mesh: object = None
    gathers: dict = dataclasses.field(default_factory=dict)

    def rows(self, batch: int) -> slice:
        """This rank's rows of a ``batch`` of requests (a data axis that
        does not divide it raises)."""
        dn = axis_size(self.mesh, "data")
        if batch % dn:
            raise ValueError(f"batch {batch} must divide over the mesh's "
                             f"data axis ({dn})")
        di = mesh_axis(self.mesh, "data").index
        return slice(di * batch // dn, (di + 1) * batch // dn)

    def all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows gathered over "data": the whole batch on every
        rank."""
        return gather(x, 0, mesh_axis(self.mesh, "data"))


def serving(cfg: TransformerConfig, mesh=None,
            device: Optional[torch.device] = None) -> Serving:
    """This rank's ``Serving`` on ``mesh`` (a model axis that does not
    divide the model raises)."""
    tp = tensor_parallel(cfg, mesh, device)
    return Serving(tp, mesh, leaf_gathers(cfg, mesh, False, tp))


def init_cache(cfg: TransformerConfig, batch: int,
               device: Optional[torch.device] = None,
               tp: Optional[TensorParallel] = None):
    """Zeroed K/V buffers: a (k, v) pair of [L, B, max_seq, KVH, Dh], the
    KV heads this rank's query heads read under ``tp`` (its share of them,
    or, where they do not divide over the model axis, the repeated ones)."""
    kvh = cfg.n_kv_heads
    if tp is not None:
        kvh = (tp.n_heads if tp.kv_index is not None
               else kvh // tp.axis.size)
    shape = (cfg.n_layers, batch, cfg.max_seq, kvh, cfg.d_head)
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


def _block(params, x, positions, cache, cur_len: int, cfg: TransformerConfig,
           srv: Optional[Serving] = None):
    """Transformer stack over x [B, T, D], writing this step's K/V into the
    cache at offset cur_len (in place).  Returns logits [B, T, vocab]
    (this rank's vocab columns on a mesh with a model axis)."""
    srv = srv or Serving()
    k_cache, v_cache = cache
    t = x.shape[1]
    for i in range(cfg.n_layers):
        kc, vc = k_cache[i], v_cache[i]

        def attn(q, kk, v, kc=kc, vc=vc):
            kc[:, cur_len:cur_len + t] = kk.to(kc.dtype)
            vc[:, cur_len:cur_len + t] = v.to(vc.dtype)
            return _attend_cache(q, kc, vc, cur_len)

        lp = {name: use_leaf(srv.gathers, name, w[i])
              for name, w in params["layers"].items()}
        x = layer_body(x, lp, cfg, positions, attn, srv.tp)
    x = _rmsnorm(x, params["final_norm"])
    return lm_logits(x, params["lm_head"], srv.tp)


@torch.no_grad()
def prefill(params, tokens, cache, cfg: TransformerConfig,
            srv: Optional[Serving] = None):
    """Full-sequence pass that fills the cache: (logits [B, T, vocab], cache)."""
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    x = embed(params["embed"].to(cfg.dtype), tokens, srv and srv.tp)
    return _block(params, x, positions, cache, 0, cfg, srv), cache


@torch.no_grad()
def decode_step(params, token, cache, cur_len: int, cfg: TransformerConfig,
                srv: Optional[Serving] = None):
    """One token in, one token's logits out.  token: [B] int64."""
    b = token.shape[0]
    positions = torch.full((b, 1), cur_len, device=token.device)
    x = embed(params["embed"].to(cfg.dtype), token[:, None], srv and srv.tp)
    return (_block(params, x, positions, cache, cur_len, cfg, srv)[:, 0],
            cache)


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


def next_token(logits, sc: SampleConfig = GREEDY,
               generator: Optional[torch.Generator] = None,
               tp: Optional[TensorParallel] = None):
    """``sample_token`` over [B, vocab] logits, or over this rank's vocab
    columns under ``tp``: greedy takes each shard's first max and its
    global index and keeps, per row, the shard with the largest (the
    lowest such shard on a tie: the global argmax); sampling gathers the
    logits over the model group.  Every rank of the group gets the same
    tokens (sampling: from generators in the same state)."""
    if tp is None:
        return sample_token(logits, sc, generator)
    if sc.temperature != 0.0:
        return sample_token(gather(logits, 1, tp.axis), sc, generator)
    val, idx = logits.max(dim=-1)
    vals = gather(val[None], 0, tp.axis)                 # [model, B]
    idxs = gather(idx[None] + tp.axis.index * tp.vocab, 0, tp.axis)
    return idxs.gather(0, vals.argmax(dim=0)[None])[0]


def decode_loop(params, first_tok, cache, t_prompt: int, max_new: int,
                cfg: TransformerConfig, sample: SampleConfig = GREEDY,
                generator: Optional[torch.Generator] = None,
                srv: Optional[Serving] = None):
    """Tokens [B, max_new] from the first generated token: max_new - 1
    decode steps (the first new token came from prefill)."""
    toks = [first_tok]
    tok = first_tok
    for i in range(max_new - 1):
        logits, cache = decode_step(params, tok, cache, t_prompt + i, cfg,
                                    srv)
        tok = next_token(logits, sample, generator,
                         srv and srv.tp).to(first_tok.dtype)
        toks.append(tok)
    return torch.stack(toks, dim=1)


def generate(params, prompt, max_new: int, cfg: TransformerConfig,
             sample: SampleConfig = GREEDY,
             generator: Optional[torch.Generator] = None, mesh=None):
    """Decode: [B, T_prompt] -> [B, T_prompt + max_new].  With a ("data",
    "model") ``mesh``, ``params`` are this rank's shard and ``prompt`` the
    global batch; each rank decodes its rows with its heads, and every
    rank returns the whole batch's tokens."""
    b, t_prompt = prompt.shape
    if t_prompt + max_new > cfg.max_seq:
        raise ValueError(f"{t_prompt} + {max_new} exceeds max_seq "
                         f"{cfg.max_seq}")
    srv = serving(cfg, mesh, prompt.device)
    prompt = prompt[srv.rows(b)]
    cache = init_cache(cfg, prompt.shape[0], prompt.device, srv.tp)
    logits, cache = prefill(params, prompt, cache, cfg, srv)
    first = next_token(logits[:, t_prompt - 1], sample, generator,
                       srv.tp).to(prompt.dtype)
    new = decode_loop(params, first, cache, t_prompt, max_new, cfg, sample,
                      generator, srv)
    return srv.all_rows(torch.cat([prompt, new], dim=1))


def make_serving_fns(cfg: TransformerConfig, prompt_len: int, max_new: int,
                     mesh=None):
    """The two serving entry points, each inside its own profiler range
    (``run_prefill`` / ``run_decode``) so the trace splits the phases:

      run_prefill(params, prompt)      -> (first_token, cache)
      run_decode(params, tok, cache)   -> [B, max_new] generated tokens

    With a ``mesh``, ``prompt`` is the global batch and both return this
    rank's rows (``serve`` gathers them)."""

    def run_prefill(p, x) -> Tuple[torch.Tensor, tuple]:
        with torch.profiler.record_function("run_prefill"):
            srv = serving(cfg, mesh, x.device)
            x = x[srv.rows(x.shape[0])]
            cache = init_cache(cfg, x.shape[0], x.device, srv.tp)
            logits, cache = prefill(p, x, cache, cfg, srv)
            tok = next_token(logits[:, x.shape[1] - 1], tp=srv.tp)
            return tok.to(x.dtype), cache

    def run_decode(p, tok, cache) -> torch.Tensor:
        with torch.profiler.record_function("run_decode"):
            return decode_loop(p, tok, cache, prompt_len, max_new, cfg,
                               srv=serving(cfg, mesh, tok.device))

    return run_prefill, run_decode


def serve(params, prompts, cfg: TransformerConfig, max_new: int, mesh=None):
    """Serve one batch of prompts through make_serving_fns, timing each
    phase to its end on the device.  Returns (tokens [B, max_new],
    prefill tokens/s, decode tokens/s); with a ``mesh``, the whole
    batch's tokens on every rank, and the global batch's rates."""
    from sofa_tpu_torch.workloads.common import fence

    b, t = prompts.shape
    run_prefill, run_decode = make_serving_fns(cfg, t, max_new, mesh)
    t0 = time.perf_counter()
    tok, cache = run_prefill(params, prompts)
    fence(tok)
    t1 = time.perf_counter()
    out = run_decode(params, tok, cache)
    fence(out)
    t2 = time.perf_counter()
    out = serving(cfg, mesh, prompts.device).all_rows(out)
    # The decode window runs max_new - 1 steps (the first new token is the
    # prefill window's argmax).
    return out, b * t / (t1 - t0), b * max(1, max_new - 1) / (t2 - t1)


def main(argv=None):
    """The JAX workload's ``main``: serve ``--batch`` prompts (after one
    warm-up run) and print the prefill and decode rates, then every
    request's tokens.  Under torchrun, or with ``--data`` / ``--model``,
    the ranks form a ("data", "model") mesh (one flag set: the other axis
    takes the rest; ``--backend``, ``--share_device`` as the training
    ``main``'s); each rank prints its lines."""
    import json
    import os

    from sofa_tpu_torch.workloads.common import (init_distributed,
                                                 make_mesh,
                                                 parse_workload_args,
                                                 resolve_device)
    from sofa_tpu_torch.workloads.transformer import init_params

    args = parse_workload_args(argv, {
        "batch": 4, "prompt": 128, "new_tokens": 128, "d_model": 512,
        "n_layers": 4, "n_heads": 8, "n_kv_heads": 4, "d_ff": 1408,
        "vocab": 32000, "device": None, "data": 0, "model": 0,
        "backend": None, "share_device": False,
    })
    cfg = TransformerConfig(vocab=args.vocab, d_model=args.d_model,
                            n_layers=args.n_layers, n_heads=args.n_heads,
                            n_kv_heads=args.n_kv_heads, d_ff=args.d_ff,
                            max_seq=args.prompt + args.new_tokens)
    mesh, tag = None, ""
    if "WORLD_SIZE" in os.environ or args.data or args.model:
        info = init_distributed(args.backend, args.device, args.share_device)
        sizes = None
        if args.data or args.model:
            sizes = (args.data or -1, args.model or -1)
        mesh = make_mesh(("data", "model"), sizes,
                         device_type=info.device.type)
        device, tag = info.device, f"rank {info.rank} "
    else:
        device = resolve_device(args.device)
    params = init_params(cfg, 0, device, mesh)
    if device.type == "cuda":
        # the init's float32 draws back to the card, which other ranks may
        # share
        torch.cuda.empty_cache()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt),
                            generator=gen, device=device)
    serve(params, prompts, cfg, args.new_tokens, mesh)    # warm up
    out, pre_tps, dec_tps = serve(params, prompts, cfg, args.new_tokens,
                                  mesh)
    where = (f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
             if mesh is not None else f"device {device}")
    if device.type == "cuda":
        where += (f", peak {torch.cuda.max_memory_allocated(device) / 1e9:.2f}"
                  " GB")
    print(f"inference: {tag}prefill {pre_tps:,.1f} tokens/s, "
          f"decode {dec_tps:,.1f} tokens/s (batch {args.batch}, prompt "
          f"{args.prompt}, new {args.new_tokens}, {where})")
    print(f"inference: {tag}tokens {json.dumps(out.tolist())}", flush=True)
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
