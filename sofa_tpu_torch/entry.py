"""The flagship workload's entry point, and a profiling demo around it.

``entry()`` mirrors ``__graft_entry__.py:entry()``: the Llama-style decoder
(vocab 8192, d_model 512, 4 layers, 8 heads / 4 KV heads, d_ff 1408) on
4 x 512 tokens, with the fused attention on.  It returns ``(fn, args)``
where ``fn(*args)`` is the forward pass.  There is no probe-and-degrade: on
the card the forward runs the ``sofa_flash_fwd`` kernel or raises.

``python -m sofa_tpu_torch.entry`` runs that forward for ``--steps``
``sofa_step_N``-annotated steps, then (``--serve_requests`` > 0) serves a
batch of requests through the KV-cache serving loop at Llama-3-8B width
with ``--serve_layers`` layers.  It is the command ``chip_smoke.py``
profiles through ``python -m sofa_tpu_torch stat``.
"""

from __future__ import annotations

import dataclasses

import torch

from sofa_tpu_torch.workloads.common import resolve_device
from sofa_tpu_torch.workloads.transformer import (
    TransformerConfig,
    forward,
    init_params,
)

ENTRY_CONFIG = TransformerConfig(vocab=8192, d_model=512, n_layers=4,
                                 n_heads=8, n_kv_heads=4, d_ff=1408,
                                 max_seq=512, flash=True)
ENTRY_BATCH, ENTRY_SEQ = 4, 512


def entry(device=None, seed: int = 0):
    """(fn, example_args) — the single-device forward step."""
    device = resolve_device(device)
    cfg = ENTRY_CONFIG
    params = init_params(cfg, seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (ENTRY_BATCH, ENTRY_SEQ),
                           generator=gen, device=device)

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)


def main(argv=None):
    from sofa_tpu_torch.workloads import inference
    from sofa_tpu_torch.workloads.common import (parse_workload_args,
                                                 steps_per_sec)

    args = parse_workload_args(argv, {
        "steps": 3, "device": None, "serve_requests": 0, "serve_layers": 2,
        "prompt": 128, "new_tokens": 8,
    })
    device = resolve_device(args.device)
    fn, (params, tokens) = entry(device)
    sps, logits = steps_per_sec(lambda _: fn(params, tokens), None,
                                args.steps, warmup=1)
    print(f"entry: {sps:.3f} forward steps/s, logits "
          f"{tuple(logits.shape)} on {device}")
    if args.serve_requests <= 0:
        return
    cfg = dataclasses.replace(TransformerConfig.llama3_8b(),
                              n_layers=args.serve_layers,
                              max_seq=args.prompt + args.new_tokens)
    params = init_params(cfg, 0, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (args.serve_requests, args.prompt),
                            generator=gen, device=device)
    out, pre_tps, dec_tps = inference.serve(params, prompts, cfg,
                                            args.new_tokens)
    print(f"serve: {args.serve_requests} requests at llama3_8b width, "
          f"{cfg.n_layers} layers: prefill {pre_tps:,.1f} tokens/s, "
          f"decode {dec_tps:,.1f} tokens/s, tokens {tuple(out.shape)}")


if __name__ == "__main__":
    main()
