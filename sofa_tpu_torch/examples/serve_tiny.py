"""A tiny serving loop: repeated prefill + KV-cache decode requests.

The counterpart of ``examples/serve_tiny.py``, and the serving-profile
target: prefill and decode run in their own profiler ranges
(``run_prefill`` / ``run_decode``), so ``python -m sofa_tpu_torch stat
"python -m sofa_tpu_torch.examples.serve_tiny"`` yields the ``serving_*``
features (per-phase device time, arithmetic intensity, decode bandwidth,
time to first token).
"""

import torch

from sofa_tpu_torch.examples import device_arg
from sofa_tpu_torch.workloads.common import fence, resolve_device
from sofa_tpu_torch.workloads.inference import make_serving_fns
from sofa_tpu_torch.workloads.transformer import TransformerConfig, init_params


def serve_requests(cfg, params, prompts, prompt: int, new_tokens: int):
    """A warm-up request (the JAX example compiles both phases), then one
    prefill and decode per request of ``prompts`` [R, B, prompt]; returns
    each request's [B, new_tokens] tokens."""
    run_prefill, run_decode = make_serving_fns(cfg, prompt, new_tokens)
    tok, cache = run_prefill(params, prompts[0])
    fence(run_decode(params, tok, cache))
    outs = []
    for r in range(prompts.shape[0]):
        tok, cache = run_prefill(params, prompts[r])
        outs.append(run_decode(params, tok, cache))
    fence(outs)
    return outs


def main(requests: int = 4, prompt: int = 64, new_tokens: int = 32,
         device=None):
    dev = resolve_device(device)
    cfg = TransformerConfig.tiny(seq=prompt + new_tokens)
    params = init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (requests, 2, prompt),
                            generator=gen, device=dev)
    serve_requests(cfg, params, prompts, prompt, new_tokens)
    print(f"served {requests} requests "
          f"(prompt {prompt}, new {new_tokens}, batch 2)")


if __name__ == "__main__":
    main(**device_arg())
