"""Long-context training: the fused GQA flash kernels, remat, and the ring.

The counterpart of ``examples/long_context.py``: the long-sequence stack in
one runnable loop.

- Every attention runs the three hand-written CUDA kernels
  (``sofa_flash_fwd``, ``sofa_flash_bwd_kv``, ``sofa_flash_bwd_dq``), with
  no [T, T] score matrix anywhere, and the KV heads stay compact (native
  GQA, 2:1 here).
- Each layer rematerializes in the backward (``remat=True``), so live
  activations are one layer deep whatever the depth.
- Under torchrun the ranks form a ("data", "seq", "model") mesh: the
  sequence shards over "seq" and every attention hop goes around the ring
  (zig-zag balanced on the card when the ring has more than one rank).  On
  one card the mesh is one rank (seq 1), so zig-zag is off, as in the JAX
  example on one device.

It keeps ``TransformerConfig.tiny``'s depth, vocab, d_ff and 2:1 GQA but
takes head dim 64 (d_model 256 over 4 query and 2 KV heads): the CUDA
kernels are built for head dims 64 and 128 only
(``sofa_tpu_torch/workloads/flash_cuda.py``, ``HEAD_DIMS``), and the auto
rule (``transformer.use_flash``) sends tiny's head dim 16 to the plain
attention, with no error, so a literal port would launch no kernel.
Profiled, the trace shows the ``sofa_flash_*`` kernel rows with their cost
estimates and per-step fw/bw attribution:

    python -m sofa_tpu_torch stat --logdir llog/ --enable_aisi \\
        "python -m sofa_tpu_torch.examples.long_context"

``--device cpu`` runs the same loop on the CPU with the plain attention.
"""

import dataclasses
import os

from sofa_tpu_torch.examples import device_arg
from sofa_tpu_torch.workloads.common import fence, step_annotation
from sofa_tpu_torch.workloads.transformer import TransformerConfig, build


def config(seq: int, sp: int, on_card: bool) -> TransformerConfig:
    """tiny's depth, vocab, d_ff and 2:1 GQA at head dim 64, remat on;
    flash=None is the auto rule: the kernels on the card, the plain
    attention elsewhere (forcing True would make an unsupported shape a
    hard error)."""
    return dataclasses.replace(
        TransformerConfig.tiny(seq=seq), d_model=256, n_heads=4,
        n_kv_heads=2, flash=None, zigzag=sp > 1 and on_card, remat=True)


def main(steps: int = 8, seq: int = 512, device=None):
    mesh, sizes = None, {"data": 1, "seq": 1, "model": 1}
    if "WORLD_SIZE" in os.environ:
        from sofa_tpu_torch.workloads.common import (init_distributed,
                                                     make_mesh)

        info = init_distributed(device=device)
        n = info.world_size
        sp = max(d for d in (1, 2, 4, 8) if n % d == 0 and d <= n)
        sizes = {"data": n // sp, "seq": sp, "model": 1}
        mesh = make_mesh(tuple(sizes), tuple(sizes.values()),
                         device_type=info.device.type)
        device = info.device
    cfg = config(seq, sizes["seq"],
                 device is None or str(device).startswith("cuda"))
    # the batch shards over the data axis, so it scales with it
    params, opt, step, tokens = build(cfg, batch=2 * sizes["data"],
                                      seq=seq, device=device, mesh=mesh)
    params, opt, loss = step(params, opt, tokens)       # warm-up
    fence(loss)
    for i in range(steps):
        with step_annotation(i):
            params, opt, loss = step(params, opt, tokens)
    fence(loss)
    print(f"mesh={sizes} seq={seq} remat=on "
          f"zigzag={'on' if cfg.zigzag else 'off'} "
          f"final loss {float(loss):.4f} after {steps} steps")
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main(**device_arg())
