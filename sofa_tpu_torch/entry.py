"""The flagship workload's entry point, and a profiling demo around it.

``entry()`` mirrors ``__graft_entry__.py:entry()``: the Llama-style decoder
(vocab 8192, d_model 512, 4 layers, 8 heads / 4 KV heads, d_ff 1408) on
4 x 512 tokens, with the fused attention on.  It returns ``(fn, args)``
where ``fn(*args)`` is the forward pass.  There is no probe-and-degrade: on
the card the forward runs the ``sofa_flash_fwd`` kernel or raises.

``dryrun_multigpu(n)`` mirrors ``__graft_entry__.py:dryrun_multichip``:
one sharded training step on each of three meshes of ``n`` ranks, at tiny
shapes derived from the axis sizes, printing one line each that ends in
``ok``: the (data, seq, model) transformer with FSDP and remat, the
(data, expert) MoE (skipped below two ranks) and the (data, stage)
pipeline.  Each rank runs its own code (the JAX package's ``shard_map``
and ``pcast`` have no counterpart here).

``python -m sofa_tpu_torch.entry`` runs that forward for ``--steps``
``sofa_step_N``-annotated steps, then (``--serve_requests`` > 0) serves a
batch of requests through the KV-cache serving loop at Llama-3-8B width
with ``--serve_layers`` layers.  It is the command ``chip_smoke.py``
profiles through ``python -m sofa_tpu_torch stat``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

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


def _dryrun_rank(rank: int, n: int, device, store: Optional[str],
                 out_path: Optional[str]) -> List[str]:
    """One rank of ``dryrun_multigpu``: joins the group (the FileStore at
    ``store``, else torchrun's environment), runs the three steps, and
    returns (rank 0 also writes to ``out_path``) the three lines."""
    import math

    import torch.distributed as dist

    from sofa_tpu_torch.workloads import moe, pipeline, transformer
    from sofa_tpu_torch.workloads.common import (balanced_factorization,
                                                 init_distributed,
                                                 make_mesh)

    if store is not None:
        torch.set_num_threads(1)    # the ranks share the host's cores
        info = init_distributed(device=device, store_path=store, rank=rank,
                                world_size=n)
    else:
        info = init_distributed(device=device)
    kind = info.device.type
    lines = []

    def finite(what, loss):
        value = float(loss)
        if not math.isfinite(value):
            raise RuntimeError(f"non-finite {what} loss {value}")
        return value

    mesh = make_mesh(("data", "seq", "model"), device_type=kind)
    dp, sp, tp = (mesh.size(i) for i in range(3))
    cfg = transformer.TransformerConfig(
        vocab=64 * tp, d_model=16 * (2 * tp), n_layers=2, n_heads=2 * tp,
        n_kv_heads=tp, d_ff=32 * tp, max_seq=16 * sp, remat=True)
    batch, seq = 2 * dp, 16 * sp
    params, opt, step, tokens = transformer.build(
        cfg, batch, seq, device=info.device, mesh=mesh, fsdp=True)
    _, _, loss = step(params, opt, tokens)
    lines.append(f"dryrun_multigpu: mesh={_shape(mesh)} batch={batch} "
                 f"seq={seq} loss={finite('transformer', loss):.4f} ok")

    if n < 2:
        lines.append("dryrun_multigpu: ep skipped (needs >= 2 devices)")
    else:
        dp2, ep = balanced_factorization(n, 2)
        if ep == 1:
            dp2, ep = 1, n
        moe_mesh = make_mesh(("data", "expert"), (dp2, ep), device_type=kind)
        moe_cfg = dataclasses.replace(moe.MoEConfig.tiny(n_experts=ep),
                                      n_layers=1, max_seq=16)
        mp, mopt, mstep, mtok = moe.build(moe_cfg, n, 16, device=info.device,
                                          mesh=moe_mesh)
        _, _, mloss = mstep(mp, mopt, mtok)
        lines.append(f"dryrun_multigpu: ep mesh={_shape(moe_mesh)} "
                     f"experts={moe_cfg.n_experts} "
                     f"loss={finite('MoE', mloss):.4f} ok")

    dp3, st = balanced_factorization(n, 2)
    if st == 1:
        dp3, st = 1, n
    pp_mesh = make_mesh(("data", "stage"), (dp3, st), device_type=kind)
    pp_cfg = dataclasses.replace(pipeline.PipelineConfig.tiny(),
                                 n_microbatches=2, max_seq=16)
    qp, qopt, qstep, qtok = pipeline.build(pp_cfg, pp_mesh, 2 * dp3, 16,
                                           device=info.device)
    _, _, qloss = qstep(qp, qopt, qtok)
    lines.append(f"dryrun_multigpu: pp mesh={_shape(pp_mesh)} stages={st} "
                 f"loss={finite('pipeline', qloss):.4f} ok")
    if info.rank == 0 and out_path is not None:
        with open(out_path, "w") as f:
            f.write("\n".join(lines) + "\n")
    dist.destroy_process_group()
    return lines


def _shape(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dryrun_multigpu(n: int, device=None, timeout: float = 300.0
                    ) -> List[str]:
    """One sharded training step on each of the three meshes of ``n``
    ranks, tiny shapes derived from the axis sizes (``__graft_entry__.py:
    dryrun_multichip``): (data, seq, model) with FSDP and remat, (data,
    expert) (skipped below 2 ranks), (data, stage).  Prints the three
    lines (rank 0's) and returns them; a non-finite loss raises.

    Under torchrun (``WORLD_SIZE`` set) this process is one of the ``n``
    ranks.  Otherwise ``spawn_ranks`` starts them, with a ``timeout``
    deadline: on the card (``device`` None) over NCCL, one rank to a card
    (``n`` up to ``torch.cuda.device_count()``); with ``device="cpu"``
    over gloo."""
    import os
    import shutil
    import tempfile

    from sofa_tpu_torch.workloads.common import resolve_device, spawn_ranks

    if "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != n:
            raise ValueError(f"dryrun_multigpu({n}) under a torchrun world "
                             f"of {os.environ['WORLD_SIZE']}")
        lines = _dryrun_rank(0, n, device, None, None)
        if int(os.environ["RANK"]) == 0:
            print("\n".join(lines), flush=True)
        return lines
    resolve_device(device)          # no card: raise here, not in n ranks
    work = tempfile.mkdtemp(prefix="sofa_dryrun_")
    try:
        out = os.path.join(work, "lines.txt")
        spawn_ranks(n, _dryrun_rank, n, device, os.path.join(work, "store"),
                    out, timeout=timeout)
        with open(out) as f:
            lines = f.read().splitlines()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("\n".join(lines), flush=True)
    return lines


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
