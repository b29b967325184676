"""Llama-style decoder-only transformer in PyTorch, on one card or over a
(data, seq) mesh of ranks.

The counterpart of ``sofa_tpu/workloads/transformer.py``: RMSNorm, rotary
position embeddings, grouped-query attention, SwiGLU MLP, untied LM head.
Params are a plain dict with the JAX package's layout (per-layer leaves
stacked as ``[n_layers, ...]``), so one init crosses between the packages
(``sofa_tpu_torch.convert``).  Matmuls keep the storage dtype (bf16 on the
card, float32 accumulation in cuBLAS); norms, rope and the silu gate run in
float32 and cast back, as in the JAX package.

Attention runs the fused CUDA kernels when the tensors are on the card and
the kernels support the shape (``cfg.flash=None``): ``sofa_flash_fwd``
forward, ``sofa_flash_bwd_kv`` and ``sofa_flash_bwd_dq`` under autograd.
``cfg.flash=False`` runs the plain materialized-score attention.  Training
is ``loss_fn`` under ``make_train_step`` (AdamW with optax's ``adamw``
defaults), with per-layer remat through ``torch.utils.checkpoint``.

With a mesh (``common.make_mesh(("data", "seq", "model"), ...)``) every
rank is handed the global token rows and keeps its own: its slice of the
batch over "data" and its shard of the sequence over "seq" (the zig-zag
chunks with ``cfg.zigzag``), with global rope positions.  A "seq" axis
above 1 runs ring attention: the fused kernels on every hop
(``ring_flash.py``; zig-zag with ``cfg.zigzag``), or the plain ring
(``ring_attention.py``).  The loss is the mean over the global tokens:
each rank divides its nll sum by the global count, and the step
all-reduces (sums) the gradients and the printed loss over the ranks.
The "model" axis (tensor parallelism, the vocab-sharded embedding) and
FSDP are not ported: a size other than 1 raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from sofa_tpu_torch.workloads.flash_cuda import (
    flash_causal_attention,
    flash_causal_segmented_attention,
    supports as flash_supports,
)
from sofa_tpu_torch.workloads.common import axis_index, axis_size, mesh_ring
from sofa_tpu_torch.workloads.ring_attention import (
    plain_causal_attention,
    plain_segmented_causal_attention,
    ring_attention_local,
)
from sofa_tpu_torch.workloads.ring_flash import (
    ring_flash_attention_local,
    zigzag_indices,
    zigzag_ring_flash_attention_local,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 1408
    max_seq: int = 1024
    dtype: Any = torch.bfloat16
    rope_theta: float = 500000.0
    # None = auto: the fused CUDA kernel when the tensors are on the card and
    # it supports the shape; False forces the plain path; True demands the
    # fused path (the kernel on CUDA, its plain version on the CPU).
    flash: Optional[bool] = None
    # Load-balanced causal sequence parallelism: shard r holds the zig-zag
    # chunks (r, 2S-1-r) so that every shard does equal work around the
    # ring.  Takes the fused path only; the plain ring ignores it.
    zigzag: bool = False
    # Rematerialize each layer in the backward pass (a non-reentrant
    # torch.utils.checkpoint per layer): live activation memory drops to
    # one layer's worth plus the residual stream, at about one forward
    # replay of FLOPs.  `remat_policy` names a policy of REMAT_POLICIES
    # (the JAX checkpoint policy of the same name) and implies remat.
    remat: bool = False
    remat_policy: Optional[str] = None

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def llama3_8b() -> "TransformerConfig":
        return TransformerConfig(vocab=128256, d_model=4096, n_layers=32,
                                 n_heads=32, n_kv_heads=8, d_ff=14336,
                                 max_seq=8192)

    @staticmethod
    def tiny(seq: int = 128) -> "TransformerConfig":
        return TransformerConfig(vocab=256, d_model=64, n_layers=2,
                                 n_heads=4, n_kv_heads=2, d_ff=128,
                                 max_seq=seq)


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Stacked-layer param dict; per-layer leaves are [n_layers, ...].

    Normal(0, fan_in^-0.5) weights drawn in float32 from a seeded
    ``torch.Generator`` on ``device`` and cast to ``cfg.dtype``; norms are
    ones.  (The JAX package's init draws other numbers from the same seed:
    cross-package tests carry one init over with ``convert``.)"""
    device = torch.device("cpu") if device is None else torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, h, kvh, dh, f, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.d_head, cfg.d_ff, cfg.n_layers)

    def norm(*shape):
        fan_in = shape[-2] if len(shape) > 1 else shape[-1]
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return w.mul_(fan_in ** -0.5).to(cfg.dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    return {
        "embed": norm(cfg.vocab, d),
        "layers": {
            "attn_norm": ones(L, d),
            "wq": norm(L, d, h * dh),
            "wk": norm(L, d, kvh * dh),
            "wv": norm(L, d, kvh * dh),
            "wo": norm(L, h * dh, d),
            "mlp_norm": ones(L, d),
            "w1": norm(L, d, f),
            "w3": norm(L, d, f),
            "w2": norm(L, f, d),
        },
        "final_norm": ones(d),
        "lm_head": norm(d, cfg.vocab),
    }


def layer_params(params: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    """Layer i's slice of the stacked per-layer leaves."""
    return {name: w[i] for name, w in params["layers"].items()}


def _rmsnorm(x, w):
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + 1e-6)
    return (y * w).to(x.dtype)


def _rope(x, positions, theta):
    """Rotary embedding over [B, T, H, D]; pairs are (x[..., :D/2], x[..., D/2:])."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d // 2, dtype=torch.float32,
                                    device=x.device) / (d // 2))
    angles = positions[:, :, None, None].float() * freqs   # [B,T,1,D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def layer_body(x, lp, cfg: TransformerConfig, positions, attn):
    """One decoder layer, parameterized by the attention implementation.

    ``attn(q, kk, v) -> o`` receives *unrepeated* KV heads ([B, T, KVH, Dh])
    so the KV-cache attention (workloads/inference.py) stores them compactly.
    The single copy of the layer math keeps forward() and the inference
    block numerically identical by construction."""
    b, t = x.shape[:2]
    h = _rmsnorm(x, lp["attn_norm"])
    q = (h @ lp["wq"]).reshape(b, t, cfg.n_heads, cfg.d_head)
    kk = (h @ lp["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.d_head)
    v = (h @ lp["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.d_head)
    q = _rope(q, positions, cfg.rope_theta)
    kk = _rope(kk, positions, cfg.rope_theta)
    o = attn(q, kk, v)
    x = x + o.reshape(b, t, -1) @ lp["wo"]
    h = _rmsnorm(x, lp["mlp_norm"])
    gate = F.silu((h @ lp["w1"]).float()).to(cfg.dtype)
    return x + (gate * (h @ lp["w3"])) @ lp["w2"]


def _segment_positions(segment_ids):
    """Rope positions that restart at each packed document: global index
    minus the running max of segment-start indices."""
    b, t = segment_ids.shape
    idx = torch.arange(t, device=segment_ids.device).expand(b, t)
    is_start = torch.cat(
        [torch.ones((b, 1), dtype=torch.bool, device=segment_ids.device),
         segment_ids[:, 1:] != segment_ids[:, :-1]], dim=1)
    starts = torch.where(is_start, idx, torch.zeros_like(idx))
    return idx - torch.cummax(starts, dim=1).values


def use_flash(cfg: TransformerConfig, t: int, device: torch.device) -> bool:
    """Whether forward() takes the fused attention path."""
    on_card = device.type == "cuda"
    if cfg.flash is None:
        return on_card and flash_supports(t, cfg.d_head)
    if cfg.flash and on_card and not flash_supports(t, cfg.d_head):
        raise ValueError(
            f"flash=True but the CUDA kernel does not support seq len {t} "
            f"with head dim {cfg.d_head}")
    return cfg.flash


def _save_matmuls(ctx, op, *args, **kwargs):
    """JAX's dots_with_no_batch_dims_saveable: keep the outputs of matrix
    products without batch dims (the weight matmuls, aten.mm), recompute
    everything else (norms, rope, silu, the batched attention einsums)."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


#: Named remat policies (``TransformerConfig.remat_policy``).
REMAT_POLICIES = {"dots_with_no_batch_dims_saveable": _save_matmuls}


def _remat_context_fn(policy: Optional[str]):
    """checkpoint's ``context_fn`` for a named policy (None: save nothing
    but the layer's inputs)."""
    if policy is None:
        return None
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; supported: "
                         f"{sorted(REMAT_POLICIES)}")
    return functools.partial(create_selective_checkpoint_contexts,
                             REMAT_POLICIES[policy])


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Where this rank's tokens sit in the global batch, and how its
    attention runs: ``rows`` of the batch, ``cols`` (global positions, in
    local order) of the sequence, the "seq" ring or None, the fused path,
    zig-zag."""

    rows: slice
    cols: torch.Tensor
    ring: Any
    fused: bool
    zigzag: bool
    #: whether ``cols`` ends at the sequence's last position (no target)
    ends: bool


def _layout(cfg: TransformerConfig, b: int, t: int, mesh,
            device: torch.device) -> _Layout:
    if axis_size(mesh, "model") != 1:
        raise ValueError(
            "the 'model' mesh axis (tensor parallelism, the vocab-sharded "
            "embedding) and FSDP are not ported yet (ROADMAP.md Queue 1 "
            "item 5): give the mesh a 'model' size of 1")
    dn, sn = axis_size(mesh, "data"), axis_size(mesh, "seq")
    if b % dn or t % sn:
        raise ValueError(f"batch {b} and sequence {t} must divide over the "
                         f"mesh's data {dn} and seq {sn} axes")
    di, si = axis_index(mesh, "data"), axis_index(mesh, "seq")
    use_ring = sn > 1
    t_local = t // sn
    # zig-zag runs the kernels per half-chunk: check that size
    fused = use_flash(cfg, t_local // 2 if cfg.zigzag and use_ring
                      else t_local, device)
    zigzag = cfg.zigzag and use_ring and fused
    if zigzag:
        perm, _ = zigzag_indices(t, sn)
        cols = torch.from_numpy(perm[si * t_local:(si + 1) * t_local])
    else:
        cols = torch.arange(si * t_local, (si + 1) * t_local)
    # in every layout, the position t - 1 is the last local one
    return _Layout(slice(di * (b // dn), (di + 1) * (b // dn)),
                   cols.to(device), mesh_ring(mesh, "seq") if use_ring
                   else None, fused, zigzag, int(cols[-1]) == t - 1)


def forward(params, tokens, cfg: TransformerConfig,
            segment_ids: Optional[torch.Tensor] = None,
            mesh=None) -> torch.Tensor:
    """Logits in float32: [B, T, vocab] without a mesh (or on one rank).

    ``segment_ids`` [B, T] packs several documents per row: attention is
    masked within segments and rope positions restart at each segment, so a
    packed batch matches processing the documents separately.  Ids must be
    contiguous runs along T; not supported with sequence parallelism.
    Differentiable: with params that require grad, the fused path's
    backward runs the two backward kernels.

    With a ``mesh``, ``tokens`` (and ``segment_ids``) are the global batch,
    the same on every rank, and the logits are this rank's: its rows over
    "data" and its positions over "seq" ([B / data, T / seq, vocab]), in
    zig-zag order when ``cfg.zigzag`` takes the fused ring."""
    b, t = tokens.shape
    return _logits(params, tokens, cfg, segment_ids,
                   _layout(cfg, b, t, mesh, tokens.device))


def _logits(params, tokens, cfg: TransformerConfig, segment_ids, lay):
    b, t = tokens.shape
    if t > cfg.max_seq:
        raise ValueError(f"sequence length {t} exceeds max_seq {cfg.max_seq}")
    if segment_ids is None:
        positions = torch.arange(t, device=tokens.device).expand(b, t)
    else:
        positions = _segment_positions(segment_ids)
    if segment_ids is not None and lay.ring is not None:
        raise ValueError("segment_ids are not supported with the "
                         "sequence-parallel (ring) path yet")
    fused, ring = lay.fused, lay.ring
    # global rope positions at the rank's own tokens
    tokens = tokens[lay.rows][:, lay.cols]
    positions = positions[lay.rows][:, lay.cols]
    if segment_ids is not None:
        segment_ids = segment_ids[lay.rows]

    def attn(q, kk, v):
        if fused:
            if ring is not None:
                if lay.zigzag:
                    return zigzag_ring_flash_attention_local(q, kk, v, ring)
                return ring_flash_attention_local(q, kk, v, ring)
            if segment_ids is not None:
                return flash_causal_segmented_attention(q, kk, v, segment_ids)
            return flash_causal_attention(q, kk, v)
        rep = cfg.n_heads // cfg.n_kv_heads
        kk = kk.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        if ring is not None:
            return ring_attention_local(q, kk, v, ring)
        if segment_ids is not None:
            return plain_segmented_causal_attention(q, kk, v, segment_ids)
        return plain_causal_attention(q, kk, v)

    def layer(x, i):
        return layer_body(x, layer_params(params, i), cfg, positions, attn)

    if cfg.remat or cfg.remat_policy:
        # a named policy implies remat, as in the JAX package
        context_fn = _remat_context_fn(cfg.remat_policy)
        kw = {} if context_fn is None else {"context_fn": context_fn}
        layer = functools.partial(checkpoint, layer, use_reentrant=False,
                                  **kw)

    x = params["embed"].to(cfg.dtype)[tokens]
    for i in range(cfg.n_layers):
        x = layer(x, i)
    x = _rmsnorm(x, params["final_norm"])
    return (x @ params["lm_head"]).float()


def loss_fn(params, tokens, cfg: TransformerConfig,
            segment_ids: Optional[torch.Tensor] = None,
            mesh=None) -> torch.Tensor:
    """Next-token cross entropy; targets are tokens shifted left.

    The forward sees the full sequence and the last position's logits are
    dropped.  With ``segment_ids`` (packed documents), positions whose
    target falls in a DIFFERENT segment are excluded and the mean runs over
    the kept positions, so a packed batch's loss equals the token-weighted
    mean of the documents' separate losses.

    With a ``mesh`` the result is this rank's share of the global mean:
    its nll sum over the global count, so that the ranks' values sum to
    the global loss (and their gradients to its gradient); on one rank,
    or without a mesh, that is the mean itself.  A shard's targets come
    from the global rows, across shard boundaries."""
    b, t = tokens.shape
    lay = _layout(cfg, b, t, mesh, tokens.device)
    logits = _logits(params, tokens, cfg, segment_ids, lay)
    cols = lay.cols
    if lay.ends:
        logits, cols = logits[:, :-1], cols[:-1]
    targets = tokens[lay.rows][:, cols + 1].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = logz - gold
    if segment_ids is None:
        # the mean times this shard's share: exactly the mean on one rank
        return nll.mean() * (nll.numel() / (b * (t - 1)))
    seg = segment_ids[lay.rows]
    keep = (seg[:, cols + 1] == seg[:, cols]).to(nll.dtype)
    count = (segment_ids[:, 1:] == segment_ids[:, :-1]).sum().clamp_min(1)
    return (nll * keep).sum() / count


def param_leaves(params):
    """Every tensor of a (nested) param dict, in key order."""
    for v in params.values():
        if isinstance(v, dict):
            yield from param_leaves(v)
        else:
            yield v


def make_optimizer(params, learning_rate: float = 1e-3
                   ) -> torch.optim.AdamW:
    """AdamW over every leaf with ``optax.adamw``'s defaults: betas
    (0.9, 0.999), eps 1e-8 and weight decay 1e-4 (torch's default is 1e-2)
    on every leaf, norms included.  The moments take each leaf's own dtype.
    Marks the leaves as requiring grad; the step updates them in place."""
    leaves = [p.requires_grad_(True) for p in param_leaves(params)]
    return torch.optim.AdamW(leaves, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def make_train_step(cfg: TransformerConfig, params,
                    learning_rate: float = 1e-3, mesh=None):
    """(optimizer, step) with step(params, opt, tokens, segment_ids=None)
    -> (params, opt, loss): one loss_fn forward and backward and one AdamW
    update of ``params`` in place (the JAX step returns new arrays).  With
    a ``mesh``, the gradients and the loss are all-reduced (summed) over
    every rank (the data x seq group: the "model" axis is 1) before the
    update, so every rank applies the same one."""
    opt = make_optimizer(params, learning_rate)
    leaves = list(param_leaves(params))

    def step(params, opt, tokens, segment_ids=None):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, cfg, segment_ids, mesh=mesh)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            import torch.distributed as dist

            for p in leaves:
                dist.all_reduce(p.grad)
            dist.all_reduce(loss)
        opt.step()
        return params, opt, loss

    return opt, step


def build(cfg: TransformerConfig, batch: int, seq: int, seed: int = 0,
          device=None, mesh=None):
    """(params, optimizer, step, tokens): init params, the train step and a
    batch of random tokens, all from ``seed`` on ``device`` (the card
    unless the caller names another).  With a ``mesh``, every rank draws
    the same params and the same global tokens (the step keeps its own
    shard of them)."""
    from sofa_tpu_torch.workloads.common import resolve_device

    device = resolve_device(device)
    _layout(cfg, batch, seq, mesh, device)          # raises on a bad mesh
    params = init_params(cfg, seed, device)
    opt, step = make_train_step(cfg, params, mesh=mesh)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=device)
    return params, opt, step, tokens


def main(argv=None):
    """The JAX workload's ``main``: train ``--steps`` steps (after two
    warm-up steps) and print the rate, the last loss and every step's
    loss.  Under torchrun, or with ``--data`` / ``--seq_par`` /
    ``--model``, the ranks form a ("data", "seq", "model") mesh
    (``--backend``, default nccl on the card; ``--share_device`` lets the
    ranks of a host share its card, over gloo); each rank prints its
    lines."""
    import os

    from sofa_tpu_torch.workloads.common import (init_distributed,
                                                 make_mesh,
                                                 parse_workload_args,
                                                 steps_per_sec)

    args = parse_workload_args(argv, {
        "batch": 8, "seq": 512, "steps": 10, "d_model": 512, "n_layers": 4,
        "n_heads": 8, "n_kv_heads": 4, "d_ff": 1408, "vocab": 32000,
        "device": None, "data": 0, "seq_par": 0, "model": 0,
        "backend": None, "share_device": False,
    })
    cfg = TransformerConfig(vocab=args.vocab, d_model=args.d_model,
                            n_layers=args.n_layers, n_heads=args.n_heads,
                            n_kv_heads=args.n_kv_heads, d_ff=args.d_ff,
                            max_seq=args.seq)
    mesh, device, tag = None, args.device, ""
    if "WORLD_SIZE" in os.environ or args.data or args.seq_par or args.model:
        info = init_distributed(args.backend, args.device, args.share_device)
        sizes = None
        if args.data or args.seq_par or args.model:
            sizes = [args.data or 1, args.seq_par or 1, args.model or 1]
        mesh = make_mesh(("data", "seq", "model"), sizes,
                         device_type=info.device.type)
        device, tag = info.device, f"rank {info.rank} "
    params, opt, step, tokens = build(cfg, args.batch, args.seq,
                                      device=device, mesh=mesh)
    losses = []

    def one(state):
        p, o, _ = state
        p, o, loss = step(p, o, tokens)
        losses.append(loss)
        return p, o, loss

    sps, state = steps_per_sec(one, (params, opt, None), args.steps)
    toks = sps * args.batch * args.seq
    where = (f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
             f"backend={info.backend}" if mesh is not None
             else f"device={tokens.device}")
    print(f"transformer: {tag}{sps:.3f} steps/s  {toks:,.0f} tokens/s  "
          f"loss={float(state[2]):.3f}  {where}")
    print(f"transformer: {tag}losses (warm-up first) "
          + " ".join(repr(x.item()) for x in losses), flush=True)
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
