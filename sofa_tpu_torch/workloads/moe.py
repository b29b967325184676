"""Switch-style Mixture-of-Experts decoder with expert parallelism.

The counterpart of ``sofa_tpu/workloads/moe.py``, and the port's
all-to-all traffic generator: two ``all_to_all_single`` exchanges per MoE
layer over the mesh's "expert" axis (``common.all_to_all``, whose
gradient is the same exchange), so the profiler's comm passes have an
expert-parallel workload to observe.

Top-1 (Switch) routing with a static capacity per expert: dispatch and
combine are dense one-hot contractions over fixed shapes; tokens past an
expert's capacity are dropped (the Switch aux loss pushes the router
toward balance).  Experts shard over "expert", each rank holding
``n_experts / expert`` of them; outside the MoE block the tokens ride
(data x expert) as one flat batch dimension: rank r of the row-major
("data", "expert") mesh holds rows [r B / n, (r + 1) B / n) of the global
batch.  The router stays float32; the dispatch gather and the combine run
in the storage dtype (the {0, 1} one-hot is exact in bf16), and the gate
scales the combined rows in float32 after it.  (The JAX package's
``upcast`` switch, a workaround for XLA:CPU's bf16 batched dots, is not
carried over: the CPU tests run float32.)

With a mesh, each rank's loss is its share of the global loss: its nll
sum over the global count plus its aux over the number of ranks, so that
the step's all-reduce (sum) over every rank gives the JAX package's loss,
whose aux is averaged over the expert group and then over data.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from sofa_tpu_torch.workloads.common import (AxisGroup, all_reduce_axes,
                                             all_to_all, axis_size,
                                             mesh_axis)
from sofa_tpu_torch.workloads.ring_attention import plain_causal_attention
from sofa_tpu_torch.workloads.transformer import _rmsnorm


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab: int = 8192
    d_model: int = 256
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 512
    n_experts: int = 8
    capacity_factor: float = 1.25
    max_seq: int = 512
    dtype: Any = torch.bfloat16
    router_aux_weight: float = 0.01

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def tiny(n_experts: int = 4) -> "MoEConfig":
        return MoEConfig(vocab=256, d_model=32, n_layers=2, n_heads=2,
                         d_ff=64, n_experts=n_experts, max_seq=64)


def init_params(cfg: MoEConfig, seed: int = 0,
                device: Optional[torch.device] = None,
                mesh=None) -> Dict[str, Any]:
    """Stacked-layer param dict ([n_layers, ...] per-layer leaves), drawn
    as ``transformer.init_params`` draws (the router in float32, scaled by
    d^-0.5, never cast).  With a ``mesh``, this rank's experts of the same
    global init (``param_specs``)."""
    from sofa_tpu_torch.convert import shard_tree

    device = torch.device("cpu") if device is None else torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, f, e, n = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.n_layers

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32)

    def norm(*shape):
        fan_in = shape[-2] if len(shape) > 1 else shape[-1]
        return randn(*shape).mul_(fan_in ** -0.5).to(cfg.dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    params = {
        "embed": norm(cfg.vocab, d),
        "layers": {
            "attn_norm": ones(n, d),
            "wqkv": norm(n, d, 3 * d),
            "wo": norm(n, d, d),
            "moe_norm": ones(n, d),
            "router": randn(n, d, e).mul_(d ** -0.5),
            "w_up": norm(n, e, d, f),
            "w_down": norm(n, e, f, d),
        },
        "final_norm": ones(d),
        "lm_head": norm(d, cfg.vocab),
    }
    if mesh is None:
        return params
    return shard_tree(params, param_specs(cfg),
                      {"expert": (mesh_axis(mesh, "expert").index,
                                  axis_size(mesh, "expert"))})


def param_specs(cfg: MoEConfig) -> Dict[str, Any]:
    """Experts shard over "expert"; everything else is replicated."""
    return {
        "embed": (None, None),
        "layers": {
            "attn_norm": (None, None),
            "wqkv": (None, None, None),
            "wo": (None, None, None),
            "moe_norm": (None, None),
            "router": (None, None, None),
            "w_up": (None, "expert", None, None),
            "w_down": (None, "expert", None, None),
        },
        "final_norm": (None,),
        "lm_head": (None, None),
    }


def _dispatch_tensors(logits, n_experts: int, capacity: int):
    """Top-1 routing -> (dispatch [N, E, C] one-hot, combine [N, E, C],
    gate [N] float32, aux).

    A token's slot in its expert's buffer is its rank among the tokens
    routed there (a cumsum); ranks >= capacity are dropped.  combine ==
    dispatch * gate[n]: callers use the factorized form (the exact {0, 1}
    gather in the storage dtype, then the gate as a float32 scale)."""
    probs = torch.softmax(logits.float(), dim=-1)                  # [N, E]
    expert = probs.argmax(dim=-1)                                  # [N]
    gate = probs.gather(1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, n_experts).float()                  # [N, E]
    pos = (onehot.cumsum(dim=0) - 1.0) * onehot                    # [N, E]
    keep = (pos < capacity).float() * onehot
    # a slot past the capacity has no one-hot column (all zero, as
    # jax.nn.one_hot gives it; F.one_hot would raise)
    slots = torch.arange(capacity, device=logits.device)
    pos_oh = (pos.sum(-1).long()[:, None] == slots).float()        # [N, C]
    dispatch = keep[:, :, None] * pos_oh[:, None, :]               # [N, E, C]
    combine = dispatch * gate[:, None, None]
    # Switch aux loss: E * sum_e(fraction dispatched_e * mean prob_e)
    frac = onehot.mean(dim=0)
    aux = n_experts * (frac * probs.mean(dim=0)).sum()
    return dispatch, combine, gate, aux


def _expert_ffn(xs, w_up, w_down, dtype):
    """Per-expert gelu (tanh) MLP over dispatched slots: xs [..., E, C, D]
    in ``dtype``, w_up [E, D, F], w_down [E, F, D]; the activation in
    float32, returned to ``dtype``."""
    h = torch.einsum("...ecd,edf->...ecf", xs, w_up.to(dtype))
    h = F.gelu(h.float(), approximate="tanh").to(dtype)
    return torch.einsum("...ecf,efd->...ecd", h, w_down.to(dtype))


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    return max(1, int(math.ceil(n_tokens / cfg.n_experts
                                * cfg.capacity_factor)))


def moe_ffn_dense(x, router_w, w_up, w_down, cfg: MoEConfig):
    """Single-device reference: every expert runs on its slots.  x [N, D];
    returns (out [N, D] in x's dtype, aux)."""
    capacity = _capacity(x.shape[0], cfg)
    logits = x.float() @ router_w                                  # [N, E]
    dispatch, _, gate, aux = _dispatch_tensors(logits, cfg.n_experts,
                                               capacity)
    xs = torch.einsum("nec,nd->ecd", dispatch.to(cfg.dtype),
                      x.to(cfg.dtype))                             # [E, C, D]
    ys = _expert_ffn(xs, w_up, w_down, cfg.dtype)
    # factorized combine: exact {0,1} gather in the storage dtype, then
    # the float32 gate
    out = torch.einsum("nec,ecd->nd", dispatch.to(cfg.dtype),
                       ys).float() * gate[:, None]
    return out.to(x.dtype), aux


def moe_ffn_expert_parallel(x, router_w, w_up, w_down, cfg: MoEConfig,
                            ax: AxisGroup):
    """Expert-parallel MoE block over ``ax`` (the "expert" axis): x
    [N_local, D] this rank's tokens, w_up / w_down [E_local, ...] this
    rank's experts (expert e lives on rank e // E_local).  Two all-to-alls:
    the slots out to their experts' ranks, the results back.  Returns
    (out, this rank's aux)."""
    shards, e_local = ax.size, w_up.shape[0]
    d = x.shape[1]
    capacity = _capacity(x.shape[0], cfg)
    logits = x.float() @ router_w
    dispatch, _, gate, aux = _dispatch_tensors(logits, cfg.n_experts,
                                               capacity)
    xs = torch.einsum("nec,nd->ecd", dispatch.to(cfg.dtype),
                      x.to(cfg.dtype))
    # [E, C, D] -> [S, E_local, C, D]; block s goes to rank s, and block s
    # of the result is rank s's tokens for this rank's experts
    xs = all_to_all(xs.reshape(shards, e_local, capacity, d), ax)
    ys = all_to_all(_expert_ffn(xs, w_up, w_down, cfg.dtype), ax)
    ys = ys.reshape(cfg.n_experts, capacity, d)
    out = torch.einsum("nec,ecd->nd", dispatch.to(cfg.dtype),
                       ys).float() * gate[:, None]
    return out.to(x.dtype), aux


@dataclasses.dataclass(frozen=True)
class _Layout:
    """This rank's ``rows`` of the global batch (the flat data x expert
    shard) and its expert axis (size 1: the dense path)."""

    rows: slice
    expert: AxisGroup
    ranks: int


def _layout(cfg: MoEConfig, b: int, mesh) -> _Layout:
    n = axis_size(mesh, "data") * axis_size(mesh, "expert")
    ax = mesh_axis(mesh, "expert")
    if ax.size > 1 and cfg.n_experts % ax.size:
        raise ValueError(f"n_experts {cfg.n_experts} must divide over the "
                         f"expert axis ({ax.size})")
    if b % n:
        raise ValueError(f"batch {b} must divide over the mesh's data x "
                         f"expert ranks ({n})")
    r = mesh_axis(mesh, "data").index * ax.size + ax.index
    return _Layout(slice(r * b // n, (r + 1) * b // n), ax, n)


def _forward(params, tokens, cfg: MoEConfig, lay: _Layout):
    """(logits of this rank's rows [B / n, T, vocab], this rank's aux mean
    over the layers)."""
    tokens = tokens[lay.rows]
    b, t = tokens.shape
    x = params["embed"].to(cfg.dtype)[tokens]
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        lp = {name: w[i] for name, w in params["layers"].items()}
        h = _rmsnorm(x, lp["attn_norm"])
        qkv = (h @ lp["wqkv"]).reshape(b, t, 3, cfg.n_heads, cfg.d_head)
        o = plain_causal_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        x = x + o.reshape(b, t, -1) @ lp["wo"]
        flat = _rmsnorm(x, lp["moe_norm"]).reshape(b * t, cfg.d_model)
        if lay.expert.size > 1:
            y, aux = moe_ffn_expert_parallel(flat, lp["router"], lp["w_up"],
                                             lp["w_down"], cfg, lay.expert)
        else:
            y, aux = moe_ffn_dense(flat, lp["router"], lp["w_up"],
                                   lp["w_down"], cfg)
        x = x + y.reshape(b, t, cfg.d_model)
        aux_sum = aux_sum + aux
    x = _rmsnorm(x, params["final_norm"])
    return (x @ params["lm_head"]).float(), aux_sum / cfg.n_layers


def forward(params, tokens, cfg: MoEConfig, mesh=None):
    """(logits, aux).  Without a mesh: [B, T, vocab] and the dense path's
    aux over the whole batch.  With a ("data", "expert") mesh, ``tokens``
    is the global batch (the same on every rank), ``params`` this rank's
    experts: the logits of this rank's rows, and the aux averaged over
    every rank (each balances its own tokens, the Switch/GShard
    statistic), the same on every rank."""
    b = tokens.shape[0]
    lay = _layout(cfg, b, mesh)
    logits, aux = _forward(params, tokens, cfg, lay)
    if mesh is not None:
        aux = all_reduce_axes(aux.detach().clone(), mesh,
                              ("data", "expert")) / lay.ranks
    return logits, aux


def loss_fn(params, tokens, cfg: MoEConfig, mesh=None):
    """Next-token cross entropy plus ``router_aux_weight`` x aux.  With a
    mesh, this rank's share: its nll sum over the global count plus its
    aux over the number of ranks (the step sums the shares)."""
    b, t = tokens.shape
    lay = _layout(cfg, b, mesh)
    logits, aux = _forward(params, tokens, cfg, lay)
    logits = logits[:, :-1]
    targets = tokens[lay.rows][:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (logz - gold).sum() / (b * (t - 1))
    return nll + cfg.router_aux_weight * aux / lay.ranks


def make_train_step(cfg: MoEConfig, params, learning_rate: float = 3e-4,
                    mesh=None):
    """(optimizer, step) with step(params, opt, tokens) -> (params, opt,
    loss): AdamW with optax's ``adamw`` defaults (``transformer.
    make_optimizer``) at the JAX workload's 3e-4.  With a mesh the
    gradients of the replicated leaves and the loss are summed over every
    rank, an expert leaf's over "data" only (its expert group holds
    other experts)."""
    from sofa_tpu_torch.workloads.transformer import sharded_step

    return sharded_step(params, param_specs(cfg), mesh, ("data", "expert"),
                        lambda p, tokens: loss_fn(p, tokens, cfg, mesh),
                        learning_rate)


def build(cfg: MoEConfig, batch: int, seq: int, seed: int = 0, device=None,
          mesh=None):
    """(params, optimizer, step, tokens) from ``seed`` on ``device`` (the
    card unless the caller names another); with a mesh, this rank's
    experts of the global init and the global tokens."""
    from sofa_tpu_torch.workloads.common import resolve_device

    device = resolve_device(device)
    _layout(cfg, batch, mesh)                       # raises on a bad mesh
    params = init_params(cfg, seed, device, mesh)
    opt, step = make_train_step(cfg, params, mesh=mesh)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=device)
    return params, opt, step, tokens


def main(argv=None):
    """The JAX workload's ``main``: train ``--steps`` steps after two
    warm-up steps and print the rate, the last loss and every step's
    loss.  Under torchrun, or with ``--data`` / ``--expert``, the ranks
    form a ("data", "expert") mesh (one flag set: the other axis takes the
    rest; ``--backend``, ``--share_device`` as the transformer's), with
    ``n_experts`` rounded up to a multiple of the expert axis; one rank
    runs the dense path."""
    import os

    from sofa_tpu_torch.workloads.common import (init_distributed,
                                                 make_mesh,
                                                 parse_workload_args,
                                                 steps_per_sec)

    args = parse_workload_args(argv, {
        "batch": 8, "seq": 256, "steps": 10, "d_model": 256, "n_layers": 2,
        "n_heads": 4, "d_ff": 512, "n_experts": 8, "vocab": 8192,
        "device": None, "data": 0, "expert": 0, "backend": None,
        "share_device": False,
    })
    cfg = MoEConfig(vocab=args.vocab, d_model=args.d_model,
                    n_layers=args.n_layers, n_heads=args.n_heads,
                    d_ff=args.d_ff, n_experts=args.n_experts,
                    max_seq=args.seq)
    mesh, device, tag = None, args.device, ""
    if "WORLD_SIZE" in os.environ or args.data or args.expert:
        info = init_distributed(args.backend, args.device, args.share_device)
        sizes = None
        if args.data or args.expert:
            sizes = (args.data or -1, args.expert or -1)
        mesh = make_mesh(("data", "expert"), sizes,
                         device_type=info.device.type)
        device, tag = info.device, f"rank {info.rank} "
        ep = axis_size(mesh, "expert")
        if cfg.n_experts % ep:
            bumped = ep * -(-cfg.n_experts // ep)
            print(f"moe: rounding n_experts {cfg.n_experts} -> {bumped} "
                  f"(multiple of expert axis {ep})")
            cfg = dataclasses.replace(cfg, n_experts=bumped)
    params, opt, step, tokens = build(cfg, args.batch, args.seq,
                                      device=device, mesh=mesh)
    losses = []

    def one(state):
        p, o, _ = state
        p, o, loss = step(p, o, tokens)
        losses.append(loss)
        return p, o, loss

    sps, state = steps_per_sec(one, (params, opt, None), args.steps)
    mesh_desc = (dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh
                 is not None else {"single": 1})
    print(f"moe: {tag}{sps:.3f} steps/s  "
          f"{sps * args.batch * args.seq:,.0f} tokens/s  "
          f"loss={float(state[2]):.3f}  mesh={mesh_desc}")
    print(f"moe: {tag}losses (warm-up first) "
          + " ".join(repr(x.item()) for x in losses), flush=True)
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
