"""Pipeline-parallel transformer training over a "stage" mesh axis.

The counterpart of ``sofa_tpu/workloads/pipeline.py``: GPipe microbatch
pipelining.  The layer params shard over "stage" (each rank owns
``layers_per_stage`` consecutive layers), microbatched activations flow
stage to stage, and the schedule is M + S - 1 ticks in which every stage
computes every tick (bubbles at the ramp ends included), as the JAX scan
does.  The stage-to-stage exchange is the JAX ``fwd_perm``, a rotation to
the next rank: ``common.Ring.rotate`` over the stage group, whose
gradient rotates the other way, so autograd's backward is the backward
pipeline.

The tick is a body, ``tick(t, s, S, state) -> state`` (``make_tick``),
with two schedules, as in ``ring_flash.py``:

* ``run_ticks``: this rank's ticks, its carry rotated to the next stage
  after each (P2P over the stage group);
* ``run_lockstep``: every stage's tick t in one process, then the carries
  roll one stage on: the schedule on one card, where gloo has no P2P for
  CUDA tensors.

Only the exchange differs.  Every branch of a tick is a tensor select
(JAX's ``jnp.where``), so every stage runs the same operations and the
same exchanges forward and backward.  The loss is taken on the last stage
(zero elsewhere), summed over "stage" and averaged over "data".
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from sofa_tpu_torch.workloads.common import axis_size, mesh_axis, mesh_ring
from sofa_tpu_torch.workloads.ring_attention import plain_causal_attention
from sofa_tpu_torch.workloads.transformer import _rmsnorm, _rope

State = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab: int = 8192
    d_model: int = 256
    n_heads: int = 4
    d_ff: int = 512
    layers_per_stage: int = 2
    n_microbatches: int = 4
    max_seq: int = 512
    dtype: Any = torch.bfloat16
    # a non-reentrant torch.utils.checkpoint per layer: each stage then
    # keeps one activation per in-flight microbatch and layer input
    remat: bool = False

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def tiny() -> "PipelineConfig":
        return PipelineConfig(vocab=256, d_model=32, n_heads=2, d_ff=64,
                              layers_per_stage=1, n_microbatches=2,
                              max_seq=64)


def init_params(cfg: PipelineConfig, n_layers: int, seed: int = 0,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """n_layers = stages x layers_per_stage; layer leaves are stacked on a
    leading dim that shards over "stage" (``param_specs``,
    ``stage_params``)."""
    device = torch.device("cpu") if device is None else torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, f, n = cfg.d_model, cfg.d_ff, n_layers

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
            "attn_norm": ones(n, d),
            "wqkv": norm(n, d, 3 * d),
            "wo": norm(n, d, d),
            "mlp_norm": ones(n, d),
            "w1": norm(n, d, f),
            "w2": norm(n, f, d),
        },
        "final_norm": ones(d),
        "lm_head": norm(d, cfg.vocab),
    }


def param_specs() -> Dict[str, Any]:
    """Layers shard over "stage"; everything else is replicated."""
    lp = ("stage", None, None)
    return {
        "embed": (None, None),
        "layers": {
            "attn_norm": ("stage", None),
            "wqkv": lp,
            "wo": lp,
            "mlp_norm": ("stage", None),
            "w1": lp,
            "w2": lp,
        },
        "final_norm": (None,),
        "lm_head": (None, None),
    }


def stage_params(params, stage: int, n_stages: int):
    """Stage ``stage``'s shard of global ``params`` (of ``n_stages``), by
    ``param_specs``."""
    from sofa_tpu_torch.convert import shard_tree

    return shard_tree(params, param_specs(), {"stage": (stage, n_stages)})


def _layer(x, lp, cfg: PipelineConfig, positions):
    b, t, _ = x.shape
    h = _rmsnorm(x, lp["attn_norm"])
    qkv = (h @ lp["wqkv"]).reshape(b, t, 3, cfg.n_heads, cfg.d_head)
    q = _rope(qkv[:, :, 0], positions, 500000.0)
    kk = _rope(qkv[:, :, 1], positions, 500000.0)
    o = plain_causal_attention(q, kk, qkv[:, :, 2])
    x = x + o.reshape(b, t, -1) @ lp["wo"]
    h = _rmsnorm(x, lp["mlp_norm"])
    gate = F.silu((h @ lp["w1"]).float()).to(cfg.dtype)
    return x + gate @ lp["w2"]


def _stage(x, stage_layers, cfg: PipelineConfig, positions):
    """This stage's stacked layers in order, each under remat with
    ``cfg.remat``."""
    layer = _layer
    if cfg.remat:
        layer = functools.partial(checkpoint, _layer, use_reentrant=False)
    for i in range(next(iter(stage_layers.values())).shape[0]):
        x = layer(x, {k: w[i] for k, w in stage_layers.items()}, cfg,
                  positions)
    return x


def _reference_forward(params, tokens, cfg: PipelineConfig):
    """Unpipelined twin: all layers in order (the tests' ground truth)."""
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    x = params["embed"].to(cfg.dtype)[tokens]
    x = _stage(x, params["layers"], cfg, positions)
    x = _rmsnorm(x, params["final_norm"])
    return (x @ params["lm_head"]).float()


def make_tick(params, tokens_local, cfg: PipelineConfig
              ) -> (Callable[[int, int, int, State], State]):
    """The tick body of one stage and its initial state.  Stage s at tick
    t runs its layers on microbatch t - s: stage 0 on the injected
    embedding, the others on the carry the previous stage sent; the last
    stage writes microbatch t - (S - 1) into ``outs``.  Every choice is a
    tensor select, so gradients reach every exchange on every stage."""
    b_loc, t_len = tokens_local.shape
    m = cfg.n_microbatches
    if b_loc % m:
        raise ValueError(f"local batch {b_loc} must divide into {m} "
                         f"microbatches")
    mbs = tokens_local.reshape(m, b_loc // m, t_len)
    positions = torch.arange(t_len, device=tokens_local.device).expand(
        b_loc // m, t_len)
    injected = params["embed"].to(cfg.dtype)[mbs]      # [M, mb_b, T, D]
    device = tokens_local.device

    def tick(t: int, s: int, n: int, state: State) -> State:
        first = torch.tensor(s == 0, device=device)
        x_in = torch.where(first, injected[min(max(t, 0), m - 1)],
                           state["carry"])
        y = _stage(x_in, params["layers"], cfg, positions)
        done = t - (n - 1)
        slot = min(max(done, 0), m - 1)
        write = torch.tensor(done >= 0 and s == n - 1, device=device)
        outs = state["outs"]
        outs = torch.cat([outs[:slot],
                          torch.where(write, y, outs[slot])[None],
                          outs[slot + 1:]])
        return {"carry": y, "outs": outs}

    zeros = torch.zeros_like(injected)
    return tick, {"carry": zeros[0], "outs": zeros}


def _stage_loss(params, tokens_local, outs, cfg: PipelineConfig, s: int,
                n: int):
    """The mean next-token loss of ``outs`` (rows in microbatch order ==
    ``tokens_local``'s) on the last stage, 0 on the others (the selected
    zero keeps the head in every stage's graph, as the JAX ``where``)."""
    b_loc, t_len = tokens_local.shape
    x = _rmsnorm(outs.reshape(b_loc, t_len, cfg.d_model),
                 params["final_norm"])
    logits = (x @ params["lm_head"]).float()[:, :-1]
    targets = tokens_local[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    last = torch.tensor(s == n - 1, device=logits.device)
    return torch.where(last, (logz - gold).mean(), torch.zeros((),
                       device=logits.device))


def run_ticks(tick, state: State, ring) -> State:
    """This stage's M + S - 1 ticks over ``ring`` (the stage group, a
    ``common.Ring``): after each, the carry goes to stage s + 1 and stage
    s - 1's arrives.  The last tick's carry is not sent (nothing reads
    it)."""
    n, s = ring.size, ring.index
    ticks = _n_ticks(state, n)
    for t in range(ticks):
        state = tick(t, s, n, state)
        if t < ticks - 1 and n > 1:
            state = {**state, "carry": ring.rotate([state["carry"]])[0]}
    return state


def _n_ticks(state: State, n: int) -> int:
    return state["outs"].shape[0] + n - 1


def run_lockstep(ticks: List, states: List[State]) -> List[State]:
    """Every stage's M + S - 1 ticks in one process: tick t of stages
    0..S-1 (``ticks[s]``, each stage's own body), then the carries roll
    one stage on, stage s taking stage s - 1's."""
    n = len(states)
    n_ticks = _n_ticks(states[0], n)
    for t in range(n_ticks):
        states = [tick(t, s, n, st)
                  for s, (tick, st) in enumerate(zip(ticks, states))]
        if t < n_ticks - 1:
            states = [{**st, "carry": states[(s - 1) % n]["carry"]}
                      for s, st in enumerate(states)]
    return states


def _rows(b: int, mesh) -> slice:
    dn = axis_size(mesh, "data")
    if b % dn:
        raise ValueError(f"batch {b} must divide over the mesh's data axis "
                         f"({dn})")
    di = mesh_axis(mesh, "data").index
    return slice(di * b // dn, (di + 1) * b // dn)


def pipeline_loss(params, tokens, cfg: PipelineConfig, mesh):
    """This rank's share of the mean next-token loss computed through the
    S-stage pipeline on ``mesh`` (("data", "stage")): ``params`` are this
    stage's (``stage_params``), ``tokens`` the global batch.  The last
    stage's mean over its data shard, divided by the data size; 0 on the
    other stages: the step's sum over every rank is the JAX package's
    ``pipeline_loss`` (a psum over "stage", a pmean over "data")."""
    tokens_local = tokens[_rows(tokens.shape[0], mesh)]
    ring = mesh_ring(mesh, "stage")
    tick, state = make_tick(params, tokens_local, cfg)
    state = run_ticks(tick, state, ring)
    return _stage_loss(params, tokens_local, state["outs"], cfg, ring.index,
                       ring.size) / axis_size(mesh, "data")


def lockstep_loss(stages: List[Dict[str, Any]], tokens_local,
                  cfg: PipelineConfig) -> List[torch.Tensor]:
    """The per-stage losses of one data shard's pipeline with every stage
    in this process (``run_lockstep``): ``stages[s]`` is stage s's params
    (its own leaves, so each stage's gradients stay its own).  Their sum
    is that shard's mean loss."""
    n = len(stages)
    made = [make_tick(p, tokens_local, cfg) for p in stages]
    states = run_lockstep([tk for tk, _ in made], [st for _, st in made])
    return [_stage_loss(p, tokens_local, st["outs"], cfg, s, n)
            for s, (p, st) in enumerate(zip(stages, states))]


def make_train_step(cfg: PipelineConfig, params, mesh,
                    learning_rate: float = 3e-4):
    """(optimizer, step) with step(params, opt, tokens) -> (params, opt,
    loss): AdamW with optax's ``adamw`` defaults at 3e-4; the gradients of
    the replicated leaves (embed, final_norm, lm_head) and the loss summed
    over every rank, a stage's layers' over "data" only."""
    from sofa_tpu_torch.workloads.transformer import sharded_step

    return sharded_step(params, param_specs(), mesh, ("data", "stage"),
                        lambda p, tokens: pipeline_loss(p, tokens, cfg,
                                                        mesh),
                        learning_rate)


def build(cfg: PipelineConfig, mesh, batch: int, seq: int, seed: int = 0,
          device=None):
    """(params, optimizer, step, tokens): this stage's shard of the global
    init of S x layers_per_stage layers, the step, and the global tokens,
    from ``seed`` on ``device`` (the card unless the caller names
    another)."""
    from sofa_tpu_torch.workloads.common import resolve_device

    device = resolve_device(device)
    n = axis_size(mesh, "stage")
    _rows(batch, mesh)                              # raises on a bad mesh
    params = init_params(cfg, n * cfg.layers_per_stage, seed, device)
    params = stage_params(params, mesh_axis(mesh, "stage").index, n)
    opt, step = make_train_step(cfg, params, mesh)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=device)
    return params, opt, step, tokens


def main(argv=None):
    """The JAX workload's ``main``: train ``--steps`` steps after two
    warm-up steps on a ("data", "stage") mesh of the ranks (torchrun; one
    flag set: the other axis takes the rest) and print the rate, the last
    loss and every step's loss.  The stage exchange is P2P: on CUDA
    tensors it needs NCCL, one rank to a card (gloo sends no CUDA
    tensor)."""
    from sofa_tpu_torch.workloads.common import (init_distributed,
                                                 make_mesh,
                                                 parse_workload_args,
                                                 steps_per_sec)

    args = parse_workload_args(argv, {
        "batch": 8, "seq": 256, "steps": 10, "d_model": 256, "n_heads": 4,
        "d_ff": 512, "layers_per_stage": 2, "n_microbatches": 4,
        "vocab": 8192, "device": None, "data": 0, "stage": 0,
        "backend": None, "share_device": False,
    })
    cfg = PipelineConfig(vocab=args.vocab, d_model=args.d_model,
                         n_heads=args.n_heads, d_ff=args.d_ff,
                         layers_per_stage=args.layers_per_stage,
                         n_microbatches=args.n_microbatches,
                         max_seq=args.seq)
    info = init_distributed(args.backend, args.device, args.share_device)
    sizes = None
    if args.data or args.stage:
        sizes = (args.data or -1, args.stage or -1)
    mesh = make_mesh(("data", "stage"), sizes, device_type=info.device.type)
    params, opt, step, tokens = build(cfg, mesh, args.batch, args.seq,
                                      device=info.device)
    losses = []

    def one(state):
        p, o, _ = state
        p, o, loss = step(p, o, tokens)
        losses.append(loss)
        return p, o, loss

    sps, state = steps_per_sec(one, (params, opt, None), args.steps)
    print(f"pipeline: rank {info.rank} {sps:.3f} steps/s  "
          f"{sps * args.batch * args.seq:,.0f} tokens/s  "
          f"loss={float(state[2]):.3f}  "
          f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    print(f"pipeline: rank {info.rank} losses (warm-up first) "
          + " ".join(repr(x.item()) for x in losses), flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
