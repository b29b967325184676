"""Llama-style decoder-only transformer in PyTorch, on one card or over a
(data, seq, model) mesh of ranks.

The counterpart of ``sofa_tpu/workloads/transformer.py``: RMSNorm, rotary
position embeddings, grouped-query attention, SwiGLU MLP, untied LM head.
Params are a plain dict with the JAX package's layout (per-layer leaves
stacked as ``[n_layers, ...]``), so one init crosses between the packages
(``sofa_tpu_torch.convert``).  Matmuls keep the storage dtype (bf16 on the
card, float32 accumulation in cuBLAS); norms, rope and the silu gate run in
float32 and cast back, as in the JAX package.

Attention runs the fused CUDA kernels when the tensors are on the card and
a kernel takes the dtype and head dim (``cfg.flash=None``;
``flash_cuda.route``): a forward kernel, and the dK/dV and dQ kernels under
autograd (the Hopper ``sofa_flash_*`` kernels for bfloat16 at D 64 and 128,
the general ``sofa_flash_gen_*`` ones for every other bfloat16, float16 or
float32 model up to D 256).
``cfg.flash=False`` runs the plain materialized-score attention.  Training
is ``loss_fn`` under ``make_train_step`` (AdamW with optax's ``adamw``
defaults), with per-layer remat through ``torch.utils.checkpoint``.

With a mesh (``common.make_mesh(("data", "seq", "model"), ...)``) every
rank is handed the global token rows and keeps its own: its slice of the
batch over "data" and its shard of the sequence over "seq" (the zig-zag
chunks with ``cfg.zigzag``), with global rope positions.  A "seq" axis
above 1 runs ring attention over this rank's seq group: the fused kernels
on every hop (``ring_flash.py``; zig-zag with ``cfg.zigzag``), or the
plain ring (``ring_attention.py``).

The params a rank holds are its shard of the global ones, cut by
``param_specs`` (the JAX package's PartitionSpecs, ``shard_params``).  A
"model" axis above 1 is Megatron's tensor parallelism: ``wq``, ``wk``,
``wv``, ``w1`` and ``w3`` split on their output columns (each rank its
contiguous heads), ``wo`` and ``w2`` on their input rows, their products
summed over the model group (``common.sum_from``) before the residual
add, whose gradient the column-parallel inputs sum back
(``common.copy_to``); the embedding and the LM head are split over the
vocab: a rank looks up the tokens of its vocab slice (zero elsewhere) and
the model group sums the rows, and the cross entropy reduces the max, the
exp-sum and the gold logit over the group, so no rank holds the whole
vocab.  Where ``n_kv_heads`` does not divide over the axis, ``wk`` and
``wv`` are gathered over it and each rank repeats the KV heads its
query heads read.  ``fsdp`` stores every leaf the spec splits over "data"
as its shard, gathered over the data group before use
(``common.gather``; per layer, inside the remat region), its gradient
reduce-scattered back, so AdamW steps the shards and its moments are
sharded too.  The loss is the mean over the global tokens: each rank
divides its nll sum by the global count, and the step all-reduces (sums)
the gradients and the printed loss over data x seq (a data-sharded leaf
over seq only, its reduce-scatter having summed over data); the model
group holds the loss and the replicated leaves' gradients whole already.
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
    route as flash_route,
    supports as flash_supports,
)
from sofa_tpu_torch.convert import shard_leaf
from sofa_tpu_torch.workloads.common import (
    AxisGroup,
    all_reduce_axes,
    axis_index,
    axis_size,
    copy_to,
    gather,
    mesh_axis,
    mesh_ring,
    sum_from,
)
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
                device: Optional[torch.device] = None,
                mesh=None, fsdp: bool = False) -> Dict[str, Any]:
    """Stacked-layer param dict; per-layer leaves are [n_layers, ...].

    Normal(0, fan_in^-0.5) weights drawn in float32 from a seeded
    ``torch.Generator`` on ``device`` and cast to ``cfg.dtype``; norms are
    ones.  (The JAX package's init draws other numbers from the same seed:
    cross-package tests carry one init over with ``convert``.)  With a
    ``mesh``, this rank's shard (``shard_params``) of the same global
    init, cut leaf by leaf as it is drawn, so that no rank holds the whole
    model at once."""
    device = torch.device("cpu") if device is None else torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, h, kvh, dh, f, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.d_head, cfg.d_ff, cfg.n_layers)
    specs, coords = param_specs(cfg, fsdp), mesh_coords(mesh)
    layer_specs = specs["layers"]

    def norm(spec, *shape):
        fan_in = shape[-2] if len(shape) > 1 else shape[-1]
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return shard_leaf(w.mul_(fan_in ** -0.5), spec, coords, cfg.dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    return {
        "embed": norm(specs["embed"], cfg.vocab, d),
        "layers": {
            "attn_norm": ones(L, d),
            "wq": norm(layer_specs["wq"], L, d, h * dh),
            "wk": norm(layer_specs["wk"], L, d, kvh * dh),
            "wv": norm(layer_specs["wv"], L, d, kvh * dh),
            "wo": norm(layer_specs["wo"], L, h * dh, d),
            "mlp_norm": ones(L, d),
            "w1": norm(layer_specs["w1"], L, d, f),
            "w3": norm(layer_specs["w3"], L, d, f),
            "w2": norm(layer_specs["w2"], L, f, d),
        },
        "final_norm": ones(d),
        "lm_head": norm(specs["lm_head"], d, cfg.vocab),
    }


def param_specs(cfg: TransformerConfig, fsdp: bool = False
                ) -> Dict[str, Any]:
    """Per leaf, the mesh axis each dimension is split over (None: whole):
    the JAX package's PartitionSpecs, to the dimension.  Tensor
    parallelism over "model", FSDP over "data"."""
    dp = "data" if fsdp else None
    return {
        "embed": ("model", dp),
        "layers": {
            "attn_norm": (None, None),
            "wq": (None, dp, "model"),
            "wk": (None, dp, "model"),
            "wv": (None, dp, "model"),
            "wo": (None, "model", dp),
            "mlp_norm": (None, None),
            "w1": (None, dp, "model"),
            "w3": (None, dp, "model"),
            "w2": (None, "model", dp),
        },
        "final_norm": (None,),
        "lm_head": (dp, "model"),
    }


def mesh_coords(mesh) -> Dict[str, Any]:
    """This rank's (index, size) along each axis of ``mesh`` (every axis
    (0, 1) without one): what ``convert.shard_leaf`` cuts by."""
    names = () if mesh is None else (mesh.mesh_dim_names or ())
    return {a: (axis_index(mesh, a), axis_size(mesh, a)) for a in names}


def shard_params(params, cfg: TransformerConfig, mesh, fsdp: bool = False):
    """This rank's shard of global ``params`` (the same on every rank), by
    ``param_specs``: what ``forward`` and the step take on a mesh."""
    from sofa_tpu_torch.convert import shard_tree

    return shard_tree(params, param_specs(cfg, fsdp), mesh_coords(mesh))


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


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's share of the "model" axis: its query heads (contiguous),
    its vocab slice, the group the row-parallel products sum over, and,
    where ``n_kv_heads`` does not divide over the axis, the KV heads (of
    the gathered ``wk`` / ``wv``) that its query heads read."""

    axis: AxisGroup
    n_heads: int
    vocab: int
    kv_index: Optional[torch.Tensor] = None


def tensor_parallel(cfg: TransformerConfig, mesh,
                    device: torch.device) -> Optional[TensorParallel]:
    """The ``TensorParallel`` of this rank on ``mesh`` (None for a "model"
    axis of 1).  A size that does not divide the heads, the vocab,
    ``d_ff`` or the KV projection's columns raises, naming it."""
    ax = mesh_axis(mesh, "model")
    if ax.size == 1:
        return None
    for what, n in (("n_heads", cfg.n_heads), ("vocab", cfg.vocab),
                    ("d_ff", cfg.d_ff),
                    ("n_kv_heads * d_head", cfg.n_kv_heads * cfg.d_head)):
        if n % ax.size:
            raise ValueError(f"the 'model' mesh axis ({ax.size}) must divide "
                             f"{what} ({n})")
    hl = cfg.n_heads // ax.size
    kv_index = None
    if cfg.n_kv_heads % ax.size:
        rep = cfg.n_heads // cfg.n_kv_heads
        kv_index = torch.arange(ax.index * hl, (ax.index + 1) * hl,
                                device=device) // rep
    return TensorParallel(ax, hl, cfg.vocab // ax.size, kv_index)


def layer_body(x, lp, cfg: TransformerConfig, positions, attn,
               tp: Optional[TensorParallel] = None):
    """One decoder layer, parameterized by the attention implementation.

    ``attn(q, kk, v) -> o`` receives *unrepeated* KV heads ([B, T, KVH, Dh])
    so the KV-cache attention (workloads/inference.py) stores them compactly.
    The single copy of the layer math keeps forward() and the inference
    block numerically identical by construction.  Under ``tp`` the layer
    runs this rank's heads and its slice of the MLP: ``lp`` holds its
    column and row shards, the column-parallel inputs pass ``copy_to`` and
    the row-parallel outputs ``sum_from`` over the model group, so the
    residual stream stays whole on every rank."""
    b, t = x.shape[:2]
    h = _rmsnorm(x, lp["attn_norm"])
    if tp is not None:
        h = copy_to(h, tp.axis)
    q = (h @ lp["wq"]).reshape(b, t, -1, cfg.d_head)
    kk = (h @ lp["wk"]).reshape(b, t, -1, cfg.d_head)
    v = (h @ lp["wv"]).reshape(b, t, -1, cfg.d_head)
    if tp is not None and tp.kv_index is not None:
        kk, v = kk[:, :, tp.kv_index], v[:, :, tp.kv_index]
    q = _rope(q, positions, cfg.rope_theta)
    kk = _rope(kk, positions, cfg.rope_theta)
    o = attn(q, kk, v).reshape(b, t, -1) @ lp["wo"]
    x = x + (o if tp is None else sum_from(o, tp.axis))
    h = _rmsnorm(x, lp["mlp_norm"])
    if tp is not None:
        h = copy_to(h, tp.axis)
    gate = F.silu((h @ lp["w1"]).float()).to(cfg.dtype)
    y = (gate * (h @ lp["w3"])) @ lp["w2"]
    return x + (y if tp is None else sum_from(y, tp.axis))


def embed(emb, tokens, tp: Optional[TensorParallel] = None):
    """The rows of ``emb`` at ``tokens``.  Under ``tp`` ``emb`` is this
    rank's vocab slice: its tokens' rows, zero for the others, summed over
    the model group (the counterpart of the JAX package's one-hot
    contraction over the vocab-sharded table)."""
    if tp is None:
        return emb[tokens]
    local = tokens - tp.axis.index * tp.vocab
    inside = (local >= 0) & (local < tp.vocab)
    rows = emb[local.clamp(0, tp.vocab - 1)].masked_fill(
        ~inside[..., None], 0)
    return sum_from(rows, tp.axis)


def lm_logits(x, lm_head, tp: Optional[TensorParallel] = None):
    """The LM head's float32 logits of the final-normed ``x``: this rank's
    vocab columns under ``tp`` (a column-parallel product)."""
    if tp is not None:
        x = copy_to(x, tp.axis)
    return (x @ lm_head).float()


def _nll(logits, targets, tp: Optional[TensorParallel] = None):
    """-log softmax(logits)[target] per position.  Under ``tp`` the logits
    are this rank's vocab columns: the max, the exp-sum and the gold
    logit are reduced over the model group, so no rank gathers the
    vocab, and every rank of the group gets the same nll."""
    if tp is None:
        logz = torch.logsumexp(logits, dim=-1)
        return logz - torch.gather(logits, -1, targets[..., None])[..., 0]
    import torch.distributed as dist

    m = logits.detach().amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.axis.group)
    sumexp = sum_from(torch.exp(logits - m[..., None]).sum(dim=-1), tp.axis)
    local = targets - tp.axis.index * tp.vocab
    inside = (local >= 0) & (local < tp.vocab)
    gold = torch.gather(logits, -1,
                        local.clamp(0, tp.vocab - 1)[..., None])[..., 0]
    gold = sum_from(gold.masked_fill(~inside, 0.0), tp.axis)
    return torch.log(sumexp) + m - gold


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
    """Whether forward() takes the fused attention path: on the card, auto
    (``flash=None``) takes it wherever a CUDA kernel takes the model's
    dtype and head dim (``flash_cuda.route``), and ``flash=True`` raises
    the wrapper's error where none does."""
    on_card = device.type == "cuda"
    if cfg.flash is None:
        return on_card and flash_supports(t, cfg.d_head, cfg.dtype)
    if cfg.flash and on_card and not flash_supports(t, cfg.d_head,
                                                    cfg.dtype):
        flash_route(cfg.dtype, cfg.d_head)      # names the dtype or D
        raise ValueError(
            f"flash=True but the CUDA kernels do not support seq len {t}")
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
    zig-zag; its tensor parallelism, and the gathers each stored leaf
    takes before use (leaf name -> (dim, axis) pairs, dims of a layer's
    slice)."""

    rows: slice
    cols: torch.Tensor
    ring: Any
    fused: bool
    zigzag: bool
    #: whether ``cols`` ends at the sequence's last position (no target)
    ends: bool
    tp: Optional[TensorParallel] = None
    gathers: Dict[str, Any] = dataclasses.field(default_factory=dict)


def use_leaf(gathers: Dict[str, Any], name: str,
             w: torch.Tensor) -> torch.Tensor:
    """The stored leaf ``name`` as the math uses it: gathered over the
    axes it is stored split over but computed whole (``gathers`` as
    ``leaf_gathers`` gives them)."""
    for dim, ax in gathers.get(name, ()):
        w = gather(w, dim, ax)
    return w


def leaf_gathers(cfg: TransformerConfig, mesh, fsdp: bool,
                 tp: Optional[TensorParallel]) -> Dict[str, Any]:
    """Leaf name -> the (dim, axis) gathers before use: every dim FSDP
    splits over "data", and the KV projections' "model" columns where
    their heads do not divide over it."""
    specs = param_specs(cfg, fsdp)
    flat = {"embed": specs["embed"], "final_norm": specs["final_norm"],
            "lm_head": specs["lm_head"],
            **{k: v[1:] for k, v in specs["layers"].items()}}
    data, out = mesh_axis(mesh, "data"), {}
    for name, spec in flat.items():
        if fsdp and data.size > 1 and "data" in spec:
            out[name] = ((spec.index("data"), data),)
    if tp is not None and tp.kv_index is not None:
        for name in ("wk", "wv"):
            out[name] = out.get(name, ()) + (
                (flat[name].index("model"), tp.axis),)
    return out


def _layout(cfg: TransformerConfig, b: int, t: int, mesh,
            device: torch.device, fsdp: bool = False) -> _Layout:
    dn, sn = axis_size(mesh, "data"), axis_size(mesh, "seq")
    if b % dn or t % sn:
        raise ValueError(f"batch {b} and sequence {t} must divide over the "
                         f"mesh's data {dn} and seq {sn} axes")
    if fsdp and cfg.d_model % dn:
        raise ValueError(f"fsdp: the 'data' mesh axis ({dn}) must divide "
                         f"d_model ({cfg.d_model})")
    tp = tensor_parallel(cfg, mesh, device)
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
                   else None, fused, zigzag, int(cols[-1]) == t - 1, tp,
                   leaf_gathers(cfg, mesh, fsdp, tp))


def forward(params, tokens, cfg: TransformerConfig,
            segment_ids: Optional[torch.Tensor] = None,
            mesh=None, fsdp: bool = False) -> torch.Tensor:
    """Logits in float32: [B, T, vocab] without a mesh (or on one rank).

    ``segment_ids`` [B, T] packs several documents per row: attention is
    masked within segments and rope positions restart at each segment, so a
    packed batch matches processing the documents separately.  Ids must be
    contiguous runs along T; not supported with sequence parallelism.
    Differentiable: with params that require grad, the fused path's
    backward runs the two backward kernels.

    With a ``mesh``, ``params`` are this rank's shard (``shard_params``,
    FSDP's with ``fsdp``), ``tokens`` (and ``segment_ids``) the global
    batch, the same on every rank, and the logits are this rank's: its
    rows over "data", its positions over "seq" and its vocab columns over
    "model" ([B / data, T / seq, vocab / model]), in zig-zag order when
    ``cfg.zigzag`` takes the fused ring."""
    b, t = tokens.shape
    return _logits(params, tokens, cfg, segment_ids,
                   _layout(cfg, b, t, mesh, tokens.device, fsdp))


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
        rep = q.shape[2] // kk.shape[2]
        kk = kk.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        if ring is not None:
            return ring_attention_local(q, kk, v, ring)
        if segment_ids is not None:
            return plain_segmented_causal_attention(q, kk, v, segment_ids)
        return plain_causal_attention(q, kk, v)

    def layer(x, i):
        lp = {name: use_leaf(lay.gathers, name, w[i])
              for name, w in params["layers"].items()}
        return layer_body(x, lp, cfg, positions, attn, lay.tp)

    if cfg.remat or cfg.remat_policy:
        # a named policy implies remat, as in the JAX package
        context_fn = _remat_context_fn(cfg.remat_policy)
        kw = {} if context_fn is None else {"context_fn": context_fn}
        layer = functools.partial(checkpoint, layer, use_reentrant=False,
                                  **kw)

    x = embed(use_leaf(lay.gathers, "embed", params["embed"]).to(cfg.dtype),
              tokens, lay.tp)
    for i in range(cfg.n_layers):
        x = layer(x, i)
    x = _rmsnorm(x, params["final_norm"])
    return lm_logits(x, use_leaf(lay.gathers, "lm_head", params["lm_head"]),
                     lay.tp)


def loss_fn(params, tokens, cfg: TransformerConfig,
            segment_ids: Optional[torch.Tensor] = None,
            mesh=None, fsdp: bool = False) -> torch.Tensor:
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
    from the global rows, across shard boundaries.  The ranks of a model
    group hold the same value (the cross entropy over the vocab-sharded
    logits, ``_nll``)."""
    b, t = tokens.shape
    lay = _layout(cfg, b, t, mesh, tokens.device, fsdp)
    logits = _logits(params, tokens, cfg, segment_ids, lay)
    cols = lay.cols
    if lay.ends:
        logits, cols = logits[:, :-1], cols[:-1]
    targets = tokens[lay.rows][:, cols + 1].long()
    nll = _nll(logits, targets, lay.tp)
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


def leaves_with_specs(params, specs):
    """(tensor, spec) of every leaf of ``params``, its spec looked up by
    its key path in ``specs`` (the dicts' key orders may differ)."""
    for k, v in params.items():
        if isinstance(v, dict):
            yield from leaves_with_specs(v, specs[k])
        else:
            yield v, specs[k]


def make_optimizer(params, learning_rate: float = 1e-3
                   ) -> torch.optim.AdamW:
    """AdamW over every leaf with ``optax.adamw``'s defaults: betas
    (0.9, 0.999), eps 1e-8 and weight decay 1e-4 (torch's default is 1e-2)
    on every leaf, norms included.  The moments take each leaf's own dtype.
    Marks the leaves as requiring grad; the step updates them in place."""
    leaves = [p.requires_grad_(True) for p in param_leaves(params)]
    return torch.optim.AdamW(leaves, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def sharded_step(params, specs, mesh, axes, loss_of,
                 learning_rate: float):
    """(optimizer, step) with step(params, opt, *batch) -> (params, opt,
    loss): ``loss_of(params, *batch)`` forward and backward, then one
    AdamW update of ``params`` in place.  With a ``mesh``, each leaf's
    gradient is all-reduced (summed) over the mesh ``axes`` its spec (in
    ``specs``) does not split it over, and the loss over all of ``axes``:
    each rank's loss is its share of the global loss."""
    opt = make_optimizer(params, learning_rate)
    leaves = [(p, [a for a in axes if a not in spec])
              for p, spec in leaves_with_specs(params, specs)]

    def step(params, opt, *batch):
        opt.zero_grad(set_to_none=True)
        loss = loss_of(params, *batch)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            for p, leaf_axes in leaves:
                all_reduce_axes(p.grad, mesh, leaf_axes)
            all_reduce_axes(loss, mesh, axes)
        opt.step()
        return params, opt, loss

    return opt, step


def make_train_step(cfg: TransformerConfig, params,
                    learning_rate: float = 1e-3, mesh=None,
                    fsdp: bool = False):
    """(optimizer, step) with step(params, opt, tokens, segment_ids=None)
    -> (params, opt, loss): one loss_fn forward and backward and one AdamW
    update of ``params`` in place (the JAX step returns new arrays).  With
    a ``mesh``, the gradients and the loss are all-reduced (summed) over
    data x seq before the update (a leaf FSDP splits over "data" over seq
    only: its gather's reduce-scatter summed it over data), so every rank
    of a model group applies the same update to the same replicated
    leaves.  Never over "model": the loss is replicated there, and a
    reduction would count it once per model rank."""
    def loss_of(params, tokens, segment_ids=None):
        return loss_fn(params, tokens, cfg, segment_ids, mesh=mesh,
                       fsdp=fsdp)

    return sharded_step(params, param_specs(cfg, fsdp), mesh,
                        ("data", "seq"), loss_of, learning_rate)


def build(cfg: TransformerConfig, batch: int, seq: int, seed: int = 0,
          device=None, mesh=None, fsdp: bool = False):
    """(params, optimizer, step, tokens): init params, the train step and a
    batch of random tokens, all from ``seed`` on ``device`` (the card
    unless the caller names another).  With a ``mesh``, every rank draws
    the same global params and keeps its shard of them (FSDP's with
    ``fsdp``), and the same global tokens (the step keeps its own shard
    of them)."""
    from sofa_tpu_torch.workloads.common import resolve_device

    device = resolve_device(device)
    _layout(cfg, batch, seq, mesh, device, fsdp)    # raises on a bad mesh
    params = init_params(cfg, seed, device, mesh, fsdp)
    opt, step = make_train_step(cfg, params, mesh=mesh, fsdp=fsdp)
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
    ranks of a host share its card, over gloo; ``--fsdp`` shards the
    params and the optimizer's moments over "data"); each rank prints its
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
        "backend": None, "share_device": False, "fsdp": False,
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
                                      device=device, mesh=mesh,
                                      fsdp=args.fsdp)
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
