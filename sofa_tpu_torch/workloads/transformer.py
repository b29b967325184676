"""Llama-style decoder-only transformer in PyTorch (single device).

The counterpart of ``sofa_tpu/workloads/transformer.py``: RMSNorm, rotary
position embeddings, grouped-query attention, SwiGLU MLP, untied LM head.
Params are a plain dict with the JAX package's layout (per-layer leaves
stacked as ``[n_layers, ...]``), so one init crosses between the packages
(``sofa_tpu_torch.convert``).  Matmuls keep the storage dtype (bf16 on the
card, float32 accumulation in cuBLAS); norms, rope and the silu gate run in
float32 and cast back, as in the JAX package.

Attention runs the fused ``sofa_flash_fwd`` CUDA kernel when the tensors are
on the card and the kernel supports the shape (``cfg.flash=None``), or the
plain materialized-score attention (``cfg.flash=False``).  Mesh sharding,
ring/zig-zag sequence parallelism, remat and the train step come later.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from sofa_tpu_torch.workloads.flash_cuda import (
    flash_causal_attention,
    flash_causal_segmented_attention,
    supports as flash_supports,
)
from sofa_tpu_torch.workloads.ring_attention import (
    plain_causal_attention,
    plain_segmented_causal_attention,
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


@torch.no_grad()
def forward(params, tokens, cfg: TransformerConfig,
            segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits [B, T, vocab] in float32.

    ``segment_ids`` [B, T] packs several documents per row: attention is
    masked within segments and rope positions restart at each segment, so a
    packed batch matches processing the documents separately.  Ids must be
    contiguous runs along T.  Inference only (no autograd graph is kept):
    the backward kernels come with the training slice."""
    b, t = tokens.shape
    if t > cfg.max_seq:
        raise ValueError(f"sequence length {t} exceeds max_seq {cfg.max_seq}")
    fused = use_flash(cfg, t, tokens.device)
    if segment_ids is None:
        positions = torch.arange(t, device=tokens.device).expand(b, t)
    else:
        positions = _segment_positions(segment_ids)

    def attn(q, kk, v):
        if fused:
            if segment_ids is not None:
                return flash_causal_segmented_attention(q, kk, v, segment_ids)
            return flash_causal_attention(q, kk, v)
        rep = cfg.n_heads // cfg.n_kv_heads
        kk = kk.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        if segment_ids is not None:
            return plain_segmented_causal_attention(q, kk, v, segment_ids)
        return plain_causal_attention(q, kk, v)

    x = params["embed"].to(cfg.dtype)[tokens]
    for i in range(cfg.n_layers):
        x = layer_body(x, layer_params(params, i), cfg, positions, attn)
    x = _rmsnorm(x, params["final_norm"])
    return (x @ params["lm_head"]).float()
