"""Reference causal attention (the single-device oracles of the ring module).

Only the plain attention the transformer's unfused path and the tests use is
ported here; the sequence-parallel ring itself comes with the multi-GPU
work.  Scores and softmax run in float32 whatever the input dtype.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _softmax_attend(q, k, v, keep):
    """softmax(q k^T * scale masked to ``keep``) v over [B, T, H, D]."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def plain_causal_attention(q, k, v):
    """Reference single-device causal attention: [B, T, H, D] in and out."""
    t = q.shape[1]
    keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    return _softmax_attend(q, k, v, keep[None, None])


def plain_segmented_causal_attention(q, k, v, segment_ids):
    """Reference causal attention over packed sequences: tokens attend
    within their own segment only."""
    t = q.shape[1]
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    same = segment_ids[:, :, None] == segment_ids[:, None, :]
    return _softmax_attend(q, k, v, (causal[None] & same)[:, None])
