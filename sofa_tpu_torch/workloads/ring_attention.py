"""Ring attention: exact causal attention over a sequence-sharded axis,
and the single-device oracles.

The counterpart of ``sofa_tpu/workloads/ring_attention.py``.  Queries stay
on their rank; key/value blocks rotate around the mesh's "seq" process
group by P2P (``common.Ring``, one exchange a hop), and each hop folds into
the running output with the online-softmax recurrence, so the [T, T] score
matrix never materializes.  After as many hops as ranks, every query has
seen every key once.  This is the transformer's unfused sequence-parallel
path; ``ring_flash.py`` runs the fused kernels on every hop.  The rotation
is differentiable (its gradient rotates the other way), so autograd
differentiates the ring as JAX does.  Scores and softmax run in float32
whatever the input dtype.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _block_attn(q, k, v, q_pos, k_pos, causal: bool):
    """One (q-block, kv-block) online-softmax step over [B, T, H, D]
    blocks: (scores' max [B,H,Tq], their exp-sum [B,H,Tq], p.v
    [B,Tq,H,D]), all float32."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(k_pos[None, None, None, :]
                          > q_pos[None, None, :, None], NEG_INF)
    m = s.amax(dim=-1)
    # a fully masked row (early hops of leading queries) keeps m at NEG_INF;
    # exp(s - m) would be 1 there, so the reference point is clamped
    m_safe = m.clamp_min(-1e29)
    p = torch.exp(s - m_safe[..., None])
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return m_safe, p.sum(dim=-1), pv


def ring_attention_local(q, k, v, ring, causal: bool = True):
    """Attention of this rank's shard q [B, T_local, H, D] over the whole
    ring's keys: k/v (this rank's [B, T_local, H, D]) visit every rank of
    ``ring`` (a ``common.Ring``).  Returns [B, T_local, H, D] in q's
    dtype."""
    n, r = ring.size, ring.index
    t_local = q.shape[1]
    q_pos = r * t_local + torch.arange(t_local, device=q.device)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((q.shape[0], q.shape[2], t_local), NEG_INF,
                   dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    k_blk, v_blk = k, v
    for i in range(n):
        src = (r - i) % n           # hop i's block came from shard r - i
        k_pos = src * t_local + torch.arange(t_local, device=q.device)
        m_blk, l_blk, pv = _block_attn(q, k_blk, v_blk, q_pos, k_pos, causal)
        m_new = torch.maximum(m, m_blk)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(m_blk - m_new)
        l = l * alpha + l_blk * beta
        o = (o * alpha.transpose(1, 2)[..., None]
             + pv * beta.transpose(1, 2)[..., None])
        m = m_new
        if i < n - 1:               # the last hop's blocks would go home
            k_blk, v_blk = ring.rotate((k_blk, v_blk))
    # every query sees at least itself under the causal rule: l > 0
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def ring_attention(q, k, v, mesh, *, seq_axis: str = "seq",
                   causal: bool = True):
    """``ring_attention_local`` over ``mesh``'s ``seq_axis``: q, k, v are
    this rank's [B, T_local, H, D] shards (PyTorch holds no global array;
    the JAX version takes the global one and shard_maps it)."""
    from sofa_tpu_torch.workloads.common import mesh_ring

    return ring_attention_local(q, k, v, mesh_ring(mesh, seq_axis), causal)


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
