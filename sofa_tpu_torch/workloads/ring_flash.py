"""Ring attention with the fused kernels on every hop, plain and zig-zag.

The counterpart of ``sofa_tpu/workloads/ring_flash.py``.  Sequence
parallelism (K/V blocks rotate around the mesh's "seq" ranks) meets the
flash kernels (``flash_cuda.py``): each hop runs ``sofa_flash_fwd`` over
the visiting K/V block with a runtime causal shift (hop i on rank r sees
shift (i - n·[i>r])·T_local: aligned-causal for the home block, full for
blocks from earlier shards, fully masked for later ones), and the hops
fold together by their per-row logsumexp, so neither the per-hop score
matrix nor any gather of the sequence materializes.  The backward is the
ring form of the flash gradient: the dK/dV accumulators rotate with their
K/V blocks, each rank adds its hop's contribution from
``sofa_flash_bwd_kv`` and ``sofa_flash_bwd_dq`` (recomputed from the saved
global logsumexp, float32 out), and after n hops every accumulator is home.
The zig-zag layout gives shard r the chunks (r, 2S-1-r) so that every
rank does the same causal work; each hop then runs the kernels on three
half-chunk pairs.

Each loop is split into a hop body and a schedule.  The hop body,
``hop(i, r, n, state) -> state``, holds every kernel call and merge; the
state is a dict of tensors.  Two schedules drive it:

* ``run_ring``: this rank's hops, rotating K/V (and in the backward
  dK/dV) to rank (r + 1) mod n by ``batch_isend_irecv`` after each;
* ``run_lockstep``: every rank's hop i in one process, then a roll of
  the list of shards: what ``chip_smoke.py`` and the tests drive, at full
  width on one card, through the very hop bodies a distributed run calls.

Only the rotation differs (JAX's ``lax.scan`` over ``ppermute`` is both
at once).  The last forward hop's K/V are not sent home (nothing reads
them); the last backward hop sends only the accumulators.  A CUDA tensor
runs the kernels or raises, a CPU tensor their plain versions: the
tensor's device decides (the JAX package's ``FORCE_PALLAS_BWD`` switch is
not carried over).  The ring accumulates in float32 and casts once.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from sofa_tpu_torch.workloads.flash_cuda import _flash_backward, _flash_forward
from sofa_tpu_torch.workloads.ring_attention import NEG_INF

State = Dict[str, torch.Tensor]
Hop = Callable[[int, int, int, State], State]

#: What each schedule rotates after a hop (the last hop's set after it).
FWD_ROTATED, FWD_LAST = ("k", "v"), ()
BWD_ROTATED, BWD_LAST = ("k", "v", "dk", "dv"), ("dk", "dv")


# --- the schedules ------------------------------------------------------------

def run_ring(hop: Hop, state: State, ring, rotated: Sequence[str],
             last: Sequence[str]) -> State:
    """This rank's n hops over ``ring`` (a ``common.Ring``): after hop i,
    the ``rotated`` tensors (``last`` after the final hop) go to rank
    (r + 1) mod n and the previous rank's arrive."""
    n, r = ring.size, ring.index
    for i in range(n):
        state = hop(i, r, n, state)
        keys = rotated if i < n - 1 else last
        if keys and n > 1:
            state = {**state, **dict(zip(keys, ring.rotate(
                [state[k] for k in keys])))}
    return state


def run_lockstep(hop: Hop, states: List[State], rotated: Sequence[str],
                 last: Sequence[str]) -> List[State]:
    """Every rank's n hops in one process: hop i of ranks 0..n-1, then the
    ``rotated`` tensors (``last`` after the final hop) roll one rank on,
    rank r taking rank r - 1's."""
    n = len(states)
    for i in range(n):
        states = [hop(i, r, n, s) for r, s in enumerate(states)]
        keys = rotated if i < n - 1 else last
        states = [{**s, **{k: states[(r - 1) % n][k] for k in keys}}
                  for r, s in enumerate(states)]
    return states


# --- the plain ring's hop bodies ---------------------------------------------

def _hop_shift(i: int, r: int, n: int, t_local: int) -> int:
    """Causal shift for hop i on ring position r: the visiting block came
    from shard (r - i) mod n, so its keys sit i shards behind the local
    queries, except when i > r, where the wrap makes them later shards
    (fully masked, negative shift)."""
    return (i - (n if i > r else 0)) * t_local


def _lse_merge(o, lse, o_i, lse_i):
    """Fold a new partial attention result into the running (o, lse): o
    [B, T, H, D] float32, lse [B, H, T].  A fully masked hop (lse_i near
    -1e29, o_i 0) gets weight 0 against a live running lse and replaces
    the initial -1e30 without a NaN."""
    new_lse = torch.logaddexp(lse, lse_i)
    a = torch.exp(lse - new_lse).transpose(1, 2)[..., None]
    b = torch.exp(lse_i - new_lse).transpose(1, 2)[..., None]
    return o * a + o_i.float() * b, new_lse


def _hop_grad(q, k, v, g, delta, lse, shift: int):
    """One hop's (dq, dk, dv), float32: the two backward kernels on the
    card (no static causal promise: the shift may be positive), their
    plain versions on the CPU."""
    return _flash_backward(q, k, v, g, None, lse, shift=shift,
                           static_causal=False, delta=delta,
                           grad_dtype=torch.float32)


def _fwd_state(q, k, v) -> State:
    b, t, h, _ = q.shape
    return {"q": q, "k": k, "v": v,
            "o": torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            "lse": torch.full((b, h, t), NEG_INF, dtype=torch.float32,
                              device=q.device)}


def ring_fwd_hop(i: int, r: int, n: int, s: State) -> State:
    """Hop i of the ring forward on rank r: the forward kernel over the
    visiting block, merged by logsumexp."""
    shift = _hop_shift(i, r, n, s["q"].shape[1])
    o_i, lse_i = _flash_forward(s["q"], s["k"], s["v"], shift)
    o, lse = _lse_merge(s["o"], s["lse"], o_i, lse_i)
    return {**s, "o": o, "lse": lse}


def _bwd_state(q, k, v, out, lse, g) -> State:
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return {"q": q, "k": k, "v": v, "g": g.contiguous(), "delta": delta,
            "lse": lse,
            "dq": torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            "dk": torch.zeros(k.shape, dtype=torch.float32, device=k.device),
            "dv": torch.zeros(v.shape, dtype=torch.float32, device=v.device)}


def ring_bwd_hop(i: int, r: int, n: int, s: State) -> State:
    """Hop i of the ring backward on rank r: the visiting block's
    contribution to dq, and to the visiting accumulators dk, dv."""
    shift = _hop_shift(i, r, n, s["q"].shape[1])
    dq_i, dk_i, dv_i = _hop_grad(s["q"], s["k"], s["v"], s["g"], s["delta"],
                                 s["lse"], shift)
    return {**s, "dq": s["dq"] + dq_i, "dk": s["dk"] + dk_i,
            "dv": s["dv"] + dv_i}


# --- zig-zag ------------------------------------------------------------------

def zigzag_indices(t: int, shards: int) -> Tuple[np.ndarray, np.ndarray]:
    """The permutation putting the zig-zag layout on a plainly sharded
    axis: 2S chunks of c = T/(2S); shard r gets chunks (r, 2S-1-r), so
    that under causal attention every shard does the same work.  Returns
    (perm, inv): x[:, perm] is zig-zag order, y[:, inv] undoes it."""
    c = t // (2 * shards)
    if c * 2 * shards != t:
        raise ValueError(f"T={t} must divide into 2*{shards} chunks")
    perm = np.concatenate([
        np.concatenate([np.arange(r * c, (r + 1) * c),
                        np.arange((2 * shards - 1 - r) * c,
                                  (2 * shards - r) * c)])
        for r in range(shards)
    ])
    return perm, np.argsort(perm)


def _zigzag_hop_shifts(i: int, r: int, n: int, c: int):
    """Causal shifts of the three contributing (q-half, k-half) pairs at
    hop i (the visiting pair came from (r - i) mod n):

      lo x lo : the plain ring's shift (aligned / full / masked)
      hi x lo : k_lo always sits before q_hi: full
      hi x hi : the sign flips (a later source's hi chunk is earlier than
                ours): full / causal / masked

    q_lo x k_hi never contributes (every k_hi chunk follows every q_lo)."""
    wrapped = n if i > r else 0
    return (i - wrapped) * c, c, (wrapped - i) * c


def _halves(x):
    """(rows [:c], rows [c:]) of a zig-zag shard along T, contiguous (the
    kernels take contiguous tensors)."""
    c = x.shape[1] // 2
    return x[:, :c].contiguous(), x[:, c:].contiguous()


def _zz_fwd_state(q, k, v) -> State:
    s = _fwd_state(q, k, v)
    s["q_lo"], s["q_hi"] = _halves(q)
    return s


def zz_fwd_hop(i: int, r: int, n: int, s: State) -> State:
    """Hop i of the zig-zag forward on rank r: three forward kernels (lo x
    lo, hi x lo, hi x hi), merged into the two halves by logsumexp."""
    c = s["q_lo"].shape[1]
    s_ll, s_hl, s_hh = _zigzag_hop_shifts(i, r, n, c)
    k_lo, k_hi = _halves(s["k"])
    v_lo, v_hi = _halves(s["v"])
    o_ll, lse_ll = _flash_forward(s["q_lo"], k_lo, v_lo, s_ll)
    o_hl, lse_hl = _flash_forward(s["q_hi"], k_lo, v_lo, s_hl)
    o_hh, lse_hh = _flash_forward(s["q_hi"], k_hi, v_hi, s_hh)
    o, lse = s["o"], s["lse"]
    o_lo, lse_lo = _lse_merge(o[:, :c], lse[..., :c], o_ll, lse_ll)
    o_hi, lse_hi = _lse_merge(o[:, c:], lse[..., c:], o_hl, lse_hl)
    o_hi, lse_hi = _lse_merge(o_hi, lse_hi, o_hh, lse_hh)
    return {**s, "o": torch.cat([o_lo, o_hi], dim=1),
            "lse": torch.cat([lse_lo, lse_hi], dim=-1)}


def _zz_bwd_state(q, k, v, out, lse, g) -> State:
    s = _bwd_state(q, k, v, out, lse, g)
    c = q.shape[1] // 2
    s["q_lo"], s["q_hi"] = _halves(q)
    s["g_lo"], s["g_hi"] = _halves(s["g"])
    for name in ("delta", "lse"):
        s[name + "_lo"] = s[name][..., :c].contiguous()
        s[name + "_hi"] = s[name][..., c:].contiguous()
    return s


def zz_bwd_hop(i: int, r: int, n: int, s: State) -> State:
    """Hop i of the zig-zag backward on rank r: the three pairs' gradients
    (each pair one launch of each backward kernel)."""
    c = s["q_lo"].shape[1]
    s_ll, s_hl, s_hh = _zigzag_hop_shifts(i, r, n, c)
    k_lo, k_hi = _halves(s["k"])
    v_lo, v_hi = _halves(s["v"])
    lo = (s["g_lo"], s["delta_lo"], s["lse_lo"])
    hi = (s["g_hi"], s["delta_hi"], s["lse_hi"])
    dq_ll, dk_ll, dv_ll = _hop_grad(s["q_lo"], k_lo, v_lo, *lo, s_ll)
    dq_hl, dk_hl, dv_hl = _hop_grad(s["q_hi"], k_lo, v_lo, *hi, s_hl)
    dq_hh, dk_hh, dv_hh = _hop_grad(s["q_hi"], k_hi, v_hi, *hi, s_hh)
    return {**s,
            "dq": s["dq"] + torch.cat([dq_ll, dq_hl + dq_hh], dim=1),
            "dk": s["dk"] + torch.cat([dk_ll + dk_hl, dk_hh], dim=1),
            "dv": s["dv"] + torch.cat([dv_ll + dv_hl, dv_hh], dim=1)}


_FWD = {False: (_fwd_state, ring_fwd_hop), True: (_zz_fwd_state, zz_fwd_hop)}
_BWD = {False: (_bwd_state, ring_bwd_hop), True: (_zz_bwd_state, zz_bwd_hop)}


def _fwd_done(s: State, dtype):
    return s["o"].to(dtype), s["lse"]


def _bwd_done(s: State, q, k, v):
    return s["dq"].to(q.dtype), s["dk"].to(k.dtype), s["dv"].to(v.dtype)


# --- the distributed ring, differentiable ---------------------------------

def ring_forward(q, k, v, ring, zigzag: bool = False):
    """(out, lse) of this rank's shard over ``ring``: q [B, T_local, H, D],
    k/v [B, T_local, KVH, D] (zig-zag layout when ``zigzag``)."""
    init, hop = _FWD[zigzag]
    return _fwd_done(run_ring(hop, init(q, k, v), ring, FWD_ROTATED,
                              FWD_LAST), q.dtype)


def ring_backward(q, k, v, out, lse, g, ring, zigzag: bool = False):
    """(dq, dk, dv) of this rank's shard over ``ring``, in the inputs'
    dtypes; dk/dv come home after the n-th rotation."""
    init, hop = _BWD[zigzag]
    return _bwd_done(run_ring(hop, init(q, k, v, out, lse, g), ring,
                              BWD_ROTATED, BWD_LAST), q, k, v)


class _RingFlash(torch.autograd.Function):
    """The ring forward whose gradient is the ring backward (the JAX
    package's custom_vjp): saves q, k, v, out and lse.  Every rank makes
    the same exchanges in the same order, in the forward and in autograd's
    backward, and a remat replay replays them too."""

    @staticmethod
    def forward(ctx, q, k, v, ring, zigzag):
        out, lse = ring_forward(q, k, v, ring, zigzag)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.zigzag = ring, zigzag
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_backward(q, k, v, out, lse, g, ctx.ring, ctx.zigzag)
        return dq, dk, dv, None, None


def ring_flash_attention_local(q, k, v, ring):
    """Exact causal attention of this rank's shard q [B, T_local, H, D]
    over the ring's sequence (k/v [B, T_local, KVH, D], GQA-native)."""
    return _RingFlash.apply(q, k, v, ring, False)


def zigzag_ring_flash_attention_local(q, k, v, ring):
    """Load-balanced exact causal attention; q, k, v [B, 2c, H, D] in the
    zig-zag layout (rows [:c] chunk r, rows [c:] chunk 2S-1-r)."""
    return _RingFlash.apply(q, k, v, ring, True)


def ring_flash_attention(q, k, v, mesh, *, seq_axis: str = "seq"):
    """``ring_flash_attention_local`` over ``mesh``'s ``seq_axis``, on this
    rank's shards (PyTorch holds no global array)."""
    from sofa_tpu_torch.workloads.common import mesh_ring

    return ring_flash_attention_local(q, k, v, mesh_ring(mesh, seq_axis))


def zigzag_ring_flash_attention(q, k, v, mesh, *, seq_axis: str = "seq"):
    """``zigzag_ring_flash_attention_local`` over ``mesh``'s
    ``seq_axis``; the shards must already be in zig-zag order
    (``zigzag_indices``)."""
    from sofa_tpu_torch.workloads.common import mesh_ring

    return zigzag_ring_flash_attention_local(q, k, v,
                                             mesh_ring(mesh, seq_axis))


# --- the lockstep schedule ------------------------------------------------------

def lockstep_forward(qs, ks, vs, zigzag: bool = False):
    """Every rank's (out, lse) in one process: ``qs``, ``ks``, ``vs`` hold
    rank r's shard at index r.  Returns (outs, lses), lists by rank."""
    init, hop = _FWD[zigzag]
    states = run_lockstep(hop, [init(*x) for x in zip(qs, ks, vs)],
                          FWD_ROTATED, FWD_LAST)
    done = [_fwd_done(s, q.dtype) for s, q in zip(states, qs)]
    return [o for o, _ in done], [lse for _, lse in done]


def lockstep_backward(qs, ks, vs, outs, lses, gs, zigzag: bool = False):
    """Every rank's (dq, dk, dv) in one process, from each rank's forward
    output, lse and output cotangent; lists by rank."""
    init, hop = _BWD[zigzag]
    states = run_lockstep(hop, [init(*x) for x in
                                zip(qs, ks, vs, outs, lses, gs)],
                          BWD_ROTATED, BWD_LAST)
    done = [_bwd_done(s, q, k, v) for s, q, k, v in zip(states, qs, ks, vs)]
    return ([d[0] for d in done], [d[1] for d in done],
            [d[2] for d in done])
