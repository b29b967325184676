"""Fused flash attention, forward and backward: the host side of the
``sofa_flash_fwd``, ``sofa_flash_bwd_kv`` and ``sofa_flash_bwd_dq`` CUDA
kernels (``csrc/flash_*.cu``) and their plain PyTorch versions.

The counterpart of ``sofa_tpu/workloads/flash_pallas.py``.  A tensor on the
card goes to the kernels or raises; the plain versions run only for tensors
on the CPU, where the tests hold them against the JAX kernels run in Pallas
interpret mode.  The kernels index [B, T, H, D] strides directly and read
the compact K/V heads themselves, so no plane transposes or head repeats are
materialized on the card.

The attention wrappers are differentiable through ``_FlashAttention``, a
``torch.autograd.Function`` whose backward is ``_flash_backward``: on the
card the two backward kernels, on the CPU their plain versions.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sofa_tpu_torch import kernels
from sofa_tpu_torch.workloads.ring_attention import NEG_INF

#: Head dims the CUDA kernel is compiled for.
HEAD_DIMS = (64, 128)
#: The running max's floor: a row with no visible key keeps m here, so its
#: masked scores underflow to exact zeros (flash_pallas.py:92-96).
M_FLOOR = -1e29


def _kv_head(head: int, h: int, kvh: int) -> int:
    """Compact KV head serving query head ``head``: the whole query group
    h // kvh shares one (the mapping of flash_pallas._kv_plane)."""
    return head // (h // kvh)


def _normalize_segments(segment_ids, kv_segment_ids, b, t, tk):
    """(seg_q [B,T] int32, seg_kv [B,Tk] int32) or (None, None): the one
    shape-validation point for the segment masks."""
    if segment_ids is None:
        if kv_segment_ids is not None:
            raise ValueError("kv_segment_ids given without segment_ids")
        return None, None
    kv = segment_ids if kv_segment_ids is None else kv_segment_ids
    if tuple(segment_ids.shape) != (b, t) or tuple(kv.shape) != (b, tk):
        raise ValueError(f"segment ids must be [B, T]/[B, Tk] = "
                         f"({b}, {t})/({b}, {tk}); got "
                         f"{tuple(segment_ids.shape)}/{tuple(kv.shape)}")
    return (segment_ids.to(torch.int32).contiguous(),
            kv.to(torch.int32).contiguous())


def _check_static_shift(static_causal: bool, shift) -> None:
    """``static_causal`` promises shift <= 0 (aligned causal or stricter);
    a positive shift under that promise is a caller error."""
    if static_causal and int(shift) > 0:
        raise ValueError(f"static_causal=True promises shift <= 0, got "
                         f"{int(shift)}; pass static_causal=False")


def supports(t: int, head_dim: int) -> bool:
    """True when a [.., T, .., head_dim] attention can run on the CUDA
    kernel.  The kernel masks the ragged edge itself, so any T >= 1 works;
    it is compiled for head dims 64 and 128."""
    return t >= 1 and head_dim in HEAD_DIMS


def _check_card_inputs(bf16, others=()) -> None:
    """What every CUDA kernel takes: tensors on one device, bfloat16
    ``bf16`` tensors with a supported head dim, all contiguous, and 16-byte
    aligned bf16 tensors.  Raises on anything else (no fallback)."""
    tensors = list(bf16) + [x for x in others if x is not None]
    if any(x.device != bf16[0].device for x in tensors):
        raise ValueError("flash attention inputs must share one CUDA device")
    if any(x.dtype != torch.bfloat16 for x in bf16):
        raise TypeError(f"the CUDA kernels take bfloat16 q/k/v (and dO); got "
                        f"{[str(x.dtype) for x in bf16]}")
    d = bf16[0].shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernels are built for head dims "
                         f"{HEAD_DIMS}; got {d}")
    if any(not x.is_contiguous() for x in tensors):
        raise ValueError("the CUDA kernels take contiguous tensors")
    if any(x.data_ptr() % 16 for x in bf16):
        raise ValueError("the CUDA kernels need 16-byte aligned q/k/v/dO")


def _segment_masked(t, tk, shift, seg_q, seg_kv, device):
    """[B or 1, 1, T, Tk] bool: pairs the causal rule (key j visible to
    query i iff j <= i + shift) or the segment ids hide."""
    q_pos = torch.arange(t, device=device)[:, None]
    k_pos = torch.arange(tk, device=device)[None, :]
    masked = (k_pos > q_pos + int(shift))[None, None]
    if seg_q is not None:
        masked = masked | (seg_q[:, None, :, None] != seg_kv[:, None, None, :])
    return masked


def _repeat_kv(x, h):
    """[B, Tk, KVH, D] -> [B, Tk, H, D]: each query head's compact KV head."""
    kvh = x.shape[2]
    idx = torch.tensor([_kv_head(i, h, kvh) for i in range(h)],
                       device=x.device)
    return x.index_select(2, idx)


def _flash_forward_plain(q, k, v, shift: int, seg_q=None, seg_kv=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: (out [B,T,H,D], lse [B,H,T]).

    Same masking, clamps and rounding as the kernel: scores in float32, m
    clamped at -1e29, p rounded to V's dtype before the P.V product while l
    sums it unrounded.  Materializes the [B, H, T, Tk] scores."""
    t, h, d = q.shape[1:]
    kr, vr = _repeat_kv(k, h), _repeat_kv(v, h)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * d ** -0.5
    s = s.masked_fill(
        _segment_masked(t, k.shape[1], shift, seg_q, seg_kv, q.device),
        NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp_min(M_FLOOR)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vr.float())
    out = (o / l.permute(0, 2, 1, 3)).to(q.dtype)
    lse = (m + torch.log(l)).squeeze(-1)
    return out, lse


def _flash_forward_cuda(q, k, v, shift: int, seg_q=None, seg_kv=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``sofa_flash_fwd`` on q's device and current stream."""
    b, t, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    _check_card_inputs((q, k, v), (seg_q, seg_kv))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if t == 0 or b == 0:
        return out, lse
    kern = kernels.FLASH_FWD
    lib = kernels.library(kern)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.sofa_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            seg_q.data_ptr() if seg_q is not None else None,
            seg_kv.data_ptr() if seg_kv is not None else None,
            out.data_ptr(), lse.data_ptr(), b, t, tk, h, kvh, d, int(shift),
            d ** -0.5, stream)
    kernels.check(kern, lib, err)
    kern.launches += 1
    return out, lse


def _check_shapes(q, k, v) -> None:
    """q [B,T,H,D] and k/v [B,Tk,KVH,D] with H a multiple of KVH."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,T,H,D] and k/v [B,Tk,KVH,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"query heads {q.shape[2]} not a multiple of kv "
                         f"heads {k.shape[2]}")


def _on_card(q) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU tensor (the
    plain versions); any other device raises."""
    if q.is_cuda:
        return True
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on CUDA (kernels) or the CPU "
                         f"(plain versions); got {q.device}")
    return False


def _flash_forward(q, k, v, shift=0, static_causal: bool = False,
                   segment_ids=None, kv_segment_ids=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,T,H,D], lse [B,H,T] float32) for q [B,T,H,D] and k/v
    [B,Tk,KVH,D] with H a multiple of KVH.

    ``shift`` is the causal offset: key j is visible to query i iff
    j <= i + shift.  0 = aligned causal, >= Tk = full attention, <= -Tk =
    fully masked (out 0, lse ~ -1e29).  ``static_causal`` promises
    shift <= 0 (checked).  CUDA tensors run the kernel; CPU tensors the
    plain version."""
    _check_shapes(q, k, v)
    _check_static_shift(static_causal, shift)
    seg_q, seg_kv = _normalize_segments(segment_ids, kv_segment_ids,
                                        q.shape[0], q.shape[1], k.shape[1])
    if _on_card(q):
        return _flash_forward_cuda(q, k, v, int(shift), seg_q, seg_kv)
    return _flash_forward_plain(q, k, v, int(shift), seg_q, seg_kv)


# --- backward ---------------------------------------------------------------

def _bwd_ds(q, k, v, g, lse, delta, shift: int, seg_q, seg_kv):
    """(p, ds) [B,H,T,Tk] float32 as the backward kernels form them: p =
    exp(s * scale - max(lse, -1e29)), exactly 0 where masked; ds =
    p * (dp - delta) rounded to q's dtype.  Materializes the scores."""
    t, h, d = q.shape[1:]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     _repeat_kv(k, h).float()) * d ** -0.5
    s = s.masked_fill(
        _segment_masked(t, k.shape[1], shift, seg_q, seg_kv, q.device),
        NEG_INF)
    p = torch.exp(s - lse.float().clamp_min(M_FLOOR)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), _repeat_kv(v, h).float())
    ds = (p * (dp - delta.float()[..., None])).to(q.dtype).float()
    return p, ds


def _group_sum(x, kvh: int):
    """[B, Tk, H, D] -> [B, Tk, KVH, D]: each compact KV head's gradient is
    the sum over the query heads of its group."""
    b, tk, h, d = x.shape
    return x.reshape(b, tk, kvh, h // kvh, d).sum(dim=3)


def _flash_bwd_kv_plain(q, k, v, g, lse, delta, shift: int, seg_q=None,
                        seg_kv=None, grad_dtype=None):
    """``sofa_flash_bwd_kv``'s function in plain PyTorch: (dk, dv)
    [B,Tk,KVH,D].  p rounds to dO's dtype before the dV product and ds to
    q's before the dK product, as in the kernel; scale after the product."""
    p, ds = _bwd_ds(q, k, v, g, lse, delta, shift, seg_q, seg_kv)
    kvh, d = k.shape[2], q.shape[3]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).float(), g.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * d ** -0.5
    return (_group_sum(dk, kvh).to(grad_dtype or k.dtype),
            _group_sum(dv, kvh).to(grad_dtype or v.dtype))


def _flash_bwd_dq_plain(q, k, v, g, lse, delta, shift: int, seg_q=None,
                        seg_kv=None, grad_dtype=None):
    """``sofa_flash_bwd_dq``'s function in plain PyTorch: dq [B,T,H,D]."""
    _, ds = _bwd_ds(q, k, v, g, lse, delta, shift, seg_q, seg_kv)
    h, d = q.shape[2], q.shape[3]
    dq = torch.einsum("bhqk,bkhd->bqhd", ds,
                      _repeat_kv(k, h).float()) * d ** -0.5
    return dq.to(grad_dtype or q.dtype)


def _flash_backward_plain(q, k, v, g, lse, delta, shift: int, seg_q=None,
                          seg_kv=None, grad_dtype=None):
    """(dq, dk, dv) from the two kernels' plain versions (CPU route)."""
    dk, dv = _flash_bwd_kv_plain(q, k, v, g, lse, delta, shift, seg_q,
                                 seg_kv, grad_dtype)
    dq = _flash_bwd_dq_plain(q, k, v, g, lse, delta, shift, seg_q, seg_kv,
                             grad_dtype)
    return dq, dk, dv


def _card_grad_dtype(grad_dtype) -> bool:
    """``grad_dtype`` as the kernels' out_f32 flag: None (the input dtype,
    bfloat16) or float32; anything else raises."""
    if grad_dtype not in (None, torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA backward kernels write bfloat16 or "
                        f"float32 gradients; got grad_dtype={grad_dtype}")
    return grad_dtype == torch.float32


def _bwd_launch(kern, q, k, v, g, lse, delta, shift, seg_q, seg_kv, outs,
                out_f32: bool) -> None:
    """Launch one backward kernel writing ``outs`` on q's current stream."""
    _check_card_inputs((q, k, v, g), (lse, delta, seg_q, seg_kv) + outs)
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError("the CUDA backward kernels take float32 lse/delta")
    b, t, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    lib = kernels.library(kern)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, kern.name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            seg_q.data_ptr() if seg_q is not None else None,
            seg_kv.data_ptr() if seg_kv is not None else None,
            *(x.data_ptr() for x in outs), int(out_f32), b, t, tk, h, kvh, d,
            int(shift), d ** -0.5, stream)
    kernels.check(kern, lib, err)
    kern.launches += 1


def _flash_bwd_kv_cuda(q, k, v, g, lse, delta, shift: int, seg_q=None,
                       seg_kv=None, grad_dtype=None):
    """Launch ``sofa_flash_bwd_kv``: (dk, dv) [B,Tk,KVH,D]."""
    out_f32 = _card_grad_dtype(grad_dtype)
    dt = torch.float32 if out_f32 else k.dtype
    dk = torch.empty(k.shape, dtype=dt, device=k.device)
    dv = torch.empty(v.shape, dtype=dt, device=v.device)
    if q.numel() and k.numel():
        _bwd_launch(kernels.FLASH_BWD_KV, q, k, v, g, lse, delta, shift,
                    seg_q, seg_kv, (dk, dv), out_f32)
    return dk, dv


def _flash_bwd_dq_cuda(q, k, v, g, lse, delta, shift: int, seg_q=None,
                       seg_kv=None, grad_dtype=None):
    """Launch ``sofa_flash_bwd_dq``: dq [B,T,H,D]."""
    out_f32 = _card_grad_dtype(grad_dtype)
    dq = torch.empty(q.shape, dtype=torch.float32 if out_f32 else q.dtype,
                     device=q.device)
    if q.numel() and k.numel():
        _bwd_launch(kernels.FLASH_BWD_DQ, q, k, v, g, lse, delta, shift,
                    seg_q, seg_kv, (dq,), out_f32)
    return dq


def _flash_backward(q, k, v, g, out, lse, shift=0, static_causal: bool = True,
                    delta=None, grad_dtype=None, segment_ids=None,
                    kv_segment_ids=None):
    """(dq, dk, dv) of attention for the output cotangent ``g`` [B,T,H,D],
    given the forward's ``out`` and ``lse``; ``shift``, ``static_causal``
    and the segment ids as in _flash_forward.

    ``delta`` = rowsum(g * out) [B,H,T] may be passed precomputed (ring
    hops reuse one), otherwise it is derived from ``out``.  Gradients come
    back in ``grad_dtype`` (default: the input dtypes), dk/dv in the compact
    [B,Tk,KVH,D] layout with each group's query heads summed.  CUDA tensors
    run ``sofa_flash_bwd_kv`` and ``sofa_flash_bwd_dq``; CPU tensors their
    plain versions."""
    _check_shapes(q, k, v)
    if g.shape != q.shape:
        raise ValueError(f"cotangent {tuple(g.shape)} does not match q "
                         f"{tuple(q.shape)}")
    _check_static_shift(static_causal, shift)
    seg_q, seg_kv = _normalize_segments(segment_ids, kv_segment_ids,
                                        q.shape[0], q.shape[1], k.shape[1])
    if delta is None:
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2)
    delta = delta.to(torch.float32).contiguous()
    lse = lse.to(torch.float32).contiguous()
    args = (q, k, v, g.contiguous(), lse, delta, int(shift), seg_q, seg_kv,
            grad_dtype)
    if _on_card(q):
        dk, dv = _flash_bwd_kv_cuda(*args)
        return _flash_bwd_dq_cuda(*args), dk, dv
    return _flash_backward_plain(*args)


class _FlashAttention(torch.autograd.Function):
    """Fused attention whose gradient is the fused backward.  Saves only
    O(B*H*T) beside the inputs (out and lse), as the JAX custom VJPs do."""

    @staticmethod
    def forward(ctx, q, k, v, shift, static_causal, seg_q, seg_kv):
        out, lse = _flash_forward(q, k, v, shift, static_causal, seg_q,
                                  seg_kv)
        ctx.save_for_backward(q, k, v, out, lse, seg_q, seg_kv)
        ctx.shift, ctx.static_causal = shift, static_causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, seg_q, seg_kv = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, g, out, lse, ctx.shift,
                                     ctx.static_causal, segment_ids=seg_q,
                                     kv_segment_ids=seg_kv)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = True, segment_ids=None,
                    kv_segment_ids=None) -> torch.Tensor:
    """Fused attention: q [B, T, H, D]; k/v may carry KVH <= H heads.
    ``segment_ids`` [B, T] masks cross-segment pairs on top of the causal
    rule; ``kv_segment_ids`` defaults to the same array."""
    shift = 0 if causal else k.shape[1]
    return _FlashAttention.apply(q, k, v, shift, causal, segment_ids,
                                 kv_segment_ids)


def flash_causal_attention(q, k, v) -> torch.Tensor:
    """Fused causal attention, [B, T, H, D] in and out (GQA-native)."""
    return _FlashAttention.apply(q, k, v, 0, True, None, None)


def flash_causal_segmented_attention(q, k, v, segment_ids) -> torch.Tensor:
    """Fused causal attention over PACKED sequences: tokens attend causally
    within their own segment only (ids are contiguous runs)."""
    return _FlashAttention.apply(q, k, v, 0, True, segment_ids, None)
