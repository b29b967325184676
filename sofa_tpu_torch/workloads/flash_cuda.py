"""Fused flash attention forward: the host side of the ``sofa_flash_fwd``
CUDA kernel (``csrc/flash_fwd.cu``) and its plain PyTorch version.

The counterpart of ``sofa_tpu/workloads/flash_pallas.py``.  A tensor on the
card goes to the kernel or raises; the plain version runs only for tensors
on the CPU, where the tests hold it against the JAX kernel run in Pallas
interpret mode.  The kernel indexes [B, T, H, D] strides directly and reads
the compact K/V heads itself, so no plane transposes or head repeats are
materialized on the card.

Forward only: the backward kernels (``sofa_flash_bwd_kv``,
``sofa_flash_bwd_dq``) come with the training slice, and until then a CUDA
call that asks for a gradient raises instead of differentiating the plain
version.
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


def _check_no_grad(*tensors) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise NotImplementedError(
            "flash attention on CUDA is forward-only: its backward kernels "
            "(sofa_flash_bwd_kv, sofa_flash_bwd_dq) come with the training "
            "slice; run under torch.no_grad() or use the plain attention")


def _flash_forward_plain(q, k, v, shift: int, seg_q=None, seg_kv=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: (out [B,T,H,D], lse [B,H,T]).

    Same masking, clamps and rounding as the kernel: scores in float32, m
    clamped at -1e29, p rounded to V's dtype before the P.V product while l
    sums it unrounded.  Materializes the [B, H, T, Tk] scores."""
    b, t, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    idx = torch.tensor([_kv_head(i, h, kvh) for i in range(h)],
                       device=k.device)
    kr, vr = k.index_select(2, idx), v.index_select(2, idx)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * d ** -0.5
    q_pos = torch.arange(t, device=q.device)[:, None]
    k_pos = torch.arange(tk, device=q.device)[None, :]
    masked = (k_pos > q_pos + int(shift))[None, None]
    if seg_q is not None:
        masked = masked | (seg_q[:, None, :, None] != seg_kv[:, None, None, :])
    s = s.masked_fill(masked, NEG_INF)
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
    tensors = [q, k, v] + ([seg_q, seg_kv] if seg_q is not None else [])
    if any(x.device != q.device for x in tensors):
        raise ValueError("flash attention inputs must share one CUDA device")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)):
        raise TypeError(f"the CUDA kernel takes bfloat16 q/k/v; got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel is built for head dims "
                         f"{HEAD_DIMS}; got {d}")
    if any(not x.is_contiguous() for x in tensors):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the CUDA kernel needs 16-byte aligned q/k/v")
    _check_no_grad(q, k, v)
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
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,T,H,D] and k/v [B,Tk,KVH,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, t, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"query heads {h} not a multiple of kv heads {kvh}")
    _check_static_shift(static_causal, shift)
    seg_q, seg_kv = _normalize_segments(segment_ids, kv_segment_ids, b, t, tk)
    if q.is_cuda:
        return _flash_forward_cuda(q, k, v, int(shift), seg_q, seg_kv)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on CUDA (kernel) or the CPU "
                         f"(plain version); got {q.device}")
    return _flash_forward_plain(q, k, v, int(shift), seg_q, seg_kv)


def flash_attention(q, k, v, causal: bool = True, segment_ids=None,
                    kv_segment_ids=None) -> torch.Tensor:
    """Fused attention: q [B, T, H, D]; k/v may carry KVH <= H heads.
    ``segment_ids`` [B, T] masks cross-segment pairs on top of the causal
    rule; ``kv_segment_ids`` defaults to the same array."""
    shift = 0 if causal else k.shape[1]
    return _flash_forward(q, k, v, shift, static_causal=causal,
                          segment_ids=segment_ids,
                          kv_segment_ids=kv_segment_ids)[0]


def flash_causal_attention(q, k, v) -> torch.Tensor:
    """Fused causal attention, [B, T, H, D] in and out (GQA-native)."""
    return _flash_forward(q, k, v, 0, static_causal=True)[0]


def flash_causal_segmented_attention(q, k, v, segment_ids) -> torch.Tensor:
    """Fused causal attention over PACKED sequences: tokens attend causally
    within their own segment only (ids are contiguous runs)."""
    return _flash_forward(q, k, v, 0, static_causal=True,
                          segment_ids=segment_ids)[0]
