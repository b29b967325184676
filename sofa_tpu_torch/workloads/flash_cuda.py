"""Fused flash attention, forward and backward: the host side of the CUDA
flash kernels (``csrc/flash_*.cu``) and their plain PyTorch versions.

The counterpart of ``sofa_tpu/workloads/flash_pallas.py``, whose three
Pallas kernels take any float dtype and any head dim.  Each has two CUDA
counterparts, and ``route`` picks one by (dtype, head dim): bfloat16 at D
64 and 128 goes to the Hopper kernels (``sofa_flash_fwd``,
``sofa_flash_bwd_kv``, ``sofa_flash_bwd_dq``: TMA and wgmma), every other
bfloat16, float16 or float32 call with 1 <= D <= 256 to the general ones
(``sofa_flash_gen_fwd``, ``sofa_flash_gen_bwd_kv``, ``sofa_flash_gen_bwd_dq``;
each picks its path by the dtype code: bfloat16 and float16 on the
tensor cores, TMA-fed where the rows and bases allow it, and float32 in FMA
on the CUDA cores).  A tensor on the card goes to exactly one kernel or
raises; the plain versions run only for tensors on the CPU, where
the tests hold them against the JAX kernels run in Pallas interpret mode.
The kernels index [B, T, H, D] strides directly and read the compact K/V
heads themselves, so no plane transposes or head repeats are materialized on
the card.

The attention wrappers are differentiable through ``_FlashAttention``, a
``torch.autograd.Function`` whose backward is ``_flash_backward``: on the
card the two backward kernels of the route, on the CPU their plain
versions.  Each launch on the card runs inside a profiler range that names
the kernel and its shapes, from which ingest credits the kernel with the
flops and bytes of the Pallas kernel's ``pl.CostEstimate``
(``sofa_tpu_torch/costs.py``).
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch

from sofa_tpu_torch import kernels
from sofa_tpu_torch.costs import cost_range_name
from sofa_tpu_torch.workloads.ring_attention import NEG_INF

#: Head dims the Hopper kernels are compiled for (bfloat16 only).
HOPPER_HEAD_DIMS = (64, 128)
#: The largest head dim the general kernels take (their largest cap).
MAX_HEAD_DIM = 256
#: The element types the kernels take, with the general kernels' codes for
#: them (``GenDtype`` in csrc/flash_gen.cuh).
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
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


def route(dtype, d: int) -> Tuple[kernels.Kernel, kernels.Kernel,
                                   kernels.Kernel]:
    """The (forward, dK/dV, dQ) kernels that take q/k/v of ``dtype`` at
    head dim ``d``: the Hopper kernels for bfloat16 at D 64 or 128, the
    general kernels for every other bfloat16, float16 or float32 call with
    1 <= D <= 256.  Raises TypeError for any other dtype and ValueError for
    any other D: nothing falls back."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA flash kernels take bfloat16, float16 or "
                        f"float32 q/k/v; got {dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the CUDA flash kernels take head dims 1 to "
                         f"{MAX_HEAD_DIM}; got {d}")
    if dtype == torch.bfloat16 and d in HOPPER_HEAD_DIMS:
        fwd, kv, dq = kernels.HOPPER
    else:
        fwd, kv, dq = kernels.GENERAL
    return fwd, kv, dq


def supports(t: int, head_dim: int, dtype) -> bool:
    """True when a [.., T, .., head_dim] attention of ``dtype`` can run on
    a CUDA kernel (``route``).  The kernels mask the ragged edge
    themselves, so any T >= 1 works."""
    return t >= 1 and dtype in _DTYPE_CODES and 1 <= head_dim <= MAX_HEAD_DIM


def _check_card_inputs(kern, inputs, others=()) -> None:
    """What ``kern`` takes: tensors on one device, ``inputs`` (q, k, v and
    dO) of one dtype and head dim of the domain (``route``), all
    contiguous; a Hopper kernel only what ``route`` sends it (bfloat16 at D
    64 or 128, 16-byte aligned for its TMA descriptors), a general kernel
    the whole domain (any alignment: where TMA cannot describe the rows it
    loads them thread by thread).  Raises on anything else (no fallback)."""
    tensors = list(inputs) + [x for x in others if x is not None]
    if any(x.device != inputs[0].device for x in tensors):
        raise ValueError("flash attention inputs must share one CUDA device")
    dtypes = {x.dtype for x in inputs}
    if len(dtypes) != 1:
        raise TypeError(f"the CUDA kernels take q/k/v (and dO) of one dtype; "
                        f"got {[str(x.dtype) for x in inputs]}")
    want = route(inputs[0].dtype, inputs[0].shape[-1])
    if kern.family == "hopper" and kern not in want:
        raise ValueError(f"{kern.name} does not take {inputs[0].dtype} at "
                         f"head dim {inputs[0].shape[-1]}; "
                         f"{[k.name for k in want]} do")
    if any(not x.is_contiguous() for x in tensors):
        raise ValueError("the CUDA kernels take contiguous tensors")
    if kern.family == "hopper" and any(x.data_ptr() % 16 for x in inputs):
        raise ValueError("the Hopper kernels need 16-byte aligned "
                         "q/k/v/dO")


def _dtype_args(kern, q) -> tuple:
    """The general kernels' element-type argument (none for Hopper's)."""
    return (_DTYPE_CODES[q.dtype],) if kern.family == "general" else ()


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


def _cost_range(kern, q, k, causal: bool):
    """The profiler range around one launch, named by the kernel and the
    shapes and element size its cost depends on (``costs.cost_range_name``):
    the kernel launches through ctypes, so no aten op tells the trace what
    it does.  Opened only while a profiler runs."""
    if not torch._C._autograd._profiler_enabled():
        return contextlib.nullcontext()
    b, t, h, d = q.shape
    return torch.profiler.record_function(cost_range_name(
        kern.name, b, t, k.shape[1], h, k.shape[2], d, causal,
        q.element_size()))


def _flash_forward_cuda(q, k, v, shift: int, seg_q=None, seg_kv=None, *,
                        static_causal: bool, defines: kernels.Defines = (),
                        kern=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel of ``route(q.dtype, D)`` (or ``kern``, a
    forward kernel that takes the inputs) on q's device and current stream,
    from the library built with ``defines``: a ring-depth variant of
    ``tools/tune_flash.py``; the main path passes none."""
    b, t, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    kern = kern or route(q.dtype, d)[0]
    _check_card_inputs(kern, (q, k, v), (seg_q, seg_kv))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if t == 0 or b == 0:
        return out, lse
    lib = kernels.library(kern, defines)
    with torch.cuda.device(q.device), _cost_range(kern, q, k, static_causal):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, kern.name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            seg_q.data_ptr() if seg_q is not None else None,
            seg_kv.data_ptr() if seg_kv is not None else None,
            out.data_ptr(), lse.data_ptr(), *_dtype_args(kern, q), b, t, tk,
            h, kvh, d, int(shift), d ** -0.5, stream)
    kernels.check(kern, lib, err)
    if not defines:             # the count is the default library's alone
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
        return _flash_forward_cuda(q, k, v, int(shift), seg_q, seg_kv,
                                   static_causal=static_causal)
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
    """The dK/dV kernels' function in plain PyTorch: (dk, dv)
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
    """The dQ kernels' function in plain PyTorch: dq [B,T,H,D]."""
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


def _card_grad_dtype(grad_dtype, dtype) -> bool:
    """``grad_dtype`` as the kernels' out_f32 flag: None or ``dtype`` (the
    inputs' dtype) or float32; anything else raises."""
    if grad_dtype not in (None, dtype, torch.float32):
        raise TypeError(f"the CUDA backward kernels write {dtype} or "
                        f"float32 gradients; got grad_dtype={grad_dtype}")
    return grad_dtype == torch.float32


def _bwd_launch(kern, q, k, v, g, lse, delta, shift, seg_q, seg_kv, outs,
                out_f32: bool, static_causal: bool,
                defines: kernels.Defines = ()) -> None:
    """Launch one backward kernel writing ``outs`` on q's current stream
    (from the library built with ``defines``)."""
    _check_card_inputs(kern, (q, k, v, g), (lse, delta, seg_q, seg_kv) + outs)
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError("the CUDA backward kernels take float32 lse/delta")
    b, t, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    lib = kernels.library(kern, defines)
    with torch.cuda.device(q.device), _cost_range(kern, q, k, static_causal):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, kern.name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            seg_q.data_ptr() if seg_q is not None else None,
            seg_kv.data_ptr() if seg_kv is not None else None,
            *(x.data_ptr() for x in outs), int(out_f32),
            *_dtype_args(kern, q), b, t, tk, h, kvh, d, int(shift),
            d ** -0.5, stream)
    kernels.check(kern, lib, err)
    if not defines:
        kern.launches += 1


def _flash_bwd_kv_cuda(q, k, v, g, lse, delta, shift: int, seg_q=None,
                       seg_kv=None, grad_dtype=None, *, static_causal: bool,
                       defines: kernels.Defines = (), kern=None):
    """Launch the dK/dV kernel of ``route(q.dtype, D)`` (or ``kern``):
    (dk, dv) [B,Tk,KVH,D]."""
    kern = kern or route(q.dtype, q.shape[-1])[1]
    out_f32 = _card_grad_dtype(grad_dtype, q.dtype)
    dt = torch.float32 if out_f32 else k.dtype
    dk = torch.empty(k.shape, dtype=dt, device=k.device)
    dv = torch.empty(v.shape, dtype=dt, device=v.device)
    if q.numel() and k.numel():
        _bwd_launch(kern, q, k, v, g, lse, delta, shift, seg_q, seg_kv,
                    (dk, dv), out_f32, static_causal, defines)
    return dk, dv


def _flash_bwd_dq_cuda(q, k, v, g, lse, delta, shift: int, seg_q=None,
                       seg_kv=None, grad_dtype=None, *, static_causal: bool,
                       defines: kernels.Defines = (), kern=None):
    """Launch the dQ kernel of ``route(q.dtype, D)`` (or ``kern``): dq
    [B,T,H,D]."""
    kern = kern or route(q.dtype, q.shape[-1])[2]
    out_f32 = _card_grad_dtype(grad_dtype, q.dtype)
    dq = torch.empty(q.shape, dtype=torch.float32 if out_f32 else q.dtype,
                     device=q.device)
    if q.numel() and k.numel():
        _bwd_launch(kern, q, k, v, g, lse, delta, shift, seg_q, seg_kv,
                    (dq,), out_f32, static_causal, defines)
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
    run the two backward kernels of ``route``; CPU tensors their plain
    versions."""
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
        dk, dv = _flash_bwd_kv_cuda(*args, static_causal=static_causal)
        return _flash_bwd_dq_cuda(*args, static_causal=static_causal), dk, dv
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
