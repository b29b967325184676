"""Flops and bytes of the work a kernel does, from what the trace records.

XLA gives every HLO op its flops and ``bytes_accessed``; a Kineto trace
gives neither.  Ingest (``ingest/kineto.py``) credits each CUDA kernel with
the cost of the host op that launched it, computed here:

  * an aten op, from the operand shapes and dtypes the profiler records
    (``Input Dims``, ``Input type``) and its scalar arguments (``Concrete
    Inputs``).  Flops for the matrix products and convolutions only (the
    elementwise and normalization work around them is bound by bytes);
    bytes in XLA's definition: every operand read once plus the result
    written once.  The trace does not record the result, so it is computed
    from the operands where the op's shape rule is known (the products and
    convolutions), taken as nothing extra for ops that only write their
    first operand (``copy_``, ``fill_``, ``zero_``), and otherwise taken as
    the size of the first operand (an elementwise op or a normalization
    returns that shape; a reduction's result is smaller, so its bytes are
    counted high, by at most the size of its input).  An operand that is a
    broadcast view (a stride of 0) counts the elements it stores.  Ops
    over tensor lists (the ``_foreach`` optimizer updates) record no
    shapes, so their kernels get no cost.
  * a hand-written flash kernel, from the ``pl.CostEstimate`` formulas of
    the JAX package's Pallas kernels (``flash_pallas.py``): the kernels
    launch through ``ctypes``, so no aten op encloses them, and their
    wrappers open a ``record_function`` range named by ``cost_range_name``
    around each launch instead.
"""

from __future__ import annotations

import math
import re
from typing import List, Optional, Sequence, Tuple

from sofa_tpu_torch.kernels import KERNELS

# Bytes per element of the dtypes the profiler names in ``Input type``.
ITEMSIZE = {
    "double": 8, "float": 4, "c10::Half": 2, "c10::BFloat16": 2,
    "c10::Float8_e4m3fn": 1, "c10::Float8_e5m2": 1, "long int": 8,
    "int": 4, "short int": 2, "signed char": 1, "unsigned char": 1,
    "bool": 1, "c10::complex<float>": 8, "c10::complex<double>": 16,
}

# (stride, padding, dilation) argument positions of the convolutions'
# forward schemas (groups show in the weight's C / g)
_CONV_ARGS = {
    "aten::conv2d": (3, 4, 5),
    "aten::convolution": (3, 4, 5),
    "aten::_convolution": (3, 4, 5),
    "aten::cudnn_convolution": (3, 2, 4),
    "aten::mkldnn_convolution": (4, 3, 5),
}
_MATMULS = {"aten::mm": (0, 1), "aten::addmm": (1, 2), "aten::bmm": (0, 1),
            "aten::baddbmm": (1, 2)}
_WRITE_ONLY = ("aten::copy_", "aten::fill_", "aten::zero_")

#: Each flash kernel's name -> the Pallas call it ports (whose
#: ``pl.CostEstimate`` it is credited with): the Hopper kernels and the
#: general ones of the rest of the (dtype, head dim) domain.
FLASH_KERNELS = {k.name: k.pallas_name for k in KERNELS}
_COST_RANGE_RE = re.compile(
    r"^(%s)\[b=(\d+),t=(\d+),tk=(\d+),h=(\d+),kvh=(\d+),d=(\d+),"
    r"causal=([01])(?:,es=(\d+))?\]$" % "|".join(FLASH_KERNELS))


def cost_range_name(kernel: str, b: int, t: int, tk: int, h: int, kvh: int,
                    d: int, causal: bool, itemsize: int = 2) -> str:
    """Name of the profiler range a flash kernel's wrapper opens around
    its launch: the kernel, the shapes its cost depends on and the inputs'
    element size in bytes."""
    return (f"{kernel}[b={b},t={t},tk={tk},h={h},kvh={kvh},d={d},"
            f"causal={int(bool(causal))},es={itemsize}]")


def is_cost_range(name: str) -> bool:
    return _COST_RANGE_RE.match(name) is not None


def flash_cost(kernel: str, b: int, t: int, tk: int, h: int, kvh: int,
               d: int, causal: bool, itemsize: int = 2
               ) -> Tuple[float, float]:
    """(flops, bytes_accessed) of one flash launch, as the Pallas kernel's
    ``pl.CostEstimate`` states them, with q, k, v, dO and the gradients of
    the input dtype at ``itemsize`` bytes an element: the forward 4 matmul
    flops a (query, key, dim), the dK/dV kernel 8, the dQ kernel 6; a
    static causal mask halves them.  Bytes: the forward reads q, k, v and
    writes out (q's size) and the float32 lse; dK/dV reads k, v, q, dO and
    the float32 lse and delta and writes dk, dv; dQ reads k, v, q, dO, lse
    and delta and writes a float32 dq.  A general kernel costs what the
    Pallas call it ports costs."""
    role = FLASH_KERNELS.get(kernel)
    frac = 0.5 if causal else 1.0
    q_bytes = b * t * h * d * itemsize
    kv_bytes = 2 * b * tk * kvh * d * itemsize
    rows = b * h * t * 4                     # one float32 per query row
    if role == "sofa_flash_fwd":
        return 4 * b * h * t * tk * d * frac, 2 * q_bytes + kv_bytes + rows
    if role == "sofa_flash_bwd_kv":
        return (8 * b * h * t * tk * d * frac,
                2 * kv_bytes + 2 * q_bytes + 2 * rows)
    if role == "sofa_flash_bwd_dq":
        return (6 * b * h * t * tk * d * frac,
                kv_bytes + 2 * q_bytes + 2 * rows + b * h * t * d * 4)
    raise ValueError(f"not a flash kernel: {kernel}")


def range_cost(name: str) -> Optional[Tuple[float, float]]:
    """(flops, bytes) of a flash cost range, None for any other name (a
    name without an element size is a bfloat16 launch's)."""
    m = _COST_RANGE_RE.match(name)
    if m is None:
        return None
    b, t, tk, h, kvh, d, causal = (int(x) for x in m.groups()[1:8])
    return flash_cost(m.group(1), b, t, tk, h, kvh, d, bool(causal),
                      int(m.group(9) or 2))


def _tensors(dims: Sequence, types: Sequence, strides: Sequence
             ) -> List[Optional[Tuple[list, int, int]]]:
    """(shape, itemsize, elements stored) of each tensor operand, None for
    any other argument (a tensor list's shapes are not recorded).  A
    broadcast view (stride 0) stores fewer elements than its shape
    holds."""
    out = []
    for i, (shape, kind) in enumerate(zip(dims, types)):
        if kind in ITEMSIZE and isinstance(shape, list):
            st = strides[i] if i < len(strides) else []
            stored = math.prod(n for j, n in enumerate(shape)
                               if j >= len(st) or st[j] != 0)
            out.append((shape, ITEMSIZE[kind], stored))
        else:
            out.append(None)
    return out


def _bytes(t) -> int:
    """Bytes an operand's read touches (its stored elements)."""
    return t[2] * t[1]


def _full_bytes(t) -> int:
    """Bytes of a result shaped like the operand."""
    return math.prod(t[0]) * t[1]


def _ints(text: str) -> List[int]:
    return [int(x) for x in re.findall(r"-?\d+", text or "")]


def _conv_flops(x, w, out_hw) -> float:
    """2 flops a multiply-add: N * K * P * Q outputs, each C/g * R * S
    products."""
    n, k = x[0], w[0]
    return 2.0 * n * k * math.prod(out_hw) * math.prod(w[1:])


def op_cost(name: str, args: dict) -> Optional[Tuple[float, float]]:
    """(flops, bytes_accessed) of one recorded aten op, or None when it
    has no tensor operand (nothing to credit a kernel with)."""
    dims = args.get("Input Dims") or []
    types = args.get("Input type") or []
    conc = args.get("Concrete Inputs") or []
    ts = _tensors(dims, types, args.get("Input Strides") or [])
    tensors = [t for t in ts if t is not None]
    if not tensors:
        return None
    read = sum(_bytes(t) for t in tensors)
    if name in _CONV_ARGS and len(ts) > 1 and ts[0] and ts[1] \
            and len(ts[0][0]) == 4 and len(ts[1][0]) == 4:
        s_i, p_i, d_i = _CONV_ARGS[name]
        x, w = ts[0][0], ts[1][0]
        stride = (_ints(conc[s_i]) if s_i < len(conc) else []) or [1, 1]
        pad = (_ints(conc[p_i]) if p_i < len(conc) else []) or [0, 0]
        dil = (_ints(conc[d_i]) if d_i < len(conc) else []) or [1, 1]
        out_hw = [(x[2 + i] + 2 * pad[i] - dil[i] * (w[2 + i] - 1) - 1)
                  // stride[i] + 1 for i in range(2)]
        return (_conv_flops(x, w, out_hw),
                read + x[0] * w[0] * math.prod(out_hw) * ts[0][1])
    if name == "aten::convolution_backward" and len(ts) > 2 and ts[0] \
            and ts[1] and ts[2] and len(ts[0][0]) == 4:
        g, x, w = ts[0][0], ts[1][0], ts[2][0]
        mask = [m == "True" for m in re.findall(r"True|False",
                                                conc[-1] if conc else "")]
        want_dx, want_dw = (mask + [True, True])[:2]
        wrote = want_dx * _full_bytes(ts[1]) + want_dw * _full_bytes(ts[2])
        return _conv_flops(x, w, g[2:]) * (want_dx + want_dw), read + wrote
    if name in _MATMULS:
        a_i, b_i = _MATMULS[name]
        if len(ts) > b_i and ts[a_i] and ts[b_i]:
            a, b = ts[a_i][0], ts[b_i][0]
            if len(a) >= 2 and len(b) >= 2:
                batch = math.prod(a[:-2])
                out = batch * a[-2] * b[-1]
                return (2.0 * out * a[-1],
                        read + out * ts[a_i][1])
    if name in _WRITE_ONLY:
        return 0.0, read
    return 0.0, read + _full_bytes(tensors[0])
