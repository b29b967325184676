"""Kernel performance of the CUDA flash kernels: regenerates
``sofa_tpu_torch/docs/KERNEL_PERF.md``.

The counterpart of ``tools/kernel_perf.py`` (whose table,
``docs/KERNEL_PERF.md``, is the JAX package's and is never written here).
It measures on the card, with CUDA events:

  - the forward at T 2048, 8192 and 16384 (B = 16384 / T, H 8, D 128),
    GQA off and 4x;
  - the forward plus backward (autograd through
    ``flash_causal_attention``: ``sofa_flash_fwd``, ``sofa_flash_bwd_kv``,
    ``sofa_flash_bwd_dq``) at the same T, GQA off: end to end, so its time
    also holds the loss, delta and the host's dispatch;
  - each backward kernel alone at the same T (the kernel's efficiency),
    against SDPA's whole backward (dq, dk and dv);
  - the ring hop: one non-causal visiting-block hop (shift >= Tk), T 4096,
    B 2;
  - the Llama-3-8B attention shape (B 4, T 2048, H 32, KVH 8, D 128),
    forward, forward plus backward, and each backward kernel alone;
  - the general kernels (``sofa_flash_gen_*``, every (dtype, head dim) the
    Hopper kernels leave out) at three shapes: float32 at the flagship's
    attention (B 4, T 512, H 8 / 4, D 64), bfloat16 at D 256 (B 1, T 8192,
    H 8 / 4) and bfloat16 at D 16 (B 8, T 2048, H 4 / 2), forward, forward
    plus backward, and each backward kernel alone.

Each row is timed in turns with SDPA on the same inputs (kernel, SDPA, SDPA,
kernel), and gives the kernel's ms, TFLOP/s (``attention_flops``, the JAX
tool's count) and % of the card's peak, SDPA's ms and the kernel/SDPA
ratio, and the bound: the least time the card could take, the larger of
the visible pairs' operations over the peak and the bytes each kernel must
move over the memory rate (an end-to-end row's bound is its kernels' sum) (``forward_cost``, ``backward_costs``; the
``kernel`` phase of ``chip_smoke.py`` computes its bounds the same way).
A row faster than its bound fails the tool.  The peaks are
``analysis/sol.py``'s ``PEAKS``, keyed on the card's name, at the rate of
the inputs' type (a float32 row against the card's float32 rate outside
the tensor cores, ``FP32_TFLOPS``): a card the tables do not name gets no
% of peak and no bound, and the file says so.  Bytes count each input and
output at its element size.

    python -m sofa_tpu_torch.tools.kernel_perf [--out F.md] [--json F]
                                               [--reps 20]

CUDA only: exits 1 without a card (a CPU run would time the plain
versions, not the kernels).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

from sofa_tpu_torch.analysis.sol import (FP32_SOURCE, FP32_TFLOPS,
                                         PEAK_SOURCE, PEAKS)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(_PKG, "docs", "KERNEL_PERF.md")

#: (flop/s, bytes/s) of a card
Peaks = Tuple[float, float]
#: model matmuls of each kernel (and of SDPA's forward and whole backward)
MATMULS = {"sofa_flash_fwd": 2, "sofa_flash_bwd_kv": 4,
           "sofa_flash_bwd_dq": 3, "sdpa fwd": 2, "sdpa bwd": 5}
#: what a row times: the forward, autograd through the forward and the
#: backward pair (end to end), or one backward kernel alone
MODES = ("fwd", "fwd+bwd", "sofa_flash_bwd_kv", "sofa_flash_bwd_dq")


def attention_flops(b: int, t: int, h: int, d: int,
                    causal: bool = True, bwd: bool = False) -> float:
    """FLOPs of (fused) attention: two matmuls forward, five backward,
    each 2*b*h*T^2*d, halved under the causal mask."""
    per_matmul = 2.0 * b * h * t * t * d * (0.5 if causal else 1.0)
    n = 2.0 + (5.0 if bwd else 0.0)
    return per_matmul * n


def card_peaks(name: str, dtype: str = "bfloat16") -> Optional[Peaks]:
    """The card's (dense flop/s at ``dtype``'s rate, HBM bytes/s) from
    ``sol.PEAKS`` (bfloat16 and float16) or ``FP32_TFLOPS`` (float32), or
    None for a card the tables do not name."""
    if name not in PEAKS or (dtype == "float32" and name not in FP32_TFLOPS):
        return None
    tflops, gbps = PEAKS[name]
    if dtype == "float32":
        tflops = FP32_TFLOPS[name]
    return tflops * 1e12, gbps * 1e9


def visible_pairs(t: int, tk: int, shift: int) -> int:
    """(query, key) pairs the causal rule leaves visible in one (batch,
    head): query i sees keys j <= i + shift of the Tk."""
    return sum(min(max(i + shift + 1, 0), tk) for i in range(t))


def forward_cost(b, t, tk, h, kvh, d, shift, itemsize: int = 2
                 ) -> Tuple[float, float]:
    """(operations, bytes) the forward kernel must do and move: two
    products over the visible pairs; q, k and v read once, out written (at
    ``itemsize`` bytes an element, the inputs' type), lse written
    (float32)."""
    flops = 4.0 * b * h * d * visible_pairs(t, tk, shift)
    nbytes = itemsize * (2.0 * b * t * h * d + 2.0 * b * tk * kvh * d) \
        + 4.0 * b * h * t
    return flops, nbytes


def backward_costs(b, t, tk, h, kvh, d, shift, itemsize: int = 2
                   ) -> Dict[str, Tuple[float, float]]:
    """{Pallas call name: (operations, bytes)} of the backward pair: q, dO,
    k and v read once, lse and delta read (float32), and each kernel's
    gradients written (q, dO, k, v and gradients at ``itemsize`` bytes an
    element); the dK/dV kernel (``sofa_flash_bwd_kv`` and its general
    counterpart) recomputes S and dP and forms dV and dK (four products over
    the visible pairs), the dQ kernel recomputes S and dP and forms dQ
    (three)."""
    pairs = b * h * visible_pairs(t, tk, shift)
    operands = itemsize * (2.0 * b * t * h * d + 2.0 * b * tk * kvh * d)
    rows = 2.0 * b * h * t * 4
    return {
        "sofa_flash_bwd_kv": (8.0 * d * pairs,
                              operands + rows + itemsize * 2.0 * b * tk
                              * kvh * d),
        "sofa_flash_bwd_dq": (6.0 * d * pairs,
                              operands + rows + itemsize * 1.0 * b * t * h
                              * d),
    }


def bound(flops: float, nbytes: float, peaks: Peaks) -> Tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time the card could take
    for the work, the larger of the two times, and which one it is."""
    t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(kernel_fn, library_fn, iters: int = 20):
    """Device ms of a kernel and of its library yardstick, timed in turns
    (kernel, library, library, kernel) so that drift in the card's clocks
    falls on both alike: ((kernel, kernel), (library, library))."""
    k1 = cuda_ms(kernel_fn, iters)
    l1 = cuda_ms(library_fn, iters)
    l2 = cuda_ms(library_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    return (k1, k2), (l1, l2)


def nvidia_smi() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return r.stdout.strip().splitlines()[0]


def _row(kernel, b, t, h, kvh, d, causal, mode, turns, peaks,
         dtype: str = "bfloat16"):
    """One table row from its in-turns readings (``peaks`` at ``dtype``'s
    rate, bytes at its element size)."""
    (k1, k2), (l1, l2) = turns
    ms, sdpa_ms = (k1 + k2) / 2, (l1 + l2) / 2
    shift = 0 if causal else t
    itemsize = ITEMSIZE[dtype]
    costs = backward_costs(b, t, t, h, kvh, d, shift, itemsize)
    if mode in costs:
        (flops, nbytes), model = costs[mode], \
            attention_flops(b, t, h, d, causal) / 2 * MATMULS[mode]
    else:
        flops, nbytes = forward_cost(b, t, t, h, kvh, d, shift, itemsize)
        if mode == "fwd+bwd":
            for f, n in costs.values():
                flops, nbytes = flops + f, nbytes + n
        model = attention_flops(b, t, h, d, causal, mode == "fwd+bwd")
    row = {"kernel": kernel, "mode": mode, "B": b, "T": t, "H": h,
           "KVH": kvh, "D": d, "dtype": dtype, "gqa": kvh != h,
           "causal": causal, "ms": ms,
           "ms_turns": [k1, k2], "sdpa_ms": sdpa_ms,
           "sdpa_turns": [l1, l2], "ratio": ms / sdpa_ms,
           "tflops": model / ms / 1e9,
           "pct_peak": None, "bound_ms": None, "bound_by": None,
           "pct_bound": None}
    if peaks is not None:
        row["pct_peak"] = 100 * row["tflops"] * 1e12 / peaks[0]
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, peaks)
        row["pct_bound"] = 100 * row["bound_ms"] / ms
    return row


def _inputs(b, t, h, kvh, d, seed, grad=False, dtype: str = "bfloat16"):
    """q [B,T,H,D] and k, v [B,T,KVH,D] of ``dtype`` on the card from
    ``seed``, and SDPA's [B,H,T,D] copies of them."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    qkv = [torch.randn(b, t, n, d, generator=g, device="cuda")
           .to(getattr(torch, dtype)) for n in (h, kvh, kvh)]
    heads_first = [x.transpose(1, 2).contiguous() for x in qkv]
    if grad:
        for x in qkv + heads_first:
            x.requires_grad_(True)
    return qkv, heads_first


def measure(kernel, b, t, h, kvh, d, causal, mode, reps, peaks, seed=0,
            dtype: str = "bfloat16"):
    """Times one row of ``mode`` in turns with SDPA's counterpart: the
    forward, autograd through the forward and the backward pair, or one
    backward kernel alone (the route's for ``dtype`` and D) against SDPA's
    whole backward."""
    import torch

    from sofa_tpu_torch.workloads import flash_cuda as fc

    sdpa = torch.nn.functional.scaled_dot_product_attention
    bwd = mode != "fwd"
    (q, k, v), (qt, kt, vt) = _inputs(b, t, h, kvh, d, seed, grad=bwd,
                                      dtype=dtype)
    if mode not in ("fwd", "fwd+bwd"):
        shift = 0 if causal else t
        with torch.no_grad():
            g = torch.randn_like(q)
            out, lse = fc._flash_forward(q, k, v, shift, causal)
            delta = (g.float() * out.float()).sum(-1).transpose(1, 2) \
                .contiguous()
        launch = fc._flash_bwd_kv_cuda if mode == "sofa_flash_bwd_kv" \
            else fc._flash_bwd_dq_cuda
        args = (q.detach(), k.detach(), v.detach(), g, lse, delta, shift)
        o = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
        g_t = g.transpose(1, 2).contiguous()

        def fused():
            return launch(*args, static_causal=causal)

        def library():
            return torch.autograd.grad(o, (qt, kt, vt), g_t,
                                       retain_graph=True)
    elif bwd:
        def fused():
            out = fc.flash_attention(q, k, v, causal=causal)
            return torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))

        def library():
            out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
            return torch.autograd.grad((out.float() ** 2).sum(),
                                       (qt, kt, vt))
    else:
        def fused():
            return fc.flash_attention(q, k, v, causal=causal)

        def library():
            return sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
    with torch.set_grad_enabled(bwd):
        turns = in_turns(fused, library, reps)
    return _row(kernel, b, t, h, kvh, d, causal, mode, turns, peaks, dtype)


#: (kernel label, B, T, H, KVH, D, causal, mode), bfloat16: the Hopper
#: kernels
SWEEP = [
    *(("flash fwd", 16384 // t, t, 8, kvh, 128, True, "fwd")
      for t in (2048, 8192, 16384) for kvh in (8, 2)),
    *(("flash fwd+bwd", 16384 // t, t, 8, 8, 128, True, "fwd+bwd")
      for t in (2048, 8192, 16384)),
    *((kern, 16384 // t, t, 8, 8, 128, True, kern)
      for t in (2048, 8192, 16384) for kern in MODES[2:]),
    ("ring hop (non-causal)", 2, 4096, 8, 8, 128, False, "fwd"),
    ("llama3_8b fwd", 4, 2048, 32, 8, 128, True, "fwd"),
    ("llama3_8b fwd+bwd", 4, 2048, 32, 8, 128, True, "fwd+bwd"),
    *((f"llama3_8b {kern}", 4, 2048, 32, 8, 128, True, kern)
      for kern in MODES[2:]),
]
#: (label prefix, B, T, H, KVH, D, dtype) of the general kernels' shapes:
#: the float32 flagship's attention, bfloat16 at D 256 and at D 16
GENERAL_SHAPES = [
    ("f32 flagship", 4, 512, 8, 4, 64, "float32"),
    ("bf16 D256", 1, 8192, 8, 4, 256, "bfloat16"),
    ("bf16 D16", 8, 2048, 4, 2, 16, "bfloat16"),
]
#: (kernel label, B, T, H, KVH, D, causal, mode, dtype): the general
#: kernels, each shape in every mode
SWEEP_GENERAL = [
    (f"{label} {mode}", b, t, h, kvh, d, True, mode, dtype)
    for label, b, t, h, kvh, d, dtype in GENERAL_SHAPES for mode in MODES]
#: bytes an element of each input type
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def run_sweep(reps: int, card: str, log=print) -> List[dict]:
    """Every row of ``SWEEP`` and ``SWEEP_GENERAL``, against ``card``'s
    peaks at each row's input type."""
    rows = []
    specs = [(*spec, "bfloat16") for spec in SWEEP] + SWEEP_GENERAL
    for *spec, dtype in specs:
        rows.append(measure(*spec, reps=reps, peaks=card_peaks(card, dtype),
                            dtype=dtype))
        log(format_row(rows[-1]))
    return rows


def _fmt(x, spec, none="—"):
    return none if x is None else format(x, spec)


def format_row(r: dict) -> str:
    return (f"kernel_perf: {r['kernel']} B{r['B']} T{r['T']} "
            f"H{r['H']}/{r['KVH']} D{r['D']}: {r['ms']:.4f} ms "
            f"({r['ms_turns'][0]:.4f} / {r['ms_turns'][1]:.4f}), "
            f"{r['tflops']:.1f} TFLOP/s, {_fmt(r['pct_peak'], '.1f')}% of "
            f"peak; SDPA {r['sdpa_ms']:.4f} ms, kernel/SDPA "
            f"{r['ratio']:.3f}; bound {_fmt(r['bound_ms'], '.4f')} ms "
            f"({r['bound_by'] or 'no peak'}), {_fmt(r['pct_bound'], '.1f')}"
            f"% of bound")


def render_md(rows, peaks: Optional[Peaks], card: str, smi: str) -> str:
    stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    lines = [
        "# Kernel performance of the CUDA flash kernels",
        "",
        "Tool-owned: regenerate with `python -m "
        "sofa_tpu_torch.tools.kernel_perf` on the card",
        f"(last: {stamp}).  Card: {card} (nvidia-smi: {smi}).",
        "Times by CUDA events, each row in turns with SDPA on the same "
        "inputs",
        "(kernel, SDPA, SDPA, kernel; the mean of each pair).  Compare "
        "rows only",
        "within one run: a card set below its power limit runs slower.",
        "",
        (f"Peak: **{peaks[0] / 1e12:.0f} TFLOP/s dense bf16, "
         f"{peaks[1] / 1e9:,.0f} GB/s** ({PEAK_SOURCE})") if peaks else
        (f"Peak: unknown ({card!r} is not in analysis/sol.py's PEAKS): no "
         "% of peak, no bound"),
        "",
    ]
    fp32 = card_peaks(card, "float32")
    if fp32 and any(r.get("dtype") == "float32" for r in rows):
        lines += [f"Float32 rows: **{fp32[0] / 1e12:.0f} TFLOP/s** "
                  f"({FP32_SOURCE})", ""]
    lines += [
        "| kernel | B | T | H / KVH | D | ms | TFLOP/s | % of peak | "
        "SDPA ms | kernel / SDPA | bound ms | bound by | % of bound |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['kernel']} | {r['B']} | {r['T']} | {r['H']} / "
            f"{r['KVH']} | {r['D']} | {r['ms']:.4f} | {r['tflops']:.1f} | "
            f"{_fmt(r['pct_peak'], '.1f')} | {r['sdpa_ms']:.4f} | "
            f"{r['ratio']:.3f} | {_fmt(r['bound_ms'], '.4f')} | "
            f"{r['bound_by'] or '—'} | {_fmt(r['pct_bound'], '.1f')} |")
    lines += [
        "",
        "TFLOP/s counts the JAX tool's model FLOPs (`attention_flops`: 2 "
        "matmuls forward, 5",
        "backward, halved under the causal mask; 4 for `sofa_flash_bwd_kv` "
        "alone, 3 for",
        "`sofa_flash_bwd_dq`); the bound counts the visible pairs and each "
        "kernel's bytes",
        "read and written once.  The fwd+bwd rows are end to end, not the "
        "kernels'",
        "efficiency: autograd through the three kernels, whose time also "
        "holds the loss,",
        "delta and the host's dispatch, against the three kernels' summed "
        "bound.  The",
        "`sofa_flash_bwd_kv` and `sofa_flash_bwd_dq` rows time each kernel "
        "alone against",
        "its own bound; their SDPA column is SDPA's whole backward (dq, dk "
        "and dv).",
        "The rows labelled `f32 flagship`, `bf16 D256` and `bf16 D16` run "
        "the general",
        "kernels (`sofa_flash_gen_fwd`, `sofa_flash_gen_bwd_kv`, "
        "`sofa_flash_gen_bwd_dq`: float32",
        "FMA on the CUDA cores), their bytes at the input's element size.",
        "",
    ]
    return "\n".join(lines)


def faster_than_bound(rows) -> List[str]:
    return [f"{r['kernel']} T{r['T']}: {r['ms']:.4f} ms < bound "
            f"{r['bound_ms']:.4f} ms" for r in rows
            if r["bound_ms"] is not None and r["ms"] < r["bound_ms"]]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--json", default="")
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_perf: requires a CUDA device (the kernels have no "
              "CPU mode)", file=sys.stderr)
        return 1
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    peaks = card_peaks(card)
    print(f"kernel_perf: {card} | nvidia-smi: {smi}", flush=True)
    rows = run_sweep(args.reps, card,
                     log=lambda line: print(line, flush=True))
    md = render_md(rows, peaks, card, smi)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(md)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "nvidia_smi": smi,
                       "peaks": peaks, "peak_source": PEAK_SOURCE,
                       "rows": rows}, f, indent=1)
    print(f"kernel_perf: wrote {args.out}")
    bad = faster_than_bound(rows)
    for line in bad:
        print(f"kernel_perf: FAIL faster than its bound: {line}",
              file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
