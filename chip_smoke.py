#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``sofa_tpu_torch``).

    python3 chip_smoke.py          # one H100, no arguments

Phases, all of them, in order; any failure raises and exits non-zero:

  device   the card's name and power limit; builds the three CUDA kernels
           from the sources in the checkout (one nvcc each, all at once)
  kernel   holds each kernel against its plain PyTorch version at the
           shapes the main paths give it and at the mask and tiling edge
           cases, checks that every kernel is deterministic (two launches
           bit-identical), and times kernel and one library call in turns
           (kernel, library, library, kernel), the plain version and the
           bound; logs the backward pair's sum against SDPA's backward
  model    the serving path: the Llama-3-8B-width decoder forward with the
           fused kernel, then 4 requests through the KV-cache serving
           loop; launch counts are zeroed just before and read just after.
           Then checks the logits against the plain-attention forward,
           the prefill's last-position logits against the forward's, and
           the first served token against the forward's argmax (exactly:
           its forward logit must be the maximum; bf16 logits may tie)
  train    the training path: Llama-3-8B width cut to 4 layers, 5 AdamW
           steps on B 4 x T 2048 after one warm-up; launch counts are
           zeroed just before the 5 steps and read just after, and the loss
           must descend; each step is timed by the host clock and between
           CUDA events (median and spread).  Then fused-vs-plain-attention
           gradients (dense and packed) and remat-vs-no-remat loss and
           gradients
  profile  ``python -m sofa_tpu_torch stat`` over the flagship forward with
           a short serving run, and over the training workload's ``main``;
           checks the device traces, steps and features

The last lines are the kernels JSON, the nvidia-smi line, and the result
JSON.  It exits non-zero without a result when no CUDA device is visible.
Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12        # H100 SXM HBM3
# bf16 storage: one ulp is 2**-8..2**-7 relative, and p rounds to bf16
# against the running max in the kernel but the final max in the plain
# version.  The worst reading on an H100 was 7.8e-3 (one ulp at |out| in
# [1, 2)) at the Llama-3-8B and the segmented shapes.
OUT_ATOL = OUT_RTOL = 1e-2
# lse is float32 throughout in both (only summation order and the fast exp
# differ).
LSE_ATOL = 1e-3
# Decoder logits after 32 bf16 layers, fused vs plain attention (and the
# serving prefill, whose cache attention is plain, vs the fused forward):
# relative Frobenius error of the logits.  The fused-vs-plain reading on an
# H100 was 1.9e-2.
LOGITS_REL = 3e-2
# Backward kernels vs their plain versions: max |err| over the largest
# |reference| of each gradient.  Both round p and ds to bf16, but at
# different ulps where __expf and torch.exp differ, and sum in other orders.
# The worst reading on an H100 was 3.43e-3 (dk, ragged T = 200).
GRAD_REL = 6e-3
# Per-leaf gradients of the 4-layer Llama-width loss at B1 T2048, fused vs
# plain attention: relative Frobenius error (worst reading on an H100
# 5.37e-3, the embedding, dense), and the loss's relative difference
# (worst reading 2.9e-5).
TRAIN_GRAD_REL = 1e-2
TRAIN_LOSS_REL = 6e-5
# Remat vs no remat replays the same deterministic kernels and cuBLAS calls
# on the same inputs: the loss and every gradient must be bit-identical (the
# reading on an H100 was 0 for all of them).
REMAT_REL = 0.0


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


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


def _leaf_names(tree, prefix=()):
    """Key paths of a nested param dict, in param_leaves order."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaf_names(val, prefix + (key,))
        else:
            yield prefix + (key,)


class Smoke:
    def __init__(self):
        import torch

        self.torch = torch
        self.dev = torch.device("cuda")
        self.smi = ""
        self.kernel_rows = {}

    # -- helpers --------------------------------------------------------------
    def gen(self, seed: int):
        g = self.torch.Generator(device=self.dev)
        g.manual_seed(seed)
        return g

    def flash_inputs(self, b, t, h, kvh, d, seed, tk=None):
        torch = self.torch
        g = self.gen(seed)
        tk = t if tk is None else tk
        q = torch.randn(b, t, h, d, generator=g, device=self.dev)
        k = torch.randn(b, tk, kvh, d, generator=g, device=self.dev)
        v = torch.randn(b, tk, kvh, d, generator=g, device=self.dev)
        return [x.to(torch.bfloat16) for x in (q, k, v)]

    # -- phases ---------------------------------------------------------------
    def device(self):
        from sofa_tpu_torch import kernels

        self.smi = nvidia_smi()
        log(f"device: {self.torch.cuda.get_device_name(0)} | nvidia-smi: "
            f"{self.smi} | torch {self.torch.__version__} cuda "
            f"{self.torch.version.cuda}")
        t0 = time.perf_counter()
        reports = kernels.build_all(kernels.KERNELS)
        log(f"device: built {', '.join(reports)} in "
            f"{time.perf_counter() - t0:.2f} s (one nvcc each, in parallel)")
        for kern in kernels.KERNELS:
            for line in reports[kern.name].splitlines():
                if any(w in line for w in ("registers", "spill", "smem",
                                           "wgmma", "arning")):
                    log(f"  {kern.name}: {line.strip()}")
            log(f"  {kern.name}: dynamic shared memory a block, D 64 / D 128 "
                f"(from the library): {kernels.smem_bytes(kern, 64)} / "
                f"{kernels.smem_bytes(kern, 128)} bytes")

    def kernel(self):
        torch = self.torch
        from sofa_tpu_torch import kernels
        from sofa_tpu_torch.workloads.flash_cuda import (
            _flash_forward, _flash_forward_plain)

        def compare(label, q, k, v, shift, seg=None):
            out, lse = _flash_forward(q, k, v, shift, segment_ids=seg)
            seg32 = None if seg is None else seg.to(torch.int32)
            ref_out, ref_lse = _flash_forward_plain(q, k, v, shift, seg32,
                                                    seg32)
            torch.cuda.synchronize()
            err = (out.float() - ref_out.float()).abs()
            lim = OUT_ATOL + OUT_RTOL * ref_out.float().abs()
            lse_err = (lse - ref_lse).abs().max().item()
            ok = bool((err <= lim).all()) and lse_err <= LSE_ATOL \
                and bool(torch.isfinite(out.float()).all())
            log(f"kernel: {label:<34} out max|err| {err.max().item():.3e} "
                f"lse max|err| {lse_err:.3e} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"sofa_flash_fwd disagrees with its "
                                     f"plain version at {label}")
            return err.max().item(), out, lse

        # the main path's shapes: Llama-3-8B attention, the entry forward
        q, k, v = self.flash_inputs(4, 2048, 32, 8, 128, seed=1)
        llama_err, out, lse = compare("llama3_8b B4 T2048 H32/8 D128", q, k,
                                      v, 0)
        again = _flash_forward(q, k, v, 0)
        same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        log(f"kernel: determinism: a second launch on the same inputs gives "
            f"bit-identical out and lse: {same}")
        if not same:
            raise AssertionError("sofa_flash_fwd is not deterministic")
        del out, lse, again
        entry = self.flash_inputs(4, 512, 8, 4, 64, seed=2)
        compare("entry B4 T512 H8/4 D64", *entry, 0)
        # mask edges: full (shift >= T), nothing visible (shift <= -T)
        compare("full shift=T B2 T256 H8/2 D128",
                *self.flash_inputs(2, 256, 8, 2, 128, seed=3), 256)
        _, out, lse = compare("masked shift=-T B2 T256 H8/2 D64",
                              *self.flash_inputs(2, 256, 8, 2, 64, seed=4),
                              -256)
        if out.abs().max().item() != 0 or lse.max().item() > -1e29:
            raise AssertionError("fully masked rows must give out 0 and "
                                 "lse <= -1e29")
        # packed segments (contiguous runs) and a ragged T
        b, t = 2, 512
        seg = (torch.rand(b, t, generator=self.gen(5), device=self.dev)
               < 0.02).to(torch.int64).cumsum(dim=1)
        compare("segmented B2 T512 H8/4 D64",
                *self.flash_inputs(b, t, 8, 4, 64, seed=6), 0, seg)
        compare("ragged T=200 B2 H8/2 D128",
                *self.flash_inputs(2, 200, 8, 2, 128, seed=7), 0)
        compare("ragged cache Tk=333 T=77 shift=256 D128",
                *self.flash_inputs(2, 77, 8, 2, 128, seed=8, tk=333), 256)
        # the edges of the 128-row / 128-key tiling: one row, one row past
        # a tile, one key, shifts that cut a tile, segment boundaries inside
        # and across tiles, D 64 with a ragged T
        compare("T=1 B2 H8/2 D128",
                *self.flash_inputs(2, 1, 8, 2, 128, seed=31), 0)
        compare("T=129 B2 H8/2 D128",
                *self.flash_inputs(2, 129, 8, 2, 128, seed=32), 0)
        compare("Tk=1 T=64 B2 H8/2 D128",
                *self.flash_inputs(2, 64, 8, 2, 128, seed=33, tk=1), 0)
        compare("shift=-1 B2 T300 H8/2 D128",
                *self.flash_inputs(2, 300, 8, 2, 128, seed=34), -1)
        compare("shift=37 B2 T300 H8/2 D128",
                *self.flash_inputs(2, 300, 8, 2, 128, seed=35), 37)
        t = 400
        seg = torch.tensor([0] * 100 + [1] * 150 + [2] * 20 + [3] * 130,
                           device=self.dev).expand(2, t)
        compare("segments at 100/250/270 B2 T400 D128",
                *self.flash_inputs(2, t, 8, 2, 128, seed=36), 0, seg)
        compare("D64 T=200 B2 H8/4",
                *self.flash_inputs(2, 200, 8, 4, 64, seed=37), 0)

        # times at the Llama shape, in turns with SDPA (a yardstick only)
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def timed(label, q, k, v, iters=20):
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            (k1, k2), (l1, l2) = in_turns(
                lambda: _flash_forward(q, k, v, 0),
                lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
                iters)
            bq, tq, hq, dq = q.shape
            flops = 4.0 * bq * hq * dq * tq * (tq + 1) / 2   # visible pairs
            nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel()) \
                + 4.0 * bq * hq * tq
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
            bound_ms = 1e3 * max(t_ops, t_bytes)
            ms, library_ms = (k1 + k2) / 2, (l1 + l2) / 2
            log(f"kernel: {label} in turns: kernel_ms {k1:.4f} / {k2:.4f}, "
                f"library_ms (SDPA) {l1:.4f} / {l2:.4f}; kernel/SDPA "
                f"{ms / library_ms:.3f}; bound_ms {bound_ms:.4f} "
                f"({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% "
                f"of bound) | {self.smi}")
            return ms, library_ms, bound_ms, t_ops >= t_bytes

        timed("entry B4 T512 H8/4 D64", *entry)
        ms, library_ms, bound_ms, by_ops = timed("llama3_8b shape", q, k, v)
        plain_ms = cuda_ms(lambda: _flash_forward_plain(q, k, v, 0), iters=3,
                           warmup=1)
        log(f"kernel: llama3_8b shape plain_ms {plain_ms:.4f}")
        kern = kernels.FLASH_FWD
        self.kernel_rows[kern.name] = {
            "name": kern.name, "route": "cuda",
            "source": kern.source_rel, "replaces": kern.replaces,
            "launches": None, "max_abs_err": llama_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if by_ops else "bytes",
            "library_ms": library_ms}
        self.kernel_backward()

    def kernel_backward(self):
        torch = self.torch
        from sofa_tpu_torch import kernels
        from sofa_tpu_torch.workloads.flash_cuda import (
            _flash_bwd_dq_cuda, _flash_bwd_dq_plain, _flash_bwd_kv_cuda,
            _flash_bwd_kv_plain, _flash_forward)

        def inputs(b, t, h, kvh, d, seed, shift=0, tk=None, seg=None,
                   hop=False):
            """hop: delta from another output, as in a ring hop, where it
            comes from the whole sequence's output.  A row that sees one
            key has p = 1 and dp = delta up to rounding when delta is its
            own (out = v), so its dq and dk are rounding noise; with a hop's
            delta they are not."""
            q, k, v = self.flash_inputs(b, t, h, kvh, d, seed, tk)
            g = self.flash_inputs(b, t, h, kvh, d, seed + 100)[0]
            out, lse = _flash_forward(q, k, v, shift, shift <= 0, seg)
            if hop:
                out = self.flash_inputs(b, t, h, kvh, d, seed + 200)[0]
            seg32 = None if seg is None else seg.to(torch.int32).contiguous()
            delta = (g.float() * out.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            return (q, k, v, g, lse, delta, shift, seg32, seg32)

        def compare(label, args, f32=False):
            gd = torch.float32 if f32 else None
            got = (*_flash_bwd_kv_cuda(*args, gd), _flash_bwd_dq_cuda(*args, gd))
            ref = (*_flash_bwd_kv_plain(*args, gd), _flash_bwd_dq_plain(*args, gd))
            torch.cuda.synchronize()
            errs, rels, ok = {}, {}, True
            for name, a, r in zip(("dk", "dv", "dq"), got, ref):
                a, r = a.float(), r.float()
                err = (a - r).abs().max().item()
                scale = r.abs().max().item()
                rels[name] = err / scale if scale else (0.0 if err == 0
                                                        else float("inf"))
                errs[name] = err
                ok = ok and bool(torch.isfinite(a).all()) \
                    and rels[name] <= GRAD_REL and got[0].dtype == (
                        torch.float32 if f32 else torch.bfloat16)
            log(f"kernel: bwd {label:<34} max|err|/max|ref| " + " ".join(
                f"{n} {rels[n]:.3e}" for n in rels) + " (max|err| " +
                " ".join(f"{n} {errs[n]:.3e}" for n in errs) +
                f") -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"backward kernels disagree with their "
                                     f"plain versions at {label}")
            return errs, got

        def deterministic(label, args):
            """Two launches of each backward kernel on the same inputs must
            agree bit for bit (remat replays the backward)."""
            first = (*_flash_bwd_kv_cuda(*args), _flash_bwd_dq_cuda(*args))
            second = (*_flash_bwd_kv_cuda(*args), _flash_bwd_dq_cuda(*args))
            same = {n: torch.equal(a, b) for n, a, b in
                    zip(("dk", "dv", "dq"), first, second)}
            log(f"kernel: bwd determinism {label}: a second launch of each "
                f"kernel gives bit-identical " + " ".join(
                    f"{n} {s}" for n, s in same.items()))
            if not all(same.values()):
                raise AssertionError(f"the backward kernels are not "
                                     f"deterministic at {label}")

        llama = inputs(4, 2048, 32, 8, 128, seed=11)
        llama_errs, _ = compare("llama3_8b B4 T2048 H32/8 D128", llama)
        deterministic("llama3_8b B4 T2048 H32/8 D128", llama)
        compare("entry B8 T512 H8/4 D64", inputs(8, 512, 8, 4, 64, seed=12))
        compare("full shift=T B2 T256 H8/2 D128",
                inputs(2, 256, 8, 2, 128, seed=13, shift=256))
        _, masked = compare("masked shift=-T B2 T256 H8/2 D64",
                            inputs(2, 256, 8, 2, 64, seed=14, shift=-256))
        if any(x.float().abs().max().item() != 0 for x in masked):
            raise AssertionError("fully masked rows must give exactly zero "
                                 "gradients")
        b, t = 2, 512
        seg = (torch.rand(b, t, generator=self.gen(15), device=self.dev)
               < 0.02).to(torch.int64).cumsum(dim=1)
        segmented = inputs(b, t, 8, 4, 64, seed=16, seg=seg)
        compare("segmented B2 T512 H8/4 D64", segmented)
        deterministic("segmented B2 T512 H8/4 D64", segmented)
        del segmented
        compare("ragged T=200 B2 H8/2 D128",
                inputs(2, 200, 8, 2, 128, seed=17))
        compare("ring hop T256 Tk512 shift=256 D128",
                inputs(2, 256, 8, 2, 128, seed=18, shift=256, tk=512))
        compare("grad_dtype=f32 B2 T256 H8/2 D128",
                inputs(2, 256, 8, 2, 128, seed=19), f32=True)
        # the edges of the backward tiling (dK/dV: 128-key blocks of two
        # 64-key warpgroups over 64-query tiles; dQ: 128-row blocks of two
        # 64-row warpgroups over 64-key tiles): one row, one row past a
        # tile, a ragged T at both head dims, one key, shifts that cut a
        # tile, GQA groups of 1 and 8, segment boundaries off the tile edges
        compare("T=1 ring-hop delta B2 H8/2 D128",
                inputs(2, 1, 8, 2, 128, seed=41, hop=True))
        compare("T=129 B2 H8/2 D128", inputs(2, 129, 8, 2, 128, seed=42))
        compare("T=129 B2 H8/4 D64", inputs(2, 129, 8, 4, 64, seed=43))
        compare("T=200 B2 H8/4 D64", inputs(2, 200, 8, 4, 64, seed=44))
        compare("Tk=1 T=64 ring-hop delta B2 H8/2 D128",
                inputs(2, 64, 8, 2, 128, seed=45, tk=1, hop=True))
        compare("shift=-1 B2 T300 H8/2 D128",
                inputs(2, 300, 8, 2, 128, seed=46, shift=-1))
        compare("shift=37 B2 T300 H8/2 D128",
                inputs(2, 300, 8, 2, 128, seed=47, shift=37))
        compare("GQA group 1 B2 T300 H8/8 D128",
                inputs(2, 300, 8, 8, 128, seed=48))
        compare("GQA group 8 B2 T300 H16/2 D64",
                inputs(2, 300, 16, 2, 64, seed=49))
        t = 400
        seg = torch.tensor([0] * 100 + [1] * 150 + [2] * 20 + [3] * 130,
                           device=self.dev).expand(2, t)
        compare("segments at 100/250/270 B2 T400 D128",
                inputs(2, t, 8, 2, 128, seed=50, seg=seg))

        # times at the Llama training shape; SDPA's backward is a yardstick
        q, k, v, g = llama[:4]
        bq, tq, hq, dq = q.shape
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        o = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        gt = g.transpose(1, 2).contiguous()

        def library():
            return torch.autograd.grad(o, (qt, kt, vt), gt, retain_graph=True)

        pairs = bq * hq * tq * (tq + 1) / 2          # visible pairs only
        rows = 2.0 * bq * hq * tq * 4                 # lse and delta
        operands = 2.0 * (2 * q.numel() + k.numel() + v.numel())
        pair_ms, pair_bound, sdpa_ms = 0.0, 0.0, []
        for kern, fn, plain, flops, written, errs in (
                (kernels.FLASH_BWD_KV, _flash_bwd_kv_cuda,
                 _flash_bwd_kv_plain, 8.0 * dq * pairs,
                 2.0 * (k.numel() + v.numel()),
                 max(llama_errs["dk"], llama_errs["dv"])),
                (kernels.FLASH_BWD_DQ, _flash_bwd_dq_cuda,
                 _flash_bwd_dq_plain, 6.0 * dq * pairs, 2.0 * q.numel(),
                 llama_errs["dq"])):
            (k1, k2), (l1, l2) = in_turns(lambda: fn(*llama), library)
            ms, library_ms = (k1 + k2) / 2, (l1 + l2) / 2
            plain_ms = cuda_ms(lambda: plain(*llama), iters=3, warmup=1)
            t_ops = flops / PEAK_BF16_FLOPS
            t_bytes = (operands + rows + written) / PEAK_HBM_BYTES
            bound_ms = 1e3 * max(t_ops, t_bytes)
            log(f"kernel: {kern.name} llama3_8b shape in turns: kernel_ms "
                f"{k1:.4f} / {k2:.4f}, library_ms (SDPA backward, dq+dk+dv) "
                f"{l1:.4f} / {l2:.4f}; plain_ms {plain_ms:.4f} bound_ms "
                f"{bound_ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s, "
                f"{100 * bound_ms / ms:.1f}% of bound) | {self.smi}")
            self.kernel_rows[kern.name] = {
                "name": kern.name, "route": "cuda",
                "source": kern.source_rel, "replaces": kern.replaces,
                "launches": None, "max_abs_err": errs, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": library_ms}
            pair_ms += ms
            pair_bound += bound_ms
            sdpa_ms += [l1, l2]
        sdpa_mean = sum(sdpa_ms) / len(sdpa_ms)
        log(f"kernel: backward pair (sofa_flash_bwd_kv + sofa_flash_bwd_dq) "
            f"llama3_8b shape {pair_ms:.4f} ms against SDPA's backward "
            f"{sdpa_mean:.4f} ms (mean of {len(sdpa_ms)} readings): ratio "
            f"{pair_ms / sdpa_mean:.3f}; {100 * pair_bound / pair_ms:.1f}% of "
            f"the pair's bound {pair_bound:.4f} ms | {self.smi}")
        del llama, qt, kt, vt, o
        torch.cuda.empty_cache()

    def model(self):
        torch = self.torch
        from sofa_tpu_torch import kernels
        from sofa_tpu_torch.workloads import inference
        from sofa_tpu_torch.workloads.common import fence
        from sofa_tpu_torch.workloads.transformer import (
            TransformerConfig, forward, init_params)

        cfg = TransformerConfig.llama3_8b()
        batch, seq, prompt_len, new = 4, 2048, 1024, 32
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device=self.dev)
        fence(params["lm_head"])
        log(f"model: llama3_8b, {cfg.n_layers} layers (no depth cut), "
            f"random weights seed 0, init {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
        tokens = torch.randint(0, cfg.vocab, (batch, seq),
                               generator=self.gen(0), device=self.dev)
        prompts = tokens[:, :prompt_len].contiguous()
        scfg = dataclasses.replace(cfg, max_seq=prompt_len + new)
        inference.serve(params, prompts, scfg, new)   # warm the libraries
        forward(params, tokens, cfg)
        fence(tokens)

        # --- the main path: counts zeroed just before, read just after ---
        kernels.reset_counts()
        t0 = time.perf_counter()
        logits = forward(params, tokens, cfg)
        fence(logits)
        fwd_s = time.perf_counter() - t0
        served, pre_tps, dec_tps = inference.serve(params, prompts, scfg, new)
        fence(served)
        counts = kernels.counts()
        # -------------------------------------------------------------------
        self.kernel_rows["sofa_flash_fwd"]["launches"] = \
            counts["sofa_flash_fwd"]
        log(f"model: serving path launches {json.dumps(counts)}")
        if counts["sofa_flash_fwd"] < cfg.n_layers:
            raise AssertionError("the forward did not go through "
                                 "sofa_flash_fwd once per layer")

        t0 = time.perf_counter()
        plain = forward(params, tokens, dataclasses.replace(cfg, flash=False))
        fence(plain)
        plain_s = time.perf_counter() - t0
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite logits")
        rel = ((logits - plain).norm() / plain.norm()).item()
        agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
        log(f"model: forward B{batch} T{seq} fused {1e3 * fwd_s:.1f} ms, "
            f"plain attention {1e3 * plain_s:.1f} ms; logits rel err "
            f"{rel:.3e} (limit {LOGITS_REL}), argmax agreement "
            f"{100 * agree:.2f}%")
        if rel > LOGITS_REL:
            raise AssertionError("fused and plain logits disagree")
        del plain

        # the serving prefill's last-position logits and first served token
        # vs the fused forward's at the last prompt token
        last = forward(params, prompts, cfg)[:, -1]
        cache = inference.init_cache(scfg, batch, self.dev)
        pre_last = inference.prefill(params, prompts, cache, scfg)[0][:, -1]
        del cache
        pre_rel = ((pre_last - last).norm() / last.norm()).item()
        # The logits come out of a bf16 matmul, one ulp apart near their
        # maximum (1/32 at 4.0), so two tokens can tie exactly; every tied
        # token is then an argmax of the forward, and greedy serving may
        # pick any of them.  The served token's forward logit must equal the
        # forward's maximum exactly.
        got = served[:, 0]
        best = last.max(-1).values
        exact = int((last.gather(-1, got[:, None])[:, 0] == best).sum())
        ties = int(((last == best[:, None]).sum(-1) > 1).sum())
        for name, x in (("forward", last), ("prefill", pre_last)):
            val, idx = x.topk(2, dim=-1)
            log(f"model: {name} last-position top-2 (token, logit) per "
                "request: " + "; ".join(
                    f"({i0}, {v0:.4f}) ({i1}, {v1:.4f})"
                    for (i0, i1), (v0, v1) in zip(idx.tolist(),
                                                  val.tolist())))
        log(f"model: prefill last-position logits rel err {pre_rel:.3e} "
            f"(limit {LOGITS_REL}); served {tuple(served.shape)} tokens, "
            f"first token is an argmax of the forward's logits for "
            f"{exact}/{batch} requests ({ties} with a tie at the maximum)")
        if not pre_rel <= LOGITS_REL:
            raise AssertionError("prefill and forward logits disagree")
        if exact != batch:
            raise AssertionError("served first token is not the forward's "
                                 "argmax")
        log(f"model: serving 4 requests (prompt {prompt_len}, {new} new): "
            f"prefill {pre_tps:,.1f} tokens/s, decode {dec_tps:,.1f} "
            f"tokens/s | {self.smi}")
        del params, logits
        torch.cuda.empty_cache()

    def train(self):
        torch = self.torch
        from sofa_tpu_torch import kernels
        from sofa_tpu_torch.workloads.common import fence
        from sofa_tpu_torch.workloads.transformer import (
            TransformerConfig, build, loss_fn, param_leaves)

        full = TransformerConfig.llama3_8b()
        batch, seq, steps = 4, 2048, 5
        cfg = dataclasses.replace(full, n_layers=4, max_seq=seq)
        t0 = time.perf_counter()
        params, opt, step, tokens = build(cfg, batch, seq, seed=0,
                                          device=self.dev)
        leaves = list(param_leaves(params))
        n_params = sum(p.numel() for p in leaves)
        fence(params["lm_head"])
        log(f"train: llama3_8b width, depth cut {full.n_layers} -> "
            f"{cfg.n_layers} layers ({n_params / 1e9:.3f}e9 params: bf16 "
            f"params, grads and AdamW moments at 8 bytes each do not fit "
            f"80 GB at full depth), random weights seed 0, B{batch} "
            f"T{seq}, init {time.perf_counter() - t0:.1f} s")
        losses = []
        params, opt, loss = step(params, opt, tokens)      # warm-up
        losses.append(loss)
        fence(loss)
        torch.cuda.reset_peak_memory_stats()

        # each step is also timed on the device, between CUDA events
        # recorded on the stream before and after it
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(steps)]
        # --- the main path: counts zeroed just before, read just after ---
        kernels.reset_counts()
        t0 = time.perf_counter()
        for start, end in events:
            start.record()
            params, opt, loss = step(params, opt, tokens)
            end.record()
            losses.append(loss)
        fence(loss)
        dt = time.perf_counter() - t0
        counts = kernels.counts()
        # -------------------------------------------------------------------
        torch.cuda.synchronize()
        dev_ms = [start.elapsed_time(end) for start, end in events]
        by_ms = sorted(dev_ms)
        log(f"train: step by CUDA events: median {by_ms[steps // 2]:.3f} ms, "
            f"min {by_ms[0]:.3f}, max {by_ms[-1]:.3f} (spread "
            f"{by_ms[-1] - by_ms[0]:.3f} ms); steps " + " ".join(
                f"{x:.3f}" for x in dev_ms) + f" | {self.smi}")
        peak = torch.cuda.max_memory_allocated()
        losses = [x.item() for x in losses]
        for name in ("sofa_flash_bwd_kv", "sofa_flash_bwd_dq"):
            self.kernel_rows[name]["launches"] = counts[name]
        log(f"train: main path launches over {steps} steps "
            f"{json.dumps(counts)}")
        log(f"train: step by host clock {1e3 * dt / steps:.1f} ms, "
            f"{batch * seq * steps / dt:,.0f} tokens/s, peak "
            f"{peak / 2**30:.2f} GiB allocated, losses (warm-up first) "
            + " ".join(f"{x:.4f}" for x in losses) + f" | {self.smi}")
        want = cfg.n_layers * steps
        if any(n != want for n in counts.values()):
            raise AssertionError(f"each kernel must launch {want} times in "
                                 f"{steps} steps; got {counts}")
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"the loss did not descend: {losses}")

        def value_and_grad(c, toks, seg=None):
            loss = loss_fn(params, toks, c, seg)
            return loss.item(), torch.autograd.grad(loss, leaves)

        def rel_errs(got, ref):
            return [((a.float() - b.float()).norm() / b.float().norm()).item()
                    for a, b in zip(got, ref)]

        # fused vs plain attention at B1 (the plain scores stay small)
        names = [".".join(k) for k in _leaf_names(params)]
        one = tokens[:1]
        seg = (torch.rand(1, seq, generator=self.gen(21), device=self.dev)
               < 1 / 300).to(torch.int64).cumsum(dim=1)
        for label, s in (("dense", None), ("packed", seg)):
            lf, gf = value_and_grad(cfg, one, s)
            lp, gp = value_and_grad(dataclasses.replace(cfg, flash=False),
                                    one, s)
            rels = rel_errs(gf, gp)
            worst = max(range(len(rels)), key=rels.__getitem__)
            loss_rel = abs(lf - lp) / abs(lp)
            log(f"train: fused vs plain grads B1 T{seq} {label}: loss "
                f"{lf:.5f} vs {lp:.5f} (rel {loss_rel:.3e}, limit "
                f"{TRAIN_LOSS_REL}); grad rel err max {rels[worst]:.3e} at "
                f"{names[worst]} (limit {TRAIN_GRAD_REL}); "
                + " ".join(f"{n} {r:.2e}" for n, r in zip(names, rels)))
            if loss_rel > TRAIN_LOSS_REL or rels[worst] > TRAIN_GRAD_REL:
                raise AssertionError(f"fused and plain gradients disagree "
                                     f"({label})")
            del gf, gp

        # one remat step against the same step without remat
        torch.cuda.reset_peak_memory_stats()
        base_loss, base = value_and_grad(cfg, tokens)
        base_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        r_loss, r_grads = value_and_grad(
            dataclasses.replace(cfg, remat=True), tokens)
        torch.cuda.synchronize()
        r_counts = kernels.counts()
        r_peak = torch.cuda.max_memory_allocated()
        rels = rel_errs(r_grads, base)
        loss_rel = abs(r_loss - base_loss) / abs(base_loss)
        log(f"train: remat B{batch} T{seq}: loss {r_loss:.6f} vs "
            f"{base_loss:.6f} (rel {loss_rel:.3e}), grad rel err max "
            f"{max(rels):.3e} (limit {REMAT_REL}); launches "
            f"{json.dumps(r_counts)}; peak {r_peak / 2**30:.2f} GiB vs "
            f"{base_peak / 2**30:.2f} GiB without remat")
        if r_counts["sofa_flash_fwd"] != 2 * cfg.n_layers or any(
                r_counts[n] != cfg.n_layers
                for n in ("sofa_flash_bwd_kv", "sofa_flash_bwd_dq")):
            raise AssertionError("remat must replay each layer's forward "
                                 "kernel once in the backward")
        if loss_rel > REMAT_REL or max(rels) > REMAT_REL:
            raise AssertionError("remat changed the loss or the gradients")
        del params, opt, step, leaves, base, r_grads
        torch.cuda.empty_cache()

    def stat(self, label: str, cmd: str, steps: int, names):
        """``python -m sofa_tpu_torch stat`` over ``cmd``: checks that it
        completes, that gputrace has rows of each kernel in ``names`` and
        gpusteps ``steps`` rows; logs where the ranged device time goes.
        Returns the features."""
        import pandas as pd

        logdir = os.path.join(REPO, "build", f"chip_smoke_profile_{label}")
        shutil.rmtree(logdir, ignore_errors=True)
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "sofa_tpu_torch", "stat", "--logdir",
             logdir, cmd], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.terminate()            # record takes the profiled tree down
            try:
                proc.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
            raise
        for line in out.splitlines():
            if not line.startswith(("USDT", "STAGE:")):
                log(f"  | {line}")
        log(f"profile[{label}]: stat rc {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s")
        if proc.returncode != 0 or "Complete!!" not in out:
            raise AssertionError(f"sofa_tpu_torch stat failed ({label})")
        gpu = pd.read_csv(os.path.join(logdir, "gputrace.csv"))
        kern = gpu[gpu["copyKind"] == 0]
        kname = kern["name"].astype(str)
        found = {n: int(kname.str.contains(n).sum()) for n in names}
        steps_df = pd.read_csv(os.path.join(logdir, "gpusteps.csv"))
        feats = pd.read_csv(os.path.join(logdir, "features.csv"))
        feats = dict(zip(feats["name"], feats["value"]))
        log(f"profile[{label}]: gputrace {len(gpu)} rows, {len(kern)} "
            f"kernels, {json.dumps(found)}; gpusteps {len(steps_df)} rows; "
            + ", ".join(f"{k} {feats.get(k)}" for k in (
                "gpu_busy_pct", "gpu_step_busy_pct", "serving_prefill_time",
                "serving_decode_time", "serving_decode_calls",
                "serving_ttft") if k in feats))
        # where the device time goes inside the annotated ranges (steps,
        # prefill, decode), outside start-up and weight init
        module = kern["module"].fillna("").astype(str)
        ranged = kern[module != ""]
        per_range = ranged.groupby(module[module != ""].str.replace(
            r"_\d+$", "_N", regex=True))["duration"].agg(["sum", "count"])
        for name, row in per_range.iterrows():
            log(f"profile[{label}]: range {name:<12} "
                f"{row['sum'] * 1e3:9.3f} ms device time in "
                f"{int(row['count'])} kernels")
        top = ranged.groupby("name")["duration"].agg(["sum", "count"]) \
            .sort_values("sum", ascending=False)
        for name, row in top.head(8).iterrows():
            log(f"profile[{label}]: top kernel {row['sum'] * 1e3:9.3f} ms "
                f"x{int(row['count']):5d}  {str(name)[:90]}")
        if kern.empty or not all(found.values()):
            raise AssertionError(f"gputrace lacks rows of {found} ({label})")
        if len(steps_df) != steps:
            raise AssertionError(f"gpusteps has {len(steps_df)} rows, "
                                 f"expected {steps} ({label})")
        if not feats.get("gpu_busy_pct", 0) > 0:
            raise AssertionError(f"gpu_busy_pct is not positive ({label})")
        return feats

    def profile(self):
        from sofa_tpu_torch import kernels

        steps = 3
        feats = self.stat(
            "serve", f"{sys.executable} -m sofa_tpu_torch.entry --steps "
            f"{steps} --serve_requests 4 --serve_layers 2 --prompt 128 "
            "--new_tokens 8", steps, ["sofa_flash_fwd"])
        for key in ("serving_prefill_time", "serving_decode_time"):
            if key not in feats:
                raise AssertionError(f"features.csv lacks {key}")
        # the training workload at the JAX package's main defaults (batch 8,
        # seq 512, d 512, 4 layers, 8/4 heads: D 64)
        self.stat("train", f"{sys.executable} -m "
                  f"sofa_tpu_torch.workloads.transformer --steps {steps}",
                  steps, [k.name for k in kernels.KERNELS])


PHASES = ("device", "kernel", "model", "train", "profile")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    smoke = Smoke()
    t_all = time.perf_counter()
    for phase in PHASES:
        t0 = time.perf_counter()
        log(f"=== {phase}")
        getattr(smoke, phase)()
        log(f"=== {phase} ok in {time.perf_counter() - t0:.1f} s")
    log(f"chip_smoke: all phases in {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"kernels": list(smoke.kernel_rows.values())}))
    log(smoke.smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
