"""On-card sweep of the CUDA flash kernels' ring depth (``STAGES``).

The counterpart of ``tools/tune_flash.py``, which sweeps the Pallas
kernel's ``block_q x block_k``.  On Hopper the tiles are compile-time
constants, and ``BLOCK_M`` / ``BLOCK_N`` fix each kernel's warpgroup and
``wgmma`` layouts (changing them is a redesign, not a tune), so this sweeps
only each kernel's ring depth: the ``FLASH_STAGES`` define of
``csrc/flash_fwd.cu``, ``flash_bwd_kv.cu`` and ``flash_bwd_dq.cu``, each
variant a library of its own (``kernels.build(kernel, defines)``).  The
main path never loads a variant.

A variant's dynamic shared memory comes from its library's
``<kernel>_smem_bytes(d)`` (held equal to ``smem_model``); one over the
card's opt-in maximum per block "does not fit" and is not launched.  Every
variant that fits is held against the plain version at the tolerances
defined here, which ``chip_smoke.py``'s ``kernel`` phase and the cuda tests
import (forward out atol = rtol 1e-2, lse atol 1e-3; backward max|err| at
most ``GRAD_REL`` of max|ref| in the float32 output mode, and ``grad_limit``
in the bfloat16 one, the mode that is timed), then timed by CUDA events
in turns with SDPA.  A backward row's ``max_err`` is the float32 mode's
and the bfloat16 mode's.  Beside the variants: a plain-version row and an
SDPA row, then the best per T.

    python -m sofa_tpu_torch.tools.tune_flash [--seq 2048 16384] [--heads 8]
        [--kv_heads 0] [--dim 128] [--bwd] [--json F]

Each kernel tries its default depth and the depths beside it (2 at
least).  ``--bwd`` sweeps the backward pair, each kernel timed alone.  The plain versions run one compact KV head's group at a time, so
their [B, H/KVH, T, T] scores fit at T 16384 too.  TFLOP/s counts the
model FLOPs of ``kernel_perf.attention_flops``: 2 matmuls for the
forward, 4 for ``sofa_flash_bwd_kv`` (S, dP, dV, dK), 3 for
``sofa_flash_bwd_dq`` (S, dP, dQ), 5 for SDPA's whole backward.

Exits 1 without a card, and when a variant that fits fails to build, to
launch or to agree (the default build included: never a skipped row).
"""

from __future__ import annotations

import argparse
import json
import math
import re
import sys
from typing import Dict, List, Tuple

from sofa_tpu_torch import kernels
from sofa_tpu_torch.tools.kernel_perf import (MATMULS, cuda_ms, in_turns,
                                             nvidia_smi)

# The kernels against their plain versions (the tolerances of
# ``chip_smoke.py``'s ``kernel`` phase, of this tool and of the cuda tests).
# Forward out: bf16 storage, one ulp is 2**-8..2**-7 relative, and p rounds
# to bf16 against the running max in the kernel but the final max in the
# plain version.  The worst reading on an H100 was 7.8e-3 (one ulp at |out|
# in [1, 2)) at the Llama-3-8B and the segmented shapes.
OUT_ATOL = OUT_RTOL = 1e-2
# lse is float32 throughout in both (only summation order and the fast exp
# differ).
LSE_ATOL = 1e-3
# Backward kernels: max |err| over the largest |reference| of each gradient,
# in the float32 output mode.  Both round p and ds to bf16, but at different
# ulps where __expf and torch.exp differ, and sum in other orders.  The worst
# reading on an H100 was 3.43e-3 (dk, ragged T = 200).
GRAD_REL = 6e-3


def bf16_ulp(x: float) -> float:
    """One bfloat16 ulp (8 significand bits) at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def grad_limit(scale: float, bf16: bool) -> float:
    """The largest max|err| a backward kernel's gradient may show against
    its plain version in the same output mode, ``scale`` being the largest
    |reference|: ``GRAD_REL`` of it, and in bfloat16 one ulp of it besides
    (each side's store rounds by up to half an ulp, and one ulp at an
    element just above a power of two is up to 2**-7 of ``scale``, above
    ``GRAD_REL``: 6.02e-3 was read at T 2048, H 32 / 8 on an H100)."""
    return GRAD_REL * scale + (bf16_ulp(scale) if bf16 else 0.0)
_STAGES_RE = re.compile(r"#define FLASH_STAGES (\d+)")


def default_stages(kernel: kernels.Kernel) -> int:
    """The ring depth the kernel's default library is built with (its
    source's ``#define FLASH_STAGES``)."""
    with open(kernel.source) as f:
        m = _STAGES_RE.search(f.read())
    if m is None:
        raise ValueError(f"{kernel.source_rel} sets no FLASH_STAGES")
    return int(m.group(1))


def variant_defines(kernel: kernels.Kernel, stages: int) -> kernels.Defines:
    """The ``-D`` defines of a depth: none for the default (its library is
    the main path's)."""
    return () if stages == default_stages(kernel) else (
        ("FLASH_STAGES", stages),)


def smem_model(kernel: kernels.Kernel, d: int, stages: int) -> int:
    """Dynamic shared memory a block of ``kernel`` asks for at head dim
    ``d`` and ring depth ``stages``: each source's ``Smem<D>::BYTES``
    (128-byte panels of 64 bf16 columns, 8-byte barriers, 1024 bytes of
    alignment slack)."""
    panels = d // 64
    if kernel is kernels.FLASH_FWD:        # Q; per stage K and V
        tiles = panels * 128 * 128 * (1 + 2 * stages)
        return tiles + 8 * (1 + 3 * stages) + 1024
    if kernel is kernels.FLASH_BWD_KV:     # K, V; per stage Q, dO, aux rows
        tiles = panels * (2 * 128 + stages * 2 * 64) * 128
        return tiles + stages * 3 * 64 * 4 + 8 * (1 + 2 * stages) + 1024
    if kernel is kernels.FLASH_BWD_DQ:     # Q, dO; per stage K, V, seg ids
        tiles = panels * (2 * 128 + stages * 2 * 64) * 128
        return tiles + stages * 64 * 4 + 8 * (1 + 2 * stages) + 1024
    raise ValueError(f"no shared-memory model for {kernel.name}")


def fits(smem: int, optin: int) -> bool:
    return smem <= optin


def mode_kernels(bwd: bool) -> List[kernels.Kernel]:
    return [kernels.FLASH_BWD_KV, kernels.FLASH_BWD_DQ] if bwd \
        else [kernels.FLASH_FWD]


def variants(bwd: bool) -> List[Tuple[kernels.Kernel, int]]:
    """(kernel, depth) of every variant a mode sweeps: the default depth
    and its neighbours of 2 or more, per kernel of the mode."""
    out = []
    for k in mode_kernels(bwd):
        dflt = default_stages(k)
        out += [(k, s) for s in (dflt - 1, dflt, dflt + 1) if s >= 2]
    return out


def all_variant_builds() -> List[Tuple[kernels.Kernel, kernels.Defines]]:
    """The (kernel, defines) of every non-default library the sweep of
    both modes loads (what ``chip_smoke.py`` builds beside the defaults)."""
    return [(k, variant_defines(k, s))
            for bwd in (False, True) for k, s in variants(bwd)
            if variant_defines(k, s)]


def _inputs(b, t, h, kvh, d, seed=0):
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return [torch.randn(b, t, n, d, generator=g, device="cuda")
            .to(torch.bfloat16) for n in (h, kvh, kvh, h)]


def _close_fwd(got, ref) -> Tuple[bool, float]:
    import torch

    (out, lse), (r_out, r_lse) = got, ref
    err = (out.float() - r_out.float()).abs()
    ok = bool((err <= OUT_ATOL + OUT_RTOL * r_out.float().abs()).all()) \
        and (lse - r_lse).abs().max().item() <= LSE_ATOL \
        and bool(torch.isfinite(out.float()).all())
    return ok, err.max().item()


def _close_bwd(got, ref) -> Tuple[bool, float]:
    """Each gradient within ``grad_limit`` of its output mode; the worst
    max|err| over max|ref|."""
    import torch

    ok, worst = True, 0.0
    for a, r in zip(got, ref):
        bf16 = a.dtype == torch.bfloat16
        a, r = a.float(), r.float()
        scale = r.abs().max().item()
        err = (a - r).abs().max().item()
        if not bool(torch.isfinite(a).all()):
            return False, float("inf")
        ok = ok and err <= grad_limit(scale, bf16)
        worst = max(worst, err / scale if scale else err)
    return ok, worst


class Sweep:
    """One T's inputs, the launchers of every kernel's variants, the plain
    versions and SDPA's yardstick."""

    def __init__(self, b, t, h, kvh, d, bwd: bool):
        import torch

        from sofa_tpu_torch.workloads import flash_cuda as fc

        self.fc, self.bwd, self.h, self.kvh = fc, bwd, h, kvh
        self.q, self.k, self.v, self.g = _inputs(b, t, h, kvh, d)
        out, self.lse = fc._flash_forward(self.q, self.k, self.v, 0, True)
        self.delta = (self.g.float() * out.float()).sum(-1) \
            .transpose(1, 2).contiguous()
        self.sdpa_args = [x.transpose(1, 2).contiguous()
                          for x in (self.q, self.k, self.v)]
        if bwd:
            for x in self.sdpa_args:
                x.requires_grad_(True)
            self.sdpa_out = torch.nn.functional.scaled_dot_product_attention(
                *self.sdpa_args, is_causal=True, enable_gqa=True)
            self.g_t = self.g.transpose(1, 2).contiguous()

    def launch(self, kernel, defines, grad_dtype=None):
        """The kernel's outputs, from the library built with ``defines``
        (a backward kernel's gradients in ``grad_dtype``)."""
        fc = self.fc
        bwd = (self.q, self.k, self.v, self.g, self.lse, self.delta, 0,
               None, None, grad_dtype)
        if kernel is kernels.FLASH_FWD:
            return fc._flash_forward_cuda(self.q, self.k, self.v, 0,
                                          static_causal=True,
                                          defines=defines)
        if kernel is kernels.FLASH_BWD_KV:
            return fc._flash_bwd_kv_cuda(*bwd, static_causal=True,
                                         defines=defines)
        return (fc._flash_bwd_dq_cuda(*bwd, static_causal=True,
                                      defines=defines),)

    def plain(self, kernel, grad_dtype=None):
        """The kernel's outputs from its plain version, one compact KV
        head's query group at a time (the groups are independent)."""
        import torch

        fc, rep = self.fc, self.h // self.kvh
        parts = []
        for j in range(self.kvh):
            hs, ks = slice(j * rep, (j + 1) * rep), slice(j, j + 1)
            q, g = self.q[:, :, hs], self.g[:, :, hs]
            k, v = self.k[:, :, ks], self.v[:, :, ks]
            if kernel is kernels.FLASH_FWD:
                parts.append(fc._flash_forward_plain(q, k, v, 0))
                continue
            args = (q, k, v, g, self.lse[:, hs], self.delta[:, hs], 0,
                    None, None, grad_dtype)
            parts.append(fc._flash_bwd_kv_plain(*args)
                         if kernel is kernels.FLASH_BWD_KV
                         else (fc._flash_bwd_dq_plain(*args),))
        # out [B,T,H,D] and lse [B,H,T]; dk, dv, dq along their heads
        dims = (2, 1) if kernel is kernels.FLASH_FWD else (2, 2)
        return tuple(torch.cat([p[i] for p in parts], dims[i])
                     for i in range(len(parts[0])))

    def library(self):
        import torch

        if self.bwd:
            return torch.autograd.grad(self.sdpa_out, self.sdpa_args,
                                       self.g_t, retain_graph=True)
        return torch.nn.functional.scaled_dot_product_attention(
            *self.sdpa_args, is_causal=True, enable_gqa=True)


def sweep_seq(t, args, optin, log) -> Tuple[List[dict], List[str]]:
    """Every variant of one T: (rows, failures)."""
    import torch

    h, d = args.heads, args.dim
    kvh = args.kv_heads or h
    b = max(1, 2048 * 4 // t)              # as the JAX tool: total tokens
    mode = "bwd" if args.bwd else "fwd"
    matmul = 2.0 * b * h * t * t * d * 0.5     # one causal matmul's FLOPs
    sw = Sweep(b, t, h, kvh, d, args.bwd)
    rows, failures = [], []

    def add(variant, ms, counted, kernel=None, extra=None):
        rows.append({"seq": t, "mode": mode, "variant": variant,
                     "kernel": kernel, "ms": ms,
                     "tflops": MATMULS[counted] * matmul / ms / 1e9,
                     **(extra or {})})
        log(f"T={t:6d} {mode} {variant:32s} {ms:8.4f} ms "
            f"{rows[-1]['tflops']:6.1f} TF/s" + "".join(
                f" {k} {v}" for k, v in (extra or {}).items()))

    def fail(name, what):
        failures.append(f"T={t} {name}: {what}")
        log(f"T={t:6d} {mode} {name}: FAIL {what}")

    check = _close_bwd if args.bwd else _close_fwd
    # A backward kernel is held in both output modes: float32 at GRAD_REL
    # (its arithmetic), then bfloat16 (what is timed, and what the main
    # path runs) at grad_limit, which adds the store's rounding.
    modes = (torch.float32, None) if args.bwd else (None,)
    refs: Dict[Tuple[str, object], tuple] = {}
    for kernel, stages in variants(args.bwd):
        defines = variant_defines(kernel, stages)
        name = f"{kernel.name} STAGES={stages}" + (
            "" if defines else " (default)")
        try:
            smem = kernels.smem_bytes(kernel, d, defines)
        except (OSError, RuntimeError) as e:
            fail(name, f"build: {str(e).splitlines()[0][:200]}")
            continue
        if smem != smem_model(kernel, d, stages):
            fail(name, f"the library asks {smem} bytes of shared memory, "
                 f"smem_model {smem_model(kernel, d, stages)}")
        if not fits(smem, optin):
            log(f"T={t:6d} {mode} {name}: does not fit ({smem:,} bytes of "
                f"shared memory a block > the card's {optin:,}); not "
                "launched")
            continue
        errs, ok = [], True
        try:
            for grad_dtype in modes:
                got = sw.launch(kernel, defines, grad_dtype)
                torch.cuda.synchronize()
                key = (kernel.name, grad_dtype)
                if key not in refs:
                    refs[key] = sw.plain(kernel, grad_dtype)
                agrees, err = check(got, refs[key])
                del got
                ok = ok and agrees
                errs.append(f"{err:.3e}")
        except (RuntimeError, ValueError, TypeError) as e:
            fail(name, f"launch: {e}")
            continue
        if not ok:
            fail(name, f"disagrees with the plain version ({'/'.join(errs)})")
        (k1, k2), (l1, l2) = in_turns(lambda: sw.launch(kernel, defines),
                                      sw.library)
        add(name, (k1 + k2) / 2, kernel.name, kernel.name,
            {"smem": smem, "max_err": "/".join(errs), "agrees": ok,
             "turns": f"{k1:.4f}/{k2:.4f}",
             "sdpa_ms": f"{(l1 + l2) / 2:.4f}"})
    refs.clear()
    for kernel in mode_kernels(args.bwd):
        add(f"{kernel.name} plain", cuda_ms(lambda: sw.plain(kernel),
                                            iters=3, warmup=1), kernel.name)
    add("sdpa", cuda_ms(sw.library, iters=20), f"sdpa {mode}")
    return rows, failures


def best_per_seq(results, seqs) -> List[str]:
    """The fastest variant of each (T, kernel): the ranking's lines."""
    lines = []
    for t in seqs:
        kerns = sorted({r["kernel"] for r in results
                        if r["seq"] == t and r["kernel"]})
        if not kerns:
            lines.append(f"  T={t}: every variant failed or did not fit")
        for kern in kerns:
            rs = [r for r in results if r["seq"] == t
                  and r["kernel"] == kern and r.get("agrees")]
            if not rs:
                continue
            best = min(rs, key=lambda r: r["ms"])
            lines.append(f"  T={t} {kern}: {best['variant']} "
                         f"{best['ms']:.4f} ms ({best['tflops']:.1f} TF/s)")
    return lines


def main(argv=None, log=print) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seq", type=int, nargs="+", default=[2048, 16384])
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--kv_heads", type=int, default=0,
                   help="compact KV heads (GQA); 0 = same as --heads")
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--bwd", action="store_true",
                   help="sweep the backward pair instead of the forward")
    p.add_argument("--json", default="")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("tune_flash: requires a CUDA device (the kernels have no CPU "
              "mode)", file=sys.stderr)
        return 1
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    log(f"tune_flash: {torch.cuda.get_device_name(0)} | nvidia-smi: "
        f"{nvidia_smi()} | shared memory a block (opt-in) {optin:,} bytes")
    results, failures = [], []
    for t in args.seq:
        rows, bad = sweep_seq(t, args, optin, log)
        results += rows
        failures += bad
    log("\nbest per seq:")
    for line in best_per_seq(results, args.seq):
        log(line)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"results": results, "failures": failures}, f,
                      indent=1)
    for line in failures:
        print(f"tune_flash: FAIL {line}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
