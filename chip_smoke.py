#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``sofa_tpu_torch``).

    python3 chip_smoke.py          # one H100, no arguments

Phases, all of them, in order; any failure raises and exits non-zero:

  device   the card's name and power limit; builds the CUDA kernel from
           the source in the checkout
  kernel   holds each kernel against its plain PyTorch version at the
           shapes the main path gives it and at the mask edge cases, and
           times kernel, plain version, bound and one library call
  model    the main path: the Llama-3-8B-width decoder forward with the
           fused kernel, then 4 requests through the KV-cache serving
           loop; launch counts are zeroed just before and read just after.
           Then checks the logits against the plain-attention forward,
           the prefill's last-position logits against the forward's, and
           the first served token against the forward's argmax (exactly)
  profile  ``python -m sofa_tpu_torch stat`` over the flagship forward and
           a short serving run; checks the device trace, steps and features

The last lines are the kernels JSON, the nvidia-smi line, and the result
JSON.  It exits non-zero without a result when no CUDA device is visible.
Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
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
        kern = kernels.FLASH_FWD
        t0 = time.perf_counter()
        report = kernels.build(kern)
        log(f"device: built {kern.name} in {time.perf_counter() - t0:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {kern.name}: {line.strip()}")

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
        llama_err, _, _ = compare("llama3_8b B4 T2048 H32/8 D128", q, k, v, 0)
        compare("entry B4 T512 H8/4 D64",
                *self.flash_inputs(4, 512, 8, 4, 64, seed=2), 0)
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

        # times at the Llama shape; SDPA is a yardstick only
        bq, tq, hq, dq = q.shape
        ms = cuda_ms(lambda: _flash_forward(q, k, v, 0), iters=20)
        plain_ms = cuda_ms(lambda: _flash_forward_plain(q, k, v, 0), iters=3,
                           warmup=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                          enable_gqa=True), iters=20)
        flops = 4.0 * bq * hq * dq * tq * (tq + 1) / 2   # visible pairs only
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel()) \
            + 4.0 * bq * hq * tq
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
        bound_ms = 1e3 * max(t_ops, t_bytes)
        log(f"kernel: llama3_8b shape kernel_ms {ms:.4f} plain_ms "
            f"{plain_ms:.4f} library_ms (SDPA) {library_ms:.4f} bound_ms "
            f"{bound_ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s, "
            f"{100 * bound_ms / ms:.1f}% of bound) | {self.smi}")
        kern = kernels.FLASH_FWD
        self.kernel_rows[kern.name] = {
            "name": kern.name, "route": "cuda",
            "source": kern.source_rel, "replaces": kern.replaces,
            "launches": None, "max_abs_err": llama_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}

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
        for name, n in counts.items():
            self.kernel_rows[name]["launches"] = n
        log(f"model: main path launches {json.dumps(counts)}")
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
        want = last.argmax(-1)
        got = served[:, 0]
        exact = int((got == want).sum())
        log(f"model: prefill last-position logits rel err {pre_rel:.3e} "
            f"(limit {LOGITS_REL}); served {tuple(served.shape)} tokens, "
            f"first token equals the forward's argmax for {exact}/{batch} "
            f"requests")
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

    def profile(self):
        import pandas as pd

        logdir = os.path.join(REPO, "build", "chip_smoke_profile")
        shutil.rmtree(logdir, ignore_errors=True)
        steps = 3
        cmd = (f"{sys.executable} -m sofa_tpu_torch.entry --steps {steps} "
               "--serve_requests 4 --serve_layers 2 "
               "--prompt 128 --new_tokens 8")
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
        log(f"profile: stat rc {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s")
        if proc.returncode != 0 or "Complete!!" not in out:
            raise AssertionError("sofa_tpu_torch stat failed")
        gpu = pd.read_csv(os.path.join(logdir, "gputrace.csv"))
        kern = gpu[gpu["copyKind"] == 0]
        flash = kern[kern["name"].astype(str).str.contains("sofa_flash_fwd")]
        steps_df = pd.read_csv(os.path.join(logdir, "gpusteps.csv"))
        feats = pd.read_csv(os.path.join(logdir, "features.csv"))
        feats = dict(zip(feats["name"], feats["value"]))
        log(f"profile: gputrace {len(gpu)} rows, {len(kern)} kernels, "
            f"{len(flash)} sofa_flash_fwd; gpusteps {len(steps_df)} rows; "
            + ", ".join(f"{k} {feats.get(k)}" for k in (
                "gpu_busy_pct", "gpu_step_busy_pct", "serving_prefill_time",
                "serving_decode_time", "serving_decode_calls",
                "serving_ttft")))
        # where the device time goes inside the annotated ranges (steps,
        # prefill, decode), outside start-up and weight init
        module = kern["module"].fillna("").astype(str)
        ranged = kern[module != ""]
        per_range = ranged.groupby(module[module != ""].str.replace(
            r"_\d+$", "_N", regex=True))["duration"].agg(["sum", "count"])
        for name, row in per_range.iterrows():
            log(f"profile: range {name:<12} {row['sum'] * 1e3:9.3f} ms "
                f"device time in {int(row['count'])} kernels")
        top = ranged.groupby("name")["duration"].agg(["sum", "count"]) \
            .sort_values("sum", ascending=False)
        for name, row in top.head(8).iterrows():
            log(f"profile: top kernel {row['sum'] * 1e3:9.3f} ms "
                f"x{int(row['count']):5d}  {str(name)[:90]}")
        if kern.empty or flash.empty:
            raise AssertionError("no sofa_flash_fwd kernel rows in gputrace")
        if len(steps_df) != steps:
            raise AssertionError(f"gpusteps has {len(steps_df)} rows, "
                                 f"expected {steps}")
        if not feats.get("gpu_busy_pct", 0) > 0:
            raise AssertionError("gpu_busy_pct is not positive")
        for key in ("serving_prefill_time", "serving_decode_time"):
            if key not in feats:
                raise AssertionError(f"features.csv lacks {key}")


PHASES = ("device", "kernel", "model", "profile")


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
