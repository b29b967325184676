"""Per-collector overhead budget of the in-process profiler.

    python -m sofa_tpu_torch.tools.overhead_budget [--workload resnet]
        [--steps 20] [--reps 6] [--out table.md] [--json rows.json]

The port of ``tools/overhead_budget.py``: a workload is timed bare, then
under one collector configuration, in interleaved pairs (the bare run right
before each configured one, so that drift cancels within the pair); each
row reports the median of the pairs' marginal overhead with its 95 %
order-statistic confidence interval, adding pairs (up to ``max_reps``)
until the interval's half-width is under ``ci_target_pct``.  Each row also
shows its pairs' bare median, and the baseline row the bare time before any
collector ran, before the first traced row and after the last: a collector
that leaves the process slower once stopped shows there, and shrinks every
later marginal (the traced rows come last for that reason; their own bare
runs after the first pair follow a trace).

Rows: the GPU memory sampler without allocation-site snapshots,
the sampler with allocation-stack recording at each setting of the sweep
(``torch.cuda.memory._record_memory_history``'s ``context`` None, "state",
"alloc", "all" by ``stacks`` "python", "all", with the alloc/free trace the
at-exit replay walks, ``enabled="all"``; then ``enabled="state"``: no
trace, the gate's snapshots alone); then the Kineto trace alone (the
collector's settings: operand shapes and flops recorded) and the whole
``api.profile()``.  The tool arms the recording itself, in its own process.

Workloads: ``resnet``, the ResNet-50 train step at batch 32, 224 x 224 (the
JAX benchmark's), and ``entry``, the flagship decoder's forward
(``sofa_tpu_torch.entry``: many small kernels).  It runs on the card unless
``--device cpu`` is given, which only exercises the mechanics (the tests
use it, at a tiny size): a CPU number is not a measurement of the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

# the memprof settings swept, in the table's order; the first entry the
# trace-and-stacks default of collectors/gpumon.py is compared against
MEMPROF_SWEEP = [
    {"enabled": "all", "context": context, "stacks": stacks}
    for context in (None, "state", "alloc", "all")
    for stacks in ("python", "all")
] + [{"enabled": "state", "context": "state", "stacks": "python"}]


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _median_ci(xs: List[float],
               conf: float = 0.95) -> "Optional[Tuple[float, float]]":
    """Distribution-free confidence interval of the median from binomial
    order statistics (normal approximation to the rank); None below 6
    samples, where a sample range is not a 95 % interval."""
    n = len(xs)
    s = sorted(xs)
    if n < 6:
        return None
    z = 1.959964 if conf >= 0.95 else 1.644854
    delta = z * math.sqrt(n) / 2.0
    lo = max(0, int(math.floor(n / 2.0 - delta)))
    hi = min(n - 1, int(math.ceil(n / 2.0 + delta)) - 1)
    return s[lo], s[hi]


def make_workload(name: str, device: str = "cuda"
                  ) -> Callable[[], torch.Tensor]:
    """A no-argument step of ``name`` ("resnet" or "entry") on ``device``;
    on the CPU the ResNet shrinks to a size it can take."""
    if name == "resnet":
        from sofa_tpu_torch.workloads import resnet

        torch.backends.cudnn.benchmark = True
        batch, size, stages = (2, 32, (1, 1, 1, 1)) if device == "cpu" \
            else (32, 224, (3, 4, 6, 3))
        model, x = resnet.create(batch, size, stage_sizes=stages,
                                 device=device)
        labels = torch.zeros(batch, dtype=torch.long, device=x.device)
        _, step = resnet.make_train_step(model)
        return lambda: step(x, labels)
    if name == "entry":
        from sofa_tpu_torch.entry import entry

        fn, args = entry(device)
        return lambda: fn(*args)
    raise ValueError(f"unknown workload {name!r}")


def _timed_once(step, n_steps: int) -> float:
    """Seconds of ``n_steps`` steps, after one untimed step."""
    from sofa_tpu_torch.workloads.common import fence

    fence(step())
    t0 = time.perf_counter()
    for _ in range(n_steps):
        out = step()
    fence(out)
    return time.perf_counter() - t0


def _label(h: Dict[str, Optional[str]]) -> str:
    return (f"gpumon @ 1 Hz + memprof enabled={h['enabled']} "
            f"context={h['context']} stacks={h['stacks']}")


def collector_configs(scratch: str):
    """(row name, setup, traced) triples; setup() starts the collectors and
    returns their teardown.  The rows with the Kineto trace come last: the
    process runs slower after a trace has stopped (PERF.md §5), which
    would slow every later row's bare runs."""
    from sofa_tpu_torch import api
    from sofa_tpu_torch.collectors import gpumon, kineto

    def with_kineto():
        state = kineto.start_trace(torch, scratch)
        if state is None:
            raise RuntimeError("the profiler did not start")
        return lambda: kineto.stop_trace(torch, state)

    def with_gpumon(history=None):
        ev = threading.Event()
        memprof = None
        if history is not None:
            gpumon.arm_history(torch, history)
            memprof = os.path.join(scratch, "memprof.pb.gz")
        t = gpumon.start_sampler(1, os.path.join(scratch, "gpumon.txt"), ev,
                                 memprof_path=memprof)

        def teardown():
            # joined, so that a last tick (and a stop-the-world snapshot)
            # cannot bleed into the next row's timed run
            ev.set()
            t.join(timeout=3.0)
            if t.is_alive():
                print("WARNING: the gpumon sampler did not stop within 3 s: "
                      "the next row's timing may be contaminated")
            if history is not None:
                gpumon.disarm_history(torch)
        return teardown

    def with_profile():
        cm = api.profile(os.path.join(scratch, "full"))
        cm.__enter__()
        return lambda: cm.__exit__(None, None, None)

    rows = [("gpumon @ 1 Hz, no memprof", with_gpumon, False)]
    rows += [(_label(h), lambda h=h: with_gpumon(h), False)
             for h in MEMPROF_SWEEP]
    rows += [("Kineto trace (shapes, flops)", with_kineto, True),
             ("whole api.profile()", with_profile, True)]
    return rows


def run_budget(workload: str = "resnet", steps: int = 20, reps: int = 6,
               device: str = "cuda", ci_target_pct: float = 2.0,
               max_reps: int = 10):
    """Measure each row's marginal overhead; returns (markdown table, rows
    as dicts: name, median_s, pairs, overhead_pct, ci_pct, note)."""
    max_reps = max(max_reps, reps)
    step = make_workload(workload, device)
    scratch = tempfile.mkdtemp(prefix="sofa_budget_")
    out_rows: List[dict] = []
    try:
        for _ in range(2):                       # warm the whole path
            _timed_once(step, steps)
        # bare before any collector ran, before the first traced row and
        # after the last: a collector that leaves the process slower once
        # it stops shows here (and shrinks every later row's marginal)
        clean = [_timed_once(step, steps) for _ in range(3)]
        untraced = None
        bare_times: List[float] = []
        per_cfg = []
        for name, setup, traced in collector_configs(scratch):
            if traced and untraced is None:
                untraced = [_timed_once(step, steps) for _ in range(3)]
            margins, cfg_times, fail = [], [], None
            while len(margins) < max_reps:
                teardown = None
                try:
                    tb = _timed_once(step, steps)
                    teardown = setup()
                    tc = _timed_once(step, steps)
                except Exception as e:  # sofa-lint: disable=SL002 — the failure IS the row's result: the table reports it
                    fail = e
                    break
                finally:
                    if teardown is not None:
                        teardown()
                    # let what the teardown freed go before the next run
                    gc.collect()
                    time.sleep(0.5)
                bare_times.append(tb)
                cfg_times.append(tc)
                margins.append((tc - tb) / tb * 100.0)
                if len(margins) >= max(reps, 6):
                    ci = _median_ci(margins)
                    if ci is not None and (ci[1] - ci[0]) / 2 <= ci_target_pct:
                        break
            per_cfg.append((name, cfg_times, margins, fail,
                            bare_times[len(bare_times) - len(margins):]))
        after = [_timed_once(step, steps) for _ in range(3)]
        if not bare_times:
            raise RuntimeError("no bare run was timed: every row failed "
                               "before its pair's bare run")
        b_med = _median(bare_times)
        noise_pct = 4.0 * _median([abs(t - b_med) for t in bare_times]) \
            / b_med * 100.0
        def residue(ts):
            return (_median(ts) - _median(clean)) / _median(clean) * 100.0
        out_rows.append({"name": "bare (no collectors)", "median_s": b_med,
                         "bare_median_s": b_med,
                         "pairs": len(bare_times), "overhead_pct": 0.0,
                         "ci_pct": None, "bare_s": bare_times,
                         "clean_s": clean, "untraced_s": untraced,
                         "after_s": after,
                         "residue_untraced_pct": residue(untraced),
                         "residue_pct": residue(after),
                         "note": f"baseline (bare-run noise floor "
                                 f"±{noise_pct:.1f} %); bare before any "
                                 f"collector {_median(clean):.4f} s, "
                                 f"before the first traced row "
                                 f"{_median(untraced):.4f} s "
                                 f"({residue(untraced):+.1f} %), after the "
                                 f"last {_median(after):.4f} s "
                                 f"({residue(after):+.1f} %)"})
        for name, times, margins, fail, bares in per_cfg:
            if fail is not None:
                out_rows.append({"name": name, "median_s": None,
                                 "bare_median_s": None, "pairs": 0,
                                 "overhead_pct": None, "ci_pct": None,
                                 "note": f"unavailable: {fail!r}"})
                continue
            m = _median(margins)
            ci = _median_ci(margins)
            row = {"name": name, "median_s": _median(times),
                   "bare_median_s": _median(bares),
                   "pairs": len(margins), "overhead_pct": m, "ci_pct": ci,
                   "configured_s": times, "margins_pct": margins}
            if ci is None:
                row["note"] = (f"{m:+.2f} % — only {len(margins)} pair(s), "
                               "too few for a 95% CI (raise --reps)")
            else:
                half = (ci[1] - ci[0]) / 2.0
                text = f"{m:+.2f} % [95% CI {ci[0]:+.2f}..{ci[1]:+.2f}]"
                if half > ci_target_pct:
                    verdict = (f"UNRESOLVED at ±{ci_target_pct:.0f} % (CI "
                               f"half-width {half:.2f} % after "
                               f"{len(margins)} pairs)")
                elif ci[0] > 0:
                    verdict = f"real cost, resolved to ±{half:.2f} %"
                else:
                    verdict = f"≤{max(ci[1], 0):.2f} %, resolved to ±{half:.2f} %"
                row["note"] = f"{text} — {verdict}"
            out_rows.append(row)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    where = (f"{torch.cuda.get_device_name(0)}" if device != "cpu"
             else "the CPU (mechanics only: not a measurement of the card)")
    lines = [
        "# Per-collector overhead budget", "",
        f"{workload}, {steps} steps a run, on {where}; at least {reps} "
        f"interleaved bare/configured pairs a row (up to {max_reps} until "
        f"the 95 % order-statistic CI of the median marginal resolves "
        f"±{ci_target_pct:.0f} %).", "",
        "| Collector config | median run time (s) | its pairs' bare median "
        "(s) | marginal overhead |",
        "|---|---|---|---|"]
    for r in out_rows:
        t, b = (f"{r[k]:.4f}" if r[k] is not None else "—"
                for k in ("median_s", "bare_median_s"))
        lines.append(f"| {r['name']} | {t} | {b} | {r['note']} |")
    return "\n".join(lines) + "\n", out_rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--workload", choices=("resnet", "entry"),
                   default="resnet")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--reps", type=int, default=6,
                   help="least interleaved bare/configured pairs a row")
    p.add_argument("--max_reps", type=int, default=10)
    p.add_argument("--ci_target_pct", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="also write the table here")
    p.add_argument("--json", default=None, help="and the rows as JSON")
    args = p.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        p.error("no CUDA device is visible; pass --device cpu to exercise "
                "the mechanics on the CPU")
    table, rows = run_budget(args.workload, args.steps, args.reps,
                             args.device, ci_target_pct=args.ci_target_pct,
                             max_reps=args.max_reps)
    print(table)
    for path, text in ((args.out, table),
                       (args.json, json.dumps(rows, indent=1))):
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with open(path, "w") as f:
                f.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
