"""Speed of light: the card's peak rates, and the ``sol_roofline`` pass.

The counterpart of ``sofa_tpu/analysis/sol.py``.  A TPU's peaks come from
its profiler's plane stats or a datasheet table keyed on the device kind;
a CUDA card's come from this table only, keyed on the device name that
``gpu_topo.json`` records (``torch.cuda.get_device_properties(i).name``).
A card the table does not name gets no roofline and a warning, never a
guessed peak.

    NVIDIA H100 80GB HBM3   989 TFLOP/s dense bf16, 3,350 GB/s HBM3
                            (NVIDIA H100 Tensor Core GPU data sheet, H100
                            SXM5, at its 700 W power limit; a card set to
                            a lower limit runs below these under load)
"""

from __future__ import annotations

import json
import os
from typing import Dict

import pandas as pd

from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.analysis.registry import analysis_pass
from sofa_tpu_torch.printing import print_warning
from sofa_tpu_torch.trace import CopyKind, narrow, roi_clip

# device name -> (dense bf16 TFLOP/s, HBM GB/s), the data sheet's figures
PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.0, 3350.0),
}
PEAK_SOURCE = "NVIDIA H100 data sheet (SXM5, 700 W), dense bf16"
# device name -> dense float32 TFLOP/s outside the tensor cores, the rate
# that bounds a float32 kernel that takes no TF32 shortcut
FP32_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 67.0,
}
FP32_SOURCE = ("NVIDIA H100 data sheet (SXM5, 700 W), float32 without "
               "tensor cores")


def device_peaks(cfg) -> Dict[str, Dict[str, float]]:
    """device id (str) -> {"peak_teraflops_per_second",
    "peak_hbm_bw_gigabytes_per_second", "name"} for each device of
    ``gpu_topo.json`` the table names (the JAX package's ``tpu_meta.json``
    shape); warns about the others, and is empty without a topology."""
    try:
        with open(cfg.path("gpu_topo.json")) as f:
            topo = json.load(f)
    except (OSError, ValueError):
        return {}
    out = {}
    for dev in topo.get("devices", []):
        name = str(dev.get("name", ""))
        if name not in PEAKS:
            print_warning(f"no peak rates for {name!r} (device "
                          f"{dev.get('index')}): no roofline for it")
            continue
        tflops, gbps = PEAKS[name]
        out[str(int(dev["index"]))] = {
            "peak_teraflops_per_second": tflops,
            "peak_hbm_bw_gigabytes_per_second": gbps, "name": name}
    return out


def no_costs(kern, what: str) -> bool:
    """Whether some kernel's flops or bytes are absent (NaN: the trace
    recorded no operand shapes); warns once for the pass ``what``, which
    then writes nothing rather than a roofline of zeros."""
    n = int((kern["flops"].isna() | kern["bytes_accessed"].isna()).sum())
    if n:
        print_warning(f"{what}: {n} of {len(kern)} kernels carry no flops "
                      "or bytes (the trace recorded no operand shapes: "
                      "--kineto_host_tracer_level below 2); no roofline")
    return n > 0


@analysis_pass(
    name="sol_roofline", order=270,
    reads_frames=("gputrace",),
    reads_columns=("timestamp", "duration", "deviceId", "category",
                   "copyKind", "device_kind", "hlo_category", "flops",
                   "bytes_accessed"),
    provides_features=("gpu*_sol_peak_tflops", "gpu*_sol_distance",
                       "sol_peak_source"),
    provides_artifacts=("sol_roofline.csv",),
    after=("spotlight",),
)
def sol_roofline(frames, cfg, features: Features) -> None:
    """Distance from speed of light, per device and op (``hlo_category``):
    for the kernels with flops, the attainable time is the larger of
    flops / peak FLOP/s and bytes / peak bandwidth, the distance the actual
    time over it (at least 1), duration-weighted.  Writes
    ``sol_roofline.csv``, ``gpu<N>_sol_peak_tflops`` and
    ``gpu<N>_sol_distance``, and the peaks' source as ``sol_peak_source``."""
    df = frames.get("gputrace")
    if df is None or df.empty:
        return
    df = narrow(df, ["timestamp", "duration", "deviceId", "copyKind",
                     "hlo_category", "flops", "bytes_accessed"])
    df = roi_clip(df, cfg)
    kern = df[(df["copyKind"] == int(CopyKind.KERNEL)) & (df["duration"] > 0)]
    if no_costs(kern, "sol_roofline"):
        return
    rows = kern[kern["flops"] > 0]
    if rows.empty:
        return
    peaks = device_peaks(cfg)
    out = []
    for device_id, dev in rows.groupby("deviceId"):
        p = peaks.get(str(int(device_id)))
        if not p:
            continue
        peak_tflops = p["peak_teraflops_per_second"]
        peak_gbps = p["peak_hbm_bw_gigabytes_per_second"]
        agg = dev.groupby("hlo_category").agg(
            time=("duration", "sum"), count=("duration", "count"),
            flops=("flops", "sum"), nbytes=("bytes_accessed", "sum"))
        sol = pd.concat([agg["flops"] / (peak_tflops * 1e12),
                         agg["nbytes"] / (peak_gbps * 1e9)],
                        axis=1).max(axis=1)
        agg["sol_time"] = sol
        agg["sol_distance"] = (agg["time"] / sol.where(sol > 0)).clip(
            lower=1.0)
        agg["deviceId"] = int(device_id)
        agg["peak_tflops"] = peak_tflops
        out.append(agg)
        total = float(agg["time"].sum())
        weighted = float((agg["time"] * agg["sol_distance"]).sum())
        features.add(f"gpu{device_id}_sol_peak_tflops", peak_tflops)
        if total > 0:
            features.add(f"gpu{device_id}_sol_distance", weighted / total)
    if not out:
        return
    table = (pd.concat(out).reset_index()
             .sort_values(["deviceId", "time"], ascending=[True, False]))
    table.to_csv(cfg.path("sol_roofline.csv"), index=False)
    features.add_info("sol_peak_source", PEAK_SOURCE)
