"""analyze: run the analysis passes over the preprocessed frames.

Passes run as a plain ordered list in the JAX registry's order: the
region of interest first (``device.spotlight_roi``), then the host passes
(``analysis.host.PASSES``, whose CPU samples it clips), then the GPU
passes (``analysis.gpu.PASSES``).  Then, in the JAX package's order: the tile pyramid is brought up to date
(nothing to do after a ``report``; built for an older logdir), the feature
vector is printed and saved as ``features.csv``, the rule-based hints are
printed and written to ``hints.txt``, the board's pages are staged beside
the data, and the run ends with the ``Complete!!`` line.  The run lands in the run
manifest (``telemetry.py``; the JAX package's ``analyze.py:192-212``), and
the manifest's health warnings ride the hints as ``[self]`` lines.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Optional

import pandas as pd

from sofa_tpu_torch import telemetry
from sofa_tpu_torch.analysis import advice, device, gpu, host
from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.preprocess import load_frames, read_misc
from sofa_tpu_torch.printing import print_warning
from sofa_tpu_torch.trace import derived_write_guard, reap_stale_sentinel

BOARD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "board")


def board_pages():
    """The board's static files, by name."""
    return sorted(os.listdir(BOARD_DIR))


def stage_board(cfg: SofaConfig) -> None:
    """Copy the board's pages beside the data, where viz serves them."""
    os.makedirs(cfg.logdir, exist_ok=True)
    for name in board_pages():
        shutil.copy2(os.path.join(BOARD_DIR, name), cfg.path(name))


#: Every pass analyze runs, in order.
PASSES = [device.spotlight_roi, *host.PASSES, *gpu.PASSES]


def sofa_analyze(cfg: SofaConfig,
                 frames: Optional[Dict[str, pd.DataFrame]] = None
                 ) -> Features:
    reap_stale_sentinel(cfg.logdir)
    tel = telemetry.begin("analyze")
    ok = False
    try:
        features = _analyze_body(cfg, frames, tel)
        ok = True
        return features
    finally:
        tel.write(cfg.logdir, rc=0 if ok else 1, cfg=cfg)
        telemetry.end(tel)


def _analyze_body(cfg: SofaConfig, frames, tel) -> Features:
    if frames is None:
        with tel.span("load_frames", cat="stage"):
            frames = load_frames(cfg)
    misc = read_misc(cfg)
    features = Features()
    features.add("elapsed_time", float(misc.get("elapsed_time", 0) or 0))
    with tel.span("passes", cat="stage"):
        for analysis_pass in PASSES:
            analysis_pass(frames, cfg, features)
    # without the mpstat sampler (api.profile()), the cores record wrote
    if not features.get("num_cores") and misc.get("cores"):
        features.add("num_cores", int(misc["cores"]))
    if cfg.enable_tiles:
        from sofa_tpu_torch import tiles

        try:
            with derived_write_guard(cfg.logdir):
                tiles.ensure_tiles(cfg, frames)
        except Exception as e:  # noqa: BLE001 - the overview still works
            print_warning(f"analyze: tile pyramid failed ({e!r}); the board "
                          "serves the overview only")
    print(features.render())
    features.save(cfg.path("features.csv"))
    advice.hint_report(features, cfg)
    stage_board(cfg)
    print("Complete!!")
    return features
