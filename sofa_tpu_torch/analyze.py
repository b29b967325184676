"""analyze: run the analysis passes over the preprocessed frames.

Passes run as a plain ordered list: the host passes
(``analysis.host.PASSES``), then the GPU passes (``analysis.gpu.PASSES``).
Then, in the JAX package's order: the tile pyramid is brought up to date
(nothing to do after a ``report``; built for an older logdir), the feature
vector is printed and saved as ``features.csv``, the rule-based hints are
printed and written to ``hints.txt``, the board's pages are staged beside
the data, and the run ends with the ``Complete!!`` line.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Optional

import pandas as pd

from sofa_tpu_torch.analysis import advice, gpu, host
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


def sofa_analyze(cfg: SofaConfig,
                 frames: Optional[Dict[str, pd.DataFrame]] = None
                 ) -> Features:
    reap_stale_sentinel(cfg.logdir)
    if frames is None:
        frames = load_frames(cfg)
    misc = read_misc(cfg)
    features = Features()
    features.add("elapsed_time", float(misc.get("elapsed_time", 0) or 0))
    for analysis_pass in host.PASSES + gpu.PASSES:
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
