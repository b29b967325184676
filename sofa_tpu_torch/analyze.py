"""analyze: run the analysis passes over the preprocessed frames.

Passes run as a plain ordered list: the host passes
(``analysis.host.PASSES``), then the GPU passes (``analysis.gpu.PASSES``).
The feature vector is printed, saved as ``features.csv``, and the run ends
with the ``Complete!!`` line the JAX package's analyze prints.
"""

from __future__ import annotations

from typing import Dict, Optional

import pandas as pd

from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.analysis import gpu, host
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.preprocess import load_frames, read_misc


def sofa_analyze(cfg: SofaConfig,
                 frames: Optional[Dict[str, pd.DataFrame]] = None
                 ) -> Features:
    if frames is None:
        frames = load_frames(cfg)
    features = Features()
    features.add("elapsed_time",
                 float(read_misc(cfg).get("elapsed_time", 0) or 0))
    for analysis_pass in host.PASSES + gpu.PASSES:
        analysis_pass(frames, cfg, features)
    print(features.render())
    features.save(cfg.path("features.csv"))
    print("Complete!!")
    return features
