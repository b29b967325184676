"""The optional mining passes, ``aisi`` and ``hsg`` (the JAX package's
``sofa_tpu/analysis/mlpass.py``): each gated by its option and fault
isolated like every other pass; their board series ride the registry's
``provides_series`` channel into report.js.  The work is in
``sofa_tpu_torch/ml/``, imported only when a pass runs.

Their contracts name the port's frames: ``aisi`` reads the CUDA trace,
its steps and the host trace, and the host frames its per-step profile
reads (strace, pystacks); ``hsg`` reads the perf samples, else the host
trace.
"""

from __future__ import annotations

from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.analysis.registry import analysis_pass


@analysis_pass(
    name="aisi", order=250,
    reads_frames=("gputrace", "gpusteps", "hosttrace", "strace",
                  "pystacks"),
    provides_features=("aisi_iterations", "aisi_step_time_mean",
                       "aisi_step_time_gmean", "aisi_step_time_std",
                       "aisi_comm_ratio"),
    provides_artifacts=("iterations.csv",),
    provides_series=True,
    after=("spotlight",),
    enabled_when=("enable_aisi",),
)
def aisi(frames, cfg, features: Features):
    """Iteration detection and the per-step profile (``--enable_aisi``)."""
    from sofa_tpu_torch.ml.aisi import iteration_series, sofa_aisi

    marker = iteration_series(sofa_aisi(frames, cfg, features))
    return [marker] if marker is not None else []


@analysis_pass(
    name="hsg", order=260,
    reads_frames=("cputrace", "hosttrace"),
    provides_features=("hsg_swarms",),
    provides_artifacts=("auto_caption.csv",),
    provides_series=True,
    after=("spotlight",),
    enabled_when=("enable_hsg", "enable_swarms"),
)
def hsg(frames, cfg, features: Features):
    """Swarms of the host samples (``--enable_hsg`` /
    ``--enable_swarms``)."""
    from sofa_tpu_torch.ml.hsg import sofa_hsg, swarm_series

    return list(swarm_series(sofa_hsg(frames, cfg, features),
                             cfg.num_swarms))
