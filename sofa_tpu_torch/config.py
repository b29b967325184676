"""Run configuration for the PyTorch profiler path (a trimmed SofaConfig)."""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class SofaConfig:
    logdir: str = "sofalog/"
    # Trace the profiled program with torch.profiler (Kineto: CPU ops and,
    # when the program sees a card, CUDA kernels/copies via CUPTI).
    enable_kineto: bool = True
    verbose: bool = False

    def __post_init__(self) -> None:
        if not self.logdir.endswith("/"):
            self.logdir += "/"

    def path(self, *parts: str) -> str:
        return os.path.join(self.logdir, *parts)

    @property
    def kineto_dir(self) -> str:
        return self.path("kineto")

    @property
    def inject_dir(self) -> str:
        return self.path("_inject")
