"""Run configuration for the PyTorch profiler path (a trimmed SofaConfig).

The collector fields and their defaults are the JAX package's
(``SofaConfig``'s "record: host" block), except that its TPU sampler
(``tpu_mon_rate`` / ``enable_tpu_mon``) is the GPU memory sampler here
(``gpu_mon_rate`` / ``enable_gpu_mon``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class SofaConfig:
    logdir: str = "sofalog/"
    verbose: bool = False

    # --- record: host collectors ------------------------------------------
    perf_events: str = ""            # extra `perf record -e` events
    no_perf_events: bool = False     # skip perf entirely (fallback to time -v)
    cpu_sample_rate: int = 99        # perf -F
    # "off" (default: DWARF unwinding at 99 Hz copies ~16 KB of stack per
    # sample), "fp" (frame pointers) or "dwarf".
    perf_call_graph: str = "off"
    sys_mon_rate: int = 10           # /proc sampler Hz
    enable_strace: bool = False
    strace_min_time: float = 1e-6    # drop syscalls shorter than this (s)
    enable_py_stacks: bool = False   # in-process Python stack sampler
    py_stack_rate: int = 67          # Hz for the Python stack sampler
    enable_tcpdump: bool = False
    netstat_interface: Optional[str] = None
    blkdev: Optional[str] = None     # block device for blktrace (opt-in)
    enable_vmstat: bool = True

    # --- record: GPU collectors (injected into the profiled program) ------
    # Trace the profiled program with torch.profiler (Kineto: CPU ops and,
    # when the program sees a card, CUDA kernels/copies via CUPTI).
    enable_kineto: bool = True
    enable_gpu_mon: bool = True      # allocator memory sampler (in-process)
    gpu_mon_rate: int = 1            # its rate, Hz
    enable_mem_prof: bool = True     # allocation-site snapshot (pprof) at
                                     # the observed occupancy peak

    # --- analyze: region of interest ---------------------------------------
    profile_region: str = ""         # "begin:end" manual ROI (seconds)
    spotlight: bool = False          # auto-ROI from the kernel utilization
    # set by the spotlight pass (or --profile_region); 0/0 = the whole run
    roi_begin: float = 0.0
    roi_end: float = 0.0

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
