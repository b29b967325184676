"""Programmatic, in-process profiling, for programs that own their Python
process and do not want the wrap-a-command CLI:

    import sofa_tpu_torch.api as sofa

    with sofa.profile("sofalog/"):
        train_step(...)              # any PyTorch work

    # then: python -m sofa_tpu_torch preprocess --logdir sofalog/
    #       python -m sofa_tpu_torch analyze --logdir sofalog/

The counterpart of ``sofa_tpu/api.py``.  It records what ``record`` does
minus the process-level collectors (perf, strace, vmstat, tcpdump,
blktrace, the Python stack sampler): the time base, the /proc sampler (the
native ``sysmon`` daemon, a child process outside the measurement; a
thread only where no C++ compiler can build it), the GPU memory sampler
with its allocation-site snapshots, and the Kineto trace, through the same
functions the ``record`` injection runs.  A logdir
holds one run: the previous run's files are dropped first.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Optional

from sofa_tpu_torch.config import SofaConfig


@contextlib.contextmanager
def profile(logdir: str = "sofalog/", cfg: Optional[SofaConfig] = None):
    """Profile the body of the ``with`` block; yields the run's config."""
    import torch

    from sofa_tpu_torch.collectors import gpumon, kineto
    from sofa_tpu_torch.collectors.procmon import ProcMonCollector
    from sofa_tpu_torch.collectors.timebase import TimebaseCollector
    from sofa_tpu_torch.record import _clean_stale

    if cfg is None:
        cfg = SofaConfig(logdir=logdir)
    else:
        cfg.logdir = logdir
        cfg.__post_init__()
    os.makedirs(cfg.logdir, exist_ok=True)
    _clean_stale(cfg)

    timebase = TimebaseCollector(cfg)
    procmon = ProcMonCollector(cfg)
    timebase.start()
    if procmon.probe() is None:
        procmon.start()
    memprof_path = (cfg.path("memprof.pb.gz")
                    if cfg.enable_gpu_mon and cfg.enable_mem_prof else None)
    stop = threading.Event()
    sampler = None
    if cfg.enable_gpu_mon:
        if memprof_path:
            gpumon.arm_history(torch)
        sampler = gpumon.start_sampler(cfg.gpu_mon_rate,
                                       cfg.path("gpumon.txt"), stop,
                                       memprof_path=memprof_path)
    trace = kineto.start_trace(torch, cfg.logdir) if cfg.enable_kineto \
        else None
    start = time.time()
    try:
        yield cfg
    finally:
        elapsed = time.time() - start
        if trace is not None:
            kineto.stop_trace(torch, trace)
        else:
            kineto.write_topology(torch, cfg.logdir)
        if sampler is not None:
            stop.set()
            # joined before the exit snapshot, so that the sampler's last
            # tick cannot publish after it
            sampler.join(timeout=2.0)
        if memprof_path:
            if torch.cuda.is_initialized():
                gpumon.final_memprof(torch, memprof_path)
            gpumon.disarm_history(torch)
        procmon.stop()
        timebase.stop()
        with open(cfg.path("misc.txt"), "w") as f:
            f.write(f"elapsed_time {elapsed:.6f}\n")
            f.write(f"cores {os.cpu_count() or 1}\n")
            f.write(f"pid {os.getpid()}\n")
            f.write("rc 0\n")
