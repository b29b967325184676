"""Clock-domain anchoring.

Writes two files:

  sofa_time.txt  the run's unix zero point at record start (every trace
                 timestamp becomes t - time_base)
  timebase.txt   simultaneous (realtime, monotonic, boottime,
                 monotonic_raw) ns samples from ``clock_gettime``, taken at
                 record start and again at stop: the bridge for collectors
                 that stamp a non-realtime clock (perf), and with samples at
                 both ends, for realtime-vs-monotonic drift
                 (ingest/timebase_align.py)

The Kineto trace clock is anchored separately by an in-trace marker
(collectors/kineto.py).
"""

from __future__ import annotations

import time

from sofa_tpu_torch.collectors.base import Collector


def python_timebase_samples(n: int = 3):
    rows = []
    for _ in range(n):
        rt0 = time.clock_gettime_ns(time.CLOCK_REALTIME)
        mono = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
        boot = time.clock_gettime_ns(time.CLOCK_BOOTTIME)
        raw = time.clock_gettime_ns(time.CLOCK_MONOTONIC_RAW)
        rt1 = time.clock_gettime_ns(time.CLOCK_REALTIME)
        rows.append(((rt0 + rt1) // 2, mono, boot, raw))
    return rows


def _sample_lines():
    return [" ".join(str(v) for v in row) for row in python_timebase_samples()]


class TimebaseCollector(Collector):
    name = "timebase"

    def start(self) -> None:
        with open(self.cfg.path("sofa_time.txt"), "w") as f:
            f.write(f"{time.time():.9f}\n")
        with open(self.cfg.path("timebase.txt"), "w") as f:
            f.write("\n".join(_sample_lines()) + "\n")

    def stop(self) -> None:
        try:
            with open(self.cfg.path("timebase.txt"), "a") as f:
                f.write("\n".join(_sample_lines()) + "\n")
        except OSError:
            pass

    def outputs(self):
        return [self.cfg.path("sofa_time.txt"), self.cfg.path("timebase.txt")]
