"""CPU sampling via ``perf record``.

Wraps the profiled command as ``perf record -o logdir/perf.data -F rate
[-e events] -- <cmd>``.  When perf is missing or gated by
``kernel.perf_event_paranoid`` the collector degrades to a
``/usr/bin/time -v`` wrapper (the CPU timeline then comes from procmon's
per-core counters) and says so, with the sysctl that would enable perf: a
host collector's own fallback, which hides no device.
"""

from __future__ import annotations

import os
from typing import List, Optional

from sofa_tpu_torch.collectors.base import Collector
from sofa_tpu_torch.printing import print_warning


def _read_int(path: str) -> Optional[int]:
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


class PerfCollector(Collector):
    name = "perf"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.mode = "off"  # off | perf | time

    def probe(self) -> Optional[str]:
        # A degraded perf is still a usable collector (the time -v
        # fallback): only "no fallback either" reports it unavailable.
        self.mode = "perf"
        if self.cfg.no_perf_events:
            self.mode = "time"
        elif self.which("perf") is None:
            self.mode = "time"
            print_warning("perf: not installed — falling back to "
                          "/usr/bin/time -v")
        else:
            paranoid = _read_int("/proc/sys/kernel/perf_event_paranoid")
            if paranoid is not None and paranoid > 1 and os.geteuid() != 0:
                self.mode = "time"
                print_warning(
                    f"perf: perf_event_paranoid={paranoid}; run "
                    "`sudo sysctl -w kernel.perf_event_paranoid=-1` to enable "
                    "perf sampling — falling back to /usr/bin/time -v")
        if self.mode == "time" and not os.path.isfile("/usr/bin/time"):
            return "neither perf nor /usr/bin/time available"
        return None

    def _record_argv(self) -> List[str]:
        cfg = self.cfg
        argv = ["perf", "record", "-o", cfg.path("perf.data"),
                "-F", str(cfg.cpu_sample_rate)]
        if cfg.perf_call_graph == "fp":
            argv += ["--call-graph", "fp"]
        elif cfg.perf_call_graph == "dwarf":
            argv += ["--call-graph", "dwarf,16384"]
        if cfg.perf_events:
            argv += ["-e", cfg.perf_events]
        return argv

    def command_prefix(self) -> List[str]:
        if self.mode == "perf":
            return self._record_argv() + ["--"]
        if self.mode == "time" and os.path.isfile("/usr/bin/time"):
            return ["/usr/bin/time", "-v", "-o", self.cfg.path("time.txt")]
        return []

    def attach_argv(self, pid: int) -> List[str]:
        """``perf record -p <pid>`` for attach mode; [] without perf."""
        if self.mode != "perf":
            return []
        return self._record_argv() + ["-p", str(pid)]

    def outputs(self) -> List[str]:
        cfg = self.cfg
        return [cfg.path("perf.data"), cfg.path("perf.script"),
                cfg.path("time.txt"), cfg.path("kallsyms")]

    def harvest(self) -> None:
        # Kernel symbols for offline `perf script` runs.
        if self.mode != "perf":
            return
        try:
            with open("/proc/kallsyms") as src, \
                    open(self.cfg.path("kallsyms"), "w") as dst:
                dst.write(src.read())
        except OSError:
            pass
