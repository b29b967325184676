"""Small host-process collectors: vmstat, tcpdump, blktrace, strace, each
with probe-based degradation (a missing tool skips its collector)."""

from __future__ import annotations

import subprocess
from typing import List, Optional

from sofa_tpu_torch.collectors.base import Collector, ProcessCollector
from sofa_tpu_torch.printing import print_warning


class VmstatCollector(ProcessCollector):
    name = "vmstat"

    def probe(self) -> Optional[str]:
        if not self.cfg.enable_vmstat:
            return "disabled"
        path = self.which("vmstat")
        if path is None:
            return "vmstat not installed"
        # One report, at once: a vmstat that cannot read its /proc files
        # (a host with a restricted /proc) exits 1 before its first line,
        # and would only die under the supervisor.  A deliberate addition
        # to the JAX package's probe, which checks the binary alone.
        try:
            r = subprocess.run([path, "1", "1"], capture_output=True,
                               text=True, timeout=10)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"vmstat does not run here ({e})"
        if r.returncode != 0:
            why = (r.stderr.strip().splitlines() or [""])[0][:120]
            return f"vmstat exits {r.returncode} here ({why})"
        return None

    def argv(self) -> List[str]:
        return ["vmstat", "-w", "-t", "1"]

    def start(self) -> None:
        self._out = open(self.cfg.path("vmstat.txt"), "a")
        self.launch(self.argv(), stdout=self._out, stderr=subprocess.DEVNULL)

    def stop(self, **kwargs) -> None:
        super().stop(**kwargs)
        if getattr(self, "_out", None):
            self._out.close()

    def outputs(self) -> List[str]:
        return [self.cfg.path("vmstat.txt")]


class TcpdumpCollector(ProcessCollector):
    name = "tcpdump"

    def probe(self) -> Optional[str]:
        if not self.cfg.enable_tcpdump:
            return "disabled (enable with --enable_tcpdump)"
        if self.which("tcpdump") is None:
            return "tcpdump not installed"
        return None

    def argv(self) -> List[str]:
        return ["tcpdump", "-i", "any", "-w", self.cfg.path("sofa.pcap"),
                "-s", "96"]

    def start(self) -> None:
        self.launch(self.argv(), stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL)

    def outputs(self) -> List[str]:
        return [self.cfg.path("sofa.pcap")]


class BlktraceCollector(ProcessCollector):
    name = "blktrace"

    def probe(self) -> Optional[str]:
        if not self.cfg.blkdev:
            return "disabled (enable with --blkdev <dev>)"
        if self.which("blktrace") is None:
            return "blktrace not installed"
        return None

    def argv(self) -> List[str]:
        return ["blktrace", f"--dev={self.cfg.blkdev}", "-D", self.cfg.logdir,
                "-o", "blktrace"]

    def start(self) -> None:
        self.launch(self.argv(), stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL)

    def outputs(self) -> List[str]:
        return [self.cfg.path("blktrace.txt")]

    def harvest(self) -> None:
        if self.which("blkparse") is None:
            print_warning("blktrace: blkparse missing; leaving raw trace")
            return
        try:
            with open(self.cfg.path("blktrace.txt"), "w") as out:
                subprocess.run(
                    ["blkparse", "-i", self.cfg.path("blktrace")],
                    stdout=out, stderr=subprocess.DEVNULL, timeout=120,
                )
        except (subprocess.SubprocessError, OSError) as e:
            print_warning(f"blktrace: blkparse failed: {e}")


class StraceCollector(Collector):
    name = "strace"

    def probe(self) -> Optional[str]:
        if not self.cfg.enable_strace:
            return "disabled (enable with --enable_strace)"
        if self.which("strace") is None:
            return "strace not installed"
        return None

    def command_prefix(self) -> List[str]:
        return ["strace", "-q", "-T", "-tt", "-f",
                "-o", self.cfg.path("strace.txt")]

    def outputs(self) -> List[str]:
        return [self.cfg.path("strace.txt")]
