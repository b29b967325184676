"""Collector lifecycle: probe() -> start() -> [child runs] -> stop() ->
harvest().  A collector whose probe fails is skipped with a warning; the
recording goes on without its series, so profiling works on machines that
lack any subset of the tools."""

from __future__ import annotations

import shutil
import signal
import subprocess
from typing import Dict, List, Optional

from sofa_tpu_torch.printing import print_info, print_warning


class Collector:
    """Base collector; subclasses override the hooks they need."""

    name = "collector"

    def __init__(self, cfg):
        self.cfg = cfg

    def probe(self) -> Optional[str]:
        """None if usable, else a human-readable reason it is not."""
        return None

    def start(self) -> None:
        """Begin collection (background process, thread or file setup)."""

    def stop(self) -> None:
        """End collection and flush output files."""

    def harvest(self) -> None:
        """Post-run transformation of raw output (e.g. blkparse)."""

    def command_prefix(self) -> List[str]:
        """Tokens to prepend to the profiled command (e.g. strace ...)."""
        return []

    def child_env(self) -> Dict[str, str]:
        """Environment variables to inject into the profiled command."""
        return {}

    def outputs(self) -> List[str]:
        """Paths this collector writes."""
        return []

    @staticmethod
    def which(tool: str) -> Optional[str]:
        return shutil.which(tool)


class ProcessCollector(Collector):
    """A collector backed by one background process."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.proc: Optional[subprocess.Popen] = None

    def launch(self, argv, **popen_kwargs) -> None:
        print_info(f"{self.name}: {' '.join(argv)}")
        self.proc = subprocess.Popen(argv, **popen_kwargs)

    def alive(self) -> Optional[bool]:
        """True/False while a backing process exists, None before launch."""
        if self.proc is None:
            return None
        return self.proc.poll() is None

    def stop(self, sig=signal.SIGTERM, timeout: float = 5.0) -> None:
        """Signal the process (TERM by default), then KILL it if it has not
        exited within ``timeout`` seconds."""
        if self.proc is None or self.proc.poll() is not None:
            return
        try:
            self.proc.send_signal(sig)
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                print_warning(f"{self.name}: did not exit on signal; killing")
                self.proc.kill()
                try:
                    self.proc.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    print_warning(f"{self.name}: not reaped after SIGKILL; "
                                  "abandoning the wait")
        except ProcessLookupError:
            pass
