"""System-monitor sampling: /proc/stat, /proc/diskstats, /proc/net/dev and
/proc/cpuinfo at cfg.sys_mon_rate Hz.

The sampler is the native ``sysmon`` daemon (native/sysmon.cc, built at
first use by ``native_build``): one process outside the measurement, which
matters most under ``api.profile()``, where a sampler thread would run
inside the profiled program.  Where it cannot be built (no C++ compiler),
a daemon thread of the recording process writes the same files, as the
JAX package's ``collectors/procmon.py`` falls back.  ``alive`` and
``fault_kill`` cover both routes, so the supervisor's restart and the
``die`` fault work the same on either.

Line formats (parsed by ingest/procfs.py, byte-identical to the JAX
package's sampler):

  mpstat.txt    <ts> cpu<N>|cpuall user nice system idle iowait irq
                softirq steal
  diskstat.txt  <ts> <dev> rd_ios rd_sectors rd_ms wr_ios wr_sectors
                wr_ms inflight
  netstat.txt   <ts> <iface> rx_bytes tx_bytes rx_packets tx_packets
  cpuinfo.txt   <ts> <mhz core0> <mhz core1> ...

(counters cumulative, ts unix seconds with 6 decimals).
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional

from sofa_tpu_torch.collectors.base import ProcessCollector
from sofa_tpu_torch.collectors.native_build import ensure_built
from sofa_tpu_torch.printing import print_info


def read_proc_stat_lines(ts: float) -> List[str]:
    out = []
    try:
        with open("/proc/stat") as f:
            for line in f:
                if not line.startswith("cpu"):
                    break
                parts = line.split()
                name = "cpuall" if parts[0] == "cpu" else parts[0]
                vals = (parts[1:9] + ["0"] * 8)[:8]
                out.append(f"{ts:.6f} {name} " + " ".join(vals))
    except OSError:
        pass
    return out


def read_diskstats_lines(ts: float) -> List[str]:
    out = []
    try:
        with open("/proc/diskstats") as f:
            for line in f:
                p = line.split()
                if len(p) < 12:
                    continue
                dev = p[2]
                if dev.startswith(("loop", "ram")):
                    continue
                rd_ios, rd_sec, rd_ms = p[3], p[5], p[6]
                wr_ios, wr_sec, wr_ms = p[7], p[9], p[10]
                inflight = p[11]
                out.append(f"{ts:.6f} {dev} {rd_ios} {rd_sec} {rd_ms} "
                           f"{wr_ios} {wr_sec} {wr_ms} {inflight}")
    except OSError:
        pass
    return out


def read_netdev_lines(ts: float, iface_filter: Optional[str] = None
                      ) -> List[str]:
    out = []
    try:
        with open("/proc/net/dev") as f:
            for line in f:
                if ":" not in line:
                    continue
                iface, _, rest = line.partition(":")
                iface = iface.strip()
                if iface == "lo" or (iface_filter and iface != iface_filter):
                    continue
                p = rest.split()
                if len(p) < 10:
                    continue
                rxb, rxp, txb, txp = p[0], p[1], p[8], p[9]
                out.append(f"{ts:.6f} {iface} {rxb} {txb} {rxp} {txp}")
    except OSError:
        pass
    return out


def read_cpuinfo_line(ts: float) -> str:
    mhz = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("cpu mhz"):
                    try:
                        mhz.append(f"{float(line.split(':')[1]):.3f}")
                    except (ValueError, IndexError):
                        pass
    except OSError:
        pass
    if not mhz:
        mhz = ["0"]
    return f"{ts:.6f} " + " ".join(mhz)


class ProcMonCollector(ProcessCollector):
    """Samples host system counters at sys_mon_rate Hz."""

    name = "procmon"

    def __init__(self, cfg):
        super().__init__(cfg)
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def probe(self) -> Optional[str]:
        if not os.path.isfile("/proc/stat"):
            return "no /proc filesystem"
        return None

    def start(self) -> None:
        cfg = self.cfg
        tool = ensure_built("sysmon")
        if tool:
            argv = [tool, cfg.logdir, str(cfg.sys_mon_rate)]
            if cfg.netstat_interface:
                argv.append(cfg.netstat_interface)
            self.launch(argv)
            return
        print_info("procmon: Python fallback sampler thread")
        # a fresh event each (re)start: a supervisor restart after a death
        # must not inherit the stop that ended the previous sampler
        self._stop_event = threading.Event()
        self._thread = threading.Thread(target=self._sample_loop,
                                        daemon=True, name="sofa_procmon")
        self._thread.start()

    def alive(self) -> Optional[bool]:
        if self.proc is not None:
            return super().alive()
        return None if self._thread is None else self._thread.is_alive()

    def fault_kill(self) -> None:
        """The ``die`` fault (the JAX package's ``procmon.py:130-141``):
        the daemon is killed, or the sampler thread ends; a restart appends
        to the same files."""
        if self.proc is not None:
            super().kill()  # sofa-lint: disable=SL008 — ProcessCollector.kill, the collector's own kill-all hook, not a process signal
        else:
            self._stop_event.set()

    kill = fault_kill

    def _sample_loop(self) -> None:
        cfg = self.cfg
        interval = 1.0 / max(cfg.sys_mon_rate, 1)
        files = {name: open(cfg.path(f"{name}.txt"), "a")
                 for name in ("mpstat", "diskstat", "netstat", "cpuinfo")}
        try:
            while not self._stop_event.is_set():
                ts = time.time()
                for line in read_proc_stat_lines(ts):
                    files["mpstat"].write(line + "\n")
                for line in read_diskstats_lines(ts):
                    files["diskstat"].write(line + "\n")
                for line in read_netdev_lines(ts, cfg.netstat_interface):
                    files["netstat"].write(line + "\n")
                files["cpuinfo"].write(read_cpuinfo_line(ts) + "\n")
                for f in files.values():
                    f.flush()
                self._stop_event.wait(interval)
        finally:
            for f in files.values():
                f.close()

    def stop(self, **kwargs) -> None:
        if self._thread is not None:
            self._stop_event.set()
            self._thread.join(timeout=5)
        super().stop(**kwargs)

    def outputs(self) -> List[str]:
        cfg = self.cfg
        return [cfg.path("mpstat.txt"), cfg.path("diskstat.txt"),
                cfg.path("netstat.txt"), cfg.path("cpuinfo.txt")]
