"""Environment doctor & enabler: ``python -m sofa_tpu_torch setup``.

The JAX package's ``setup`` (``sofa_tpu/setup_env.py``) with the device
side made CUDA's.  It *reports* what each collector needs and prints the
exact commands: the sysctls perf and strace want, the collector binaries,
and with ``--empower <tool>`` the capability grant a non-root profiling
user needs for it.  ``setup --apply`` runs the commands (through sudo
when available).  Nothing is installed — missing binaries only degrade
the matching collector.

The device check looks for the NVIDIA device nodes and then probes the
backend in a SUBPROCESS bounded by a 30 s timeout: ``torch.cuda``
initialization can hang on a wedged driver, and ``setup`` must always
return.  An unusable backend counts as a problem (exit 1);
``--no-device-probe`` skips the probe.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from typing import Callable, List, Optional, Tuple

from sofa_tpu_torch.printing import (print_hint, print_info, print_progress,
                                     print_warning)

# (sysctl key, value wanted for full-fidelity perf/strace recording)
SYSCTLS = [
    ("kernel.perf_event_paranoid", "-1"),
    ("kernel.kptr_restrict", "0"),
]

# Collector binaries and the subsystem each one unlocks.
TOOLS = [
    ("perf", "CPU sampling (collectors/perf.py)"),
    ("tcpdump", "packet capture (collectors/hostproc.py)"),
    ("blktrace", "block-IO tracing (collectors/hostproc.py)"),
    ("blkparse", "block-IO trace decoding"),
    ("strace", "syscall tracing (collectors/hostproc.py)"),
    ("vmstat", "memory/context-switch sampling"),
]

# Capabilities a non-root profiling user needs per utility.
CAPS = {
    "tcpdump": "cap_net_raw,cap_net_admin=eip",
    "blktrace": "cap_sys_admin=eip",
    "perf": "cap_perfmon,cap_sys_ptrace=eip",
}

# The NVIDIA driver's device nodes: the first card and the control node.
DEVICE_NODES = ("/dev/nvidia0", "/dev/nvidiactl")

PROBE_TIMEOUT_S = 30.0

# Run in a fresh interpreter, so that a wedged driver hangs the child, not
# setup.  Prints "<backend> <count> <name of card 0>".
_PROBE_CODE = ("import torch\n"
               "if not torch.cuda.is_available():\n"
               "    raise SystemExit('torch.cuda.is_available() is False "
               "(no card visible to the CUDA driver)')\n"
               "n = torch.cuda.device_count()\n"
               "print('cuda', n, torch.cuda.get_device_name(0))\n")


def _read_sysctl(key: str) -> Optional[str]:
    path = "/proc/sys/" + key.replace(".", "/")
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return None


def _sudo_prefix() -> str:
    return "sudo " if shutil.which("sudo") and os.geteuid() != 0 else ""


def check(utilities: Optional[List[str]] = None,
          probe_device: bool = True) -> Tuple[List[str], int]:
    """Returns (fix commands, number of problems found) and prints a report."""
    fixes: List[str] = []
    problems = 0
    sudo = _sudo_prefix()

    for key, want in SYSCTLS:
        have = _read_sysctl(key)
        if have is None:
            print_warning(f"setup: {key} unreadable (sandboxed /proc?)")
            problems += 1
        elif have != want:
            print_warning(f"setup: {key} = {have}, want {want}")
            fixes.append(f"{sudo}sysctl -w {key}={want}")
            problems += 1
        else:
            print_info(f"setup: {key} = {have} ok")

    for tool, why in TOOLS:
        path = shutil.which(tool)
        if path:
            print_info(f"setup: {tool} found at {path}")
        else:
            print_warning(f"setup: {tool} missing — degrades {why}")
            problems += 1

    for util in utilities or []:
        path = shutil.which(util) or util
        cap = CAPS.get(os.path.basename(path))
        if cap is None:
            print_warning(
                f"setup: no capability profile for {util!r} (known: "
                f"{', '.join(sorted(CAPS))}) — refusing to guess a grant")
            problems += 1
            continue
        if not os.path.isfile(path):
            print_warning(f"setup: {util}: not a file, cannot grant caps")
            problems += 1
            continue
        got = ""
        if shutil.which("getcap"):
            try:
                out = subprocess.run(["getcap", path], capture_output=True,
                                     text=True, timeout=10)
                got = out.stdout.strip()
            except (subprocess.SubprocessError, OSError) as e:
                print_warning(f"setup: getcap {path} failed ({e}); "
                              "assuming no capabilities")
        # getcap prints caps sorted by capability number, so compare the
        # individual names, not the whole comma-joined string.
        if all(c in got for c in cap.split("=")[0].split(",")):
            print_info(f"setup: {path} already has {cap}")
        else:
            print_warning(f"setup: {path} lacks {cap}")
            fixes.append(f"{sudo}setcap {cap} {path}")
            problems += 1

    nodes = [d for d in DEVICE_NODES if os.path.exists(d)]
    if nodes:
        print_info(f"setup: NVIDIA device node present: {', '.join(nodes)}")
    else:
        print_info("setup: no NVIDIA device node (/dev/nvidia0, "
                   "/dev/nvidiactl): no local card, or a container "
                   "without the driver's devices")
    if probe_device and not _probe_backend():
        problems += 1   # an unusable device backend IS a setup problem:
        # scripts gating on the exit code must not read 'fully enabled'
    return fixes, problems


def _probe_backend(timeout_s: float = PROBE_TIMEOUT_S) -> bool:
    """Bounded CUDA backend health report (never raises, never hangs);
    True iff torch saw at least one card."""
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE_CODE],
                           capture_output=True, text=True,
                           timeout=timeout_s)
    except subprocess.TimeoutExpired:
        print_warning(
            f"setup: device backend init hung > {timeout_s:.0f}s — the "
            "CUDA driver is wedged or the card is lost; torch programs "
            "(and `record` of them) will hang at their first CUDA call.  "
            "Host-side collectors still work; `nvidia-smi` shows the "
            "driver's state")
        return False
    except OSError as e:
        print_warning(f"setup: backend probe could not launch: {e}")
        return False
    if r.returncode == 0 and r.stdout.strip():
        parts = r.stdout.strip().split(None, 2)
        backend = parts[0]
        n = parts[1] if len(parts) > 1 else "?"
        kind = parts[2] if len(parts) > 2 else ""
        # print_progress, not print_info: the health verdict is the answer
        # the user ran `setup` for — it must show without --verbose
        print_progress(f"setup: device backend healthy: {backend} "
                       f"({n} device(s){', ' + kind if kind else ''})")
        return True
    tail = (r.stderr.strip().splitlines() or ["?"])[-1]
    print_warning(f"setup: device backend init failed (CUDA driver): "
                  f"{tail[:160]}")
    return False


def sofa_setup(utilities: Optional[List[str]] = None, apply: bool = False,
               runner: Callable[[str], int] = None,
               probe_device: bool = True) -> int:
    """Report (and with apply=True, fix) host prerequisites.

    runner is injectable for tests; defaults to shell execution.
    """
    fixes, problems = check(utilities, probe_device)
    if not fixes:
        if problems:
            print_hint(f"setup: {problems} issue(s), none auto-fixable "
                       "(install missing tools via your image/package manager)")
        else:
            print_progress("setup: environment fully enabled")
        return 0 if not problems else 1
    if not apply:
        print_hint("setup: run these (or re-run with --apply):")
        for cmd in fixes:
            print(f"  {cmd}")
        return 1
    run = runner or _run_fix
    rc = 0
    for cmd in fixes:
        print_progress(f"setup: {cmd}")
        rc = max(rc, run(cmd))
    return rc


def _run_fix(cmd: str, timeout_s: float = 120.0) -> int:
    """Default --apply runner.  Bounded: the fix commands are setcap/sysctl
    one-liners — a sudo prompt or wedged PAM stack must not hang
    `setup --apply` forever."""
    try:
        return subprocess.run(cmd, shell=True, timeout=timeout_s).returncode
    except subprocess.TimeoutExpired:
        print_warning(f"setup: fix command exceeded {timeout_s:.0f}s and "
                      f"was killed: {cmd}")
        return 124
