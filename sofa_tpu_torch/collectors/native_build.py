"""Build the native helpers at first use (the JAX package's
``collectors/native_build.py``).

``native/sysmon.cc`` (the /proc sampler daemon) and
``native/perfetto_write.cc`` (the Perfetto export's writer, linked with
zlib) are compiled with the first of ``g++``, ``c++`` and ``clang++`` into
``build/torch_native/``,
the binary named by a hash of its source (as ``kernels.py`` names the
flash libraries), so that an edited source is rebuilt and the source
directory is never written into.  The clock samples stay in Python
(``collectors/timebase.py``), where the JAX package runs a native
``timebase``.  The compile goes to a per-process temp
name and lands with ``os.replace``: two concurrent builds never hand
each other a half-written binary.

Without a compiler, or when the build fails, ``ensure_built`` warns once
per tool and process and returns None: the caller then runs its Python
fallback (the sampler thread), as the JAX package does on such a host.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional

from sofa_tpu_torch.concurrency import Guard
from sofa_tpu_torch.printing import print_info, print_warning

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_native")
BUILD_TIMEOUT_S = 120
COMPILERS = ("g++", "c++", "clang++")
#: Libraries a tool links with.
LINK_FLAGS = {"perfetto_write": ("-lz",)}

# Tools whose build already failed in this process: retrying the compiler
# on every call would cost up to the build timeout each time.  Collectors
# starting on the main flow and on the supervisor's thread both record
# failures.
_BUILD_GUARD = Guard("native_build.failed", protects=("_FAILED", "BUILDS"))
_FAILED: set = set()
# What this process built: tool -> {"compiler", "seconds", "path"}.
BUILDS: Dict[str, dict] = {}


def source_path(tool: str) -> str:
    return os.path.join(NATIVE_DIR, f"{tool}.cc")


def binary_path(tool: str) -> str:
    """``build/torch_native/<tool>-<sha256 of the source, 12 hex>``."""
    with open(source_path(tool), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"{tool}-{digest}")


def find_compiler() -> Optional[str]:
    for name in COMPILERS:
        found = shutil.which(name)
        if found:
            return found
    return None


def _give_up(tool: str, why: str) -> None:
    with _BUILD_GUARD:
        _FAILED.add(tool)
    print_warning(f"native {tool}: {why}; using the Python fallback")


def ensure_built(tool: str) -> Optional[str]:
    """The path of the native helper ``tool``, building it if needed; None
    when it cannot be built (warned once per process)."""
    source = source_path(tool)
    if not os.path.isfile(source):
        return None
    binary = binary_path(tool)
    if os.access(binary, os.X_OK):
        return binary
    if tool in _FAILED:
        return None
    cxx = find_compiler()
    if cxx is None:
        _give_up(tool, "no C++ compiler (" + ", ".join(COMPILERS) + ")")
        return None
    tmp = f"{binary}.build.{os.getpid()}"
    t0 = time.perf_counter()
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run([cxx, "-O2", "-o", tmp, source,
                        *LINK_FLAGS.get(tool, ())], check=True,
                       capture_output=True, timeout=BUILD_TIMEOUT_S)
        os.replace(tmp, binary)
    except (subprocess.SubprocessError, OSError) as e:
        err = getattr(e, "stderr", None) or b""
        _give_up(tool, f"build failed ({e}"
                 + (f": {err.decode(errors='replace')[-300:]}" if err
                    else "") + ")")
        return None
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    seconds = time.perf_counter() - t0
    with _BUILD_GUARD:
        BUILDS[tool] = {"compiler": cxx, "seconds": seconds, "path": binary}
    print_info(f"native {tool}: built with {cxx} in {seconds:.2f} s")
    return binary
