"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is a ``csrc/*.cu`` file with a plain C entry point (the shared
``csrc/*.cuh`` headers hold what the kernels have in common).  On first use
it is compiled by ``nvcc`` for ``sm_90a`` into a shared library of its own
under ``<repo>/build/torch_kernels/`` and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes).  The library's file name
carries a hash of its source and the headers, so an edited source is never
served a stale build.  Loading a library binds the ``argtypes`` of every
registered entry point it holds (and its ``<name>_smem_bytes``, the
dynamic shared memory its launch asks for).  Nothing here runs at import
time: this module must import on a host with no CUDA toolkit (the CPU tests
import every module).

Every kernel has a launch count.  Its wrapper adds one where it launches the
kernel and nowhere else, so a run can show that its main path went through
the kernel (``reset_counts`` before, ``counts`` after).
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(REPO, "build", "torch_kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BUILD_TIMEOUT_S = 600


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: where its source lives, which TPU kernel it
    replaces, and how many times its wrapper has launched it."""

    name: str            # the C entry point; the profiler's symbol contains it
    lib: str             # csrc/<lib>.cu -> build/torch_kernels/lib<lib>-<hash>.so
    replaces: str        # file:line of the Pallas call it ports
    argtypes: List       # ctypes signature of the C entry point
    launches: int = 0

    @property
    def source(self) -> str:
        return os.path.join(_PKG, "csrc", f"{self.lib}.cu")

    @property
    def source_rel(self) -> str:
        return os.path.relpath(self.source, REPO)


_P, _I = ctypes.c_void_p, ctypes.c_int
_LL, _F = ctypes.c_longlong, ctypes.c_float
# (pointers..., B, T, Tk, H, KVH, D, shift, scale, stream)
_SHAPE = [_I, _I, _I, _I, _I, _I, _LL, _F, _P]
FLASH_FWD = Kernel(name="sofa_flash_fwd", lib="flash_fwd",
                   replaces="sofa_tpu/workloads/flash_pallas.py:282",
                   argtypes=[_P] * 7 + _SHAPE)
# q, k, v, dout, lse, delta, seg_q, seg_k, dk, dv, out_f32, ...
FLASH_BWD_KV = Kernel(name="sofa_flash_bwd_kv", lib="flash_bwd_kv",
                      replaces="sofa_tpu/workloads/flash_pallas.py:619",
                      argtypes=[_P] * 10 + [_I] + _SHAPE)
# q, k, v, dout, lse, delta, seg_q, seg_k, dq, out_f32, ...
FLASH_BWD_DQ = Kernel(name="sofa_flash_bwd_dq", lib="flash_bwd_dq",
                      replaces="sofa_tpu/workloads/flash_pallas.py:673",
                      argtypes=[_P] * 9 + [_I] + _SHAPE)

KERNELS = [FLASH_FWD, FLASH_BWD_KV, FLASH_BWD_DQ]

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return cand if os.access(cand, os.X_OK) else None


def library_path(kernel: Kernel) -> str:
    h = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cuh")))
    for path in [kernel.source] + headers:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{kernel.lib}-{h.hexdigest()[:12]}.so")


def nvcc_command(nvcc: str, kernel: Kernel, out: str) -> list:
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out, kernel.source]


def build(kernel: Kernel) -> str:
    """Compile ``kernel`` unless its hashed library exists; returns the
    compiler's report (empty when nothing was built).  Raises on any
    failure: there is no fallback to an uncompiled path."""
    path = library_path(kernel)
    if os.path.exists(path):
        return ""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build {kernel.name}: nvcc not found on PATH or under "
            "$CUDA_HOME/bin (the CUDA kernels build only where the CUDA "
            "toolkit is installed)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build beside the target, then rename: a concurrent loader sees either
    # no library or a whole one.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(nvcc_command(nvcc, kernel, tmp),
                             capture_output=True, text=True,
                             timeout=BUILD_TIMEOUT_S)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kernel.source_rel} "
                               f"(rc {res.returncode}):\n{res.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return res.stdout + res.stderr


def build_all(kernels: List[Kernel]) -> Dict[str, str]:
    """Build every kernel at once (one ``nvcc`` per source, all started
    together); returns each kernel's compiler report by name."""
    with ThreadPoolExecutor(max_workers=max(1, len(kernels))) as pool:
        reports = list(pool.map(build, kernels))
    return {k.name: r for k, r in zip(kernels, reports)}


def library(kernel: Kernel) -> ctypes.CDLL:
    """The loaded library of ``kernel``, building it on first use."""
    with _lock:
        lib = _loaded.get(kernel.lib)
        if lib is None:
            build(kernel)
            lib = ctypes.CDLL(library_path(kernel))
            _bind(kernel.lib, lib)
            _loaded[kernel.lib] = lib
        return lib


def _bind(lib_name: str, lib: ctypes.CDLL) -> None:
    """Sets the signature of every registered entry point in ``lib``, so no
    entry point is ever called with ctypes' default int arguments."""
    for k in KERNELS:
        if k.lib == lib_name:
            entry = getattr(lib, k.name)
            entry.argtypes, entry.restype = k.argtypes, _I
            smem = getattr(lib, f"{k.name}_smem_bytes")
            smem.argtypes, smem.restype = [_I], _I
    lib.sofa_cuda_error_string.argtypes = [_I]
    lib.sofa_cuda_error_string.restype = ctypes.c_char_p


def smem_bytes(kernel: Kernel, d: int) -> int:
    """Dynamic shared memory one block of ``kernel`` asks for at head dim
    ``d``, as its library's launch code computes it (``<name>_smem_bytes``;
    ``ptxas -v`` reports only static shared memory).  Builds on first use."""
    return getattr(library(kernel), f"{kernel.name}_smem_bytes")(d)


def check(kernel: Kernel, lib: ctypes.CDLL, err: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.sofa_cuda_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{kernel.name} launch failed: CUDA error {err} "
                           f"({msg})")
