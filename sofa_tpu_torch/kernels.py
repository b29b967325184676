"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is a ``csrc/*.cu`` file with a plain C entry point (the shared
``csrc/*.cuh`` headers hold what the kernels have in common).  On first use
it is compiled by ``nvcc`` for ``sm_90a`` into a shared library of its own
under ``<repo>/build/torch_kernels/`` and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes).  The library's file name
carries a hash of its source and the headers, so an edited source is never
served a stale build.  A variant built with ``-D`` defines (the ring depths
``tools/tune_flash.py`` sweeps) is a library of its own, whose hash covers
the defines too; the main path loads only the default libraries.  Loading a
library binds the ``argtypes`` of every registered entry point it holds
(and its ``<name>_smem_bytes``, the dynamic shared memory its launch asks
for).  Nothing here runs at import time: this module must import on a host
with no CUDA toolkit (the CPU tests import every module).

Every kernel has a launch count.  Its wrapper adds one where it launches the
kernel from its default library and nowhere else (a ring-depth variant's
launch is not counted), so a run can show that its main path went through
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
from typing import Dict, List, Optional, Sequence, Tuple

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
    # "hopper": bfloat16 at head dims 64 and 128 (TMA and wgmma);
    # "general": every other dtype and head dim of the domain
    family: str = "hopper"
    # the Pallas call's name= (the Hopper kernel's own name)
    ports: str = ""

    @property
    def pallas_name(self) -> str:
        return self.ports or self.name

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

#: The Hopper kernels (bfloat16 at D 64 and 128), which tools/tune_flash.py
#: sweeps.
HOPPER = [FLASH_FWD, FLASH_BWD_KV, FLASH_BWD_DQ]

# The general kernels take the element type as one more int before the
# shapes (flash_cuda._DTYPE_CODES).
GEN_FWD = Kernel(name="sofa_flash_gen_fwd", lib="flash_gen_fwd",
                 replaces=FLASH_FWD.replaces,
                 argtypes=[_P] * 7 + [_I] + _SHAPE, family="general",
                 ports=FLASH_FWD.name)
GEN_BWD_KV = Kernel(name="sofa_flash_gen_bwd_kv", lib="flash_gen_bwd_kv",
                    replaces=FLASH_BWD_KV.replaces,
                    argtypes=[_P] * 10 + [_I, _I] + _SHAPE, family="general",
                    ports=FLASH_BWD_KV.name)
GEN_BWD_DQ = Kernel(name="sofa_flash_gen_bwd_dq", lib="flash_gen_bwd_dq",
                    replaces=FLASH_BWD_DQ.replaces,
                    argtypes=[_P] * 9 + [_I, _I] + _SHAPE, family="general",
                    ports=FLASH_BWD_DQ.name)
#: The general kernels: every other (dtype, head dim) up to D 256; each runs
#: bfloat16 and float16 on the tensor cores and float32 in FMA on the CUDA
#: cores.
GENERAL = [GEN_FWD, GEN_BWD_KV, GEN_BWD_DQ]

#: Every kernel of the port.
KERNELS = HOPPER + GENERAL

#: -D defines of a variant build, as (name, value) pairs
Defines = Tuple[Tuple[str, int], ...]

_loaded: Dict[Tuple[str, Defines], ctypes.CDLL] = {}
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


def library_path(kernel: Kernel, defines: Defines = ()) -> str:
    """The library of ``kernel`` built with ``defines`` ((name, value)
    pairs, each passed as ``-Dname=value``): its hash covers the source,
    the headers and the defines; with none it is the default library's."""
    h = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cuh")))
    for path in [kernel.source] + headers:
        with open(path, "rb") as f:
            h.update(f.read())
    for name, value in defines:
        h.update(f"\0-D{name}={value}".encode())
    return os.path.join(BUILD_DIR, f"lib{kernel.lib}-{h.hexdigest()[:12]}.so")


def nvcc_command(nvcc: str, kernel: Kernel, out: str,
                 defines: Defines = ()) -> list:
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            *(f"-D{name}={value}" for name, value in defines),
            "-o", out, kernel.source]


def build(kernel: Kernel, defines: Defines = ()) -> str:
    """Compile ``kernel`` (with ``defines``) unless its hashed library
    exists; returns the compiler's report (empty when nothing was built).
    Raises on any failure: there is no fallback to an uncompiled path."""
    path = library_path(kernel, defines)
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
        res = subprocess.run(nvcc_command(nvcc, kernel, tmp, defines),
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


def build_all(kernels: List[Kernel],
              variants: Sequence[Tuple[Kernel, Defines]] = ()
              ) -> Dict[str, str]:
    """Build every kernel, and every (kernel, defines) variant, at once
    (one ``nvcc`` each, all started together); returns each default
    library's compiler report by kernel name (a variant's is dropped)."""
    jobs = [(k, ()) for k in kernels] + list(variants)
    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
        reports = list(pool.map(lambda job: build(*job), jobs))
    return {k.name: r for (k, _), r in zip(jobs, reports[:len(kernels)])}


def library(kernel: Kernel, defines: Defines = ()) -> ctypes.CDLL:
    """The loaded library of ``kernel`` (built with ``defines``), building
    it on first use."""
    with _lock:
        lib = _loaded.get((kernel.lib, defines))
        if lib is None:
            build(kernel, defines)
            lib = ctypes.CDLL(library_path(kernel, defines))
            _bind(kernel.lib, lib)
            _loaded[(kernel.lib, defines)] = lib
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


def smem_bytes(kernel: Kernel, d: int, defines: Defines = ()) -> int:
    """Dynamic shared memory one block of ``kernel`` (built with
    ``defines``) asks for at head dim ``d``, as its library's launch code
    computes it (``<name>_smem_bytes``; ``ptxas -v`` reports only static
    shared memory).  Builds on first use."""
    return getattr(library(kernel, defines), f"{kernel.name}_smem_bytes")(d)


def check(kernel: Kernel, lib: ctypes.CDLL, err: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.sofa_cuda_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{kernel.name} launch failed: CUDA error {err} "
                           f"({msg})")
