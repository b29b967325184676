"""In-process Python stack sampler.

A daemon thread inside the profiled interpreter samples
``sys._current_frames()`` (delivered by the Kineto collector's
sitecustomize injection, which starts it at interpreter start-up); it needs
no ptrace capability and works in containers.

Output format (pystacks.txt), one line per thread per tick:

    <unix_ts> <tid> <outermost;...;innermost>

where each frame is ``module.function`` (the module of a ``python -m``
program by its import name, not ``__main__``).  Parsed by
ingest/strace_parse.py:parse_pystacks.
"""

from __future__ import annotations

import os

# Self-contained module text written into the injection directory: it runs
# inside whatever Python the profiled command uses and imports nothing of
# this package.
_SAMPLER = '''
"""sofa_tpu_torch in-process Python stack sampler (auto-generated)."""
import sys
import threading
import time


def _format_stack(frame):
    parts = []
    depth = 0
    while frame is not None and depth < 128:
        code = frame.f_code
        g = frame.f_globals
        mod = g.get("__name__", "?")
        if mod == "__main__":
            # a `python -m pkg.mod` program: name it by its import name
            mod = getattr(g.get("__spec__"), "name", None) or mod
        parts.append("%s.%s" % (mod, code.co_name))
        frame = frame.f_back
        depth += 1
    parts.reverse()
    return ";".join(parts)


def _loop(rate_hz, out_path, self_tid):
    interval = 1.0 / max(rate_hz, 1e-3)
    with open(out_path, "a", buffering=1) as out:
        while True:
            ts = time.time()
            try:
                frames = sys._current_frames()
            except Exception:
                return
            for tid, frame in frames.items():
                if tid == self_tid:
                    continue
                try:
                    out.write("%.6f %d %s\\n"
                              % (ts, tid, _format_stack(frame)))
                except Exception:
                    return
            time.sleep(interval)


def start_sampler(rate_hz, out_path):
    # The sampler must skip its own thread; its ident is only known once the
    # thread runs, so capture it inside the target.
    def _run():
        _loop(rate_hz, out_path, threading.get_ident())

    t = threading.Thread(target=_run, daemon=True, name="sofa_torch_pystacks")
    t.start()
    return t
'''


def write_sampler_module(inject_dir: str) -> None:
    with open(os.path.join(inject_dir, "sofa_torch_pystacks.py"), "w") as f:
        f.write(_SAMPLER)
