"""Event-driven recording: trigger windowed captures on log keywords.

The counterpart of ``sofa_tpu/tools/edr.py``.  It polls an application log
for ``keyword[=phase_name]`` triggers, each firing one timed system
capture, ``python -m sofa_tpu_torch record "sleep N"``, into
``<logdir>-<phase>/`` while the watched application keeps running.

    python -m sofa_tpu_torch.tools.edr --log train.log \\
        --trigger "starting epoch=epoch" --trigger "evaluating=eval" \\
        --record_seconds 30 --logdir sofalog/

Each phase fires at most once (re-arm with --rearm: suffixes -2, -3, ...).
Pairs naturally with ``--kineto_delay_s`` / ``--kineto_duration_s`` for
windowed in-process traces of the application itself.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def parse_trigger(spec: str):
    keyword, _, name = spec.partition("=")
    return keyword, (name or keyword.strip().replace(" ", "_"))


def tail_lines(path: str, pos: int):
    """Read new complete lines past byte offset pos; returns (lines, newpos).

    The file is read in binary and the offset tracked in raw bytes: decoding
    first would mis-count whenever the log holds non-UTF-8 bytes (each
    becomes a 3-byte U+FFFD) and skip real content.  A file shorter than
    ``pos`` was rotated or truncated, and is read again from its start.
    """
    try:
        size = os.path.getsize(path)
    except OSError:
        return [], pos
    if size < pos:
        pos = 0
    if size == pos:
        return [], pos
    with open(path, "rb") as f:
        f.seek(pos)
        chunk = f.read()
    last_nl = chunk.rfind(b"\n")
    if last_nl < 0:
        return [], pos
    chunk = chunk[: last_nl + 1]
    return chunk.decode(errors="replace").splitlines(), pos + len(chunk)


def run_edr(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sofa-edr", description=__doc__)
    p.add_argument("--log", required=True,
                   help="application log file to watch")
    p.add_argument("--trigger", action="append", required=True,
                   help='"keyword[=phase_name]", repeatable')
    p.add_argument("--record_seconds", type=float, default=30.0)
    p.add_argument("--logdir", default="sofalog/")
    p.add_argument("--poll_s", type=float, default=1.0)
    p.add_argument("--rearm", action="store_true",
                   help="phases may fire more than once (suffix -2, -3, ...)")
    p.add_argument("--timeout_s", type=float, default=0.0,
                   help="stop watching after this many seconds (0 = forever)")
    args = p.parse_args(argv)

    triggers = [parse_trigger(s) for s in args.trigger]
    fired: dict = {}
    pos = 0
    t0 = time.monotonic()  # watch deadline: immune to wall-clock steps
    print(f"sofa-edr: watching {args.log} for "
          f"{[k for k, _ in triggers]}", flush=True)
    while True:
        if args.timeout_s and time.monotonic() - t0 > args.timeout_s:
            print("sofa-edr: timeout reached", flush=True)
            return 0
        lines, pos = tail_lines(args.log, pos)
        for line in lines:
            for keyword, phase in triggers:
                if keyword not in line:
                    continue
                count = fired.get(phase, 0)
                if count and not args.rearm:
                    continue
                fired[phase] = count + 1
                suffix = phase if count == 0 else f"{phase}-{count + 1}"
                logdir = args.logdir.rstrip("/") + f"-{suffix}/"
                print(f"sofa-edr: trigger {keyword!r} -> recording "
                      f"{args.record_seconds:.0f}s into {logdir}", flush=True)
                # A timed system-wide capture while the application keeps
                # running.  Bounded: the capture is record_seconds long by
                # construction, so a generous grace past that means record
                # wedged (a stuck epilogue), and EDR must keep watching.
                try:
                    subprocess.run(
                        [sys.executable, "-m", "sofa_tpu_torch", "record",
                         f"sleep {args.record_seconds}", "--logdir", logdir],
                        timeout=args.record_seconds + 300,
                    )
                except subprocess.TimeoutExpired:
                    print(f"sofa-edr: record of {logdir} exceeded "
                          f"{args.record_seconds + 300:.0f}s: killed; "
                          "resuming watch", flush=True)
        if all(phase in fired for _, phase in triggers) and not args.rearm:
            print("sofa-edr: all phases captured", flush=True)
            return 0
        time.sleep(args.poll_s)


if __name__ == "__main__":
    sys.exit(run_edr())
