"""Disk/IO churner: writes and re-reads a few hundred MB through a temp file.

The counterpart of ``examples/io_churn.py``, the same Python (it never
touches the card): a host-only target for the diskstat / vmstat / blktrace
path, the equivalent of the reference smoke workload ``dd if=/dev/zero
of=dummy.out bs=100M count=10``.
"""

import os
import tempfile


def main(mb: int = 256, block_kb: int = 1024):
    block = os.urandom(block_kb * 1024)
    with tempfile.NamedTemporaryFile(dir=".", suffix=".sofa_io") as f:
        for _ in range(mb * 1024 // block_kb):
            f.write(block)
        f.flush()
        os.fsync(f.fileno())
        f.seek(0)
        read = 0
        while True:
            chunk = f.read(block_kb * 1024)
            if not chunk:
                break
            read += len(chunk)
    print(f"wrote+read {mb} MiB (read back {read >> 20} MiB)")


if __name__ == "__main__":
    main()
