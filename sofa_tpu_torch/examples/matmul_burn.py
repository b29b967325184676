"""A ~5 s matmul burner: the smallest interesting profiling target.

The counterpart of ``examples/matmul_burn.py``: just enough device work
that the kernel trace, the launching ops and the utilization series all
have something to show.  Each burn is waited for, so the 5 s are the
card's work, not a queue of launches.
"""

import time

import torch

from sofa_tpu_torch.examples import device_arg
from sofa_tpu_torch.workloads.common import fence, resolve_device


def burn(x):
    for _ in range(8):
        x = torch.tanh(x @ x) + 0.1
    return x


def main(seconds: float = 5.0, n: int = 2048, device=None):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn(n, n, generator=gen, device=dev).to(torch.bfloat16)
    x = burn(x)          # warm-up (the JAX example's compile)
    fence(x)
    t0 = time.monotonic()
    steps = 0
    while time.monotonic() - t0 < seconds:
        x = burn(x)
        fence(x)
        steps += 1
    dt = time.monotonic() - t0
    print(f"{steps} burns in {dt:.2f}s on {dev.type}")


if __name__ == "__main__":
    main(**device_arg())
