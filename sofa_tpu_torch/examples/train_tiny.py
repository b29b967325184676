"""A 20-step tiny-transformer training loop with per-step annotations.

The counterpart of ``examples/train_tiny.py``, and the iteration-detection
target: each step is wrapped in the ``sofa_step_N`` range the AISI pass
anchors on, so ``python -m sofa_tpu_torch stat "python -m
sofa_tpu_torch.examples.train_tiny" --enable_aisi`` yields an
iterations.csv with step times and fw/bw splits.  ``TransformerConfig.tiny``
has head dim 16, which the CUDA kernels are not built for: its attention is
the plain one (``examples/long_context`` is the one that runs the kernels).
"""

from sofa_tpu_torch.examples import device_arg
from sofa_tpu_torch.workloads.common import fence, step_annotation
from sofa_tpu_torch.workloads.transformer import TransformerConfig, build


def train(params, opt, step, tokens, steps: int):
    """One warm-up step (the JAX example's compile step), then ``steps``
    annotated steps; returns the last loss."""
    params, opt, loss = step(params, opt, tokens)
    fence(loss)
    for i in range(steps):
        with step_annotation(i):
            params, opt, loss = step(params, opt, tokens)
    return loss


def main(steps: int = 20, device=None):
    cfg = TransformerConfig.tiny(seq=128)
    params, opt, step, tokens = build(cfg, batch=8, seq=128, device=device)
    loss = train(params, opt, step, tokens, steps)
    print(f"final loss {float(loss):.4f} after {steps} steps")


if __name__ == "__main__":
    main(**device_arg())
