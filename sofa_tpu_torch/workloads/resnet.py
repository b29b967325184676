"""ResNet-50 in PyTorch (single device): the single-card profiling target.

The counterpart of ``sofa_tpu/workloads/resnet.py``: bottleneck blocks,
stage sizes (3, 4, 6, 3), 1000 classes, bf16 compute with float32
parameters and float32 batch-norm statistics, the last batch norm of each
block initialized to a zero scale, and SGD (lr 0.1, momentum 0.9) on the
softmax cross-entropy.  Plain ``torch.nn``, no torchvision; the
convolutions are cuDNN's through ``torch.nn.functional.conv2d``.  On the
card activations and convolution weights use the ``channels_last`` memory
format.

Four places where a literal translation of the flax model goes wrong:

  * flax ``BatchNorm(momentum=0.9)`` keeps 0.9 of the running average;
    torch's ``momentum`` is the share of the new batch, 0.1 here;
  * flax updates the running variance with the *biased* batch variance,
    ``nn.BatchNorm2d`` with the unbiased one (n / (n - 1) larger, up to 2x
    on a small late-stage batch), so ``BatchNorm`` below updates it as flax
    does;
  * flax ``padding="SAME"`` pads ``total // 2`` before and the rest after:
    on even sizes the stride-2 3x3 convolution and the 3x3 max-pool pad 0
    before and 1 after, which torch's symmetric ``padding=1`` shifts by one
    window (``same_pads``); the max-pool pads with -inf;
  * JAX feeds NHWC images and HWIO kernels, torch NCHW and OIHW
    (``sofa_tpu_torch.convert.resnet_from_numpy`` crosses them).

The head averages in the compute dtype (float32 accumulation, as
``jnp.mean`` upcasts) and multiplies in float32, as the flax ``Dense`` does.

``python -m sofa_tpu_torch.workloads.resnet [--train]`` prints the JAX
workload's ``main`` line.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of one spatial dim under XLA's ``SAME``:
    the output has ceil(size / stride) positions."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pads_2d(x: torch.Tensor, kernel: int, stride: int):
    """(symmetric padding or None, F.pad tuple) of SAME on x's H and W."""
    (ht, hb), (wl, wr) = (same_pads(x.shape[2], kernel, stride),
                          same_pads(x.shape[3], kernel, stride))
    if ht == hb and wl == wr:
        return (ht, wl), None
    return None, (wl, wr, ht, hb)


def conv2d_same(x: torch.Tensor, weight: torch.Tensor,
                stride: int = 1) -> torch.Tensor:
    """``nn.Conv(padding="SAME")`` of an NCHW input and an OIHW weight (no
    bias), padding asymmetrically only where SAME does."""
    sym, pad = _pads_2d(x, weight.shape[2], stride)
    if pad is not None:
        x = F.pad(x, pad)
        sym = 0
    return F.conv2d(x, weight, stride=stride, padding=sym)


def max_pool_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """``nn.max_pool(padding="SAME")``: pads with -inf."""
    sym, pad = _pads_2d(x, kernel, stride)
    if pad is not None:
        x = F.pad(x, pad, value=float("-inf"))
        sym = 0
    return F.max_pool2d(x, kernel, stride, padding=sym)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over NCHW: statistics and normalization in
    float32 whatever the input dtype, the output in the input's dtype.  In
    training the batch statistics normalize and the running averages move
    0.1 of the way to them (flax ``momentum=0.9``), the variance's being
    the biased batch variance.  The state is ``nn.BatchNorm2d``'s without
    its batch count, which flax does not keep."""

    eps, momentum = 1e-5, 0.1

    def __init__(self, channels: int, zero_scale: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,),
                                              0.0 if zero_scale else 1.0))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            # invstd = (var + eps) ** -0.5, var the biased batch variance
            self.running_var.lerp_(invstd.pow(-2) - self.eps, self.momentum)
        return y


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 projection: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.conv1 = nn.Conv2d(in_ch, filters, 1, bias=False)
        self.bn1 = BatchNorm(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, bias=False)
        self.bn2 = BatchNorm(filters)
        self.conv3 = nn.Conv2d(filters, 4 * filters, 1, bias=False)
        self.bn3 = BatchNorm(4 * filters, zero_scale=True)
        self.proj_conv = self.proj_bn = None
        if projection:
            self.proj_conv = nn.Conv2d(in_ch, 4 * filters, 1, bias=False)
            self.proj_bn = BatchNorm(4 * filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.relu(self.bn1(F.conv2d(x, self.conv1.weight.to(dt))))
        y = F.relu(self.bn2(conv2d_same(y, self.conv2.weight.to(dt),
                                        self.stride)))
        y = self.bn3(F.conv2d(y, self.conv3.weight.to(dt)))
        residual = x
        if self.proj_conv is not None:
            residual = self.proj_bn(conv2d_same(
                x, self.proj_conv.weight.to(dt), self.stride))
        return F.relu(y + residual)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.stem_bn = BatchNorm(64)
        blocks, in_ch = [], 64
        for i, n_blocks in enumerate(stage_sizes):
            filters = 64 * 2 ** i
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(Bottleneck(in_ch, filters, stride,
                                         projection=(j == 0), dtype=dtype))
                in_ch = 4 * filters
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(in_ch, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW images -> float32 logits."""
        x = x.to(self.dtype)
        x = F.conv2d(x, self.stem.weight.to(self.dtype), stride=2, padding=3)
        x = max_pool_same(F.relu(self.stem_bn(x)), 3, 2)
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3))
        return F.linear(x.float(), self.head.weight, self.head.bias)


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax's default kernel init: a normal truncated at 2 std, scaled to
    variance 1 / fan_in."""
    fan_in = w[0].numel()
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


def create(batch: int, image_size: int = 224, num_classes: int = 1000,
           stage_sizes=(3, 4, 6, 3), seed: int = 0, device=None,
           dtype=torch.bfloat16):
    """(model, images): a randomly initialized ResNet in training mode and a
    batch of NCHW normal images, both from ``seed`` on ``device`` (the card
    unless the caller names another; ``channels_last`` there)."""
    from sofa_tpu_torch.workloads.common import resolve_device

    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.device(device):
        model = ResNet(tuple(stage_sizes), num_classes, dtype)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                _lecun_normal_(m.weight, gen)
        nn.init.zeros_(model.head.bias)
    x = torch.randn(batch, 3, image_size, image_size, generator=gen,
                    device=device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
        x = x.contiguous(memory_format=torch.channels_last)
    return model, x


def make_infer_step(model: ResNet):
    """infer(x) -> logits with the running batch statistics."""
    def infer(x):
        model.eval()
        with torch.no_grad():
            return model(x)
    return infer


def make_train_step(model: ResNet, learning_rate: float = 0.1):
    """(optimizer, step) with step(x, labels) -> loss: one forward in
    training mode (the batch statistics normalize and move the running
    averages), the mean softmax cross-entropy, its backward and one SGD
    update with momentum 0.9 (``optax.sgd(lr, momentum=0.9)``), all in
    place."""
    opt = torch.optim.SGD(model.parameters(), lr=learning_rate, momentum=0.9)

    def step(x, labels):
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(x), labels)
        loss.backward()
        opt.step()
        return loss.detach()

    return opt, step


def main(argv=None):
    from sofa_tpu_torch.workloads.common import (parse_workload_args,
                                                 steps_per_sec)

    args = parse_workload_args(argv, {
        "batch": 64, "image_size": 224, "steps": 20, "train": False,
        "num_classes": 1000, "device": None,
    })
    model, x = create(args.batch, args.image_size, args.num_classes,
                      device=args.device)
    if x.is_cuda:
        torch.backends.cudnn.benchmark = True   # as XLA autotunes its convs
    if args.train:
        labels = torch.zeros(args.batch, dtype=torch.long, device=x.device)
        _, step = make_train_step(model)
        sps, loss = steps_per_sec(lambda _: step(x, labels), None, args.steps)
        print(f"resnet50 train: {sps:.3f} steps/s  "
              f"{sps * args.batch:.1f} images/s  loss={float(loss):.3f}")
    else:
        infer = make_infer_step(model)
        sps, _ = steps_per_sec(lambda _: infer(x), None, args.steps)
        print(f"resnet50 infer: {sps:.3f} steps/s  "
              f"{sps * args.batch:.1f} images/s")


if __name__ == "__main__":
    main()
