"""The port's ResNet against the JAX package's flax ResNet, on one init.

Both packages run the same numpy inputs and the same parameters (the flax
tree filled with seeded random values, so that every batch norm, including
each block's zero-initialized last one, takes part) at a small size:
stage sizes (1, 1, 1, 1), 10 classes, batch 2, 64 x 64 images.  float32
runs are held at the reference's tolerances (logits atol/rtol 1e-4; two SGD
steps' losses, parameters and batch statistics atol 1e-4 / rtol 1e-3);
the bf16 forward at a relative Frobenius error of 3e-2.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofa_tpu.workloads import resnet as jax_resnet
from sofa_tpu_torch.convert import resnet_from_numpy
from sofa_tpu_torch.workloads import resnet

STAGES, CLASSES, BATCH, IMAGE = (1, 1, 1, 1), 10, 2, 64


def _random_variables(dtype):
    """(flax model, numpy variables, NHWC images, labels) from seed 0."""
    model = jax_resnet.ResNet(stage_sizes=STAGES, num_classes=CLASSES,
                              dtype=dtype)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))

    def fill(path, leaf):
        name = path[-1].key
        n = np.prod(leaf.shape)
        if name == "kernel":
            fan_in = n // leaf.shape[-1]
            v = rng.standard_normal(leaf.shape) / np.sqrt(fan_in)
        elif name == "scale":
            v = 1.0 + 0.2 * rng.standard_normal(leaf.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, leaf.shape)
        else:                           # bias, mean
            v = 0.1 * rng.standard_normal(leaf.shape)
        return np.asarray(v, np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    labels = rng.integers(0, CLASSES, BATCH)
    return model, variables, x, labels


def _port(variables, dtype):
    model = resnet.ResNet(STAGES, CLASSES, dtype)
    model.load_state_dict(resnet_from_numpy(variables))
    return model


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_f32_inference_logits_match_jax():
    model, variables, x, _ = _random_variables(jnp.float32)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    got = resnet.make_infer_step(_port(variables, torch.float32))(_nchw(x))
    assert got.dtype == torch.float32 and got.shape == (BATCH, CLASSES)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_two_sgd_steps_match_jax():
    model, variables, x, labels = _random_variables(jnp.float32)
    tx, jstep = jax_resnet.make_train_step(model)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    port = _port(variables, torch.float32)
    _, step = resnet.make_train_step(port)
    xt, lt = _nchw(x), torch.from_numpy(labels)
    for _ in range(2):
        params, stats, opt_state, jloss = jstep(
            params, stats, opt_state, jnp.asarray(x), jnp.asarray(labels))
        loss = step(xt, lt)
        np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-4,
                                   rtol=1e-3)
    want = resnet_from_numpy(jax.tree.map(
        np.asarray, {"params": params, "batch_stats": stats}))
    got = port.state_dict()
    assert set(got) == set(want)
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=name)


def test_bf16_logits_match_jax():
    model, variables, x, _ = _random_variables(jnp.bfloat16)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), train=False),
                     np.float32)
    got = resnet.make_infer_step(_port(variables, torch.bfloat16))(_nchw(x))
    assert got.dtype == torch.float32
    rel = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
    assert rel <= 3e-2, rel


def test_running_variance_is_flax_biased_one():
    """A 4-element batch: flax moves the running variance toward the
    biased batch variance, torch's BatchNorm2d toward 4/3 of it."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 1, 1, 3)).astype(np.float32)
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    v = flax_bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    _, upd = flax_bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    bn = resnet.BatchNorm(3)
    bn(_nchw(x))
    want = np.asarray(upd["batch_stats"]["var"])
    np.testing.assert_allclose(bn.running_var.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-7)
    plain = torch.nn.BatchNorm2d(3)
    plain(_nchw(x))
    assert not np.allclose(plain.running_var.numpy(), want, rtol=1e-2)


@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("op", ["conv3x3", "conv1x1", "max_pool"])
def test_same_padding_matches_flax(op, stride, size):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    if op == "max_pool":
        ref = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(stride, stride),
                           padding="SAME")
        got = resnet.max_pool_same(_nchw(x), 3, stride)
    else:
        k = 3 if op == "conv3x3" else 1
        w = rng.standard_normal((k, k, 4, 5)).astype(np.float32)
        conv = fnn.Conv(5, (k, k), strides=(stride, stride), use_bias=False)
        ref = conv.apply({"params": {"kernel": jnp.asarray(w)}},
                         jnp.asarray(x))
        got = resnet.conv2d_same(
            _nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
            stride)
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_same_pads_put_the_odd_pixel_after():
    assert resnet.same_pads(8, 3, 2) == (0, 1)
    assert resnet.same_pads(7, 3, 2) == (1, 1)
    assert resnet.same_pads(112, 3, 2) == (0, 1)
    assert resnet.same_pads(8, 1, 2) == (0, 0)


def test_create_and_main_on_the_cpu(capsys):
    model, x = resnet.create(2, 32, 10, stage_sizes=(1, 1, 1, 1),
                             device="cpu")
    assert x.shape == (2, 3, 32, 32) and x.device.type == "cpu"
    # each block's last batch norm starts at a zero scale
    assert all(float(b.bn3.weight.detach().abs().sum()) == 0
               for b in model.blocks)
    assert sum(p.numel() for p in model.parameters()) > 0
    resnet.main(["--device", "cpu", "--batch", "2", "--image_size", "32",
                 "--steps", "2", "--num_classes", "10", "--train"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("resnet50 train: ") and "images/s" in line


def test_published_widths():
    model = resnet.ResNet()
    n = sum(p.numel() for p in model.parameters())
    assert n == 25_557_032          # ResNet-50, 1000 classes
    assert len(model.blocks) == 16
