"""Carry a model's parameters across packages as numpy arrays.

Tests hold the port against the JAX package on ONE init: the JAX params go
through ``jax.tree.map(np.asarray, params)`` and this module turns that
nested dict of arrays into the port's params: the transformer's, the
MoE's and the pipeline's keep their keys and layout
(``params_from_numpy``), and ``shard_tree`` cuts this rank's block of
each leaf out of a global dict by a spec table (the JAX package's
PartitionSpecs as tuples of axis names); the ResNet's flax
``{"params", "batch_stats"}`` tree becomes the torch module's state dict
(``resnet_from_numpy``).  (Two independent random inits would never
agree.)  This module imports neither JAX nor the JAX package: it sees only
numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def params_from_numpy(tree: Dict[str, Any],
                      device: Optional[torch.device] = None,
                      dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Nested dict of arrays -> the same dict of tensors on ``device``.

    Weight matrices are cast to ``dtype`` (the config's dtype); the norm
    scales (keys ending in ``norm``) and the MoE router stay float32, as
    both packages keep them.  Arrays of any float dtype numpy can widen
    (including bfloat16 from ml_dtypes) are read through float32."""

    def leaf(name: str, x) -> torch.Tensor:
        t = torch.from_numpy(np.array(x, dtype=np.float32))
        keep = name.endswith("norm") or name in FLOAT32_LEAVES
        t = t.to(torch.float32 if keep else dtype)
        return t.to(device) if device is not None else t

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in node.items()}

    return walk(tree)


#: weight leaves that stay float32 in every dtype (the MoE router: tiny,
#: and its logit noise moves tokens between experts)
FLOAT32_LEAVES = ("router",)


def shard_leaf(x, spec: Tuple[Optional[str], ...],
               coords: Dict[str, Tuple[int, int]],
               dtype: Optional[torch.dtype] = None):
    """This rank's block of one global leaf (a tensor or an array).

    ``spec[i]`` names the mesh axis that dimension i is split over (None:
    whole); ``coords[axis]`` is (this rank's index, the axis size).  A
    dimension splits into equal contiguous parts, part ``index`` kept, as
    a ``NamedSharding`` places a PartitionSpec's blocks.  A dimension that
    does not divide raises.  A cut block is a copy, so the global leaf can
    be freed; a tensor's is made in ``dtype`` (one copy that also casts),
    and an uncut tensor is cast to it."""
    index, cut = [], False
    for dim, axis in enumerate(spec):
        i, n = coords.get(axis, (0, 1)) if axis is not None else (0, 1)
        if n == 1:
            index.append(slice(None))
            continue
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"dimension {dim} ({size}) of a leaf split over "
                             f"'{axis}' does not divide into {n} parts")
        index.append(slice(i * size // n, (i + 1) * size // n))
        cut = True
    block = x[tuple(index)]
    if not isinstance(block, torch.Tensor):
        return np.ascontiguousarray(block) if cut else block
    dtype = block.dtype if dtype is None else dtype
    return block.to(dtype, copy=cut)


def shard_tree(tree: Dict[str, Any], specs: Dict[str, Any],
               coords: Dict[str, Tuple[int, int]]) -> Dict[str, Any]:
    """``shard_leaf`` over a nested dict and its spec table, key by key."""
    return {k: shard_tree(v, specs[k], coords) if isinstance(v, dict)
            else shard_leaf(v, specs[k], coords) for k, v in tree.items()}


# flax names inside one Bottleneck, in creation order -> the port's modules
_BLOCK_CONVS = {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "conv3",
                "Conv_3": "proj_conv"}
_BLOCK_NORMS = {"BatchNorm_0": "bn1", "BatchNorm_1": "bn2",
                "BatchNorm_2": "bn3", "BatchNorm_3": "proj_bn"}


def resnet_from_numpy(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax ResNet's ``{"params", "batch_stats"}`` (numpy leaves) ->
    the state dict of ``sofa_tpu_torch.workloads.resnet.ResNet``, float32.

    HWIO convolution kernels become OIHW, the [in, out] dense kernel the
    [out, in] linear weight; each ``BatchNorm_k`` gives its module's
    weight (scale), bias, running_mean and running_var."""
    params, stats = variables["params"], variables["batch_stats"]

    def t(x, perm=None):
        a = np.array(x, dtype=np.float32)
        return torch.from_numpy(np.ascontiguousarray(
            a.transpose(perm) if perm else a))

    out: Dict[str, torch.Tensor] = {}

    def conv(prefix, p):
        out[f"{prefix}.weight"] = t(p["kernel"], (3, 2, 0, 1))

    def norm(prefix, p, s):
        out[f"{prefix}.weight"] = t(p["scale"])
        out[f"{prefix}.bias"] = t(p["bias"])
        out[f"{prefix}.running_mean"] = t(s["mean"])
        out[f"{prefix}.running_var"] = t(s["var"])

    conv("stem", params["Conv_0"])
    norm("stem_bn", params["BatchNorm_0"], stats["BatchNorm_0"])
    n_blocks = sum(k.startswith("Bottleneck_") for k in params)
    for i in range(n_blocks):
        p, s = params[f"Bottleneck_{i}"], stats[f"Bottleneck_{i}"]
        for flax_name, name in _BLOCK_CONVS.items():
            if flax_name in p:
                conv(f"blocks.{i}.{name}", p[flax_name])
        for flax_name, name in _BLOCK_NORMS.items():
            if flax_name in p:
                norm(f"blocks.{i}.{name}", p[flax_name], s[flax_name])
    out["head.weight"] = t(params["Dense_0"]["kernel"], (1, 0))
    out["head.bias"] = t(params["Dense_0"]["bias"])
    return out
