"""Carry a transformer param tree across packages as numpy arrays.

Tests hold the port against the JAX package on ONE init: the JAX params go
through ``jax.tree.map(np.asarray, params)`` and this module turns that
nested dict of arrays into the port's params, same keys and layout.  (Two
independent random inits would never agree.)  This module imports neither
JAX nor the JAX package: it sees only numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def params_from_numpy(tree: Dict[str, Any],
                      device: Optional[torch.device] = None,
                      dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Nested dict of arrays -> the same dict of tensors on ``device``.

    Weight matrices are cast to ``dtype`` (the config's dtype); the norm
    scales (keys ending in ``norm``) stay float32, as both packages keep
    them.  Arrays of any float dtype numpy can widen (including bfloat16
    from ml_dtypes) are read through float32."""

    def leaf(name: str, x) -> torch.Tensor:
        t = torch.from_numpy(np.array(x, dtype=np.float32))
        t = t.to(torch.float32 if name.endswith("norm") else dtype)
        return t.to(device) if device is not None else t

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in node.items()}

    return walk(tree)
