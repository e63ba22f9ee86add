"""Carry a parameter tree across from the JAX package.

``params_from_numpy(tree, device)`` maps the JAX package's param tree —
nested dicts of numpy arrays, e.g. ``jax.tree.map(np.asarray, params)`` —
onto the port's tree: the same keys, the same layouts (linear weights
``(d_in, d_out)``, stacked ``(n_layers, ...)`` layer leaves), as torch
tensors on ``device``.  This module imports neither JAX nor the JAX
package: it only reads numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16: torch.from_numpy refuses it, so reinterpret
        # the bits (same 2-byte layout) and view them back as bf16
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_numpy(tree, device="cpu"):
    """Nested dict of numpy arrays -> nested dict of torch tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _tensor(tree, device)
