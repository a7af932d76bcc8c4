"""Weight bridge: the JAX package's parameters, as numpy, to the port's
tensors.

Both packages keep one layout (``[in, out]`` weights, stacked ``[L, ...]``
layers, ``{"q8"|"q4", "scale"}`` quantized dicts), so the bridge converts
leaves and changes no shape. A caller turns a JAX tree into numpy with
``jax.tree_util.tree_map(np.asarray, params)`` first; this module imports
neither JAX nor ``ml_dtypes``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tensor_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    """One leaf. bfloat16 arrays (``ml_dtypes``; recognised by dtype name)
    become ``torch.bfloat16`` through a ``uint16`` view, bit for bit; other
    dtypes (float32, int8 codes, bool) keep their bytes."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:   # e.g. np.asarray of a JAX array
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """A nested dict/list of numpy arrays -> the same tree of tensors.

    An int4 dict whose scale is ``uint16`` holds bf16 bit patterns (the
    port's numpy quantizer writes them so: numpy has no bfloat16) and its
    scale becomes ``torch.bfloat16``."""
    if isinstance(tree, dict):
        out = {k: params_from_numpy(v, device) for k, v in tree.items()}
        if "q4" in out and out["scale"].dtype == torch.uint16:
            out["scale"] = out["scale"].view(torch.bfloat16)
        return out
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return tensor_from_numpy(np.asarray(tree), device)
