"""``ParamTree``: a nested dict of weight tensors held by an ``nn.Module``.

The port keeps the JAX package's parameter layout (``[in, out]`` weights,
per-layer tensors stacked on a leading ``[L, ...]`` axis, quantized
weights as ``{"q8"|"q4", "scale"}`` dicts) so that the weight bridge is a
rename. The modules hold that tree as buffers, which ``state_dict``,
``.to`` and ``named_buffers`` see, and hand it back as the plain dict the
functional forward passes take.
"""

from __future__ import annotations

from typing import Any, Dict, List, Union

import torch
from torch import nn

Tree = Union[Dict[str, Any], List[Any], torch.Tensor]


class ParamTree(nn.Module):
    """Buffers for the tensors of a nested dict/list tree (weights are not
    trained in the serving slice, so they are buffers, not parameters)."""

    def __init__(self, tree: Tree) -> None:
        super().__init__()
        self._kind = "list" if isinstance(tree, list) else "dict"
        items = enumerate(tree) if isinstance(tree, list) else tree.items()
        self._keys = []
        for key, val in items:
            name = f"item{key}" if self._kind == "list" else key
            self._keys.append(name)
            if isinstance(val, (dict, list)):
                self.add_module(name, ParamTree(val))
            else:
                self.register_buffer(name, val)

    def tree(self) -> Tree:
        """The held tensors as the nested dict/list they came from."""
        vals = []
        for name in self._keys:
            val = getattr(self, name)
            vals.append(val.tree() if isinstance(val, ParamTree) else val)
        if self._kind == "list":
            return vals
        return dict(zip(self._keys, vals))
